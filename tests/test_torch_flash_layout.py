"""The flash kernels' layout gate and the kernel library's C signatures.

``kernel_layout`` (``paddle_tpu_torch/ops/kernels/flash_attention.py``)
decides, on any device, whether q, k and v reach the flash kernels as
they are or as fresh contiguous copies: every bf16 kernel (the forward,
the backward's dK/dV body and its dQ body) runs on the tensor cores and
stages 16-byte chunks by ``cp.async``, so every bf16 base pointer must
be 16-byte aligned and every stride on (B, S, H) a multiple of 8
elements; the fp32 kernels, on the CUDA cores, take such views as they
are. These tests hold the gate to that contract on CPU
tensors: GPT's per-head qkv views pass without a copy (from the
model's own forward at ``gpt_tiny`` scale, under bf16 AMP), a view
misaligned by one element or with an odd stride is copied for the
tensor-core kernels only, and k and v with unequal strides are copied
together. A copy changes the layout, never the values.

``_SIGNATURES`` (``_build.py``) declares the ctypes argument types of
every C entry point; the last tests parse every ``extern "C"``
definition in ``csrc/*.cu`` and require the two to agree, name for name
and argument for argument, and every entry point that a script at the
root of the checkout names to be declared.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import flash_attention as port_fa

CSRC = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"


def _randn(*shape, dtype=torch.bfloat16, seed=0):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def _assert_copied_equal(got, given):
    for a, b in zip(got, given):
        assert a.data_ptr() != b.data_ptr()
        assert a.is_contiguous() and a.data_ptr() % 16 == 0
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [16, 64, 128])
def test_gate_passes_qkv_split_views_without_a_copy(D):
    """models/gpt.py: qkv.reshape(b, s, H, 3D).split(D, -1), strides
    (3SHD, 3HD, 3D, 1) at element offsets 0, D and 2D."""
    B, S, H = 2, 128, 4
    q, k, v = _randn(B, S, H, 3 * D).split(D, dim=-1)
    got = port_fa.kernel_layout(q, k, v)
    assert _ptrs(got) == _ptrs((q, k, v))
    assert [t.stride() for t in got] == [(S * H * 3 * D, H * 3 * D, 3 * D,
                                          1)] * 3


def test_gate_sees_gpt_views_in_the_model_forward(monkeypatch):
    """gpt_tiny's no-cache forward under bf16 AMP: every layer hands K1
    bf16 views the gate passes as they are."""
    cfg = gpt_tiny()
    model = GPTForCausalLM(cfg, device="cpu", seed=0)
    seen = []
    real = port_fa.flash_fwd

    def spy(q, k, v, scale, causal):
        got = port_fa.kernel_layout(q, k, v)
        seen.append((q.dtype, _ptrs(got) == _ptrs((q, k, v)), q.stride()))
        return real(q, k, v, scale, causal)

    monkeypatch.setattr(port_fa, "flash_fwd", spy)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, cfg.max_position_embeddings)))
    with torch.no_grad(), auto_cast(level="O1", dtype="bfloat16"):
        model(ids)
    H = cfg.num_heads
    D = cfg.hidden_size // H
    S = cfg.max_position_embeddings
    assert seen == [(torch.bfloat16, True,
                     (S * H * 3 * D, H * 3 * D, 3 * D, 1))] * cfg.num_layers


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gate_copies_a_view_misaligned_by_one_element(dtype):
    B, S, H, D = 2, 64, 2, 64
    n = B * S * H * D
    q, k, v = (_randn(n + 1, dtype=dtype, seed=i)[1:].view(B, S, H, D)
               for i in range(3))
    # contiguous, so .contiguous() would hand back the same view
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    got = port_fa.kernel_layout(q, k, v)
    if dtype == torch.bfloat16:
        _assert_copied_equal(got, (q, k, v))
    else:   # the fp32 kernels load elements
        assert _ptrs(got) == _ptrs((q, k, v))


def test_gate_copies_a_bf16_stride_off_the_16_byte_grid():
    """(B, S, H, D + 1)[..., :D]: the head dim is contiguous, but the
    strides on (B, S, H) are not multiples of 8."""
    B, S, H, D = 2, 64, 2, 64
    q, k, v = (_randn(B, S, H, D + 1, seed=i)[..., :D] for i in range(3))
    assert q.stride(2) == D + 1
    got = port_fa.kernel_layout(q, k, v)
    _assert_copied_equal(got, (q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gate_copies_k_and_v_with_unequal_strides(dtype):
    """The kernels take one stride triple for k and v together."""
    B, S, H, D = 2, 64, 2, 64
    q = _randn(B, S, H, D, dtype=dtype)
    k = _randn(B, S, H, D, dtype=dtype, seed=1)
    v = _randn(B, H, S, D, dtype=dtype, seed=2).transpose(1, 2)
    assert k.stride() != v.stride()
    got = port_fa.kernel_layout(q, k, v)
    assert got[0].data_ptr() == q.data_ptr()
    assert got[1].stride() == got[2].stride()
    _assert_copied_equal(got[1:], (k, v))


_CTYPE = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
          "float": ctypes.c_float}


def _c_entry_points():
    """name -> [ctypes type] of every extern "C" definition in csrc/*.cu,
    with the sources' object-like macros expanded."""
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text().replace("\\\n", " ")
        macros = dict(re.findall(r"^#define\s+(\w+)\s+(.*)$", text, re.M))
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       text):
            for macro, body in macros.items():
                params = re.sub(rf"\b{macro}\b", body, params)
            assert name not in found, f"{name} defined twice"
            found[name] = [ctypes.c_void_p if "*" in p
                           else _CTYPE[" ".join(p.split()[:-1])]
                           for p in params.split(",")]
    return found


def test_signatures_match_the_c_entry_points():
    entry = _c_entry_points()
    assert set(entry) == set(_build._SIGNATURES)
    for name, types in entry.items():
        assert _build._SIGNATURES[name] == types, name


SCRIPTS = ["chip_smoke.py", "k1_fault_check.py", "k3_fault_check.py",
           "k3_variants.py", "k4_fault_check.py", "k4_variants.py",
           "k5_fault_check.py", "k5_variants.py", "k2_fault_check.py",
           "k2_variants.py", "k45_f32_fault_check.py",
           "k45_f32_variants.py"]


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_name_only_declared_entry_points(script):
    """Every C entry point a script at the root names (the occupancy
    queries of chip_smoke.py's phase 2) has its ctypes signature in
    ``_SIGNATURES``; an undeclared one would be called with 32-bit
    arguments."""
    text = (CSRC.parents[1] / script).read_text()
    named = set(re.findall(r"\bptt_\w+", text))
    assert named <= set(_build._SIGNATURES), named - set(_build._SIGNATURES)
