"""float16 through K2, K4 and K5's plain versions and the serving path,
against the JAX package on the CPU.

The Pallas K2, K4 and K5 take fp16 inputs and compute in fp32 (the
output cast to the input's dtype). On the card the port runs fp16 in
the same hand-written bodies as bf16, instantiated on ``__half``; here,
on CPU tensors, the wrappers run their plain versions, which these tests
hold to the Pallas kernels in interpret mode on the same numpy inputs:

- K2: ``layer_norm_fwd`` on fp16 rows (with and without w and b) within
  one fp16 rounding of the Pallas output (both compute in fp32 and
  round y once: ``atol`` 1e-3 at |y| <= 8, where fp16's unit in the last
  place is 2**-8), mean and rstd in fp32 within 1e-5;
- K4 and K5: fp16 queries over fp16 pools and over int8 code pools with
  their scales, the decode and verify shapes and chunks at several
  starts, on pools poisoned where no query may read. The plain version
  rounds the logits and P to fp16 where the Pallas kernel keeps fp32
  (|logit| <= ~4 here, 2**-9 of rounding, P within ~1e-3 relatively),
  and both round the output: ``ATOL`` 4e-3 (|out| <= ~2) over fp16
  pools; over int8 pools, whose dequantized values reach ~6, ``ATOL``
  relative to max(1, max |out|);
- serving: an fp16 ``gpt_tiny`` on fp16 pools and on int8 pools against
  the JAX fp16 engine, greedy tokens equal but at near-ties, as
  ``tests/test_torch_serving_bf16.py`` holds bf16 (its helper, with fp16's
  unit in the last place; over int8 pools the unit of the codes, which
  hold a row's absmax in 127 steps, 2**-7, as bf16's 8 bits do: the two
  frameworks' fp16 K/V differ in their last bits, which can move a code
  by one), and agreement with the JAX model's teacher-forced argmax of
  at least 0.9.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.ops.pallas.chunk_prefill import chunk_prefill_pallas
from paddle_tpu.ops.pallas.layer_norm import _ln_forward
from paddle_tpu.ops.pallas.paged_attention import paged_attention_pallas

from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
from paddle_tpu_torch.ops.kernels import layer_norm as k2
from paddle_tpu_torch.ops.kernels import paged_attention as k4
from test_torch_int8 import _read_jax_positions_from_t
from test_torch_kernels import BP, BS, B, D, H, NBLK, _poison

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

ATOL = 4e-3
F16 = np.float16
# two units in the last place of the top logit, relatively: fp16's, and
# over int8 pools the codes'
NEAR_TIE = {None: 2.0 ** -9, "int8": 2.0 ** -6}


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape", [(8, 64), (5, 48)])
def test_layer_norm_fp16_matches_pallas(affine, shape):
    rs = np.random.RandomState(0)
    R, C = shape
    x = (rs.randn(R, C) * 2 + 0.5).astype(F16)
    w = (1 + 0.1 * rs.randn(C)).astype(F16) if affine else None
    b = (0.1 * rs.randn(C)).astype(F16) if affine else None
    y, mean, rstd = _ln_forward(jnp.asarray(x),
                                None if w is None else jnp.asarray(w),
                                None if b is None else jnp.asarray(b),
                                1e-5, 256, True)
    py, pm, pr = k2.layer_norm_fwd(_t(x), None if w is None else _t(w),
                                   None if b is None else _t(b), 1e-5)
    assert py.dtype == torch.float16 and pm.dtype == torch.float32
    assert np.asarray(y).dtype == F16
    np.testing.assert_allclose(py.float().numpy(),
                               np.asarray(y, np.float32), atol=1e-3, rtol=0)
    np.testing.assert_allclose(pm.numpy(), np.asarray(mean), atol=1e-5)
    np.testing.assert_allclose(pr.numpy(), np.asarray(rstd), atol=1e-5)


def _pools(seed, int8):
    rs = np.random.RandomState(seed)
    if int8:
        kp, vp = (rs.randint(-127, 128, (NBLK, BS, H, D)).astype(np.int8)
                  for _ in range(2))
        ks, vs = ((0.02 + 0.01 * np.abs(rs.randn(NBLK, H))).astype(
            np.float32) for _ in range(2))
    else:
        kp, vp = (rs.randn(NBLK, BS, H, D).astype(F16) for _ in range(2))
        ks = vs = None
    tbl = rs.randint(1, 13, size=(B, BP)).astype(np.int32)
    return rs, kp, vp, ks, vs, tbl


def _poisoned(kp, vp, tbl, reach, int8):
    """Rows no query may read poisoned (saturated codes over int8 pools,
    1e4 over fp16, past which fp16 logits would overflow), blocks no
    table names NaN (fp16) — never read by either side."""
    if int8:
        kpp, vpp = kp.copy(), vp.copy()
        for blk in range(NBLK):
            for r in range(BS):
                if not any(tbl[o, j] == blk and j * BS + r <= reach[o]
                           for o in range(tbl.shape[0]) for j in range(BP)):
                    kpp[blk, r] = vpp[blk, r] = 127
        return kpp, vpp
    kpp, vpp = _poison(kp.astype(np.float32), vp.astype(np.float32), tbl,
                       reach)
    return (np.where(kpp == 1e9, 1e4, kpp).astype(F16),
            np.where(vpp == 1e9, 1e4, vpp).astype(F16))


def _check(out, ref, int8):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert np.isfinite(out).all()
    norm = max(1.0, float(np.abs(ref).max())) if int8 else 1.0
    err = float(np.abs(out - ref).max()) / norm
    assert err <= ATOL, err


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s", [1, 5])
def test_paged_attention_fp16_matches_pallas(int8, s):
    """The decode step and a verify of 4 drafts at per-slot offsets that
    straddle block boundaries, clean and poisoned."""
    rs, kp, vp, ks, vs, tbl = _pools(2 + int8, int8)
    q = rs.randn(B, s, H, D).astype(F16)
    t = np.asarray([5, 17, 40 - s], np.int32)
    sc = (None, None) if ks is None else (jnp.asarray(ks), jnp.asarray(vs))
    ref = paged_attention_pallas(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), *sc, jnp.asarray(tbl),
                                 jnp.asarray(t), interpret=True)
    assert np.asarray(ref).dtype == F16
    psc = {} if ks is None else dict(k_scale=_t(ks), v_scale=_t(vs))
    kpp, vpp = _poisoned(kp, vp, tbl, t + s - 1, int8)
    for a, b in ((kp, vp), (kpp, vpp)):
        out = k4.paged_attention(_t(q), _t(a), _t(b), _t(tbl), _t(t), **psc)
        assert out.dtype == torch.float16
        _check(out, ref, int8)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s,start", [(16, 0), (16, 24), (12, 40)])
def test_chunk_prefill_fp16_matches_pallas(int8, s, start):
    """Single-slot chunks at several starts (at 40 the tail runs past
    the table's 48 rows), clean and poisoned."""
    rs, kp, vp, ks, vs, tbl = _pools(4 + int8, int8)
    tbl = tbl[:1]
    q = rs.randn(1, s, H, D).astype(F16)
    sc = (None, None) if ks is None else (jnp.asarray(ks), jnp.asarray(vs))
    ref = chunk_prefill_pallas(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), *sc, jnp.asarray(tbl),
                               jnp.asarray(start), interpret=True)
    psc = {} if ks is None else dict(k_scale=_t(ks), v_scale=_t(vs))
    st = torch.tensor(start, dtype=torch.int32)
    kpp, vpp = _poisoned(kp, vp, tbl, [start + s - 1], int8)
    for a, b in ((kp, vp), (kpp, vpp)):
        out = k5.chunk_prefill(_t(q), _t(a), _t(b), _t(tbl), st, **psc)
        assert out.dtype == torch.float16
        _check(out, ref, int8)


def test_fp16_queries_pass_the_wrappers_checks():
    """fp16 q with fp16 or int8 pools passes ``check_paged_args`` (the
    card's gate); fp16 q over bf16 pools does not."""
    rs, kp, vp, ks, vs, tbl = _pools(6, False)
    q = _t(rs.randn(B, 1, H, D).astype(F16))
    assert k4.check_paged_args("k4", q, _t(kp), _t(vp), _t(tbl)) == 3
    _, kq, vq, ks, vs, _ = _pools(6, True)
    assert k4.check_paged_args("k4", q, _t(kq), _t(vq), _t(tbl), _t(ks),
                               _t(vs)) == k4._INT8
    with pytest.raises(TypeError, match="share q's dtype"):
        k4.check_paged_args("k4", q, _t(kp).bfloat16(), _t(vp).bfloat16(),
                            _t(tbl))
    assert k2._DTYPES[torch.float16] == 3


# ------------------------------------------------------------------ serving
SYS = [7, 3, 9, 11, 2, 5, 8, 4] * 4
PROMPTS = [SYS + [1, 2, 3], list(range(100, 103))]


@pytest.fixture(scope="module")
def models():
    """Both models in fp16 with the same random weights (those of
    ``tests/test_torch_serving_bf16.py``)."""
    paddle.seed(1234)
    jm = JaxGPT(jax_gpt_tiny())
    rs = np.random.RandomState(0)
    state = {}
    for k, v in jm.state_dict().items():
        a = rs.randn(*v.shape).astype(np.float32) * (0.3 if v.ndim == 2
                                                     else 0.1)
        if ".ln_" in k and k.endswith("weight"):
            a += 1.0
        state[k] = a
    jm.set_state_dict(state)
    jm.to(dtype="float16")
    jm.eval()
    pm = GPTForCausalLM(gpt_tiny(), device="cpu", dtype=torch.float16)
    pm.set_state_dict(state)
    pm.eval()
    return jm, pm


def _serve(engine_cls, request_cls, model, kv_dtype, **kw):
    eng = engine_cls(model, max_batch_slots=2, max_len=128, top_k=1,
                     prefill_chunk=16, block_size=16, kv_dtype=kv_dtype,
                     **kw)
    reqs = [eng.submit(request_cls(prompt=p, max_new_tokens=8, greedy=True))
            for p in PROMPTS]
    eng.run()
    assert all(r.status == "done" for r in reqs)
    return [r.tokens for r in reqs]


# the JAX no-cache forwards run at one padded length, under the flash
# gate's 128 (the reference's plain attention), so each eager op of the
# forward compiles once for the module; the model is causal, so the
# padding after a sequence changes none of its logits
PAD = 127


def _jax_logits(jm, ids):
    arr = np.zeros((1, PAD), np.int64)
    arr[0, :len(ids)] = ids
    return np.asarray(jm(Tensor(jnp.asarray(arr))).value,
                      np.float32)[0, :len(ids)]


def _near_tie(jm, pm, ids, kv_dtype):
    """The JAX model's top-2 gap after ``ids`` and its rounding limit:
    twice the largest difference from the port's no-cache logits, plus
    two units of the top one (fp16's, or the int8 codes')."""
    jl = _jax_logits(jm, ids)[-1]
    with torch.no_grad():
        pl = pm(torch.tensor([ids])).float().numpy()[0, -1]
    top = np.sort(jl)[::-1]
    limit = 2 * float(np.abs(jl - pl).max()) + NEAR_TIE[kv_dtype] * abs(
        top[0])
    return float(top[0] - top[1]), limit


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_fp16_greedy_tokens_match_jax_up_to_rounding(models, kv_dtype,
                                                     monkeypatch):
    jm, pm = models
    assert pm.kv_cache_spec()["dtype"] == torch.float16
    if kv_dtype is not None:
        _read_jax_positions_from_t(monkeypatch)
    want = _serve(JaxEngine, JaxRequest, jm, kv_dtype)
    eng = ServingEngine(pm, max_batch_slots=2, max_len=128, block_size=16,
                        kv_dtype=kv_dtype, device="cpu")
    assert eng.engine.pool_dtype == (torch.int8 if kv_dtype
                                     else torch.float16)
    got = _serve(ServingEngine, Request, pm, kv_dtype, device="cpu")
    agree = total = 0
    for prompt, w, g in zip(PROMPTS, want, got):
        if w != g:
            step = next(i for i, (a, b) in enumerate(zip(w, g)) if a != b)
            gap, limit = _near_tie(jm, pm, prompt + w[:step], kv_dtype)
            assert gap <= limit, (prompt[:4], step, w, g, gap, limit)
        arg = _jax_logits(jm, prompt + g[:-1])[len(prompt) - 1:].argmax(-1)
        agree += int((arg == np.asarray(g)).sum())
        total += len(g)
    assert agree >= 0.9 * total, (agree, total)
