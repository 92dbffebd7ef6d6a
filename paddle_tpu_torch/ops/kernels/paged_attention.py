"""K4: paged decode/verify attention — CUDA kernel, plain version, counter.

Replaces ``paddle_tpu/ops/pallas/paged_attention.py`` (``_paged_kernel``
via ``paged_attention_pallas``), full-precision pools. The kernel is
``paddle_tpu_torch/csrc/paged_attention.cu``; its header note says what
bounds it on the H100 and how the design answers that.

:func:`paged_attention` is the wrapper: a CPU tensor takes
:func:`paged_attention_ref` — the counterpart of ``paged_attention_xla``,
which gathers each slot's logical view out of the pool through the
table, masks ``cols <= t + i`` and runs the plain softmax attention — a
CUDA tensor launches the kernel or raises. ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.nn.functional.attention import _sdpa
from paddle_tpu_torch.ops.kernels import _build

__all__ = ["paged_attention", "paged_attention_ref", "launches",
           "reset_launches", "check_paged_args", "broadcast_offsets"]

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    global launches
    launches = 0


def broadcast_offsets(t, b: int, device) -> torch.Tensor:
    """(b,) int32 offsets from a scalar or per-slot ``t`` (the scalar
    chunk-prefill offset broadcasts, as ``paged_attention.py:181``)."""
    t = torch.as_tensor(t, device=device).to(torch.int32).reshape(-1)
    return t.expand(b).contiguous()


def paged_attention_ref(q, k_pool, v_pool, table, t,
                        scale: Optional[float] = None):
    """Plain PyTorch paged attention: gather every table row's blocks
    into a dense (b, bp*bs, H, D) view, mask ``cols <= t + i`` and run
    :func:`~paddle_tpu_torch.nn.functional.attention._sdpa`."""
    bs = k_pool.shape[1]
    b, s = q.shape[0], q.shape[1]
    tail = tuple(k_pool.shape[2:])
    rows = table.shape[1] * bs
    idx = table.long()
    k_view = k_pool[idx].reshape((b, rows) + tail)
    v_view = v_pool[idx].reshape((b, rows) + tail)
    cols = torch.arange(rows, device=q.device)[None, None, None, :]
    steps = torch.arange(s, device=q.device)[None, None, :, None]
    t = torch.as_tensor(t, device=q.device)
    if t.dim() == 0:
        mask = cols <= t + steps
    else:
        mask = cols <= t.reshape(-1, 1, 1, 1) + steps
    return _sdpa(q, k_view, v_view, attn_mask=mask, scale=scale)


def check_paged_args(what, q, k_pool, v_pool, table):
    """Device, dtype, shape and contiguity checks shared by K4 and K5.
    The kernels' shared memory depends on the query rows and head_dim
    only (their key tiles are a fixed number of rows), so any block size
    fits."""
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"{what}: q must be (b, s, H, D) and the pools "
                         "(num_blocks, block_size, H, D)")
    b, s, h, d = q.shape
    if tuple(k_pool.shape) != tuple(v_pool.shape) or \
            tuple(k_pool.shape[2:]) != (h, d):
        raise ValueError(f"{what}: pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q heads "
                         f"{(h, d)}")
    if d not in (64, 128):
        raise ValueError(f"{what}: head_dim {d} not supported (64, 128)")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or \
            v_pool.dtype != q.dtype:
        raise TypeError(f"{what}: q and pools must share one dtype of "
                        f"float32/bfloat16, got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if table.dtype != torch.int32 or table.dim() != 2 or \
            table.shape[0] != b:
        raise ValueError(f"{what}: table must be int32 (b, blocks), got "
                         f"{table.dtype} {tuple(table.shape)}")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("table", table)):
        if x.device != q.device:
            raise ValueError(f"{what}: {name} is on {x.device}, q on "
                             f"{q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def paged_attention(q, k_pool, v_pool, table, t,
                    scale: Optional[float] = None):
    """Paged attention over (b, s, H, D) queries at per-slot offsets
    ``t`` ((b,) int32, or a scalar broadcast to every slot)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, table, t, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    check_paged_args("paged_attention", q, k_pool, v_pool, table)
    b, s, h, d = q.shape
    if not 1 <= s <= 16:
        raise ValueError(f"paged_attention: s={s} query rows per slot; the "
                         "kernel holds at most 16")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tv = broadcast_offsets(t, b, q.device)
    out = torch.empty_like(q)
    lib = _build.load_library()
    err = lib.ptt_paged_attention_fwd(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), tv.data_ptr(), out.data_ptr(), b, s, h, d,
        k_pool.shape[1], table.shape[1], float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention kernel")
    global launches
    launches += 1
    return out
