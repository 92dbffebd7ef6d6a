"""K4: paged decode/verify attention — CUDA kernel, plain version, counter.

Replaces ``paddle_tpu/ops/pallas/paged_attention.py`` (``_paged_kernel``
via ``paged_attention_pallas``) in both of its branches: full-precision
pools, and int8 code pools dequantized by ``(num_blocks, H)`` fp32
absmax scales (``paged_attention.py:134-136``). The kernels are in
``paddle_tpu_torch/csrc/paged_attention.cu``, whose header note says what
bounds them on the H100 and how the designs answer that: bf16 q runs a
tensor-core body (``mma.sync``) whose key walk is split across a
thread-block cluster and merged through distributed shared memory, over
bf16 or int8 pools (C entry ``ptt_paged_decode_fwd``; a pointer or pool
row that ``cp.async`` cannot take, 16 bytes, is refused and the wrapper
raises); fp32 q runs the CUDA-core body that K5's fp32 q shares
(``ptt_paged_attention_fwd``), its key walk split across a cluster too,
whose C entry refuses pools or an output off 16 bytes.

:func:`paged_attention` is the wrapper: a CPU tensor takes
:func:`paged_attention_ref` — the counterpart of ``paged_attention_xla``,
which gathers each slot's logical view out of the pool through the
table (dequantizing int8 codes by their block's scale), masks
``cols <= t + i`` and runs the plain softmax attention — a CUDA tensor
launches the kernel or raises. ``launches`` counts launches over
full-precision pools, ``launches_q`` over int8 pools, and nothing else.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.nn.functional.attention import _sdpa
from paddle_tpu_torch.ops.kernels import _build

__all__ = ["paged_attention", "paged_attention_ref", "launches",
           "launches_q", "reset_launches", "check_paged_args",
           "broadcast_offsets"]

launches = 0      # launches over full-precision pools
launches_q = 0    # launches over int8 code pools

# type codes of csrc/common.cuh: q's (and a full-precision pool's), and
# the code of an int8 pool
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT8 = 2


def reset_launches():
    global launches, launches_q
    launches = launches_q = 0


def broadcast_offsets(t, b: int, device) -> torch.Tensor:
    """(b,) int32 offsets from a scalar or per-slot ``t`` (the scalar
    chunk-prefill offset broadcasts, as ``paged_attention.py:181``)."""
    t = torch.as_tensor(t, device=device).to(torch.int32).reshape(-1)
    return t.expand(b).contiguous()


def paged_attention_ref(q, k_pool, v_pool, table, t,
                        scale: Optional[float] = None, k_scale=None,
                        v_scale=None):
    """Plain PyTorch paged attention: gather every table row's blocks
    into a dense (b, bp*bs, H, D) view, mask ``cols <= t + i`` and run
    :func:`~paddle_tpu_torch.nn.functional.attention._sdpa`. With
    ``k_scale``/``v_scale`` the pools hold int8 codes: the gathered
    blocks become ``codes.float() * scale[table]``, cast to q's dtype
    (``paged_attention_xla``, ``paged_attention.py:81-86``)."""
    bs = k_pool.shape[1]
    b, s = q.shape[0], q.shape[1]
    tail = tuple(k_pool.shape[2:])
    rows = table.shape[1] * bs
    idx = table.long()
    kg, vg = k_pool[idx], v_pool[idx]            # (b, bp, bs, H, D)
    if k_scale is not None:
        kg = (kg.float() * k_scale[idx][:, :, None, :, None]).to(q.dtype)
        vg = (vg.float() * v_scale[idx][:, :, None, :, None]).to(q.dtype)
    k_view = kg.reshape((b, rows) + tail)
    v_view = vg.reshape((b, rows) + tail)
    cols = torch.arange(rows, device=q.device)[None, None, None, :]
    steps = torch.arange(s, device=q.device)[None, None, :, None]
    t = torch.as_tensor(t, device=q.device)
    if t.dim() == 0:
        mask = cols <= t + steps
    else:
        mask = cols <= t.reshape(-1, 1, 1, 1) + steps
    return _sdpa(q, k_view, v_view, attn_mask=mask, scale=scale)


def check_paged_args(what, q, k_pool, v_pool, table, k_scale=None,
                     v_scale=None):
    """Device, dtype, shape and contiguity checks shared by K4 and K5.
    Pools share q's dtype, or are int8 codes together with both fp32
    ``(num_blocks, H)`` scale tensors. The kernels' shared memory
    depends on the query rows and head_dim only (their key tiles are a
    fixed number of rows), so any block size fits. Returns the pools'
    type code."""
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
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    tensors = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
               ("table", table)]
    if k_pool.dtype == torch.int8 and v_pool.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError(f"{what}: int8 pools need both k_scale and "
                             "v_scale")
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if x.dtype != torch.float32 or \
                    tuple(x.shape) != (k_pool.shape[0], h):
                raise ValueError(
                    f"{what}: {name} must be float32 (num_blocks, H) = "
                    f"{(k_pool.shape[0], h)}, got {x.dtype} "
                    f"{tuple(x.shape)}")
            tensors.append((name, x))
        pool = _INT8
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{what}: pools must share q's dtype or be int8 "
                        f"codes with scales, got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    elif k_scale is not None or v_scale is not None:
        raise ValueError(f"{what}: scales are for int8 pools; the pools "
                         f"are {k_pool.dtype}")
    else:
        pool = _DTYPES[q.dtype]
    if table.dtype != torch.int32 or table.dim() != 2 or \
            table.shape[0] != b:
        raise ValueError(f"{what}: table must be int32 (b, blocks), got "
                         f"{table.dtype} {tuple(table.shape)}")
    for name, x in tensors:
        if x.device != q.device:
            raise ValueError(f"{what}: {name} is on {x.device}, q on "
                             f"{q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return pool


def scale_ptrs(k_scale, v_scale):
    """The scale tensors' pointers for the C entry points (null on the
    full-precision path)."""
    if k_scale is None:
        return None, None
    return k_scale.data_ptr(), v_scale.data_ptr()


def paged_attention(q, k_pool, v_pool, table, t,
                    scale: Optional[float] = None, k_scale=None,
                    v_scale=None):
    """Paged attention over (b, s, H, D) queries at per-slot offsets
    ``t`` ((b,) int32, or a scalar broadcast to every slot); int8 pools
    come with their ``(num_blocks, H)`` fp32 scales."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, table, t, scale,
                                   k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    pool = check_paged_args("paged_attention", q, k_pool, v_pool, table,
                            k_scale, v_scale)
    b, s, h, d = q.shape
    if not 1 <= s <= 16:
        raise ValueError(f"paged_attention: s={s} query rows per slot; the "
                         "kernel holds at most 16")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tv = broadcast_offsets(t, b, q.device)
    out = torch.empty_like(q)
    lib = _build.load_library()
    args = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            *scale_ptrs(k_scale, v_scale), table.data_ptr(), tv.data_ptr(),
            out.data_ptr(), b, s, h, d, k_pool.shape[1], table.shape[1],
            float(scale))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        err = lib.ptt_paged_decode_fwd(*args, pool, stream)
    else:
        err = lib.ptt_paged_attention_fwd(*args, _DTYPES[q.dtype], pool,
                                          stream)
    _build.check(err, "paged_attention kernel")
    global launches, launches_q
    if pool == _INT8:
        launches_q += 1
    else:
        launches += 1
    return out
