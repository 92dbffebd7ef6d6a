"""K5: chunk-prefill attention — CUDA kernel, plain version, counter.

Replaces ``paddle_tpu/ops/pallas/chunk_prefill.py`` (``_chunk_kernel``
via ``chunk_prefill_pallas``) in both of its branches: full-precision
pools, and int8 code pools with ``(num_blocks, H)`` fp32 scales
(``chunk_prefill.py:126-128``). The kernel is
``paddle_tpu_torch/csrc/chunk_prefill.cu``; its header note says what
bounds it on the H100 and how the design answers that. bf16 or fp16 q
runs its tensor-core body (``mma.sync``; one source instantiated on both
types) in 64-row tiles of the chunk, over pools of q's dtype or int8
pools; fp32 q runs K4's fp32 body on the CUDA cores in row
tiles of its own (16, 32 or 64 rows by the chunk's length), each tile's
key walk split across a thread-block cluster. A pointer or row that
``cp.async`` cannot take (16 bytes) is refused by the C entry, and the
wrapper raises.

:func:`chunk_prefill` is the wrapper: a CPU tensor takes
:func:`chunk_prefill_ref`, which DELEGATES to the K4 plain version
exactly as ``chunk_prefill_xla`` delegates to ``paged_attention_xla`` —
row i of the chunk attends ``cols <= start + i``. A CUDA tensor launches
the kernel or raises. ``launches`` counts launches over full-precision
pools, ``launches_q`` over int8 pools, and nothing else.

The kernel keeps the row-independence contract of
``chunk_prefill.py:30-43``: no state crosses query rows, masking uses
absolute positions, and only rows committed before the launch are read.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels.paged_attention import (
    _DTYPES, _INT8, broadcast_offsets, check_paged_args,
    paged_attention_ref, scale_ptrs)

__all__ = ["chunk_prefill", "chunk_prefill_ref", "pick_qbs", "launches",
           "launches_q", "reset_launches", "MAX_QBS"]

launches = 0      # launches over full-precision pools
launches_q = 0    # launches over int8 code pools

# q-block cap of pick_qbs: the q-block is the reference's tiling, which
# the C entry checks (qbs <= 64, dividing s) but neither body follows:
# both tile the chunk by rows of their own (fp32 16, 32 or 64 by s, bf16
# 64), since the rows are independent (chunk_prefill.py:30-43)
MAX_QBS = 64


def reset_launches():
    global launches, launches_q
    launches = launches_q = 0


def pick_qbs(s: int) -> int:
    """``_pick_qbs`` of ``chunk_prefill.py:159`` capped at
    :data:`MAX_QBS`: the largest power of two up to 128 dividing the
    chunk length, else 1 — so non-power-of-two chunks still run."""
    for c in (128, 64, 32, 16, 8, 4, 2):
        if s % c == 0:
            return min(c, s, MAX_QBS)
    return 1


def chunk_prefill_ref(q, k_pool, v_pool, table, start,
                      scale: Optional[float] = None, k_scale=None,
                      v_scale=None):
    """Plain chunk-prefill attention: the K4 plain version at a scalar
    (or per-slot) start offset."""
    return paged_attention_ref(q, k_pool, v_pool, table, start, scale,
                               k_scale, v_scale)


def chunk_prefill(q, k_pool, v_pool, table, start,
                  scale: Optional[float] = None, k_scale=None,
                  v_scale=None):
    """Chunk-prefill attention over ``(b, s, H, D)`` chunk queries at a
    scalar (or per-slot) start offset; int8 pools come with their
    ``(num_blocks, H)`` fp32 scales."""
    if q.device.type == "cpu":
        return chunk_prefill_ref(q, k_pool, v_pool, table, start, scale,
                                 k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"chunk_prefill: unsupported device {q.device}")
    pool = check_paged_args("chunk_prefill", q, k_pool, v_pool, table,
                            k_scale, v_scale)
    b, s, h, d = q.shape
    qbs = pick_qbs(s)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tv = broadcast_offsets(start, b, q.device)
    out = torch.empty_like(q)
    lib = _build.load_library()
    err = lib.ptt_chunk_prefill_fwd(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        *scale_ptrs(k_scale, v_scale), table.data_ptr(), tv.data_ptr(),
        out.data_ptr(), b, s, qbs, h, d, k_pool.shape[1], table.shape[1],
        float(scale), _DTYPES[q.dtype], pool,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "chunk_prefill kernel")
    global launches, launches_q
    if pool == _INT8:
        launches_q += 1
    else:
        launches += 1
    return out
