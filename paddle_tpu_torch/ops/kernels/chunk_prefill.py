"""K5: chunk-prefill attention — CUDA kernel, plain version, counter.

Replaces ``paddle_tpu/ops/pallas/chunk_prefill.py`` (``_chunk_kernel``
via ``chunk_prefill_pallas``), full-precision pools. The kernel is
``paddle_tpu_torch/csrc/chunk_prefill.cu``; its header note says what
bounds it on the H100 and how the design answers that.

:func:`chunk_prefill` is the wrapper: a CPU tensor takes
:func:`chunk_prefill_ref`, which DELEGATES to the K4 plain version
exactly as ``chunk_prefill_xla`` delegates to ``paged_attention_xla`` —
row i of the chunk attends ``cols <= start + i``. A CUDA tensor launches
the kernel or raises. ``launches`` counts kernel launches and nothing
else.

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
    _DTYPES, broadcast_offsets, check_paged_args, paged_attention_ref)

__all__ = ["chunk_prefill", "chunk_prefill_ref", "pick_qbs", "launches",
           "reset_launches", "MAX_QBS"]

launches = 0

# q-block cap: a 64-row q tile and the 64-row logit tile fit one CTA's
# shared memory, and 64*D/256 fp32 accumulators per thread its
# registers; larger q-blocks would need the tensor-core rewrite
MAX_QBS = 64


def reset_launches():
    global launches
    launches = 0


def pick_qbs(s: int) -> int:
    """``_pick_qbs`` of ``chunk_prefill.py:159`` capped at
    :data:`MAX_QBS`: the largest power of two up to 128 dividing the
    chunk length, else 1 — so non-power-of-two chunks still run."""
    for c in (128, 64, 32, 16, 8, 4, 2):
        if s % c == 0:
            return min(c, s, MAX_QBS)
    return 1


def chunk_prefill_ref(q, k_pool, v_pool, table, start,
                      scale: Optional[float] = None):
    """Plain chunk-prefill attention: the K4 plain version at a scalar
    (or per-slot) start offset."""
    return paged_attention_ref(q, k_pool, v_pool, table, start, scale)


def chunk_prefill(q, k_pool, v_pool, table, start,
                  scale: Optional[float] = None):
    """Chunk-prefill attention over ``(b, s, H, D)`` chunk queries at a
    scalar (or per-slot) start offset."""
    if q.device.type == "cpu":
        return chunk_prefill_ref(q, k_pool, v_pool, table, start, scale)
    if q.device.type != "cuda":
        raise ValueError(f"chunk_prefill: unsupported device {q.device}")
    check_paged_args("chunk_prefill", q, k_pool, v_pool, table)
    b, s, h, d = q.shape
    qbs = pick_qbs(s)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tv = broadcast_offsets(start, b, q.device)
    out = torch.empty_like(q)
    lib = _build.load_library()
    err = lib.ptt_chunk_prefill_fwd(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), tv.data_ptr(), out.data_ptr(), b, s, qbs, h, d,
        k_pool.shape[1], table.shape[1], float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "chunk_prefill kernel")
    global launches
    launches += 1
    return out
