"""Ulysses all-to-all sequence parallelism over the ``sep`` ranks — the
port of ``paddle_tpu/distributed/ulysses.py`` (:47-125).

Activations arrive sequence-cut, ``(B, S/n, H, D)`` on each of the
``n`` ranks. One all-to-all re-cuts heads for sequence, so each rank
holds the WHOLE sequence for ``H/n`` heads; the port's local attention
runs unchanged (``nn.functional.attention._local_attention``: the flash
gate, so K1 forward and K3a backward where the JAX package takes flash);
a second all-to-all restores the sequence cut. The all-to-all is an
autograd Function (:class:`_AllToAll`) whose backward is the inverse
all-to-all, taking its group in the forward. Causal masking needs no
position bookkeeping: each rank sees the whole sequence. The head count
must divide by the axis size.

:func:`sequence_parallel_mode` picks the schedule
``F.scaled_dot_product_attention`` runs in a sequence-cut region:
``"ring"`` (the default) or ``"ulysses"``; process-wide, as
``ring_attention.sep_sharded_scope`` is, because the card's autograd runs
the backward (and so a checkpoint's replay of the forward) on its own
device thread, which must see the schedule the forward took.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import List, Optional

import torch

from paddle_tpu_torch.distributed import collective as _coll
from paddle_tpu_torch.distributed import env as _env
from paddle_tpu_torch.distributed.ring_attention import (SEP_AXIS, _comm_of,
                                                         _SeqGather,
                                                         _SeqShard)

__all__ = ["ulysses_attention", "ulysses_self_attention",
           "sequence_parallel_mode", "get_sequence_parallel_mode"]

_MODES = ("ring", "ulysses")
_MODE_STACK: List[str] = []


def get_sequence_parallel_mode() -> str:
    """The schedule attention takes in a sequence-cut region."""
    return _MODE_STACK[-1] if _MODE_STACK else "ring"


@contextmanager
def sequence_parallel_mode(mode: str):
    """Select the sequence-parallel attention schedule ("ring" |
    "ulysses") for calls made inside the context."""
    if mode not in _MODES:
        raise ValueError(
            f"sequence_parallel_mode: unknown mode {mode!r}; one of {_MODES}")
    _MODE_STACK.append(mode)
    try:
        yield
    finally:
        _MODE_STACK.pop()


class _AllToAll(torch.autograd.Function):
    """``split_axis`` cut over the axis's ranks, the received chunks
    joined on ``concat_axis``; the backward is the inverse."""

    @staticmethod
    def forward(ctx, x, mesh, axis: str, split_axis: int, concat_axis: int):
        ctx.args = (mesh, axis, concat_axis, split_axis)
        with _env._mesh_scope(mesh):
            return _coll.alltoall(x.contiguous(), axis_name=axis,
                                  split_axis=split_axis,
                                  concat_axis=concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        with _env._mesh_scope(mesh):
            out = _coll.alltoall(g.contiguous(), axis_name=axis,
                                 split_axis=split_axis,
                                 concat_axis=concat_axis)
        return out, None, None, None, None


def ulysses_attention(q, k, v, *, axis: str = SEP_AXIS,
                      is_causal: bool = False,
                      scale: Optional[float] = None,
                      try_pallas: bool = True):
    """All-to-all attention on this rank's sequence chunks ``(B, S/n, H,
    D)``; must run where ``axis`` is bound. ``try_pallas=False`` keeps
    the local attention on the plain path."""
    mesh, n, _ = _comm_of(axis)
    heads = q.shape[2]
    if heads % n:
        raise ValueError(
            f"ulysses attention: num_heads ({heads}) must be divisible by "
            f"the '{axis}' axis size ({n}); use ring attention otherwise")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    from paddle_tpu_torch.nn.functional.attention import (_local_attention,
                                                          _sdpa)

    def seq_to_heads(x):      # (B, S/n, H, D) -> (B, S, H/n, D)
        return x if n == 1 else _AllToAll.apply(x, mesh, axis, 2, 1)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if try_pallas:
        out = _local_attention(qh, kh, vh, None, 0.0, is_causal,
                               float(scale))
    else:
        out = _sdpa(qh, kh, vh, is_causal=is_causal, scale=float(scale))
    if n == 1:
        return out
    return _AllToAll.apply(out, mesh, axis, 1, 2)


def ulysses_self_attention(q, k, v, mesh, *, axis: str = SEP_AXIS,
                           is_causal: bool = False,
                           scale: Optional[float] = None,
                           try_pallas: bool = True):
    """The whole ``(B, S, H, D)`` q, k and v on every rank: Ulysses on
    this rank's chunk over ``axis`` of ``mesh``, the whole output (and
    gradients) on every rank."""
    with _env._mesh_scope(mesh):
        out = ulysses_attention(*(_SeqShard.apply(t, mesh, axis)
                                  for t in (q, k, v)),
                                axis=axis, is_causal=is_causal, scale=scale,
                                try_pallas=try_pallas)
    return _SeqGather.apply(out, mesh, axis)
