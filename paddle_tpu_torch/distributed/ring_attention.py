"""Ring attention over the ``sep`` ranks — the port of
``paddle_tpu/distributed/ring_attention.py`` (:40-163).

The sequence is cut into contiguous chunks over the ``sep`` axis: rank
``r`` of ``n`` holds positions ``r*S .. (r+1)*S - 1`` of q, k and v
(``(B, S, H, D)`` each, ``S`` the chunk). Q stays; K and V rotate
``n - 1`` times around the ring (``collective.ppermute``, ``i -> i+1``),
so each rank meets every chunk once. The body is flash per block, an
autograd Function (:class:`_Ring`):

- forward: K1 (``flash_fwd``) on each block the rank may see (causal:
  the diagonal block causal, earlier blocks whole, later ones skipped
  though they still pass through), the block results ``(O_i, lse_i)``
  merged by logsumexp in fp32. That is the reference's online softmax
  (its notes, :13-14) a block at a time;
- backward: K3a (``flash_bwd_fused``) per visible block with the MERGED
  lse and ``delta = rowsum(dO * O)``, which make each block's
  probabilities the global ones. dQ adds up locally; dK and dV add up in
  an fp32 buffer that travels with their block and takes one more step
  home after the last.

Each rank launches K1 and K3a once per visible block: ``n`` each, or
``r + 1`` on rank ``r`` when causal. On the CPU the same Function runs
the kernels' plain versions (the wrappers pick them by device).

:func:`sep_sharded_scope` marks the region whose activations are
sequence-cut over an axis: ``ShardedTrainer`` enters it around a step
when it cuts the batch's sequence over ``sep``, and there
``F.scaled_dot_product_attention`` runs this ring (the default) or
Ulysses (``ulysses.sequence_parallel_mode``), and the GPT and BERT
embeddings add the chunk's offset to their positions. The scope is
process-wide (the backward of a card's tensors runs on autograd's own
thread, so every Function here takes its group in the forward).
``sep_sharded_scope(None)`` marks a region where a ``sep`` axis is
bound but the sequence is whole on every rank.

:func:`ring_attention` takes local chunks where a mesh with the axis is
bound; :func:`ring_self_attention` takes the whole ``(B, S, H, D)``
arrays on every rank, runs the ring on this rank's chunk and returns the
whole output on every rank. Its gradient is whole on every rank too:
each rank's chunk of the cotangent, the ring's backward, then the chunk
gradients gathered. The reference's refusal of causal masking with
unequal q and kv lengths (:85-89) stays.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import List, Optional

import torch

from paddle_tpu_torch.distributed import collective as _coll
from paddle_tpu_torch.distributed import env as _env
from paddle_tpu_torch.ops.kernels.flash_attention import (flash_bwd_fused,
                                                          flash_fwd)

__all__ = ["ring_attention", "ring_self_attention", "SEP_AXIS",
           "sep_sharded_scope", "get_sep_sharded_scope"]

SEP_AXIS = "sep"

# the entered scopes, innermost last: (mesh, axis), or None where the
# sequence is whole
_SCOPES: List = []


def get_sep_sharded_scope():
    """(mesh, axis) of the active sequence-cut region, or None."""
    return _SCOPES[-1] if _SCOPES else None


@contextmanager
def sep_sharded_scope(mesh, axis: str = SEP_AXIS):
    """Mark a region whose activations are sequence-cut over ``axis`` of
    ``mesh`` (``mesh=None``: whole sequences although the axis exists).
    Process-wide; read in the forward."""
    _SCOPES.append((mesh, axis) if mesh is not None else None)
    try:
        yield
    finally:
        _SCOPES.pop()


def _sep_position_offset(length: int) -> int:
    """The first global position of this rank's chunk of ``length``
    positions in the active scope (0 outside one)."""
    ctx = get_sep_sharded_scope()
    if ctx is None:
        return 0
    mesh, axis = ctx
    return mesh.index(axis) * length


def _comm_of(axis: str):
    """(mesh, degree, index) of ``axis`` on the bound mesh; raises where
    no bound mesh has it."""
    mesh = _env._bound_mesh()
    if mesh is None or axis not in mesh.axis_names:
        raise ValueError(
            f"ring/Ulysses attention must run where the {axis!r} axis is "
            "bound (ShardedTrainer binds its mesh); use the "
            "*_self_attention wrappers with a mesh otherwise")
    return mesh, mesh.degree(axis), mesh.index(axis)


def _rotate(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` of the previous rank on ``axis`` (ring ``i -> i+1``)."""
    n = mesh.degree(axis)
    with _env._mesh_scope(mesh):
        return _coll.ppermute(x.contiguous(),
                              [(i, (i + 1) % n) for i in range(n)], axis)


def _merge(o, lse, o_i, lse_i):
    """Two normalised partial attentions combined by their logsumexps:
    ``o`` fp32 (B, S, H, D), ``lse`` fp32 (B, H, S)."""
    if o is None:
        return o_i.float(), lse_i
    new = torch.logaddexp(lse, lse_i)
    a = torch.exp(lse - new).transpose(1, 2).unsqueeze(-1)
    b = torch.exp(lse_i - new).transpose(1, 2).unsqueeze(-1)
    return o * a + o_i.float() * b, new


class _Ring(torch.autograd.Function):
    """Ring attention on this rank's chunks (see the module's notes)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis: str, scale: float, causal: bool):
        n, r = mesh.degree(axis), mesh.index(axis)
        o = lse = None
        kv = torch.stack([k, v])
        for t in range(n):
            if t:
                kv = _rotate(kv, mesh, axis)
            src = (r - t) % n
            if causal and src > r:
                continue
            o_i, lse_i = flash_fwd(q, kv[0], kv[1], scale,
                                   causal and src == r)
            o, lse = _merge(o, lse, o_i, lse_i)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.axis, ctx.scale, ctx.causal = mesh, axis, scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        n, r = mesh.degree(axis), mesh.index(axis)
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros((2, *k.shape), dtype=torch.float32,
                          device=k.device)
        for t in range(n):
            if t:
                kv = _rotate(kv, mesh, axis)
                dkv = _rotate(dkv, mesh, axis)
            src = (r - t) % n
            if ctx.causal and src > r:
                continue
            dq_i, dk_i, dv_i = flash_bwd_fused(
                q, kv[0], kv[1], do, lse, delta, ctx.scale,
                ctx.causal and src == r)
            dq += dq_i.float()
            dkv[0] += dk_i.float()
            dkv[1] += dv_i.float()
        if n > 1:
            dkv = _rotate(dkv, mesh, axis)     # each block home
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def ring_attention(q, k, v, *, axis: str = SEP_AXIS,
                   is_causal: bool = False, scale: Optional[float] = None):
    """Ring attention on this rank's sequence chunks ``(B, S/n, H, D)``;
    must run where ``axis`` is bound (raises otherwise)."""
    if is_causal and q.shape[1] != k.shape[1]:
        raise NotImplementedError(
            "ring attention: causal masking requires equal per-chunk q/kv "
            "lengths (global positions are computed with the chunk stride); "
            "decode-style causal cross-attention is not ring-lowered")
    mesh, _, _ = _comm_of(axis)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Ring.apply(q, k, v, mesh, axis, float(scale), bool(is_causal))


class _SeqShard(torch.autograd.Function):
    """This rank's chunk of dim 1 of a tensor every rank holds whole;
    the backward gathers the chunks' gradients, the whole gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis: str):
        n, r = mesh.degree(axis), mesh.index(axis)
        ctx.mesh, ctx.axis = mesh, axis
        return x.chunk(n, dim=1)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.mesh, ctx.axis), None, None


class _SeqGather(torch.autograd.Function):
    """Every rank's chunk gathered on dim 1, for a consumer every rank
    runs alike (the same loss on every rank): the backward keeps this
    rank's chunk of the gradient, not a sum over ranks, which would
    count that consumer once per rank."""

    @staticmethod
    def forward(ctx, x, mesh, axis: str):
        ctx.mesh, ctx.axis = mesh, axis
        return _gather_seq(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        n, r = ctx.mesh.degree(ctx.axis), ctx.mesh.index(ctx.axis)
        return g.chunk(n, dim=1)[r].contiguous(), None, None


class _SeqGatherSum(torch.autograd.Function):
    """Every rank's chunk gathered on dim 1, for a consumer each rank
    runs on its own part (local attention over the whole sequence): the
    backward sums the ranks' gradients and keeps this rank's chunk."""

    @staticmethod
    def forward(ctx, x, mesh, axis: str):
        ctx.mesh, ctx.axis = mesh, axis
        return _gather_seq(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        with _env._mesh_scope(ctx.mesh):
            out = _coll.reduce_scatter(g.contiguous(), axis_name=ctx.axis,
                                       scatter_dim=1)
        return out, None, None


def _gather_seq(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    with _env._mesh_scope(mesh):
        parts: List[torch.Tensor] = []
        _coll.all_gather(parts, x.contiguous(), axis_name=axis)
    return torch.cat(parts, dim=1)


def _sep_gather(x: torch.Tensor, mesh, axis: str = SEP_AXIS) -> torch.Tensor:
    """The whole sequence (dim 1) of ``x`` on every rank, for a consumer
    every rank runs alike (:class:`_SeqGather`)."""
    return _SeqGather.apply(x, mesh, axis)


def ring_self_attention(q, k, v, mesh, *, axis: str = SEP_AXIS,
                        is_causal: bool = False,
                        scale: Optional[float] = None):
    """The whole ``(B, S, H, D)`` q, k and v on every rank: the ring on
    this rank's chunk over ``axis`` of ``mesh``, the whole output on
    every rank."""
    with _env._mesh_scope(mesh):
        out = ring_attention(*(_SeqShard.apply(t, mesh, axis)
                               for t in (q, k, v)),
                             axis=axis, is_causal=is_causal, scale=scale)
    return _SeqGather.apply(out, mesh, axis)
