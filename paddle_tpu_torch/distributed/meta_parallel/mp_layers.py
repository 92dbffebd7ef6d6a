"""Tensor-parallel layers — the port of
``paddle_tpu/distributed/meta_parallel/mp_layers.py`` (:48-283).

Two modes, picked per call as the reference picks them:

- **dense** (no mesh bound, or one without the layer's axis): the layer
  holds the whole weight and runs the plain math, as the reference's
  GSPMD mode computes the global result;
- **explicit** (inside a mesh bound by ``env._mesh_scope`` with the
  layer's axis, ``axis_in_scope``): the weight is this rank's shard
  (``ShardedTrainer`` slices every parameter by its ``dist_spec``), and
  the layer runs the reference's collectives over the axis's process
  group: ``mp_identity`` (identity forward, all-reduce of the gradient)
  where a replicated activation enters sharded compute, ``mp_allreduce``
  (all-reduce forward, identity backward) where partial sums leave it,
  and an all-gather of the last dim for ``gather_output``.

Each parameter carries the reference's ``dist_spec``, a tuple with one
mesh axis (or None) per dim: ``ColumnParallelLinear``'s weight
``(None, "mp")`` and bias ``("mp",)``, ``RowParallelLinear``'s weight
``("mp", None)`` (its bias replicated, added once after the
reduction), ``VocabParallelEmbedding``'s table ``("mp", None)``.
Weights keep paddle's (in, out) layout. ``weight_attr`` takes a
``ParamAttr``, an initializer or a name, as ``nn.Linear``'s does;
``mp_group`` is accepted at its default only (the layers use the
``"mp"`` axis), ``fuse_matmul_bias`` at every value (one ``F.linear``
either way), and ``name`` is accepted and, as in the reference, not
read.

``ParallelCrossEntropy`` over vocab-sharded logits: the max and the sum
of exponentials are all-reduced over the axis (the max as a constant,
as the reference stops its gradient), the true label's logit is taken
by the rank that owns it and all-reduced, and rows at ``ignore_index``
give 0. It returns the per-row loss with a trailing unit axis.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.unported import refuse_unported
from paddle_tpu_torch.distributed import env as _env
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.common import Linear

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "axis_in_scope", "mp_identity", "mp_allreduce", "MP_AXIS"]

MP_AXIS = "mp"


def _pg(axis: str):
    """(process group, size, index) of this rank on ``axis`` of the bound
    mesh."""
    mesh = _env._bound_mesh()
    return mesh.group(axis), mesh.degree(axis), mesh.index(axis)


def _all_reduce(t, pg, n, op=torch.distributed.ReduceOp.SUM):
    if n > 1:
        torch.distributed.all_reduce(t, op=op, group=pg)
    return t


class _MpIdentity(torch.autograd.Function):
    """The reference's ``_c_identity``: identity forward, all-reduce of
    the gradient over the axis (its group taken in the forward: the
    backward of a card's tensors runs on autograd's own thread)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.pg, ctx.n, _ = _pg(axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.pg, ctx.n), None


class _MpAllreduce(torch.autograd.Function):
    """The reference's ``_mp_allreduce``: all-reduce forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, axis):
        pg, n, _ = _pg(axis)
        return _all_reduce(x.contiguous().clone(), pg, n)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """All-gather of the last dim over the axis; the backward keeps this
    rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, axis):
        pg, n, i = _pg(axis)
        ctx.n, ctx.i = n, i
        if n == 1:
            return x.view_as(x)
        parts = [torch.empty_like(x) for _ in range(n)]
        torch.distributed.all_gather(parts, x.contiguous(), group=pg)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=-1)[ctx.i].contiguous(), None


def axis_in_scope(name: str) -> bool:
    """True iff a bound mesh has an axis called ``name``."""
    mesh = _env._bound_mesh()
    return mesh is not None and name in mesh.axis_names


def mp_identity(x, axis: str = MP_AXIS):
    """Identity forward, all-reduce of the gradient over ``axis`` (the
    identity outside a mesh that spans it)."""
    if not axis_in_scope(axis) or _pg(axis)[1] == 1:
        return x
    return _MpIdentity.apply(x, axis)


def mp_allreduce(x, axis: str = MP_AXIS):
    """All-reduce forward over ``axis``, identity backward (the identity
    outside a mesh that spans it)."""
    if not axis_in_scope(axis) or _pg(axis)[1] == 1:
        return x
    return _MpAllreduce.apply(x, axis)


def _gather_last(x, axis: str = MP_AXIS):
    if not axis_in_scope(axis) or _pg(axis)[1] == 1:
        return x
    return _GatherLast.apply(x, axis)


class _ParallelLinear(Linear):
    _op_name: str   # the op name AMP decides by

    def __init__(self, in_features: int, out_features: int, weight_attr,
                 has_bias: bool, mp_group, name, device, dtype):
        refuse_unported(type(self).__name__, mp_group=(mp_group, None))
        super().__init__(in_features, out_features, weight_attr,
                         bias_attr=None if has_bias else False,
                         device=device, dtype=dtype)
        self._axis = MP_AXIS


class ColumnParallelLinear(_ParallelLinear):
    """Weight (in, out) split along the OUT columns over ``mp``; the
    output is gathered back whole when ``gather_output``, else left as
    this rank's columns."""
    _op_name = "column_parallel_linear"

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = True,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         mp_group, name, device, dtype)
        self.gather_output = gather_output
        self.weight.dist_spec = (None, self._axis)
        self.weight.is_distributed = True
        if self.bias is not None:
            self.bias.dist_spec = (self._axis,)
            self.bias.is_distributed = True

    def forward(self, x):
        if not axis_in_scope(self._axis):
            return F.linear(x, self.weight, self.bias, op_name=self._op_name)
        out = F.linear(mp_identity(x, self._axis), self.weight, self.bias,
                       op_name=self._op_name)
        return _gather_last(out, self._axis) if self.gather_output else out


class RowParallelLinear(_ParallelLinear):
    """Weight (in, out) split along the IN rows over ``mp``: each rank's
    partial product is all-reduced, then the (replicated) bias added.
    Unless ``input_is_parallel``, a whole input is first cut to this
    rank's columns."""
    _op_name = "row_parallel_linear"

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         mp_group, name, device, dtype)
        self.input_is_parallel = input_is_parallel
        self.weight.dist_spec = (self._axis, None)
        self.weight.is_distributed = True

    def forward(self, x):
        if not axis_in_scope(self._axis):
            return F.linear(x, self.weight, self.bias, op_name=self._op_name)
        if not self.input_is_parallel:
            _, n, i = _pg(self._axis)
            x = mp_identity(x, self._axis).chunk(n, dim=-1)[i]
        out = mp_allreduce(F.linear(x, self.weight, None,
                                    op_name=self._op_name), self._axis)
        return out if self.bias is None else out + self.bias


class VocabParallelEmbedding(Layer):
    """Embedding table (vocab, hidden), drawn XavierUniform as the
    reference's (``mp_layers.py:211``), its rows split over ``mp``: each
    rank looks up the ids it owns, zeros elsewhere, and the lookups are
    all-reduced."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        refuse_unported("VocabParallelEmbedding", mp_group=(mp_group, None))
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self._axis = MP_AXIS
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr, dtype=dtype,
            default_initializer=I.XavierUniform(), device=device)
        self.weight.dist_spec = (self._axis, None)
        self.weight.is_distributed = True

    def forward(self, x):
        if not axis_in_scope(self._axis):
            return F.embedding(x, self.weight)
        _, n, i = _pg(self._axis)
        per = self.weight.shape[0]
        local = x.long() - i * per
        in_range = (local >= 0) & (local < per)
        out = F.embedding(torch.where(in_range, local, 0), self.weight)
        out = out * in_range.unsqueeze(-1).to(out.dtype)
        return mp_allreduce(out, self._axis)


class ParallelCrossEntropy(Layer):
    """Softmax cross entropy of logits against labels, the logits' last
    (vocab) dim split over ``mp`` inside a mesh."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        refuse_unported("ParallelCrossEntropy", mp_group=(mp_group, None))
        self._axis = MP_AXIS
        self.ignore_index = ignore_index

    def forward(self, input, label):
        lbl = label.squeeze(-1) if label.dim() == input.dim() else label
        lbl = lbl.long()
        if axis_in_scope(self._axis):
            pg, n, i = _pg(self._axis)
            per = input.shape[-1]
            gmax = _all_reduce(input.detach().amax(dim=-1).contiguous(),
                               pg, n, torch.distributed.ReduceOp.MAX)
            shifted = input - gmax.unsqueeze(-1)
            sumexp = mp_allreduce(shifted.exp().sum(dim=-1), self._axis)
            local = lbl - i * per
            in_range = (local >= 0) & (local < per)
            picked = shifted.gather(
                -1, torch.where(in_range, local, 0).unsqueeze(-1))[..., 0]
            picked = mp_allreduce(torch.where(in_range, picked, 0.0),
                                  self._axis)
            loss = torch.log(sumexp) - picked
        else:
            logp = torch.log_softmax(input, dim=-1)
            loss = -logp.gather(-1, lbl.clamp(min=0).unsqueeze(-1))[..., 0]
        loss = torch.where(lbl != self.ignore_index, loss, 0.0)
        return loss.unsqueeze(-1)
