"""Pipeline parallelism over the ``pp`` ranks (GPipe) — the port of
``paddle_tpu/distributed/pipeline.py`` (:54-311).

The reference runs the whole pipeline as one SPMD program (a
``lax.scan`` with ``lax.ppermute`` inside ``shard_map``). The port is
one process a rank, so the schedule is driven by each rank's host:

- :class:`PipelineParallel` segments a :class:`PipelineLayer` (or a
  layer list) into ``num_stages`` structurally identical stages and
  re-owns their parameters as stacked ``(num_stages, ...)`` parameters
  named ``name.replace(".", "__")`` with ``dist_spec ("pp", *orig)``, as
  the reference does (:157-207): ``ShardedTrainer`` cuts the stacked dim
  over ``pp``, so each rank holds its own stage, and checkpoints keep
  the reference's names and bounds;
- :func:`gpipe_spmd` is GPipe over the ranks of the ``pp`` axis: every
  microbatch forward, each stage sending its activation to the next
  (the first stage takes the batch), then every microbatch backward in
  reverse order, each stage sending the input's cotangent to the
  previous one. The stages keep the graphs of their ``M`` microbatches
  between the two passes (GPipe's activation memory, O(M)). The last
  stage's output is broadcast over ``pp``, so every rank returns it
  (the reference's replicated ``out_specs``), and the backward takes
  the last stage's cotangent of it: every rank computes the same loss
  from it, so a sum would count it once per rank. The cotangent of the
  input is broadcast from the first stage, so layers outside the
  pipeline (replicated over ``pp``) get the same gradient on every
  rank.
- ``forward`` with no ``pp`` mesh attached (or one not bound) runs the
  stages in order on this rank: the sequential fallback.

Point-to-point messages go through :func:`_exchange`: one
``batch_isend_irecv`` over the ``pp`` group, staged through host copies
on the gloo backend (its send and recv refuse CUDA tensors:
``collective.py``). Every message travels in the input's dtype.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from paddle_tpu_torch.distributed import env as _env
from paddle_tpu_torch.distributed.meta_parallel.parallel_layers import \
    PipelineLayer
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.container import LayerList

__all__ = ["PipelineParallel", "gpipe_spmd"]


def _exchange(mesh, axis: str, sends, recvs) -> List[torch.Tensor]:
    """One round of point-to-point messages over ``axis`` of ``mesh``.

    ``sends``: ``(dst, tensor, tag)``; ``recvs``: ``(src, like, tag)``
    with ``like`` a tensor whose shape, dtype and device the message
    takes (``dst`` and ``src`` are indices on the axis). Every rank
    issues its sends and receives in the same order, so two messages
    between one pair are matched by tag on gloo and by order on NCCL.
    Returns the received tensors, in ``recvs``' order."""
    pg = mesh.group(axis)
    ranks = mesh.group_ranks(axis)
    dev = (sends or recvs)[0][1].device
    staged = dev.type != "cpu" and dist.get_backend(pg) == "gloo"
    ops, bufs = [], []
    for dst, t, tag in sends:
        buf = t.detach().to("cpu") if staged else t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, buf.contiguous(), ranks[dst],
                              group=pg, tag=tag))
    for src, like, tag in recvs:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device)
        ops.append(dist.P2POp(dist.irecv, buf, ranks[src], group=pg, tag=tag))
        bufs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(like.device) if staged else b
            for b, (_, like, _) in zip(bufs, recvs)]


def _broadcast(t: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """``t`` of the rank at index ``src`` on ``axis``, on every rank of
    the axis (in place; returned)."""
    pg = mesh.group(axis)
    dist.broadcast(t, src=mesh.group_ranks(axis)[src], group=pg)
    return t


class _GPipe(torch.autograd.Function):
    """GPipe over the ``pp`` ranks: ``forward`` runs the microbatches'
    forward with their graphs kept, ``backward`` their backward in
    reverse order (see the module's notes)."""

    @staticmethod
    def forward(ctx, run, x, *params):
        stage_apply, names, mesh, axis, S, M = run
        s = mesh.index(axis)
        xs = x.chunk(M)
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        inputs, outputs = [], []
        with torch.enable_grad():
            local = {n: l[0] for n, l in zip(names, leaves)}
            for m in range(M):
                if s == 0:
                    inp = xs[m].detach().requires_grad_(x.requires_grad)
                else:
                    inp, = _exchange(mesh, axis, [],
                                     [(s - 1, xs[m], 0)])
                    inp.requires_grad_(True)
                y = stage_apply(local, inp)
                if s < S - 1:
                    _exchange(mesh, axis, [(s + 1, y.to(x.dtype), 0)], [])
                inputs.append(inp)
                outputs.append(y)
        out = (torch.cat([y.detach().to(x.dtype) for y in outputs])
               if s == S - 1 else torch.empty_like(x))
        _broadcast(out, mesh, axis, S - 1)
        ctx.run, ctx.s = run, s
        ctx.leaves, ctx.inputs, ctx.outputs = leaves, inputs, outputs
        ctx.x_grad = x.requires_grad
        return out

    @staticmethod
    def backward(ctx, g):
        _, _, mesh, axis, S, M = ctx.run
        s = ctx.s
        gs = g.chunk(M)
        for m in reversed(range(M)):
            y, inp = ctx.outputs[m], ctx.inputs[m]
            if s == S - 1:
                cot = gs[m]
            else:
                cot, = _exchange(mesh, axis, [], [(s + 1, gs[m], 1)])
            torch.autograd.backward(y, cot.to(y.dtype))
            if s > 0:
                gin = inp.grad if inp.grad is not None \
                    else torch.zeros_like(inp)
                _exchange(mesh, axis, [(s - 1, gin.to(g.dtype), 1)], [])
        gx = None
        if ctx.x_grad:
            gx = (torch.cat([i.grad if i.grad is not None
                             else torch.zeros_like(i) for i in ctx.inputs])
                  if s == 0 else torch.empty_like(g))
            _broadcast(gx, mesh, axis, 0)
        grads = tuple(l.grad if l.requires_grad else None
                      for l in ctx.leaves)
        ctx.inputs = ctx.outputs = ctx.leaves = None
        return (None, gx, *grads)


def gpipe_spmd(stage_apply: Callable, stacked_params: Dict[str, torch.Tensor],
               x, *, mesh, num_stages: int, num_microbatches: int,
               axis: str = "pp"):
    """GPipe over ``axis`` of ``mesh``: ``stage_apply(params_one_stage,
    x_mb) -> y_mb`` on this rank's stage, ``stacked_params`` its local
    ``(1, ...)`` window of each stacked parameter, ``x`` the whole batch
    (every rank passes it; the first stage reads it). Returns the last
    stage's output, the batch dim restored, on every rank."""
    S, M = num_stages, num_microbatches
    if mesh.shape.get(axis, 1) != S:
        raise ValueError(
            f"num_stages={S} must equal the mesh '{axis}' axis size "
            f"{mesh.shape.get(axis, 1)} (stage s lives on {axis}-rank s)")
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"num_microbatches {M}")
    names = list(stacked_params)
    for n in names:
        if stacked_params[n].shape[0] != 1:
            raise ValueError(
                f"gpipe_spmd: {n} holds {stacked_params[n].shape[0]} stages "
                "on this rank; pass its local (1, ...) window")
    run = (stage_apply, names, mesh, axis, S, M)
    return _GPipe.apply(run, x, *[stacked_params[n] for n in names])


class _StageModule(Layer):
    """One pipeline stage: chains its sublayers."""

    def __init__(self, layers: Sequence):
        super().__init__()
        self.stage = LayerList([l for l in layers if isinstance(l, Layer)])
        object.__setattr__(self, "_all", list(layers))

    def forward(self, x):
        for fn in self._all:
            x = fn(x)
        return x


def _release(module: Layer):
    """Drop the storage of ``module``'s own parameters: they only give
    the structure a functional call substitutes values into."""
    with torch.no_grad():
        for p in module.parameters():
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)


class PipelineParallel(Layer):
    """Stage-stacked pipeline module (``fleet.meta_parallel.
    PipelineParallel``). ``forward`` is the GPipe schedule over the
    ``pp`` ranks when a mesh with ``pp`` above 1 is attached
    (``ShardedTrainer`` attaches its own) and bound (the trainer's
    step), else the sequential fallback on this rank."""

    def __init__(self, layers, num_stages: Optional[int] = None,
                 topology=None, mesh=None, num_microbatches: int = 1,
                 strategy=None, seg_method: str = "uniform", loss_fn=None):
        super().__init__()
        if strategy is not None:
            num_microbatches = max(
                num_microbatches, strategy.pipeline_configs.accumulate_steps)
        pipe = (layers if isinstance(layers, PipelineLayer)
                else PipelineLayer(layers, num_stages=num_stages,
                                   topology=topology, seg_method=seg_method,
                                   loss_fn=loss_fn))
        S = pipe.num_stages
        self.num_stages = S
        self.num_microbatches = num_microbatches
        self.loss_fn = pipe.loss_fn
        object.__setattr__(self, "_mesh", mesh)
        stage_modules = [_StageModule(pipe.get_stage_layers(s))
                         for s in range(S)]
        trees = [dict(m.named_parameters()) for m in stage_modules]
        ref_keys = list(trees[0])
        for s, t in enumerate(trees):
            if list(t) != ref_keys or any(
                    t[k].shape != trees[0][k].shape
                    or t[k].dtype != trees[0][k].dtype for k in ref_keys):
                raise ValueError(
                    f"pipeline stages must be structurally identical; stage "
                    f"{s} differs from stage 0. Keep heterogeneous layers "
                    "(embedding/head) outside the PipelineParallel body.")
            if dict(stage_modules[s].named_buffers()):
                raise NotImplementedError(
                    "buffered layers inside a pipeline body are not "
                    "supported yet")
        self._param_names = ref_keys
        self._stacked: Dict[str, torch.nn.Parameter] = {}
        for name in ref_keys:
            ref = trees[0][name]
            stacked = torch.nn.Parameter(
                torch.stack([trees[s][name].detach() for s in range(S)]),
                requires_grad=ref.requires_grad)
            orig = getattr(ref, "dist_spec", None)
            stacked.dist_spec = ("pp", *orig) if orig else ("pp",)
            for attr in ("optimize_attr", "regularizer", "need_clip"):
                if hasattr(ref, attr):
                    setattr(stacked, attr, getattr(ref, attr))
            self.register_parameter(name.replace(".", "__"), stacked)
            self._stacked[name] = stacked
        # the template runs any stage's math with its values substituted;
        # kept off the module tree, so its parameters are not registered
        object.__setattr__(self, "_template", stage_modules[0])
        _release(stage_modules[0])

    # -- execution ------------------------------------------------------------
    def _stage_apply(self, params_one_stage: Dict[str, torch.Tensor], x):
        return torch.func.functional_call(self._template, params_one_stage,
                                          (x,))

    def _pipelined_mesh(self):
        """The attached mesh when it has ``pp`` above 1 and is bound."""
        mesh = self._mesh
        if mesh is None or mesh.shape.get("pp", 1) <= 1:
            return None
        return mesh if _env._bound_mesh() is mesh else None

    def forward(self, x):
        names = self._param_names
        mesh = self._pipelined_mesh()
        if mesh is not None:
            return gpipe_spmd(self._stage_apply,
                              {n: self._stacked[n] for n in names}, x,
                              mesh=mesh, num_stages=self.num_stages,
                              num_microbatches=self.num_microbatches)
        for s in range(self.num_stages):
            x = self._stage_apply({n: self._stacked[n][s] for n in names}, x)
        return x

    def attach_mesh(self, mesh):
        object.__setattr__(self, "_mesh", mesh)

    # -- reference-API surface ------------------------------------------------
    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One optimizer step over the batch (``pipeline_parallel.py
        :152``): forward, ``loss_fn``, backward, step."""
        if self.loss_fn is None:
            raise ValueError("train_batch requires loss_fn")
        x, label = data
        loss = self.loss_fn(self.forward(torch.as_tensor(x)),
                            torch.as_tensor(label))
        optimizer.clear_grad()
        if scaler is not None:
            scaler.scale(loss).backward()
            scaler.step(optimizer)
            scaler.update()
        else:
            loss.backward()
            optimizer.step()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss
