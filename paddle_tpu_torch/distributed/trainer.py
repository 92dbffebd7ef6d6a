"""Single-device trainer with the ``ShardedTrainer`` contract of
``paddle_tpu/distributed/trainer.py`` (:60-1070, one device).

``train_step(*batch)``: the last element of ``batch`` is the label when
a ``loss_fn`` is given (``loss_fn(model(*inputs), label)``); with
``loss_fn=None`` the model's own output is the loss (``GPTForCausalLM
(ids, labels)``'s fused head and cross entropy). The loss is reduced to
a mean in fp32. The batch first passes the ``trainer:batch`` fault point
(``testing/fault_injection.py``). One step runs the forward under
``auto_cast`` when ``amp`` is on, then the backward, then
``optimizer.step()`` and ``clear_grad()``. It returns the loss as a
0-dim tensor on the model's device without reading it back, so steps
queue on the card back to back. The optimizer's own options flow
through ``step()``: its ``grad_clip`` (on the raw gradients, before L2
decay), its learning-rate scheduler (read at each step; the user steps
it) and its ``multi_precision`` master weights.

``recompute=True`` (or ``strategy.recompute``) checkpoints the whole
loss closure through ``fleet.utils.recompute``. ``strategy=`` takes a
``DistributedStrategy``: ``amp`` and ``recompute`` as the constructor's
flags; ``gradient_merge`` with ``k_steps > 1`` adds each call's raw
gradients into fp32 accumulators, one per parameter, and every
``k_steps``-th call sets the merged gradient (scaled by ``1/k`` when
``avg``) and steps the optimizer (clip, decay, update) with the
learning rate read at that call; the step counter counts micro-steps.
``sharding`` is a no-op on one device, as in the reference (its
``sharding`` axis has one member), and so is ``moe``: the reference's
trainer never reads it, and a GPT-MoE model trains through its own
``loss_with_aux``. A ``Pipeline1F1B`` model with ``loss_fn=None`` trains
on its class's ``loss`` (else its own ``loss_fn``) over its sequential
forward.

Over a mesh of ranks (``mesh=``, a ``distributed.env.Mesh`` of more
than one rank from ``build_mesh`` or ``fleet.init``; every rank runs the
same script and builds the same whole model from the same seed): the
reference is one process driving a GSPMD mesh, the port one process a
rank, so the trainer does by hand what GSPMD does there.

- At construction each parameter is cut to this rank's window of its
  ``dist_spec`` (the tensor-parallel layers' ``mp`` entries), as the
  reference's ``device_put`` with a ``NamedSharding`` places it. ZeRO
  (``strategy.sharding`` with a ``sharding`` axis above 1) adds
  ``sharding`` to a parameter's spec as ``_extend_with_sharding`` does:
  on the largest free dim the degree divides, else sub-sharding a dim
  already split, else replicated (warned for large tensors).
- ``train_step`` takes the GLOBAL batch; each rank keeps its dim-0 slice
  by its index on ``dp x sharding`` (dp slowest), runs the forward and
  backward under the bound mesh (the tensor-parallel layers' collectives
  run there), and returns the global mean loss, the same on every rank.
- The gradients are averaged over ``dp x sharding``: all-reduced, or,
  for a ZeRO parameter, reduce-scattered over ``sharding`` (then
  all-reduced over ``dp``) so each rank holds its shard's gradient.
- ZeRO-1 and 2: the optimizer's state (moments, masters) exists for this
  rank's shard only; the step updates the shard in place inside the
  whole parameter (a view), and the updated shards are all-gathered
  back. ZeRO-3: between steps each parameter IS its shard; a forward
  pre-hook on the layer that owns it all-gathers it at its first use in
  each forward, and it is cut back to its shard once its gradient is
  taken, so the gathered copy lives from its use in the forward to the
  end of the backward. Offload moves each rank's own slot shards.
- Gradient merge accumulates the raw local gradients and synchronises
  the merged one; the clip's global norm and the anomaly policy's are
  taken over the whole mesh (``nn/clip.py``), and ``ok`` and the loss
  are the same on every rank, so every rank skips the same step.
- Checkpoints are the reference's multi-process layout: each rank writes
  the windows it is the first replica of, and ``load_checkpoint``
  assembles each rank's windows from whatever mesh saved them.
- ``pp``: the trainer attaches its mesh to every ``PipelineParallel``
  and ``Pipeline1F1B`` in the model (``trainer.py:96-109``); their
  stacked parameters' ``("pp", ...)`` specs give each pp rank its
  stage. A ``Pipeline1F1B`` model with ``pp`` above 1 owns its loss and
  gradients (:meth:`Pipeline1F1B.loss_and_grads`, the 1F1B schedule,
  under the trainer's AMP; ``:495-515``): a ``loss_fn`` other than its
  own warns, as the reference does, and is used for ``eval_step`` only.
  Under ZeRO-3 every parameter is gathered before the schedule. A
  ``PipelineParallel`` runs GPipe inside the model's forward.
- ``sep``: the trainer cuts dim 1 of each token leaf of the batch (the
  leaves whose dim 1 is the sequence, ``_spec_for_leaf``, :285-300;
  with a ``loss_fn``, the label stays whole) by the rank's ``sep``
  coordinate, and runs the step in ``ring_attention.sep_sharded_scope``:
  attention runs ring or Ulysses, the embeddings offset their positions.
  With a ``loss_fn`` the model's output is gathered over ``sep`` on dim
  1 before it (every rank computes the same loss; the gather's backward
  keeps this rank's chunk). Gathered logits are large: gpt2_small at 8 x
  1024 in fp32 is 1.65 GB a rank; ``GPTForCausalLM``'s own loss
  (``loss_fn=None``) gathers only the label ids. Parameter gradients are
  SUMMED over ``sep`` (each rank holds its chunk's part of the same
  loss's gradient), then averaged over ``dp x sharding``. A sequence
  ``sep`` does not divide, or a pipelined 1F1B model, warns as the
  reference does (``:120-132``), and every sep rank then runs the whole
  sequence: the same function.

A mesh of one rank (or ``mesh=None``) is the one-card trainer above,
unchanged.

ZeRO offload (``sharding=True, sharding_configs={"offload": True}``):
every non-scalar optimizer slot (``moment1``, ``moment2``, ``velocity``,
``@master`` ...) lives in pinned host memory between steps; the 0-dim
slots (beta powers) stay on the device, as in the reference. Around each
``optimizer.step()`` the slots stream in (host to device on the current
stream, into fresh device buffers the update works on) and back out
(device to host on a side stream, which first waits for the update, so
the copy-out overlaps the next step's forward; the buffers are marked
used by the side stream so the allocator keeps them until it is done).
The next copy-in waits for that copy-out on the device, and every host
reader or writer of the slots (a checkpoint's save or load,
``_opt_states``, ``eval_step``, ``predict_step``) first waits for it on
the host. A failed pin or copy raises; the state is never kept on the
device instead. On ``device="cpu"`` the host buffers are plain CPU
tensors (pinning needs a card) and the same copies run synchronously, so
the arithmetic is the same with and without offload.

``enable_anomaly_policy`` arms the reference's step-level guard
(``resilience.AnomalyConfig``): the fp32 global norm of the raw
gradients and ``ok = isfinite(loss) & isfinite(gnorm) & (loss <= cap)``
(``cap`` the spike threshold) are read on the host once, before the
update. The reference commits its compiled step behind a ``jnp.where``
on ``ok``; the port's optimizer updates in place, so a bad step never
calls ``optimizer.step()``: the parameters, the optimizer's state (beta
powers and ``@master`` included) and the buffers keep their pre-step
values while the step counter advances. ``skip_step`` counts and warns,
``rollback`` restores the attached ``CheckpointManager``'s newest valid
checkpoint after ``rollback_after`` consecutive bad steps, ``raise``
raises ``FloatingPointError``.

``save_checkpoint``/``load_checkpoint`` write and read the reference's
format (``distributed/checkpoint.py``) under its keys: ``param/<n>``,
``opt/<n>/<slot>`` (``moment1``, ``moment2``, ``beta1_pow``,
``beta2_pow``, ``velocity``, ``@master``), ``buf/<n>`` and
``gm_accum/<n>``, with ``step`` and ``lr_scheduler`` in the extra state
(and torch's generators under ``torch_rng``). A checkpoint without
``@master`` (the JAX trainer keeps none) seeds the master from the
loaded parameter. ``eval_step``/``predict_step`` run the forward in eval
mode under no grad and the trainer's AMP, then restore every sublayer's
``training`` flag.
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch.amp.auto_cast import auto_cast
from paddle_tpu_torch.core.place import module_device
from paddle_tpu_torch.core.unported import refuse_unported
from paddle_tpu_torch.distributed import collective as _coll
from paddle_tpu_torch.distributed import env as _env
from paddle_tpu_torch.distributed.fleet.utils import recompute as _recompute
from paddle_tpu_torch.optimizer.lr import LRScheduler
from paddle_tpu_torch.testing import fault_injection as _fi

__all__ = ["ShardedTrainer"]


def _norm_spec(spec, ndim: int) -> tuple:
    """A ``dist_spec`` as a tuple of ``ndim`` entries (None: replicated)."""
    entries = tuple(spec) if spec is not None else ()
    return entries + (None,) * (ndim - len(entries))


def _extend_with_sharding(spec: tuple, shape, mesh, name: str) -> tuple:
    """``spec`` with ``sharding`` added, as the reference's
    ``_extend_with_sharding`` (``trainer.py:315-360``): on the largest
    free dim the degree divides (ties to dim 0), else appended to an
    occupied dim whose per-shard extent it divides, else none (a large
    replicated tensor is warned about)."""
    deg = mesh.shape["sharding"]
    axes_of = [_env._spec_axes(e) for e in spec]
    if any("sharding" in a for a in axes_of):
        return spec
    best_dim, best_n = None, 0
    for dim, n in enumerate(shape):
        if not axes_of[dim] and n % deg == 0 and n > best_n:
            best_dim, best_n = dim, n
    if best_dim is not None:
        axes_of[best_dim] = ("sharding",)
    else:
        best_per = 0
        for dim, n in enumerate(shape):
            if not axes_of[dim]:
                continue
            held = int(np.prod([mesh.shape.get(a, 1) for a in axes_of[dim]]))
            if n % (held * deg) == 0 and n // held > best_per:
                best_dim, best_per = dim, n // held
        if best_dim is not None:
            axes_of[best_dim] = axes_of[best_dim] + ("sharding",)
    if best_dim is None:
        if shape and int(np.prod(shape)) >= 4096:
            warnings.warn(
                f"ZeRO: parameter {name} shape {tuple(shape)} (spec {spec}) "
                f"has no dim divisible by sharding degree {deg}; it will be "
                "REPLICATED on every shard rank", UserWarning)
        return spec
    return tuple(a[0] if len(a) == 1 else (a if a else None)
                 for a in axes_of)


class _Plan:
    """How one parameter lies on the mesh: its global ``shape``, its
    ``spec`` (the tensor-parallel entries) and ``zero_spec`` (with ZeRO's
    ``sharding``), this rank's ``local`` window, and, under ZeRO, the dim
    (``zero_dim``) and span of this rank's shard within it. ``axes``: the
    mesh axes over which the tensor the optimizer steps (the shard under
    ZeRO, else the local window) differs from rank to rank."""

    def __init__(self, mesh, name: str, p, zero: int):
        self.shape = tuple(p.shape)
        self.spec = _norm_spec(getattr(p, "dist_spec", None), p.dim())
        self.zero_spec = _extend_with_sharding(
            self.spec, self.shape, mesh, name) if zero else self.spec
        self.zero_dim = next(
            (d for d, e in enumerate(self.zero_spec)
             if "sharding" in _env._spec_axes(e)), None) if zero else None
        win = mesh.window(self.spec, self.shape)
        self.slices = tuple(slice(a, b) for a, b in win)
        self.local_shape = tuple(b - a for a, b in win)
        self.whole = self.local_shape == self.shape
        if self.zero_dim is not None:
            k = mesh.shape["sharding"]
            self.shard_len = self.local_shape[self.zero_dim] // k
            self.shard_start = mesh.coord["sharding"] * self.shard_len
        step_spec = self.zero_spec if self.zero_dim is not None \
            else self.spec
        self.axes = tuple(a for e in step_spec for a in _env._spec_axes(e)
                          if mesh.shape.get(a, 1) > 1)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.whole else t[self.slices].clone()

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO shard of the local window ``t`` (a view)."""
        return t.narrow(self.zero_dim, self.shard_start, self.shard_len)


class ShardedTrainer:
    def __init__(self, model, optimizer, loss_fn: Optional[Callable] = None,
                 mesh=None, strategy=None, batch_spec=None,
                 recompute: bool = False, amp: bool = False,
                 amp_dtype: str = "bfloat16"):
        from paddle_tpu_torch.distributed.strategy import DistributedStrategy

        from paddle_tpu_torch.distributed.env import Mesh

        if mesh is not None and getattr(mesh, "size", 1) != 1 \
                and not isinstance(mesh, Mesh):
            raise NotImplementedError(
                "ShardedTrainer: a mesh of more than one device is a "
                "distributed.env Mesh over torch.distributed ranks "
                "(build_mesh or fleet.init)")
        refuse_unported("ShardedTrainer", batch_spec=(batch_spec, None))
        from paddle_tpu_torch.distributed.pipeline_1f1b import Pipeline1F1B

        self.strategy = strategy or DistributedStrategy()
        st = self.strategy
        self.model = model
        self.optimizer = optimizer
        if loss_fn is None and isinstance(model, Pipeline1F1B):
            loss_fn = getattr(type(model), "loss", model.loss_fn)
        self.loss_fn = loss_fn
        self.recompute = recompute or st.recompute
        self.amp = amp or st.amp
        self.amp_dtype = amp_dtype
        self.device = module_device(model)
        self.param_tensors = dict(model.named_parameters())
        self._names = {id(p): n for n, p in self.param_tensors.items()}
        self.mesh = mesh
        self._mesh = mesh if isinstance(mesh, Mesh) and mesh.size > 1 \
            else None
        if self._mesh is not None:
            self._mesh_init()
        self._pipe_init(loss_fn)
        # every slot exists from the start, as the reference's state
        # pytree does: a checkpoint before the first step holds them all
        self._offload = bool(st.sharding and st.sharding_configs.offload)
        self._host_slots = {}
        self._copy_stream = self._out_done = None
        with self._shard_views():
            live = self.optimizer._named_state(self._names)
        if self._offload:
            self._offload_init(live)
        self._global_step = 0
        gm = st.gradient_merge_configs
        self._gm_k, self._gm_avg = 1, True
        self._gm_accum = None
        if st.gradient_merge and gm.k_steps > 1:
            self._gm_k, self._gm_avg = int(gm.k_steps), bool(gm.avg)
            self._gm_accum = {
                n: torch.zeros(self._local_shape(n), dtype=torch.float32,
                               device=self.device)
                for n, p in self.param_tensors.items() if p.requires_grad}

    # -- the step -------------------------------------------------------------
    def _loss(self, *batch) -> torch.Tensor:
        """The loss closure: the forward and the fp32 mean loss (the
        model's output gathered over ``sep`` first when the step cut the
        sequence)."""
        if self.loss_fn is not None:
            *xs, label = batch
            res = self.loss_fn(self._sep_gathered(self.model(*xs), xs),
                               label)
        else:
            res = self.model(*batch)
        return res.float().mean()

    def _sep_gathered(self, out, xs):
        """``out`` with each tensor whose dim 1 is the local sequence
        chunk gathered over ``sep`` (``ring_attention._sep_gather``)."""
        if not self._sep_cut:
            return out
        from paddle_tpu_torch.distributed.ring_attention import _sep_gather

        local = next(t.shape[1] for t in xs if t.dim() >= 2)

        def one(t):
            if isinstance(t, torch.Tensor) and t.dim() >= 2 \
                    and t.shape[1] == local:
                return _sep_gather(t, self._mesh)
            return t

        if isinstance(out, (tuple, list)):
            return type(out)(one(t) for t in out)
        return one(out)

    def _to_device(self, batch):
        return tuple(torch.as_tensor(b).to(self.device, non_blocking=True)
                     for b in batch)

    def _forward_backward(self, batch) -> torch.Tensor:
        with auto_cast(enable=self.amp, dtype=self.amp_dtype):
            loss = (_recompute(self._loss, *batch) if self.recompute
                    else self._loss(*batch))
        loss.backward()
        return loss.detach()

    def _opt_states(self):
        """The optimizer's live slots by parameter name (``opt/<n>/...``);
        under offload the host buffers, once any copy-out has landed."""
        self._offload_wait()
        return self.optimizer._named_state(self._names)

    def _inner_optimizer(self):
        """The optimizer under any fleet or ASP wrappers."""
        opt = self.optimizer
        while hasattr(opt, "inner_opt"):
            opt = opt.inner_opt
        return opt

    # -- ZeRO offload ---------------------------------------------------------
    def _offload_init(self, live):
        """Move every non-scalar slot into a pinned host buffer, which
        takes the slot's place in the optimizer between steps."""
        cuda = self.device.type == "cuda"
        if cuda:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        for n, slots in live.items():
            for slot, v in slots.items():
                if v.dim() == 0:
                    continue
                host = torch.empty(v.shape, dtype=v.dtype, device="cpu",
                                   pin_memory=cuda)
                if cuda and not host.is_pinned():
                    raise RuntimeError(
                        f"ZeRO offload: the host buffer of {n}/{slot} is "
                        "not pinned")
                host.copy_(v)
                slots[slot] = host
                self._host_slots[(n, slot)] = host
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()

    def _offload_wait(self):
        """Block the host until the last copy-out has landed."""
        if self._out_done is not None:
            self._out_done.synchronize()
            self._out_done = None

    def _stream_in(self):
        """The offloaded slots into fresh device buffers for the update,
        after the last copy-out on the device."""
        if not self._offload:
            return
        live = self.optimizer._named_state(self._names)
        cuda = self.device.type == "cuda"
        if cuda and self._out_done is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._out_done)
        for (n, slot), host in self._host_slots.items():
            live[n][slot] = host.to(self.device, non_blocking=cuda,
                                    copy=True)

    def _stream_out(self):
        """The updated slots back into their host buffers, on the side
        stream after the update; the host buffers take their place."""
        if not self._offload:
            return
        live = self.optimizer._named_state(self._names)
        if self.device.type != "cuda":
            for (n, slot), host in self._host_slots.items():
                host.copy_(live[n][slot])
                live[n][slot] = host
            return
        side = self._copy_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for (n, slot), host in self._host_slots.items():
                dev = live[n][slot]
                host.copy_(dev, non_blocking=True)
                dev.record_stream(side)
                live[n][slot] = host
            self._out_done = torch.cuda.Event()
            self._out_done.record(side)

    def _optimizer_step(self):
        """``optimizer.step()`` and ``clear_grad()``, the offloaded slots
        streamed in before and out after."""
        self._stream_in()
        try:
            self.optimizer.step()
        finally:
            self._stream_out()
        self.optimizer.clear_grad()

    def _merge_step(self):
        """Gradient merge: add this call's raw gradients into the fp32
        accumulators; on every k-th call step on the merged gradient."""
        names = [n for n, p in self.param_tensors.items()
                 if p.grad is not None and n in self._gm_accum]
        accum = [self._gm_accum[n] for n in names]
        with torch.no_grad():
            torch._foreach_add_(accum, [self.param_tensors[n].grad
                                        for n in names])
        self.optimizer.clear_grad()
        if (self._global_step + 1) % self._gm_k:
            return
        scale = 1.0 / self._gm_k if self._gm_avg else 1.0
        with torch.no_grad():
            for n, a in self._gm_accum.items():
                p = self.param_tensors[n]
                p.grad = (a * scale).to(p.dtype)
        self._optimizer_step()
        torch._foreach_zero_(list(self._gm_accum.values()))

    def _guarded_step(self, loss: torch.Tensor, buffers):
        """The anomaly policy's step: one host read of ``ok`` before the
        update; a bad step puts ``buffers`` (their pre-step copies) back.
        Returns True when a rollback replaced this step."""
        norms = torch._foreach_norm(
            [p.grad for p in self.param_tensors.values()
             if p.grad is not None], 2, dtype=torch.float32)
        gnorm = (torch.linalg.vector_norm(torch.stack(norms)) if norms
                 else torch.zeros((), device=self.device))
        cap = float(self._anomaly_cap())
        ok = torch.isfinite(loss) & torch.isfinite(gnorm) & (loss <= cap)
        if not bool(ok):
            self.optimizer.clear_grad()
            with torch.no_grad():
                for n, b in self.model.named_buffers():
                    b.copy_(buffers[n])
            return self._handle_anomaly(loss, gnorm)
        self._optimizer_step()
        self._bad_streak = 0
        if self._anomaly.spike_window:
            self._loss_history.append(float(loss))
        return False

    def train_step(self, *batch) -> torch.Tensor:
        """Run one step; returns the (pre-update) loss as a 0-dim fp32
        tensor on the model's device. Under ``strategy.gradient_merge``
        each call accumulates; the optimizer applies every
        ``k_steps``-th call."""
        batch = _fi.transform("trainer:batch", tuple(batch),
                              step=self._global_step)
        if self._mesh is not None:
            return self._mesh_train_step(batch)
        batch = self._to_device(batch)
        buffers = None
        if self._anomaly is not None:
            buffers = {n: b.clone() for n, b in self.model.named_buffers()}
        loss = self._forward_backward(batch)
        if self._gm_accum is not None:
            self._merge_step()
        elif self._anomaly is not None:
            if self._guarded_step(loss, buffers):
                return loss
        else:
            self._optimizer_step()
        self._global_step += 1
        self._inner_optimizer()._global_step = self._global_step
        self.maybe_auto_checkpoint()
        return loss

    # -- the mesh ---------------------------------------------------------------
    _plans = None
    _zero_stage = 0
    _gathering = False

    _pipe_1f1b = None
    _sep = False          # the mesh has a sep axis above 1
    _sep_cut = False      # this step cuts the sequence over it

    def _pipe_init(self, loss_fn):
        """Attach the mesh to the model's pipelines; a pipelined 1F1B
        model owns its gradients, and then the sequence stays whole."""
        from paddle_tpu_torch.distributed.pipeline import PipelineParallel
        from paddle_tpu_torch.distributed.pipeline_1f1b import Pipeline1F1B

        for sub in self.model.modules():
            if isinstance(sub, (PipelineParallel, Pipeline1F1B)):
                sub.attach_mesh(self._mesh)
        model = self.model
        if not (isinstance(model, Pipeline1F1B) and model.pipelined()):
            return
        self._pipe_1f1b = model
        if loss_fn is not None and loss_fn is not model.loss_fn \
                and loss_fn is not getattr(type(model), "loss", None):
            warnings.warn(
                "ShardedTrainer: the training objective of a pipelined "
                "Pipeline1F1B model is its OWN loss_fn (baked into the "
                "1F1B schedule); the loss_fn passed here is used only "
                "for eval_step. Make sure they agree.", UserWarning)
        if self._sep:
            warnings.warn(
                "ShardedTrainer: 'sep' is not composed with the 1F1B "
                "pipeline schedule; attention inside pipeline stages "
                "runs the local kernel (sequence gathered per stage). "
                "Use sep with non-pipelined models.", UserWarning)
            self._sep = False

    def _mesh_init(self):
        """Cut every parameter to this rank's window (and, under ZeRO-3,
        its shard); record each one's plan."""
        mesh, st = self._mesh, self.strategy
        self._sep = mesh.shape.get("sep", 1) > 1
        self._data_axes = tuple(a for a in ("dp", "sharding")
                                if mesh.shape.get(a, 1) > 1)
        self._zero_stage = int(st.sharding_configs.stage) if (
            st.sharding and mesh.shape.get("sharding", 1) > 1) else 0
        self._plans = {}
        self._gathered = set()
        with torch.no_grad():
            for n, p in self.param_tensors.items():
                plan = self._plans[n] = _Plan(mesh, n, p, self._zero_stage)
                p.data = plan.local(p.data)
                if self._zero_stage >= 3 and plan.zero_dim is not None:
                    p.data = plan.shard(p.data).clone()
                p._mesh_axes = plan.axes
        if self._zero_stage >= 3:
            for mod in self.model.modules():
                own = [self._names[id(p)] for p in mod._parameters.values()
                       if p is not None and id(p) in self._names
                       and self._plans[self._names[id(p)]].zero_dim
                       is not None]
                if own:
                    mod.register_forward_pre_hook(
                        functools.partial(self._gather_hook, own))

    def _gather_all(self):
        """ZeRO-3: every sharded parameter gathered (before a pipeline's
        schedule, which calls its stages' layers on some ranks only)."""
        if self._zero_stage >= 3:
            self._gather_hook([n for n, plan in self._plans.items()
                               if plan.zero_dim is not None], None, ())

    def _local_shape(self, name: str):
        plan = (self._plans or {}).get(name)
        return plan.local_shape if plan is not None \
            else tuple(self.param_tensors[name].shape)

    def _gather_hook(self, names, module, args):
        """ZeRO-3: all-gather the layer's own parameters at their first
        use in this forward."""
        if not self._gathering:
            return
        for n in names:
            if n in self._gathered:
                continue
            p, plan = self.param_tensors[n], self._plans[n]
            parts = []
            _coll.all_gather(parts, p.data, axis_name="sharding")
            p.data = torch.cat(parts, dim=plan.zero_dim)
            self._gathered.add(n)

    def _release(self):
        """ZeRO-3: every gathered parameter back to its shard."""
        for n in self._gathered:
            p = self.param_tensors[n]
            p.data = self._plans[n].shard(p.data).clone()
        self._gathered.clear()

    @contextlib.contextmanager
    def _shard_views(self):
        """ZeRO-1/2: each sharded parameter shows the optimizer its
        shard, a view into the whole parameter, for the duration."""
        if self._mesh is None or self._zero_stage not in (1, 2):
            yield
            return
        whole = {}
        for n, plan in self._plans.items():
            if plan.zero_dim is not None:
                p = self.param_tensors[n]
                whole[n] = p.data
                p.data = plan.shard(p.data)
        try:
            yield
        finally:
            for n, t in whole.items():
                p = self.param_tensors[n]
                p.grad = None
                p.data = t

    def _gather_shards(self):
        """ZeRO-1/2: the updated shards all-gathered into every rank's
        whole parameter."""
        if self._zero_stage not in (1, 2):
            return
        with torch.no_grad():
            for n, plan in self._plans.items():
                if plan.zero_dim is None:
                    continue
                p = self.param_tensors[n]
                parts = []
                _coll.all_gather(parts, plan.shard(p.data).contiguous(),
                                 axis_name="sharding")
                p.data.copy_(torch.cat(parts, dim=plan.zero_dim))

    def _local_batch(self, batch, labelled: bool = True):
        """This rank's dim-0 slice of every leaf of the global batch, by
        its index on ``dp x sharding`` (dp slowest); under ``sep``, also
        its dim-1 chunk of each token leaf (:meth:`_sep_leaves`;
        ``labelled``: the batch ends with the label)."""
        n = self._mesh.degree(self._data_axes)
        i = self._mesh.index(self._data_axes)
        out = []
        for b in batch:
            t = torch.as_tensor(b)
            if t.shape[0] % n:
                raise ValueError(
                    f"the global batch's dim 0 ({t.shape[0]}) must divide "
                    f"over dp x sharding ({n} ranks)")
            out.append(t.chunk(n, 0)[i] if n > 1 else t)
        cut = self._sep_leaves(out, labelled)
        if cut:
            k, r = self._mesh.degree("sep"), self._mesh.index("sep")
            out = [t.chunk(k, 1)[r].contiguous() if j in cut else t
                   for j, t in enumerate(out)]
        return tuple(out)

    _sep_warned = False

    def _sep_leaves(self, batch, labelled: bool):
        """The indices of the leaves ``sep`` cuts on dim 1 (sets
        ``_sep_cut``): those whose dim 1 is the sequence length (the
        first integer leaf's dim 1, else the first 2-D leaf's), the
        label excluded when a ``loss_fn`` takes it whole. None when the
        sequence does not divide over ``sep``, which warns."""
        self._sep_cut = False
        if not self._sep:
            return None
        leaves = list(batch[:-1] if labelled and self.loss_fn is not None
                      else batch)
        seq = next((t.shape[1] for t in leaves if t.dim() >= 2
                    and not t.is_floating_point()), None)
        if seq is None:
            seq = next((t.shape[1] for t in leaves if t.dim() >= 2), None)
        k = self._mesh.degree("sep")
        if seq is None or seq % k:
            if not self._sep_warned:
                warnings.warn(
                    f"sequence-parallel scope: a sequence length ({seq}) "
                    f"not divisible by the 'sep' axis ({k}): every sep "
                    "rank runs the whole sequence (correct but not "
                    "sep-scheduled)", UserWarning, stacklevel=4)
                self._sep_warned = True
            return None
        self._sep_cut = True
        return {j for j, t in enumerate(leaves)
                if t.dim() >= 2 and t.shape[1] == seq}

    def _sep_scope(self):
        """The step's ``sep_sharded_scope``: the mesh when this step cuts
        the sequence, a whole-sequence scope when the mesh has ``sep``
        but it does not, nothing without ``sep``."""
        from paddle_tpu_torch.distributed.ring_attention import \
            sep_sharded_scope

        if self._mesh is None or self._mesh.shape.get("sep", 1) <= 1:
            return contextlib.nullcontext()
        return sep_sharded_scope(self._mesh if self._sep_cut else None)

    def _data_mean(self, value: torch.Tensor) -> torch.Tensor:
        """The mean of a per-rank value over ``dp x sharding``."""
        n = self._mesh.degree(self._data_axes)
        if n == 1:
            return value
        out = value.detach().clone()
        with _env._mesh_scope(self._mesh):
            _coll.all_reduce(out, axis_name=self._data_axes)
        return out / n

    def _sync_grads(self, grads):
        """Average each raw local gradient over ``dp x sharding``, after
        summing it over ``sep`` when the step cut the sequence: a ZeRO
        parameter's reduce-scattered over ``sharding`` to its shard (then
        all-reduced over ``dp`` and ``sep``), the others all-reduced."""
        n_data = self._mesh.degree(self._data_axes)
        sep = ("sep",) if self._sep_cut else ()
        rest = tuple(a for a in ("dp",) + sep
                     if self._mesh.shape.get(a, 1) > 1)
        summed = self._data_axes + sep
        out = {}
        for n, g in grads.items():
            plan = self._plans[n]
            if plan.zero_dim is not None:
                g = _coll.reduce_scatter(g, axis_name="sharding",
                                         scatter_dim=plan.zero_dim)
                if rest:
                    _coll.all_reduce(g, axis_name=rest)
            elif self._mesh.degree(summed) > 1:
                _coll.all_reduce(g, axis_name=summed)
            out[n] = g.div_(n_data) if n_data > 1 else g
        return out

    def _take_grads(self):
        """The raw gradients, taken off the parameters; ZeRO-3's gathered
        parameters then go back to their shards."""
        grads = {}
        for n, p in self.param_tensors.items():
            if p.grad is not None:
                grads[n] = p.grad
                p.grad = None
        self._release()
        return grads

    def _mesh_update(self, synced):
        """The optimizer's step on the synchronised gradients, each
        parameter seen as the tensor this rank steps (its shard under
        ZeRO), then the ZeRO-1/2 shards gathered back."""
        with self._shard_views():
            for n, g in synced.items():
                p = self.param_tensors[n]
                p.grad = g.to(p.dtype)
            self._optimizer_step()
        self._gather_shards()

    def _pipe_forward_backward(self, batch) -> torch.Tensor:
        """The 1F1B schedule's loss, its gradients on the parameters."""
        self._gather_all()
        with auto_cast(enable=self.amp, dtype=self.amp_dtype):
            loss, _ = self._pipe_1f1b.loss_and_grads(
                None, (batch[0], batch[-1]), None)
        return loss.detach()

    def _mesh_train_step(self, batch):
        batch = self._to_device(self._local_batch(batch))
        buffers = None
        if self._anomaly is not None:
            buffers = {n: b.clone() for n, b in self.model.named_buffers()}
        with _env._mesh_scope(self._mesh), self._sep_scope():
            self._gathering = True
            try:
                loss = (self._pipe_forward_backward(batch)
                        if self._pipe_1f1b is not None
                        else self._forward_backward(batch))
            finally:
                self._gathering = False
            grads = self._take_grads()
            loss = self._data_mean(loss)
            if self._gm_accum is not None:
                with torch.no_grad():
                    for n, g in grads.items():
                        self._gm_accum[n].add_(g)
                if (self._global_step + 1) % self._gm_k == 0:
                    scale = 1.0 / self._gm_k if self._gm_avg else 1.0
                    merged = {n: a * scale for n, a in self._gm_accum.items()}
                    self._mesh_update(self._sync_grads(merged))
                    torch._foreach_zero_(list(self._gm_accum.values()))
            elif self._anomaly is not None:
                if self._mesh_guarded_step(loss, buffers, grads):
                    return loss
            else:
                self._mesh_update(self._sync_grads(grads))
        self._global_step += 1
        self._inner_optimizer()._global_step = self._global_step
        self.maybe_auto_checkpoint()
        return loss

    def _mesh_guarded_step(self, loss, buffers, grads):
        """The anomaly policy over the mesh: the global norm of the
        synchronised gradients and the global loss decide ``ok``, the
        same on every rank."""
        from paddle_tpu_torch.nn.clip import _mesh_sq_sum

        synced = self._sync_grads(grads)
        pairs = [(self.param_tensors[n], g) for n, g in synced.items()]
        gnorm = _mesh_sq_sum(pairs).sqrt()
        cap = float(self._anomaly_cap())
        ok = torch.isfinite(loss) & torch.isfinite(gnorm) & (loss <= cap)
        if not bool(ok):
            with torch.no_grad():
                for n, b in self.model.named_buffers():
                    b.copy_(buffers[n])
            return self._handle_anomaly(loss, gnorm)
        self._mesh_update(synced)
        self._bad_streak = 0
        if self._anomaly.spike_window:
            self._loss_history.append(float(loss))
        return False

    def _in_mesh(self, fn, *args, **kwargs):
        """``fn`` under the bound mesh (ZeRO-3 gathering at use), then
        the gathered parameters back to their shards."""
        if self._mesh is None:
            return fn(*args, **kwargs)
        with _env._mesh_scope(self._mesh), self._sep_scope():
            self._gathering = True
            try:
                return fn(*args, **kwargs)
            finally:
                self._gathering = False
                self._release()

    # -- step-level anomaly policies (distributed/resilience.py) --------------
    _anomaly = None
    _anomaly_manager = None
    _anomaly_skipped = 0
    _anomaly_rollbacks = 0
    _bad_streak = 0
    _loss_history = None

    def enable_anomaly_policy(self, config=None, *, checkpoint_manager=None,
                              **kwargs):
        """Arm step-level anomaly handling (``resilience.AnomalyConfig``,
        or kwargs to build one: ``policy=``, ``rollback_after=``,
        ``spike_window=``, ``spike_factor=``). Call before training or
        at any step boundary."""
        from paddle_tpu_torch.distributed.resilience import AnomalyConfig

        if config is None:
            config = AnomalyConfig(**kwargs)
        if (self.strategy.gradient_merge
                and int(self.strategy.gradient_merge_configs.k_steps) > 1):
            raise ValueError(
                "anomaly policies do not compose with gradient_merge yet: "
                "a skipped micro-step would silently shrink the merge "
                "window")
        if config.policy == "rollback" and checkpoint_manager is None:
            raise ValueError(
                "policy='rollback' needs a CheckpointManager to restore "
                "from (pass checkpoint_manager=)")
        self._anomaly = config
        self._anomaly_manager = checkpoint_manager
        if checkpoint_manager is not None:
            checkpoint_manager.attach(self)
        self._loss_history = deque(maxlen=max(1, config.spike_window))
        return self

    @property
    def anomaly_stats(self):
        return {"skipped": self._anomaly_skipped,
                "rollbacks": self._anomaly_rollbacks,
                "consecutive_bad": self._bad_streak}

    def _anomaly_cap(self):
        """Spike threshold: spike_factor x the running median of the last
        spike_window GOOD losses; +inf until the window fills (or spike
        detection is off, or the median is not positive)."""
        cfg = self._anomaly
        if (not cfg.spike_window
                or len(self._loss_history) < cfg.spike_window):
            return np.float32(np.inf)
        med = float(np.median(self._loss_history))
        if med <= 0:
            return np.float32(np.inf)
        return np.float32(med * cfg.spike_factor)

    def _handle_anomaly(self, loss, gnorm):
        """Policy dispatch for a failed step predicate: the state kept its
        pre-step values; count and continue, roll back, or die."""
        from paddle_tpu_torch.distributed.resilience import \
            TransientFailureWarning

        cfg = self._anomaly
        msg = (f"anomalous train step {self._global_step + 1}: "
               f"loss={float(loss):g}, grad_norm={float(gnorm):g}")
        if cfg.policy == "raise":
            raise FloatingPointError(msg)
        self._anomaly_skipped += 1
        self._bad_streak += 1
        warnings.warn(TransientFailureWarning(
            f"{msg} — update dropped ({cfg.policy}, consecutive bad: "
            f"{self._bad_streak})"), stacklevel=4)
        if (cfg.policy == "rollback"
                and self._bad_streak >= cfg.rollback_after):
            streak = self._bad_streak
            step = self._anomaly_manager.restore()
            self._anomaly_rollbacks += 1
            self._bad_streak = 0
            self._loss_history.clear()
            warnings.warn(TransientFailureWarning(
                f"{streak} consecutive anomalous steps: rolled back to "
                f"checkpoint step {step}"), stacklevel=4)
            return True
        return False

    # -- eval / predict -------------------------------------------------------
    def _run_in_eval_mode(self, fn, *args):
        """Eval-mode semantics (dropout off) under no grad and the
        trainer's AMP for the call, then each sublayer's training flag
        restored."""
        self._offload_wait()
        layers = list(self.model.modules())
        saved = [m.training for m in layers]
        for m in layers:
            m.training = False
        try:
            with torch.no_grad(), auto_cast(enable=self.amp,
                                            dtype=self.amp_dtype):
                return fn(*args)
        finally:
            for m, flag in zip(layers, saved):
                m.training = flag

    def eval_step(self, *batch):
        """Forward + loss in eval mode; returns the fp32 mean loss (over a
        mesh: of the global batch, on every rank)."""
        if self._mesh is None:
            return self._run_in_eval_mode(self._loss,
                                          *self._to_device(batch))
        loss = self._run_in_eval_mode(
            self._in_mesh, self._loss,
            *self._to_device(self._local_batch(batch)))
        return self._data_mean(loss)

    def predict_step(self, *batch):
        """Forward in eval mode; returns the model's raw outputs (over a
        mesh: of the global batch, gathered on every rank)."""
        if self._mesh is None:
            return self._run_in_eval_mode(self.model,
                                          *self._to_device(batch))
        xs = self._to_device(self._local_batch(batch, labelled=False))
        out = self._run_in_eval_mode(self._in_mesh, self.model, *xs)
        if self._sep_cut:
            with _env._mesh_scope(self._mesh), torch.no_grad():
                out = self._sep_gathered(out, xs)
        with _env._mesh_scope(self._mesh):
            gather = functools.partial(_coll.all_gather,
                                       axis_name=self._data_axes, tiled=True)
            if isinstance(out, (tuple, list)):
                return type(out)(gather(o) for o in out)
            return gather(out)

    @property
    def step_count(self):
        return self._global_step

    def optimizer_state_bytes(self, predicate=None):
        """(per-device, total) bytes of the non-scalar optimizer state
        (``predicate(name)`` filters parameters): this rank's slots, and
        what they would take whole; on one card the two are equal."""
        per_dev = total = 0
        for key, v, _, shape in self._entries():
            n = key.split("/")[1] if key.startswith("opt/") else None
            if n is None or v.dim() == 0 or (predicate is not None
                                             and not predicate(n)):
                continue
            per_dev += v.numel() * v.element_size()
            total += int(np.prod(shape)) * v.element_size()
        return per_dev, total

    # -- checkpoints ----------------------------------------------------------
    def _entries(self):
        """``(key, tensor, spec, global shape)`` of every checkpoint entry
        as this rank holds it (spec ``()``: replicated)."""
        out = []
        plans = self._plans or {}
        zero3 = self._zero_stage >= 3

        def step_spec(n, t, sharded: bool):
            """A ZeRO shard's spec, else the tensor-parallel one."""
            plan = plans.get(n)
            if plan is None:
                return (), tuple(t.shape)
            return (plan.zero_spec if sharded else plan.spec), plan.shape

        for n, p in self.param_tensors.items():
            out.append((f"param/{n}", p.detach(), *step_spec(n, p, zero3)))
        with self._shard_views():
            for n, slots in self._opt_states().items():
                cur = tuple(self.param_tensors[n].shape)
                for slot, v in slots.items():
                    if v.dim() > 0 and tuple(v.shape) == cur:
                        spec, shape = step_spec(n, v, True)
                    else:
                        spec, shape = (), tuple(v.shape)
                    out.append((f"opt/{n}/{slot}", v, spec, shape))
        out.extend((f"buf/{n}", b, (), tuple(b.shape))
                   for n, b in self.model.named_buffers())
        if self._gm_accum is not None:
            # a mid-window resume must not drop accumulated gradients
            out.extend((f"gm_accum/{n}", v,
                        plans[n].spec if n in plans else (),
                        plans[n].shape if n in plans else tuple(v.shape))
                       for n, v in self._gm_accum.items())
        return out

    def _checkpoint_state(self):
        """The entries to save: whole tensors on one card; over a mesh,
        each rank's windows (``checkpoint._Piece``), written by their
        first replica."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt

        if self._mesh is None:
            return {key: t for key, t, _, _ in self._entries()}
        return {key: ckpt._Piece(t, shape, self._mesh.window(spec, shape),
                                 self._mesh.is_first_replica(spec))
                for key, t, spec, shape in self._entries()}

    def _checkpoint_extra(self):
        """Host-side train state riding along with the tensors: the step
        counter, torch's generators, the lr scheduler's state."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt

        extra = {"step": self._global_step,
                 "torch_rng": ckpt.save_rng_state()}
        lr = self.optimizer._learning_rate
        if isinstance(lr, LRScheduler):
            extra["lr_scheduler"] = lr.state_dict()
        return extra

    def save_checkpoint(self, path: str):
        """Save params + optimizer state + buffers + train state (step,
        lr scheduler, generators) in the reference's format."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt

        ckpt.save_state(self._checkpoint_state(), path,
                        extra=self._checkpoint_extra())

    def load_checkpoint(self, path: str, verify: Optional[bool] = None):
        """Restore a checkpoint of either package into this trainer, in
        place, on its device; training continues from its step.
        ``verify`` forwards to ``checkpoint.load_state`` (checksums)."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt

        specs = None
        if self._mesh is not None:
            specs = {key: spec for key, _, spec, _ in self._entries()}
        arrays, extra = ckpt.load_state(path, self._mesh, specs,
                                        verify=verify, device=self.device)
        with torch.no_grad():
            for n, p in self.param_tensors.items():
                p.copy_(arrays[f"param/{n}"])
            with self._shard_views():
                for n, slots in self._opt_states().items():
                    for slot, v in slots.items():
                        key = f"opt/{n}/{slot}"
                        if key in arrays:
                            v.copy_(arrays[key])
                        elif slot == "@master":
                            v.copy_(self.param_tensors[n])
            for n, b in self.model.named_buffers():
                b.copy_(arrays[f"buf/{n}"])
            for n, a in (self._gm_accum or {}).items():
                key = f"gm_accum/{n}"
                if key in arrays:
                    a.copy_(arrays[key])
        self._global_step = int(extra.get("step", 0))
        self._inner_optimizer()._global_step = self._global_step
        if "torch_rng" in extra:
            ckpt.load_rng_state(extra["torch_rng"])
        lr = self.optimizer._learning_rate
        if isinstance(lr, LRScheduler) and "lr_scheduler" in extra:
            lr.set_state_dict(extra["lr_scheduler"])
        return self

    _auto_ckpt = None

    def enable_auto_checkpoint(self, path: str, every_steps: int = 100):
        """Save every ``every_steps`` steps from inside ``train_step``;
        resume by calling ``load_checkpoint`` on restart."""
        self._auto_ckpt = (path, int(every_steps))

    def maybe_auto_checkpoint(self):
        if self._auto_ckpt is None:
            return False
        path, every = self._auto_ckpt
        if self._global_step > 0 and self._global_step % every == 0:
            self.save_checkpoint(path)
            return True
        return False
