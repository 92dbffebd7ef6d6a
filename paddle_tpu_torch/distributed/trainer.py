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
``loss_with_aux``. Pipelines and a mesh of more than one device are
later work and raise ``NotImplementedError``.

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

import warnings
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch.amp.auto_cast import auto_cast
from paddle_tpu_torch.core.place import module_device
from paddle_tpu_torch.core.unported import refuse_unported
from paddle_tpu_torch.distributed.fleet.utils import recompute as _recompute
from paddle_tpu_torch.optimizer.lr import LRScheduler
from paddle_tpu_torch.testing import fault_injection as _fi

__all__ = ["ShardedTrainer"]


class ShardedTrainer:
    def __init__(self, model, optimizer, loss_fn: Optional[Callable] = None,
                 mesh=None, strategy=None, batch_spec=None,
                 recompute: bool = False, amp: bool = False,
                 amp_dtype: str = "bfloat16"):
        from paddle_tpu_torch.distributed.strategy import DistributedStrategy

        if mesh is not None and getattr(mesh, "size", 1) != 1:
            raise NotImplementedError(
                "ShardedTrainer: meshes of more than one device are not "
                "ported yet (the port trains on one card)")
        refuse_unported("ShardedTrainer", batch_spec=(batch_spec, None))
        self.strategy = strategy or DistributedStrategy()
        st = self.strategy
        if st.pipeline:
            raise NotImplementedError(
                "ShardedTrainer: strategy.pipeline is not ported yet (the "
                "port trains one model on one card)")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.recompute = recompute or st.recompute
        self.amp = amp or st.amp
        self.amp_dtype = amp_dtype
        self.device = module_device(model)
        self.param_tensors = dict(model.named_parameters())
        self._names = {id(p): n for n, p in self.param_tensors.items()}
        # every slot exists from the start, as the reference's state
        # pytree does: a checkpoint before the first step holds them all
        self._offload = bool(st.sharding and st.sharding_configs.offload)
        self._host_slots = {}
        self._copy_stream = self._out_done = None
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
                n: torch.zeros(p.shape, dtype=torch.float32,
                               device=self.device)
                for n, p in self.param_tensors.items() if p.requires_grad}

    # -- the step -------------------------------------------------------------
    def _loss(self, *batch) -> torch.Tensor:
        """The loss closure: the forward and the fp32 mean loss."""
        if self.loss_fn is not None:
            *xs, label = batch
            res = self.loss_fn(self.model(*xs), label)
        else:
            res = self.model(*batch)
        return res.float().mean()

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
        """Forward + loss in eval mode; returns the fp32 mean loss."""
        return self._run_in_eval_mode(self._loss, *self._to_device(batch))

    def predict_step(self, *batch):
        """Forward in eval mode; returns the model's raw outputs."""
        return self._run_in_eval_mode(self.model, *self._to_device(batch))

    @property
    def step_count(self):
        return self._global_step

    def optimizer_state_bytes(self, predicate=None):
        """(per-device, total) bytes of the non-scalar optimizer state
        (``predicate(name)`` filters parameters); on one card the two
        are equal."""
        total = sum(v.numel() * v.element_size()
                    for n, slots in self._opt_states().items()
                    if predicate is None or predicate(n)
                    for v in slots.values() if v.dim() > 0)
        return total, total

    # -- checkpoints ----------------------------------------------------------
    def _checkpoint_state(self):
        state = {f"param/{n}": p.detach()
                 for n, p in self.param_tensors.items()}
        for n, slots in self._opt_states().items():
            for slot, v in slots.items():
                state[f"opt/{n}/{slot}"] = v
        state.update({f"buf/{n}": b for n, b in self.model.named_buffers()})
        if self._gm_accum is not None:
            # a mid-window resume must not drop accumulated gradients
            state.update({f"gm_accum/{n}": v
                          for n, v in self._gm_accum.items()})
        return state

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

        arrays, extra = ckpt.load_state(path, verify=verify,
                                        device=self.device)
        with torch.no_grad():
            for n, p in self.param_tensors.items():
                p.copy_(arrays[f"param/{n}"])
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
