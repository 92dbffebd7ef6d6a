"""Dynamic loss scaling — the port of ``paddle_tpu/amp/grad_scaler.py``.

``GradScaler`` (and its legacy name ``AmpScaler``) keeps the reference's
whole state machine on the host: the scale, the good and bad step
counters, ``incr_every_n_steps`` and ``decr_every_n_nan_or_inf``, and
the count of skipped steps. The protocol is paddle's:

    scaled = scaler.scale(loss); scaled.backward()
    scaler.step(optimizer)      # unscale, then step unless non-finite
    scaler.update()             # or scaler.minimize(optimizer, scaled)

``unscale_`` multiplies every gradient by 1/scale in place and checks
that all of them are finite in one fused pass over each dtype's
gradients (``torch._amp_foreach_non_finite_check_and_unscale_``: the
reference's check_finite_and_unscale), reading one flag back to the host
once a step. Over a process group of more than one rank the flag is
max-reduced over the whole world first, so every rank skips the same
step. A step whose gradients are not all finite is skipped: the
optimizer is not called, so the parameters and its state stay bit for
bit what they were, and the skip is counted and warned about with
``distributed.resilience.TransientFailureWarning``, as the reference
warns.
"""

from __future__ import annotations

import warnings
from typing import Dict

import torch

__all__ = ["GradScaler", "AmpScaler"]


def _found_anywhere(found):
    """The non-finite flag, max-reduced over every rank of the process
    group, so every rank skips the same step."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return found
    if found is None:
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
        found = torch.zeros((), dtype=torch.float32, device=dev)
    dist.all_reduce(found, op=dist.ReduceOp.MAX)
    return found


class GradScaler:
    def __init__(self, enable: bool = True, init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False
        self._step_called = False
        self._skip_count = 0

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> float:
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Divide every gradient of ``optimizer`` by the scale, in place,
        and note whether all are finite (one read back)."""
        if not self._enable or self._unscaled:
            return
        by_dtype: Dict[torch.dtype, list] = {}
        for p in optimizer._parameter_list:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        found = None
        for grads in by_dtype.values():
            if found is None:
                dev = grads[0].device
                found = torch.zeros((), dtype=torch.float32, device=dev)
                inv = torch.full((), 1.0 / self._scale, dtype=torch.float32,
                                 device=dev)
            torch._amp_foreach_non_finite_check_and_unscale_(grads, found,
                                                             inv)
        found = _found_anywhere(found)
        self._found_inf = bool(found is not None and found.item() != 0.0)
        self._unscaled = True

    def step(self, optimizer):
        """unscale + skip-on-inf + optimizer.step. As in the reference,
        the scale changes only in ``update()``/``minimize()``: the
        pattern is ``scaler.step(opt); scaler.update()``."""
        if not self._enable:
            optimizer.step()
            return
        if self._step_called:
            raise RuntimeError(
                "GradScaler.step() has already been called since the last "
                "update(); call scaler.update() once per iteration")
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        else:
            from paddle_tpu_torch.distributed.resilience import \
                TransientFailureWarning

            self._skip_count += 1
            warnings.warn(TransientFailureWarning(
                f"GradScaler: non-finite gradients at loss scale "
                f"{self._scale:g}; update skipped (total skipped: "
                f"{self._skip_count})"), stacklevel=2)
        self._step_called = True

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def update(self):
        if not self._enable:
            return
        if self._dynamic:
            if self._found_inf:
                self._bad_steps += 1
                self._good_steps = 0
                if self._bad_steps >= self._decr_every_n:
                    self._scale = max(self._scale * self._decr_ratio, 1.0)
                    self._bad_steps = 0
            else:
                self._good_steps += 1
                self._bad_steps = 0
                if self._good_steps >= self._incr_every_n:
                    self._scale *= self._incr_ratio
                    self._good_steps = 0
        self._found_inf = False
        self._unscaled = False
        self._step_called = False

    @property
    def num_skipped_steps(self) -> int:
        """How many updates skip-on-inf dropped so far."""
        return self._skip_count

    def state_dict(self) -> Dict:
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every_n,
                "decr_every_n_nan_or_inf": self._decr_every_n,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, state: Dict):
        self._scale = state["scale"]
        self._incr_ratio = state["incr_ratio"]
        self._decr_ratio = state["decr_ratio"]
        self._incr_every_n = state["incr_every_n_steps"]
        self._decr_every_n = state["decr_every_n_nan_or_inf"]
        self._good_steps = state["good_steps"]
        self._bad_steps = state["bad_steps"]
        self._dynamic = state["use_dynamic_loss_scaling"]


AmpScaler = GradScaler  # legacy fluid name
