"""Fleet meta-optimizers that wrap a user optimizer with a periodic
cross-worker behavior: the port of
``paddle_tpu/distributed/fleet/meta_optimizers.py`` (the reference's
``fleet/meta_optimizers/localsgd_optimizer.py``).

LocalSGD takes ``k_steps`` purely local optimizer steps, then averages
the parameters across workers: ``sync_params`` all-reduces every
trainable parameter over the data-parallel ranks (the fleet's ``dp``
axis once ``fleet.init`` built a mesh, else the whole world) and divides
by their count. In a one-process world it counts and returns, as the
reference's does (the mean over ``{self}``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["LocalSGDOptimizer", "AdaptiveLocalSGDOptimizer"]


def _dp_group():
    """The fleet's data-parallel group once its mesh exists, else None
    (the whole world)."""
    from paddle_tpu_torch.distributed import fleet

    hcg = fleet.get_hybrid_communicate_group()
    if hcg is None or fleet.get_mesh() is None:
        return None
    return hcg.get_data_parallel_group()


class LocalSGDOptimizer:
    """Wraps an optimizer: k local steps, then parameters averaged across
    processes (one process: counted, nothing to average)."""

    def __init__(self, inner, k_steps: int = 1, begin_step: int = 1):
        self._inner = inner
        self.k_steps = max(int(k_steps), 1)
        self.begin_step = max(int(begin_step), 1)
        self._step_count = 0
        self._sync_count = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def inner_opt(self):
        return self._inner

    def step(self):
        self._inner.step()
        self._step_count += 1
        if (self._step_count >= self.begin_step
                and self._step_count % self.k_steps == 0):
            self.sync_params()

    def clear_grad(self):
        self._inner.clear_grad()

    # -- parameter averaging -------------------------------------------------

    def _params(self):
        return [p for p in self._inner._parameter_list if p.requires_grad]

    def sync_params(self):
        """Average the trainable parameters over the data-parallel ranks
        (in a one-process world the mean over ``{self}``), counted."""
        from paddle_tpu_torch.distributed import collective

        self._sync_count += 1
        group = _dp_group()
        n = collective._comm(group).size
        if n <= 1:
            return
        with torch.no_grad():
            for p in self._params():
                collective.all_reduce(p.data, group=group)
                p.data.div_(n)


class AdaptiveLocalSGDOptimizer(LocalSGDOptimizer):
    """Adaptive variant: ``k = init_k * sqrt((lr0 / lr) * (loss /
    loss0))`` clamped to ``[1, max_k_steps]``. Call ``set_loss(loss)``
    after each step (one host read of the loss)."""

    def __init__(self, inner, init_k_steps: int = 1, begin_step: int = 1,
                 max_k_steps: int = 16):
        super().__init__(inner, k_steps=init_k_steps, begin_step=begin_step)
        self.init_k_steps = max(int(init_k_steps), 1)
        self.max_k_steps = max(int(max_k_steps), 1)
        self._base_loss: Optional[float] = None
        self._base_lr: Optional[float] = None

    def _lr(self) -> float:
        get = getattr(self._inner, "get_lr", None)
        try:
            return float(get()) if get is not None else 1.0
        except Exception:
            return 1.0

    def set_loss(self, loss):
        val = float(loss.detach().float().cpu()) if isinstance(
            loss, torch.Tensor) else float(np.asarray(loss))
        if self._base_loss is None:
            self._base_loss = max(val, 1e-12)
            self._base_lr = max(self._lr(), 1e-12)
        ratio = ((self._base_lr / max(self._lr(), 1e-12))
                 * (max(val, 0.0) / self._base_loss))
        self.k_steps = int(np.clip(round(np.sqrt(ratio) * self.init_k_steps),
                                   1, self.max_k_steps))
