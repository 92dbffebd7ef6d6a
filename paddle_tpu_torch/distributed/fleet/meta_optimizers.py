"""Fleet meta-optimizers that wrap a user optimizer with a periodic
cross-worker behavior: the port of
``paddle_tpu/distributed/fleet/meta_optimizers.py`` (the reference's
``fleet/meta_optimizers/localsgd_optimizer.py``).

LocalSGD takes ``k_steps`` purely local optimizer steps, then averages
the parameters across workers. The port trains on one card in one
process: there ``sync_params`` counts and returns, as the reference's
does in a one-process world (the mean over ``{self}``). Averaging across
processes needs the mesh of ROADMAP.md Queue 1 item 6: with
``torch.distributed`` initialised over more than one rank, ``sync_params``
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["LocalSGDOptimizer", "AdaptiveLocalSGDOptimizer"]


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


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
        """Average the trainable parameters across processes: in a
        one-process world the mean over ``{self}``, counted."""
        self._sync_count += 1
        if _world_size() <= 1:
            return
        raise NotImplementedError(
            "LocalSGD parameter averaging across processes needs the mesh "
            "of ROADMAP.md Queue 1 item 6; the port trains on one card")


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
