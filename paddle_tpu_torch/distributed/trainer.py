"""Single-device trainer with the ``ShardedTrainer`` contract of
``paddle_tpu/distributed/trainer.py`` (:60, :389-430, :800-862).

``train_step(*batch)``: the last element of ``batch`` is the label when
a ``loss_fn`` is given (``loss_fn(model(*inputs), label)``); with
``loss_fn=None`` the model's own output is the loss (``GPTForCausalLM
(ids, labels)``'s fused head and cross entropy). The loss is reduced to
a mean in fp32. One step runs the forward under ``auto_cast`` when
``amp`` is on, then the backward, then ``optimizer.step()`` and
``clear_grad()``. It returns the loss as a 0-dim tensor on the model's
device without reading it back, so steps queue on the card back to
back.

The JAX trainer compiles one SPMD program over a mesh. The port runs
eagerly on the model's device (``cuda`` unless the model was built on
the CPU). A mesh of more than one device, a strategy (gradient merge,
ZeRO, sequence parallelism), recompute and the anomaly policy are later
work and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from paddle_tpu_torch.amp.auto_cast import auto_cast
from paddle_tpu_torch.core.place import get_device

__all__ = ["ShardedTrainer"]


class ShardedTrainer:
    def __init__(self, model, optimizer, loss_fn: Optional[Callable] = None,
                 mesh=None, strategy=None, batch_spec=None,
                 recompute: bool = False, amp: bool = False,
                 amp_dtype: str = "bfloat16"):
        if mesh is not None and getattr(mesh, "size", 1) != 1:
            raise NotImplementedError(
                "ShardedTrainer: meshes of more than one device are not "
                "ported yet (the port trains on one card)")
        if strategy is not None or batch_spec is not None:
            raise NotImplementedError(
                "ShardedTrainer: distributed strategies (gradient merge, "
                "ZeRO, sequence parallelism) are not ported yet")
        if recompute:
            raise NotImplementedError(
                "ShardedTrainer: recompute is not ported yet")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.amp = amp
        self.amp_dtype = amp_dtype
        self.device = get_device(model)

    def enable_anomaly_policy(self, config=None, **kwargs):
        raise NotImplementedError(
            "ShardedTrainer: the anomaly policy is not ported yet")

    def train_step(self, *batch) -> torch.Tensor:
        """Run one step; returns the (pre-update) loss as a 0-dim fp32
        tensor on the model's device."""
        batch = tuple(torch.as_tensor(b).to(self.device, non_blocking=True)
                      for b in batch)
        with auto_cast(enable=self.amp, dtype=self.amp_dtype):
            if self.loss_fn is not None:
                *xs, label = batch
                res = self.loss_fn(self.model(*xs), label)
            else:
                res = self.model(*batch)
        loss = res.float().mean()
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach()
