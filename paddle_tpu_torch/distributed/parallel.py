"""Distributed model wrappers — the port of
``paddle_tpu/distributed/parallel.py``.

:class:`DataParallel` is paddle's eager data parallelism over
``torch.distributed``: the wrapped layers stay whole on every rank, each
rank runs its own part of the batch, and each parameter's gradient is
averaged over the group as soon as it is accumulated in the backward
(a post-accumulate-grad hook per parameter, firing in the same order on
every rank). The group is ``group``, else the fleet's data-parallel axis
when ``fleet.init`` ran, else the whole world. The parameters are
broadcast from the group's first rank when the wrapper is built, so the
ranks start alike. ``scale_loss`` returns the loss as it is and
``apply_collective_grads`` does nothing: the hooks already averaged, as
the reference's Reducer does.

:class:`DistributedModel` is ``fleet.distributed_model``'s product:
``prepare(optimizer, loss_fn)`` builds a ``ShardedTrainer`` over the
fleet's mesh, ``train_batch(batch)`` runs one of its steps on the global
batch, and ``forward`` runs the layers, under the trainer's mesh once it
exists (its parameters are then this rank's shards).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from paddle_tpu_torch.nn.layer import Layer

__all__ = ["DataParallel", "DistributedModel"]


class DataParallel(Layer):
    """Replicated layers with gradients averaged over the data-parallel
    group in the backward."""

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size: int = 25,
                 last_comm_buffer_size: int = 1,
                 find_unused_parameters: bool = False, group=None):
        super().__init__()
        from paddle_tpu_torch.distributed import collective

        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self._group = group if group is not None else self._fleet_group()
        comm = collective._comm(self._group)
        self._nranks = comm.size
        self._hooks = []
        if comm.size > 1:
            src = comm.ranks[0]
            with torch.no_grad():
                for p in layers.parameters():
                    collective.broadcast(p.data, src=src, group=self._group)
            for p in layers.parameters():
                if p.requires_grad:
                    self._hooks.append(
                        p.register_post_accumulate_grad_hook(self._average))

    @staticmethod
    def _fleet_group():
        from paddle_tpu_torch.distributed import fleet

        hcg = fleet.get_hybrid_communicate_group()
        if hcg is None or fleet.get_mesh() is None:
            return None
        return hcg.get_data_parallel_group()

    def _average(self, p):
        from paddle_tpu_torch.distributed import collective

        collective.all_reduce(p.grad, group=self._group)
        p.grad.div_(self._nranks)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass


class DistributedModel(Layer):
    """fleet.distributed_model product: routes train_batch through a
    ShardedTrainer over the fleet mesh."""

    def __init__(self, layers: Layer, fleet_state, loss_fn: Optional[Callable] = None):
        super().__init__()
        self._layers = layers
        self._fleet_state = fleet_state
        self._loss_fn = loss_fn
        self._trainer = None

    def forward(self, *inputs, **kwargs):
        if self._trainer is None:
            return self._layers(*inputs, **kwargs)
        return self._trainer._in_mesh(self._layers, *inputs, **kwargs)

    def prepare(self, optimizer, loss_fn: Optional[Callable] = None):
        """Bind the optimizer (and loss) and build the trainer over the
        fleet's mesh."""
        from paddle_tpu_torch.distributed.fleet import HybridParallelOptimizer
        from paddle_tpu_torch.distributed.trainer import ShardedTrainer

        inner = optimizer.inner_opt if isinstance(
            optimizer, HybridParallelOptimizer) else optimizer
        self._trainer = ShardedTrainer(
            self._layers, inner, loss_fn or self._loss_fn,
            mesh=self._fleet_state.mesh,
            strategy=self._fleet_state.strategy)
        return self

    def train_batch(self, batch, optimizer=None, lr_scheduler=None,
                    scaler=None):
        """One hybrid-parallel training step on the global ``batch``
        (inputs..., labels); returns the global mean loss."""
        from paddle_tpu_torch.core.unported import refuse_unported

        refuse_unported("DistributedModel.train_batch", scaler=(scaler, None))
        if self._trainer is None:
            if optimizer is None:
                raise RuntimeError("call prepare(optimizer, loss_fn) or pass "
                                   "optimizer to train_batch")
            self.prepare(optimizer)
        loss = self._trainer.train_step(*batch)
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    @property
    def trainer(self):
        return self._trainer

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)
