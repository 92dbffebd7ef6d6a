"""``fleet`` of the port: ``utils.recompute`` (activation
rematerialization), the ``DistributedStrategy`` tree, and the optimizer
side of the facade of ``paddle_tpu/distributed/fleet/__init__.py``:
``distributed_optimizer``, ``HybridParallelOptimizer``, ``fleet_state``
and the LocalSGD meta-optimizers (``meta_optimizers``).

``distributed_optimizer`` picks, in the reference's order: adaptive
LocalSGD, then Lars in place of a ``Momentum``, then LocalSGD, then the
plain wrapper. The wrappers delegate everything else to the optimizer
they hold (``inner_opt``), so ``ShardedTrainer`` trains through them.

``init``, ``distributed_model``, the topology and the process
environment build a mesh: they are ROADMAP.md Queue 1 item 6 and raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.distributed.fleet import meta_optimizers, utils
from paddle_tpu_torch.distributed.strategy import DistributedStrategy

__all__ = ["utils", "meta_optimizers", "DistributedStrategy", "init",
           "is_initialized", "distributed_model", "distributed_optimizer",
           "HybridParallelOptimizer", "fleet_state"]

_MESH = ("the hybrid topology and its mesh are ROADMAP.md Queue 1 item 6; "
         "the port trains on one card")


class _FleetState:
    def __init__(self):
        self.initialized = False
        self.strategy: Optional[DistributedStrategy] = None
        self.topology = None
        self.hcg = None
        self.mesh = None


_state = _FleetState()


def fleet_state() -> _FleetState:
    return _state


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, log_level="INFO"):
    """``fleet.init`` builds the hybrid topology and its mesh: not ported
    yet."""
    raise NotImplementedError(f"fleet.init: {_MESH}")


def is_initialized() -> bool:
    return _state.initialized


def distributed_model(model, loss_fn=None):
    """``fleet.distributed_model`` wraps a model for the mesh: not ported
    yet."""
    raise NotImplementedError(f"fleet.distributed_model: {_MESH}")


def distributed_optimizer(optimizer, strategy=None):
    """Wrap ``optimizer`` as ``strategy`` (default: the fleet's) asks:
    adaptive LocalSGD, Lars over a ``Momentum``, LocalSGD, else the plain
    ``HybridParallelOptimizer``."""
    strategy = strategy or _state.strategy
    if strategy is not None and getattr(strategy, "adaptive_localsgd", False):
        c = strategy.adaptive_localsgd_configs
        return meta_optimizers.AdaptiveLocalSGDOptimizer(
            optimizer, init_k_steps=c.init_k_steps, begin_step=c.begin_step,
            max_k_steps=c.max_k_steps)
    if strategy is not None and getattr(strategy, "lars", False):
        from paddle_tpu_torch.optimizer import Lars, Momentum

        if isinstance(optimizer, Momentum):
            c = strategy.lars_configs
            lars = Lars(learning_rate=optimizer._learning_rate,
                        momentum=optimizer._momentum,
                        lars_coeff=c.lars_coeff,
                        lars_weight_decay=c.lars_weight_decay,
                        epsilon=c.epsilon,
                        exclude_from_weight_decay=c.exclude_from_weight_decay,
                        parameters=[p for g in optimizer._param_groups
                                    for p in g["params"]],
                        grad_clip=optimizer._grad_clip)
            return HybridParallelOptimizer(lars, _state)
    if strategy is not None and getattr(strategy, "localsgd", False):
        c = strategy.localsgd_configs
        return meta_optimizers.LocalSGDOptimizer(
            optimizer, k_steps=c.k_steps, begin_step=c.begin_step)
    return HybridParallelOptimizer(optimizer, _state)


class HybridParallelOptimizer:
    """Holds the inner optimizer (``inner_opt``) and delegates to it; on
    one card there is no gradient to synchronise across groups, and the
    global-norm clip is the inner optimizer's own."""

    def __init__(self, inner, state: _FleetState):
        self._inner = inner
        self._state = state

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def inner_opt(self):
        return self._inner

    def step(self):
        self._inner.step()

    def clear_grad(self):
        self._inner.clear_grad()
