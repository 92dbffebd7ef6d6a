"""``fleet`` of the port — ``paddle_tpu/distributed/fleet/__init__.py``:
``utils.recompute``, the ``DistributedStrategy`` tree, the LocalSGD
meta-optimizers (``meta_optimizers``), and the facade: ``init`` builds
the hybrid topology and its mesh, ``distributed_model`` and
``distributed_optimizer`` wrap the model and the optimizer for it.

``init`` reads the degrees of ``strategy.hybrid_configs`` (``dp``,
``pp``, ``sharding``, ``mp``, and ``sep`` as a fifth axis when above
1), lets dp absorb the ranks the others leave (``world % product ==
0``, as at the reference's ``:66-79``), joins the process group
(``init_parallel_env``; degrees the world cannot hold raise first, so
no group is left behind), and builds the ``CommunicateTopology``, this
rank's ``HybridCommunicateGroup`` and the mesh ``[dp, pp, sharding,
mp(, sep)]``, which becomes the global mesh (``env.set_mesh``).
``distributed_model`` wraps any model, a pipeline included: its
``train_batch`` runs the ``ShardedTrainer`` step, which drives the
pipeline's schedule over ``pp``.

``distributed_optimizer`` picks, in the reference's order: adaptive
LocalSGD, then Lars in place of a ``Momentum``, then LocalSGD, then the
plain wrapper. The wrappers delegate everything else to the optimizer
they hold (``inner_opt``), so ``ShardedTrainer`` trains through them;
``HybridParallelOptimizer`` adds nothing to the step itself: the
trainer synchronises the gradients over the mesh and the clip takes
the global norm over it.
"""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.distributed.fleet import meta_optimizers, utils
from paddle_tpu_torch.distributed.strategy import DistributedStrategy

__all__ = ["utils", "meta_optimizers", "DistributedStrategy", "init",
           "is_initialized", "get_hybrid_communicate_group",
           "distributed_model", "distributed_optimizer", "worker_index",
           "worker_num", "get_mesh", "HybridParallelOptimizer",
           "fleet_state"]


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
    """Join the process group and build the topology and the global mesh
    from the strategy's hybrid degrees over the world's ranks."""
    import copy

    from paddle_tpu_torch.distributed import env as dist_env
    from paddle_tpu_torch.distributed.topology import (
        CommunicateTopology, HybridCommunicateGroup)

    # work on a copy: the effective degrees (dp absorbing leftover ranks)
    # must not rewrite the caller's config object
    strategy = copy.deepcopy(strategy) if strategy is not None \
        else DistributedStrategy()
    hc = strategy.hybrid_configs
    # the world init_parallel_env will join (the launcher's, else one)
    world = dist_env.ParallelEnv().world_size
    degrees = {"data": hc.dp_degree, "pipe": hc.pp_degree,
               "sharding": hc.sharding_degree, "model": hc.mp_degree}
    if hc.sep_degree > 1:
        degrees["sep"] = hc.sep_degree
    specified = 1
    for v in degrees.values():
        specified *= v
    if specified < world and world % specified == 0:
        # dp absorbs the remaining ranks (the reference launcher computes
        # dp from world_size the same way)
        degrees["data"] *= world // specified
        hc.dp_degree = degrees["data"]
    elif specified != world:
        raise ValueError(
            f"hybrid degrees {degrees} need {specified} ranks but the "
            f"world has {world}")
    dist_env.init_parallel_env()
    names = list(degrees)
    topo = CommunicateTopology(names, [degrees[n] for n in names])
    _state.strategy = strategy
    _state.topology = topo
    _state.hcg = HybridCommunicateGroup(topo)
    _state.mesh = _state.hcg.build_mesh()
    dist_env.set_mesh(_state.mesh)
    _state.initialized = True
    return _state


def is_initialized() -> bool:
    return _state.initialized


def get_hybrid_communicate_group():
    return _state.hcg


def get_mesh():
    return _state.mesh


def worker_index() -> int:
    from paddle_tpu_torch.distributed import env as dist_env

    return dist_env.get_rank()


def worker_num() -> int:
    from paddle_tpu_torch.distributed import env as dist_env

    return dist_env.get_world_size()


def distributed_model(model, loss_fn=None):
    """Wrap ``model`` for the fleet's mesh: a ``DistributedModel`` whose
    ``train_batch`` runs a ``ShardedTrainer`` over it once an optimizer
    is attached (``prepare``)."""
    from paddle_tpu_torch.distributed.parallel import DistributedModel

    if not _state.initialized:
        raise RuntimeError("call fleet.init() first")
    return DistributedModel(model, _state, loss_fn=loss_fn)


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
    """Holds the inner optimizer (``inner_opt``) and delegates to it; the
    trainer synchronises the gradients over the mesh, and the inner
    optimizer's global-norm clip takes its norm over the bound mesh
    (``nn/clip.py``)."""

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
