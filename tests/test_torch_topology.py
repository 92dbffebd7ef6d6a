"""The port's hybrid topology and mesh arithmetic against the JAX
package's, with no process group: ``CommunicateTopology``'s coordinates
and comm lists and ``HybridCommunicateGroup``'s view equal the
reference's for several shapes (``tests/test_distributed.py:24-69``);
the port's ``Mesh`` slices, windows and first replicas follow the same
rank order; ``ShardedTrainer``'s ZeRO layout (``_extend_with_sharding``)
picks the dims the JAX trainer picks; ``fleet.init``'s ``pp`` and
``sep`` topologies equal the reference's, and a world too small for its
degrees raises before joining. All exact.
"""

import itertools
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import (CommunicateTopology,
                                          DistributedStrategy,
                                          HybridCommunicateGroup, fleet)
from paddle_tpu_torch.distributed.env import Mesh
from paddle_tpu_torch.distributed.trainer import _extend_with_sharding

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

NAMES = ["data", "pipe", "sharding", "model"]
SHAPES = [[2, 2, 1, 2], [2, 1, 1, 4], [1, 1, 2, 2], [2, 1, 2, 1],
          [4, 1, 1, 1], [1, 2, 2, 2]]


def _mesh_at(dims, rank):
    """The port's mesh as rank ``rank`` sees it (no process group)."""
    mesh = Mesh(np.arange(int(np.prod(dims))).reshape(dims),
                ["dp", "pp", "sharding", "mp"])
    mesh.rank = rank
    mesh.coord = dict(zip(mesh.axis_names, map(int, np.argwhere(
        mesh.devices == rank)[0])))
    return mesh


@pytest.mark.parametrize("dims", SHAPES)
def test_topology_matches_the_reference(dims):
    from paddle_tpu.distributed import CommunicateTopology as JaxTopology
    from paddle_tpu.distributed import HybridCommunicateGroup as JaxHcg

    mine, ref = CommunicateTopology(NAMES, dims), JaxTopology(NAMES, dims)
    assert mine.world_size() == ref.world_size()
    for r in range(ref.world_size()):
        assert mine.get_coord(r) == ref.get_coord(r)
        assert mine.get_rank(**dict(zip(NAMES, ref.get_coord(r)))) == r
    for name in NAMES:
        assert mine.get_comm_list(name) == ref.get_comm_list(name)
        for i in range(ref.get_dim(name)):
            assert mine.get_axis_list(name, i) == ref.get_axis_list(name, i)
    for r in range(ref.world_size()):
        a, b = HybridCommunicateGroup(mine, r), JaxHcg(ref, r)
        for m in ("get_data_parallel_rank", "get_model_parallel_rank",
                  "get_stage_id", "get_sharding_parallel_rank",
                  "get_data_parallel_world_size",
                  "get_model_parallel_world_size", "is_first_stage",
                  "is_last_stage", "get_p2p_groups"):
            assert getattr(a, m)() == getattr(b, m)(), m
        for g in ("data", "model", "pipe", "sharding"):
            getter = {"data": "get_data_parallel_group",
                      "model": "get_model_parallel_group",
                      "pipe": "get_pipe_parallel_group",
                      "sharding": "get_sharding_parallel_group"}[g]
            mg, rg = getattr(a, getter)(), getattr(b, getter)()
            assert mg.ranks == rg.ranks and mg.axis_name == rg.axis_name


@pytest.mark.parametrize("dims", SHAPES)
def test_mesh_slices_windows_and_replicas(dims):
    """The mesh's slices over any set of axes are the topology's comm
    lists (one axis) and their products; a rank's window of a spec is
    its block in the reference's tuple order; exactly one rank of each
    window is its first replica."""
    topo = CommunicateTopology(NAMES, dims)
    axes = ["dp", "pp", "sharding", "mp"]
    world = int(np.prod(dims))
    shape = (24, 16)
    specs = [(None, "mp"), ("mp", None), (("mp", "sharding"), None),
             ("sharding", "mp"), (), (("dp", "sharding"),)]
    for r in range(world):
        mesh = _mesh_at(dims, r)
        for name, axis in zip(NAMES, axes):
            if dims[axes.index(axis)] > 1:
                assert mesh.comm_list(axis) == topo.get_comm_list(name)
                assert mesh.index(axis) == topo.get_coord(r)[
                    axes.index(axis)]
        for spec in specs:
            win = mesh.window(spec, shape)
            for d, (a, b) in enumerate(win):
                named = [x for x in (spec[d] if d < len(spec) else None,)
                         if x is not None]
                tup = named[0] if named and isinstance(named[0], tuple) \
                    else tuple(named)
                live = [x for x in tup if mesh.shape[x] > 1]
                count = int(np.prod([mesh.shape[x] for x in live]))
                idx = 0
                for x in live:
                    idx = idx * mesh.shape[x] + mesh.coord[x]
                assert (a, b) == (idx * shape[d] // count,
                                  (idx + 1) * shape[d] // count)
    for spec in specs:
        seen = {}
        for r in range(world):
            mesh = _mesh_at(dims, r)
            key = str(mesh.window(spec, shape))
            seen[key] = seen.get(key, 0) + mesh.is_first_replica(spec)
        assert set(seen.values()) == {1}


@pytest.mark.parametrize("dims,shape,spec", [
    ([1, 1, 2, 2], (64, 192), (None, "mp")),
    ([1, 1, 2, 2], (192, 64), ("mp", None)),
    ([1, 1, 2, 2], (256, 64), ("mp", None)),
    ([1, 1, 4, 1], (6, 4), ()),
    ([1, 1, 4, 2], (6, 16), (None, "mp")),
    ([1, 1, 2, 1], (3, 5), ()),
    ([2, 1, 2, 1], (64,), ()),
    ([1, 1, 2, 2], (192,), ("mp",)),
])
def test_zero_layout_matches_the_jax_trainer(dims, shape, spec):
    """``_extend_with_sharding`` adds ``sharding`` where the JAX trainer
    does: the largest free dim the degree divides, else a sub-shard of
    an occupied dim, else none."""
    import jax
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.distributed import ShardedTrainer as JaxTrainer
    from paddle_tpu.distributed import build_mesh

    jmesh = build_mesh(dims, ["dp", "pp", "sharding", "mp"],
                       devices=jax.devices()[:int(np.prod(dims))])

    class _T:
        mesh = jmesh

    class _Pm:
        name = "p"

    _Pm.shape = shape
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the large-replica warning
        want = JaxTrainer._extend_with_sharding(_T(), P(*spec), _Pm())
        got = _extend_with_sharding(
            tuple(spec) + (None,) * (len(shape) - len(spec)), shape,
            _mesh_at(dims, 0), "p")
    norm = tuple(got)
    while norm and norm[-1] is None:
        norm = norm[:-1]
    assert norm == tuple(want)


@pytest.mark.parametrize("configs,name", [
    ({"pp_degree": 2}, "pp_degree"), ({"sep_degree": 2}, "sep_degree")])
def test_fleet_init_refuses_the_pipeline_and_sep(configs, name):
    """``fleet.init`` with ``pp_degree`` or ``sep_degree`` 2 (refused
    until the pipeline and the sequence axis were ported): over eight
    ranks it lays out the topology the JAX ``fleet.init`` builds on
    eight devices (dp absorbing the rest; ``sep`` the fifth axis), whose
    stage ids, first and last stages and p2p neighbours equal the
    reference's on every rank; in a world of one rank it raises the
    reference's ``ValueError`` before joining any process group."""
    from paddle_tpu.distributed import CommunicateTopology as JaxTopology
    from paddle_tpu.distributed import HybridCommunicateGroup as JaxHcg

    strategy = DistributedStrategy()
    strategy.hybrid_configs = configs
    names, dims = ((NAMES, [4, 2, 1, 1]) if name == "pp_degree"
                   else (NAMES + ["sep"], [4, 1, 1, 1, 2]))
    mine, ref = CommunicateTopology(names, dims), JaxTopology(names, dims)
    assert mine.get_hybrid_group_names() == ref.get_hybrid_group_names()
    for r in range(8):
        assert mine.get_coord(r) == ref.get_coord(r)
        a, b = HybridCommunicateGroup(mine, r), JaxHcg(ref, r)
        for m in ("get_stage_id", "is_first_stage", "is_last_stage",
                  "get_p2p_groups", "get_pipe_parallel_world_size",
                  "get_data_parallel_world_size"):
            assert getattr(a, m)() == getattr(b, m)(), m
        assert a.get_pipe_parallel_group().ranks == \
            b.get_pipe_parallel_group().ranks
    with pytest.raises(ValueError, match="need 2 ranks but the world has 1"):
        fleet.init(is_collective=True, strategy=strategy)
    assert not fleet.is_initialized()
    assert not torch.distributed.is_initialized()


def test_comm_list_orders_every_axis_set_like_the_reference():
    """A set of axes' slices vary those axes (the first slowest) and fix
    the rest: for one axis they are ``get_comm_list``'s."""
    dims = [2, 1, 2, 2]
    mesh = _mesh_at(dims, 0)
    topo = CommunicateTopology(NAMES, dims)
    for k in (1, 2, 3):
        for axes in itertools.combinations(["dp", "sharding", "mp"], k):
            lists = mesh.comm_list(axes)
            flat = sorted(r for lst in lists for r in lst)
            assert flat == list(range(8))
            for lst in lists:
                coords = [topo.get_coord(r) for r in lst]
                fixed = [i for i, a in enumerate(["dp", "pp", "sharding",
                                                  "mp"]) if a not in axes]
                assert len({tuple(c[i] for i in fixed)
                            for c in coords}) == 1
                assert coords == sorted(coords)
