"""Hybrid-parallel topology — the port of
``paddle_tpu/distributed/topology.py``.

``CommunicateTopology`` is the reference's rank arithmetic unchanged: a
cartesian rank grid over named axes, rank order ``itertools.product`` of
the axes (the last axis fastest), so every rank's coordinate, and with
it its slice of the batch and of each sharded tensor, is the
reference's. ``HybridCommunicateGroup`` is one rank's view of it. Its
groups are :class:`~paddle_tpu_torch.distributed.collective.Group`\\ s
over the rank lists of ``get_comm_list``, carrying the mesh axis name;
once the fleet's mesh is built, collectives on such a group run over
that mesh axis's process group.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names: Sequence[str] = ("data", "pipe", "sharding", "model"),
                 dims: Sequence[int] = (1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self._coord_list = list(itertools.product(*(range(d) for d in dims)))
        self._coord2rank = {c: i for i, c in enumerate(self._coord_list)}
        self._rank2coord = {i: c for c, i in self._coord2rank.items()}

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs) -> int:
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return self._coord2rank[coord]

    def get_coord(self, rank: int) -> Tuple[int, ...]:
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """All ranks whose coordinate on ``axis_name`` equals ``index``."""
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord2rank.items() if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """Groups of ranks that communicate along ``axis_name`` (vary that
        axis, fix the others)."""
        axis = self._parallel_names.index(axis_name)
        other_axes = [i for i in range(len(self._dims)) if i != axis]
        groups = []
        for fixed in itertools.product(*(range(self._dims[i]) for i in other_axes)):
            ranks = []
            for v in range(self._dims[axis]):
                coord = [0] * len(self._dims)
                for i, o in zip(other_axes, fixed):
                    coord[i] = o
                coord[axis] = v
                ranks.append(self._coord2rank[tuple(coord)])
            groups.append(ranks)
        return groups

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        coord = list(self.get_coord(global_rank))
        for name, v in kwargs.items():
            coord[self._parallel_names.index(name)] = v
        return self._coord2rank[tuple(coord)]


_AXIS = {"data": "dp", "pipe": "pp", "sharding": "sharding", "model": "mp",
         "sep": "sep"}


class HybridCommunicateGroup:
    """One rank's view of the hybrid topology: its degrees, its index on
    each axis, and its group along each axis."""

    def __init__(self, topology: CommunicateTopology,
                 global_rank: Optional[int] = None):
        from paddle_tpu_torch.distributed import env as dist_env

        self._topo = topology
        self.global_rank = (global_rank if global_rank is not None
                            else dist_env.get_rank())
        self.nranks = topology.world_size()

        names = topology.get_hybrid_group_names()
        self._dp_degree = topology.get_dim("data") if "data" in names else 1
        self._pp_degree = topology.get_dim("pipe") if "pipe" in names else 1
        self._sharding_degree = (topology.get_dim("sharding")
                                 if "sharding" in names else 1)
        self._mp_degree = topology.get_dim("model") if "model" in names else 1
        self._sep_degree = topology.get_dim("sep") if "sep" in names else 1

        coord = topology.get_coord(self.global_rank)
        self._coord = dict(zip(names, coord))

    # degrees --------------------------------------------------------------
    def get_data_parallel_world_size(self) -> int:
        return self._dp_degree

    def get_model_parallel_world_size(self) -> int:
        return self._mp_degree

    def get_pipe_parallel_world_size(self) -> int:
        return self._pp_degree

    def get_sharding_parallel_world_size(self) -> int:
        return self._sharding_degree

    # ranks-in-group -------------------------------------------------------
    def _axis_rank(self, name: str) -> int:
        return self._coord.get(name, 0)

    def get_data_parallel_rank(self) -> int:
        return self._axis_rank("data")

    def get_model_parallel_rank(self) -> int:
        return self._axis_rank("model")

    def get_stage_id(self) -> int:
        return self._axis_rank("pipe")

    def get_sharding_parallel_rank(self) -> int:
        return self._axis_rank("sharding")

    # group rank lists -----------------------------------------------------
    def _group_ranks(self, name: str) -> List[int]:
        for ranks in self._topo.get_comm_list(name):
            if self.global_rank in ranks:
                return ranks
        return [self.global_rank]

    def _group(self, name: str):
        from paddle_tpu_torch.distributed.collective import Group

        ranks = self._group_ranks(name) if name in \
            self._topo.get_hybrid_group_names() else [self.global_rank]
        return Group(ranks, axis_name=_AXIS[name])

    def get_data_parallel_group(self):
        return self._group("data")

    def get_model_parallel_group(self):
        return self._group("model")

    def get_pipe_parallel_group(self):
        return self._group("pipe")

    def get_sharding_parallel_group(self):
        return self._group("sharding")

    def get_check_parallel_group(self):
        from paddle_tpu_torch.distributed.collective import Group

        return Group(list(range(self.nranks)), axis_name=None)

    # p2p neighbours (pipeline) --------------------------------------------
    def is_first_stage(self) -> bool:
        return self.get_stage_id() == 0

    def is_last_stage(self) -> bool:
        return self.get_stage_id() == self._pp_degree - 1

    def get_p2p_groups(self):
        stage = self.get_stage_id()
        prev_stage = (stage - 1) % self._pp_degree
        next_stage = (stage + 1) % self._pp_degree
        prev_rank = self._topo.get_rank_from_stage(self.global_rank,
                                                   pipe=prev_stage)
        next_rank = self._topo.get_rank_from_stage(self.global_rank,
                                                   pipe=next_stage)
        return prev_rank, next_rank

    # the mesh ---------------------------------------------------------------
    def build_mesh(self, devices=None, axis_map=None):
        """The topology as a :class:`~paddle_tpu_torch.distributed.env.
        Mesh`: axes ``[dp, pp, sharding, mp]`` (+ ``sep``) over the ranks
        ``devices`` (default every rank), dp outermost."""
        from paddle_tpu_torch.distributed import env as dist_env

        names = self._topo.get_hybrid_group_names()
        axis_map = axis_map or _AXIS
        dims = [self._topo.get_dim(n) for n in names]
        return dist_env.build_mesh(dims, [axis_map[n] for n in names],
                                   devices=devices)
