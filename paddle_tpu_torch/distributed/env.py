"""The process environment and the mesh — the port of
``paddle_tpu/distributed/env.py``.

The reference is single-controller: one process drives every device of
a JAX ``Mesh``. The port is SPMD: one process per rank, each running the
same script, joined by ``torch.distributed``. So:

- :class:`ParallelEnv` reads the launcher's contract
  (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``,
  ``PADDLE_MASTER``, ``PADDLE_CURRENT_ENDPOINT``,
  ``PADDLE_TRAINER_ENDPOINTS``), falling back on the process group once
  one exists;
- :func:`init_parallel_env` calls ``torch.distributed.init_process_group``
  over ``PADDLE_MASTER`` (``host:port`` becomes ``tcp://host:port``; a
  ``tcp://`` or ``file://`` URL is taken as it is). The backend is NCCL,
  each rank on ``cuda:{local_rank % device_count}``. Gloo is used only
  when the caller names it (``backend="gloo"``) or after
  ``set_device("cpu")``; an NCCL failure raises, it never falls back to
  gloo. A one-process world with no master gets a one-rank group on a
  free local port;
- :class:`Mesh` is the port's stand-in for ``jax.sharding.Mesh``: the
  rank grid (``devices``), ``axis_names``, ``shape[axis]``, ``size``,
  and this rank's coordinate. :func:`build_mesh` creates one process
  group for every set of axes of size > 1 (``get_comm_list``'s slices,
  every rank creating every group in the same order, as
  ``torch.distributed.new_group`` requires), and :meth:`Mesh.group`
  hands out this rank's group of any such set.

Inside :func:`_mesh_scope` a mesh is *bound*, as a ``shard_map`` binds
its axes in the reference: collectives named by ``axis_name`` resolve to
the bound mesh's groups, and the tensor-parallel layers run their
explicit collectives (``meta_parallel.mp_layers.axis_in_scope``). The
trainer binds its mesh around each of its steps.
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import os
import socket
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "init_parallel_env", "is_initialized", "get_rank", "get_world_size",
    "get_mesh", "set_mesh", "build_mesh", "ParallelEnv",
]

_GLOBAL: Dict[str, object] = {"initialized": False, "mesh": None}
# the bound meshes, innermost last: process-wide, since the backward of a
# card's tensors runs on autograd's own thread
_BOUND: List["Mesh"] = []
DEFAULT_TIMEOUT_S = 600.0


def _dist_on() -> bool:
    return dist.is_available() and dist.is_initialized()


class ParallelEnv:
    """paddle.distributed.ParallelEnv: the launcher's environment, else
    the process group's."""

    @property
    def rank(self) -> int:
        if "PADDLE_TRAINER_ID" in os.environ:
            return int(os.environ["PADDLE_TRAINER_ID"])
        return dist.get_rank() if _dist_on() else 0

    @property
    def world_size(self) -> int:
        if "PADDLE_TRAINERS_NUM" in os.environ:
            return int(os.environ["PADDLE_TRAINERS_NUM"])
        return dist.get_world_size() if _dist_on() else 1

    @property
    def local_rank(self) -> int:
        return int(os.environ.get("PADDLE_LOCAL_RANK", self.rank))

    @property
    def device_id(self) -> int:
        """This rank's card: ``local_rank % device_count`` (0 without a
        card)."""
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return self.local_rank % n if n else 0

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self) -> List[str]:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_method(coord: Optional[str]) -> str:
    if not coord:
        return f"tcp://127.0.0.1:{_free_port()}"
    if "://" in coord:
        return coord
    return f"tcp://{coord}"


def _default_backend() -> str:
    from paddle_tpu_torch.core.place import get_default_place

    return "gloo" if get_default_place().platform == "cpu" else "nccl"


def init_parallel_env(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None, *,
                      backend: Optional[str] = None,
                      timeout: Optional[float] = None):
    """Join the process group (once; later calls return the environment).

    ``coordinator_address`` (default ``PADDLE_MASTER``), ``num_processes``
    (``PADDLE_TRAINERS_NUM``, else 1) and ``process_id``
    (``PADDLE_TRAINER_ID``, else 0) as the reference reads them.
    ``backend``: ``"nccl"`` (the default) or ``"gloo"`` (named, or the
    default after ``set_device("cpu")``). ``timeout`` in seconds bounds
    every collective of the group (default 600)."""
    if _GLOBAL["initialized"] and _dist_on():
        return ParallelEnv()
    coord = coordinator_address or os.environ.get("PADDLE_MASTER")
    nprocs = int(num_processes or os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    pid = int(process_id if process_id is not None
              else os.environ.get("PADDLE_TRAINER_ID", "0"))
    backend = backend or _default_backend()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if not _dist_on():
        kwargs = {}
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "init_parallel_env: the NCCL backend needs a card and "
                    "none is available; name backend='gloo' (or call "
                    "set_device('cpu')) to run the ranks on the CPU")
            dev = torch.device("cuda", ParallelEnv().device_id)
            torch.cuda.set_device(dev)
            kwargs["device_id"] = dev
        dist.init_process_group(
            backend, init_method=_init_method(coord), rank=pid,
            world_size=nprocs,
            timeout=datetime.timedelta(
                seconds=timeout if timeout is not None else DEFAULT_TIMEOUT_S),
            **kwargs)
    _GLOBAL["initialized"] = True
    return ParallelEnv()


def is_initialized() -> bool:
    return bool(_GLOBAL["initialized"]) and _dist_on()


def get_rank(group=None) -> int:
    if group is not None:
        return group.get_group_rank(ParallelEnv().rank)
    return ParallelEnv().rank


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    return ParallelEnv().world_size


# -- the mesh ----------------------------------------------------------------

class Mesh:
    """A grid of ranks over named axes (the port's ``jax.sharding.Mesh``):
    ``devices`` is the rank grid, ``shape`` maps each axis to its size.
    ``coord[axis]`` is this process's index on ``axis``; :meth:`group`
    its process group over a set of axes (None where the set spans one
    rank)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"a mesh of shape {self.devices.shape} needs "
                f"{self.devices.ndim} axis names, got {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.rank = get_rank() if self.size > 1 else int(
            self.devices.reshape(-1)[0])
        where = np.argwhere(self.devices == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not in the mesh "
                             f"{self.devices.tolist()}")
        self.coord = dict(zip(self.axis_names, map(int, where[0])))
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._ranks: Dict[Tuple[str, ...], List[int]] = {}

    def __repr__(self):
        return f"Mesh({self.shape})"

    def _axes(self, axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names
                     if a in names and self.shape[a] > 1)

    def comm_list(self, axes) -> List[List[int]]:
        """Every slice of ranks that varies ``axes`` and fixes the rest,
        the first of ``axes`` (in the mesh's order) slowest."""
        axes = self._axes(axes)
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        grid = np.transpose(self.devices, rest + idx)
        return grid.reshape(-1, int(np.prod([self.devices.shape[i]
                                             for i in idx], dtype=int))
                            ).tolist()

    def _make_groups(self, backend=None, timeout=None):
        """One process group per slice of every set of axes of size > 1,
        created in the same order on every rank."""
        live = self._axes(self.axis_names)
        kw = {}
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout)
        for k in range(1, len(live) + 1):
            for axes in itertools.combinations(live, k):
                for ranks in self.comm_list(axes):
                    g = dist.new_group(ranks, backend=backend, **kw)
                    if self.rank in ranks:
                        self._groups[axes] = g
                        self._ranks[axes] = ranks

    def group(self, axes):
        """This rank's process group over ``axes`` (an axis name or a
        tuple); None when those axes span this rank alone."""
        return self._groups.get(self._axes(axes))

    def group_ranks(self, axes) -> List[int]:
        """The global ranks of :meth:`group`, in group-rank order."""
        return self._ranks.get(self._axes(axes), [self.rank])

    def degree(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)],
                           dtype=int))

    def index(self, axes) -> int:
        """This rank's index within :meth:`group` (the first axis
        slowest)."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coord[a]
        return i

    def window(self, spec, shape) -> List[List[int]]:
        """This rank's ``[[start, stop], ...]`` of a tensor of global
        ``shape`` laid out by ``spec`` (one entry per leading dim: None,
        an axis name, or a tuple of axes, the first slowest, as in a
        ``PartitionSpec``)."""
        out = []
        for d, n in enumerate(shape):
            axes = [a for a in _spec_axes(spec[d] if d < len(spec) else None)
                    if self.shape.get(a, 1) > 1]
            count, i = 1, 0
            for a in axes:
                count *= self.shape[a]
                i = i * self.shape[a] + self.coord[a]
            if n % count:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide over {axes} ({count} ranks)")
            out.append([i * n // count, (i + 1) * n // count])
        return out

    def is_first_replica(self, spec) -> bool:
        """True on the one rank of each set holding the same window of a
        ``spec`` tensor: index 0 on every axis the spec does not name
        (the reference's ``replica_id == 0``)."""
        named = {a for e in spec for a in _spec_axes(e)}
        return all(self.coord[a] == 0 for a in self.axis_names
                   if a not in named)


def _spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def build_mesh(mesh_shape: Sequence[int], axis_names: Sequence[str],
               devices=None) -> Mesh:
    """A :class:`Mesh` of ``mesh_shape`` over ``devices`` (ranks; default
    every rank of the process group, ``range(world_size)``), axes in the
    hybrid order ``[dp, pp, sharding, mp]``. Every rank must call it
    (the groups are created collectively)."""
    total = int(np.prod(mesh_shape, dtype=int))
    ranks = np.asarray(devices if devices is not None
                       else np.arange(get_world_size()))
    if total != ranks.size:
        raise ValueError(
            f"mesh shape {tuple(mesh_shape)} needs {total} devices, "
            f"have {ranks.size}")
    mesh = Mesh(ranks.reshape(tuple(mesh_shape)), axis_names)
    if mesh.size > 1:
        if not _dist_on():
            raise RuntimeError(
                "build_mesh: a mesh of more than one rank needs the "
                "process group; call init_parallel_env() (or fleet.init) "
                "in every rank first")
        mesh._make_groups()
    return mesh


def set_mesh(mesh):
    _GLOBAL["mesh"] = mesh


def get_mesh():
    return _GLOBAL["mesh"]


@contextlib.contextmanager
def _mesh_scope(mesh):
    """Bind ``mesh`` for the duration: collectives by axis name and the
    tensor-parallel layers' explicit mode read it."""
    _BOUND.append(mesh)
    try:
        yield mesh
    finally:
        _BOUND.pop()


def _bound_mesh() -> Optional[Mesh]:
    return _BOUND[-1] if _BOUND else None
