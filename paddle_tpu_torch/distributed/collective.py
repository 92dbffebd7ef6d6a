"""The collective API — the port of ``paddle_tpu/distributed/collective.py``.

The reference runs collectives as XLA ops over named mesh axes inside a
traced program, and as the identity in a one-process world. The port
runs them over ``torch.distributed`` process groups, one process per
rank. A collective picks its group, in order: ``axis_name`` (this
rank's group over that axis of the bound mesh, ``env._mesh_scope``), a
:class:`Group`, else the whole world. With no process group, or a group
of one rank, every collective is the identity, as in the reference's
one-process world.

Signatures and results are the reference's. ``all_reduce``,
``broadcast`` and ``reduce`` work in place and return the tensor;
``all_gather`` fills ``tensor_list`` or returns the gathered tensor
(a leading group axis, or concatenated when ``tiled``);
``reduce_scatter`` returns this rank's ``scatter_dim`` chunk of the sum;
``alltoall`` splits ``split_axis`` over the group and concatenates the
received chunks on ``concat_axis``; ``ppermute`` sends along
``perm``'s ``(src, dst)`` pairs of axis indices and returns zeros where
nothing arrives. ``ReduceOp.AVG`` is a sum divided by the group size,
``PROD`` an all-reduce with torch's product.

Gloo's collective set: on a machine with one card, ranks of one
communicator cannot share the card under NCCL, so the card's multi-rank
runs name the gloo backend with CUDA tensors. On an H100 with torch
2.11 (``gloo_probe.py``, two ranks) gloo takes CUDA tensors in ``all_reduce`` (sum, max,
avg, product), ``reduce_scatter_tensor``, ``all_gather``,
``all_to_all_single``, ``reduce``, ``scatter``, ``gather``,
``broadcast``, ``all_gather_object`` and ``barrier``. It refuses the
list ``all_to_all`` ("does not support alltoall"), and its ``send`` and
``recv`` hand the card's pointer to the TCP transport, which kills the
process ("writev ... Bad address"). So ``alltoall`` runs
``all_to_all_single`` on every backend, and for the gloo backend only,
chosen by its name and never on error, ``send``, ``recv`` and
``ppermute`` stage each tensor through a host copy
(``_host_staged``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from paddle_tpu_torch.distributed import env as _env

__all__ = [
    "Group", "new_group", "get_group", "all_reduce", "all_gather",
    "all_gather_object", "broadcast", "reduce", "scatter", "alltoall",
    "all_to_all", "send", "recv", "barrier", "ReduceOp", "split",
    "reduce_scatter", "wait", "get_rank_in_group", "ppermute",
]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {ReduceOp.SUM: "SUM", ReduceOp.MAX: "MAX", ReduceOp.MIN: "MIN",
             ReduceOp.PROD: "PRODUCT", ReduceOp.AVG: "SUM"}


class Group:
    """A communicator handle: an ordered list of global ranks, the mesh
    axis it spans (or None) and its ``torch.distributed`` process group
    (None for the whole world)."""

    _next_id = [0]

    def __init__(self, ranks: Sequence[int], axis_name: Optional[str] = None,
                 gid: Optional[int] = None, *, process_group=None):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.axis_name = axis_name
        self.process_group = process_group
        if gid is None:
            Group._next_id[0] += 1
            gid = Group._next_id[0]
        self.id = gid

    def get_group_rank(self, global_rank: int) -> int:
        return self.ranks.index(global_rank) if global_rank in self.ranks \
            else -1

    @property
    def rank(self) -> int:
        return self.get_group_rank(_env.get_rank())

    @property
    def world_size(self) -> int:
        return self.nranks

    def __repr__(self):
        return (f"Group(id={self.id}, axis={self.axis_name}, "
                f"ranks={self.ranks})")


_groups = {}
_default_group: Optional[Group] = None


def _get_default_group() -> Group:
    global _default_group
    if _default_group is None or _default_group.nranks != \
            _env.get_world_size():
        _default_group = Group(list(range(_env.get_world_size())),
                               axis_name=None, gid=0)
        _groups[0] = _default_group
    return _default_group


def new_group(ranks=None, backend=None, axis_name=None) -> Group:
    """A group over ``ranks`` (default every rank). Every rank of the
    world must call it, in the same order, members or not."""
    if ranks is None:
        ranks = list(range(_env.get_world_size()))
    pg = None
    if _env._dist_on() and len(ranks) > 1:
        pg = dist.new_group(list(ranks), backend=backend)
    g = Group(ranks, axis_name=axis_name, process_group=pg)
    _groups[g.id] = g
    return g


def get_group(gid: int) -> Optional[Group]:
    if gid == 0:
        return _get_default_group()
    return _groups.get(gid)


def get_rank_in_group(group: Optional[Group] = None) -> int:
    g = group or _get_default_group()
    return g.rank


class _Comm:
    """The resolved communicator of one call: the torch process group
    (None: the world), its size, this rank's index, and its global
    ranks."""

    __slots__ = ("pg", "size", "index", "ranks")

    def __init__(self, pg, size, index, ranks):
        self.pg, self.size, self.index, self.ranks = pg, size, index, ranks

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.pg))


def _comm(group: Optional[Group] = None,
          axis_name: Optional[str] = None) -> _Comm:
    """The communicator a call names: ``axis_name`` (an axis, or a tuple
    of axes taken together) of the bound mesh, else ``group`` (its axis on the bound mesh when it has no process
    group of its own), else the world."""
    if not _env._dist_on():
        return _Comm(None, 1, 0, [0])
    axis = axis_name if axis_name is not None else (
        group.axis_name if group is not None and group.process_group is None
        else None)
    if axis is not None:
        mesh = _env._bound_mesh() or _env.get_mesh()
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        if mesh is None or not set(names) <= set(mesh.axis_names):
            raise ValueError(
                f"axis {axis!r} is not an axis of a bound mesh; bind one "
                "(the trainer does) or pass a Group")
        return _Comm(mesh.group(axis), mesh.degree(axis), mesh.index(axis),
                     mesh.group_ranks(axis))
    if group is not None:
        return _Comm(group.process_group, group.nranks, group.rank,
                     group.ranks)
    return _Comm(None, dist.get_world_size(), dist.get_rank(),
                 list(range(dist.get_world_size())))


def _op(op: str):
    if op not in _TORCH_OP:
        raise ValueError(f"unknown reduce op {op}")
    return getattr(dist.ReduceOp, _TORCH_OP[op])


# -- collectives -------------------------------------------------------------

def all_reduce(tensor, op: str = ReduceOp.SUM, group: Optional[Group] = None,
               sync_op: bool = True, axis_name: Optional[str] = None):
    """Reduce ``tensor`` over the group, in place; returns it."""
    c = _comm(group, axis_name)
    if c.size == 1:
        return tensor
    dist.all_reduce(tensor, op=_op(op), group=c.pg)
    if op == ReduceOp.AVG:
        tensor.div_(c.size)
    return tensor


def _gather_list(tensor, c: _Comm) -> List[torch.Tensor]:
    out = [torch.empty_like(tensor) for _ in range(c.size)]
    dist.all_gather(out, tensor.contiguous(), group=c.pg)
    return out


def all_gather(tensor_list: Optional[List], tensor=None,
               group: Optional[Group] = None, sync_op: bool = True,
               axis_name: Optional[str] = None, tiled: bool = False):
    """``all_gather(tensor_list, tensor)`` extends ``tensor_list`` with
    every rank's tensor; ``all_gather(tensor)`` returns them stacked on a
    new leading axis, or concatenated on dim 0 when ``tiled``."""
    if tensor is None:
        tensor, tensor_list = tensor_list, None
    c = _comm(group, axis_name)
    parts = _gather_list(tensor, c) if c.size > 1 else [tensor]
    if tensor_list is not None:
        tensor_list.extend(parts)
        return None
    return torch.cat(parts, 0) if tiled else torch.stack(parts, 0)


def all_gather_object(object_list: List, obj, group: Optional[Group] = None):
    """Extend ``object_list`` with every rank's ``obj``."""
    c = _comm(group)
    if c.size == 1:
        object_list.append(obj)
        return
    out = [None] * c.size
    dist.all_gather_object(out, obj, group=c.pg)
    object_list.extend(out)


def reduce_scatter(tensor, op: str = ReduceOp.SUM,
                   group: Optional[Group] = None, sync_op: bool = True,
                   axis_name: Optional[str] = None, scatter_dim: int = 0):
    """This rank's ``scatter_dim`` chunk of the reduction of ``tensor``
    over the group (its size must divide that dim)."""
    c = _comm(group, axis_name)
    if c.size == 1:
        return tensor
    if tensor.shape[scatter_dim] % c.size:
        raise ValueError(
            f"reduce_scatter: dim {scatter_dim} of {tuple(tensor.shape)} "
            f"is not divisible by the group size {c.size}")
    src = tensor.movedim(scatter_dim, 0).contiguous()
    out = torch.empty((src.shape[0] // c.size, *src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, op=_op(op), group=c.pg)
    out = out.movedim(0, scatter_dim).contiguous()
    if op == ReduceOp.AVG:
        out.div_(c.size)
    return out


def broadcast(tensor, src: int = 0, group: Optional[Group] = None,
              sync_op: bool = True, axis_name: Optional[str] = None):
    """``src``'s tensor (a global rank) into every rank's, in place."""
    c = _comm(group, axis_name)
    if c.size == 1:
        return tensor
    dist.broadcast(tensor, src=src, group=c.pg)
    return tensor


def reduce(tensor, dst: int = 0, op: str = ReduceOp.SUM,
           group: Optional[Group] = None, sync_op: bool = True,
           axis_name: Optional[str] = None):
    """The reduction lands in ``dst``'s tensor (a global rank)."""
    c = _comm(group, axis_name)
    if c.size == 1:
        return tensor
    dist.reduce(tensor, dst=dst, op=_op(op), group=c.pg)
    if op == ReduceOp.AVG and _env.get_rank() == dst:
        tensor.div_(c.size)
    return tensor


def scatter(tensor, tensor_list=None, src: int = 0,
            group: Optional[Group] = None, sync_op: bool = True,
            axis_name: Optional[str] = None):
    """Rank ``src`` (a global rank) passes ``tensor_list``, one tensor a
    group member; every rank receives its entry into ``tensor`` and
    returns it (paddle's eager form: the other ranks pass None)."""
    c = _comm(group, axis_name)
    if c.size == 1:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    dist.scatter(tensor, list(tensor_list) if _env.get_rank() == src
                 else None, src=src, group=c.pg)
    return tensor


def _all_to_all(outs, ins, c: _Comm):
    """``all_to_all`` of equal-shaped chunks through one
    ``all_to_all_single`` of their flattened concatenation."""
    flat = torch.cat([t.reshape(-1) for t in ins])
    got = torch.empty_like(flat)
    dist.all_to_all_single(got, flat, group=c.pg)
    for o, part in zip(outs, got.chunk(c.size)):
        o.copy_(part.view_as(o))


def alltoall(in_tensor_list, out_tensor_list=None,
             group: Optional[Group] = None, sync_op: bool = True,
             axis_name: Optional[str] = None, split_axis: int = 0,
             concat_axis: int = 0):
    """Lists: rank i's ``in_tensor_list[j]`` lands in rank j's
    ``out_tensor_list[i]``. A tensor: ``split_axis`` split over the
    group, the chunks received concatenated on ``concat_axis``."""
    c = _comm(group, axis_name)
    if isinstance(in_tensor_list, (list, tuple)):
        ins = [t.contiguous() for t in in_tensor_list]
        outs = [torch.empty_like(t) for t in ins]
        if c.size > 1:
            _all_to_all(outs, ins, c)
        else:
            outs = ins
        if out_tensor_list is not None:
            out_tensor_list.extend(outs)
            return None
        return outs
    x = in_tensor_list
    if c.size == 1:
        return x
    ins = [t.contiguous() for t in x.chunk(c.size, dim=split_axis)]
    outs = [torch.empty_like(t) for t in ins]
    _all_to_all(outs, ins, c)
    return torch.cat(outs, dim=concat_axis)


all_to_all = alltoall


def _host_staged(c: _Comm) -> bool:
    """Gloo's point-to-point takes host tensors only."""
    return c.backend == "gloo"


def send(tensor, dst: int = 0, group: Optional[Group] = None,
         sync_op: bool = True):
    """Send ``tensor`` to global rank ``dst``."""
    c = _comm(group)
    if c.size > 1:
        buf = tensor.to("cpu") if _host_staged(c) else tensor.contiguous()
        dist.send(buf.contiguous(), dst=dst, group=c.pg)
    return tensor


def recv(tensor, src: int = 0, group: Optional[Group] = None,
         sync_op: bool = True):
    """Receive global rank ``src``'s tensor into ``tensor``."""
    c = _comm(group)
    if c.size > 1:
        if _host_staged(c):
            buf = torch.empty(tensor.shape, dtype=tensor.dtype)
            dist.recv(buf, src=src, group=c.pg)
            tensor.copy_(buf)
        else:
            dist.recv(tensor, src=src, group=c.pg)
    return tensor


def ppermute(value, perm, axis_name: str):
    """``lax.ppermute`` over an axis of the bound mesh: for each ``(src,
    dst)`` of axis indices, ``src``'s value lands in ``dst``'s result;
    ranks that receive nothing return zeros."""
    c = _comm(axis_name=axis_name)
    if c.size == 1:
        return value if any(s == d == 0 for s, d in perm) \
            else torch.zeros_like(value)
    staged = _host_staged(c)
    out = torch.zeros_like(value)
    buf = torch.zeros(value.shape, dtype=value.dtype) if staged else out
    src = value.to("cpu") if staged else value
    ops = []
    for s, d in perm:
        if s == c.index and d == c.index:
            out.copy_(value)
        elif s == c.index:
            ops.append(dist.P2POp(dist.isend, src.contiguous(),
                                  c.ranks[d], group=c.pg))
        elif d == c.index:
            ops.append(dist.P2POp(dist.irecv, buf, c.ranks[s], group=c.pg))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged and any(d == c.index != s for s, d in perm):
            out.copy_(buf)
    return out


def barrier(group: Optional[Group] = None):
    c = _comm(group)
    if c.size > 1:
        dist.barrier(group=c.pg)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def wait(tensor, group: Optional[Group] = None, use_calc_stream: bool = True):
    """Block the host until ``tensor``'s pending work on its card is
    done (collectives here are synchronous already)."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def split(x, num_or_sections, axis: int = 0, group: Optional[Group] = None):
    """paddle.distributed.split-style activation split helper."""
    from paddle_tpu_torch import ops

    return ops.split(x, num_or_sections, axis=axis)
