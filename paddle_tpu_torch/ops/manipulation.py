"""Shape and layout ops of the port (``paddle_tpu/ops/manipulation.py``).

Plain functions on torch tensors with the reference's semantics where
they differ from torch's: ``transpose`` takes a whole permutation
(reversed when None), ``squeeze`` drops only the named axes of size 1,
``split`` takes a count or sizes (one of them -1), ``gather`` is
``jnp.take`` along an axis, ``expand`` keeps a dim given as -1, ``pad``
takes pairs for every axis or for the last axes innermost first,
``sort`` and ``argsort`` with ``descending`` flip the stable ascending
order, and ``unique``, ``nonzero`` and ``masked_select`` (whose output
shape depends on the data) run on the host as the reference does.
Under ``auto_cast`` each op casts its positional tensors by the
reference's op name; none of these names is on either list.
"""

from __future__ import annotations

import builtins
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as TF

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs
from paddle_tpu_torch.ops.creation import _dtype

__all__ = [
    "cast", "reshape", "transpose", "concat", "stack", "unstack", "split",
    "chunk", "squeeze", "unsqueeze", "flatten", "gather", "gather_nd",
    "scatter", "scatter_nd_add", "index_select", "index_sample", "tile",
    "expand", "expand_as", "broadcast_to", "flip", "roll", "pad", "where",
    "one_hot", "topk", "sort", "argsort", "unique", "nonzero", "masked_select",
    "take_along_axis", "put_along_axis", "slice", "strided_slice", "getitem",
    "numel", "shard_index", "repeat_interleave", "moveaxis", "as_complex",
    "as_real", "crop", "unbind",
]


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _cast(name, *xs):
    return maybe_cast_inputs(name, xs)


def cast(x, dtype):
    (x,) = _cast("cast", x)
    return x.to(_dtype(dtype))


def reshape(x, shape, name=None):
    (x,) = _cast("reshape", x)
    return torch.reshape(x, tuple(_int(s) for s in shape))


def transpose(x, perm=None, name=None):
    (x,) = _cast("transpose", x)
    if perm is None:
        perm = tuple(reversed(range(x.dim())))
    return x.permute(*(int(p) for p in perm))


def moveaxis(x, source, destination, name=None):
    (x,) = _cast("moveaxis", x)
    return torch.movedim(x, source, destination)


def concat(x: Sequence, axis=0, name=None):
    xs = _cast("concat", *x)
    return torch.cat(list(xs), dim=_int(axis))


def stack(x: Sequence, axis=0, name=None):
    xs = _cast("stack", *x)
    return torch.stack(list(xs), dim=int(axis))


def unstack(x, axis=0, num=None):
    (x,) = _cast("unstack", x)
    return list(torch.unbind(x, dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    """Equal parts of dim // n (a remainder is dropped, as in the
    reference), or the given sizes, one of which may be -1."""
    axis = _int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [_int(s) for s in num_or_sections]
        if builtins_sum(1 for s in sizes if s < 0):
            known = builtins_sum(s for s in sizes if s >= 0)
            sizes = [s if s >= 0 else dim - known for s in sizes]
    offsets = np.cumsum([0] + sizes[:-1]).tolist()
    (x,) = _cast("split", x)
    return [x.narrow(axis, off, sz) for off, sz in zip(offsets, sizes)]


def builtins_sum(it, start=0):
    total = start
    for v in it:
        total = total + v
    return total


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def unbind(x, axis=0):
    return unstack(x, axis=axis)


def squeeze(x, axis=None, name=None):
    (x,) = _cast("squeeze", x)
    if axis is None:
        return torch.squeeze(x)
    axes = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    axes = tuple(int(a) for a in axes if x.shape[a] == 1)
    return torch.squeeze(x, axes) if axes else x


def unsqueeze(x, axis, name=None):
    """New axes at ``axis`` (an int or a list), each counted in the
    output's rank as ``jnp.expand_dims`` counts them."""
    (x,) = _cast("unsqueeze", x)
    axes = [_int(a) for a in axis] if isinstance(axis, (list, tuple)) \
        else [_int(axis)]
    nd = x.dim() + len(axes)
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    (x,) = _cast("flatten", x)
    if x.dim() == 0:
        return x.reshape(-1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


def _take(x, idx, axis):
    """``jnp.take(x, idx, axis)``: out shape x.shape[:axis] + idx.shape +
    x.shape[axis + 1:]; negative ids count from the end."""
    axis = axis % x.dim()
    idx = torch.as_tensor(idx, device=x.device).long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(*x.shape[:axis], *idx.shape, *x.shape[axis + 1:])


def gather(x, index, axis=0, name=None):
    x, index = _cast("gather", x, index)
    return _take(x, index, _int(axis))


def gather_nd(x, index, name=None):
    x, index = _cast("gather_nd", x, index)
    return x[tuple(torch.movedim(index.long(), -1, 0))]


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` set to ``updates`` (overwrite), or zeroed
    and then summed over repeated ids (paddle's accumulate mode)."""
    x, index, updates = _cast("scatter", x, index, updates)
    idx = index.reshape(-1).long()
    out = x.clone()
    if overwrite:
        out[idx] = updates.to(out.dtype)
        return out
    out[idx] = 0
    return out.index_put((idx,), updates.to(out.dtype), accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    x, index, updates = _cast("scatter_nd_add", x, index, updates)
    return x.index_put(tuple(torch.movedim(index.long(), -1, 0)),
                       updates.to(x.dtype), accumulate=True)


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis=axis)


def index_sample(x, index):
    x, index = _cast("index_sample", x, index)
    return torch.gather(x, 1, index.long())


def take_along_axis(arr, indices, axis, name=None):
    arr, indices = _cast("take_along_axis", arr, indices)
    return torch.take_along_dim(arr, indices.long(), dim=axis)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    arr, indices, values = _cast("put_along_axis", arr, indices, values)
    idx = indices.long()
    val = torch.as_tensor(values, dtype=arr.dtype, device=arr.device)
    val = torch.broadcast_to(val, idx.shape)
    if reduce == "assign":
        return arr.scatter(axis, idx, val)
    if reduce == "add":
        return arr.scatter_add(axis, idx, val)
    if reduce == "multiply":
        return arr.scatter_reduce(axis, idx, val, "prod")
    raise ValueError(f"unknown reduce mode {reduce}")


def tile(x, repeat_times, name=None):
    (x,) = _cast("tile", x)
    return torch.tile(x, tuple(_int(r) for r in repeat_times))


def expand(x, shape, name=None):
    """Broadcast to ``shape``; a -1 keeps the input's dim there."""
    (x,) = _cast("expand", x)
    tgt = [_int(s) for s in shape]
    offset = len(tgt) - x.dim()
    tgt = [x.shape[i - offset] if s == -1 else s for i, s in enumerate(tgt)]
    return torch.broadcast_to(x, tgt)


def expand_as(x, y, name=None):
    x, y = _cast("expand_as", x, y)
    return torch.broadcast_to(x, y.shape)


def broadcast_to(x, shape, name=None):
    (x,) = _cast("broadcast_to", x)
    return torch.broadcast_to(x, tuple(_int(s) for s in shape))


def flip(x, axis, name=None):
    (x,) = _cast("flip", x)
    axes = [axis] if isinstance(axis, int) else list(axis)
    return torch.flip(x, axes)


def roll(x, shifts, axis=None, name=None):
    (x,) = _cast("roll", x)
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


_NP_MODE = {"reflect": "reflect", "replicate": "edge", "circular": "wrap"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``pad`` holds a (before, after) pair for every axis in order, or
    pairs for the last axes, innermost first (torch's ``F.pad`` order);
    ``data_format`` is accepted and, as in the reference, not read."""
    (x,) = _cast("pad", x)
    pad = [int(p) for p in pad]
    if len(pad) == x.dim() * 2:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(x.dim())]
    else:
        n = len(pad) // 2
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(n)]
        cfg = [(0, 0)] * (x.dim() - n) + pairs[::-1]
    if mode == "constant":
        flat = [p for pair in reversed(cfg) for p in pair]
        return TF.pad(x, flat, value=float(value))
    for axis, (lo, hi) in enumerate(cfg):
        if lo or hi:    # the source positions numpy's own pad reads
            src = np.pad(np.arange(x.shape[axis]), (lo, hi),
                         mode=_NP_MODE[mode])
            x = torch.index_select(x, axis, torch.as_tensor(
                src, device=x.device))
    return x


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition)
    condition, x, y = _cast("where", condition, x, y)
    return torch.where(torch.as_tensor(condition).bool(), x, y)


def one_hot(x, num_classes, name=None):
    (x,) = _cast("one_hot_v2", x)
    return TF.one_hot(x.long(), int(num_classes)).float()


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    (x,) = _cast("topk", x)
    vals, idx = torch.topk(x, _int(k), dim=axis, largest=largest,
                           sorted=True)
    return vals, idx


def sort(x, axis=-1, descending=False, name=None):
    (x,) = _cast("sort", x)
    out = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(out, [axis]) if descending else out


def argsort(x, axis=-1, descending=False, name=None):
    (x,) = _cast("argsort", x)
    idx = torch.argsort(x, dim=axis, stable=True)
    return torch.flip(idx, [axis]) if descending else idx


def _host(x):
    return torch.as_tensor(x).detach().cpu().numpy()


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, name=None):
    res = np.unique(_host(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    dev = x.device
    if isinstance(res, tuple):
        return tuple(torch.as_tensor(r, device=dev) for r in res)
    return torch.as_tensor(res, device=dev)


def nonzero(x, as_tuple=False):
    idx = np.nonzero(_host(x))
    dev = x.device
    if as_tuple:
        return tuple(torch.as_tensor(i, device=dev) for i in idx)
    return torch.as_tensor(np.stack(idx, axis=1), device=dev)


def masked_select(x, mask, name=None):
    return torch.as_tensor(_host(x)[_host(mask).astype(bool)],
                           device=x.device)


def _slice_axes(x, axes, slices):
    """``x[..., s, ...]`` with slice ``s`` on each axis of ``axes``; a
    negative step reads backwards, as numpy's slicing does."""
    for ax, s in zip(axes, slices):
        start, stop, step = s.indices(x.shape[ax])
        if step > 0:
            x = x[(builtins.slice(None),) * ax
                  + (builtins.slice(start, stop, step),)]
        else:
            x = torch.index_select(x, ax, torch.arange(
                start, stop, step, device=x.device))
    return x


def slice(input, axes, starts, ends):  # noqa: A001,A002
    (input,) = _cast("slice", input)
    return _slice_axes(input, axes, [builtins.slice(_int(s), _int(e))
                                     for s, e in zip(starts, ends)])


def strided_slice(x, axes, starts, ends, strides):
    (x,) = _cast("strided_slice", x)
    return _slice_axes(x, axes, [builtins.slice(int(s), int(e), int(d))
                                 for s, e, d in zip(starts, ends, strides)])


def _to_index(it, device):
    if isinstance(it, tuple):
        return tuple(_to_index(i, device) for i in it)
    if isinstance(it, (list, np.ndarray)):
        return torch.as_tensor(np.asarray(it), device=device)
    return it


def getitem(x, item):
    """``x[item]`` (differentiable): slices, ints, None, Ellipsis, tensors
    and lists or arrays of ids or flags, as numpy indexes."""
    (x,) = _cast("getitem", x)
    return x[_to_index(item, x.device)]


def numel(x, name=None):
    return torch.tensor(int(np.prod(x.shape)), dtype=torch.int32)


def shard_index(input, index_num, nshards, shard_id,  # noqa: A002
                ignore_value=-1):
    """Vocab-sharding id remap (the distributed lookup table's)."""
    (input,) = _cast("shard_index", input)
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(input, shard_size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, input % shard_size,
                       torch.as_tensor(ignore_value, dtype=input.dtype,
                                       device=input.device))


def repeat_interleave(x, repeats, axis=None, name=None):
    (x,) = _cast("repeat_interleave", x)
    if isinstance(repeats, (list, tuple)):
        repeats = torch.as_tensor(repeats, device=x.device)
    else:
        repeats = _int(repeats)
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


def as_complex(x, name=None):
    (x,) = _cast("as_complex", x)
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    (x,) = _cast("as_real", x)
    return torch.stack([x.real, x.imag], dim=-1)


def crop(x, shape=None, offsets=None, name=None):
    (x,) = _cast("crop", x)
    off = [_int(o) for o in offsets] if offsets else [0] * x.dim()
    for ax, (o, s) in enumerate(zip(off, (_int(s) for s in shape))):
        x = x.narrow(ax, o, s)
    return x
