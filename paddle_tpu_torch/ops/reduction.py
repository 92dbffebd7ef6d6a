"""Reduction ops of the port (``paddle_tpu/ops/reduction.py``).

``axis`` is None (every axis), an int or a list of ints. Under
``auto_cast`` each op casts its input by the reference's op name:
``sum`` is ``reduce_sum`` (black-listed: fp32) and ``logsumexp`` is
black-listed; ``mean`` is ``reduce_mean``, on neither list, so it
follows its input as in the reference. ``mean`` of an integer tensor is
float32, as ``jnp.mean`` gives.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs
from paddle_tpu_torch.ops.creation import _dtype

__all__ = [
    "sum", "mean", "max", "min", "prod", "all", "any", "argmax", "argmin",
    "logsumexp", "std", "var", "amax", "amin", "median", "count_nonzero",
]


def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """The reduced dims as a tuple (all of them for None)."""
    if axis is None:
        return tuple(range(x.dim()))
    return axis if isinstance(axis, tuple) else (axis,)


def _float(x):
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _prod(x, dims, keepdim):
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        x = torch.prod(x, d, keepdim=keepdim)
    return x


def _median(x, dims, keepdim):
    """The mean of the two middle values for an even count, as
    ``jnp.median``: the 0.5 quantile with linear interpolation."""
    dims = tuple(sorted(d % x.dim() for d in dims))
    rest = [d for d in range(x.dim()) if d not in dims]
    moved = x.permute(*rest, *dims)
    flat = moved.reshape(*moved.shape[:len(rest)], -1)
    out = torch.quantile(_float(flat), 0.5, dim=-1)
    if keepdim:
        out = out.reshape([1 if d in dims else x.shape[d]
                           for d in range(x.dim())])
    return out


_KERNELS = {
    "reduce_sum": lambda x, d, k: torch.sum(x, d, keepdim=k),
    "reduce_mean": lambda x, d, k: torch.mean(_float(x), d, keepdim=k),
    "reduce_max": lambda x, d, k: torch.amax(x, d, keepdim=k),
    "reduce_min": lambda x, d, k: torch.amin(x, d, keepdim=k),
    "reduce_prod": _prod,
    "reduce_amax": lambda x, d, k: torch.amax(x, d, keepdim=k),
    "reduce_amin": lambda x, d, k: torch.amin(x, d, keepdim=k),
    "reduce_all": lambda x, d, k: torch.all(x, d, keepdim=k),
    "reduce_any": lambda x, d, k: torch.any(x, d, keepdim=k),
    "logsumexp": lambda x, d, k: torch.logsumexp(_float(x), d, keepdim=k),
    "median": _median,
    "count_nonzero": lambda x, d, k: (x != 0).sum(d, keepdim=k),
}


def _run(name, x, axis, keepdim):
    (x,) = maybe_cast_inputs(name, (x,))
    if x.dim() == 0:
        return _KERNELS[name](x.reshape(1), (0,), False).reshape(())
    return _KERNELS[name](x, _dims(x, axis), keepdim)


def _reduce(name):
    def op(x, axis=None, keepdim=False, name_arg=None, dtype=None):
        out = _run(name, x, _norm_axis(axis), keepdim)
        return out if dtype is None else out.to(_dtype(dtype))

    op.__name__ = name
    return op


sum = _reduce("reduce_sum")  # noqa: A001
mean = _reduce("reduce_mean")
max = _reduce("reduce_max")  # noqa: A001
min = _reduce("reduce_min")  # noqa: A001
prod = _reduce("reduce_prod")
amax = _reduce("reduce_amax")
amin = _reduce("reduce_amin")


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _run("reduce_all", x, _norm_axis(axis), keepdim)


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _run("reduce_any", x, _norm_axis(axis), keepdim)


def _arg(name, fn, x, axis, keepdim):
    (x,) = maybe_cast_inputs(name, (x,))
    axis = _norm_axis(axis)
    if axis is None:            # over the flattened input; keepdim unused
        return fn(x.reshape(-1), 0)
    return fn(x, axis, keepdim=keepdim)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg("argmax", torch.argmax, x, axis, keepdim)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg("argmin", torch.argmin, x, axis, keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return _run("logsumexp", x, _norm_axis(axis), keepdim)


def _moment(name, x, axis, unbiased, keepdim):
    (x,) = maybe_cast_inputs(name, (x,))
    fn = torch.std if name == "std" else torch.var
    return fn(_float(x), _dims(x, _norm_axis(axis)),
              correction=1 if unbiased else 0, keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moment("std", x, axis, unbiased, keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moment("var", x, axis, unbiased, keepdim)


def median(x, axis=None, keepdim=False, name=None):
    return _run("median", x, _norm_axis(axis), keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return _run("count_nonzero", x, _norm_axis(axis), keepdim)

