"""Tensor creation ops of the port (``paddle_tpu/ops/creation.py``).

Plain functions on torch tensors. The reference's dispatch registry is
not ported: each op calls torch directly. A dtype is a torch dtype, a
numpy dtype or paddle's name for one (``"float32"``, ``"int64"``, ...);
``None`` is float32 where the reference takes the default float type.
Ops that make a tensor from nothing take the port's keyword-only
``device``, ``"cuda"`` unless given (it raises on a host without a
card, naming ``device="cpu"``); the ``*_like`` ops and
the ops on an input keep the input's device. Random ops draw from
torch's default generator on that device; ``uniform(seed=)`` with a
nonzero seed draws from a generator seeded with it, as the reference
draws from ``jax.random.key(seed)`` (the two streams differ).
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.random import generator

__all__ = [
    "zeros", "ones", "full", "empty", "zeros_like", "ones_like", "full_like",
    "empty_like", "arange", "linspace", "eye", "rand", "randn", "uniform",
    "normal", "randint", "randperm", "assign", "to_tensor", "tril", "triu",
    "diag", "meshgrid", "clone",
]

_NAMES = {"float32": torch.float32, "float": torch.float32,
          "float64": torch.float64, "double": torch.float64,
          "float16": torch.float16, "half": torch.float16,
          "bfloat16": torch.bfloat16, "int8": torch.int8,
          "uint8": torch.uint8, "int16": torch.int16, "int32": torch.int32,
          "int": torch.int32, "int64": torch.int64, "long": torch.int64,
          "bool": torch.bool, "complex64": torch.complex64,
          "complex128": torch.complex128}


def _dtype(dtype, default=torch.float32):
    """A torch dtype from ``dtype`` (torch, numpy or paddle's name), or
    ``default`` for None."""
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name.startswith("paddle."):
        name = name[len("paddle."):]
    if name not in _NAMES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _NAMES[name]


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None, *, device=None):
    return torch.zeros(_shape(shape), dtype=_dtype(dtype),
                       device=resolve_device(device))


def ones(shape, dtype=None, *, device=None):
    return torch.ones(_shape(shape), dtype=_dtype(dtype),
                      device=resolve_device(device))


def full(shape, fill_value, dtype=None, *, device=None):
    return torch.full(_shape(shape), _scalar(fill_value), dtype=_dtype(dtype),
                      device=resolve_device(device))


def empty(shape, dtype=None, *, device=None):
    """Zeros, as the reference's ``empty`` gives."""
    return zeros(shape, dtype, device=device)


def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=_dtype(dtype, x.dtype))


def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=_dtype(dtype, x.dtype))


def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, _scalar(fill_value),
                           dtype=_dtype(dtype, x.dtype))


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, *, device=None):
    """int64 when start, end and step are all whole numbers and no
    ``dtype`` is given, else float32 (the reference's rule)."""
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        whole = all(float(v) == int(v) for v in (start, end, step))
        dt = torch.int64 if whole else torch.float32
    else:
        dt = _dtype(dtype)
    return torch.arange(start, end, step, dtype=dt,
                        device=resolve_device(device))


def linspace(start, stop, num, dtype=None, *, device=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=_dtype(dtype), device=resolve_device(device))


def eye(num_rows, num_columns=None, dtype=None, *, device=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=_dtype(dtype),
                     device=resolve_device(device))


def rand(shape, dtype=None, *, device=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0, device=device)


def randn(shape, dtype=None, *, device=None):
    return torch.randn(_shape(shape), dtype=_dtype(dtype),
                       device=resolve_device(device))


def uniform(shape, dtype=None, min=0.0, max=1.0, seed=0, *,  # noqa: A002
            device=None):
    out = torch.empty(_shape(shape), dtype=_dtype(dtype),
                      device=resolve_device(device))
    return out.uniform_(float(_scalar(min)), float(_scalar(max)),
                        generator=generator(seed, out.device) if seed
                        else None)


def normal(mean=0.0, std=1.0, shape=None, dtype=None, *, device=None):
    dt = _dtype(dtype)
    sample = torch.randn(_shape(shape if shape is not None else [1]),
                         dtype=dt, device=resolve_device(device))
    return sample * torch.as_tensor(std, dtype=dt, device=sample.device) \
        + torch.as_tensor(mean, dtype=dt, device=sample.device)


def randint(low=0, high=None, shape=(1,), dtype=None, *, device=None):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), _shape(shape),
                         device=resolve_device(device)).to(
                             _dtype(dtype, torch.int64))


def randperm(n, dtype=None, *, device=None):
    return torch.randperm(int(n), device=resolve_device(device)).to(
        _dtype(dtype, torch.int64))


def assign(x, output=None):
    """A copy of ``x`` (a tensor, an array or a nested list); with
    ``output``, written into it in place."""
    (x,) = maybe_cast_inputs("assign", (torch.as_tensor(x),))
    out = x.clone()
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x):
    (x,) = maybe_cast_inputs("clone", (x,))
    return x.clone()


def tril(x, diagonal=0):
    (x,) = maybe_cast_inputs("tril", (x,))
    return torch.tril(x, diagonal)


def triu(x, diagonal=0):
    (x,) = maybe_cast_inputs("triu", (x,))
    return torch.triu(x, diagonal)


def diag(x, offset=0):
    (x,) = maybe_cast_inputs("diag", (x,))
    return torch.diag(x, offset)


def meshgrid(*args):
    return list(torch.meshgrid(*args, indexing="ij"))


# re-export for paddle.to_tensor parity, as the reference does
from paddle_tpu_torch.core.tensor import to_tensor  # noqa: E402,F401
