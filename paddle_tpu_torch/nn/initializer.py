"""Weight initializers of the port (``paddle_tpu/nn/initializer.py``).

Each initializer is a callable ``(shape, dtype) -> torch.Tensor`` with
the reference's distribution and its fan rules for paddle's layouts
(linear (in, out), conv (out, in, *k)). The port's keyword-only
``device`` places the tensor and ``generator`` names the
``torch.Generator`` to draw from; without one, a draw takes the
generator a model build has put in scope (:func:`_drawing_from`), else
the device's default generator, which ``paddle_tpu_torch.seed``
governs. JAX's threefry stream is not reproduced: the two packages'
draws agree in distribution, not in value.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain",
]


class _Scope(threading.local):
    generator: Optional[torch.Generator] = None


_scope = _Scope()


@contextlib.contextmanager
def _drawing_from(generator: Optional[torch.Generator]):
    """Every draw without an explicit generator inside the block takes
    ``generator`` (a model built from a seed); None leaves the scope as
    it is."""
    saved = _scope.generator
    if generator is not None:
        _scope.generator = generator
    try:
        yield
    finally:
        _scope.generator = saved


def _gen(generator, device):
    """The generator to draw with on ``device``: the given one, the
    scope's if it lives on that device type, else None (the device's
    default generator)."""
    g = generator if generator is not None else _scope.generator
    if g is not None and g.device.type != torch.device(device or "cpu").type:
        return None
    return g


def _empty(shape, dtype, device):
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device=device)


def calculate_gain(nonlinearity: str, param=None) -> float:
    recommended = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3.0,
        "relu": math.sqrt(2.0), "selu": 3.0 / 4.0,
    }
    if nonlinearity == "leaky_relu":
        neg_slope = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + neg_slope ** 2))
    if nonlinearity in recommended:
        return recommended[nonlinearity]
    raise ValueError(f"unsupported nonlinearity {nonlinearity!r}")


def _fan_in_out(shape: Sequence[int]):
    if len(shape) < 2:
        fan_in = fan_out = int(shape[0]) if shape else 1
    else:
        receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        # paddle weight layouts: linear (in, out); conv (out, in, *k)
        if len(shape) == 2:
            fan_in, fan_out = shape[0], shape[1]
        else:
            fan_out = shape[0] * receptive
            fan_in = shape[1] * receptive
    return fan_in, fan_out


class Initializer:
    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        return _empty(shape, dtype, device).fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        return _empty(shape, dtype, device).normal_(
            self.mean, self.std, generator=_gen(generator, device))


class TruncatedNormal(Initializer):
    """mean + std * N(0, 1) truncated to [-2, 2]."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        out = torch.nn.init.trunc_normal_(
            _empty(shape, dtype, device), 0.0, 1.0, -2.0, 2.0,
            generator=_gen(generator, device))
        return out.mul_(self.std).add_(self.mean)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        return _empty(shape, dtype, device).uniform_(
            self.low, self.high, generator=_gen(generator, device))


class XavierNormal(Initializer):
    def __init__(self, fan_in: Optional[float] = None,
                 fan_out: Optional[float] = None, gain: float = 1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _empty(shape, dtype, device).normal_(
            0.0, std, generator=_gen(generator, device))


class XavierUniform(Initializer):
    def __init__(self, fan_in: Optional[float] = None,
                 fan_out: Optional[float] = None, gain: float = 1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _empty(shape, dtype, device).uniform_(
            -limit, limit, generator=_gen(generator, device))


def _kaiming_gain(nonlinearity, negative_slope):
    if nonlinearity == "leaky_relu":
        return calculate_gain("leaky_relu", negative_slope)
    return calculate_gain(nonlinearity)


class KaimingNormal(Initializer):
    def __init__(self, fan_in: Optional[float] = None,
                 negative_slope: float = 0.0, nonlinearity: str = "relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        fi, _ = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        std = _kaiming_gain(self.nonlinearity,
                            self.negative_slope) / math.sqrt(fi)
        return _empty(shape, dtype, device).normal_(
            0.0, std, generator=_gen(generator, device))


class KaimingUniform(Initializer):
    def __init__(self, fan_in: Optional[float] = None,
                 negative_slope: float = 0.0, nonlinearity: str = "relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        fi, _ = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        limit = _kaiming_gain(self.nonlinearity,
                              self.negative_slope) * math.sqrt(3.0 / fi)
        return _empty(shape, dtype, device).uniform_(
            -limit, limit, generator=_gen(generator, device))


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        v = self.value
        arr = (v.detach() if isinstance(v, torch.Tensor)
               else torch.as_tensor(np.asarray(v)))
        arr = arr.to(device=device, dtype=dtype).clone()
        if tuple(arr.shape) != tuple(shape):
            arr = arr.reshape(tuple(shape))
        return arr


class Orthogonal(Initializer):
    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        if len(shape) < 2:
            raise ValueError("Orthogonal requires >= 2 dims")
        rows = int(shape[0])
        cols = int(np.prod(shape[1:]))
        flat = _empty((max(rows, cols), min(rows, cols)), torch.float32,
                      device).normal_(generator=_gen(generator, device))
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(tuple(shape)).to(dtype)


class Dirac(Initializer):
    def __init__(self, groups: int = 1):
        self.groups = groups

    def __call__(self, shape, dtype=torch.float32, *, device=None,
                 generator=None):
        out = np.zeros(shape, np.float32)
        out_c, in_c = shape[0], shape[1]
        min_c = min(out_c // self.groups, in_c)
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(min_c):
                idx = (g * (out_c // self.groups) + i, i) + tuple(centers)
                out[idx] = 1.0
        return torch.as_tensor(out, device=device).to(dtype)
