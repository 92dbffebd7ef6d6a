"""Activation functionals of the port (``nn/functional/activation.py``).

The reference's formulas term for term, on torch tensors. Under
``auto_cast`` each casts its tensor inputs by the reference's op name:
``softmax`` and ``log_softmax`` are black-listed (fp32), the rest are on
neither list and follow their inputs (``sigmoid`` and ``tanh`` dispatch
as ``sigmoid_act`` and ``tanh_act`` there).
``gumbel_softmax`` draws its Gumbel noise from the device's default
generator (JAX's threefry stream is not reproduced).
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs

__all__ = [
    "relu", "relu6", "leaky_relu", "prelu", "elu", "selu", "celu", "gelu",
    "sigmoid", "hardsigmoid", "log_sigmoid", "tanh", "hardtanh", "softsign",
    "softplus", "swish", "silu", "hardswish", "mish", "tanhshrink",
    "softshrink", "hardshrink", "thresholded_relu", "maxout",
    "softmax", "log_softmax", "gumbel_softmax", "glu",
]


def _in(name, x):
    return maybe_cast_inputs(name, (x,))[0]


def _zero(x):
    return x.new_zeros(())


def relu(x):
    return TF.relu(_in("relu", x))


def relu6(x):
    return torch.clamp(_in("relu6", x), 0.0, 6.0)


def leaky_relu(x, negative_slope: float = 0.01):
    return TF.leaky_relu(_in("leaky_relu", x), negative_slope)


def prelu(x, weight, data_format: str = "NCHW"):
    """``where(x >= 0, x, w * x)``; a per-channel ``weight`` broadcasts
    along the channel axis (1 for NCHW, the last otherwise)."""
    x, w = maybe_cast_inputs("prelu", (x, weight))
    if w.dim() == 1 and w.shape[0] != 1 and x.dim() > 1:
        axis = 1 if data_format == "NCHW" else x.dim() - 1
        shape = [1] * x.dim()
        shape[axis] = w.shape[0]
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def elu(x, alpha: float = 1.0):
    return TF.elu(_in("elu", x), alpha)


def selu(x, scale: float = 1.0507009873554805,
         alpha: float = 1.6732632423543772):
    x = _in("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha: float = 1.0):
    return TF.celu(_in("celu", x), alpha)


def gelu(x, approximate: bool = False):
    """``jax.nn.gelu``: ``approximate=True`` is the tanh form GPT uses
    (``models/gpt.py:455``), torch's ``approximate="tanh"``."""
    return TF.gelu(_in("gelu", x), approximate="tanh" if approximate
                   else "none")


def sigmoid(x):
    return torch.sigmoid(_in("sigmoid_act", x))


def hardsigmoid(x, slope: float = 1.0 / 6.0, offset: float = 0.5):
    return torch.clamp(slope * _in("hardsigmoid", x) + offset, 0.0, 1.0)


def log_sigmoid(x):
    return TF.logsigmoid(_in("log_sigmoid", x))


def tanh(x):
    return torch.tanh(_in("tanh_act", x))


def hardtanh(x, min: float = -1.0, max: float = 1.0):  # noqa: A002
    return torch.clamp(_in("hardtanh", x), min, max)


def softsign(x):
    x = _in("softsign", x)
    return x / (1 + torch.abs(x))


def softplus(x, beta: float = 1.0, threshold: float = 20.0):
    x = _in("softplus", x)
    scaled = beta * x
    return torch.where(scaled > threshold, x,
                       torch.logaddexp(scaled, _zero(scaled)) / beta)


def swish(x):
    return TF.silu(_in("swish", x))


silu = swish


def hardswish(x):
    x = _in("hardswish", x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def mish(x):
    x = _in("mish", x)
    return x * torch.tanh(torch.logaddexp(x, _zero(x)))


def tanhshrink(x):
    x = _in("tanhshrink", x)
    return x - torch.tanh(x)


def softshrink(x, threshold: float = 0.5):
    x = _in("softshrink", x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, _zero(x)))


def hardshrink(x, threshold: float = 0.5):
    x = _in("hardshrink", x)
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


def thresholded_relu(x, threshold: float = 1.0):
    x = _in("thresholded_relu", x)
    return torch.where(x > threshold, x, _zero(x))


def maxout(x, groups: int, axis: int = 1):
    x = _in("maxout", x)
    ax = axis if axis >= 0 else x.dim() + axis
    shape = list(x.shape)
    shape[ax] = x.shape[ax] // groups
    shape.insert(ax + 1, groups)
    return torch.amax(x.reshape(shape), dim=ax + 1)


def softmax(x, axis: int = -1):
    return torch.softmax(_in("softmax", x), dim=axis)


def log_softmax(x, axis: int = -1):
    return torch.log_softmax(_in("log_softmax", x), dim=axis)


def gumbel_softmax(x, temperature: float = 1.0, hard: bool = False,
                   axis: int = -1):
    """softmax((x + g) / temperature) with Gumbel(0, 1) noise ``g``;
    ``hard`` gives the one-hot argmax forward and the soft gradient."""
    x = _in("gumbel_softmax", x)
    u = torch.rand(x.shape, dtype=x.dtype, device=x.device)
    tiny = torch.finfo(x.dtype).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        onehot = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y + (onehot - y).detach()
    return y


def glu(x, axis: int = -1):
    a, b = torch.chunk(_in("glu", x), 2, dim=axis)
    return a * torch.sigmoid(b)
