"""Activation layers of the port (``nn/layers/activation.py``).

Each calls its functional (``nn/functional/activation.py``); ``name`` is
accepted and, as in the reference, not read. ``PReLU``'s slope is a
parameter from ``Layer.create_parameter``, built on the port's
keyword-only ``device`` at its ``dtype``.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = [
    "ReLU", "ReLU6", "LeakyReLU", "PReLU", "ELU", "SELU", "CELU", "GELU",
    "Sigmoid", "Hardsigmoid", "LogSigmoid", "Tanh", "Hardtanh", "Softsign",
    "Softplus", "Swish", "SiLU", "Silu", "Hardswish", "Mish", "Tanhshrink",
    "Softshrink", "Hardshrink", "ThresholdedReLU", "Maxout", "Softmax",
    "LogSoftmax", "GLU",
]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu6(x)


class LeakyReLU(Layer):
    def __init__(self, negative_slope: float = 0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class PReLU(Layer):
    def __init__(self, num_parameters: int = 1, init: float = 0.25,
                 weight_attr=None, data_format: str = "NCHW", name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), attr=weight_attr, dtype=dtype,
            default_initializer=I.Constant(init), device=device)

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self.data_format)


class ELU(Layer):
    def __init__(self, alpha: float = 1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class SELU(Layer):
    def __init__(self, scale: float = 1.0507009873554805,
                 alpha: float = 1.6732632423543772, name=None):
        super().__init__()
        self.scale = scale
        self.alpha = alpha

    def forward(self, x):
        return F.selu(x, scale=self.scale, alpha=self.alpha)


class CELU(Layer):
    def __init__(self, alpha: float = 1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class GELU(Layer):
    def __init__(self, approximate: bool = False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self.approximate)


class Sigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.sigmoid(x)


class Hardsigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardsigmoid(x)


class LogSigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.log_sigmoid(x)


class Tanh(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)


class Hardtanh(Layer):
    def __init__(self, min: float = -1.0, max: float = 1.0,  # noqa: A002
                 name=None):
        super().__init__()
        self.min = min
        self.max = max

    def forward(self, x):
        return F.hardtanh(x, min=self.min, max=self.max)


class Softsign(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.softsign(x)


class Softplus(Layer):
    def __init__(self, beta: float = 1.0, threshold: float = 20.0, name=None):
        super().__init__()
        self.beta = beta
        self.threshold = threshold

    def forward(self, x):
        return F.softplus(x, beta=self.beta, threshold=self.threshold)


class Swish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.swish(x)


class SiLU(Swish):
    pass


class Silu(Swish):
    """Reference spelling (python/paddle/nn/layer/activation.py Silu)."""
    pass


class Hardswish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardswish(x)


class Mish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.mish(x)


class Tanhshrink(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanhshrink(x)


class Softshrink(Layer):
    def __init__(self, threshold: float = 0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, threshold=self.threshold)


class Hardshrink(Layer):
    def __init__(self, threshold: float = 0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, threshold=self.threshold)


class ThresholdedReLU(Layer):
    def __init__(self, threshold: float = 1.0, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, threshold=self.threshold)


class Maxout(Layer):
    def __init__(self, groups: int, axis: int = 1, name=None):
        super().__init__()
        self.groups = groups
        self.axis = axis

    def forward(self, x):
        return F.maxout(x, self.groups, axis=self.axis)


class Softmax(Layer):
    def __init__(self, axis: int = -1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis: int = -1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self.axis)


class GLU(Layer):
    def __init__(self, axis: int = -1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, axis=self.axis)
