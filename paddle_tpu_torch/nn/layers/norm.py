"""Normalization layers of the port (counterpart of ``nn/layers/norm.py``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["LayerNorm"]


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` axes (an int or a
    tuple), weight 1 and bias 0 at birth unless ``weight_attr`` or
    ``bias_attr`` say otherwise (False: none); runs through
    :func:`~paddle_tpu_torch.nn.functional.layer_norm` (K2 over the last
    axis). ``name`` is accepted and, as in the reference, not read."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(int(s) for s in normalized_shape)
        self.epsilon = float(epsilon)
        self.weight = None if weight_attr is False else \
            self.create_parameter(self.normalized_shape, attr=weight_attr,
                                  dtype=dtype, device=device,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else \
            self.create_parameter(self.normalized_shape, attr=bias_attr,
                                  dtype=dtype, is_bias=True, device=device)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)
