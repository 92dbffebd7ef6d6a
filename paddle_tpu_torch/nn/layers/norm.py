"""Normalization layers of the port (counterpart of ``nn/layers/norm.py``)."""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["LayerNorm"]


class LayerNorm(Layer):
    """LayerNorm over the last axis, weight 1 and bias 0 at birth; runs
    through :func:`~paddle_tpu_torch.nn.functional.layer_norm` (K2)."""

    def __init__(self, normalized_shape: int, epsilon: float = 1e-5,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.normalized_shape = int(normalized_shape)
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(
            (self.normalized_shape,), device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(
            (self.normalized_shape,), device=device, dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)
