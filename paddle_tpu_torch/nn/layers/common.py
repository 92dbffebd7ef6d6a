"""Common layers of the port (counterpart of ``nn/layers/common.py``).

Fresh weights follow the reference's initializers: ``Linear`` draws
XavierUniform over its (in, out) layout, ``Embedding`` Normal(0, 1).
They draw from torch's default generator on the parameter's device, so
``paddle_tpu_torch.seed`` governs them and a layer built on the card
draws there.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from paddle_tpu_torch.core.unported import refuse_unported
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


def _xavier_uniform_(weight: torch.Tensor) -> torch.Tensor:
    """Fill an (in, out) weight from U(-a, a), a = sqrt(6 / (in + out))
    (the reference's ``XavierUniform``), in place."""
    limit = math.sqrt(6.0 / (weight.shape[0] + weight.shape[1]))
    return weight.uniform_(-limit, limit)


class Linear(Layer):
    """y = x @ W + b with W of shape (in_features, out_features) —
    paddle's layout (``nn/layers/common.py:29-39``), not torch's; W
    starts XavierUniform and b at zero. ``bias_attr=False`` builds no
    bias (the reference's meaning); other parameter attributes and
    ``name`` are accepted at their defaults only."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        refuse_unported("Linear", weight_attr=(weight_attr, None),
                        name=(name, None))
        if bias_attr is not None and bias_attr is not False:
            raise NotImplementedError(
                f"Linear: bias_attr={bias_attr!r} is not ported yet; only "
                "None (a bias) and False (none) are accepted")
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(_xavier_uniform_(torch.empty(
            (in_features, out_features), device=device, dtype=dtype)))
        self.bias = None if bias_attr is False else nn.Parameter(torch.zeros(
            (out_features,), device=device, dtype=dtype))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(Layer):
    """A (num_embeddings, embedding_dim) table gathered by id, drawn from
    Normal(0, 1) (``nn/layers/common.py:68``); the reference's
    ``padding_idx``, ``sparse``, ``weight_attr`` and ``name`` are
    accepted at their defaults only."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse: bool = False, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        refuse_unported("Embedding", padding_idx=(padding_idx, None),
                        sparse=(sparse, False),
                        weight_attr=(weight_attr, None), name=(name, None))
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), device=device,
            dtype=dtype).normal_(0.0, 1.0))

    def forward(self, x):
        return F.embedding(x, self.weight)


class Dropout(Layer):
    """upscale_in_train dropout over every element; the reference's
    ``axis``, ``mode`` and ``name`` are accepted at their defaults
    only."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None):
        super().__init__()
        refuse_unported("Dropout", axis=(axis, None),
                        mode=(mode, "upscale_in_train"), name=(name, None))
        self.p = p

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training)
