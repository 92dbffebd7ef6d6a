"""Common layers of the port (counterpart of ``nn/layers/common.py``).

Parameters come from ``Layer.create_parameter`` with the reference's
``ParamAttr`` handling and default initializers: ``Linear`` draws
XavierUniform over its (in, out) layout and a zero bias, ``Embedding``
Normal(0, 1). Without a ``ParamAttr`` initializer they draw from torch's
default generator on the parameter's device, so
``paddle_tpu_torch.seed`` governs them and a layer built on the card
draws there. ``name`` is accepted and, as in the reference, not read.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.unported import refuse_unported
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(Layer):
    """y = x @ W + b with W of shape (in_features, out_features) —
    paddle's layout (``nn/layers/common.py:29-39``), not torch's.
    ``weight_attr``/``bias_attr`` take a ``ParamAttr``, an initializer
    or a name; ``bias_attr=False`` builds no bias."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr, dtype=dtype,
            default_initializer=I.XavierUniform(), device=device)
        self.bias = self.create_parameter(
            (out_features,), attr=bias_attr, dtype=dtype, is_bias=True,
            device=device)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(Layer):
    """A (num_embeddings, embedding_dim) table gathered by id, Normal(0,
    1) unless ``weight_attr`` says otherwise (``nn/layers/common.py:
    57-72``). Ids equal to ``padding_idx`` (negative counts from the end)
    give zero rows and no gradient to that row; ``sparse`` is stored and,
    as in the reference, the gradient is dense."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse: bool = False, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self.padding_idx = padding_idx
        self.sparse = sparse
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr, dtype=dtype,
            default_initializer=I.Normal(0.0, 1.0), device=device)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx,
                           sparse=self.sparse)


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
