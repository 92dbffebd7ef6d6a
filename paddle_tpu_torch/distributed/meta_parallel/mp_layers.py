"""Tensor-parallel layers, single-device dense form.

Counterpart of ``paddle_tpu/distributed/meta_parallel/mp_layers.py``
(:109, :152, :198). The port runs on one card in this slice, so these
are the plain dense layers the JAX ones reduce to without a mesh; they
exist so GPT's parameter names (``qkv_proj``, ``out_proj``, ``fc_in``,
``fc_out``, ``wte``) and (in, out) weight layouts match the reference.
Sharding over NCCL is later work.
"""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.common import Linear

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]


class _DenseLinear(Linear):
    def __init__(self, in_features: int, out_features: int,
                 has_bias: bool = True, device=None, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=has_bias,
                         device=device, dtype=dtype)


class ColumnParallelLinear(_DenseLinear):
    """Weight (in, out); the reference splits the OUT columns over 'mp'."""


class RowParallelLinear(_DenseLinear):
    """Weight (in, out); the reference splits the IN rows over 'mp'."""


class VocabParallelEmbedding(Layer):
    """Embedding table (vocab, hidden); the reference splits the vocab
    rows over 'mp'."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), device=device, dtype=dtype))

    def forward(self, x):
        return F.embedding(x, self.weight)
