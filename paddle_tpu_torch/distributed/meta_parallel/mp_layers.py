"""Tensor-parallel layers, single-device dense form.

Counterpart of ``paddle_tpu/distributed/meta_parallel/mp_layers.py``
(:109, :152, :198). The port runs on one card in this slice, so these
are the plain dense layers the JAX ones reduce to without a mesh; they
exist so GPT's parameter names (``qkv_proj``, ``out_proj``, ``fc_in``,
``fc_out``, ``wte``) and (in, out) weight layouts match the reference.
Sharding over NCCL is later work. On one card ``gather_output``,
``input_is_parallel`` and ``fuse_matmul_bias`` give the same result at
every value (the model-parallel degree is 1); ``weight_attr``,
``mp_group`` and ``name`` are accepted at their defaults only.
"""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.core.unported import refuse_unported
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.common import Linear

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]


class _DenseLinear(Linear):
    _op_name: str   # the op name AMP decides by

    def __init__(self, in_features: int, out_features: int, weight_attr,
                 has_bias: bool, mp_group, name, device, dtype):
        refuse_unported(type(self).__name__, weight_attr=(weight_attr, None),
                        mp_group=(mp_group, None), name=(name, None))
        super().__init__(in_features, out_features,
                         bias_attr=None if has_bias else False,
                         device=device, dtype=dtype)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias, op_name=self._op_name)


class ColumnParallelLinear(_DenseLinear):
    """Weight (in, out); the reference splits the OUT columns over 'mp'."""
    _op_name = "column_parallel_linear"

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = True,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         mp_group, name, device, dtype)


class RowParallelLinear(_DenseLinear):
    """Weight (in, out); the reference splits the IN rows over 'mp'."""
    _op_name = "row_parallel_linear"

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         mp_group, name, device, dtype)


class VocabParallelEmbedding(Layer):
    """Embedding table (vocab, hidden); the reference splits the vocab
    rows over 'mp'."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        refuse_unported("VocabParallelEmbedding",
                        weight_attr=(weight_attr, None),
                        mp_group=(mp_group, None), name=(name, None))
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            (num_embeddings, embedding_dim), device=device, dtype=dtype))

    def forward(self, x):
        return F.embedding(x, self.weight)
