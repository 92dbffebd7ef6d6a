"""Fused transformer blocks — the port of
``paddle_tpu/incubate/nn/fused_transformer.py``.

Attention, feed-forward and the encoder layer with the residual and the
pre- or post-norm inside the block, under the reference's parameter names
(``qkv_proj``, ``out_proj``, ``norm``; ``linear1``, ``linear2``,
``norm``). The qkv projection keeps the reference's PER-HEAD packed
layout: ``(b, s, H, 3 * head_dim)``, split on the last axis into q, k
and v (:68-71). The attention core is ``F.scaled_dot_product_attention``
(non-causal), so the JAX gate picks the route: with no mask and no
active attention dropout (and both lengths at least 128, tiling into
blocks of 64) the flash kernels K1 and K3a, else the plain attention;
every norm runs K2. The reference's restrictions stay: no
``need_weights``, self-attention only, no incremental ``cache``. Layers
take the port's keyword-only ``device`` (default ``"cuda"``, raising on
a host without a card, naming ``device="cpu"``) and ``dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.common import Dropout, Linear
from paddle_tpu_torch.nn.layers.norm import LayerNorm

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer"]


class FusedMultiHeadAttention(Layer):
    """Self-attention + residual + (pre/post) layer norm in one block
    (``fused_transformer.py:18``). ``kdim`` and ``vdim`` are accepted
    and, as in the reference, not read (self-attention only)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dropout_rate: float = 0.5, attn_dropout_rate: float = 0.5,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 normalize_before: bool = False, need_weights: bool = False,
                 weight_attr=None, bias_attr=None, epsilon: float = 1e-5,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        if need_weights:
            raise NotImplementedError(
                "need_weights=True is not supported (the reference's fused "
                "kernel restriction)")
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.qkv_proj = Linear(embed_dim, 3 * embed_dim,
                               weight_attr=weight_attr, bias_attr=bias_attr,
                               **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr=weight_attr,
                               bias_attr=bias_attr, **kw)
        self.norm = LayerNorm(embed_dim, epsilon=epsilon, **kw)
        self.attn_dropout_rate = attn_dropout_rate
        self.dropout = Dropout(dropout_rate)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if key is not None and key is not query:
            raise NotImplementedError(
                "FusedMultiHeadAttention is self-attention only (the "
                "reference's fused kernel); pass key=None")
        if value is not None and value is not query:
            raise NotImplementedError(
                "FusedMultiHeadAttention is self-attention only; pass "
                "value=None")
        if cache is not None:
            raise NotImplementedError(
                "the fused block has no incremental decoding cache; use "
                "nn.MultiHeadAttention")
        residual = query
        x = self.norm(query) if self.normalize_before else query
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(b, s, self.num_heads,
                                       3 * self.head_dim)
        q, k, v = qkv.split(self.head_dim, dim=-1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.attn_dropout_rate if self.training else 0.0,
            training=self.training)
        out = self.dropout(self.out_proj(out.reshape(b, s, self.embed_dim)))
        out = residual + out
        if not self.normalize_before:
            out = self.norm(out)
        return out


class FusedFeedForward(Layer):
    """linear -> activation -> linear + residual + (pre/post) norm
    (``fused_transformer.py:85``). The norm takes ``ln1_scale_attr`` and
    ``ln1_bias_attr``; the ``ln2_*`` attributes are accepted and, as in
    the reference, not read."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 dropout_rate: float = 0.1, epsilon: float = 1e-5,
                 activation: str = "relu", act_dropout_rate=None,
                 normalize_before: bool = False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.normalize_before = normalize_before
        self.linear1 = Linear(d_model, dim_feedforward,
                              weight_attr=linear1_weight_attr,
                              bias_attr=linear1_bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model,
                              weight_attr=linear2_weight_attr,
                              bias_attr=linear2_bias_attr, **kw)
        self.norm = LayerNorm(d_model, epsilon=epsilon,
                              weight_attr=ln1_scale_attr,
                              bias_attr=ln1_bias_attr, **kw)
        self.dropout = Dropout(dropout_rate)
        self.act_dropout = Dropout(dropout_rate if act_dropout_rate is None
                                   else act_dropout_rate)
        self.activation = getattr(F, activation)

    def forward(self, src, cache=None):
        residual = src
        x = self.norm(src) if self.normalize_before else src
        x = self.act_dropout(self.activation(self.linear1(x)))
        x = self.dropout(self.linear2(x))
        out = residual + x
        if not self.normalize_before:
            out = self.norm(out)
        return out


class FusedTransformerEncoderLayer(Layer):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward``
    (``fused_transformer.py:124``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout_rate: float = 0.1, activation: str = "relu",
                 attn_dropout_rate=None, act_dropout_rate=None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate),
            normalize_before=normalize_before, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before,
            linear1_weight_attr=weight_attr, linear1_bias_attr=bias_attr,
            linear2_weight_attr=weight_attr, linear2_bias_attr=bias_attr,
            **kw)

    def forward(self, src, src_mask=None, cache=None):
        # the reference drops ``cache`` here without a word; the port
        # hands it to the attention, which refuses it
        out = self.fused_attn(src, attn_mask=src_mask, cache=cache)
        return self.ffn(out)
