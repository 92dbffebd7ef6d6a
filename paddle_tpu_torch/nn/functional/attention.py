"""Attention functionals of the port.

Counterpart of ``paddle_tpu/nn/functional/attention.py``, in paddle's
(batch, seq, heads, head_dim) layout:

- ``_sdpa`` is the plain attention of ``_sdpa_xla`` (:26): fp32
  softmax, a causal mask aligned BOTTOM-right (``tril(k=sk-sq)``), a
  boolean mask selecting with -inf, probabilities cast back to the
  input dtype before the value product;
- :func:`flash_attention` is the flash path (K1 forward, K3 backward,
  ``ops/kernels/flash_attention.py``), whose causal mask is TOP-left
  aligned as the Pallas kernels' is;
- ``_local_attention`` picks between them with the gate of JAX
  ``_local_attention`` (:101-123), copied exactly: flash only with no
  mask and no active dropout, not for causal sq != sk, and only where
  sq, sk >= 128 and both tile into blocks of at least 64.

:func:`scaled_dot_product_attention` has the JAX function's signature
(:209-213). Attention dropout (p > 0 while training) is not ported yet
and raises; the JAX gate sends it to XLA too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs
from paddle_tpu_torch.ops.kernels.flash_attention import (FlashAttentionFn,
                                                          _pick_block)

__all__ = ["scaled_dot_product_attention", "flash_attention"]


def _sdpa(q, k, v, attn_mask=None, is_causal: bool = False,
          scale: Optional[float] = None):
    """q, k, v: (batch, seq, heads, head_dim)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    logits = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    # a Python scalar, not a device tensor: building one on the card
    # would cost a host-to-device copy and a stream sync per call
    neg_inf = float("-inf")
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=logits.device).tril(diagonal=sk - sq)
        logits = torch.where(causal, logits, neg_inf)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits, neg_inf)
        else:
            logits = logits + attn_mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, vt).transpose(1, 2)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """Blockwise attention over (batch, seq, heads, head_dim) inputs
    (``ops/pallas/flash_attention.py:582``); ``scale`` defaults to
    1/sqrt(head_dim)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttentionFn.apply(q, k, v, float(scale), bool(causal))


def _local_attention(query, key, value, attn_mask, dropout_p: float = 0.0,
                     is_causal: bool = False, scale: Optional[float] = None):
    """The flash-or-plain pick of JAX ``_local_attention`` (:101-123)."""
    if attn_mask is None and dropout_p <= 0.0:
        sq, sk = query.shape[1], key.shape[1]
        if not (is_causal and sq != sk):
            # tiny or degenerately-tiling shapes (e.g. prime seq lengths)
            # don't block usefully — they take the plain path
            if (sq >= 128 and sk >= 128
                    and _pick_block(sq, 256) >= 64
                    and _pick_block(sk, 256) >= 64):
                return flash_attention(query, key, value, causal=is_causal,
                                       scale=scale)
    return _sdpa(query, key, value, attn_mask=attn_mask, is_causal=is_causal,
                 scale=scale)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 scale: Optional[float] = None,
                                 training: bool = True):
    """Paddle-layout attention, the JAX function's signature and
    defaults. Under AMP q, k and v are cast as the white-listed op
    ``scaled_dot_product_attention`` (the mask is not)."""
    drop = dropout_p if training else 0.0
    if drop > 0.0:
        raise NotImplementedError(
            "attention dropout (dropout_p > 0 while training) is not "
            "ported yet; pass training=False or dropout_p=0")
    query, key, value = maybe_cast_inputs("scaled_dot_product_attention",
                                          (query, key, value))
    return _local_attention(query, key, value, attn_mask, drop, is_causal,
                            scale)
