"""Attention functionals of the port.

Counterpart of ``paddle_tpu/nn/functional/attention.py``. ``_sdpa`` is
the plain attention of ``_sdpa_xla`` (:26) in paddle's (batch, seq,
heads, head_dim) layout: fp32 softmax, a boolean mask selects with
-inf, probabilities cast back to the input dtype before the value
product.

The JAX package routes its no-cache causal attention to the Pallas
flash kernel (K1) on a TPU. K1 is not ported yet (it is next on the
port's roadmap), so :func:`scaled_dot_product_attention` runs the plain
``_sdpa`` math on every device for now. It is off the serving path,
which reaches attention only through the paged kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["scaled_dot_product_attention"]


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


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False, training=False,
                                 scale: Optional[float] = None):
    """Paddle-layout attention. Dropout on the attention probabilities is
    not supported yet (the serving path runs in eval mode)."""
    if training and dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet (training slice)")
    return _sdpa(query, key, value, attn_mask=attn_mask,
                 is_causal=is_causal, scale=scale)
