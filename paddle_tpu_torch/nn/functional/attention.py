"""Attention functionals of the port.

Counterpart of ``paddle_tpu/nn/functional/attention.py``, in paddle's
(batch, seq, heads, head_dim) layout:

- ``_sdpa`` is the plain attention of ``_sdpa_xla`` (:26): fp32
  softmax, a causal mask aligned BOTTOM-right (``tril(k=sk-sq)``), a
  boolean mask selecting with -inf, probabilities cast back to the
  input dtype before the value product, and attention dropout on those
  probabilities (:48-51): ``where(keep, probs / (1 - p), 0)``;
- :func:`flash_attention` is the flash path (K1 forward, K3 backward,
  ``ops/kernels/flash_attention.py``), whose causal mask is TOP-left
  aligned as the Pallas kernels' is;
- ``_local_attention`` picks between them with the gate of JAX
  ``_local_attention`` (:101-123), copied exactly: flash only with no
  mask and no active dropout, not for causal sq != sk, and only where
  sq, sk >= 128 and both tile into blocks of at least 64.

:func:`scaled_dot_product_attention` has the JAX function's signature
(:209-213). Attention dropout (p > 0 while training) keeps the plain
path, as the JAX gate sends it to XLA: there is no flash kernel with
dropout in either package. Its keep mask is drawn from the device's
default generator, the stream ``F.dropout`` draws from, so a recompute
(``fleet.utils.recompute``, which saves and restores that generator's
state) replays the same mask. JAX's threefry bits are not reproduced:
the mask's distribution is the reference's, not its values.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs
from paddle_tpu_torch.core.unported import refuse_unported
from paddle_tpu_torch.ops.kernels.flash_attention import (FlashAttentionFn,
                                                          _pick_block)

__all__ = ["scaled_dot_product_attention", "flash_attention"]


def _sdpa(q, k, v, attn_mask=None, is_causal: bool = False,
          scale: Optional[float] = None, dropout_p: float = 0.0,
          keep=None):
    """q, k, v: (batch, seq, heads, head_dim). With ``dropout_p`` > 0 the
    probabilities are dropped by ``keep`` ((batch, heads, sq, sk) bool;
    drawn here when None) and the kept ones scaled by 1 / (1 - p)."""
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
    if dropout_p > 0.0:
        if keep is None:   # Bernoulli(1 - p) from the default generator
            keep = torch.empty(probs.shape, device=probs.device).bernoulli_(
                1.0 - dropout_p).bool()
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            probs.new_zeros(()))
    return torch.matmul(probs, vt).transpose(1, 2)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    interpret: Optional[bool] = None):
    """Blockwise attention over (batch, seq, heads, head_dim) inputs
    (``ops/pallas/flash_attention.py:582``); ``scale`` defaults to
    1/sqrt(head_dim). The reference's TPU tiling (``block_q``,
    ``block_k``) and Pallas ``interpret`` mode are accepted at their
    defaults only."""
    refuse_unported("flash_attention", block_q=(block_q, None),
                    block_k=(block_k, None), interpret=(interpret, None))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttentionFn.apply(q, k, v, float(scale), bool(causal))


def _flash_gate(sq: int, sk: int, is_causal: bool, masked: bool,
                dropout_p: float = 0.0) -> bool:
    """Whether JAX ``_local_attention``'s gate (:101-123) sends ``sq``
    query rows over ``sk`` keys to flash: no mask, no active dropout,
    not causal with sq != sk, and both at least 128 and tiling into
    blocks of at least 64 (tiny or degenerately tiling shapes, such as
    prime lengths, do not block usefully)."""
    return (not masked and dropout_p <= 0.0 and not (is_causal and sq != sk)
            and sq >= 128 and sk >= 128 and _pick_block(sq, 256) >= 64
            and _pick_block(sk, 256) >= 64)


def _local_attention(query, key, value, attn_mask, dropout_p: float = 0.0,
                     is_causal: bool = False, scale: Optional[float] = None):
    """The flash-or-plain pick of JAX ``_local_attention`` (:101-123)."""
    if _flash_gate(query.shape[1], key.shape[1], is_causal,
                   attn_mask is not None, dropout_p):
        return flash_attention(query, key, value, causal=is_causal,
                               scale=scale)
    return _sdpa(query, key, value, attn_mask=attn_mask, is_causal=is_causal,
                 scale=scale, dropout_p=dropout_p)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 scale: Optional[float] = None,
                                 training: bool = True):
    """Paddle-layout attention, the JAX function's signature and
    defaults. Under AMP q, k and v are cast as the white-listed op
    ``scaled_dot_product_attention`` (the mask is not). ``dropout_p``
    applies while ``training``; with ``training=False`` it is the
    identity."""
    drop = dropout_p if training else 0.0
    query, key, value = maybe_cast_inputs("scaled_dot_product_attention",
                                          (query, key, value))
    return _local_attention(query, key, value, attn_mask, drop, is_causal,
                            scale)
