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
  sq, sk >= 128 and both tile into blocks of at least 64;
- the sequence-parallel routing of ``_sdpa_kernel`` (:55-197): inside
  the trainer's ``sep_sharded_scope`` attention runs ring or Ulysses
  (``distributed/ring_attention.py``, ``distributed/ulysses.py``), a
  mask or active dropout warning and running locally on the gathered
  sequence; where a bound mesh carries ``sep`` outside any such scope,
  the same schedules run and a mask or dropout raises.

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


_sep_hooks = None


def _get_sep_hooks():
    """The sequence-parallel modules, imported once (the distributed
    package imports this one)."""
    global _sep_hooks
    if _sep_hooks is None:
        import importlib

        _sep_hooks = tuple(importlib.import_module(
            f"paddle_tpu_torch.distributed.{m}")
            for m in ("env", "ring_attention", "ulysses"))
    return _sep_hooks


def _sep_bound() -> bool:
    """A bound mesh carries a ``sep`` axis above 1 and no
    ``sep_sharded_scope`` says how the sequence lies: the caller's
    tensors are its chunks (the reference's ``shard_map`` binding)."""
    env, ring, _ = _get_sep_hooks()
    if ring._SCOPES:
        return False
    mesh = env._bound_mesh()
    return mesh is not None and mesh.shape.get(ring.SEP_AXIS, 1) > 1


def _sep_schedule(query, key, value, is_causal, scale):
    """Ring (the default) or Ulysses, by ``sequence_parallel_mode``."""
    _, ring, ulysses = _get_sep_hooks()
    if ulysses.get_sequence_parallel_mode() == "ulysses":
        return ulysses.ulysses_attention(query, key, value,
                                         is_causal=is_causal, scale=scale)
    return ring.ring_attention(query, key, value, is_causal=is_causal,
                               scale=scale)


def _sep_attention(query, key, value, attn_mask, dropout_p, is_causal,
                   scale):
    """The bound case (``_sdpa_kernel``'s ``_sep_bound`` arm, :77-97):
    the tensors are sequence chunks, so attention MUST run a
    sequence-parallel schedule; a mask or active dropout raises, since
    chunk-local attention would be another function."""
    if attn_mask is not None or dropout_p > 0.0:
        raise NotImplementedError(
            "attention with attn_mask/dropout is not sequence-parallel-"
            "lowered; disable attention dropout (or masks) under sequence "
            "parallelism")
    return _sep_schedule(query, key, value, is_causal, scale)


def _sep_scope_attention(query, key, value, attn_mask, dropout_p,
                         is_causal, scale, ctx):
    """The trainer's sequence-cut region (``_sep_gspmd_attention``,
    :126-167): ring or Ulysses; a mask, active dropout or
    cross-attention warns and runs the local attention on the gathered
    sequence (the same function, not sep-scheduled), this rank's rows
    kept."""
    mesh, axis = ctx
    if attn_mask is None and dropout_p <= 0.0 \
            and query.shape[1] == key.shape[1]:
        return _sep_schedule(query, key, value, is_causal, scale)
    import warnings

    warnings.warn(
        "sequence-parallel scope: attention with attn_mask/dropout or "
        "cross-attention falls back to the local kernel on the gathered "
        f"sequence over '{axis}' (correct but not sep-scheduled)",
        UserWarning, stacklevel=3)
    _, ring, _ = _get_sep_hooks()
    n, r = mesh.degree(axis), mesh.index(axis)
    q, k, v = (ring._SeqGatherSum.apply(t, mesh, axis)
               for t in (query, key, value))
    if attn_mask is not None and attn_mask.shape[-1] == key.shape[1] \
            and n > 1:
        attn_mask = ring._gather_seq(attn_mask.movedim(-1, 1), mesh,
                                     axis).movedim(1, -1)
    out = _local_attention(q, k, v, attn_mask, dropout_p, is_causal, scale)
    return out.chunk(n, dim=1)[r]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 scale: Optional[float] = None,
                                 training: bool = True):
    """Paddle-layout attention, the JAX function's signature and
    defaults. Under AMP q, k and v are cast as the white-listed op
    ``scaled_dot_product_attention`` (the mask is not). ``dropout_p``
    applies while ``training``; with ``training=False`` it is the
    identity. In a sequence-cut region (``ring_attention.
    sep_sharded_scope``) or where a bound mesh carries a ``sep`` axis,
    the tensors are sequence chunks and the sequence-parallel routing
    above applies."""
    drop = dropout_p if training else 0.0
    query, key, value = maybe_cast_inputs("scaled_dot_product_attention",
                                          (query, key, value))
    env, ring, _ = _get_sep_hooks()
    if ring._SCOPES:
        ctx = ring.get_sep_sharded_scope()
        if ctx is not None:
            return _sep_scope_attention(query, key, value, attn_mask, drop,
                                        is_causal, scale, ctx)
    elif env._BOUND and _sep_bound():
        return _sep_attention(query, key, value, attn_mask, drop, is_causal,
                              scale)
    return _local_attention(query, key, value, attn_mask, drop, is_causal,
                            scale)
