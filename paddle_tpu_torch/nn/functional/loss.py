"""Loss functionals of the port (``paddle_tpu/nn/functional/loss.py``).

- :func:`cross_entropy`: JAX ``cross_entropy`` (:36-115). Its
  hard-label fast path: logits stay in their dtype, max and logsumexp
  accumulate in fp32, ``ignore_index`` rows count neither in the sum
  nor in the mean's denominator. Its general path, for soft labels,
  class weights, label smoothing or ``use_softmax=False``: fp32
  log-probabilities (``log_softmax``, or ``log(clip(p, 1e-15, 1))`` of
  given probabilities), soft labels smoothed toward uniform, hard labels
  smoothed by the mean log-probability, a class-weighted mean divided by
  the summed weights of the rows not ignored.
- :func:`linear_cross_entropy` (:374-410): the fused LM head and
  cross entropy. :class:`_LinearCE` mirrors ``_linear_ce`` (:293-371):
  the vocabulary goes in chunks of ``vocab_chunk`` with an online
  logsumexp, so the (N, vocab) logits never exist at once, and the
  backward recomputes each chunk from the saved fp32 lse. Its products
  stay ``torch.matmul`` in fp32 accumulation: JAX leaves them to XLA.

Both are gray under AMP (on neither list): they follow their inputs.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch.autograd.function import once_differentiable

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs

__all__ = ["cross_entropy", "linear_cross_entropy"]


def _reduce(loss, reduction: str):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0):
    """Cross entropy over ``axis`` of logits (or, with
    ``use_softmax=False``, probabilities) against hard labels (class ids,
    with or without a trailing unit axis) or, with ``soft_label``, a
    distribution per row. ``reduction="mean"`` averages hard labels over
    the rows not ignored (weighted: divides by their summed class
    weights), soft labels over every row."""
    # the op's positional inputs, as the reference's dispatcher casts them
    logits, label = maybe_cast_inputs("cross_entropy", (input, label))
    if (soft_label or not use_softmax or weight is not None
            or label_smoothing != 0.0):
        return _cross_entropy_general(logits, label, weight, ignore_index,
                                      reduction, soft_label, axis,
                                      use_softmax, label_smoothing)
    lbl = label
    if lbl.dim() == logits.dim():
        lbl = lbl.squeeze(axis)
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    m = logits.amax(dim=axis, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted.float()).sum(dim=axis))
    picked = torch.gather(shifted, axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, lse - picked.float(), 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1).float()
    return _reduce(loss, reduction)


def _cross_entropy_general(logits, label, weight, ignore_index: int,
                           reduction: str, soft_label: bool, axis: int,
                           use_softmax: bool, label_smoothing: float):
    """The general path of JAX ``cross_entropy`` (:69-115), term for
    term, in fp32."""
    if logits.is_floating_point() and torch.finfo(logits.dtype).bits < 32:
        logits = logits.float()
    if use_softmax:
        logp = torch.log_softmax(logits, dim=axis)
    else:
        logp = torch.log(logits.clamp(1e-15, 1.0))
    num_classes = logits.shape[axis]
    if soft_label:
        lbl = label
        if label_smoothing > 0.0:
            lbl = (1 - label_smoothing) * lbl + label_smoothing / num_classes
        term = lbl * logp
        if weight is not None:
            shape = [1] * term.dim()
            shape[axis] = num_classes
            term = term * weight.reshape(shape)
        loss = -term.sum(dim=axis)
        valid = None
    else:
        lbl = label
        if lbl.dim() == logp.dim():    # (N, ..., 1) index form
            lbl = lbl.squeeze(axis)
        lbl = lbl.long()
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, 0)
        picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
        if label_smoothing > 0.0:
            smooth = logp.mean(dim=axis)
            picked = (1 - label_smoothing) * picked + label_smoothing * smooth
        loss = -torch.where(valid, picked, 0.0)
        if weight is not None:
            w = torch.where(valid, weight[safe], 0.0)
            loss = loss * w
            if reduction == "mean":
                return loss.sum() / w.sum().clamp(min=1e-12)
    if reduction == "mean" and not soft_label:
        return loss.sum() / valid.sum().clamp(min=1).to(loss.dtype)
    return _reduce(loss, reduction)


def _lce_chunks(vocab: int, chunk: int) -> List[Tuple[int, int]]:
    """Static chunk boundaries covering [0, vocab)."""
    return [(s, min(chunk, vocab - s)) for s in range(0, vocab, chunk)]


def _slice_w(w, start: int, width: int, w_vocab_major: bool):
    return w[start:start + width] if w_vocab_major \
        else w[:, start:start + width]


def _chunk_logits(x, w_c, w_vocab_major: bool):
    """(N, E) x chunk -> fp32 (N, width), from either weight layout with
    no transposed copy of the whole weight."""
    w_c = w_c.float()
    return torch.matmul(x.float(), w_c.t() if w_vocab_major else w_c)


class _LinearCE(torch.autograd.Function):
    """Per-row loss of ``x @ W`` against ``label``: x (N, E), W (E, V) or
    (V, E) with ``w_vocab_major``, label (N,) int64."""

    @staticmethod
    def forward(ctx, x, w, label, chunk: int, w_vocab_major: bool,
                ignore_index: int):
        n = x.shape[0]
        v = w.shape[0] if w_vocab_major else w.shape[1]
        m = torch.full((n,), float("-inf"), dtype=torch.float32,
                       device=x.device)
        s = torch.zeros((n,), dtype=torch.float32, device=x.device)
        picked = torch.zeros((n,), dtype=torch.float32, device=x.device)
        for start, width in _lce_chunks(v, chunk):
            logits = _chunk_logits(x, _slice_w(w, start, width,
                                               w_vocab_major), w_vocab_major)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            local = label - start
            in_chunk = (local >= 0) & (local < width)
            idx = local.clamp(0, width - 1)
            got = torch.gather(logits, 1, idx[:, None])[:, 0]
            picked = torch.where(in_chunk, got, picked)
        lse = m + torch.log(s)
        loss = torch.where(label != ignore_index, lse - picked, 0.0)
        ctx.save_for_backward(x, w, label, lse)
        ctx.chunk, ctx.w_vocab_major = chunk, w_vocab_major
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, label, lse = ctx.saved_tensors
        wvm = ctx.w_vocab_major
        v = w.shape[0] if wvm else w.shape[1]
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw_chunks = []
        valid = (label != ctx.ignore_index).float()
        gcol = (g.float() * valid)[:, None]                 # (N, 1)
        for start, width in _lce_chunks(v, ctx.chunk):
            w_c = _slice_w(w, start, width, wvm)
            logits = _chunk_logits(x, w_c, wvm)
            p = torch.exp(logits - lse[:, None])            # softmax chunk
            local = label - start
            onehot = (torch.arange(width, device=x.device)[None, :]
                      == local[:, None])
            # cast to x's dtype before the products, as _linear_ce_bwd
            dlogits = ((p - onehot.float()) * gcol).to(x.dtype).float()
            dx += torch.matmul(dlogits, w_c.float() if wvm
                               else w_c.float().t())
            dw_c = torch.matmul(dlogits.t(), x.float()) if wvm \
                else torch.matmul(x.float().t(), dlogits)
            dw_chunks.append(dw_c.to(w.dtype))
        dw = torch.cat(dw_chunks, dim=0 if wvm else 1)
        return dx.to(x.dtype), dw, None, None, None, None


def linear_cross_entropy(x, weight, label, reduction: str = "mean",
                         vocab_chunk: int = 8192, w_vocab_major: bool = False,
                         ignore_index: int = -100):
    """Fused LM-head projection + softmax cross entropy: x (..., E);
    weight (E, V), or (V, E) with ``w_vocab_major=True`` (a tied input
    embedding, consumed as it is); label (...,) int. Leading dims are
    flattened; ``reduction="mean"`` averages over rows not ignored."""
    x, weight = maybe_cast_inputs("linear_cross_entropy", (x, weight))
    lead = x.shape[:-1]
    flat_label = label.reshape(-1).long()
    loss = _LinearCE.apply(x.reshape(-1, x.shape[-1]), weight, flat_label,
                           int(vocab_chunk), bool(w_vocab_major),
                           int(ignore_index))
    if reduction == "mean":
        count = (flat_label != ignore_index).float().sum().clamp(min=1.0)
        return loss.sum() / count
    return _reduce(loss.reshape(lead), reduction)
