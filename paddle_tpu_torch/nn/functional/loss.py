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

The rest of the reference's losses (``softmax_with_cross_entropy`` and
``binary_cross_entropy`` through :func:`ctc_loss`) follow its formulas
term for term; each casts its leading tensor inputs by the reference's
op name under ``auto_cast`` (``binary_cross_entropy``,
``binary_cross_entropy_with_logits``, ``nll_loss``, ``kl_div``,
``l1_loss``, ``mse_loss``, ``smooth_l1_loss`` and ``sigmoid_focal_loss``
are black-listed: fp32). :func:`ctc_loss` is the reference's log-space
alpha recursion over time, batched over samples.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch.autograd.function import once_differentiable

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "nll_loss", "kl_div", "l1_loss",
    "mse_loss", "smooth_l1_loss", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "triplet_margin_loss",
    "sigmoid_focal_loss", "square_error_cost", "log_loss", "dice_loss",
    "linear_cross_entropy", "ctc_loss",
]


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


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               ignore_index: int = -100, axis: int = -1,
                               return_softmax: bool = False):
    """The fused op's contract: the unreduced loss with a unit axis at
    ``axis``, and with ``return_softmax`` the softmax too."""
    from paddle_tpu_torch.nn.functional.activation import softmax
    from paddle_tpu_torch.ops.manipulation import unsqueeze

    loss = unsqueeze(cross_entropy(logits, label, soft_label=soft_label,
                                   ignore_index=ignore_index,
                                   reduction="none", axis=axis), axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def _cast(name, *xs):
    return maybe_cast_inputs(name, xs)


def binary_cross_entropy(input, label, weight=None, reduction: str = "mean"):
    input, label = _cast("binary_cross_entropy", input, label)
    eps = 1e-12
    x = input.clamp(eps, 1.0 - eps)
    loss = -(label * torch.log(x) + (1.0 - label) * torch.log(1.0 - x))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction: str = "mean",
                                     pos_weight=None):
    logit, label = _cast("binary_cross_entropy_with_logits", logit, label)
    max_val = (-logit).clamp(min=0.0)
    soft = torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * label + 1.0
        loss = (1.0 - label) * logit + log_w * (soft + max_val)
    else:
        loss = logit.clamp(min=0) - logit * label + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index: int = -100,
             reduction: str = "mean"):
    """``input`` (N, C, ...) log-probabilities; the mean divides by the
    summed weights of the rows not ignored."""
    input, label = _cast("nll_loss", input, label)
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    picked = torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    w = valid.to(input.dtype)
    if weight is not None:
        w = weight[safe] * w
    loss = -picked * w
    if reduction == "mean":
        return loss.sum() / w.sum().clamp(min=1e-12)
    return _reduce(loss, reduction)


def kl_div(input, label, reduction: str = "mean"):
    input, label = _cast("kl_div", input, label)
    loss = label * (torch.log(label.clamp(min=1e-12)) - input)
    loss = torch.where(label > 0, loss, loss.new_zeros(()))
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def l1_loss(input, label, reduction: str = "mean"):
    input, label = _cast("l1_loss", input, label)
    return _reduce(torch.abs(input - label), reduction)


def mse_loss(input, label, reduction: str = "mean"):
    input, label = _cast("mse_loss", input, label)
    return _reduce(torch.square(input - label), reduction)


def smooth_l1_loss(input, label, reduction: str = "mean", delta: float = 1.0):
    input, label = _cast("smooth_l1_loss", input, label)
    diff = torch.abs(input - label)
    loss = torch.where(diff < delta, 0.5 * torch.square(diff) / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin: float = 0.0,
                        reduction: str = "mean"):
    input, other, label = _cast("margin_ranking_loss", input, other, label)
    loss = (-label * (input - other) + margin).clamp(min=0.0)
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin: float = 1.0,
                         reduction: str = "mean"):
    input, label = _cast("hinge_embedding_loss", input, label)
    loss = torch.where(label == 1.0, input, (margin - input).clamp(min=0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin: float = 0.0,
                          reduction: str = "mean"):
    input1, input2, label = _cast("cosine_embedding_loss", input1, input2,
                                  label)
    cos = (input1 * input2).sum(-1) / (
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1)).clamp(min=1e-12)
    loss = torch.where(label == 1, 1.0 - cos, (cos - margin).clamp(min=0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin: float = 1.0,
                        p: float = 2.0, epsilon: float = 1e-6,
                        swap: bool = False, reduction: str = "mean"):
    input, positive, negative = _cast("triplet_margin_loss", input,
                                      positive, negative)

    def dist(a, b):
        return torch.pow(torch.pow(torch.abs(a - b) + epsilon, p).sum(-1),
                         1.0 / p)

    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce((d_pos - d_neg + margin).clamp(min=0.0), reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha: float = 0.25,
                       gamma: float = 2.0, reduction: str = "sum"):
    logit, label = _cast("sigmoid_focal_loss", logit, label)
    p = torch.sigmoid(logit)
    ce = logit.clamp(min=0) - logit * label + torch.log1p(
        torch.exp(-torch.abs(logit)))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def square_error_cost(input, label):
    input, label = _cast("square_error_cost", input, label)
    return torch.square(input - label)


def log_loss(input, label, epsilon: float = 1e-4):
    input, label = _cast("log_loss", input, label)
    return (-label * torch.log(input + epsilon)
            - (1.0 - label) * torch.log(1.0 - input + epsilon))


def dice_loss(input, label, epsilon: float = 1e-5):
    """``input`` (N, ..., C) probabilities, ``label`` (N, ..., 1) ids."""
    input, label = _cast("dice_loss", input, label)
    label_oh = torch.nn.functional.one_hot(
        label.squeeze(-1).long(), input.shape[-1]).to(input.dtype)
    axes = tuple(range(1, input.dim()))
    inter = (input * label_oh).sum(axes)
    union = input.sum(axes) + label_oh.sum(axes)
    dice = (2.0 * inter + epsilon) / (union + epsilon)
    return (1.0 - dice).mean()


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
                ignore_index: int, axis=None):
        n = x.shape[0]
        ctx.label_in = label
        if axis is not None:
            # this rank's vocab rows are [start, start + V_local) of the
            # whole vocab: labels are taken relative to them
            from paddle_tpu_torch.distributed import env

            mesh = env._bound_mesh()
            label = label - mesh.index(axis) * (
                w.shape[0] if w_vocab_major else w.shape[1])
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
        if axis is not None:
            # the vocab-parallel online logsumexp: every rank's running
            # max and sum joined over the axis, the true logit taken
            # from the rank that owns it (the others hold 0)
            from paddle_tpu_torch.distributed import collective as coll

            gm = coll.all_reduce(m.clone(), coll.ReduceOp.MAX,
                                 axis_name=axis)
            s = coll.all_reduce(s * torch.exp(m - gm), axis_name=axis)
            picked = coll.all_reduce(picked, axis_name=axis)
            m = gm
        lse = m + torch.log(s)
        loss = torch.where(ctx.label_in != ignore_index, lse - picked, 0.0)
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
        valid = (ctx.label_in != ctx.ignore_index).float()
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
        return dx.to(x.dtype), dw, None, None, None, None, None


def linear_cross_entropy(x, weight, label, reduction: str = "mean",
                         vocab_chunk: int = 8192, w_vocab_major: bool = False,
                         ignore_index: int = -100):
    """Fused LM-head projection + softmax cross entropy: x (..., E);
    weight (E, V), or (V, E) with ``w_vocab_major=True`` (a tied input
    embedding, consumed as it is); label (...,) int. Leading dims are
    flattened; ``reduction="mean"`` averages over rows not ignored."""
    return _linear_cross_entropy(x, weight, label, reduction, vocab_chunk,
                                 w_vocab_major, ignore_index)


def _linear_cross_entropy(x, weight, label, reduction="mean",
                          vocab_chunk=8192, w_vocab_major=False,
                          ignore_index=-100, axis=None):
    """:func:`linear_cross_entropy`; with ``axis`` (a bound mesh axis,
    ``models/gpt.py`` under tensor parallelism) ``weight`` is this
    rank's shard of the vocab and the loss is the vocab-parallel one:
    each rank runs the chunked online logsumexp over its own rows, the
    running max, the sum of exponentials and the true logit are
    all-reduced over the axis (three (N,) fp32 vectors: no rank gathers
    the weight or the (N, V) logits), and the input's gradient, partial
    on each rank, is all-reduced in the backward (``mp_identity``)."""
    x, weight = maybe_cast_inputs("linear_cross_entropy", (x, weight))
    if axis is not None:
        from paddle_tpu_torch.distributed.meta_parallel.mp_layers import \
            mp_identity

        x = mp_identity(x, axis)
    lead = x.shape[:-1]
    flat_label = label.reshape(-1).long()
    loss = _LinearCE.apply(x.reshape(-1, x.shape[-1]), weight, flat_label,
                           int(vocab_chunk), bool(w_vocab_major),
                           int(ignore_index), axis)
    if reduction == "mean":
        count = (flat_label != ignore_index).float().sum().clamp(min=1.0)
        return loss.sum() / count
    return _reduce(loss.reshape(lead), reduction)


_NEG = -1e30    # log of zero in the CTC lattice, as the reference's


def ctc_loss(log_probs, labels, input_lengths, label_lengths,
             blank: int = 0, reduction: str = "mean",
             norm_by_times: bool = False):
    """Connectionist temporal classification: ``log_probs`` (T, B, C)
    unnormalized logits, ``labels`` (B, L) padded ids, per-sample input
    and label lengths. The extended sequence (blank l1 blank ... blank)
    runs the alpha recursion over time in fp32 for every sample at once,
    frozen past each sample's input length; ``reduction="mean"`` divides
    each loss by its label length, then averages over the batch."""
    (log_probs,) = _cast("ctc_loss", log_probs)
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    t_max, batch, _ = lp.shape
    l_max = labels.shape[1]
    dev = lp.device
    labels = labels.long().to(dev)
    in_len = torch.as_tensor(input_lengths, device=dev).long()
    lab_len = torch.as_tensor(label_lengths, device=dev).long()
    s_max = 2 * l_max + 1
    pos = torch.arange(s_max, device=dev)
    lab_idx = torch.div(pos - 1, 2, rounding_mode="floor").clamp(0, l_max - 1)
    odd = (pos % 2 == 1)[None, :]
    ext = torch.where(odd, labels[:, lab_idx], blank)              # (B, S)
    ext = torch.where((lab_idx[None, :] < lab_len[:, None]) | ~odd, ext, -1)
    safe = torch.where(ext >= 0, ext, blank)
    gathered = torch.gather(lp.transpose(0, 1), 2,
                            safe[:, None, :].expand(batch, t_max, s_max))
    gathered = torch.where((ext >= 0)[:, None, :], gathered, _NEG)  # (B,T,S)
    skip = torch.zeros((batch, s_max), dtype=torch.bool, device=dev)
    if s_max > 2:
        skip[:, 2:] = ((ext[:, 2:] != ext[:, :-2]) & (ext[:, 2:] != -1)
                       & odd[:, 2:])
    neg = torch.full((batch, 1), _NEG, device=dev)
    alpha = torch.full((batch, s_max), _NEG, device=dev)
    alpha[:, 0] = gathered[:, 0, 0]
    if s_max > 1:
        alpha[:, 1] = gathered[:, 0, 1]
    for t in range(1, t_max):
        prev1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)[:, :s_max]
        prev2 = torch.where(skip, prev2, _NEG)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        alpha = torch.where((t < in_len)[:, None], merged + gathered[:, t],
                            alpha)
    ext_len = 2 * lab_len + 1
    last = torch.gather(alpha, 1, (ext_len - 1)[:, None])[:, 0]
    prev = torch.gather(alpha, 1, (ext_len - 2).clamp(min=0)[:, None])[:, 0]
    ll = torch.where(ext_len > 1, torch.logaddexp(last, prev), alpha[:, 0])
    loss = -ll
    if norm_by_times:
        loss = loss / in_len.float().clamp(min=1.0)
    if reduction == "mean":
        return (loss / lab_len.float().clamp(min=1.0)).mean()
    return _reduce(loss, reduction)
