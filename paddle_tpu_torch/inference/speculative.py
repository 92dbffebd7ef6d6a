"""Speculative decoding over the paged arena — the port of
``paddle_tpu/inference/speculative.py``.

Draft-and-verify (Leviathan et al. 2023; Chen et al. 2023): a cheap
drafter proposes k continuation tokens per slot; ONE forward of the
target model over ``[pending, d_1..d_k]`` per slot — the decode step's
per-slot write, mask and position math at s = k+1, so the model routes
it to the paged decode kernel K4 — returns logits at every candidate
position; an acceptance rule keeps the longest valid prefix of the draft
and draws one more token from the target's own distribution. Every
verify commits between 1 and k+1 tokens per slot.

Rollback of rejected tokens is free by construction: a slot never reads
a column past its own offset (K4 masks ``cols <= t + j``), so rejecting
a draft suffix is just not advancing ``t``; the stale rows are
overwritten by the next write before anything reads them.

- :class:`NgramDrafter` — model-free prompt lookup on the host: the
  continuation of the most recent earlier occurrence of the slot's
  trailing n-gram, or the last token repeated.
- :class:`SpeculativeEngine` — a paged :class:`~paddle_tpu_torch.
  inference.serving.DecodeEngine` plus :meth:`~SpeculativeEngine.verify`.

Acceptance (``speculative.py:427-506`` of the reference): greedy slots
accept the exact prefix matching the target's argmax (token-identical to
non-speculative greedy decoding); temperature slots accept ``d_j`` with
probability ``p(d_j)`` under the filtered target distribution and, at the
first rejection, draw from the residual (``d_j`` removed, renormalised) —
the committed marginal is exactly ``p``. Position ``P = t + 1 + j``'s
acceptance coin and draw are ``position_uniforms(keydata, P, lane)`` on
lanes ``LANE_COIN`` and ``LANE_DRAW`` (``core/random.py``), so a
request's stream depends on the request and the position only.

Not ported yet: the draft-model drafter (it rides a dense arena), the
constrained verify's masks, the logit guard, adapters and replicas.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.random import LANE_COIN, LANE_DRAW
from paddle_tpu_torch.core.unported import refuse_unported
from paddle_tpu_torch.inference.serving import DecodeEngine

__all__ = ["NgramDrafter", "SpeculativeEngine"]

# K4 on the card holds at most this many query rows per slot
# (ops/kernels/paged_attention.py); a verify runs k + 1 of them
_K4_MAX_ROWS = 16


class NgramDrafter:
    """Model-free prompt-lookup drafter (host-side suffix match).

    Proposes the continuation of the most recent earlier occurrence of
    the slot's trailing n-gram, trying n = ``max_ngram`` down to
    ``min_ngram``; with no match it proposes the last token repeated.
    ``window`` caps the matched context."""

    def __init__(self, k: int = 4, max_ngram: int = 3, min_ngram: int = 1,
                 window: int = 512):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = int(k)
        self.max_ngram = int(max_ngram)
        self.min_ngram = max(1, int(min_ngram))
        self.window = int(window)
        self.k_eff = self.k

    @property
    def accept_cap(self) -> int:
        return self.k

    def set_draft_len(self, k_eff: int):
        """Record an effective draft length in [1, k]; the proposal
        shape stays (b, k)."""
        if not 1 <= int(k_eff) <= self.k:
            raise ValueError(
                f"k_eff must be in [1, {self.k}], got {k_eff}")
        self.k_eff = int(k_eff)

    # lifecycle hooks of the drafter interface; stateless here
    def begin(self, slots: int, max_len: int):
        pass

    def admit(self, slots, ids, prompt_lens):
        pass

    def release(self):
        pass

    def executable_count(self) -> int:
        return 0   # no device programs of its own

    def _lookup(self, ctx: np.ndarray) -> np.ndarray:
        n_ctx = ctx.shape[0]
        for n in range(min(self.max_ngram, n_ctx - 1), self.min_ngram - 1,
                       -1):
            pat = ctx[-n:]
            win = np.lib.stride_tricks.sliding_window_view(ctx, n)
            hits = np.nonzero((win == pat).all(axis=1))[0]
            # drop the trailing self-match; keep starts whose
            # continuation is non-empty
            hits = hits[hits < n_ctx - n]
            if hits.size:
                s = int(hits[-1])   # most recent occurrence
                cont = ctx[s + n: s + n + self.k]
                out = np.empty((self.k,), np.int32)
                out[:cont.shape[0]] = cont
                out[cont.shape[0]:] = cont[-1] if cont.shape[0] else ctx[-1]
                return out
        return np.full((self.k,), ctx[-1], np.int32)

    def propose(self, contexts: Sequence[Optional[Sequence[int]]],
                pending, t) -> np.ndarray:
        """``contexts[slot]`` is the slot's committed ids (prompt +
        generated, pending token last) or None for an idle slot.
        Returns (b, k) int32 draft tokens (zeros for idle slots)."""
        out = np.zeros((len(contexts), self.k), np.int32)
        for i, ctx in enumerate(contexts):
            if not ctx:
                continue
            arr = np.asarray(ctx[-self.window:], np.int64)
            out[i] = self._lookup(arr)
        return out


class SpeculativeEngine(DecodeEngine):
    """A paged :class:`DecodeEngine` plus one verify at fixed ``k``.

    :meth:`verify` runs the target over the k+1 tokens ``[pending,
    d_1..d_k]`` per slot, written at rows t..t+k of the slot's blocks,
    and applies the acceptance rule on the device. Callers keep ``t + k
    <= max_len - 1`` for every slot (the serving engine reserves k rows
    of headroom). On a CUDA device ``k + 1`` may not exceed the 16 query
    rows K4 holds. The reference's ``ids_dtype``, ``mesh``,
    ``logit_guard``, ``host_tier_blocks``, ``seq_parallel`` and
    ``adapter_pool`` are accepted at their defaults only."""

    def __init__(self, model, max_batch_slots: int, max_len: int,
                 k: int = 4, top_k: Optional[int] = None, ids_dtype=None,
                 prefill_chunk: int = 128,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None, kv_dtype=None,
                 mesh=None, logit_guard: bool = False,
                 host_tier_blocks: Optional[int] = None,
                 seq_parallel: bool = False, adapter_pool=None):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        super().__init__(model, max_batch_slots, max_len, top_k=top_k,
                         ids_dtype=ids_dtype, prefill_chunk=prefill_chunk,
                         block_size=block_size, num_blocks=num_blocks,
                         kv_dtype=kv_dtype, mesh=mesh,
                         logit_guard=logit_guard,
                         host_tier_blocks=host_tier_blocks,
                         seq_parallel=seq_parallel,
                         adapter_pool=adapter_pool)
        if self.device.type == "cuda" and k + 1 > _K4_MAX_ROWS:
            raise ValueError(
                f"k={k}: the verify runs k + 1 = {k + 1} query rows per "
                f"slot through the paged decode kernel K4, which holds at "
                f"most {_K4_MAX_ROWS} on the card; use k <= "
                f"{_K4_MAX_ROWS - 1}")
        self.k = int(k)

    def verify(self, pending, drafts, t, temps, greedy, keydata,
               topks=None, topps=None, defer: bool = False):
        """One draft-and-verify step over all b slots. ``pending`` is
        (b, 1) — each slot's last committed token (its K/V not yet
        written) — and ``drafts`` (b, k); ``keydata`` the slots' (b, 2)
        uint32 streams; ``topks``/``topps`` the per-slot runtime filters
        (None = disabled) of the target distribution the rule preserves.
        Returns ``(out, accept)`` as (b, k+1) and (b,) device tensors,
        WITHOUT waiting for the card: commit ``out[slot, :accept[slot] +
        1]`` (clamped by the caller's cap) and advance ``t`` by as many.
        ``defer`` is accepted at its default only."""
        refuse_unported("SpeculativeEngine.verify", defer=(defer, False))
        self._ensure_buffers()
        k = self.k
        toks = np.concatenate(
            [np.asarray(pending, np.int64).reshape(self.b, 1),
             np.asarray(drafts, np.int64).reshape(self.b, k)], axis=1)
        ids = self._vec(toks, torch.int64)
        table = self._vec(self.table, torch.int32)
        t_np = np.asarray(t, np.int64)
        tv = self._vec(t_np, torch.int32)
        a = self._sampler_args(temps, greedy, topks, topps)
        pos = t_np[:, None] + 1 + np.arange(k + 1)
        u_draw = self._uniforms(a, keydata, pos, LANE_DRAW)
        u_coin = self._uniforms(a, keydata, pos[:, :k], LANE_COIN)
        with self._eval_mode():
            # one forward over the k+1 candidate rows per slot; all of
            # them are genuine token K/V, so with int8 pools all k+1
            # count toward the block scales (cl = k + 1)
            logits, _ = self.model(ids, caches=self._caches(table, tv, k + 1))
            lg = self._filter_dev(logits.float(), a)    # (b, k+1, V)
            return self._accept(lg, ids[:, 1:], a["greedy"], u_coin, u_draw)

    def _accept(self, lg, drafts, greedy, u_coin, u_draw):
        """The acceptance rule over the filtered logits ``lg`` (b, k+1,
        V): ``(out, accept)``. ``greedy`` is None when every slot is
        greedy (then no uniform is needed)."""
        k = self.k
        gmax = torch.argmax(lg, dim=-1)                   # (b, k+1)
        match = drafts == gmax[:, :k]
        if greedy is None:
            acc, y = match, gmax
        else:
            probs = torch.softmax(lg[:, :k], dim=-1)
            p_d = torch.gather(probs, -1, drafts[..., None])[..., 0]
            acc = torch.where(greedy[:, None], match, u_coin < p_d)
            # residual at j < k (the draft's logit removed), the
            # untouched bonus at j = k; a residual at an accepted
            # position is never committed, so an all -inf row there
            # (p(d) = 1) is harmless
            res = lg[:, :k].scatter(-1, drafts[..., None], float("-inf"))
            cand = torch.cat([res, lg[:, k:]], dim=1)
            y = torch.where(greedy[:, None], gmax,
                            self._draw_dev(cand, u_draw))
        accept = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
        pad = torch.cat([drafts, drafts[:, -1:]], dim=1)
        jidx = torch.arange(k + 1, device=lg.device)[None, :]
        out = torch.where(jidx < accept[:, None], pad, y)
        return out, accept.to(torch.int32)
