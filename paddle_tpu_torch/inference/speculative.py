"""Speculative decoding over the dense or the paged arena — the port of
``paddle_tpu/inference/speculative.py``.

Draft-and-verify (Leviathan et al. 2023; Chen et al. 2023): a cheap
drafter proposes k continuation tokens per slot; ONE forward of the
target model over ``[pending, d_1..d_k]`` per slot — the decode step's
per-slot write, mask and position math at s = k+1, so on the paged
arena the model routes it to the paged decode kernel K4, any k — returns
logits at every candidate position; an acceptance rule keeps the longest
valid prefix of the draft and draws one more token from the target's
own distribution. Every
verify commits between 1 and k+1 tokens per slot.

Rollback of rejected tokens is free by construction: a slot never reads
a column past its own offset (K4 and the dense mask read ``cols <= t +
j``), so rejecting a draft suffix is just not advancing ``t``; the
stale rows are overwritten by the next write before anything reads
them.

- :class:`NgramDrafter` — model-free prompt lookup on the host: the
  continuation of the most recent earlier occurrence of the slot's
  trailing n-gram, or the last token repeated.
- :class:`DraftModelDrafter` — a small draft model on a private dense
  :class:`~paddle_tpu_torch.inference.serving.DecodeEngine` whose arena
  mirrors the target's commit state, drafting k tokens greedily a tick,
  at accept cap k - 1.
- :class:`SpeculativeEngine` — a :class:`~paddle_tpu_torch.inference.
  serving.DecodeEngine` plus :meth:`~SpeculativeEngine.verify`.

Acceptance (``speculative.py:427-506`` of the reference): greedy slots
accept the exact prefix matching the target's argmax (token-identical to
non-speculative greedy decoding); temperature slots accept ``d_j`` with
probability ``p(d_j)`` under the filtered target distribution and, at the
first rejection, draw from the residual (``d_j`` removed, renormalised) —
the committed marginal is exactly ``p``. Position ``P = t + 1 + j``'s
acceptance coin and draw are ``position_uniforms(keydata, P, lane)`` on
lanes ``LANE_COIN`` and ``LANE_DRAW`` (``core/random.py``), so a
request's stream depends on the request and the position only.

The verify dispatches as the ``verify`` program of the engine's
:class:`~paddle_tpu_torch.inference.program_set.ProgramSet`, beside the
chunk prefill, so a speculative engine counts chunk + verify = 2
executables; with ``logit_guard=True`` it also returns the per-slot
finite mask over every candidate position (``speculative.py:559``).

Not ported yet: ``DraftLenController`` (adaptive k), the constrained
verify's masks, adapters and replicas.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.random import LANE_COIN, LANE_DRAW
from paddle_tpu_torch.inference.program_set import _weak_program
from paddle_tpu_torch.inference.serving import DecodeEngine, _MaskMirror
from paddle_tpu_torch.observability.sentinel import describe_args

__all__ = ["NgramDrafter", "DraftModelDrafter", "SpeculativeEngine"]


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


class DraftModelDrafter:
    """Small-draft-model drafter on its own dense decode arena
    (``speculative.py:159``).

    The draft model (same vocabulary as the target) runs k greedy decode
    steps a tick through a private dense :class:`DecodeEngine` whose
    (slots, max_len) arena mirrors the target's: a draft step feeds the
    slot's pending token at the target's own offset, so after a verify
    accepts a < k tokens the draft arena's rows [0, t + a + 1) hold
    exactly the committed sequence's K/V, and rollback is the same
    "don't advance t" as the target's. The k-th draft's K/V is never
    written (k steps write rows t .. t + k - 1), so ``accept_cap`` is
    k - 1: the mirror stays exact with no catch-up step. Greedy drafting
    keeps the proposal deterministic, which the acceptance rule for
    sampled targets needs."""

    def __init__(self, model, k: int = 4, prefill_chunk: int = 128):
        if k < 2:
            raise ValueError(
                f"DraftModelDrafter needs k >= 2 (accept cap is k-1; "
                f"k=1 could never accept a draft), got {k}")
        self.model = model
        self.k = int(k)
        self.prefill_chunk = int(prefill_chunk)
        self.engine: Optional[DecodeEngine] = None
        self.k_eff = self.k

    @property
    def accept_cap(self) -> int:
        return self.k - 1

    def set_draft_len(self, k_eff: int):
        """Adopt an effective draft length in [1, k]: :meth:`propose`
        runs ``min(k, k_eff + 1)`` draft steps (each a full draft-model
        forward) and pads the remaining columns with the last draft; the
        engine's commit clamp at k_eff makes pad positions
        uncommittable. k_eff + 1 steps keep the mirror exact: an accept
        of a <= k_eff tokens needs draft rows up to t + a, and step j
        writes row t + j."""
        if not 1 <= int(k_eff) <= self.k:
            raise ValueError(
                f"k_eff must be in [1, {self.k}], got {k_eff}")
        self.k_eff = int(k_eff)

    def begin(self, slots: int, max_len: int):
        """The draft arena of ``slots`` rows of ``max_len``, built once
        per geometry."""
        if self.engine is not None and \
                (self.engine.b, self.engine.max_len) == (int(slots),
                                                         int(max_len)):
            self.engine.refresh_params()
            return
        self.engine = DecodeEngine(self.model, slots, max_len, top_k=None,
                                   prefill_chunk=self.prefill_chunk)
        b = self.engine.b
        self._temps = np.ones((b,), np.float32)
        self._greedy = np.ones((b,), bool)           # deterministic drafts
        self._keydata = np.zeros((b, 2), np.uint32)  # unused under greedy

    def admit(self, slots, ids, prompt_lens):
        """Prefill the draft arena rows of newly admitted slots with the
        prompts the target prefilled."""
        nb = len(slots)
        self.engine.prefill(np.asarray(ids, np.int64),
                            np.asarray(slots, np.int32),
                            np.asarray(prompt_lens, np.int32),
                            self._temps[:nb], self._greedy[:nb],
                            self._keydata[:nb])

    def propose(self, contexts, pending, t) -> np.ndarray:
        """k greedy draft steps over the whole arena in lockstep, feeding
        each slot's pending token at the target's offset; the chain d_1
        .. d_k is the proposal, (b, k) int32, read back once. Idle slots
        step garbage rows that are never read."""
        b = self.engine.b
        toks = np.asarray(pending, np.int64).reshape(b, 1)
        tt = np.asarray(t, np.int32).copy()
        steps = min(self.k, int(self.k_eff) + 1)
        chain = []
        for _ in range(steps):
            toks = self.engine.step(toks, tt, self._temps, self._greedy,
                                    self._keydata)
            chain.append(toks)
            tt += 1
        drafts = np.zeros((b, self.k), np.int32)
        drafts[:, :steps] = torch.cat(chain, dim=1).cpu().numpy()
        if steps < self.k:
            # the verify still reads k columns: pad with the last draft
            drafts[:, steps:] = drafts[:, steps - 1:steps]
        return drafts

    def release(self):
        """Free the draft arena alongside the target's."""
        if self.engine is not None:
            self.engine.release_buffers()

    def executable_count(self) -> Optional[int]:
        """The draft arena's program count (0 before :meth:`begin`)."""
        if self.engine is None:
            return 0
        return self.engine.executable_count()


class SpeculativeEngine(DecodeEngine):
    """A :class:`DecodeEngine` (dense or paged) plus one verify at fixed
    ``k``.

    :meth:`verify` runs the target over the k+1 tokens ``[pending,
    d_1..d_k]`` per slot, written at rows t..t+k of the slot's row or
    blocks, and applies the acceptance rule on the device. Callers keep
    ``t + k <= max_len - 1`` for every slot (the serving engine reserves
    k rows of headroom). The target's adapters apply at every verify
    offset, and the constrained verify folds per-position vocab masks
    (``verify_masks``, ``(b, k+1, ceil(V/32))``: position j's row is the
    grammar's mask after stepping along d_1..d_j) before every filter,
    so acceptance, the residual and the bonus draw all see the
    grammar-filtered target (``speculative.py:311-360``). The
    reference's ``ids_dtype``, ``mesh`` and ``seq_parallel`` are
    accepted at their defaults only."""

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
        self.k = int(k)
        # the constrained verify's per-(slot, position) rows, mirrored
        # on the device like the base masks
        self._vmasks: Optional[_MaskMirror] = None
        self.verify_masks: Optional[np.ndarray] = None  # its host rows
        if self._masks is not None:
            self._vmasks = _MaskMirror(
                (self.b, self.k + 1, self.mask_lanes), self.device)
            self.verify_masks = self._vmasks.host
        # same registry as the base programs: the sentinel and
        # executable_count() see the verify beside the chunk prefill
        self.programs.register("verify", _weak_program(self._verify_program))

    def set_verify_mask_rows(self, slot: int, rows) -> None:
        """Write one slot's (k+1, ceil(V/32)) per-position mask block
        and invalidate the device copy."""
        self._vmasks.set(slot, rows)

    def reset_mask_row(self, slot: int) -> None:
        """Retire hygiene: the base row AND the verify block back to the
        identity (no dirtying when already identity)."""
        super().reset_mask_row(slot)
        if self._vmasks is not None:
            self._vmasks.reset(slot)

    def _vmasks_arg(self):
        return (None, False) if self._vmasks is None else \
            self._vmasks.arg()

    def verify_mask_arg(self):
        """The (b, k+1, ceil(V/32)) verify-mask argument, a device copy
        cached behind the dirty flag; None when masks are unsupported."""
        return self._vmasks_arg()[0]

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
        With the logit guard, ``last_step_finite`` holds the (b,)
        finite mask over every candidate position. ``defer=True``
        returns ``(out, accept, finalize)``, the overlap contract of
        :meth:`DecodeEngine.step`."""
        self._ensure_buffers()
        topks, topps = self._sampling_vectors(self.b, topks, topps)
        t = np.asarray(t, np.int32)
        temps = np.asarray(temps, np.float32)
        greedy = np.asarray(greedy, bool)
        keydata = np.asarray(keydata, np.uint32)
        vmasks, fold = self._vmasks_arg()
        adapters, aids = self._adapter_args()
        res = self.programs.call(
            "verify", pending, drafts, t, temps, greedy, keydata, topks,
            topps, vmasks, fold, adapters, aids,
            describe=lambda: describe_args(
                pending=pending, drafts=drafts, t=t, temps=temps,
                greedy=greedy, keydata=keydata, topks=topks, topps=topps,
                vmasks=vmasks, aids=aids),
            defer=defer)
        fin = None
        if defer:
            res, fin = res
        out, acc, self.last_step_finite = res
        return (out, acc, fin) if defer else (out, acc)

    def _verify_program(self, pending, drafts, t, temps, greedy, keydata,
                        topks, topps, vmasks, fold: bool, adapters, aids):
        """The verify program (``_build_verify``): one forward over the
        k+1 candidate rows a slot and the acceptance rule, ``(out,
        accept, finite or None)`` on the device."""
        k = self.k
        toks = np.concatenate(
            [np.asarray(pending, np.int64).reshape(self.b, 1),
             np.asarray(drafts, np.int64).reshape(self.b, k)], axis=1)
        ids = self._vec(toks, torch.int64)
        table = self._table()
        t_np = np.asarray(t, np.int64)
        tv = self._vec(t_np, torch.int32)
        a = self._sampler_args(temps, greedy, topks, topps)
        pos = t_np[:, None] + 1 + np.arange(k + 1)
        u_draw = self._uniforms(a, keydata, pos, LANE_DRAW)
        u_coin = self._uniforms(a, keydata, pos[:, :k], LANE_COIN)
        a["masks"] = vmasks if fold else None
        ok = None
        with self._eval_mode():
            # one forward over the k+1 candidate rows per slot; all of
            # them are genuine token K/V, so with int8 pools all k+1
            # count toward the block scales (cl = k + 1); the TARGET's
            # adapter applies at every verify offset
            logits, _ = self.model(
                ids, caches=self._caches(table, tv, k + 1),
                **self._forward_adapters(adapters, aids))
            lg = logits.float()                            # (b, k+1, V)
            if self.logit_guard:
                # a poisoned slot's acceptance and resample run on
                # zeros: valid draws the caller discards
                ok, lg = self._guard(lg, 2)
            lg = self._filter_dev(lg, a)
            out, acc = self._accept(lg, ids[:, 1:], a["greedy"], u_coin,
                                    u_draw)
        return out, acc, ok

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
