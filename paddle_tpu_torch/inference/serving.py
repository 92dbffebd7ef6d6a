"""Continuous-batching serving over a KV arena — the port of
``paddle_tpu/inference/serving.py``.

Two layers, as in the JAX package:

- :class:`DecodeEngine` — the device substrate, over one of two arenas.
  PAGED (``block_size=`` set): each layer's K/V lives in ONE block pool
  ``(num_blocks, block_size, H, D)`` addressed through an int32 block
  table ``(slots, max_len // block_size)`` — at the model's dtype, or
  (``kv_dtype="int8"``) as int8 codes with fp32 ``(num_blocks, H)``
  absmax scales per layer, quantized on commit (``models/gpt.py``
  ``_upd_paged_q``) and dequantized inside K4/K5. DENSE (the default,
  ``block_size=None``): each layer's K/V is a ``(slots, max_len, H,
  D)`` buffer, a slot one row of it, attended through the plain masked
  attention (the reference computes it in XLA, not in a Pallas
  kernel). Prompts prefill one slot at a time in fixed-size chunks
  (``prefill_chunk`` tokens at a scalar offset: on the paged arena the
  chunk-prefill kernel K5), and decode steps every slot in lockstep
  (per-slot offsets: on the paged arena the paged-decode kernel K4),
  ending in the sampler. PyTorch runs eagerly, so the JAX package's
  compiled programs (``_build_chunk_prefill``, ``_build_step``) are
  plain methods here.

- :class:`ServingEngine` — the host scheduler. FIFO admission gated on
  free BLOCKS (paged) or free slots alone (dense), one prefill chunk
  per tick (oldest-admitted prefilling slot) interleaved with one
  lockstep decode step, on the paged arena lazy block growth as
  committed lengths cross block boundaries and preemption of the
  newest-admitted request when the pool runs dry (it resumes by
  re-prefilling prompt + committed tokens), retirement at EOS or
  length, ``on_token`` streaming, and counted metrics. With a
  :class:`~paddle_tpu_torch.inference.prefix_cache.PrefixCache` a
  prompt's cached full chunks are spliced into the slot's table
  zero-copy (one block reference each; the dense arena copies the
  cached segments into the slot's rows) and only its suffix prefills;
  its new full chunks join the trie when the prompt is committed.

- The host tier (``host_tier_blocks=``, paged only): a
  :class:`~paddle_tpu_torch.inference.block_pool.HostTier` of host
  blocks under the pool. A preempted request's committed full blocks
  are SPILLED there before its device blocks recycle, and re-admission
  copies them back into fresh blocks (swap-back) and resumes its chunk
  prefill at the spilled frontier instead of re-prefilling everything;
  a prefix cache's cold nodes demote there before they are dropped.
  Every copy is blocking, so a block is never recycled or handed out
  while a copy of it is in flight. A spill that fails falls back to
  recompute, a swap-back that fails to a full re-prefill, a promotion
  that fails to a miss.

Lockstep garbage (as in the JAX package's ``serving.py`` docstring):
idle slots keep computing at offset 0 — on the paged arena with an
all-zero table row, so their writes land in scratch block 0, which is
never allocated; on the dense arena in their own row, which nobody
reads before its next prompt rewrites it — and a slot still prefilling
is parked at offset ``plen - 1``, a row its own final chunk rewrites
before the slot's first real decode.

Sampling: greedy is argmax (first index on ties) and token-exact with
the JAX engine. Temperature draws cannot reproduce JAX's threefry
``fold_in(slot_key, P)`` stream. The engine instead takes the
reference's per-slot ``keydata`` — ``(b, 2)`` uint32 key data, one row a
request (``core/random.py`` ``request_keydata``: from ``Request.seed``
when set, else from the engine seed and the request id) — and the token
landing at position ``P`` is the inverse-CDF pick of the filtered
softmax at the uniform ``position_uniforms(keydata, P, LANE_DRAW)``,
computed on the device. A draw is therefore a function of the request
and the position only: it survives preemption and never depends on the
neighbouring slots. It is held to the JAX engine by distribution, not by
value.

The overlapped tick of the JAX engine is kept: a decode step is
launched asynchronously, the next tick's admissions run while the card
computes, and only then are the tokens read back.

With ``spec=`` (an ``NgramDrafter`` or a ``DraftModelDrafter``) the
decode half of a tick is a speculative verify
(``inference/speculative.py``): every live slot commits between 1 and
k+1 tokens per tick.

Out of the port so far (each queued in ROADMAP.md): meshes and
replicas, telemetry and resilience (snapshot/restore of a request, the
audit, fault points), the swap-threshold controller, cancellation, the
front door and fleet, LoRA, constraints, score/embed.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.place import module_device, resolve_device
from paddle_tpu_torch.core.random import (LANE_DRAW, position_uniforms,
                                          request_keydata)
from paddle_tpu_torch.core.unported import refuse_unported
from paddle_tpu_torch.inference.block_pool import BlockAllocator, HostTier
from paddle_tpu_torch.inference.frontend.scheduler import FifoScheduler
from paddle_tpu_torch.inference.prefix_cache import PrefixCache

__all__ = ["DecodeEngine", "ServingEngine", "Request", "ServingMetrics",
           "apply_topk_topp"]


def apply_topk_topp(logits, topks, topps):
    """Per-slot top-k / top-p (nucleus) filter over the last axis
    (``serving.py:102``). ``topks`` (int, ``<= 0`` disables) and
    ``topps`` (float, ``>= 1`` disables) are ``(b,)`` tensors on the
    logits' device; both become a CUTOFF LOGIT (the max of the two
    thresholds), so boundary ties stay in and the argmax token is always
    kept. Works on ``(b, V)`` and ``(b, s, V)`` logits."""
    V = logits.shape[-1]

    def per_slot(x):
        return x.reshape((-1,) + (1,) * (logits.dim() - 1))

    srt = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(topks <= 0, torch.full_like(topks, V), topks)
    kidx = per_slot(k.clamp(1, V) - 1).long().expand(srt.shape[:-1] + (1,))
    kth = torch.gather(srt, -1, kidx)
    probs = torch.softmax(srt, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # token i stays while the mass BEFORE it is short of top_p, so the
    # top token always stays and the nucleus is the minimal cover
    keep = (cum - probs) < per_slot(topps.clamp(0.0, 1.0))
    cnt = keep.sum(dim=-1, keepdim=True).clamp(min=1)
    pth = torch.gather(srt, -1, cnt - 1)
    return torch.where(logits < torch.maximum(kth, pth),
                       torch.full_like(logits, float("-inf")), logits)


def _is_int8(kv_dtype) -> bool:
    """Whether ``kv_dtype`` names int8 (``"int8"``, ``np.int8`` or
    ``torch.int8``)."""
    if kv_dtype is torch.int8:
        return True
    try:
        return np.dtype(kv_dtype) == np.int8
    except TypeError:
        return False


class DecodeEngine:
    """Per-slot decode over a dense arena or one KV block pool per layer.

    ``model`` exposes ``kv_cache_spec()`` and the cache forward
    ``model(ids, caches=[...]) -> (logits, caches)``
    (:class:`~paddle_tpu_torch.models.gpt.GPTForCausalLM`): dense
    ``(k_buf, v_buf, t)``, paged ``(k_pool, v_pool, table, t)`` or
    quantized ``(k_pool, v_pool, k_scale, v_scale, table, t, cl)``. The
    engine runs on the model's device. ``block_size=None`` (the
    default) is the dense arena, ``(slots, max_len, H, D)`` buffers a
    layer; else ``block_size`` must divide ``max_len`` and
    ``num_blocks`` counts the scratch block 0 and defaults to the
    dense-equivalent ``slots * max_len / block_size + 1``. ``top_k`` is
    the static top-k filter of every draw. ``kv_dtype="int8"`` stores
    the pools as int8 codes with per-(block, head) fp32 absmax scales
    (paged only, as ``num_blocks``). ``host_tier_blocks`` (paged only)
    puts a :class:`HostTier` of that many host blocks under the pool,
    pinned on the card. The reference's ``ids_dtype``, ``mesh``,
    ``logit_guard``, ``seq_parallel`` and ``adapter_pool`` are accepted
    at their defaults only."""

    def __init__(self, model, max_batch_slots: int, max_len: int,
                 top_k: Optional[int] = None, ids_dtype=None,
                 prefill_chunk: int = 128,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None, kv_dtype=None, mesh=None,
                 logit_guard: bool = False,
                 host_tier_blocks: Optional[int] = None,
                 seq_parallel: bool = False, adapter_pool=None):
        refuse_unported(
            "DecodeEngine", ids_dtype=(ids_dtype, None), mesh=(mesh, None),
            logit_guard=(logit_guard, False),
            seq_parallel=(seq_parallel, False),
            adapter_pool=(adapter_pool, None))
        spec = model.kv_cache_spec()
        mpe = spec.get("max_position_embeddings")
        if mpe is not None and max_len > mpe:
            raise ValueError(
                f"max_len {max_len} exceeds the model's "
                f"max_position_embeddings {mpe}")
        if kv_dtype is not None and not _is_int8(kv_dtype):
            raise ValueError(
                f"kv_dtype {kv_dtype!r} is not supported: the quantized "
                "KV pool stores int8 codes with per-block absmax scales "
                "(pass kv_dtype='int8') or full precision (leave unset)")
        self.quantized = kv_dtype is not None
        self.paged = block_size is not None
        if self.quantized and not self.paged:
            raise ValueError(
                "kv_dtype='int8' quantizes the PAGED block pools (the "
                "scale is per block); pass block_size= to enable the "
                "paged arena")
        if num_blocks is not None and not self.paged:
            raise ValueError(
                "num_blocks without block_size would be silently ignored "
                "— the KV budget only exists on the paged arena; pass "
                "block_size= to enable it")
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.model = model
        self.device = spec["device"]
        self.b = int(max_batch_slots)
        self.max_len = int(max_len)
        self.top_k = top_k
        self.prefill_chunk = min(int(prefill_chunk), self.max_len)
        self.L = int(spec["num_layers"])
        self.heads = int(spec["num_heads"])
        self.head_dim = int(spec["head_dim"])
        self.dtype = spec["dtype"]
        # pool storage: int8 codes when quantized, else the model's dtype
        self.pool_dtype = torch.int8 if self.quantized else self.dtype
        self.kbufs: Optional[List[torch.Tensor]] = None
        self.vbufs: Optional[List[torch.Tensor]] = None
        self.kscales: Optional[List[torch.Tensor]] = None
        self.vscales: Optional[List[torch.Tensor]] = None
        # the paged bookkeeping; None on the dense arena
        self.allocator: Optional[BlockAllocator] = None
        self.table: Optional[np.ndarray] = None
        if self.paged:
            self._init_paged(int(block_size), num_blocks)
        # the host tier: preempted requests' committed blocks and demoted
        # trie nodes park here and are copied back instead of recomputed
        self.host_tier: Optional[HostTier] = None
        if host_tier_blocks is not None:
            if not self.paged:
                raise ValueError(
                    "host_tier_blocks needs the paged arena (the tier "
                    "parks pool blocks); pass block_size= to enable it")
            self.host_tier = HostTier(
                int(host_tier_blocks), self.block_size, self.L, self.heads,
                self.head_dim, dtype=self.pool_dtype,
                quantized=self.quantized,
                pin_memory=self.device.type == "cuda")

    def _init_paged(self, bs: int, num_blocks: Optional[int]):
        """The block pool's geometry, allocator and host table."""
        if bs < 1 or self.max_len % bs:
            raise ValueError(
                f"block_size {bs} must be >= 1 and divide "
                f"max_len {self.max_len} (the gathered per-slot "
                "view must match the dense arena row for row)")
        self.block_size = bs
        self.blocks_per_slot = self.max_len // bs
        self.num_blocks = int(num_blocks) if num_blocks is not None \
            else self.b * self.blocks_per_slot + 1
        if self.num_blocks < 2:
            raise ValueError(
                f"num_blocks {self.num_blocks} leaves no allocatable "
                "block after the reserved scratch block 0")
        # what one block pins across all layers: K + V rows at the pool
        # dtype, plus the two scale rows of every layer when quantized —
        # the unit of every kv_bytes metric
        itemsize = torch.empty((), dtype=self.pool_dtype).element_size()
        row_nbytes = 2 * self.L * self.heads * self.head_dim * itemsize
        scale_nbytes = 2 * self.L * self.heads * 4 if self.quantized else 0
        self.allocator = BlockAllocator(
            self.num_blocks, bs, block_nbytes=bs * row_nbytes + scale_nbytes)
        # host mirror of the block table; entries past a slot's mapped
        # count stay 0 = the scratch sink
        self.table = np.zeros((self.b, self.blocks_per_slot), np.int32)

    def reset(self):
        """Zero the arena: the dense buffers, or the pools and, when
        quantized, their scales (the table and allocator belong to the
        scheduler and are left alone)."""
        shape = (self.num_blocks, self.block_size, self.heads,
                 self.head_dim) if self.paged else \
            (self.b, self.max_len, self.heads, self.head_dim)

        def zeros(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=self.device)
                    for _ in range(self.L)]

        self.kbufs = zeros(shape, self.pool_dtype)
        self.vbufs = zeros(shape, self.pool_dtype)
        if self.quantized:
            self.kscales = zeros((self.num_blocks, self.heads), torch.float32)
            self.vscales = zeros((self.num_blocks, self.heads), torch.float32)

    def _ensure_buffers(self):
        if self.kbufs is None:
            self.reset()

    def release_buffers(self):
        """Free the arena (``serving.py:770``); it is allocated again, zeroed,
        on the next prefill or step. ``generate()`` releases a cached
        engine between calls, so the model's engine cache pins geometry,
        not device memory."""
        self.kbufs = self.vbufs = None
        self.kscales = self.vscales = None

    def refresh_params(self):
        """Pick up updated weights (``serving.py:662``). The reference
        snapshots parameter values as its programs' arguments; the port
        reads the model's parameters at every forward, so there is
        nothing to refresh."""

    @contextlib.contextmanager
    def _eval_mode(self):
        """Run with the model in eval mode and no autograd, restoring the
        caller's mode after."""
        was = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                yield
        finally:
            self.model.train(was)

    def _caches(self, table, t, cl: int, slot: Optional[int] = None):
        """Per-layer cache tuples; ``cl`` is the commit's count of REAL
        rows, which bounds the quantizer's absmax (``gpt.py:125-135``).
        Dense: the whole arena, or with ``slot`` that slot's row (a view:
        the commit lands in the arena)."""
        if not self.paged:
            rows = slice(None) if slot is None else slice(slot, slot + 1)
            return [(self.kbufs[i][rows], self.vbufs[i][rows], t)
                    for i in range(self.L)]
        if self.quantized:
            return [(self.kbufs[i], self.vbufs[i], self.kscales[i],
                     self.vscales[i], table, t, cl) for i in range(self.L)]
        return [(self.kbufs[i], self.vbufs[i], table, t)
                for i in range(self.L)]

    def _vec(self, x, dtype):
        """``x`` (host values, or a tensor: the previous step's tokens
        stay on the device) as a device tensor of ``dtype``."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def _table(self, rows=slice(None)):
        """The block table's ``rows`` on the device; None on the dense
        arena."""
        if not self.paged:
            return None
        return self._vec(self.table[rows], torch.int32)

    def _sampler_args(self, temps, greedy, topks, topps):
        """The sampler's host vectors as device tensors. Built BEFORE the
        forward: a host-to-device copy after it would wait for the whole
        forward to finish. ``topks``/``topps`` None disable the runtime
        filters for every slot."""
        greedy = np.asarray(greedy)
        n = greedy.shape[0]
        topks = np.zeros(n, np.int64) if topks is None else np.asarray(topks)
        topps = np.ones(n, np.float32) if topps is None else np.asarray(topps)
        filt = (topks > 0).any() or (topps < 1.0).any()
        return {
            "temps": self._vec(np.maximum(temps, 1e-6), torch.float32),
            "greedy": None if greedy.all() else self._vec(greedy, torch.bool),
            "topks": self._vec(topks, torch.int64) if filt else None,
            "topps": self._vec(topps, torch.float32) if filt else None,
        }

    def _uniforms(self, a, keydata, positions, lane: int):
        """``position_uniforms`` of the slots' ``keydata`` at host
        ``positions`` ((b,) or (b, n)), on the device; None when every
        slot is greedy (nothing is drawn)."""
        if a["greedy"] is None:
            return None
        kd = self._vec(np.asarray(keydata, np.uint32).astype(np.int64),
                       torch.int64)
        return position_uniforms(kd, self._vec(positions, torch.int64), lane)

    def _sample(self, last, temps, greedy, uniforms, topks, topps):
        """Device sampler over ``(n, V)`` fp32 logits (``serving.py:833``
        without the threefry stream). Host vectors: ``temps``,
        ``greedy``, ``topks``, ``topps`` and ``uniforms`` (one draw in
        [0, 1) per row, ignored for greedy rows)."""
        a = self._sampler_args(temps, greedy, topks, topps)
        a["uniforms"] = self._vec(uniforms, torch.float32)
        return self._sample_dev(last, a)

    def _filter_dev(self, last, a):
        """The target distribution's logits: temperature, the static
        ``top_k`` and the per-slot runtime top-k/top-p, over ``(b, V)``
        or ``(b, s, V)`` logits (per-slot vectors broadcast over s)."""
        last = last / a["temps"].reshape((-1,) + (1,) * (last.dim() - 1))
        if self.top_k is not None:
            kth = torch.topk(last, self.top_k, dim=-1).values[..., -1:]
            last = torch.where(last < kth,
                               torch.full_like(last, float("-inf")), last)
        if a["topks"] is not None:
            last = apply_topk_topp(last, a["topks"], a["topps"])
        return last

    @staticmethod
    def _draw_dev(logits, u):
        """Inverse-CDF draw from ``softmax(logits)`` at uniforms ``u`` of
        the leading shape; a token outside the filter (probability 0)
        is never picked."""
        cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
        target = (u * cdf[..., -1])[..., None]
        drawn = torch.searchsorted(cdf, target, right=True)[..., 0]
        return drawn.clamp(max=logits.shape[-1] - 1)

    def _sample_dev(self, last, a):
        last = self._filter_dev(last, a)
        arg = torch.argmax(last, dim=-1)
        if a["greedy"] is None:
            return arg
        return torch.where(a["greedy"], arg,
                           self._draw_dev(last, a["uniforms"]))

    def prefill_chunk_at(self, ids_row, slot: int, pos: int, plen: int,
                         temps, greedy, keydata, topks=None, topps=None,
                         targets_row=None):
        """Run the zero-padded ``(1, prefill_chunk)`` prompt chunk
        covering ``[pos, min(pos+C, plen))`` for ``slot``; returns
        ``(tok, next_pos)`` — ``tok`` a (1, 1) device tensor, meaningful
        only for the prompt's final chunk. ``targets_row`` (scoring) is
        accepted at its default only."""
        refuse_unported("prefill_chunk_at", targets_row=(targets_row, None))
        C = self.prefill_chunk
        n = min(C, int(plen) - int(pos))
        chunk = np.zeros((1, C), np.int64)
        chunk[0, :n] = np.asarray(ids_row[pos:pos + n])
        tok = self.run_prefill_chunk(chunk, slot, pos, n - 1, temps,
                                     greedy, keydata, topks=topks,
                                     topps=topps)
        return tok, pos + n

    def run_prefill_chunk(self, ids_chunk, slot: int, start: int,
                          last_idx: int, temps, greedy, keydata,
                          topks=None, topps=None, targets=None):
        """ONE ``(1, prefill_chunk)`` chunk for ``slot`` at pool offset
        ``start`` (a 0-dim offset: the model routes it to K5); samples
        the token of position ``start + last_idx + 1`` at ``last_idx``
        from ``keydata`` ((1, 2) uint32). The pad tail of a short final
        chunk computes discarded rows whose K/V past the table's reach
        is dropped. ``targets`` is accepted at its default only."""
        refuse_unported("run_prefill_chunk", targets=(targets, None))
        self._ensure_buffers()
        ids = self._vec(ids_chunk, torch.int64)
        table = self._table(slice(slot, slot + 1))
        t = torch.tensor(int(start), dtype=torch.int32, device=self.device)
        args = self._sampler_args(temps, greedy, topks, topps)
        args["uniforms"] = self._uniforms(
            args, keydata, [int(start) + int(last_idx) + 1], LANE_DRAW)
        with self._eval_mode():
            # last_idx + 1 real rows: the pad tail of a short final
            # chunk never shapes a block scale
            logits, _ = self.model(
                ids, caches=self._caches(table, t, int(last_idx) + 1,
                                         slot=int(slot)))
            tok = self._sample_dev(logits[:, int(last_idx)].float(), args)
        return tok[:, None]

    def prefill(self, ids, slots, prompt_lens, temps, greedy, keydata,
                topks=None, topps=None):
        """Prefill ``nb`` prompts into arena ``slots``, one slot after
        another in chunks (``serving.py:1669``); returns their first
        tokens, (nb, 1) on the device. ``ids`` is (nb, plen) right-padded
        to the longest prompt (host values or a device tensor),
        ``prompt_lens`` each row's real length; ``temps``, ``greedy``,
        ``keydata`` and the runtime filters are per row."""
        plens = np.asarray(prompt_lens, np.int32)
        nb = plens.shape[0]
        if nb and int(plens.max()) > self.max_len:
            raise ValueError(
                f"prompt length {int(plens.max())} exceeds the "
                f"{self.max_len}-row KV arena")
        if nb and int(plens.min()) < 1:
            raise ValueError(
                "prefill needs at least one prompt token per row (the "
                "first output token samples from the prompt's logits); "
                f"got prompt_lens={plens.tolist()}")
        rows = ids.cpu().numpy() if isinstance(ids, torch.Tensor) \
            else np.asarray(ids)
        slots = np.asarray(slots, np.int32)
        temps = np.asarray(temps, np.float32)
        greedy = np.asarray(greedy, bool)
        keydata = np.asarray(keydata, np.uint32)
        topks = np.zeros(nb, np.int64) if topks is None \
            else np.asarray(topks)
        topps = np.ones(nb, np.float32) if topps is None \
            else np.asarray(topps)
        toks = []
        for r in range(nb):
            plen, pos, tok = int(plens[r]), 0, None
            sl = slice(r, r + 1)
            while pos < plen:
                tok, pos = self.prefill_chunk_at(
                    rows[r], int(slots[r]), pos, plen, temps[sl],
                    greedy[sl], keydata[sl], topks=topks[sl],
                    topps=topps[sl])
            toks.append(tok)
        return torch.cat(toks, dim=0)

    def step(self, toks, t, temps, greedy, keydata, topks=None, topps=None,
             defer: bool = False):
        """One lockstep decode step over all slots (per-slot offsets:
        the model routes it to K4); returns the next token per slot as a
        (b, 1) device tensor, WITHOUT waiting for the card. Slot ``i``'s
        token lands at position ``t[i] + 1`` and is drawn from
        ``keydata[i]`` ((b, 2) uint32). Rows of idle or prefilling slots
        compute garbage the caller discards. ``defer`` is accepted at its
        default only."""
        refuse_unported("DecodeEngine.step", defer=(defer, False))
        self._ensure_buffers()
        ids = self._vec(toks, torch.int64)
        table = self._table()
        tv = self._vec(t, torch.int32)
        args = self._sampler_args(temps, greedy, topks, topps)
        args["uniforms"] = self._uniforms(
            args, keydata, np.asarray(t, np.int64) + 1, LANE_DRAW)
        with self._eval_mode():
            logits, _ = self.model(
                ids, caches=self._caches(table, tv, ids.shape[1]))
            tok = self._sample_dev(logits[:, -1].float(), args)
        return tok[:, None]

    # -- the dense arena's prefix cache: chunk copy and extract -------------
    def copy_chunk(self, slot: int, start: int, kseg, vseg):
        """Seed arena rows ``[start, start + chunk)`` of ``slot`` from a
        cached ``(L, chunk, H, D)`` segment pair (``_build_copy``,
        ``serving.py:1210``): one slice write a layer."""
        if self.paged:
            raise RuntimeError(
                "chunk-copy is a dense-arena program; the paged engine "
                "shares cached prefixes by block-table splice instead")
        self._ensure_buffers()
        cc, start = int(kseg.shape[1]), int(start)
        for i in range(self.L):
            self.kbufs[i][slot, start:start + cc].copy_(kseg[i])
            self.vbufs[i][slot, start:start + cc].copy_(vseg[i])

    def extract_chunk(self, slot: int, start: int, chunk_tokens: int):
        """Arena rows ``[start, start + chunk_tokens)`` of ``slot`` as a
        new ``(L, chunk, H, D)`` segment pair (``_build_extract``,
        ``serving.py:1235``), on the arena's device."""
        if self.paged:
            raise RuntimeError(
                "chunk-extract is a dense-arena program; the paged "
                "engine captures a prefix by taking block references "
                "instead")
        self._ensure_buffers()
        rows = slice(int(start), int(start) + int(chunk_tokens))
        return (torch.stack([self.kbufs[i][slot, rows]
                             for i in range(self.L)]),
                torch.stack([self.vbufs[i][slot, rows]
                             for i in range(self.L)]))

    # -- the host tier: spill and swap-back ---------------------------------
    def gather_blocks_to_host(self, blocks: Sequence[int],
                              replica: int = 0):
        """``blocks``'s pool rows of every layer copied to the host:
        ``(kseg, vseg, kscale, vscale)`` in the :class:`HostTier` layout
        (``(n, L, bs, H, D)`` data, ``(n, L, H)`` scales, None at full
        precision), CPU tensors. The copy is blocking: it has landed when
        this returns. ``replica`` must name the one plane (0)."""
        refuse_unported("gather_blocks_to_host", replica=(replica, 0))
        return tuple(None if x is None else x.cpu()
                     for x in self._gather_blocks(blocks))

    def _gather_blocks(self, blocks: Sequence[int]):
        """``blocks``'s pool rows of every layer, gathered on the
        device in the :class:`HostTier` layout."""
        self._ensure_buffers()
        idx = torch.as_tensor(list(blocks), dtype=torch.int64,
                              device=self.device)

        def take(bufs):
            return torch.stack([bufs[i].index_select(0, idx)
                                for i in range(self.L)], dim=1)

        ks = vs = None
        if self.quantized:
            ks, vs = take(self.kscales), take(self.vscales)
        return take(self.kbufs), take(self.vbufs), ks, vs

    def spill_blocks(self, blocks: Sequence[int],
                     replica: int = 0) -> Optional[List[int]]:
        """Park ``blocks``'s committed KV in the host tier; returns the
        host block ids holding it (one tier reference each, the
        caller's), or None when the tier cannot grant the space (the
        caller recomputes instead). A raise from the copy returns the
        grant first, so a failed spill leaks nothing."""
        refuse_unported("spill_blocks", replica=(replica, 0))
        if self.host_tier is None:
            return None
        host = self.host_tier.alloc(len(blocks))
        if host is None:
            return None
        try:
            # device rows copied straight into the (pinned) tier
            self.host_tier.write(host, *self._gather_blocks(blocks))
        except BaseException:
            # nothing was parked: undo the grant without counting a drop
            self.host_tier.deref(host, aborted=True)
            raise
        return host

    def restore_blocks(self, host_blocks: Sequence[int],
                       device_blocks: Sequence[int], replica: int = 0):
        """Copy parked KV of ``host_blocks`` into pool blocks
        ``device_blocks`` (and their scale rows when quantized), the
        exact bits: one ``index_copy_`` a layer and pool. Remapping the
        block table stays the caller's."""
        refuse_unported("restore_blocks", replica=(replica, 0))
        if self.host_tier is None:
            raise RuntimeError("restore_blocks without a host tier")
        if len(host_blocks) != len(device_blocks):
            raise ValueError(
                f"swap-back maps {len(host_blocks)} host blocks onto "
                f"{len(device_blocks)} device blocks")
        self._ensure_buffers()
        # one copy a tensor from the tier's pinned read to the device
        kseg, vseg, ks, vs = (None if x is None else x.to(self.device)
                              for x in self.host_tier.read(host_blocks))
        idx = torch.as_tensor(list(device_blocks), dtype=torch.int64,
                              device=self.device)
        for i in range(self.L):
            self.kbufs[i].index_copy_(0, idx, kseg[:, i])
            self.vbufs[i].index_copy_(0, idx, vseg[:, i])
            if self.quantized:
                self.kscales[i].index_copy_(0, idx, ks[:, i])
                self.vscales[i].index_copy_(0, idx, vs[:, i])
        self.host_tier.count_swap_in(len(host_blocks))


@dataclass
class Request:
    """One generation request (``serving.py:2025``).

    ``on_token(request, token_id, done)`` streams tokens as they are
    committed (the first when the prompt's prefill completes = time to
    first token). ``finish_reason`` after completion: ``"eos"`` or
    ``"length"``. ``arrival_time`` is an offset in seconds from the start
    of :meth:`ServingEngine.run` (0 = already queued). ``seed`` pins the
    request's sample stream (its ``keydata``); unset, the stream derives
    from the engine seed and the request id. ``top_k``/``top_p`` are
    per-request filters. The fields keep the reference's order; its ``sampling``,
    ``deadline``, ``tenant``, ``priority``, ``adapter``, ``kind`` and
    ``response_format`` are accepted at their defaults only."""

    prompt: Sequence[int]
    max_new_tokens: int = 32
    temperature: float = 1.0
    greedy: bool = False
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    sampling: Optional[Any] = None
    eos_id: Optional[int] = None
    seed: Optional[int] = None
    on_token: Optional[Callable[["Request", int, bool], None]] = None
    on_finish: Optional[Callable[["Request"], None]] = None
    arrival_time: float = 0.0
    deadline: Optional[float] = None
    tenant: str = "default"
    priority: Optional[int] = None
    adapter: Optional[str] = None
    kind: str = "generate"
    response_format: Optional[Any] = None

    # engine-owned
    id: int = -1
    tokens: List[int] = field(default_factory=list)
    status: str = "new"          # new -> queued -> running -> done
    finish_reason: Optional[str] = None

    def __post_init__(self):
        refuse_unported(
            "Request", sampling=(self.sampling, None),
            deadline=(self.deadline, None), tenant=(self.tenant, "default"),
            priority=(self.priority, None), adapter=(self.adapter, None),
            kind=(self.kind, "generate"),
            response_format=(self.response_format, None))


class ServingMetrics:
    """Per-request records and per-tick samples of one ``run()`` window;
    :meth:`aggregate` folds them into the reference's headline keys
    (``serving.py:2475``), with the prefix cache's counted economics
    (``prefix_hit_tokens``, ``prefix_hit_rate``, ``evictions``) when
    ``cache`` is given, the host tier's (``blocks_spilled``,
    ``blocks_swapped_in``, ``reprefill_tokens_avoided``) and the
    speculative ones (``spec_*``) after verify steps. The reference's
    ``registry`` and ``slo`` (telemetry) are accepted at their defaults
    only."""

    def __init__(self, max_batch_slots: int,
                 cache: Optional[PrefixCache] = None,
                 allocator: Optional[BlockAllocator] = None,
                 registry=None, slo=None):
        refuse_unported("ServingMetrics", registry=(registry, None),
                        slo=(slo, None))
        self.slots = max_batch_slots
        self.records: List[Dict[str, Any]] = []
        self.step_samples: List[Dict[str, float]] = []
        self.tick_samples: List[Dict[str, float]] = []
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.prefill_chunks = 0
        self.prompt_tokens = 0
        self.prefix_hit_tokens = 0
        self.preemptions = 0
        self.blocks_spilled = 0
        self.blocks_swapped_in = 0
        self.swap_in_tokens = 0
        self._cache = cache
        self._evict_base = cache.evictions if cache is not None else 0
        self._alloc = allocator
        self._alloc_base = (allocator.allocs, allocator.freed) \
            if allocator is not None else (0, 0)
        if allocator is not None:
            # the high-water mark restarts with the window
            allocator.peak = allocator.blocks_in_use()

    def count_prefill_chunk(self):
        self.prefill_chunks += 1

    def count_prompt_tokens(self, n: int):
        # admission semantics: a preempted request's re-prefill counts
        # again, so prefill_tokens_computed charges the redone work
        self.prompt_tokens += int(n)

    def count_prefix_hit_tokens(self, n: int):
        self.prefix_hit_tokens += int(n)

    def record_preemption(self):
        self.preemptions += 1

    def count_spill(self, blocks: int):
        self.blocks_spilled += int(blocks)

    def count_swap_in(self, blocks: int, tokens: int):
        self.blocks_swapped_in += int(blocks)
        self.swap_in_tokens += int(tokens)

    def record_tick(self, occupied: int, queued: int,
                    blocks: Optional[int] = None):
        """One tick's load sample; ``occupied`` counts every in-flight
        slot, prefilling ones included."""
        sample = {"occupied": float(occupied), "queued": float(queued)}
        if blocks is not None:
            sample["blocks"] = float(blocks)
        self.tick_samples.append(sample)

    def record_step(self, active: int, queued: int,
                    accepted: Optional[int] = None,
                    committed: Optional[int] = None, *,
                    seconds: Optional[float] = None):
        """One decode (or verify) step over ``active`` live slots. A
        speculative step also counts the draft tokens ``accepted`` over
        the live slots and the tokens ``committed`` (accepted plus one
        target token per slot, less budget and EOS truncation).
        ``seconds`` is the host time from launch to tokens on the host,
        the source of ``decode_step_ms_p50``."""
        sample = {"active": float(active), "queued": float(queued)}
        if accepted is not None:
            sample["accepted"] = float(accepted)
            sample["committed"] = float(committed or 0)
        if seconds is not None:
            sample["seconds"] = float(seconds)
        self.step_samples.append(sample)

    def record_request(self, req: Request, arrival: float, admitted: float,
                       first_token: float, finished: float,
                       resume_wait: float = 0.0,
                       resume_wait_pre_first: float = 0.0):
        """One retired request. Time spent back in the queue after a
        preemption counts as queue wait, not TTFT or TPOT."""
        self.t_first = arrival if self.t_first is None \
            else min(self.t_first, arrival)
        self.t_last = finished if self.t_last is None \
            else max(self.t_last, finished)
        n = len(req.tokens)
        decode_time = (finished - first_token) \
            - (resume_wait - resume_wait_pre_first)
        self.records.append({
            "id": req.id, "prompt_len": len(req.prompt), "new_tokens": n,
            "queue_wait": (admitted - arrival) + resume_wait,
            "ttft": first_token - arrival - resume_wait_pre_first,
            "latency": finished - arrival,
            "tpot": decode_time / (n - 1) if n > 1 else None,
        })

    def aggregate(self) -> Dict[str, float]:
        out: Dict[str, float] = {"completed": float(len(self.records))}
        if self.records:
            lat = np.asarray([r["latency"] for r in self.records])
            ttft = np.asarray([r["ttft"] for r in self.records])
            qwait = np.asarray([r["queue_wait"] for r in self.records])
            out["total_new_tokens"] = float(
                sum(r["new_tokens"] for r in self.records))
            wall = max((self.t_last or 0.0) - (self.t_first or 0.0), 1e-9)
            out["wall_s"] = wall
            out["aggregate_tokens_per_s"] = out["total_new_tokens"] / wall
            out["latency_p50_s"] = float(np.percentile(lat, 50))
            out["latency_p99_s"] = float(np.percentile(lat, 99))
            out["mean_ttft_s"] = float(np.mean(ttft))
            out["ttft_p50_s"] = float(np.percentile(ttft, 50))
            out["ttft_p99_s"] = float(np.percentile(ttft, 99))
            out["mean_queue_wait_s"] = float(np.mean(qwait))
            out["queue_wait_p50_s"] = float(np.percentile(qwait, 50))
            out["queue_wait_p99_s"] = float(np.percentile(qwait, 99))
        if self.step_samples:
            out["decode_steps"] = float(len(self.step_samples))
            secs = [s["seconds"] for s in self.step_samples
                    if "seconds" in s]
            if secs:
                out["decode_step_ms_p50"] = 1e3 * float(
                    np.percentile(secs, 50))
        load = self.tick_samples or self.step_samples
        if load:
            occ = [s.get("occupied", s.get("active", 0.0)) for s in load]
            out["mean_slot_occupancy"] = float(np.mean(occ) / self.slots)
            out["peak_concurrent"] = float(max(occ))
            out["mean_concurrent"] = float(np.mean(occ))
            out["mean_queue_depth"] = float(
                np.mean([s["queued"] for s in load]))
        out["preemptions"] = float(self.preemptions)
        if self._alloc is not None:
            blocks = [s["blocks"] for s in self.tick_samples
                      if "blocks" in s]
            if blocks or self._alloc.peak:
                # the allocator's own high-water mark catches growth
                # after a tick's sample (lazy growth runs mid-tick)
                peak = float(max([*blocks, float(self._alloc.peak)]))
                out["blocks_in_use_peak"] = peak
                out["blocks_in_use_mean"] = \
                    float(np.mean(blocks)) if blocks else peak
                out["kv_bytes_in_use_peak"] = \
                    peak * self._alloc.block_nbytes
            out["block_allocs"] = float(
                self._alloc.allocs - self._alloc_base[0])
            out["block_frees"] = float(
                self._alloc.freed - self._alloc_base[1])
        out["prefill_chunks"] = float(self.prefill_chunks)
        if self.records:
            out["prefill_chunk_dispatches_per_request"] = float(
                self.prefill_chunks / len(self.records))
        out["prompt_tokens"] = float(self.prompt_tokens)
        out["prefix_hit_tokens"] = float(self.prefix_hit_tokens)
        out["prefix_hit_rate"] = (
            self.prefix_hit_tokens / self.prompt_tokens
            if self.prompt_tokens else 0.0)
        # spliced prefix rows and swapped-back rows were committed
        # without running the model
        out["prefill_tokens_computed"] = float(
            self.prompt_tokens - self.prefix_hit_tokens
            - self.swap_in_tokens)
        out["blocks_spilled"] = float(self.blocks_spilled)
        out["blocks_swapped_in"] = float(self.blocks_swapped_in)
        out["reprefill_tokens_avoided"] = float(self.swap_in_tokens)
        if self._cache is not None:
            out["evictions"] = float(self._cache.evictions
                                     - self._evict_base)
        spec = [s for s in self.step_samples if "accepted" in s]
        if spec:
            # per-(slot, verify) means (serving.py:2581-2590)
            slot_steps = sum(s["active"] for s in spec)
            out["spec_verify_steps"] = float(len(spec))
            out["spec_mean_accepted_per_step"] = float(
                sum(s["accepted"] for s in spec) / max(slot_steps, 1.0))
            out["spec_mean_tokens_per_step"] = float(
                sum(s["committed"] for s in spec) / max(slot_steps, 1.0))
        return out


class ServingEngine:
    """Continuous-batching scheduler over a :class:`DecodeEngine`
    (``serving.py:2653``), dense (``block_size=None``, the default) or
    paged.

    ``submit()`` validates and enqueues; ``run()`` drives the
    admit -> prefill-chunk + decode-step -> retire loop until the queue
    drains (or ``max_steps`` ticks). The engine runs on ``device``
    (default ``"cuda"``; the model must already live there — nothing is
    moved). ``seed`` seeds every request that does not pin its own.
    ``kv_dtype="int8"`` quantizes the block pools; ``prefix_cache`` (a
    :class:`PrefixCache`) shares prompt prefixes across requests:
    zero-copy on the paged arena (``chunk_tokens`` a multiple of
    ``block_size``), as cached segment copies on the dense arena.
    ``host_tier_blocks`` (paged only) puts a host tier under the pool:
    a preempted request's committed full blocks spill there and are
    copied back at re-admission when they cover at least
    ``swap_min_tokens`` tokens (default one block), and the prefix
    cache's cold nodes demote there. ``spec`` (an
    :class:`~paddle_tpu_torch.inference.speculative.NgramDrafter` or
    ``DraftModelDrafter``) turns the decode half of every tick into a
    draft-and-verify step at fixed ``k = spec.k``, which reserves k rows
    of each slot for the verify's writes. The parameters keep the
    reference's order; its ``telemetry``, ``mesh``, ``quarantine``,
    ``logit_guard``, ``dispatch_retries``, ``dispatch_stall_s``,
    ``engine_failure_threshold``, ``overlap``, ``profile``,
    ``seq_parallel``, ``adaptive`` and ``adapter_pool`` are accepted at
    their defaults only."""

    def __init__(self, model, max_batch_slots: int = 8, max_len: int = 256,
                 top_k: Optional[int] = None, eos_id: Optional[int] = None,
                 prefill_chunk: int = 128, seed: int = 0,
                 clock: Callable[[], float] = time.perf_counter, spec=None,
                 prefix_cache: Optional[PrefixCache] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None, kv_dtype=None,
                 telemetry=None, scheduler=None, mesh=None,
                 quarantine: bool = True, logit_guard: bool = False,
                 dispatch_retries: int = 2,
                 dispatch_stall_s: Optional[float] = None,
                 engine_failure_threshold: int = 3, overlap: bool = True,
                 host_tier_blocks: Optional[int] = None,
                 swap_min_tokens: Optional[int] = None, profile: bool = False,
                 seq_parallel: bool = False, adaptive=None,
                 adapter_pool=None, *, device=None):
        refuse_unported(
            "ServingEngine",
            telemetry=(telemetry, None), mesh=(mesh, None),
            quarantine=(quarantine, True), logit_guard=(logit_guard, False),
            dispatch_retries=(dispatch_retries, 2),
            dispatch_stall_s=(dispatch_stall_s, None),
            engine_failure_threshold=(engine_failure_threshold, 3),
            overlap=(overlap, True),
            profile=(profile, False), seq_parallel=(seq_parallel, False),
            adaptive=(adaptive, None), adapter_pool=(adapter_pool, None))
        dev = resolve_device(device)
        mdev = module_device(model)
        if mdev.type != dev.type:
            raise ValueError(
                f"the model lives on {mdev}, the engine was asked for "
                f"{dev}; build the model on the engine's device")
        self.spec = spec
        kw = dict(top_k=top_k, prefill_chunk=prefill_chunk,
                  block_size=block_size, num_blocks=num_blocks,
                  kv_dtype=kv_dtype, host_tier_blocks=host_tier_blocks)
        if spec is None:
            self.engine = DecodeEngine(model, max_batch_slots, max_len, **kw)
        else:
            # draft-and-verify (serving.py:2806-2822): the decode step
            # becomes a k+1-row verify committing 1..k+1 tokens a slot
            from paddle_tpu_torch.inference.speculative import (
                SpeculativeEngine)

            self.engine = SpeculativeEngine(model, max_batch_slots, max_len,
                                            k=spec.k, **kw)
            spec.begin(self.engine.b, self.engine.max_len)
        self._spec_k = spec.k if spec is not None else 0
        self.paged = self.engine.paged
        self._alloc = self.engine.allocator   # None on the dense arena
        self._host = self.engine.host_tier    # None without a tier
        self.quantized = self.engine.quantized
        # the swap-vs-recompute threshold: a victim's committed full
        # blocks spill only when they cover at least this many tokens
        # (default one block; a sub-block tail always recomputes)
        if swap_min_tokens is not None and self._host is None:
            raise ValueError(
                "swap_min_tokens without host_tier_blocks would be "
                "silently ignored — the swap policy only exists with "
                "a host tier")
        self._swap_min = int(swap_min_tokens) if swap_min_tokens \
            is not None else (self.engine.block_size
                              if self._host is not None else 0)
        self._cache = prefix_cache
        if prefix_cache is not None and \
                prefix_cache.chunk_tokens > self.engine.max_len:
            raise ValueError(
                f"prefix cache chunk {prefix_cache.chunk_tokens} "
                f"exceeds the {self.engine.max_len}-row KV arena")
        if prefix_cache is not None and self.paged:
            # zero-copy sharing: trie nodes hold ref-counted block ids of
            # this pool (validates the chunk/block alignment)
            prefix_cache.bind_block_allocator(self._alloc)
            if self._host is not None:
                # tiered eviction: cold nodes demote to the host tier
                # before they are dropped, and a lookup that reaches one
                # copies it back through these closures
                prefix_cache.bind_host_tier(
                    self._host, spill=self.engine.spill_blocks,
                    promote=self._promote_host_blocks)
        elif prefix_cache is not None and \
                prefix_cache._allocator is not None:
            # a block-bound cache's nodes hold no segments for the dense
            # copy path
            raise ValueError(
                "prefix cache is bound to a paged engine's block pool; "
                "a dense engine needs a fresh (host-segment) cache")
        self.b = self.engine.b
        self.max_len = self.engine.max_len
        # one row of every slot is reserved for a generated token, k for
        # the verify's writes past it
        self._plen_max = self.max_len - max(self._spec_k, 1)
        self.eos_id = eos_id
        self.seed = int(seed)
        self.clock = clock
        self.scheduler = scheduler if scheduler is not None \
            else FifoScheduler()
        self._slots: List[Optional[Request]] = [None] * self.b
        self._free: List[int] = list(range(self.b))[::-1]
        self._next_id = 0
        # host mirrors of the per-slot device state
        self._t = np.zeros((self.b,), np.int32)
        self._toks = np.zeros((self.b, 1), np.int64)
        self._temps = np.ones((self.b,), np.float32)
        self._greedy = np.zeros((self.b,), bool)
        self._topk = np.zeros((self.b,), np.int64)    # 0 = disabled
        self._topp = np.ones((self.b,), np.float32)   # 1.0 = disabled
        self._budget = np.zeros((self.b,), np.int32)
        self._keydata = np.zeros((self.b, 2), np.uint32)
        # chunked-prefill state per slot (None = past prefill)
        self._pf: List[Optional[Dict[str, Any]]] = [None] * self.b
        self._times: Dict[int, Dict[str, float]] = {}
        self._t0: Optional[float] = None
        # paged bookkeeping: mapped-block count per slot (table entries
        # [0, nblocks) are live), admission sequence (preemption victims
        # are newest-first), timing marks parked across a preemption
        self._nblocks = np.zeros((self.b,), np.int32)
        self._seq = np.zeros((self.b,), np.int64)
        self._adm_seq = 0
        self._ptimes: Dict[int, Dict[str, float]] = {}
        # memo of the last blocked admission: (request id, allocator
        # free counter) — retried only once capacity could have grown
        self._adm_blocked: Optional[tuple] = None
        self.metrics = ServingMetrics(self.b, self._cache, self._alloc)

    # -- submission ---------------------------------------------------------
    def submit(self, req: Request) -> Request:
        if req.status != "new":
            raise ValueError(
                f"request already {req.status}; submit a fresh Request "
                "object per generation")
        if req.top_k is not None and int(req.top_k) < 1:
            raise ValueError(f"top_k must be >= 1, got {req.top_k}")
        if req.top_p is not None and not 0.0 < float(req.top_p) <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {req.top_p}")
        try:
            float(req.temperature)
            if req.seed is not None:
                int(req.seed)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"temperature must be a number and seed an int; got "
                f"temperature={req.temperature!r}, seed={req.seed!r}"
            ) from e
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        plen = len(req.prompt)
        if plen < 1 or plen > self._plen_max:
            spec_note = (f" minus the k={self._spec_k} speculation "
                         "headroom" if self._spec_k else "")
            raise ValueError(
                f"prompt length {plen} must be in [1, {self._plen_max}] "
                f"(max_len={self.max_len}{spec_note}) — the slot needs "
                "at least one row for generated tokens")
        if plen + req.max_new_tokens > self._plen_max + 1:
            spec_note = (f" (max_len={self.max_len} minus the "
                         f"k={self._spec_k} speculation verify headroom)"
                         if self._spec_k else f" (max_len={self.max_len})")
            raise ValueError(
                f"prompt_len + max_new_tokens = {plen} + "
                f"{req.max_new_tokens} = {plen + req.max_new_tokens} "
                f"exceeds the {self._plen_max + 1}-token slot budget"
                f"{spec_note}; shorten the prompt or lower "
                "max_new_tokens")
        if self.paged:
            # a request must be able to finish ALONE on the pool, or
            # preempting everyone else could never unblock it; its
            # deepest write is row plen + max_new - 2, plus the k verify
            # rows once a verify dispatches (max_new == 1 retires at
            # prefill commit)
            bs = self.engine.block_size
            deep = plen + req.max_new_tokens - 2
            if req.max_new_tokens > 1:
                deep += self._spec_k
            alone = max(deep, plen - 1) // bs + 1
            if alone > self._alloc.capacity:
                raise ValueError(
                    f"request needs {alone} blocks of {bs} tokens to "
                    f"finish, but the pool only has "
                    f"{self._alloc.capacity} allocatable blocks — it "
                    "could never be scheduled; grow num_blocks or "
                    "shrink the request")
        req.id = self._next_id
        self._next_id += 1
        req.status = "queued"
        self.scheduler.submit(req)
        return req

    def active_count(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    def free_block_count(self) -> Optional[int]:
        """Free paged-pool blocks; None on the dense arena."""
        return self._alloc.free_count() if self.paged else None

    def host_tier_state(self) -> Optional[Dict[str, int]]:
        """The host tier's occupancy (None without a tier)."""
        if self._host is None:
            return None
        return {"capacity": self._host.capacity,
                "free": self._host.free_count(),
                "in_use": self._host.blocks_in_use(),
                "spills": self._host.spills,
                "swap_ins": self._host.swap_ins}

    # -- scheduling ---------------------------------------------------------
    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = self.clock()
        return self.clock() - self._t0

    def _admit(self, req: Request) -> bool:
        """Admit ``req`` into a free slot if the pool can back its
        prompt beyond its cached prefix (the dense arena: a free slot is
        enough); False leaves it queued. A preempted request resumes
        here: with a spill manifest its parked KV is copied back and its
        prefill resumes at the spilled frontier, else it re-prefills
        prompt + committed tokens (riding the prefix cache where
        present)."""
        ids = np.asarray(list(req.prompt) + req.tokens, np.int64)
        plen = int(ids.shape[0])
        nodes, hit, fresh = [], 0, []
        # a manifest covers prompt AND generated tokens, more than any
        # trie prefix could: its request skips the lookup (no phantom
        # hits, no trie refs to undo) and takes a whole fresh grant
        spill = getattr(req, "_spill", None)
        if self._cache is not None and spill is None:
            nodes, hit = self._cache.lookup(ids)
        if self.paged:
            fresh = self._grant_prompt_blocks(req, plen, nodes, hit)
            if fresh is None:
                return False
        slot = self._free.pop()
        self._temps[slot] = max(float(req.temperature), 1e-6)
        self._greedy[slot] = bool(req.greedy)
        self._topk[slot] = int(req.top_k) if req.top_k is not None else 0
        self._topp[slot] = float(req.top_p) if req.top_p is not None \
            else 1.0
        self._budget[slot] = req.max_new_tokens
        # the request's stream: a function of (seed, id) only, so a
        # resumed request replays the draws of its first residency
        self._keydata[slot] = request_keydata(self.seed, req.id, req.seed)
        self._slots[slot] = req
        self._pf[slot] = st = {"ids": ids, "pos": 0, "nodes": nodes,
                               "seq": req.id}
        self._seq[slot] = self._adm_seq
        self._adm_seq += 1
        req.status = "running"
        tm = self._ptimes.pop(req.id, None)
        if tm is not None:
            pa = tm.pop("preempted_at", None)
            if pa is not None:
                w = self._now() - pa
                tm["resume_wait"] = tm.get("resume_wait", 0.0) + w
                if "first_token" not in tm:
                    tm["resume_wait_pre_first"] = \
                        tm.get("resume_wait_pre_first", 0.0) + w
        self._times[req.id] = tm if tm is not None else \
            {"arrival": req.arrival_time, "admitted": self._now()}
        # park the slot's lockstep decode garbage at plen-1, a row the
        # FINAL prefill chunk rewrites before the slot's first decode and
        # one no spliced prefix covers (hit <= plen-1)
        self._t[slot] = plen - 1
        self._toks[slot, 0] = 0
        self.metrics.count_prompt_tokens(plen)
        if self.paged:
            self._seed_slot_storage(slot, st, nodes, fresh)
            if spill is not None:
                self._swap_back(req, slot, st, fresh, spill)
        elif nodes:
            # the dense arena: one slice copy a layer for every cached
            # chunk, far cheaper than the model forwards it replaces
            cc = self._cache.chunk_tokens
            for j, node in enumerate(nodes):
                self.engine.copy_chunk(slot, j * cc, node.kseg, node.vseg)
                st["pos"] = (j + 1) * cc
                self.metrics.count_prefix_hit_tokens(cc)
        return True

    def _grant_prompt_blocks(self, req: Request, plen: int, nodes, hit: int):
        """The fresh blocks behind rows [hit, plen) of an admission: the
        spliced prefix brings its own. None when the pool is short: the
        lookup's trie refs are dropped and the failure is remembered
        against the allocator's free counter. A fault in here drops the
        lookup's trie refs before propagating."""
        try:
            bs = self.engine.block_size
            need = (plen - 1) // bs + 1 - hit // bs
            if self._alloc.free_count() < need and self._cache is not None:
                # trie-held blocks are reclaimable capacity: evict cold
                # unreferenced leaves first
                self._cache.evict_for_blocks(need)
            fresh = self._alloc.alloc(need)
        except BaseException:
            if nodes:
                self._cache.release(nodes)
            raise
        if fresh is None:
            if nodes:
                self._cache.release(nodes)
            # re-trying every tick while nothing freed would only burn
            # host work (and count phantom trie lookups): remember the
            # failure against the free counter
            self._adm_blocked = (req.id, self._alloc.freed)
        return fresh

    def _seed_slot_storage(self, slot: int, st, nodes, fresh):
        """Wire the admitted slot's storage: splice the trie hit's block
        ids into its table (ZERO-COPY: one allocator reference per
        block, no device work — the shared rows are committed the moment
        the table points at them), then place the fresh grant. The
        prefill starts at the hit."""
        nb = 0
        for node in nodes:
            self._alloc.ref(node.blocks)
            self.engine.table[slot, nb:nb + len(node.blocks)] = node.blocks
            nb += len(node.blocks)
            st["pos"] += self._cache.chunk_tokens
            self.metrics.count_prefix_hit_tokens(self._cache.chunk_tokens)
        self.engine.table[slot, nb:nb + len(fresh)] = fresh
        self._nblocks[slot] = nb + len(fresh)

    def _admit_ready(self):
        while self._free:
            req = self.scheduler.next_due(self._now())
            if req is None:
                break
            if self._adm_blocked is not None and \
                    self._adm_blocked == (req.id, self._alloc.freed):
                break   # still blocked: nothing freed since the last try
            self.scheduler.pop(req)
            if not self._admit(req):
                self.scheduler.requeue(req)
                break   # pool short of blocks: the head waits

    def _run_prefill_chunk(self):
        """Advance the oldest-admitted prefilling slot by one chunk; on
        the prompt's final chunk, commit its first token."""
        pf = [i for i in range(self.b) if self._pf[i] is not None]
        if not pf:
            return
        slot = min(pf, key=lambda i: self._pf[i]["seq"])
        st = self._pf[slot]
        plen = len(st["ids"])
        sl = slice(slot, slot + 1)
        st["tok"], st["pos"] = self.engine.prefill_chunk_at(
            st["ids"], slot, st["pos"], plen, self._temps[sl],
            self._greedy[sl], self._keydata[sl], topks=self._topk[sl],
            topps=self._topp[sl])
        self.metrics.count_prefill_chunk()
        if st["pos"] >= plen:
            self._finish_prefill(slot)

    def _finish_prefill(self, slot: int):
        """Prompt committed: hand its new full chunks to the prefix cache
        and release the trie refs held since admission, then read its
        first token (the one host sync of the whole prefill = TTFT) and
        move the slot into the decode cohort."""
        req = self._slots[slot]
        st = self._pf[slot]
        if self._cache is not None:
            cc = self._cache.chunk_tokens
            bpc = cc // self.engine.block_size if self.paged else 0
            ids = st["ids"]
            path, st["nodes"] = list(st["nodes"]), []
            try:
                for j in range(len(path), len(ids) // cc):
                    parent = path[-1] if path else None
                    key = ids[j * cc:(j + 1) * cc]
                    # another request with this prefix may have finished
                    # first: reuse its node instead of capturing a copy
                    # that first-writer-wins would drop
                    node = self._cache.acquire_child(parent, key)
                    if node is None and self.paged:
                        # ZERO-COPY insert: the trie takes references to
                        # the very blocks the slot prefilled into
                        node = self._cache.insert_blocks(
                            parent, key,
                            self.engine.table[slot,
                                              j * bpc:(j + 1) * bpc].tolist())
                    elif node is None:
                        node = self._cache.insert(
                            parent, key,
                            *self.engine.extract_chunk(slot, j * cc, cc))
                    path.append(node)
            finally:
                # held refs drop even if an insert raises: pinned nodes
                # would shrink the evictable budget for good
                self._cache.release(path)
        first = int(st["tok"][0, 0])
        self._pf[slot] = None
        self._adm_blocked = None
        if self.spec is not None:
            # the drafter's admit hook (serving.py:4759-4763)
            self.spec.admit(np.asarray([slot], np.int32),
                            st["ids"][None, :],
                            np.asarray([len(st["ids"])], np.int32))
        self._t[slot] = len(st["ids"])
        self._toks[slot, 0] = first
        # a resumed request streamed its first token in an earlier
        # residency: TTFT is recorded once
        if "first_token" not in self._times[req.id]:
            self._times[req.id]["first_token"] = self._now()
        self._commit_token(slot, first)

    def _commit_token(self, slot: int, token: int):
        req = self._slots[slot]
        req.tokens.append(int(token))
        eos = req.eos_id if req.eos_id is not None else self.eos_id
        done_eos = eos is not None and token == eos
        done = bool(done_eos or len(req.tokens) >= self._budget[slot])
        try:
            if req.on_token is not None:
                req.on_token(req, int(token), done)
        finally:
            # retirement does not depend on the callback surviving
            if done and self._slots[slot] is req:
                self._retire(slot, "eos" if done_eos else "length")

    def _release_held_nodes(self, slot: int):
        """A slot torn down while still prefilling must not leave its
        admission refs pinning trie nodes."""
        st = self._pf[slot]
        if st is not None and st["nodes"]:
            self._cache.release(st["nodes"])
        self._pf[slot] = None

    def _retire(self, slot: int, reason: str):
        req = self._slots[slot]
        req.status = "done"
        req.finish_reason = reason
        self._slots[slot] = None
        self._release_held_nodes(slot)
        self._free.append(slot)
        self._release_blocks(slot)
        if self._host is not None:
            # a request that retires with its swap-back still pending
            # must not leave its parked host blocks behind
            self._release_spill(req)
        self._adm_blocked = None   # retire changes the free capacity
        # park the freed slot at offset 0: its lockstep garbage lands in
        # the scratch block its zeroed table row points at
        self._t[slot] = 0
        tm = self._times.pop(req.id)
        now = self._now()
        self.metrics.record_request(
            req, tm["arrival"], tm["admitted"], tm.get("first_token", now),
            now, resume_wait=tm.get("resume_wait", 0.0),
            resume_wait_pre_first=tm.get("resume_wait_pre_first", 0.0))
        if req.on_finish is not None:
            req.on_finish(req)

    def _release_blocks(self, slot: int):
        """Drop the slot's blocks and point its table row back at the
        scratch sink (nothing to drop on the dense arena)."""
        if not self.paged:
            return
        n = int(self._nblocks[slot])
        if n:
            self._alloc.deref(self.engine.table[slot, :n].tolist())
        self.engine.table[slot, :] = 0
        self._nblocks[slot] = 0

    # -- the host tier: spill and swap-back ---------------------------------
    def _swap_back(self, req: Request, slot: int, st, fresh, spill):
        """Copy a resumed request's parked KV into its fresh blocks (the
        table already maps them) and start its chunk prefill AT the
        spilled frontier (``st["pos"]``): the copy replaces the chunks
        that frontier covers, counted as ``reprefill_tokens_avoided``. A
        copy that raises falls back to a full re-prefill (the host
        blocks dropped, ``pos`` left at 0)."""
        host_blocks = spill["host_blocks"]
        nfull = len(host_blocks)
        try:
            self.engine.restore_blocks(host_blocks, fresh[:nfull])
        except Exception:
            req._spill = None
            self._host.deref(host_blocks)
            return
        req._spill = None
        self._host.deref(host_blocks, restored=True)
        st["pos"] = int(spill["tokens"])
        self.metrics.count_swap_in(nfull, spill["tokens"])

    def _spill_victim(self, slot: int, req: Request) -> bool:
        """Park the victim's committed full blocks in the host tier
        before they recycle, when they cover at least ``swap_min_tokens``
        tokens (a shorter prefix recomputes). A full tier first drops
        the prefix cache's oldest demoted nodes; a spill that raises
        falls back to recompute."""
        self._release_spill(req)
        bs = self.engine.block_size
        nfull = int(self._t[slot]) // bs
        tokens = nfull * bs
        if nfull < 1 or tokens < self._swap_min:
            return False
        blocks = self.engine.table[slot, :nfull].tolist()
        try:
            host = self.engine.spill_blocks(blocks)
            if host is None and self._cache is not None and \
                    self._cache.reclaim_host_blocks(nfull):
                # a live request's work outranks a cold cached prefix
                host = self.engine.spill_blocks(blocks)
        except Exception:
            return False
        if host is None:
            return False
        req._spill = {"host_blocks": host, "tokens": tokens}
        self.metrics.count_spill(nfull)
        return True

    def _release_spill(self, req: Request):
        """Drop a request's parked host blocks if it holds any (a
        request that ends without swapping back)."""
        spill = getattr(req, "_spill", None)
        if spill is None:
            return
        req._spill = None
        self._host.deref(spill["host_blocks"])

    def _promote_host_blocks(self, host_blocks) -> Optional[List[int]]:
        """The prefix cache's promotion closure: grant device blocks for
        a demoted node and copy its parked KV into them. None when the
        pool cannot grant them or the copy raises (the lookup then
        misses there); it never evicts or preempts on its own."""
        dev = self._alloc.alloc(len(host_blocks))
        if dev is None:
            return None
        try:
            self.engine.restore_blocks(host_blocks, dev)
        except Exception:
            self._alloc.deref(dev)
            return None
        return dev

    def _preempt(self, slot: int):
        """Pool exhausted: push this request back to the queue HEAD. With
        a host tier its committed full blocks spill first, and
        re-admission copies them back; else (or below the threshold) its
        blocks recycle now and its committed tokens stay on the Request,
        so re-admission re-prefills prompt + tokens and continues where
        it left off (greedy decoding makes that token-exact; a sampled
        request keeps its private stream)."""
        req = self._slots[slot]
        if self._host is not None and self._pf[slot] is None:
            # before the release below recycles the blocks the copy
            # reads; a victim still prefilling recomputes
            self._spill_victim(slot, req)
        self._release_held_nodes(slot)
        self._release_blocks(slot)
        self._slots[slot] = None
        self._free.append(slot)
        self._t[slot] = 0
        tm = self._times.pop(req.id)
        tm["preempted_at"] = self._now()
        self._ptimes[req.id] = tm
        req.status = "queued"
        self.scheduler.requeue(req)
        self._adm_blocked = None
        self.metrics.record_preemption()

    def _select_victim(self) -> Optional[int]:
        cands = [(i, r, int(self._seq[i]))
                 for i, r in enumerate(self._slots) if r is not None]
        if not cands:
            return None
        return self.scheduler.select_victim(cands, self._now())

    def _ensure_decode_blocks(self, span: int):
        """Lazy block growth before a decode or verify step: every live
        slot needs storage behind rows ``[t, t + span)``, the rows this
        tick writes (rows past the arena are dropped). Oldest slots
        are served first; when the pool is dry the newest-admitted
        request is preempted (repeatedly if needed), after the prefix
        cache's cold leaves — submit()'s alone-fit check guarantees this
        converges."""
        bs = self.engine.block_size
        order = sorted((i for i, r in enumerate(self._slots)
                        if r is not None and self._pf[i] is None),
                       key=lambda i: self._seq[i])
        for slot in order:
            while self._slots[slot] is not None:
                target = min(int(self._t[slot]) + span - 1,
                             self.max_len - 1) // bs + 1
                need = target - int(self._nblocks[slot])
                if need <= 0:
                    break
                if self._alloc.free_count() < need and \
                        self._cache is not None:
                    self._cache.evict_for_blocks(need)
                got = self._alloc.alloc(need)
                if got is None:
                    self._preempt(self._select_victim())
                    continue    # the needy slot itself may be gone now
                n0 = int(self._nblocks[slot])
                self.engine.table[slot, n0:n0 + need] = got
                self._nblocks[slot] += need

    def step_decode(self):
        """One tick: one prefill chunk (oldest-admitted prefilling slot)
        plus one lockstep decode step committing a token to every live
        slot past prefill. A slot whose prompt completed this very tick
        joins the decode half immediately."""
        self.scheduler.on_tick(self._now())
        occupied = self.active_count()
        if occupied:
            self.metrics.record_tick(
                occupied, self.scheduler.due_count(self._now()),
                blocks=self._alloc.blocks_in_use() if self.paged else None)
        self._run_prefill_chunk()
        if self.paged:
            self._ensure_decode_blocks(self._spec_k + 1)
        live = [i for i, r in enumerate(self._slots)
                if r is not None and self._pf[i] is None]
        if not live:
            return
        if self.spec is not None:
            return self._step_speculative(live)
        t0 = time.perf_counter()
        tok = self.engine.step(self._toks, self._t, self._temps,
                               self._greedy, self._keydata,
                               topks=self._topk, topps=self._topp)
        # overlapped tick: the next tick's admissions run while the card
        # computes this step (slots retire at commit, after this pass,
        # so WHICH requests admit is unchanged — only when)
        self._admit_ready()
        toks = tok.cpu().numpy()
        self.metrics.record_step(len(live),
                                 self.scheduler.due_count(self._now()),
                                 seconds=time.perf_counter() - t0)
        for slot in live:
            self._t[slot] += 1
            self._toks[slot, 0] = int(toks[slot, 0])
            self._commit_token(slot, int(toks[slot, 0]))

    def _step_speculative(self, live):
        """One draft-and-verify tick (``serving.py:6234-6350`` without
        constraints, quarantine or telemetry): drafts from the slots'
        contexts, one verify over all slots, the next tick's admissions
        while the card computes, one read of ``out`` and ``accept``,
        then every live slot commits between 1 and ``accept_cap + 1``
        tokens — a host decision, never a shape."""
        ctxs: List[Optional[List[int]]] = [None] * self.b
        for i in live:
            r = self._slots[i]
            ctxs[i] = list(r.prompt) + r.tokens
        drafts = self.spec.propose(ctxs, self._toks[:, 0], self._t)
        t0 = time.perf_counter()
        out, acc = self.engine.verify(
            self._toks, drafts, self._t, self._temps, self._greedy,
            self._keydata, topks=self._topk, topps=self._topp)
        self._admit_ready()
        # one host read of both
        res = torch.cat([out, acc[:, None].to(out.dtype)], dim=1).cpu()
        out, acc = res[:, :-1].numpy(), res[:, -1].numpy()
        seconds = time.perf_counter() - t0
        backlog = self.scheduler.due_count(self._now())
        cap = min(self.spec.accept_cap, self._spec_k)
        accepted_total = committed_total = 0
        for slot in live:
            req = self._slots[slot]
            # never outrun the admitted budget; accepted counts what the
            # verify accepted (clamped by the drafter's cap only),
            # committed what was delivered
            remaining = int(self._budget[slot]) - len(req.tokens)
            va = min(int(acc[slot]), cap)
            a = min(va, remaining - 1)
            accepted_total += va
            # offset and pending token advance with each append
            for j in range(a + 1):
                self._t[slot] += 1
                self._toks[slot, 0] = int(out[slot, j])
                self._commit_token(slot, int(out[slot, j]))
                committed_total += 1
                if self._slots[slot] is None:
                    break   # EOS inside the accepted prefix: drop the rest
        self.metrics.record_step(len(live), backlog, accepted_total,
                                 committed_total, seconds=seconds)

    def _idle_wait(self, wait: float):
        """Sleep toward the next arrival; an injected clock that does not
        advance fails loudly instead of spinning forever."""
        before = self.clock()
        time.sleep(min(wait, 0.05))
        if self.clock() <= before:
            raise RuntimeError(
                "ServingEngine clock did not advance during an idle "
                "wait — when injecting a simulated clock, override "
                "_idle_wait() to advance it (or submit requests with "
                "arrival_time already due)")

    def _tick_once(self) -> str:
        self._admit_ready()
        if not self.active_count():
            if not self.scheduler.depth():
                return "done"
            now = self._now()
            nxt = self.scheduler.next_arrival(now)
            wait = (nxt - now) if nxt is not None else 0.0
            if wait > 0:
                self._idle_wait(wait)
                return "idle"
            # a stale shortage memo must never turn into a stall
            self._adm_blocked = None
            self._admit_ready()
            if self.active_count() or \
                    self.scheduler.next_due(self._now()) is None:
                return "idle"
            raise RuntimeError(
                "admission stalled with an idle engine: the head request "
                "is due but cannot be admitted — the block pool cannot "
                "satisfy it even when empty")
        self.step_decode()
        return "stepped"

    def run(self, max_steps: Optional[int] = None,
            keep_epoch: bool = False) -> ServingMetrics:
        """Drive the loop until queue and slots drain (or ``max_steps``
        ticks). A call that starts from an idle engine opens a fresh
        metrics window and clock anchor for ``arrival_time``.
        ``keep_epoch`` is accepted at its default only."""
        refuse_unported("ServingEngine.run", keep_epoch=(keep_epoch, False))
        if not self.active_count():
            self._t0 = self.clock()
            self.metrics = ServingMetrics(self.b, self._cache, self._alloc)
            self._ptimes.clear()
        self._now()
        steps = 0
        while self.scheduler.depth() or self.active_count():
            outcome = self._tick_once()
            if outcome == "done":
                break
            if outcome == "stepped":
                steps += 1
                if max_steps is not None and steps >= max_steps:
                    break
        return self.metrics
