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

Telemetry and resilience (``ServingEngine``'s docstring): an
always-on :class:`~paddle_tpu_torch.observability.Telemetry` bundle,
the program registry (``inference/program_set.py``) with its dispatch
retries, stall watchdog and ledger, request-scoped fault quarantine,
the NaN/inf logit guard, the engine-scoped circuit breaker,
``audit()``, and the tick profiler.

Multi-LoRA serving (``adapter_pool=``), constrained decoding
(``Request.response_format``) and the ``score`` and ``embed`` request
kinds ride the same programs as runtime arguments: per-slot adapter ids
into the stacked pools, packed vocab bitmasks folded in the sampler,
and the chunk program's target logprobs and final hidden state.

Out of the port so far (each queued in ROADMAP.md): meshes and
replicas, and the adaptive controllers (``adaptive=``).
"""

from __future__ import annotations

import contextlib
import sys
import threading
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
from paddle_tpu_torch.inference.program_set import ProgramSet, _weak_program
from paddle_tpu_torch.observability import Telemetry
from paddle_tpu_torch.observability.metrics import (DEFAULT_SIZE_BUCKETS,
                                                    DEFAULT_TIME_BUCKETS,
                                                    MetricsRegistry)
from paddle_tpu_torch.observability.profile import PHASE_BUCKETS
from paddle_tpu_torch.observability.sentinel import describe_args
from paddle_tpu_torch.testing.fault_injection import fault_point

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


class _MaskMirror:
    """Packed vocab-mask rows, one block a slot, on the host and on the
    device (``serving.py:1289-1330``). A write dirties the device copy
    and the next :meth:`arg` re-sends the whole mirror, a blocking copy
    from pageable memory, so a later host write cannot race it. -1 per
    lane is the identity."""

    def __init__(self, shape, device):
        self.host = np.full(shape, -1, np.int32)
        self.device = device
        self._dev: Optional[torch.Tensor] = None
        self._any = False
        self._dirty = True

    def set(self, slot: int, rows) -> None:
        self.host[int(slot)] = rows
        self._dirty = True

    def reset(self, slot: int) -> None:
        """Back to the identity; the device copy stays clean when the
        slot already is."""
        block = self.host[int(slot)]
        if (block != -1).any():
            block.fill(-1)
            self._dirty = True

    def arg(self):
        """``(device tensor, fold)``: ``fold`` is whether any row is not
        the identity (folding identity rows changes nothing, so the
        programs skip it)."""
        if self._dev is None or self._dirty:
            self._dev = torch.from_numpy(self.host.copy()).to(self.device)
            self._any = bool((self.host != -1).any())
            self._dirty = False
        return self._dev, self._any


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
    pinned on the card.

    The engine's programs (``chunk_prefill``, ``decode_step``, on the
    dense arena the prefix cache's ``chunk_copy``/``chunk_extract``)
    dispatch through a :class:`~paddle_tpu_torch.inference.program_set.
    ProgramSet` (``self.programs``): the ``serving:dispatch`` fault
    point, bounded retries, the stall watchdog, the dispatch ledger and
    the recompile ``sentinel`` live there. ``logit_guard=True`` adds a
    per-slot finite check over the sampled logits of the step, the
    verify and every prefill chunk, on the device
    (``torch.isfinite(logits).all(-1)``); a row that fails samples from
    zeros instead (a valid draw the caller discards), and the mask
    lands in ``last_step_finite`` / ``last_prefill_finite`` as a
    device tensor the caller reads with the tokens.

    ``adapter_pool`` (an :class:`~paddle_tpu_torch.inference.
    adapter_pool.AdapterPool`) adds multi-LoRA serving: every program
    takes the pool's resident device tensors and the per-slot adapter
    ids (host mirror ``adapter_ids``, 0 = the identity row) as runtime
    arguments (``serving.py:477-498``). The vocab bitmasks of
    constrained decoding (``serving.py:499-520``) ride every sampling
    program the same way: a packed ``(b, ceil(V/32))`` int32 row a slot
    (host mirror ``vocab_masks``, -1 per lane = no constraint), cached
    on the device behind a dirty flag and folded ``mask ? logit :
    -inf`` before temperature and every filter. The chunk program also
    returns the chunk's per-position target logprobs
    (``last_prefill_scores``, score requests) and, when the model takes
    ``output_hidden``, the last real row's final hidden state
    (``last_prefill_hidden``). The reference's ``ids_dtype``, ``mesh``
    and ``seq_parallel`` are accepted at their defaults only."""

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
            seq_parallel=(seq_parallel, False))
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
        # the NaN/inf logit guard: per-slot finite masks of the last
        # step/verify (b,) and the last prefill chunk (1,), device tensors
        self.logit_guard = bool(logit_guard)
        self.last_step_finite: Optional[torch.Tensor] = None
        self.last_prefill_finite: Optional[torch.Tensor] = None
        # the last chunk's (1, C) target logprobs and (1, H) final hidden
        # state at its last real row, device tensors
        self.last_prefill_scores: Optional[torch.Tensor] = None
        self.last_prefill_hidden: Optional[torch.Tensor] = None
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
        self._init_adapters(adapter_pool)
        self._init_masks(model)
        # the embedding surface: a static property of the model, never
        # of the traffic mix
        self.supports_hidden = False
        try:
            import inspect
            self.supports_hidden = "output_hidden" in \
                inspect.signature(model.forward).parameters
        except (TypeError, ValueError):
            pass
        # the program registry: dispatch, retries, the watchdog, the
        # ledger and the sentinel's signatures in one home
        self.programs = ProgramSet(mesh)
        self.programs.register("decode_step",
                               _weak_program(self._step_program))
        self.programs.register("chunk_prefill",
                               _weak_program(self._chunk_program))

    @property
    def sentinel(self):
        """Optional :class:`~paddle_tpu_torch.observability.sentinel.
        RecompileSentinel`, stored ON the program registry so the
        sentinel and :meth:`executable_count` watch the same
        programs."""
        return self.programs.sentinel

    @sentinel.setter
    def sentinel(self, s):
        self.programs.sentinel = s

    def executable_count(self) -> Optional[int]:
        """Distinct ``(program, argument signature)`` pairs dispatched
        so far (``serving.py:1767``): 2 for a plain serving engine, the
        padded chunk and the lockstep step."""
        return self.programs.executable_count()

    def _init_adapters(self, adapter_pool):
        """The multi-LoRA pool (``serving.py:477-498``): the pool's
        device tensors and the per-slot id vector are runtime arguments
        of every program, so no adapter mix changes a signature."""
        self.adapter_pool = adapter_pool
        self.adapter_ids: Optional[np.ndarray] = None
        # the ids' device copy and the host values it was made from
        self._aids_dev: Optional[torch.Tensor] = None
        self._aids_sent: Optional[np.ndarray] = None
        if adapter_pool is None:
            return
        if int(adapter_pool.L) != self.L:
            raise ValueError(
                f"adapter pool is stacked for {adapter_pool.L} layers, "
                f"model has {self.L}")
        self.adapter_ids = np.zeros((self.b,), np.int32)
        adapter_pool.bind(self)

    def _init_masks(self, model):
        """The runtime vocab bitmasks (``serving.py:499-520``): one
        packed int32 row of ``ceil(V/32)`` lanes a slot (bit ``t % 32``
        of lane ``t // 32`` set = token t legal), -1 per lane = the
        identity. Models without a ``config.vocab_size`` get none."""
        cfg = getattr(model, "config", None)
        self.vocab_size = int(getattr(cfg, "vocab_size", 0)) or None
        self.mask_lanes = 0
        self._masks: Optional[_MaskMirror] = None
        self.vocab_masks: Optional[np.ndarray] = None   # its host rows
        self._mask_unpack: Optional[tuple] = None
        if self.vocab_size is not None:
            self.mask_lanes = (self.vocab_size + 31) // 32
            self._masks = _MaskMirror((self.b, self.mask_lanes),
                                      self.device)
            self.vocab_masks = self._masks.host

    def _adapter_args(self):
        """The ``(adapters, ids)`` runtime-argument pair of a dispatch
        (``serving.py:650-660``): the pool's resident device tensors and
        the (b,) int32 id vector on the device, re-sent only when the
        host mirror changed — (None, None) without a pool."""
        if self.adapter_pool is None:
            return None, None
        if self._aids_dev is None or \
                not np.array_equal(self._aids_sent, self.adapter_ids):
            self._aids_sent = self.adapter_ids.copy()
            self._aids_dev = torch.from_numpy(self._aids_sent).to(
                self.device)
        return self.adapter_pool.device_arrays(), self._aids_dev

    @staticmethod
    def _forward_adapters(adapters, aids):
        """The model's ``adapters=`` keyword from a program's pair; none
        without a pool, so a pool-less engine calls the model as
        before."""
        return {} if adapters is None else \
            {"adapters": dict(adapters, ids=aids)}

    # -- vocab bitmask plumbing (serving.py:1289-1330) ----------------------
    def set_mask_row(self, slot: int, row) -> None:
        """Write one slot's packed vocab-mask row into the host mirror
        and invalidate the device copy (constrained slots only: a run
        without constraints never dirties it)."""
        self._masks.set(slot, row)

    def reset_mask_row(self, slot: int) -> None:
        """Back to the identity row at retirement; a no-op that leaves
        the device copy clean when the row already is the identity."""
        if self._masks is not None:
            self._masks.reset(slot)

    def _masks_arg(self):
        """The step's ``(masks, fold)`` pair: (None, False) when the
        model declares no vocab size."""
        return (None, False) if self._masks is None else self._masks.arg()

    def decode_masks(self):
        """The (b, ceil(V/32)) mask argument of the step and verify, a
        device copy cached behind the dirty flag; None when the model
        declares no vocab size."""
        return self._masks_arg()[0]

    def mask_row_arg(self, slot: int):
        """One slot's (1, ceil(V/32)) mask row for the chunk program: a
        view of the cached device copy."""
        masks = self.decode_masks()
        return None if masks is None else masks[int(slot):int(slot) + 1]

    def _fold_masks(self, last, masks):
        """``mask ? logit : -inf`` over the last axis (``serving.py:
        843-870``): ``masks`` (..., ceil(V/32)) int32 broadcasts over the
        logits' leading axes. ``& 1`` keeps the arithmetic shift of a
        negative lane to one bit."""
        V = last.shape[-1]
        if self._mask_unpack is None or \
                self._mask_unpack[0].device != last.device:
            idx = torch.arange(V, device=last.device)
            self._mask_unpack = (idx // 32, (idx % 32).to(torch.int32))
        lane, shift = self._mask_unpack
        bit = (masks.index_select(-1, lane) >> shift) & 1
        return last.masked_fill(bit == 0, float("-inf"))

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

    @staticmethod
    def _sampling_vectors(n: int, topks, topps):
        """The per-slot runtime filters as host arrays (``serving.py:874``):
        None disables them for every row (top-k 0, top-p 1.0), so every
        dispatch carries the same argument signature."""
        topks = np.zeros((n,), np.int64) if topks is None \
            else np.asarray(topks, np.int64)
        topps = np.ones((n,), np.float32) if topps is None \
            else np.asarray(topps, np.float32)
        return topks, topps

    @staticmethod
    def _guard(logits, dims):
        """The logit guard: ``ok`` True where every logit of a row over
        ``dims`` is finite; failing rows become zeros, a valid
        distribution whose draw the caller discards."""
        ok = torch.isfinite(logits).flatten(1).all(-1) if dims > 1 \
            else torch.isfinite(logits).all(-1)
        shape = (-1,) + (1,) * (logits.dim() - 1)
        return ok, torch.where(ok.reshape(shape), logits,
                               torch.zeros_like(logits))

    def _sampler_args(self, temps, greedy, topks, topps):
        """The sampler's host vectors as device tensors. Built BEFORE the
        forward: a host-to-device copy after it would wait for the whole
        forward to finish. ``topks``/``topps`` are host arrays, as
        :meth:`_sampling_vectors` gives them."""
        greedy = np.asarray(greedy)
        topks, topps = np.asarray(topks), np.asarray(topps)
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
        """The target distribution's logits: the vocab masks
        (``a["masks"]``, None = unconstrained), temperature, the static
        ``top_k`` and the per-slot runtime top-k/top-p, in the
        reference's order, over ``(b, V)`` or ``(b, s, V)`` logits
        (per-slot vectors broadcast over s; ``(b, s, lanes)`` masks per
        position)."""
        if a.get("masks") is not None:
            last = self._fold_masks(last, a["masks"])
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
        only for the prompt's final chunk. ``targets_row`` (score
        requests) is the full per-position target-id row scored
        alongside: position p's logprob of ``targets_row[p]`` lands in
        ``last_prefill_scores``."""
        chunk, n = self.chunk_slice(ids_row, pos, plen)
        targets = None
        if targets_row is not None:
            targets, _ = self.chunk_slice(targets_row, pos, plen)
        tok = self.run_prefill_chunk(chunk, slot, pos, n - 1, temps,
                                     greedy, keydata, topks=topks,
                                     topps=topps, targets=targets)
        return tok, pos + n

    def chunk_slice(self, ids_row, pos: int, plen: int):
        """The zero-padded (1, C) chunk of ``ids_row`` covering ``[pos,
        min(pos+C, plen))`` and its real-token count (``serving.py:
        1336``): the one home of the chunk slice and pad arithmetic."""
        C = self.prefill_chunk
        n = min(C, int(plen) - int(pos))
        chunk = np.zeros((1, C), np.int64)
        chunk[0, :n] = np.asarray(ids_row[pos:pos + n])
        return chunk, n

    def run_prefill_chunk(self, ids_chunk, slot: int, start: int,
                          last_idx: int, temps, greedy, keydata,
                          topks=None, topps=None, targets=None):
        """ONE ``(1, prefill_chunk)`` chunk for ``slot`` at pool offset
        ``start`` (a 0-dim offset: the model routes it to K5); samples
        the token of position ``start + last_idx + 1`` at ``last_idx``
        from ``keydata`` ((1, 2) uint32). The pad tail of a short final
        chunk computes discarded rows whose K/V past the table's reach
        is dropped. With the logit guard, ``last_prefill_finite`` holds
        the chunk's (1,) finite mask. ``targets`` is the (1, C)
        target-id chunk of a score request: its per-position logprobs
        (``logit[target] - logsumexp(logits)``) land in
        ``last_prefill_scores``; without it the scores are not computed.
        The slot's adapter and mask row ride the chunk."""
        self._ensure_buffers()
        topks, topps = self._sampling_vectors(1, topks, topps)
        ids_chunk = ids_chunk if isinstance(ids_chunk, torch.Tensor) \
            else np.asarray(ids_chunk, np.int64)
        temps = np.asarray(temps, np.float32)
        greedy = np.asarray(greedy, bool)
        keydata = np.asarray(keydata, np.uint32)
        score = targets is not None
        tgt = np.asarray(targets, np.int64) if score \
            else np.zeros((1, int(ids_chunk.shape[-1])), np.int64)
        masks = self.mask_row_arg(slot)
        constrained = masks is not None and \
            bool((self.vocab_masks[int(slot)] != -1).any())
        adapters, aid_vec = self._adapter_args()
        aids = None if aid_vec is None else aid_vec[int(slot):int(slot) + 1]
        (tok, self.last_prefill_finite, self.last_prefill_scores,
         self.last_prefill_hidden) = self.programs.call(
            "chunk_prefill", ids_chunk, int(slot), int(start),
            int(last_idx), temps, greedy, keydata, topks, topps,
            masks, constrained, tgt, score, adapters, aids,
            describe=lambda: describe_args(
                ids_chunk=ids_chunk, slot=slot, start=start,
                last_idx=last_idx, temps=temps, greedy=greedy,
                keydata=keydata, topks=topks, topps=topps, masks=masks,
                targets=tgt, aids=aids))
        return tok

    def _chunk_program(self, ids_chunk, slot: int, start: int,
                       last_idx: int, temps, greedy, keydata, topks,
                       topps, masks, fold: bool, targets, score: bool,
                       adapters, aids):
        """The chunk-prefill program (``_build_chunk_prefill``): the
        forward and the sampler, ``(tok (1, 1), finite (1,) or None,
        scores (1, C) or None, hidden (1, H) or None)`` on the
        device."""
        ids = self._vec(ids_chunk, torch.int64)
        table = self._table(slice(slot, slot + 1))
        t = torch.tensor(int(start), dtype=torch.int32, device=self.device)
        args = self._sampler_args(temps, greedy, topks, topps)
        args["uniforms"] = self._uniforms(
            args, keydata, [int(start) + int(last_idx) + 1], LANE_DRAW)
        # folding an all-identity row would change nothing: skipped
        args["masks"] = masks if fold else None
        tgt = self._vec(targets, torch.int64) if score else None
        ok = scores = hidden = None
        with self._eval_mode():
            # last_idx + 1 real rows: the pad tail of a short final
            # chunk never shapes a block scale
            out = self.model(
                ids, caches=self._caches(table, t, int(last_idx) + 1,
                                         slot=int(slot)),
                **self._forward_adapters(adapters, aids),
                **({"output_hidden": True} if self.supports_hidden
                   else {}))
            logits = out[0]
            if self.supports_hidden:
                # the final hidden state at the chunk's last real row
                hidden = out[1][:, int(last_idx)].float()
            if score:
                # per-position target logprobs: the one-reduction gather,
                # never a (C, V) log-softmax held whole
                lg32 = logits.float()
                picked = torch.gather(lg32, -1, tgt[..., None])[..., 0]
                scores = picked - torch.logsumexp(lg32, dim=-1)
            last = logits[:, int(last_idx)].float()
            if self.logit_guard:
                # the guard covers the FIRST token too: a chunk over a
                # poisoned shared prefix must not stream a garbage token
                ok, last = self._guard(last, 1)
            tok = self._sample_dev(last, args)
        return tok[:, None], ok, scores, hidden

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
        topks, topps = self._sampling_vectors(nb, topks, topps)
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
        compute garbage the caller discards. With the logit guard,
        ``last_step_finite`` holds the (b,) finite mask.

        ``defer=True`` returns ``(tok, finalize)``: the serving tick
        runs its next round's admission while the card computes and
        calls ``finalize()`` (the armed watchdog's sync point; a no-op
        when unarmed) right before it reads the tokens."""
        self._ensure_buffers()
        topks, topps = self._sampling_vectors(self.b, topks, topps)
        t = np.asarray(t, np.int32)
        temps = np.asarray(temps, np.float32)
        greedy = np.asarray(greedy, bool)
        keydata = np.asarray(keydata, np.uint32)
        masks, fold = self._masks_arg()
        adapters, aids = self._adapter_args()
        out = self.programs.call(
            "decode_step", toks, t, temps, greedy, keydata, topks, topps,
            masks, fold, adapters, aids,
            describe=lambda: describe_args(
                toks=toks, t=t, temps=temps, greedy=greedy,
                keydata=keydata, topks=topks, topps=topps, masks=masks,
                aids=aids),
            defer=defer)
        fin = None
        if defer:
            out, fin = out
        tok, self.last_step_finite = out
        return (tok, fin) if defer else tok

    def _step_program(self, toks, t, temps, greedy, keydata, topks, topps,
                      masks, fold: bool, adapters, aids):
        """The decode-step program (``_build_step``): the forward over
        every slot and the sampler, ``(tok (b, 1), finite (b,) or
        None)`` on the device."""
        ids = self._vec(toks, torch.int64)
        table = self._table()
        tv = self._vec(t, torch.int32)
        args = self._sampler_args(temps, greedy, topks, topps)
        args["uniforms"] = self._uniforms(
            args, keydata, np.asarray(t, np.int64) + 1, LANE_DRAW)
        args["masks"] = masks if fold else None
        ok = None
        with self._eval_mode():
            logits, _ = self.model(
                ids, caches=self._caches(table, tv, ids.shape[1]),
                **self._forward_adapters(adapters, aids))
            last = logits[:, -1].float()
            if self.logit_guard:
                # NaN never reaches the argmax or the draw of ANY slot
                ok, last = self._guard(last, 1)
            tok = self._sample_dev(last, args)
        return tok[:, None], ok

    def poison_slot_kv(self, slot: int, table_row=None):
        """Chaos/testing utility (``serving.py:1854``): corrupt ONE slot's
        committed KV storage with NaN — its dense row, or every pool
        block its table row (or ``table_row``) maps; int8 pools poison
        their fp32 SCALE rows instead (int8 codes hold no NaN). The
        slot's next logits go non-finite through the real kernels while
        every other slot's storage is untouched. Shared (trie-spliced)
        blocks are poisoned too, as real corruption would be."""
        self._ensure_buffers()
        nan = float("nan")
        if not self.paged:
            for i in range(self.L):
                self.kbufs[i][int(slot)] = nan
                self.vbufs[i][int(slot)] = nan
            return
        row = np.asarray(self.table[slot] if table_row is None
                         else table_row)
        blocks = [int(b) for b in np.unique(row) if b != 0]
        if not blocks:
            return
        idx = torch.as_tensor(blocks, dtype=torch.int64, device=self.device)
        for i in range(self.L):
            if self.quantized:
                self.kscales[i][idx] = nan
                self.vscales[i][idx] = nan
            else:
                self.kbufs[i][idx] = nan
                self.vbufs[i][idx] = nan

    def scrub_slot_kv(self, slot: Optional[int] = None,
                      blocks: Optional[Sequence[int]] = None,
                      replica: int = 0):
        """Zero poisoned KV storage after a non-finite quarantine
        (``serving.py:1895``): the dense ``slot`` row, or the pool
        ``blocks`` with their int8 scale rows. Masks bound which rows a
        query attends, but NaN survives an additive mask, so a NaN row
        in reachable storage would poison the next occupant's softmax:
        it must be cleared. ``replica`` must name the one plane (0)."""
        refuse_unported("scrub_slot_kv", replica=(replica, 0))
        if self.kbufs is None:
            return
        idx = None
        if blocks:
            idx = torch.as_tensor([int(b) for b in blocks],
                                  dtype=torch.int64, device=self.device)
        for i in range(self.L):
            if slot is not None and not self.paged:
                self.kbufs[i][int(slot)] = 0
                self.vbufs[i][int(slot)] = 0
            if idx is not None:
                self.kbufs[i][idx] = 0
                self.vbufs[i][idx] = 0
                if self.quantized:
                    self.kscales[i][idx] = 0.0
                    self.vscales[i][idx] = 0.0

    # -- the dense arena's prefix cache: chunk copy and extract -------------
    def copy_chunk(self, slot: int, start: int, kseg, vseg):
        """Seed arena rows ``[start, start + chunk)`` of ``slot`` from a
        cached ``(L, chunk, H, D)`` segment pair (``_build_copy``,
        ``serving.py:1210``): one slice write a layer, dispatched as
        the ``chunk_copy[chunk]`` program."""
        if self.paged:
            raise RuntimeError(
                "chunk-copy is a dense-arena program; the paged engine "
                "shares cached prefixes by block-table splice instead")
        cc = int(kseg.shape[1])
        name = f"chunk_copy[{cc}]"
        if not self.programs.defined(name):
            self.programs.register(name, _weak_program(self._copy_program))
        self._ensure_buffers()
        self.programs.call(
            name, kseg, vseg, int(slot), int(start),
            describe=lambda: describe_args(kseg=kseg, vseg=vseg,
                                           slot=slot, start=start))

    def _copy_program(self, kseg, vseg, slot: int, start: int):
        cc = int(kseg.shape[1])
        for i in range(self.L):
            self.kbufs[i][slot, start:start + cc].copy_(kseg[i])
            self.vbufs[i][slot, start:start + cc].copy_(vseg[i])

    def extract_chunk(self, slot: int, start: int, chunk_tokens: int):
        """Arena rows ``[start, start + chunk_tokens)`` of ``slot`` as a
        new ``(L, chunk, H, D)`` segment pair (``_build_extract``,
        ``serving.py:1235``), on the arena's device, dispatched as the
        ``chunk_extract[chunk]`` program."""
        if self.paged:
            raise RuntimeError(
                "chunk-extract is a dense-arena program; the paged "
                "engine captures a prefix by taking block references "
                "instead")
        cc = int(chunk_tokens)
        name = f"chunk_extract[{cc}]"
        if not self.programs.defined(name):
            self.programs.register(name, _weak_program(self._extract))
        self._ensure_buffers()
        return self.programs.call(
            name, int(slot), int(start), cc,
            describe=lambda: describe_args(slot=slot, start=start))

    def _extract(self, slot: int, start: int, cc: int):
        rows = slice(start, start + cc)
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
        # the chaos point fires before any device write, so a faulted
        # swap-back leaves the pool untouched for the re-prefill
        fault_point("serving:swap_in", n=len(host_blocks))
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
    first token). ``finish_reason`` after completion: ``"eos"``,
    ``"length"``, or ``"error"`` for a request the engine quarantined.
    ``arrival_time`` is an offset in seconds from the start of
    :meth:`ServingEngine.run` (0 = already queued). ``seed`` pins the
    request's sample stream (its ``keydata``); unset, the stream derives
    from the engine seed and the request id. ``top_k``/``top_p`` are
    per-request filters; ``sampling`` takes a
    :class:`~paddle_tpu_torch.inference.frontend.sampling.SamplingParams`
    bundle that overrides the individual fields at
    :meth:`ServingEngine.submit`.

    ``adapter`` names a LoRA adapter registered in the engine's
    :class:`~paddle_tpu_torch.inference.adapter_pool.AdapterPool`
    (None = the base model). ``kind`` is ``"generate"``, ``"score"``
    (the prompt's teacher-forced next-token logprobs land in
    ``logprobs``: ``logprobs[p]`` scores ``prompt[p+1]``) or
    ``"embed"`` (the final prompt position's hidden state lands in
    ``embedding``); both retire ``"complete"`` at prefill completion.
    ``response_format`` constrains decoding: a
    :class:`~paddle_tpu_torch.inference.constrain.GrammarConstraint` or
    the wire dict :func:`~paddle_tpu_torch.inference.constrain.
    from_response_format` takes; a grammar with no legal continuation
    retires ``"constraint_dead_end"``.

    ``tenant``/``priority`` feed the pluggable scheduler (priority
    overrides the tenant's tier when set; lower = more urgent).
    ``deadline`` is an ABSOLUTE offset on the run clock (the domain of
    ``arrival_time``); past it the request retires
    ``"deadline_exceeded"``, queued or running. ``on_finish`` fires
    exactly once at retirement, cancellations and expiries included
    (they deliver no final ``on_token``). The fields keep the
    reference's order."""

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
    cancel_requested: bool = field(default=False, init=False)
    # the spill manifest of a request parked in the host tier (host
    # block ids + covered token count), and the key data a RESTORED
    # request continues from (the snapshot carried it: the restoring
    # engine's seed must never enter its stream)
    _spill: Optional[Dict[str, Any]] = field(default=None, init=False,
                                             repr=False)
    _keydata: Optional[Any] = field(default=None, init=False, repr=False)
    # the adapter-pool slot acquired at submit (0 = no adapter)
    _adapter_sid: int = field(default=0, init=False, repr=False)
    # score/embed results: logprobs[p] = log P(prompt[p+1] |
    # prompt[:p+1]) for p in [0, plen-2]; the final prompt position's
    # hidden state
    logprobs: Optional[List[float]] = field(default=None, init=False)
    embedding: Optional[Any] = field(default=None, init=False)
    # the grammar compiled at submit; each residency walks a fresh
    # cursor over it
    _constraint: Optional[Any] = field(default=None, init=False,
                                       repr=False)


class ServingMetrics:
    """Per-request records and per-tick samples of one ``run()`` window;
    :meth:`aggregate` folds them into the reference's headline keys
    (``serving.py:2475``), with the prefix cache's counted economics
    (``prefix_hit_tokens``, ``prefix_hit_rate``, ``evictions``) when
    ``cache`` is given, the host tier's (``blocks_spilled``,
    ``blocks_swapped_in``, ``reprefill_tokens_avoided``), the overlap
    window's (``overlap_ticks``, ``overlap_fraction``) and the
    speculative ones (``spec_*``) after verify steps.

    A window ALSO streams into an observability ``MetricsRegistry``
    (``registry=``; a private one when not given) under the reference's
    family names: per-request TTFT/TPOT/queue-wait/latency and
    prompt/new-token histograms, the lifetime counters and the load
    gauges. The registry is cumulative across windows (the service's
    scrape state); ``slo`` (an :class:`~paddle_tpu_torch.observability.
    slo.SLOTracker`) observes every retired request's TTFT and TPOT."""

    def __init__(self, max_batch_slots: int,
                 cache: Optional[PrefixCache] = None,
                 allocator: Optional[BlockAllocator] = None,
                 registry=None, slo=None):
        self.slots = max_batch_slots
        self.records: List[Dict[str, Any]] = []
        self.drops: List[Dict[str, Any]] = []
        self.step_samples: List[Dict[str, float]] = []
        self.tick_samples: List[Dict[str, float]] = []
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.prefill_chunks = 0
        self.prompt_tokens = 0
        self.prefix_hit_tokens = 0
        # ticks whose next-round admission ran while the dispatched
        # step was in flight
        self.overlap_ticks = 0
        self.preemptions = 0
        self.blocks_spilled = 0
        self.blocks_swapped_in = 0
        self.swap_in_tokens = 0
        # host reads of a prefill's sampled token (final chunks only)
        self.prefill_token_syncs = 0
        # constrained decoding: committed tokens that advanced a
        # grammar, mask builds by where they ran, boundary fallbacks and
        # dead-end retirements
        self.constrained_tokens = 0
        self.mask_builds_in_window = 0
        self.mask_builds_boundary = 0
        self.mask_fallback_syncs = 0
        self.constraint_dead_ends = 0
        self._cache = cache
        self._evict_base = cache.evictions if cache is not None else 0
        self._alloc = allocator
        self._alloc_base = (allocator.allocs, allocator.freed) \
            if allocator is not None else (0, 0)
        if allocator is not None:
            # the high-water mark restarts with the window
            allocator.peak = allocator.blocks_in_use()
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._slo = slo
        r = self.registry
        tb, sb = DEFAULT_TIME_BUCKETS, DEFAULT_SIZE_BUCKETS
        self._h_ttft = r.histogram(
            "serving_ttft_seconds", "arrival to first token", tb)
        self._h_tpot = r.histogram(
            "serving_tpot_seconds",
            "time per output token after the first (Sarathi's stall "
            "metric, per request)", tb)
        self._h_qwait = r.histogram(
            "serving_queue_wait_seconds", "arrival to admission", tb)
        self._h_latency = r.histogram(
            "serving_request_latency_seconds", "arrival to last token",
            tb)
        self._h_prompt = r.histogram(
            "serving_prompt_tokens", "prompt length per request", sb)
        self._h_new = r.histogram(
            "serving_new_tokens", "generated tokens per request", sb)
        self._c_done = r.counter(
            "serving_requests_completed_total",
            "retired requests by finish reason", labelnames=("reason",))
        self._c_dropped = r.counter(
            "serving_requests_dropped_total",
            "queued requests dropped before admission "
            "(cancelled / deadline_exceeded)", labelnames=("reason",))
        self._c_tokens = r.counter(
            "serving_tokens_generated_total", "committed new tokens")
        self._c_steps = r.counter(
            "serving_decode_steps_total", "lockstep decode/verify ticks")
        self._c_chunks = r.counter(
            "serving_prefill_chunks_total", "chunk-prefill dispatches")
        self._c_overlap = r.counter(
            "serving_overlap_ticks_total",
            "decode/verify ticks whose next-tick admission/scheduling "
            "ran while the dispatched programs were in flight")
        self._c_prompt = r.counter(
            "serving_prompt_tokens_total", "prompt tokens admitted")
        self._c_hit = r.counter(
            "serving_prefix_hit_tokens_total",
            "prompt tokens served from the prefix cache")
        self._c_preempt = r.counter(
            "serving_preemptions_total",
            "requests preempted back to the queue on pool exhaustion")
        self._c_spilled = r.counter(
            "serving_blocks_spilled_total",
            "pool blocks copied to the host tier at preemption "
            "(trie demotions count on the cache's own stats)")
        self._c_swapped = r.counter(
            "serving_blocks_swapped_in_total",
            "host-tier blocks spliced back into the device pool")
        self._c_avoided = r.counter(
            "serving_reprefill_tokens_avoided_total",
            "prompt+token positions a swap-back seeded instead of "
            "recomputing through the model")
        self._c_tok_syncs = r.counter(
            "serving_prefill_token_syncs_total",
            "host syncs materializing a prefill chunk's sampled token "
            "(final chunks only — non-final draws stay on device)")
        self._c_con_tokens = r.counter(
            "serving_constrained_tokens_total",
            "committed tokens that advanced a grammar automaton "
            "(constrained slots only — unconstrained traffic never "
            "touches the mask path)")
        self._c_mask_builds = r.counter(
            "serving_mask_builds_total",
            "next-step vocab-mask builds by where the automaton "
            "stepped (overlap_window = hidden under the in-flight "
            "dispatch; boundary = serialized at the tick boundary)",
            labelnames=("where",))
        self._c_mask_fallback = r.counter(
            "serving_mask_fallback_syncs_total",
            "constrained ticks whose mask build could not ride the "
            "overlap window (overlap disabled or the window skipped) "
            "and ran at the token-sync boundary instead")
        self._c_dead_end = r.counter(
            "serving_constraint_dead_ends_total",
            "requests retired because their grammar reached a state "
            "with no legal continuation (a counted typed retirement, "
            "never a crash)")
        self._g_queue = r.gauge(
            "serving_queue_depth", "due requests waiting for admission")
        self._g_occ = r.gauge(
            "serving_slots_occupied", "in-flight slots (incl. prefill)")
        self._g_blocks = r.gauge(
            "serving_blocks_in_use", "paged pool blocks mapped")

    # counted-economics updates: one home each, so the window attribute
    # and the lifetime registry series never drift apart
    def count_prefill_chunk(self):
        self.prefill_chunks += 1
        self._c_chunks.inc()

    def count_prompt_tokens(self, n: int):
        # admission semantics: a preempted request's re-prefill counts
        # again, so prefill_tokens_computed charges the redone work
        self.prompt_tokens += int(n)
        self._c_prompt.inc(int(n))

    def count_prefix_hit_tokens(self, n: int):
        self.prefix_hit_tokens += int(n)
        self._c_hit.inc(int(n))

    def count_overlap_tick(self):
        self.overlap_ticks += 1
        self._c_overlap.inc()

    def record_preemption(self):
        self.preemptions += 1
        self._c_preempt.inc()

    def count_spill(self, blocks: int):
        self.blocks_spilled += int(blocks)
        self._c_spilled.inc(int(blocks))

    def count_swap_in(self, blocks: int, tokens: int):
        self.blocks_swapped_in += int(blocks)
        self.swap_in_tokens += int(tokens)
        self._c_swapped.inc(int(blocks))
        self._c_avoided.inc(int(tokens))

    def count_prefill_token_sync(self):
        self.prefill_token_syncs += 1
        self._c_tok_syncs.inc()

    def count_constrained_token(self):
        self.constrained_tokens += 1
        self._c_con_tokens.inc()

    def count_mask_build(self, in_window: bool):
        if in_window:
            self.mask_builds_in_window += 1
            self._c_mask_builds.labels(where="overlap_window").inc()
        else:
            self.mask_builds_boundary += 1
            self._c_mask_builds.labels(where="boundary").inc()

    def count_mask_fallback_sync(self):
        self.mask_fallback_syncs += 1
        self._c_mask_fallback.inc()

    def count_constraint_dead_end(self):
        self.constraint_dead_ends += 1
        self._c_dead_end.inc()

    def record_tick(self, occupied: int, queued: int,
                    blocks: Optional[int] = None):
        """One tick's load sample; ``occupied`` counts every in-flight
        slot, prefilling ones included."""
        sample = {"occupied": float(occupied), "queued": float(queued)}
        if blocks is not None:
            sample["blocks"] = float(blocks)
            self._g_blocks.set(blocks)
        self._g_occ.set(occupied)
        self._g_queue.set(queued)
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
        self._c_steps.inc()
        self.step_samples.append(sample)

    def record_request(self, req: Request, arrival: float, admitted: float,
                       first_token: float, finished: float,
                       resume_wait: float = 0.0,
                       resume_wait_pre_first: float = 0.0):
        """One retired request. ``resume_wait`` is the TOTAL time the
        request spent back in the queue after preemptions; its
        ``resume_wait_pre_first`` share fell before the first token.
        Both count as queue wait, so a resumed request's stalls inflate
        neither TTFT (the pre-first share) nor TPOT (the rest); only the
        end-to-end ``latency`` keeps them."""
        self.t_first = arrival if self.t_first is None \
            else min(self.t_first, arrival)
        self.t_last = finished if self.t_last is None \
            else max(self.t_last, finished)
        n = len(req.tokens)
        decode_time = (finished - first_token) \
            - (resume_wait - resume_wait_pre_first)
        rec = {
            "id": req.id, "prompt_len": len(req.prompt), "new_tokens": n,
            "tenant": req.tenant,
            "queue_wait": (admitted - arrival) + resume_wait,
            "ttft": first_token - arrival - resume_wait_pre_first,
            "latency": finished - arrival,
            "tpot": decode_time / (n - 1) if n > 1 else None,
            "decode_tps": (n - 1) / max(decode_time, 1e-9)
            if n > 1 else 0.0,
        }
        self.records.append(rec)
        self._h_ttft.observe(rec["ttft"])
        self._h_qwait.observe(rec["queue_wait"])
        self._h_latency.observe(rec["latency"])
        if n > 1:
            self._h_tpot.observe(rec["tpot"])
        self._h_prompt.observe(rec["prompt_len"])
        self._h_new.observe(n)
        self._c_tokens.inc(n)
        self._c_done.labels(reason=req.finish_reason or "unknown").inc()
        if self._slo is not None:
            self._slo.observe(req.tenant, rec["ttft"], rec["tpot"])

    def record_drop(self, req: Request, reason: str):
        """A queued request dropped before admission: counted by reason,
        with no latency sample."""
        self.drops.append({"id": req.id, "reason": reason,
                           "tenant": req.tenant})
        self._c_dropped.labels(reason=reason).inc()

    def by_tenant(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant percentile split of the window's records
        (``serving.py:2442``): p50/p99 TTFT and TPOT, p99 queue wait
        and latency, completions and drops. A tenant whose every
        request was dropped still gets a row."""
        groups: Dict[str, List[Dict[str, Any]]] = {}
        for r in self.records:
            groups.setdefault(r.get("tenant", "default"), []).append(r)
        for x in self.drops:
            groups.setdefault(x.get("tenant", "default"), [])
        out: Dict[str, Dict[str, float]] = {}
        for ten, rs in groups.items():
            d: Dict[str, float] = {"completed": float(len(rs))}
            if rs:
                ttft = np.asarray([r["ttft"] for r in rs])
                qw = np.asarray([r["queue_wait"] for r in rs])
                lat = np.asarray([r["latency"] for r in rs])
                d["ttft_p50_s"] = float(np.percentile(ttft, 50))
                d["ttft_p99_s"] = float(np.percentile(ttft, 99))
                d["queue_wait_p99_s"] = float(np.percentile(qw, 99))
                d["latency_p99_s"] = float(np.percentile(lat, 99))
                tpot = [r["tpot"] for r in rs if r["tpot"] is not None]
                if tpot:
                    d["tpot_p50_s"] = float(np.percentile(tpot, 50))
                    d["tpot_p99_s"] = float(np.percentile(tpot, 99))
            d["dropped"] = float(sum(
                1 for x in self.drops
                if x.get("tenant", "default") == ten))
            out[ten] = d
        return out

    def aggregate(self) -> Dict[str, float]:
        out: Dict[str, float] = {"completed": float(len(self.records))}
        if self.drops:
            out["dropped"] = float(len(self.drops))
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
        out["overlap_ticks"] = float(self.overlap_ticks)
        if self.step_samples:
            out["overlap_fraction"] = float(
                self.overlap_ticks / len(self.step_samples))
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
        out["prefill_token_syncs"] = float(self.prefill_token_syncs)
        # constrained decoding (serving.py:2565-2577): reported only when
        # the window saw constrained traffic, so an unconstrained run
        # keeps the same set of keys
        builds = self.mask_builds_in_window + self.mask_builds_boundary
        if builds or self.constrained_tokens or self.constraint_dead_ends:
            out["constrained_tokens"] = float(self.constrained_tokens)
            out["mask_builds"] = float(builds)
            out["mask_in_window_fraction"] = (
                self.mask_builds_in_window / builds if builds else 0.0)
            out["mask_fallback_syncs"] = float(self.mask_fallback_syncs)
            out["constraint_dead_ends"] = float(self.constraint_dead_ends)
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


# the profiling-off fast path: ServingEngine._phase returns this shared
# reusable null context, so an unprofiled tick allocates nothing a phase
_NULL_PHASE = contextlib.nullcontext()

# magic prefix of the request-snapshot byte frame
# (ServingEngine.snapshot_request_bytes; ``serving.py:2612``): magic +
# 8-byte LE header length + JSON header + npz payload
_SNAP_MAGIC = b"PTRQSNP1"


class _ProfPhase:
    """A guarded tick-profiler phase span (``serving.py:2615``): a
    raising profiler is absorbed, counted into
    ``serving_profiler_errors_total`` and warned once, while the engine
    keeps serving token-exact. Exceptions from the BODY of the ``with``
    block propagate untouched."""

    __slots__ = ("_eng", "_name", "_cm")

    def __init__(self, eng, name):
        self._eng = eng
        self._name = name
        self._cm = None

    def __enter__(self):
        prof = getattr(self._eng.telemetry, "profiler", None)
        if prof is None or not prof.enabled:
            return self
        try:
            cm = prof.phase(self._name)
            cm.__enter__()
            self._cm = cm
        except Exception as err:
            self._cm = None
            self._eng._profile_failed(err)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._cm is not None:
            try:
                self._cm.__exit__(None, None, None)
            except Exception as err:
                self._eng._profile_failed(err)
        return False


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
    of each slot for the verify's writes.

    ``telemetry`` is the engine's observability bundle
    (:class:`~paddle_tpu_torch.observability.Telemetry`), ALWAYS on — a
    private one per engine by default. Every request's lifecycle
    streams into its tracer (one chrome-trace lane a request), every
    engine event (admission, preemption, block churn, trie eviction,
    program launch) into its flight recorder (dumped if ``run()``
    dies), the latency and length histograms and the counters into its
    registry under the reference's names, and its recompile sentinel
    watches every program. ``profile=True`` arms the bundle's
    :class:`~paddle_tpu_torch.observability.profile.TickProfiler`: the
    tick's phases (``admission``, ``bookkeeping``,
    ``prefill_dispatch``, ``block_growth``, ``draft``,
    ``decode_dispatch``, ``overlap_window``, ``token_sync``,
    ``callbacks``) as host-clock spans. Every telemetry and profiler
    call is guarded: a raising one is counted and warned, never a
    request fault.

    ``overlap=True`` (default) runs the next tick's admissions while the
    dispatched step is in flight, reading the tokens only after.

    Resilience: a fault on one request's admit, prefix splice or copy,
    chunk prefill or swap-back path is QUARANTINED — that request
    retires with ``finish_reason="error"`` (counted under
    ``serving_request_errors_total{where=}``, its slot, blocks and trie
    pins released) and the engine keeps serving; ``quarantine=False``
    fails fast instead. Engine-scoped tick failures count against a
    consecutive-failure circuit breaker (``engine_failure_threshold``)
    that drains to the fail-all path (flight dump, raise).
    ``logit_guard=True`` retires exactly the slot whose logits went
    non-finite, and zeroes the storage it released. Program dispatches
    get ``dispatch_retries`` bounded jittered retries and, with
    ``dispatch_stall_s``, a watchdog that records ``dispatch_stall``
    events. :meth:`audit` reconciles the pool, the host tier, the trie
    pins and the slot table after every quarantine.

    Cross-thread use: :meth:`submit` and :meth:`cancel` are safe from
    any thread and wake an idle engine; cancellations and deadline
    expiries apply at the next tick boundary (a queued request drops,
    a running one retires, counted under
    ``serving_requests_dropped_total{reason}`` or
    ``serving_requests_completed_total{reason}``).
    :meth:`at_tick_boundary` runs a callable at that boundary and hands
    its result (or its raise) back to the calling thread; the request
    snapshots (:meth:`snapshot_request`, :meth:`snapshot_request_bytes`,
    :meth:`restore_request`, :meth:`migrate_out_request`) run there.

    ``adapter_pool`` (an :class:`~paddle_tpu_torch.inference.
    adapter_pool.AdapterPool`) serves ``Request(adapter=)`` traffic
    through the engine's one set of programs: a request acquires its
    adapter at submit (an unknown one is a counted typed rejection,
    ``serving_adapter_rejected_total``) and releases it at retirement;
    its tenant defaults to ``adapter:<name>``. Its prompt never meets
    the prefix cache: the adapter's qkv delta changes K and V, so KV
    computed for another adapter (or none) is wrong for it. A
    ``response_format`` compiles at submit (failures counted in
    ``serving_constraint_rejected_total``) and its per-step mask row
    rides the step, the chunk and the verify; ``kind="score"`` and
    ``"embed"`` requests retire ``"complete"`` at prefill completion
    with one host read and never dispatch a decode step.

    The parameters keep the reference's order; its ``mesh``,
    ``seq_parallel`` and ``adaptive`` are accepted at their defaults
    only."""

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
            "ServingEngine", mesh=(mesh, None),
            seq_parallel=(seq_parallel, False),
            adaptive=(adaptive, None))
        dev = resolve_device(device)
        mdev = module_device(model)
        if mdev.type != dev.type:
            raise ValueError(
                f"the model lives on {mdev}, the engine was asked for "
                f"{dev}; build the model on the engine's device")
        # telemetry is ALWAYS on; the default bundle is private
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry(clock=clock)
        self.spec = spec
        kw = dict(top_k=top_k, prefill_chunk=prefill_chunk,
                  block_size=block_size, num_blocks=num_blocks,
                  kv_dtype=kv_dtype, logit_guard=logit_guard,
                  host_tier_blocks=host_tier_blocks,
                  adapter_pool=adapter_pool)
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
        self.adapter_pool = adapter_pool
        self.replicas = 1
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
        self._swaps_in_flight = 0
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
        # cross-thread submission and cancellation: the lock guards
        # queue and flag mutations (the tick's dispatches run outside
        # it, and the ops plane's scrapes read under it); the condition
        # wakes an idle engine the moment work arrives
        self._lock = threading.RLock()
        self._wake = threading.Condition()
        self._wake_flag = False
        self._cancels: List[Request] = []
        # tick-boundary jobs: callables appended under _lock from any
        # thread and drained at the top of every tick and around run()'s
        # loop; with no run() in flight a job drains inline under the
        # tick gate, so a bare engine needs no pump thread
        self._boundary_jobs: List[tuple] = []
        self._tick_gate = threading.RLock()
        self._running = False
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
        # constrained decoding per slot: the grammar cursor (advances
        # only at commit), the dead-end flag the commit loop retires on,
        # and the speculative commit clamp (first dead position + 1);
        # _mask_work_done / _in_mask_window count where mask builds ran
        self._constraints: List[Optional[Any]] = [None] * self.b
        self._con_dead = [False] * self.b
        self._con_commit: List[Optional[int]] = [None] * self.b
        self._mask_work_done = False
        self._in_mask_window = False
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
        # -- resilience ---------------------------------------------------
        self._quar = bool(quarantine)
        self._breaker_threshold = int(engine_failure_threshold)
        if self._breaker_threshold < 1:
            raise ValueError(
                f"engine_failure_threshold must be >= 1, got "
                f"{engine_failure_threshold}")
        self._engine_failures = 0       # consecutive; reset per clean tick
        # breaker STATE: open from a trip until the next run() call
        self._breaker_open = False
        self._cb_error = False          # the raise came from a callback
        self._ticks_total = 0
        self.logit_guard = bool(logit_guard)
        # the guarded step's finite mask, read with its tokens
        self._finite_host: Optional[np.ndarray] = None
        self._profile = bool(profile)
        self._profile_warned = False
        if self._profile:
            prof = getattr(self.telemetry, "profiler", None)
            if prof is not None:
                prof.enable()
        # per-replica utilization accounting (one replica here)
        self._rep_ticks = 0
        self._rep_busy = [0] * self.replicas
        self._rep_tokens = [0] * self.replicas
        self._overlap = bool(overlap)
        # dispatch-level resilience lives on the ProgramSet (the draft
        # model's arena included)
        for ps in self._program_sets():
            ps.dispatch_retries = int(dispatch_retries)
            ps.stall_threshold = dispatch_stall_s
        self._wire_telemetry(self.telemetry)
        self.metrics = ServingMetrics(self.b, self._cache, self._alloc,
                                      registry=self.telemetry.registry,
                                      slo=self.telemetry.slo)
        self._arm_resilience_telemetry(self.telemetry)
        self._arm_load_gauges(self.telemetry)

    def _program_sets(self):
        """Every ProgramSet this engine dispatches through: its own,
        plus the draft model's when one rides along."""
        sets = [self.engine.programs]
        if self.spec is not None and \
                getattr(self.spec, "engine", None) is not None:
            sets.append(self.spec.engine.programs)
        return sets

    def _wire_telemetry(self, telemetry):
        """Point the sentinel at every program and the flight recorder
        at the pools and the trie, and register the submission
        counter."""
        self.engine.sentinel = telemetry.sentinel
        if self.spec is not None and \
                getattr(self.spec, "engine", None) is not None:
            self.spec.engine.sentinel = telemetry.sentinel
        if self._alloc is not None:
            self._alloc.recorder = telemetry.recorder
        if self._host is not None:
            self._host.recorder = telemetry.recorder
        if self._cache is not None:
            self._cache.recorder = telemetry.recorder
        self._c_submitted = telemetry.registry.counter(
            "serving_requests_submitted_total",
            "requests accepted into the queue")
        self._c_adapter_rejected = telemetry.registry.counter(
            "serving_adapter_rejected_total",
            "submissions refused at the door for adapter reasons "
            "(named adapter missing/evicted, or no pool configured) — "
            "typed rejections, never a crash")
        self._c_constraint_rejected = telemetry.registry.counter(
            "serving_constraint_rejected_total",
            "submissions refused at the door for structured-output "
            "reasons (bad response_format, unknown model vocab, "
            "embed without hidden-state support, unsatisfiable "
            "grammar) — typed rejections, never a crash-in-flight")

    def _arm_resilience_telemetry(self, telemetry):
        """Register the resilience counters and gauges on ``telemetry``
        (eager, so a scrape before the first fault shows explicit 0s)
        and point the ProgramSets' watchdog, retry and ledger hooks at
        its ring and registry (``serving.py:3173``)."""
        r = telemetry.registry
        self._c_req_err = r.counter(
            "serving_request_errors_total",
            "requests quarantined with finish_reason='error', by "
            "faulting path", labelnames=("where",))
        self._c_nonfinite = r.counter(
            "serving_nonfinite_logit_events_total",
            "slots retired by the NaN/inf logit guard")
        self._c_eng_err = r.counter(
            "serving_engine_errors_total",
            "engine-scoped tick failures absorbed by the breaker")
        self._c_breaker = r.counter(
            "serving_breaker_trips_total",
            "circuit-breaker trips draining to the fail-all path")
        self._c_dump_failed = r.counter(
            "serving_flight_dump_failed_total",
            "tracer/flight-ring writes that failed and were absorbed "
            "(crash handling and request paths; serving continues)")
        c_stall = r.counter(
            "serving_dispatch_stalls_total",
            "compiled dispatches that overran the stall watchdog")
        c_retry = r.counter(
            "serving_dispatch_retries_total",
            "transient dispatch errors absorbed by bounded retry")
        self._g_leaked = r.gauge(
            "serving_leaked_blocks",
            "pool blocks with unaccounted references at the last "
            "audit (0 = reconciled clean)")
        self._g_orphaned = r.gauge(
            "serving_orphaned_pins",
            "prefix-trie references no live slot accounts for at the "
            "last audit")
        self._c_swap_dec = r.counter(
            "serving_swap_decisions_total",
            "per-preemption swap-vs-recompute verdicts (swap = spill "
            "to the host tier; recompute = prefix below the "
            "crossover; host_full = tier could not grant; fault = "
            "spill faulted mid-write) — sums to the tier-eligible "
            "preemptions", labelnames=("choice",))
        self._c_swap_fb = r.counter(
            "serving_swap_fallbacks_total",
            "spill/swap-back faults degraded to re-prefill (the "
            "request survives; only the copy saving is lost)",
            labelnames=("where",))
        self._g_leaked_host = r.gauge(
            "serving_leaked_host_blocks",
            "host-tier blocks with unaccounted references at the "
            "last audit (0 = reconciled clean)")
        self._g_leaked_adapters = r.gauge(
            "serving_leaked_adapters",
            "adapter-pool slot references no live or queued request "
            "accounts for at the last audit (0 = reconciled clean)")
        self._c_snapshots = r.counter(
            "serving_request_snapshots_total",
            "live requests serialized through the checkpoint "
            "machinery (sha256-checksummed shards)")
        self._c_restores = r.counter(
            "serving_request_restores_total",
            "snapshots re-enqueued, by KV outcome (swap_in = parked "
            "for splice-back; reprefill = no tier/space; "
            "corrupt_fallback = shard failed its checksum, tokens "
            "recovered from metadata)", labelnames=("outcome",))
        self._c_migrations = r.counter(
            "serving_request_migrations_out_total",
            "live requests snapshotted to a byte frame and retired "
            "(finish_reason=\"migrated\") for restore on a peer "
            "engine — the fleet router's drain/rebalance primitive")
        self._c_prof_err = r.counter(
            "serving_profiler_errors_total",
            "tick-profiler calls that raised and were absorbed "
            "(profiling is observability, never control flow; "
            "serving continues)")
        # the per-program dispatch ledger
        c_disp = r.counter(
            "program_dispatches_total",
            "compiled-program dispatches by program (the ProgramSet "
            "ledger; every dispatch counts, deferred ones included)",
            labelnames=("program",))
        h_enq = r.histogram(
            "serving_program_enqueue_seconds",
            "host-side dispatch call duration per program (async "
            "enqueue, not device completion)",
            PHASE_BUCKETS, labelnames=("program",))
        h_win = r.histogram(
            "serving_program_device_window_seconds",
            "enqueue-return to finalize per program — on an async "
            "backend, the device-side window the host can overlap",
            PHASE_BUCKETS, labelnames=("program",))
        h_wall = r.histogram(
            "serving_program_wall_seconds",
            "dispatch to finalize per program (enqueue + device "
            "window)", PHASE_BUCKETS, labelnames=("program",))
        for ps in self._program_sets():
            ps.recorder = telemetry.recorder
            ps.stall_counter = c_stall
            ps.retry_counter = c_retry
            ps.dispatch_counter = c_disp
            ps.enqueue_hist = h_enq
            ps.window_hist = h_win
            ps.wall_hist = h_wall

    def _arm_load_gauges(self, telemetry):
        """Register the scrape-time LOAD gauges a fleet router routes on
        (``serving.py:3292``); :meth:`publish_load_gauges` refreshes
        them per scrape, so the tick loop never pays for them."""
        r = telemetry.registry
        self._g_free_slots = r.gauge(
            "serving_free_slots",
            "decode slots free for admission at the last scrape")
        self._g_free_blocks = r.gauge(
            "serving_free_blocks",
            "paged pool blocks on the free list at the last scrape "
            "(-1 = dense engine, no pool)")
        self._g_tier_depth = r.gauge(
            "serving_queue_depth_tier",
            "queued requests by priority tier at the last scrape",
            labelnames=("tier",))
        self._g_overlap_frac = r.gauge(
            "serving_overlap_fraction",
            "overlapped ticks / decode steps in the current metrics "
            "window")
        self._g_breaker_open = r.gauge(
            "serving_breaker_open",
            "1 while the circuit breaker is open (tripped, engine "
            "drained to fail-all; re-closes on the next run()), else 0")
        self._g_stalled = r.gauge(
            "serving_dispatch_stalled",
            "compiled dispatches currently past the stall watchdog "
            "threshold")
        self._g_host_blocks = r.gauge(
            "serving_host_blocks_in_use",
            "host-tier blocks holding spilled KV at the last scrape "
            "(-1 = no host tier configured)")
        self._g_swap_inflight = r.gauge(
            "serving_swap_in_flight",
            "host<->device block copies in flight right now (spills "
            "and swap-backs; >0 on a scrape = the tick is paying a "
            "swap stall)")
        self._g_prefill_backlog = r.gauge(
            "serving_prefill_backlog_tokens",
            "unprefilled prompt tokens summed over prefilling slots "
            "at the last scrape — the saturation signal a "
            "role='prefill' engine's /readyz and the fleet router's "
            "long-prompt classifier read")
        self._tiers_seen = set()
        self._g_rep_util = r.gauge(
            "serving_replica_utilization",
            "busy-slot-ticks / (ticks * slots-per-replica) in the "
            "current metrics window, by replica (R=1 publishes the "
            "single replica 0 child)", labelnames=("replica",))
        self._g_rep_tpt = r.gauge(
            "serving_replica_tokens_per_tick",
            "tokens committed per scheduler tick in the current "
            "metrics window, by replica", labelnames=("replica",))
        self._g_skew = r.gauge(
            "serving_replica_skew",
            "max/mean of per-replica busy-slot-ticks in the current "
            "metrics window (1.0 = perfectly balanced; counted, "
            "wall-clock-free — trivially 1.0 at R=1)")
        self._g_pfx_hit_rate = self._g_pfx_bytes = None
        self._g_pfx_hit_tokens = None
        if self._cache is not None:
            self._g_pfx_hit_rate = r.gauge(
                "serving_prefix_hit_rate",
                "prefix-cache lookups that matched >= 1 chunk / total "
                "lookups since the trie was built, by replica-local "
                "trie", labelnames=("replica",))
            self._g_pfx_bytes = r.gauge(
                "serving_prefix_trie_bytes",
                "device KV bytes pinned by the replica-local trie's "
                "cached chunks at the last scrape (demoted host-tier "
                "bytes excluded)", labelnames=("replica",))
            self._g_pfx_hit_tokens = r.gauge(
                "serving_prefix_hit_tokens_recovered",
                "prompt tokens served from cached KV instead of "
                "recomputed, cumulative since the trie was built, by "
                "replica-local trie", labelnames=("replica",))
            self._g_pfx_hit_rate.labels(replica="0").set(0.0)
            self._g_pfx_bytes.labels(replica="0").set(
                float(self._cache.bytes))
            self._g_pfx_hit_tokens.labels(replica="0").set(
                float(self._cache.hit_tokens))
        # the adapter pool's occupancy and load economics, registered
        # only with a pool (a pool-less scrape keeps its families)
        self._g_ad_in_use = self._g_ad_loads = None
        self._g_ad_evictions = self._g_ad_bytes = None
        if self.adapter_pool is not None:
            self._g_ad_in_use = r.gauge(
                "serving_adapter_slots_in_use",
                "adapter-pool slots holding a registered adapter at "
                "the last scrape (slot 0, the identity row, excluded)")
            self._g_ad_loads = r.gauge(
                "serving_adapter_loads_total",
                "adapters registered into the pool, cumulative "
                "(re-registrations after eviction count again)")
            self._g_ad_evictions = r.gauge(
                "serving_adapter_evictions_total",
                "adapters evicted from the pool, cumulative (LRU "
                "pressure evictions and explicit evict() calls)")
            self._g_ad_bytes = r.gauge(
                "serving_adapter_bytes_loaded_total",
                "host bytes copied into adapter-pool rows, cumulative")
            self._publish_adapter_gauges()

    def _publish_adapter_gauges(self):
        if self._g_ad_in_use is None:
            return
        pool = self.adapter_pool
        self._g_ad_in_use.set(float(pool.slots_in_use()))
        self._g_ad_loads.set(float(pool.loads))
        self._g_ad_evictions.set(float(pool.evictions))
        self._g_ad_bytes.set(float(pool.bytes_loaded))

    def prefill_backlog_tokens(self) -> int:
        """Unprefilled prompt tokens summed over prefilling slots (queued
        requests are not counted)."""
        with self._lock:
            return sum(len(st["ids"]) - st["pos"]
                       for st in self._pf
                       if st is not None and st["pos"] < len(st["ids"]))

    def set_telemetry(self, telemetry):
        """Swap in a fresh telemetry bundle between runs — e.g. after a
        warmup request, so exported histograms, lanes and rings describe
        the measured traffic. Idle engines only."""
        if self.active_count() or self.scheduler.depth():
            raise RuntimeError(
                "set_telemetry with requests queued or in flight would "
                "split their lifecycle across two bundles; drain first")
        # carry the warmup baselines over: a fresh sentinel observing
        # warm programs for the "first" time would swallow a real
        # post-swap recompile as its own warmup
        telemetry.sentinel.adopt_baseline(
            self.telemetry.sentinel.baseline())
        self.telemetry = telemetry
        self._wire_telemetry(telemetry)
        self.metrics = ServingMetrics(self.b, self._cache, self._alloc,
                                      registry=telemetry.registry,
                                      slo=telemetry.slo)
        self._arm_resilience_telemetry(telemetry)
        self._arm_load_gauges(telemetry)
        if self._profile:
            prof = getattr(telemetry, "profiler", None)
            if prof is not None:
                prof.enable()

    # -- submission ---------------------------------------------------------
    def submit(self, req: Request) -> Request:
        if req.status != "new":
            raise ValueError(
                f"request already {req.status}; submit a fresh Request "
                "object per generation")
        sp = req.sampling
        if sp is not None:
            # a SamplingParams bundle overrides the individual fields
            # (already validated by its own __post_init__)
            req.temperature = float(getattr(sp, "temperature",
                                            req.temperature))
            req.greedy = bool(getattr(sp, "greedy", req.greedy))
            req.top_k = getattr(sp, "top_k", req.top_k)
            req.top_p = getattr(sp, "top_p", req.top_p)
            if getattr(sp, "seed", None) is not None:
                req.seed = sp.seed
            if getattr(sp, "response_format", None) is not None:
                req.response_format = sp.response_format
        if req.kind not in ("generate", "score", "embed"):
            raise ValueError(
                f"kind must be 'generate', 'score' or 'embed', got "
                f"{req.kind!r}")
        if req.kind != "generate":
            # score/embed never decode: the budget is the one token the
            # chunk program samples (and discards), so the pool checks
            # below price the true footprint
            req.max_new_tokens = 1
            if req.response_format is not None:
                self._c_constraint_rejected.inc()
                raise ValueError(
                    f"response_format only applies to kind='generate' "
                    f"(got kind={req.kind!r}) — a {req.kind} request "
                    "emits no tokens to constrain")
        if req.kind == "embed" and not self.engine.supports_hidden:
            self._c_constraint_rejected.inc()
            raise ValueError(
                "kind='embed' needs a model whose forward exposes "
                "hidden states (output_hidden=) — this engine's model "
                "does not; score and generate still work")
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
        if req.deadline is not None and \
                req.deadline <= req.arrival_time:
            # an already-dead request would only churn the scheduler
            raise ValueError(
                f"deadline {req.deadline} is not after arrival_time "
                f"{req.arrival_time} — the request could never run "
                "(deadline is an absolute offset on the run clock)")
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
        if req.response_format is not None:
            req._constraint = self._compile_constraint(req)
        if req.adapter is not None:
            # LAST validation on purpose: the acquire is the request's
            # one reference, and nothing below can fail
            self._acquire_adapter(req)
        with self._lock:
            req.id = self._next_id
            self._next_id += 1
            req.status = "queued"
            self.scheduler.submit(req)
            self._c_submitted.inc()
            with self._telemetry("submit events"):
                self.telemetry.tracer.lifecycle(
                    req.id, "submitted", prompt_len=plen,
                    max_new_tokens=req.max_new_tokens,
                    arrival_time=req.arrival_time)
                self.telemetry.recorder.record(
                    "submit", rid=req.id, prompt_len=plen,
                    max_new_tokens=req.max_new_tokens,
                    tenant=req.tenant, req_kind=req.kind)
        self._wake_up()     # an idle engine admits this within a tick
        return req

    def _compile_constraint(self, req: Request):
        """Resolve and compile ``req.response_format`` against the
        model's vocabulary (``serving.py:3757-3793``): a bad pattern or
        schema, a model without a vocab size, or a grammar with no legal
        first token is a counted typed rejection here, never a fault in
        flight."""
        from paddle_tpu_torch.inference.constrain import from_response_format

        V = self.engine.vocab_size
        if V is None:
            self._c_constraint_rejected.inc()
            raise ValueError(
                "response_format needs a model with a declared "
                "vocab_size (model.config.vocab_size) — this engine "
                "cannot map token ids to a grammar alphabet")
        eos = req.eos_id if req.eos_id is not None else self.eos_id
        try:
            grammar = from_response_format(req.response_format).compile(
                V, eos)
            first_row = grammar.mask(grammar.start)
        except ValueError:
            self._c_constraint_rejected.inc()
            raise
        except Exception as e:
            self._c_constraint_rejected.inc()
            raise ValueError(
                f"response_format failed to compile: {e!r}") from e
        if grammar.is_dead(grammar.start) or not first_row.any():
            self._c_constraint_rejected.inc()
            raise ValueError(
                "response_format admits no legal first token under this "
                "model's vocabulary (and no EOS) — the request could "
                "never emit anything")
        return grammar

    def _acquire_adapter(self, req: Request):
        """The request's one adapter reference (``serving.py:
        3794-3826``), held until retirement; an unknown adapter or a
        pool-less engine is a counted typed rejection."""
        if not isinstance(req.adapter, str):
            self._c_adapter_rejected.inc()
            raise ValueError(
                f"adapter must be a registered adapter name (str), got "
                f"{type(req.adapter).__name__}")
        if self.adapter_pool is None:
            self._c_adapter_rejected.inc()
            raise ValueError(
                f"adapter {req.adapter!r} requested but this engine has "
                "no adapter_pool — construct "
                "ServingEngine(adapter_pool=AdapterPool(...))")
        try:
            req._adapter_sid = self.adapter_pool.acquire(req.adapter)
        except KeyError as e:
            self._c_adapter_rejected.inc()
            raise ValueError(
                f"adapter {req.adapter!r} is not registered (missing or "
                "already evicted) — register it before submitting") from e
        # the adapter IS the tenant unless the caller named one
        if req.tenant == "default":
            req.tenant = f"adapter:{req.adapter}"

    def _release_adapter(self, req: Request):
        """Drop the request's adapter reference: the one release point
        of every terminal path, idempotent per request."""
        if req._adapter_sid and self.adapter_pool is not None:
            try:
                self.adapter_pool.release(req._adapter_sid)
            except KeyError:
                pass    # evicted out of band: the reference is gone
            req._adapter_sid = 0

    def cancel(self, req: Request) -> bool:
        """Request cancellation from any thread (``serving.py:3845``).
        Applied at the next TICK BOUNDARY, like admissions: a queued
        request drops from the scheduler, a running one retires with
        reason ``"cancelled"``, releasing its slot, blocks, trie pins
        and parked host blocks. False when the request already retired
        (tokens already delivered win the race)."""
        if req.id < 0:
            raise ValueError("request was never submitted")
        with self._lock:
            if req.status == "done":
                return False
            req.cancel_requested = True
            self._cancels.append(req)
            with self._telemetry("cancel events"):
                self.telemetry.recorder.record("cancel", rid=req.id,
                                               status=req.status)
                self.telemetry.tracer.event(req.id, "cancel_requested")
        self._wake_up()
        return True

    def _wake_up(self):
        with self._wake:
            self._wake_flag = True
            self._wake.notify_all()

    def active_count(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    def queue_depth(self) -> int:
        return self.scheduler.depth()

    def executable_count(self) -> Optional[int]:
        """Programs behind this serving engine (``serving.py:3878``):
        the engine's distinct ``(program, signature)`` pairs plus the
        draft model's when one rides along."""
        n = self.engine.executable_count()
        if n is None or self.spec is None:
            return n
        dn = self.spec.executable_count()
        return None if dn is None else n + dn

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
        present). Every fallible coercion runs before the first
        acquisition, and everything acquired is registered on the slot
        before anything else can fault, so a fault tears down through
        :meth:`_retire` to zero leaks."""
        ids = np.asarray(list(req.prompt) + req.tokens, np.int64)
        plen = int(ids.shape[0])
        temp = max(float(req.temperature), 1e-6)
        greedy = bool(req.greedy)
        topk = int(req.top_k) if req.top_k is not None else 0
        topp = float(req.top_p) if req.top_p is not None else 1.0
        # the request's stream: a function of (seed, id) only, so a
        # resumed request replays the draws of its first residency; a
        # RESTORED request draws from its original engine's key data
        if req._keydata is not None:
            keydata = np.asarray(req._keydata, np.uint32).reshape(2)
        else:
            keydata = request_keydata(self.seed, req.id, req.seed)
        # score: row p's logits score prompt[p+1], so the targets are the
        # prompt shifted left (the last row's draw is discarded)
        targets_row = None
        if req.kind == "score":
            targets_row = np.zeros_like(ids)
            targets_row[:-1] = ids[1:]
        nodes, hit, fresh = [], 0, []
        # a manifest covers prompt AND generated tokens, more than any
        # trie prefix could: its request skips the lookup (no phantom
        # hits, no trie refs to undo) and takes a whole fresh grant
        spill = getattr(req, "_spill", None)
        # a score request computes every position: a spliced prefix is
        # never run through the model, so it would get no logprobs
        if self._shares_prefix(req) and spill is None and \
                req.kind != "score":
            with self._phase("trie_lookup"):
                nodes, hit = self._cache.lookup(ids)
        block_snap = None
        if self.paged:
            fresh, block_snap = self._grant_prompt_blocks(req, plen, nodes,
                                                          hit)
            if fresh is None:
                return False
        free_snap = len(self._free)
        slot = self._free.pop()
        self._temps[slot] = temp
        self._greedy[slot] = greedy
        self._topk[slot] = topk
        self._topp[slot] = topp
        self._budget[slot] = req.max_new_tokens
        self._keydata[slot] = keydata
        # REGISTER first: once the slot holds the request and its held
        # nodes, a later fault tears down completely through _retire
        st = {"ids": ids, "pos": 0, "nodes": nodes, "seq": req.id}
        if targets_row is not None:
            # per-chunk device score slices, read once at completion
            st["targets"] = targets_row
            st["scores"] = []
        if req.kind == "embed":
            st["embed"] = True
        self._slots[slot] = req
        self._pf[slot] = st
        self._seq[slot] = self._adm_seq
        self._adm_seq += 1
        req.status = "running"
        resuming = req.id in self._ptimes
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
        if self.engine.adapter_ids is not None:
            # the submit-time acquire pins the slot id against eviction;
            # 0 is the identity row, the no-adapter default
            self.engine.adapter_ids[slot] = req._adapter_sid
        if req._constraint is not None:
            self._start_constraint(req, slot)
        try:
            self.metrics.count_prompt_tokens(plen)
            with self._telemetry("admit events"):
                self.telemetry.recorder.record(
                    "select_slot", rid=req.id, slot=int(slot), replica=0,
                    free_slots=[free_snap],
                    free_blocks=None if block_snap is None
                    else [block_snap], hits=None, decision=None,
                    req_kind=req.kind)
                if not resuming:
                    # the queued band starts at the request's due time
                    anchor = self._t0 if self._t0 is not None \
                        else self.clock()
                    self.telemetry.tracer.lifecycle(
                        req.id, "arrived",
                        ts=min(anchor + max(float(req.arrival_time), 0.0),
                               self.clock()))
                self.telemetry.tracer.lifecycle(
                    req.id, "resumed" if resuming else "admitted",
                    slot=slot, prompt_len=plen, prefix_hit_tokens=hit)
                self.telemetry.recorder.record(
                    "admit", rid=req.id, slot=slot, prompt_len=plen,
                    hit=hit, resumed=resuming)
                if hit:
                    self.telemetry.tracer.lifecycle(
                        req.id, "prefix_hit", tokens=hit)
            with self._phase("trie_splice"):
                self._seed_slot_storage(req, slot, st, nodes, fresh)
        except BaseException:
            # registration claimed the slot and nodes (teardown releases
            # them) and the table every PLACED fresh block; only an
            # un-placed grant has no owner yet
            if self._nblocks[slot] == 0 and fresh:
                self._alloc.deref(fresh)
                fresh.clear()
            raise
        return True

    def _shares_prefix(self, req: Request) -> bool:
        """Whether ``req``'s KV meets the prefix cache. An adapter
        request's does not: its qkv delta changes K and V, so another
        request's cached KV for the same tokens is wrong for it, and its
        own is wrong for everyone else (the reference keys the trie on
        token ids alone, ``serving.py:4025-4029`` and ``:4690-4720``)."""
        return self._cache is not None and not req._adapter_sid

    def _start_constraint(self, req: Request, slot: int):
        """A fresh grammar cursor for this residency (``serving.py:
        4240-4262``), re-walked over the committed tokens so a resumed
        request lands on the state an uninterrupted run had; the first
        mask row lands before any dispatch (a boundary build)."""
        from paddle_tpu_torch.inference.constrain import ConstraintState

        cs = ConstraintState(req._constraint)
        row = cs.mask_row()
        for t in req.tokens:
            row = cs.advance(t)
            if row is None:
                self._con_dead[slot] = True
                break
        self._constraints[slot] = cs
        if row is not None and row.any():
            self.engine.set_mask_row(slot, row)
        else:
            self._con_dead[slot] = True
            self.engine.reset_mask_row(slot)
        self.metrics.count_mask_build(self._in_mask_window)

    def _grant_prompt_blocks(self, req: Request, plen: int, nodes, hit: int):
        """The fresh blocks behind rows [hit, plen) of an admission (the
        spliced prefix brings its own) and the free count they were
        granted from. None when the pool is short: the lookup's trie
        refs are dropped and the failure is remembered against the
        allocator's free counter. A fault in here (the allocator's
        ``serving:alloc`` point included) drops the lookup's trie refs
        before propagating."""
        try:
            bs = self.engine.block_size
            need = (plen - 1) // bs + 1 - hit // bs
            if self._alloc.free_count() < need and self._cache is not None:
                # trie-held blocks are reclaimable capacity: evict cold
                # unreferenced leaves first
                self._cache.evict_for_blocks(need)
            fresh, free = None, self._alloc.free_count()
            if free >= need:
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
            with self._telemetry("admit_blocked event"):
                self.telemetry.recorder.record(
                    "admit_blocked", rid=req.id, need=need,
                    free=self._alloc.free_count())
        return fresh, free

    def _seed_slot_storage(self, req: Request, slot: int, st, nodes,
                           fresh):
        """Wire the admitted slot's storage: on the paged arena splice
        the trie hit's block ids into its table (ZERO-COPY: one
        allocator reference per block, no device work) and place the
        fresh grant, then swap a spilled request's KV back; on the dense
        arena copy the cached segments into the slot's rows. Bookkeeping
        advances a node or block at a time, so a fault at any point
        leaves a slot whose teardown reconciles to zero leaked blocks."""
        if self.paged:
            nb = 0
            try:
                if nodes:
                    cc = self._cache.chunk_tokens
                    fault_point("serving:prefix_splice", rid=req.id,
                                slot=slot)
                    for node in nodes:
                        self._alloc.ref(node.blocks)
                        self.engine.table[
                            slot, nb:nb + len(node.blocks)] = node.blocks
                        nb += len(node.blocks)
                        self._nblocks[slot] = nb
                        st["pos"] += cc
                        self.metrics.count_prefix_hit_tokens(cc)
                for off, blk in enumerate(fresh):
                    self.engine.table[slot, nb + off] = blk
                    self._nblocks[slot] = nb + off + 1
            except BaseException:
                # return the un-placed share of the grant (no other
                # holder exists for it) and truncate the list so the
                # caller's unwind cannot double-free it
                placed = int(self._nblocks[slot]) - nb
                if placed < len(fresh):
                    self._alloc.deref(fresh[placed:])
                    del fresh[placed:]
                raise
            spill = getattr(req, "_spill", None)
            if spill is not None:
                self._swap_back(req, slot, st, fresh, spill)
        elif nodes:
            # the dense arena: one slice copy a layer for every cached
            # chunk, far cheaper than the model forwards it replaces
            cc = self._cache.chunk_tokens
            fault_point("serving:prefix_copy", rid=req.id, slot=slot)
            for j, node in enumerate(nodes):
                self.engine.copy_chunk(slot, j * cc, node.kseg, node.vseg)
                st["pos"] = (j + 1) * cc
                self.metrics.count_prefix_hit_tokens(cc)

    def _admit_ready(self):
        while self._free:
            with self._lock:
                req = self.scheduler.next_due(self._now())
                if req is None:
                    break
                if self._adm_blocked is not None and \
                        self._adm_blocked == (req.id, self._alloc.freed):
                    break   # still blocked: nothing freed since the last try
                self.scheduler.pop(req)
            if req.deadline is not None and self._now() > req.deadline:
                # expired while queued (during this tick's earlier
                # admissions, say): drop it before admission spends a
                # trie walk and a block grant on it
                with self._telemetry("deadline event"):
                    self.telemetry.recorder.record(
                        "deadline_exceeded", rid=req.id, queued=True,
                        pre_admission=True)
                self._drop_queued(req, "deadline_exceeded")
                continue
            try:
                admitted = self._admit(req)
            except Exception as e:
                # per-request fault QUARANTINE: this request's admission
                # faulted (trie walk, block grant, splice, copy or
                # swap-back); retire IT and keep serving everyone else
                if not self._quar or self._cb_error:
                    if req.status != "running":
                        with self._lock:
                            self.scheduler.requeue(req)
                    raise
                self._quarantine(req, e, "admit")
                continue
            except BaseException:
                # before the slot was assigned nothing was mutated: back
                # to the front of the policy's order
                if req.status != "running":
                    with self._lock:
                        self.scheduler.requeue(req)
                raise
            if not admitted:
                with self._lock:
                    self.scheduler.requeue(req)
                break   # pool short of blocks: the head waits

    def _run_prefill_chunk(self):
        """Advance the oldest-admitted prefilling slot by one chunk; on
        the prompt's final chunk, commit its first token. A fault on
        this path is quarantined to the owning request."""
        pf = [i for i in range(self.b) if self._pf[i] is not None]
        if not pf:
            return
        with self._phase("prefill_dispatch"):
            slot = min(pf, key=lambda i: self._pf[i]["seq"])
            req = self._slots[slot]
            try:
                fault_point("serving:prefill_chunk", rid=req.id,
                            slot=slot, replica=0)
                self._prefill_turn(slot)
            except Exception as e:
                # a client callback's raise (the first token's on_token
                # runs inside _finish_prefill) stays engine-scoped
                if not self._quar or self._cb_error:
                    raise
                self._quarantine(req, e, "prefill")

    def _prefill_turn(self, slot: int):
        st = self._pf[slot]
        rid = self._slots[slot].id
        plen = len(st["ids"])
        if st["pos"] < plen:
            with self._telemetry("launch event"):
                self.telemetry.recorder.record(
                    "launch", program="chunk_prefill", rid=rid,
                    slot=slot, pos=st["pos"])
            sl = slice(slot, slot + 1)
            # the chunk's span on the request's trace lane, on the
            # tracer's clock (the engine clock)
            tracer = self.telemetry.tracer
            t_span = tracer.clock()
            pos0 = int(st["pos"])
            try:
                tok, st["pos"] = self.engine.prefill_chunk_at(
                    st["ids"], slot, st["pos"], plen, self._temps[sl],
                    self._greedy[sl], self._keydata[sl],
                    topks=self._topk[sl], topps=self._topp[sl],
                    targets_row=st.get("targets"))
            finally:
                with self._telemetry("prefill span"):
                    tracer.record_event_sink("serving:prefill_chunk", rid,
                                             t_span,
                                             tracer.clock() - t_span)
            if "scores" in st:
                # device slices stay unread until the prompt completes
                st["scores"].append((int(st["pos"]) - pos0,
                                     self.engine.last_prefill_scores))
            if st.get("embed"):
                # only the final chunk's last-row hidden state matters
                st["hidden"] = self.engine.last_prefill_hidden
            self.metrics.count_prefill_chunk()
            finite = self.engine.last_prefill_finite
            if self.logit_guard and finite is not None:
                # one host read of the draw and its finite flag
                pair = torch.cat([tok.reshape(-1),
                                  finite.reshape(-1).to(tok.dtype)]).cpu()
                if not bool(pair[1]):
                    # the chunk attended over poisoned KV (a corrupted
                    # shared prefix): retire the slot before any token
                    # reaches its stream
                    self._quarantine_nonfinite(slot)
                    return
                tok = pair[:1].reshape(1, 1)
            # only the final chunk's draw is read: a non-final chunk's
            # stays on the device unread
            st["tok"] = tok
        if st["pos"] >= plen:
            self._finish_prefill(slot)

    def _finish_prefill(self, slot: int):
        """Prompt committed: hand its new full chunks to the prefix cache
        and release the trie refs held since admission, then read its
        first token (the one host sync of the whole prefill = TTFT) and
        move the slot into the decode cohort. Re-entrant on the cache
        path: a failed insert releases every held ref and clears the
        held list, so a retry or a teardown never double-releases."""
        req = self._slots[slot]
        st = self._pf[slot]
        if self._shares_prefix(req):
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
        if req.kind != "generate":
            self._finish_batch_request(slot, req, st)
            return
        with self._phase("token_sync"):
            first = int(st["tok"][0, 0])
        self.metrics.count_prefill_token_sync()
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
            with self._telemetry("first_token event"):
                self.telemetry.tracer.lifecycle(req.id, "first_token",
                                                token=first)
        if self._constraints[slot] is not None:
            # the decode that follows dispatches under the
            # post-first-token mask (a boundary build)
            with self._phase("mask_build"):
                self._advance_constraint(slot, first)
        self._commit_token(slot, first)
        if self._slots[slot] is req and self._con_dead[slot]:
            self._retire_constraint_dead_end(slot)

    def _finish_batch_request(self, slot: int, req: Request, st):
        """A score or embed request retires ``"complete"`` at prefill
        completion (``serving.py:4724-4760``): ONE host read brings back
        every chunk's score slice and the final hidden state, and its
        sampled token is discarded unread."""
        plen = len(st["ids"])
        parts = [dev.reshape(-1)[:n] for n, dev in st.get("scores", ())
                 if n > 0]
        if st.get("embed") and st.get("hidden") is not None:
            parts.append(st["hidden"].reshape(-1).float())
        with self._phase("token_sync"):
            flat = torch.cat(parts).cpu().numpy() if parts \
                else np.zeros(0, np.float32)
        if "scores" in st:
            # row p scored prompt[p+1]; the final row's target was
            # padding: plen - 1 real scores
            req.logprobs = [float(x) for x in flat[:plen - 1]]
        if st.get("embed"):
            h = st.get("hidden")
            req.embedding = None if h is None else \
                flat[flat.shape[0] - h.numel():].astype(np.float32)
        self._pf[slot] = None
        self._adm_blocked = None
        self._retire(slot, "complete")

    def _commit_token(self, slot: int, token: int):
        req = self._slots[slot]
        req.tokens.append(int(token))
        self._rep_tokens[0] += 1
        with self._telemetry("token event"):
            self.telemetry.tracer.event(req.id, "token", tok=int(token),
                                        n=len(req.tokens))
        eos = req.eos_id if req.eos_id is not None else self.eos_id
        done_eos = eos is not None and token == eos
        done = bool(done_eos or len(req.tokens) >= self._budget[slot])
        try:
            if req.on_token is not None:
                try:
                    req.on_token(req, int(token), done)
                except BaseException:
                    # a raising CLIENT callback is engine-scoped: the
                    # streaming contract broke
                    self._cb_error = True
                    raise
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
        self._free.append(slot)
        self._release_adapter(req)
        if self.engine.adapter_ids is not None:
            # the freed lane gathers the identity row again (hygiene: an
            # idle lane's draw is discarded either way)
            self.engine.adapter_ids[slot] = 0
        self._clear_constraint(slot)
        self._release_held_nodes(slot)
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
        with self._telemetry("retire events"):
            self.telemetry.tracer.lifecycle(
                req.id, "finished", reason=reason,
                new_tokens=len(req.tokens))
            self.telemetry.recorder.record("retire", rid=req.id,
                                           reason=reason,
                                           new_tokens=len(req.tokens))
        if req.on_finish is not None:
            try:
                req.on_finish(req)
            except BaseException:
                self._cb_error = True   # client fault: engine-scoped
                raise

    def _clear_constraint(self, slot: int):
        """The slot's grammar state dies with its residency; the mask
        lane returns to the identity row (a no-op for a lane that never
        left it)."""
        if self._constraints[slot] is not None or self._con_dead[slot]:
            self._constraints[slot] = None
            self._con_dead[slot] = False
            self._con_commit[slot] = None
            self.engine.reset_mask_row(slot)

    def _advance_constraint(self, slot: int, token: int):
        """Advance ``slot``'s grammar cursor on a token being committed
        and write its next mask row into the engine's host mirror
        (``serving.py:4888-4907``). A dead end flags the slot for a
        counted retirement and parks the lane on the identity row: an
        all-zero row must never reach the sampler."""
        cs = self._constraints[slot]
        if cs is None or self._con_dead[slot]:
            return
        row = cs.advance(int(token))
        self.metrics.count_constrained_token()
        self.metrics.count_mask_build(self._in_mask_window)
        if row is None or not row.any():
            self._con_dead[slot] = True
            self.engine.reset_mask_row(slot)
        else:
            self.engine.set_mask_row(slot, row)

    def _retire_constraint_dead_end(self, slot: int):
        """The grammar has no legal continuation: retire the slot with
        the typed ``constraint_dead_end`` reason, counted."""
        req = self._slots[slot]
        self.metrics.count_constraint_dead_end()
        with self._telemetry("dead_end event"):
            self.telemetry.recorder.record(
                "constraint_dead_end", rid=req.id, slot=slot,
                new_tokens=len(req.tokens))
        self._retire(slot, "constraint_dead_end")

    def _decode_mask_work(self, toks, con, in_window: bool):
        """Advance each constrained slot's cursor on the step's host
        tokens, so the next dispatch's masks are ready before it
        (``serving.py:4920-4941``)."""
        with self._phase("mask_build"):
            self._in_mask_window = in_window
            try:
                for slot in con:
                    if self._slots[slot] is not None:
                        self._advance_constraint(slot, int(toks[slot, 0]))
            finally:
                self._in_mask_window = False
            self._mask_work_done = True

    def _spec_mask_work(self, out, acc, con, in_window: bool):
        """The speculative twin (``serving.py:4943-4977``): walk each
        constrained cursor along exactly the tokens the commit loop
        will deliver, stopping at EOS or a dead end; a dead end at
        position j clamps the commit to j + 1 tokens."""
        with self._phase("mask_build"):
            cap = min(self.spec.accept_cap, self._spec_k)
            self._in_mask_window = in_window
            try:
                for slot in con:
                    req = self._slots[slot]
                    if req is None or self._constraints[slot] is None:
                        continue
                    remaining = int(self._budget[slot]) - len(req.tokens)
                    a = min(min(int(acc[slot]), cap), remaining - 1)
                    eid = req.eos_id if req.eos_id is not None \
                        else self.eos_id
                    for j in range(a + 1):
                        t = int(out[slot, j])
                        self._advance_constraint(slot, t)
                        if self._con_dead[slot]:
                            self._con_commit[slot] = j + 1
                            break
                        if eid is not None and t == eid:
                            break   # the commit loop retires here
            finally:
                self._in_mask_window = False
            self._mask_work_done = True

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
        copy that raises (the ``serving:swap_in`` point included) falls
        back to a full re-prefill, counted: the host blocks are dropped
        and ``pos`` stays 0."""
        host_blocks = spill["host_blocks"]
        nfull = len(host_blocks)
        self._swaps_in_flight += 1
        try:
            with self._phase("swap_in"):
                self.engine.restore_blocks(host_blocks, fresh[:nfull])
        except Exception as e:
            req._spill = None
            self._host.deref(host_blocks)
            self._c_swap_fb.labels(where="swap_in").inc()
            with self._telemetry("swap_in_failed event"):
                self.telemetry.recorder.record(
                    "swap_in_failed", rid=req.id, blocks=nfull,
                    error=repr(e))
            return
        finally:
            self._swaps_in_flight -= 1
        req._spill = None
        self._host.deref(host_blocks, restored=True)
        st["pos"] = int(spill["tokens"])
        self.metrics.count_swap_in(nfull, spill["tokens"])
        with self._telemetry("swap_in event"):
            self.telemetry.tracer.event(req.id, "swap_in",
                                        tokens=int(spill["tokens"]),
                                        blocks=nfull)
            self.telemetry.recorder.record(
                "swap_in", rid=req.id, slot=slot,
                tokens=int(spill["tokens"]), blocks=nfull)

    def _spill_victim(self, slot: int, req: Request) -> bool:
        """Park the victim's committed full blocks in the host tier
        before they recycle, when they cover at least ``swap_min_tokens``
        tokens (a shorter prefix recomputes). A full tier first drops
        the prefix cache's oldest demoted nodes; a spill that raises
        (the ``serving:spill_write`` point included) falls back to
        recompute. Every verdict is counted."""
        self._release_spill(req)
        bs = self.engine.block_size
        nfull = int(self._t[slot]) // bs
        tokens = nfull * bs
        if nfull < 1 or tokens < self._swap_min:
            self._c_swap_dec.labels(choice="recompute").inc()
            return False
        blocks = self.engine.table[slot, :nfull].tolist()
        self._swaps_in_flight += 1
        try:
            with self._phase("spill"):
                host = self.engine.spill_blocks(blocks)
            if host is None and self._cache is not None and \
                    self._cache.reclaim_host_blocks(nfull):
                # a live request's work outranks a cold cached prefix
                with self._phase("spill"):
                    host = self.engine.spill_blocks(blocks)
        except Exception as e:
            self._c_swap_dec.labels(choice="fault").inc()
            self._c_swap_fb.labels(where="spill").inc()
            with self._telemetry("spill_failed event"):
                self.telemetry.recorder.record(
                    "spill_failed", rid=req.id, blocks=nfull,
                    error=repr(e))
            return False
        finally:
            self._swaps_in_flight -= 1
        if host is None:
            self._c_swap_dec.labels(choice="host_full").inc()
            return False
        req._spill = {"host_blocks": host, "tokens": tokens}
        self.metrics.count_spill(nfull)
        self._c_swap_dec.labels(choice="swap").inc()
        with self._telemetry("spill event"):
            self.telemetry.tracer.event(req.id, "spill", tokens=tokens,
                                        blocks=nfull)
            self.telemetry.recorder.record(
                "spill", rid=req.id, slot=slot, tokens=tokens,
                blocks=nfull)
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
        pool cannot grant them or the copy raises (counted; the lookup
        then misses there); it never evicts or preempts on its own."""
        dev = self._alloc.alloc(len(host_blocks))
        if dev is None:
            return None
        self._swaps_in_flight += 1
        try:
            self.engine.restore_blocks(host_blocks, dev)
        except Exception:
            self._alloc.deref(dev)
            self._c_swap_fb.labels(where="promote").inc()
            return None
        finally:
            self._swaps_in_flight -= 1
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
        # the cursor dies with the residency; re-admission re-walks the
        # committed tokens
        self._clear_constraint(slot)
        tm = self._times.pop(req.id)
        tm["preempted_at"] = self._now()
        self._ptimes[req.id] = tm
        req.status = "queued"
        self.scheduler.requeue(req)
        self._adm_blocked = None
        self.metrics.record_preemption()
        with self._telemetry("preempt events"):
            self.telemetry.tracer.lifecycle(
                req.id, "preempted", slot=slot,
                tokens_so_far=len(req.tokens))
            self.telemetry.recorder.record(
                "preempt", rid=req.id, slot=slot,
                tokens_so_far=len(req.tokens))

    def _drop_queued(self, req: Request, reason: str):
        """Retire a request that holds no slot: cancelled or
        deadline-expired while queued, or a faulted admission that never
        got one. A preempted request dropped here releases only host
        state (its blocks and trie refs recycled at preemption), plus
        any spill manifest still parking its KV in the host tier."""
        req.status = "done"
        req.finish_reason = reason
        self._release_adapter(req)
        if self._host is not None:
            self._release_spill(req)
        self._ptimes.pop(req.id, None)
        self.metrics.record_drop(req, reason)
        with self._telemetry("drop events"):
            self.telemetry.tracer.lifecycle(
                req.id, "finished", reason=reason,
                new_tokens=len(req.tokens))
            self.telemetry.recorder.record("retire", rid=req.id,
                                           reason=reason, queued=True)
        if req.on_finish is not None:
            try:
                req.on_finish(req)
            except BaseException:
                self._cb_error = True   # client fault: engine-scoped
                raise

    def _quarantine(self, req: Request, exc: BaseException, where: str):
        """Retire exactly ONE faulted request with
        ``finish_reason="error"`` (``serving.py:5248``): a request that
        owns a slot tears down through :meth:`_retire` (slot, blocks and
        trie pins released, ``on_finish`` fired); one that never got a
        slot drops like a queued request. The fault is counted, lands in
        the flight ring and on the request's trace lane, and an
        :meth:`audit` reconciles the pools."""
        self._c_req_err.labels(where=where).inc()
        # the quarantine's own telemetry is best-effort: an unhealthy
        # recorder must not turn a request fault into an engine fault
        try:
            self.telemetry.recorder.record(
                "request_error", rid=req.id, where=where,
                error=repr(exc))
            self.telemetry.tracer.event(req.id, "request_error",
                                        where=where, error=repr(exc))
        except Exception as rec_err:
            self._warn_dump_failed("request_error event", rec_err)
        slot = next((i for i, r in enumerate(self._slots) if r is req),
                    None)
        if slot is not None:
            self._retire(slot, "error")
        elif req.status != "done":
            self._drop_queued(req, "error")
        try:
            self.audit()
        except Exception as rec_err:
            self._warn_dump_failed("post-quarantine audit", rec_err)

    def audit(self, record: bool = True) -> Dict[str, int]:
        """State reconciliation (``serving.py:5283``): the block pool's
        refcounts, the host tier's, the trie's pins and the slot table
        against what the scheduler can account for, published as the
        ``serving_leaked_blocks``, ``serving_orphaned_pins``,
        ``serving_leaked_host_blocks`` and ``serving_leaked_adapters``
        gauges. Pure read.

        A block's holders are the live slots whose table maps it (one
        reference a mapped entry) plus each trie node listing it; a trie
        node's pins are the prefilling slots holding it since admission;
        a host block's holders are the spill manifests of queued and
        live requests plus demoted trie nodes."""
        report = {"leaked_blocks": 0, "missing_refs": 0,
                  "free_list_errors": 0, "orphaned_pins": 0,
                  "slot_errors": 0, "leaked_host_blocks": 0,
                  "missing_host_refs": 0, "host_free_list_errors": 0,
                  "leaked_adapters": 0, "missing_adapter_refs": 0,
                  "adapter_free_list_errors": 0}
        # occupied and free must partition [0, b), and a prefill record
        # needs a live owner
        occupied = {i for i, r in enumerate(self._slots) if r is not None}
        free = set(self._free)
        report["slot_errors"] = (
            len(occupied & free) + (self.b - len(occupied | free))
            + sum(1 for i in range(self.b)
                  if self._pf[i] is not None and self._slots[i] is None))
        held: Dict[int, int] = {}
        for i in occupied:
            if self._pf[i] is not None:
                for nd in self._pf[i]["nodes"]:
                    held[id(nd)] = held.get(id(nd), 0) + 1
        expected: Dict[int, int] = {}
        host_expected: Dict[int, int] = {}
        if self._cache is not None:
            # ONE trie walk: the pins, the nodes' device blocks and a
            # demoted node's parked host blocks
            for nd in self._cache.iter_nodes():
                extra = nd.refs - held.get(id(nd), 0)
                if extra > 0:
                    report["orphaned_pins"] += extra
                for b in nd.blocks or ():
                    expected[int(b)] = expected.get(int(b), 0) + 1
                for b in getattr(nd, "host_blocks", None) or ():
                    host_expected[int(b)] = host_expected.get(int(b), 0) + 1
        if self.paged:
            for i in occupied:
                for b in self.engine.table[i, :self._nblocks[i]]:
                    expected[int(b)] = expected.get(int(b), 0) + 1
            report.update(self._alloc.reconcile(expected))
        if self._host is not None:
            with self._lock:
                pending = list(self.scheduler.pending())
            for r in pending + [r for r in self._slots if r is not None]:
                sp = getattr(r, "_spill", None)
                for b in (sp or {}).get("host_blocks", ()):
                    host_expected[int(b)] = host_expected.get(int(b), 0) + 1
            report.update(self._host.reconcile(host_expected))
        if self.adapter_pool is not None:
            # a slot reference's holders are the requests carrying its
            # sid: live slots AND the queue (submit acquires before
            # admission, and a preempted request keeps its reference)
            ad_expected: Dict[int, int] = {}
            with self._lock:
                pending = list(self.scheduler.pending())
            for r in pending + [r for r in self._slots if r is not None]:
                if r._adapter_sid:
                    ad_expected[r._adapter_sid] = \
                        ad_expected.get(r._adapter_sid, 0) + 1
            report.update(self.adapter_pool.reconcile(ad_expected))
        self._g_leaked.set(report["leaked_blocks"])
        self._g_orphaned.set(report["orphaned_pins"])
        self._g_leaked_host.set(report["leaked_host_blocks"])
        self._g_leaked_adapters.set(report["leaked_adapters"])
        if record:
            self.telemetry.recorder.record("audit", **report)
        return report

    # -- ops-plane accessors: read-only load and health state ---------------
    def free_slot_count(self) -> int:
        return len(self._free)

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

    def _req_tier(self, req: Request) -> int:
        """The tier the scheduler would place ``req`` in: the policy's
        own mapping when it has one (FairScheduler's priority override
        and tenant tiers), else priority with a 0 default."""
        tier_of = getattr(self.scheduler, "_tier", None)
        if tier_of is not None:
            return int(tier_of(req))
        p = getattr(req, "priority", None)
        return int(p) if p is not None else 0

    def queue_depth_by_tier(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        with self._lock:
            pending = list(self.scheduler.pending())
        for r in pending:
            t = self._req_tier(r)
            out[t] = out.get(t, 0) + 1
        return out

    def breaker_state(self) -> Dict[str, Any]:
        """Circuit-breaker state: ``open`` is True from a trip until the
        next :meth:`run` call (the operator's restart)."""
        return {"open": self._breaker_open,
                "failures": self._engine_failures,
                "threshold": self._breaker_threshold}

    def audit_state(self) -> Dict[str, int]:
        """The LAST audit's leak gauges, what ``/readyz`` reads without
        paying a fresh reconciliation per probe."""
        return {"leaked_blocks": int(self._g_leaked.value),
                "orphaned_pins": int(self._g_orphaned.value),
                "leaked_host_blocks": int(self._g_leaked_host.value),
                "leaked_adapters": int(self._g_leaked_adapters.value)}

    def dispatch_stalled(self) -> int:
        """Dispatches CURRENTLY past the stall watchdog, across every
        ProgramSet this engine drives (the drafter's included)."""
        return sum(ps.stalls_in_progress for ps in self._program_sets())

    def publish_load_gauges(self) -> None:
        """Refresh the scrape-time load gauges (``serving.py:5483``):
        read-only snapshots the ops plane takes per ``/metrics``
        scrape, so the tick loop never pays for them."""
        self._g_free_slots.set(self.free_slot_count())
        fb = self.free_block_count()
        self._g_free_blocks.set(-1.0 if fb is None else float(fb))
        depth = self.queue_depth_by_tier()
        for t in self._tiers_seen - set(depth):
            self._g_tier_depth.labels(tier=str(t)).set(0.0)
        for t, n in depth.items():
            self._tiers_seen.add(t)
            self._g_tier_depth.labels(tier=str(t)).set(float(n))
        m = self.metrics
        steps = len(m.step_samples)
        self._g_overlap_frac.set(m.overlap_ticks / steps if steps else 0.0)
        self._g_breaker_open.set(1.0 if self._breaker_open else 0.0)
        self._g_stalled.set(float(self.dispatch_stalled()))
        self._g_host_blocks.set(
            -1.0 if self._host is None
            else float(self._host.blocks_in_use()))
        self._g_swap_inflight.set(float(self._swaps_in_flight))
        self._g_prefill_backlog.set(float(self.prefill_backlog_tokens()))
        util = self.replica_utilization()
        self._g_rep_util.labels(replica="0").set(util["utilization"][0])
        self._g_rep_tpt.labels(replica="0").set(util["tokens_per_tick"][0])
        self._g_skew.set(util["skew"])
        if self._g_pfx_hit_rate is not None:
            cache = self._cache
            lk = cache.lookups
            self._g_pfx_hit_rate.labels(replica="0").set(
                cache.hits / lk if lk else 0.0)
            self._g_pfx_bytes.labels(replica="0").set(float(cache.bytes))
            self._g_pfx_hit_tokens.labels(replica="0").set(
                float(cache.hit_tokens))
        self._publish_adapter_gauges()

    def debug_requests(self) -> Dict[str, Any]:
        """The live slot and queue table plus the reconciliation report
        (``/debug/requests``), built from the enumeration :meth:`audit`
        reconciles, with ``record=False`` so a scrape never lands an
        event in the flight ring."""
        with self._lock:
            slots = []
            for i, r in enumerate(self._slots):
                if r is None:
                    slots.append(None)
                    continue
                row = {"slot": i, "id": r.id, "tenant": r.tenant,
                       "status": ("prefilling" if self._pf[i] is not None
                                  else "decoding"),
                       "prompt_len": len(r.prompt),
                       "new_tokens": len(r.tokens),
                       "offset": int(self._t[i]),
                       "budget": int(self._budget[i]),
                       "finish_reason": r.finish_reason}
                if self.paged:
                    row["blocks"] = int(self._nblocks[i])
                slots.append(row)
            queue = [{"id": r.id, "tenant": r.tenant,
                      "tier": self._req_tier(r),
                      "prompt_len": len(r.prompt),
                      "arrival_time": r.arrival_time,
                      "deadline": r.deadline}
                     for r in self.scheduler.pending()]
            report = self.audit(record=False)
        return {"slots": slots, "queue": queue, "audit": report,
                "free_slots": len(self._free),
                "free_blocks": self.free_block_count(),
                "host_tier": self.host_tier_state(),
                "breaker": self.breaker_state()}

    def poison_slot_kv(self, slot: int):
        """Chaos/testing delegate (``serving.py:5604``): corrupt one live
        slot's committed KV (:meth:`DecodeEngine.poison_slot_kv`), the
        trigger of the ``serving:tick`` point's
        :func:`~paddle_tpu_torch.testing.fault_injection.nan_kv`."""
        self.engine.poison_slot_kv(slot)

    # -- tick-boundary jobs -------------------------------------------------
    def boundary_jobs_pending(self) -> bool:
        """True while jobs wait for the next tick boundary — part of the
        FrontDoor pump's wake predicate, so a parked pump serves a
        migrate-in or -out without waiting for traffic."""
        with self._lock:
            return bool(self._boundary_jobs)

    def at_tick_boundary(self, fn, timeout: float = 30.0):
        """Run ``fn()`` at the engine's next iteration-level boundary and
        return its result (``serving.py:5620``): the job queues under
        the lock, the tick loop drains it before the next
        admit/prefill/step, and THIS thread blocks until it ran. On an
        idle engine (no ``run()`` in flight) it runs inline under the
        tick gate instead. ``fn``'s raise is re-raised here, never in
        the tick loop; ``TimeoutError`` means no boundary came within
        ``timeout`` seconds (a wedged or dead pump)."""
        done = threading.Event()
        box: Dict[str, Any] = {}
        job = (fn, box, done)
        with self._lock:
            self._boundary_jobs.append(job)
        self._wake_up()
        if not self._running:
            # the pop under _lock makes this race-free against a run()
            # starting concurrently: whichever drainer pops the job runs
            # it exactly once
            with self._tick_gate:
                self._run_boundary_jobs()
        if not done.wait(timeout):
            with self._lock:
                if job in self._boundary_jobs:
                    # never ran: un-queue it, so a late boundary does
                    # not run a job whose caller gave up
                    self._boundary_jobs.remove(job)
                    raise TimeoutError(
                        f"no tick boundary within {timeout}s (engine "
                        "pump wedged or dead)")
            # popped but unfinished: mid-execution, wait it out
            if not done.wait(timeout):
                raise TimeoutError(
                    f"tick-boundary job still running after "
                    f"{2 * timeout}s")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def _run_boundary_jobs(self):
        """Drain queued boundary jobs. A job's raise is DELIVERED to its
        waiter, never propagated into the tick: a failed migration must
        not trip the breaker."""
        while True:
            with self._lock:
                if not self._boundary_jobs:
                    return
                fn, box, done = self._boundary_jobs.pop(0)
            try:
                box["result"] = fn()
            except BaseException as e:  # delivered, not propagated
                box["error"] = e
            finally:
                done.set()

    # -- live-request snapshot and restore ----------------------------------
    def snapshot_request(self, rid: int, path: str,
                         version: Optional[int] = None,
                         keep_last: int = 3) -> int:
        """Serialize one LIVE request (``serving.py:5679``): tokens,
        sampling parameters, key data and its committed full-block KV,
        through :mod:`paddle_tpu_torch.distributed.checkpoint`
        (sha256-checksummed shards, crash-safe commit, keep-last
        retention), in the reference's on-disk format. A restored
        request (:meth:`restore_request`, on any engine with the same
        model, weights and block geometry) continues TOKEN-EXACT. Call
        between ticks (from another thread, :meth:`at_tick_boundary` is
        that boundary). ``path`` may also be a writable file object: the
        snapshot then lands as the :meth:`snapshot_request_bytes` frame.
        Returns the committed version."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt

        state, extra, req = self._snapshot_capture(rid)
        if version is None:
            version = len(req.tokens)
        if not isinstance(path, (str, bytes)) and hasattr(path, "write"):
            path.write(self._frame_snapshot(state, extra))
        else:
            ckpt.save_state(state, path, extra=extra, version=int(version),
                            keep_last=int(keep_last))
        self._note_snapshot(rid, int(version), extra)
        return int(version)

    def _snapshot_capture(self, rid: int):
        """One live request's restorable state as ``(arrays, extra,
        request)``: the KV of its committed full blocks (host copies in
        the reference's ``(n, L, bs, H, D)`` layout) and the metadata a
        peer rebuilds the request from."""
        if not self.paged:
            raise RuntimeError(
                "snapshot_request captures paged pool blocks; the "
                "dense arena has no block enumeration to serialize")
        slot = next((i for i, r in enumerate(self._slots)
                     if r is not None and r.id == rid), None)
        if slot is None:
            raise ValueError(f"request {rid} holds no slot (snapshot "
                             "covers LIVE requests; queued ones are "
                             "already plain host state)")
        if self._pf[slot] is not None:
            raise RuntimeError(
                f"request {rid} is still prefilling — its KV frontier "
                "is mid-chunk; snapshot after its first token")
        req = self._slots[slot]
        rf = req.response_format
        if rf is not None and not isinstance(rf, dict):
            raise ValueError(
                f"request {rid} is constrained by a "
                f"{type(rf).__name__} object, which a snapshot cannot "
                "carry; submit its response_format as the wire dict")
        bs = self.engine.block_size
        nfull = int(self._t[slot]) // bs
        blocks = self.engine.table[slot, :nfull].tolist()
        kseg, vseg, ks, vs = self.engine.gather_blocks_to_host(blocks)
        state = {"kv_k": kseg, "kv_v": vseg}
        if self.quantized:
            state["kv_kscale"] = ks
            state["kv_vscale"] = vs
        extra = {
            "kind": "paddle_tpu.request_snapshot.v1",
            "rid": int(rid), "tenant": req.tenant,
            "prompt": [int(x) for x in req.prompt],
            "tokens": [int(x) for x in req.tokens],
            "max_new_tokens": int(req.max_new_tokens),
            "temperature": float(req.temperature),
            "greedy": bool(req.greedy),
            "top_k": int(req.top_k) if req.top_k is not None else None,
            "top_p": float(req.top_p) if req.top_p is not None else None,
            "eos_id": req.eos_id if req.eos_id is not None
            else self.eos_id,
            "keydata": [int(x) for x in
                        np.asarray(self._keydata[slot]).ravel()],
            "tokens_covered": nfull * bs,
            "block_size": bs, "quantized": bool(self.quantized),
            "layers": self.engine.L, "heads": self.engine.heads,
            "head_dim": self.engine.head_dim,
            # the reference drops these two (serving.py:5748-5766), so
            # its restore serves the base model with no grammar
            "adapter": req.adapter, "response_format": rf,
        }
        return state, extra, req

    def _note_snapshot(self, rid: int, version: int, extra: Dict):
        nfull = int(extra["tokens_covered"]) // int(extra["block_size"])
        self._c_snapshots.inc()
        with self._telemetry("snapshot events"):
            self.telemetry.tracer.event(rid, "snapshot",
                                        version=int(version), blocks=nfull)
            self.telemetry.recorder.record(
                "snapshot", rid=rid, version=int(version), blocks=nfull,
                tokens_covered=int(extra["tokens_covered"]))
        return int(version)

    def snapshot_request_bytes(self, rid: int) -> bytes:
        """:meth:`snapshot_request` into one self-verifying byte frame
        (``serving.py:5781``): magic + length-prefixed JSON header (the
        snapshot's metadata and the payload's sha256) + an npz payload of
        the KV arrays. The fleet's transport: it restores on a peer
        through :meth:`restore_request`, and a corrupt payload degrades
        to metadata-only recovery and a re-prefill, counted."""
        state, extra, req = self._snapshot_capture(rid)
        frame = self._frame_snapshot(state, extra)
        self._note_snapshot(rid, len(req.tokens), extra)
        return frame

    @staticmethod
    def _frame_snapshot(state: Dict[str, Any], extra: Dict) -> bytes:
        import hashlib
        import io
        import json as _json

        from paddle_tpu_torch.distributed.checkpoint import _to_host

        # bf16 rides as raw 2-byte elements ('<V2'), as numpy stores it
        bio = io.BytesIO()
        np.savez(bio, **{k: _to_host(v)[0] for k, v in state.items()})
        payload = bio.getvalue()
        header = _json.dumps({
            "extra": extra,
            "payload_sha256": hashlib.sha256(payload).hexdigest(),
            "payload_len": len(payload),
        }).encode("utf-8")
        return (_SNAP_MAGIC + len(header).to_bytes(8, "little")
                + header + payload)

    @staticmethod
    def _parse_snapshot_frame(data: bytes):
        """Decode a :meth:`snapshot_request_bytes` frame into
        ``(arrays_or_None, extra, corrupt_reason_or_None)``. A bad magic
        or header is a ``ValueError`` (nothing recoverable); a payload
        that fails its sha256 or does not load as npz returns
        ``arrays=None`` with the reason."""
        import hashlib
        import io
        import json as _json

        data = bytes(data)
        if len(data) < 16 or data[:8] != _SNAP_MAGIC:
            raise ValueError(
                "not a request-snapshot byte frame (bad magic); "
                "expected the snapshot_request_bytes format")
        hlen = int.from_bytes(data[8:16], "little")
        if 16 + hlen > len(data):
            raise ValueError(
                "request-snapshot frame truncated inside its header")
        try:
            header = _json.loads(data[16:16 + hlen].decode("utf-8"))
        except (UnicodeDecodeError, _json.JSONDecodeError) as e:
            raise ValueError(
                f"request-snapshot frame header is not JSON ({e})")
        extra = header.get("extra", {})
        payload = data[16 + hlen:]
        if (len(payload) != header.get("payload_len")
                or hashlib.sha256(payload).hexdigest()
                != header.get("payload_sha256")):
            return None, extra, "payload failed its sha256 check"
        try:
            with np.load(io.BytesIO(payload)) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception as e:
            return None, extra, f"payload did not load as npz ({e!r})"
        return arrays, extra, None

    @staticmethod
    def _host_tensor(a) -> torch.Tensor:
        """A snapshot array as a CPU tensor: numpy's raw 2-byte
        elements ('<V2', how either package stores bf16) read back
        through int16."""
        if isinstance(a, torch.Tensor):
            return a.cpu()
        a = np.asarray(a)
        if a.dtype.kind == "V" and a.dtype.itemsize == 2:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.ascontiguousarray(a))

    def restore_request(self, source, **overrides) -> Request:
        """Re-enqueue a snapshotted request on THIS engine
        (``serving.py:5910``). ``source`` is a checkpoint directory
        (str), a :meth:`snapshot_request_bytes` frame
        (bytes/bytearray/memoryview) or a readable file object holding
        one. Corrupt data falls back to the metadata (the commit's
        ``meta.json`` or the frame header) and a full re-prefill, counted
        ``corrupt_fallback``; with a clean read and a host tier the KV
        parks in the tier and admission splices it back like a preempted
        request's spill (``swap_in``); else it re-prefills
        (``reprefill``). The continuation is token-exact by the
        snapshot's key data. An adapter request re-acquires its adapter
        here (it must be registered on this engine), and a constrained
        one recompiles its grammar, which admission re-walks over the
        committed tokens. ``overrides`` patch Request fields (a new
        ``on_token``, say). Call between ticks (from another thread,
        :meth:`at_tick_boundary` is that boundary)."""
        import warnings

        from paddle_tpu_torch.distributed import checkpoint as ckpt
        from paddle_tpu_torch.distributed.resilience import \
            TransientFailureWarning

        if not self.paged:
            raise RuntimeError(
                "restore_request needs the paged arena (the snapshot "
                "manifest is block-shaped)")
        if hasattr(source, "read"):
            source = source.read()
        if isinstance(source, (bytes, bytearray, memoryview)):
            src_label = "<snapshot frame>"
            arrays, extra, corrupt = self._parse_snapshot_frame(source)
            if corrupt is not None:
                warnings.warn(TransientFailureWarning(
                    f"request-snapshot frame failed integrity check "
                    f"({corrupt}); restoring from its header metadata "
                    "with a full re-prefill"), stacklevel=2)
        else:
            src_label = str(source)
            arrays = None
            try:
                arrays, extra = ckpt.load_state(source, verify=True,
                                                device="cpu")
            except ckpt.CheckpointCorruptError as e:
                # the shard data is gone, but the commit's metadata is a
                # file of its own: recover the REQUEST and re-prefill
                extra = ckpt.load_meta(source).get("extra", {})
                warnings.warn(TransientFailureWarning(
                    f"request snapshot failed integrity check ({e}); "
                    "restoring from metadata with a full re-prefill"),
                    stacklevel=2)
        if extra.get("kind") != "paddle_tpu.request_snapshot.v1":
            raise ValueError(
                f"{src_label} is not a request snapshot (kind="
                f"{extra.get('kind')!r})")
        if arrays is not None and \
                int(extra["block_size"]) != self.engine.block_size:
            raise ValueError(
                f"snapshot block_size {extra['block_size']} != this "
                f"engine's {self.engine.block_size} — KV blocks do "
                "not remap across geometries; re-prefill instead "
                "(restore on a matching engine, or strip the shards)")
        if arrays is not None and \
                bool(extra["quantized"]) != bool(self.quantized):
            raise ValueError(
                "snapshot and engine disagree on kv_dtype — int8 "
                "codes only splice into an int8 pool")
        eng = self.engine
        geo = (extra.get("layers", eng.L), extra.get("heads", eng.heads),
               extra.get("head_dim", eng.head_dim))
        if arrays is not None and \
                geo != (eng.L, eng.heads, eng.head_dim):
            raise ValueError(
                f"snapshot KV geometry (L, H, D) = {geo} does not "
                f"match this engine's ({eng.L}, {eng.heads}, "
                f"{eng.head_dim}) — snapshots restore onto the SAME "
                "model architecture")
        prompt = list(extra["prompt"])
        tokens = list(extra["tokens"])
        if len(prompt) + len(tokens) > self._plen_max:
            raise ValueError(
                f"snapshot context of {len(prompt) + len(tokens)} "
                f"tokens exceeds this engine's {self._plen_max}-token "
                "admission budget")
        req = Request(
            prompt=prompt,
            max_new_tokens=int(extra["max_new_tokens"]),
            temperature=float(extra["temperature"]),
            greedy=bool(extra["greedy"]),
            top_k=extra.get("top_k"), top_p=extra.get("top_p"),
            eos_id=extra.get("eos_id"),
            tenant=extra.get("tenant", "default"),
            adapter=extra.get("adapter"),
            response_format=extra.get("response_format"))
        for k, v in overrides.items():
            setattr(req, k, v)
        # the continuation state goes on BEFORE submit(): once the
        # scheduler sees the request, the tick loop may admit it
        req.tokens = tokens
        req._keydata = [int(x) for x in extra["keydata"]]
        outcome = "reprefill"
        covered = int(extra.get("tokens_covered", 0))
        if arrays is None:
            outcome = "corrupt_fallback"
        elif covered and self._host is not None:
            # no trie reclaim here: a short tier degrades to re-prefill
            nblocks = covered // self.engine.block_size
            host = self._host.alloc(nblocks)
            if host is not None:
                try:
                    ht = self._host_tensor
                    self._host.write(
                        host, ht(arrays["kv_k"]).to(self._host.dtype),
                        ht(arrays["kv_v"]).to(self._host.dtype),
                        ht(arrays["kv_kscale"]) if self.quantized
                        else None,
                        ht(arrays["kv_vscale"]) if self.quantized
                        else None)
                except Exception as e:
                    # a faulted park must neither crash the restore nor
                    # strand the grant: only the copy saving is lost
                    self._host.deref(host, aborted=True)
                    self._c_swap_fb.labels(where="restore").inc()
                    with self._telemetry("restore_park_failed event"):
                        self.telemetry.recorder.record(
                            "restore_park_failed", blocks=nblocks,
                            error=repr(e))
                else:
                    req._spill = {"host_blocks": host, "tokens": covered}
                    outcome = "swap_in"
        self._c_restores.labels(outcome=outcome).inc()
        # the fleet's migrate-in reports how the KV landed
        req._restore_outcome = outcome
        try:
            self.submit(req)
        except BaseException:
            # a refused submission must not strand the KV it parked
            if self._host is not None:
                self._release_spill(req)
            raise
        with self._telemetry("restore events"):
            self.telemetry.recorder.record(
                "restore", rid=req.id, outcome=outcome,
                tokens_covered=covered if outcome == "swap_in" else 0,
                prior_tokens=len(tokens))
        return req

    def migrate_out_request(self, rid: int) -> bytes:
        """Snapshot one LIVE request to a byte frame and retire it
        (``finish_reason="migrated"``) in one step (``serving.py:6012``):
        the fleet router's drain and rebalance primitive. The source's
        blocks free at the retire, so ``audit()`` reconciles to zero the
        moment the frame is in hand. From another thread, run it through
        ``engine.at_tick_boundary(lambda: engine.migrate_out_request(
        rid))``."""
        frame = self.snapshot_request_bytes(rid)
        slot = next((i for i, r in enumerate(self._slots)
                     if r is not None and r.id == rid), None)
        self._retire(slot, "migrated")
        self._c_migrations.inc()
        with self._telemetry("migrate_out event"):
            self.telemetry.recorder.record(
                "migrate_out", rid=rid, frame_bytes=len(frame))
        return frame

    def _process_cancellations(self):
        """Apply cancel() flags at the tick boundary, so a cross-thread
        cancel never races a dispatch."""
        with self._lock:
            if not self._cancels:
                return
            pending, self._cancels = self._cancels, []
        for req in pending:
            if req.status == "done":
                continue        # retired normally before we got here
            if req.status == "queued":
                # remove() scans; a cross-thread submit() into the same
                # queue must not race it
                with self._lock:
                    removed = self.scheduler.remove(req)
                if removed:
                    self._drop_queued(req, "cancelled")
                continue
            slot = next((i for i, r in enumerate(self._slots)
                         if r is req), None)
            if slot is not None:
                self._retire(slot, "cancelled")

    def _expire_deadlines(self):
        """Retire everything past its deadline: queued requests drop
        without admission, running ones retire mid-flight, freeing
        blocks for requests that can still meet theirs."""
        now = self._now()
        with self._lock:
            expired = self.scheduler.pop_expired(now)
        for req in expired:
            with self._telemetry("deadline event"):
                self.telemetry.recorder.record("deadline_exceeded",
                                               rid=req.id, queued=True)
            self._drop_queued(req, "deadline_exceeded")
        for slot, r in enumerate(self._slots):
            if r is not None and r.deadline is not None \
                    and now > r.deadline:
                with self._telemetry("deadline event"):
                    self.telemetry.recorder.record(
                        "deadline_exceeded", rid=r.id,
                        tokens_so_far=len(r.tokens))
                self._retire(slot, "deadline_exceeded")

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

    def _backlog(self, now: float) -> int:
        return self.scheduler.due_count(now)

    def step_decode(self):
        """One tick: one prefill chunk (oldest-admitted prefilling slot)
        plus one lockstep decode step committing a token to every live
        slot past prefill. A slot whose prompt completed this very tick
        joins the decode half immediately."""
        # chaos hook: crash mid-tick, or storage corruption (nan_kv)
        self._ticks_total += 1
        fault_point("serving:tick", engine=self, step=self._ticks_total)
        with self._phase("bookkeeping"):
            self.scheduler.on_tick(self._now())
            occupied = self.active_count()
            self._rep_ticks += 1
            self._rep_busy[0] += occupied
            if occupied:
                self.metrics.record_tick(
                    occupied, self._backlog(self._now()),
                    blocks=self._alloc.blocks_in_use() if self.paged
                    else None)
        self._run_prefill_chunk()
        if self.paged:
            with self._phase("block_growth"):
                self._ensure_decode_blocks(self._spec_k + 1)
        with self._phase("bookkeeping"):
            live = [i for i, r in enumerate(self._slots)
                    if r is not None and self._pf[i] is None]
        if not live:
            return
        if self.spec is not None:
            return self._step_speculative(live)
        with self._phase("bookkeeping"):
            with self._telemetry("launch event"):
                self.telemetry.recorder.record(
                    "launch", program="decode_step", live=len(live))
        con = [i for i in live if self._constraints[i] is not None]
        t0 = time.perf_counter()
        with self._phase("decode_dispatch"):
            tok, fin = self.engine.step(self._toks, self._t, self._temps,
                                        self._greedy, self._keydata,
                                        topks=self._topk, topps=self._topp,
                                        defer=True)
        read: Dict[str, np.ndarray] = {}

        def mask_work():
            # the tick's one token read, moved into the window: the next
            # dispatch's masks are built while the host would wait anyway
            read["toks"] = self._read_tokens(tok)
            self._decode_mask_work(read["toks"], con, True)

        self._mask_work_done = False
        self._overlap_window(fin, mask_work=mask_work if con else None)
        with self._phase("token_sync"):
            toks = read["toks"] if "toks" in read \
                else self._read_tokens(tok)
        if con and not self._mask_work_done:
            # overlap off (or the window skipped): the automaton work
            # serializes at the boundary, counted
            self.metrics.count_mask_fallback_sync()
            self._decode_mask_work(toks, con, False)
        with self._phase("bookkeeping"):
            self.metrics.record_step(len(live), self._backlog(self._now()),
                                     seconds=time.perf_counter() - t0)
            finite = self._finite_mask()
        with self._phase("callbacks"):
            for slot in live:
                if finite is not None and not finite[slot]:
                    self._quarantine_nonfinite(slot)
                    continue
                # per-SLOT state commit: if a later slot's commit raises
                # and the breaker absorbs the tick, the untouched slots
                # still hold their last committed token and offset
                self._t[slot] += 1
                self._toks[slot, 0] = int(toks[slot, 0])
                self._commit_token(slot, int(toks[slot, 0]))
                if self._slots[slot] is not None and self._con_dead[slot]:
                    # the committed token was legal, but the grammar has
                    # no continuation: a typed retirement
                    self._retire_constraint_dead_end(slot)

    def _read_tokens(self, tok) -> np.ndarray:
        """The step's tokens on the host; with the logit guard, its
        finite mask rides the same device-to-host copy."""
        finite = self.engine.last_step_finite
        if not self.logit_guard or finite is None:
            self._finite_host = None
            return tok.cpu().numpy()
        res = torch.cat([tok, finite[:, None].to(tok.dtype)], dim=1).cpu()
        self._finite_host = res[:, -1].numpy().astype(bool)
        return res[:, :-1].numpy()

    def _step_speculative(self, live):
        """One draft-and-verify tick (``serving.py:6233``): drafts from
        the slots' contexts, one verify over all slots, the next tick's
        admissions while the card computes, one read of ``out``,
        ``accept`` (and the finite mask), then every live slot commits
        between 1 and ``accept_cap + 1`` tokens — a host decision, never
        a shape. A constrained slot's verify runs under per-position
        masks from a non-mutating walk of its cursor along its draft;
        the authoritative cursor advances only along what commits."""
        with self._phase("bookkeeping"):
            ctxs: List[Optional[List[int]]] = [None] * self.b
            for i in live:
                r = self._slots[i]
                ctxs[i] = list(r.prompt) + r.tokens
        with self._phase("draft"):
            drafts = self.spec.propose(ctxs, self._toks[:, 0], self._t)
        con = [i for i in live if self._constraints[i] is not None]
        if con:
            with self._phase("mask_build"):
                dr = np.asarray(drafts)
                for slot in con:
                    self.engine.set_verify_mask_rows(
                        slot, self._constraints[slot].draft_masks(
                            dr[slot], dr.shape[1]))
        with self._phase("bookkeeping"):
            with self._telemetry("launch event"):
                self.telemetry.recorder.record(
                    "launch", program="verify", live=len(live))
        t0 = time.perf_counter()
        with self._phase("decode_dispatch"):
            out_d, acc_d, fin = self.engine.verify(
                self._toks, drafts, self._t, self._temps, self._greedy,
                self._keydata, topks=self._topk, topps=self._topp,
                defer=True)
        read: Dict[str, np.ndarray] = {}

        def read_verify():
            # one host read of out, accept and the finite mask
            cols = [out_d, acc_d[:, None].to(out_d.dtype)]
            finite = self.engine.last_step_finite
            if self.logit_guard and finite is not None:
                cols.append(finite[:, None].to(out_d.dtype))
            res = torch.cat(cols, dim=1).cpu().numpy()
            k1 = out_d.shape[1]
            read["out"], read["acc"] = res[:, :k1], res[:, k1]
            self._finite_host = res[:, k1 + 1].astype(bool) \
                if len(cols) == 3 else None

        def mask_work():
            read_verify()
            self._spec_mask_work(read["out"], read["acc"], con, True)

        self._mask_work_done = False
        self._overlap_window(fin, mask_work=mask_work if con else None)
        with self._phase("token_sync"):
            if "out" not in read:
                read_verify()
            out, acc = read["out"], read["acc"]
        if con and not self._mask_work_done:
            self.metrics.count_mask_fallback_sync()
            self._spec_mask_work(out, acc, con, False)
        with self._phase("bookkeeping"):
            seconds = time.perf_counter() - t0
            backlog = self._backlog(self._now())
            cap = min(self.spec.accept_cap, self._spec_k)
            accepted_total = committed_total = 0
            finite = self._finite_mask()
        with self._phase("callbacks"):
            for slot in live:
                if finite is not None and not finite[slot]:
                    self._quarantine_nonfinite(slot)
                    continue
                req = self._slots[slot]
                # never outrun the admitted budget; accepted counts what
                # the verify accepted (clamped by the drafter's cap
                # only), committed what was delivered
                remaining = int(self._budget[slot]) - len(req.tokens)
                va = min(int(acc[slot]), cap)
                a = min(va, remaining - 1)
                cc = self._con_commit[slot]
                if cc is not None:
                    # a grammar dead end at position cc - 1: tokens past
                    # it were verified under draft-path masks that no
                    # longer bind
                    a = min(a, cc - 1)
                    self._con_commit[slot] = None
                accepted_total += va
                # offset and pending token advance with each append
                for j in range(a + 1):
                    self._t[slot] += 1
                    self._toks[slot, 0] = int(out[slot, j])
                    self._commit_token(slot, int(out[slot, j]))
                    committed_total += 1
                    if self._slots[slot] is None:
                        break   # EOS inside the accepted prefix
                if self._slots[slot] is not None and self._con_dead[slot]:
                    self._retire_constraint_dead_end(slot)
        with self._phase("bookkeeping"):
            self.metrics.record_step(len(live), backlog, accepted_total,
                                     committed_total, seconds=seconds)

    def _overlap_window(self, fin, mask_work=None):
        """The tick's host/device overlap window (``serving.py:6476``),
        between the decode or verify DISPATCH and its token read: the
        next tick's admissions run while the step is in flight, then
        ``mask_work`` (the constrained slots' next masks, whose token
        read is the tick's sync), then the dispatch window closes
        (``fin``). A skipped window leaves the mask work to the caller,
        counted as a fallback. The ``finally`` keeps a raising window
        from leaking an armed watchdog timer."""
        try:
            if self._overlap and not self._cb_error:
                with self._phase("overlap_window"):
                    self._overlap_admit()
                if mask_work is not None:
                    mask_work()
        finally:
            with self._phase("token_sync"):
                self._await_dispatch(fin)

    def _overlap_admit(self):
        """One admission pass for the next tick. Slots retire at commit,
        after this window, so WHICH requests admit is what the next tick
        boundary would have admitted — only when moves. Counted as an
        overlapped tick when there was due work and a free slot."""
        worked = bool(self._free) and self._backlog(self._now()) > 0
        self._admit_ready()
        if worked:
            self.metrics.count_overlap_tick()

    def _await_dispatch(self, fin):
        """The device-completion boundary (the armed watchdog's event
        wait; a no-op unarmed, where the token read is the sync)."""
        if fin is not None:
            fin()

    def _finite_mask(self):
        """The guarded step's per-slot finite mask on the host (read with
        its tokens), or None when the guard is off."""
        if not self.logit_guard:
            return None
        return self._finite_host

    def _quarantine_nonfinite(self, slot: int):
        """The logit guard flagged ``slot`` (``serving.py:6545``): retire
        exactly that request, counted, discarding its draw, then
        DECONTAMINATE the storage it released — the dense row, or every
        released block no other holder kept (a trie-shared block keeps
        its content, and the guard retires its next reader too)."""
        req = self._slots[slot]
        self._c_nonfinite.inc()
        with self._telemetry("nonfinite event"):
            self.telemetry.recorder.record(
                "nonfinite_logits", rid=req.id, slot=slot,
                tokens_so_far=len(req.tokens))
        mapped = None
        if self.paged:
            mapped = [int(b) for b in
                      np.unique(self.engine.table[
                          slot, :self._nblocks[slot]]) if b != 0]
        self._quarantine(
            req, FloatingPointError("non-finite decode logits"),
            "logit_guard")
        if not self.paged:
            self.engine.scrub_slot_kv(slot=slot)
        elif mapped:
            self.engine.scrub_slot_kv(
                blocks=[b for b in mapped if self._alloc.refcount(b) == 0])

    def _idle_wait(self, wait: float):
        """Park until the next event is due OR work arrives
        (``serving.py:6191``): a condition wait that ``submit()`` and
        ``cancel()`` from any thread notify, so an idle engine admits a
        late arrival within one tick. An injected clock that does not
        advance fails loudly instead of blocking for fake seconds."""
        before = self.clock()
        with self._wake:
            if self._wake_flag:
                self._wake_flag = False
                return
            notified = self._wake.wait(timeout=min(wait, 0.05))
            self._wake_flag = False
        if notified:
            return
        if self.clock() <= before:
            raise RuntimeError(
                "ServingEngine clock did not advance during an idle "
                "wait — when injecting a simulated clock, override "
                "_idle_wait() to advance it (or submit requests with "
                "arrival_time already due)")
        # the clock is real: park the remainder in ONE condition wait; a
        # submit or cancel landing between the two waits sets the flag
        remaining = wait - (self.clock() - before)
        if remaining > 0:
            with self._wake:
                if not self._wake_flag:
                    self._wake.wait(timeout=remaining)
                self._wake_flag = False

    def run(self, max_steps: Optional[int] = None,
            keep_epoch: bool = False) -> ServingMetrics:
        """Drive the loop until queue and slots drain (or ``max_steps``
        ticks). A call that starts from an idle engine opens a fresh
        metrics window and clock anchor for ``arrival_time``; a call is
        also the operator's restart of a tripped breaker.
        Engine-scoped tick failures count against the breaker: below
        ``engine_failure_threshold`` consecutive ones the broken tick is
        skipped, at it the engine dumps its flight ring and raises.
        ``keep_epoch`` keeps the EXISTING clock anchor and metrics window
        across an idle restart: the FrontDoor pump uses it, so a
        long-lived server's arrival stamps, deadlines and percentiles
        live on one anchor instead of resetting per burst. Tick-boundary
        jobs drain before the loop, at the top of every tick and after
        the loop."""
        steps = 0
        self._breaker_open = False
        self._engine_failures = 0
        if not self.active_count() and \
                not (keep_epoch and self._t0 is not None):
            self._t0 = self.clock()
            self.metrics = ServingMetrics(
                self.b, self._cache, self._alloc,
                registry=self.telemetry.registry, slo=self.telemetry.slo)
            self._ptimes.clear()
            self._rep_ticks = 0
            self._rep_busy = [0] * self.replicas
            self._rep_tokens = [0] * self.replicas
        self._now()
        self._running = True
        try:
            # boundary jobs may be what woke an idle engine: a
            # migrate-in's restore submits the work the loop then sees
            with self._tick_gate:
                self._run_boundary_jobs()
            while self.scheduler.depth() or self.active_count():
                try:
                    with self._tick_gate:
                        outcome = self._run_tick()
                except Exception as e:
                    if not self._quar:
                        raise
                    cb, self._cb_error = self._cb_error, False
                    self._engine_failures += 1
                    self._c_eng_err.inc()
                    try:
                        self.telemetry.recorder.record(
                            "engine_error", error=repr(e),
                            failures=self._engine_failures,
                            client_callback=cb)
                    except Exception as rec_err:
                        self._warn_dump_failed("engine_error event",
                                               rec_err)
                    if self._engine_failures >= self._breaker_threshold:
                        self._breaker_open = True
                        self._c_breaker.inc()
                        try:
                            self.telemetry.recorder.record(
                                "breaker_trip",
                                failures=self._engine_failures,
                                threshold=self._breaker_threshold)
                        except Exception as rec_err:
                            self._warn_dump_failed("breaker_trip event",
                                                   rec_err)
                        raise
                    try:
                        self.audit()
                    except Exception as rec_err:
                        self._warn_dump_failed("post-failure audit",
                                               rec_err)
                    continue
                self._engine_failures = 0
                if outcome == "done":
                    break
                if outcome == "stepped":
                    steps += 1
                    if max_steps is not None and steps >= max_steps:
                        break
        except BaseException as e:
            # postmortem first, propagation second; every telemetry step
            # is guarded, so a broken recorder neither masks ``e`` nor
            # skips the dump
            try:
                self.telemetry.recorder.record(
                    "exception", error=repr(e), steps=steps,
                    active=self.active_count(),
                    queued=self.queue_depth())
            except Exception as rec_err:
                self._warn_dump_failed("exception event", rec_err)
            try:
                path = self.telemetry.recorder.dump_on_crash(
                    e, context={"steps": steps,
                                "active": self.active_count(),
                                "queued": self.queue_depth()})
            except Exception as rec_err:
                path = None
                self._warn_dump_failed("crash dump", rec_err)
            if path is not None:
                print(f"[serving] flight recorder dumped to {path} "
                      f"(render: python -m paddle_tpu_torch.observability."
                      f"dump {path})", file=sys.stderr)
            raise
        finally:
            # flag FIRST, then drain: a job appended after this drain
            # saw _running False and drains itself inline, so no job
            # waits out its timeout against an exited loop
            self._running = False
            with self._tick_gate:
                self._run_boundary_jobs()
        return self.metrics

    def _telemetry(self, what: str):
        """Context for tracer and flight-ring EMISSION on request paths:
        a failing write is counted (``serving_flight_dump_failed_total``)
        and warned, never propagated."""
        @contextlib.contextmanager
        def scope():
            try:
                yield
            except Exception as err:
                self._warn_dump_failed(what, err)

        return scope()

    # -- tick-anatomy profiling ----------------------------------------------
    def _phase(self, name: str):
        """Guarded profiler phase span: the shared null context when
        profiling is off, an absorb-count-warn :class:`_ProfPhase` when
        it is on."""
        try:
            prof = getattr(self.telemetry, "profiler", None)
            if prof is None or not prof.enabled:
                return _NULL_PHASE
        except Exception as err:
            self._profile_failed(err)
            return _NULL_PHASE
        return _ProfPhase(self, name)

    def _prof_tick_begin(self):
        prof = getattr(self.telemetry, "profiler", None)
        if prof is None or not prof.enabled:
            return None
        try:
            return prof.tick_begin()
        except Exception as err:
            self._profile_failed(err)
            return None

    def _prof_tick_end(self, token, stepped: bool):
        if token is None:
            return
        prof = getattr(self.telemetry, "profiler", None)
        try:
            if prof is not None:
                prof.tick_end(token, commit=stepped)
        except Exception as err:
            self._profile_failed(err)

    def _profile_failed(self, err: BaseException):
        """A profiler call raised: count it every time, warn once."""
        try:
            self._c_prof_err.inc()
        except Exception:
            pass
        if self._profile_warned:
            return
        self._profile_warned = True
        try:
            print(f"[serving] tick profiler raised and was absorbed "
                  f"({err!r}); further failures are counted in "
                  f"serving_profiler_errors_total without this "
                  f"warning", file=sys.stderr)
        except Exception:
            pass

    def replica_utilization(self) -> Dict[str, Any]:
        """Utilization accounting for the current metrics window,
        counted on the tick path (one replica here)."""
        ticks = self._rep_ticks
        busy = [int(b) for b in self._rep_busy]
        toks = [int(t) for t in self._rep_tokens]
        denom = ticks * self.b
        mean = sum(busy) / len(busy) if busy else 0.0
        return {
            "ticks": int(ticks),
            "busy_slot_ticks": busy,
            "utilization": [b / denom if denom else 0.0 for b in busy],
            "tokens": toks,
            "tokens_per_tick": [t / ticks if ticks else 0.0
                                for t in toks],
            "skew": (max(busy) / mean) if mean > 0 else 1.0,
        }

    def profile_state(self) -> Dict[str, Any]:
        """The ``/debug/profile`` snapshot (``serving.py:6832``): the
        tick-phase breakdown, the programs ranked by cumulative warm
        wall time from every ProgramSet's dispatch ledger, and the
        utilization split."""
        prof = getattr(self.telemetry, "profiler", None)
        out: Dict[str, Any] = {
            "enabled": bool(prof is not None and prof.enabled),
            "profiler": prof.snapshot() if prof is not None else None,
        }
        programs: Dict[str, Dict[str, float]] = {}
        for ps in self._program_sets():
            for name, st in ps.dispatch_stats().items():
                agg = programs.setdefault(name, {})
                for k, v in st.items():
                    agg[k] = agg.get(k, 0.0) + v
        top = [dict(program=name, **st) for name, st in programs.items()]
        top.sort(key=lambda row: -row.get("wall_s", 0.0))
        out["top_programs"] = top
        out["replicas"] = dict(self.replica_utilization(),
                               count=self.replicas)
        out["adaptations"] = None
        return out

    def _warn_dump_failed(self, what: str, err: BaseException):
        """A telemetry write failed: count it and warn on stderr. Guarded
        itself — the original exception stays the one the caller sees."""
        try:
            self._c_dump_failed.inc()
        except Exception:
            pass
        try:
            print(f"[serving] flight_dump_failed: {what} could not be "
                  f"written ({err!r})", file=sys.stderr)
        except Exception:
            pass

    def _run_tick(self) -> str:
        """One iteration of the serving loop, bracketed by the tick
        profiler; only ``"stepped"`` iterations commit as profiled
        ticks."""
        tok = self._prof_tick_begin()
        if tok is None:
            return self._tick_once()
        outcome = "error"
        try:
            outcome = self._tick_once()
            return outcome
        finally:
            self._prof_tick_end(tok, outcome == "stepped")

    def _tick_once(self) -> str:
        # boundary jobs, cancellations and deadlines are tick-boundary
        # work like admissions: applied before this tick's
        # admit/prefill/step, so a cancelled slot frees THIS tick
        with self._phase("admission"):
            self._run_boundary_jobs()
            self._process_cancellations()
            self._expire_deadlines()
            self._admit_ready()
        if not self.active_count():
            if not self.scheduler.depth():
                return "done"
            # every pending request lies in the future: park until the
            # earliest arrival OR queued deadline, or a wake-up
            now = self._now()
            nxt = self.scheduler.next_arrival(now)
            wait = (nxt - now) if nxt is not None else 0.0
            dls = [r.deadline for r in self.scheduler.pending()
                   if r.deadline is not None]
            if dls:
                wait = min(wait, min(dls) - now)
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
