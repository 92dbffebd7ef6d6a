"""Continuous-batching serving over the paged KV arena — the port of
``paddle_tpu/inference/serving.py`` (slice 1).

Two layers, as in the JAX package:

- :class:`DecodeEngine` — the device substrate. Each layer's K/V lives
  in ONE block pool ``(num_blocks, block_size, H, D)`` addressed through
  an int32 block table ``(slots, max_len // block_size)``. Prompts
  prefill one slot at a time in fixed-size chunks (``prefill_chunk``
  tokens at a scalar offset: the chunk-prefill kernel K5), and decode
  steps every slot in lockstep (per-slot offsets: the paged-decode
  kernel K4), ending in the sampler. PyTorch runs eagerly, so the
  JAX package's compiled programs (``_build_chunk_prefill``,
  ``_build_step``) are plain methods here.

- :class:`ServingEngine` — the host scheduler. FIFO admission gated on
  free BLOCKS, one prefill chunk per tick (oldest-admitted prefilling
  slot) interleaved with one lockstep decode step, lazy block growth as
  committed lengths cross block boundaries, preemption of the
  newest-admitted request when the pool runs dry (it resumes by
  re-prefilling prompt + committed tokens), retirement at EOS or
  length, ``on_token`` streaming, and counted metrics.

Lockstep garbage (as in the JAX package's ``serving.py`` docstring):
idle slots keep computing with an all-zero table row and offset 0, so
their writes land in scratch block 0, which is never allocated;
a slot still prefilling is parked at offset ``plen - 1``, a row its own
final chunk rewrites before the slot's first real decode.

Sampling: greedy is argmax (first index on ties) and token-exact with
the JAX engine. Temperature draws cannot reproduce JAX's threefry
``fold_in`` stream; each request instead owns a ``torch.Generator``
(``core/random.py``) from which the engine draws exactly one uniform per
committed sampled token, and the token is the inverse-CDF pick of the
filtered softmax on the device. The stream is therefore private to the
request and survives preemption; it is held to the JAX engine by
distribution, not by value.

The overlapped tick of the JAX engine is kept: a decode step is
launched asynchronously, the next tick's admissions run while the card
computes, and only then are the tokens read back.

Out of this slice (each queued in ROADMAP.md): the dense arena, int8
pools, the prefix cache, speculative decoding, meshes and replicas,
telemetry and resilience, the host tier, the front door and fleet,
LoRA, constraints, score/embed, ``generate()``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.place import get_device, resolve_device
from paddle_tpu_torch.core.random import request_generator
from paddle_tpu_torch.inference.block_pool import BlockAllocator
from paddle_tpu_torch.inference.frontend.scheduler import FifoScheduler

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


class DecodeEngine:
    """Per-slot paged decode over one KV block pool per layer.

    ``model`` exposes ``kv_cache_spec()`` and the paged-cache forward
    ``model(ids, caches=[(k_pool, v_pool, table, t), ...]) -> (logits,
    caches)`` (:class:`~paddle_tpu_torch.models.gpt.GPTForCausalLM`).
    The engine runs on the model's device. ``block_size`` must divide
    ``max_len``; ``num_blocks`` counts the scratch block 0 and defaults
    to the dense-equivalent ``slots * max_len / block_size + 1``.
    ``top_k`` is the static top-k filter of every draw."""

    def __init__(self, model, max_batch_slots: int, max_len: int,
                 top_k: Optional[int] = None, prefill_chunk: int = 128,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None):
        spec = model.kv_cache_spec()
        mpe = spec.get("max_position_embeddings")
        if mpe is not None and max_len > mpe:
            raise ValueError(
                f"max_len {max_len} exceeds the model's "
                f"max_position_embeddings {mpe}")
        if block_size is None:
            raise NotImplementedError(
                "the dense KV arena (block_size=None) is not ported yet — "
                "it is a later slice of the port; pass block_size= for "
                "the paged arena")
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
        bs = int(block_size)
        if bs < 1 or self.max_len % bs:
            raise ValueError(
                f"block_size {block_size} must be >= 1 and divide "
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
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        row_nbytes = 2 * self.L * self.heads * self.head_dim * itemsize
        self.allocator = BlockAllocator(self.num_blocks, bs,
                                        block_nbytes=bs * row_nbytes)
        # host mirror of the block table; entries past a slot's mapped
        # count stay 0 = the scratch sink
        self.table = np.zeros((self.b, self.blocks_per_slot), np.int32)
        self.kbufs: Optional[List[torch.Tensor]] = None
        self.vbufs: Optional[List[torch.Tensor]] = None

    def reset(self):
        """Zero the pools (the table and allocator belong to the
        scheduler and are left alone)."""
        shape = (self.num_blocks, self.block_size, self.heads,
                 self.head_dim)
        self.kbufs = [torch.zeros(shape, dtype=self.dtype,
                                  device=self.device) for _ in range(self.L)]
        self.vbufs = [torch.zeros(shape, dtype=self.dtype,
                                  device=self.device) for _ in range(self.L)]

    def _ensure_buffers(self):
        if self.kbufs is None:
            self.reset()

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

    def _caches(self, table, t):
        return [(self.kbufs[i], self.vbufs[i], table, t)
                for i in range(self.L)]

    def _vec(self, x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def _sampler_args(self, temps, greedy, uniforms, topks, topps):
        """The sampler's host vectors as device tensors. Built BEFORE the
        forward: a host-to-device copy after it would wait for the whole
        forward to finish."""
        greedy = np.asarray(greedy)
        filt = (np.asarray(topks) > 0).any() or (np.asarray(topps) < 1.0).any()
        return {
            "temps": self._vec(np.maximum(temps, 1e-6), torch.float32),
            "greedy": None if greedy.all() else self._vec(greedy, torch.bool),
            "uniforms": self._vec(uniforms, torch.float32),
            "topks": self._vec(topks, torch.int64) if filt else None,
            "topps": self._vec(topps, torch.float32) if filt else None,
        }

    def _sample(self, last, temps, greedy, uniforms, topks, topps):
        """Device sampler over ``(n, V)`` fp32 logits (``serving.py:833``
        without the threefry stream). Host vectors: ``temps``,
        ``greedy``, ``topks``, ``topps`` and ``uniforms`` (one draw in
        [0, 1) per row, ignored for greedy rows)."""
        return self._sample_dev(last, self._sampler_args(
            temps, greedy, uniforms, topks, topps))

    def _sample_dev(self, last, a):
        last = last / a["temps"][:, None]
        if self.top_k is not None:
            kth = torch.topk(last, self.top_k, dim=-1).values[:, -1:]
            last = torch.where(last < kth,
                               torch.full_like(last, float("-inf")), last)
        if a["topks"] is not None:
            last = apply_topk_topp(last, a["topks"], a["topps"])
        arg = torch.argmax(last, dim=-1)
        if a["greedy"] is None:
            return arg
        cdf = torch.cumsum(torch.softmax(last, dim=-1), dim=-1)
        target = a["uniforms"][:, None] * cdf[:, -1:]
        drawn = torch.searchsorted(cdf, target, right=True)[:, 0]
        drawn = drawn.clamp(max=last.shape[-1] - 1)
        return torch.where(a["greedy"], arg, drawn)

    def prefill_chunk_at(self, ids_row, slot: int, pos: int, plen: int,
                         temps, greedy, uniforms, topks, topps):
        """Run the zero-padded ``(1, prefill_chunk)`` prompt chunk
        covering ``[pos, min(pos+C, plen))`` for ``slot``; returns
        ``(tok, next_pos)`` — ``tok`` a (1, 1) device tensor, meaningful
        only for the prompt's final chunk."""
        C = self.prefill_chunk
        n = min(C, int(plen) - int(pos))
        chunk = np.zeros((1, C), np.int64)
        chunk[0, :n] = np.asarray(ids_row[pos:pos + n])
        tok = self.run_prefill_chunk(chunk, slot, pos, n - 1, temps,
                                     greedy, uniforms, topks, topps)
        return tok, pos + n

    def run_prefill_chunk(self, ids_chunk, slot: int, start: int,
                          last_idx: int, temps, greedy, uniforms, topks,
                          topps):
        """ONE ``(1, prefill_chunk)`` chunk for ``slot`` at pool offset
        ``start`` (a 0-dim offset: the model routes it to K5); samples
        at ``last_idx``. The pad tail of a short final chunk computes
        discarded rows whose K/V past the table's reach is dropped."""
        self._ensure_buffers()
        ids = self._vec(ids_chunk, torch.int64)
        table = self._vec(self.table[slot:slot + 1], torch.int32)
        t = torch.tensor(int(start), dtype=torch.int32, device=self.device)
        args = self._sampler_args(temps, greedy, uniforms, topks, topps)
        with self._eval_mode():
            logits, _ = self.model(ids, caches=self._caches(table, t))
            tok = self._sample_dev(logits[:, int(last_idx)].float(), args)
        return tok[:, None]

    def step(self, toks, t, temps, greedy, uniforms, topks, topps):
        """One lockstep decode step over all slots (per-slot offsets:
        the model routes it to K4); returns the next token per slot as a
        (b, 1) device tensor, WITHOUT waiting for the card. Rows of idle
        or prefilling slots compute garbage the caller discards."""
        self._ensure_buffers()
        ids = self._vec(toks, torch.int64)
        table = self._vec(self.table, torch.int32)
        tv = self._vec(t, torch.int32)
        args = self._sampler_args(temps, greedy, uniforms, topks, topps)
        with self._eval_mode():
            logits, _ = self.model(ids, caches=self._caches(table, tv))
            tok = self._sample_dev(logits[:, -1].float(), args)
        return tok[:, None]


@dataclass
class Request:
    """One generation request (``serving.py:2025``).

    ``on_token(request, token_id, done)`` streams tokens as they are
    committed (the first when the prompt's prefill completes = time to
    first token). ``finish_reason`` after completion: ``"eos"`` or
    ``"length"``. ``arrival_time`` is an offset in seconds from the start
    of :meth:`ServingEngine.run` (0 = already queued). ``seed`` pins the
    request's private sample stream; unset, it derives from the engine
    seed and the request id. ``top_k``/``top_p`` are per-request
    filters."""

    prompt: Sequence[int]
    max_new_tokens: int = 32
    temperature: float = 1.0
    greedy: bool = False
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_id: Optional[int] = None
    seed: Optional[int] = None
    on_token: Optional[Callable[["Request", int, bool], None]] = None
    on_finish: Optional[Callable[["Request"], None]] = None
    arrival_time: float = 0.0

    # engine-owned
    id: int = -1
    tokens: List[int] = field(default_factory=list)
    status: str = "new"          # new -> queued -> running -> done
    finish_reason: Optional[str] = None
    _gen: Optional[torch.Generator] = field(default=None, repr=False)


class ServingMetrics:
    """Per-request records and per-tick samples of one ``run()`` window;
    :meth:`aggregate` folds them into the reference's headline keys
    (``serving.py:2475``)."""

    def __init__(self, max_batch_slots: int,
                 allocator: Optional[BlockAllocator] = None):
        self.slots = max_batch_slots
        self.records: List[Dict[str, Any]] = []
        self.step_samples: List[Dict[str, float]] = []
        self.tick_samples: List[Dict[str, float]] = []
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.prefill_chunks = 0
        self.prompt_tokens = 0
        self.preemptions = 0
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

    def record_preemption(self):
        self.preemptions += 1

    def record_tick(self, occupied: int, queued: int,
                    blocks: Optional[int] = None):
        """One tick's load sample; ``occupied`` counts every in-flight
        slot, prefilling ones included."""
        sample = {"occupied": float(occupied), "queued": float(queued)}
        if blocks is not None:
            sample["blocks"] = float(blocks)
        self.tick_samples.append(sample)

    def record_step(self, active: int, queued: int, seconds: float):
        """One decode step over ``active`` live slots, ``seconds`` from
        launch to tokens on the host."""
        self.step_samples.append({"active": float(active),
                                  "queued": float(queued),
                                  "seconds": float(seconds)})

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
            out["decode_step_ms_p50"] = 1e3 * float(np.percentile(
                [s["seconds"] for s in self.step_samples], 50))
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
        out["prefill_tokens_computed"] = float(self.prompt_tokens)
        return out


class ServingEngine:
    """Continuous-batching scheduler over a paged :class:`DecodeEngine`
    (``serving.py:2653``).

    ``submit()`` validates and enqueues; ``run()`` drives the
    admit -> prefill-chunk + decode-step -> retire loop until the queue
    drains (or ``max_steps`` ticks). The engine runs on ``device``
    (default ``"cuda"``; the model must already live there — nothing is
    moved). ``seed`` seeds every request that does not pin its own."""

    def __init__(self, model, max_batch_slots: int = 8, max_len: int = 256,
                 top_k: Optional[int] = None, eos_id: Optional[int] = None,
                 prefill_chunk: int = 128, seed: int = 0,
                 clock: Callable[[], float] = time.perf_counter,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None, scheduler=None,
                 device=None):
        dev = resolve_device(device)
        mdev = get_device(model)
        if mdev.type != dev.type:
            raise ValueError(
                f"the model lives on {mdev}, the engine was asked for "
                f"{dev}; build the model on the engine's device")
        self.engine = DecodeEngine(model, max_batch_slots, max_len,
                                   top_k=top_k, prefill_chunk=prefill_chunk,
                                   block_size=block_size,
                                   num_blocks=num_blocks)
        self._alloc = self.engine.allocator
        self.b = self.engine.b
        self.max_len = self.engine.max_len
        # one row of every slot is reserved for a generated token
        self._plen_max = self.max_len - 1
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
        self.metrics = ServingMetrics(self.b, self._alloc)

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
            raise ValueError(
                f"prompt length {plen} must be in [1, {self._plen_max}] "
                f"(max_len={self.max_len}) — the slot needs "
                "at least one row for generated tokens")
        if plen + req.max_new_tokens > self._plen_max + 1:
            raise ValueError(
                f"prompt_len + max_new_tokens = {plen} + "
                f"{req.max_new_tokens} = {plen + req.max_new_tokens} "
                f"exceeds the {self._plen_max + 1}-token slot budget"
                f" (max_len={self.max_len}); shorten the prompt or lower "
                "max_new_tokens")
        # a request must be able to finish ALONE on the pool, or
        # preempting everyone else could never unblock it; its deepest
        # write is row plen + max_new - 2
        bs = self.engine.block_size
        alone = max(plen + req.max_new_tokens - 2, plen - 1) // bs + 1
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

    # -- scheduling ---------------------------------------------------------
    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = self.clock()
        return self.clock() - self._t0

    def _admit(self, req: Request) -> bool:
        """Admit ``req`` into a free slot if the pool can back its
        prompt; False leaves it queued. A preempted request resumes here
        and re-prefills prompt + committed tokens."""
        ids = np.asarray(list(req.prompt) + req.tokens, np.int64)
        plen = int(ids.shape[0])
        need = (plen - 1) // self.engine.block_size + 1
        fresh = self._alloc.alloc(need)
        if fresh is None:
            # re-trying every tick while nothing freed would only burn
            # host work: remember the failure against the free counter
            self._adm_blocked = (req.id, self._alloc.freed)
            return False
        slot = self._free.pop()
        self._temps[slot] = max(float(req.temperature), 1e-6)
        self._greedy[slot] = bool(req.greedy)
        self._topk[slot] = int(req.top_k) if req.top_k is not None else 0
        self._topp[slot] = float(req.top_p) if req.top_p is not None \
            else 1.0
        self._budget[slot] = req.max_new_tokens
        if req._gen is None:
            req._gen = request_generator(self.seed, req.id, req.seed)
        self._slots[slot] = req
        self._pf[slot] = {"ids": ids, "pos": 0, "seq": req.id}
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
        # FINAL prefill chunk rewrites before the slot's first decode
        self._t[slot] = plen - 1
        self._toks[slot, 0] = 0
        self.metrics.count_prompt_tokens(plen)
        self.engine.table[slot, :need] = fresh
        self._nblocks[slot] = need
        return True

    def _admit_ready(self):
        while self._free:
            req = self.scheduler.next_due(self._now())
            if req is None:
                break
            if self._adm_blocked == (req.id, self._alloc.freed):
                break   # still blocked: nothing freed since the last try
            self.scheduler.pop(req)
            if not self._admit(req):
                self.scheduler.requeue(req)
                break   # pool short of blocks: the head waits

    def _draw(self, slots) -> np.ndarray:
        """One uniform per slot from its request's generator — only for
        sampled (non-greedy) slots, so each request's stream advances
        exactly once per committed sampled token."""
        u = np.zeros((len(slots),), np.float32)
        for i, slot in enumerate(slots):
            if not self._greedy[slot]:
                u[i] = torch.rand((), generator=self._slots[slot]._gen)
        return u

    def _run_prefill_chunk(self):
        """Advance the oldest-admitted prefilling slot by one chunk; on
        the prompt's final chunk, commit its first token."""
        pf = [i for i in range(self.b) if self._pf[i] is not None]
        if not pf:
            return
        slot = min(pf, key=lambda i: self._pf[i]["seq"])
        st = self._pf[slot]
        plen = len(st["ids"])
        final = plen - st["pos"] <= self.engine.prefill_chunk
        u = self._draw([slot]) if final else np.zeros((1,), np.float32)
        sl = slice(slot, slot + 1)
        st["tok"], st["pos"] = self.engine.prefill_chunk_at(
            st["ids"], slot, st["pos"], plen, self._temps[sl],
            self._greedy[sl], u, self._topk[sl], self._topp[sl])
        self.metrics.count_prefill_chunk()
        if st["pos"] >= plen:
            self._finish_prefill(slot)

    def _finish_prefill(self, slot: int):
        """Prompt committed: read its first token (the one host sync of
        the whole prefill = TTFT) and move the slot into the decode
        cohort."""
        req = self._slots[slot]
        st = self._pf[slot]
        first = int(st["tok"][0, 0])
        self._pf[slot] = None
        self._adm_blocked = None
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

    def _retire(self, slot: int, reason: str):
        req = self._slots[slot]
        req.status = "done"
        req.finish_reason = reason
        self._slots[slot] = None
        self._pf[slot] = None
        self._free.append(slot)
        self._release_blocks(slot)
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
        scratch sink."""
        n = int(self._nblocks[slot])
        if n:
            self._alloc.deref(self.engine.table[slot, :n].tolist())
        self.engine.table[slot, :] = 0
        self._nblocks[slot] = 0

    def _preempt(self, slot: int):
        """Pool exhausted: push this request back to the queue HEAD. Its
        blocks recycle now; its committed tokens stay on the Request, so
        re-admission re-prefills prompt + tokens and continues where it
        left off (greedy decoding makes that token-exact; a sampled
        request keeps its private stream)."""
        req = self._slots[slot]
        self._pf[slot] = None
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

    def _ensure_decode_blocks(self):
        """Lazy block growth before a decode step: every live slot needs
        storage behind row ``t``, the row this tick writes. Oldest slots
        are served first; when the pool is dry the newest-admitted
        request is preempted (repeatedly if needed) — submit()'s
        alone-fit check guarantees this converges."""
        bs = self.engine.block_size
        order = sorted((i for i, r in enumerate(self._slots)
                        if r is not None and self._pf[i] is None),
                       key=lambda i: self._seq[i])
        for slot in order:
            while self._slots[slot] is not None:
                target = min(int(self._t[slot]), self.max_len - 1) // bs + 1
                need = target - int(self._nblocks[slot])
                if need <= 0:
                    break
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
                blocks=self._alloc.blocks_in_use())
        self._run_prefill_chunk()
        self._ensure_decode_blocks()
        live = [i for i, r in enumerate(self._slots)
                if r is not None and self._pf[i] is None]
        if not live:
            return
        u = np.zeros((self.b,), np.float32)
        u[live] = self._draw(live)
        t0 = time.perf_counter()
        tok = self.engine.step(self._toks, self._t, self._temps,
                               self._greedy, u, self._topk, self._topp)
        # overlapped tick: the next tick's admissions run while the card
        # computes this step (slots retire at commit, after this pass,
        # so WHICH requests admit is unchanged — only when)
        self._admit_ready()
        toks = tok.cpu().numpy()
        self.metrics.record_step(len(live),
                                 self.scheduler.due_count(self._now()),
                                 time.perf_counter() - t0)
        for slot in live:
            self._t[slot] += 1
            self._toks[slot, 0] = int(toks[slot, 0])
            self._commit_token(slot, int(toks[slot, 0]))

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

    def run(self, max_steps: Optional[int] = None) -> ServingMetrics:
        """Drive the loop until queue and slots drain (or ``max_steps``
        ticks). A call that starts from an idle engine opens a fresh
        metrics window and clock anchor for ``arrival_time``."""
        if not self.active_count():
            self._t0 = self.clock()
            self.metrics = ServingMetrics(self.b, self._alloc)
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
