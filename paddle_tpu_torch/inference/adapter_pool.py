"""Host-side adapter-slot manager for multi-LoRA serving.

The port's copy of ``paddle_tpu/inference/adapter_pool.py``: stacked
per-layer LoRA pools — for every adapted projection a pair of ``(L,
num_slots, din, r)`` A and ``(L, num_slots, r, dout)`` B arrays (the
port's ``nn.Linear`` keeps paddle's (in, out) layout, so the shapes are
the reference's) — plus a free-list + refcount slot allocator over the
``num_slots`` axis, the grant/deref/reconcile design of
``block_pool.py``. The engine's programs take the pools and a per-slot
int32 adapter-id vector as runtime arguments: registering, evicting or
swapping adapters changes pool VALUES and id values, never shapes, so
the argument signatures stay flat across any adapter mix.

Slot 0 is the IDENTITY adapter and is never handed out: its A/B rows
are all-zero, so a request with no adapter gathers slot 0 and adds an
exact zero delta.

Reference counting follows the block pool's discipline: a request
takes one reference at submit and drops it at retirement (preemption
and host-tier spill keep the request live, so the reference rides
through untouched). Eviction of a slot with live references is REFUSED
— a hard error like a double free. Cold unpinned adapters are
LRU-evicted when the pool is full; pinned adapters leave only by an
explicit ``evict`` after unpinning.

Device side: :meth:`device_arrays` returns torch tensors on the bound
engine's device, allocated ONCE per binding. A register or evict
writes the host rows and marks the slot dirty; the next
:meth:`device_arrays` call — on the engine's thread, at a dispatch —
copies exactly the dirty rows into the resident tensors in place. A
register from another thread (the front door's) therefore never writes
device memory a dispatch is reading, and no tensor is ever
reallocated. One pool lock orders every change to the slot table, the
refcounts and the host rows: the front door's acquires, the tick
loop's releases and an operator's register or evict may run on
different threads. ``SPECS`` (the tensor-parallel annotations) and the
replica axis are inert on one device.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.inference.block_pool import _check_deref

__all__ = ["AdapterPool"]


class AdapterPool:
    """Free-list + refcount manager over stacked per-layer LoRA pools.

    Parameters
    ----------
    num_adapters : int
        Allocatable adapter slots (slot 0, the all-zero identity, is
        reserved on top — the device pools carry ``num_adapters + 1``
        rows).
    rank : int
        LoRA rank ``r`` shared by every slot (one rank keeps the pool
        shapes — and therefore the executables — static; pad smaller
        adapters with zero rows).
    num_layers, hidden_size : int
        The base model's depth and width.
    ffn_size : int, optional
        MLP inner width (default ``4 * hidden_size``).
    dtype : numpy dtype
        Host/device pool storage dtype (deltas cast to the activation
        dtype inside the program).
    """

    #: adapted projections, in model order
    TARGETS = ("qkv", "out", "fc_in", "fc_out")
    #: dist_spec-style annotations over the LOGICAL (L, N, d1, d2)
    #: pool dims — "mp" marks the tensor-parallel dim, mirroring the
    #: specs on the weights each pool perturbs (column-parallel
    #: qkv/fc_in shard B's output dim; row-parallel out/fc_out shard
    #: A's input dim). The engine maps "mp" onto its mesh axis and
    #: prepends the replica axis on 2-D meshes — one spec, every mesh.
    SPECS: Dict[str, Tuple[Tuple, Tuple]] = {
        "qkv": ((None, None, None, None), (None, None, None, "mp")),
        "out": ((None, None, "mp", None), (None, None, None, None)),
        "fc_in": ((None, None, None, None), (None, None, None, "mp")),
        "fc_out": ((None, None, "mp", None), (None, None, None, None)),
    }

    def __init__(self, num_adapters: int, rank: int, num_layers: int,
                 hidden_size: int, ffn_size: Optional[int] = None,
                 dtype=np.float32):
        if num_adapters < 1:
            raise ValueError(
                f"need >= 1 allocatable adapter slot (slot 0 is the "
                f"reserved identity), got {num_adapters}")
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.capacity = int(num_adapters)
        self.num_slots = self.capacity + 1      # + identity slot 0
        self.rank = int(rank)
        self.L = int(num_layers)
        h = int(hidden_size)
        ffn = int(ffn_size) if ffn_size is not None else 4 * h
        self.dtype = np.dtype(dtype)
        #: target -> (din, dout) of the adapted projection
        self.dims: Dict[str, Tuple[int, int]] = {
            "qkv": (h, 3 * h), "out": (h, h),
            "fc_in": (h, ffn), "fc_out": (ffn, h)}
        r, N = self.rank, self.num_slots
        self._host: Dict[str, Tuple[np.ndarray, np.ndarray]] = {
            t: (np.zeros((self.L, N, din, r), self.dtype),
                np.zeros((self.L, N, r, dout), self.dtype))
            for t, (din, dout) in self.dims.items()}
        # bytes ONE adapter slot pins across all layers and targets —
        # the unit of the bytes_loaded stat and the pool-sizing docs
        self.adapter_nbytes = sum(
            self.L * (din * r + r * dout) * self.dtype.itemsize
            for din, dout in self.dims.values())
        # LIFO free list over slots [1, num_slots) — block_pool's
        # layout; slot 0 never circulates
        self._free: List[int] = list(range(self.num_slots - 1, 0, -1))
        self._refs = np.zeros((self.num_slots,), np.int32)
        self._by_name: Dict[str, int] = {}
        self._names: Dict[int, str] = {}
        self._pinned: set = set()
        # LRU clock: bumped on register and every acquire; eviction
        # under pressure takes the coldest unpinned zero-ref slot
        self._clock = 0
        self._last_use: Dict[int, int] = {}
        # counted stats (the benchmark/metrics currency)
        self.loads = 0
        self.evictions = 0
        self.bytes_loaded = 0
        # device binding (one engine per pool: the device arrays carry
        # that engine's mesh layout)
        self._engine = None
        self._dev: Optional[Dict[str, Tuple[Any, Any]]] = None
        # slots whose host rows changed since the device copy
        self._dirty: set = set()
        # orders the slot table, refcounts and host rows across threads,
        # and host writes against the engine thread's row copies;
        # re-entrant because register evicts under it
        self._lock = threading.RLock()

    # -- queries ----------------------------------------------------------
    def free_count(self) -> int:
        return len(self._free)

    def slots_in_use(self) -> int:
        return self.capacity - len(self._free)

    def lookup(self, name: str) -> Optional[int]:
        """The slot id serving ``name``, or None."""
        return self._by_name.get(name)

    def name_of(self, sid: int) -> Optional[str]:
        return self._names.get(int(sid))

    def refcount(self, name_or_sid) -> int:
        return int(self._refs[self._sid(name_or_sid)])

    def pinned(self, name_or_sid) -> bool:
        return self._sid(name_or_sid) in self._pinned

    def names(self) -> List[str]:
        return list(self._by_name)

    def bytes_in_use(self) -> int:
        return self.slots_in_use() * self.adapter_nbytes

    def _sid(self, name_or_sid) -> int:
        if isinstance(name_or_sid, str):
            sid = self._by_name.get(name_or_sid)
            if sid is None:
                raise KeyError(
                    f"adapter {name_or_sid!r} is not registered")
            return sid
        sid = int(name_or_sid)
        if not (0 < sid < self.num_slots) or sid not in self._names:
            raise KeyError(f"no adapter in slot {sid}")
        return sid

    # -- register / evict -------------------------------------------------
    def register(self, name: str, weights: Dict[str, Tuple],
                 pinned: bool = False) -> int:
        """Load ``weights`` — ``{target: (A (L, din, r), B (L, r,
        dout))}`` host arrays — into a fresh slot under ``name`` and
        return the slot id. A full pool LRU-evicts the coldest
        unpinned zero-reference adapter first; when every slot is
        pinned or live the load FAILS (RuntimeError) rather than
        corrupt a tenant in flight."""
        if not name or not isinstance(name, str):
            raise ValueError(f"adapter name must be a non-empty str, "
                             f"got {name!r}")
        with self._lock:
            return self._register(name, weights, pinned)

    def _register(self, name: str, weights: Dict[str, Tuple],
                  pinned: bool) -> int:
        if name in self._by_name:
            raise ValueError(
                f"adapter {name!r} is already registered (slot "
                f"{self._by_name[name]}) — evict it first to reload")
        missing = [t for t in self.TARGETS if t not in weights]
        if missing:
            raise ValueError(
                f"adapter {name!r} is missing weights for {missing}")
        if not self._free:
            victim = self._lru_victim()
            if victim is None:
                raise RuntimeError(
                    f"adapter pool exhausted: all {self.capacity} "
                    "slots are live or pinned — nothing is evictable")
            self.evict(self._names[victim])
        sid = self._free.pop()
        r = self.rank
        for t, (din, dout) in self.dims.items():
            a, b_ = weights[t]
            a = np.asarray(a, self.dtype)
            b_ = np.asarray(b_, self.dtype)
            if a.shape != (self.L, din, r) or b_.shape != (self.L, r, dout):
                raise ValueError(
                    f"adapter {name!r} target {t!r}: want A "
                    f"{(self.L, din, r)} / B {(self.L, r, dout)}, got "
                    f"A {a.shape} / B {b_.shape}")
            ha, hb = self._host[t]
            ha[:, sid] = a
            hb[:, sid] = b_
        self._by_name[name] = sid
        self._names[sid] = name
        if pinned:
            self._pinned.add(sid)
        self._clock += 1
        self._last_use[sid] = self._clock
        self.loads += 1
        self.bytes_loaded += self.adapter_nbytes
        self._mark_dirty(sid)   # rows copy over at the next dispatch
        return sid

    def _lru_victim(self) -> Optional[int]:
        cold = [sid for sid in self._names
                if self._refs[sid] == 0 and sid not in self._pinned]
        if not cold:
            return None
        return min(cold, key=lambda s: self._last_use.get(s, 0))

    def evict(self, name: str) -> int:
        """Free ``name``'s slot. REFUSED (hard error, like a double
        free) while the adapter is live — a request in flight gathers
        through that slot id, and recycling it would silently serve it
        the next tenant's weights. Pinned adapters must be unpinned
        first."""
        with self._lock:
            return self._evict(name)

    def _evict(self, name: str) -> int:
        sid = self._sid(name)
        if self._refs[sid] > 0:
            raise RuntimeError(
                f"evict({name!r}): slot {sid} has "
                f"{int(self._refs[sid])} live reference(s) — evicting "
                "a live adapter would corrupt requests in flight")
        if sid in self._pinned:
            raise RuntimeError(
                f"evict({name!r}): slot {sid} is pinned — unpin first")
        for t in self.TARGETS:
            ha, hb = self._host[t]
            ha[:, sid] = 0
            hb[:, sid] = 0
        del self._by_name[self._names.pop(sid)]
        self._last_use.pop(sid, None)
        self._free.append(sid)
        self.evictions += 1
        self._mark_dirty(sid)
        return sid

    def pin(self, name: str):
        with self._lock:
            self._pinned.add(self._sid(name))

    def unpin(self, name: str):
        with self._lock:
            self._pinned.discard(self._sid(name))

    # -- acquire / release ------------------------------------------------
    def acquire(self, name: str) -> int:
        """One reference for a request entering the system (KeyError
        when ``name`` is unknown — the typed admission rejection's
        trigger). Returns the slot id the request's per-slot
        ``adapter_id`` entry will carry."""
        with self._lock:
            sid = self._sid(name)
            self._refs[sid] += 1
            self._clock += 1
            self._last_use[sid] = self._clock
            return sid

    def release(self, name_or_sid) -> int:
        """Drop one reference (request retired). A release past zero
        raises BEFORE mutating — block_pool's double-free check,
        shared verbatim."""
        with self._lock:
            sid = self._sid(name_or_sid)
            _check_deref(self._refs, [sid], "AdapterPool")
            self._refs[sid] -= 1
            return sid

    # -- audit ------------------------------------------------------------
    def reconcile(self, expected: Dict[int, int]) -> Dict[str, int]:
        """Audit slot refcounts against ``expected`` — holder count
        per slot id the CALLER can account for (live slots' requests
        plus queued/preempted requests holding an adapter). Returns
        counted discrepancies, mirroring
        :meth:`BlockAllocator.reconcile`: ``leaked_adapters`` (more
        refs than holders — slots that can never free),
        ``missing_adapter_refs`` (fewer — a future release will
        double-free) and ``adapter_free_list_errors`` (free-list /
        refcount / identity-slot mismatches). Pure read."""
        with self._lock:
            free = set(self._free)
            leaked = missing = flerr = 0
            if 0 in free or self._refs[0] != 0 or 0 in expected \
                    or 0 in self._names:
                flerr += 1          # identity slot must never circulate
            for sid in range(1, self.num_slots):
                refs = int(self._refs[sid])
                want = int(expected.get(sid, 0))
                if refs > want:
                    leaked += 1
                elif refs < want:
                    missing += 1
                registered = sid in self._names
                if (sid in free) == registered:
                    flerr += 1      # free while named, or unfree unnamed
                if refs > 0 and not registered:
                    flerr += 1      # references on an unregistered slot
            return {"leaked_adapters": leaked,
                    "missing_adapter_refs": missing,
                    "adapter_free_list_errors": flerr}

    # -- weights helpers --------------------------------------------------
    def random_weights(self, seed: int = 0, scale: float = 0.02) \
            -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """Synthesize a full set of host adapter weights (both factors
        nonzero, so the delta is observable) — the tests' and
        benchmark's adapter generator."""
        rng = np.random.default_rng(seed)
        out = {}
        r = self.rank
        for t, (din, dout) in self.dims.items():
            out[t] = (
                rng.normal(0.0, scale, (self.L, din, r))
                .astype(self.dtype),
                rng.normal(0.0, scale, (self.L, r, dout))
                .astype(self.dtype))
        return out

    def merged_delta(self, name: str, target: str, layer: int) \
            -> np.ndarray:
        """``A @ B`` of one slot's layer for ``target`` — the
        (din, dout) dense delta a merged-weights (W + A@B) reference
        model folds into its projection. The parity tests' ground
        truth."""
        with self._lock:
            sid = self._sid(name)
            ha, hb = self._host[target]
            return np.asarray(ha[layer, sid] @ hb[layer, sid])

    # -- device binding ---------------------------------------------------
    def bind(self, engine):
        """Attach the pool to ONE engine: the device pools live on that
        engine's device. Rebinding to a different engine is refused
        while any slot holds live references (a request in flight on the
        old engine gathers through this pool's slot ids); with zero
        references the pool moves over cleanly."""
        with self._lock:
            if self._engine is not None and self._engine is not engine \
                    and self._refs[1:].any():
                raise RuntimeError(
                    "AdapterPool is bound to another engine with live "
                    "references — drain it first (or build one pool per "
                    "engine)")
            self._engine = engine
            self._dev = None

    def _mark_dirty(self, sid: int):
        with self._lock:
            self._dirty.add(int(sid))

    def device_arrays(self) -> Dict[str, Tuple[Any, Any]]:
        """The stacked device pools, ``{target: (A (L, N, din, r), B
        (L, N, r, dout))}`` torch tensors on the bound engine's device.
        Allocated once per binding; afterwards a register or evict only
        copies its slot's rows into them in place, so every dispatch
        sees the same tensors and the same signatures."""
        with self._lock:
            if self._dev is None:
                dev = getattr(self._engine, "device", None) or "cpu"
                self._dev = {
                    t: (torch.from_numpy(ha.copy()).to(dev),
                        torch.from_numpy(hb.copy()).to(dev))
                    for t, (ha, hb) in self._host.items()}
                self._dirty.clear()
            elif self._dirty:
                idx = sorted(self._dirty)
                self._dirty.clear()
                for t, (ha, hb) in self._host.items():
                    da, db = self._dev[t]
                    for sid in idx:
                        # a blocking copy from pageable host memory: the
                        # host row may be rewritten the moment it returns
                        da[:, sid].copy_(torch.from_numpy(ha[:, sid]))
                        db[:, sid].copy_(torch.from_numpy(hb[:, sid]))
            return self._dev
