"""Host-side block allocator for the paged KV arena, and the host tier
under it.

The port's own copy of ``paddle_tpu/inference/block_pool.py``'s
``BlockAllocator`` (:55), single replica: a LIFO free list plus
per-block reference counts over one pool of ``num_blocks`` blocks. The
engine's kernels never see it — they take the block table and offsets as
tensors.

Block 0 is the SCRATCH SINK and is never handed out: idle slots keep
computing in the lockstep decode, and their garbage writes land in
whatever their all-zero table rows point at. Double frees are a hard
error, checked before anything is mutated.

:class:`HostTier` (reference :315) is host RAM under the device pool:
the same free list and reference counts over host blocks shaped like
device blocks, where a preempted request's committed KV and a demoted
trie node's KV park until they are copied back.

Both carry the serving chaos points — ``serving:alloc`` on every grant
(reference :206) and ``serving:spill_write`` on every tier write
(:472) — and an optional flight ``recorder`` that receives
``block_alloc``, ``block_free``, ``host_block_free``, ``host_spill``
and ``host_swap_in`` events. :meth:`BlockAllocator.reconcile` and
:meth:`HostTier.reconcile` are what ``ServingEngine.audit()`` checks
the pools with.

Not ported yet: replica planes.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.unported import refuse_unported
from paddle_tpu_torch.testing.fault_injection import fault_point

__all__ = ["BlockAllocator", "HostTier"]


def _check_deref(refs: np.ndarray, blocks: Sequence[int], what: str):
    """The one copy of the double-free check both pools share
    (reference :39): every pending decrement is validated BEFORE
    anything is mutated, duplicates within this call included."""
    for b, n in Counter(int(x) for x in blocks).items():
        if refs[b] < n:
            raise RuntimeError(
                f"{what}.deref x{n} on block {b} with "
                f"{int(refs[b])} reference(s) — double free corrupts "
                "the pool")


def _one_plane(replica):
    """The allocator has one plane: ``replica`` may name it (0) or be
    left unset."""
    if replica not in (None, 0):
        raise NotImplementedError(
            f"BlockAllocator: replica={replica!r} is not ported yet; the "
            "port's allocator has one plane (replica 0)")


class BlockAllocator:
    """Free-list + refcount allocator over ``num_blocks`` pool blocks
    (including the reserved scratch block 0; ``capacity`` =
    ``num_blocks - 1`` are allocatable). ``block_nbytes`` is what one
    block pins across all layers (K + V), the unit of
    ``kv_bytes_in_use``. One plane: the reference's ``devices`` and
    ``replicas`` are accepted at their defaults only, and a method's
    ``replica`` must name plane 0."""

    def __init__(self, num_blocks: int, block_size: int, block_nbytes: int,
                 devices: int = 1, replicas: int = 1):
        refuse_unported("BlockAllocator", devices=(devices, 1),
                        replicas=(replicas, 1))
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 pool blocks (block 0 is the scratch sink), "
                f"got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.block_nbytes = int(block_nbytes)
        self.capacity = self.num_blocks - 1
        # LIFO: recently freed blocks are re-used first
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._refs = np.zeros((self.num_blocks,), np.int32)
        # counted stats; `peak` is updated inside alloc() so a grow-then-
        # retire spike within one tick is never missed by samplers
        self.allocs = 0
        self.freed = 0
        self.peak = 0
        # optional FlightRecorder: block churn is postmortem evidence
        self.recorder = None

    def free_count(self, replica: Optional[int] = None) -> int:
        _one_plane(replica)
        return len(self._free)

    def blocks_in_use(self, replica: Optional[int] = None) -> int:
        _one_plane(replica)
        return self.capacity - len(self._free)

    def refcount(self, block: int, replica: int = 0) -> int:
        _one_plane(replica)
        return int(self._refs[block])

    def reconcile(self, expected: Dict[int, int],
                  replica: int = 0) -> Dict[str, int]:
        """Audit the pool against ``expected``, the holder count per
        block the caller can account for (live slots' table entries plus
        prefix-trie references): ``leaked_blocks`` carry more references
        than holders, ``missing_refs`` fewer (a legitimate deref would
        double-free), ``free_list_errors`` count free-list entries with
        references, referenced blocks missing from both, and a
        circulating scratch block. Pure read."""
        _one_plane(replica)
        free = set(self._free)
        leaked = missing = flerr = 0
        if 0 in free or self._refs[0] != 0 or 0 in expected:
            flerr += 1          # the scratch sink must never circulate
        for b in range(1, self.num_blocks):
            refs = int(self._refs[b])
            want = int(expected.get(b, 0))
            if refs > want:
                leaked += 1
            elif refs < want:
                missing += 1
            if (b in free) != (refs == 0):
                flerr += 1
        return {"leaked_blocks": leaked, "missing_refs": missing,
                "free_list_errors": flerr}

    def alloc(self, n: int, replica: int = 0) -> Optional[List[int]]:
        """Pop ``n`` fresh blocks (one reference each), or None — never a
        partial grant — when fewer than ``n`` are free."""
        _one_plane(replica)
        if n < 0:
            raise ValueError(f"alloc({n})")
        # chaos hook: an armed injector fails this grant like a real
        # allocator fault would
        fault_point("serving:alloc", n=n, free=len(self._free),
                    replica=replica)
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        self.allocs += n
        self.peak = max(self.peak, self.blocks_in_use())
        if self.recorder is not None and n:
            self.recorder.record("block_alloc", n=n, replica=replica,
                                 in_use=self.blocks_in_use(),
                                 free=len(self._free))
        return out

    def ref(self, blocks: Sequence[int], replica: int = 0):
        """One more holder per block; only live blocks can gain one."""
        _one_plane(replica)
        for b in blocks:
            if self._refs[b] <= 0:
                raise RuntimeError(
                    f"BlockAllocator.ref on free block {int(b)} — "
                    "references can only be added to live blocks")
            self._refs[b] += 1

    def deref(self, blocks: Sequence[int], replica: int = 0) -> int:
        """Drop one reference per block; blocks reaching zero return to
        the free list. Returns how many were freed. A deref past zero —
        duplicates within this call included — raises before mutating."""
        _one_plane(replica)
        _check_deref(self._refs, blocks, "BlockAllocator")
        freed = 0
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(int(b))
                freed += 1
        self.freed += freed
        if self.recorder is not None and freed:
            self.recorder.record("block_free", n=freed, replica=replica,
                                 in_use=self.blocks_in_use(),
                                 free=len(self._free))
        return freed


class HostTier:
    """Host-RAM tier UNDER the device block pool (reference :315).

    A free list and reference counts, as :class:`BlockAllocator`'s, over
    ``num_blocks`` host blocks sized like device blocks: one ``(L,
    block_size, H, D)`` K and V segment a block at the pool's ``dtype``
    and, when ``quantized``, the ``(L, H)`` fp32 absmax scale rows, so a
    spilled block round-trips bit-exact (int8 codes and their scales).
    The storage is torch CPU tensors allocated up front — the tier's
    capacity is budgeted like the pool's — and pinned with
    ``pin_memory=True`` (the serving engine asks for it on the card), so
    that a spill copies device rows straight into the tier and a read
    hands the restore a pinned buffer: both transfers are DMA copies,
    with no pageable staging.

    No kernel reads host blocks, so every block is allocatable (no
    scratch sink). Holders are preempted requests carrying a spill
    manifest and demoted prefix-trie nodes; :meth:`reconcile` audits the
    tier against what the engine can account for.

    Counted stats: ``spills`` and ``swap_ins`` in blocks,
    ``bytes_spilled`` and ``bytes_restored``, and ``drops`` (host blocks
    released without a swap-back: parked work abandoned)."""

    def __init__(self, num_blocks: int, block_size: int, layers: int,
                 heads: int, head_dim: int, dtype=torch.float32,
                 quantized: bool = False, *, pin_memory: bool = False):
        if num_blocks < 1:
            raise ValueError(
                f"host tier needs >= 1 block, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.L = int(layers)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.quantized = bool(quantized)
        self.pin_memory = bool(pin_memory)
        shape = (self.num_blocks, self.L, self.block_size, self.heads,
                 self.head_dim)

        def host(shape, dt):
            return torch.zeros(shape, dtype=dt, pin_memory=pin_memory)

        self.kdata = host(shape, self.dtype)
        self.vdata = host(shape, self.dtype)
        self.kscale = self.vscale = None
        scale_nbytes = 0
        if self.quantized:
            sshape = (self.num_blocks, self.L, self.heads)
            self.kscale = host(sshape, torch.float32)
            self.vscale = host(sshape, torch.float32)
            scale_nbytes = 2 * self.L * self.heads * 4
        self.block_nbytes = (
            2 * self.L * self.block_size * self.heads * self.head_dim
            * self.kdata.element_size() + scale_nbytes)
        self.capacity = self.num_blocks
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._refs = np.zeros((self.num_blocks,), np.int32)
        # counted stats
        self.spills = 0          # blocks written into the tier
        self.swap_ins = 0        # blocks restored to the device pool
        self.drops = 0           # blocks freed without a swap-back
        self.bytes_spilled = 0
        self.bytes_restored = 0
        self.recorder = None     # optional FlightRecorder

    # -- queries ----------------------------------------------------------
    def free_count(self) -> int:
        return len(self._free)

    def blocks_in_use(self) -> int:
        return self.capacity - len(self._free)

    def bytes_in_use(self) -> int:
        return self.blocks_in_use() * self.block_nbytes

    def refcount(self, block: int) -> int:
        return int(self._refs[block])

    def reconcile(self, expected: Dict[int, int]) -> Dict[str, int]:
        """Audit the tier against ``expected`` holder counts per host
        block (spill manifests of queued requests plus demoted trie
        nodes). Pure read."""
        free = set(self._free)
        leaked = missing = flerr = 0
        for b in range(self.num_blocks):
            refs = int(self._refs[b])
            want = int(expected.get(b, 0))
            if refs > want:
                leaked += 1
            elif refs < want:
                missing += 1
            if (b in free) != (refs == 0):
                flerr += 1
        return {"leaked_host_blocks": leaked,
                "missing_host_refs": missing,
                "host_free_list_errors": flerr}

    # -- alloc / ref / deref ----------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` host blocks (one reference each) or None — never a
        partial grant, so a spill parks all of a victim's blocks or
        none."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def ref(self, blocks: Sequence[int]):
        for b in blocks:
            if self._refs[b] <= 0:
                raise RuntimeError(
                    f"HostTier.ref on free host block {int(b)} — "
                    "references can only be added to live blocks")
            self._refs[b] += 1

    def deref(self, blocks: Sequence[int], restored: bool = False,
              aborted: bool = False) -> int:
        """Drop one reference per block; blocks reaching zero return to
        the free list. ``restored=True`` counts the release as a
        completed swap-back, ``aborted=True`` as neither (a grant undone
        before anything was parked), else as a drop. A double free
        raises before anything is mutated."""
        _check_deref(self._refs, blocks, "HostTier")
        freed = 0
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(int(b))
                freed += 1
        if not restored and not aborted:
            self.drops += freed
        if self.recorder is not None and freed:
            self.recorder.record("host_block_free", n=freed,
                                 restored=bool(restored),
                                 in_use=self.blocks_in_use())
        return freed

    # -- data plane --------------------------------------------------------
    def write(self, blocks: Sequence[int], kseg, vseg,
              kscale=None, vscale=None):
        """Park block data: ``kseg``/``vseg`` are ``(n, L, block_size,
        H, D)`` tensors (the engine's gathered pool rows, on any device),
        ``kscale``/``vscale`` the ``(n, L, H)`` absmax rows when
        quantized. Each block is one blocking copy into its slot of the
        tier: every byte has landed when this returns, before the caller
        recycles the device blocks. The counters move only after every
        copy, so a raise (the ``serving:spill_write`` chaos point
        included) leaves the grant releasable by the caller."""
        fault_point("serving:spill_write", n=len(blocks))
        if self.quantized and (kscale is None or vscale is None):
            raise ValueError(
                "quantized host tier needs the absmax scale rows "
                "spilled with the int8 codes")
        pairs = [(self.kdata, kseg), (self.vdata, vseg)]
        if self.quantized:
            pairs += [(self.kscale, kscale), (self.vscale, vscale)]
        for dst, src in pairs:
            for j, b in enumerate(blocks):
                dst[int(b)].copy_(src[j])
        n = len(blocks)
        self.spills += n
        self.bytes_spilled += n * self.block_nbytes
        if self.recorder is not None and n:
            self.recorder.record("host_spill", n=n,
                                 in_use=self.blocks_in_use())

    def read(self, blocks: Sequence[int]) -> Tuple:
        """Parked block data ``(kseg, vseg, kscale, vscale)`` in the
        layout :meth:`write` took (scales None at full precision), as
        new host tensors, pinned like the tier. Counted at the restore
        site, not here."""
        idx = torch.as_tensor(list(blocks), dtype=torch.int64)

        def take(src):
            out = torch.empty((len(idx),) + tuple(src.shape[1:]),
                              dtype=src.dtype, pin_memory=self.pin_memory)
            return torch.index_select(src, 0, idx, out=out)

        ks = vs = None
        if self.quantized:
            ks, vs = take(self.kscale), take(self.vscale)
        return take(self.kdata), take(self.vdata), ks, vs

    def count_swap_in(self, n: int):
        """Record ``n`` blocks restored to the device pool (after the
        device-side write succeeded)."""
        self.swap_ins += int(n)
        self.bytes_restored += int(n) * self.block_nbytes
        if self.recorder is not None and n:
            self.recorder.record("host_swap_in", n=int(n),
                                 in_use=self.blocks_in_use())
