"""Host-side block allocator for the paged KV arena.

The port's own copy of ``paddle_tpu/inference/block_pool.py``'s
``BlockAllocator`` (:55), single replica: a LIFO free list plus
per-block reference counts over one pool of ``num_blocks`` blocks. The
engine's kernels never see it — they take the block table and offsets as
tensors.

Block 0 is the SCRATCH SINK and is never handed out: idle slots keep
computing in the lockstep decode, and their garbage writes land in
whatever their all-zero table rows point at. Double frees are a hard
error, checked before anything is mutated.

Not ported in this slice: the host tier, replica planes and ``reconcile``.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

import numpy as np

from paddle_tpu_torch.core.unported import refuse_unported

__all__ = ["BlockAllocator"]


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

    def free_count(self, replica: Optional[int] = None) -> int:
        _one_plane(replica)
        return len(self._free)

    def blocks_in_use(self, replica: Optional[int] = None) -> int:
        _one_plane(replica)
        return self.capacity - len(self._free)

    def refcount(self, block: int, replica: int = 0) -> int:
        _one_plane(replica)
        return int(self._refs[block])

    def alloc(self, n: int, replica: int = 0) -> Optional[List[int]]:
        """Pop ``n`` fresh blocks (one reference each), or None — never a
        partial grant — when fewer than ``n`` are free."""
        _one_plane(replica)
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        self.allocs += n
        self.peak = max(self.peak, self.blocks_in_use())
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
        for b, n in Counter(int(x) for x in blocks).items():
            if self._refs[b] < n:
                raise RuntimeError(
                    f"BlockAllocator.deref x{n} on block {b} with "
                    f"{int(self._refs[b])} reference(s) — double free "
                    "corrupts the pool")
        freed = 0
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(int(b))
                freed += 1
        self.freed += freed
        return freed
