"""Cross-request KV prefix cache — the port of
``paddle_tpu/inference/prefix_cache.py``.

A token-id trie over fixed-size token chunks. KV at position ``i`` is a
function of tokens ``[0, i]`` only (causal masks, absolute positions),
so a chunk computed for one request is what any other request with the
same prefix would compute: a new request reuses the longest cached
prefix and only its suffix runs through the model. Two forms:

- **Paged** (``bind_block_allocator``): each node holds REFERENCES to
  the pool blocks its chunk was prefilled into (one ``BlockAllocator``
  reference per block), so a hit is a zero-copy splice of block ids into
  the slot's table (:meth:`insert_blocks`).
- **Dense**: each node holds a copy of its chunk's K/V, an ``(L, chunk,
  H, D)`` segment pair taken out of the slot's arena rows
  (:meth:`insert`), which a hit copies into the admitted slot's rows.

- **Ref-counting**: a slot that admitted against a trie path holds one
  reference per node from admission until its prompt is committed and
  its new chunks inserted; referenced nodes are never evicted.
- **LRU leaf-first eviction**: under the byte budget (``max_bytes``)
  and on demand when the pool runs short (:meth:`evict_for_blocks`),
  unreferenced LEAVES go oldest-``last_use`` first, so every cached
  path stays contiguous from the root.

- **Host tier** (``bind_host_tier``, paged only): a cold leaf DEMOTES
  to host RAM before it is dropped — its KV parked in a ``HostTier``,
  the node kept in the trie — and a lookup that reaches a demoted node
  copies it back up (a host hit). When the tier itself is short, the
  oldest demoted leaves are dropped for a live request's spill
  (:meth:`reclaim_host_blocks`).

Chunking rules: only FULL chunks are cached; a lookup never returns
more than ``(len(prompt) - 1) // chunk_tokens`` chunks, so the prompt's
last token always runs through the model (its logits sample the first
output token).

An optional flight ``recorder`` (set by the serving engine) receives
``trie_promote``, ``trie_demote`` and ``trie_evict`` events.

Not ported yet: ``clone_empty`` for replicas.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixCache", "PrefixCacheNode"]


class PrefixCacheNode:
    """One cached chunk: the token ids it covers (the edge key from its
    parent) and its KV — a dense engine's ``(L, chunk, H, D)`` segment
    pair ``kseg``/``vseg``, or the ref-counted pool ``blocks`` of a
    paged engine. A DEMOTED node (host tier) has ``blocks`` None and its
    KV in the tier's ``host_blocks``."""

    __slots__ = ("key", "parent", "children", "kseg", "vseg", "blocks",
                 "host_blocks", "nbytes", "refs", "last_use")

    def __init__(self, key: Tuple[int, ...],
                 parent: Optional["PrefixCacheNode"], kseg, vseg,
                 blocks: Optional[List[int]] = None,
                 nbytes: Optional[int] = None):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "PrefixCacheNode"] = {}
        self.kseg = kseg
        self.vseg = vseg
        self.blocks = blocks
        self.host_blocks: Optional[List[int]] = None
        self.nbytes = int(nbytes) if nbytes is not None else (
            int(getattr(kseg, "nbytes", 0)) + int(getattr(vseg, "nbytes", 0)))
        self.refs = 0
        self.last_use = 0


class PrefixCache:
    """Token-chunk trie of reusable KV blocks under a byte budget.

    ``chunk_tokens`` is the trie granularity (on the paged arena a
    multiple of the block size, checked at :meth:`bind_block_allocator`);
    ``max_bytes`` the budget over all cached KV on the device — inserts
    past it evict unreferenced LRU leaves (demoting them where a host
    tier is bound), and when everything else is referenced the budget
    may be exceeded for a while. A cache belongs to ONE serving engine
    (one model, one weight snapshot): chunks are indexed by token ids
    only."""

    def __init__(self, chunk_tokens: int = 64, max_bytes: int = 1 << 30):
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got "
                             f"{chunk_tokens}")
        self.chunk_tokens = int(chunk_tokens)
        self.max_bytes = int(max_bytes)
        self.root = PrefixCacheNode((), None, None, None)
        self.bytes = 0
        self._allocator = None     # bound by the paged serving engine
        # the host tier and the engine's copy closures (bind_host_tier):
        # the trie is host policy, the copies are the engine's
        self._host_tier = None
        self._spill_fn = None
        self._promote_fn = None
        self._tick = 0
        # counted stats
        self.lookups = 0
        self.hits = 0              # lookups that matched >= 1 chunk
        self.hit_tokens = 0        # tokens served from the cache
        self.inserts = 0
        self.evictions = 0         # hard drops (the node left the trie)
        # the host tier's: demotions (device -> host), host drops (a
        # demoted node dropped), host hits (a demoted node copied back
        # by a lookup), promotions that failed
        self.host_demotions = 0
        self.host_drops = 0
        self.host_hits = 0
        self.host_hit_tokens = 0
        self.promote_failures = 0
        # optional FlightRecorder (set by the serving engine): trie
        # evictions are postmortem evidence
        self.recorder = None

    # -- queries ----------------------------------------------------------
    def iter_nodes(self):
        """Every live node (root excluded), in no particular order; no
        mutation during the walk."""
        stack = [self.root]
        while stack:
            nd = stack.pop()
            for child in nd.children.values():
                yield child
                stack.append(child)

    def node_count(self) -> int:
        return sum(1 for _ in self.iter_nodes())

    def stats(self) -> Dict[str, float]:
        return {"lookups": self.lookups, "hits": self.hits,
                "hit_tokens": self.hit_tokens, "inserts": self.inserts,
                "evictions": self.evictions, "bytes": self.bytes,
                "nodes": self.node_count(),
                "host_demotions": self.host_demotions,
                "host_drops": self.host_drops,
                "host_hits": self.host_hits,
                "host_hit_tokens": self.host_hit_tokens,
                "promote_failures": self.promote_failures}

    def peek(self, prompt: Sequence[int]) -> int:
        """Longest cached prefix of ``prompt`` in tokens, without taking
        references, touching LRU order, promoting demoted chunks or
        counting a lookup. A demoted chunk counts: a lookup would copy
        it back. Capped as :meth:`lookup` is."""
        cc = self.chunk_tokens
        matched = 0
        node = self.root
        for j in range((len(prompt) - 1) // cc):
            child = node.children.get(
                tuple(int(x) for x in prompt[j * cc:(j + 1) * cc]))
            if child is None or (child.blocks is None
                                 and child.host_blocks is None
                                 and child.kseg is None):
                break
            matched += 1
            node = child
        return matched * cc

    # -- lookup / refs ----------------------------------------------------
    def lookup(self, prompt: Sequence[int]
               ) -> Tuple[List[PrefixCacheNode], int]:
        """Longest cached prefix of ``prompt`` as ``(path, tokens)``,
        capped so the final prompt token stays uncached. A demoted node
        on the path is copied back to the device first; a promotion that
        fails ends the match there (the suffix recomputes, and the node
        stays parked). Every matched node is ref'd and LRU-touched; the
        caller MUST :meth:`release` the path once the admitted slot's
        prompt KV is committed."""
        cc = self.chunk_tokens
        self.lookups += 1
        self._tick += 1
        path: List[PrefixCacheNode] = []
        node = self.root
        for j in range((len(prompt) - 1) // cc):
            child = node.children.get(
                tuple(int(x) for x in prompt[j * cc:(j + 1) * cc]))
            if child is None:
                break
            if child.blocks is None and child.host_blocks is not None \
                    and not self._promote_node(child):
                break
            path.append(child)
            node = child
        for nd in path:
            nd.refs += 1
            nd.last_use = self._tick
        if path:
            self.hits += 1
            self.hit_tokens += len(path) * cc
        return path, len(path) * cc

    def _promote_node(self, node: PrefixCacheNode) -> bool:
        """Copy one demoted chunk back to the device: on success the
        node holds fresh pool blocks (the grant's reference passes to
        the trie) and its host blocks return to the tier, counted as a
        host hit. Any failure is a miss, never a request fault."""
        if self._promote_fn is None:
            return False
        try:
            dev = self._promote_fn(node.host_blocks)
        except Exception:
            dev = None
        if dev is None:
            self.promote_failures += 1
            return False
        host, node.host_blocks = node.host_blocks, None
        node.blocks = [int(b) for b in dev]
        self._host_tier.deref(host, restored=True)
        self.bytes += node.nbytes   # back on the device budget
        self.host_hits += 1
        self.host_hit_tokens += self.chunk_tokens
        if self.recorder is not None:
            self.recorder.record("trie_promote", tokens=len(node.key),
                                 blocks=list(node.blocks))
        return True

    def release(self, nodes: Sequence[PrefixCacheNode]):
        if any(nd.refs <= 0 for nd in nodes):
            # validate BEFORE mutating: a partial decrement followed by a
            # retry would double-release the survivors
            raise RuntimeError(
                "PrefixCache.release() without a matching lookup/insert "
                "ref — double release corrupts the eviction guard")
        for nd in nodes:
            nd.refs -= 1
        # refs were all that kept an over-budget cache from evicting
        self._evict_to_budget()

    def acquire_child(self, parent: Optional[PrefixCacheNode],
                      key: Sequence[int]) -> Optional[PrefixCacheNode]:
        """Ref + LRU-touch the child of ``parent`` covering ``key`` if
        another request already inserted it, else None. Release it with
        the rest of the held path."""
        node = (parent or self.root).children.get(
            tuple(int(x) for x in key))
        if node is not None:
            self._tick += 1
            node.refs += 1
            node.last_use = self._tick
        return node

    # -- block-backed nodes -----------------------------------------------
    def bind_block_allocator(self, allocator):
        """Attach the paged engine's block allocator. ``chunk_tokens``
        must be whole blocks, so a cached chunk is an exact block run and
        a hit splices block ids without splitting a block."""
        if self._allocator is not None and self._allocator is not allocator:
            raise RuntimeError(
                "PrefixCache is already bound to a block allocator; a "
                "cache instance belongs to ONE serving engine")
        if self.chunk_tokens % allocator.block_size:
            raise ValueError(
                f"chunk_tokens {self.chunk_tokens} must be a multiple "
                f"of the paged arena's block_size "
                f"{allocator.block_size} for zero-copy prefix sharing")
        if self.node_count() and self._allocator is None:
            raise RuntimeError(
                "PrefixCache already holds host-copied segments; bind "
                "a fresh cache to a paged engine")
        self._allocator = allocator

    def bind_host_tier(self, tier, spill, promote):
        """Tiered eviction on a block-bound cache: a cold node DEMOTES
        to ``tier`` (a :class:`~paddle_tpu_torch.inference.block_pool.
        HostTier`) before it is dropped, and a lookup that reaches a
        demoted node copies it back. ``spill(blocks) -> host ids |
        None`` and ``promote(host ids) -> device blocks | None`` are the
        serving engine's copy closures."""
        if self._allocator is None:
            raise RuntimeError(
                "bind_host_tier needs bind_block_allocator() first — "
                "demotion parks POOL blocks, not host segments")
        if self._host_tier is not None and self._host_tier is not tier:
            raise RuntimeError(
                "PrefixCache is already bound to a host tier; a cache "
                "instance belongs to ONE serving engine")
        self._host_tier = tier
        self._spill_fn = spill
        self._promote_fn = promote

    def insert_blocks(self, parent: Optional[PrefixCacheNode],
                      key: Tuple[int, ...],
                      blocks: Sequence[int]) -> PrefixCacheNode:
        """Attach one chunk under ``parent`` (None = root) whose KV lives
        in ``blocks``; the trie takes ONE reference per block. First
        writer wins: if the chunk exists the passed blocks are not ref'd
        and the existing node is returned. Either way the returned node
        carries one reference for the caller."""
        if self._allocator is None:
            raise RuntimeError(
                "insert_blocks needs bind_block_allocator() first")
        expect = self.chunk_tokens // self._allocator.block_size
        if len(blocks) != expect:
            raise ValueError(
                f"chunk of {self.chunk_tokens} tokens covers {expect} "
                f"blocks, got {len(blocks)}")

        def make(k, p):
            owned = [int(b) for b in blocks]
            self._allocator.ref(owned)
            return PrefixCacheNode(
                k, p, None, None, blocks=owned,
                nbytes=len(owned) * self._allocator.block_nbytes)

        return self._attach(parent, key, make)

    def insert(self, parent: Optional[PrefixCacheNode],
               key: Tuple[int, ...], kseg, vseg) -> PrefixCacheNode:
        """Dense counterpart of :meth:`insert_blocks`: attach one chunk
        under ``parent`` (None = root) holding the segment pair ``kseg``,
        ``vseg``. First writer wins (the passed segments are dropped if
        the chunk exists; both are the same KV by construction); the
        returned node carries one reference for the caller."""
        return self._attach(
            parent, key, lambda k, p: PrefixCacheNode(k, p, kseg, vseg))

    def _attach(self, parent: Optional[PrefixCacheNode],
                key: Tuple[int, ...], make_node) -> PrefixCacheNode:
        """The one copy of the attach protocol both inserts share: key
        check, first-writer-wins child lookup (``make_node`` runs only
        for a new chunk — a block payload takes its references there),
        byte and insert accounting, one caller reference and LRU touch,
        then eviction to the budget."""
        parent = parent or self.root
        key = tuple(int(x) for x in key)
        if len(key) != self.chunk_tokens:
            raise ValueError(
                f"insert key has {len(key)} tokens; the trie is chunked "
                f"at {self.chunk_tokens}")
        self._tick += 1
        node = parent.children.get(key)
        if node is None:
            node = make_node(key, parent)
            parent.children[key] = node
            self.bytes += node.nbytes
            self.inserts += 1
        node.refs += 1
        node.last_use = self._tick
        self._evict_to_budget()
        return node

    def evict_for_blocks(self, need: int) -> bool:
        """Evict unreferenced leaves (LRU, leaf-first) until the bound
        allocator has ``need`` free blocks. Only leaves whose blocks the
        trie holds ALONE free memory; a leaf spliced into a live slot is
        skipped. False when nothing more can be evicted."""
        if self._allocator is None:
            raise RuntimeError(
                "evict_for_blocks needs bind_block_allocator() first")
        alloc = self._allocator
        while alloc.free_count() < need:
            victims = [n for n in self._evictable_leaves()
                       if n.blocks is not None
                       and all(alloc.refcount(b) == 1 for b in n.blocks)]
            if not victims:
                # demoted leaves free no device blocks, but they hide
                # device-backed parents from the leaf-first walk: drop
                # one and look again
                if not self._peel_lru_demoted():
                    return False
                continue
            victims.sort(key=lambda n: n.last_use)
            for victim in victims:
                if alloc.free_count() >= need:
                    break
                self._evict_node(victim)
        return True

    # -- eviction ---------------------------------------------------------
    def _evictable_leaves(self) -> List[PrefixCacheNode]:
        victims = []
        stack = [self.root]
        while stack:
            nd = stack.pop()
            for child in nd.children.values():
                if child.children:
                    stack.append(child)
                elif child.refs == 0:
                    victims.append(child)
        return victims

    def _demote_node(self, victim: PrefixCacheNode) -> bool:
        """Park one block-backed leaf's KV in the host tier and free its
        device blocks; the node STAYS in the trie, so paths stay
        contiguous. False when the tier cannot take it (full even after
        dropping older demoted nodes, or the spill raised): the caller
        drops the node."""
        if self._spill_fn is None or victim.blocks is None:
            return False
        try:
            host = self._spill_fn(victim.blocks)
            if host is None and self.reclaim_host_blocks(
                    len(victim.blocks), protect=victim):
                # older parked chunks are worth less than this fresher
                # victim: drop the oldest demoted nodes and retry once
                host = self._spill_fn(victim.blocks)
        except Exception:
            return False    # a failed spill degrades to the drop
        if host is None:
            return False
        blocks, victim.blocks = victim.blocks, None
        victim.host_blocks = [int(b) for b in host]
        self._allocator.deref(blocks)
        self.bytes -= victim.nbytes     # off the device budget
        self.host_demotions += 1
        if self.recorder is not None:
            self.recorder.record("trie_demote", tokens=len(victim.key),
                                 nbytes=victim.nbytes,
                                 host_blocks=list(victim.host_blocks))
        return True

    def reclaim_host_blocks(self, need: int, protect=None) -> bool:
        """Drop demoted leaves (LRU first, never ``protect``) until the
        host tier has ``need`` free blocks: parked cold prefixes are
        reclaimable capacity for a live request's spill. False when the
        target cannot be reached."""
        if self._host_tier is None:
            return False
        while self._host_tier.free_count() < need:
            victims = [n for n in self._evictable_leaves()
                       if n.host_blocks is not None and n is not protect]
            if not victims:
                return False
            victims.sort(key=lambda n: n.last_use)
            for victim in victims:
                if self._host_tier.free_count() >= need:
                    break
                self._evict_node(victim, demote=False)
        return True

    def _peel_lru_demoted(self) -> bool:
        """Drop the least recently used demoted evictable leaf: the one
        copy of the rule both device-pressure paths share. Demoted
        leaves free no device memory themselves but hide device-backed
        parents from the leaf-first walk; one a round, since each drop
        loses a future host hit. False when none is evictable."""
        demoted = [n for n in self._evictable_leaves()
                   if n.host_blocks is not None]
        if not demoted:
            return False
        self._evict_node(min(demoted, key=lambda n: n.last_use),
                         demote=False)
        return True

    def _evict_node(self, victim: PrefixCacheNode, demote: bool = True):
        """Evict one leaf: with a host tier bound, a block-backed node
        DEMOTES first (``demote=False`` forces the drop); otherwise it
        leaves the trie and returns its storage EXACTLY once — segments
        dropped, pool blocks deref'd, parked host blocks returned to the
        tier."""
        if demote and self._host_tier is not None \
                and victim.blocks is not None \
                and self._demote_node(victim):
            return
        if self.recorder is not None:
            self.recorder.record(
                "trie_evict", tokens=len(victim.key),
                nbytes=victim.nbytes,
                blocks=list(victim.blocks) if victim.blocks is not None
                else None,
                host_blocks=list(victim.host_blocks)
                if victim.host_blocks is not None else None)
        del victim.parent.children[victim.key]
        demoted = victim.host_blocks is not None
        if not demoted:
            # a demoted node already left the device budget
            self.bytes -= victim.nbytes
        victim.kseg = victim.vseg = None
        if victim.blocks is not None:
            blocks, victim.blocks = victim.blocks, None
            self._allocator.deref(blocks)
        if demoted:
            host, victim.host_blocks = victim.host_blocks, None
            self._host_tier.deref(host)
            self.host_drops += 1
        self.evictions += 1

    def _evict_to_budget(self):
        # one walk collects the evictable leaves; evicting a leaf can
        # expose its parent, so re-walk while over budget
        while self.bytes > self.max_bytes:
            # demoted leaves are off the device budget: dropping them
            # frees nothing it counts
            victims = [n for n in self._evictable_leaves()
                       if n.host_blocks is None]
            if not victims:
                # only demoted leaves left: they hide the on-budget
                # parents, so drop one and look again
                if not self._peel_lru_demoted():
                    return  # everything left is referenced or interior
                continue
            victims.sort(key=lambda n: n.last_use)
            for victim in victims:
                if self.bytes <= self.max_bytes:
                    return
                self._evict_node(victim)

    def clear(self):
        """Drop every unreferenced node, demoted ones included (nothing
        demotes on the way out); a referenced path survives."""
        while True:
            victims = self._evictable_leaves()
            if not victims:
                return
            for victim in victims:
                self._evict_node(victim, demote=False)
