"""Cross-request KV prefix cache over the paged arena — the port of
``paddle_tpu/inference/prefix_cache.py`` in its block-backed form.

A token-id trie over fixed-size token chunks. KV at position ``i`` is a
function of tokens ``[0, i]`` only (causal masks, absolute positions),
so a chunk computed for one request is what any other request with the
same prefix would compute: a new request reuses the longest cached
prefix and only its suffix runs through the model. Each node holds
REFERENCES to the pool blocks its chunk was prefilled into (one
``BlockAllocator`` reference per block), so a hit is a zero-copy splice
of block ids into the slot's table.

- **Ref-counting**: a slot that admitted against a trie path holds one
  reference per node from admission until its prompt is committed and
  its new chunks inserted; referenced nodes are never evicted.
- **LRU leaf-first eviction**: under the byte budget (``max_bytes``)
  and on demand when the pool runs short (:meth:`evict_for_blocks`),
  unreferenced LEAVES go oldest-``last_use`` first, so every cached
  path stays contiguous from the root.

Chunking rules: only FULL chunks are cached; a lookup never returns
more than ``(len(prompt) - 1) // chunk_tokens`` chunks, so the prompt's
last token always runs through the model (its logits sample the first
output token).

Not ported in this slice: the host tier (``bind_host_tier``, demotion,
promotion, peeling), the dense-arena form (``insert`` of host K/V
copies) and ``clone_empty`` for replicas.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.core.unported import refuse_unported

__all__ = ["PrefixCache", "PrefixCacheNode"]


class PrefixCacheNode:
    """One cached chunk: the token ids it covers (the edge key from its
    parent) and the ref-counted pool ``blocks`` holding its KV. The
    dense arena's host segments ``kseg``/``vseg`` are not ported: they
    must be None."""

    __slots__ = ("key", "parent", "children", "blocks", "nbytes", "refs",
                 "last_use")

    def __init__(self, key: Tuple[int, ...],
                 parent: Optional["PrefixCacheNode"], kseg, vseg,
                 blocks: Optional[List[int]] = None,
                 nbytes: Optional[int] = None):
        refuse_unported("PrefixCacheNode", kseg=(kseg, None),
                        vseg=(vseg, None))
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "PrefixCacheNode"] = {}
        self.blocks = blocks
        self.nbytes = int(nbytes) if nbytes is not None else 0
        self.refs = 0
        self.last_use = 0


class PrefixCache:
    """Token-chunk trie of reusable KV blocks under a byte budget.

    ``chunk_tokens`` is the trie granularity (a multiple of the paged
    arena's block size, checked at :meth:`bind_block_allocator`);
    ``max_bytes`` the budget over all cached blocks — inserts past it
    evict unreferenced LRU leaves, and when everything else is
    referenced the budget may be exceeded for a while. A cache belongs
    to ONE serving engine (one model, one weight snapshot): chunks are
    indexed by token ids only."""

    def __init__(self, chunk_tokens: int = 64, max_bytes: int = 1 << 30):
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got "
                             f"{chunk_tokens}")
        self.chunk_tokens = int(chunk_tokens)
        self.max_bytes = int(max_bytes)
        self.root = PrefixCacheNode((), None, None, None)
        self.bytes = 0
        self._allocator = None     # bound by the paged serving engine
        self._tick = 0
        # counted stats
        self.lookups = 0
        self.hits = 0              # lookups that matched >= 1 chunk
        self.hit_tokens = 0        # tokens served from the cache
        self.inserts = 0
        self.evictions = 0

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
                "nodes": self.node_count()}

    def _walk(self, prompt: Sequence[int]) -> List[PrefixCacheNode]:
        """The longest cached full-chunk path of ``prompt``, capped so the
        final prompt token stays uncached."""
        cc = self.chunk_tokens
        path: List[PrefixCacheNode] = []
        node = self.root
        for j in range((len(prompt) - 1) // cc):
            child = node.children.get(
                tuple(int(x) for x in prompt[j * cc:(j + 1) * cc]))
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def peek(self, prompt: Sequence[int]) -> int:
        """Longest cached prefix of ``prompt`` in tokens, without taking
        references, touching LRU order or counting a lookup."""
        return len(self._walk(prompt)) * self.chunk_tokens

    # -- lookup / refs ----------------------------------------------------
    def lookup(self, prompt: Sequence[int]
               ) -> Tuple[List[PrefixCacheNode], int]:
        """Longest cached prefix of ``prompt`` as ``(path, tokens)``.
        Every matched node is ref'd and LRU-touched; the caller MUST
        :meth:`release` the path once the admitted slot's prompt KV is
        committed."""
        self.lookups += 1
        self._tick += 1
        path = self._walk(prompt)
        for nd in path:
            nd.refs += 1
            nd.last_use = self._tick
        if path:
            self.hits += 1
            self.hit_tokens += len(path) * self.chunk_tokens
        return path, len(path) * self.chunk_tokens

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
        self._allocator = allocator

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
        parent = parent or self.root
        key = tuple(int(x) for x in key)
        if len(key) != self.chunk_tokens:
            raise ValueError(
                f"insert key has {len(key)} tokens; the trie is chunked "
                f"at {self.chunk_tokens}")
        self._tick += 1
        node = parent.children.get(key)
        if node is None:
            owned = [int(b) for b in blocks]
            self._allocator.ref(owned)
            node = PrefixCacheNode(
                key, parent, None, None, blocks=owned,
                nbytes=len(owned) * self._allocator.block_nbytes)
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
                       if all(alloc.refcount(b) == 1 for b in n.blocks)]
            if not victims:
                return False
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

    def _evict_node(self, victim: PrefixCacheNode):
        """Detach one leaf and return its blocks EXACTLY once."""
        del victim.parent.children[victim.key]
        self.bytes -= victim.nbytes
        blocks, victim.blocks = victim.blocks, None
        if blocks is not None:
            self._allocator.deref(blocks)
        self.evictions += 1

    def _evict_to_budget(self):
        # one walk collects the evictable leaves; evicting a leaf can
        # expose its parent, so re-walk while over budget
        while self.bytes > self.max_bytes:
            victims = self._evictable_leaves()
            if not victims:
                return      # everything left is referenced or interior
            victims.sort(key=lambda n: n.last_use)
            for victim in victims:
                if self.bytes <= self.max_bytes:
                    return
                self._evict_node(victim)

    def clear(self):
        """Drop every unreferenced node; a referenced path survives."""
        while True:
            victims = self._evictable_leaves()
            if not victims:
                return
            for victim in victims:
                self._evict_node(victim)
