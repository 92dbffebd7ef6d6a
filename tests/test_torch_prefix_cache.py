"""Port prefix cache (``paddle_tpu_torch.inference.prefix_cache``) and its
engine path against the JAX package's.

- The trie: one sequence of lookups, inserts, releases, demand and
  budget evictions over a port ``BlockAllocator`` and the JAX one leaves
  equal stats, node keys, refcounts, LRU ticks and allocator state.
- The engine: the single-replica paged traces of
  ``tests/test_prefix_cache.py:63-135``, ``tests/test_paged_kv.py:178-280``
  and ``:606-626``, on fp32 and on int8 pools. Greedy tokens equal the
  JAX engine's and the port's own with the cache off; the counted
  ``prefix_hit_tokens``, ``prefill_chunks``, ``evictions`` and
  ``preemptions`` equal the JAX engine's; after every run the trie holds
  every block still in use, and clearing it drains the pool to
  ``capacity``. The int8 JAX runs read positions from ``t`` (see
  ``tests/test_torch_int8.py``).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.block_pool import BlockAllocator as JaxAllocator
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxCache
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from test_torch_int8 import _read_jax_positions_from_t

from paddle_tpu_torch.inference import (BlockAllocator, PrefixCache, Request,
                                        ServingEngine)
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

SYS = [7, 3, 9, 11, 2, 5, 8, 4] * 4          # 32-token shared prefix
TRIE_STATS = ("lookups", "hits", "hit_tokens", "inserts", "evictions",
              "bytes", "nodes")


# ------------------------------------------------------------------ the trie
def _nodes(cache):
    """{key path: (refs, blocks, last_use, nbytes)} of every live node."""
    out, stack = {}, [((), cache.root)]
    while stack:
        path, nd = stack.pop()
        for key, child in nd.children.items():
            p = path + (key,)
            out[p] = (child.refs, child.blocks, child.last_use, child.nbytes)
            stack.append((p, child))
    return out


def _same_state(jc, pc, ja, pa, what):
    js, ps = jc.stats(), pc.stats()
    assert {k: ps[k] for k in TRIE_STATS} == \
        {k: js[k] for k in TRIE_STATS}, what
    assert _nodes(pc) == _nodes(jc), what
    assert pa._free == ja._free[0], what
    np.testing.assert_array_equal(pa._refs, ja._refs[0], err_msg=what)


def test_trie_same_ops_same_state():
    """Chunk 4 over blocks of 2 (two blocks a chunk), a budget of 5
    chunks. Branching inserts, first-writer-wins, lookups capped before
    the last token, LRU demand eviction that skips blocks a slot still
    maps, budget eviction that spares referenced nodes, and clear()."""
    ja = JaxAllocator(num_blocks=24, block_size=2, block_nbytes=10)
    pa = BlockAllocator(num_blocks=24, block_size=2, block_nbytes=10)
    jc = JaxCache(chunk_tokens=4, max_bytes=100)
    pc = PrefixCache(chunk_tokens=4, max_bytes=100)
    jc.bind_block_allocator(ja)
    pc.bind_block_allocator(pa)
    A, B2, C, D2 = [1, 2, 3, 4], [5, 6, 7, 8], [9, 9, 9, 9], [4, 3, 2, 1]
    held = {}

    def both(op, *args, tag=None):
        jr, pr = op(jc, ja, *args), op(pc, pa, *args)
        if tag is not None:
            held[tag] = (jr, pr)
        return jr, pr

    def insert(parent_tag, key, n):
        def op(cache, alloc, *_):
            blocks = alloc.alloc(n)
            parent = None if parent_tag is None else \
                held[parent_tag][0 if cache is jc else 1]
            node = cache.insert_blocks(parent, key, blocks)
            alloc.deref(blocks)     # the slot retires: the trie holds on
            return node
        return op

    both(insert(None, A, 2), tag="a")
    both(insert("a", B2, 2), tag="ab")
    both(insert(None, D2, 2), tag="d")
    _same_state(jc, pc, ja, pa, "after three inserts")
    for tag in ("a", "ab", "d"):
        both(lambda c, _a, t=tag: c.release([held[t][0 if c is jc else 1]]))
    # first writer wins: a second insert of A returns the existing node
    jr, pr = both(insert(None, A, 2))
    assert jr is held["a"][0] and pr is held["a"][1]
    both(lambda c, _a: c.release([held["a"][0 if c is jc else 1]]))
    # lookups: the final token never comes from the cache
    for prompt in (A + B2 + C, A + B2, A + [0], D2 + C + [1], C):
        jr, pr = both(lambda c, _a, p=prompt: c.lookup(p))
        assert pr[1] == jr[1]
        assert [n.key for n in pr[0]] == [n.key for n in jr[0]]
        both(lambda c, _a, r=(jr, pr): c.release(r[0 if c is jc else 1][0]))
    _same_state(jc, pc, ja, pa, "after lookups")
    # acquire_child of an existing chunk and of a missing one
    jr, pr = both(lambda c, _a: c.acquire_child(None, D2))
    assert pr.key == jr.key
    assert both(lambda c, _a: c.acquire_child(None, C)) == (None, None)
    both(lambda c, _a, r=(jr, pr): c.release([r[0 if c is jc else 1]]))
    # a slot splices A's blocks: demand eviction must skip that leaf's
    # ancestors' shared blocks and take the LRU leaf alone
    both(lambda c, a: a.ref(held["a"][0 if c is jc else 1].blocks))
    jr, pr = both(lambda c, a: c.evict_for_blocks(a.free_count() + 2))
    assert pr == jr
    _same_state(jc, pc, ja, pa, "after demand eviction")
    both(lambda c, a: a.deref(held["a"][0 if c is jc else 1].blocks))
    # budget: 3 more chunks push past 5 x 20 bytes
    both(insert(None, C, 2), tag="c")
    both(insert("c", A, 2), tag="ca")
    both(insert("ca", B2, 2), tag="cab")
    both(insert("cab", D2, 2), tag="cabd")
    _same_state(jc, pc, ja, pa, "pinned path over budget")
    for tag in ("c", "ca", "cab", "cabd"):
        both(lambda c, _a, t=tag: c.release([held[t][0 if c is jc else 1]]))
    _same_state(jc, pc, ja, pa, "budget eviction after release")
    with pytest.raises(RuntimeError, match="double release"):
        pc.release([held["c"][1]] * (held["c"][1].refs + 1))
    jr, pr = both(lambda c, a: c.evict_for_blocks(a.capacity + 1))
    assert pr == jr is False
    both(lambda c, _a: c.clear())
    _same_state(jc, pc, ja, pa, "after clear")
    assert pa.free_count() == pa.capacity


def test_trie_checks_match_jax():
    pa = BlockAllocator(num_blocks=8, block_size=4, block_nbytes=8)
    ja = JaxAllocator(num_blocks=8, block_size=4, block_nbytes=8)
    for cls, alloc in ((PrefixCache, pa), (JaxCache, ja)):
        with pytest.raises(ValueError, match="multiple"):
            cls(chunk_tokens=6).bind_block_allocator(alloc)
        with pytest.raises(ValueError, match="chunk_tokens must be"):
            cls(chunk_tokens=0)
        with pytest.raises(RuntimeError, match="bind_block_allocator"):
            cls(chunk_tokens=8).insert_blocks(None, [1] * 8, [1, 2])
        c = cls(chunk_tokens=8)
        c.bind_block_allocator(alloc)
        with pytest.raises(ValueError, match="covers 2 blocks"):
            c.insert_blocks(None, [1] * 8, [1])
        other = BlockAllocator(num_blocks=8, block_size=4, block_nbytes=8)
        with pytest.raises(RuntimeError, match="ONE serving engine"):
            c.bind_block_allocator(other)


# ---------------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def models():
    paddle.seed(1234)
    jm = JaxGPT(jax_gpt_tiny())
    rs = np.random.RandomState(0)
    state = {}
    for k, v in jm.state_dict().items():
        a = rs.randn(*v.shape).astype(np.float32) * (0.3 if v.ndim == 2
                                                     else 0.1)
        if ".ln_" in k and k.endswith("weight"):
            a += 1.0
        state[k] = a
    jm.set_state_dict(state)
    pm = GPTForCausalLM(gpt_tiny(), device="cpu")
    pm.set_state_dict(state)
    return jm, pm


# name: (engine kwargs, waves of (prompt, max_new_tokens), cache kwargs
# with the budget as max_bytes or as a number of blocks); each wave is
# submitted and run to the end before the next
TRACES = {
    # test_prefix_cache.py:63 — a shared-prefix batch, two slots
    "shared_batch": (
        dict(max_batch_slots=2, max_len=128, block_size=8),
        [[(SYS + [21, 22, 23], 6), (SYS + [30], 6), (SYS + [21, 22, 23], 6),
          (SYS + [40, 41, 42, 43, 44, 45, 46], 6)]],
        dict(chunk_tokens=8)),
    # test_prefix_cache.py:135 — LRU budget, hits, then recompute
    "lru_waves": (
        dict(max_batch_slots=2, max_len=128, block_size=8),
        [[([i + 1] * 8 + [100 + i], 6) for i in range(4)],
         [([1] * 8 + [100], 6), ([3] * 8 + [7], 6)]],
        dict(chunk_tokens=8, max_blocks=3)),
    # test_prefix_cache.py:227 — a budget nothing fits: every insert
    # evicts the last
    "thrash": (
        dict(max_batch_slots=2, max_len=128, block_size=8),
        [[([i + 1] * 9, 2) for i in range(3)]],
        dict(chunk_tokens=8, max_bytes=1)),
    # test_paged_kv.py:178 — zero-copy sharing, one slot, blocks of 16
    "zero_copy": (
        dict(max_batch_slots=1, max_len=128, block_size=16),
        [[(SYS + [21, 22, 23], 4)], [(SYS + [40, 41], 4)]],
        dict(chunk_tokens=16)),
    # test_paged_kv.py:257 — a cold trie holding most of the pool is
    # evicted on demand at admission
    "demand_eviction": (
        dict(max_batch_slots=1, max_len=64, block_size=8, num_blocks=8),
        [[([1] * 17, 2)], [([2] * 17, 2)], [([3] * 17, 2)],
         [([9] * 40, 2)]],
        dict(chunk_tokens=8)),
    # a starved pool with a shared prefix: preemption, then a resume
    # that rides the trie
    "preempting": (
        dict(max_batch_slots=2, max_len=64, block_size=8, num_blocks=8),
        [[(SYS[:16] + list(range(1, 9)), 12),
          (SYS[:16] + list(range(30, 38)), 12)]],
        dict(chunk_tokens=8)),
}
COUNTED = ("prefix_hit_tokens", "prefill_chunks", "evictions",
           "preemptions", "prompt_tokens", "prefill_tokens_computed")


def _make_cache(cls, cache_kw):
    kw = dict(cache_kw)
    blocks = kw.pop("max_blocks", None)
    return cls(**kw), blocks


def _bind_budget(cache, blocks, engine):
    if blocks is not None:
        cache.max_bytes = blocks * engine._alloc.block_nbytes


def _run(engine, request, waves):
    toks, aggs = [], []
    for wave in waves:
        reqs = [engine.submit(request(prompt=p, max_new_tokens=n,
                                      greedy=True)) for p, n in wave]
        aggs.append(engine.run(max_steps=800).aggregate())
        assert all(r.status == "done" for r in reqs)
        toks.append([r.tokens for r in reqs])
    return toks, aggs


def _port(pm, kw, waves, cache_kw, kv_dtype):
    cache, blocks = _make_cache(PrefixCache, cache_kw) \
        if cache_kw is not None else (None, None)
    eng = ServingEngine(pm, top_k=1, prefill_chunk=16, kv_dtype=kv_dtype,
                        prefix_cache=cache, device="cpu", **kw)
    _bind_budget(cache, blocks, eng)
    toks, aggs = _run(eng, Request, waves)
    alloc = eng._alloc
    held = set() if cache is None else \
        {b for n in cache.iter_nodes() for b in n.blocks}
    assert alloc.blocks_in_use() == len(held), \
        "blocks in use other than the trie's after the run"
    assert all(alloc.refcount(b) == 1 for b in held)
    if cache is not None:
        cache.clear()
    assert alloc.free_count() == alloc.capacity
    return toks, aggs, cache


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("trace", list(TRACES))
def test_engine_traces_match_jax(models, trace, kv_dtype, monkeypatch):
    jm, pm = models
    if kv_dtype is not None:
        _read_jax_positions_from_t(monkeypatch)
    kw, waves, cache_kw = TRACES[trace]
    jcache, blocks = _make_cache(JaxCache, cache_kw)
    jeng = JaxEngine(jm, top_k=1, prefill_chunk=16, kv_dtype=kv_dtype,
                     prefix_cache=jcache, **kw)
    _bind_budget(jcache, blocks, jeng)
    jt, jaggs = _run(jeng, JaxRequest, waves)
    pt, paggs, pcache = _port(pm, kw, waves, cache_kw, kv_dtype)
    off, _, _ = _port(pm, kw, waves, None, kv_dtype)
    assert pt == jt, "greedy tokens differ from the JAX engine's"
    assert pt == off, "the prefix cache changed greedy tokens"
    for ja, pa in zip(jaggs, paggs):
        for k in COUNTED:
            assert pa[k] == ja[k], k
        assert pa["prefix_hit_rate"] == pytest.approx(ja["prefix_hit_rate"])
    hits = sum(a["prefix_hit_tokens"] for a in paggs)
    assert pcache.hit_tokens == jcache.hit_tokens
    # the trie also counts the lookups of admissions the pool refused
    # (their refs are released and the request waits), which only the
    # starved pool of "preempting" sees
    assert pcache.hit_tokens == hits if trace != "preempting" else \
        pcache.hit_tokens > hits
    if trace in ("shared_batch", "lru_waves", "zero_copy", "preempting"):
        assert hits > 0
    if trace == "thrash":
        assert paggs[0]["evictions"] >= 2 and hits == 0
    if trace == "preempting":
        assert paggs[0]["preemptions"] >= 1


def test_zero_copy_splice_allocates_only_the_suffix(models):
    """``test_paged_kv.py:178``: the second request's 32-token prefix is
    two trie-held blocks spliced into its table (refcount 2 while it
    runs); it allocates one block for its suffix."""
    _, pm = models
    cache = PrefixCache(chunk_tokens=16)
    eng = ServingEngine(pm, max_batch_slots=1, max_len=128, top_k=1,
                        prefill_chunk=16, block_size=16, prefix_cache=cache,
                        device="cpu")
    eng.submit(Request(prompt=SYS + [21, 22, 23], max_new_tokens=4,
                       greedy=True))
    eng.run(max_steps=200)
    assert eng._alloc.blocks_in_use() == 2
    shared = [b for n in cache.iter_nodes() for b in n.blocks]
    seen = []
    allocs = eng._alloc.allocs
    second = eng.submit(Request(
        prompt=SYS + [40, 41], max_new_tokens=4, greedy=True,
        on_token=lambda r, t, d: seen.append(
            [eng._alloc.refcount(b) for b in shared])))
    agg = eng.run(max_steps=200).aggregate()
    assert second.status == "done" and agg["prefix_hit_tokens"] == 32.0
    assert eng._alloc.allocs - allocs == 1
    assert seen[0] == [2, 2]
    assert list(eng.engine.table[0]) == [0] * eng.engine.blocks_per_slot


def test_int8_splice_token_exact_against_a_cold_run(models):
    """``test_paged_kv.py:606-626``: the spliced blocks hold the first
    request's chunk-prefill codes and a cold run commits the same prefix
    at the same chunk granularity, so the int8 tokens are EXACT."""
    _, pm = models
    kw = dict(max_batch_slots=1, max_len=128, top_k=1, prefill_chunk=16,
              block_size=16, kv_dtype="int8", device="cpu")
    eng = ServingEngine(pm, prefix_cache=PrefixCache(chunk_tokens=16), **kw)
    eng.submit(Request(prompt=SYS + [21, 22, 23], max_new_tokens=4,
                       greedy=True))
    eng.run(max_steps=200)
    hot = eng.submit(Request(prompt=SYS + [40, 41], max_new_tokens=4,
                             greedy=True))
    assert eng.run(max_steps=200).aggregate()["prefix_hit_tokens"] == 32.0
    cold = ServingEngine(pm, **kw)
    ref = cold.submit(Request(prompt=SYS + [40, 41], max_new_tokens=4,
                              greedy=True))
    cold.run(max_steps=200)
    assert hot.tokens == ref.tokens


def test_engine_cache_checks(models):
    _, pm = models
    with pytest.raises(ValueError, match="exceeds the 64-row KV arena"):
        ServingEngine(pm, max_batch_slots=1, max_len=64, block_size=8,
                      prefix_cache=PrefixCache(chunk_tokens=128),
                      device="cpu")
    with pytest.raises(ValueError, match="multiple of the paged arena"):
        ServingEngine(pm, max_batch_slots=1, max_len=64, block_size=8,
                      prefix_cache=PrefixCache(chunk_tokens=12),
                      device="cpu")
    cache = PrefixCache(chunk_tokens=8)
    ServingEngine(pm, max_batch_slots=1, max_len=64, block_size=8,
                  prefix_cache=cache, device="cpu")
    with pytest.raises(RuntimeError, match="ONE serving engine"):
        ServingEngine(pm, max_batch_slots=1, max_len=64, block_size=8,
                      prefix_cache=cache, device="cpu")
    # a dense engine takes a fresh cache, never one bound to a pool
    with pytest.raises(ValueError, match="bound to a paged engine"):
        ServingEngine(pm, max_batch_slots=1, max_len=64,
                      prefix_cache=cache, device="cpu")
    ServingEngine(pm, max_batch_slots=1, max_len=64,
                  prefix_cache=PrefixCache(chunk_tokens=8), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(pm, max_batch_slots=1, max_len=64, block_size=8,
                          kv_dtype="int8",
                          prefix_cache=PrefixCache(chunk_tokens=8))
