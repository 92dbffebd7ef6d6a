"""The dense arena's prefix cache against the JAX package (the dense arms of
``tests/test_prefix_cache.py``).

On the dense arena (``block_size=None``) a trie node holds a copy of its
chunk's K/V, an ``(L, chunk, H, D)`` segment pair taken out of the
slot's rows when its prompt is committed (``DecodeEngine.extract_chunk``,
inserted by ``PrefixCache.insert``), and a hit copies the segments into
the admitted slot's rows (``DecodeEngine.copy_chunk``). The same weights
(copied by name, dropout off, fp32 matmuls) and the same traces through
the JAX engine and the port's:

- cache on against cache off, and against the JAX engine with its cache
  (``test_prefix_cache.py:63``): greedy tokens and the counted hit
  tokens, chunks and steps equal;
- a slot seeded from the trie on an arena poisoned with 1e9 after the
  trie was filled (``:81``): the clean run's tokens;
- LRU eviction under the byte budget, referenced paths surviving, and an
  evicted prefix re-admitted by recomputing (``:135``), with the
  segments' storage dropped;
- a long prompt's chunked prefill interleaved with a decoding slot
  (``:179``): the counted chunks and the order of streamed tokens;
- n-gram speculation over cache-seeded rows (``:206``): the tokens of
  plain greedy decoding and of the JAX speculative engine;
- a thrashing budget's evictions in ``aggregate()`` (``:222``).

Greedy tokens and counters are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxCache
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.inference.speculative import NgramDrafter as JaxNgram

from paddle_tpu_torch.inference import (NgramDrafter, PrefixCache, Request,
                                        ServingEngine)
from test_torch_serving import SYS, models  # noqa: F401  (fixture)

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

COUNTS = ("prefix_hit_tokens", "prefill_chunks", "decode_steps",
          "prompt_tokens", "prefill_tokens_computed")


def _serve(engine, request, model, prompts, n=6, cache=None, spec=None,
           prefill_chunk=16, on_token=None):
    """``prompts`` through ``engine`` (the port's or the JAX one) on the
    dense arena: (tokens, aggregate, engine)."""
    eng = engine(model, max_batch_slots=2, max_len=128, top_k=1,
                 prefill_chunk=prefill_chunk, prefix_cache=cache, spec=spec,
                 **({"device": "cpu"} if engine is ServingEngine else {}))
    reqs = [eng.submit(request(prompt=p, max_new_tokens=n, greedy=True,
                               on_token=on_token and on_token(i)))
            for i, p in enumerate(prompts)]
    agg = eng.run(max_steps=500).aggregate()
    assert all(r.status == "done" for r in reqs)
    return [r.tokens for r in reqs], agg, eng


def _port(pm, prompts, **kw):
    return _serve(ServingEngine, Request, pm, prompts, **kw)


def _jax(jm, prompts, **kw):
    return _serve(JaxEngine, JaxRequest, jm, prompts, **kw)


def test_cache_on_vs_off_and_vs_jax(models):
    """``test_prefix_cache.py:63``: the shared 32-token prefix served
    from the trie to the second wave, greedy tokens unchanged, and the
    same hits, chunks and steps as the JAX engine's cache."""
    jm, pm = models
    prompts = [SYS + [21, 22, 23], SYS + [30], SYS + [21, 22, 23],
               SYS + [40, 41, 42, 43, 44, 45, 46]]
    base, _, _ = _port(pm, prompts)
    cache = PrefixCache(chunk_tokens=8, max_bytes=1 << 30)
    cached, agg, eng = _port(pm, prompts, cache=cache)
    assert cached == base
    assert agg["prefix_hit_tokens"] >= 32
    assert 0 < agg["prefix_hit_rate"] < 1
    assert cache.stats()["hits"] >= 1
    assert not eng.paged and eng.free_block_count() is None
    jcache = JaxCache(chunk_tokens=8, max_bytes=1 << 30)
    jtoks, jagg, _ = _jax(jm, prompts, cache=jcache)
    assert cached == jtoks
    for k in COUNTS:
        assert agg[k] == jagg[k], (k, agg[k], jagg[k])
    s, js = cache.stats(), jcache.stats()
    for k in ("lookups", "hits", "hit_tokens", "inserts", "evictions",
              "bytes", "nodes"):
        assert s[k] == js[k], (k, s[k], js[k])
    # a node's segments are (L, chunk, H, D) copies on the arena's device
    node = next(cache.iter_nodes())
    assert tuple(node.kseg.shape) == (2, 8, 4, 16)
    assert node.nbytes == node.kseg.nbytes + node.vseg.nbytes
    assert node.blocks is None and node.host_blocks is None


def test_poisoned_arena_never_leaks_into_a_seeded_slot(models):
    """``test_prefix_cache.py:81``: after the trie holds the prefix the
    whole arena is filled with 1e9; a slot seeded from the trie reads
    only copied or freshly computed rows, so its tokens are the clean
    run's."""
    _, pm = models
    prompt = SYS + [21, 22, 23]
    base, _, _ = _port(pm, [prompt])
    cache = PrefixCache(chunk_tokens=8, max_bytes=1 << 30)
    eng = ServingEngine(pm, max_batch_slots=1, max_len=128, top_k=1,
                        prefill_chunk=16, prefix_cache=cache, device="cpu")
    warm = eng.submit(Request(prompt=prompt, max_new_tokens=6, greedy=True))
    eng.run(max_steps=200)
    assert warm.tokens == base[0]
    for b in eng.engine.kbufs + eng.engine.vbufs:
        b.fill_(1e9)
    hot = eng.submit(Request(prompt=prompt, max_new_tokens=6, greedy=True))
    agg = eng.run(max_steps=200).aggregate()
    assert agg["prefix_hit_tokens"] >= 32
    assert hot.tokens == base[0]


def test_eviction_lru_refcount_and_readmit_recompute(models):
    """``test_prefix_cache.py:135``: LRU leaves evict first, a
    referenced path survives any budget, an evicted node drops its
    segments, and an evicted prefix re-admits by recomputing."""
    _, pm = models
    prompts = [[i + 1] * 8 + [100 + i] for i in range(4)]
    base, _, _ = _port(pm, prompts)
    cache = PrefixCache(chunk_tokens=8, max_bytes=1 << 30)
    toks, _, eng = _port(pm, prompts, cache=cache)
    assert toks == base
    nodes = [cache.root.children[tuple(p[:8])] for p in prompts]
    seg = nodes[0].nbytes
    assert cache.bytes == 4 * seg and cache.node_count() == 4
    path, hit = cache.lookup(prompts[0])
    assert hit == 8 and path == [nodes[0]]
    cache.max_bytes = 2 * seg
    cache._evict_to_budget()
    assert cache.evictions == 2
    kept = set(cache.root.children.values())
    assert nodes[0] in kept and nodes[3] in kept
    assert nodes[1] not in kept and nodes[2] not in kept
    assert nodes[1].kseg is None and nodes[1].vseg is None
    cache.max_bytes = 0
    cache._evict_to_budget()
    assert nodes[0] in set(cache.root.children.values())
    assert cache.bytes == seg
    cache.release(path)
    cache._evict_to_budget()
    assert cache.node_count() == 0 and cache.bytes == 0
    cache.max_bytes = 1 << 30
    again = eng.submit(Request(prompt=prompts[0], max_new_tokens=6,
                               greedy=True))
    agg = eng.run(max_steps=100).aggregate()
    assert again.tokens == base[0]
    assert agg["prefix_hit_tokens"] == 0.0


def test_chunked_prefill_interleaves_with_decode(models):
    """``test_prefix_cache.py:179``: a 96-token prompt prefills one chunk
    a tick while a short request decodes; 7 chunks, the short request
    streaming throughout, and the long one's tokens its unchunked run's
    and the JAX engine's."""
    jm, pm = models
    prompts = [[5, 9, 2], list(range(1, 97))]
    order = []

    def stream(i):
        return lambda r, t, d: order.append(("short", "long")[i])

    eng = ServingEngine(pm, max_batch_slots=2, max_len=128, top_k=1,
                        prefill_chunk=16, device="cpu")
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=n, greedy=True,
                               on_token=stream(i)))
            for i, (p, n) in enumerate(zip(prompts, (8, 2)))]
    agg = eng.run(max_steps=200).aggregate()
    assert agg["prefill_chunks"] == 7.0
    assert order.index("long") > order.index("short") + 4
    ref, _, _ = _port(pm, [prompts[1]], n=2, prefill_chunk=128)
    assert reqs[1].tokens == ref[0]
    jeng = JaxEngine(jm, max_batch_slots=2, max_len=128, top_k=1,
                     prefill_chunk=16)
    jreqs = [jeng.submit(JaxRequest(prompt=p, max_new_tokens=n,
                                    greedy=True))
             for p, n in zip(prompts, (8, 2))]
    jeng.run(max_steps=200)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]


def test_spec_verify_composes_with_cache_seeded_rows(models):
    """``test_prefix_cache.py:206``: n-gram speculation over rows copied
    from the trie gives plain greedy decoding's tokens and the JAX
    speculative engine's, with the same hits."""
    jm, pm = models
    prompts = [SYS + [21, 22, 23], SYS + [21, 22, 23],
               SYS + [1, 2, 1, 2, 1, 2]]
    base, _, _ = _port(pm, prompts, n=8)
    toks, agg, _ = _port(pm, prompts, n=8,
                         cache=PrefixCache(chunk_tokens=8),
                         spec=NgramDrafter(k=4))
    assert toks == base
    assert agg["prefix_hit_tokens"] >= 32
    jtoks, jagg, _ = _jax(jm, prompts, n=8, cache=JaxCache(chunk_tokens=8),
                          spec=JaxNgram(k=4))
    assert toks == jtoks
    assert agg["prefix_hit_tokens"] == jagg["prefix_hit_tokens"]


def test_eviction_counter_reaches_metrics(models):
    """``test_prefix_cache.py:222``: a budget that holds nothing evicts
    every insert, counted in ``aggregate()``; tokens unchanged."""
    _, pm = models
    prompts = [[i + 1] * 9 for i in range(3)]
    toks, agg, _ = _port(pm, prompts, n=2,
                         cache=PrefixCache(chunk_tokens=8, max_bytes=1))
    assert agg["evictions"] >= 2
    assert agg["prefix_hit_tokens"] == 0
    base, _, _ = _port(pm, prompts, n=2)
    assert toks == base


def test_copy_and_extract_are_slice_copies(models):
    """``copy_chunk`` writes exactly the segment's rows of one slot and
    ``extract_chunk`` reads them back as a copy; the paged engine keeps
    the reference's refusal."""
    _, pm = models
    eng = ServingEngine(pm, max_batch_slots=2, max_len=32, top_k=1,
                        device="cpu").engine
    eng.reset()
    rs = np.random.RandomState(0)
    k = torch.from_numpy(rs.randn(2, 8, 4, 16).astype(np.float32))
    v = torch.from_numpy(rs.randn(2, 8, 4, 16).astype(np.float32))
    eng.copy_chunk(1, 8, k, v)
    for i in range(2):
        assert torch.equal(eng.kbufs[i][1, 8:16], k[i])
        assert torch.equal(eng.vbufs[i][1, 8:16], v[i])
        assert not eng.kbufs[i][0].any() and not eng.kbufs[i][1, :8].any()
    ks, vs = eng.extract_chunk(1, 8, 8)
    assert torch.equal(ks, k) and torch.equal(vs, v)
    eng.kbufs[0].fill_(3.0)
    assert torch.equal(ks, k)           # a copy, not a view of the arena
    # the JAX engine's extract of the same rows: the same layout
    jeng = JaxEngine(models[0], max_batch_slots=2, max_len=32,
                     top_k=1).engine
    jeng._ensure_buffers()
    jeng.copy_chunk(1, 8, jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))
    jk, _ = jeng.extract_chunk(1, 8, 8)
    np.testing.assert_array_equal(np.asarray(jk), k.numpy())
    paged = ServingEngine(pm, max_batch_slots=1, max_len=32, block_size=8,
                          device="cpu").engine
    with pytest.raises(RuntimeError, match="block-table splice"):
        paged.copy_chunk(0, 0, k, v)
