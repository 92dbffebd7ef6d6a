"""The port's host KV tier against the JAX package (``tests/test_tiered_kv.py``).

The same weights (copied by name, dropout off, fp32 matmuls on both
sides) and the same traces through the JAX engine and the port's:

- :class:`HostTier` as an allocator (atomic grants, refcounts, double
  frees, drops) and as a store (a bit-exact write/read round trip,
  ``reconcile``), one op sequence through both tiers
  (``test_tiered_kv.py:118``, ``:139``); its refusals (``:160``);
- spill and swap-back (``:173``): on poisoned pools (1e9, or saturated
  int8 codes and 1e7 scales) a starved pool's run with a tier, without
  one and a roomy run give the same greedy tokens, and the tiered run's
  counted metrics (preemptions, blocks spilled and swapped in, re-prefill
  tokens avoided, prefill tokens computed, chunks, steps) equal the JAX
  engine's on the same trace; fp32 and int8 pools;
- the swap threshold above every victim's prefix spills nothing
  (``:194``);
- the prefix cache's demotion and host hits (``:281``), a demoted leaf
  that must not hide its parent's blocks from reclaim (``:313``), and
  demoted nodes reclaimed under host pressure (``:344``): tokens and
  the trie's counters equal to the JAX engine's;
- a spill or swap-back that raises (``HostTier.write`` or
  ``DecodeEngine.restore_blocks`` patched to raise once) falls back to
  recompute, with the tokens of the run without a tier and both pools
  back to empty.

Greedy tokens are exact; counters are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.inference.block_pool import HostTier as JaxHostTier
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxCache
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine

from paddle_tpu_torch.inference import PrefixCache, Request, ServingEngine
from paddle_tpu_torch.inference.block_pool import HostTier
from paddle_tpu_torch.inference.serving import DecodeEngine
from test_torch_int8 import _read_jax_positions_from_t
from test_torch_serving import models  # noqa: F401  (fixture)

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

PROMPTS = [[5, 9, 2, 11, 4, 7, 8, 3] * 3, [3, 3, 7, 1, 8, 2, 9, 4] * 3,
           [17, 23, 2, 9, 14, 6, 1, 12] * 3]
COUNTS = ("preemptions", "blocks_spilled", "blocks_swapped_in",
          "reprefill_tokens_avoided", "prefill_tokens_computed",
          "prefill_chunks", "decode_steps", "prompt_tokens")
KW = dict(max_batch_slots=3, max_len=64, top_k=1, prefill_chunk=16, seed=7,
          block_size=8)


def _poison_port(eng):
    e = eng.engine
    e.reset()
    for b in e.kbufs + e.vbufs:
        b.fill_(127 if e.quantized else 1e9)
    for s in (e.kscales or []) + (e.vscales or []):
        s.fill_(1e7)


def _poison_jax(eng):
    e = eng.engine
    e._ensure_buffers()
    e.kbufs = [jnp.full_like(b, 127 if e.quantized else 1e9)
               for b in e.kbufs]
    e.vbufs = [jnp.full_like(b, 127 if e.quantized else 1e9)
               for b in e.vbufs]
    if e.quantized:
        e.kscales = [jnp.full_like(s, 1e7) for s in e.kscales]
        e.vscales = [jnp.full_like(s, 1e7) for s in e.vscales]


def _serve_port(pm, prompts=PROMPTS, n=16, poison=False, **kw):
    eng = ServingEngine(pm, **{**KW, **kw}, device="cpu")
    if poison:
        _poison_port(eng)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=n, greedy=True))
            for p in prompts]
    agg = eng.run(max_steps=3000).aggregate()
    assert all(r.status == "done" for r in reqs)
    return [r.tokens for r in reqs], agg, eng


def _serve_jax(jm, prompts=PROMPTS, n=16, poison=False, **kw):
    eng = JaxEngine(jm, **{**KW, **kw})
    if poison:
        _poison_jax(eng)
    reqs = [eng.submit(JaxRequest(prompt=p, max_new_tokens=n, greedy=True))
            for p in prompts]
    agg = eng.run(max_steps=3000).aggregate()
    assert all(r.status == "done" for r in reqs)
    return [r.tokens for r in reqs], agg, eng


def _assert_empty(eng):
    """Both pools reconciled to empty: no device block, no host block."""
    assert eng._alloc.free_count() == eng._alloc.capacity
    if eng._host is not None:
        assert eng._host.free_count() == eng._host.capacity
        assert eng._host.reconcile({}) == {
            "leaked_host_blocks": 0, "missing_host_refs": 0,
            "host_free_list_errors": 0}


# ---------------------------------------------------------------- HostTier
def test_host_tier_allocator_same_ops_same_state():
    """``test_tiered_kv.py:118``'s op sequence through both tiers:
    identical grants, refcounts, free lists, counters and errors."""
    jt = JaxHostTier(4, 16, layers=2, heads=2, head_dim=8)
    pt = HostTier(4, 16, layers=2, heads=2, head_dim=8)

    def state(t):
        return (t.free_count(), t.blocks_in_use(), list(t._free),
                [t.refcount(b) for b in range(4)], t.drops, t.swap_ins,
                t.block_nbytes, t.capacity)

    for op, args, kw in (("alloc", (3,), {}), ("alloc", (2,), {}),
                         ("ref", ([0],), {}), ("deref", ([0],), {}),
                         ("deref", ([0, 1, 2],), {"restored": True}),
                         ("alloc", (1,), {}), ("deref", ([2],), {})):
        assert getattr(jt, op)(*args, **kw) == getattr(pt, op)(*args, **kw)
        assert state(jt) == state(pt), op
    assert pt.drops == 1                # released without a swap-back
    b = pt.alloc(1)
    with pytest.raises(RuntimeError, match="double free"):
        pt.deref(b + b)                 # a duplicate within one call
    pt.deref(b, aborted=True)
    assert pt.drops == 1                # an unwound grant is no drop
    with pytest.raises(RuntimeError, match="free host block"):
        pt.ref(b)


@pytest.mark.parametrize("quantized", [False, True])
def test_host_tier_write_read_roundtrip_and_reconcile(quantized):
    """``test_tiered_kv.py:139``: the exact bits back (int8 codes and
    their scales alike), the counters and byte sizes the JAX tier's,
    and ``reconcile`` finding a block nobody accounts for."""
    dt = np.int8 if quantized else np.float32
    jt = JaxHostTier(3, 4, layers=2, heads=2, head_dim=3, dtype=dt,
                     quantized=quantized)
    pt = HostTier(3, 4, layers=2, heads=2, head_dim=3,
                  dtype=torch.int8 if quantized else torch.float32,
                  quantized=quantized)
    rs = np.random.RandomState(0)
    if quantized:
        k, v = (rs.randint(-127, 128, (2, 2, 4, 2, 3)).astype(np.int8)
                for _ in range(2))
        ks, vs = (rs.rand(2, 2, 2).astype(np.float32) for _ in range(2))
    else:
        k, v = (rs.randn(2, 2, 4, 2, 3).astype(np.float32) for _ in range(2))
        ks = vs = None
    blocks = pt.alloc(2)
    assert blocks == jt.alloc(2)
    jt.write(blocks, k, v, ks, vs)
    pt.write(blocks, *(None if a is None else torch.from_numpy(a)
                       for a in (k, v, ks, vs)))
    for got, want in zip(pt.read(blocks), jt.read(blocks)):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    assert (pt.spills, pt.bytes_spilled, pt.block_nbytes) == \
        (jt.spills, jt.bytes_spilled, jt.block_nbytes)
    pt.count_swap_in(2)
    jt.count_swap_in(2)
    assert (pt.swap_ins, pt.bytes_restored) == (jt.swap_ins,
                                                jt.bytes_restored)
    full = {int(b): 1 for b in blocks}
    assert pt.reconcile(full) == jt.reconcile(full) == {
        "leaked_host_blocks": 0, "missing_host_refs": 0,
        "host_free_list_errors": 0}
    assert pt.reconcile({int(blocks[0]): 1})["leaked_host_blocks"] == 1
    if quantized:
        with pytest.raises(ValueError, match="scale rows"):
            pt.write(blocks, torch.from_numpy(k), torch.from_numpy(v))


def test_host_tier_requires_paged(models):
    """``test_tiered_kv.py:160``: the reference's refusals."""
    _, pm = models
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(pm, max_batch_slots=1, max_len=32,
                      host_tier_blocks=4, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(pm, 1, 32, host_tier_blocks=4)
    with pytest.raises(ValueError, match="swap_min_tokens"):
        ServingEngine(pm, max_batch_slots=1, max_len=32, block_size=8,
                      swap_min_tokens=8, device="cpu")
    eng = ServingEngine(pm, max_batch_slots=1, max_len=32, block_size=8,
                        host_tier_blocks=4, device="cpu")
    assert eng.host_tier_state() == {"capacity": 4, "free": 4, "in_use": 0,
                                     "spills": 0, "swap_ins": 0}
    assert ServingEngine(pm, max_batch_slots=1, max_len=32, block_size=8,
                         device="cpu").host_tier_state() is None
    with pytest.raises(RuntimeError, match="dense-arena"):
        eng.engine.copy_chunk(0, 0, torch.zeros(2, 8, 4, 16),
                              torch.zeros(2, 8, 4, 16))
    with pytest.raises(RuntimeError, match="dense-arena"):
        eng.engine.extract_chunk(0, 0, 8)


# ------------------------------------------------------ spill / swap-back
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_spill_swap_back_token_exact_and_counts_match_jax(models, kv_dtype,
                                                          monkeypatch):
    """``test_tiered_kv.py:173`` on poisoned pools: the roomy run, the
    starved run without a tier and the starved run with one give the
    same tokens, the tier avoids re-prefill work, and the tiered run's
    counts are the JAX engine's on the same trace."""
    jm, pm = models
    if kv_dtype:
        _read_jax_positions_from_t(monkeypatch)
    kw = dict(kv_dtype=kv_dtype, poison=True)
    base, abase, _ = _serve_port(pm, **kw)
    assert abase["preemptions"] == 0
    nt, ant, e1 = _serve_port(pm, num_blocks=13, **kw)
    assert ant["preemptions"] >= 1 and ant["blocks_spilled"] == 0
    tier, at, e2 = _serve_port(pm, num_blocks=13, host_tier_blocks=16, **kw)
    assert at["preemptions"] >= 1
    assert at["blocks_spilled"] > 0 and at["blocks_swapped_in"] > 0
    assert at["reprefill_tokens_avoided"] > 0
    assert at["prefill_tokens_computed"] < ant["prefill_tokens_computed"]
    assert base == nt == tier
    _assert_empty(e1)
    _assert_empty(e2)
    st = e2.host_tier_state()
    assert st["spills"] == at["blocks_spilled"] == st["swap_ins"]
    jtier, jat, _ = _serve_jax(jm, num_blocks=13, host_tier_blocks=16, **kw)
    assert tier == jtier
    for k in COUNTS:
        assert at[k] == jat[k], (k, at[k], jat[k])


def test_swap_threshold_above_every_prefix_spills_nothing(models):
    """``test_tiered_kv.py:194``: ``swap_min_tokens`` above every
    victim's committed prefix recomputes (nothing spilled) with the same
    tokens."""
    _, pm = models
    nt, ant, _ = _serve_port(pm, num_blocks=13)
    tier, at, eng = _serve_port(pm, num_blocks=13, host_tier_blocks=16,
                                swap_min_tokens=10_000)
    assert at["preemptions"] >= 1 and at["blocks_spilled"] == 0
    assert at["prefill_tokens_computed"] == ant["prefill_tokens_computed"]
    assert nt == tier
    _assert_empty(eng)


@pytest.mark.parametrize("where", ["spill", "swap_in"])
def test_tier_fault_degrades_to_recompute(models, where, monkeypatch):
    """A spill write or a swap-back copy that raises (once) falls back to
    recompute: the tokens of the run without a tier, nothing leaked in
    either pool."""
    _, pm = models
    base, _, _ = _serve_port(pm, num_blocks=13)
    cls, name = ((HostTier, "write") if where == "spill"
                 else (DecodeEngine, "restore_blocks"))
    orig, fired = getattr(cls, name), []

    def once(self, *a, **kw):
        if not fired:
            fired.append(1)
            raise RuntimeError("injected tier fault")
        return orig(self, *a, **kw)

    monkeypatch.setattr(cls, name, once)
    tier, at, eng = _serve_port(pm, num_blocks=13, host_tier_blocks=16)
    assert fired == [1]
    assert base == tier
    if where == "swap_in":
        # the faulted swap-back's request re-prefilled in full
        assert at["blocks_swapped_in"] < at["blocks_spilled"]
    _assert_empty(eng)


# ------------------------------------------- prefix-cache demotion / promotion
def _trie_run(model, engine, request, cache, host, prompts, n):
    """``prompts`` one after another through ``engine`` (the port's or
    the JAX one) behind ``cache``, with a tier of ``host`` blocks."""
    eng = engine(model, max_batch_slots=2, max_len=64, top_k=1,
                 prefill_chunk=16, seed=7, block_size=16, prefix_cache=cache,
                 host_tier_blocks=host,
                 **({"device": "cpu"} if engine is ServingEngine else {}))
    outs = []
    for p in prompts:
        r = eng.submit(request(prompt=p, max_new_tokens=n, greedy=True))
        eng.run(max_steps=600)
        assert r.status == "done"
        outs.append(r.tokens)
    return outs, eng


def test_trie_demotion_and_host_hit_match_jax(models):
    """``test_tiered_kv.py:281``: a byte budget of 1 evicts every insert
    at once — without a tier every request recomputes, with one the
    nodes demote and later lookups copy them back (host hits); tokens
    and the trie's counters equal to the JAX engine's."""
    jm, pm = models
    shared = list(range(1, 17))
    prompts = [shared + [20 + i, 3] for i in range(4)]
    base, _ = _trie_run(pm, ServingEngine, Request,
                        c0 := PrefixCache(chunk_tokens=16, max_bytes=1),
                        None, prompts, 6)
    tier, eng = _trie_run(pm, ServingEngine, Request,
                          c1 := PrefixCache(chunk_tokens=16, max_bytes=1),
                          8, prompts, 6)
    assert base == tier
    assert c0.stats()["hits"] == 0
    s = c1.stats()
    assert s["host_demotions"] >= 3 and s["host_hits"] >= 3
    assert s["host_hit_tokens"] == s["host_hits"] * 16
    jtier, _ = _trie_run(jm, JaxEngine, JaxRequest,
                         jc := JaxCache(chunk_tokens=16, max_bytes=1), 8,
                         prompts, 6)
    assert tier == jtier
    assert s == jc.stats()
    # the trie holds every block left in either pool
    assert eng._alloc.blocks_in_use() == sum(
        len(nd.blocks or []) for nd in c1.iter_nodes())
    parked = {b: 1 for nd in c1.iter_nodes() for b in nd.host_blocks or []}
    assert eng._host.reconcile(parked) == {
        "leaked_host_blocks": 0, "missing_host_refs": 0,
        "host_free_list_errors": 0}


def test_demoted_leaf_does_not_shadow_ancestor_reclaim(models):
    """``test_tiered_kv.py:313``: a demoted leaf hides its device-backed
    parent from the leaf-first walk; reclaim under device pressure drops
    the demoted child so the parent's blocks free, and the byte budget
    falls past a layer of demoted leaves."""
    _, pm = models
    prompt = list(range(1, 34))     # two full 16-token chunks: A -> B
    cache = PrefixCache(chunk_tokens=16, max_bytes=1 << 24)
    _, eng = _trie_run(pm, ServingEngine, Request, cache, 8, [prompt], 4)
    assert cache.node_count() == 2
    cache.max_bytes = cache.bytes - 1
    cache._evict_to_budget()        # the leaf B demotes; A stays
    assert cache.stats()["host_demotions"] >= 1
    used = eng._alloc.blocks_in_use()
    assert used >= 1
    assert cache.evict_for_blocks(eng._alloc.free_count() + used)
    assert eng._alloc.blocks_in_use() == 0
    cache.max_bytes = 0
    cache._evict_to_budget()
    assert cache.bytes == 0
    assert eng._host.free_count() == eng._host.capacity - sum(
        len(nd.host_blocks or []) for nd in cache.iter_nodes())


def test_demoted_nodes_reclaimed_under_host_pressure_match_jax(models):
    """``test_tiered_kv.py:344``: a 1-block tier parks one demoted chunk;
    demoting a second drops the first (a host drop), the same counts as
    the JAX engine's, the tier never over-full."""
    jm, pm = models

    def mk(i):
        return [(7 * j + i) % 241 + 1 for j in range(16)] + [30 + i]

    prompts = [mk(i) for i in range(3)]
    outs, eng = _trie_run(pm, ServingEngine, Request,
                          cache := PrefixCache(chunk_tokens=16, max_bytes=1),
                          1, prompts, 4)
    s = cache.stats()
    assert s["host_demotions"] >= 2 and s["host_drops"] >= 1
    assert eng._host.blocks_in_use() <= 1
    jouts, _ = _trie_run(jm, JaxEngine, JaxRequest,
                         jc := JaxCache(chunk_tokens=16, max_bytes=1), 1,
                         prompts, 4)
    assert outs == jouts
    assert s == jc.stats()
