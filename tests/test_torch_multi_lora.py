"""Multi-LoRA serving in the port (``paddle_tpu_torch.inference.
adapter_pool`` and the ``adapters=`` path of ``models/gpt.py``) against
the JAX package.

- ``AdapterPool`` makes the reference's decisions, call for call: the
  same slot grants off the LIFO free list, refcounts, LRU victims,
  refusals and ``reconcile`` reports, and the same numpy-seeded
  ``random_weights``.
- On gpt_tiny with the same weights and adapters, the port's greedy
  tokens equal the JAX engine's for a mixed batch (base requests and two
  adapters), through plain decode and through the k = 4 verify, and
  equal a pool-less engine over a model merged to ``W + A@B``. Base
  requests equal a pool-less engine's bitwise. The argument signatures
  stay at 2 across register, evict and swap.
- The reference's prefix cache keys on token ids alone, so an adapter
  request reuses KV a base request computed for the same prefix; the
  port keeps adapter requests off the trie. The test shows the
  reference's divergence from the merged-weights model and the port's
  agreement with it.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.adapter_pool import AdapterPool as JaxPool
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxCache
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

from paddle_tpu_torch.inference import PrefixCache, Request, ServingEngine
from paddle_tpu_torch.inference.adapter_pool import AdapterPool
from paddle_tpu_torch.inference.speculative import NgramDrafter
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

PROMPTS = [[5, 9, 2, 11, 4] * 3, [3, 3, 7, 1, 8, 2, 6] * 2,
           list(range(1, 20)), [17, 23]]
MIX = ["a", None, "b", "a"]
N_NEW = 6
# LoRA factors drawn at this scale move greedy tokens on gpt_tiny
SCALE = 0.2
ENGINE_KW = dict(max_batch_slots=2, max_len=96, top_k=1, prefill_chunk=16,
                 block_size=16, seed=7)


def _state():
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
    return state


def _pool(mod, cfg, capacity=4, rank=4):
    return mod(capacity, rank, num_layers=cfg.num_layers,
               hidden_size=cfg.hidden_size, ffn_size=cfg.ffn_size)


def _merged(state, pool, name):
    """The merged-weights (W + A@B) state dict of adapter ``name``."""
    out = dict(state)
    for i in range(gpt_tiny().num_layers):
        for tgt, key in (("qkv", "attn.qkv_proj"), ("out", "attn.out_proj"),
                         ("fc_in", "mlp.fc_in"), ("fc_out", "mlp.fc_out")):
            k = f"gpt.h.{i}.{key}.weight"
            out[k] = (state[k] + pool.merged_delta(name, tgt, i)).astype(
                np.float32)
    return out


def _port_model(state):
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    m.set_state_dict(state)
    return m


def _serve_port(model, prompts, adapters, pool=None, **kw):
    eng = ServingEngine(model, adapter_pool=pool, device="cpu",
                        **dict(ENGINE_KW, **kw))
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=N_NEW, greedy=True,
                               adapter=a))
            for p, a in zip(prompts, adapters)]
    eng.run(max_steps=800)
    assert all(r.status == "done" for r in reqs)
    return [r.tokens for r in reqs], eng


def _clean(eng):
    rep = eng.audit()
    assert all(v == 0 for v in rep.values()), rep
    assert eng.executable_count() == 2
    assert eng.telemetry.recompile_events() == 0


@pytest.fixture(scope="module")
def setup():
    state = _state()
    cfg = gpt_tiny()
    pool = _pool(AdapterPool, cfg)
    pool.register("a", pool.random_weights(seed=10, scale=SCALE))
    pool.register("b", pool.random_weights(seed=11, scale=SCALE))
    return state, pool


@pytest.fixture(scope="module")
def jax_mix(setup):
    """The JAX engine over the same weights and adapters: the mix's
    greedy tokens."""
    state, _ = setup
    paddle.seed(1234)
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict(state)
    jpool = _pool(JaxPool, jax_gpt_tiny())
    jpool.register("a", jpool.random_weights(seed=10, scale=SCALE))
    jpool.register("b", jpool.random_weights(seed=11, scale=SCALE))
    eng = JaxEngine(jm, adapter_pool=jpool, **ENGINE_KW)
    reqs = [eng.submit(JaxRequest(prompt=p, max_new_tokens=N_NEW,
                                  greedy=True, adapter=a))
            for p, a in zip(PROMPTS, MIX)]
    eng.run(max_steps=800)
    assert all(r.status == "done" for r in reqs)
    return [r.tokens for r in reqs]


# -- the pool, decision for decision -----------------------------------------

def _ops(mod):
    """One op sequence through a pool of ``mod``: every return value or
    exception type, and the pool's state after each op."""
    cfg = gpt_tiny()
    pool = _pool(mod, cfg, capacity=3, rank=2)
    w = [pool.random_weights(seed=s) for s in range(5)]
    ops = [("register", "a", w[0]), ("register", "b", w[1]),
           ("acquire", "a"), ("acquire", "a"), ("pin", "b"),
           ("register", "c", w[2]), ("register", "d", w[3]),
           ("unpin", "b"), ("release", "a"), ("evict", "a"),
           ("release", "a"), ("release", "a"), ("evict", "a"),
           ("register", "d", w[3]), ("register", "e", w[4]),
           ("acquire", "ghost"), ("register", "b", w[0]),
           ("evict", "b"), ("register", "b", w[1])]
    out = []
    for op, *args in ops:
        try:
            r = getattr(pool, op)(*args)
        except (KeyError, ValueError, RuntimeError) as e:
            r = type(e).__name__
        out.append((op, args[0], r, list(pool._free),
                    pool._refs.tolist(), sorted(pool.names()),
                    pool.loads, pool.evictions, pool.bytes_loaded))
    expected = {pool.lookup("e"): 2} if pool.lookup("e") else {}
    out.append(pool.reconcile(expected))
    out.append(pool.reconcile({}))
    return out, pool


def test_pool_decisions_and_reconcile_equal_the_reference():
    mine, pp = _ops(AdapterPool)
    theirs, jp = _ops(JaxPool)
    assert mine == theirs
    for t in AdapterPool.TARGETS:
        for a, b in zip(pp._host[t], jp._host[t]):
            np.testing.assert_array_equal(a, b)
    assert pp.adapter_nbytes == jp.adapter_nbytes


def test_random_weights_and_merged_delta_equal_the_reference():
    cfg = gpt_tiny()
    pp, jp = _pool(AdapterPool, cfg), _pool(JaxPool, cfg)
    wp, wj = pp.random_weights(seed=3), jp.random_weights(seed=3)
    for t in AdapterPool.TARGETS:
        for a, b in zip(wp[t], wj[t]):
            np.testing.assert_array_equal(a, b)
    pp.register("x", wp)
    jp.register("x", wj)
    np.testing.assert_array_equal(pp.merged_delta("x", "fc_out", 1),
                                  jp.merged_delta("x", "fc_out", 1))


def test_device_rows_update_in_place():
    """Register and evict copy rows into the resident device tensors:
    the tensors a dispatch sees never change identity."""
    cfg = gpt_tiny()
    pool = _pool(AdapterPool, cfg)
    eng = ServingEngine(_port_model(_state()), adapter_pool=pool,
                        device="cpu", **ENGINE_KW)
    dev = pool.device_arrays()
    sid = pool.register("z", pool.random_weights(seed=5))
    again = pool.device_arrays()
    assert all(again[t][0] is dev[t][0] for t in pool.TARGETS)
    np.testing.assert_array_equal(dev["qkv"][1][:, sid].numpy(),
                                  pool._host["qkv"][1][:, sid])
    pool.evict("z")
    assert not pool.device_arrays()["qkv"][1][:, sid].any()
    assert not dev["qkv"][0][:, 0].any()        # the identity row
    assert eng.engine.adapter_ids.tolist() == [0, 0]


def test_pool_bookkeeping_holds_across_threads():
    """Three client threads acquire and release while an operator thread
    registers and evicts: every acquire lands on a slot that holds the
    name it asked for, evict never frees a live slot, and once the
    threads end every reference is back and reconcile is clean."""
    pool = _pool(AdapterPool, gpt_tiny(), capacity=2, rank=1)
    w = pool.random_weights(seed=3)
    pool.register("a", w)
    stop, bad = threading.Event(), []

    def client():
        for i in range(1500):
            name = "ab"[i % 2]
            try:
                sid = pool.acquire(name)
            except KeyError:
                continue            # "b" is between evict and register
            if pool.name_of(sid) != name:
                bad.append((name, sid))
            pool.release(sid)

    def operator():
        while not stop.is_set():
            try:
                pool.register("b", w)
            except ValueError:
                pass                # still registered
            try:
                pool.evict("b")
            except RuntimeError:
                pass                # live: refused

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        op = threading.Thread(target=operator, daemon=True)
        op.start()
        clients = [threading.Thread(target=client, daemon=True)
                   for _ in range(3)]
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=60)
        stop.set()
        op.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not op.is_alive() and not any(th.is_alive() for th in clients)
    assert bad == []
    assert not pool._refs.any()
    assert pool.reconcile({}) == {"leaked_adapters": 0,
                                  "missing_adapter_refs": 0,
                                  "adapter_free_list_errors": 0}


# -- serving parity ----------------------------------------------------------

def test_mixed_adapters_equal_jax_and_merged_weights(setup, jax_mix):
    state, pool = setup
    model = _port_model(state)
    toks, eng = _serve_port(model, PROMPTS, MIX, pool=pool)
    assert toks == jax_mix
    _clean(eng)
    # each adapter request equals a pool-less engine over W + A@B, and
    # each base request a pool-less engine over W, bitwise
    for name in ("a", "b", None):
        idx = [i for i, a in enumerate(MIX) if a == name]
        ref_model = model if name is None else \
            _port_model(_merged(state, pool, name))
        ref, reng = _serve_port(ref_model, [PROMPTS[i] for i in idx],
                                [None] * len(idx))
        assert [toks[i] for i in idx] == ref, name
        _clean(reng)
    # the adapters move tokens: the test would see a dropped delta
    base, _ = _serve_port(model, PROMPTS, [None] * 4)
    assert sum(base[i] != toks[i] for i, a in enumerate(MIX) if a) >= 2
    assert pool.refcount("a") == pool.refcount("b") == 0


def test_verify_applies_the_target_adapter(setup, jax_mix):
    """Greedy speculation at k = 4 commits the plain decode's tokens:
    the target's adapter applies at every verify offset."""
    state, pool = setup
    toks, eng = _serve_port(_port_model(state), PROMPTS, MIX, pool=pool,
                            spec=NgramDrafter(k=4), max_len=128)
    assert toks == jax_mix
    _clean(eng)
    assert eng.metrics.aggregate()["spec_verify_steps"] > 0


def test_signatures_flat_across_register_evict_swap(setup, jax_mix):
    state, _ = setup
    pool = _pool(AdapterPool, gpt_tiny())
    pool.register("a", pool.random_weights(seed=10, scale=SCALE))
    pool.register("b", pool.random_weights(seed=11, scale=SCALE))
    model = _port_model(state)
    eng = ServingEngine(model, adapter_pool=pool, device="cpu", **ENGINE_KW)
    for round_, mix in enumerate((MIX, ["c", "d", None, "a"])):
        if round_:
            pool.evict("b")
            pool.register("c", pool.random_weights(seed=12, scale=SCALE))
            pool.register("d", pool.random_weights(seed=13, scale=SCALE))
        reqs = [eng.submit(Request(prompt=p, max_new_tokens=N_NEW,
                                   greedy=True, adapter=a))
                for p, a in zip(PROMPTS, mix)]
        eng.run(max_steps=800)
        assert eng.executable_count() == 2
    # the surviving adapter still decodes as before the swap
    assert reqs[3].tokens == jax_mix[3]
    _clean(eng)
    assert {r.tenant for r in reqs} == {"adapter:c", "adapter:d",
                                        "default", "adapter:a"}


def test_preemption_keeps_the_adapter_reference(setup):
    """A pool too small for the batch preempts an adapter request and
    resumes it by re-prefill: its tokens stay the merged model's and
    the reference survives the round trip."""
    state, pool = setup
    model = _port_model(state)
    toks, eng = _serve_port(model, PROMPTS[:2], ["a", "a"], pool=pool,
                            num_blocks=4, max_len=64)
    assert eng.metrics.preemptions > 0
    ref, _ = _serve_port(_port_model(_merged(state, pool, "a")),
                         PROMPTS[:2], [None, None], max_len=64)
    assert toks == ref
    _clean(eng)
    assert pool.refcount("a") == 0


def test_adapter_rejections_counted_as_the_reference(setup):
    state, pool = setup
    eng = ServingEngine(_port_model(state), adapter_pool=pool,
                        device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="not registered"):
        eng.submit(Request(prompt=[1, 2], max_new_tokens=2,
                           adapter="ghost"))
    with pytest.raises(ValueError, match="adapter name"):
        eng.submit(Request(prompt=[1, 2], max_new_tokens=2, adapter=7))
    assert eng._c_adapter_rejected.value == 2
    bare = ServingEngine(_port_model(state), device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="no adapter_pool"):
        bare.submit(Request(prompt=[1, 2], max_new_tokens=2, adapter="a"))
    assert bare.telemetry.registry.snapshot()[
        "serving_adapter_rejected_total"] == 1.0
    # a queued adapter request holds its reference; a cancel drops it
    r = eng.submit(Request(prompt=[1, 2], max_new_tokens=2, adapter="b"))
    assert pool.refcount("b") == 1 and eng.audit()["leaked_adapters"] == 0
    eng.cancel(r)
    eng.run(max_steps=20)
    assert r.finish_reason == "cancelled" and pool.refcount("b") == 0
    assert eng.audit_state()["leaked_adapters"] == 0


# -- the reference's prefix cache ignores adapters ---------------------------

PREFIX = [7, 3, 9, 11, 2, 5, 8, 4] * 4      # two 16-token chunks


def test_reference_prefix_cache_serves_base_kv_to_an_adapter(setup):
    """A base request caches a 32-token prefix; an adapter request with
    the same prefix then splices that KV in the reference, which keys
    its trie on token ids alone. The port computes the adapter's own KV
    and matches the merged-weights model; the reference does not."""
    state, pool = setup
    prompt_b = PREFIX + [1, 2, 3]
    # the merged-weights ground truth for the adapter request
    truth, _ = _serve_port(_port_model(_merged(state, pool, "a")),
                           [prompt_b], [None])
    # the port, with a prefix cache
    eng = ServingEngine(_port_model(state), adapter_pool=pool,
                        prefix_cache=PrefixCache(chunk_tokens=16),
                        device="cpu", **ENGINE_KW)
    r0 = eng.submit(Request(prompt=PREFIX + [6], max_new_tokens=N_NEW,
                            greedy=True))
    eng.run(max_steps=400)
    r1 = eng.submit(Request(prompt=prompt_b, max_new_tokens=N_NEW,
                            greedy=True, adapter="a"))
    eng.run(max_steps=400)
    assert r0.status == r1.status == "done"
    assert r1.tokens == truth[0]
    assert eng.metrics.prefix_hit_tokens == 0     # the adapter missed
    _clean(eng)
    # the reference, same trace
    paddle.seed(1234)
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict(state)
    jpool = _pool(JaxPool, jax_gpt_tiny())
    jpool.register("a", jpool.random_weights(seed=10, scale=SCALE))
    jeng = JaxEngine(jm, adapter_pool=jpool,
                     prefix_cache=JaxCache(chunk_tokens=16), **ENGINE_KW)
    j0 = jeng.submit(JaxRequest(prompt=PREFIX + [6], max_new_tokens=N_NEW,
                                greedy=True))
    jeng.run(max_steps=400)
    j1 = jeng.submit(JaxRequest(prompt=prompt_b, max_new_tokens=N_NEW,
                                greedy=True, adapter="a"))
    jeng.run(max_steps=400)
    assert j0.tokens == r0.tokens
    assert jeng.metrics.prefix_hit_tokens == 32   # spliced base KV
    assert j1.tokens != truth[0], "the reference's fault did not show"


# -- the reference's snapshot drops the adapter ------------------------------

def _migrate(make, R, pools, prompt, steps, **req_kw):
    """Serve ``prompt`` for ``steps`` ticks on one engine, migrate it out
    and restore the frame on a peer with its own pool: the request's
    tokens before the move, after it, and the restore's outcome."""
    src = make(pools[0])
    r = src.submit(R(prompt=prompt, max_new_tokens=12, greedy=True,
                     **req_kw))
    src.run(max_steps=steps)
    before = list(r.tokens)
    assert 2 <= len(before) < 12
    frame = src.migrate_out_request(r.id)
    peer = make(pools[1])
    r2 = peer.restore_request(frame)
    peer.run(max_steps=400)
    assert r2.status == "done"
    return before, list(r2.tokens), r2._restore_outcome, peer


def test_reference_migration_serves_an_adapter_request_the_base_model(
        setup):
    """A live adapter request moves to a peer engine mid-flight. The
    port's snapshot carries the adapter: the peer re-acquires it,
    splices the adapter's KV back (``swap_in``) and ends on the
    merged-weights model's tokens. The reference's snapshot drops it
    (``serving.py:5748-5766``), so its peer finishes the request on the
    base model."""
    state, pool = setup
    cfg = gpt_tiny()
    prompt = PREFIX + [1, 2, 3]             # two full blocks
    kw = dict(ENGINE_KW, host_tier_blocks=16)
    ref = ServingEngine(_port_model(_merged(state, pool, "a")),
                        device="cpu", **ENGINE_KW)
    truth = ref.submit(Request(prompt=prompt, max_new_tokens=12,
                               greedy=True))
    ref.run(max_steps=400)
    truth = list(truth.tokens)
    peer_pool = _pool(AdapterPool, cfg)
    peer_pool.register("a", peer_pool.random_weights(seed=10, scale=SCALE))
    model = _port_model(state)
    before, toks, outcome, peer = _migrate(
        lambda p: ServingEngine(model, adapter_pool=p, device="cpu", **kw),
        Request, (pool, peer_pool), prompt, 5, adapter="a")
    assert toks == truth and outcome == "swap_in"
    assert peer_pool.refcount("a") == 0 and pool.refcount("a") == 0
    _clean(peer)
    # the reference, same trace
    paddle.seed(1234)
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict(state)
    jpools = []
    for _ in range(2):
        jp = _pool(JaxPool, jax_gpt_tiny())
        jp.register("a", jp.random_weights(seed=10, scale=SCALE))
        jpools.append(jp)
    jbefore, jtoks, _, _ = _migrate(
        lambda p: JaxEngine(jm, adapter_pool=p, **kw), JaxRequest, jpools,
        prompt, 5, adapter="a")
    assert jbefore == before == truth[:len(before)]
    assert jtoks != truth, "the reference's fault did not show"
