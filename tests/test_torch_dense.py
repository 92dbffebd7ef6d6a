"""The port's dense KV arena (``block_size=None``) against the JAX package.

The same weights (copied by name, dropout off, fp32 matmuls on both
sides), the same numpy inputs:

- the dense static cache ``(k_buf, v_buf, t)`` of ``GPTModel`` at a
  scalar offset (a chunk), at per-slot offsets (a step, a verify of 3
  rows): logits within ``ATOL`` and the committed buffers within 1e-5
  of the JAX model's, and the offsets advanced alike;
- a chunk's pad tail past ``max_len`` DROPPED, never wrapped and never
  clamped back over committed rows (the reference's ``mode="drop"``;
  the counterpart of ``tests/test_paged_kv.py:428``), and an idle slot
  at ``t = max_len`` written where ``dynamic_update_slice`` clamps it,
  ``max_len - s``, without touching its neighbours;
- the dense ``DecodeEngine``'s ``prefill``, ``step`` and
  ``run_prefill_chunk``: tokens equal to the JAX engine's, buffers
  within 1e-5 + 1e-5 |x| (the second layer's K/V reach |x| ~ 4);
- greedy serving: dense against paged in the port on a 1e9-poisoned
  arena (the counterpart of ``tests/test_paged_kv.py:92``), and
  ``ServingEngine()`` with its defaults against the JAX engine and
  JAX ``generate(jit=True)`` on ``tests/test_serving.py:42``'s trace,
  token for token;
- the reference's refusals (the dense prefix cache itself is
  ``tests/test_torch_dense_prefix.py``'s).

Tolerance: fp32 logits ``ATOL`` 1e-4 (``tests/test_torch_gpt.py``'s:
two layers of width 64, summation order); greedy tokens exact.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import DecodeEngine as JaxDecode
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine

from paddle_tpu_torch.inference import (DecodeEngine, PrefixCache, Request,
                                        ServingEngine)
from test_torch_serving import SYS, models  # noqa: F401  (fixture)

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

ATOL = 1e-4
L, H, D = 2, 4, 16                    # gpt_tiny's layers, heads, head_dim


def _buffers(b, max_len, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, max_len, H, D).astype(np.float32)
            for _ in range(2 * L)]


def _forward_both(models, ids, bufs, t):
    """One dense-cache forward of each model on the same ids, buffers and
    offset: (logits, buffers after, offsets after) of JAX, then port."""
    jm, pm = models
    jm.eval()
    jc = [(paddle.to_tensor(bufs[2 * i]), paddle.to_tensor(bufs[2 * i + 1]),
           paddle.to_tensor(np.asarray(t, np.int32))) for i in range(L)]
    jl, jnew = jm(paddle.to_tensor(ids.astype(np.int32)), caches=jc)
    pbufs = [torch.from_numpy(b.copy()) for b in bufs]
    pc = [(pbufs[2 * i], pbufs[2 * i + 1],
           torch.as_tensor(np.asarray(t, np.int32))) for i in range(L)]
    with torch.inference_mode():
        pl, pnew = pm(torch.from_numpy(ids.astype(np.int64)), caches=pc)
    jout = (jl.numpy(), [np.asarray(c[j].value) for c in jnew
                         for j in (0, 1)], np.asarray(jnew[0][2].value))
    pout = (pl.numpy(), [b.numpy() for b in pbufs], pnew[0][2].numpy())
    # the port commits in place and hands the same buffers on
    assert all(pnew[i][0] is pbufs[2 * i] for i in range(L))
    return jout, pout


@pytest.mark.parametrize("what,b,s,t", [
    ("chunk", 1, 8, 5),
    ("step", 3, 1, [4, 17, 0]),
    ("verify", 3, 3, [9, 0, 20]),
])
def test_dense_forward_matches_jax(models, what, b, s, t):
    max_len = 32
    rs = np.random.RandomState(len(what))
    ids = rs.randint(0, 256, (b, s))
    bufs = _buffers(b, max_len, seed=s)
    (jl, jb, jt), (pl, pb, pt) = _forward_both(models, ids, bufs, t)
    np.testing.assert_allclose(pl, jl, atol=ATOL, rtol=0)
    for x, y in zip(pb, jb):
        np.testing.assert_allclose(x, y, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(pt, jt)
    assert np.abs(pl).max() > 1.0          # real logits, not a zero row


def test_dense_pad_tail_dropped_not_wrapped(models):
    """A chunk of 16 at t = 24 on a 32-row arena: rows 24..31 land, the
    8 rows past max_len are dropped — rows 0..23 keep their content,
    exactly as the reference's scatter leaves them."""
    max_len, t = 32, 24
    ids = np.random.RandomState(3).randint(0, 256, (1, 16))
    bufs = _buffers(1, max_len, seed=4)
    (jl, jb, _), (pl, pb, _) = _forward_both(models, ids, bufs, t)
    for x, y, before in zip(pb, jb, bufs):
        np.testing.assert_allclose(x, y, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(x[:, :t], before[:, :t])
        assert not np.allclose(x[:, t:], before[:, t:])
    # the real rows' logits agree; the pad rows' are discarded anyway
    np.testing.assert_allclose(pl[:, :max_len - t], jl[:, :max_len - t],
                               atol=ATOL, rtol=0)


def test_idle_slot_at_max_len_clamps_like_dynamic_update_slice(models):
    """Slot 1 idles at t = max_len: its 2 rows land at max_len - 2 (the
    start clamp of the reference's dynamic_update_slice), the live slots'
    rows at their own offsets, and every buffer equals the JAX one."""
    max_len, s = 32, 2
    t = [5, max_len, 30]
    ids = np.random.RandomState(5).randint(0, 256, (3, s))
    bufs = _buffers(3, max_len, seed=6)
    (jl, jb, jt), (pl, pb, pt) = _forward_both(models, ids, bufs, t)
    for x, y, before in zip(pb, jb, bufs):
        np.testing.assert_allclose(x, y, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(x[1, :max_len - s],
                                      before[1, :max_len - s])
        assert not np.allclose(x[1, max_len - s:], before[1, max_len - s:])
    assert np.isfinite(pl).all()
    np.testing.assert_allclose(pl[[0, 2]], jl[[0, 2]], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(pt, jt)


def _jax_dense(jm, b, max_len, chunk):
    return JaxDecode(jm, b, max_len, top_k=1, prefill_chunk=chunk)


def test_dense_decode_engine_matches_jax(models):
    """The batched prefill (a prompt longer than a chunk, one shorter),
    four lockstep steps and one more chunk run through
    run_prefill_chunk: the same tokens, buffers within 1e-5 + 1e-5
    |x|."""
    jm, pm = models
    b, max_len, chunk = 3, 64, 16
    je = _jax_dense(jm, b, max_len, chunk)
    pe = DecodeEngine(pm, b, max_len, top_k=1, prefill_chunk=chunk)
    assert pe.paged is False and pe.allocator is None and pe.table is None
    prompts = np.zeros((2, 21), np.int64)
    prompts[0] = np.arange(1, 22)
    prompts[1, :9] = [5, 9, 2, 7, 7, 3, 1, 8, 4]
    plens = np.asarray([21, 9], np.int32)
    slots = np.asarray([2, 0], np.int32)
    temps, greedy = np.ones(2, np.float32), np.ones(2, bool)
    kd = np.zeros((2, 2), np.uint32)
    jt = np.asarray(je.prefill(prompts.astype(np.int32), slots, plens, temps,
                               greedy, kd))
    pt = pe.prefill(prompts, slots, plens, temps, greedy, kd)
    assert pt.shape == (2, 1)
    np.testing.assert_array_equal(pt.numpy(), jt)
    toks = np.zeros((b, 1), np.int64)
    toks[slots, 0] = jt[:, 0]
    t = np.zeros(b, np.int32)
    t[slots] = plens
    ones, kd3 = np.ones(b, np.float32), np.zeros((b, 2), np.uint32)
    for _ in range(4):
        jn = np.asarray(je.step(toks.astype(np.int32), t, ones,
                                np.ones(b, bool), kd3))
        pn = pe.step(toks, t, ones, np.ones(b, bool), kd3).numpy()
        np.testing.assert_array_equal(pn[slots], jn[slots])
        toks, t = pn, t + 1
    chunk_ids = np.zeros((1, chunk), np.int64)
    chunk_ids[0, :5] = [4, 4, 2, 9, 1]
    one = (np.ones(1, np.float32), np.ones(1, bool),
           np.zeros((1, 2), np.uint32))
    jc = np.asarray(je.run_prefill_chunk(chunk_ids.astype(np.int32), 1, 0, 4,
                                         *one))
    pc = pe.run_prefill_chunk(chunk_ids, 1, 0, 4, *one).numpy()
    np.testing.assert_array_equal(pc, jc)
    for x, y in zip(pe.kbufs + pe.vbufs, je.kbufs + je.vbufs):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5,
                                   rtol=1e-5)
    pe.release_buffers()
    assert pe.kbufs is None and pe.vbufs is None
    pe.refresh_params()
    # the arena comes back zeroed on the next use
    pe.step(toks, t, ones, np.ones(b, bool), kd3)
    assert pe.kbufs[0].shape == (b, max_len, H, D)


def _serve(pm, prompts, n=6, max_len=128, poison=False, **kw):
    eng = ServingEngine(pm, max_batch_slots=2, max_len=max_len, top_k=1,
                        prefill_chunk=16, device="cpu", **kw)
    if poison:
        eng.engine.reset()
        for buf in eng.engine.kbufs + eng.engine.vbufs:
            buf.fill_(1e9)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=n, greedy=True))
            for p in prompts]
    m = eng.run(max_steps=800)
    assert all(r.status == "done" for r in reqs)
    return [r.tokens for r in reqs], m.aggregate(), eng


def test_dense_vs_paged_greedy_parity_on_poisoned_arenas(models):
    """Mixed-length concurrent greedy decode: the dense arena and a
    paged pool, both filled with 1e9 first, emit the same tokens (every
    row a slot reads was written by its own prompt or steps)."""
    _, pm = models
    prompts = [[5, 9, 2], SYS + [21, 22, 23], [3, 3, 7, 1, 8, 2, 6],
               list(range(1, 40))]
    dense, da, eng = _serve(pm, prompts, poison=True)
    paged, pa, _ = _serve(pm, prompts, poison=True, block_size=16)
    assert dense == paged
    assert len({t for toks in dense for t in toks}) > 4
    assert eng.free_block_count() is None
    assert "blocks_in_use_peak" not in da and "block_allocs" not in da
    for k in ("prefill_chunks", "decode_steps", "prompt_tokens"):
        assert da[k] == pa[k], k


def test_default_serving_engine_serves_the_reference_trace(models):
    """``tests/test_serving.py:42``: ServingEngine with its defaults (the
    dense arena) serves two prompts concurrently, token-exact against
    the JAX engine and against JAX ``generate(jit=True)``; then a mixed
    trace on 2 slots with retirement and re-admission against the JAX
    engine."""
    jm, pm = models
    prompts = [[5, 9, 2], [3, 3, 7, 1, 8, 2, 6]]
    eng = ServingEngine(pm, max_batch_slots=2, max_len=64, top_k=1,
                        device="cpu")
    assert eng.paged is False and eng.engine.paged is False
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=6, greedy=True))
            for p in prompts]
    eng.run(max_steps=50)
    jeng = JaxEngine(jm, max_batch_slots=2, max_len=64, top_k=1)
    jreqs = [jeng.submit(JaxRequest(prompt=p, max_new_tokens=6,
                                    greedy=True)) for p in prompts]
    jeng.run(max_steps=50)
    for p, r, jr in zip(prompts, reqs, jreqs):
        ids = paddle.to_tensor(np.asarray([p], np.int32))
        ref = jm.generate(ids, max_new_tokens=6, top_k=1, jit=True)
        assert r.tokens == jr.tokens == ref.numpy()[0, len(p):].tolist()
    mixed = [[1, 2, 3, 4] * 5, [9] * 11, [10, 20, 30, 40, 50],
             list(range(60, 99))]
    ptoks, pagg, _ = _serve(pm, mixed, n=9)
    jeng = JaxEngine(jm, max_batch_slots=2, max_len=128, top_k=1,
                     prefill_chunk=16)
    jreqs = [jeng.submit(JaxRequest(prompt=p, max_new_tokens=9,
                                    greedy=True)) for p in mixed]
    jagg = jeng.run(max_steps=800).aggregate()
    assert ptoks == [r.tokens for r in jreqs]
    for k in ("prefill_chunks", "decode_steps", "prompt_tokens"):
        assert pagg[k] == jagg[k], k


def test_dense_refusals(models):
    """The reference's refusals (``serving.py:315-327``, ``:2929-2935``):
    int8 or ``num_blocks`` without ``block_size``, and a prefix cache
    bound to a paged engine's pool on the dense arena."""
    _, pm = models
    with pytest.raises(ValueError, match="PAGED"):
        DecodeEngine(pm, 2, 64, kv_dtype="int8")
    with pytest.raises(ValueError, match="num_blocks without block_size"):
        DecodeEngine(pm, 2, 64, num_blocks=9)
    # the paged arena binds its cache to the pool ...
    cache = PrefixCache(chunk_tokens=16)
    ServingEngine(pm, 2, 64, prefix_cache=cache, block_size=16,
                  device="cpu")
    # ... which the dense arena's segment copies cannot read
    with pytest.raises(ValueError, match="bound to a paged engine"):
        ServingEngine(pm, 2, 64, prefix_cache=cache, device="cpu")
