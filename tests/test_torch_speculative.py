"""Port speculative decoding (``paddle_tpu_torch.inference.speculative``)
against the JAX package's.

- ``NgramDrafter.propose`` equals the reference's exactly.
- Greedy ``SpeculativeEngine.verify`` at k = 4, 16 and 31 (17 and 32
  query rows a slot, K4's two row tiles on the card): ``out`` and
  ``accept`` equal the JAX engine's on the same poisoned paged pools,
  table, offsets and drafts (some drafts matching the argmax prefix); the pools after the
  call match within 1e-5 (fp32; int8: codes within one step, scales
  1e-5).
- ``ServingEngine(spec=NgramDrafter(k=4), block_size=16)``: greedy tokens
  equal the JAX speculative engine's, the port's non-speculative
  engine's and the reference's dense non-speculative baseline, with
  mixed lengths, the prefix cache and a pool tight enough to preempt;
  the ``spec_*`` keys of ``aggregate()`` equal the JAX engine's. int8
  pools against the JAX int8 speculative engine with its position read
  corrected (``test_torch_int8.py``).
- Temperature: the committed marginal of the acceptance rule is the
  filtered target distribution (chi-square at p > 1e-3 over 20000
  verifies of a fixed logit row; no draw outside the filter), and the
  position-keyed stream (``core/random.py``) is uniform, its lanes
  uncorrelated, and a pure function of (keydata, P, lane).
- EOS inside an accepted prefix, the speculation headroom's errors (the
  reference's messages), and the device rule (no k refused on a card).
"""

import numpy as np
import pytest
import torch
from scipy import stats

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxPrefixCache
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.inference.speculative import NgramDrafter as JaxNgram
from paddle_tpu.inference.speculative import \
    SpeculativeEngine as JaxSpecEngine
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

from paddle_tpu_torch.core.random import (LANE_COIN, LANE_DRAW,
                                          position_uniforms, request_keydata)
from paddle_tpu_torch.inference import (NgramDrafter, PrefixCache, Request,
                                        ServingEngine, SpeculativeEngine)
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from test_torch_int8 import _read_jax_positions_from_t

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

SYS = [7, 3, 9, 11, 2, 5, 8, 4] * 4          # 32-token shared prefix
MIXED = [[1, 2, 3, 4] * 5, [3, 3, 7, 1, 8, 2, 6], [9] * 11,
         [10, 20, 30, 40, 50], list(range(1, 40))]


@pytest.fixture(scope="module")
def models():
    """Both models with the same random weights (``test_torch_serving``'s
    fixture), wide enough that greedy decoding produces varied tokens."""
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


# ------------------------------------------------------------- drafter
def _contexts(kind, rs):
    if kind == "random":
        # a small alphabet, so n-grams recur at every length
        ctxs = [rs.randint(0, 6, rs.randint(1, 40)).tolist()
                for _ in range(60)]
    else:
        ctxs = [(list(range(p)) * 8)[:rs.randint(1, 40)] + [0] * j
                for p in (1, 2, 3, 5) for j in range(4)]
        ctxs += [[5, 6, 7, 9, 5, 6, 7, 8, 5, 6, 7], [1, 2, 3], [4]]
    return ctxs + [None, []]


@pytest.mark.parametrize("kind", ["random", "repetitive"])
@pytest.mark.parametrize("max_ngram", [1, 3])
@pytest.mark.parametrize("k", [1, 4])
def test_ngram_propose_matches_the_reference(k, max_ngram, kind):
    ctxs = _contexts(kind, np.random.RandomState(k * 10 + max_ngram))
    for window in (512, 8):
        want = JaxNgram(k=k, max_ngram=max_ngram, window=window).propose(
            ctxs, None, None)
        got = NgramDrafter(k=k, max_ngram=max_ngram, window=window).propose(
            ctxs, None, None)
        assert got.dtype == want.dtype and got.shape == (len(ctxs), k)
        np.testing.assert_array_equal(got, want)


def test_ngram_drafter_interface():
    d = NgramDrafter(k=4)
    assert (d.accept_cap, d.executable_count(), d.k_eff) == (4, 0, 4)
    d.set_draft_len(2)
    assert d.k_eff == 2
    with pytest.raises(ValueError, match="k_eff"):
        d.set_draft_len(5)
    with pytest.raises(ValueError, match="k must be"):
        NgramDrafter(k=0)
    d.begin(2, 64)
    d.admit([0], [[1, 2]], [2])
    d.release()


# -------------------------------------------------------------- verify
B, K, MAX_LEN, BS, NBLK = 4, 4, 64, 16, 12
# per slot: offset, mapped blocks, drafts matching the argmax prefix
VERIFY_SLOTS = [(37, [1, 2, 3, 4], 4), (10, [5, 6, 0, 0], 2),
                (20, [7, 8, 0, 0], 0), (0, [0, 0, 0, 0], 0)]   # idle


def _geometry(k):
    """(max_len, table, num_blocks) of a verify at ``k``: VERIFY_SLOTS'
    blocks and arena (k = K), and past it an arena of whole blocks
    holding the deepest slot's t + k, with fresh blocks mapped behind
    every live slot's rows t .. t + k."""
    deepest = max(off for off, _, _ in VERIFY_SLOTS) + k
    max_len = max(MAX_LEN, (deepest // BS + 1) * BS)
    table = np.zeros((B, max_len // BS), np.int32)
    nblk = NBLK
    for slot, (off, blocks, _) in enumerate(VERIFY_SLOTS):
        table[slot, :len(blocks)] = blocks
        if not any(blocks):
            continue                       # the idle slot: scratch only
        for j in range((off + k) // BS + 1):
            if not table[slot, j]:
                table[slot, j], nblk = nblk, nblk + 1
    return max_len, table, nblk


def _verify_state(int8, k=K):
    """Pools with random context below each slot's offset and poison
    everywhere else (1e9, or int8 codes 127 with 1e7 scales in blocks no
    table names), the table and the offsets."""
    rs = np.random.RandomState(11)
    L, H, D = 2, 4, 16
    _, table, nblk = _geometry(k)
    t = np.asarray([s for s, _, _ in VERIFY_SLOTS], np.int32)
    pools = []
    for _ in range(2 * L):
        if int8:
            codes = np.full((nblk, BS, H, D), 127, np.int8)
            scales = np.full((nblk, H), 1e7, np.float32)
        else:
            codes = np.full((nblk, BS, H, D), 1e9, np.float32)
        for slot, (off, blocks, _) in enumerate(VERIFY_SLOTS):
            for r in range(off):
                blk = blocks[r // BS]
                if int8:
                    codes[blk, r % BS] = rs.randint(-127, 128, (H, D))
                    scales[blk] = 0.01 + 0.02 * np.abs(rs.randn(H))
                else:
                    codes[blk, r % BS] = rs.randn(H, D)
        pools.append((codes, scales) if int8 else codes)
    return pools, table, t


def _port_verify_engine(pm, int8, pools, table, k=K):
    max_len, _, nblk = _geometry(k)
    eng = SpeculativeEngine(pm, B, max_len, k=k, block_size=BS,
                            num_blocks=nblk,
                            kv_dtype="int8" if int8 else None)
    eng.reset()
    L = eng.L
    for i in range(L):
        for buf, src, sc in ((eng.kbufs, pools[2 * i], eng.kscales),
                             (eng.vbufs, pools[2 * i + 1], eng.vscales)):
            if int8:
                buf[i].copy_(torch.from_numpy(src[0]))
                sc[i].copy_(torch.from_numpy(src[1]))
            else:
                buf[i].copy_(torch.from_numpy(src))
    eng.table[:] = table
    return eng


def _greedy_args():
    return (np.ones((B,), np.float32), np.ones((B,), bool),
            np.zeros((B, 2), np.uint32))


def _drafts(pm, int8, pools, table, t, pending, k=K):
    """Drafts whose first ``want`` tokens are the target's argmax chain
    (found by growing the chain one port verify at a time; a verify
    rewrites rows t..t+k before reading them, so rerunning it on the
    same pools is harmless), then a token off it."""
    eng = _port_verify_engine(pm, int8, pools, table, k)
    drafts = np.zeros((B, k), np.int64)
    for j in range(k):
        out, _ = eng.verify(pending, drafts, t, *_greedy_args())
        out = out.numpy()
        for slot, (_, _, want) in enumerate(VERIFY_SLOTS):
            drafts[slot, j] = out[slot, j] if j < want \
                else (out[slot, j] + 1) % 256
    return drafts


@pytest.mark.parametrize("int8", [False, True])
def test_greedy_verify_matches_jax(models, int8, monkeypatch):
    _check_greedy_verify(models, int8, K, monkeypatch)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", [16, 31])
def test_greedy_verify_past_16_rows_matches_jax(models, k, int8,
                                                monkeypatch):
    """k + 1 = 17 and 32 query rows a slot, which K4 on the card runs as
    two 16-row tiles of its bf16 body (one ragged at 17): the plain
    version the CPU runs against the reference's, as at k = 4."""
    _check_greedy_verify(models, int8, k, monkeypatch)


def _check_greedy_verify(models, int8, k, monkeypatch):
    """``out``, ``accept`` and the pools after one greedy verify at ``k``
    of the port and of JAX on the same poisoned pools."""
    jm, pm = models
    if int8:
        _read_jax_positions_from_t(monkeypatch)
    pools, table, t = _verify_state(int8, k)
    pending = np.asarray([[17], [3], [250], [0]], np.int64)
    drafts = _drafts(pm, int8, pools, table, t, pending, k)

    max_len, _, nblk = _geometry(k)
    je = JaxSpecEngine(jm, B, max_len, k=k, block_size=BS, num_blocks=nblk,
                       kv_dtype="int8" if int8 else None)
    je._ensure_buffers()
    if int8:
        je.kbufs = [jnp.asarray(pools[2 * i][0]) for i in range(2)]
        je.vbufs = [jnp.asarray(pools[2 * i + 1][0]) for i in range(2)]
        je.kscales = [jnp.asarray(pools[2 * i][1]) for i in range(2)]
        je.vscales = [jnp.asarray(pools[2 * i + 1][1]) for i in range(2)]
    else:
        je.kbufs = [jnp.asarray(pools[2 * i]) for i in range(2)]
        je.vbufs = [jnp.asarray(pools[2 * i + 1]) for i in range(2)]
    je.table[:] = table
    jout, jacc = je.verify(pending.astype(np.int32),
                           drafts.astype(np.int32), t, *_greedy_args())

    pe = _port_verify_engine(pm, int8, pools, table, k)
    out, acc = pe.verify(pending, drafts, t, *_greedy_args())
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    # the argmax chains landed where they were built to
    assert acc.numpy()[:3].tolist() == [w for _, _, w in VERIFY_SLOTS][:3]
    for i in range(2):
        for mine, theirs in ((pe.kbufs[i], je.kbufs[i]),
                             (pe.vbufs[i], je.vbufs[i])):
            if int8:
                diff = np.abs(mine.numpy().astype(np.int32)
                              - np.asarray(theirs).astype(np.int32))
                assert diff.max() <= 1
            else:
                np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                           atol=1e-5, rtol=1e-5)
        if int8:
            for mine, theirs in ((pe.kscales[i], je.kscales[i]),
                                 (pe.vscales[i], je.vscales[i])):
                np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                           atol=0, rtol=1e-5)


# ------------------------------------------------------------- serving
def _serve_jax(jm, prompts, n, spec=True, max_len=128, poison=False,
               eos_id=None, **kw):
    eng = JaxEngine(jm, max_batch_slots=2, max_len=max_len, top_k=1,
                    prefill_chunk=16, eos_id=eos_id,
                    spec=JaxNgram(k=4) if spec else None, **kw)
    if poison:
        eng.engine._ensure_buffers()
        if eng.engine.quantized:
            eng.engine.kbufs = [jnp.full_like(b, 127)
                                for b in eng.engine.kbufs]
            eng.engine.vbufs = [jnp.full_like(b, 127)
                                for b in eng.engine.vbufs]
            eng.engine.kscales = [jnp.full_like(s, 1e7)
                                  for s in eng.engine.kscales]
            eng.engine.vscales = [jnp.full_like(s, 1e7)
                                  for s in eng.engine.vscales]
        else:
            eng.engine.kbufs = [jnp.full_like(b, 1e9)
                                for b in eng.engine.kbufs]
            eng.engine.vbufs = [jnp.full_like(b, 1e9)
                                for b in eng.engine.vbufs]
    reqs = [eng.submit(JaxRequest(prompt=p, max_new_tokens=n, greedy=True))
            for p in prompts]
    m = eng.run(max_steps=800)
    assert all(r.status == "done" for r in reqs)
    return [r.tokens for r in reqs], m.aggregate(), reqs


def _serve_port(pm, prompts, n, spec=True, max_len=128, poison=False,
                eos_id=None, **kw):
    eng = ServingEngine(pm, max_batch_slots=2, max_len=max_len, top_k=1,
                        prefill_chunk=16, eos_id=eos_id,
                        spec=NgramDrafter(k=4) if spec else None,
                        device="cpu", **kw)
    if poison:
        eng.engine.reset()
        fill = 127 if eng.quantized else 1e9
        for buf in eng.engine.kbufs + eng.engine.vbufs:
            buf.fill_(fill)
        for sc in (eng.engine.kscales or []) + (eng.engine.vscales or []):
            sc.fill_(1e7)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=n, greedy=True))
            for p in prompts]
    m = eng.run(max_steps=800)
    assert all(r.status == "done" for r in reqs)
    # every block is back, but for those the trie holds
    held = set() if eng._cache is None else \
        {b for n in eng._cache.iter_nodes() for b in n.blocks}
    assert eng._alloc.free_count() + len(held) == eng._alloc.capacity
    return [r.tokens for r in reqs], m.aggregate(), reqs


SPEC_KEYS = ("spec_verify_steps", "spec_mean_accepted_per_step",
             "spec_mean_tokens_per_step", "decode_steps", "prefill_chunks",
             "preemptions", "blocks_in_use_peak", "block_allocs",
             "block_frees", "prompt_tokens", "prefix_hit_tokens")
TRACES = {
    # test_speculative.py's mixed lengths on a poisoned pool
    "mixed": (MIXED, 9, dict(block_size=16, poison=True)),
    # test_paged_kv.py:453: three prompts on two slots, the third riding
    # the trie the first two populated
    "prefix_cache": ([SYS + [21, 22, 23], SYS + [1, 2, 1, 2, 1, 2],
                      SYS + [21, 22, 23]], 8,
                     dict(block_size=16, cache=16)),
    # 7 allocatable blocks of 8, each request needs 5 with the k rows
    "preempting": ([list(range(1, 25)), list(range(30, 54))], 12,
                   dict(max_len=64, block_size=8, num_blocks=8)),
}


def _kw(kw, jax_side):
    kw = dict(kw)
    cache = kw.pop("cache", None)
    if cache is not None:
        kw["prefix_cache"] = (JaxPrefixCache if jax_side else PrefixCache)(
            chunk_tokens=cache)
    return kw


@pytest.mark.parametrize("trace", list(TRACES))
def test_spec_serving_matches_jax_and_the_plain_engine(models, trace):
    jm, pm = models
    prompts, n, kw = TRACES[trace]
    jt, ja, _ = _serve_jax(jm, prompts, n, **_kw(kw, True))
    pt, pa, _ = _serve_port(pm, prompts, n, **_kw(kw, False))
    plain, plain_agg, _ = _serve_port(pm, prompts, n, spec=False,
                                      **_kw(kw, False))
    assert pt == jt == plain
    assert len({t for toks in pt for t in toks}) > 4   # not a copy loop
    for key in SPEC_KEYS:
        assert pa[key] == ja[key], key
    # the verify commits more than one token a slot a step on these
    assert pa["spec_mean_tokens_per_step"] > 1.0
    assert pa["decode_steps"] < plain_agg["decode_steps"]
    if trace == "preempting":
        assert pa["preemptions"] >= 1
    if trace == "prefix_cache":
        # the reference's contract: the dense non-speculative baseline
        dense, _, _ = _serve_jax(jm, prompts, n, spec=False)
        assert pt == dense
        assert pa["prefix_hit_tokens"] >= 32


def test_int8_spec_serving_matches_jax_int8_spec(models, monkeypatch):
    """int8 pools (poisoned): the JAX int8 verify reads its positions
    from ``cl`` = k + 1 (the reference fault of ``test_torch_int8.py``);
    with that one read corrected, the tokens and counts are equal."""
    jm, pm = models
    _read_jax_positions_from_t(monkeypatch)
    prompts = [SYS + [21, 22, 23], SYS + [1, 2, 1, 2, 1, 2], [5, 9, 2]]
    kw = dict(block_size=16, kv_dtype="int8", poison=True)
    jt, ja, _ = _serve_jax(jm, prompts, 8, **kw)
    pt, pa, _ = _serve_port(pm, prompts, 8, **kw)
    assert pt == jt
    for key in SPEC_KEYS:
        assert pa[key] == ja[key], key


def test_sampled_stream_isolated_and_seeded(models):
    """A seeded temperature request commits the same tokens alone or
    next to other requests, and again on a fresh engine (drafts depend
    on its own context, coins and draws on (keydata, position))."""
    _, pm = models

    def run(neighbours):
        eng = ServingEngine(pm, max_batch_slots=2, max_len=96,
                            block_size=16, prefill_chunk=16,
                            spec=NgramDrafter(k=4), device="cpu")
        r = eng.submit(Request(prompt=[4, 9, 6, 4, 9, 6], max_new_tokens=8,
                               temperature=0.9, seed=77))
        for p in neighbours:
            eng.submit(Request(prompt=p, max_new_tokens=10,
                               temperature=0.7, seed=5))
        eng.run(max_steps=200)
        return r.tokens

    alone = run([])
    assert run([[1, 2, 3, 4, 5, 6, 7, 8], [2, 2]]) == alone
    assert run([]) == alone


# ---------------------------------------------------------- temperature
class _FixedLogits(torch.nn.Module):
    """A stub target whose logits are one fixed row at every position."""

    def __init__(self, row, device="cpu"):
        super().__init__()
        self.row = torch.as_tensor(row, dtype=torch.float32)
        self.device = torch.device(device)

    def kv_cache_spec(self):
        return {"num_layers": 1, "num_heads": 1, "head_dim": 1,
                "dtype": torch.float32, "device": self.device,
                "max_position_embeddings": 64}

    def forward(self, ids, caches=None):
        b, s = ids.shape
        return self.row.expand(b, s, -1).clone(), caches


@pytest.mark.parametrize("top_p", [1.0, 0.9])
def test_temperature_acceptance_preserves_the_target(top_p):
    """20000 verifies (1000 slots x 20 streams) of one logit row at
    temperature 0.8 with a non-argmax draft: the accept rate is p(d),
    the committed token at position 0 — and at position 1 after an
    accept — follows the filtered softmax (chi-square at p > 1e-3), and
    no committed token lies outside the nucleus."""
    V, b, rounds, temp, k = 12, 1000, 20, 0.8, 2
    row = np.random.RandomState(4).randn(V).astype(np.float32)
    z = row / temp
    order = np.argsort(-z)
    p_sorted = np.exp(z[order] - z.max())
    p_sorted /= p_sorted.sum()
    keep = np.zeros(V, bool)
    keep[order[(np.cumsum(p_sorted) - p_sorted) < top_p]] = True
    p = np.where(keep, np.exp(z - z.max()), 0.0)
    p /= p.sum()
    d = int(order[1])            # plausibly but not always accepted

    eng = SpeculativeEngine(_FixedLogits(row), b, 16, k=k, block_size=16)
    temps = np.full((b,), temp, np.float32)
    greedy = np.zeros((b,), bool)
    topps = np.full((b,), top_p, np.float32)
    pending = np.full((b, 1), 5, np.int64)
    drafts = np.full((b, k), d, np.int64)
    t = np.full((b,), 4, np.int32)
    first, second, accepts = [], [], []
    for r in range(rounds):
        kd = np.stack([request_keydata(r, i) for i in range(b)])
        out, acc = eng.verify(pending, drafts, t, temps, greedy, kd,
                              topps=topps)
        out2, acc2 = eng.verify(pending, drafts, t, temps, greedy, kd,
                                topps=topps)
        assert torch.equal(out, out2) and torch.equal(acc, acc2)
        out, acc = out.numpy(), acc.numpy()
        first.append(out[:, 0])
        second.append(out[acc >= 1, 1])
        accepts.append(acc >= 1)
    assert abs(np.mean(accepts) - p[d]) < 0.02
    for toks in (np.concatenate(first), np.concatenate(second)):
        counts = np.bincount(toks, minlength=V)
        assert counts[~keep].sum() == 0
        n = len(toks)
        chi2 = (((counts[keep] - n * p[keep]) ** 2) / (n * p[keep])).sum()
        assert chi2 < stats.chi2.ppf(0.999, keep.sum() - 1), chi2


def test_position_uniforms_are_uniform_uncorrelated_and_pure():
    kd = np.stack([request_keydata(0, i) for i in range(1000)])
    pos = np.arange(100)[None, :] + np.zeros((1000, 1), np.int64)
    u0 = position_uniforms(kd, torch.from_numpy(pos), LANE_DRAW).numpy()
    u1 = position_uniforms(kd, torch.from_numpy(pos), LANE_COIN).numpy()
    assert u0.dtype == np.float32 and u0.shape == (1000, 100)
    assert u0.min() >= 0.0 and u0.max() < 1.0
    for u in (u0, u1):
        counts = np.bincount((u.ravel() * 100).astype(int), minlength=100)
        chi2 = ((counts - u.size / 100) ** 2 / (u.size / 100)).sum()
        assert chi2 < stats.chi2.ppf(0.999, 99), chi2
    # lanes, neighbouring positions and neighbouring requests: |r| well
    # under 5 standard errors (1 / sqrt(n))
    for a, b in ((u0, u1), (u0[:, :-1], u0[:, 1:]), (u0[:-1], u0[1:])):
        r = np.corrcoef(a.ravel(), b.ravel())[0, 1]
        assert abs(r) < 5 / np.sqrt(a.size), r
    # pure: the same (keydata, P, lane) gives the same bits in any batch
    # and shape, from numpy or torch key data
    sub = position_uniforms(torch.from_numpy(kd[7:9].astype(np.int64)),
                            torch.tensor([30, 99]), LANE_DRAW).numpy()
    assert sub.tolist() == [u0[7, 30], u0[8, 99]]
    again = position_uniforms(kd, torch.from_numpy(pos), LANE_DRAW).numpy()
    assert np.array_equal(again, u0)
    # the key data is the request's stream: seed pins it, else (engine
    # seed, id) decides it
    assert np.array_equal(request_keydata(3, 5, 77), request_keydata(9, 1, 77))
    assert not np.array_equal(request_keydata(0, 1), request_keydata(0, 2))


# ------------------------------------------------------ EOS, headroom
def _accepted_indices(eng, plen):
    """Wrap ``eng.engine.verify`` to collect the stream indices of slot
    0's tokens that were accepted drafts."""
    seen = []
    verify = eng.engine.verify

    def wrapped(*args, **kw):
        # the serving tick defers the verify: (out, acc, finalize)
        res = verify(*args, **kw)
        acc = res[1]
        t0, a = int(args[2][0]), min(int(acc[0]), 4)
        seen.extend(t0 - plen + 1 + j for j in range(a))
        return res

    eng.engine.verify = wrapped
    return seen


def test_eos_inside_an_accepted_prefix_retires_at_eos(models):
    """The EOS id is a token of the reference's own greedy continuation
    that the port's verify committed as an accepted draft, first seen at
    that index: with it as EOS both speculative engines retire there,
    the tokens after it dropped."""
    jm, pm = models
    # the n-gram drafter copies from the context, so an accepted draft
    # seen for the first time in the output comes from the prompt
    prompt = [184, 60, 180, 22, 0]
    ref, _, _ = _serve_jax(jm, [prompt], 16, spec=False)
    ref = ref[0]
    eng = ServingEngine(pm, max_batch_slots=2, max_len=128, top_k=1,
                        prefill_chunk=16, block_size=16,
                        spec=NgramDrafter(k=4), device="cpu")
    accepted = _accepted_indices(eng, len(prompt))
    r = eng.submit(Request(prompt=prompt, max_new_tokens=16, greedy=True))
    eng.run(max_steps=100)
    assert r.tokens == ref
    stop = next(i for i in accepted
                if 2 <= i < len(ref) - 1 and ref[i] not in ref[:i])
    eos = ref[stop]
    jt, _, jreqs = _serve_jax(jm, [prompt], 16, eos_id=eos)
    pt, _, preqs = _serve_port(pm, [prompt], 16, eos_id=eos,
                               block_size=16)
    assert pt == jt == [ref[:stop + 1]]
    assert preqs[0].finish_reason == jreqs[0].finish_reason == "eos"


@pytest.mark.parametrize("case", [
    dict(prompt=[1] * 61, max_new_tokens=2),            # prompt headroom
    dict(prompt=[3] * 58, max_new_tokens=32),           # slot budget
    dict(prompt=[3] * 30, max_new_tokens=17),           # alone-fit + k
])
def test_headroom_errors_carry_the_reference_messages(models, case):
    jm, pm = models
    kw = dict(max_batch_slots=1, max_len=64, top_k=1, block_size=8,
              num_blocks=7)
    je = JaxEngine(jm, spec=JaxNgram(k=4), **kw)
    pe = ServingEngine(pm, spec=NgramDrafter(k=4), device="cpu", **kw)
    with pytest.raises(ValueError) as jerr:
        je.submit(JaxRequest(**case))
    with pytest.raises(ValueError) as perr:
        pe.submit(Request(**case))
    assert str(perr.value) == str(jerr.value)
    assert "speculation" in str(perr.value) or "blocks" in str(perr.value)


def test_boundary_budget_runs_to_length(models):
    _, pm = models
    eng = ServingEngine(pm, max_batch_slots=1, max_len=64, top_k=1,
                        block_size=16, spec=NgramDrafter(k=4), device="cpu")
    n = (64 - 4) - 58 + 1
    edge = eng.submit(Request(prompt=[3] * 58, max_new_tokens=n,
                              greedy=True))
    eng.run(max_steps=100)
    assert edge.finish_reason == "length" and len(edge.tokens) == n


def test_device_refusals(models):
    """No card: the default device raises. A verify of any k is taken on
    a CUDA device too, K4 running any number of query rows a slot (a
    stub model that claims the card; nothing is allocated at
    construction), as on the CPU."""
    _, pm = models
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(pm, max_batch_slots=1, max_len=64, block_size=8,
                          spec=NgramDrafter(k=4))
    stub = _FixedLogits(np.zeros(4, np.float32), device="cuda")
    for k in (15, 16, 31):
        assert SpeculativeEngine(stub, 1, 64, k=k, block_size=8).k == k
        assert SpeculativeEngine(_FixedLogits(np.zeros(4)), 1, 64, k=k,
                                 block_size=8).k == k
