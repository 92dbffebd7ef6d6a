"""Port int8 KV pools against the JAX package's.

- The int8 plain versions of K4 and K5 against ``paged_attention_pallas``
  / ``chunk_prefill_pallas`` in interpret mode, on random codes and
  scales as ``tests/test_pallas_paged.py`` draws them. Tolerance: fp32
  atol/rtol 1e-5 (summation order only; the dequant ``code * scale`` is
  one fp32 product on both sides).
- The quantized commit ``_upd_paged_q`` against the JAX function on the
  same fp rows, tables and offsets: codes and scales EQUAL, commit after
  commit from a poisoned pool (saturated codes, 1e7 scales).
- The int8 engine against the JAX int8 engine on the traces of
  ``tests/test_paged_kv.py``: greedy tokens and counted metrics equal.
  The JAX model reads its position offset from the LAST element of a
  cache tuple (``gpt.py:545-549``), which in the quantized 7-tuple is
  ``cl``, not ``t``: its int8 serving runs at wrong positions. The port
  reads ``t``. The engine parity runs the JAX engine with that one read
  corrected by a test-local patch of ``GPTModel.forward`` (nothing in
  the JAX package changes), and a test of its own pins the fault.
- The engine's own checks: ``block_nbytes`` and the ``kv_dtype`` errors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu.models.gpt import _upd_paged_q as jax_upd_paged_q
from paddle_tpu.ops.pallas.chunk_prefill import chunk_prefill_pallas
from paddle_tpu.ops.pallas.paged_attention import (paged_attention_pallas,
                                                   paged_attention_xla)

from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.models.gpt import _upd_paged_q
from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
from paddle_tpu_torch.ops.kernels import paged_attention as k4

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
SYS = [7, 3, 9, 11, 2, 5, 8, 4] * 4          # 32-token shared prefix

# pool geometry of tests/test_torch_kernels.py: 3 slots, 4 heads, head
# dim 64, blocks of 8 rows, 6 blocks per slot, 16 physical blocks
B, H, D, BS, BP, NBLK = 3, 4, 64, 8, 6, 16


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _quant_pools(seed):
    """Random codes in [-127, 127] and scales 0.01 + |N(0, 0.02)|, as
    ``tests/test_pallas_paged.py:43-47``; an aliasing table over blocks
    1..12 (13..15 sit in no table row)."""
    rs = np.random.RandomState(seed)
    kq = rs.randint(-127, 128, (NBLK, BS, H, D)).astype(np.int8)
    vq = rs.randint(-127, 128, (NBLK, BS, H, D)).astype(np.int8)
    ks = (np.abs(rs.randn(NBLK, H)) * 0.02 + 0.01).astype(np.float32)
    vs = (np.abs(rs.randn(NBLK, H)) * 0.02 + 0.01).astype(np.float32)
    tbl = rs.randint(1, 13, size=(B, BP)).astype(np.int32)
    return rs, kq, vq, ks, vs, tbl


# ----------------------------------------------------------- K4/K5 int8
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("scalar_t", [False, True])
def test_paged_attention_int8_matches_pallas(s, scalar_t):
    rs, kq, vq, ks, vs, tbl = _quant_pools(1)
    q = rs.randn(B, s, H, D).astype(np.float32)
    t = np.int32(9) if scalar_t else np.asarray([5, 17, 40 - s], np.int32)
    ref = paged_attention_pallas(*map(jnp.asarray, (q, kq, vq, ks, vs,
                                                    tbl, t)),
                                 interpret=True)
    k4.reset_launches()
    out = k4.paged_attention(_t(q), _t(kq), _t(vq), _t(tbl),
                             torch.tensor(t), k_scale=_t(ks),
                             v_scale=_t(vs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert k4.launches == k4.launches_q == 0     # CPU: no kernel launch


@pytest.mark.parametrize("s,start", [(16, 0), (12, 5), (16, 24), (16, 40)])
def test_chunk_prefill_int8_matches_pallas(s, start):
    """Single-slot chunks at several offsets; at start 40 the chunk's
    tail runs past the table's 48 rows. Saturated codes and 1e7 scales
    in every block no table row names leave the output unchanged."""
    rs, kq, vq, ks, vs, tbl = _quant_pools(2)
    tbl = tbl[:1]
    q = rs.randn(1, s, H, D).astype(np.float32)
    ref = chunk_prefill_pallas(*map(jnp.asarray, (q, kq, vq, ks, vs, tbl,
                                                  np.int32(start))),
                               interpret=True)
    st = torch.tensor(start, dtype=torch.int32)
    out = k5.chunk_prefill(_t(q), _t(kq), _t(vq), _t(tbl), st,
                           k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    unnamed = ~np.isin(np.arange(NBLK), tbl)
    kp, vp, kss, vss = kq.copy(), vq.copy(), ks.copy(), vs.copy()
    kp[unnamed] = vp[unnamed] = 127
    kss[unnamed] = vss[unnamed] = 1e7
    poisoned = k5.chunk_prefill(_t(q), _t(kp), _t(vp), _t(tbl), st,
                                k_scale=_t(kss), v_scale=_t(vss))
    np.testing.assert_allclose(poisoned.numpy(), out.numpy(), rtol=0,
                               atol=0)


def test_int8_plain_version_casts_the_dequantized_view_to_q_dtype():
    """bf16 q: the plain version dequantizes in fp32 and casts the view
    to bf16 before the attention, as ``paged_attention_xla`` does
    (``paged_attention.py:81-86``). Tolerance 2e-2: both run the
    attention in bf16, rounding at places of their own."""
    rs, kq, vq, ks, vs, tbl = _quant_pools(3)
    q = rs.randn(B, 1, H, D).astype(np.float32)
    t = np.asarray([5, 17, 39], np.int32)
    ref = paged_attention_xla(jnp.asarray(q, jnp.bfloat16),
                              *map(jnp.asarray, (kq, vq, ks, vs, tbl, t)))
    out = k4.paged_attention(_t(q).bfloat16(), _t(kq), _t(vq), _t(tbl),
                             _t(t), k_scale=_t(ks), v_scale=_t(vs))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=0)


def test_check_paged_args_int8_needs_both_contiguous_scales():
    _, kq, vq, ks, vs, tbl = _quant_pools(4)
    q = torch.zeros(B, 1, H, D)
    args = (q, _t(kq), _t(vq), _t(tbl))
    assert k4.check_paged_args("k4", *args, _t(ks), _t(vs)) == k4._INT8
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        k4.check_paged_args("k4", *args, _t(ks), None)
    with pytest.raises(ValueError, match="float32 .num_blocks, H."):
        k4.check_paged_args("k4", *args, _t(ks[:, :2]), _t(vs))
    with pytest.raises(ValueError, match="contiguous"):
        k4.check_paged_args("k4", *args, _t(ks),
                            _t(np.asfortranarray(vs)))
    with pytest.raises(ValueError, match="scales are for int8 pools"):
        k4.check_paged_args("k4", q, _t(kq).float(), _t(vq).float(),
                            _t(tbl), _t(ks), _t(vs))
    with pytest.raises(TypeError, match="int8 codes with scales"):
        k4.check_paged_args("k4", q, _t(kq), _t(vq).float(), _t(tbl))


# ------------------------------------------------------- the quantized commit
class _Pools:
    """The same int8 pools and scales on both sides, poisoned as
    ``tests/test_paged_kv.py:66-79``: saturated codes (127) and 1e7
    scales everywhere before the first commit."""

    def __init__(self, nblk=12, bs=8, heads=2, hd=16):
        shape = (nblk, bs, heads, hd)
        self.j = [jnp.full(shape, 127, jnp.int8), jnp.full(shape, 127,
                                                           jnp.int8),
                  jnp.full((nblk, heads), 1e7, jnp.float32),
                  jnp.full((nblk, heads), 1e7, jnp.float32)]
        self.p = [torch.from_numpy(np.array(a)) for a in self.j]
        self.bs, self.heads, self.hd = bs, heads, hd

    def commit(self, kn, vn, tbl, tv, cl):
        self.j = list(jax_upd_paged_q(*self.j, jnp.asarray(kn),
                                      jnp.asarray(vn), jnp.asarray(tbl),
                                      jnp.asarray(tv), jnp.asarray(cl,
                                                                   jnp.int32)))
        kp, vp, ksc, vsc = self.p
        _upd_paged_q(kp, vp, ksc, vsc, _t(kn), _t(vn), _t(tbl), _t(tv), cl)

    def assert_equal(self, what):
        for name, a, b in zip(("k codes", "v codes", "k scales",
                               "v scales"), self.j, self.p):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"{what}: {name}")


def test_quantized_commit_equals_jax_codes_and_scales():
    """One poisoned pool through a serving-like sequence of commits,
    codes and scales equal to the JAX function's after every one:

    - a 16-row prefill chunk, then a final chunk with a pad tail
      (cl = 5 < s = 16) whose scale must not see the pad rows;
    - lockstep decode into partly filled blocks (the ``keep`` floor),
      with growing magnitudes (a scale that grows requantizes the
      block's earlier rows) and a step that crosses a block edge;
    - a chunk that starts mid-block and crosses a block edge;
    - a chunk whose pad tail runs past the table's reach (dropped)."""
    rs = np.random.RandomState(0)
    P = _Pools()
    bs, Hh, Dd = P.bs, P.heads, P.hd
    table = np.asarray([[3, 7, 1, 9], [2, 4, 10, 11], [5, 6, 8, 0]],
                       np.int32)

    def rows(nb, s, mag=1.0):
        return [(rs.randn(nb, s, Hh, Dd) * mag).astype(np.float32)
                for _ in range(2)]

    P.commit(*rows(1, 16), table[:1], np.int32(0), 16)
    P.assert_equal("prefill chunk 1")
    P.commit(*rows(1, 16), table[:1], np.int32(16), 5)
    P.assert_equal("final chunk with a pad tail")
    P.commit(*rows(1, 8), table[1:2], np.int32(0), 8)
    P.assert_equal("slot 1 prefill")
    P.commit(*rows(1, 16), table[2:3], np.int32(4), 13)
    P.assert_equal("chunk crossing a block edge")
    t = np.asarray([21, 8, 17], np.int32)
    for step, mag in enumerate((0.5, 1.0, 3.0, 0.2, 8.0, 1.0, 2.0, 0.1)):
        P.commit(*rows(3, 1, mag), table, t, 1)
        P.assert_equal(f"decode step {step}")
        t = t + 1                # slot 0 crosses into block 3 at row 24
    P.commit(*rows(1, 16), table[1:2], np.int32(25), 7)
    P.assert_equal("chunk running past the table's reach")


def test_quantized_commit_writes_only_touched_blocks():
    """Blocks outside the window pass through code-exact and are never
    written: a shared prefix block stays byte-identical, and the last
    pool row (what a -1 index would hit) is untouched."""
    rs = np.random.RandomState(1)
    P = _Pools()
    table = np.asarray([[3, 7, 1, 9]], np.int32)
    for start in (0, 8, 16):
        P.commit(*[rs.randn(1, 8, P.heads, P.hd).astype(np.float32)
                   for _ in range(2)], table, np.int32(start), 8)
    before = [x.clone() for x in P.p]
    P.commit(*[rs.randn(1, 4, P.heads, P.hd).astype(np.float32) * 5
               for _ in range(2)], table, np.int32(24), 4)
    P.assert_equal("decode-size chunk into block 9")
    for a, b in zip(before, P.p):
        untouched = [blk for blk in range(a.shape[0]) if blk != 9]
        assert torch.equal(a[untouched], b[untouched])


def test_nan_scale_hazard_is_the_reference_s():
    """A reference trait, kept: the absmax is ``abs(view) * valid``
    (``gpt.py:190-193``), so a NaN scale on a fresh block makes its
    stale rows NaN * 0 = NaN, and ``gpt.py:200`` turns the block scale
    into 1.0. Both sides agree on it; the engine never leaves a NaN
    scale in a block a commit can take (poison uses 1e7)."""
    rs = np.random.RandomState(2)
    P = _Pools()
    P.j[2] = P.j[2].at[3].set(jnp.nan)
    P.p[2][3] = float("nan")
    kn, vn = [rs.randn(1, 2, P.heads, P.hd).astype(np.float32)
              for _ in range(2)]
    P.commit(kn, vn, np.asarray([[3, 7]], np.int32), np.int32(0), 2)
    np.testing.assert_array_equal(P.p[2][3].numpy(), 1.0)
    np.testing.assert_array_equal(np.asarray(P.j[2][3]), 1.0)
    np.testing.assert_array_equal(P.p[3].numpy(), np.asarray(P.j[3]))


# ------------------------------------------------------------ the engine
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


def _read_jax_positions_from_t(monkeypatch):
    """Patch the JAX model to read its position offset from ``t``, the
    6th element of a quantized 7-tuple cache, instead of the last one
    (``cl``) — the one read the port corrects."""
    from paddle_tpu import ops

    orig = JaxGPTModel.forward

    def forward(self, input_ids, position_ids=None, caches=None, **kw):
        if position_ids is None and caches is not None and \
                len(caches[0]) == 7:
            t = caches[0][5]
            steps = ops.arange(0, input_ids.shape[1], dtype="int32")
            position_ids = steps + t if not getattr(t, "ndim", 0) else \
                ops.reshape(steps, [1, -1]) + ops.reshape(t, [-1, 1])
        return orig(self, input_ids, position_ids, caches, **kw)

    monkeypatch.setattr(JaxGPTModel, "forward", forward)


@pytest.fixture
def jax_positions_from_t(monkeypatch):
    _read_jax_positions_from_t(monkeypatch)


def _quantized_prefill(jm, pm, start, cl):
    """One quantized prefill chunk at offset ``start`` with ``cl`` real
    rows through both models on zeroed pools: the two logits."""
    L, Hh, Dd, bs, nblk = 2, 4, 16, 16, 10
    table = np.asarray([[3, 7, 1, 9]], np.int32)
    ids = np.random.RandomState(5).randint(0, 256, (1, 16))

    def pools():
        return [np.zeros((nblk, bs, Hh, Dd), np.int8),
                np.zeros((nblk, bs, Hh, Dd), np.int8),
                np.zeros((nblk, Hh), np.float32),
                np.zeros((nblk, Hh), np.float32)]

    jc = [tuple(Tensor(jnp.asarray(a)) for a in pools())
          + (Tensor(jnp.asarray(table)), Tensor(jnp.asarray(np.int32(start))),
             Tensor(jnp.asarray(np.int32(cl)))) for _ in range(L)]
    jl, _ = jm(Tensor(jnp.asarray(ids)), caches=jc)
    pc = [tuple(_t(a) for a in pools())
          + (_t(table), torch.tensor(start, dtype=torch.int32), cl)
          for _ in range(L)]
    with torch.no_grad():
        pl, _ = pm(_t(ids), caches=pc)
    return np.asarray(jl.value), pl.numpy()


def test_reference_reads_int8_positions_from_cl(models, monkeypatch):
    """The reference fault, pinned: a quantized prefill chunk at offset
    16 with 5 real rows. The JAX model takes positions from ``cl`` = 5
    (its logits differ from the port's by far more than fp32 noise);
    with the offset read from ``t`` they agree within 1e-4, as the fp32
    cache path does (``tests/test_torch_gpt.py``)."""
    jm, pm = models
    jl, pl = _quantized_prefill(jm, pm, start=16, cl=5)
    assert np.abs(jl - pl).max() > 1e-1
    _read_jax_positions_from_t(monkeypatch)
    jl, pl = _quantized_prefill(jm, pm, start=16, cl=5)
    np.testing.assert_allclose(pl, jl, atol=1e-4, rtol=0)


def _serve_jax(jm, prompts, n=6, max_len=128, **kw):
    eng = JaxEngine(jm, max_batch_slots=2, max_len=max_len, top_k=1,
                    prefill_chunk=16, kv_dtype="int8", **kw)
    eng.engine._ensure_buffers()
    eng.engine.kbufs = [jnp.full_like(b, 127) for b in eng.engine.kbufs]
    eng.engine.vbufs = [jnp.full_like(b, 127) for b in eng.engine.vbufs]
    eng.engine.kscales = [jnp.full_like(s, 1e7) for s in eng.engine.kscales]
    eng.engine.vscales = [jnp.full_like(s, 1e7) for s in eng.engine.vscales]
    reqs = [eng.submit(JaxRequest(prompt=p, max_new_tokens=n, greedy=True))
            for p in prompts]
    m = eng.run(max_steps=800)
    assert all(r.status == "done" for r in reqs)
    return [r.tokens for r in reqs], m.aggregate()


def _serve_port(pm, prompts, n=6, max_len=128, **kw):
    eng = ServingEngine(pm, max_batch_slots=2, max_len=max_len, top_k=1,
                        prefill_chunk=16, kv_dtype="int8", device="cpu",
                        **kw)
    eng.engine.reset()
    for buf in eng.engine.kbufs + eng.engine.vbufs:
        buf.fill_(127)
    for sc in eng.engine.kscales + eng.engine.vscales:
        sc.fill_(1e7)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=n, greedy=True))
            for p in prompts]
    m = eng.run(max_steps=800)
    assert all(r.status == "done" for r in reqs)
    assert eng._alloc.free_count() == eng._alloc.capacity
    return [r.tokens for r in reqs], m.aggregate()


COUNTED = ("prefill_chunks", "decode_steps", "preemptions",
           "blocks_in_use_peak", "kv_bytes_in_use_peak", "block_allocs",
           "block_frees", "prompt_tokens")


@pytest.mark.parametrize("trace", ["mixed", "preempting"])
def test_int8_engine_matches_jax_int8_engine(models, trace,
                                             jax_positions_from_t):
    """The poisoned int8 traces of ``tests/test_paged_kv.py``: the mixed
    lengths of :483-506 (block 16) and the starved pool of :581-600
    (7 allocatable blocks of 8, a preemption). Greedy tokens and the
    counted metrics equal the JAX int8 engine's."""
    jm, pm = models
    if trace == "mixed":
        prompts = [[5, 9, 2], SYS + [21, 22, 23], [3, 3, 7, 1, 8, 2, 6],
                   list(range(1, 40))]
        kw = dict(block_size=16)
    else:
        prompts = [list(range(1, 25)), list(range(30, 54))]
        kw = dict(n=12, max_len=64, block_size=8, num_blocks=8)
    jt, ja = _serve_jax(jm, prompts, **kw)
    pt, pa = _serve_port(pm, prompts, **kw)
    assert pt == jt
    assert len({t for toks in pt for t in toks}) > 4   # not a copy loop
    for k in COUNTED:
        assert pa[k] == ja[k], k
    if trace == "preempting":
        assert pa["preemptions"] >= 1
    else:
        # the three-way trace of test_paged_kv.py:483: on it the int8
        # tokens equal the fp32 engine's
        fp = ServingEngine(pm, max_batch_slots=2, max_len=128, top_k=1,
                           prefill_chunk=16, device="cpu", **kw)
        reqs = [fp.submit(Request(prompt=p, max_new_tokens=6, greedy=True))
                for p in prompts]
        fp.run(max_steps=800)
        assert [r.tokens for r in reqs] == pt


def test_int8_block_bytes_include_scales(models):
    """``block_nbytes`` is codes plus scales (``test_paged_kv.py:520``),
    equal to the JAX engine's, and ``kv_bytes_in_use_peak`` rides it."""
    jm, pm = models
    kw = dict(max_batch_slots=2, max_len=128, top_k=1, prefill_chunk=16,
              block_size=16)
    eng = ServingEngine(pm, kv_dtype="int8", device="cpu", **kw)
    e = eng.engine
    L, Hh, Dd, bs = e.L, e.heads, e.head_dim, 16
    assert eng._alloc.block_nbytes == bs * 2 * L * Hh * Dd + 2 * L * Hh * 4
    assert eng._alloc.block_nbytes == \
        JaxEngine(jm, kv_dtype="int8", **kw)._alloc.block_nbytes
    fp = ServingEngine(pm, device="cpu", **kw)
    assert fp._alloc.block_nbytes == bs * 2 * L * Hh * Dd * 4
    e.reset()
    assert eng.quantized and e.pool_dtype == torch.int8
    assert all(b.dtype == torch.int8 for b in e.kbufs + e.vbufs)
    assert all(s.shape == (e.num_blocks, Hh) and s.dtype == torch.float32
               and not s.any() for s in e.kscales + e.vscales)
    r = eng.submit(Request(prompt=[3] * 20, max_new_tokens=4, greedy=True))
    agg = eng.run(max_steps=100).aggregate()
    assert r.status == "done"
    assert agg["kv_bytes_in_use_peak"] == \
        agg["blocks_in_use_peak"] * eng._alloc.block_nbytes


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"),
                                dict(block_size=8, kv_dtype="float16"),
                                dict(block_size=8, kv_dtype="bogus")])
def test_kv_dtype_errors_match_jax(models, kw):
    """int8 only, and only on the paged arena — the JAX messages."""
    jm, pm = models
    with pytest.raises((ValueError, TypeError)) as jerr:
        JaxEngine(jm, max_batch_slots=1, max_len=64, **kw)
    with pytest.raises(ValueError) as perr:
        ServingEngine(pm, max_batch_slots=1, max_len=64, device="cpu", **kw)
    if jerr.type is ValueError:
        assert str(perr.value) == str(jerr.value)
    for arg in ("int8", np.int8, torch.int8):
        assert ServingEngine(pm, max_batch_slots=1, max_len=64,
                             block_size=8, kv_dtype=arg,
                             device="cpu").quantized
