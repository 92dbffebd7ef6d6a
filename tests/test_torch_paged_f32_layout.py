"""K4's and K5's fp32 body, rehearsed on the CPU.

``csrc/paged_common.cuh``'s ``paged_f32_kernel<TP, D, RT>`` runs fp32
queries over fp32 or int8 pools for both K4 (decode/verify) and K5
(chunk prefill), in row tiles of 16, 32 or 64 by the slot's query rows
(``f32_rows`` in the same header): a CTA owns a row tile of
one (slot, head), the C CTAs of a cluster split its key walk into even
shares of KT-key tiles, and the partials merge through distributed
shared memory. No card is needed to check that dataflow: this file
emulates every CTA of every cluster in numpy fp32, with the constants,
the grid order, the rank's tile range, the reach, the cluster size rule
and the merge's chunk loop parsed from the source, and checks that

- each row tile's keys up to its reach are walked exactly once across
  the cluster's ranks, whatever the cluster size (1, 2, 4, 8), and no
  pool row past the reach, nor its block's scale, is ever addressed
  (every row no query may read, and every block no table names, holds
  NaN; int8 codes 127 there, scales NaN);
- a rank with no key tile merges as m = -1e30, l = 0, o = 0;
- the thread map covers the tile once: 16 row groups x 16 lanes, rows
  grp + 16 r, keys lane + 16 c (QK) and dims 4 lane + 64 x (P.V), and
  the merge's float4 chunks once across ranks and threads;
- the row tile is the body's own, whatever q-block ``pick_qbs`` gives
  (s 100, 64, 128), K4's verify takes any s (17 and 32 rows: one 32-row
  tile; 80: a 64-row tile and a ragged one) and the tile's reach mask
  holds on a 33-row table (blocks of 11) that a 16-row verify runs off;
- int8 codes are dequantized by their own block's (block, head) scale.

Every case is held to the plain version (``paged_attention_ref`` /
``chunk_prefill_ref``) on clean pools within 1e-5 + 1e-5 |plain|: both
sides compute in fp32 and differ in summation order, exp2 of log2-scaled
logits against exp, and the merge; a key tile dropped, a rank left out,
a mask off or a scale of the wrong block moves an output by more than
1e-2. One chunk is also held to the JAX package's ``chunk_prefill_xla``.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.chunk_prefill import chunk_prefill_xla
from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
from paddle_tpu_torch.ops.kernels import paged_attention as k4

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"
SRC = (CSRC / "paged_common.cuh").read_text()
K5_SRC = (CSRC / "chunk_prefill.cu").read_text()
BODY = SRC[SRC.index("paged_f32_kernel(const float*"):
           SRC.index("inline int f32_splits(")]
LOG2E = np.float32(1.4426950408889634)
MASKED = np.float32(-1e30)
ATOL = RTOL = 1e-5
SMS = 132                                # the H100's SMs


def _const(name, src=SRC):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


THREADS, LANES = _const("kF32Threads"), _const("kF32Lanes")
GROUPS = THREADS // LANES
MAX_SPLITS, CTAS_PER_SM = _const("kF32MaxSplits"), _const("kF32CTAsPerSM")


def _c_expr(expr):
    """A C int expression as Python: one ternary (possibly nested right),
    min, and / on non-negative ints."""
    expr = " ".join(expr.split())
    m = re.fullmatch(r"(.*?) \? (.*?) : (.*)", expr)
    if m:
        return (f"(({_c_expr(m.group(2))}) if ({m.group(1)}) else "
                f"({_c_expr(m.group(3))}))")
    return (expr.replace("/", "//").replace("||", " or ")
            .replace("&&", " and "))


def _int(name, body=BODY):
    """The body's ``name = ...`` initialiser as Python: up to the first
    comma or semicolon outside parentheses."""
    i = re.search(rf"\b{name} =\s*", body).end()
    depth = 0
    for j in range(i, len(body)):
        ch = body[j]
        depth += (ch == "(") - (ch == ")")
        if depth == 0 and ch in ",;":
            return _c_expr(body[i:j])
    raise AssertionError(name)


_KT = _c_expr(re.search(r"static constexpr int value = (.*?);",
                        SRC).group(1))
_WALK = {n: _int(n) for n in ("tile", "row0", "nrows", "base", "reach",
                              "n_tiles", "tile_lo", "tile_hi")}
_F32_ROWS = _c_expr(re.search(r"inline int f32_rows\(int s\) \{ return "
                              r"(.*?); \}", SRC).group(1))
_SPLIT_WHILE = _c_expr(re.search(r"while \(c > 1 && (.*?)\) c /= 2;",
                                 SRC).group(1))
assert "static_cast<int64_t>(kF32CTAsPerSM) * 16 / RT * sms;" in SRC
assert re.search(r"f32_splits\(units, RT, \(bp \* bs \+ F32Keys<D>::value - 1\)"
                 r" /\s*F32Keys<D>::value, sms\);", SRC)
# the grid: C CTAs a cluster on x, a cluster a (unit, head)
assert "cfg.gridDim = dim3(static_cast<unsigned>(c * units));" in SRC
assert ("const int h = blockIdx.x / nsplit % H, unit = blockIdx.x / nsplit"
        " / H;" in BODY)
# the thread map as the body writes it
assert "qs + (grp + kF32Groups * r) * KP" in BODY
assert "kt + (lane + kF32Lanes * c) * KP" in BODY
assert "vt + (c + k) * D +\n" in BODY and "4 * lane + 64 * x" in BODY
assert "const bool busy = grp < nrows;" in BODY
# the fp32 launch paths take no q-block
assert re.search(r"f32_by_dim<int8_t>\(q, k_pool, v_pool, ks, vs, tbl, tv,"
                 r"\s*out, b,\s*s, H, D,", K5_SRC)


def key_tile(D):
    return eval(_KT, {"D": D})


def f32_rows(s):
    return eval(_F32_ROWS, {"s": s})


def f32_splits(units, RT, max_tiles, sms=SMS):
    """The cluster size f32_splits picks for a grid of ``units`` walks of
    RT-row tiles over tables of ``max_tiles`` key tiles."""
    c = MAX_SPLITS
    env = {"units": units, "target": CTAS_PER_SM * 16 // RT * sms,
           "max_tiles": max_tiles}
    while c > 1 and eval(_SPLIT_WHILE, {**env, "c": c}):
        c //= 2
    return c


def walk(unit, rank, nsplit, s, ntile, RT, KT, t, bs, bp):
    """The CTA's row tile and key tiles, by the body's expressions."""
    env = {"unit": unit, "rank": rank, "nsplit": nsplit, "s": s,
           "ntile": ntile, "RT": RT, "KT": KT, "bs": bs, "bp": bp,
           "min": min}
    for name in ("tile", "row0", "nrows"):
        env[name] = eval(_WALK[name], env)
    env["tv"] = t
    env["slot"] = unit // ntile
    env["base"] = int(eval(_WALK["base"], env))
    for name in ("reach", "n_tiles", "tile_lo", "tile_hi"):
        env[name] = eval(_WALK[name], env)
    return env


@functools.lru_cache(maxsize=None)
def merge_chunks(nrows, D, rank, nsplit):
    """The float4 chunks rank ``rank`` merges, by the body's loop."""
    m = re.search(r"for \(int idx = (.*?); idx < (.*?);\s*idx \+= (.*?)\)",
                  BODY, re.S)
    init, bound, step = (_c_expr(x) for x in m.groups())
    env = {"rank": rank, "nsplit": nsplit, "NT": THREADS, "nrows": nrows,
           "OC": D // 4}
    got = []
    for tid in range(THREADS):
        idx = eval(init.replace("tid", str(tid)), env)
        while idx < eval(bound, env):
            got.append(idx)
            idx += eval(step, env)
    return got


def emulate_cta(q, kp, vp, ksc, vsc, table, t, unit, h, rank, nsplit, RT,
                scale, walked):
    """One CTA: its partial (m, l, o) of its tile's nrows rows, every key
    it walks added to ``walked``."""
    b, s, H, D = q.shape
    bs, bp = kp.shape[1], table.shape[1]
    KT = key_tile(D)
    ntile = -(-s // RT)
    w = walk(unit, rank, nsplit, s, ntile, RT, KT, t, bs, bp)
    slot, nrows, row0 = w["slot"], w["nrows"], w["row0"]
    base, reach = w["base"], w["reach"]
    qs = np.zeros((RT, D), np.float32)
    qs[:nrows] = q[slot, row0:row0 + nrows, h] * np.float32(scale * LOG2E)
    m = np.full(RT, MASKED, np.float32)
    lsum = np.zeros(RT, np.float32)
    acc = np.zeros((RT, D), np.float32)
    pos = base + np.arange(RT)[:, None]
    for j in range(w["tile_lo"], w["tile_hi"]):
        K = np.zeros((KT, D), np.float32)
        V = np.zeros((KT, D), np.float32)
        cols = j * KT + np.arange(KT)
        for r, col in enumerate(cols):
            if col > reach:             # zero-filled, never addressed
                continue
            walked[(slot, h, w["tile"])].append(int(col))
            blk = table[slot, col // bs]
            K[r], V[r] = kp[blk, col % bs, h], vp[blk, col % bs, h]
            if ksc is not None:
                K[r] *= ksc[blk, h]
                V[r] *= vsc[blk, h]
        S = qs @ K.T
        S = np.where((cols[None, :] > pos) | (cols[None, :] > reach), MASKED,
                     S).astype(np.float32)
        mn = np.maximum(m, S.max(1))
        alpha = np.exp2(m - mn)
        P = np.where(mn[:, None] == MASKED, np.float32(0),
                     np.exp2(S - mn[:, None])).astype(np.float32)
        lsum = lsum * alpha + P.sum(1)
        acc = acc * alpha[:, None] + P @ V
        m = mn
    return w, m[:nrows], lsum[:nrows], acc[:nrows]


def emulate(q, kp, vp, ksc, vsc, table, t, RT, nsplit=None):
    """Every cluster of the grid (C = ``nsplit``, else f32_splits's
    choice): O (b, s, H, D) fp32 and the keys each row tile walked."""
    b, s, H, D = q.shape
    scale = 1.0 / np.sqrt(D)
    ntile = -(-s // RT)
    units = b * ntile * H
    KT = key_tile(D)
    max_tiles = -(-kp.shape[1] * table.shape[1] // KT)
    C = f32_splits(units, RT, max_tiles) if nsplit is None else nsplit
    out = np.full(q.shape, np.nan, np.float32)
    walked = {(sl, h, ti): [] for sl in range(b) for h in range(H)
              for ti in range(ntile)}
    for bx in range(0, C * units, C):   # a cluster's first CTA
        unit, h = divmod(bx // C, H)
        parts = [emulate_cta(q, kp, vp, ksc, vsc, table, t, unit, h,
                             (bx + rank) % C, C, RT, scale, walked)
                 for rank in range(C)]
        w = parts[0][0]
        for rank in range(C):
            wr, pm, pl, po = parts[rank]
            if wr["tile_hi"] == wr["tile_lo"]:   # a rank with no tile
                assert (pm == MASKED).all() and (pl == 0).all() \
                    and (po == 0).all()
        seen = []
        for rank in range(C):
            for idx in merge_chunks(w["nrows"], D, rank, C):
                seen.append(idx)
                row, c = divmod(idx, D // 4)
                ms = np.array([p[1][row] for p in parts])
                mm = ms.max()
                a = np.exp2(ms - mm)
                ls = sum(p[2][row] * ai for p, ai in zip(parts, a))
                o = sum(p[3][row, 4 * c:4 * c + 4] * ai
                        for p, ai in zip(parts, a))
                out[w["slot"], w["row0"] + row, h, 4 * c:4 * c + 4] = \
                    o * (np.float32(1) / ls)
        assert sorted(seen) == list(range(w["nrows"] * D // 4))
    return out, walked


def _case(b, s, starts, D, bs, bp, int8, seed, H=2):
    """q, pools (and scales) and a shuffled table of distinct blocks, with
    the scratch block 0 and 4 spare blocks named by no table row."""
    rs = np.random.RandomState(seed)
    nblk = 1 + b * bp + 4
    table = (1 + rs.permutation(nblk - 1)[:b * bp]).reshape(b, bp).astype(
        np.int32)
    q = rs.randn(b, s, H, D).astype(np.float32)
    if int8:
        kp, vp = (rs.randint(-127, 128, (nblk, bs, H, D)).astype(np.int8)
                  for _ in range(2))
        ksc, vsc = ((0.02 + 0.01 * np.abs(rs.randn(nblk, H))).astype(
            np.float32) for _ in range(2))
    else:
        kp, vp = (rs.randn(nblk, bs, H, D).astype(np.float32)
                  for _ in range(2))
        ksc = vsc = None
    return q, kp, vp, ksc, vsc, table, np.asarray(starts, np.int32)


def _poisoned(kp, vp, ksc, vsc, table, t, s):
    """NaN (int8: code 127, scale NaN) where no query may read: rows past
    each slot's last position that the table names, and blocks no table
    names."""
    nblk, bs = kp.shape[0], kp.shape[1]
    readable = np.zeros((nblk, bs), bool)
    cols = np.arange(table.shape[1] * bs)
    for slot, t0 in enumerate(t):
        ok = cols <= t0 + s - 1
        readable[table[slot][cols[ok] // bs], cols[ok] % bs] = True
    named = np.zeros(nblk, bool)
    named[table.reshape(-1)] = True
    kp, vp = kp.copy(), vp.copy()
    if ksc is None:
        for p in (kp, vp):
            p[~readable] = np.nan
            p[~named] = np.nan
        return kp, vp, None, None
    ksc, vsc = ksc.copy(), vsc.copy()
    for p in (kp, vp):
        p[~readable] = 127
    ksc[~named] = np.nan
    vsc[~named] = np.nan
    return kp, vp, ksc, vsc


def _plain(fn, q, kp, vp, ksc, vsc, table, t):
    sc = {} if ksc is None else dict(k_scale=torch.from_numpy(ksc),
                                     v_scale=torch.from_numpy(vsc))
    return fn(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
              torch.from_numpy(table), torch.from_numpy(t), **sc).numpy()


def _check(kernel, b, s, starts, D, bs, bp, int8, seed, nsplit=None):
    q, kp, vp, ksc, vsc, table, t = _case(b, s, starts, D, bs, bp, int8,
                                          seed)
    RT = f32_rows(s)
    got, walked = emulate(q, *_poisoned(kp, vp, ksc, vsc, table, t, s),
                          table, t, RT, nsplit)
    ref = _plain(k4.paged_attention_ref if kernel == "K4"
                 else k5.chunk_prefill_ref, q, kp, vp, ksc, vsc, table, t)
    assert np.isfinite(got).all()
    err = np.abs(got - ref) - RTOL * np.abs(ref)
    assert float(err.max()) <= ATOL
    # every row tile's keys up to its reach, each walked once
    for (slot, h, ti), cols in walked.items():
        nrows = min(RT, s - ti * RT)
        reach = min(int(t[slot]) + ti * RT + nrows - 1, bp * bs - 1)
        assert sorted(cols) == list(range(reach + 1))
    return got, ref


# (kernel, b, s, starts, D, bs, bp, int8): K4's decode step (3 slots),
# a verify (s 5), 16 rows running off a 33-row table (blocks of 11), D
# 128, verifies of 16 and 31 drafts (s 17 and 32: one 32-row tile, the
# s-17 one ragged) and 80 rows (a 64-row tile and a 16-row one) whose
# second slot runs off its table; K5's chunks of 128 (two 64-row tiles), 100 (its s-100 tiling: 64
# + 36 rows, not pick_qbs's 25 of 4), 64, a 24-row chunk (a 32-row tile)
# and a chunk running off a 5-block table; each over fp32 and int8 pools
CASES = [("K4", 3, 1, (0, 37, 200), 64, 16, 16),
         ("K4", 2, 5, (78, 30), 64, 16, 8),
         ("K4", 1, 16, (32,), 64, 11, 3),
         ("K4", 2, 3, (5, 90), 128, 16, 8),
         ("K4", 2, 17, (0, 100), 64, 16, 8),
         ("K4", 2, 32, (40, 3), 64, 16, 8),
         ("K4", 2, 80, (7, 60), 64, 16, 8),
         ("K5", 1, 128, (37,), 64, 16, 16),
         ("K5", 1, 100, (75,), 64, 16, 16),
         ("K5", 2, 64, (0, 130), 64, 16, 16),
         ("K5", 1, 24, (9,), 128, 16, 4),
         ("K5", 1, 64, (40,), 64, 16, 5)]


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-b{c[1]}-s"
                         f"{c[2]}-D{c[4]}-bs{c[5]}x{c[6]}")
def test_emulated_body_matches_the_plain_version(case, int8):
    kernel, b, s, starts, D, bs, bp = case
    _check(kernel, b, s, starts, D, bs, bp, int8, seed=b + s + D + bp)


@pytest.mark.parametrize("nsplit", [1, 2, 4, 8])
def test_every_cluster_size_walks_each_key_once(nsplit):
    """Ranks 0 .. C-1 split every row tile's keys without gap or overlap,
    empty ranks merging as m = -1e30, l = 0 (a 16-row tile at start 0 has
    one key tile: C - 1 ranks get none)."""
    _check("K5", 1, 128, (517,), 64, 16, 64, False, seed=5, nsplit=nsplit)
    _check("K4", 2, 16, (0, 3), 64, 16, 4, True, seed=6, nsplit=nsplit)


def test_thread_map_covers_the_tile_once():
    for RT in (16, 32, 64):
        for D in (64, 128):
            KT = key_tile(D)
            rows = sorted(g + GROUPS * r for g in range(GROUPS)
                          for r in range(RT // GROUPS))
            keys = sorted(lane + LANES * c for lane in range(LANES)
                          for c in range(KT // LANES))
            dims = sorted(4 * lane + 64 * x + e for lane in range(LANES)
                          for x in range(D // 64) for e in range(4))
            assert rows == list(range(RT)) and keys == list(range(KT))
            assert dims == list(range(D))
            # rows < nrows all belong to busy threads (grp < nrows)
            for nrows in range(1, RT + 1):
                assert all(g < nrows for g in range(GROUPS)
                           for r in range(RT // GROUPS)
                           if g + GROUPS * r < nrows)


@pytest.mark.parametrize("s", [100, 64, 128])
def test_row_tile_is_the_body_s_own(s):
    """The fp32 body tiles a chunk by f32_rows(s), whatever pick_qbs
    gives: s 100 runs 2 tiles a head, not 25 q-blocks of 4."""
    RT = f32_rows(s)
    assert RT == 64
    assert (k5.pick_qbs(s), -(-s // RT)) == {100: (4, 2), 64: (64, 1),
                                              128: (64, 2)}[s]
    _check("K5", 1, s, (130,), 64, 16, 24, False, seed=s)


def test_cluster_size_follows_the_grid_not_t():
    """f32_splits: 8 CTAs a cluster while the grid stays within
    kF32CTAsPerSM * 16 / RT CTAs an SM and the table holds 8 key tiles,
    halved past either: gpt2_small's decode step of 8 slots (96 walks of
    16-row tiles) takes 4, a lone request 8, a chunk of 128 (24 walks of
    64-row tiles) 4, a table of 80 rows 2."""
    assert f32_splits(96, 16, 16) == 4 and f32_splits(12, 16, 16) == 8
    assert f32_splits(24, 64, 16) == 4 and f32_splits(12, 64, 16) == 8
    assert f32_splits(24, 16, 2) == 2 and f32_splits(12, 16, 1) == 1
    for RT in (16, 32, 64):
        target = CTAS_PER_SM * 16 // RT * SMS
        assert f32_splits(target, RT, 16) == 1
        for units in range(1, 700, 7):
            for tiles in (1, 2, 3, 5, 16):
                c = f32_splits(units, RT, tiles)
                assert c == 1 or (units * c <= target and c <= tiles)


def test_one_chunk_matches_the_reference_xla():
    q, kp, vp, ksc, vsc, table, t = _case(1, 100, (75,), 64, 16, 16, False,
                                          seed=9)
    got, _ = emulate(q, kp, vp, None, None, table, t, f32_rows(100))
    ref = np.asarray(chunk_prefill_xla(jnp.asarray(q), jnp.asarray(kp),
                                       jnp.asarray(vp), None, None,
                                       jnp.asarray(table), 75))
    assert float((np.abs(got - ref) - RTOL * np.abs(ref)).max()) <= ATOL
