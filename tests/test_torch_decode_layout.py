"""K4's bf16 tensor-core cluster body, rehearsed on the CPU.

``csrc/paged_attention.cu``'s ``paged_decode_mma_kernel`` runs decode
and verify attention over the paged pool as ``mma.sync.m16n8k16``
products fed by ``ldmatrix``, with the lane address patterns of
``csrc/flash_mma.cuh``, and splits each (slot, head, 16-row tile)'s key
walk over the CTAs of a thread-block cluster. No card is needed to check that
dataflow: this file emulates every CTA of every cluster lane by lane in
numpy, with the instruction emulations of
``tests/test_torch_flash_bwd_layout.py`` (which hold the patterns, parsed
from the header, to the PTX fragment maps), as the kernel takes its
steps:

- each CTA's row tile (its first row, its row count, its position and
  its reach) and each rank's key-tile range and each warp's key slices,
  with the expressions parsed from the source, for any number of query
  rows a slot (s 17 and 32: two row tiles, one of them ragged);
- each slice gathered row by row through a shuffled table, rows past
  the reach zero-filled and never addressed (every row no query may
  read, and every block none of whose rows may be read, holds NaN,
  codes and scales alike);
- int8 codes turned into bf16 (K) and fp16 (V) exactly, the k scale on
  S's columns, the v scale on P before its fp16 rounding, relative to
  the slice's largest v scale fv, which o carries from slice to slice;
- S on the accumulators, the masks (row and reach), the online softmax
  in log2 units on the fragments, P packed into the A fragment of P.V;
- the warps' partials (o with its fv undone) folded into the CTA's, and
  the cluster merge of every rank's partial, chunk by chunk as the
  source assigns chunks to ranks, into bf16.

Each case is held to the plain version ``paged_attention_ref``
evaluated in fp32 on the same values, element by element: |emulated -
plain| <= 4e-3 + 1e-2 |plain|. The two differ by P rounded to bf16
(2**-9 of each p at most; fp16 over int8 pools, 2**-12), by the
output's bf16 rounding (2**-9 relative) and by summation order and
exp2 against exp; a key tile dropped, a row from the wrong block, a
scale of the wrong block, an fv not undone or a rank left out of the
merge is off by the size of the output itself. One case is also held to
the JAX package's ``paged_attention_xla`` and ``paged_attention_pallas``
(interpret mode) on the same inputs.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.paged_attention import (paged_attention_pallas,
                                                   paged_attention_xla)
from paddle_tpu_torch.ops.kernels import paged_attention as k4
from test_torch_chunk_layout import pack_a_f16
from test_torch_flash_bwd_layout import G, T, _at, _bf16, ldsm, mma, pack_a

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

SRC = (Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"
       / "paged_attention.cu").read_text()
BODY = SRC[SRC.index("paged_decode_mma_kernel(const T*"):]
LOG2E = np.float32(1.4426950408889634)
MASKED = np.float32(-1e30)
ATOL, RTOL = 4e-3, 1e-2


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


SPLITS, TILE, WARPS = _const("kSplits"), _const("kTile"), _const("kWarps")
WARP_KEYS, MAX_ROWS = _const("kWarpKeys"), _const("kMaxRows")
THREADS = 32 * WARPS


def _c_expr(expr):
    """A C int expression of the body as Python: one ternary, min, and /
    on non-negative ints."""
    expr = " ".join(expr.split())
    m = re.fullmatch(r"(.*?) \? (.*?) : (.*)", expr)
    if m:
        expr = f"(({m.group(2)}) if ({m.group(1)}) else ({m.group(3)}))"
    return expr.replace("/", "//")


def _body_int(name):
    """The body's ``const int name = ...`` (or ``name = ...`` in a
    declaration list) as Python source: the initialiser up to the first
    comma or semicolon outside parentheses."""
    i = re.search(rf"\b{name} =\s*", BODY).end()
    depth = 0
    for j in range(i, len(BODY)):
        ch = BODY[j]
        depth += (ch == "(") - (ch == ")")
        if depth == 0 and ch in ",;":
            return _c_expr(BODY[i:j])
    raise AssertionError(name)


_WALK = {name: _body_int(name) for name in
         ("row0", "nrows", "t0", "reach", "n_tiles", "tile_lo", "tile_hi",
          "k_lo", "k_hi", "n_slices", "n_mine")}


def row_tile(tile, s, t, bs, bp):
    """(row0, nrows, t0, reach) of the CTAs of row tile ``tile`` of a slot
    at offset ``t`` with ``s`` query rows, by the body's expressions."""
    env = {"blockIdx": SimpleNamespace(z=tile), "kMaxRows": MAX_ROWS,
           "s": s, "tv": [t], "slot": 0, "bs": bs, "bp": bp, "min": min}
    for name in ("row0", "nrows", "t0", "reach"):
        env[name] = eval(_WALK[name], env)
    return env["row0"], env["nrows"], env["t0"], env["reach"]
_K0 = _c_expr(re.search(r"const int k0 = (.*?);", BODY).group(1))


def walk(reach, rank):
    """{warp: [first key of each of its slices]} of CTA ``rank`` of a
    cluster for a slot of reach ``reach``, by the body's expressions."""
    env = {"reach": reach, "rank": rank, "kTile": TILE, "kSplits": SPLITS,
           "kWarps": WARPS, "kWarpKeys": WARP_KEYS, "min": min}
    for name in ("n_tiles", "tile_lo", "tile_hi", "k_lo", "k_hi",
                 "n_slices"):
        env[name] = eval(_WALK[name], env)
    out = {}
    for warp in range(WARPS):
        env["warp"] = warp
        n_mine = eval(_WALK["n_mine"], env)
        out[warp] = [eval(_K0, {**env, "u": u}) for u in range(n_mine)]
    return out


def merge_chunks(nrows, D, rank):
    """The 8-column output chunks of a row tile of ``nrows`` rows that
    ``rank`` merges, by the body's loop over idx."""
    m = re.search(r"for \(int idx = (.*?); idx < (.*?);\s*idx \+= (.*?)\)",
                  BODY, re.S)
    init, bound, step = (_c_expr(x) for x in m.groups())
    env = {"rank": rank, "kSplits": SPLITS, "kMmaThreads": THREADS,
           "nrows": nrows, "OC": D // 8}
    got = []
    for tid in range(THREADS):
        idx = eval(init.replace("threadIdx.x", str(tid)), env)
        while idx < eval(bound, env):
            got.append(idx)
            idx += eval(step, env)
    return got


def _slice_partial(q16, kp, vp, ksc, vsc, trow, h, t0, reach, keys, scale,
                   bs):
    """One warp's walk over its slices (first keys ``keys``): its rows'
    m, l (per lane, in the C layout) and o, with o's v-scale factor f."""
    D = q16.shape[1]
    code = ksc is not None
    LDS = D + 8
    KD, ND, NS = D // 16, D // 8, WARP_KEYS // 8
    qs = np.zeros(MAX_ROWS * LDS, np.float32)
    for r in range(MAX_ROWS):
        qs[r * LDS:r * LDS + D] = q16[r]
    qf = [ldsm(qs, _at("a_x4", 0, LDS, 0, 16 * kd)) for kd in range(KD)]
    scale_l2 = np.float32(scale) * LOG2E
    m = np.full((2, 32), MASKED, np.float32)
    lsum = np.zeros((2, 32), np.float32)
    f = np.float32(1)
    o = np.zeros((ND, 32, 4), np.float32)
    for k0 in keys:
        # the ring stage: rows past the reach zero-filled, never read
        kt = np.zeros(WARP_KEYS * LDS, np.float32)
        vt = np.zeros(WARP_KEYS * LDS, np.float32)
        ks_ = np.zeros(WARP_KEYS, np.float32)
        vs_ = np.zeros(WARP_KEYS, np.float32)
        for r in range(WARP_KEYS):
            col = k0 + r
            if col > reach:
                continue
            blk = trow[col // bs]
            kt[r * LDS:r * LDS + D] = kp[blk, col % bs, h]
            vt[r * LDS:r * LDS + D] = vp[blk, col % bs, h]
            if code:
                ks_[r], vs_[r] = ksc[blk, h], vsc[blk, h]
        sc = np.zeros((NS, 32, 4), np.float32)
        for kd in range(KD):
            for n in range(0, NS, 2):
                kf = ldsm(kt, _at("b_x4", 0, LDS, 8 * n, 16 * kd))
                mma(sc[n], qf[kd], kf[:, 0], kf[:, 1])
                mma(sc[n + 1], qf[kd], kf[:, 2], kf[:, 3])
        edge = k0 + WARP_KEYS - 1 > t0 or k0 + WARP_KEYS - 1 > reach
        mx = m.copy()
        for n in range(NS):
            for e in range(4):
                c = 8 * n + 2 * T + e % 2
                x = sc[n][:, e] * scale_l2
                if code:
                    x = x * ks_[c]
                if edge:
                    pos, col = t0 + G + 8 * (e // 2), k0 + c
                    x = np.where((col > pos) | (col > reach), MASKED, x)
                sc[n][:, e] = x
                mx[e // 2] = np.maximum(mx[e // 2], x)
        fv = rescale = np.float32(1)
        if code:                # the slice's largest v scale
            fv = vs_.max() or f
            rescale, f = f / fv, fv
        # a row's max over its quad (lanes 4g .. 4g + 3)
        mx = np.repeat(mx.reshape(2, 8, 4).max(-1), 4, axis=-1)
        alpha = np.exp2(m - mx)
        m = mx
        lsum *= alpha
        for n in range(NS):
            for e in range(4):
                p = np.where(m[e // 2] == MASKED, np.float32(0),
                             np.exp2(sc[n][:, e] - m[e // 2]))
                lsum[e // 2] += p
                if code:
                    p = p * (vs_[8 * n + 2 * T + e % 2] / fv)
                sc[n][:, e] = p
        for e in range(4):
            o[:, :, e] *= alpha[e // 2] * rescale
        for kk in range(NS // 2):
            pa = (pack_a_f16 if code else pack_a)(sc[2 * kk], sc[2 * kk + 1])
            for n in range(0, ND, 2):
                vf = ldsm(vt, _at("bt_x4", 0, LDS, 16 * kk, 8 * n),
                          trans=True)
                mma(o[n], pa, vf[:, 0], vf[:, 1])
                mma(o[n + 1], pa, vf[:, 2], vf[:, 3])
    return m, lsum, o, f


def _warp_rows(m, lsum, o, f, D):
    """A warp's partial by row, as it writes it: m, the quad's l, and o
    times its f (16 rows)."""
    wm = m.reshape(2, 8, 4)[:, :, 0].reshape(16)
    wl = lsum.reshape(2, 8, 4).sum(-1).reshape(16)
    wo = np.zeros((16, D), np.float32)
    for n in range(D // 8):
        for e in range(4):
            wo[G + 8 * (e // 2), 8 * n + 2 * T + e % 2] = o[n][:, e] * f
    return wm, wl, wo


def _fold(ms, ls, os_):
    """Partials (m, l, o) of one row set into one: m = max, l and o
    weighted by 2^(m_p - m)."""
    ms, ls, os_ = np.stack(ms), np.stack(ls), np.stack(os_)
    mm = ms.max(0)
    a = np.exp2(ms - mm)
    return mm, (ls * a).sum(0), (os_ * a[:, :, None]).sum(0)


def emulate(q, kp, vp, ksc, vsc, table, tv, scale=None):
    """Every cluster of the grid: q (b, s, H, D) bf16 values in fp32;
    pools (nblk, bs, H, D) bf16 values, or int8 codes with (nblk, H)
    scales ``ksc``, ``vsc`` (None for bf16 pools). Returns O in bf16."""
    b, s, H, D = q.shape
    bs, bp = kp.shape[1], table.shape[1]
    scale = 1.0 / np.sqrt(D) if scale is None else scale
    out = np.full(q.shape, np.nan, np.float32)
    ntile = -(-s // MAX_ROWS)
    # rows past s: zeros
    qz = np.zeros((b, ntile * MAX_ROWS, H, D), np.float32)
    qz[:, :s] = q
    for slot, tile in np.ndindex(b, ntile):
        row0, nrows, t0, reach = row_tile(tile, s, int(tv[slot]), bs, bp)
        q16 = qz[slot, row0:row0 + MAX_ROWS]
        for h in range(H):
            cta = []
            for rank in range(SPLITS):
                parts = [_warp_rows(*_slice_partial(
                    q16[:, h], kp, vp, ksc, vsc, table[slot], h, t0,
                    reach, keys, scale, bs), D)
                    for keys in walk(reach, rank).values()]
                cta.append(_fold(*zip(*((pm[:nrows], pl[:nrows],
                                         po[:nrows])
                                        for pm, pl, po in parts))))
            # the cluster merge, chunk by chunk as the ranks take them
            for rank in range(SPLITS):
                for idx in merge_chunks(nrows, D, rank):
                    row, c = divmod(idx, D // 8)
                    mm, ls, acc = _fold(
                        *zip(*((pm[row:row + 1], pl[row:row + 1],
                                po[row:row + 1, 8 * c:8 * c + 8])
                               for pm, pl, po in cta)))
                    out[slot, row0 + row, h, 8 * c:8 * c + 8] = _bf16(
                        acc[0] * (np.float32(1) / ls[0]))
    return out


def _readable(table, tv, s, bs, nblk):
    """(nblk, bs) rows some query row may read."""
    readable = np.zeros((nblk, bs), bool)
    cols = np.arange(table.shape[1] * bs)
    for slot, t in enumerate(tv):
        ok = cols <= t + s - 1
        readable[table[slot][cols[ok] // bs], cols[ok] % bs] = True
    return readable


def _case(b, s, starts, D, bs, bp, int8, seed, H):
    """q, pools (and scales) and a shuffled table of distinct blocks, the
    scratch block 0 and 4 spare blocks named by no table row; ``starts``
    None is the decode step's shuffled linspace(0, 1000, b). Over
    hundreds of keys q is 3x a unit normal, so that the softmax still
    puts most of its weight on a few, and a key tile lost or read from
    the wrong block moves O by more than the limit; over a short
    context it is a unit normal, so that a zero-filled key left unmasked
    weighs as much as a real one."""
    rs = np.random.RandomState(seed)
    nblk = 1 + b * bp + 4
    table = (1 + rs.permutation(nblk - 1)[:b * bp]).reshape(b, bp).astype(
        np.int32)
    q = rs.randn(b, s, H, D)
    if int8:
        kp, vp = (rs.randint(-127, 128, (nblk, bs, H, D)).astype(np.float32)
                  for _ in range(2))
        ksc, vsc = ((0.02 + 0.01 * np.abs(rs.randn(nblk, H))).astype(
            np.float32) for _ in range(2))
    else:
        kp, vp = (_bf16(rs.randn(nblk, bs, H, D)) for _ in range(2))
        ksc = vsc = None
    if starts is None:
        tv = np.linspace(0, 1000, b).round().astype(np.int32)
        rs.shuffle(tv)
    else:
        tv = np.asarray(starts, np.int32)
    q = _bf16(q * (3 if tv.max() >= 256 else 1))
    return q, kp, vp, ksc, vsc, table, tv


def _plain(q, kp, vp, ksc, vsc, table, tv):
    """``paged_attention_ref`` in fp32 on the same values (int8 codes
    dequantized in fp32)."""
    t = torch.from_numpy
    kw = {}
    if ksc is not None:
        kp, vp = kp.astype(np.int8), vp.astype(np.int8)
        kw = dict(k_scale=t(ksc), v_scale=t(vsc))
    return k4.paged_attention_ref(t(q), t(kp), t(vp), t(table), t(tv),
                                  **kw).numpy()


def _poisoned(q, kp, vp, ksc, vsc, table, tv):
    """The pools with NaN wherever no query may read: rows, and for int8
    the scales of every block none of whose rows may be read."""
    readable = _readable(table, tv, q.shape[1], kp.shape[1], kp.shape[0])
    kp, vp = kp.copy(), vp.copy()
    kp[~readable] = vp[~readable] = np.nan
    if ksc is not None:
        dead = ~readable.any(1)
        ksc, vsc = ksc.copy(), vsc.copy()
        ksc[dead] = vsc[dead] = np.nan
    return q, kp, vp, ksc, vsc, table, tv


def _hold(got, ref):
    assert np.isfinite(got).all()
    worst = np.max(np.abs(got - ref) / (ATOL + RTOL * np.abs(ref)))
    assert worst <= 1.0, worst
    assert np.abs(ref).max() > 0.2      # the case has real outputs


# (b, s, starts, D, bs, bp, H): a lone request at t 1000 (16 tiles, 2 a
# rank); the decode step, 8 slots at shuffled offsets 0-1000 (None); a
# verify of 4 drafts (s 5) at those offsets; t 0 (ranks 1-7 walk no
# tile), at s 1 and s 5; a slot whose reach runs off a table of 5
# blocks (80 rows, no multiple of 64) beside one inside it, and 16 rows
# off a table of 3 blocks of 11 (33 rows: the last warp slice holds one
# key and 15 zero-filled ones that rows 1-15's positions admit); D 128;
# 16 rows over blocks of 5 rows, so slices and blocks never line up;
# verifies of 16 and 31 drafts (s 17, 32: two row tiles, the first's
# second of one row), the s-32 one running off a table of 3 blocks.
# Each over bf16 pools and int8 pools.
CASES = [
    (1, 1, [1000], 64, 16, 64, 2),
    (8, 1, None, 64, 16, 64, 1),
    (8, 5, None, 64, 16, 64, 1),
    (2, 1, [0, 0], 64, 16, 4, 2),
    (1, 5, [0], 64, 16, 4, 2),
    (2, 5, [78, 30], 64, 16, 5, 2),
    (1, 16, [32], 64, 11, 3, 2),
    (1, 5, [300], 128, 16, 64, 1),
    (2, 16, [7, 61], 64, 5, 24, 1),
    (2, 17, [0, 90], 64, 16, 8, 1),
    (1, 32, [20], 64, 16, 3, 1),
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b,s,starts,D,bs,bp,H", CASES)
def test_emulated_body_matches_the_plain_version(b, s, starts, D, bs, bp, H,
                                                 int8):
    args = _case(b, s, starts, D, bs, bp, int8, seed=7 * s + D + bs + b, H=H)
    _hold(emulate(*_poisoned(*args)), _plain(*args))


@pytest.mark.parametrize("int8", [False, True])
def test_emulated_body_matches_the_jax_kernels(int8):
    """The off-table case against the JAX package's gather reference and
    its Pallas kernel in interpret mode, on the same values (fp32); the
    port's plain version against both, to summation order."""
    q, kp, vp, ksc, vsc, table, tv = _case(2, 5, [78, 30], 64, 16, 5, int8,
                                           seed=11, H=2)
    got = emulate(*_poisoned(q, kp, vp, ksc, vsc, table, tv))
    plain = _plain(q, kp, vp, ksc, vsc, table, tv)
    jkw = (jnp.asarray(ksc), jnp.asarray(vsc)) if int8 else (None, None)
    codes = (kp.astype(np.int8), vp.astype(np.int8)) if int8 else (kp, vp)
    args = (jnp.asarray(q), jnp.asarray(codes[0]), jnp.asarray(codes[1]),
            *jkw, jnp.asarray(table), jnp.asarray(tv))
    for ref in (np.asarray(paged_attention_xla(*args)),
                np.asarray(paged_attention_pallas(*args, interpret=True))):
        _hold(got, ref)
        np.testing.assert_allclose(plain, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("reach", [0, 5, 63, 64, 65, 200, 511, 1000, 1023])
def test_every_key_is_walked_by_exactly_one_warp(reach):
    walked = np.zeros(reach + 1 + WARP_KEYS, int)
    for rank in range(SPLITS):
        for keys in walk(reach, rank).values():
            for k0 in keys:
                assert 0 <= k0 <= reach
                walked[k0:k0 + WARP_KEYS] += 1
    assert (walked[:reach + 1] == 1).all()


@pytest.mark.parametrize("reach", [0, 63, 1000])
def test_ranks_share_a_slot_s_tiles_evenly(reach):
    """Each rank takes floor or ceil of T / kSplits tiles (ranks with no
    tile where T < kSplits), whatever the slot's length."""
    n_tiles = reach // TILE + 1
    per_rank = [len({k0 // TILE for keys in walk(reach, r).values()
                     for k0 in keys}) for r in range(SPLITS)]
    assert sum(per_rank) == n_tiles
    assert set(per_rank) <= {n_tiles // SPLITS, -(-n_tiles // SPLITS)}


@pytest.mark.parametrize("s", [1, 5, 16])
@pytest.mark.parametrize("D", [64, 128])
def test_every_output_chunk_is_merged_by_one_rank(s, D):
    merged = np.zeros(s * D // 8, int)
    for rank in range(SPLITS):
        for idx in merge_chunks(s, D, rank):
            merged[idx] += 1
    assert (merged == 1).all()


@pytest.mark.parametrize("s", [17, 32, 80])
def test_row_tiles_cover_the_slot_s_rows_once(s):
    """The grid's row tiles take rows [row0, row0 + nrows) of the slot's
    s, 16 a tile and the last one ragged, each at its own position and
    reach (t + row0 + nrows - 1, cut at the table's end)."""
    assert "cfg.gridDim = dim3(kSplits, b * H, (s + kMaxRows - 1) / " \
        "kMaxRows);" in SRC
    covered = np.zeros(s, int)
    for tile in range(-(-s // MAX_ROWS)):
        row0, nrows, t0, reach = row_tile(tile, s, 1000, 16, 64)
        assert 1 <= nrows <= MAX_ROWS and t0 == 1000 + row0
        assert reach == min(1000 + row0 + nrows - 1, 1023)
        covered[row0:row0 + nrows] += 1
    assert (covered == 1).all()
