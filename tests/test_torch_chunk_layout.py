"""K5's bf16 tensor-core body, rehearsed on the CPU.

``csrc/chunk_prefill.cu``'s ``chunk_prefill_mma_kernel`` runs a prompt
chunk's attention over the paged pool as ``mma.sync.m16n8k16`` products
fed by ``ldmatrix``, with the lane address patterns of
``csrc/flash_mma.cuh``. No card is needed to check that dataflow: this
file emulates every CTA lane by lane in numpy, with the instruction
emulations of ``tests/test_torch_flash_bwd_layout.py`` (which hold the
patterns, parsed from the header, to the PTX fragment maps), as the
kernel takes its steps:

- the CTA's (slot, 64-row tile) from ``blockIdx.x`` in the grid order
  the source sets (parsed from it), and the tile's rows, base position
  and reach;
- each key tile gathered row by row through a shuffled table into the
  ring stage, rows past the reach zero-filled and never addressed
  (every row no query may read, and every block no table names, holds
  NaN, codes and scales alike);
- int8 codes turned into bf16 (K) and fp16 (V) exactly, the k scale on
  S's columns, the v scale on P before its fp16 rounding, relative to
  the tile's largest v scale, which o carries from tile to tile;
- S on the accumulators, the mask at the diagonal, at the reach and for
  rows past s, the online softmax in log2 units on the fragments, P
  packed into the A fragment of P.V, and the bf16 stores.

Each case is held to the plain version ``chunk_prefill_ref`` evaluated
in fp32 on the same values, element by element: |emulated - plain| <=
4e-3 + 1e-2 |plain|. The two differ by P rounded to bf16 (2**-9 of each
p at most; fp16 over int8 pools, 2**-12), by the output's bf16 rounding
(2**-9 relative) and by
summation order and exp2 against exp; a key tile dropped, a row from the
wrong block or a scale of the wrong block is off by the size of the
output itself. A last test holds every shape's rows to exactly one CTA.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.chunk_prefill import chunk_prefill_xla
from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
from test_torch_flash_bwd_layout import G, T, _at, _bf16, ldsm, mma, pack_a

SRC = (Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"
       / "chunk_prefill.cu").read_text()
LOG2E = np.float32(1.4426950408889634)
MASKED = np.float32(-1e30)
ATOL, RTOL = 4e-3, 1e-2


def pack_a_f16(c, c8):
    """``pack_a_f16``: two n8 accumulator tiles rounded to fp16."""
    return np.stack([c[:, 0:2], c[:, 2:4], c8[:, 0:2], c8[:, 2:4]],
                    axis=1).astype(np.float16).astype(np.float32)


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


ROWS, KEYS, STAGES = _const("kRows"), _const("kKeys"), _const("kStages")
WARPS = ROWS // 16


def _tile_order():
    """f(ntile, bx) -> the 64-row tile CTA ``bx`` owns, parsed from the
    body's ``tile`` expression."""
    expr = re.search(r"const int tile = (.*?);", SRC).group(1)
    body = expr.replace("blockIdx.x", "bx").replace("/", "//")
    return eval(f"lambda ntile, bx: {body}")


TILE_OF = _tile_order()


def _cta_rows(s, b, bx):
    """(slot, first row, rows) of CTA ``bx`` for b slots of s rows."""
    ntile = -(-s // ROWS)
    tile = TILE_OF(ntile, bx)
    return bx // ntile, tile * ROWS, min(ROWS, s - tile * ROWS)


def emulate_cta(q, kp, vp, ksc, vsc, table, tv, bx, h, scale, out):
    """CTA (bx, h) of ``chunk_prefill_mma_kernel``: q (b, s, H, D) bf16
    values in fp32; pools (nblk, bs, H, D) bf16 values, or int8 codes
    with (nblk, H) scales ``ksc``, ``vsc`` (None for bf16 pools). Writes
    its rows of ``out`` in bf16."""
    b, s, H, D = q.shape
    bs, bp = kp.shape[1], table.shape[1]
    code = ksc is not None
    LDS = D + 8
    KD, ND, NS = D // 16, D // 8, KEYS // 8
    slot, r0, rows = _cta_rows(s, b, bx)
    base = int(tv[slot]) + r0
    reach = min(base + rows - 1, bp * bs - 1)
    n_tiles = reach // KEYS + 1
    qs = np.zeros(ROWS * LDS, np.float32)
    for r in range(ROWS):       # rows past s: zero-filled
        if r0 + r < s:
            qs[r * LDS:r * LDS + D] = q[slot, r0 + r, h]
    ring = np.zeros((2, STAGES, KEYS, D), np.float32)     # K, V
    scales = np.zeros((2, STAGES, KEYS), np.float32)

    def stage_tile(j, st):      # cp.async through the table
        for r in range(KEYS):
            col = j * KEYS + r
            if col > reach:     # src-size 0: zero-filled, nothing read
                ring[:, st, r] = 0.0
                scales[:, st, r] = 0.0
                continue
            blk = table[slot, col // bs]
            ring[0, st, r] = kp[blk, col % bs, h]
            ring[1, st, r] = vp[blk, col % bs, h]
            if code:
                scales[0, st, r] = ksc[blk, h]
                scales[1, st, r] = vsc[blk, h]

    qf = [[ldsm(qs, _at("a_x4", 0, LDS, 16 * w, 16 * kd))
           for kd in range(KD)] for w in range(WARPS)]
    scale_l2 = np.float32(scale) * LOG2E
    m = np.full((WARPS, 2, 32), MASKED, np.float32)
    lsum = np.zeros((WARPS, 2, 32), np.float32)
    f = np.ones(WARPS, np.float32)      # o's v-scale factor (int8 pools)
    o = np.zeros((WARPS, ND, 32, 4), np.float32)
    for j in range(n_tiles):
        j0, st = j * KEYS, j % STAGES
        stage_tile(j, st)
        # the stage, or its codes turned into bf16 and fp16 (exact), as a
        # tile of row stride LDS
        kt = np.zeros(KEYS * LDS, np.float32)
        vt = np.zeros(KEYS * LDS, np.float32)
        for r in range(KEYS):
            kt[r * LDS:r * LDS + D] = _bf16(ring[0, st, r])
            vt[r * LDS:r * LDS + D] = _bf16(ring[1, st, r])
        for w in range(WARPS):
            wbase = base + 16 * w
            if 16 * w >= rows or j0 > wbase + 15:
                continue
            sc = np.zeros((NS, 32, 4), np.float32)
            for kd in range(KD):
                for n in range(0, NS, 2):
                    kf = ldsm(kt, _at("b_x4", 0, LDS, 8 * n, 16 * kd))
                    mma(sc[n], qf[w][kd], kf[:, 0], kf[:, 1])
                    mma(sc[n + 1], qf[w][kd], kf[:, 2], kf[:, 3])
            edge = j0 + KEYS - 1 > wbase or j0 + KEYS - 1 > reach
            mx = m[w].copy()
            for n in range(NS):
                for e in range(4):
                    c = 8 * n + 2 * T + e % 2
                    x = sc[n][:, e] * scale_l2
                    if code:
                        x = x * scales[0, st, c]
                    if edge:
                        pos, col = wbase + G + 8 * (e // 2), j0 + c
                        x = np.where((col > pos) | (col > reach), MASKED, x)
                    sc[n][:, e] = x
                    mx[e // 2] = np.maximum(mx[e // 2], x)
            fv = rescale = np.float32(1)
            if code:            # the tile's largest v scale
                fv = scales[1, st].max() or f[w]
                rescale, f[w] = f[w] / fv, fv
            # a row's max over its quad (lanes 4g .. 4g + 3)
            mx = np.repeat(mx.reshape(2, 8, 4).max(-1), 4, axis=-1)
            alpha = np.exp2(m[w] - mx)
            m[w] = mx
            lsum[w] *= alpha
            for n in range(NS):
                for e in range(4):
                    p = np.exp2(sc[n][:, e] - m[w][e // 2])
                    lsum[w][e // 2] += p
                    if code:
                        p = p * (scales[1, st, 8 * n + 2 * T + e % 2] / fv)
                    sc[n][:, e] = p
            for e in range(4):
                o[w][:, :, e] *= alpha[e // 2] * rescale
            for kk in range(NS // 2):
                pa = (pack_a_f16 if code else pack_a)(sc[2 * kk],
                                                      sc[2 * kk + 1])
                for n in range(0, ND, 2):
                    vf = ldsm(vt, _at("bt_x4", 0, LDS, 16 * kk, 8 * n),
                              trans=True)
                    mma(o[w][n], pa, vf[:, 0], vf[:, 1])
                    mma(o[w][n + 1], pa, vf[:, 2], vf[:, 3])
    for w in range(WARPS):
        if 16 * w >= rows:
            continue
        lq = np.repeat(lsum[w].reshape(2, 8, 4).sum(-1), 4, axis=-1) / f[w]
        for i in range(2):
            row = r0 + 16 * w + G + 8 * i
            ok = row < s
            for n in range(ND):
                for x in range(2):
                    out[slot, row[ok], h, 8 * n + 2 * T[ok] + x] = _bf16(
                        o[w][n][ok, 2 * i + x] / lq[i][ok])


def _readable(table, tv, s, bs, nblk):
    """(nblk, bs) rows some query of the chunk may read, and the blocks
    a table names."""
    readable = np.zeros((nblk, bs), bool)
    named = np.zeros(nblk, bool)
    cols = np.arange(table.shape[1] * bs)
    for slot, t in enumerate(tv):
        named[table[slot]] = True
        ok = cols <= t + s - 1
        readable[table[slot][cols[ok] // bs], cols[ok] % bs] = True
    return readable, named


def _case(b, s, starts, D, bs, bp, int8, seed, H=2):
    """q, pools (and scales) and a shuffled table of distinct blocks,
    the scratch block 0 and 4 spare blocks named by no table row."""
    rs = np.random.RandomState(seed)
    nblk = 1 + b * bp + 4
    table = (1 + rs.permutation(nblk - 1)[:b * bp]).reshape(b, bp).astype(
        np.int32)
    q = _bf16(rs.randn(b, s, H, D))
    if int8:
        kp, vp = (rs.randint(-127, 128, (nblk, bs, H, D)).astype(np.float32)
                  for _ in range(2))
        ksc, vsc = ((0.02 + 0.01 * np.abs(rs.randn(nblk, H))).astype(
            np.float32) for _ in range(2))
    else:
        kp, vp = (_bf16(rs.randn(nblk, bs, H, D)) for _ in range(2))
        ksc = vsc = None
    return q, kp, vp, ksc, vsc, table, np.asarray(starts, np.int32)


def _plain(q, kp, vp, ksc, vsc, table, tv):
    """``chunk_prefill_ref`` in fp32 on the same values (int8 codes
    dequantized in fp32)."""
    t = torch.from_numpy
    kw = {}
    if ksc is not None:
        kp, vp = kp.astype(np.int8), vp.astype(np.int8)
        kw = dict(k_scale=t(ksc), v_scale=t(vsc))
    return k5.chunk_prefill_ref(t(q), t(kp), t(vp), t(table), t(tv),
                                **kw).numpy()


def _emulate(q, kp, vp, ksc, vsc, table, tv):
    """Every CTA of the grid on pools poisoned with NaN wherever no query
    may read (rows and, for int8, the scales of blocks no table names)."""
    b, s, H, D = q.shape
    readable, named = _readable(table, tv, s, kp.shape[1], kp.shape[0])
    kp, vp = kp.copy(), vp.copy()
    kp[~readable] = vp[~readable] = np.nan
    if ksc is not None:
        ksc, vsc = ksc.copy(), vsc.copy()
        ksc[~named] = vsc[~named] = np.nan
    out = np.full(q.shape, np.nan, np.float32)
    for bx in range(b * -(-s // ROWS)):
        for h in range(H):
            emulate_cta(q, kp, vp, ksc, vsc, table, tv, bx, h,
                        1.0 / np.sqrt(D), out)
    return out


# (b, s, starts, D, bs, bp, int8): the serving shape's chunk over a
# prefix (s 128 at 517, both pools); s 100, two 64-row tiles, the second
# 36 rows; s 64 at start 1000, whose pad tail runs past the table's 1024
# rows; s 40 at start 100 off a table of 112 rows, whose second key tile
# holds zero-filled rows past the reach that the pad rows' positions
# admit; D 128; two slots at their own starts; blocks of 5 rows, so
# tiles and blocks never line up
CASES = [
    (1, 128, [517], 64, 16, 64, False),
    (1, 128, [517], 64, 16, 64, True),
    (1, 100, [300], 64, 16, 64, False),
    (1, 100, [300], 64, 16, 64, True),
    (1, 64, [1000], 64, 16, 64, False),
    (1, 64, [1000], 64, 16, 64, True),
    (1, 40, [100], 64, 16, 7, False),
    (1, 40, [100], 64, 16, 7, True),
    (1, 70, [5], 128, 16, 8, False),
    (1, 70, [5], 128, 16, 8, True),
    (2, 40, [90, 3], 64, 16, 12, True),
    (2, 33, [7, 61], 64, 5, 24, False),
]


@pytest.mark.parametrize("b,s,starts,D,bs,bp,int8", CASES)
def test_emulated_body_matches_the_plain_version(b, s, starts, D, bs, bp,
                                                 int8):
    args = _case(b, s, starts, D, bs, bp, int8, seed=s + D + bs + starts[0])
    got = _emulate(*args)
    ref = _plain(*args)
    assert np.isfinite(got).all()
    worst = np.max(np.abs(got - ref) / (ATOL + RTOL * np.abs(ref)))
    assert worst <= 1.0, worst
    assert np.abs(ref).max() > 0.2      # the case has real outputs


@pytest.mark.parametrize("int8", [False, True])
def test_plain_version_is_the_reference_s_at_the_emulated_inputs(int8):
    """The emulation's yardstick against JAX's ``chunk_prefill_xla`` on
    the same values (fp32): summation order only."""
    q, kp, vp, ksc, vsc, table, tv = _case(1, 100, [300], 64, 16, 64, int8,
                                           seed=7)
    ref = _plain(q, kp, vp, ksc, vsc, table, tv)
    if int8:
        kp, vp = kp.astype(np.int8), vp.astype(np.int8)
        ksc, vsc = jnp.asarray(ksc), jnp.asarray(vsc)
    jax_out = chunk_prefill_xla(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), ksc, vsc, jnp.asarray(table),
                                int(tv[0]))
    np.testing.assert_allclose(ref, np.asarray(jax_out), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("s", [1, 5, 63, 64, 65, 100, 128, 129, 1000])
@pytest.mark.parametrize("b", [1, 3])
def test_every_query_row_has_exactly_one_cta(s, b):
    owned = np.zeros((b, s), int)
    for bx in range(b * -(-s // ROWS)):
        slot, r0, rows = _cta_rows(s, b, bx)
        assert 1 <= rows <= ROWS
        owned[slot, r0:r0 + rows] += 1
    assert (owned == 1).all()


@pytest.mark.parametrize("s,ctas", [(100, 2), (128, 2), (64, 1), (1, 1)])
def test_tiling_ignores_the_q_block_pick(s, ctas):
    """The bf16 body cuts any chunk into 64-row tiles: s 100 is two CTAs
    a head where the fp32 body's q-blocks of ``pick_qbs`` are 25."""
    assert -(-s // ROWS) == ctas
    assert ROWS == 64 and KEYS == 64
