"""The bf16 flash backward's tensor-core dataflow, rehearsed on the CPU.

``csrc/flash_bwd.cu``'s two bf16 bodies, the dK/dV body
(``flash_bwd_mma_kernel``, K3a with dQ and K3b's first pass without)
and the dQ body (``flash_dq_mma_kernel``, K3b's second pass), run every
product as ``mma.sync.m16n8k16`` fed by ``ldmatrix``, with lane address
patterns from ``csrc/flash_mma.cuh``. No card is needed to check that
dataflow: this file emulates both instructions lane by lane in numpy,
following the fragment maps written in the header of ``flash_mma.cuh``
(the PTX ISA's), and runs

- each address pattern (``a_x4``, ``b_x4``, ``bt_x4``, ``at_x4``; their
  expressions are parsed from the header, so the test follows the
  source) against the operand fragment it is meant to load;
- every CTA of the dK/dV body, step by step as the kernel takes them
  (K/V and the ring stages in shared memory at the kernel's row
  strides, S^T and dP^T on the accumulators, P^T and dS^T packed into A
  fragments, the dS^T tile, the dQ pass and its atomics, the bf16
  stores), on ragged causal and non-causal cases, against the plain
  version ``flash_bwd_ref``;
- every CTA of the dQ body the same way (Q and dO staged once, K and V
  through the ring, S and dP on the accumulators, dS packed into the A
  fragment of dS K, the bf16 stores), in the grid order and with the
  key chunk that the kernel's source sets (both parsed from it).

The emulated kernel and the plain version differ in summation order and
in ``exp2`` against ``exp``; P and dS are rounded to bf16 on both sides,
where a last-bit difference can flip one rounding. The limit for every
output element, |emulated - plain| <= 2e-3 + 2**-7 |plain|, is one bf16
rounding of the output (2**-8 relative, both sides) plus those flips; a
fragment from the wrong lane, row or tile is off by the size of the
output itself.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as port_fa

CSRC = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"
MMA_CUH = CSRC / "flash_mma.cuh"

LANES = np.arange(32)
G, T = LANES // 4, LANES % 4      # the group and the lane in it
TILE_ROWS = 64                    # kTile: keys of a CTA, queries of a tile
WARPS = 4
LOG2E = np.float32(1.4426950408889634)
ATOL, RTOL = 2e-3, 2.0 ** -7


def _patterns():
    """name -> f(LDS, r0, c0, lane): element offset of each lane's row,
    parsed from the return expression of each pattern in the header."""
    src = MMA_CUH.read_text()
    found = re.findall(
        r"const bf16\* (\w+_x4)\(const bf16\* s, int (\w+), int (\w+),\s*"
        r"int lane\) \{\s*return s \+ (.*?);", src, re.S)
    out = {}
    for name, p0, p1, expr in found:
        # non-negative ints: C's / and % are Python's // and %
        body = " ".join(expr.split()).replace("/", "//")
        out[name] = eval(f"lambda LDS, {p0}, {p1}, lane: {body}")
    return out


PATTERNS = _patterns()


def _bf16(x):
    """fp32 -> bf16 (round to nearest even) -> fp32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def ldsm(smem, addr, trans=False):
    """ldmatrix.x4 (optionally .trans): lane l names row l % 8 of matrix
    l / 8 (8 contiguous b16 elements at ``addr[l]``); returns (32, 4, 2),
    register i of each lane as (lower, upper) half."""
    m = smem[addr[:, None] + np.arange(8)].reshape(4, 8, 8)
    if trans:    # rows 2t, 2t + 1 of column g
        lo, hi = m[:, 2 * T, G], m[:, 2 * T + 1, G]
    else:        # row g, elements 2t, 2t + 1
        lo, hi = m[:, G, 2 * T], m[:, G, 2 * T + 1]
    return np.stack([lo.T, hi.T], axis=-1)


def a_matrix(a):
    """The 16 x 16 A operand that fragment registers ``a`` hold."""
    A = np.full((16, 16), np.nan)
    for i, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        A[G + dr, 2 * T + dc] = a[:, i, 0]
        A[G + dr, 2 * T + dc + 1] = a[:, i, 1]
    return A


def b_matrix(b0, b1):
    """The 16 x 8 B operand that fragment registers (b0, b1) hold."""
    B = np.full((16, 8), np.nan)
    for b, dk in ((b0, 0), (b1, 8)):
        B[2 * T + dk, G] = b[:, 0]
        B[2 * T + dk + 1, G] = b[:, 1]
    return B


def mma(d, a, b0, b1):
    """d += A.B, m16n8k16, fp32 accumulators (32, 4) in the C layout."""
    C = (a_matrix(a) @ b_matrix(b0, b1)).astype(np.float32)
    d[:, 0] += C[G, 2 * T]
    d[:, 1] += C[G, 2 * T + 1]
    d[:, 2] += C[G + 8, 2 * T]
    d[:, 3] += C[G + 8, 2 * T + 1]


def pack_a(c, c8):
    """Two n8 accumulator tiles, rounded to bf16, as one k16 A fragment."""
    return _bf16(np.stack([c[:, 0:2], c[:, 2:4], c8[:, 0:2], c8[:, 2:4]],
                          axis=1))


def _at(name, base, ld, r0, c0):
    return base + PATTERNS[name](ld, r0, c0, LANES)


# ------------------------------------------------------------ the patterns
def test_header_declares_the_four_patterns():
    assert sorted(PATTERNS) == ["a_x4", "at_x4", "b_x4", "bt_x4"]


def test_mma_emulation_is_a_matrix_product():
    rs = np.random.RandomState(0)
    A = _bf16(rs.randn(16, 16))
    B = _bf16(rs.randn(16, 8))
    a = np.stack([np.stack([A[G + dr, 2 * T + dc], A[G + dr, 2 * T + dc + 1]],
                           -1) for dr, dc in ((0, 0), (8, 0), (0, 8), (8, 8))],
                 axis=1)
    b0 = np.stack([B[2 * T, G], B[2 * T + 1, G]], -1)
    b1 = np.stack([B[2 * T + 8, G], B[2 * T + 9, G]], -1)
    assert not np.isnan(a_matrix(a)).any() and not np.isnan(
        b_matrix(b0, b1)).any()
    d = np.zeros((32, 4), np.float32)
    mma(d, a, b0, b1)
    C = (A @ B).astype(np.float32)
    np.testing.assert_allclose(
        d, np.stack([C[G, 2 * T], C[G, 2 * T + 1], C[G + 8, 2 * T],
                     C[G + 8, 2 * T + 1]], -1), rtol=1e-6)


@pytest.mark.parametrize("name", ["a_x4", "b_x4", "bt_x4", "at_x4"])
def test_pattern_loads_its_operand(name):
    """A random bf16 tile at a padded row stride: each pattern, with
    ldmatrix as the kernel issues it, yields exactly the operand its
    comment names."""
    rs = np.random.RandomState(1)
    ld = 136                # D 128's padded row stride
    tile = _bf16(rs.randn(64, ld))
    flat = tile.reshape(-1)
    r0, c0 = 16, 32
    if name == "a_x4":    # A = tile[r0:+16, c0:+16]
        np.testing.assert_array_equal(
            a_matrix(ldsm(flat, _at(name, 0, ld, r0, c0))),
            tile[r0:r0 + 16, c0:c0 + 16])
    elif name == "at_x4":  # A[m][k] = tile[c0 + k][r0 + m], column-major
        np.testing.assert_array_equal(
            a_matrix(ldsm(flat, _at(name, 0, ld, r0, c0), trans=True)),
            tile[c0:c0 + 16, r0:r0 + 16].T)
    elif name == "b_x4":   # B[k][n] = tile[n0 + n][c0 + k], two n8 tiles
        r = ldsm(flat, _at(name, 0, ld, r0, c0))
        for i, n0 in enumerate((r0, r0 + 8)):
            np.testing.assert_array_equal(
                b_matrix(r[:, 2 * i], r[:, 2 * i + 1]),
                tile[n0:n0 + 8, c0:c0 + 16].T)
    else:                  # B[k][n] = tile[r0 + k][c0 + n], two n8 tiles
        r = ldsm(flat, _at(name, 0, ld, r0, c0), trans=True)
        for i, n0 in enumerate((c0, c0 + 8)):
            np.testing.assert_array_equal(
                b_matrix(r[:, 2 * i], r[:, 2 * i + 1]),
                tile[r0:r0 + 16, n0:n0 + 8])


# ------------------------------------------------------------ one body
def emulate_cta(q, k, v, do, lse, delta, scale, causal, k0, dq_acc, dk_out,
                dv_out):
    """One CTA of ``flash_bwd_mma_kernel`` for one (batch, head): keys
    [k0, k0 + 64); q, do (Sq, D), k, v (Sk, D) bf16 values in fp32; lse,
    delta (Sq,) fp32. Adds into ``dq_acc`` (None: the dK/dV pass alone)
    and writes its dK, dV rows in bf16."""
    Sq, D = q.shape
    Sk = k.shape[0]
    LDS, LDP = D + 8, TILE_ROWS + 8
    TILE = TILE_ROWS * LDS
    QC = 32 if D == 64 else 16     # queries per chunk of a tile
    DQC = 64                       # dQ columns per pass
    KD, ND, NC = D // 16, D // 8, QC // 8
    smem = np.zeros(6 * TILE, np.float32)
    dss = np.zeros(TILE_ROWS * LDP, np.float32)
    ks, vs, qs, dos = 0, TILE, 2 * TILE, 4 * TILE
    lse_s = np.zeros((2, TILE_ROWS), np.float32)
    delta_s = np.zeros((2, TILE_ROWS), np.float32)

    def stage(dst, src, r0, S):   # cp.async, zero-filled past S
        for r in range(TILE_ROWS):
            smem[dst + r * LDS:dst + r * LDS + D] = (
                src[r0 + r] if r0 + r < S else 0.0)

    def rows(dst, src, r0):
        n = max(0, min(TILE_ROWS, Sq - r0))
        dst[:] = 0.0
        dst[:n] = src[r0:r0 + n]

    stage(ks, k, k0, Sk)
    stage(vs, v, k0, Sk)
    q_first = k0 if causal else 0
    n_tiles = -(-(Sq - q_first) // TILE_ROWS) if q_first < Sq else 0
    scale_l2 = np.float32(scale) * LOG2E
    dk = np.zeros((WARPS, ND, 32, 4), np.float32)
    dv = np.zeros((WARPS, ND, 32, 4), np.float32)
    for j in range(n_tiles):
        q0, st = q_first + j * TILE_ROWS, j & 1
        qt, dt = qs + st * TILE, dos + st * TILE
        stage(qt, q, q0, Sq)
        stage(dt, do, q0, Sq)
        rows(lse_s[st], lse, q0)
        rows(delta_s[st], delta, q0)
        edge = ((causal and q0 < k0 + TILE_ROWS) or q0 + TILE_ROWS > Sq
                or k0 + TILE_ROWS > Sk)
        for w in range(WARPS):
            kw = k0 + 16 * w
            for c in range(0, TILE_ROWS, QC):
                s = np.zeros((NC, 32, 4), np.float32)
                dp = np.zeros((NC, 32, 4), np.float32)
                for kd in range(KD):
                    ka = ldsm(smem, _at("a_x4", ks, LDS, 16 * w, 16 * kd))
                    va = ldsm(smem, _at("a_x4", vs, LDS, 16 * w, 16 * kd))
                    for n in range(0, NC, 2):
                        bq = ldsm(smem, _at("b_x4", qt, LDS, c + 8 * n,
                                            16 * kd))
                        mma(s[n], ka, bq[:, 0], bq[:, 1])
                        mma(s[n + 1], ka, bq[:, 2], bq[:, 3])
                        bd = ldsm(smem, _at("b_x4", dt, LDS, c + 8 * n,
                                            16 * kd))
                        mma(dp[n], va, bd[:, 0], bd[:, 1])
                        mma(dp[n + 1], va, bd[:, 2], bd[:, 3])
                for n in range(NC):
                    col = c + 8 * n + 2 * T
                    for e in range(4):
                        lse_c = lse_s[st][col + e % 2]
                        delta_c = delta_s[st][col + e % 2]
                        p = np.exp2(s[n][:, e] * scale_l2 - lse_c * LOG2E)
                        if edge:
                            row, key = q0 + col + e % 2, kw + G + 8 * (e // 2)
                            hide = (row >= Sq) | (key >= Sk)
                            if causal:
                                hide |= row < key
                            p = np.where(hide, np.float32(0), p)
                        s[n][:, e] = p
                        dp[n][:, e] = p * (dp[n][:, e] - delta_c) * np.float32(
                            scale)
                for kk in range(NC // 2):
                    pa = pack_a(s[2 * kk], s[2 * kk + 1])
                    da = pack_a(dp[2 * kk], dp[2 * kk + 1])
                    for n in range(0, ND, 2):
                        bf = ldsm(smem, _at("bt_x4", dt, LDS, c + 16 * kk,
                                            8 * n), trans=True)
                        mma(dv[w][n], pa, bf[:, 0], bf[:, 1])
                        mma(dv[w][n + 1], pa, bf[:, 2], bf[:, 3])
                        bf = ldsm(smem, _at("bt_x4", qt, LDS, c + 16 * kk,
                                            8 * n), trans=True)
                        mma(dk[w][n], da, bf[:, 0], bf[:, 1])
                        mma(dk[w][n + 1], da, bf[:, 2], bf[:, 3])
                    base = (16 * w + G) * LDP + c + 16 * kk + 2 * T
                    for i, off in enumerate((0, 8 * LDP, 8, 8 * LDP + 8)):
                        dss[base + off] = da[:, i, 0]
                        dss[base + off + 1] = da[:, i, 1]
        if dq_acc is None:
            continue
        for w in range(WARPS):   # after the barrier: dQ = dS K
            for dc in range(0, D, DQC):
                dq = np.zeros((DQC // 8, 32, 4), np.float32)
                for kk in range(TILE_ROWS // 16):
                    sa = ldsm(dss, _at("at_x4", 0, LDP, 16 * w, 16 * kk),
                              trans=True)
                    for n in range(0, DQC // 8, 2):
                        bf = ldsm(smem, _at("bt_x4", ks, LDS, 16 * kk,
                                            dc + 8 * n), trans=True)
                        mma(dq[n], sa, bf[:, 0], bf[:, 1])
                        mma(dq[n + 1], sa, bf[:, 2], bf[:, 3])
                for i in range(2):
                    row = q0 + 16 * w + G + 8 * i
                    ok = row < Sq
                    for n in range(DQC // 8):
                        cols = dc + 8 * n + 2 * T
                        np.add.at(dq_acc, (row[ok], cols[ok]),
                                  dq[n][ok, 2 * i])
                        np.add.at(dq_acc, (row[ok], cols[ok] + 1),
                                  dq[n][ok, 2 * i + 1])
    for w in range(WARPS):
        for i in range(2):
            key = k0 + 16 * w + G + 8 * i
            ok = key < Sk
            for n in range(ND):
                cols = 8 * n + 2 * T
                for out, acc in ((dk_out, dk), (dv_out, dv)):
                    out[key[ok], cols[ok]] = _bf16(acc[w][n][ok, 2 * i])
                    out[key[ok], cols[ok] + 1] = _bf16(
                        acc[w][n][ok, 2 * i + 1])


def _inputs(Sq, Sk, D, seed):
    rs = np.random.RandomState(seed)
    q, do = (_bf16(rs.randn(Sq, D)) for _ in range(2))
    k, v = (_bf16(rs.randn(Sk, D)) for _ in range(2))
    return q, k, v, do


def _plain(q, k, v, do, scale, causal):
    """lse from the plain forward, delta = rowsum(dO * O), and the plain
    backward, on (1, S, 1, D) bf16 tensors as the wrapper sees them."""
    qt, kt, vt, dot = (torch.from_numpy(x)[None, :, None, :].to(torch.bfloat16)
                       for x in (q, k, v, do))
    o, lse = port_fa.flash_fwd_ref(qt, kt, vt, scale, causal)
    delta = (dot.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    grads = port_fa.flash_bwd_ref(qt, kt, vt, dot, lse, delta, scale, causal)
    return (lse[0, 0].numpy(), delta[0, 0].numpy(),
            [g[0, :, 0].float().numpy() for g in grads])


# (Sq, Sk, D, causal): ragged causal at D 64 (the training head dim), Sq
# != Sk under the top-left causal mask, and D 128 (16-query chunks, two
# dQ column passes, the fragments re-read from shared memory) non-causal
CASES = [(200, 200, 64, True), (130, 70, 64, True), (96, 160, 128, False)]


@pytest.mark.parametrize("with_dq", [True, False], ids=["fused", "dkv"])
@pytest.mark.parametrize("Sq,Sk,D,causal", CASES)
def test_emulated_body_matches_the_plain_backward(Sq, Sk, D, causal,
                                                  with_dq):
    q, k, v, do = _inputs(Sq, Sk, D, seed=Sq + Sk + D)
    scale = 1.0 / np.sqrt(D)
    lse, delta, (rdq, rdk, rdv) = _plain(q, k, v, do, scale, causal)
    dq_acc = np.zeros((Sq, D), np.float32) if with_dq else None
    dk = np.full((Sk, D), np.nan, np.float32)
    dv = np.full((Sk, D), np.nan, np.float32)
    for k0 in range(0, Sk, TILE_ROWS):
        emulate_cta(q, k, v, do, lse, delta, scale, causal, k0, dq_acc, dk,
                    dv)
    got = [("dK", dk, rdk), ("dV", dv, rdv)]
    if with_dq:    # the wrapper casts the fp32 buffer to q's dtype
        got.append(("dQ", _bf16(dq_acc), rdq))
    for name, out, ref in got:
        assert np.isfinite(out).all(), name
        worst = np.max(np.abs(out - ref) / (ATOL + RTOL * np.abs(ref)))
        assert worst <= 1.0, (name, worst)
        assert np.abs(ref).max() > 0.5, name   # the case has real gradients


# ------------------------------------------------------------ the dQ body
def _dq_body_source():
    src = (CSRC / "flash_bwd.cu").read_text()
    start = src.index("flash_dq_mma_kernel(const Args a) {")
    return src[start:src.index("\n}\n", start)]


def _dq_grid_order():
    """f(n_tiles, block, causal) -> the query tile that CTA ``block`` of
    the dQ body owns, parsed from the kernel's ``tile`` expression."""
    expr = re.search(r"const int tile = (.*?);", _dq_body_source()).group(1)
    m = re.fullmatch(r"a\.causal \? (.*) : (.*)", expr)
    branches = m.groups() if m else (expr, expr)
    py = [b.replace("gridDim.x", "nx").replace("blockIdx.x", "bx")
          for b in branches]
    return eval(f"lambda nx, bx, causal: ({py[0]}) if causal else ({py[1]})")


DQ_TILE = _dq_grid_order()
DQ_KC = int(re.search(r"constexpr int KC = (\d+);", _dq_body_source())
            .group(1))


def emulate_dq_cta(q, k, v, do, lse, delta, scale, causal, block, dq_out):
    """CTA ``block`` of ``flash_dq_mma_kernel`` for one (batch, head): q,
    do (Sq, D), k, v (Sk, D) bf16 values in fp32; lse, delta (Sq,) fp32.
    Writes its dQ rows in bf16."""
    Sq, D = q.shape
    Sk = k.shape[0]
    LDS = D + 8
    TILE = TILE_ROWS * LDS
    KD, ND, NC = D // 16, D // 8, DQ_KC // 8
    smem = np.zeros(6 * TILE, np.float32)
    qs, dos, ks, vs = 0, TILE, 2 * TILE, 4 * TILE

    def stage(dst, src, r0, S):   # cp.async, zero-filled past S
        for r in range(TILE_ROWS):
            smem[dst + r * LDS:dst + r * LDS + D] = (
                src[r0 + r] if r0 + r < S else 0.0)

    q0 = DQ_TILE(-(-Sq // TILE_ROWS), block, causal) * TILE_ROWS
    stage(qs, q, q0, Sq)
    stage(dos, do, q0, Sq)
    k_end = min(q0 + TILE_ROWS, Sk) if causal else Sk
    n_tiles = -(-k_end // TILE_ROWS)
    scale_l2 = np.float32(scale) * LOG2E
    # each lane's rows w0 + G and w0 + G + 8, clamped to Sq - 1
    rows = [[np.minimum(q0 + 16 * w + G + 8 * i, Sq - 1) for i in range(2)]
            for w in range(WARPS)]
    lse_l2 = [[lse[r] * LOG2E for r in rw] for rw in rows]
    delta_r = [[delta[r] for r in rw] for rw in rows]
    dq = np.zeros((WARPS, ND, 32, 4), np.float32)
    for j in range(n_tiles):
        k0, st = j * TILE_ROWS, j & 1
        kt, vt = ks + st * TILE, vs + st * TILE
        stage(kt, k, k0, Sk)
        stage(vt, v, k0, Sk)
        for w in range(WARPS):
            w0 = q0 + 16 * w
            edge = (causal and k0 + TILE_ROWS - 1 > w0) or k0 + TILE_ROWS > Sk
            for c in range(0, TILE_ROWS, DQ_KC):
                s = np.zeros((NC, 32, 4), np.float32)
                dp = np.zeros((NC, 32, 4), np.float32)
                for kd in range(KD):
                    qa = ldsm(smem, _at("a_x4", qs, LDS, 16 * w, 16 * kd))
                    da = ldsm(smem, _at("a_x4", dos, LDS, 16 * w, 16 * kd))
                    for n in range(0, NC, 2):
                        bk = ldsm(smem, _at("b_x4", kt, LDS, c + 8 * n,
                                            16 * kd))
                        mma(s[n], qa, bk[:, 0], bk[:, 1])
                        mma(s[n + 1], qa, bk[:, 2], bk[:, 3])
                        bv = ldsm(smem, _at("b_x4", vt, LDS, c + 8 * n,
                                            16 * kd))
                        mma(dp[n], da, bv[:, 0], bv[:, 1])
                        mma(dp[n + 1], da, bv[:, 2], bv[:, 3])
                for n in range(NC):
                    for e in range(4):
                        p = np.exp2(s[n][:, e] * scale_l2
                                    - lse_l2[w][e // 2])
                        if edge:
                            row = w0 + G + 8 * (e // 2)
                            key = k0 + c + 8 * n + 2 * T + e % 2
                            hide = key >= Sk
                            if causal:
                                hide |= row < key
                            p = np.where(hide, np.float32(0), p)
                        dp[n][:, e] = p * (dp[n][:, e] - delta_r[w][e // 2]
                                           ) * np.float32(scale)
                for kk in range(NC // 2):
                    sa = pack_a(dp[2 * kk], dp[2 * kk + 1])
                    for n in range(0, ND, 2):
                        bf = ldsm(smem, _at("bt_x4", kt, LDS, c + 16 * kk,
                                            8 * n), trans=True)
                        mma(dq[w][n], sa, bf[:, 0], bf[:, 1])
                        mma(dq[w][n + 1], sa, bf[:, 2], bf[:, 3])
    for w in range(WARPS):
        for i in range(2):
            row = q0 + 16 * w + G + 8 * i
            ok = row < Sq
            for n in range(ND):
                cols = 8 * n + 2 * T
                dq_out[row[ok], cols[ok]] = _bf16(dq[w][n][ok, 2 * i])
                dq_out[row[ok], cols[ok] + 1] = _bf16(dq[w][n][ok, 2 * i + 1])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_tiles", [1, 5, 130])
def test_dq_grid_owns_every_query_tile_once(n_tiles, causal):
    order = [DQ_TILE(n_tiles, bx, causal) for bx in range(n_tiles)]
    assert sorted(order) == list(range(n_tiles))


# the dK/dV body's cases, and D 128 causal with Sq not a multiple of 64:
# under the causal grid order the last, partial query tile launches first
DQ_CASES = CASES + [(330, 330, 128, True)]


@pytest.mark.parametrize("Sq,Sk,D,causal", DQ_CASES)
def test_emulated_dq_body_matches_the_plain_backward(Sq, Sk, D, causal):
    q, k, v, do = _inputs(Sq, Sk, D, seed=Sq + Sk + D + 1)
    scale = 1.0 / np.sqrt(D)
    lse, delta, (rdq, _, _) = _plain(q, k, v, do, scale, causal)
    dq = np.full((Sq, D), np.nan, np.float32)
    for block in range(-(-Sq // TILE_ROWS)):
        emulate_dq_cta(q, k, v, do, lse, delta, scale, causal, block, dq)
    assert np.isfinite(dq).all()
    worst = np.max(np.abs(dq - rdq) / (ATOL + RTOL * np.abs(rdq)))
    assert worst <= 1.0, worst
    assert np.abs(rdq).max() > 0.5   # the case has real gradients
