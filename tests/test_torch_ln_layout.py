"""K2's two LayerNorm kernels, rehearsed on the CPU.

``csrc/layer_norm.cu`` runs LayerNorm over (R, C) rows in one of two
kernels, chosen by its C entry: ``ln_warp_kernel<T, VPL>`` (one warp a
row, kWarps warps a CTA, a grid of at most the CTAs the card holds,
warps striding over rows; a lane holds its 16-byte vectors lane, lane +
32, ... of the row in registers) when C is a whole number of 16-byte
vectors, at most 32 * kMaxVecs of them, and every pointer is 16-byte
aligned; else ``ln_row_kernel<T, kStaged>`` (one CTA of kRowThreads a
row, the row staged in shared memory, or read again from global memory
on each pass where it is too wide for that: the same arithmetic in the
same order). No card is needed to check that mapping
and its arithmetic: this file emulates both lane by lane in numpy fp32,
in the kernels' order of summation (a lane's elements in order, then the
warp's shuffle butterfly; the row kernel's CTA sum through its warps),
with the constants, the instantiations and the choice parsed from the
source, and checks that

- every element of every row is loaded and stored by exactly one lane
  (the vector tail: lanes past the row's last vector hold nothing), and
  every row's mean and rstd once, rows past R by none (the last CTA's
  warps run off R);
- both kernels, with and without w and b, agree with the plain version
  ``layer_norm_ref``: fp32 within 2e-5 (chip_smoke.py's ATOL) and mean
  and rstd within 2e-5 + 2**-22 |plain|; bf16 y within one bf16 rounding
  (1e-6 + 2**-7 |plain|), since the two sides round the same fp32 value
  at most one ulp apart;
- at a large mean (x = 1e3 + 2 randn) the kernel's two-step mean keeps y
  within 2e-6 of the plain version's formula evaluated in fp64, where
  the rejected E[x^2] - mean^2 in fp32 loses over 0.1% of the variance
  and the plain version in fp32 (its mean rounded once more) is off by
  more than 2e-6.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import layer_norm as k2

SRC = (Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"
       / "layer_norm.cu").read_text()
F32 = np.float32


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


WARPS, MAX_VECS, ROW_THREADS = (_const("kWarps"), _const("kMaxVecs"),
                                _const("kRowThreads"))
# elements of a 16-byte vector, by Pack<T>'s specialisations in order
_N = [int(n) for n in re.findall(r"static constexpr int N = (\d+);", SRC)]
VEC = {torch.float32: _N[0], torch.bfloat16: _N[1]}
# ceil(nv / 32) -> the instantiation by_vectors launches
_STEPS = [(int(a), int(b)) for a, b in re.findall(
    r"if \(need <= (\d+)\)\s*return launch_warp<T, (\d+)>", SRC)]
assert _STEPS and all(a == b for a, b in _STEPS)
assert "if (vec && need <= kMaxVecs)" in SRC
assert "const bool vec = C % N == 0 && aligned16(x) && aligned16(y) &&" in SRC


def vpl_for(need):
    """The VPL of the warp kernel that by_vectors picks for ``need``."""
    for bound, vpl in _STEPS:
        if need <= bound:
            return vpl
    return MAX_VECS


def choose(x, w, b, C):
    """("warp", VPL) or ("row", vec) as the C entry chooses, from C, the
    dtype and the pointers' alignment."""
    n = VEC[x.dtype]
    al = [t.data_ptr() % 16 == 0 for t in (x, w, b) if t is not None]
    vec = C % n == 0 and all(al)   # y is a fresh allocation: aligned
    need = (C // n + 31) // 32
    if vec and need <= MAX_VECS:
        return "warp", vpl_for(need)
    return "row", vec


def warp_sum(v):
    """ptt::warp_sum over the last axis (32 lanes), butterfly order."""
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., np.arange(32) ^ o]).astype(F32)
    return v


def _rsqrt(x):
    return (1.0 / np.sqrt(x.astype(np.float64))).astype(F32)


def emulate_warp(xf, wf, bf, R, C, n, vpl, eps, full):
    """ln_warp_kernel<T, VPL> on fp32 values of x (R, C), w, b (or None):
    y (fp32, before its rounding to T), mean, rstd and the count of
    stores each element, mean and rstd received."""
    nv = C // n
    grid = min((R + WARPS - 1) // WARPS, full)
    writes = np.zeros((R, C), int)
    stats = np.zeros(R, int)
    y = np.zeros((R, C), F32)
    mean = np.zeros(R, F32)
    rstd = np.zeros(R, F32)
    lanes = np.arange(32)
    vidx = lanes[:, None] + 32 * np.arange(vpl)[None, :]     # (32, VPL)
    live = vidx < nv
    cols = vidx[..., None] * n + np.arange(n)                 # (32, VPL, n)
    cols_c = np.where(live[..., None], cols, 0)
    rows = [r for cta in range(grid) for w in range(WARPS)
            for r in range(cta * WARPS + w, R, grid * WARPS)]
    assert sorted(rows) == list(range(R))    # each row by one warp
    for row in rows:
        f = xf[row][cols_c]                                   # (32, VPL, n)
        s = np.zeros(32, F32)
        for v in range(vpl):
            for e in range(n):
                s = np.where(live[:, v], s + f[:, v, e], s).astype(F32)
        m1 = F32(warp_sum(s)[0] / F32(C))
        s1 = np.zeros(32, F32)
        for v in range(vpl):
            for e in range(n):
                s1 = np.where(live[:, v], s1 + (f[:, v, e] - m1), s1)
                s1 = s1.astype(F32)
        c = F32(warp_sum(s1)[0] / F32(C))
        s2 = np.zeros(32, F32)
        d = ((f - m1).astype(F32) - c).astype(F32)
        for v in range(vpl):
            for e in range(n):
                s2 = np.where(live[:, v], s2 + d[:, v, e] * d[:, v, e], s2)
                s2 = s2.astype(F32)
        rs = _rsqrt(np.asarray(F32(warp_sum(s2)[0] / F32(C)) + F32(eps)))
        o = (d * rs).astype(F32)
        if wf is not None:
            o = (o * wf[cols_c]).astype(F32)
        if bf is not None:
            o = (o + bf[cols_c]).astype(F32)
        y[row, cols[live]] = o[live]
        np.add.at(writes[row], cols[live], 1)
        mean[row], rstd[row] = F32(m1 + c), rs
        stats[row] += 1
    return y, mean, rstd, writes, stats


def _block_sum(parts):
    """block_sum of per-thread values (kRowThreads,): warp sums, lane 0's
    into red[warp], then lanes < kRowThreads / 32 of a warp sum red."""
    warps = warp_sum(parts.reshape(-1, 32).astype(F32))[:, 0]
    red = np.zeros(32, F32)
    red[:len(warps)] = warps
    return F32(warp_sum(red)[0])


def emulate_row(xf, wf, bf, R, C, eps):
    """ln_row_kernel<T>: one CTA a row, thread t over columns t, t +
    kRowThreads, ... of the row."""
    y = np.zeros((R, C), F32)
    mean = np.zeros(R, F32)
    rstd = np.zeros(R, F32)
    writes = np.zeros((R, C), int)
    steps = (C + ROW_THREADS - 1) // ROW_THREADS
    idx = np.arange(ROW_THREADS)[:, None] + ROW_THREADS * np.arange(steps)
    live = idx < C
    idx_c = np.where(live, idx, 0)
    for row in range(R):
        f = xf[row][idx_c]
        s = np.zeros(ROW_THREADS, F32)
        for k in range(steps):
            s = np.where(live[:, k], s + f[:, k], s).astype(F32)
        m1 = F32(_block_sum(s) / F32(C))
        s1 = np.zeros(ROW_THREADS, F32)
        for k in range(steps):
            s1 = np.where(live[:, k], s1 + (f[:, k] - m1), s1).astype(F32)
        cc = F32(_block_sum(s1) / F32(C))
        d = ((f - m1).astype(F32) - cc).astype(F32)
        s2 = np.zeros(ROW_THREADS, F32)
        for k in range(steps):
            s2 = np.where(live[:, k], s2 + d[:, k] * d[:, k], s2).astype(F32)
        rs = _rsqrt(np.asarray(F32(_block_sum(s2) / F32(C)) + F32(eps)))
        o = (d * rs).astype(F32)
        if wf is not None:
            o = (o * wf[idx_c]).astype(F32)
        if bf is not None:
            o = (o + bf[idx_c]).astype(F32)
        y[row, idx[live]] = o[live]
        np.add.at(writes[row], idx[live], 1)
        mean[row], rstd[row] = F32(m1 + cc), rs
    return y, mean, rstd, writes, np.ones(R, int)


def run(x, w, b, eps=1e-5, full=5):
    """The kernel the C entry picks, emulated: (y in x's dtype, mean,
    rstd, which kernel)."""
    R, C = x.shape
    kind, arg = choose(x, w, b, C)
    xf, wf, bf = (None if t is None else t.float().numpy()
                  for t in (x, w, b))
    if kind == "warp":
        y, mean, rstd, writes, stats = emulate_warp(
            xf, wf, bf, R, C, VEC[x.dtype], arg, eps, full)
    else:
        y, mean, rstd, writes, stats = emulate_row(xf, wf, bf, R, C, eps)
    assert (writes == 1).all() and (stats == 1).all()
    return (torch.from_numpy(y).to(x.dtype), torch.from_numpy(mean)[:, None],
            torch.from_numpy(rstd)[:, None], (kind, arg))


def _inputs(R, C, dtype, seed, offset=0, loc=0.5, spread=2.0):
    rs = np.random.RandomState(seed)
    buf = torch.from_numpy((rs.randn(R * C + offset) * spread + loc)
                           .astype(np.float32)).to(dtype)
    x = buf[offset:].view(R, C)
    w = torch.from_numpy((1 + 0.1 * rs.randn(C)).astype(np.float32)).to(dtype)
    b = torch.from_numpy((0.1 * rs.randn(C)).astype(np.float32)).to(dtype)
    return x, w, b


def _check(x, w, b, got):
    y, mean, rstd, _ = got
    ry, rmean, rrstd = k2.layer_norm_ref(x, w, b, 1e-5)
    if x.dtype == torch.float32:
        assert float((y - ry).abs().max()) <= 2e-5
    else:
        lim = 1e-6 + 2.0 ** -7 * ry.float().abs()
        assert bool(((y.float() - ry.float()).abs() <= lim).all())
    for a, r in ((mean, rmean), (rstd, rrstd)):
        assert bool(((a - r).abs() <= 2e-5 + 2.0 ** -22 * r.abs()).all())


# (R, C, dtype, offset, the kernel the entry must pick): gpt2_small's
# width in fp32 (6 vectors a lane) and bf16 (3), a vector tail (130
# vectors: lanes 0-1 hold 5, the rest 4), gpt_tiny's width (16 vectors:
# lanes 16-31 hold none), an odd C, an offset view, two rows past the warp
# kernel's cap of kMaxVecs vectors a lane (fp32 C 2056 and 1536), and
# bf16 at the cap; R never a multiple of kWarps, so the last CTA's warps
# run off R
CASES = [(37, 768, torch.float32, 0, ("warp", 6)),
         (19, 768, torch.bfloat16, 0, ("warp", 3)),
         (11, 520, torch.float32, 0, ("warp", 6)),
         (9, 64, torch.float32, 0, ("warp", 1)),
         (5, 771, torch.float32, 0, ("row", False)),
         (5, 768, torch.float32, 1, ("row", False)),
         (3, 2056, torch.float32, 0, ("row", True)),
         (6, 776, torch.bfloat16, 0, ("warp", 4)),
         (4, 1536, torch.float32, 0, ("row", True)),
         (3, 32 * MAX_VECS * 8, torch.bfloat16, 0, ("warp", MAX_VECS))]


@pytest.mark.parametrize("affine", ["both", "weight", "bias", "none"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[:2]}-{c[2]}-"
                         f"off{c[3]}")
def test_emulated_kernels_match_plain(case, affine):
    R, C, dtype, offset, kind = case
    x, w, b = _inputs(R, C, dtype, seed=R + C, offset=offset)
    w = w if affine in ("both", "weight") else None
    b = b if affine in ("both", "bias") else None
    got = run(x, w, b)
    assert got[3] == kind
    _check(x, w, b, got)


def exact(x, w, b, eps):
    """The plain version's formula in fp64 (``layer_norm_ref`` itself
    computes in fp32): y and the mean."""
    xd = x.double()
    mean = xd.mean(dim=-1, keepdim=True)
    xc = xd - mean
    y = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return y * w.double() + b.double(), mean


def test_large_mean_is_centred_exactly():
    """x = 1e3 + 2 randn: y within 2e-6 of the plain version in fp64 (the
    shared fp32 ATOL is 2e-5), and E[x^2] - mean^2 in fp32 off by more
    than 0.1% of the variance on some row."""
    x, w, b = _inputs(128, 768, torch.float32, seed=7, loc=1e3)
    y, mean, rstd, kind = run(x, w, b, full=8)
    assert kind == ("warp", 6)
    ry, rmean = exact(x, w, b, 1e-5)
    assert float((y.double() - ry).abs().max()) <= 2e-6
    assert bool(((mean.double() - rmean).abs() <= 2.0 ** -23
                 * rmean.abs()).all())
    y32 = k2.layer_norm_ref(x, w, b, 1e-5)[0]
    assert float((y32.double() - ry).abs().max()) > 2e-6
    xn = x.numpy()
    naive = (np.mean(xn * xn, axis=1, dtype=F32)
             - np.mean(xn, axis=1, dtype=F32) ** 2)
    var = xn.astype(np.float64).var(axis=1)
    assert float(np.max(np.abs(naive - var) / var)) > 1e-3


def test_warp_rows_cover_the_grid_once():
    """Every grid the warp kernel can get (from one CTA to more than the
    rows need) takes every row once."""
    x, w, b = _inputs(23, 64, torch.float32, seed=3)
    ref = run(x, w, b, full=1)
    for full in (2, 3, 6, 100):
        got = run(x, w, b, full=full)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
