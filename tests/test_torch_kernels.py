"""Port kernels' plain versions against the JAX package's Pallas kernels.

``paddle_tpu_torch`` keeps a plain PyTorch version beside each CUDA
kernel (K2 LayerNorm, K4 paged decode, K5 chunk prefill); on CPU tensors
the wrappers run it. Here the same numpy inputs from a seed go through
the JAX Pallas kernels in interpret mode (as ``tests/test_pallas_paged.py``
runs them) and through the port's wrappers on the CPU.

Tolerance: fp32 atol/rtol 1e-5 — both sides compute in float32 and
differ only in summation order (online softmax over blocks vs one
softmax over the gathered view).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.pallas.chunk_prefill import (_pick_qbs,
                                                 chunk_prefill_pallas)
from paddle_tpu.ops.pallas.layer_norm import _ln_forward, layer_norm_pallas
from paddle_tpu.ops.pallas.paged_attention import paged_attention_pallas

from paddle_tpu_torch.nn.functional import layer_norm
from paddle_tpu_torch.ops.kernels import chunk_prefill as k5
from paddle_tpu_torch.ops.kernels import layer_norm as k2
from paddle_tpu_torch.ops.kernels import paged_attention as k4

TOL = dict(atol=1e-5, rtol=1e-5)

# pool geometry: 3 slots, 4 heads, head_dim 64, blocks of 8 rows,
# 6 blocks per slot (48 logical rows), 16 physical blocks (some in no
# table row)
B, H, D, BS, BP, NBLK = 3, 4, 64, 8, 6, 16


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("affine", ["both", "weight", "bias", "none"])
@pytest.mark.parametrize("shape", [(6, 32), (2, 3, 16)])
def test_layer_norm_matches_pallas(affine, shape):
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32) * 3 + 1
    C = shape[-1]
    w = rs.randn(C).astype(np.float32) if affine in ("both", "weight") \
        else None
    b = rs.randn(C).astype(np.float32) if affine in ("both", "bias") \
        else None
    ref = layer_norm_pallas(jnp.asarray(x), C,
                            None if w is None else jnp.asarray(w),
                            None if b is None else jnp.asarray(b),
                            1e-5, interpret=True)
    out = layer_norm(_t(x), C, None if w is None else _t(w),
                     None if b is None else _t(b), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the residuals the training slice will use: fp32 (R, 1) mean, rstd
    _, mean, rstd = _ln_forward(jnp.asarray(x.reshape(-1, C)),
                                None if w is None else jnp.asarray(w),
                                None if b is None else jnp.asarray(b),
                                1e-5, 256, True)
    _, pm, pr = k2.layer_norm_ref(_t(x.reshape(-1, C)),
                                  None if w is None else _t(w),
                                  None if b is None else _t(b), 1e-5)
    np.testing.assert_allclose(pm.numpy(), np.asarray(mean), **TOL)
    np.testing.assert_allclose(pr.numpy(), np.asarray(rstd), **TOL)


@pytest.mark.parametrize("case", ["narrow", "rank1", "two_axes",
                                  "weight_2d"])
def test_layer_norm_shape_gate_matches_pallas(case):
    """Shapes the JAX function hands to its composed op (C < 8, rank-1
    x, a two-axis normalized_shape, a non-1-D weight) take the port's
    composed op too, with the same result."""
    rs = np.random.RandomState(1)
    ns, w = None, None
    if case == "narrow":
        x = rs.randn(5, 6)
        ns = 6
    elif case == "rank1":
        x = rs.randn(32)
        ns = 32
    elif case == "two_axes":
        x = rs.randn(3, 4, 16)
        ns = (4, 16)
    else:
        x = rs.randn(3, 4, 16)
        ns = (4, 16)
        w = rs.randn(4, 16).astype(np.float32)
    x = x.astype(np.float32)
    ref = layer_norm_pallas(jnp.asarray(x), ns,
                            None if w is None else jnp.asarray(w), None,
                            1e-5, interpret=True)
    out = layer_norm(_t(x), ns, None if w is None else _t(w), None, 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _pools(seed):
    rs = np.random.RandomState(seed)
    kp = rs.randn(NBLK, BS, H, D).astype(np.float32)
    vp = rs.randn(NBLK, BS, H, D).astype(np.float32)
    # aliasing allowed; block 0 is the scratch sink; blocks 13..15 sit in
    # no table row
    tbl = rs.randint(1, 13, size=(B, BP)).astype(np.int32)
    return rs, kp, vp, tbl


def _poison(kp, vp, tbl, reach):
    """1e9 in every physical row no (slot, table entry) can read, NaN in
    every block no table row names. ``reach[o]`` is slot o's deepest
    readable column."""
    kp, vp = kp.copy(), vp.copy()
    nb = tbl.shape[0]
    for blk in range(NBLK):
        if not (tbl == blk).any():
            kp[blk] = np.nan
            vp[blk] = np.nan
            continue
        for r in range(BS):
            readable = any(tbl[o, j] == blk and j * BS + r <= reach[o]
                           for o in range(nb) for j in range(BP))
            if not readable:
                kp[blk, r] = 1e9
                vp[blk, r] = 1e9
    return kp, vp


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("scalar_t", [False, True])
def test_paged_attention_matches_pallas(s, scalar_t):
    """Decode (s=1) and verify (s=4) shapes, per-slot offsets that
    straddle block boundaries, and a scalar offset broadcast to every
    slot."""
    rs, kp, vp, tbl = _pools(2)
    q = rs.randn(B, s, H, D).astype(np.float32)
    t = np.int32(9) if scalar_t else np.asarray([5, 17, 40 - s], np.int32)
    ref = paged_attention_pallas(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), None, None,
                                 jnp.asarray(tbl), jnp.asarray(t),
                                 interpret=True)
    out = k4.paged_attention(_t(q), _t(kp), _t(vp), _t(tbl),
                             torch.tensor(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_paged_attention_poisoned_pool_never_read():
    """Rows no slot can read hold 1e9 and blocks no table row names hold
    NaN: the output stays finite and equal to the clean pool's."""
    rs, kp, vp, tbl = _pools(3)
    q = rs.randn(B, 1, H, D).astype(np.float32)
    t = np.asarray([5, 17, 40], np.int32)
    kpp, vpp = _poison(kp, vp, tbl, t)
    clean = paged_attention_pallas(jnp.asarray(q), jnp.asarray(kp),
                                   jnp.asarray(vp), None, None,
                                   jnp.asarray(tbl), jnp.asarray(t),
                                   interpret=True)
    out = k4.paged_attention(_t(q), _t(kpp), _t(vpp), _t(tbl), _t(t))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(clean), **TOL)


@pytest.mark.parametrize("s", [16, 12])
@pytest.mark.parametrize("start", [0, 5, 24, 40])
def test_chunk_prefill_matches_pallas(s, start):
    """Power-of-two and non-power-of-two chunks at several offsets of a
    single-slot chunk (the serving engine's shape), on a poisoned pool:
    rows past start+s-1 hold 1e9, blocks outside the table NaN. At start
    40 the chunk's tail runs past the table's 48 rows."""
    rs, kp, vp, tbl = _pools(4)
    tbl = tbl[:1]
    q = rs.randn(1, s, H, D).astype(np.float32)
    ref = chunk_prefill_pallas(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), None, None,
                               jnp.asarray(tbl), jnp.asarray(start),
                               interpret=True)
    st = torch.tensor(start, dtype=torch.int32)
    out = k5.chunk_prefill(_t(q), _t(kp), _t(vp), _t(tbl), st)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    kpp, vpp = _poison(kp, vp, tbl, [start + s - 1])
    poisoned = k5.chunk_prefill(_t(q), _t(kpp), _t(vpp), _t(tbl), st)
    assert torch.isfinite(poisoned).all()
    np.testing.assert_allclose(poisoned.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("s", [1, 7, 12, 16, 100, 128, 256])
def test_pick_qbs_is_the_pallas_pick_capped(s):
    assert k5.pick_qbs(s) == min(_pick_qbs(s), k5.MAX_QBS)
    assert s % k5.pick_qbs(s) == 0


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers run their plain versions and never
    count a kernel launch."""
    for m in (k2, k4, k5):
        m.reset_launches()
    rs, kp, vp, tbl = _pools(5)
    q = _t(rs.randn(B, 1, H, D).astype(np.float32))
    t = torch.tensor([3, 4, 5], dtype=torch.int32)
    args = (q, _t(kp), _t(vp), _t(tbl), t)
    assert torch.equal(k4.paged_attention(*args),
                       k4.paged_attention_ref(*args))
    assert torch.equal(k5.chunk_prefill(*args), k5.chunk_prefill_ref(*args))
    x = _t(rs.randn(4, 16).astype(np.float32))
    assert torch.equal(k2.layer_norm_fwd(x, None, None, 1e-5)[0],
                       k2.layer_norm_ref(x, None, None, 1e-5)[0])
    assert (k2.launches, k4.launches, k5.launches) == (0, 0, 0)
