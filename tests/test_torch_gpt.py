"""Port GPT (``paddle_tpu_torch.models.gpt``) against the JAX GPT.

The port copies the JAX model's weights by parameter name
(``Layer.set_state_dict``), then both models run the same numpy inputs:
the no-cache forward, and the paged full-precision cache path (a chunk
prefill at a scalar offset, then lockstep decode steps at per-slot
offsets) over the same pools and block tables.

Tolerance: fp32 logits atol 1e-4 — float32 on both sides, differing in
matmul and softmax summation order across two layers of width 64.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models.gpt import _upd_paged as jax_upd_paged

from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.models.gpt import _upd_paged

ATOL = 1e-4


def _diverse_state(names_shapes, seed=0):
    """Random weights wide enough that greedy decoding does not simply
    repeat the last token (the 0.02 init of a 2-layer model does)."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, shape in names_shapes.items():
        a = rs.randn(*shape).astype(np.float32) * (0.3 if len(shape) == 2
                                                   else 0.1)
        if ".ln_" in k and k.endswith("weight"):
            a += 1.0
        out[k] = a
    return out


@pytest.fixture(scope="module")
def models():
    paddle.seed(1234)
    jm = JaxGPT(jax_gpt_tiny())
    state = _diverse_state({k: tuple(v.shape)
                            for k, v in jm.state_dict().items()})
    jm.set_state_dict(state)
    pm = GPTForCausalLM(gpt_tiny(), device="cpu")
    pm.set_state_dict(state)
    pm.eval()
    return jm, pm


def test_weight_bridge_names_and_shapes_match():
    paddle.seed(1)
    jm = JaxGPT(jax_gpt_tiny())
    jstate = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    pm = GPTForCausalLM(gpt_tiny(), device="cpu")
    pshapes = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert pshapes == {k: v.shape for k, v in jstate.items()}
    pm.set_state_dict(jstate)
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jstate[k])
    missing = dict(jstate)
    missing.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError, match="gpt.ln_f.bias"):
        pm.set_state_dict(missing)
    with pytest.raises(KeyError, match="extra"):
        pm.set_state_dict(dict(jstate, extra=np.zeros(3, np.float32)))
    bad = dict(jstate)
    bad["gpt.wpe.weight"] = bad["gpt.wpe.weight"].T
    with pytest.raises(ValueError, match="gpt.wpe.weight"):
        pm.set_state_dict(bad)


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(gpt_tiny())


def test_no_cache_logits_match_jax(models):
    jm, pm = models
    ids = np.random.RandomState(0).randint(0, 256, (2, 37))
    jl = np.asarray(jm(paddle.to_tensor(ids)).value)
    with torch.no_grad():
        pl = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(pl, jl, atol=ATOL, rtol=0)


def _jax_paged(jm, ids, kps, vps, tbl, t):
    caches = [(Tensor(paddle.to_tensor(kp).value),
               Tensor(paddle.to_tensor(vp).value),
               paddle.to_tensor(tbl), paddle.to_tensor(t))
              for kp, vp in zip(kps, vps)]
    logits, new = jm(paddle.to_tensor(ids), caches=caches)
    return (np.asarray(logits.value), [np.asarray(c[0].value) for c in new],
            [np.asarray(c[1].value) for c in new])


def test_paged_prefill_and_decode_logits_match_jax(models):
    """A 3-slot pool: slot 0 chunk-prefills 16 tokens (scalar offset),
    then all slots decode two lockstep steps at per-slot offsets; logits
    and the committed pools agree with the JAX model driven through the
    same caches."""
    jm, pm = models
    L, H, D, bs, nblk, bp = 2, 4, 16, 8, 12, 4
    rs = np.random.RandomState(1)
    kps = [rs.randn(nblk, bs, H, D).astype(np.float32) for _ in range(L)]
    vps = [rs.randn(nblk, bs, H, D).astype(np.float32) for _ in range(L)]
    table = np.asarray([[3, 7, 1, 9], [2, 4, 0, 0], [5, 6, 8, 10]],
                       np.int32)
    # chunk prefill of slot 0: 16 real rows at offset 4
    ids = rs.randint(0, 256, (1, 16))
    jl, jk, jv = _jax_paged(jm, ids, kps, vps, table[:1], np.int32(4))
    tk = [torch.from_numpy(a.copy()) for a in kps]
    tv = [torch.from_numpy(a.copy()) for a in vps]
    with torch.no_grad():
        pl, _ = pm(torch.from_numpy(ids), caches=[
            (tk[i], tv[i], torch.from_numpy(table[:1]),
             torch.tensor(4, dtype=torch.int32)) for i in range(L)])
    np.testing.assert_allclose(pl.numpy(), jl, atol=ATOL, rtol=0)
    for i in range(L):
        np.testing.assert_allclose(tk[i].numpy(), jk[i], atol=ATOL, rtol=0)
        np.testing.assert_allclose(tv[i].numpy(), jv[i], atol=ATOL, rtol=0)
    # two lockstep decode steps at per-slot offsets
    t = np.asarray([20, 9, 30], np.int32)
    kps, vps = jk, jv
    for _ in range(2):
        tok = rs.randint(0, 256, (3, 1))
        jl, kps, vps = _jax_paged(jm, tok, kps, vps, table, t)
        with torch.no_grad():
            pl, _ = pm(torch.from_numpy(tok), caches=[
                (tk[i], tv[i], torch.from_numpy(table), torch.from_numpy(t))
                for i in range(L)])
        np.testing.assert_allclose(pl.numpy(), jl, atol=ATOL, rtol=0)
        for i in range(L):
            np.testing.assert_allclose(tk[i].numpy(), kps[i], atol=ATOL,
                                       rtol=0)
        t = t + 1


def test_paged_commit_drops_rows_past_the_table():
    """A chunk whose pad tail runs past the table's reach: those rows
    are dropped (never clamped or wrapped to the last pool row), exactly
    as the JAX commit's past-the-end sentinel drops them."""
    rs = np.random.RandomState(2)
    nblk, bs, H, D = 6, 4, 2, 8
    kp = rs.randn(nblk, bs, H, D).astype(np.float32)
    vp = rs.randn(nblk, bs, H, D).astype(np.float32)
    kn = rs.randn(1, 8, H, D).astype(np.float32)
    vn = rs.randn(1, 8, H, D).astype(np.float32)
    tbl = np.asarray([[2, 4, 1]], np.int32)      # 12 rows of reach
    start = np.int32(7)                          # rows 12..14 fall off
    jk, jv = jax_upd_paged(paddle.to_tensor(kp).value,
                           paddle.to_tensor(vp).value,
                           paddle.to_tensor(kn).value,
                           paddle.to_tensor(vn).value,
                           paddle.to_tensor(tbl).value,
                           paddle.to_tensor(start).value)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    _upd_paged(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
               torch.from_numpy(tbl), torch.tensor(start))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the last pool row (what a -1 sentinel would hit) is untouched
    np.testing.assert_array_equal(tk.numpy()[-1], kp[-1])
