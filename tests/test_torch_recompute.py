"""Recompute, attention dropout and the whole training loop: the port
against itself and against the JAX package.

- Recompute rematerializes and replays exactly: ``gpt_tiny`` with both
  dropouts on (0.1) and ``recompute_granularity="full"`` gives the loss
  and every gradient of the same model without it BITWISE, from the
  same generator state (the replay draws the forward's masks); so does
  ``ShardedTrainer(recompute=True)`` over two steps, under fp32 and
  bf16 AMP (the replay casts as the forward did). With the dropouts off
  the recomputed gradients equal the JAX model's (``jax.grad`` through
  its per-block ``recompute``) within 1e-5, as every fp32 gradient of
  this file. Per-block recompute launches each block's forward kernels
  twice (K1 2L and K2 4L + 1 a step), which ``chip_smoke.py`` phase 6b
  counts on the card.
- ``fleet.utils.recompute`` pops ``preserve_rng_state`` and is a plain
  call under ``no_grad``.
- Attention dropout: its keep rate is held to 1 - p by a chi-square
  test on 2**16 draws; its formula, given one keep mask, to a numpy
  transcription of the reference's ``_sdpa_xla`` (:26-58) and to the
  JAX function itself with its Bernoulli draw replaced by that mask
  (1e-6); ``training=False`` is the identity.
- Five ``train_step``s of ``ShardedTrainer`` with a warm-up + cosine
  schedule, a global-norm clip (active) and AdamW, against the JAX
  trainer on a one-device mesh: the losses within 1e-5 relative and the
  parameters within 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import _no_tape
from paddle_tpu.distributed import ShardedTrainer as JaxTrainer
from paddle_tpu.distributed import build_mesh
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

from paddle_tpu_torch.distributed import ShardedTrainer
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.functional import attention as port_attention
from paddle_tpu_torch.ops.kernels import flash_attention as port_fa
from paddle_tpu_torch.ops.kernels import layer_norm as port_k2
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as port_lr

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

jax_attention = importlib.import_module("paddle_tpu.nn.functional.attention")
jax_lr = importlib.import_module("paddle_tpu.optimizer.lr")


def _cfg(dropout=0.1, remat=None, layers=2):
    cfg = gpt_tiny()
    cfg.num_layers = layers
    cfg.hidden_dropout = cfg.attention_dropout = dropout
    cfg.recompute_granularity = remat
    return cfg


def _ids(seed=0, b=2, s=128):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (b, s)).astype(np.int64))


def _loss_and_grads(model, ids, seed):
    torch.manual_seed(seed)
    loss = model(ids, ids)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


@pytest.mark.parametrize("dropout", [0.1, 0.0])
def test_per_block_recompute_equals_the_plain_backward_bitwise(dropout):
    plain = GPTForCausalLM(_cfg(dropout), device="cpu", seed=3)
    remat = GPTForCausalLM(_cfg(dropout, "full"), device="cpu", seed=3)
    plain.train()
    remat.train()
    ids = _ids()
    for seed in (0, 1):
        l0, g0 = _loss_and_grads(plain, ids, seed)
        l1, g1 = _loss_and_grads(remat, ids, seed)
        assert torch.equal(l0, l1)
        for n in g0:
            assert torch.equal(g0[n], g1[n]), n
    # the dropouts are live: another seed, another loss
    if dropout:
        assert not torch.equal(_loss_and_grads(plain, ids, 5)[0], l0)


def test_recompute_replays_each_block_forward_once_more(monkeypatch):
    """Per step with per-block recompute: K1 2L, K3a L, K2 4L + 1 (the
    forward, the replay of each block, ln_f once), counted at the
    wrappers on the CPU; without it K1 L and K2 2L + 1."""
    calls = {"fwd": 0, "bwd": 0, "ln": 0}

    def counting(name, real):
        def spy(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return spy

    monkeypatch.setattr(port_fa, "flash_fwd",
                        counting("fwd", port_fa.flash_fwd))
    monkeypatch.setattr(port_fa, "flash_bwd_fused",
                        counting("bwd", port_fa.flash_bwd_fused))
    monkeypatch.setattr(port_k2, "layer_norm_fwd",
                        counting("ln", port_k2.layer_norm_fwd))
    L = 3
    for remat, want in ((None, (L, L, 2 * L + 1)),
                        ("full", (2 * L, L, 4 * L + 1))):
        for k in calls:
            calls[k] = 0
        m = GPTForCausalLM(_cfg(0.0, remat, layers=L), device="cpu", seed=0)
        m.train()
        m(_ids(), _ids()).backward()
        assert (calls["fwd"], calls["bwd"], calls["ln"]) == want, remat
    # eval and caches never recompute
    calls["fwd"] = 0
    m.eval()
    with torch.no_grad():
        m(_ids())
    assert calls["fwd"] == L


@pytest.mark.parametrize("amp", [False, True])
def test_trainer_recompute_equals_the_plain_trainer_bitwise(amp):
    ids = _ids(1)
    runs = []
    for remat in (False, True):
        m = GPTForCausalLM(_cfg(0.1), device="cpu", seed=4)
        m.train()
        opt = AdamW(1e-3, parameters=m.named_parameters(), weight_decay=0.01)
        tr = ShardedTrainer(m, opt, None, recompute=remat, amp=amp)
        torch.manual_seed(7)
        losses = [tr.train_step(ids, ids) for _ in range(2)]
        runs.append((losses, {n: p.detach().clone()
                              for n, p in m.named_parameters()}))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


def test_recompute_gradients_match_jax():
    """Dropout off (JAX's threefry draws are not reproduced): the port's
    per-block recompute against ``jax.grad`` of the JAX model with its
    own per-block recompute, on the same weights."""
    paddle.seed(0)
    jcfg = jax_gpt_tiny()
    jcfg.hidden_dropout = jcfg.attention_dropout = 0.0
    jcfg.recompute_granularity = "full"
    jm = JaxGPT(jcfg)
    jm.train()
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    ids = _ids(2).numpy()
    params = {n: p.value for n, p in jm.named_parameters()}

    def f(ps):
        with _no_tape():
            return jm.functional_call(ps, jnp.asarray(ids),
                                      jnp.asarray(ids)).value

    jl, jg = jax.jit(jax.value_and_grad(f))(params)
    cfg = _cfg(0.0, "full")
    cfg.num_layers = jcfg.num_layers
    pm = GPTForCausalLM(cfg, device="cpu")
    pm.set_state_dict(state)
    pm.train()
    loss = pm(torch.from_numpy(ids), torch.from_numpy(ids))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[n]),
                                   atol=1e-5, rtol=0, err_msg=n)


def test_recompute_utility_contract():
    x = torch.randn(3, requires_grad=True)

    def f(a, scale=1.0):
        return (a * scale).sin()

    y = recompute(f, x, scale=2.0, preserve_rng_state=False)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(),
                               (2 * torch.cos(2 * x)).detach().numpy(),
                               rtol=1e-6)
    with torch.no_grad():
        assert torch.equal(recompute(f, x), f(x))


# ------------------------------------------------------------ attention dropout
def test_attention_dropout_keep_rate():
    """q = k = 0 makes every probability 1/sk; v the identity (sk = D)
    makes out * sk * (1 - p) the keep mask itself."""
    p, sk, rows = 0.3, 64, 1024
    q = torch.zeros(1, rows, 1, 64)
    v = torch.eye(sk).reshape(1, sk, 1, sk)
    torch.manual_seed(0)
    out = port_attention.scaled_dot_product_attention(q, q[:, :sk], v,
                                                      dropout_p=p)
    keep = out[0, :, 0] * sk * (1 - p)
    assert torch.allclose(keep, keep.round(), atol=1e-4)
    kept = int(keep.round().sum())
    n = rows * sk
    expect = n * (1 - p)
    chi2 = (kept - expect) ** 2 / expect + (kept - expect) ** 2 / (n * p)
    assert chi2 < 10.83          # 1 degree of freedom, p = 0.001
    # two draws differ; the same generator state draws the same mask
    torch.manual_seed(0)
    again = port_attention.scaled_dot_product_attention(q, q[:, :sk], v,
                                                        dropout_p=p)
    assert torch.equal(out, again)
    assert not torch.equal(out, port_attention.scaled_dot_product_attention(
        q, q[:, :sk], v, dropout_p=p))


def _numpy_sdpa(q, k, v, keep, p, causal, scale):
    """A numpy transcription of ``_sdpa_xla`` (attention.py:26-58), fp32
    throughout, with the keep mask given."""
    qt, kt, vt = (np.swapaxes(x, 1, 2) for x in (q, k, v))
    logits = np.einsum("bhqd,bhkd->bhqk", qt, kt) * np.float32(scale)
    if causal:
        sq, sk = logits.shape[-2:]
        logits = np.where(np.tril(np.ones((sq, sk), bool), k=sk - sq),
                          logits, -np.inf)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    probs = np.where(keep, probs / np.float32(1.0 - p), np.float32(0))
    return np.swapaxes(np.einsum("bhqk,bhkd->bhqd", probs, vt), 1, 2)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_dropout_formula_given_a_mask(causal, monkeypatch):
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(2, 40, 3, 16).astype(np.float32) for _ in range(3))
    keep = rs.rand(2, 3, 40, 40) > 0.25
    p, scale = 0.25, 0.25
    want = _numpy_sdpa(q, k, v, keep, p, causal, scale)
    got = port_attention._sdpa(*map(torch.from_numpy, (q, k, v)),
                               is_causal=causal, scale=scale, dropout_p=p,
                               keep=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the reference itself, its Bernoulli draw replaced by the same mask
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, prob, shape: jnp.asarray(keep))
    jref = jax_attention._sdpa_xla(
        *map(jnp.asarray, (q, k, v)), dropout_key=jax.random.PRNGKey(0),
        dropout_p=p, is_causal=causal, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-5,
                               atol=1e-6)


def test_attention_dropout_is_the_identity_out_of_training():
    rs = np.random.RandomState(1)
    q = torch.from_numpy(rs.randn(1, 32, 2, 16).astype(np.float32))
    base = port_attention.scaled_dot_product_attention(q, q, q, dropout_p=0.0)
    off = port_attention.scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                                      training=False)
    assert torch.equal(base, off)


# ------------------------------------------------------------ the loop
def _schedule(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(2e-3, T_max=5), 2, 0.0,
                          2e-3)


def test_five_steps_with_schedule_clip_and_adamw_match_the_jax_trainer():
    paddle.seed(21)
    jm = JaxGPT(jax_gpt_tiny())
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    jm.train()
    mesh = build_mesh([1, 1, 1, 1], ["dp", "pp", "sharding", "mp"],
                      devices=np.array(jax.devices()[:1]))
    jsched = _schedule(jax_lr)
    jclip = importlib.import_module("paddle_tpu.nn.clip")
    jopt = paddle.optimizer.AdamW(
        learning_rate=jsched, parameters=jm.parameters(), weight_decay=0.01,
        grad_clip=jclip.ClipGradByGlobalNorm(0.5))
    jt = JaxTrainer(jm, jopt, None, mesh)
    pm = GPTForCausalLM(gpt_tiny(), device="cpu")
    pm.set_state_dict(state)
    pm.train()
    psched = _schedule(port_lr)
    clip = ClipGradByGlobalNorm(0.5)
    norms = []
    real = clip._global_norm_sq

    def spy(pairs):
        sq = real(pairs)
        norms.append(float(sq) ** 0.5)
        return sq

    clip._global_norm_sq = spy
    popt = AdamW(learning_rate=psched, parameters=pm.named_parameters(),
                 weight_decay=0.01, grad_clip=clip)
    pt = ShardedTrainer(pm, popt, None)
    rs = np.random.RandomState(9)
    ids = rs.randint(0, 256, (2, 128)).astype(np.int32)
    labels = ids.astype(np.int64)
    want, got = [], []
    for _ in range(5):
        want.append(float(np.asarray(jt.train_step(ids, labels))))
        got.append(pt.train_step(ids, labels).item())
        jsched.step()
        psched.step()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    assert max(norms) > 0.5                  # the clip scaled the grads
    jstate = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jstate[n], atol=1e-5,
                                   rtol=0, err_msg=n)
