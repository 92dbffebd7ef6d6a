"""Port training slice (``paddle_tpu_torch``) against the JAX package.

The same numpy inputs (and, for the models, the same weights copied by
name with ``set_state_dict``) go through both packages on the CPU:
LayerNorm gradients (K2's autograd Function), the fused chunked head and
cross entropy, three AdamW updates, the AMP cast decisions, GPT's loss
path with its gradients, and three ``ShardedTrainer.train_step``s.

Tolerances, all fp32 unless stated: gradients and losses differ only in
summation order (atol 1e-5 on unit-scale values); AdamW's arithmetic is
the same sequence of fp32 operations (rtol 1e-6; the moments atol 1e-8,
one rounding of Adam's L2 term g + coeff * p, which torch may fuse). The AMP trainer
compares two bf16 computations that round at different places (XLA and
torch fuse and cast differently), so its losses are held to 2e-2
relative; the fp32 trainer's to 1e-5 relative.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import auto_cast as jax_auto_cast
from paddle_tpu.core.tensor import Tensor, _no_tape
from paddle_tpu.distributed import ShardedTrainer as JaxTrainer
from paddle_tpu.distributed import build_mesh
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt2_small as jax_gpt2_small
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.optimizer import Adam as JaxAdam
from paddle_tpu.optimizer import AdamW as JaxAdamW

from paddle_tpu_torch.amp import auto_cast, maybe_cast_inputs
from paddle_tpu_torch.distributed import ShardedTrainer
from paddle_tpu_torch.models import GPTForCausalLM, gpt2_small, gpt_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import attention as port_attention
from paddle_tpu_torch.optimizer import Adam, AdamW

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

# by module path: the packages' __init__ re-export functions of the
# same names
jax_amp = importlib.import_module("paddle_tpu.amp.auto_cast")
jax_loss = importlib.import_module("paddle_tpu.nn.functional.loss")
jax_ln = importlib.import_module("paddle_tpu.ops.pallas.layer_norm")


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("affine", ["both", "weight", "bias", "none"])
def test_layer_norm_gradients_match_jax(affine):
    rs = np.random.RandomState(0)
    x = rs.randn(4, 5, 32).astype(np.float32) * 2 + 0.5
    gy = rs.randn(4, 5, 32).astype(np.float32)
    w = rs.randn(32).astype(np.float32) if affine in ("both", "weight") \
        else None
    b = rs.randn(32).astype(np.float32) if affine in ("both", "bias") \
        else None
    args = [a for a in (x, w, b) if a is not None]

    def loss(*vals):
        it = iter(vals)
        xv = next(it)
        wv = next(it) if w is not None else None
        bv = next(it) if b is not None else None
        y = jax_ln.layer_norm_pallas(xv, 32, wv, bv, 1e-5, interpret=True)
        return jnp.sum(y * gy)

    want = jax.grad(loss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    ts = [_t(a).requires_grad_() for a in args]
    it = iter(ts)
    tx = next(it)
    tw = next(it) if w is not None else None
    tb = next(it) if b is not None else None
    (F.layer_norm(tx, 32, tw, tb, 1e-5) * _t(gy)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("w_vocab_major", [False, True])
def test_linear_cross_entropy_matches_jax(w_vocab_major, reduction):
    """V=300 in chunks of 128 (a ragged last chunk of 44), with ignored
    rows."""
    rs = np.random.RandomState(1)
    x = rs.randn(3, 4, 16).astype(np.float32)
    w = rs.randn(*((300, 16) if w_vocab_major else (16, 300))).astype(
        np.float32) * 0.5
    label = rs.randint(0, 300, (3, 4))
    label[0, 1] = label[2, 3] = -100
    g = rs.randn(3, 4).astype(np.float32)
    kw = dict(reduction=reduction, vocab_chunk=128,
              w_vocab_major=w_vocab_major)

    def jloss(xv, wv):
        out = jax_loss.linear_cross_entropy(xv, wv, jnp.asarray(label), **kw)
        return out if reduction == "mean" else jnp.sum(out * g)

    want_loss = jloss(jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                       jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    out = F.linear_cross_entropy(tx, tw, _t(label), **kw)
    loss = out if reduction == "mean" else (out * _t(g)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw),
                               atol=1e-5, rtol=1e-5)


def test_cross_entropy_matches_jax():
    rs = np.random.RandomState(2)
    logits = rs.randn(2, 5, 30).astype(np.float32) * 3
    label = rs.randint(0, 30, (2, 5))
    label[1, 2] = -100
    want = jax_loss.cross_entropy(jnp.asarray(logits), jnp.asarray(label))
    got = F.cross_entropy(_t(logits), _t(label))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("kind", ["adamw", "adamw_decay_fun", "adam_l2"])
def test_three_updates_match_jax_update_rule(kind):
    rs = np.random.RandomState(3)
    init = {"w": rs.randn(4, 3).astype(np.float32),
            "b": rs.randn(3).astype(np.float32)}
    grads = [{n: rs.randn(*a.shape).astype(np.float32)
              for n, a in init.items()} for _ in range(3)]
    lr, coeff = 1e-2, 0.05
    decays = (lambda n: n == "w") if kind == "adamw_decay_fun" else None
    tp = {n: torch.nn.Parameter(_t(a.copy())) for n, a in init.items()}
    if kind == "adam_l2":
        opt = Adam(lr, parameters=list(tp.items()), weight_decay=coeff)
    else:
        opt = AdamW(lr, parameters=list(tp.items()), weight_decay=coeff,
                    apply_decay_param_fun=decays)
    jp = {n: jnp.asarray(a) for n, a in init.items()}
    js = {n: {"moment1": jnp.zeros_like(a), "moment2": jnp.zeros_like(a),
              "beta1_pow": jnp.ones((), jnp.float32),
              "beta2_pow": jnp.ones((), jnp.float32)} for n, a in jp.items()}
    for gs in grads:
        for n, p in tp.items():
            p.grad = _t(gs[n])
        opt.step()
        opt.clear_grad()
        for n in jp:
            g = jnp.asarray(gs[n])
            lr_j = jnp.asarray(lr, jnp.float32)
            if kind == "adam_l2":
                jp[n], js[n] = JaxAdam._update(jp[n], g + coeff * jp[n],
                                               js[n], lr_j)
            else:
                c = 0.0 if decays is not None and not decays(n) else coeff
                jp[n], js[n] = JaxAdamW._update(jp[n], g, js[n], lr_j,
                                                coeff=c)
        for n, p in tp.items():
            assert p.grad is None
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                       rtol=1e-6, atol=1e-7)
            state = opt._accumulators[id(p)]
            for slot, val in js[n].items():
                np.testing.assert_allclose(state[slot].numpy(),
                                           np.asarray(val), rtol=1e-6,
                                           atol=1e-8)


def test_decay_fun_needs_named_parameters():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = AdamW(1e-3, parameters=[p], apply_decay_param_fun=lambda n: True)
    p.grad = torch.ones(3)
    with pytest.raises(ValueError, match="named_parameters"):
        opt.step()


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("custom", [False, True])
def test_amp_cast_decisions_match_jax(level, custom):
    ops = ["linear", "matmul", "column_parallel_linear",
           "row_parallel_linear", "scaled_dot_product_attention",
           "layer_norm", "linear_cross_entropy", "cross_entropy", "gelu",
           "softmax", "embedding"]
    lists = (dict(custom_white_list={"gelu"}, custom_black_list={"matmul"})
             if custom else {})
    jvals = [jnp.ones(2, jnp.float32), jnp.ones(2, jnp.bfloat16),
             jnp.ones(2, jnp.float16), jnp.ones(2, jnp.int32), None]
    tvals = [torch.ones(2), torch.ones(2, dtype=torch.bfloat16),
             torch.ones(2, dtype=torch.float16),
             torch.ones(2, dtype=torch.int32), None]
    for op in ops:
        with jax_auto_cast(level=level, **lists):
            want = [None if v is None else str(v.dtype)
                    for v in jax_amp.maybe_cast_inputs(op, jvals)]
        with auto_cast(level=level, **lists):
            got = [None if v is None else str(v.dtype).split(".")[1]
                   for v in maybe_cast_inputs(op, tvals)]
        assert got == want, op
    # off: nothing is cast
    assert maybe_cast_inputs("linear", tvals) == tvals


def _diverse_state(names_shapes, seed=0):
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
def tiny_pair():
    paddle.seed(5)
    jm = JaxGPT(jax_gpt_tiny())
    state = _diverse_state({k: tuple(v.shape)
                            for k, v in jm.state_dict().items()})
    jm.set_state_dict(state)
    pm = GPTForCausalLM(gpt_tiny(), device="cpu")
    pm.set_state_dict(state)
    return jm, pm


def test_gpt_loss_and_gradients_match_jax_through_flash(tiny_pair,
                                                        monkeypatch):
    """S=128 passes the gate, so the port's attention is the flash path
    (its plain versions on the CPU) against JAX's XLA attention."""
    jm, pm = tiny_pair
    flash_calls = []
    real_flash = port_attention.flash_attention
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda *a, **k: flash_calls.append(1)
                        or real_flash(*a, **k))
    ids = np.random.RandomState(4).randint(0, 256, (2, 128))

    def jax_loss_of(params):
        with _no_tape():
            return jm.functional_call(params, Tensor(jnp.asarray(ids)),
                                      Tensor(jnp.asarray(ids))).value

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss_of))(
        {n: p.value for n, p in jm.named_parameters()})
    pm.zero_grad()
    ploss = pm(_t(ids), _t(ids))
    ploss.backward()
    assert len(flash_calls) == gpt_tiny().num_layers
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-5)
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[n]),
                                   atol=2e-5, rtol=1e-4, err_msg=n)
    # the logits path and the functional loss agree with JAX too
    with torch.no_grad():
        logits = pm(_t(ids))
    jlogits = jm(paddle.to_tensor(ids))
    np.testing.assert_allclose(
        GPTForCausalLM.loss(logits, _t(ids)).item(),
        float(JaxGPT.loss(jlogits, paddle.to_tensor(ids)).numpy()),
        rtol=1e-5)
    np.testing.assert_allclose(GPTForCausalLM.loss(logits, _t(ids)).item(),
                               ploss.item(), rtol=1e-5)


def test_forward_signature_and_labels_check_match_jax(tiny_pair):
    _, pm = tiny_pair
    names = list(inspect.signature(GPTForCausalLM.forward).parameters)
    jnames = list(inspect.signature(JaxGPT.forward).parameters)
    assert names == jnames == ["self", "input_ids", "labels",
                               "position_ids", "caches", "adapters",
                               "output_hidden"]
    ids = torch.zeros(2, 16, dtype=torch.long)
    with pytest.raises(TypeError, match="position_ids"):
        pm(ids, torch.arange(16))               # position_ids passed as labels
    with pytest.raises(TypeError, match="integer ids"):
        pm(ids, ids.float())


@pytest.mark.parametrize("padding_idx", [None, 3, -1])
def test_embedding_padding_idx_matches_jax(padding_idx):
    """``F.embedding(x, w, padding_idx)``: ids equal to ``padding_idx``
    (negative from the end) give zero rows, whose weights get a zero
    gradient — the JAX function's output and gradient, exactly."""
    jf = importlib.import_module("paddle_tpu.nn.functional")
    rs = np.random.RandomState(0)
    w = rs.randn(10, 4).astype(np.float32)
    x = np.asarray([[1, 3, 3, 9], [0, 3, 2, 1]])
    r = rs.randn(2, 4, 4).astype(np.float32)

    def jax_out(wv):
        with _no_tape():
            return jf.embedding(Tensor(jnp.asarray(x)), Tensor(wv),
                                padding_idx=padding_idx).value

    jgrad = jax.grad(lambda wv: (jax_out(wv) * r).sum())(jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    out = F.embedding(torch.from_numpy(x), wt, padding_idx=padding_idx)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jax_out(jnp.asarray(w))))
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jgrad))
    if padding_idx is not None:
        assert not wt.grad[padding_idx % 10].any()


def test_num_params_matches_jax_and_the_model():
    assert gpt2_small().num_params() == jax_gpt2_small().num_params()
    assert gpt_tiny().num_params() == jax_gpt_tiny().num_params()
    pm = GPTForCausalLM(gpt_tiny(), device="cpu")
    assert sum(p.numel() for p in pm.parameters()) == \
        gpt_tiny().num_params()


@pytest.mark.parametrize("amp,rtol", [(False, 1e-5), (True, 2e-2)])
def test_three_train_steps_match_jax_trainer(amp, rtol):
    paddle.seed(11)
    jm = JaxGPT(jax_gpt_tiny())
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    jm.train()
    mesh = build_mesh([1, 1, 1, 1], ["dp", "pp", "sharding", "mp"],
                      devices=np.array(jax.devices()[:1]))
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01)
    jt = JaxTrainer(jm, jopt, None, mesh, amp=amp)
    pm = GPTForCausalLM(gpt_tiny(), device="cpu")
    pm.set_state_dict(state)
    pm.train()
    popt = AdamW(learning_rate=1e-3, parameters=pm.parameters(),
                 weight_decay=0.01)
    pt = ShardedTrainer(pm, popt, None, amp=amp)
    rs = np.random.RandomState(6)
    ids = rs.randint(0, 256, (2, 128)).astype(np.int32)
    labels = ids.astype(np.int64)
    want = [float(np.asarray(jt.train_step(ids, labels))) for _ in range(3)]
    got = []
    for _ in range(3):
        loss = pt.train_step(ids, labels)
        assert loss.dim() == 0 and loss.dtype == torch.float32
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert got[-1] < got[0]


def test_trainer_refuses_what_is_not_ported():
    """A mesh of more than one device that is not the port's ``Mesh``
    of ranks, and a batch spec, are refused; a one-device mesh is
    accepted (ZeRO offload is ported: tests/test_torch_offload.py;
    ``strategy.moe`` trains a GPT-MoE: tests/test_torch_moe.py), and so
    is ``strategy.pipeline``, which the reference's trainer does not
    read either: the pipeline over ranks comes from the mesh's ``pp``
    axis (tests/test_torch_pipeline.py)."""
    from paddle_tpu_torch.distributed import DistributedStrategy

    pm = GPTForCausalLM(gpt_tiny(), device="cpu")
    opt = AdamW(parameters=pm.parameters())
    for kw, match in ((dict(mesh=np.zeros(4)), "more than one device"),
                      (dict(batch_spec=("dp",)), "batch_spec")):
        with pytest.raises(NotImplementedError, match=match):
            ShardedTrainer(pm, opt, None, **kw)
    assert ShardedTrainer(pm, opt, None, mesh=np.zeros(1)).step_count == 0
    piped = ShardedTrainer(pm, opt, None,
                           strategy=DistributedStrategy(pipeline=True))
    ids = torch.zeros(2, 8, dtype=torch.long)
    assert torch.isfinite(piped.train_step(ids, ids))
