"""Clipping, loss scaling, O2 and master weights: the port against the
JAX package on the same seeded numpy inputs.

- The three clippers and ``clip_grad_norm_`` on fp32 gradients of mixed
  shapes (one parameter with ``need_clip`` false): each clipped
  gradient within 1e-6 of the reference's (fp32 norms summed in another
  order), the global norm's scale active. ``ClipGradByGlobalNorm`` on
  bf16 gradients sums in fp32.
- The order of one ``Adam(weight_decay=..., grad_clip=...)`` step: the
  clip reads the raw gradients, then L2 decay is folded in
  (optimizer.py:182-185); the parameters within 1e-6 of the reference
  optimizer's, and off by far more from the other order.
- ``GradScaler`` over a planted sequence of finite and non-finite
  gradient steps, under two counter settings: the scale and the skip
  count EXACTLY the reference's after every step, the parameters within
  1e-6 (Adam's rule is the same fp32 arithmetic in another order: a few
  ulps of each step, over 20 steps of lr 0.05), a skipped step leaving
  parameters and Adam state bitwise unchanged, and ``state_dict`` equal
  to the reference's.
- ``decorate(level="O2")``: each parameter's dtype equal to the
  reference's on ``gpt_tiny`` (bf16 and fp16; LayerNorm stays fp32).
- Three ``AdamW(multi_precision=True)`` steps on bf16 parameters: fp32
  masters and state within 1e-6 relative, 1e-7 absolute (a few ulps of
  a step of lr 1e-2) of the reference's, the bf16
  parameters the masters rounded to bf16, and ``state_dict`` /
  ``set_state_dict`` carrying the masters.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

from paddle_tpu_torch.amp import GradScaler, decorate
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue, clip_grad_norm_)
from paddle_tpu_torch.optimizer import Adam, AdamW

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

jax_clip = importlib.import_module("paddle_tpu.nn.clip")
jax_decorate = importlib.import_module("paddle_tpu.amp.auto_cast").decorate

SHAPES = [(4, 5), (7,), (3, 2, 2), (6,)]


def _grads(seed=0, scale=1.0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*s) * scale).astype(np.float32) for s in SHAPES]


class _P:
    """A stand-in parameter for the clippers, with ``need_clip``."""

    def __init__(self, need_clip=True):
        self.need_clip = need_clip


@pytest.mark.parametrize("which", ["value", "norm", "global"])
def test_clippers_match_the_reference(which):
    grads = _grads(scale=2.0)
    owners = [_P(), _P(), _P(False), _P()]
    make = {"value": lambda m: m.ClipGradByValue(1.5, -0.5),
            "norm": lambda m: m.ClipGradByNorm(2.0),
            "global": lambda m: m.ClipGradByGlobalNorm(3.0)}[which]
    want = make(jax_clip)([(o, jnp.asarray(g))
                           for o, g in zip(owners, grads)])
    mod = importlib.import_module("paddle_tpu_torch.nn.clip")
    got = make(mod)([(o, torch.from_numpy(g)) for o, g in zip(owners, grads)])
    changed = 0
    for (_, w), (_, g), raw in zip(want, got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
        changed += not np.array_equal(g.numpy(), raw)
    assert changed >= 2                      # the clip is active
    assert np.array_equal(got[2][1].numpy(), grads[2])   # need_clip False


def test_global_norm_sums_bf16_gradients_in_fp32():
    grads = _grads(1, scale=30.0)
    want = jax_clip.ClipGradByGlobalNorm(1.0)(
        [(None, jnp.asarray(g, jnp.bfloat16)) for g in grads])
    got = ClipGradByGlobalNorm(1.0)(
        [(None, torch.from_numpy(g).to(torch.bfloat16)) for g in grads])
    for (_, w), (_, g) in zip(want, got):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=2 ** -7)
    sq = ClipGradByGlobalNorm(1.0)._global_norm_sq(
        [(None, torch.from_numpy(g).to(torch.bfloat16)) for g in grads])
    assert sq.dtype == torch.float32


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_the_reference(norm_type):
    grads = _grads(2, scale=3.0)
    jps = [paddle.nn.Parameter(jnp.zeros(g.shape, jnp.float32))
           for g in grads]
    for p, g in zip(jps, grads):
        p.grad = Tensor(jnp.asarray(g))
    want = jax_clip.clip_grad_norm_(jps, 2.5, norm_type)
    tps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(tps, grads):
        p.grad = torch.from_numpy(g.copy())
    got = clip_grad_norm_(tps, 2.5, norm_type)
    np.testing.assert_allclose(float(got), float(np.asarray(want.value)),
                               rtol=1e-6)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad.value),
                                   rtol=1e-6, atol=1e-7)
    assert float(got) > 2.5                   # the clip is active


def test_clip_runs_on_raw_gradients_before_l2_decay():
    rs = np.random.RandomState(3)
    init = [rs.randn(*s).astype(np.float32) * 3 for s in SHAPES]
    grads = _grads(4)
    coeff, lr = 0.5, 0.1
    jps = [paddle.nn.Parameter(jnp.asarray(a)) for a in init]
    jopt = paddle.optimizer.Adam(lr, parameters=jps, weight_decay=coeff,
                                 grad_clip=jax_clip.ClipGradByGlobalNorm(1.0))
    for p, g in zip(jps, grads):
        p.grad = Tensor(jnp.asarray(g))
    jopt.step()
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = Adam(lr, parameters=tps, weight_decay=coeff,
               grad_clip=ClipGradByGlobalNorm(1.0))
    for p, g in zip(tps, grads):
        p.grad = torch.from_numpy(g.copy())
    opt.step()
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(),
                                   np.asarray(jp.value), rtol=1e-6,
                                   atol=1e-6)
    # the other order (decay folded in, then the clip) is another step
    other = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    folded = [torch.from_numpy(g) + coeff * torch.from_numpy(a)
              for g, a in zip(grads, init)]
    clipped = ClipGradByGlobalNorm(1.0)(list(zip(other, folded)))
    o2 = Adam(lr, parameters=other)
    for p, (_, g) in zip(other, clipped):
        p.grad = g
    o2.step()
    gap = max(float((a - b).detach().abs().max()) for a, b in zip(other, tps))
    assert gap > 1e-3


# (finite?) per step: runs of good steps that cross incr_every_n, single
# and back-to-back non-finite steps (inf and NaN)
PLAN = [True, True, True, False, True, True, True, True, False, False,
        True, False, True, True, True, True, True, True, False, True]


@pytest.mark.parametrize("incr,decr", [(3, 1), (2, 2)])
def test_grad_scaler_matches_the_reference(incr, decr):
    rs = np.random.RandomState(5)
    init = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    kw = dict(init_loss_scaling=2.0 ** 10, incr_ratio=2.0, decr_ratio=0.5,
              incr_every_n_steps=incr, decr_every_n_nan_or_inf=decr)
    jscaler = paddle.amp.GradScaler(**kw)
    scaler = GradScaler(**kw)
    jps = [paddle.nn.Parameter(jnp.asarray(a)) for a in init]
    jopt = paddle.optimizer.Adam(0.05, parameters=jps)
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = Adam(0.05, parameters=tps)
    for i, finite in enumerate(PLAN):
        grads = _grads(100 + i)
        if not finite:
            grads[i % len(grads)].flat[0] = np.inf if i % 2 else np.nan
        before = [p.detach().clone() for p in tps]
        states = {id(p): {k: v.clone() for k, v in st.items()}
                  for p in tps if (st := opt._accumulators.get(id(p)))}
        for jp, tp, g in zip(jps, tps, grads):
            s = np.float32(jscaler.get_loss_scaling())
            jp.grad = Tensor(jnp.asarray(g * s))
            tp.grad = torch.from_numpy(g * s)
        if finite:
            jscaler.step(jopt)
            scaler.step(opt)
        else:
            with pytest.warns(UserWarning, match="update skipped"):
                jscaler.step(jopt)
            with pytest.warns(UserWarning, match="update skipped"):
                scaler.step(opt)
        jscaler.update()
        scaler.update()
        for p in jps:
            p.clear_grad()
        opt.clear_grad()
        assert scaler.get_loss_scaling() == jscaler.get_loss_scaling(), i
        assert scaler.num_skipped_steps == jscaler.num_skipped_steps
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp.value), rtol=1e-6,
                                       atol=1e-6)
        if not finite:
            for b, p in zip(before, tps):
                assert torch.equal(b, p.detach())
            for p in tps:
                for k, v in states.get(id(p), {}).items():
                    assert torch.equal(v, opt._accumulators[id(p)][k])
    assert scaler.num_skipped_steps == PLAN.count(False)
    assert scaler.state_dict() == jscaler.state_dict()
    again = GradScaler()
    again.load_state_dict(scaler.state_dict())
    assert again.state_dict() == scaler.state_dict()


def test_grad_scaler_protocol_errors_and_disabled_path():
    p = torch.nn.Parameter(torch.ones(2))
    opt = Adam(0.1, parameters=[p])
    scaler = GradScaler(init_loss_scaling=4.0)
    loss = (p * 3.0).sum()
    scaler.scale(loss).backward()
    scaler.step(opt)
    with pytest.raises(RuntimeError, match="update"):
        scaler.step(opt)
    scaler.update()
    off = GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()
    p.grad = torch.ones(2)
    before = p.detach().clone()
    off.minimize(opt, loss)
    assert not torch.equal(before, p.detach())


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_decorate_o2_casts_what_the_reference_casts(dtype):
    jm = JaxGPT(jax_gpt_tiny())
    jax_decorate(jm, level="O2", dtype=dtype)
    want = {n: str(p.value.dtype) for n, p in jm.named_parameters()}
    pm = GPTForCausalLM(gpt_tiny(), device="cpu")
    ids = {n: id(p) for n, p in pm.named_parameters()}
    out = decorate(pm, level="O2", dtype=dtype)
    assert out is pm
    got = {n: str(p.dtype).split(".")[1] for n, p in pm.named_parameters()}
    assert got == want
    assert {n: id(p) for n, p in pm.named_parameters()} == ids
    assert got["gpt.ln_f.weight"] == "float32" and got[
        "gpt.h.0.attn.qkv_proj.weight"] == dtype
    # O1 leaves the parameters as they are; a list and an optimizer
    m2 = GPTForCausalLM(gpt_tiny(), device="cpu")
    opt = AdamW(parameters=m2.parameters())
    models, same = decorate([m2], opt, level="O1", dtype=dtype)
    assert models == [m2] and same is opt
    assert all(p.dtype == torch.float32 for p in m2.parameters())


def test_adamw_multi_precision_matches_the_reference_in_bf16():
    rs = np.random.RandomState(7)
    init = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    init16 = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in init]
    jps = [paddle.nn.Parameter(jnp.asarray(a, jnp.bfloat16)) for a in init]
    jopt = paddle.optimizer.AdamW(1e-2, parameters=jps, weight_decay=0.1,
                                  multi_precision=True)
    tps = [torch.nn.Parameter(torch.from_numpy(
        a.astype(np.float32)).to(torch.bfloat16)) for a in init16]
    names = [f"w{i}" for i in range(len(tps))]
    opt = AdamW(1e-2, parameters=list(zip(names, tps)), weight_decay=0.1,
                multi_precision=True)
    for step in range(3):
        grads = _grads(20 + step)
        for jp, tp, g in zip(jps, tps, grads):
            jp.grad = Tensor(jnp.asarray(g, jnp.bfloat16))
            tp.grad = torch.from_numpy(g).to(torch.bfloat16)
        jopt.step()
        opt.step()
        opt.clear_grad()
    for jp, tp in zip(jps, tps):
        jst = jopt._accumulators[id(jp)]
        st = opt._accumulators[id(tp)]
        assert tp.dtype == torch.bfloat16
        for slot in ("@master", "moment1", "moment2", "beta1_pow",
                     "beta2_pow"):
            assert st[slot].dtype == torch.float32, slot
            np.testing.assert_allclose(st[slot].numpy(),
                                       np.asarray(jst[slot]), rtol=1e-6,
                                       atol=1e-7)
        # the parameter is its master rounded to bf16
        assert torch.equal(tp.detach(), st["@master"].to(torch.bfloat16))
        np.testing.assert_allclose(tp.detach().float().numpy(),
                                   np.asarray(jp.value, np.float32),
                                   rtol=2 ** -8)
    sd = opt.state_dict()
    assert sd["@global_step"] == 3 and "w0.@master" in sd
    fresh = AdamW(1e-2, parameters=list(zip(names, tps)), weight_decay=0.1,
                  multi_precision=True)
    fresh.set_state_dict(sd)
    for tp in tps:
        for k, v in opt._accumulators[id(tp)].items():
            assert torch.equal(fresh._accumulators[id(tp)][k], v)
    # without multi_precision the bf16 parameter carries bf16 state
    plain = AdamW(1e-2, parameters=tps[:1])
    tps[0].grad = torch.ones(SHAPES[0], dtype=torch.bfloat16)
    plain.step()
    assert "@master" not in plain._accumulators[id(tps[0])]
    assert plain._accumulators[id(tps[0])]["moment1"].dtype == torch.bfloat16


def test_lazy_mode_and_lr_ratio_are_accepted_as_the_reference_accepts_them():
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(3))
    a = AdamW(0.1, parameters=[p], lr_ratio=lambda _: 0.5, lazy_mode=True)
    b = AdamW(0.1, parameters=[q])
    for o, t in ((a, p), (b, q)):
        t.grad = torch.full((3,), 0.3)
        o.step()
    assert torch.equal(p, q)
    assert Adam(0.1, parameters=[p], lazy_mode=True) is not None
