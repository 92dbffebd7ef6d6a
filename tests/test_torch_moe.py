"""The port's MoE (``paddle_tpu_torch/incubate/distributed/models/moe/``
and GPT-MoE in ``models/gpt.py``) against the reference's on the CPU.

Routing decisions are integers, so they must be equal exactly: the
capacity, every assignment's slot ``loc`` (capacity drops forced), and
the combine tensor's support. Routing weights, aux losses and the
combine tensor's values agree within 1e-6 (fp32 softmaxes of two
frameworks). ``MoELayer`` runs each of its four routes (the compact
plan, expert choice, the combine tensor, the heterogeneous loop; and a
non-``ExpertLayer`` stack under ``vmap``) from the reference's weights:
outputs within 1e-5, every gradient within 1e-5 of the largest. Random
routing cannot reproduce JAX's threefry stream: its keep rate of the
second choice is held to ``mean(min(1, 2 * p2))`` within 4.5 binomial
standard deviations, and its aux loss to the reference's without random
routing (the aux is taken before the drop).

``gpt_moe_tiny`` (gshard top-2, 4 experts in block 1) takes the
reference's state dict by its own keys, through ``framework/io.py``
both ways: eval logits, ``loss_with_aux`` and every gradient match
(fp32, atol 1e-4 / 1e-5), and the paged ``ServingEngine``'s greedy
tokens equal the JAX engine's exactly at the default capacity and at
``moe_capacity_factor=0.5``, where the prefill chunks drop assignments,
on full-precision pools and on int8 pools (the JAX engine with its int8
position read corrected, as in test_torch_int8.py).
Under bf16 AMP (O1 and O2) at most 5% of the routing choices differ
(near-ties the two frameworks' roundings break apart), and with the
routing pinned to the reference's the loss and gradients hold
chip_smoke's 7b bounds.
The other serving paths (dense engine, ``generate``, speculation, int8
pools) serve it; ``DistributedStrategy(moe=True)`` trains it: three
``ShardedTrainer`` steps give the JAX trainer's losses (fp32 1e-5, bf16
AMP 2e-2 relative, as the dense GPT's in test_torch_train.py).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu.core.tensor import Tensor, _no_tape
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.incubate.distributed.models.moe import gate as jgate
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import gpt as ref_gpt

import paddle_tpu_torch as paddle
from paddle_tpu_torch.incubate.distributed.models import moe
from paddle_tpu_torch.incubate.distributed.models.moe import gate as pgate
from paddle_tpu_torch.inference import (NgramDrafter, Request,
                                        ServingEngine)
from paddle_tpu_torch.models import GPTForCausalLM, gpt_moe_tiny
from paddle_tpu_torch.models import gpt as port_gpt
from test_torch_int8 import _read_jax_positions_from_t

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

D = 8


def _np(t):
    return np.asarray(t.value if hasattr(t, "value") else t)


def _state(jlayer, seed, scale=0.5):
    """Random weights for ``jlayer`` (set on it), by the reference's
    names."""
    rs = np.random.RandomState(seed)
    state = {k: rs.randn(*v.shape).astype(np.float32) * scale
             for k, v in jlayer.state_dict().items()}
    jlayer.set_state_dict(state)
    return state


def _x(s, seed=0):
    return np.random.RandomState(seed).randn(s, D).astype(np.float32)


# -- capacity and the plan arithmetic -----------------------------------------

@pytest.mark.parametrize("rate,S,E,k", [(1.2, 16, 4, 2), (2.4, 16, 4, 2),
                                        (0.5, 16, 4, 2), (1.2, 8192, 8, 2),
                                        (2.4, 8, 16, 2), (1.2, 7, 3, 1)])
def test_capacity_equals_the_reference(rate, S, E, k):
    assert pgate._capacity(rate, S, E, k) == jgate._capacity(rate, S, E, k)


PLAN_CASES = [(24, 2, 4, 4), (24, 2, 4, 16), (30, 1, 3, 5), (17, 2, 5, 4)]


@pytest.mark.parametrize("S,K,E,C", PLAN_CASES)
def test_plan_and_combine_equal_the_reference(S, K, E, C):
    """Random assignments with dropped choices (-1) and, at the smaller
    capacities, capacity drops: ``loc``, ``w`` and the combine tensor are
    the reference's exactly."""
    rs = np.random.RandomState(S + C)
    idx = rs.randint(-1, E, (S, K)).astype(np.int32)
    val = rs.rand(S, K).astype(np.float32)
    jloc, jw = jgate._build_plan(jnp.asarray(idx), jnp.asarray(val), E, C)
    ploc, pw = pgate._build_plan(torch.from_numpy(idx),
                                 torch.from_numpy(val), E, C)
    np.testing.assert_array_equal(ploc.numpy(), np.asarray(jloc))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    jc = jgate._build_combine(jnp.asarray(idx), jnp.asarray(val), E, C)
    pc = pgate._build_combine(torch.from_numpy(idx), torch.from_numpy(val),
                              E, C)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    if C == 4:
        assert (ploc.numpy() == E * C).sum() > (idx < 0).sum()


# -- the gates -------------------------------------------------------------

def _gate_pair(kind, seed, training, capacity=(0.3, 0.3)):
    ref.seed(seed)
    if kind == "naive":
        jg = jgate.NaiveGate(D, 4, topk=2, capacity=capacity)
        pg = pgate.NaiveGate(D, 4, topk=2, capacity=capacity, device="cpu")
    elif kind == "gshard":
        jg = jgate.GShardGate(D, 4, capacity=capacity, random_routing=False)
        pg = pgate.GShardGate(D, 4, capacity=capacity, random_routing=False,
                              device="cpu")
    else:
        jg = jgate.SwitchGate(D, 4, capacity=capacity)
        pg = pgate.SwitchGate(D, 4, capacity=capacity, device="cpu")
    pg.set_state_dict(_state(jg, seed))
    jg.train() if training else jg.eval()
    pg.train(training)
    return jg, pg


GATE_CASES = [("naive", False), ("naive", True), ("gshard", False),
              ("gshard", True), ("switch", False)]


@pytest.mark.parametrize("kind,training", GATE_CASES)
def test_gate_plan_and_combine_equal_the_reference(kind, training):
    """Capacity 0.3 of the balanced load forces drops: the plan's slots
    are the reference's exactly, the weights and the aux loss within
    1e-6, the combine tensor's support exact."""
    jg, pg = _gate_pair(kind, 3, training)
    x = _x(32, seed=4)
    jloc, jw, jC, jaux = jg.dispatch_plan(Tensor(jnp.asarray(x)))
    with torch.no_grad():
        ploc, pw, pC, paux = pg.dispatch_plan(torch.from_numpy(x))
        pcomb, paux2 = pg.dispatch_info(torch.from_numpy(x))
    jcomb, _ = jg.dispatch_info(Tensor(jnp.asarray(x)))
    assert pC == jC
    np.testing.assert_array_equal(ploc.numpy(), _np(jloc))
    assert (ploc.numpy() == 4 * pC).any()        # drops were forced
    np.testing.assert_allclose(pw.numpy(), _np(jw), atol=1e-6)
    np.testing.assert_array_equal(pcomb.numpy() > 0, _np(jcomb) > 0)
    np.testing.assert_allclose(pcomb.numpy(), _np(jcomb), atol=1e-6)
    np.testing.assert_allclose(float(paux), float(_np(jaux)), atol=1e-6)
    np.testing.assert_allclose(float(paux2), float(_np(jaux)), atol=1e-6)


def test_naive_gate_forward_equals_the_reference():
    jg, pg = _gate_pair("naive", 5, False)
    x = _x(16, seed=6)
    jv, ji, js = jg(Tensor(jnp.asarray(x)), return_all_scores=True)
    pv, pi, ps = pg(torch.from_numpy(x), True)
    np.testing.assert_array_equal(pi.numpy(), _np(ji))
    np.testing.assert_allclose(pv.detach().numpy(), _np(jv), atol=1e-6)
    np.testing.assert_allclose(ps.detach().numpy(), _np(js), atol=1e-6)


def test_gshard_random_routing_keeps_the_second_choice_at_2p2():
    """In training, the second choice survives with probability min(1,
    2 p2): the kept count over 4096 tokens sits within 4.5 binomial
    standard deviations of the sum of those probabilities; first choices
    are never dropped; eval routes without random drops; the aux loss is
    the reference's without random routing (taken before the drop)."""
    ref.seed(7)
    jg = jgate.GShardGate(D, 4, random_routing=False)
    pg = pgate.GShardGate(D, 4, device="cpu")
    pg.set_state_dict(_state(jg, 7, scale=0.2))
    x = _x(4096, seed=8)
    torch.manual_seed(0)
    with torch.no_grad():
        idx, _, aux = pg.train()._routed(torch.from_numpy(x))
        probs = torch.softmax(pg.gate(torch.from_numpy(x)), dim=-1)
        idx_eval, _, _ = pg.eval()._routed(torch.from_numpy(x))
    p2 = torch.sort(probs, dim=-1, descending=True).values[:, 1].numpy()
    keep = np.minimum(1.0, 2.0 * p2)
    kept = int((idx[:, 1] >= 0).sum())
    sd = float(np.sqrt((keep * (1 - keep)).sum()))
    assert abs(kept - keep.sum()) <= 4.5 * sd, (kept, keep.sum(), sd)
    assert 0 < kept < len(x)
    assert bool((idx[:, 0] >= 0).all()) and bool((idx_eval >= 0).all())
    jg.train()
    jaux = jg._routed(Tensor(jnp.asarray(x)))[2]
    np.testing.assert_allclose(float(aux), float(_np(jaux)), atol=1e-6)


def test_switch_jitter_scales_the_input_within_eps():
    """Switch's training jitter is uniform in (1 - eps, 1 + eps): with a
    bias-free gate of one expert row set to a unit vector, the logit of
    that expert over the token's coordinate is its jittered value."""
    pg = pgate.SwitchGate(D, 2, switch_eps=0.25, device="cpu").train()
    with torch.no_grad():
        pg.gate.weight.zero_()
        pg.gate.weight[0, 0] = 1.0
        pg.gate.bias.zero_()
    seen = []
    real = pg.gate.forward
    pg.gate.forward = lambda x: seen.append(x) or real(x)
    x = torch.ones(2048, D)
    pg._routed(x)
    j = seen[0]
    assert float(j.min()) >= 0.75 and float(j.max()) <= 1.25
    assert abs(float(j.mean()) - 1.0) < 0.01 and float(j.std()) > 0.1


def test_expert_choice_gate_equals_the_reference_with_ties():
    """Expert choice's picks (``dispatch_plan_ec``) are the reference's,
    with the lower token first among identical rows (a stable sort, as
    ``lax.top_k``); the combine tensor too."""
    ref.seed(9)
    jg = jgate.ExpertChoiceGate(D, 4, capacity_factor=2.0)
    pg = pgate.ExpertChoiceGate(D, 4, capacity_factor=2.0, device="cpu")
    pg.set_state_dict(_state(jg, 9))
    x = _x(16, seed=10)
    x[5] = x[2]
    x[11] = x[2]                     # three identical tokens: ties
    jidx, jval, _ = jg.dispatch_plan_ec(Tensor(jnp.asarray(x)))
    with torch.no_grad():
        pidx, pval, paux = pg.dispatch_plan_ec(torch.from_numpy(x))
        pcomb, _ = pg.dispatch_info(torch.from_numpy(x))
    jcomb, _ = jg.dispatch_info(Tensor(jnp.asarray(x)))
    assert pg.capacity_for(16) == jg.capacity_for(16) == 8
    assert pg.capacity_for(3) == 1 and pg.capacity_for(1) == 1
    np.testing.assert_array_equal(pidx.numpy(), _np(jidx))
    np.testing.assert_allclose(pval.numpy(), _np(jval), atol=1e-6)
    np.testing.assert_allclose(pcomb.numpy(), _np(jcomb), atol=1e-6)
    assert float(paux) == 0.0
    tied = [row for row in pidx.numpy().tolist() if 2 in row and 5 in row]
    assert tied and all(r.index(2) < r.index(5) for r in tied)


# -- MoELayer: the four routes -------------------------------------------------

class _JaxWide(ref.nn.Layer):
    def __init__(self, d):
        super().__init__()
        self.fc = ref.nn.Linear(d, d)

    def forward(self, x):
        return self.fc(x)


class _PortWide(paddle.nn.Layer):
    def __init__(self, d):
        super().__init__()
        self.fc = paddle.nn.Linear(d, d, device="cpu")

    def forward(self, x):
        return self.fc(x)


def _layer_pair(route, seed=11):
    ref.seed(seed)
    gate = {"type": "gshard", "top_k": 2, "capacity": (0.6, 0.6)}
    if route == "expert_choice":
        jg = jgate.ExpertChoiceGate(D, 4)
        pg = pgate.ExpertChoiceGate(D, 4, device="cpu")
        jm = jmoe.MoELayer(D, [jmoe.ExpertLayer(D, 16) for _ in range(4)],
                           gate=jg)
        pm = moe.MoELayer(D, [moe.ExpertLayer(D, 16, device="cpu")
                              for _ in range(4)], gate=pg)
    elif route == "hetero":
        gate = {"type": "naive", "top_k": 1}
        jm = jmoe.MoELayer(D, [jmoe.ExpertLayer(D, 16), _JaxWide(D)],
                           gate=gate)
        pm = moe.MoELayer(D, [moe.ExpertLayer(D, 16, device="cpu"),
                              _PortWide(D)], gate=gate)
    elif route == "vmap":
        jm = jmoe.MoELayer(D, [_JaxWide(D) for _ in range(4)], gate=gate)
        pm = moe.MoELayer(D, [_PortWide(D) for _ in range(4)], gate=gate)
    else:          # "plan" and "combine" (the allreduce mode)
        jm = jmoe.MoELayer(D, [jmoe.ExpertLayer(D, 16) for _ in range(4)],
                           gate=gate)
        pm = moe.MoELayer(D, [moe.ExpertLayer(D, 16, device="cpu")
                              for _ in range(4)], gate=gate)
    pm.set_state_dict(_state(jm, seed))
    for m in (jm, pm):
        m.eval()
    return jm, pm


ROUTES = ["plan", "combine", "expert_choice", "hetero", "vmap"]


@pytest.mark.parametrize("route", ROUTES)
def test_moe_layer_route_equals_the_reference(route):
    """Output and every gradient (the input's included) of each route,
    from the reference's weights, on (4, 6, d) tokens (capacity drops at
    0.6 in the gshard routes)."""
    jm, pm = _layer_pair(route)
    x = np.random.RandomState(12).randn(4, 6, D).astype(np.float32)
    w = np.random.RandomState(13).randn(4, 6, D).astype(np.float32)
    mode = "allreduce" if route == "combine" else "alltoall"

    def jloss(params, xv):
        with _no_tape(), jmoe.moe_dispatch_mode(mode):
            out = jm.functional_call(params, Tensor(xv)).value
        return jnp.sum(out * w), out

    names = [n for n, _ in jm.named_parameters()]
    (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        {n: p.value for n, p in jm.named_parameters()}, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    with moe.moe_dispatch_mode(mode):
        out = pm(xt)
    (out * torch.from_numpy(w)).sum().backward()
    assert (pm.experts is None) == (route != "hetero")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    pgrads = dict(pm.named_parameters())
    assert sorted(pgrads) == sorted(names)
    for n in names:
        want = np.asarray(jg[n])
        np.testing.assert_allclose(pgrads[n].grad.numpy(), want,
                                   atol=1e-5 * max(1.0, np.abs(want).max()),
                                   err_msg=n)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-5)


def test_stacked_parameters_carry_the_reference_names_and_flags():
    jm, pm = _layer_pair("plan")
    shapes = {n: tuple(p.shape) for n, p in pm.named_parameters()}
    assert shapes == {n: tuple(p.shape) for n, p in jm.named_parameters()}
    assert shapes["htoh4__weight"] == (4, D, 16)
    assert shapes["h4toh__bias"] == (4, D)
    assert all(getattr(p, "is_expert", False) for n, p in
               pm.named_parameters() if not n.startswith("gate."))
    assert moe.get_moe_dispatch_mode() == "alltoall"
    with pytest.raises(ValueError, match="unknown mode"):
        with moe.moe_dispatch_mode("ring"):
            pass


def test_custom_gate_with_only_dispatch_info_takes_the_combine_route():
    """A BaseGate with only ``dispatch_info`` drives the stacked experts
    through the combine tensor: the same output as the allreduce mode."""
    _, pm = _layer_pair("plan")
    inner = pm.gate

    class OnlyInfo(pgate.BaseGate):
        def __init__(self):
            super().__init__(4, 1)
            self.inner = inner

        def dispatch_info(self, x):
            return self.inner.dispatch_info(x)

    x = torch.from_numpy(np.random.RandomState(14).randn(24, D)
                         .astype(np.float32))
    with moe.moe_dispatch_mode("allreduce"):
        want = pm(x)
    pm.gate = OnlyInfo()
    torch.testing.assert_close(pm(x), want, rtol=0, atol=0)


def test_recompute_interval_gives_the_same_output_and_gradients():
    _, pm = _layer_pair("plan")
    x = np.random.RandomState(15).randn(24, D).astype(np.float32)
    res = []
    for interval in (0, 1):
        pm.recompute_interval = interval
        xt = torch.from_numpy(x).requires_grad_()
        out = pm(xt)
        out.square().sum().backward()
        res.append((out.detach(), xt.grad,
                    [p.grad.clone() for p in pm.parameters()]))
        pm.zero_grad()
    torch.testing.assert_close(res[0][0], res[1][0], rtol=0, atol=0)
    torch.testing.assert_close(res[0][1], res[1][1], rtol=0, atol=0)
    for a, b in zip(res[0][2], res[1][2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_expert_parallelism_and_the_moe_pipeline_refuse_naming_item_6():
    group = types.SimpleNamespace(nranks=2, axis_name="mp")
    experts = [moe.ExpertLayer(D, 16, device="cpu") for _ in range(2)]
    for build in (lambda: moe.MoELayer(D, experts, moe_group=group),
                  lambda: pgate.GShardGate(D, 2, group=group, device="cpu"),
                  lambda: pgate.SwitchGate(D, 2, group=group, device="cpu"),
                  lambda: moe.ClipGradForMOEByGlobalNorm(1.0,
                                                         moe_group=group),
                  lambda: port_gpt.GPTForCausalLMPipe(gpt_moe_tiny(), 2, 2)):
        with pytest.raises(NotImplementedError, match="item 6"):
            build()
    one = types.SimpleNamespace(nranks=1, axis_name="mp")
    assert moe.MoELayer(D, experts, moe_group=one).world_size == 1


def test_entry_points_default_to_the_card():
    for build in (lambda: moe.ExpertLayer(D, 16),
                  lambda: pgate.NaiveGate(D, 4),
                  lambda: GPTForCausalLM(gpt_moe_tiny())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


# -- the clip ------------------------------------------------------------------

def test_moe_clip_equals_the_reference():
    """Expert and normal sums of squares combine into one coefficient;
    ``need_clip=False`` and gradient-less pairs pass through; a custom
    ``is_expert_param_func`` is honoured."""
    rs = np.random.RandomState(16)
    specs = [(True, True), (False, True), (True, True), (False, False),
             (False, True)]
    grads = [rs.randn(3, 4).astype(np.float32) * 2 for _ in specs]

    def params():
        return [types.SimpleNamespace(is_expert=e, need_clip=c, i=i)
                for i, (e, c) in enumerate(specs)]

    for func in (None, lambda p: p.i == 4):
        jp, pp = params(), params()
        jout = jmoe.ClipGradForMOEByGlobalNorm(1.5, func)(
            [(p, Tensor(jnp.asarray(g))) for p, g in zip(jp, grads)]
            + [(types.SimpleNamespace(), None)])
        pout = moe.ClipGradForMOEByGlobalNorm(1.5, func)(
            [(p, torch.from_numpy(g)) for p, g in zip(pp, grads)]
            + [(types.SimpleNamespace(), None)])
        assert pout[-1][1] is None
        for (_, a), (_, b), g in zip(pout, jout, grads):
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6)
        coef = pout[0][1].numpy() / grads[0]
        jcoef = _np(jout[0][1]) / grads[0]
        np.testing.assert_allclose(coef, jcoef, rtol=1e-6)
        assert np.all(coef < 1.0)
        np.testing.assert_array_equal(pout[3][1].numpy(), grads[3])


# -- gpt_moe_tiny ------------------------------------------------------------

def _jax_moe_model(seed=1, cap=None):
    cfg = ref_gpt.gpt_moe_tiny()
    cfg.moe_capacity_factor = cap
    ref.seed(0)
    jm = ref.models.GPTForCausalLM(cfg)
    rs = np.random.RandomState(seed)
    state = {}
    for k, v in jm.state_dict().items():
        a = rs.randn(*v.shape).astype(np.float32) * (0.3 if v.ndim >= 2
                                                     else 0.1)
        if ".ln_" in k and k.endswith("weight"):
            a += 1.0
        state[k] = a
    jm.set_state_dict(state)
    return jm


def _port_from(jm, tmp_path, cap=None):
    """The port's gpt_moe_tiny from the reference's state dict, written
    by the reference's ``paddle.save`` and read by the port's
    ``paddle.load``."""
    path = str(tmp_path / "ref.pdparams")
    ref.save(jm.state_dict(), path)
    cfg = gpt_moe_tiny()
    cfg.moe_capacity_factor = cap
    pm = GPTForCausalLM(cfg, device="cpu", seed=3)
    pm.set_state_dict(paddle.load(path, return_numpy=True))
    return pm


def test_gpt_moe_configs_and_the_placement_rule():
    pm = GPTForCausalLM(gpt_moe_tiny(), device="cpu")
    assert gpt_moe_tiny().num_params() == 124672
    kinds = [type(b.mlp).__name__ for b in pm.gpt.h]
    assert kinds == ["GPTMLP", "GPTMoEMLP"]
    cfg = port_gpt.gpt_moe_1p3b()
    assert (cfg.num_experts, cfg.moe_every_k, cfg.num_layers) == (16, 2, 24)
    assert [i for i in range(24) if i % 2 == 1] == [
        i for i in range(24) if i % cfg.moe_every_k == cfg.moe_every_k - 1]


def test_gpt_moe_logits_loss_and_gradients_equal_the_reference(tmp_path):
    """Eval logits (default capacity); training ``loss_with_aux`` and
    every gradient with random routing off on both sides (training
    capacity binds at S = 64: drops included). The port's state dict
    read back by the reference equals it exactly."""
    jm = _jax_moe_model()
    pm = _port_from(jm, tmp_path)
    back = str(tmp_path / "port.pdparams")
    paddle.save(pm.state_dict(), back)
    for k, v in ref.load(back).items():
        np.testing.assert_array_equal(_np(v), _np(jm.state_dict()[k]))
    ids = np.random.RandomState(2).randint(0, 256, (2, 32)).astype(np.int32)
    params = {n: p.value for n, p in jm.named_parameters()}
    for m in list(jm.sublayers()) + list(pm.modules()):
        if hasattr(m, "random_routing"):
            m.random_routing = False

    def logits_of(p, x):
        with _no_tape():
            return jm.functional_call(p, Tensor(x)).value

    jm.eval()
    pm.eval()
    jl = jax.jit(logits_of)(params, jnp.asarray(ids))
    ids_t = torch.from_numpy(ids).long()
    with torch.no_grad():
        np.testing.assert_allclose(pm(ids_t).numpy(), np.asarray(jl),
                                   atol=1e-4)

    def loss_of(p, x):
        with _no_tape():
            lg = jm.functional_call(p, Tensor(x))
            return jm.loss_with_aux(lg, Tensor(x)).value

    jm.train()
    pm.train()
    jloss, jg = jax.jit(jax.value_and_grad(loss_of))(params,
                                                     jnp.asarray(ids))
    loss = pm.loss_with_aux(pm(ids_t), ids_t)
    assert all(b.mlp.moe.gate.get_loss(clear=False) is None
               for b in pm.gpt.h[1:])
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    for n, p in pm.named_parameters():
        want = np.asarray(jg[n])
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_gpt_moe_bf16_amp_matches_the_reference(level, tmp_path):
    """Under bf16 AMP (O1, and O2 after ``decorate``) the gate's Linear
    and the experts' bmms run in bf16, the gate's softmax in fp32. Two
    frameworks' bf16 roundings can flip a near-tied routing choice, so:
    at most 5% of the 128 assignments differ from the reference's; and
    with the routing pinned to the reference's choices (the port's gate
    then weighs them from its own fp32 softmax), ``loss_with_aux`` and
    every gradient agree within chip_smoke's 7b bounds (loss 2·2e-2·√L
    relative, each gradient 2·2e-2·√(2L) in norm, floored at their rms;
    L = 2), each gradient in the reference's dtype."""
    from paddle_tpu.amp import auto_cast as jax_auto_cast
    from paddle_tpu.amp.auto_cast import decorate as jax_decorate

    from paddle_tpu_torch.amp import auto_cast, decorate

    jm = _jax_moe_model(seed=7)
    pm = _port_from(jm, tmp_path)
    for m in list(jm.sublayers()) + list(pm.modules()):
        if hasattr(m, "random_routing"):
            m.random_routing = False
    if level == "O2":
        jax_decorate(jm, level="O2", dtype="bfloat16")
        decorate(pm, level="O2", dtype="bfloat16")
    jm.train()
    pm.train()
    (jg_,) = [m for m in jm.sublayers() if isinstance(m, jgate.GShardGate)]
    (pg_,) = [m for m in pm.modules() if isinstance(m, pgate.GShardGate)]
    routed = []
    real_j = jg_._routed
    jg_._routed = lambda x: routed.append(real_j(x)) or routed[-1]
    ids = np.random.RandomState(8).randint(0, 256, (2, 32)).astype(np.int32)

    def loss_of(p, x):
        with _no_tape(), jax_auto_cast(level=level, dtype="bfloat16"):
            lg = jm.functional_call(p, Tensor(x))
            loss = jm.loss_with_aux(lg, Tensor(x)).value
        return loss.astype(jnp.float32), routed[-1][0].value

    (jloss, jidx), jg = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        {n: p.value for n, p in jm.named_parameters()}, jnp.asarray(ids))
    jidx = torch.from_numpy(np.array(jidx)).long()
    ids_t = torch.from_numpy(ids).long()
    real_p = pg_._routed
    own = []
    pg_._routed = lambda x: own.append(real_p(x)) or own[-1]
    with torch.no_grad(), auto_cast(level=level, dtype="bfloat16"):
        pm(ids_t)
    assert float((own[-1][0].long() != jidx).float().mean()) <= 0.05

    def pinned(x):
        _, _, aux = real_p(x)
        logits = pg_.gate(x)
        val = torch.softmax(logits.float(), dim=-1).gather(1, jidx)
        w = val / val.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        return jidx.int(), w.to(logits.dtype), aux

    pg_._routed = pinned
    with auto_cast(level=level, dtype="bfloat16"):
        loss = pm.loss_with_aux(pm(ids_t), ids_t).float()
    loss.backward()
    L = 2
    assert abs(loss.item() - float(jloss)) <= 2 * 2e-2 * L ** 0.5 * abs(
        float(jloss))
    named = dict(pm.named_parameters())
    want = {n: np.asarray(g, np.float32) for n, g in jg.items()}
    floor = np.sqrt(np.mean([np.sum(w ** 2) for w in want.values()]))
    for n, w in want.items():
        got = named[n].grad
        assert str(got.dtype).split(".")[-1] == str(jg[n].dtype), n
        err = np.linalg.norm(got.float().numpy() - w)
        assert err <= 2 * 2e-2 * (2 * L) ** 0.5 * max(np.linalg.norm(w),
                                                       floor), n


def _drops(pm):
    """Count the assignments each MoE forward drops (the plan's dummy
    slot), by chunk size."""
    seen = []
    for blk in pm.gpt.h:
        if hasattr(blk.mlp, "moe"):
            g = blk.mlp.moe.gate
            real = g.dispatch_plan

            def plan(x, real=real):
                loc, w, C, aux = real(x)
                seen.append((x.shape[0],
                             int((loc == 4 * C).sum())))
                return loc, w, C, aux

            g.dispatch_plan = plan
    return seen


def _engine_parity(cap, tmp_path, kv_dtype=None):
    jm = _jax_moe_model(seed=1, cap=cap)
    pm = _port_from(jm, tmp_path, cap=cap)
    prompts = [[5, 9, 2], [7, 3, 9, 11, 2, 5, 8, 4] * 3, list(range(1, 30))]
    kw = dict(max_batch_slots=2, max_len=64, top_k=1, prefill_chunk=16,
              block_size=16, kv_dtype=kv_dtype)
    jeng = JaxEngine(jm, **kw)
    jreqs = [jeng.submit(JaxRequest(prompt=p, max_new_tokens=8,
                                    greedy=True)) for p in prompts]
    jeng.run(max_steps=400)
    seen = _drops(pm)
    peng = ServingEngine(pm, device="cpu", **kw)
    preqs = [peng.submit(Request(prompt=p, max_new_tokens=8, greedy=True))
             for p in prompts]
    peng.run(max_steps=400)
    assert all(r.status == "done" for r in jreqs + preqs)
    assert [r.tokens for r in preqs] == [r.tokens for r in jreqs]
    chunk_drops = sum(d for s, d in seen if s == 16)
    assert (chunk_drops > 0) == (cap == 0.5), seen
    assert sum(d for s, d in seen if s == 2) == 0     # decode never drops


@pytest.mark.parametrize("cap", [None, 0.5])
def test_paged_engine_serves_the_jax_engines_tokens(cap, tmp_path):
    """Greedy tokens of the paged engine (2 slots, chunk 16, blocks of
    16) equal the JAX engine's; at capacity factor 0.5 (C = 4 for a
    16-row chunk) the prefill chunks drop assignments."""
    _engine_parity(cap, tmp_path)


@pytest.mark.parametrize("cap", [None, 0.5])
def test_paged_engine_on_int8_pools_serves_the_jax_engines_tokens(
        cap, tmp_path, monkeypatch):
    """The same on int8 pools, against the JAX engine's int8 pools: the
    MoE blocks route rows computed from dequantized K/V. The JAX model
    reads its int8 positions from the wrong element of the cache tuple
    (a reference fault, pinned in test_torch_int8.py): the JAX engine
    runs with that one read corrected."""
    _read_jax_positions_from_t(monkeypatch)
    _engine_parity(cap, tmp_path, kv_dtype="int8")


def test_every_serving_path_serves_gpt_moe():
    """At the default capacity no row is dropped, so a token's output is
    independent of the rows beside it: the dense engine, speculation,
    ``generate`` (concat caches and the cached dense engine) give the
    paged engine's greedy tokens; int8 pools serve every request."""
    pm = GPTForCausalLM(gpt_moe_tiny(), device="cpu", seed=5)
    prompts = [[5, 9, 2, 7], [7, 3, 9, 11, 2, 5, 8, 4] * 2]
    out = {}
    for name, kw in (("paged", dict(block_size=16)), ("dense", {}),
                     ("spec", dict(block_size=16, spec=NgramDrafter(k=3))),
                     ("int8", dict(block_size=16, kv_dtype="int8"))):
        eng = ServingEngine(pm, max_batch_slots=2, max_len=64, top_k=1,
                            prefill_chunk=16, device="cpu", **kw)
        reqs = [eng.submit(Request(prompt=p, max_new_tokens=6, greedy=True))
                for p in prompts]
        eng.run(max_steps=400)
        assert all(r.status == "done" for r in reqs), name
        out[name] = [r.tokens for r in reqs]
    assert out["dense"] == out["paged"] == out["spec"]
    assert all(len(t) == 6 for t in out["int8"])
    ids = torch.tensor([prompts[0]])
    for kw in (dict(use_cache=True), dict(use_cache=False), dict(jit=True)):
        got = pm.generate(ids, 6, top_k=1, **kw)[0, 4:].tolist()
        assert got == out["paged"][0], kw


def test_strategy_moe_trains_gpt_moe_on_one_device():
    """``DistributedStrategy(moe=True)`` is accepted (the reference's
    trainer never reads it): ``loss_with_aux`` through the trainer equals
    the same steps by hand on a copy, and the loss falls."""
    from paddle_tpu_torch.distributed import (DistributedStrategy,
                                              ShardedTrainer)
    from paddle_tpu_torch.optimizer import AdamW

    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (2, 32)))
    runs = []
    for use_trainer in (True, False):
        torch.manual_seed(0)
        pm = GPTForCausalLM(gpt_moe_tiny(), device="cpu", seed=4)
        pm.train()
        opt = AdamW(learning_rate=1e-2, parameters=pm.parameters())
        tr = ShardedTrainer(pm, opt, pm.loss_with_aux,
                            strategy=DistributedStrategy(moe=True))
        losses = []
        for _ in range(4):
            if use_trainer:
                losses.append(float(tr.train_step(ids, ids)))
            else:
                loss = pm.loss_with_aux(pm(ids), ids)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(float(loss))
        runs.append(losses)
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]


@pytest.mark.parametrize("amp,rtol", [(False, 1e-5), (True, 2e-2)])
def test_strategy_moe_steps_match_the_jax_trainer(amp, rtol):
    """Three ``train_step``s of ``gpt_moe_tiny`` (dropout 0, random
    routing off, so both route from the same numbers) under
    ``DistributedStrategy(moe=True)`` with ``loss_with_aux`` and AdamW:
    the losses equal the JAX ``ShardedTrainer``'s within the dense GPT's
    bounds (test_torch_train.py), fp32 and bf16 AMP, and fall."""
    from paddle_tpu.distributed import DistributedStrategy as JaxStrategy
    from paddle_tpu.distributed import ShardedTrainer as JaxTrainer
    from paddle_tpu.distributed import build_mesh

    from paddle_tpu_torch.distributed import (DistributedStrategy,
                                              ShardedTrainer)
    from paddle_tpu_torch.optimizer import AdamW

    def no_random(m, moe_layer):
        for sub in m.sublayers() if hasattr(m, "sublayers") else m.modules():
            if isinstance(sub, moe_layer):
                sub.gate.random_routing = False

    cfg = ref_gpt.gpt_moe_tiny()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    ref.seed(12)
    jm = ref.models.GPTForCausalLM(cfg)
    no_random(jm, jmoe.MoELayer)
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    jm.train()
    mesh = build_mesh([1, 1, 1, 1], ["dp", "pp", "sharding", "mp"],
                      devices=np.array(jax.devices()[:1]))
    jopt = ref.optimizer.AdamW(learning_rate=1e-3,
                               parameters=jm.parameters(), weight_decay=0.01)
    jt = JaxTrainer(jm, jopt, jm.loss_with_aux, mesh,
                    strategy=JaxStrategy(moe=True), amp=amp)
    pcfg = gpt_moe_tiny()
    pcfg.hidden_dropout = pcfg.attention_dropout = 0.0
    pm = GPTForCausalLM(pcfg, device="cpu", seed=0)
    no_random(pm, moe.MoELayer)
    pm.set_state_dict(state)
    pm.train()
    popt = AdamW(learning_rate=1e-3, parameters=pm.parameters(),
                 weight_decay=0.01)
    pt = ShardedTrainer(pm, popt, pm.loss_with_aux,
                        strategy=DistributedStrategy(moe=True), amp=amp)
    ids = np.random.RandomState(7).randint(0, 256, (2, 64)).astype(np.int32)
    labels = ids.astype(np.int64)
    want = [float(np.asarray(jt.train_step(ids, labels))) for _ in range(3)]
    got = [float(pt.train_step(ids, labels)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert got[-1] < got[0]
