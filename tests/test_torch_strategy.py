"""The port's ``DistributedStrategy``, gradient merge, ``SGD`` /
``Momentum`` and ``ShardedTrainer``'s eval/predict against the JAX
package.

- ``DistributedStrategy`` round-trips to the reference's dict, field for
  field, whether configs come as dataclasses or dicts.
- ``SGD`` and ``Momentum`` (plain and Nesterov) take three updates equal
  to the JAX rules' ``_update`` (the same fp32 operations: exact).
- Gradient merge (``k_steps`` 4, ``avg`` True and False, SGD, gpt_tiny):
  each micro-step's loss and the parameters after two merged windows
  equal the JAX trainer's up to summation order (losses rtol 1e-5; the
  parameters atol 1e-6 after 0.1 x a gradient that differs by ~1e-6),
  and a merged window equals one step on the whole batch, as the
  reference's own test holds (atol 1e-5).
- ``eval_step``/``predict_step`` on gpt_tiny with 0.1 dropouts equal the
  JAX trainer's (dropout off; loss rtol 1e-5, logits atol 2e-5) and leave
  every sublayer training; ``step_count`` and ``optimizer_state_bytes``
  equal the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import ShardedTrainer as JaxTrainer
from paddle_tpu.distributed import build_mesh
from paddle_tpu.distributed.strategy import \
    DistributedStrategy as JaxStrategy
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.optimizer import SGD as JaxSGD

from paddle_tpu_torch.distributed import DistributedStrategy, ShardedTrainer
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.optimizer import SGD, AdamW, Momentum

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)


def _mesh1():
    return build_mesh([1, 1, 1, 1], ["dp", "pp", "sharding", "mp"],
                      devices=np.array(jax.devices()[:1]))


def _configure(st):
    st.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    st.sharding = True
    st.sharding_configs = {"stage": 2, "degree": 2}
    st.gradient_merge = True
    st.gradient_merge_configs = {"k_steps": 4, "avg": False}
    st.amp_configs = {"level": "O2"}
    st.recompute_configs.checkpoints = ["h.0"]
    return st


def test_strategy_round_trips_as_the_reference():
    assert DistributedStrategy().to_dict() == JaxStrategy().to_dict()
    mine, ref = _configure(DistributedStrategy()), _configure(JaxStrategy())
    assert mine.to_dict() == ref.to_dict()
    assert mine.hybrid_configs.world == ref.hybrid_configs.world == 4
    kw = dict(gradient_merge=True, gradient_merge_configs={"k_steps": 3},
              moe_configs={"num_experts": 8}, lars_configs={"epsilon": 0.1})
    assert DistributedStrategy(**kw).to_dict() == JaxStrategy(**kw).to_dict()
    assert fleet.DistributedStrategy is DistributedStrategy
    assert repr(mine).startswith("DistributedStrategy{")


@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov"])
def test_three_updates_match_jax_update_rule(kind):
    rs = np.random.RandomState(3)
    init = {"w": rs.randn(4, 3).astype(np.float32),
            "b": rs.randn(3).astype(np.float32)}
    grads = [{n: rs.randn(*a.shape).astype(np.float32)
              for n, a in init.items()} for _ in range(3)]
    lr = 0.1
    tp = {n: torch.nn.Parameter(torch.from_numpy(a.copy()))
          for n, a in init.items()}
    if kind == "sgd":
        opt = SGD(lr, parameters=list(tp.items()))
        rule, hyper = JaxSGD._update, {}
    else:
        nesterov = kind == "nesterov"
        opt = Momentum(lr, 0.8, parameters=list(tp.items()),
                       use_nesterov=nesterov)
        rule, hyper = JaxMomentum._update, dict(momentum=0.8,
                                                nesterov=nesterov)
    jp = {n: jnp.asarray(a) for n, a in init.items()}
    js = {n: ({} if kind == "sgd" else {"velocity": jnp.zeros_like(a)})
          for n, a in jp.items()}
    for gs in grads:
        for n, p in tp.items():
            p.grad = torch.from_numpy(gs[n])
        opt.step()
        opt.clear_grad()
        for n in jp:
            jp[n], js[n] = rule(jp[n], jnp.asarray(gs[n]), js[n],
                                jnp.asarray(lr, jnp.float32), **hyper)
        for n, p in tp.items():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          np.asarray(jp[n]))
            for slot, val in js[n].items():
                np.testing.assert_array_equal(
                    opt._accumulators[id(p)][slot].numpy(), np.asarray(val))


def _gpt_pair(dropout=0.0):
    """A JAX gpt_tiny and the port's on the same weights."""
    paddle.seed(11)
    cfg = jax_gpt_tiny()
    cfg.hidden_dropout = cfg.attention_dropout = dropout
    jm = JaxGPT(cfg)
    jm.train()
    pcfg = gpt_tiny()
    pcfg.hidden_dropout = pcfg.attention_dropout = dropout
    pm = GPTForCausalLM(pcfg, device="cpu")
    pm.set_state_dict({k: np.asarray(v.value)
                       for k, v in jm.state_dict().items()})
    pm.train()
    return jm, pm


def _merge_strategy(cls, avg):
    st = cls()
    st.gradient_merge = True
    st.gradient_merge_configs = {"k_steps": 4, "avg": avg}
    return st


@pytest.mark.parametrize("avg", [True, False])
def test_gradient_merge_matches_jax_trainer(avg):
    """Two windows of 4 micro-batches of 2 x 32: each loss, the step
    counts and the parameters after each window equal the JAX
    trainer's."""
    lr = 0.1 if avg else 0.02
    jm, pm = _gpt_pair()
    jt = JaxTrainer(jm, paddle.optimizer.SGD(
        learning_rate=lr, parameters=jm.parameters()), None, _mesh1(),
        strategy=_merge_strategy(JaxStrategy, avg))
    pt = ShardedTrainer(pm, SGD(lr, parameters=pm.parameters()), None,
                        strategy=_merge_strategy(DistributedStrategy, avg))
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, (16, 32)).astype(np.int32)
    labels = ids.astype(np.int64)
    start = {n: p.detach().clone() for n, p in pt.param_tensors.items()}
    for w in range(2):
        jl, pl = [], []
        for i in range(4):
            rows = slice(8 * w + 2 * i, 8 * w + 2 * i + 2)
            jl.append(float(np.asarray(jt.train_step(ids[rows],
                                                     labels[rows]))))
            pl.append(pt.train_step(ids[rows], labels[rows]).item())
            assert pt.step_count == jt.step_count == 4 * w + i + 1
            assert pt.optimizer._global_step == pt.step_count
            if i < 3:    # mid-window: nothing applied yet
                assert all(torch.equal(p, start[n])
                           for n, p in pt.param_tensors.items())
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
        for n, p in pt.param_tensors.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jt.params[n]), atol=1e-6,
                                       err_msg=n)
            assert not pt._gm_accum[n].any()
        start = {n: p.detach().clone() for n, p in pt.param_tensors.items()}


def test_gradient_merge_matches_full_batch():
    """k averaged micro-steps == one step on the concatenated batch."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, (8, 32))

    def run(merge):
        model = GPTForCausalLM(gpt_tiny(), device="cpu", seed=0)
        model.train()
        tr = ShardedTrainer(model, SGD(0.1, parameters=model.parameters()),
                            None, strategy=_merge_strategy(
                                DistributedStrategy, True) if merge else None)
        for i in range(4 if merge else 1):
            rows = slice(2 * i, 2 * i + 2) if merge else slice(None)
            tr.train_step(ids[rows], ids[rows])
        return tr.param_tensors

    merged, full = run(True), run(False)
    for n, p in full.items():
        np.testing.assert_allclose(merged[n].detach().numpy(),
                                   p.detach().numpy(), atol=1e-5)


def test_strategy_flags_reach_the_trainer():
    pm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=0)
    opt = AdamW(parameters=pm.parameters())
    st = DistributedStrategy(amp=True, recompute=True)
    t = ShardedTrainer(pm, opt, None, strategy=st)
    assert t.amp and t.recompute and t.strategy is st
    assert not ShardedTrainer(pm, opt, None).amp


def test_sharding_is_a_no_op_on_one_card():
    """ZeRO stage 2 on one device trains bitwise as no strategy does."""
    ids = np.random.RandomState(1).randint(0, 256, (2, 16))
    losses = []
    for st in (None, DistributedStrategy(
            sharding=True, sharding_configs={"stage": 2, "degree": 1})):
        pm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=0)
        pm.train()
        t = ShardedTrainer(pm, AdamW(1e-3, parameters=pm.parameters()),
                           None, strategy=st)
        losses.append([t.train_step(ids, ids).item() for _ in range(2)])
    assert losses[0] == losses[1]


def test_eval_and_predict_match_jax_trainer():
    jm, pm = _gpt_pair(dropout=0.1)
    jt = JaxTrainer(jm, paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()), None, _mesh1())
    pt = ShardedTrainer(pm, AdamW(1e-3, parameters=pm.parameters()), None)
    ids = np.random.RandomState(2).randint(0, 256, (2, 32)).astype(np.int32)
    labels = ids.astype(np.int64)
    want = float(np.asarray(jt.eval_step(ids, labels)))
    got = pt.eval_step(ids, labels)
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    assert got.item() == pt.eval_step(ids, labels).item()   # no dropout
    logits = pt.predict_step(ids)
    assert not logits.requires_grad
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jt.predict_step(ids)), atol=2e-5)
    assert all(m.training for m in pm.modules())
    assert pt.step_count == jt.step_count == 0
    pt.train_step(ids, labels)
    jt.train_step(ids, labels)
    assert pt.step_count == jt.step_count == 1
    # AdamW's non-scalar slots (the moments; the beta powers are 0-dim)
    assert pt.optimizer_state_bytes() == jt.optimizer_state_bytes()
    wte = pt.optimizer_state_bytes(lambda n: n == "gpt.wte.weight")
    assert wte == (2 * 4 * 256 * 64,) * 2
