"""The port's fleet meta-optimizers, ``fleet.distributed_optimizer`` and
``incubate.asp`` against the JAX package's.

- LocalSGD's sync cadence (k steps past ``begin_step``) and the adaptive
  k rule equal the reference classes' step for step (the cases of
  ``tests/test_localsgd_asp.py``); in a one-process world a sync counts
  and leaves the parameters as they are.
- ``distributed_optimizer`` picks, for each strategy, the reference's
  wrapper: adaptive LocalSGD, Lars in place of a ``Momentum`` (carrying
  its rate, momentum and the strategy's Lars settings), LocalSGD, else
  ``HybridParallelOptimizer``; ``fleet.init`` and ``distributed_model``
  train in one process (over four ranks: ``test_torch_mesh_trainer.py``),
  and a pipeline degree above the world's ranks raises the reference's
  ``ValueError``.
- ASP's 1-D and 2-D greedy masks equal the reference's bitwise on the
  same arrays, ``prune_model`` prunes the reference's parameters of a
  port GPT with the same masks, and ``decorate`` keeps the pattern
  through steps.
- The slice: ``gpt_tiny`` trained 3 steps by the port's
  ``ShardedTrainer`` with ZeRO offload and ``Lamb`` against the
  reference's ``ShardedTrainer`` with ``Lamb`` on the same weights: each
  loss within 1e-5 relatively (fp32; the two differ in summation order
  only) and the parameters within 1e-5 of their largest magnitude; the
  key biases, whose gradient is rounding noise, are left out, and the
  query and value biases that share their trust ratio are held to 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import ShardedTrainer as JaxTrainer
from paddle_tpu.distributed import build_mesh
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet import meta_optimizers as jmeta
from paddle_tpu.incubate import asp as jasp
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

from paddle_tpu_torch.distributed import DistributedStrategy, ShardedTrainer
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import meta_optimizers as meta
from paddle_tpu_torch.incubate import asp
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.optimizer import SGD, AdamW, Lamb, Lars, Momentum

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)


class _Counting:
    """An inner optimizer that counts steps and reports a learning rate
    (both packages' wrappers read only these)."""

    def __init__(self, lrs=None):
        self.steps = 0
        self._lrs = list(lrs or [])

    def step(self):
        self.steps += 1

    def clear_grad(self):
        pass

    def get_lr(self):
        return self._lrs[min(self.steps, len(self._lrs) - 1)] \
            if self._lrs else 0.1

    _parameter_list = []


@pytest.mark.parametrize("k,begin", [(3, 2), (1, 1), (4, 1), (2, 5)])
def test_localsgd_sync_cadence_as_the_reference(k, begin):
    ours = meta.LocalSGDOptimizer(_Counting(), k_steps=k, begin_step=begin)
    theirs = jmeta.LocalSGDOptimizer(_Counting(), k_steps=k,
                                     begin_step=begin)
    for _ in range(11):
        ours.step()
        theirs.step()
        assert ours._sync_count == theirs._sync_count
        assert ours._step_count == theirs._step_count
    assert ours.inner_opt.steps == 11


def test_adaptive_localsgd_k_rule_as_the_reference():
    rs = np.random.RandomState(0)
    lrs = list(np.linspace(0.1, 0.01, 12))
    losses = list(4.0 * np.exp(-np.arange(12) / 5) + rs.rand(12) * 0.1)
    ours = meta.AdaptiveLocalSGDOptimizer(_Counting(lrs), init_k_steps=2,
                                          begin_step=1, max_k_steps=8)
    theirs = jmeta.AdaptiveLocalSGDOptimizer(_Counting(lrs), init_k_steps=2,
                                             begin_step=1, max_k_steps=8)
    for loss in losses:
        ours.step()
        theirs.step()
        ours.set_loss(torch.tensor(loss, dtype=torch.float32))
        theirs.set_loss(np.float32(loss))
        assert ours.k_steps == theirs.k_steps
        assert ours._sync_count == theirs._sync_count


def test_localsgd_sync_in_one_process_keeps_the_parameters():
    m = Linear(8, 4, device="cpu")
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(0)))
    opt = meta.LocalSGDOptimizer(SGD(0.1, parameters=m.parameters()),
                                 k_steps=1)
    before = [p.detach().clone() for p in m.parameters()]
    opt.sync_params()
    assert opt._sync_count == 1
    assert all(torch.equal(a, p) for a, p in zip(before, m.parameters()))
    assert len(opt._params()) == 2


def _strategies(cls):
    s_ad = cls()
    s_ad.adaptive_localsgd = True
    s_ad.adaptive_localsgd_configs = {"init_k_steps": 2, "begin_step": 3,
                                      "max_k_steps": 5}
    s_lars = cls()
    s_lars.lars = True
    s_lars.lars_configs = {"lars_coeff": 0.01, "lars_weight_decay": 0.001,
                           "epsilon": 1e-8,
                           "exclude_from_weight_decay": ["bias"]}
    s_local = cls()
    s_local.localsgd = True
    s_local.localsgd_configs = {"k_steps": 4, "begin_step": 2}
    both = cls()
    both.lars = both.localsgd = True
    return {"adaptive": s_ad, "lars": s_lars, "localsgd": s_local,
            "lars+localsgd": both, "plain": cls(), "none": None}


@pytest.mark.parametrize("which", ["adaptive", "lars", "localsgd",
                                   "lars+localsgd", "plain", "none"])
@pytest.mark.parametrize("inner", ["momentum", "sgd"])
def test_distributed_optimizer_picks_the_reference_wrapper(which, inner):
    import paddle_tpu.nn as jnn

    jm = jnn.Linear(8, 8)
    pm = Linear(8, 8, device="cpu")
    if inner == "momentum":
        jo = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.8,
                                       parameters=jm.parameters())
        po = Momentum(learning_rate=0.1, momentum=0.8,
                      parameters=pm.named_parameters())
    else:
        jo = paddle.optimizer.SGD(learning_rate=0.1,
                                  parameters=jm.parameters())
        po = SGD(learning_rate=0.1, parameters=pm.named_parameters())
    jw = jfleet.distributed_optimizer(jo, strategy=_strategies(
        jfleet.DistributedStrategy)[which])
    pw = fleet.distributed_optimizer(po, strategy=_strategies(
        DistributedStrategy)[which])
    assert type(pw).__name__ == type(jw).__name__
    assert type(pw.inner_opt).__name__ == type(jw.inner_opt).__name__
    for attr in ("k_steps", "begin_step", "init_k_steps", "max_k_steps"):
        assert getattr(pw, attr, None) == getattr(jw, attr, None), attr
    if isinstance(pw.inner_opt, Lars):
        lars, jl = pw.inner_opt, jw.inner_opt
        assert (lars._momentum, lars._lars_coeff, lars._lars_decay,
                lars._lars_eps, lars._exclude, lars.get_lr()) == (
            jl._momentum, jl._lars_coeff, jl._lars_decay, jl._lars_eps,
            jl._exclude, jl.get_lr())
        # the Momentum's named parameters carry over to Lars
        assert [n for _, n, _ in lars._parameters()] == ["weight", "bias"]
    else:
        assert pw.inner_opt is po


def test_fleet_init_and_distributed_model_refuse(tmp_path):
    """``fleet.init`` and ``distributed_model`` are ported (the mesh over
    ``torch.distributed``; ``test_torch_mesh_trainer.py`` drives them
    over four ranks). What refuses: ``distributed_model`` before
    ``init``, and a pipeline degree above the world's ranks. In one
    process on a one-rank gloo group, ``init`` builds the ``[1, 1, 1,
    1]`` topology and mesh, and the wrapped model trains like the
    reference's ``train_batch`` (``tests/test_distributed.py:364-387``)."""
    from paddle_tpu_torch.distributed import env, gloo_release, \
        init_parallel_env
    from paddle_tpu_torch.nn import functional as F

    assert not fleet.is_initialized()
    assert fleet.fleet_state() is fleet.fleet_state()
    with pytest.raises(RuntimeError, match="fleet.init"):
        fleet.distributed_model(Linear(2, 2, device="cpu"))
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": 2}
    # pp 2 in a world of one rank: the JAX fleet.init's ValueError for
    # too few devices, raised before any process group is joined
    with pytest.raises(ValueError, match="need 2 ranks"):
        fleet.init(is_collective=True, strategy=strategy)
    init_parallel_env(f"file://{tmp_path}/store", 1, 0, backend="gloo",
                      timeout=60)
    try:
        fleet.init(is_collective=True)
        assert fleet.is_initialized()
        hcg = fleet.get_hybrid_communicate_group()
        assert hcg.get_data_parallel_world_size() == 1
        assert (fleet.worker_index(), fleet.worker_num()) == (0, 1)
        assert fleet.get_mesh().shape == {"dp": 1, "pp": 1, "sharding": 1,
                                          "mp": 1}
        torch.manual_seed(30)
        net = torch.nn.Sequential(Linear(8, 16, device="cpu"),
                                  torch.nn.ReLU(),
                                  Linear(16, 1, device="cpu"))
        model = fleet.distributed_model(net, loss_fn=F.mse_loss)
        model.prepare(fleet.distributed_optimizer(
            SGD(learning_rate=0.05, parameters=net.parameters())))
        rs = np.random.RandomState(6)
        x = rs.randn(32, 8).astype(np.float32)
        y = x @ rs.randn(8, 1).astype(np.float32)
        losses = [float(model.train_batch((x, y))) for _ in range(6)]
        assert losses[-1] < losses[0]
    finally:
        gloo_release()
        fleet.fleet_state().__init__()
        env.set_mesh(None)


# -- ASP ------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 8), (12, 10), (5, 17), (64, 48)])
@pytest.mark.parametrize("algo", ["get_mask_1d", "get_mask_2d_greedy"])
@pytest.mark.parametrize("nm", [(2, 4), (1, 4), (4, 8)])
def test_masks_bitwise_as_the_reference(shape, algo, nm):
    mat = np.random.RandomState(hash((shape, nm)) % 2**31).randn(
        *shape).astype(np.float32)
    got = getattr(asp, algo)(mat, *nm)
    want = getattr(jasp, algo)(mat, *nm)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert asp.check_sparsity(mat * got, *nm) == \
        jasp.check_sparsity(mat * want, *nm)
    assert asp.check_sparsity(torch.from_numpy(mat * got), *nm) == \
        jasp.check_sparsity(mat * want, *nm)


def test_mask_1d_reference_example_and_density():
    mat = np.array([[0, 1, 5, 4], [2, 7, 3, 6]], "float32")
    mask = asp.get_mask_1d(mat, 2, 4)
    np.testing.assert_array_equal(mask, [[0, 0, 1, 1], [0, 1, 0, 1]])
    assert asp.check_sparsity(mat * mask, n=2, m=4)
    assert not asp.check_sparsity(torch.from_numpy(mat), n=2, m=4)
    assert asp.calculate_density(torch.from_numpy(mat * mask)) == \
        jasp.calculate_density(mat * mask) == 0.5


def _gpt_pair():
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    jm.train()
    pm = GPTForCausalLM(gpt_tiny(), device="cpu")
    pm.set_state_dict({k: np.asarray(v.value)
                       for k, v in jm.state_dict().items()})
    pm.train()
    return jm, pm


def test_prune_model_masks_the_references_parameters(monkeypatch):
    jm, pm = _gpt_pair()
    asp.reset_excluded_layers()
    jasp.reset_excluded_layers()
    try:
        asp.set_excluded_layers(["wpe"])
        jasp.set_excluded_layers(["wpe"])
        want = jasp.prune_model(jm)
        got = asp.prune_model(pm)
    finally:
        asp.reset_excluded_layers()
        jasp.reset_excluded_layers()
    assert sorted(got) == sorted(want) and "gpt.wpe.weight" not in got
    assert all(not k.endswith("bias") for k in got)
    params = dict(pm.named_parameters())
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
        np.testing.assert_array_equal(
            params[name].detach().numpy(),
            np.asarray(dict(jm.named_parameters())[name].value))
        assert asp.check_sparsity(params[name])

    opt = asp.decorate(AdamW(learning_rate=1e-2,
                             parameters=pm.named_parameters()))
    t = ShardedTrainer(pm, opt, None)
    ids = np.random.RandomState(0).randint(0, 256, (2, 32))
    for _ in range(2):
        t.train_step(ids, ids)
        assert all(asp.check_sparsity(params[n]) for n in got)
    assert t.step_count == 2 and opt.inner_opt._global_step == 2


def _mesh1():
    return build_mesh([1, 1, 1, 1], ["dp", "pp", "sharding", "mp"],
                      devices=np.array(jax.devices()[:1]))


def test_lamb_with_offload_trains_as_the_reference():
    jm, pm = _gpt_pair()
    jt = JaxTrainer(jm, paddle.optimizer.Lamb(
        learning_rate=1e-2, lamb_weight_decay=0.01,
        parameters=jm.parameters()), None, _mesh1())
    st = DistributedStrategy(sharding=True,
                             sharding_configs={"offload": True})
    pt = ShardedTrainer(pm, Lamb(learning_rate=1e-2, lamb_weight_decay=0.01,
                                 parameters=pm.named_parameters()), None,
                        strategy=st)
    assert pt._host_slots
    rs = np.random.RandomState(1)
    for _ in range(3):
        ids = rs.randint(0, 256, (2, 32))
        jl = float(np.asarray(jt.train_step(ids.astype(np.int32),
                                            ids.astype(np.int64))))
        pl = pt.train_step(ids, ids).item()
        assert abs(pl - jl) <= 1e-5 * abs(jl), (pl, jl)
    heads, d = jax_gpt_tiny().num_heads, 64 // jax_gpt_tiny().num_heads
    for n, p in pt.param_tensors.items():
        got, want = p.detach().numpy(), np.asarray(jt.params[n])
        tol = 1e-5
        if n.endswith("qkv_proj.bias"):
            # the key bias: softmax ignores a shift every key shares, so
            # its gradient is 0 in exact arithmetic and rounding noise in
            # both packages, which Lamb's m1 / sqrt(m2) scales to a full
            # step of either sign; it is left out, and the query and value
            # biases share its trust ratio (one norm a tensor), so they
            # are held to 1e-4
            keep = np.ones((heads, 3 * d), bool)
            keep[:, d:2 * d] = False
            got, want = got[keep.ravel()], want[keep.ravel()]
            tol = 1e-4
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= tol, (n, err)
