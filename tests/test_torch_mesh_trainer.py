"""``ShardedTrainer`` over a mesh of four gloo ranks on the CPU against
the JAX ``ShardedTrainer`` on its CPU mesh at the same degrees.

gpt_tiny (dropout off), weights drawn by the JAX package and copied by
name into every rank, AdamW (lr 1e-3, weight decay 0.01) with a global
norm clip of 1.0, the global batch 8 x 32, 3 fp32 steps, on:

- ``[1, 1, 2, 2]`` ZeRO-2 x mp, ``[2, 1, 1, 2]`` dp x mp and
  ``[2, 1, 2, 1]`` dp x ZeRO-3, each against the JAX trainer on
  ``build_mesh(dims, ..., devices=jax.devices()[:4])``: the three losses
  and every parameter after them (gathered from the port's four-rank
  checkpoint);
- ``fleet.init`` (mp 2, dp absorbing the other ranks) ->
  ``distributed_model`` -> ``distributed_optimizer`` -> ``prepare`` ->
  ``train_batch`` (``tests/test_distributed.py:364-387``), against the
  JAX dp x mp run;
- on the mesh as a whole: ``eval_step`` and ``predict_step`` against one
  process on the same weights, ZeRO-2 offload bitwise against ZeRO-2,
  gradient merge over ZeRO-3 against one process, and the anomaly
  policy dropping the same steps on every rank.

Tolerances, measured on the CPU: the port's gang and the JAX mesh run
sum in other orders (the mesh's split matmuls, the averaged gradients,
torch's and XLA's fp32 kernels). Their losses differ by at most 9.2e-8
relative and their parameters after three Adam steps by at most 6.9e-6
(Adam's first steps are ~lr in size whatever the gradient's scale, so a
gradient near zero may step either way): the gates are 4e-7 relative
and 3e-5, 4.4x and 4.3x above those. The planted faults below land at
4.3e-3 to 2.0e-2 (losses) and 6.0e-3 (parameters).

Checkpoints: the port's four-rank checkpoint (ZeRO-2 x mp: parameters
in mp shards, AdamW slots in ZeRO shards) loads in the JAX
``load_state`` and in the one-process port bitwise; a JAX checkpoint of
a dp x mp run loads into the gang, which saves it again, bitwise.

Planted faults, run inside the gang on dp x mp: ``mp_identity``'s
backward all-reduce made the identity (the gradient of each replicated
activation left partial), ``mp_allreduce``'s backward made an
all-reduce (the gradient counted once per mp rank, the over-count the
reference's custom VJP exists to stop), and the dp averaging dropped
(each rank steps on its own gradient). Each fails the parity gate that
the sound run passes.

One four-rank gang runs every case (``test_torch_collective.run_gang``);
the JAX runs happen in the test process.
"""

import json
import warnings

import numpy as np
import pytest
import torch

from test_torch_collective import WORLD, once_per_session, run_gang

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

LOSS_RTOL = 4e-7
PARAM_ATOL = 3e-5
STEPS = 3
CASES = {"zero2_mp": ([1, 1, 2, 2], 2), "dp_mp": ([2, 1, 1, 2], 0),
         "zero3_dp": ([2, 1, 2, 1], 3)}
FAULTS = ("mp_identity_bwd", "mp_allreduce_bwd", "no_dp_average")
AXES = ["dp", "pp", "sharding", "mp"]


def _batch():
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 256, (8, 32)).astype(np.int64)
    return ids, ids.copy()


def _port_model(state):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt_tiny()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    model = GPTForCausalLM(cfg, device="cpu")
    model.set_state_dict(state)
    model.train()
    opt = AdamW(learning_rate=1e-3, parameters=model.named_parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    return model, opt


def _strategy(stage, offload=False, merge=1):
    from paddle_tpu_torch.distributed import DistributedStrategy

    st = DistributedStrategy()
    if stage:
        st.sharding = True
        st.sharding_configs = {"stage": stage, "offload": offload}
    if merge > 1:
        st.gradient_merge = True
        st.gradient_merge_configs = {"k_steps": merge, "avg": True}
    return st


def _train(dims, stage, state, ckpt, steps=STEPS, anomaly=None,
           evaluate=None, **kw):
    """``steps`` steps on ``dims``; returns the losses (and, with an
    ``anomaly`` config, every rank's anomaly counts too). ``evaluate``:
    a path for the eval loss and predicted logits after them."""
    from paddle_tpu_torch.distributed import (ShardedTrainer,
                                              all_gather_object,
                                              build_mesh)

    model, opt = _port_model(state)
    trainer = ShardedTrainer(model, opt, None,
                             mesh=build_mesh(dims, AXES) if dims else None,
                             strategy=_strategy(stage, **kw))
    if anomaly is not None:
        trainer.enable_anomaly_policy(**anomaly)
    ids, labels = _batch()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the skipped steps' warnings
        losses = [float(trainer.train_step(ids, labels))
                  for _ in range(steps)]
    trainer.save_checkpoint(ckpt)
    if evaluate is not None:
        np.savez(evaluate, loss=trainer.eval_step(ids, labels).numpy(),
                 logits=trainer.predict_step(ids).numpy())
    if anomaly is None:
        return losses
    stats = []
    all_gather_object(stats, trainer.anomaly_stats)
    return losses, stats


def _faulty(fault, state, ckpt):
    """dp x mp with one fault planted for the run."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.meta_parallel import mp_layers
    from paddle_tpu_torch.distributed.trainer import ShardedTrainer

    patches = {
        "mp_identity_bwd": (mp_layers._MpIdentity, "backward",
                            staticmethod(lambda ctx, g: (g, None))),
        "mp_allreduce_bwd": (mp_layers._MpAllreduce, "backward",
                             staticmethod(lambda ctx, g: (
                                 collective.all_reduce(
                                     g.contiguous().clone(),
                                     axis_name="mp"), None))),
        "no_dp_average": (ShardedTrainer, "_sync_grads",
                          lambda self, grads: grads),
    }
    owner, name, value = patches[fault]
    saved = owner.__dict__[name]
    setattr(owner, name, value)
    try:
        return _train(*CASES["dp_mp"], state, ckpt)
    finally:
        setattr(owner, name, saved)


def _gang_main(rank, work):
    from paddle_tpu_torch.distributed import (ShardedTrainer, build_mesh,
                                              fleet)
    from paddle_tpu_torch.distributed import DistributedStrategy

    state = dict(np.load(f"{work}/init.npz"))
    out = {}
    for name, (dims, stage) in CASES.items():
        out[name] = _train(dims, stage, state, f"{work}/{name}",
                           evaluate=f"{work}/{name}.eval{rank}.npz")

    # the fleet path: mp 2, dp absorbing the other two ranks
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    out["fleet_degrees"] = [hcg.get_data_parallel_world_size(),
                            hcg.get_model_parallel_world_size(),
                            fleet.worker_index(), fleet.worker_num()]
    model, opt = _port_model(state)
    dmodel = fleet.distributed_model(model)
    dmodel.prepare(fleet.distributed_optimizer(opt))
    ids, labels = _batch()
    out["fleet"] = [float(dmodel.train_batch((ids, labels)))
                    for _ in range(STEPS)]

    # a JAX dp x mp checkpoint into the gang, saved again
    model, opt = _port_model(state)
    trainer = ShardedTrainer(model, opt, None,
                             mesh=build_mesh(*CASES["dp_mp"][:1], AXES),
                             strategy=_strategy(0))
    trainer.load_checkpoint(f"{work}/jax_ckpt")
    out["jax_ckpt_step"] = trainer.step_count
    trainer.save_checkpoint(f"{work}/jax_resaved")
    out["after_jax_ckpt"] = float(trainer.train_step(ids, labels))

    # ZeRO offload: the same arithmetic on each rank's host slot shards
    out["zero2_offload"] = _train(*CASES["zero2_mp"], state,
                                  f"{work}/zero2_offload", offload=True)
    # gradient merge over ZeRO-3: two updates of two micro-steps
    out["zero3_merge"] = _train(*CASES["zero3_dp"], state,
                                f"{work}/zero3_merge", steps=4, merge=2)
    # a spike cap of half the last good loss: steps 2 and 3 are dropped,
    # on every rank
    out["anomaly"] = _train(*CASES["dp_mp"], state, f"{work}/anomaly",
                            anomaly={"policy": "skip_step",
                                     "spike_window": 1,
                                     "spike_factor": 0.5})
    for fault in FAULTS:
        out[fault] = _faulty(fault, state, f"{work}/{fault}")
    if rank == 0:
        with open(f"{work}/results.json", "w") as f:
            json.dump(out, f)


def _jax_run(dims, stage, state, steps=STEPS, ckpt=None):
    """The JAX ShardedTrainer on its CPU mesh: (losses, its params)."""
    import jax

    import paddle_tpu as paddle
    from paddle_tpu.distributed import DistributedStrategy as JaxStrategy
    from paddle_tpu.distributed import ShardedTrainer as JaxTrainer
    from paddle_tpu.distributed import build_mesh as jax_mesh
    from paddle_tpu.models import GPTForCausalLM as JaxGPT
    from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

    cfg = jax_gpt_tiny()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    model = JaxGPT(cfg)
    model.set_state_dict(state)
    model.train()
    opt = paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=model.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    st = JaxStrategy()
    if stage:
        st.sharding = True
        st.sharding_configs = {"stage": stage}
    mesh = jax_mesh(dims, AXES, devices=jax.devices()[:WORLD])
    trainer = JaxTrainer(model, opt, None, mesh, strategy=st)
    ids, labels = _batch()
    losses = [float(np.asarray(trainer.train_step(ids.astype(np.int32),
                                                  labels)))
              for _ in range(steps)]
    if ckpt is not None:
        trainer.save_checkpoint(ckpt)
    return losses, {n: np.asarray(v) for n, v in trainer.params.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return once_per_session(tmp_path_factory, "mesh_trainer_gang", _build)


def _build(work):
    """The JAX weights and checkpoint, the gang, and the JAX mesh runs."""
    import paddle_tpu as paddle
    from paddle_tpu.models import GPTForCausalLM as JaxGPT
    from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

    paddle.seed(0)
    state = {k: np.asarray(v.value)
             for k, v in JaxGPT(jax_gpt_tiny()).state_dict().items()}
    np.savez(work / "init.npz", **state)
    _jax_run(*CASES["dp_mp"], state, steps=1, ckpt=str(work / "jax_ckpt"))
    run_gang(_gang_main, WORLD, work, str(work))
    results = json.loads((work / "results.json").read_text())
    refs = {name: _jax_run(dims, stage, state)
            for name, (dims, stage) in CASES.items()}
    return work, state, results, refs


def _port_params(path):
    from paddle_tpu_torch.distributed import checkpoint

    arrays, extra = checkpoint.load_state(str(path), device="cpu")
    return {k[len("param/"):]: v.numpy() for k, v in arrays.items()
            if k.startswith("param/")}, arrays, extra


def _distance(losses, params, ref):
    ref_losses, ref_params = ref
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    param = max(float(np.abs(params[n] - ref_params[n]).max())
                for n in ref_params)
    return loss_rel, param


def _within(dist):
    return dist[0] <= LOSS_RTOL and dist[1] <= PARAM_ATOL


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_matches_the_jax_trainer(run, case):
    work, _, results, refs = run
    params, _, extra = _port_params(work / case)
    assert extra["step"] == STEPS
    dist = _distance(results[case], params, refs[case])
    assert _within(dist), (case, dist, (LOSS_RTOL, PARAM_ATOL))
    assert results[case][-1] < results[case][0]


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_eval_and_predict_match_one_process(run, case):
    """``eval_step`` (the global mean loss) and ``predict_step`` (the
    global batch's logits, vocab gathered) on every rank equal one
    process on the mesh run's final weights (1e-5: fp32 sums in another
    order)."""
    from paddle_tpu_torch.distributed import ShardedTrainer

    work, state, _, _ = run
    model, opt = _port_model(state)
    trainer = ShardedTrainer(model, opt, None)
    trainer.load_checkpoint(str(work / case))
    ids, labels = _batch()
    loss = trainer.eval_step(ids, labels).item()
    logits = trainer.predict_step(ids).numpy()
    for r in range(WORLD):
        got = np.load(work / f"{case}.eval{r}.npz")
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(got["logits"], logits, atol=1e-5)


def test_fleet_distributed_model_trains_like_dp_x_mp(run):
    work, _, results, refs = run
    assert results["fleet_degrees"] == [2, 2, 0, WORLD]
    np.testing.assert_allclose(results["fleet"], refs["dp_mp"][0],
                               rtol=LOSS_RTOL)
    # the same program as the direct dp x mp trainer: the same numbers
    assert results["fleet"] == results["dp_mp"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails_the_parity_gate(run, fault):
    work, _, results, refs = run
    params, _, _ = _port_params(work / fault)
    dist = _distance(results[fault], params, refs["dp_mp"])
    assert not _within(dist), (fault, dist)


def test_four_rank_checkpoint_loads_in_jax_and_one_process(run):
    """ZeRO-2 x mp: each array written in pieces by its first replicas
    (``index-<rank>.json`` bounds); the JAX ``load_state`` and the
    one-process port assemble the same arrays, bitwise, and a
    one-process trainer takes them."""
    import importlib

    from paddle_tpu_torch.distributed import ShardedTrainer

    work, state, _, _ = run
    path = work / "zero2_mp"
    jckpt = importlib.import_module("paddle_tpu.distributed.checkpoint")
    jarrays, jextra = jckpt.load_state(str(path))
    _, arrays, extra = _port_params(path)
    assert set(jarrays) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(jarrays[k]), v.numpy(), k)
    assert jextra["step"] == extra["step"] == STEPS
    version = next(p for p in path.iterdir() if p.name.startswith("v"))
    assert sorted(p.name for p in version.glob("shard-*.npz")) == [
        f"shard-{r}.npz" for r in range(WORLD)]
    index = json.loads((version / "index-3.json").read_text())
    # rank 3 is (sharding 1, mp 1): a ZeRO shard of a moment, no param
    assert not any(rec["name"].startswith("param/") for rec in
                   index.values())
    assert any(rec["name"].endswith("moment1") for rec in index.values())
    model, opt = _port_model(state)
    trainer = ShardedTrainer(model, opt, None)
    trainer.load_checkpoint(str(path))
    assert trainer.step_count == STEPS
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      arrays[f"param/{n}"].numpy())


def test_offload_merge_and_anomaly_act_on_the_mesh(run, tmp_path):
    """ZeRO-2 offload moves each rank's slot shards and keeps the
    arithmetic bitwise; gradient merge over ZeRO-3 (4 micro-steps, 2
    updates) matches the one-process port's; the anomaly policy drops
    the same two steps on every rank, leaving the parameters of one
    step (the JAX trainer's after its first)."""
    work, state, results, _ = run
    assert results["zero2_offload"] == results["zero2_mp"]
    off, _, _ = _port_params(work / "zero2_offload")
    ref, _, _ = _port_params(work / "zero2_mp")
    for n in ref:
        np.testing.assert_array_equal(off[n], ref[n], n)
    one = _train(None, 0, state, str(tmp_path / "one"), steps=4, merge=2)
    merged, _, _ = _port_params(work / "zero3_merge")
    one_params, _, _ = _port_params(tmp_path / "one")
    assert _within(_distance(results["zero3_merge"], merged,
                             (one, one_params)))
    losses, stats = results["anomaly"]
    assert stats == [{"skipped": 2, "rollbacks": 0,
                      "consecutive_bad": 2}] * WORLD
    params, _, _ = _port_params(work / "anomaly")
    jax_params, _, _ = _port_params(work / "jax_ckpt")
    assert max(float(np.abs(params[n] - jax_params[n]).max())
               for n in params) <= PARAM_ATOL


def test_jax_mesh_checkpoint_loads_in_the_gang(run):
    """The JAX trainer's dp x mp checkpoint after one step loads into the
    four ranks (each its window) and saves again bitwise; the gang's
    next step matches the JAX trainer's second loss."""
    work, state, results, refs = run
    _, jax_arrays, _ = _port_params(work / "jax_ckpt")
    _, again, extra = _port_params(work / "jax_resaved")
    assert results["jax_ckpt_step"] == 1 and extra["step"] == 1
    for k, v in jax_arrays.items():
        np.testing.assert_array_equal(again[k].numpy(), v.numpy(), k)
    np.testing.assert_allclose(results["after_jax_ckpt"],
                               refs["dp_mp"][0][1], rtol=LOSS_RTOL)
