"""The pipeline over ``pp`` ranks (``PipelineLayer``, GPipe, 1F1B with
interleaving, the GPT/BERT/ERNIE Pipe models) in a gang of four gloo
ranks on the CPU, against the JAX package.

The JAX reference compiles the pipelined schedule into one SPMD program;
the port drives it from each rank's host. The reference's own contract
is that the pipelined run equals the sequential run of the same Pipe
model (``tests/test_pipeline.py``: pp4 == pp1), and the JAX pipelined
arms need partial-auto ``shard_map`` on meshes with dp or mp, which this
JAX cannot compile. So every port run is held to the JAX package's
SEQUENTIAL run of the same model on the same weights (one device, the
whole batch), to the port's own one-process run in the same layout, and
the plain pp2 run also to the JAX pipelined run on a ``[1, 2, 1, 1]``
mesh, which does compile here. Gang cases, 2 steps of SGD (lr 0.1,
weight decay 0.01, global norm clip 1.0; Adam would turn the rounding
of a gradient that is zero in exact arithmetic, such as a key bias's,
into a step of either sign) on the global batch 8 x 16, dropout off:

- GPipe (``PipelineParallel`` of four residual MLP blocks, MSE) on dp2 x
  pp2, M 4;
- 1F1B ``GPTForCausalLMPipe`` (gpt_tiny, 4 blocks) on dp2 x pp2 (M 4),
  dp2 x pp2 x V2 (M 4), pp2 x mp2 (M 4), pp2 x ZeRO-2 and ZeRO-3 over
  sharding 2 (M 4), and 5 blocks (uneven, 3 + 2) on dp2 x pp2;
  ``fleet.init(pp_degree=2)`` -> ``distributed_model`` ->
  ``train_batch``;
- ``BertForPretrainingPipe`` and ``ErnieForPretrainingPipe`` (2 layers,
  hidden 32, MLM labels on a quarter of the positions) on dp2 x pp2;
- the pp2 checkpoint crossing both ways with JAX ``load_state``;
- dropout on (0.1): the pipelined gradients of one ``loss_and_grads``
  equal the one-process sequential run's with the same chunk seeds, so
  each recompute drew its forward's masks;
- planted faults: the extras' gradients not summed over ``pp``, and the
  recompute's generator not seeded (its masks drawn afresh).

Tolerances, measured on the CPU: losses within 2.7e-7 relative of the
JAX runs and parameters within 6.0e-8 after the two steps (the fp32
sums run in other orders: microbatches, the dp average, the pp sum of
the tied embedding's gradient); the gates are 1e-6 and 3e-7. The
planted extras fault lands at 1.4e-4 (losses) and 6.8e-3
(parameters); the dropout run's gradients sit 7.5e-9 from the
sequential run's, the unseeded recompute's 0.14 (gate 1e-6).
"""

import json

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn.layer import Layer
from test_torch_collective import (WORLD, once_per_session, start_gang,
                                   wait_for)

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

LOSS_RTOL = 1e-6
PARAM_ATOL = 3e-7
GRAD_ATOL = 1e-6
STEPS = 2
AXES = ["dp", "pp", "sharding", "mp"]
B, S = 8, 16
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
# case: (model kind, blocks, mesh dims, V[, ZeRO stage])
CASES = {"pp2": ("gpt", 4, [2, 2, 1, 1], 1),
         "pp2_v2": ("gpt", 4, [2, 2, 1, 1], 2),
         "pp2_mp2": ("gpt", 4, [1, 2, 1, 2], 1),
         "pp2_zero2": ("gpt", 4, [1, 2, 2, 1], 1, 2),
         "pp2_zero3": ("gpt", 4, [1, 2, 2, 1], 1, 3),
         "uneven5": ("gpt", 5, [2, 2, 1, 1], 1),
         "bert": ("bert", 2, [2, 2, 1, 1], 1),
         "ernie": ("ernie", 2, [2, 2, 1, 1], 1)}


def _ids():
    rs = np.random.RandomState(3)
    return rs.randint(0, 64, (B, S)).astype(np.int64)


def _mlm_labels():
    ids = _ids()
    lab = np.full_like(ids, -100)
    lab[:, ::4] = ids[:, ::4]
    return lab


def _gpt_cfg(blocks, dropout=0.0):
    from paddle_tpu_torch.models import gpt_tiny

    cfg = gpt_tiny()
    cfg.num_layers = blocks
    cfg.hidden_dropout = cfg.attention_dropout = dropout
    return cfg


def _port_pipe(kind, blocks, V, state, dropout=0.0):
    """The port's Pipe model at pp 2, M 4, ``state`` (per-block layout
    independent: see :func:`_relayout`) loaded."""
    from paddle_tpu_torch.models import (BertConfig, BertForPretrainingPipe,
                                         ErnieConfig, ErnieForPretrainingPipe,
                                         GPTForCausalLMPipe)

    if kind == "gpt":
        m = GPTForCausalLMPipe(_gpt_cfg(blocks, dropout), 2, 4, V,
                               device="cpu")
    elif kind == "bert":
        m = BertForPretrainingPipe(BertConfig(**BERT), 2, 4, device="cpu")
    else:
        m = ErnieForPretrainingPipe(ErnieConfig(**BERT), 2, 4, device="cpu")
    m.set_state_dict(_relayout(state, m))
    m.train()
    return m


def _blocks_of(state, counts, order, names):
    """Per-block weights of a stacked state (``names``: the model's
    ``layers.{i}.<rest>`` stack names)."""
    W = len(counts)
    starts = np.concatenate([[0], np.cumsum(counts)])
    blocks = [dict() for _ in range(int(starts[-1]))]
    for n in names:
        i, rest = n.split(".", 2)[1:]
        arr = np.asarray(state["stage__" + n.replace(".", "__")])
        for j in range(W):
            w = order[j]
            if int(i) < counts[w]:
                blocks[starts[w] + int(i)][rest] = arr[j]
    return blocks


def _relayout(state, model):
    """``state`` (a stacked S=2, V=1 layout of the same blocks, or
    already ``model``'s) in ``model``'s layout."""
    if all(k in state and tuple(np.shape(state[k])) == tuple(p.shape)
           for k, p in model.named_parameters()):
        return state
    src = [k[len("stage__"):].replace("__", ".") for k in state
           if k.startswith("stage__")]
    blocks = _blocks_of(state, *_src_layout(model), src)
    names = model._stack_names
    out = {k: v for k, v in state.items() if not k.startswith("stage__")}
    counts, order = model._stage_counts, model._virtual_order
    starts = np.concatenate([[0], np.cumsum(counts)])
    for n in names:
        i, rest = n.split(".", 2)[1:]
        out["stage__" + n.replace(".", "__")] = np.stack([
            blocks[starts[order[j]] + int(i)][rest]
            if int(i) < counts[order[j]] else blocks[0][rest]
            for j in range(len(order))])
    return out


def _src_layout(model):
    """(counts, order) of the S=2, V=1 stacked layout of ``model``'s
    blocks."""
    n_blocks = sum(model._stage_counts)
    return [n_blocks // 2 + n_blocks % 2, n_blocks // 2], [0, 1]


def _per_block(params, model_like):
    """Per-block arrays (and the extras) of a trained model's params."""
    blocks = _blocks_of(params, model_like._stage_counts,
                        model_like._virtual_order, model_like._stack_names)
    out = {k: v for k, v in params.items() if not k.startswith("stage__")}
    for b, blk in enumerate(blocks):
        out.update({f"block{b}.{k}": v for k, v in blk.items()})
    return out


def _opt(model):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD

    return SGD(learning_rate=0.1, parameters=model.named_parameters(),
               weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))


def _labels(kind):
    return _ids() if kind == "gpt" else _mlm_labels()


def _train(case, state, ckpt, steps=STEPS, mesh=True):
    """The case on its mesh (or, ``mesh=False``, in one process);
    returns the losses, the checkpoint at ``ckpt`` (if given)."""
    from paddle_tpu_torch.distributed import (DistributedStrategy,
                                              ShardedTrainer, build_mesh)

    kind, blocks, dims, V, *zero = CASES[case]
    model = _port_pipe(kind, blocks, V, state)
    st = DistributedStrategy()
    if zero and mesh:
        st.sharding = True
        st.sharding_configs = {"stage": zero[0]}
    trainer = ShardedTrainer(model, _opt(model), type(model).loss
                             if kind == "gpt" else model.mlm_loss,
                             mesh=build_mesh(dims, AXES) if mesh else None,
                             strategy=st)
    losses = [float(trainer.train_step(_ids(), _labels(kind)))
              for _ in range(steps)]
    if ckpt is not None:
        trainer.save_checkpoint(ckpt)
    if not mesh:
        return losses, {n: p.detach().numpy().copy()
                        for n, p in model.named_parameters()}
    return losses


class Block(Layer):
    """The GPipe body block (``tests/test_pipeline.py``'s ``Block``)."""

    def __init__(self, h):
        from paddle_tpu_torch.nn.layers import Linear

        super().__init__()
        self.fc1 = Linear(h, 2 * h, device="cpu")
        self.fc2 = Linear(2 * h, h, device="cpu")

    def forward(self, x):
        return x + self.fc2(torch.relu(self.fc1(x)))


def _gpipe(state, ckpt, mesh=True):
    from paddle_tpu_torch.distributed import (PipelineParallel,
                                              ShardedTrainer, build_mesh)
    from paddle_tpu_torch.distributed.meta_parallel import (LayerDesc,
                                                            PipelineLayer)
    from paddle_tpu_torch.nn import functional as F

    pp = PipelineParallel(PipelineLayer([LayerDesc(Block, 16)
                                         for _ in range(4)], num_stages=2),
                          num_microbatches=4, loss_fn=F.mse_loss)
    pp.set_state_dict(state)
    x, y = _gpipe_data()
    trainer = ShardedTrainer(pp, _opt(pp), F.mse_loss,
                             mesh=build_mesh([2, 2, 1, 1], AXES)
                             if mesh else None)
    losses = [float(trainer.train_step(x, y)) for _ in range(STEPS)]
    if not mesh:
        return losses, {n: p.detach().numpy().copy()
                        for n, p in pp.named_parameters()}
    trainer.save_checkpoint(ckpt)
    return losses


def _gpipe_data():
    rs = np.random.RandomState(1)
    return (rs.randn(B, 16).astype(np.float32),
            rs.randn(B, 16).astype(np.float32))


def _dropout_grads(state, out, fault):
    """One pipelined ``loss_and_grads`` with dropout 0.1 on dp2 x pp2;
    this rank's gradients (its stage's stacked slots, the extras)."""
    from paddle_tpu_torch.distributed import build_mesh
    from paddle_tpu_torch.distributed import env as dist_env
    from paddle_tpu_torch.distributed import pipeline_1f1b

    mesh = build_mesh([2, 2, 1, 1], AXES)
    model = _port_pipe("gpt", 4, 1, state, dropout=0.1)
    saved = pipeline_1f1b._chunk_rng
    if fault:
        import contextlib

        pipeline_1f1b._chunk_rng = lambda dev, seed: contextlib.nullcontext()
    try:
        model.attach_mesh(mesh)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n.startswith("stage__"):
                    p.data = p.data[mesh.index("pp"):mesh.index("pp") + 1]
        ids = torch.as_tensor(_ids()).chunk(2)[mesh.index("dp")]
        with dist_env._mesh_scope(mesh):
            loss, grads = model.loss_and_grads(None, (ids, ids), 1234)
    finally:
        pipeline_1f1b._chunk_rng = saved
    np.savez(out, loss=loss.numpy(),
             **{n: g.numpy() for n, g in grads.items()})


def _gang_main(rank, work):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import DistributedStrategy
    from paddle_tpu_torch.distributed.pipeline_1f1b import Pipeline1F1B

    wait_for(f"{work}/states.ready")
    states = dict(np.load(f"{work}/states.npz", allow_pickle=True))
    states = {k: v.item() for k, v in states.items()}
    out = {}
    for case, (kind, blocks, *_) in CASES.items():
        key = kind if kind != "gpt" else f"gpt{blocks}"
        out[case] = _train(case, states[key], f"{work}/{case}")
    out["gpipe"] = _gpipe(states["gpipe"], f"{work}/gpipe")

    # fleet.init with pp 2: dp absorbs the other two ranks
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    out["fleet_degrees"] = [hcg.get_data_parallel_world_size(),
                            hcg.get_pipe_parallel_world_size(),
                            hcg.get_stage_id(), list(fleet.get_mesh().shape
                                                     .values())]
    model = _port_pipe("gpt", 4, 1, states["gpt4"])
    dmodel = fleet.distributed_model(model)
    dmodel.prepare(fleet.distributed_optimizer(_opt(model)),
                   type(model).loss)
    out["fleet"] = [float(dmodel.train_batch((_ids(), _ids())))
                    for _ in range(STEPS)]

    # the JAX sequential trainer's checkpoint into the gang, saved again
    from paddle_tpu_torch.distributed import ShardedTrainer, build_mesh

    model = _port_pipe("gpt", 4, 1, states["gpt4"])
    trainer = ShardedTrainer(model, _opt(model), type(model).loss,
                             mesh=build_mesh([2, 2, 1, 1], AXES))
    wait_for(f"{work}/jax_ckpt.ready")
    trainer.load_checkpoint(f"{work}/jax_ckpt")
    out["jax_ckpt_step"] = trainer.step_count
    trainer.save_checkpoint(f"{work}/jax_resaved")
    out["after_jax_ckpt"] = float(trainer.train_step(_ids(), _ids()))

    # planted: the extras' gradients left unsummed over pp
    saved = Pipeline1F1B._sum_extras_over_pp
    Pipeline1F1B._sum_extras_over_pp = lambda self: None
    try:
        out["no_extras_sum"] = _train("pp2", states["gpt4"],
                                      f"{work}/no_extras_sum")
    finally:
        Pipeline1F1B._sum_extras_over_pp = saved

    for fault in (False, True):
        _dropout_grads(states["gpt4"],
                       f"{work}/dropout{int(fault)}.rank{rank}.npz", fault)
    if rank == 0:
        with open(f"{work}/results.json", "w") as f:
            json.dump(out, f)


def _jax_pipe(kind, blocks):
    import paddle_tpu as paddle
    from paddle_tpu.models import (BertConfig, BertForPretrainingPipe,
                                   ErnieConfig, ErnieForPretrainingPipe,
                                   GPTForCausalLMPipe, gpt_tiny)

    paddle.seed(11)
    if kind == "gpt":
        cfg = gpt_tiny()
        cfg.num_layers = blocks
        return GPTForCausalLMPipe(cfg, 2, 4)
    if kind == "bert":
        return BertForPretrainingPipe(BertConfig(**BERT), 2, 4)
    return ErnieForPretrainingPipe(ErnieConfig(**BERT), 2, 4)


def _jax_run(model, loss_fn, batch, dims, steps=STEPS, ckpt=None):
    """The JAX trainer on ``dims`` (one device: the sequential run):
    (losses, params); ``ckpt`` is saved after the first step."""
    import jax

    import paddle_tpu as paddle
    from paddle_tpu.distributed import ShardedTrainer as JaxTrainer
    from paddle_tpu.distributed import build_mesh as jax_mesh

    opt = paddle.optimizer.SGD(
        learning_rate=0.1, parameters=model.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    n = int(np.prod(dims))
    trainer = JaxTrainer(model, opt, loss_fn,
                         jax_mesh(dims, AXES, devices=jax.devices()[:n]))
    losses = []
    for i in range(steps):
        losses.append(float(np.asarray(trainer.train_step(*batch))))
        if ckpt is not None and i == 0:
            trainer.save_checkpoint(ckpt)
    return losses, {k: np.asarray(v) for k, v in trainer.params.items()}


def _jax_gpipe():
    import paddle_tpu as paddle
    from paddle_tpu import nn
    from paddle_tpu.distributed import PipelineParallel
    from paddle_tpu.distributed.meta_parallel.parallel_layers import (
        LayerDesc, PipelineLayer)

    class JaxBlock(nn.Layer):
        def __init__(self, h):
            super().__init__()
            self.fc1 = nn.Linear(h, 2 * h)
            self.fc2 = nn.Linear(2 * h, h)

        def forward(self, x):
            return x + self.fc2(nn.functional.relu(self.fc1(x)))

    paddle.seed(5)
    return PipelineParallel(PipelineLayer([LayerDesc(JaxBlock, 16)
                                           for _ in range(4)], num_stages=2),
                            num_microbatches=4,
                            loss_fn=nn.functional.mse_loss)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return once_per_session(tmp_path_factory, "pipeline_gang", _build)


def _build(work):
    """The JAX weights, sequential runs and checkpoint; the gang; the
    port's one-process runs."""
    import paddle_tpu as paddle
    from paddle_tpu.models import (BertForPretrainingPipe,
                                   GPTForCausalLMPipe)

    ids32 = _ids().astype(np.int32)
    runs = {"gpt4": ("gpt", 4), "gpt5": ("gpt", 5), "bert": ("bert", 2),
            "ernie": ("ernie", 2)}
    # the gang starts at once and reads the weights, then the JAX
    # checkpoint, once each is written; the JAX runs go on beside it (a
    # marker is written even on a failure here: the gang then fails at
    # once on what is missing)
    wait = start_gang(_gang_main, WORLD, work, str(work))
    try:
        models = {key: _jax_pipe(kind, blocks)
                  for key, (kind, blocks) in runs.items()}
        models["gpipe"] = _jax_gpipe()
        states = {key: {k: np.asarray(v.value)
                        for k, v in model.state_dict().items()}
                  for key, model in models.items()}
        np.savez(work / "states.npz",
                 **{k: np.asarray(v, dtype=object)
                    for k, v in states.items()})
    finally:
        (work / "states.ready").touch()
    try:
        refs = {"gpt4": _jax_run(models["gpt4"], GPTForCausalLMPipe.loss,
                                 (ids32, ids32), [1, 1, 1, 1],
                                 ckpt=str(work / "jax_ckpt"))}
    finally:
        (work / "jax_ckpt.ready").touch()
    refs["jax_ckpt_loss2"] = refs["gpt4"][0][1]
    refs["jax_pp2"] = _jax_run(_jax_pipe("gpt", 4), GPTForCausalLMPipe.loss,
                               (ids32, ids32), [1, 2, 1, 1])
    for key in ("gpt5", "bert", "ernie"):
        kind = runs[key][0]
        loss_fn = GPTForCausalLMPipe.loss if kind == "gpt" \
            else BertForPretrainingPipe.mlm_loss
        labels = ids32 if kind == "gpt" else _mlm_labels().astype(np.int32)
        refs[key] = _jax_run(models[key], loss_fn, (ids32, labels),
                             [1, 1, 1, 1])
    refs["gpipe"] = _jax_run(models["gpipe"], paddle.nn.functional.mse_loss,
                             _gpipe_data(), [1, 1, 1, 1])
    wait()
    results = json.loads((work / "results.json").read_text())
    # the port's one-process runs of each case (no pp: the sequential
    # path), the same layout
    port = {case: _train(case, states[kind if kind != "gpt"
                                      else f"gpt{blocks}"], None, mesh=False)
            for case, (kind, blocks, *_) in CASES.items()}
    port["gpipe"] = _gpipe(states["gpipe"], None, mesh=False)
    return work, states, results, (refs, port)


def _port_params(path):
    from paddle_tpu_torch.distributed import checkpoint

    arrays, extra = checkpoint.load_state(str(path), device="cpu")
    return {k[len("param/"):]: v.numpy() for k, v in arrays.items()
            if k.startswith("param/")}, arrays, extra


def _distance(losses, params, ref):
    ref_losses, ref_params = ref
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    assert set(params) == set(ref_params)
    param = max(float(np.abs(params[n] - ref_params[n]).max())
                for n in ref_params)
    return loss_rel, param


def _within(dist):
    return dist[0] <= LOSS_RTOL and dist[1] <= PARAM_ATOL


def _case_params(work, case, states):
    """The case's trained parameters and the JAX reference's, per block
    where the layouts differ."""
    kind, blocks, _, V = CASES[case][:4]
    params, _, _ = _port_params(work / case)
    if V == 1:
        return params, None
    model = _port_pipe(kind, blocks, V,
                       states["gpt4" if kind == "gpt" else kind])
    return _per_block(params, model), _port_pipe(kind, blocks, 1,
                                                 states["gpt4"])


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_run_matches_the_jax_sequential_run(run, case):
    """Against the JAX sequential run (per block where the layouts
    differ) and against the port's own one-process run in the case's
    layout (torch's kernels on both sides: the tighter gate)."""
    work, states, results, (refs, port) = run
    kind, blocks = CASES[case][:2]
    key = kind if kind != "gpt" else f"gpt{blocks}"
    params, _, _ = _port_params(work / case)
    assert _within(_distance(results[case], params, port[case])), (
        case, _distance(results[case], params, port[case]))
    mine, v1 = _case_params(work, case, states)
    ref_losses, ref_params = refs[key]
    if v1 is not None:
        ref_params = _per_block(ref_params, v1)
    dist = _distance(results[case], mine, (ref_losses, ref_params))
    assert _within(dist), (case, dist)
    assert results[case][-1] < results[case][0]


def test_pp2_matches_the_jax_pipelined_run(run):
    """The JAX pipelined schedule compiles on a pure ``[1, 2, 1, 1]``
    mesh: the port's dp2 x pp2 run equals it too."""
    work, _, results, (refs, _) = run
    params, _, _ = _port_params(work / "pp2")
    dist = _distance(results["pp2"], params, refs["jax_pp2"])
    assert _within(dist), dist


def test_gpipe_matches_the_jax_sequential_run(run):
    work, _, results, (refs, port) = run
    params, _, _ = _port_params(work / "gpipe")
    assert _within(_distance(results["gpipe"], params, port["gpipe"]))
    assert _within(_distance(results["gpipe"], params, refs["gpipe"]))


def test_fleet_pp_degree_trains_like_the_trainer(run):
    _, _, results, _ = run
    assert results["fleet_degrees"][:2] == [2, 2]
    assert results["fleet_degrees"][3] == [2, 2, 1, 1]
    assert results["fleet"] == results["pp2"]


def test_pp2_checkpoint_crosses_with_jax(run):
    """The gang's pp2 checkpoint (stacked ``stage__*`` parameters written
    in their pp windows) loads in JAX ``load_state`` and in one process
    bitwise; the JAX sequential trainer's checkpoint loads into the
    gang, which saves it again bitwise and steps on as JAX did."""
    import importlib

    work, _, results, (refs, _) = run
    jckpt = importlib.import_module("paddle_tpu.distributed.checkpoint")
    jarrays, jextra = jckpt.load_state(str(work / "pp2"))
    _, arrays, extra = _port_params(work / "pp2")
    assert set(jarrays) == set(arrays)
    assert any(k.startswith("param/stage__") for k in arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(jarrays[k]), v.numpy(), k)
    assert jextra["step"] == extra["step"] == STEPS
    _, jax_arrays, _ = _port_params(work / "jax_ckpt")
    _, again, extra = _port_params(work / "jax_resaved")
    assert results["jax_ckpt_step"] == 1 and extra["step"] == 1
    for k, v in jax_arrays.items():
        np.testing.assert_array_equal(again[k].numpy(), v.numpy(), k)
    np.testing.assert_allclose(results["after_jax_ckpt"],
                               refs["jax_ckpt_loss2"], rtol=LOSS_RTOL)


def _dropout_distance(work, states, fault):
    """(loss, gradient) distances of dp rank 0's pipelined ranks (pp 0
    and 1) from the one-process sequential run on the same chunk
    seeds."""
    model = _port_pipe("gpt", 4, 1, states["gpt4"], dropout=0.1)
    ids = torch.as_tensor(_ids()).chunk(2)[0]
    loss, grads = model.loss_and_grads(None, (ids, ids), 1234)
    loss_rel = grad = 0.0
    for pp_rank, rank in ((0, 0), (1, 1)):     # dp 0: ranks 0 and 1
        got = np.load(work / f"dropout{int(fault)}.rank{rank}.npz")
        loss_rel = max(loss_rel, abs(float(got["loss"]) - loss.item())
                       / loss.item())
        for n, g in grads.items():
            want = g.numpy()[pp_rank:pp_rank + 1] \
                if n.startswith("stage__") else g.numpy()
            grad = max(grad, float(np.abs(got[n] - want).max()))
    return loss_rel, grad


def test_dropout_recompute_repeats_the_forward_masks(run):
    work, states, _, _ = run
    loss_rel, grad = _dropout_distance(work, states, False)
    assert loss_rel <= LOSS_RTOL and grad <= GRAD_ATOL, (loss_rel, grad)


@pytest.mark.parametrize("fault", ["no_extras_sum", "unseeded_recompute"])
def test_planted_fault_fails_the_parity_gate(run, fault):
    work, states, results, (_, port) = run
    if fault == "unseeded_recompute":
        assert _dropout_distance(work, states, True)[1] > GRAD_ATOL
        return
    params, _, _ = _port_params(work / fault)
    dist = _distance(results[fault], params, port["pp2"])
    assert not _within(dist), dist


# -- no gang: segmentation and the schedule's constants --------------------

def test_pipeline_layer_segments_like_the_reference():
    """``PipelineLayer``'s bounds for ``uniform``, ``param`` and
    ``layer:<Class>`` equal the JAX package's."""
    import paddle_tpu as paddle
    from paddle_tpu import nn as jnn
    from paddle_tpu.distributed.meta_parallel.parallel_layers import \
        PipelineLayer as JaxPipelineLayer

    from paddle_tpu_torch.distributed.meta_parallel import (LayerDesc,
                                                            PipelineLayer,
                                                            SharedLayerDesc)
    from paddle_tpu_torch.nn.layers import Linear, Tanh

    widths = [8, 32, 8, 16, 8, 8, 64]
    for method in ("uniform", "param", "layer:Tanh"):
        for stages in (2, 3):
            paddle.seed(0)
            jax_layers = []
            port_layers = []
            for w in widths:
                jax_layers += [jnn.Linear(w, w), jnn.Tanh()]
                port_layers += [Linear(w, w, device="cpu"), Tanh()]
            ref = JaxPipelineLayer(jax_layers, num_stages=stages,
                                   seg_method=method)
            mine = PipelineLayer(port_layers, num_stages=stages,
                                 seg_method=method)
            assert mine.segment_parts == ref.segment_parts, (method, stages)
    shared = PipelineLayer([SharedLayerDesc("emb", Linear, 4, 4,
                                            device="cpu"),
                            LayerDesc(Tanh),
                            SharedLayerDesc("emb", Linear, 4, 4,
                                            device="cpu")], num_stages=1)
    assert shared.get_stage_layers(0)[0] is shared.get_stage_layers(0)[2]
    assert len(list(shared.parameters())) == 2


def test_stage_counts_and_schedule_constants_match_the_reference():
    """``_stage_counts`` (13 blocks at pp 4, and at pp 2 x V 2),
    ``_virtual_order`` and ``schedule_constants`` equal the JAX
    package's; the reference's refusals stay."""
    from paddle_tpu.models import GPTForCausalLMPipe as JaxPipe
    from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

    from paddle_tpu_torch.models import GPTForCausalLMPipe

    for blocks, S, M, V in [(13, 4, 4, 1), (13, 2, 4, 2), (8, 2, 4, 1),
                            (8, 4, 8, 1), (8, 2, 4, 2), (8, 2, 8, 2),
                            (8, 4, 8, 2)]:
        jcfg = jax_gpt_tiny()
        jcfg.num_layers = blocks
        ref = JaxPipe(jcfg, S, M, V)
        mine = GPTForCausalLMPipe(_gpt_cfg(blocks), S, M, V, device="cpu")
        assert mine._stage_counts == ref._stage_counts
        assert mine._virtual_order == ref._virtual_order
        assert mine.schedule_constants() == ref.schedule_constants()
        assert sorted(n for n, _ in mine.named_parameters()) == sorted(
            ref.state_dict())
    with pytest.raises(ValueError, match="at least one body block"):
        GPTForCausalLMPipe(_gpt_cfg(3), num_stages=4, num_microbatches=2,
                           device="cpu")
    with pytest.raises(ValueError, match="divisible by num_stages"):
        GPTForCausalLMPipe(_gpt_cfg(8), 2, 3, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="position_ids"):
        GPTForCausalLMPipe(_gpt_cfg(2), device="cpu")(
            torch.zeros(1, 4, dtype=torch.long), torch.zeros(1, 4))
