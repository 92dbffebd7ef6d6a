"""The sequence axis over ``sep`` ranks (ring and Ulysses attention, and
``ShardedTrainer`` cutting the sequence) in a gang of four gloo ranks on
the CPU, against the JAX package.

Attention, at (2, 32, 4, 16) fp32 on ``sep`` 4 (``[4]``) and ``sep`` 2
(``[2, 2]`` over dp x sep), causal and not: every rank passes the whole
q, k and v to ``ring_self_attention`` / ``ulysses_self_attention`` and
back-propagates ``sum(out * cot)``. The outputs are held to the JAX
package's ``ring_self_attention`` / ``ulysses_self_attention`` on its
CPU mesh (sep 4, causal: one call each, their forward only) and to the
JAX plain attention; the gradients to the JAX plain attention's, which
the reference's own ``test_ring_grad_matches_full`` shows its ring
equals (JAX's ring gradient costs 26 s a call here, so it is not
rerun).

Training, gpt_tiny (dropout off) on dp2 x sep2 (``[2, 1, 1, 1, 2]``),
the global batch 8 x 32, two steps of SGD (lr 0.1, weight decay 0.01,
global norm clip 1.0): ring with ``GPTForCausalLM.loss`` (the logits
gathered over ``sep``), ring and Ulysses with the model's own fused loss
(``loss_fn=None``: only the label ids gathered), ring on mp2 x sep2
(the fused loss vocab-parallel), Ulysses on ZeRO-2 x sep2 (sharding 2),
and
``fleet.init(sep_degree=2)`` -> ``distributed_model`` ->
``train_batch``, each against the JAX one-device trainer on the same
weights; a 31-token batch (``sep`` does not divide it) warns and runs
the whole sequence on every sep rank, equal to one process.

Planted faults, each failing the gate the sound run passes: the sep
gradients averaged instead of summed, the logits gather's backward
summed over the ranks instead of keeping this rank's chunk, and the
positions without the chunk's offset.

Tolerances, measured on the CPU: attention outputs within 6.0e-7 of
JAX's (its ring and Ulysses, and its plain attention) and gradients
within 1.2e-6 of the plain attention's (gate 4e-6); training losses
within 1.8e-7 relative and parameters within 7.5e-9 of the JAX trainer
after two steps (gates 1e-6 and 3e-7). The faults land at 5.7e-3
(averaged: losses), 6.8e-4 (summed gather: parameters) and 3.0e-3
(positions: losses).
"""

import json
import warnings

import numpy as np
import pytest
import torch

from test_torch_collective import (WORLD, once_per_session, start_gang,
                                   wait_for)

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

ATTN_ATOL = 4e-6
LOSS_RTOL = 1e-6
PARAM_ATOL = 3e-7
STEPS = 2
AXES = ["dp", "pp", "sharding", "mp", "sep"]
QKV = (2, 32, 4, 16)
ATTN = [(sep, mode, causal) for sep in (4, 2)
        for mode in ("ring", "ulysses") for causal in (True, False)]
# case: (schedule, loss_fn is GPTForCausalLM.loss, mesh, ZeRO stage)
TRAIN = {"ring": ("ring", True, (2, 1, 1, 1, 2), 0),
         "ring_own": ("ring", False, (2, 1, 1, 1, 2), 0),
         "ulysses_own": ("ulysses", False, (2, 1, 1, 1, 2), 0),
         "ring_mp2": ("ring", False, (1, 1, 1, 2, 2), 0),
         "ulysses_zero2": ("ulysses", True, (1, 1, 2, 1, 2), 2)}
FAULTS = ("sep_averaged", "gather_summed", "no_offset")


def _qkv():
    rs = np.random.RandomState(7)
    return [rs.randn(*QKV).astype(np.float32) for _ in range(4)]


def _batch(seq=32):
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 256, (8, seq)).astype(np.int64)
    return ids, ids.copy()


def _attn_key(sep, mode, causal):
    return f"{mode}_sep{sep}_{'causal' if causal else 'full'}"


def _attention(rank, work):
    from paddle_tpu_torch.distributed import (build_mesh,
                                              ring_self_attention,
                                              ulysses_self_attention)

    meshes = {4: build_mesh([4], ["sep"]), 2: build_mesh([2, 2],
                                                         ["dp", "sep"])}
    q, k, v, cot = (torch.tensor(a) for a in _qkv())
    out = {}
    for sep, mode, causal in ATTN:
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn = ring_self_attention if mode == "ring" else \
            ulysses_self_attention
        o = fn(*ts, meshes[sep], is_causal=causal)
        (o * cot).sum().backward()
        key = _attn_key(sep, mode, causal)
        out[key] = o.detach().numpy()
        for name, t in zip("qkv", ts):
            out[f"{key}.d{name}"] = t.grad.numpy()
    if rank == 0:
        np.savez(f"{work}/attention.npz", **out)


def _port_gpt(state):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD

    cfg = gpt_tiny()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    model = GPTForCausalLM(cfg, device="cpu")
    model.set_state_dict(state)
    model.train()
    opt = SGD(learning_rate=0.1, parameters=model.named_parameters(),
              weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    return model, opt


def _train(state, ckpt, mode, own_loss, dims=(2, 1, 1, 1, 2), seq=32,
           zero=0):
    from paddle_tpu_torch.distributed import (DistributedStrategy,
                                              ShardedTrainer, build_mesh,
                                              sequence_parallel_mode)
    from paddle_tpu_torch.models import GPTForCausalLM

    model, opt = _port_gpt(state)
    st = DistributedStrategy()
    if zero:
        st.sharding = True
        st.sharding_configs = {"stage": zero}
    trainer = ShardedTrainer(model, opt,
                             None if own_loss else GPTForCausalLM.loss,
                             mesh=build_mesh(list(dims), AXES)
                             if dims else None, strategy=st)
    with sequence_parallel_mode(mode):
        losses = [float(trainer.train_step(*_batch(seq)))
                  for _ in range(STEPS)]
    trainer.save_checkpoint(ckpt)
    return losses


def _faulty(fault, state, ckpt):
    import importlib

    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed import env as dist_env
    from paddle_tpu_torch.distributed.trainer import ShardedTrainer
    from paddle_tpu_torch.models import gpt

    # the package's ring_attention is the function; the module by path
    ring = importlib.import_module(
        "paddle_tpu_torch.distributed.ring_attention")

    sync = ShardedTrainer._sync_grads

    def summed_gather(ctx, g):
        with dist_env._mesh_scope(ctx.mesh):
            return (collective.reduce_scatter(g.contiguous(),
                                              axis_name=ctx.axis,
                                              scatter_dim=1), None, None)

    patches = {
        "sep_averaged": (ShardedTrainer, "_sync_grads",
                         lambda self, grads: {
                             n: g / 2 for n, g in sync(self, grads).items()}),
        "gather_summed": (ring._SeqGather, "backward",
                          staticmethod(summed_gather)),
        "no_offset": (gpt, "_sep_position_offset", lambda s: 0),
    }
    owner, name, value = patches[fault]
    saved = owner.__dict__[name]
    setattr(owner, name, value)
    try:
        return _train(state, ckpt, "ring", False)
    finally:
        setattr(owner, name, saved)


def _gang_main(rank, work):
    from paddle_tpu_torch.distributed import DistributedStrategy, fleet
    from paddle_tpu_torch.models import GPTForCausalLM

    _attention(rank, work)
    wait_for(f"{work}/init.ready")
    state = dict(np.load(f"{work}/init.npz"))
    out = {}
    for case, (mode, jax_loss, dims, zero) in TRAIN.items():
        out[case] = _train(state, f"{work}/{case}", mode, not jax_loss,
                           dims=dims, zero=zero)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out["ragged"] = _train(state, f"{work}/ragged", "ring", True,
                               seq=31)
    out["ragged_warned"] = any("not divisible by the 'sep' axis"
                               in str(w.message) for w in seen)
    strategy = DistributedStrategy()
    strategy.hybrid_configs = {"sep_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    out["fleet_mesh"] = dict(fleet.get_mesh().shape)
    model, opt = _port_gpt(state)
    dmodel = fleet.distributed_model(model)
    dmodel.prepare(fleet.distributed_optimizer(opt), GPTForCausalLM.loss)
    out["fleet"] = [float(dmodel.train_batch(_batch()))
                    for _ in range(STEPS)]
    for fault in FAULTS:
        out[fault] = _faulty(fault, state, f"{work}/{fault}")
    if rank == 0:
        with open(f"{work}/results.json", "w") as f:
            json.dump(out, f)


def _jax_train(state, seq=32):
    import jax

    import paddle_tpu as paddle
    from paddle_tpu.distributed import ShardedTrainer as JaxTrainer
    from paddle_tpu.distributed import build_mesh as jax_mesh
    from paddle_tpu.models import GPTForCausalLM as JaxGPT
    from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

    cfg = jax_gpt_tiny()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    model = JaxGPT(cfg)
    model.set_state_dict(state)
    model.train()
    opt = paddle.optimizer.SGD(
        learning_rate=0.1, parameters=model.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    trainer = JaxTrainer(model, opt, JaxGPT.loss,
                         jax_mesh([1, 1, 1, 1], AXES[:4],
                                  devices=jax.devices()[:1]))
    ids, labels = _batch(seq)
    losses = [float(np.asarray(trainer.train_step(ids.astype(np.int32),
                                                  labels.astype(np.int32))))
              for _ in range(STEPS)]
    return losses, {n: np.asarray(v) for n, v in trainer.params.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return once_per_session(tmp_path_factory, "sep_gang", _build)


def _build(work):
    """The JAX weights, the gang, and beside it the JAX one-device
    trainer and attention references."""
    import paddle_tpu as paddle
    from paddle_tpu.models import GPTForCausalLM as JaxGPT
    from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

    # the gang starts at once and reads the weights once they are
    # written (the marker comes even on a failure: the gang then fails)
    wait = start_gang(_gang_main, WORLD, work, str(work))
    try:
        paddle.seed(0)
        state = {k: np.asarray(v.value)
                 for k, v in JaxGPT(jax_gpt_tiny()).state_dict().items()}
        np.savez(work / "init.npz", **state)
    finally:
        (work / "init.ready").touch()
    ref = _jax_train(state)
    jax_attn = {mode: _jax_sep_schedule(mode)
                for mode in ("ring", "ulysses")}
    jax_attn.update({causal: _jax_plain(causal) for causal in (True, False)})
    wait()
    results = json.loads((work / "results.json").read_text())
    return work, state, results, ref, jax_attn


def _jax_sep_schedule(mode):
    """The JAX package's own ring / Ulysses on its CPU mesh (sep 4,
    causal), forward."""
    import jax
    from jax.sharding import Mesh

    from paddle_tpu.distributed import (ring_self_attention,
                                        ulysses_self_attention)

    q, k, v, _ = _qkv()
    mesh = Mesh(np.array(jax.devices()[:4]), ("sep",))
    fn = ring_self_attention if mode == "ring" else ulysses_self_attention
    return np.asarray(fn(q, k, v, mesh, is_causal=True))


def _port_params(path):
    from paddle_tpu_torch.distributed import checkpoint

    arrays, extra = checkpoint.load_state(str(path), device="cpu")
    return {k[len("param/"):]: v.numpy() for k, v in arrays.items()
            if k.startswith("param/")}


def _distance(losses, params, ref):
    ref_losses, ref_params = ref
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    param = max(float(np.abs(params[n] - ref_params[n]).max())
                for n in ref_params)
    return loss_rel, param


def _within(dist):
    return dist[0] <= LOSS_RTOL and dist[1] <= PARAM_ATOL


def _jax_plain(causal):
    """JAX's plain attention and its vjp at the cotangent."""
    import jax

    from paddle_tpu.nn.functional.attention import _sdpa_xla

    q, k, v, cot = _qkv()
    out, pull = jax.vjp(lambda a, b, c: _sdpa_xla(a, b, c, is_causal=causal),
                        q, k, v)
    return np.asarray(out), [np.asarray(g) for g in pull(cot)]


@pytest.mark.parametrize("sep,mode,causal", ATTN)
def test_attention_matches_jax_full_attention(run, sep, mode, causal):
    work = run[0]
    got = np.load(work / "attention.npz")
    key = _attn_key(sep, mode, causal)
    out, grads = run[4][causal]
    np.testing.assert_allclose(got[key], out, atol=ATTN_ATOL, rtol=0)
    for name, g in zip("qkv", grads):
        np.testing.assert_allclose(got[f"{key}.d{name}"], g,
                                   atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_attention_matches_jax_sep_schedule(run, mode):
    """The JAX package's own ring / Ulysses on its CPU mesh (sep 4,
    causal), forward (computed in the fixture, beside the gang)."""
    work = run[0]
    got = np.load(work / "attention.npz")
    np.testing.assert_allclose(got[_attn_key(4, mode, True)], run[4][mode],
                               atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("case", list(TRAIN))
def test_sep_training_matches_the_jax_trainer(run, case):
    work, _, results, ref, _ = run
    dist = _distance(results[case], _port_params(work / case), ref)
    assert _within(dist), (case, dist, (LOSS_RTOL, PARAM_ATOL))
    assert results[case][-1] < results[case][0]


def test_fleet_sep_degree_builds_the_fifth_axis(run):
    _, _, results, _, _ = run
    assert results["fleet_mesh"] == {"dp": 2, "pp": 1, "sharding": 1,
                                     "mp": 1, "sep": 2}
    assert results["fleet"] == results["ring"]


def test_undivided_sequence_warns_and_runs_whole(run, tmp_path):
    work, state, results, _, _ = run
    assert results["ragged_warned"]
    one = _train(state, str(tmp_path / "one"), "ring", True, dims=None,
                 seq=31)
    dist = _distance(results["ragged"], _port_params(work / "ragged"),
                     (one, _port_params(tmp_path / "one")))
    assert _within(dist), dist


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails_the_parity_gate(run, fault):
    work, _, results, ref, _ = run
    dist = _distance(results[fault], _port_params(work / fault), ref)
    assert not _within(dist), (fault, dist)


def test_schedule_reaches_autograd_thread_and_recompute_replay():
    """On the card autograd runs the backward, and so a checkpoint's
    replay of the forward, on its own device thread: the schedule is
    process-wide, and a recompute replays under the schedule and the AMP
    state its forward took, even after both contexts closed."""
    import threading

    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.amp.auto_cast import amp_state
    from paddle_tpu_torch.distributed import (get_sequence_parallel_mode,
                                              sequence_parallel_mode)
    from paddle_tpu_torch.distributed.fleet.utils import recompute

    seen, other = [], []

    def body(x):
        seen.append((get_sequence_parallel_mode(), amp_state().enabled))
        return x.sin() * x

    def on_thread(fn):
        thread = threading.Thread(target=fn)
        thread.start()
        thread.join()

    x = torch.ones(3, requires_grad=True)
    with sequence_parallel_mode("ulysses"), auto_cast(dtype="bfloat16"):
        on_thread(lambda: other.append(get_sequence_parallel_mode()))
        y = recompute(body, x).float().sum()
    on_thread(y.backward)
    assert other == ["ulysses"]
    assert seen == [("ulysses", True), ("ulysses", True)]
    assert get_sequence_parallel_mode() == "ring"
    np.testing.assert_allclose(x.grad.numpy(),
                               np.full(3, np.sin(1) + np.cos(1)), rtol=1e-6)
