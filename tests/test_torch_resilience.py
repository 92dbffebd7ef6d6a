"""Fault-tolerant training of the port (``paddle_tpu_torch.distributed.
resilience``, ``testing.fault_injection``, ``core.flags``) against the
JAX package.

Each single-device test of ``tests/test_resilience.py`` runs on the
port: retries, checksums and fallback restore, the crash-safe commit,
retention, the retried shard write and host barrier, the SIGTERM
handler. The anomaly policies run a JAX ``ShardedTrainer`` and the port's
side by side (``nn.Linear(4, 4)``, AdamW, one-device mesh, the same
weights copied by name) on the same planted batches: the decisions, the
``anomaly_stats``, the step counts and the losses agree (fp32, the same
sequence of operations but for summation order: rtol 1e-5), and a
skipped step leaves the parameters and AdamW state bitwise as they were.
Both packages' ``GradScaler`` warn with ``TransientFailureWarning``.
"""

import os
import signal

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import CheckpointManager as JaxManager
from paddle_tpu.distributed import RetentionPolicy as JaxRetention
from paddle_tpu.distributed import ShardedTrainer as JaxTrainer
from paddle_tpu.distributed import TransientFailureWarning as JaxTFW
from paddle_tpu.distributed import build_mesh
from paddle_tpu.testing import fault_injection as jfi

import paddle_tpu_torch as ptt
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.distributed import (AnomalyConfig, CheckpointManager,
                                          RetentionPolicy, ShardedTrainer,
                                          TransientFailureWarning, checkpoint,
                                          retry_call)
from paddle_tpu_torch.distributed.checkpoint import CheckpointCorruptError
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.testing import fault_injection as fi

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fast_backoff():
    """Millisecond backoff in both packages, so retries don't sleep."""
    old, jold = (ptt.get_flags(["FLAGS_io_backoff_base_ms"]),
                 paddle.get_flags(["FLAGS_io_backoff_base_ms"]))
    ptt.set_flags({"FLAGS_io_backoff_base_ms": 1})
    paddle.set_flags({"FLAGS_io_backoff_base_ms": 1})
    yield
    ptt.set_flags(old)
    paddle.set_flags(jold)


def _mse(out, label):
    d = out - label
    return (d * d).mean()


def _pair(seed=0, lr=0.05):
    """A JAX trainer and the port's on the same Linear(4, 4) weights."""
    paddle.seed(seed)
    jm = jnn.Linear(4, 4)
    jm.train()
    mesh = build_mesh([1, 1, 1, 1], ["dp", "pp", "sharding", "mp"],
                      devices=np.array(jax.devices()[:1]))
    jt = JaxTrainer(jm, paddle.optimizer.AdamW(
        learning_rate=lr, parameters=jm.parameters()), _mse, mesh)
    pm = Linear(4, 4, device="cpu")
    pm.set_state_dict({k: np.asarray(v.value)
                       for k, v in jm.state_dict().items()})
    pm.train()
    pt = ShardedTrainer(pm, AdamW(learning_rate=lr,
                                  parameters=pm.named_parameters()), _mse)
    return jt, pt


def _seeded(layer, seed):
    """Seeded weights: the port's ``Linear`` leaves its weight
    uninitialized (ROADMAP Queue 3)."""
    rs = np.random.RandomState(seed)
    layer.set_state_dict({n: rs.uniform(-0.5, 0.5, t.shape).astype(
        np.float32) for n, t in layer.state_dict().items()})
    return layer


def _port(seed=0, lr=0.05):
    pm = _seeded(Linear(4, 4, device="cpu"), seed)
    pm.train()
    return ShardedTrainer(pm, AdamW(learning_rate=lr,
                                    parameters=pm.named_parameters()), _mse)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(8, 4).astype(np.float32)
    w = rs.randn(4, 4).astype(np.float32)
    return x, (x @ w).astype(np.float32)


def _state(trainer):
    """Every parameter and optimizer slot of a port trainer, copied."""
    out = {f"param/{n}": p.detach().clone()
           for n, p in trainer.param_tensors.items()}
    out.update({f"opt/{n}/{s}": v.clone()
                for n, st in trainer._opt_states().items()
                for s, v in st.items()})
    return out


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _corrupt(vdir, fname="shard-0.npz"):
    target = os.path.join(vdir, fname)
    with open(target, "r+b") as f:
        f.seek(max(0, os.path.getsize(target) // 2))
        f.write(b"\xde\xad\xbe\xef")


# -- flags and fault injection -----------------------------------------------

def test_flags_match_the_reference():
    names = ["FLAGS_io_max_retries", "FLAGS_io_backoff_base_ms",
             "FLAGS_ckpt_verify"]
    defaults = {n: flags._REGISTRY._specs[n].default for n in names}
    from paddle_tpu.core import flags as jflags

    assert defaults == {n: jflags._REGISTRY._specs[n].default for n in names}
    old = ptt.get_flags(names)
    try:
        ptt.set_flags({"FLAGS_io_max_retries": "5", "FLAGS_ckpt_verify": 0})
        assert ptt.get_flags(names)["FLAGS_io_max_retries"] == 5
        assert flags.get_flag("FLAGS_ckpt_verify") is False
        assert flags.flags_snapshot()["FLAGS_io_max_retries"] == 5
        with pytest.raises(KeyError):
            ptt.set_flags({"FLAGS_unknown": 1})
        with pytest.raises(TypeError):
            ptt.set_flags({"FLAGS_io_max_retries": [1]})
    finally:
        ptt.set_flags(old)
    os.environ["FLAGS_port_test_only"] = "off"
    try:
        assert flags.define_flag("FLAGS_port_test_only", True) is False
    finally:
        del os.environ["FLAGS_port_test_only"]
        flags._REGISTRY._specs.pop("FLAGS_port_test_only")
        flags._REGISTRY._values.pop("FLAGS_port_test_only")
    assert set(flags.__all__) == set(jflags.__all__)


def test_nan_batch_poisons_float_leaves_only():
    batch = (torch.ones(2, 3), np.ones(3, np.float32),
             torch.arange(3), np.arange(4), [torch.ones(1)])
    with fi.inject("trainer:batch", fi.nan_batch(),
                   when=lambda c: c["step"] == 1) as inj:
        assert fi.transform("trainer:batch", batch, step=0) is batch
        out = fi.transform("trainer:batch", batch, step=1)
    assert inj.fired == 1 and not fi.armed("trainer:batch")
    assert torch.isnan(out[0]).all() and np.isnan(out[1]).all()
    assert out[2] is batch[2] and out[3] is batch[3]
    assert torch.isnan(out[4][0]).all()


# -- retry/backoff ------------------------------------------------------------

def test_retry_call_retries_then_succeeds():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    with pytest.warns(TransientFailureWarning, match="transient"):
        assert retry_call(flaky, retries=3, base_delay=0.001) == "ok"
    assert calls["n"] == 3


def test_retry_call_budget_exhausted():
    def always():
        raise OSError("down")

    with pytest.warns(TransientFailureWarning, match=r"attempt 2/3"):
        with pytest.raises(OSError, match="down"):
            retry_call(always, retries=2, base_delay=0.001)


def test_retry_call_injected_crash_not_absorbed():
    def crash():
        raise fi.InjectedCrash("preempted")

    with pytest.raises(fi.InjectedCrash):
        retry_call(crash, retries=5, base_delay=0.001)


# -- checksums, fallback restore, commit protocol -----------------------------

def test_checksum_mismatch_detected(tmp_path):
    checkpoint.save_state({"w": torch.arange(64, dtype=torch.float32)},
                          str(tmp_path), extra={"step": 1}, version=1)
    _corrupt(str(tmp_path / "v000000000001"))
    with pytest.raises(CheckpointCorruptError, match="checksum mismatch"):
        checkpoint.load_state(str(tmp_path), device="cpu")
    assert ptt.get_flags(["FLAGS_ckpt_verify"])["FLAGS_ckpt_verify"]


def test_restore_falls_back_past_corrupt_version(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=5, async_save=False)
    mgr.save(state={"w": torch.full((4,), 1.0)}, step=1)
    mgr.save(state={"w": torch.full((4,), 2.0)}, step=2)
    _corrupt(str(tmp_path / "v000000000002"))
    with pytest.warns(TransientFailureWarning, match="integrity"):
        arrays, extra = mgr.restore(device="cpu")
    assert torch.equal(arrays["w"], torch.full((4,), 1.0))
    assert extra["step"] == 1
    # the JAX manager falls back to the same version of the same store
    with pytest.warns(JaxTFW, match="integrity"):
        jarrays, jextra = JaxManager(str(tmp_path)).restore()
    np.testing.assert_array_equal(np.asarray(jarrays["w"]), np.full(4, 1.0))
    assert jextra == extra


def test_restore_all_versions_corrupt_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(state={"w": torch.zeros(4)}, step=1)
    _corrupt(str(tmp_path / "v000000000001"))
    with pytest.warns(TransientFailureWarning):
        with pytest.raises(CheckpointCorruptError, match="every committed"):
            mgr.restore(device="cpu")


def test_restore_drains_an_in_flight_save(tmp_path):
    """A save still committing (its commit held back) is drained before
    the versions are listed, so restore returns it; a drained save that
    failed is warned about and the older version restores."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(state={"w": torch.full((4,), 1.0)}, step=1)
    with fi.inject("ckpt:pre_commit", fi.sleep_(0.3)):
        mgr.save(state={"w": torch.full((4,), 2.0)}, step=2)
        assert mgr._checkpointer.in_flight
        arrays, extra = mgr.restore(device="cpu")
    assert extra["step"] == 2 and torch.equal(arrays["w"],
                                              torch.full((4,), 2.0))
    with fi.inject("ckpt:pre_commit", fi.raise_(OSError("store gone"))):
        mgr.save(state={"w": torch.full((4,), 3.0)}, step=3)
        with pytest.warns(TransientFailureWarning, match="store gone"):
            arrays, extra = mgr.restore(device="cpu")
    assert extra["step"] == 2
    mgr.close()


def test_crash_between_write_and_commit_resumes_bit_exact(tmp_path):
    """A save killed between the shard write and COMMIT leaves the store
    restoring the previous committed version bit-exactly: parameters,
    AdamW state, step and torch's generator; the resumed step replays
    bit-exactly against a clean restore."""
    x, y = _batch()
    t1 = _port(seed=0)
    mgr = CheckpointManager(str(tmp_path), trainer=t1, async_save=False)
    t1.train_step(x, y)
    t1.train_step(x, y)
    mgr.save()
    saved = _state(t1)
    rng = checkpoint.save_rng_state()
    t1.train_step(x, y)
    with fi.inject("ckpt:pre_commit",
                   fi.raise_(fi.InjectedCrash("preempted mid-save"))):
        with pytest.raises(fi.InjectedCrash):
            mgr.save()
    assert (tmp_path / "v000000000003.staging").exists()
    assert [v for v, _ in checkpoint.list_versions(str(tmp_path))] == [2]
    torch.manual_seed(99)                       # move the generator on
    t2 = _port(seed=123)
    assert CheckpointManager(str(tmp_path), trainer=t2).restore() == 2
    assert t2.step_count == 2 and t2.optimizer._global_step == 2
    _same(_state(t2), saved)
    assert checkpoint.save_rng_state() == rng
    ref = _port(seed=0)
    CheckpointManager(str(tmp_path), trainer=ref).restore()
    assert torch.equal(t2.train_step(x, y), ref.train_step(x, y))
    _same(_state(t2), _state(ref))


@pytest.mark.parametrize("keep_last,keep_every", [(2, 4), (3, 0), (0, 3)])
def test_retention_keeps_exact_set(tmp_path, keep_last, keep_every):
    """keep-last + keep-every over steps 1..8: the port's store keeps the
    set the JAX policy names ({4, 7, 8} for keep-last 2, keep-every 4)."""
    mgr = CheckpointManager(str(tmp_path), keep_last=keep_last,
                            keep_every=keep_every, async_save=False)
    for step in range(1, 9):
        mgr.save(state={"w": torch.full((4,), float(step))}, step=step)
    mgr.close()
    want = sorted(JaxRetention(keep_last, keep_every).survivors(range(1, 9)))
    assert [v for v, _ in checkpoint.list_versions(str(tmp_path))] == want
    assert sorted(RetentionPolicy(keep_last, keep_every).survivors(
        range(1, 9))) == want
    arrays, extra = mgr.restore(device="cpu")
    assert extra["step"] == 8 and torch.equal(arrays["w"],
                                              torch.full((4,), 8.0))


def test_retention_policy_survivors():
    rp = RetentionPolicy(keep_last=3, keep_every=10)
    assert rp.survivors([10, 12, 17, 20, 23, 25, 26]) == {10, 20, 23, 25, 26}
    assert RetentionPolicy(keep_last=0).survivors([1, 2, 3]) == {1, 2, 3}


def test_shard_write_retry(tmp_path):
    with fi.inject("ckpt:shard_write", fi.raise_(OSError("flaky store")),
                   times=1) as inj:
        with pytest.warns(TransientFailureWarning, match="flaky store"):
            checkpoint.save_state({"w": torch.ones(4)}, str(tmp_path),
                                  extra={"step": 1}, version=1)
    assert inj.fired == 1
    arrays, _ = checkpoint.load_state(str(tmp_path), device="cpu")
    assert torch.equal(arrays["w"], torch.ones(4))


def test_host_barrier_retry_async(tmp_path):
    ac = checkpoint.AsyncCheckpointer()
    with fi.inject("ckpt:host_barrier", fi.raise_(TimeoutError("slow peer")),
                   times=2) as inj:
        with pytest.warns(TransientFailureWarning, match="slow peer"):
            ac.save({"w": torch.full((2,), 7.0)}, str(tmp_path),
                    extra={"step": 1})
            ac.wait_until_finished()
    assert inj.fired == 2
    arrays, _ = checkpoint.load_state(str(tmp_path), device="cpu")
    assert torch.equal(arrays["w"], torch.full((2,), 7.0))


def test_host_barrier_hang_surfaces_after_budget(tmp_path):
    ac = checkpoint.AsyncCheckpointer()
    with fi.inject("ckpt:host_barrier", fi.raise_(TimeoutError("hung"))):
        # the commit thread warns on each retry: the capture must be
        # live before save() starts it, or a thread that finishes its
        # retries first leaves nothing to catch
        with pytest.warns(TransientFailureWarning):
            ac.save({"w": torch.ones(2)}, str(tmp_path), extra={"step": 1})
            with pytest.raises(TimeoutError, match="hung"):
                ac.wait_until_finished()
    assert not ac.in_flight


# -- anomaly policies, held to the JAX trainer --------------------------------

def _both_steps(jt, pt, x, y, n, action=None, **when):
    """``n`` steps of both trainers, with ``action(package's
    fault_injection)`` armed on each package's ``trainer:batch`` (none
    when ``action`` is None); returns both losses."""
    from contextlib import nullcontext

    jl, pl = [], []
    for trainer, mod, out in ((jt, jfi, jl), (pt, fi, pl)):
        armed = (nullcontext() if action is None
                 else mod.inject("trainer:batch", action(mod), **when))
        with armed:
            for _ in range(n):
                out.append(float(np.asarray(trainer.train_step(x, y))))
    return jl, pl


def _check_same(jt, pt, jl, pl):
    assert jt.anomaly_stats == pt.anomaly_stats
    assert jt.step_count == pt.step_count
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for n, p in pt.param_tensors.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jt.params[n]), rtol=1e-5,
                                   atol=1e-6)


def test_skip_step_policy():
    """NaN gradients at step 2 under 'skip_step': both trainers count
    the step and drop the update; the port's parameters and AdamW state
    stay bitwise; both carry on alike."""
    x, y = _batch()
    jt, pt = _pair()
    jt.enable_anomaly_policy(policy="skip_step")
    pt.enable_anomaly_policy(policy="skip_step")
    _check_same(jt, pt, *_both_steps(jt, pt, x, y, 2))
    before = _state(pt)
    with pytest.warns((TransientFailureWarning, JaxTFW),
                      match="update dropped"):
        jl, pl = _both_steps(jt, pt, x, y, 1, lambda m: m.nan_batch(),
                             when=lambda c: c["step"] == 2)
    assert np.isnan(jl[0]) and np.isnan(pl[0])
    assert pt.step_count == jt.step_count == 3
    assert pt.anomaly_stats == jt.anomaly_stats == {
        "skipped": 1, "rollbacks": 0, "consecutive_bad": 1}
    _same(_state(pt), before)
    jl, pl = _both_steps(jt, pt, x, y, 2)
    assert np.isfinite(pl).all()
    _check_same(jt, pt, jl, pl)
    assert pt.anomaly_stats["consecutive_bad"] == 0


def test_raise_policy():
    x, y = _batch()
    jt, pt = _pair()
    for t, mod in ((jt, jfi), (pt, fi)):
        t.enable_anomaly_policy(policy="raise")
        t.train_step(x, y)
        with mod.inject("trainer:batch", mod.nan_batch()):
            with pytest.raises(FloatingPointError, match="anomalous"):
                t.train_step(x, y)
    assert pt.step_count == jt.step_count == 1


def test_rollback_policy(tmp_path):
    """Two consecutive bad steps under 'rollback' (rollback_after=2)
    restore the last good checkpoint in both packages, each from its own
    store; the port's state comes back bitwise and both carry on."""
    x, y = _batch()
    jt, pt = _pair()
    jmgr = JaxManager(str(tmp_path / "jax"), async_save=False)
    pmgr = CheckpointManager(str(tmp_path / "port"), async_save=True)
    jt.enable_anomaly_policy(policy="rollback", rollback_after=2,
                             checkpoint_manager=jmgr)
    pt.enable_anomaly_policy(AnomalyConfig(policy="rollback",
                                           rollback_after=2),
                             checkpoint_manager=pmgr)
    _both_steps(jt, pt, x, y, 2)
    jmgr.save()
    pmgr.save()
    saved = _state(pt)
    with pytest.warns((TransientFailureWarning, JaxTFW), match="rolled back"):
        jl, pl = _both_steps(jt, pt, x, y, 2, lambda m: m.nan_batch(),
                             times=2)
    assert pt.step_count == jt.step_count == 2
    assert pt.anomaly_stats == jt.anomaly_stats == {
        "skipped": 2, "rollbacks": 1, "consecutive_bad": 0}
    _same(_state(pt), saved)
    jl, pl = _both_steps(jt, pt, x, y, 1)
    assert np.isfinite(pl).all() and pt.step_count == 3
    _check_same(jt, pt, jl, pl)
    pmgr.close()


def test_loss_spike_detection():
    """A finite but exploding loss (>> the running median) is dropped by
    both trainers alike."""
    x, y = _batch()
    jt, pt = _pair(lr=1e-3)
    for t in (jt, pt):
        t.enable_anomaly_policy(policy="skip_step", spike_window=4,
                                spike_factor=10.0)
    _check_same(jt, pt, *_both_steps(jt, pt, x, y, 4))
    before = _state(pt)

    def explode(mod):
        return lambda ctx: (ctx["value"][0] * 1e4, ctx["value"][1])

    with pytest.warns((TransientFailureWarning, JaxTFW),
                      match="update dropped"):
        jl, pl = _both_steps(jt, pt, x, y, 1, explode, times=1)
    assert np.isfinite(pl[0]) and pl[0] > 1e6
    assert pt.anomaly_stats == jt.anomaly_stats
    assert pt.anomaly_stats["skipped"] == 1
    _same(_state(pt), before)


class _Tracking(Linear):
    """Linear(4, 4) with a buffer its forward updates (a running mean of
    the inputs, as a norm layer's statistics)."""

    def __init__(self):
        super().__init__(4, 4, device="cpu")
        _seeded(self, 0)
        self.register_buffer("mean", torch.zeros(4))

    def forward(self, x):
        with torch.no_grad():
            self.mean.mul_(0.9).add_(0.1 * x.mean(0))
        return super().forward(x)


@pytest.mark.parametrize("policy", ["skip_step", "raise"])
def test_bad_step_keeps_buffers_and_checkpoints_carry_them(tmp_path,
                                                          policy):
    """A bad step puts the buffers back too, as the reference's guarded
    commit keeps them; ``buf/<name>`` rides in the checkpoint."""
    x, y = _batch()
    m = _Tracking()
    t = ShardedTrainer(m, AdamW(0.05, parameters=m.parameters()), _mse)
    t.enable_anomaly_policy(policy=policy)
    t.train_step(x, y)
    before = m.mean.clone()
    with fi.inject("trainer:batch", fi.nan_batch()):
        with pytest.warns(TransientFailureWarning) if policy == "skip_step" \
                else pytest.raises(FloatingPointError):
            t.train_step(x, y)
    assert torch.equal(m.mean, before)
    t.save_checkpoint(str(tmp_path))
    other = _Tracking()
    ShardedTrainer(other, AdamW(0.05, parameters=other.parameters()),
                   _mse).load_checkpoint(str(tmp_path))
    assert torch.equal(other.mean, before) and other.mean.any()


def test_policy_refusals_match_the_reference(tmp_path):
    from paddle_tpu_torch.distributed import DistributedStrategy

    pt = _port()
    with pytest.raises(ValueError, match="CheckpointManager"):
        pt.enable_anomaly_policy(policy="rollback")
    with pytest.raises(ValueError, match="unknown policy"):
        AnomalyConfig(policy="ignore")
    with pytest.raises(ValueError, match="rollback_after"):
        AnomalyConfig(rollback_after=0)
    pm = Linear(4, 4, device="cpu")
    st = DistributedStrategy(gradient_merge=True,
                             gradient_merge_configs={"k_steps": 2})
    gm = ShardedTrainer(pm, SGD(0.1, parameters=pm.parameters()), _mse,
                        strategy=st)
    with pytest.raises(ValueError, match="gradient_merge"):
        gm.enable_anomaly_policy(policy="skip_step")


# -- preemption ---------------------------------------------------------------

def test_sigterm_drains_and_writes_emergency_checkpoint(tmp_path):
    x, y = _batch()
    t = _port()
    mgr = CheckpointManager(str(tmp_path), trainer=t, async_save=True)
    mgr.install_preemption_handler(exit_after_save=False)
    try:
        t.train_step(x, y)
        mgr.save()  # async save in flight while the signal lands
        with pytest.warns(TransientFailureWarning, match="preemption"):
            fi.simulate_preemption()
        assert mgr.preempted
        versions = [v for v, _ in checkpoint.list_versions(str(tmp_path))]
        assert versions and versions[-1] == 1
    finally:
        mgr.close()
    t2 = _port(seed=7)
    assert CheckpointManager(str(tmp_path), trainer=t2).restore() == 1
    _same(_state(t2), _state(t))


def test_preemption_handler_uninstalls_cleanly(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    prev = signal.getsignal(signal.SIGTERM)
    mgr.install_preemption_handler(exit_after_save=False)
    assert signal.getsignal(signal.SIGTERM) is not prev
    mgr.uninstall_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) == prev


def test_maybe_save_every_steps(tmp_path):
    x, y = _batch()
    t = _port()
    with CheckpointManager(str(tmp_path), trainer=t, every_steps=2,
                           async_save=True) as mgr:
        saved = []
        for _ in range(5):
            t.train_step(x, y)
            saved.append(mgr.maybe_save())
        assert saved == [False, True, False, True, False]
        assert not mgr.maybe_save()       # step 5: not a multiple
    assert [v for v, _ in checkpoint.list_versions(str(tmp_path))] == [2, 4]


# -- GradScaler ---------------------------------------------------------------

def test_grad_scaler_skip_warns_transient_failure_in_both_packages():
    """An inf loss: both scalers skip the step with a
    TransientFailureWarning of the same text, and nothing moves."""
    jm = jnn.Linear(2, 2)
    jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=jm.parameters())
    jscaler = paddle.amp.GradScaler(init_loss_scaling=4.0)
    jx = paddle.to_tensor(np.ones((2, 2), np.float32))
    jscaler.scale((jm(jx) * float("inf")).mean()).backward()
    with pytest.warns(JaxTFW, match="update skipped") as jrec:
        jscaler.step(jopt)
    pm = _seeded(Linear(2, 2, device="cpu"), 0)
    popt = SGD(learning_rate=0.1, parameters=pm.parameters())
    scaler = GradScaler(init_loss_scaling=4.0)
    scaler.scale((pm(torch.ones(2, 2)) * float("inf")).mean()).backward()
    before = [p.detach().clone() for p in pm.parameters()]
    with pytest.warns(TransientFailureWarning, match="update skipped") as rec:
        scaler.step(popt)
    scaler.update()
    jscaler.update()
    assert scaler.num_skipped_steps == jscaler.num_skipped_steps == 1
    assert [str(w.message) for w in rec] == [str(w.message) for w in jrec]
    assert all(torch.equal(a, p) for a, p in zip(before, pm.parameters()))
