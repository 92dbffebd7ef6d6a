"""The port's checkpoints (``paddle_tpu_torch.distributed.checkpoint``
and ``ShardedTrainer.save_checkpoint``/``load_checkpoint``) against the
JAX package's.

Both packages write the same on-disk format, so a checkpoint crosses in
both directions: arrays the JAX package saved under the tests' 8-device
CPU mesh, each sharded its own way, load whole and bitwise in the port
(bf16, integers and scalars included); the port's files load in the JAX
package bitwise; a JAX ``ShardedTrainer`` (gpt_tiny, AdamW on a
``StepDecay`` schedule, one-device mesh) and the port's trainer load
each other's train state (parameters, AdamW slots, ``step``,
``lr_scheduler``) bitwise and continue with losses within
``test_torch_train.py``'s fp32 tolerance (rtol 1e-5); so do O2 models
with bf16 parameters (the first loss after loading within its bf16
tolerance, 2e-2). The single-device tests of ``tests/test_checkpoint.py``
run on the port: the commit protocol, the coverage check, exact resume,
auto-checkpoints, a gradient-merge resume mid-window and the
asynchronous checkpointer, whose snapshot must copy (the port's
optimizer updates tensors in place).

The reference cannot read a bf16 checkpoint, its own included: its
``load_state`` copies the '<V2' entries numpy returns into a bfloat16
buffer, which numpy refuses ("No cast function available";
``test_reference_cannot_read_bf16_checkpoints``). The port->JAX bf16
test patches that one read at test time (``_reference_reads_bf16``).
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.distributed import ShardedTrainer as JaxTrainer
from paddle_tpu.distributed import build_mesh
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

from paddle_tpu_torch.amp import decorate
from paddle_tpu_torch.distributed import (DistributedStrategy,
                                          ShardedTrainer, checkpoint)
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.optimizer import SGD, AdamW, lr

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

jckpt = importlib.import_module("paddle_tpu.distributed.checkpoint")


def _mesh1():
    return build_mesh([1, 1, 1, 1], ["dp", "pp", "sharding", "mp"],
                      devices=np.array(jax.devices()[:1]))


def _ids(seed=0, shape=(4, 16)):
    ids = np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)
    return ids, ids.astype(np.int64)


def _t2np(t):
    """A tensor's exact values as numpy (bf16 through ml_dtypes)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _bits(a):
    return np.asarray(a).reshape(-1).view(np.uint8)


@pytest.fixture
def _reference_reads_bf16(monkeypatch):
    """Repair, at test time only, the reference's bf16 read: its npz
    entries come back as '<V2', viewed here as ml_dtypes.bfloat16."""

    class _Npz:
        def __init__(self, z):
            self.z = z

        def __getitem__(self, key):
            a = self.z[key]
            return a.view(ml_dtypes.bfloat16) if a.dtype == np.dtype("V2") \
                else a

    class _Numpy:
        def __getattr__(self, name):
            return getattr(np, name)

        @staticmethod
        def load(path, *args, **kwargs):
            return _Npz(np.load(path, *args, **kwargs))

    monkeypatch.setattr(jckpt, "np", _Numpy())


# -- arrays --------------------------------------------------------------------

_SHARDED = {
    "w_dp_mp": ((8, 8), np.float32, P("dp", "mp")),
    "w_rows": ((8, 16), np.float32, P("dp", None)),
    "w_zero": ((6, 4, 8), np.float32, P(None, "sharding", "mp")),
    "replicated": ((4, 4), np.float32, P()),
    "bf16_mp": ((4, 8), ml_dtypes.bfloat16, P(None, "mp")),
    "ids": ((8,), np.int32, P("dp")),
    "scalar": ((), np.float32, P()),
}


def test_jax_sharded_save_loads_bitwise_in_the_port(tmp_path):
    """Every piece the JAX package wrote (one per shard, replicas once)
    assembles into the whole array in the port, bit for bit."""
    mesh = build_mesh([2, 1, 2, 2], ["dp", "pp", "sharding", "mp"])
    rs = np.random.RandomState(0)
    want, state = {}, {}
    for name, (shape, dt, spec) in _SHARDED.items():
        a = np.asarray(rs.randn(*shape) * 10).astype(dt)
        want[name] = a
        state[name] = jax.device_put(a, NamedSharding(mesh, spec))
    jckpt.save_state(state, str(tmp_path), extra={"step": 7})
    with open(tmp_path / "v000000000007" / "index-0.json") as f:
        assert len(json.load(f)) > len(_SHARDED)       # real shards
    got, extra = checkpoint.load_state(str(tmp_path), device="cpu")
    assert extra == {"step": 7} and set(got) == set(want)
    for name, a in want.items():
        t = got[name]
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(_bits(_t2np(t)), _bits(a))
    assert got["bf16_mp"].dtype == torch.bfloat16
    assert got["ids"].dtype == torch.int32


def test_port_save_loads_bitwise_in_jax(tmp_path, _reference_reads_bf16):
    """The port's layout is the reference's, and the JAX package reads
    it (with the bf16 repair) bit for bit."""
    rs = np.random.RandomState(1)
    state = {"w": torch.from_numpy(rs.randn(5, 3).astype(np.float32)),
             "h": torch.from_numpy(rs.randn(7).astype(np.float32)).to(
                 torch.bfloat16),
             "f16": torch.ones(3, dtype=torch.float16),
             "n": torch.arange(4), "s": torch.tensor(2.5),
             "np": np.arange(6, dtype=np.int32).reshape(2, 3)}
    checkpoint.save_state(state, str(tmp_path), extra={"step": 3,
                                                       "note": "x"})
    vdir = tmp_path / "v000000000003"
    assert sorted(os.listdir(vdir)) == ["COMMIT-0", "checksums-0.json",
                                        "index-0.json", "meta.json",
                                        "shard-0.npz"]
    meta = json.loads((vdir / "meta.json").read_text())
    assert meta["format"] == "paddle_tpu.sharded.v1" and meta["nprocs"] == 1
    assert meta["arrays"]["h"] == {"shape": [7], "dtype": "bfloat16"}
    assert np.load(vdir / "shard-0.npz")["h#0"].dtype == np.dtype("V2")
    jgot, jextra = jckpt.load_state(str(tmp_path))
    assert jextra == {"step": 3, "note": "x"}
    for name, v in state.items():
        # JAX holds int64 as int32 (x64 off); every other dtype as saved
        want = _t2np(v) if isinstance(v, torch.Tensor) else v
        want = want.astype(jnp.asarray(want).dtype)
        assert np.asarray(jgot[name]).dtype == want.dtype
        np.testing.assert_array_equal(_bits(jgot[name]), _bits(want))
    got, _ = checkpoint.load_state(str(tmp_path), device="cpu")
    for name, v in state.items():
        assert torch.equal(got[name], torch.as_tensor(v))


def test_reference_cannot_read_bf16_checkpoints(tmp_path):
    """The reference's fault, recorded: its own bf16 save does not load
    back (the port reads it)."""
    jckpt.save_state({"w": jnp.arange(4, dtype=jnp.bfloat16)},
                     str(tmp_path))
    with pytest.raises(ValueError, match="No cast function"):
        jckpt.load_state(str(tmp_path))
    got, _ = checkpoint.load_state(str(tmp_path), device="cpu")
    assert torch.equal(got["w"], torch.arange(4, dtype=torch.bfloat16))


def test_partial_coverage_detected(tmp_path):
    checkpoint.save_state({"w": torch.ones(8, 8)}, str(tmp_path))
    vdir = checkpoint._resolve_dir(str(tmp_path))
    idx_path = os.path.join(vdir, "index-0.json")
    with open(idx_path) as f:
        idx = json.load(f)
    idx["w#0"]["bounds"][0] = [0, 4]          # claim half the rows
    with open(idx_path, "w") as f:
        json.dump(idx, f)
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.load_state(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="not fully covered"):
        checkpoint.load_state(str(tmp_path), verify=False, device="cpu")


def test_interrupted_save_keeps_previous_checkpoint(tmp_path):
    checkpoint.save_state({"w": torch.ones(4, 4)}, str(tmp_path),
                          extra={"step": 1}, version=1)
    os.makedirs(tmp_path / "v000000000002.staging")
    got, extra = checkpoint.load_state(str(tmp_path), device="cpu")
    assert torch.equal(got["w"], torch.ones(4, 4)) and extra["step"] == 1
    assert checkpoint.load_meta(str(tmp_path))["extra"] == {"step": 1}


def test_load_refuses_a_mesh_of_more_than_one_device(tmp_path):
    checkpoint.save_state({"w": torch.ones(2)}, str(tmp_path))

    class Mesh:
        size = 4

    with pytest.raises(NotImplementedError, match="mesh"):
        checkpoint.load_state(str(tmp_path), Mesh(), device="cpu")
    Mesh.size = 1
    got, _ = checkpoint.load_state(str(tmp_path), Mesh(), {"w": None},
                                   device="cpu")
    assert torch.equal(got["w"], torch.ones(2))


# -- the asynchronous checkpointer ---------------------------------------------

def test_async_checkpointer_snapshot_isolation(tmp_path):
    """The save copies at call time: a tensor updated in place right
    after ``save`` returns (as the optimizer does) is saved as it was."""
    ac = checkpoint.AsyncCheckpointer()
    w = torch.arange(8, dtype=torch.float32)
    ac.save({"w": w, "a": np.ones(3)}, str(tmp_path), extra={"step": 1})
    w.mul_(0.0)
    ac.wait_until_finished()
    assert not ac.in_flight
    got, _ = checkpoint.load_state(str(tmp_path), device="cpu")
    assert torch.equal(got["w"], torch.arange(8, dtype=torch.float32))


def test_async_checkpointer_error_surfaces_on_wait(tmp_path):
    ac = checkpoint.AsyncCheckpointer()
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("file in the way")
    ac.save({"w": torch.ones(2)}, str(blocker / "sub"), extra={"step": 0})
    with pytest.raises(OSError):
        ac.wait_until_finished()
    ac.save({"w": torch.ones(2)}, str(tmp_path), extra={"step": 2})
    ac.wait_until_finished()


def test_async_checkpointer_orders_saves(tmp_path):
    ac = checkpoint.AsyncCheckpointer()
    for step in (1, 2, 3):
        ac.save({"w": torch.full((4,), float(step))}, str(tmp_path),
                extra={"step": step}, keep_last=2)
    ac.wait_until_finished()
    got, _ = checkpoint.load_state(str(tmp_path), device="cpu")
    assert torch.equal(got["w"], torch.full((4,), 3.0))
    assert [v for v, _ in checkpoint.list_versions(str(tmp_path))] == [2, 3]


def test_async_uses_host_barrier(monkeypatch, tmp_path):
    seen = {}
    orig = checkpoint._write_shards

    def spy(*args, **kwargs):
        seen["barrier"] = kwargs.get("barrier")
        return orig(*args, **kwargs)

    monkeypatch.setattr(checkpoint, "_write_shards", spy)
    ac = checkpoint.AsyncCheckpointer()
    ac.save({"w": torch.ones(2)}, str(tmp_path), extra={"step": 0})
    ac.wait_until_finished()
    assert seen["barrier"] is checkpoint._host_barrier


# -- trainers ------------------------------------------------------------------

def _sched():
    return lr.StepDecay(1e-3, step_size=2)


def _port_trainer(seed=0, o2=False):
    model = GPTForCausalLM(gpt_tiny(), device="cpu", seed=seed)
    model.train()
    opt = AdamW(_sched(), parameters=model.parameters(), weight_decay=0.01,
                multi_precision=o2)
    if o2:
        model, opt = decorate(model, opt, level="O2", dtype="bfloat16")
    return ShardedTrainer(model, opt, None, amp=o2)


def _port_state(t):
    out = {f"param/{n}": p.detach().clone()
           for n, p in t.param_tensors.items()}
    out.update({f"opt/{n}/{s}": v.clone()
                for n, st in t._opt_states().items() for s, v in st.items()})
    return out


def test_trainer_checkpoint_exact_resume(tmp_path):
    """Train 2 steps, save, train 2 more; a trainer built from another
    seed loads the checkpoint and trains the same 2 steps: the losses are
    equal exactly (the CPU's plain versions are deterministic)."""
    ids, labels = _ids()
    t1 = _port_trainer()
    t1.train_step(ids, labels)
    t1.train_step(ids, labels)
    t1.save_checkpoint(str(tmp_path / "ck"))
    saved = _port_state(t1)
    cont = [t1.train_step(ids, labels).item() for _ in range(2)]
    t2 = _port_trainer(seed=123)
    t2.load_checkpoint(str(tmp_path / "ck"))
    assert t2.step_count == 2 and t2.optimizer._learning_rate.last_epoch == 0
    for k, v in _port_state(t2).items():
        assert torch.equal(v, saved[k]), k
    assert [t2.train_step(ids, labels).item() for _ in range(2)] == cont
    meta = checkpoint.load_meta(str(tmp_path / "ck"))
    assert "rng" not in meta["extra"] and "torch_rng" in meta["extra"]


def test_trainer_auto_checkpoint(tmp_path):
    ids, labels = _ids()
    t = _port_trainer()
    t.enable_auto_checkpoint(str(tmp_path / "auto"), every_steps=2)
    t.train_step(ids, labels)
    assert not os.path.exists(tmp_path / "auto")
    t.train_step(ids, labels)
    _, extra = checkpoint.load_state(str(tmp_path / "auto"), device="cpu")
    assert extra["step"] == 2


def _jax_trainer(o2=False):
    paddle.seed(3)
    jm = JaxGPT(jax_gpt_tiny())
    jm.train()
    opt = paddle.optimizer.AdamW(learning_rate=_jax_sched(),
                                 parameters=jm.parameters(),
                                 weight_decay=0.01)
    if o2:
        jm, opt = paddle.amp.decorate(jm, opt, level="O2", dtype="bfloat16")
    return JaxTrainer(jm, opt, None, _mesh1(), amp=o2)


def _jax_sched():
    return paddle.optimizer.lr.StepDecay(1e-3, step_size=2)


def _steps(t, ids, labels, n):
    return [float(np.asarray(t.train_step(ids, labels))) for _ in range(n)]


def _assert_port_holds_jax(pt, jt):
    for n, p in pt.param_tensors.items():
        np.testing.assert_array_equal(_bits(_t2np(p)),
                                      _bits(np.asarray(jt.params[n])), n)
    for n, slots in jt.opt_states.items():
        for s, v in slots.items():
            mine = pt._opt_states()[n][s]
            np.testing.assert_array_equal(
                _t2np(mine), np.asarray(v).astype(_t2np(mine).dtype))
    assert pt.step_count == jt.step_count
    assert pt.optimizer._learning_rate.state_dict() == \
        jt.optimizer._learning_rate.state_dict()


def test_checkpoints_cross_between_the_trainers(tmp_path):
    """JAX trains 2 steps and saves; the port loads it bitwise, both go
    on 2 steps alike; the port saves at step 4, JAX loads that bitwise,
    and both go on 2 more steps alike."""
    ids, labels = _ids(1)
    jt = _jax_trainer()
    _steps(jt, ids, labels, 2)
    jt.save_checkpoint(str(tmp_path / "jax"))
    pt = _port_trainer(seed=9)
    pt.load_checkpoint(str(tmp_path / "jax"))
    _assert_port_holds_jax(pt, jt)
    np.testing.assert_allclose(_steps(pt, ids, labels, 2),
                               _steps(jt, ids, labels, 2), rtol=1e-5)
    for sched in (pt.optimizer._learning_rate, jt.optimizer._learning_rate):
        sched.step()
    pt.save_checkpoint(str(tmp_path / "port"))
    _steps(jt, ids, labels, 1)                  # move JAX away first
    jt.load_checkpoint(str(tmp_path / "port"))
    _assert_port_holds_jax(pt, jt)
    assert jt.step_count == 4 and jt.optimizer._learning_rate.last_epoch == 1
    np.testing.assert_allclose(_steps(pt, ids, labels, 2),
                               _steps(jt, ids, labels, 2), rtol=1e-5)


def test_o2_checkpoints_cross_between_the_trainers(tmp_path,
                                                   _reference_reads_bf16):
    """bf16 parameters (LayerNorm's fp32) cross bitwise both ways. The
    JAX trainer keeps no master weights, so a JAX checkpoint seeds the
    port's fp32 ``@master`` from the loaded parameter and its fp32 AdamW
    moments from the bf16 ones; the port's ``@master`` rides along in
    its files, ignored by the JAX trainer."""
    ids, labels = _ids(2)
    jt = _jax_trainer(o2=True)
    assert any(np.asarray(v).dtype == ml_dtypes.bfloat16
               for v in jt.params.values())
    _steps(jt, ids, labels, 1)
    jt.save_checkpoint(str(tmp_path / "jax"))
    pt = _port_trainer(seed=4, o2=True)
    pt.load_checkpoint(str(tmp_path / "jax"))
    _assert_port_holds_jax(pt, jt)
    for n, p in pt.param_tensors.items():
        st = pt._opt_states()[n]
        if p.dtype == torch.bfloat16:
            assert torch.equal(st["@master"], p.detach().float())
    np.testing.assert_allclose(_steps(pt, ids, labels, 1),
                               _steps(jt, ids, labels, 1), rtol=2e-2)
    pt.save_checkpoint(str(tmp_path / "port"))
    meta = checkpoint.load_meta(str(tmp_path / "port"))
    assert meta["arrays"]["param/gpt.h.0.attn.qkv_proj.weight"]["dtype"] == \
        "bfloat16"
    assert meta["arrays"]["opt/gpt.h.0.attn.qkv_proj.weight/@master"][
        "dtype"] == "float32"
    jt.load_checkpoint(str(tmp_path / "port"))
    for n, p in pt.param_tensors.items():
        np.testing.assert_array_equal(_bits(_t2np(p)),
                                      _bits(np.asarray(jt.params[n])), n)
    np.testing.assert_allclose(_steps(pt, ids, labels, 1),
                               _steps(jt, ids, labels, 1), rtol=2e-2)


def test_gradient_merge_mid_window_resume(tmp_path):
    """A checkpoint taken mid-window keeps the pending merged gradients:
    the resumed run ends bitwise where the uninterrupted one does."""
    rs = np.random.RandomState(0)
    batches = [rs.randint(0, 256, (2, 16)) for _ in range(6)]

    def make():
        model = GPTForCausalLM(gpt_tiny(), device="cpu", seed=0)
        model.train()
        st = DistributedStrategy()
        st.gradient_merge = True
        st.gradient_merge_configs.k_steps = 4
        return ShardedTrainer(model, SGD(0.1, parameters=model.parameters()),
                              None, strategy=st)

    ref = make()
    for b in batches:
        ref.train_step(b, b)
    saver = make()
    for b in batches[:2]:
        saver.train_step(b, b)
    saver.save_checkpoint(str(tmp_path / "ck"))
    meta = checkpoint.load_meta(str(tmp_path / "ck"))
    assert meta["arrays"]["gm_accum/gpt.wte.weight"]["dtype"] == "float32"
    resumed = make()
    resumed.load_checkpoint(str(tmp_path / "ck"))
    for b in batches[2:]:
        resumed.train_step(b, b)
    for n, p in ref.param_tensors.items():
        assert torch.equal(p, resumed.param_tensors[n]), n
