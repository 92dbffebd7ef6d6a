"""ZeRO offload on the port's one-card ``ShardedTrainer``.

``DistributedStrategy(sharding=True, sharding_configs={"offload":
True})`` keeps every non-scalar optimizer slot in a host buffer between
steps and streams it to the device and back around each update. On the
CPU the host buffers are plain CPU tensors and the copies run
synchronously: the same bookkeeping as on the card (the slots swapped
in and out of the optimizer, checkpoints and loads going through the
host buffers, a skipped or merged step), with the same arithmetic. So
against the same trainer without offload, from the same weights:

- ``gpt_tiny`` trained 3 steps (AdamW, AMP O1; Momentum under O2 with
  fp32 masters) gives bitwise equal losses, parameters and slots, and
  checkpoints whose arrays are bitwise equal;
- between steps every non-scalar slot IS its host buffer and every
  0-dim slot (beta powers) stays where the parameter lives;
- gradient merge (k 2) and the anomaly policy's skipped step agree
  bitwise, a skipped step leaving the host buffers untouched;
- a checkpoint loaded into an offloaded trainer lands in the host
  buffers, and training continues bitwise as the trainer that saved it.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import DistributedStrategy, ShardedTrainer
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.optimizer import AdamW, Momentum
from paddle_tpu_torch.testing import fault_injection as fi

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)


def _offload(**kw):
    return DistributedStrategy(sharding=True,
                               sharding_configs={"offload": True}, **kw)


def _trainer(offload, amp_level=None, loss_fn=None, **st_kw):
    """gpt_tiny from seed 0 with AdamW, or under O2 (bf16 parameters)
    Momentum with fp32 masters."""
    model = GPTForCausalLM(gpt_tiny(), device="cpu", seed=0)
    model.train()
    if amp_level == "O2":
        model.to(torch.bfloat16)
        o = Momentum(learning_rate=1e-2, parameters=model.named_parameters(),
                     multi_precision=True)
    else:
        o = AdamW(learning_rate=1e-3, parameters=model.named_parameters(),
                  weight_decay=0.01)
    st = _offload(**st_kw) if offload else DistributedStrategy(**st_kw)
    return ShardedTrainer(model, o, loss_fn, strategy=st,
                          amp=amp_level is not None)


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (2, 32)).astype(np.int64) for _ in range(n)]


def _state(t):
    out = {f"param/{n}": p.detach().clone()
           for n, p in t.param_tensors.items()}
    out.update({f"opt/{n}/{s}": v.clone()
                for n, st in t._opt_states().items()
                for s, v in st.items()})
    return out


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _check_placement(t):
    """Non-scalar slots are the host buffers; 0-dim slots are not."""
    n_host = 0
    for n, st in t.optimizer._named_state(t._names).items():
        for slot, v in st.items():
            if v.dim() == 0:
                assert (n, slot) not in t._host_slots
            else:
                assert v is t._host_slots[(n, slot)]
                n_host += 1
    assert n_host == len(t._host_slots) > 0


@pytest.mark.parametrize("amp_level", ["O1", "O2"])
def test_offload_trains_bitwise_and_checkpoints_equal(amp_level, tmp_path):
    base = _trainer(False, amp_level=amp_level)
    off = _trainer(True, amp_level=amp_level)
    _check_placement(off)
    if amp_level == "O2":
        assert any(s == "@master" for _, s in off._host_slots)
    for ids in _batches(3):
        lb = base.train_step(ids, ids)
        lo = off.train_step(ids, ids)
        assert torch.equal(lb, lo)
        _check_placement(off)
    _same(_state(base), _state(off))
    base.save_checkpoint(str(tmp_path / "base"))
    off.save_checkpoint(str(tmp_path / "off"))
    a, ea = ckpt.load_state(str(tmp_path / "base"), device="cpu")
    b, eb = ckpt.load_state(str(tmp_path / "off"), device="cpu")
    assert a.keys() == b.keys() and ea["step"] == eb["step"] == 3
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert off.optimizer_state_bytes() == base.optimizer_state_bytes()


def test_offload_gradient_merge_bitwise():
    base = _trainer(False, gradient_merge=True,
                    gradient_merge_configs={"k_steps": 2})
    off = _trainer(True, gradient_merge=True,
                   gradient_merge_configs={"k_steps": 2})
    for ids in _batches(4, seed=1):
        assert torch.equal(base.train_step(ids, ids),
                           off.train_step(ids, ids))
        _check_placement(off)
    _same(_state(base), _state(off))
    assert off.step_count == 4 and off.optimizer._global_step == 4


def _scaled(loss, scale):
    return loss * scale.mean()


def test_offload_skipped_step_keeps_the_host_state():
    """A NaN scale on the loss at step 2 under ``skip_step``: both
    trainers drop the update, the offloaded one's host buffers keep
    their bits, and the next step agrees bitwise."""
    base = _trainer(False, loss_fn=_scaled)
    off = _trainer(True, loss_fn=_scaled)
    for t in (base, off):
        t.enable_anomaly_policy(policy="skip_step")
    x = _batches(3, seed=2)
    one = np.ones((1,), np.float32)
    for t in (base, off):
        t.train_step(x[0], x[0], one)
    before = _state(off)
    for t in (base, off):
        with pytest.warns(Warning, match="update dropped"):
            with fi.inject("trainer:batch", fi.nan_batch()):
                t.train_step(x[1], x[1], one)
    _same(_state(off), before)
    assert off.anomaly_stats["skipped"] == base.anomaly_stats["skipped"] == 1
    for t in (base, off):
        t.train_step(x[2], x[2], one)
    _same(_state(base), _state(off))
    _check_placement(off)


def test_offload_load_checkpoint_lands_in_the_host_buffers(tmp_path):
    src = _trainer(False)
    for ids in _batches(2, seed=3):
        src.train_step(ids, ids)
    src.save_checkpoint(str(tmp_path))
    dst = _trainer(True)
    host = dict(dst._host_slots)
    dst.load_checkpoint(str(tmp_path))
    assert all(dst._host_slots[k] is v for k, v in host.items())
    _check_placement(dst)
    _same(_state(src), _state(dst))
    for ids in _batches(2, seed=4):
        assert torch.equal(src.train_step(ids, ids),
                           dst.train_step(ids, ids))
    _same(_state(src), _state(dst))
    # eval reads the parameters after any copy-out has landed
    ids = _batches(1, seed=5)[0]
    assert torch.equal(src.eval_step(ids, ids), dst.eval_step(ids, ids))
