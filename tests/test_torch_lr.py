"""The port's learning-rate schedulers against the JAX package's.

Every scheduler of ``paddle_tpu/optimizer/lr.py`` is host arithmetic on
Python floats, and the port repeats it term for term, so each rate is
held to the reference's EXACTLY (``==``) over 40 steps: at birth, after
each ``step()``, and through a ``state_dict`` round trip into a fresh
scheduler mid-run. ``ReduceOnPlateau`` is fed one fixed metric sequence
(plateaus, a cooldown, the floor ``min_lr``) in both packages, as a
float and as a 0-dim (fp64) tensor. An optimizer built on a scheduler reads
it at every step (``get_lr``), refuses ``set_lr`` with the reference's
``RuntimeError``, and carries the scheduler's state in its own
``state_dict``.
"""

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as port_lr

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

jax_lr = importlib.import_module("paddle_tpu.optimizer.lr")

STEPS = 40


def _noam(m):
    return m.NoamDecay(64, 10, learning_rate=2.0)


# id -> factory(module): every scheduler of the reference, several in
# more than one mode
SCHEDULERS = {
    "NoamDecay": _noam,
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 15, 30],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, 0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, 0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, 20, 0.01, 2.0),
    "PolynomialDecay-cycle": lambda m: m.PolynomialDecay(0.5, 12, 0.01, 1.5,
                                                         cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.5, 10, 0.0, 0.5),
    "LinearWarmup-cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.5, 20, 0.01), 5, 0.0, 0.5),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, 0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [5, 12, 30], 0.5),
    "StepDecay": lambda m: m.StepDecay(0.5, 7, 0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.5, 15, 0.01),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.5, lambda e: 0.9 if e % 3 else 1.05),
    "OneCycleLR": lambda m: m.OneCycleLR(0.5, STEPS),
    "OneCycleLR-three-phase-linear": lambda m: m.OneCycleLR(
        0.5, 30, 10.0, 1e-4, 0.25, "linear", three_phase=True),
    "CyclicLR-triangular": lambda m: m.CyclicLR(0.01, 0.1, 5, 7),
    "CyclicLR-triangular2": lambda m: m.CyclicLR(0.01, 0.1, 4,
                                                 mode="triangular2"),
    "CyclicLR-exp_range": lambda m: m.CyclicLR(0.01, 0.1, 6, 3,
                                               mode="exp_range",
                                               exp_gamma=0.97),
    "CyclicLR-scale_fn": lambda m: m.CyclicLR(
        0.01, 0.1, 5, scale_fn=lambda x: 1.0 / (1 + x),
        scale_mode="iterations"),
}

# ReduceOnPlateau's metrics: a fall, a plateau past the patience (a
# reduction, then the cooldown), a rise, and plateaus until min_lr
METRICS = ([1.0, 0.9, 0.8, 0.8, 0.8, 0.8, 0.79999, 0.9, 0.95, 0.7]
           + [0.7] * 30)


def _trace(s, n=STEPS):
    out = [(s(), s.last_epoch, s.last_lr)]
    for _ in range(n):
        s.step()
        out.append((s(), s.last_epoch, s.last_lr))
    return out


def test_port_has_every_scheduler_of_the_reference():
    assert port_lr.__all__ == jax_lr.__all__
    names = {f(jax_lr).__class__.__name__ for f in SCHEDULERS.values()}
    assert names | {"LRScheduler", "ReduceOnPlateau"} == set(jax_lr.__all__)


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_rates_equal_the_reference(name):
    want = _trace(SCHEDULERS[name](jax_lr))
    got = _trace(SCHEDULERS[name](port_lr))
    assert got == want
    assert len({r for r, _, _ in got}) > 1      # the rate moves


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_state_dict_round_trip_equals_the_reference(name):
    js, ps = SCHEDULERS[name](jax_lr), SCHEDULERS[name](port_lr)
    for _ in range(17):
        js.step()
        ps.step()
    assert ps.state_dict() == js.state_dict()
    fresh = SCHEDULERS[name](port_lr)
    fresh.set_state_dict(ps.state_dict())
    assert _trace(fresh, 10) == _trace(js, 10)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_reduce_on_plateau_equals_the_reference(as_tensor):
    kw = dict(mode="min", factor=0.5, patience=2, threshold=1e-4,
              cooldown=1, min_lr=0.1)
    js = jax_lr.ReduceOnPlateau(1.0, **kw)
    ps = port_lr.ReduceOnPlateau(1.0, **kw)
    seen = []
    for m in METRICS:
        js.step(m)
        ps.step(torch.tensor(m, dtype=torch.float64) if as_tensor else m)
        assert (ps(), ps.last_epoch, ps.best, ps.num_bad_epochs,
                ps.cooldown_counter) == (js(), js.last_epoch, js.best,
                                         js.num_bad_epochs,
                                         js.cooldown_counter)
        seen.append(ps())
    assert seen[-1] == 0.1 and len(set(seen)) == 5     # to the floor
    ps.step(None)                                      # no metric: no-op
    assert ps.last_epoch == len(METRICS)
    assert ps.state_dict() == js.state_dict()


@pytest.mark.parametrize("mode,threshold_mode", [("max", "rel"),
                                                 ("max", "abs"),
                                                 ("min", "abs")])
def test_reduce_on_plateau_modes_equal_the_reference(mode, threshold_mode):
    metrics = [-m if mode == "max" else m for m in METRICS]
    js = jax_lr.ReduceOnPlateau(1.0, mode, 0.3, 1, 0.05, threshold_mode)
    ps = port_lr.ReduceOnPlateau(1.0, mode, 0.3, 1, 0.05, threshold_mode)
    for m in metrics:
        js.step(m)
        ps.step(m)
        assert ps() == js()


def test_optimizer_reads_its_scheduler_and_refuses_set_lr():
    jsched = SCHEDULERS["LinearWarmup-cosine"](jax_lr)
    psched = SCHEDULERS["LinearWarmup-cosine"](port_lr)
    jw = paddle.nn.Parameter(paddle.to_tensor(np.ones(3, np.float32)).value)
    jopt = paddle.optimizer.AdamW(jsched, parameters=[jw])
    p = torch.nn.Parameter(torch.ones(3))
    opt = AdamW(psched, parameters=[("w", p)])
    for _ in range(12):
        assert opt.get_lr() == jopt.get_lr() == psched()
        p.grad = torch.ones(3)
        opt.step()
        psched.step()
        jsched.step()
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    sd = opt.state_dict()
    assert sd["@lr_scheduler"] == jopt.state_dict()["@lr_scheduler"]
    assert sd["@global_step"] == 12
    plain = AdamW(0.01, parameters=[p])
    plain.set_lr(0.5)
    assert plain.get_lr() == 0.5 and "@lr_scheduler" not in \
        plain.state_dict()
