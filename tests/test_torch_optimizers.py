"""The port's Adagrad, Adamax, RMSProp, Lars, Lamb and Adadelta against
the JAX package's rules.

Each case starts both packages from the same numpy parameters, state
and three steps of gradients, drawn from a seed: the reference through
``type(opt)._update`` with ``opt._hyper_for_param(group, param)`` (the
rule and per-parameter hyperparameters its trainer runs, L2 decay folded
into the gradient as its ``step`` folds it), the port through
``step()``. After each step every parameter and every state slot agree
within 1e-6 of the slot's largest magnitude (fp32). With
``multi_precision`` the port's parameters are bf16: the reference rule
runs on the fp32 masters with the bf16 gradients, the port's ``@master``
slot holds to it and its bf16 parameter is the master rounded to
nearest.

The cases take the hyperparameters that change the branch: RMSProp
centered and not, with momentum; Lars with ``exclude_from_weight_decay``
(the names the reference matches: the parameters carry the same names
in both packages); Lamb's decay with ``exclude_from_weight_decay_fn``;
Adagrad's initial accumulator; L2 ``weight_decay``.

The state then crosses through the checkpoint format both packages read:
the port's slots saved by ``paddle_tpu_torch.distributed.checkpoint``
are read back by the reference's loader bitwise, and a fresh port
optimizer loaded from them takes the next step bitwise as the original.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.distributed import checkpoint as jax_ckpt
from paddle_tpu import optimizer as jopt

from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.distributed import checkpoint as ckpt

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

SHAPES = {"fc.weight": (16, 8), "fc.bias": (8,), "ln.norm.weight": (8,),
          "proj.weight": (8, 12)}
LR = 0.01


def _exclude(p):
    return "bias" in p.name or "norm" in p.name


# id -> (class name, keyword arguments, L2 decay the step folds in)
CASES = {
    "Adagrad": ("Adagrad", dict(epsilon=1e-6,
                                initial_accumulator_value=0.1), None),
    "Adagrad-l2": ("Adagrad", dict(weight_decay=0.01), 0.01),
    "Adamax": ("Adamax", dict(beta1=0.9, beta2=0.99), None),
    "RMSProp": ("RMSProp", dict(rho=0.9, momentum=0.5), None),
    "RMSProp-centered": ("RMSProp", dict(rho=0.9, momentum=0.5,
                                         centered=True), None),
    "Lars": ("Lars", dict(momentum=0.9, lars_coeff=0.01,
                          lars_weight_decay=0.005), None),
    "Lars-exclude": ("Lars", dict(momentum=0.9, lars_coeff=0.01,
                                  lars_weight_decay=0.005,
                                  exclude_from_weight_decay=["bias",
                                                             "norm"]), None),
    "LarsMomentum": ("LarsMomentum", dict(lars_coeff=0.02), None),
    "Lamb": ("Lamb", dict(lamb_weight_decay=0.01), None),
    "Lamb-exclude": ("Lamb", dict(lamb_weight_decay=0.05,
                                  exclude_from_weight_decay_fn=_exclude),
                     None),
    "Adadelta": ("Adadelta", dict(epsilon=1e-6, rho=0.9), None),
    "Adadelta-l2": ("Adadelta", dict(weight_decay=0.02), 0.02),
}
MULTI = ["Adagrad", "Adamax", "RMSProp-centered", "Lars-exclude",
         "Lamb-exclude", "Adadelta"]
# slots that must stay positive (square roots of them)
POSITIVE = {"moment", "moment2", "inf_norm", "mean_square",
            "avg_squared_grad", "avg_squared_update"}


def _draw(seed):
    rs = np.random.RandomState(seed)
    params = {n: rs.randn(*s).astype(np.float32) * 0.5
              for n, s in SHAPES.items()}
    grads = [{n: rs.randn(*s).astype(np.float32) * 0.1
              for n, s in SHAPES.items()} for _ in range(3)]
    return rs, params, grads


def _start_state(rs, slots, params):
    """A mid-training state: positive second moments, small first ones,
    beta powers of a few steps in."""
    out = {}
    for n, p in params.items():
        st = {}
        for slot in slots:
            if slot.endswith("_pow"):
                st[slot] = np.float32(0.9 ** 3 if slot == "beta1_pow"
                                      else 0.999 ** 3)
            elif slot in POSITIVE:
                st[slot] = (np.abs(rs.randn(*p.shape)) * 0.01 + 1e-3
                            ).astype(np.float32)
            else:
                st[slot] = (rs.randn(*p.shape) * 0.01).astype(np.float32)
        out[n] = st
    return out


def _close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= 1e-6, f"{what}: relative error {err}"


def _reference(cls_name, kw, params, state, grads, l2):
    """The reference rule over named JAX parameters: the per-step values
    of every parameter and slot."""
    jparams = {n: JaxParameter(jnp.asarray(v), name=n)
               for n, v in params.items()}
    opt = getattr(jopt, cls_name)(learning_rate=LR,
                                  parameters=list(jparams.values()), **kw)
    group = opt._param_groups[0]
    st = {n: {k: jnp.asarray(v) for k, v in s.items()}
          for n, s in state.items()}
    vals = {n: jnp.asarray(v) for n, v in params.items()}
    trail = []
    for g in grads:
        for n, p in jparams.items():
            gv = jnp.asarray(g[n])
            if l2:
                gv = gv + l2 * vals[n]
            p._replace_value(vals[n])
            vals[n], st[n] = type(opt)._update(
                vals[n], gv, st[n], jnp.asarray(LR, jnp.float32),
                **opt._hyper_for_param(group, p))
        trail.append(({n: np.asarray(v) for n, v in vals.items()},
                      {n: {k: np.asarray(v) for k, v in s.items()}
                       for n, s in st.items()}))
    return trail


def _port(cls_name, kw, params, state, multi):
    dtype = torch.bfloat16 if multi else torch.float32
    tensors = {n: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dtype))
               for n, v in params.items()}
    extra = {"multi_precision": True} if multi else {}
    opt = getattr(popt, cls_name)(learning_rate=LR,
                                  parameters=list(tensors.items()),
                                  **kw, **extra)
    sd = {f"{n}.{k}": torch.from_numpy(np.array(v)) for n, s in state.items()
          for k, v in s.items()}
    if multi:
        sd.update({f"{n}.@master": torch.from_numpy(v.copy())
                   for n, v in params.items()})
    opt.set_state_dict(sd)
    return opt, tensors


def _step(opt, tensors, g):
    for n, p in tensors.items():
        p.grad = torch.from_numpy(g[n]).to(p.dtype)
    opt.step()
    opt.clear_grad()


@pytest.mark.parametrize("case,multi",
                         [(c, False) for c in CASES]
                         + [(c, True) for c in MULTI])
def test_step_matches_the_reference_rule(case, multi):
    cls_name, kw, l2 = CASES[case]
    rs, params, grads = _draw(list(CASES).index(case))
    slots = getattr(popt, cls_name)._state_slots
    state = _start_state(rs, slots, params)
    if multi:
        # the masters are fp32 and the parameters their bf16 rounding:
        # both packages start from the same masters
        params = {n: torch.from_numpy(v).bfloat16().float().numpy()
                  for n, v in params.items()}
        # a bf16 parameter's gradient is bf16: the masters step on it
        grads = [{n: torch.from_numpy(v).bfloat16().float().numpy()
                  for n, v in g.items()} for g in grads]
    trail = _reference(cls_name, kw, params, state, grads, l2)
    opt, tensors = _port(cls_name, kw, params, state, multi)
    for i, (g, (want_p, want_s)) in enumerate(zip(grads, trail)):
        _step(opt, tensors, g)
        for n, p in tensors.items():
            st = opt._accumulators[id(p)]
            value = st["@master"] if multi else p.detach()
            _close(value.numpy(), want_p[n], f"step {i + 1} {n}")
            if multi:
                assert torch.equal(p.detach(), st["@master"].bfloat16())
            for k, v in want_s[n].items():
                _close(st[k].float().numpy(), v, f"step {i + 1} {n}.{k}")
    if "exclude" in case:
        # the excluded names decay 0: a different trail than without
        plain = {k: v for k, v in kw.items() if not k.startswith("exclude")}
        other = _reference(cls_name, plain, params, state, grads, l2)
        assert not np.array_equal(other[-1][0]["fc.bias"],
                                  trail[-1][0]["fc.bias"])
        np.testing.assert_array_equal(other[-1][0]["fc.weight"],
                                      trail[-1][0]["fc.weight"])


@pytest.mark.parametrize("case", ["Adagrad", "Adamax", "RMSProp-centered",
                                  "Lars-exclude", "Lamb", "Adadelta"])
def test_state_crosses_the_checkpoint_format(case, tmp_path):
    cls_name, kw, _ = CASES[case]
    rs, params, grads = _draw(7)
    opt, tensors = _port(cls_name, kw, params,
                         _start_state(rs, getattr(popt, cls_name)
                                      ._state_slots, params), False)
    for g in grads[:2]:
        _step(opt, tensors, g)
    state = {f"param/{n}": p.detach() for n, p in tensors.items()}
    state.update({f"opt/{n}/{k}": v for n, p in tensors.items()
                  for k, v in opt._accumulators[id(p)].items()})
    ckpt.save_state(state, str(tmp_path), extra={"step": 2})
    arrays, extra = jax_ckpt.load_state(str(tmp_path))
    assert extra["step"] == 2
    for key, v in state.items():
        np.testing.assert_array_equal(np.asarray(arrays[key]), v.numpy())
    # a fresh optimizer from the reference's reading takes the next step
    # as the original does
    fresh = {n: torch.nn.Parameter(torch.from_numpy(
        np.array(arrays[f"param/{n}"]))) for n in tensors}
    opt2 = getattr(popt, cls_name)(learning_rate=LR,
                                   parameters=list(fresh.items()), **kw)
    opt2.set_state_dict({f"{n}.{k}": np.array(arrays[f"opt/{n}/{k}"])
                         for n in tensors
                         for k in opt._accumulators[id(tensors[n])]})
    _step(opt, tensors, grads[2])
    _step(opt2, fresh, grads[2])
    for n in tensors:
        assert torch.equal(tensors[n].detach(), fresh[n].detach()), n


def test_signatures_and_exports_follow_the_reference():
    for name in ("Adagrad", "Adamax", "RMSProp", "Lars", "LarsMomentum",
                 "Lamb", "Adadelta"):
        assert name in popt.__all__ and hasattr(jopt, name)
        assert getattr(popt, name)._state_slots == \
            tuple(getattr(jopt, name)._state_slots)
    assert popt.LarsMomentum is popt.Lars
    with pytest.raises(TypeError):
        # the reference takes multi_precision nowhere in Adagrad: the
        # port's is keyword-only
        popt.Adagrad(0.1, 1e-6, [torch.nn.Parameter(torch.zeros(2))],
                     None, None, None, 0.0, True)
