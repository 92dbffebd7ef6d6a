"""The port's ``nn`` surface (activations, losses, initializers,
``ParamAttr``, containers, ``Embedding``) against the JAX package.

- Activations and losses: the same seeded numpy inputs through the JAX
  functional and layer and the port's; outputs and input gradients
  within 1e-5 (absolute and relative: fp32 on both sides, differing
  only in the order of float operations).
- Initializers: the two packages draw from different generators, so
  they are held by distribution, as ``test_torch_init.py`` holds the
  layers' fresh weights: every draw inside the distribution's support,
  the sample mean and variance each within 4 standard errors of the
  distribution's, and a two-sample Kolmogorov-Smirnov statistic between
  the two packages' draws under its 1% critical value. Deterministic
  initializers (``Constant``, ``Assign``, ``Dirac``) are held exactly,
  ``Orthogonal`` by orthonormality at its gain.
- ``ParamAttr``: ``trainable``, ``learning_rate`` and ``need_clip`` on a
  layer, one clipped SGD step in both packages from the same weights:
  the updated weights within 1e-6.
- Containers: names, order and forwards as the reference's.
- ``Embedding(padding_idx=, sparse=)``: the JAX layer's output and
  weight gradient exactly.
"""

import importlib
import math
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import initializer as JI

import paddle_tpu_torch
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import ShardedTrainer
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.regularizer import L2Decay

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

JF = importlib.import_module("paddle_tpu.nn.functional")
TOL = dict(rtol=1e-5, atol=1e-5)

RS = np.random.RandomState(0)
X = (RS.randn(3, 4, 6) * 2).astype(np.float32)
G = RS.randn(3, 4, 6).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v.numpy() if isinstance(v, Tensor) else v)


def _jax_out_and_grad(fn, weigh, x, *rest):
    """``fn(x, *rest)`` and the gradient of ``sum(weigh(first output))``
    in x, as one compiled JAX program (one compile, not one an op)."""
    def run(a, *r):
        out = fn(a, *r)
        return out, jax.grad(lambda b: jnp.sum(weigh(_first(fn(b, *r)))))(a)

    return jax.jit(run)(jnp.asarray(x), *[jnp.asarray(v) for v in rest])


# ------------------------------------------------------------ activations
# functional -> (positional extras, keyword args)
ACTS = {name: ((), {}) for name in (
    "relu", "relu6", "elu", "selu", "celu", "gelu", "sigmoid",
    "hardsigmoid", "log_sigmoid", "tanh", "softsign", "softplus", "swish",
    "silu", "hardswish", "mish", "tanhshrink", "softshrink", "hardshrink",
    "thresholded_relu", "softmax", "log_softmax", "glu")}
ACTS.update({
    "leaky_relu": ((), {"negative_slope": 0.2}),
    "gelu-tanh": ((), {"approximate": True}),
    "hardtanh": ((), {"min": -0.5, "max": 2.0}),
    "softplus-beta": ((), {"beta": 2.0, "threshold": 3.0}),
    "softmax-axis": ((), {"axis": 1}),
    "maxout": ((2,), {"axis": 1}),
    "prelu": ((RS.rand(4).astype(np.float32),), {}),
    "elu-alpha": ((), {"alpha": 0.5}),
})


@pytest.mark.parametrize("case", list(ACTS))
def test_activation_matches_jax_with_gradient(case):
    name = case.split("-")[0]
    extra, kw = ACTS[case]
    jfn, pfn = getattr(JF, name), getattr(F, name)
    jx = [jnp.asarray(e) if isinstance(e, np.ndarray) else e for e in extra]
    px = [_t(e) if isinstance(e, np.ndarray) else e for e in extra]
    want, want_g = _jax_out_and_grad(
        lambda a: jfn(a, *jx, **kw),
        lambda out: out * (G if out.shape == X.shape else 1.0), X)
    xt = _t(X).requires_grad_()
    got = pfn(xt, *px, **kw)
    (got * (_t(G) if got.shape == X.shape else 1.0)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(want_g), **TOL)


# layer -> constructor args
ACT_LAYERS = {name: () for name in (
    "ReLU", "ReLU6", "LeakyReLU", "ELU", "SELU", "CELU", "GELU", "Sigmoid",
    "Hardsigmoid", "LogSigmoid", "Tanh", "Hardtanh", "Softsign", "Softplus",
    "Swish", "SiLU", "Silu", "Hardswish", "Mish", "Tanhshrink",
    "Softshrink", "Hardshrink", "ThresholdedReLU", "Softmax", "LogSoftmax",
    "GLU", "PReLU")}
ACT_LAYERS.update({"Maxout": (2,), "PReLU-channels": (4, 0.1)})


@pytest.mark.parametrize("case", list(ACT_LAYERS))
def test_activation_layer_matches_jax(case):
    name = case.split("-")[0]
    args = ACT_LAYERS[case]
    jl = getattr(jnn, name)(*args)
    pl = getattr(nn, name)(*args, **({"device": "cpu"} if name == "PReLU"
                                     else {}))
    if name == "PReLU":
        pl.set_state_dict({k: np.asarray(v.value)
                           for k, v in jl.state_dict().items()})
    want = jl(paddle.to_tensor(X))
    np.testing.assert_allclose(_np(pl(_t(X))), _np(want), **TOL)


def test_gumbel_softmax_is_a_distribution_and_hard_is_one_hot():
    torch.manual_seed(0)
    soft = F.gumbel_softmax(_t(X), 0.5)
    hard = F.gumbel_softmax(_t(X), 0.5, True)
    jsoft = JF.gumbel_softmax(paddle.to_tensor(X), 0.5)
    assert soft.shape == hard.shape == tuple(jsoft.shape)
    np.testing.assert_allclose(_np(soft.sum(-1)), 1.0, atol=1e-6)
    assert set(np.unique(_np(hard))) <= {0.0, 1.0}
    np.testing.assert_array_equal(_np(hard.sum(-1)), 1.0)


# ------------------------------------------------------------ losses
N, K = 6, 5
LOGITS = RS.randn(N, K).astype(np.float32) * 2
LABEL = RS.randint(0, K, (N,)).astype(np.int64)
LABEL_IGN = LABEL.copy()
LABEL_IGN[[1, 4]] = -100
SOFT = RS.dirichlet(np.ones(K), N).astype(np.float32)
WEIGHT = RS.rand(K).astype(np.float32) + 0.5
PROB = RS.uniform(0.05, 0.95, (N, K)).astype(np.float32)
BIN = (RS.rand(N, K) > 0.5).astype(np.float32)
A = RS.randn(N, 8).astype(np.float32)
A2 = RS.randn(N, 8).astype(np.float32)
A3 = RS.randn(N, 8).astype(np.float32)
PM1 = np.where(RS.rand(N) > 0.5, 1.0, -1.0).astype(np.float32)
LOGP = np.log(RS.dirichlet(np.ones(K), N)).astype(np.float32)
# CTC: T 7, batch 2, 5 classes, labels of lengths 3 and 2 (repeats)
CTC_LP = RS.randn(7, 2, 5).astype(np.float32)
CTC_LAB = np.asarray([[1, 2, 2], [3, 4, 0]], np.int32)
CTC_IN = np.asarray([7, 5], np.int32)
CTC_LEN = np.asarray([3, 2], np.int32)

# id -> (layer, layer kwargs, functional, functional kwargs, inputs;
#        the first input is the one differentiated)
LOSSES = {
    "ce": ("CrossEntropyLoss", {}, "cross_entropy", {},
           (LOGITS, LABEL_IGN)),
    "ce-weight": ("CrossEntropyLoss", {"weight": WEIGHT}, "cross_entropy",
                  {"weight": WEIGHT}, (LOGITS, LABEL_IGN)),
    "ce-soft": ("CrossEntropyLoss", {"soft_label": True}, "cross_entropy",
                {"soft_label": True}, (LOGITS, SOFT)),
    "ce-smooth": ("CrossEntropyLoss", {"label_smoothing": 0.1},
                  "cross_entropy", {"label_smoothing": 0.1},
                  (LOGITS, LABEL)),
    "ce-probs": ("CrossEntropyLoss", {"use_softmax": False,
                                      "reduction": "sum"},
                 "cross_entropy", {"use_softmax": False, "reduction": "sum"},
                 (PROB, LABEL)),
    "ce-none-axis": ("CrossEntropyLoss", {"reduction": "none", "axis": 0},
                     "cross_entropy", {"reduction": "none", "axis": 0},
                     (LOGITS.T.copy(), LABEL)),
    "mse": ("MSELoss", {}, "mse_loss", {}, (LOGITS, PROB)),
    "l1": ("L1Loss", {"reduction": "sum"}, "l1_loss", {"reduction": "sum"},
           (LOGITS, PROB)),
    "nll": ("NLLLoss", {}, "nll_loss", {}, (LOGP, LABEL_IGN)),
    "nll-weight": ("NLLLoss", {"weight": WEIGHT, "reduction": "sum"},
                   "nll_loss", {"weight": WEIGHT, "reduction": "sum"},
                   (LOGP, LABEL)),
    "bce": ("BCELoss", {}, "binary_cross_entropy", {}, (PROB, BIN)),
    "bce-logits": ("BCEWithLogitsLoss", {"pos_weight": WEIGHT},
                   "binary_cross_entropy_with_logits",
                   {"pos_weight": WEIGHT}, (LOGITS, BIN)),
    "kl": ("KLDivLoss", {"reduction": "batchmean"}, "kl_div",
           {"reduction": "batchmean"}, (LOGP, SOFT)),
    "smooth-l1": ("SmoothL1Loss", {"delta": 0.5}, "smooth_l1_loss",
                  {"delta": 0.5}, (LOGITS, PROB)),
    "margin-ranking": ("MarginRankingLoss", {"margin": 0.2},
                       "margin_ranking_loss", {"margin": 0.2},
                       (A[:, 0], A2[:, 0], PM1)),
    "hinge": ("HingeEmbeddingLoss", {}, "hinge_embedding_loss", {},
              (A[:, 0], PM1)),
    "cosine": ("CosineEmbeddingLoss", {"margin": 0.1},
               "cosine_embedding_loss", {"margin": 0.1}, (A, A2, PM1)),
    "triplet": ("TripletMarginLoss", {"swap": True}, "triplet_margin_loss",
                {"swap": True}, (A, A2, A3)),
    "ctc": ("CTCLoss", {}, "ctc_loss", {},
            (CTC_LP, CTC_LAB, CTC_IN, CTC_LEN)),
    "ctc-sum": ("CTCLoss", {"reduction": "sum"}, "ctc_loss",
                {"reduction": "sum", "norm_by_times": True},
                (CTC_LP, CTC_LAB, CTC_IN, CTC_LEN)),
    "focal": (None, None, "sigmoid_focal_loss", {}, (LOGITS, BIN)),
    "square-error": (None, None, "square_error_cost", {}, (LOGITS, PROB)),
    "log-loss": (None, None, "log_loss", {}, (PROB, BIN)),
    "dice": (None, None, "dice_loss", {}, (PROB, LABEL[:, None])),
    "softmax-ce": (None, None, "softmax_with_cross_entropy",
                   {"return_softmax": True}, (LOGITS, LABEL_IGN)),
}


def _jax_kw(kw):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _port_kw(kw):
    return {k: _t(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _total(out):
    return out[0].sum() if isinstance(out, tuple) else out.sum()


@pytest.mark.parametrize("case", list(LOSSES))
def test_loss_matches_jax_with_gradient(case):
    layer, lkw, fn, fkw, inputs = LOSSES[case]
    want, want_g = _jax_out_and_grad(
        lambda *a: getattr(JF, fn)(*a, **_jax_kw(fkw)), lambda out: out,
        *inputs)
    pin = [_t(a) for a in inputs]
    pin[0].requires_grad_()
    got = getattr(F, fn)(*pin, **_port_kw(fkw))
    _total(got).backward()
    for g, w in zip(_flat(got), _flat(want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    np.testing.assert_allclose(_np(pin[0].grad), np.asarray(want_g), **TOL)
    if layer is not None:
        jl = getattr(jnn, layer)(**_jax_kw(lkw))
        pl = getattr(nn, layer)(**_port_kw(lkw))
        np.testing.assert_allclose(
            _np(pl(*[_t(a) for a in inputs])),
            _np(jl(*[paddle.to_tensor(a) for a in inputs])), **TOL)


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


# ------------------------------------------------------------ initializers
SHAPE = (64, 48)
CONV = (16, 8, 3, 3)


def _fans(shape):
    if len(shape) == 2:
        return shape[0], shape[1]
    r = int(np.prod(shape[2:]))
    return shape[1] * r, shape[0] * r


def _dist(name, shape):
    """The scipy distribution of each random initializer at ``shape``
    (its reference arguments)."""
    fi, fo = _fans(shape)
    relu = math.sqrt(2.0)
    a_xu = math.sqrt(6.0 / (fi + fo))
    a_ku = relu * math.sqrt(3.0 / fi)
    return {
        "Normal": (JI.Normal(0.5, 2.0), I.Normal(0.5, 2.0),
                   stats.norm(0.5, 2.0)),
        "TruncatedNormal": (JI.TruncatedNormal(0.1, 0.5),
                            I.TruncatedNormal(0.1, 0.5),
                            stats.truncnorm(-2, 2, loc=0.1, scale=0.5)),
        "Uniform": (JI.Uniform(-0.3, 0.7), I.Uniform(-0.3, 0.7),
                    stats.uniform(-0.3, 1.0)),
        "XavierNormal": (JI.XavierNormal(), I.XavierNormal(),
                         stats.norm(0, math.sqrt(2.0 / (fi + fo)))),
        "XavierUniform": (JI.XavierUniform(gain=2.0),
                          I.XavierUniform(gain=2.0),
                          stats.uniform(-2 * a_xu, 4 * a_xu)),
        "KaimingNormal": (JI.KaimingNormal(), I.KaimingNormal(),
                          stats.norm(0, relu / math.sqrt(fi))),
        "KaimingUniform": (JI.KaimingUniform(), I.KaimingUniform(),
                           stats.uniform(-a_ku, 2 * a_ku)),
        "KaimingNormal-leaky": (
            JI.KaimingNormal(negative_slope=0.2, nonlinearity="leaky_relu"),
            I.KaimingNormal(negative_slope=0.2, nonlinearity="leaky_relu"),
            stats.norm(0, math.sqrt(2.0 / 1.04) / math.sqrt(fi))),
    }[name]


RANDOM_INITS = ["Normal", "TruncatedNormal", "Uniform", "XavierNormal",
                "XavierUniform", "KaimingNormal", "KaimingUniform",
                "KaimingNormal-leaky"]


@pytest.mark.parametrize("shape", [SHAPE, CONV])
@pytest.mark.parametrize("name", RANDOM_INITS)
def test_initializer_follows_the_reference_distribution(name, shape):
    jinit, pinit, dist = _dist(name, shape)
    paddle.seed(3)
    ref = np.asarray(jinit(shape), np.float64).ravel()
    mine = pinit(shape, generator=paddle_tpu_torch.core.generator(3)
                 ).numpy().astype(np.float64).ravel()
    n = mine.size
    lo, hi = dist.support()
    mean, var = dist.mean(), dist.var()
    raw = [dist.moment(k) for k in (1, 2, 3, 4)]      # E[x^k]
    mu4 = (raw[3] - 4 * mean * raw[2] + 6 * mean ** 2 * raw[1]
           - 3 * mean ** 4)
    se_var = math.sqrt((mu4 - var * var * (n - 3) / (n - 1)) / n)
    for w in (ref, mine):
        assert lo - 1e-6 <= w.min() and w.max() <= hi + 1e-6
        assert abs(w.mean() - mean) <= 4 * math.sqrt(var / n)
        assert abs(w.var(ddof=1) - var) <= 4 * se_var
    crit = 1.628 * math.sqrt(2.0 / n)         # two-sample KS, alpha 0.01
    assert stats.ks_2samp(ref, mine).statistic < crit


def test_deterministic_initializers_equal_the_reference():
    value = RS.randn(4, 6).astype(np.float32)
    pairs = [(JI.Constant(0.7), I.Constant(0.7), SHAPE),
             (JI.Assign(value), I.Assign(value), (4, 6)),
             (JI.Assign(value), I.Assign(_t(value)), (24,)),
             (JI.Dirac(), I.Dirac(), (8, 4, 3, 3)),
             (JI.Dirac(groups=2), I.Dirac(groups=2), (8, 4, 3))]
    for jinit, pinit, shape in pairs:
        np.testing.assert_array_equal(pinit(shape).numpy(),
                                      np.asarray(jinit(shape)))
    assert I.calculate_gain("tanh") == JI.calculate_gain("tanh")
    assert I.calculate_gain("leaky_relu", 0.3) == \
        JI.calculate_gain("leaky_relu", 0.3)


@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (4, 2, 3)])
def test_orthogonal_is_orthonormal_at_its_gain(shape):
    for w in (np.asarray(JI.Orthogonal(gain=1.5)(shape)),
              I.Orthogonal(gain=1.5)(shape).numpy()):
        flat = w.reshape(shape[0], -1)
        small = flat @ flat.T if flat.shape[0] <= flat.shape[1] \
            else flat.T @ flat
        np.testing.assert_allclose(small, 2.25 * np.eye(len(small)),
                                   atol=1e-5)


def test_a_model_seed_and_an_explicit_generator_repeat_their_draws():
    a = nn.Linear(8, 4, weight_attr=nn.ParamAttr(initializer=I.Normal()),
                  device="cpu")
    with I._drawing_from(paddle_tpu_torch.core.generator(5)):
        b = nn.Linear(8, 4, device="cpu")
    with I._drawing_from(paddle_tpu_torch.core.generator(5)):
        c = nn.Linear(8, 4, device="cpu")
    assert torch.equal(b.weight, c.weight)
    assert not torch.equal(a.weight, b.weight)


# ------------------------------------------------------------ ParamAttr
def _pair(attr_kw):
    """A JAX and a port Linear(6, 3) with the same weights and the
    ``ParamAttr`` fields ``attr_kw`` on the weight (the bias plain)."""
    paddle.seed(0)
    jl = jnn.Linear(6, 3, weight_attr=jnn.ParamAttr(**attr_kw))
    pl = nn.Linear(6, 3, weight_attr=nn.ParamAttr(**attr_kw), device="cpu")
    pl.set_state_dict({k: np.asarray(v.value)
                       for k, v in jl.state_dict().items()})
    return jl, pl


@pytest.mark.parametrize("attr", [{"learning_rate": 0.25},
                                  {"trainable": False},
                                  {"need_clip": False},
                                  {"learning_rate": 2.0, "need_clip": False}])
def test_param_attr_reaches_the_optimizer_and_the_clip(attr):
    """One SGD step under a global-norm clip small enough to bind."""
    jl, pl = _pair(attr)
    x = RS.randn(5, 6).astype(np.float32)
    jopt = paddle.optimizer.SGD(
        learning_rate=0.1, parameters=jl.parameters(),
        grad_clip=jnn.ClipGradByGlobalNorm(0.05))
    (jl(paddle.to_tensor(x)) ** 2).sum().backward()
    jopt.step()
    popt = SGD(learning_rate=0.1, parameters=pl.parameters(),
               grad_clip=nn.ClipGradByGlobalNorm(0.05))
    (pl(_t(x)) ** 2).sum().backward()
    popt.step()
    assert pl.weight.requires_grad == attr.get("trainable", True)
    assert pl.weight.need_clip == attr.get("need_clip", True)
    for k, v in pl.state_dict().items():
        np.testing.assert_allclose(_np(v), np.asarray(
            jl.state_dict()[k].value), rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("opt,decay,reg", [
    ("SGD", None, ("L1Decay", 0.1)), ("SGD", None, ("L2Decay", 0.2)),
    ("SGD", 0.05, ("L1Decay", 0.1)), ("Momentum", 0.05, None),
    ("Momentum", ("L1Decay", 0.05), None),
    ("Momentum", ("L2Decay", 0.05), ("L1Decay", 0.1))])
def test_regularizers_fold_into_the_gradient_as_the_reference(opt, decay,
                                                              reg):
    """A ``ParamAttr(regularizer=)`` on the weight takes priority over the
    optimizer's ``weight_decay`` (a float or a regularizer), which the
    bias takes: two steps, each parameter against the JAX optimizer."""
    import paddle_tpu.regularizer as JR

    from paddle_tpu_torch import optimizer as popt_mod
    from paddle_tpu_torch import regularizer as PR

    def make(mod, spec):
        return getattr(mod, spec[0])(spec[1]) if isinstance(spec, tuple) \
            else spec

    paddle.seed(0)
    jl = jnn.Linear(6, 3, weight_attr=jnn.ParamAttr(
        regularizer=make(JR, reg)))
    pl = nn.Linear(6, 3, weight_attr=nn.ParamAttr(regularizer=make(PR, reg)),
                   device="cpu")
    pl.set_state_dict({k: np.asarray(v.value)
                       for k, v in jl.state_dict().items()})
    jopt = getattr(paddle.optimizer, opt)(
        learning_rate=0.1, parameters=jl.parameters(),
        weight_decay=make(JR, decay))
    popt = getattr(popt_mod, opt)(learning_rate=0.1,
                                  parameters=pl.parameters(),
                                  weight_decay=make(PR, decay))
    x = RS.randn(5, 6).astype(np.float32)
    for _ in range(2):
        (jl(paddle.to_tensor(x)) ** 2).sum().backward()
        jopt.step()
        jopt.clear_grad()
        (pl(_t(x)) ** 2).sum().backward()
        popt.step()
        popt.clear_grad()
    for k, v in pl.state_dict().items():
        np.testing.assert_allclose(_np(v), np.asarray(
            jl.state_dict()[k].value), rtol=1e-6, atol=1e-6, err_msg=k)


def test_param_attr_initializer_regularizer_and_the_trainer_multiplier():
    reg = L2Decay(0.5)
    lin = nn.Linear(4, 4, weight_attr=nn.ParamAttr(
        initializer=I.Constant(0.3), learning_rate=0.0, regularizer=reg),
        bias_attr=I.Constant(0.1), device="cpu")
    assert torch.all(lin.weight == 0.3) and torch.all(lin.bias == 0.1)
    assert lin.weight.regularizer is reg
    assert lin.weight.optimize_attr == {"learning_rate": 0.0}
    assert nn.Linear(4, 4, bias_attr=False, device="cpu").bias is None
    # ShardedTrainer steps through the optimizer: a 0 multiplier freezes
    # the weight, the bias moves
    trainer = ShardedTrainer(lin, SGD(0.1, lin.parameters()),
                             lambda out, y: ((out - y) ** 2).mean())
    before = (lin.weight.detach().clone(), lin.bias.detach().clone())
    trainer.train_step(torch.ones(2, 4), torch.zeros(2, 4))
    assert torch.equal(lin.weight, before[0])
    assert not torch.equal(lin.bias, before[1])
    norm = nn.LayerNorm(4, weight_attr=False, bias_attr=False, device="cpu")
    assert norm.weight is None and norm.bias is None
    with pytest.raises(TypeError, match="ParamAttr"):
        nn.Linear(4, 4, weight_attr=3, device="cpu")


# ------------------------------------------------------------ containers
def test_sequential_names_and_forward_match_jax():
    paddle.seed(0)
    jseq = jnn.Sequential(jnn.Linear(6, 5), jnn.ReLU(), jnn.Linear(5, 2))
    pseq = nn.Sequential(nn.Linear(6, 5, device="cpu"), nn.ReLU(),
                         nn.Linear(5, 2, device="cpu"))
    state = {k: np.asarray(v.value) for k, v in jseq.state_dict().items()}
    assert list(state) == list(pseq.state_dict())
    pseq.set_state_dict(state)
    x = RS.randn(3, 6).astype(np.float32)
    np.testing.assert_allclose(_np(pseq(_t(x))),
                               _np(jseq(paddle.to_tensor(x))), **TOL)
    assert len(pseq) == 3 and isinstance(pseq[1], nn.ReLU)
    assert isinstance(pseq[1:], nn.Sequential) and len(pseq[1:]) == 2
    named = nn.Sequential(("fc", nn.Linear(2, 2, device="cpu")),
                          ("act", nn.Tanh()))
    od = nn.Sequential(OrderedDict(fc=nn.Linear(2, 2, device="cpu")))
    assert list(named.state_dict()) == ["fc.weight", "fc.bias"]
    assert list(od.state_dict()) == ["fc.weight", "fc.bias"]
    assert [type(m) for m in named] == [nn.Linear, nn.Tanh]


def test_layer_dict_layer_list_and_parameter_list_name_as_the_reference():
    jd = jnn.LayerDict({"a": jnn.Linear(2, 3), "b": jnn.Linear(3, 1)})
    pd = nn.LayerDict({"a": nn.Linear(2, 3, device="cpu"),
                       "b": nn.Linear(3, 1, device="cpu")})
    assert list(pd.state_dict()) == list(jd.state_dict())
    assert list(pd.keys()) == list(jd.keys()) and "a" in pd
    pd.update([("c", nn.ReLU())])
    assert list(pd.keys()) == ["a", "b", "c"]
    assert isinstance(pd.pop("c"), nn.ReLU) and len(pd) == 2
    pl = nn.LayerList([nn.Linear(2, 2, device="cpu")])
    pl.append(nn.Linear(2, 3, device="cpu"))
    pl.insert(0, nn.Linear(2, 4, device="cpu"))
    pl.extend([nn.ReLU()])
    assert [m.out_features for m in pl[:3]] == [4, 2, 3] and len(pl) == 4
    assert list(pl.state_dict())[:2] == ["0.weight", "0.bias"]
    params = nn.ParameterList([torch.nn.Parameter(torch.zeros(2))])
    params.append(torch.nn.Parameter(torch.ones(3)))
    jp = jnn.ParameterList([paddle.create_parameter([2], "float32"),
                            paddle.create_parameter([3], "float32")])
    assert list(params.state_dict()) == list(jp.state_dict()) == ["0", "1"]


# ------------------------------------------------------------ Embedding
@pytest.mark.parametrize("padding_idx,sparse", [(None, False), (3, True),
                                                (-1, False), (-3, True)])
def test_embedding_layer_padding_idx_and_sparse_match_jax(padding_idx,
                                                          sparse):
    paddle.seed(0)
    jl = jnn.Embedding(10, 4, padding_idx, sparse)
    pl = nn.Embedding(10, 4, padding_idx, sparse, device="cpu")
    w = np.asarray(jl.weight.value)
    pl.set_state_dict({"weight": w})
    assert pl.padding_idx == jl.padding_idx and pl.sparse == sparse
    ids = np.asarray([[1, 3, 9, 7], [0, 3, 2, 9]])
    r = RS.randn(2, 4, 4).astype(np.float32)
    jw = jl.weight.value

    def jout(wv):
        return jl.functional_call({"weight": wv},
                                  paddle.to_tensor(ids)).value

    jgrad = jax.grad(lambda wv: jnp.sum(jout(wv) * r))(jw)
    out = pl(_t(ids))
    (out * _t(r)).sum().backward()
    np.testing.assert_array_equal(_np(out), np.asarray(jout(jw)))
    np.testing.assert_array_equal(_np(pl.weight.grad), np.asarray(jgrad))
    assert pl.weight.grad.layout == torch.strided     # dense, as JAX's
    if padding_idx is not None:
        assert not pl.weight.grad[padding_idx % 10].any()
