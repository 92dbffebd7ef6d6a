"""The port's ``cross_entropy`` variants against the JAX package's.

The same seeded numpy logits and labels go through JAX ``cross_entropy``
(``paddle_tpu/nn/functional/loss.py:37-115``) and the port's, on every
branch of its general path: soft labels (with and without smoothing and
class weights), hard labels with class weights, label smoothing,
``use_softmax=False`` on given probabilities, ``ignore_index`` rows, the
``(N, 1)`` label form, a class axis that is not the last, and each
reduction. Both compute fp32 log-probabilities and reduce them in
another order: every loss within 1e-6 (relative, 1e-6 absolute). The
gradients of the weighted, smoothed mean agree to the same limit.
Under AMP (bf16, O1 and O2) the port casts the op's positional inputs
as the reference's dispatcher does and computes the general path in
fp32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.amp import auto_cast as jax_auto_cast
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.nn import functional as F

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

jax_loss = importlib.import_module("paddle_tpu.nn.functional.loss")

N, C = 12, 7
REDUCTIONS = ["mean", "sum", "none"]


def _data(seed=0):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(N, C) * 2).astype(np.float32)
    hard = rs.randint(0, C, N).astype(np.int64)
    hard[[2, 7]] = -100                       # ignored rows
    soft = rs.rand(N, C).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    weight = rs.rand(C).astype(np.float32) + 0.5
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return logits, hard, soft, weight, probs.astype(np.float32)


def _both(logits, label, **kw):
    w = kw.pop("weight", None)
    want = jax_loss.cross_entropy(
        jnp.asarray(logits), jnp.asarray(label),
        weight=None if w is None else jnp.asarray(w), **kw)
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                          weight=None if w is None else torch.from_numpy(w),
                          **kw)
    return got.detach().numpy(), np.asarray(want)


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [False, True])
def test_soft_labels(reduction, smoothing, weighted):
    logits, _, soft, weight, _ = _data(1)
    _close(*_both(logits, soft, soft_label=True, reduction=reduction,
                  label_smoothing=smoothing,
                  weight=weight if weighted else None))


# (smoothing, weighted): the hard-label combinations of the general
# path (neither is the fast path, held in test_torch_train)
@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("smoothing,weighted", [(0.2, False), (0.0, True),
                                                (0.2, True)])
def test_hard_labels_general_path(reduction, smoothing, weighted):
    logits, hard, _, weight, _ = _data(2)
    _close(*_both(logits, hard, reduction=reduction,
                  label_smoothing=smoothing,
                  weight=weight if weighted else None))


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("soft_label", [False, True])
def test_use_softmax_false_on_probabilities(reduction, soft_label):
    _, hard, soft, _, probs = _data(3)
    probs[0, 0] = 0.0                        # clipped to 1e-15, not -inf
    label = soft if soft_label else hard
    _close(*_both(probs, label, use_softmax=False, soft_label=soft_label,
                  reduction=reduction))


@pytest.mark.parametrize("ignore_index", [-100, 3])
def test_ignore_index_and_the_unit_label_axis(ignore_index):
    logits, hard, _, weight, _ = _data(4)
    hard = np.where(hard < 0, ignore_index, hard)[:, None]   # (N, 1)
    for kw in (dict(weight=weight), dict(label_smoothing=0.1),
               dict(weight=weight, label_smoothing=0.1)):
        for reduction in REDUCTIONS:
            _close(*_both(logits, hard, ignore_index=ignore_index,
                          reduction=reduction, **kw))


def test_all_rows_ignored_mean_is_finite():
    logits, _, _, weight, _ = _data(5)
    hard = np.full(N, -100, np.int64)
    for kw in (dict(weight=weight), dict(label_smoothing=0.1)):
        got, want = _both(logits, hard, **kw)
        _close(got, want)
        assert np.isfinite(got)


def test_class_axis_not_last():
    rs = np.random.RandomState(6)
    logits = rs.randn(3, C, 5).astype(np.float32)
    hard = rs.randint(0, C, (3, 5)).astype(np.int64)
    weight = rs.rand(C).astype(np.float32) + 0.5
    soft = rs.rand(3, C, 5).astype(np.float32)
    soft /= soft.sum(1, keepdims=True)
    for reduction in REDUCTIONS:
        _close(*_both(logits, hard, axis=1, weight=weight,
                      label_smoothing=0.1, reduction=reduction))
        _close(*_both(logits, soft, axis=1, soft_label=True, weight=weight,
                      reduction=reduction))


def test_gradient_of_the_weighted_smoothed_mean():
    logits, hard, _, weight, _ = _data(7)

    def jloss(x):
        return jax_loss.cross_entropy(x, jnp.asarray(hard),
                                      weight=jnp.asarray(weight),
                                      label_smoothing=0.1)

    want = jax.grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    F.cross_entropy(x, torch.from_numpy(hard),
                    weight=torch.from_numpy(weight),
                    label_smoothing=0.1).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_general_path_under_bf16_amp(level):
    """bf16 logits (and, under O2, the soft labels, a positional input)
    reach the general path, which computes in fp32, as the reference's
    does. Without smoothing: smoothing bf16 labels is bf16 arithmetic,
    which XLA and torch round at different places."""
    logits, _, soft, weight, _ = _data(8)
    lb = np.asarray(jnp.asarray(logits, jnp.bfloat16), np.float32)
    with jax_auto_cast(level=level):
        want = jax_loss.cross_entropy(
            Tensor(jnp.asarray(lb, jnp.bfloat16)), Tensor(jnp.asarray(soft)),
            weight=jnp.asarray(weight), soft_label=True).value
    with auto_cast(level=level):
        got = F.cross_entropy(torch.from_numpy(lb).to(torch.bfloat16),
                              torch.from_numpy(soft),
                              weight=torch.from_numpy(weight),
                              soft_label=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(np.asarray(want)),
                               rtol=1e-5)
