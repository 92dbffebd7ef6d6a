"""Port BERT and ERNIE (``paddle_tpu_torch.models``) against the JAX
package's models.

The port loads the JAX model's ``state_dict()`` by name
(``set_state_dict``) and both run the same seeded numpy ids at a tiny
width (hidden 32, 2 layers, 2 heads):

- logits within 1e-5 absolute (fp32 on both sides, differing only in
  the order of float operations), with and without a (batch, seq)
  padding mask; at S 128 with no mask the port's attention takes the
  flash route through the gate (K1's plain version on the CPU) once
  per layer, and with a mask it never does;
- the pretraining loss (MLM with ignore_index -100, plus NSP) and every
  parameter's gradient after one backward: loss rtol 1e-5, gradients
  within 2e-5 absolute and 1e-4 relative (two fp32 reductions over the
  batch in different orders);
- ERNIE's classifier with task-type ids and a mask, the same way;
- under AMP (bf16) the MLM logits come out bf16 in both (the tied
  decoder is the white-listed ``matmul``) and agree within 3e-2 of the
  logits' scale: two bf16 computations that round at different places;
- ``ShardedTrainer`` trains, evaluates and predicts with a ``loss_fn``
  over the models' tuple outputs.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import auto_cast as jax_auto_cast
from paddle_tpu.core.tensor import Tensor, _no_tape
from paddle_tpu.models import BertConfig as JaxBertConfig
from paddle_tpu.models import BertForPretraining as JaxBertPretraining
from paddle_tpu.models import \
    BertForSequenceClassification as JaxBertClassifier
from paddle_tpu.models import ErnieConfig as JaxErnieConfig
from paddle_tpu.models import ErnieForSequenceClassification as JaxErnie

from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.distributed import ShardedTrainer
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     BertForSequenceClassification,
                                     ErnieConfig,
                                     ErnieForSequenceClassification,
                                     ernie_1_0)
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.models import ernie as port_ernie
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import attention as port_attention
from paddle_tpu_torch.optimizer import AdamW

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

JF = importlib.import_module("paddle_tpu.nn.functional")

TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=160, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _state(jm):
    return {k: np.asarray(v.value) for k, v in jm.state_dict().items()}


def _jax_run(jm, *arrays):
    """The JAX model's forward on ``arrays`` (numpy or None), compiled:
    one XLA program instead of an eager op-by-op run."""
    def run(params, *vals):
        with _no_tape():
            out = jm.functional_call(params, *[
                None if v is None else Tensor(v) for v in vals])
        return jax.tree_util.tree_map(lambda t: t.value, out,
                                      is_leaf=lambda t: isinstance(t, Tensor))

    return jax.jit(run)({n: p.value for n, p in jm.named_parameters()},
                        *[None if a is None else jnp.asarray(a)
                          for a in arrays])


def _pair(jcls, pcls, jcfg, pcfg, seed=0):
    paddle.seed(seed)
    jm = jcls(jcfg)
    jm.eval()
    pm = pcls(pcfg, device="cpu")
    pm.set_state_dict(_state(jm))
    pm.eval()
    return jm, pm


@pytest.fixture(scope="module")
def bert():
    return _pair(JaxBertPretraining, BertForPretraining, JaxBertConfig(**TINY),
                 BertConfig(**TINY))


@pytest.fixture(scope="module")
def classifier():
    return _pair(JaxBertClassifier, BertForSequenceClassification,
                 JaxBertConfig(**TINY), BertConfig(**TINY), seed=2)


@pytest.fixture(scope="module")
def ernie():
    return _pair(JaxErnie, ErnieForSequenceClassification,
                 JaxErnieConfig(**TINY, num_labels=3),
                 ErnieConfig(**TINY, num_labels=3), seed=1)


def _batch(s, seed, masked):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 64, (2, s))
    tt = rs.randint(0, 2, (2, s))
    mask = None
    if masked:
        mask = np.ones((2, s), np.int64)
        mask[1, s // 2:] = 0
    return ids, tt, mask


def _count_flash(monkeypatch):
    calls = []
    real = port_attention.flash_attention
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_state_dict_names_and_shapes_match_every_model(bert, classifier,
                                                       ernie):
    for jm, pm in (bert, classifier, ernie):
        want = {k: v.shape for k, v in _state(jm).items()}
        assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} \
            == want
        for k, v in pm.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), _state(jm)[k])


@pytest.mark.parametrize("s,masked,flash", [(16, True, 0), (128, False, 2),
                                            (128, True, 0)])
def test_pretraining_logits_match_jax(bert, monkeypatch, s, masked, flash):
    jm, pm = bert
    ids, tt, mask = _batch(s, s, masked)
    calls = _count_flash(monkeypatch)
    want = _jax_run(jm, ids, tt, mask)
    with torch.no_grad():
        got = pm(_t(ids), _t(tt), None if mask is None else _t(mask))
    assert len(calls) == flash
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def _mlm_nsp_labels(ids, seed):
    rs = np.random.RandomState(seed)
    mlm = np.where(rs.rand(*ids.shape) < 0.15, ids, -100)
    mlm[0, 0] = ids[0, 0]               # at least one masked position
    return mlm, rs.randint(0, 2, (ids.shape[0],))


@pytest.mark.parametrize("s,masked", [(128, False), (16, True)])
def test_pretraining_loss_and_gradients_match_jax(bert, s, masked):
    jm, pm = bert
    ids, tt, mask = _batch(s, 7 + s, masked)
    mlm, nsp = _mlm_nsp_labels(ids, s)

    def jloss_of(params):
        with _no_tape():
            m_logits, n_logits = jm.functional_call(
                params, Tensor(jnp.asarray(ids)), Tensor(jnp.asarray(tt)),
                None if mask is None else Tensor(jnp.asarray(mask)))
            return (JF.cross_entropy(m_logits.value, jnp.asarray(mlm),
                                     ignore_index=-100)
                    + JF.cross_entropy(n_logits.value, jnp.asarray(nsp)))

    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_of))(
        {n: p.value for n, p in jm.named_parameters()})
    pm.zero_grad()
    m_logits, n_logits = pm(_t(ids), _t(tt), None if mask is None
                            else _t(mask))
    loss = (F.cross_entropy(m_logits, _t(mlm), ignore_index=-100)
            + F.cross_entropy(n_logits, _t(nsp)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[n]),
                                   atol=2e-5, rtol=1e-4, err_msg=n)


def test_ernie_classifier_logits_and_gradients_match_jax(ernie):
    jm, pm = ernie
    ids, tt, mask = _batch(24, 3, True)
    task = np.random.RandomState(4).randint(0, 3, ids.shape)
    labels = np.asarray([2, 0])

    def jloss_of(params):
        with _no_tape():
            logits = jm.functional_call(
                params, Tensor(jnp.asarray(ids)), Tensor(jnp.asarray(tt)),
                Tensor(jnp.asarray(mask)), Tensor(jnp.asarray(task)))
            return JF.cross_entropy(logits.value, jnp.asarray(labels)), \
                logits.value

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jloss_of, has_aux=True))({n: p.value
                                  for n, p in jm.named_parameters()})
    pm.zero_grad()
    logits = pm(_t(ids), _t(tt), _t(mask), _t(task))
    loss = F.cross_entropy(logits, _t(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[n]),
                                   atol=2e-5, rtol=1e-4, err_msg=n)


def test_sequence_classifier_logits_match_jax(classifier):
    jm, pm = classifier
    ids, tt, mask = _batch(20, 5, True)
    want = _jax_run(jm, ids, tt, mask)
    with torch.no_grad():
        got = pm(_t(ids), _t(tt), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_amp_logits_are_bf16_and_near_the_reference(bert):
    jm, pm = bert
    ids, tt, _ = _batch(16, 9, False)
    with jax_auto_cast(dtype="bfloat16"):
        want = _jax_run(jm, ids, tt)[0]
    with torch.no_grad(), auto_cast(dtype="bfloat16"):
        got = pm(_t(ids), _t(tt))[0]
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    w = np.asarray(want, np.float32)
    g = got.float().numpy()
    assert np.abs(g - w).max() <= 3e-2 * np.abs(w).max()


def test_trainer_trains_evaluates_and_predicts_with_tuple_outputs():
    """MLM + NSP: the labels ride in one (b, s + 1) tensor, the NSP label
    in the last column; the first step's loss is the model's loss on the
    same weights, and 6 steps on one batch lower it."""
    torch.manual_seed(0)
    model = BertForPretraining(BertConfig(**TINY), device="cpu", seed=3)
    ids, tt, mask = _batch(16, 11, True)
    mlm, nsp = _mlm_nsp_labels(ids, 12)
    labels = np.concatenate([mlm, nsp[:, None]], axis=1)

    def loss_fn(out, label):
        mlm_logits, nsp_logits = out
        return (F.cross_entropy(mlm_logits, label[:, :-1], ignore_index=-100)
                + F.cross_entropy(nsp_logits, label[:, -1]))

    with torch.no_grad():
        first = loss_fn(model(_t(ids), _t(tt), _t(mask)), _t(labels))
    trainer = ShardedTrainer(model, AdamW(1e-3, parameters=model.parameters()),
                             loss_fn)
    losses = [float(trainer.train_step(ids, tt, mask, labels))
              for _ in range(6)]
    np.testing.assert_allclose(losses[0], first.item(), rtol=1e-6)
    assert losses[-1] < losses[0]
    ev = trainer.eval_step(ids, tt, mask, labels)
    with torch.no_grad():
        model.eval()
        direct = loss_fn(model(_t(ids), _t(tt), _t(mask)), _t(labels))
    np.testing.assert_allclose(float(ev), direct.item(), rtol=1e-6)
    mlm_logits, nsp_logits = trainer.predict_step(ids, tt, mask)
    assert tuple(mlm_logits.shape) == (2, 16, 64)
    assert tuple(nsp_logits.shape) == (2, 2)
    # the classifier: logits against class ids
    clf = ErnieForSequenceClassification(ErnieConfig(**TINY), device="cpu",
                                         seed=4)
    ct = ShardedTrainer(clf, AdamW(1e-3, parameters=clf.parameters()),
                        lambda out, y: F.cross_entropy(out, y))
    task = np.zeros_like(ids)
    steps = [float(ct.train_step(ids, tt, mask, task, np.asarray([1, 0])))
             for _ in range(4)]
    assert steps[-1] < steps[0]
    assert tuple(ct.predict_step(ids, tt, mask, task).shape) == (2, 2)


def test_seeded_builds_repeat_and_ernie_defaults_are_the_reference():
    a = BertForPretraining(BertConfig(**TINY), device="cpu", seed=7)
    b = BertForPretraining(BertConfig(**TINY), device="cpu", seed=7)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    assert ernie_1_0() == ErnieConfig() and ErnieConfig().vocab_size == 18000
    std = a.bert.embeddings.word_embeddings.weight.std().item()
    assert abs(std - 0.02) < 0.002       # initializer_range


def test_pipeline_variants_raise_naming_the_roadmap_item():
    """The pipeline variants, refusals (ROADMAP.md Queue 1 item 6) until
    the pipeline was ported: ``BertForPretrainingPipe`` and
    ``ErnieForPretrainingPipe`` at 2 stages take the JAX models' weights
    by name (the stacked ``stage__*`` layout, the tied decode stored
    once) and their sequential forward gives the JAX MLM logits; the
    mean MLM loss of ``loss_and_grads`` over 2 microbatches equals the
    JAX ``mlm_loss`` of those logits."""
    from paddle_tpu.models import BertForPretrainingPipe as JaxBertPipe
    from paddle_tpu.models import ErnieForPretrainingPipe as JaxErniePipe

    rs = np.random.RandomState(4)
    ids = rs.randint(0, 64, (2, 16)).astype(np.int32)
    labels = np.where(rs.rand(2, 16) < 0.3, ids, -100).astype(np.int32)
    for jax_cls, port_cls, cfg_cls in (
            (JaxBertPipe, port_bert.BertForPretrainingPipe, BertConfig),
            (JaxErniePipe, port_ernie.ErnieForPretrainingPipe,
             ErnieConfig)):
        paddle.seed(2)
        ref = jax_cls(getattr(importlib.import_module(
            "paddle_tpu.models"), cfg_cls.__name__)(**TINY), 2, 2)
        ref.eval()
        mine = port_cls(cfg_cls(**TINY), 2, 2, device="cpu")
        mine.set_state_dict({k: np.asarray(v.value)
                             for k, v in ref.state_dict().items()})
        mine.eval()
        assert isinstance(mine.last, port_bert.BertMLMHeadStage)
        assert mine.last.word_embeddings is mine.first.word_embeddings
        want = np.asarray(ref(Tensor(jnp.asarray(ids))).value)
        got = mine(torch.as_tensor(ids, dtype=torch.long))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
        loss, _ = mine.loss_and_grads(
            None, (torch.as_tensor(ids, dtype=torch.long),
                   torch.as_tensor(labels, dtype=torch.long)), 0)
        with _no_tape():
            halves = [float(np.asarray(jax_cls.mlm_loss(
                Tensor(jnp.asarray(want[i:i + 1])),
                Tensor(jnp.asarray(labels[i:i + 1]))).value))
                for i in range(2)]
        np.testing.assert_allclose(loss.item(), np.mean(halves), rtol=1e-5)


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from paddle_tpu_torch import nn, ops

    builds = [lambda: BertForPretraining(BertConfig(**TINY)),
              lambda: ErnieForSequenceClassification(ErnieConfig(**TINY)),
              lambda: nn.Transformer(16, 2, 1, 1, 32),
              lambda: nn.TransformerEncoderLayer(16, 2, 32),
              lambda: nn.TransformerDecoderLayer(16, 2, 32),
              lambda: nn.MultiHeadAttention(16, 2),
              lambda: nn.Transformer.generate_square_subsequent_mask(4),
              lambda: ops.to_tensor([1.0, 2.0])]
    for name, args in (("zeros", ([3],)), ("ones", ([3],)),
                       ("empty", ([3],)), ("full", ([3], 1.0)),
                       ("arange", (4,)), ("linspace", (0.0, 1.0, 3)),
                       ("eye", (3,)), ("rand", ([3],)), ("randn", ([3],)),
                       ("uniform", ([3],)), ("normal", (0.0, 1.0, [3])),
                       ("randint", (3,)), ("randperm", (3,))):
        builds.append(lambda op=getattr(ops, name), a=args: op(*a))
    for build in builds:
        with pytest.raises(RuntimeError, match='device="cpu"|device=.cpu.'):
            build()
