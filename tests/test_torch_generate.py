"""``GPTForCausalLM.generate`` of the port against the JAX package's.

The same weights (copied by name, dropout off, fp32 matmuls on both
sides) and the same prompts:

- greedy (``top_k=1``) is exact: ``use_cache=True`` (the concat caches),
  ``use_cache=False`` (the whole sequence each token) and ``jit=True``
  (a dense ``DecodeEngine`` cached on the model) give the tokens of JAX
  ``generate`` on ``tests/test_models.py:51-130``'s batch, and
  ``jit=True, spec="ngram"`` and a ``DraftModelDrafter`` give those of
  JAX ``generate(jit=True)`` on ``tests/test_speculative.py:100``'s;
- sampled output is held by distribution (JAX's threefry stream is not
  reproduced): the first token of 4000 identical rows follows the
  filtered softmax of the prompt's logits (chi-square at p > 1e-3, none
  outside the filter), and the jit path draws the eager path's tokens
  from the same key data;
- the engine cache and its key, the released buffers, and the
  reference's errors.
"""

import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as paddle

from paddle_tpu_torch.core.random import seed as torch_seed
from paddle_tpu_torch.inference import DraftModelDrafter
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, gpt_tiny
from test_torch_serving import models  # noqa: F401  (fixture)

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

MODELS_BATCH = [[5, 9, 2, 11], [3, 3, 7, 1]]                # test_models.py
SPEC_BATCH = [[1, 2, 3, 4] * 3,                            # test_speculative
              [7, 8, 9, 7, 8, 9, 3, 1, 4, 1, 5, 9]]


def _jax_generate(jm, batch, n, **kw):
    ids = paddle.to_tensor(np.asarray(batch, np.int32))
    return jm.generate(ids, max_new_tokens=n, top_k=1, **kw).numpy()


def _port_generate(pm, batch, n, **kw):
    ids = torch.as_tensor(np.asarray(batch, np.int64))
    out = pm.generate(ids, max_new_tokens=n, top_k=1, **kw)
    assert out.dtype == ids.dtype and out.shape == (len(batch),
                                                    len(batch[0]) + n)
    return out.numpy()


def test_greedy_generate_matches_jax_on_every_path(models):
    jm, pm = models
    want = _jax_generate(jm, MODELS_BATCH, 6)
    assert len(set(want[:, 4:].ravel().tolist())) > 3   # not a copy loop
    for kw in (dict(), dict(use_cache=False), dict(jit=True)):
        np.testing.assert_array_equal(
            _port_generate(pm, MODELS_BATCH, 6, **kw), want, err_msg=str(kw))


def test_greedy_speculative_generate_matches_jax(models):
    """spec="ngram" and a draft model of the target's own weights (which
    accepts every draft up to the cap) and of other weights: the tokens
    of the reference's non-speculative jit path."""
    jm, pm = models
    want = _jax_generate(jm, SPEC_BATCH, 11, jit=True)
    np.testing.assert_array_equal(
        _port_generate(pm, SPEC_BATCH, 11, jit=True), want)
    np.testing.assert_array_equal(
        _port_generate(pm, SPEC_BATCH, 11, jit=True, spec="ngram"), want)
    other = GPTForCausalLM(gpt_tiny(), device="cpu", seed=3)
    for draft in (pm, other):
        np.testing.assert_array_equal(
            _port_generate(pm, SPEC_BATCH, 11, jit=True,
                           spec=DraftModelDrafter(draft, k=3)), want)


def _small_model():
    cfg = GPTConfig(vocab_size=12, hidden_size=16, num_layers=1,
                    num_heads=2, max_position_embeddings=64,
                    hidden_dropout=0.0, attention_dropout=0.0)
    m = GPTForCausalLM(cfg, device="cpu", seed=5)
    with torch.no_grad():
        m.gpt.wte.weight.mul_(4.0)   # logits spread over a few tokens
    return m


@pytest.mark.parametrize("top_k,top_p", [(None, None), (5, None),
                                         (None, 0.8)])
def test_sampled_first_token_follows_the_filtered_softmax(top_k, top_p):
    """4000 rows of one prompt at temperature 0.8, one new token each:
    the draws follow softmax(logits / 0.8) under the filter (chi-square
    at p > 1e-3) and never leave it; 300 rows through the jit path from
    the same seed draw the eager rows' tokens."""
    m, temp, prompt = _small_model(), 0.8, [1, 2, 3, 4]
    with torch.no_grad():
        z = m(torch.as_tensor([prompt]))[0, -1].double().numpy() / temp
    order = np.argsort(-z)
    keep = np.ones(len(z), bool)
    if top_k is not None:
        keep[:] = False
        keep[order[:top_k]] = True
    if top_p is not None:
        ps = np.exp(z[order] - z.max())
        ps /= ps.sum()
        keep[:] = False
        keep[order[(np.cumsum(ps) - ps) < top_p]] = True
    p = np.where(keep, np.exp(z - z.max()), 0.0)
    p /= p.sum()
    assert 3 <= keep.sum() and p.max() < 0.8
    n = 4000
    torch_seed(11)
    got = m.generate(torch.as_tensor([prompt] * n), 1, temp, top_k,
                     top_p).numpy()[:, -1]
    counts = np.bincount(got, minlength=len(z))
    assert counts[~keep].sum() == 0
    chi2 = (((counts[keep] - n * p[keep]) ** 2) / (n * p[keep])).sum()
    assert chi2 < stats.chi2.ppf(0.999, keep.sum() - 1), chi2
    torch_seed(11)
    jit = m.generate(torch.as_tensor([prompt] * 300), 1, temp, top_k, top_p,
                     jit=True).numpy()[:, -1]
    torch_seed(11)
    eager = m.generate(torch.as_tensor([prompt] * 300), 1, temp, top_k,
                       top_p).numpy()[:, -1]
    assert np.mean(jit == eager) >= 0.99


def test_engine_cache_key_release_and_errors(models):
    """One dense engine per (batch, max_len, dtypes, top_k, spec k),
    reused across calls and released after each; the reference's
    errors."""
    _, pm = models
    pm._decode_cache = None
    ids = torch.as_tensor(MODELS_BATCH)
    pm.generate(ids, 4, top_k=1, jit=True)
    pm.generate(ids, 9, top_k=1, jit=True)        # the same max_len 64
    pm.generate(ids, 4, top_k=2, jit=True)
    drafter = DraftModelDrafter(pm, k=2)
    pm.generate(ids, 4, top_k=1, jit=True, spec=drafter)
    keys = sorted(pm._decode_cache, key=str)
    assert keys == sorted([(2, 64, "torch.float32", "torch.int64", 1, None),
                           (2, 64, "torch.float32", "torch.int64", 2, None),
                           (2, 64, "torch.float32", "torch.int64", 1, 2)],
                          key=str)
    assert all(e.kbufs is None and e.paged is False
               for e in pm._decode_cache.values())
    assert drafter.engine.kbufs is None and drafter.engine.paged is False
    assert torch.equal(pm.generate(ids, 0), ids)
    with pytest.raises(ValueError, match="jit=True, spec"):
        pm.generate(ids, 4, spec="ngram")
    with pytest.raises(ValueError, match="top_p"):
        pm.generate(ids, 4, top_p=1.5)
    with pytest.raises(ValueError, match="unknown spec drafter"):
        pm.generate(ids, 4, jit=True, spec="tree")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        pm.generate(ids, 125, jit=True)
    with pytest.raises(ValueError, match="spec headroom k=4"):
        pm.generate(ids, 121, jit=True, spec="ngram")
