"""The port's transformer layers (``paddle_tpu_torch.nn``) against the
JAX package's.

Both packages build the same tiny ``nn.Transformer`` (d_model 32, 4
heads, 2 + 2 layers, FFN 64, dropout 0), post-norm and pre-norm; the
port loads the JAX model's ``state_dict()`` by name and both run the
same seeded numpy inputs:

- the layer structure: the same parameter names, and layers 2..n of the
  encoder and the decoder drawn fresh from the first layer's config
  (different weights), not copied;
- the forward with no mask, with ``generate_square_subsequent_mask`` as
  ``tgt_mask`` (additive -inf) and with a boolean padding ``src_mask``,
  within 1e-5 absolute (fp32, differing only in the order of float
  operations); at length 128 with no mask every attention (encoder
  self, decoder self and cross) takes the flash route through the gate
  (K1's plain version on the CPU), with the causal ``tgt_mask`` the
  decoder's self-attention takes the plain one;
- every parameter's gradient of one backward within 2e-5 absolute and
  1e-4 relative;
- incremental decoding with ``MultiHeadAttention.Cache`` (self
  attention) and ``StaticCache`` (cross attention) from
  ``TransformerDecoder.gen_cache``: each step's output within 1e-5 of
  the JAX decoder's, and of the whole-sequence forward under the causal
  mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor, _no_tape

from paddle_tpu_torch import nn
from paddle_tpu_torch.nn.functional import attention as port_attention

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

D, H, FFN = 32, 4, 64
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _build(normalize_before, seed):
    kw = dict(d_model=D, nhead=H, num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=FFN, dropout=0.0,
              normalize_before=normalize_before)
    paddle.seed(seed)
    jm = jnn.Transformer(**kw)
    jm.eval()
    pm = nn.Transformer(**kw, device="cpu")
    pm.set_state_dict({k: np.asarray(v.value)
                       for k, v in jm.state_dict().items()})
    pm.eval()
    return jm, pm


@pytest.fixture(scope="module", params=[False, True], ids=["post", "pre"])
def pair(request):
    return _build(request.param, seed=3)


def _inputs(s, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(2, s, D).astype(np.float32),
            rs.randn(2, s, D).astype(np.float32))


def _jax_forward(jm, src, tgt, src_mask=None, tgt_mask=None):
    def run(params, a, b, sm, tm):
        with _no_tape():
            return jm.functional_call(
                params, Tensor(a), Tensor(b),
                None if sm is None else Tensor(sm),
                None if tm is None else Tensor(tm)).value

    return jax.jit(run)({n: p.value for n, p in jm.named_parameters()},
                        *[None if a is None else jnp.asarray(a)
                          for a in (src, tgt, src_mask, tgt_mask)])


def test_layers_are_named_as_the_reference_and_drawn_fresh(pair):
    jm, pm = pair
    assert list(pm.state_dict()) == list(jm.state_dict())
    fresh = nn.Transformer(D, H, 2, 2, FFN, device="cpu")
    for stack in (fresh.encoder.layers, fresh.decoder.layers):
        w0 = stack[0].linear1.weight
        assert not torch.equal(w0, stack[1].linear1.weight)
        assert stack[1]._config == stack[0]._config


def _padding_mask(s):
    keep = np.ones((2, 1, 1, s), bool)
    keep[1, ..., s - 5:] = False
    return keep


@pytest.mark.parametrize("s,masks,flash", [
    (16, "none", 0), (16, "causal", 0), (16, "padding", 0),
    (128, "none", 6), (128, "causal", 4)])
def test_forward_matches_jax(pair, monkeypatch, s, masks, flash):
    jm, pm = pair
    src, tgt = _inputs(s, s)
    tgt_mask = src_mask = None
    if masks == "causal":
        tgt_mask = np.asarray(
            jnn.Transformer.generate_square_subsequent_mask(s).numpy())
        np.testing.assert_array_equal(
            nn.Transformer.generate_square_subsequent_mask(
                s, device="cpu").numpy(),
            tgt_mask)
    if masks == "padding":
        src_mask = _padding_mask(s)
    calls = []
    real = port_attention.flash_attention
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want = _jax_forward(jm, src, tgt, src_mask, tgt_mask)
    with torch.no_grad():
        got = pm(_t(src), _t(tgt), None if src_mask is None
                 else _t(src_mask), None if tgt_mask is None
                 else _t(tgt_mask))
    assert len(calls) == flash
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_gradients_match_jax(pair):
    jm, pm = pair
    src, tgt = _inputs(12, 1)
    mask = np.asarray(jnn.Transformer.generate_square_subsequent_mask(12)
                      .numpy())
    r = np.random.RandomState(2).randn(2, 12, D).astype(np.float32)

    def jloss(params):
        with _no_tape():
            out = jm.functional_call(params, Tensor(jnp.asarray(src)),
                                     Tensor(jnp.asarray(tgt)), None,
                                     Tensor(jnp.asarray(mask))).value
        return jnp.sum(out * r)

    jgrads = jax.jit(jax.grad(jloss))({n: p.value
                                       for n, p in jm.named_parameters()})
    pm.zero_grad()
    (pm(_t(src), _t(tgt), None, _t(mask)) * _t(r)).sum().backward()
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[n]),
                                   atol=2e-5, rtol=1e-4, err_msg=n)


def test_incremental_decoding_with_caches_matches_jax_and_the_full_pass(pair):
    jm, pm = pair
    src, tgt = _inputs(4, 4)
    jmem = jm.encoder(paddle.to_tensor(src))
    with torch.no_grad():
        pmem = pm.encoder(_t(src))
        np.testing.assert_allclose(pmem.numpy(), np.asarray(jmem.numpy()),
                                   atol=ATOL)
        jcache = jm.decoder.gen_cache(jmem)
        pcache = pm.decoder.gen_cache(pmem)
        assert isinstance(pcache[0][0], nn.MultiHeadAttention.Cache)
        assert isinstance(pcache[0][1], nn.MultiHeadAttention.StaticCache)
        steps = []
        for i in range(tgt.shape[1]):
            step = tgt[:, i:i + 1]
            jout, jcache = jm.decoder(paddle.to_tensor(step), jmem,
                                      cache=jcache)
            pout, pcache = pm.decoder(_t(step), pmem, cache=pcache)
            np.testing.assert_allclose(pout.numpy(),
                                       np.asarray(jout.numpy()), atol=ATOL)
            steps.append(pout)
        assert tuple(pcache[0][0].k.shape) == (2, 4, H, D // H)
        full = pm.decoder(_t(tgt), pmem, tgt_mask=_t(np.asarray(
            jnn.Transformer.generate_square_subsequent_mask(4).numpy())))
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               atol=ATOL)


def test_multi_head_attention_cache_and_encoder_cache_match_jax():
    paddle.seed(9)
    jl = jnn.TransformerEncoderLayer(D, H, FFN, dropout=0.0,
                                     activation="gelu")
    jl.eval()
    pl = nn.TransformerEncoderLayer(D, H, FFN, dropout=0.0,
                                    activation="gelu", device="cpu")
    pl.set_state_dict({k: np.asarray(v.value)
                       for k, v in jl.state_dict().items()})
    pl.eval()
    x = np.random.RandomState(5).randn(2, 3, D).astype(np.float32)
    with torch.no_grad():
        jout, jc = jl(paddle.to_tensor(x), cache=jl.gen_cache(
            paddle.to_tensor(x)))
        pout, pc = pl(_t(x), cache=pl.gen_cache(_t(x)))
        np.testing.assert_allclose(pout.numpy(), np.asarray(jout.numpy()),
                                   atol=ATOL)
        assert tuple(pc.k.shape) == tuple(jc.k.shape) == (2, 3, H, D // H)
        # a StaticCache of given key/value projections
        mha = pl.self_attn
        kv = _t(np.random.RandomState(6).randn(2, 5, D).astype(np.float32))
        static = mha.gen_cache(kv, kv, type=nn.MultiHeadAttention.StaticCache)
        np.testing.assert_allclose(mha(_t(x), cache=static).numpy(),
                                   mha(_t(x), kv, kv).numpy(), atol=ATOL)
