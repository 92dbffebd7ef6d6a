"""float16 flash attention: the port's plain versions against the Pallas
kernels in interpret mode.

fp16 AMP sends fp16 q, k and v to the flash path (``auto_cast(dtype=
"float16")``; ``scaled_dot_product_attention`` is white-listed). On the
card the port runs the tensor-core bodies instantiated on ``__half``; on
the CPU its wrappers run the plain versions, which round P and dS to
fp16 where the Pallas kernels round them. The same seeded fp16 inputs go
through JAX ``flash_attention`` (interpret mode, both routes) and the
port, forward and the three gradients, at head dims 16 and 64, causal
and not; the outputs are fp16 on both sides. Both compute fp32 logits
and softmax state from the same fp16 values and round P, dS and each
output to fp16 once, but sum in another order, so a rounding can land
one fp16 ulp apart: every element within 2e-3 + 2**-9 |jax| (one ulp of
fp16 at the outputs' scale, 2**-10 relative, plus a flipped rounding of
P or dS carried through a product).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.nn.functional import attention as port_attention
from paddle_tpu_torch.ops.kernels import flash_attention as port_fa

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

B, S, H = 2, 128, 2
ATOL, RTOL = 2e-3, 2.0 ** -9


def _inputs(D, seed, n=4):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, S, H, D).astype(np.float16) for _ in range(n)]


def _close(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.fixture
def route(monkeypatch):
    def pick(name):
        value = {"resident": 10 ** 9, "stream": 1}[name]
        monkeypatch.setattr(jax_fa, "_STREAM_THRESHOLD", value)
        monkeypatch.setattr(port_fa, "_STREAM_THRESHOLD", value)
    return pick


@pytest.mark.parametrize("which", ["resident", "stream"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [16, 64])
def test_fp16_forward_and_gradients_match_the_pallas_kernels(which, causal,
                                                             D, route):
    route(which)
    q, k, v, w = _inputs(D, seed=D + causal)

    def loss(a, b, c):
        o = jax_fa.flash_attention(a, b, c, causal=causal, interpret=True,
                                   block_q=64, block_k=64)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w, jnp.float32)), o

    (_, jo), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    assert jo.dtype == jnp.float16 and all(g.dtype == jnp.float16
                                           for g in jgrads)
    port_fa.reset_launches()
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = port_attention.flash_attention(*ts, causal=causal)
    assert o.dtype == torch.float16
    (o.float() * torch.from_numpy(w).float()).sum().backward()
    _close(o, jo)
    for t, g in zip(ts, jgrads):
        assert t.grad.dtype == torch.float16
        _close(t.grad, g)
    assert all(n == 0 for n in port_fa.launches.values())


def test_fp16_plain_forward_rounds_p_to_fp16():
    """The plain forward rounds P to V's dtype before P.V: in fp16 its O
    differs from the same computation with P kept in fp32."""
    q, k, v, _ = _inputs(64, seed=3)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = port_fa.flash_fwd_ref(qt, kt, vt, 0.125, True)
    assert o.dtype == torch.float16 and lse.dtype == torch.float32
    s = port_fa._scores(qt, kt, 0.125, True)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))   # unnormalized, <= 1
    l = p.sum(dim=-1, keepdim=True)
    vf = vt.transpose(1, 2).float()
    exact = (torch.matmul(p, vf) / l).transpose(1, 2)
    rounded = (torch.matmul(p.to(torch.float16).float(), vf) / l
               ).transpose(1, 2)
    assert torch.equal(o, rounded.to(torch.float16))
    assert not torch.equal(o, exact.to(torch.float16))


def test_fp16_amp_reaches_the_flash_path_in_fp16(monkeypatch):
    """Under auto_cast(dtype="float16") the public sdpa hands the flash
    path fp16 q, k and v, as the JAX package's AMP does."""
    seen = []
    real = port_fa.flash_fwd

    def spy(q, k, v, scale, causal):
        seen.append(q.dtype)
        return real(q, k, v, scale, causal)

    monkeypatch.setattr(port_fa, "flash_fwd", spy)
    q = torch.randn(1, 128, 2, 64)
    with auto_cast(dtype="float16"):
        out = port_attention.scaled_dot_product_attention(q, q, q,
                                                          is_causal=True)
    assert seen == [torch.float16] and out.dtype == torch.float16
