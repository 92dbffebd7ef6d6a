"""Port flash attention (``paddle_tpu_torch``) against the JAX package.

The same numpy inputs from a seed go through the JAX Pallas flash
kernels in interpret mode (as ``tests/test_pallas.py`` runs them) and
through the port's plain versions on the CPU: the forward (O, lse) of
both TPU routes, the gradients of the port's autograd Function against
``jax.grad`` on both routes, the routing gate of ``_local_attention``,
and the signature of ``scaled_dot_product_attention``.

Tolerances: fp32 on both sides, differing only in summation order —
O and lse atol 2e-5 (one softmax over the whole row against an online
softmax over 64-key blocks), gradients atol 1e-5 at these sizes.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn.functional import attention as port_attention
from paddle_tpu_torch.ops.kernels import flash_attention as port_fa

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

# by module path: the packages' __init__ re-export functions of the
# same names
jax_attention = importlib.import_module("paddle_tpu.nn.functional.attention")
jax_fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

B, S, H = 2, 256, 2


def _inputs(D, seed=0, n=3, s=S):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, s, H, D).astype(np.float32) for _ in range(n)]


@pytest.fixture
def route(monkeypatch):
    """Set the streaming threshold of both packages: "resident" keeps
    the test's lengths on the fused route, "stream" sends them to the
    streaming one."""
    def pick(name):
        value = {"resident": 10 ** 9, "stream": 1}[name]
        monkeypatch.setattr(jax_fa, "_STREAM_THRESHOLD", value)
        monkeypatch.setattr(port_fa, "_STREAM_THRESHOLD", value)
    return pick


@pytest.mark.parametrize("jax_route", ["_flash_fwd_resident",
                                       "_flash_fwd_stream"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [16, 64])
def test_plain_forward_matches_pallas(jax_route, causal, D):
    q, k, v = _inputs(D)
    scale = 1.0 / np.sqrt(D)
    out, (_, lse, *_rest) = getattr(jax_fa, jax_route)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
        64, 64, True)
    o, plse = port_fa.flash_fwd(*map(torch.from_numpy, (q, k, v)), scale,
                                causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse)[:, :, 0],
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("which", ["resident", "stream"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [16, 64])
def test_gradients_match_jax_grad(which, causal, D, route):
    route(which)
    q, k, v, w = _inputs(D, seed=1, n=4, s=128)   # two 64-row blocks

    def loss(a, b, c):
        o = jax_fa.flash_attention(a, b, c, causal=causal, interpret=True,
                                   block_q=64, block_k=64)
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    port_fa.reset_launches()
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = port_attention.flash_attention(*ts, causal=causal)
    (o * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5,
                                   rtol=0)
    # CPU tensors take the plain versions: no kernel ran
    assert all(n == 0 for n in port_fa.launches.values())


# (sq, sk, causal, masked, dropout, flash?): short, prime, block-tiling
# and cross-attention cases on both sides of every condition of the
# gate. A prime length >= 128 is its own block (_pick_block(131, 256) is
# 131), so it goes to flash; 257 only tiles into blocks of 1.
GATE_CASES = [
    (127, 127, True, False, False, False), (131, 131, True, False, False, True),
    (128, 128, True, False, False, True), (192, 192, True, False, False, True),
    (1024, 1024, True, False, False, True),
    (1024, 1024, False, False, False, True),
    (256, 128, False, False, False, True), (256, 128, True, False, False, False),
    (128, 131, False, False, False, True), (320, 320, True, False, False, True),
    (257, 257, True, False, False, False),
    (256, 256, True, True, False, False), (256, 256, True, False, True, False),
    (64, 64, False, False, False, False),
]


@pytest.mark.parametrize("case", GATE_CASES)
def test_gate_goes_to_flash_exactly_where_jax_does(case, monkeypatch):
    sq, sk, causal, masked, dropout, flash = case
    calls = []

    def record(*args, **kwargs):
        calls.append(True)
        return args[0]

    monkeypatch.setattr(jax_fa, "flash_attention", record)
    monkeypatch.setattr(port_attention, "flash_attention", record)
    q = np.zeros((1, sq, 1, 8), np.float32)
    kv = np.zeros((1, sk, 1, 8), np.float32)
    mask = np.ones((sq, sk), bool) if masked else None
    p = 0.5 if dropout else 0.0
    jax_attention._local_attention(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
        None if mask is None else jnp.asarray(mask),
        jax.random.PRNGKey(0) if dropout else None, p, causal, None,
        try_pallas=True)
    jax_took = bool(calls)
    assert jax_took == flash
    calls.clear()
    port_attention._local_attention(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
        None if mask is None else torch.from_numpy(mask), p, causal, None)
    assert bool(calls) == jax_took


def test_sdpa_signature_and_dropout_default_match_jax():
    """The argument order and defaults are the JAX function's, so a
    positional scale is a scale, and training defaults to True: dropout
    with p > 0 is then active, as JAX applies it (some outputs differ
    from the attention without dropout), and with training=False the
    call is the attention without dropout."""
    jsig = inspect.signature(jax_attention.scaled_dot_product_attention)
    psig = inspect.signature(port_attention.scaled_dot_product_attention)
    assert [(p.name, p.default) for p in psig.parameters.values()] == \
        [(p.name, p.default) for p in jsig.parameters.values()]
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 1, 8, generator=g)
    plain = port_attention.scaled_dot_product_attention(q, q, q)
    torch.manual_seed(0)
    dropped = port_attention.scaled_dot_product_attention(q, q, q,
                                                          dropout_p=0.5)
    assert dropped.shape == q.shape and not torch.allclose(dropped, plain)
    out = port_attention.scaled_dot_product_attention(
        q, q, q, None, 0.1, True, 0.5, False)
    assert out.shape == q.shape
    assert torch.equal(out, port_attention.scaled_dot_product_attention(
        q, q, q, None, 0.0, True, 0.5))
