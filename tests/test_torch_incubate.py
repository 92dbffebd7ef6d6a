"""The port's ``incubate`` (``paddle_tpu_torch/incubate/``: the fused
transformer layers and the extras) against the reference's on the CPU.

``import paddle_tpu_torch.incubate`` gives every name of
``paddle_tpu.incubate.__all__`` and of the MoE package's. The fused
layers take the reference's weights by name: outputs and the input's
gradient within 1e-5 and every parameter gradient within 1e-5 of its
largest, for attention, feed-forward and the encoder layer, pre- and
post-norm (fp32, the plain attention route at these lengths), and the
reference's refusals. Each extras function runs
on the same inputs as the reference's: the optimizer wrappers through
the same sequence of inner steps (exact to fp32 rounding), the fused
softmax-mask ops within 1e-6, the segment and message-passing
reductions (empty segments and isolated nodes read 0) within 1e-6, and
the host graph utilities exactly where they draw nothing
(``sample_size`` -1, hop sizes past every degree). Sampling draws from
``np.random.RandomState(seed)``: a seed repeats its draw, and each
node's sample is ``min(degree, size)`` distinct neighbours of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu import incubate as jinc
from paddle_tpu.core.tensor import Parameter, Tensor, _no_tape
from paddle_tpu.incubate import extras as jex
from paddle_tpu.incubate.nn import fused_transformer as jft

import paddle_tpu_torch.incubate as inc
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.incubate import extras as pex
from paddle_tpu_torch.incubate.nn import fused_transformer as pft

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(t):
    return np.asarray(t.value if hasattr(t, "value") else t)


def test_incubate_carries_every_reference_name():
    from paddle_tpu.incubate.distributed.models import moe as jmoe

    from paddle_tpu_torch.incubate.distributed.models import moe

    assert inc.__all__ == jinc.__all__
    assert all(hasattr(inc, n) for n in jinc.__all__)
    assert moe.__all__ == jmoe.__all__
    assert all(hasattr(moe, n) for n in jmoe.__all__)
    assert inc.nn.__all__ == jinc.nn.__all__
    assert inc.distributed.models.moe is moe


# -- the fused layers ----------------------------------------------------------

def _build(kind, pre):
    common = dict(normalize_before=pre)
    if kind == "attn":
        args, kw = (32, 4), dict(dropout_rate=0.0, attn_dropout_rate=0.0)
        return (jft.FusedMultiHeadAttention(*args, **kw, **common),
                pft.FusedMultiHeadAttention(*args, **kw, **common,
                                            device="cpu"))
    if kind == "ffn":
        args, kw = (32, 64), dict(dropout_rate=0.0, activation="gelu")
        return (jft.FusedFeedForward(*args, **kw, **common),
                pft.FusedFeedForward(*args, **kw, **common, device="cpu"))
    args, kw = (32, 4, 64), dict(dropout_rate=0.0)
    return (jft.FusedTransformerEncoderLayer(*args, **kw, **common),
            pft.FusedTransformerEncoderLayer(*args, **kw, **common,
                                             device="cpu"))


@pytest.mark.parametrize("kind", ["attn", "ffn", "encoder"])
@pytest.mark.parametrize("pre", [False, True])
def test_fused_layer_equals_the_reference(kind, pre):
    ref.seed(3)
    jl, pl = _build(kind, pre)
    rs = np.random.RandomState(4)
    state = {k: rs.randn(*v.shape).astype(np.float32) * 0.3
             + (1.0 if "norm" in k and k.endswith("weight") else 0.0)
             for k, v in jl.state_dict().items()}
    jl.set_state_dict(state)
    pl.set_state_dict(state)
    x = rs.randn(2, 8, 32).astype(np.float32)
    w = rs.randn(2, 8, 32).astype(np.float32)

    def loss(params, xv):
        with _no_tape():
            out = jl.functional_call(params, Tensor(xv)).value
        return jnp.sum(out * w), out

    names = [n for n, _ in jl.named_parameters()]
    (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        {n: p.value for n, p in jl.named_parameters()}, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = pl(xt)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    params = dict(pl.named_parameters())
    assert sorted(params) == sorted(names)
    for n in names:
        want = np.asarray(jg[n])
        np.testing.assert_allclose(params[n].grad.numpy(), want,
                                   atol=1e-5 * max(1.0, np.abs(want).max()),
                                   err_msg=n)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)


def test_fused_layers_keep_the_reference_refusals():
    with pytest.raises(NotImplementedError, match="need_weights"):
        pft.FusedMultiHeadAttention(32, 4, need_weights=True, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        pft.FusedMultiHeadAttention(30, 4, device="cpu")
    attn = pft.FusedMultiHeadAttention(32, 4, device="cpu").eval()
    enc = pft.FusedTransformerEncoderLayer(32, 4, 64, device="cpu").eval()
    x, y = torch.randn(1, 4, 32), torch.randn(1, 4, 32)
    for call in (lambda: attn(x, y), lambda: attn(x, None, y),
                 lambda: attn(x, cache=(x, x)), lambda: enc(x, cache=(x,))):
        with pytest.raises(NotImplementedError):
            call()
    assert tuple(attn(x, x, x).shape) == (1, 4, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pft.FusedFeedForward(32, 64)


def test_fused_attention_keeps_the_per_head_packed_layout():
    """Head h's q, k, v are columns [3 h d, 3 (h + 1) d) of the qkv
    projection, in that order: columns [8, 12) are head 0's v (they
    would be head 0's k in a hidden-wide q | k | v split), so a
    projection that writes only them gives head 0 an output and head 1
    none."""
    attn = pft.FusedMultiHeadAttention(8, 2, dropout_rate=0.0,
                                       attn_dropout_rate=0.0,
                                       normalize_before=True,
                                       device="cpu").eval()
    with torch.no_grad():
        attn.qkv_proj.weight.zero_()
        attn.qkv_proj.bias.zero_()
        attn.qkv_proj.weight[:, 8:12] = torch.eye(8)[:, :4]
        attn.out_proj.weight.copy_(torch.eye(8))
        attn.out_proj.bias.zero_()
    x = torch.randn(1, 3, 8)
    out = attn(x) - x
    assert torch.count_nonzero(out[..., :4]) > 0
    assert torch.count_nonzero(out[..., 4:]) == 0


# -- the extras: optimizer wrappers -------------------------------------------

class _FakeInner:
    """An inner optimizer whose i-th step subtracts 0.1 * i * (1 + j) from
    parameter j: the same updates on either framework's parameters."""

    def __init__(self, params, write):
        self._parameter_list = params
        self._write = write
        self.n = 0

    def step(self):
        self.n += 1
        for j, p in enumerate(self._parameter_list):
            self._write(p, -0.1 * self.n * (1 + j))

    def clear_grad(self):
        pass


def _pairs(rs):
    vals = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    jp = [Parameter(jnp.asarray(v)) for v in vals]
    pp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in vals]
    return jp, pp


def _jwrite(p, d):
    p._replace_value(p.value + d)


def _pwrite(p, d):
    with torch.no_grad():
        p.add_(d)


def test_lookahead_equals_the_reference():
    jp, pp = _pairs(np.random.RandomState(5))
    jl = jex.LookAhead(_FakeInner(jp, _jwrite), alpha=0.3, k=3)
    pl = pex.LookAhead(_FakeInner(pp, _pwrite), alpha=0.3, k=3)
    assert pl.inner_opt is pl._inner and pl.n == 0   # __getattr__ forwards
    for _ in range(7):
        jl.step()
        pl.step()
        for a, b in zip(jp, pp):
            np.testing.assert_allclose(b.detach().numpy(), _np(a),
                                       atol=1e-6)
    loss = (pp[0] * 2).sum()
    pl.minimize(loss)
    assert pl._step_count == 8


def test_model_average_equals_the_reference():
    jp, pp = _pairs(np.random.RandomState(6))
    jm = jex.ModelAverage(0.5, parameters=jp, min_average_window=2,
                          max_average_window=3)
    pm = pex.ModelAverage(0.5, parameters=pp, min_average_window=2,
                          max_average_window=3)
    for i in range(6):
        for j, (a, b) in enumerate(zip(jp, pp)):
            _jwrite(a, 0.2 * (i + j))
            _pwrite(b, 0.2 * (i + j))
        jm.step()
        pm.step()
        for need in (True, False) if i == 5 else (True,):
            jm.apply(need_restore=need)
            pm.apply(need_restore=need)
            for a, b in zip(jp, pp):
                np.testing.assert_allclose(b.detach().numpy(), _np(a),
                                           atol=1e-6)
            jm.restore()
            pm.restore()
            for a, b in zip(jp, pp):
                np.testing.assert_allclose(b.detach().numpy(), _np(a),
                                           atol=1e-6)


# -- the extras: tensor ops ---------------------------------------------------

def test_softmax_mask_fuse_equals_the_reference():
    rs = np.random.RandomState(7)
    x = rs.randn(2, 3, 5, 5).astype(np.float32)
    mask = np.where(rs.rand(2, 1, 5, 5) > 0.3, 0.0, -1e4).astype(np.float32)
    got = pex.softmax_mask_fuse(torch.from_numpy(x), torch.from_numpy(mask))
    want = jex.softmax_mask_fuse(Tensor(jnp.asarray(x)),
                                 Tensor(jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)
    got = pex.softmax_mask_fuse_upper_triangle(torch.from_numpy(x))
    want = jex.softmax_mask_fuse_upper_triangle(Tensor(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)
    assert float(got[0, 0, 0, 1:].abs().max()) == 0.0


SEGMENT_IDS = np.asarray([0, 0, 2, 2, 2, 5, 3], np.int64)   # 1 and 4 empty


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean",
                                "segment_max", "segment_min"])
def test_segment_op_equals_the_reference(op):
    data = np.random.RandomState(8).randn(7, 3).astype(np.float32)
    xt = torch.from_numpy(data).requires_grad_()
    got = getattr(pex, op)(xt, torch.from_numpy(SEGMENT_IDS))
    want = getattr(jex, op)(Tensor(jnp.asarray(data)),
                            Tensor(jnp.asarray(SEGMENT_IDS.astype(np.int32))))
    assert tuple(got.shape) == (6, 3)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-6)
    assert float(got[1].abs().sum()) == float(got[4].abs().sum()) == 0.0
    got.sum().backward()
    assert xt.grad is not None and bool(torch.isfinite(xt.grad).all())


@pytest.mark.parametrize("pool", ["sum", "mean", "max", "min"])
def test_graph_send_recv_equals_the_reference(pool):
    x = np.random.RandomState(9).randn(5, 4).astype(np.float32)
    src = np.asarray([0, 1, 2, 3, 0, 4], np.int64)
    dst = np.asarray([1, 2, 1, 0, 0, 2], np.int64)    # node 3, 4 isolated
    for out_size in (None, 6):
        got = pex.graph_send_recv(torch.from_numpy(x), src, dst, pool,
                                  out_size)
        want = jex.graph_send_recv(Tensor(jnp.asarray(x)),
                                   Tensor(jnp.asarray(src.astype(np.int32))),
                                   Tensor(jnp.asarray(dst.astype(np.int32))),
                                   pool, out_size)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)
    with pytest.raises(ValueError, match="pool_type"):
        pex.graph_send_recv(torch.from_numpy(x), src, dst, "prod")


# -- the extras: graph utilities on the host -----------------------------------

@pytest.fixture
def cpu_place():
    """``set_device("cpu")`` for one test: host arrays give outputs on
    the default place, the card otherwise."""
    port_place._default_place = None
    port_place.set_device("cpu")
    yield
    port_place._default_place = None


# a CSC graph of 6 nodes: node i's neighbours are row[colptr[i]:colptr[i+1]]
ROW = np.asarray([1, 2, 3, 0, 2, 0, 1, 4, 5, 3, 5, 4], np.int64)
COLPTR = np.asarray([0, 3, 5, 8, 9, 11, 12], np.int64)


def test_graph_reindex_equals_the_reference():
    x = np.asarray([4, 0], np.int64)
    nb = np.asarray([3, 5, 1, 2, 3], np.int64)
    cnt = np.asarray([2, 3], np.int64)
    got = pex.graph_reindex(torch.from_numpy(x), torch.from_numpy(nb),
                            torch.from_numpy(cnt))
    want = jex.graph_reindex(x, nb, cnt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_graph_sample_neighbors_equals_the_reference_when_it_keeps_all(cpu_place):
    nodes = np.asarray([0, 2, 5], np.int64)
    for eids in (None, np.arange(100, 112, dtype=np.int64)):
        got = pex.graph_sample_neighbors(ROW, COLPTR, nodes, -1, eids,
                                         return_eids=True)
        want = jex.graph_sample_neighbors(ROW, COLPTR, nodes, -1, eids,
                                          return_eids=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), _np(w))
    nb, cnt = pex.graph_sample_neighbors(torch.from_numpy(ROW), COLPTR,
                                         nodes)
    assert nb.dtype == torch.int64 and cnt.tolist() == [3, 3, 1]


def test_graph_sample_neighbors_draws_from_its_seed(cpu_place):
    nodes = np.arange(6)
    a = pex.graph_sample_neighbors(ROW, COLPTR, nodes, 2, seed=3)
    b = pex.graph_sample_neighbors(ROW, COLPTR, nodes, 2, seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    nb, cnt = a
    deg = np.diff(COLPTR)
    assert cnt.tolist() == np.minimum(deg, 2).tolist()
    off = np.concatenate([[0], np.cumsum(cnt.numpy())])
    for i in range(6):
        mine = nb.numpy()[off[i]:off[i + 1]].tolist()
        assert len(set(mine)) == len(mine)
        assert set(mine) <= set(ROW[COLPTR[i]:COLPTR[i + 1]].tolist())
    draws = {tuple(pex.graph_sample_neighbors(ROW, COLPTR, [0], 2,
                                              seed=s)[0].tolist())
             for s in range(40)}
    assert len(draws) > 1


def test_graph_khop_sampler_equals_the_reference_past_every_degree(cpu_place):
    nodes = np.asarray([0], np.int64)
    got = pex.graph_khop_sampler(ROW, COLPTR, nodes, [5, 5], seed=0)
    want = jex.graph_khop_sampler(ROW, COLPTR, nodes, [5, 5])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    a = pex.graph_khop_sampler(ROW, COLPTR, nodes, [2, 1], seed=4)
    b = pex.graph_khop_sampler(ROW, COLPTR, nodes, [2, 1], seed=4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(NotImplementedError, match="return_eids"):
        pex.graph_khop_sampler(ROW, COLPTR, nodes, [2], return_eids=True)


def test_extras_follow_their_inputs_device():
    args = (np.asarray([1]), np.asarray([2]), np.asarray([1]))
    nb = pex.graph_reindex(torch.from_numpy(args[0]), *args[1:])[0]
    assert nb.device.type == "cpu"
    # host arrays alone land on the default place: the card, which this
    # host lacks, unless set_device("cpu") names the CPU
    port_place._default_place = None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pex.graph_reindex(*args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pex.graph_sample_neighbors(ROW, COLPTR, [0], 1, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pex.graph_khop_sampler(ROW, COLPTR, [0], [1], seed=0)
    try:
        port_place.set_device("cpu")
        assert pex.graph_reindex(*args)[0].device.type == "cpu"
    finally:
        port_place._default_place = None
    out = pex.segment_sum(torch.ones(3, 2), np.asarray([0, 1, 1]))
    assert out.tolist() == [[1.0, 1.0], [2.0, 2.0]]
