"""The port's tensor-parallel layers in their explicit mode, over a gang
of four gloo ranks on the CPU (one mesh axis ``mp`` of 4), against the
JAX package: forward values against the reference's explicit
``shard_map`` forms at the same inputs (``tests/test_distributed.py:
144-265``), gradients against ``jax.grad`` of the dense computation
(each rank's gradient of its own shard, and the input's gradient whole
on every rank). Also the vocab-parallel fused head and cross entropy
(``models/gpt.py`` under tensor parallelism) against the JAX
``linear_cross_entropy``, ``mp_identity``/``mp_allreduce``'s forward
and backward, ``DataParallel``'s averaged gradients, LocalSGD's
parameter averaging and the ``GradScaler``'s world-wide skip.

Tolerances: fp32 sums in another order, atol 1e-5 on unit-scale
values. One four-rank gang runs every case (a module-scoped fixture,
``test_torch_collective.run_gang``).
"""

import numpy as np
import pytest
import torch

from test_torch_collective import WORLD, once_per_session, run_gang

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

ATOL = 1e-5
_RS = np.random.RandomState(7)
X = _RS.randn(4, 8).astype(np.float32)
W1 = (_RS.randn(8, 16) * 0.5).astype(np.float32)
B1 = _RS.randn(16).astype(np.float32)
G1 = _RS.randn(4, 16).astype(np.float32)
W2 = (_RS.randn(16, 8) * 0.5).astype(np.float32)
B2 = _RS.randn(8).astype(np.float32)
G2 = _RS.randn(4, 8).astype(np.float32)
EMB = _RS.randn(16, 4).astype(np.float32)
IDS = np.array([[0, 5, 15], [8, 7, 3]], np.int64)
GE = _RS.randn(2, 3, 4).astype(np.float32)
LOGITS = (_RS.randn(4, 16) * 2).astype(np.float32)
LABELS = np.array([1, 7, -100, 15], np.int64)
GL = _RS.randn(4).astype(np.float32)
H = _RS.randn(2, 5, 8).astype(np.float32)
WTE = (_RS.randn(16, 8) * 0.5).astype(np.float32)
HEAD_LABELS = np.array([[3, 15, 0, -100, 9], [12, 4, 4, 7, 11]], np.int64)


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _shard(a, spec, mesh):
    win = mesh.window(spec, a.shape)
    return a[tuple(slice(x, y) for x, y in win)]


def _layers(rank, out):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding, mp_layers)
    from paddle_tpu_torch.nn.functional import loss as port_loss

    mesh = dist.build_mesh([1, 1, 1, WORLD], ["dp", "pp", "sharding", "mp"])
    res = {}

    def load(layer, **arrays):
        with torch.no_grad():
            for name, a in arrays.items():
                p = getattr(layer, name)
                spec = getattr(p, "dist_spec", ())
                p.data = torch.tensor(_shard(a, spec, mesh))

    with env._mesh_scope(mesh):
        col = ColumnParallelLinear(8, 16, gather_output=True, device="cpu")
        load(col, weight=W1, bias=B1)
        x = _t(X, True)
        y = col(x)
        (y * _t(G1)).sum().backward()
        res.update(col_out=y, col_dx=x.grad, col_dw=col.weight.grad,
                   col_db=col.bias.grad)

        c2 = ColumnParallelLinear(8, 16, gather_output=False, device="cpu")
        r2 = RowParallelLinear(16, 8, input_is_parallel=True, device="cpu")
        load(c2, weight=W1, bias=B1)
        load(r2, weight=W2, bias=B2)
        x = _t(X, True)
        y = r2(c2(x))
        (y * _t(G2)).sum().backward()
        res.update(pair_out=y, pair_dx=x.grad, pair_dw1=c2.weight.grad,
                   pair_dw2=r2.weight.grad, pair_db2=r2.bias.grad)

        r3 = RowParallelLinear(16, 8, input_is_parallel=False, device="cpu")
        load(r3, weight=W2, bias=B2)
        h = _t(np.tanh(X @ W1), True)
        y = r3(h)
        (y * _t(G2)).sum().backward()
        res.update(row_out=y, row_dx=h.grad, row_dw=r3.weight.grad)

        emb = VocabParallelEmbedding(16, 4, device="cpu")
        load(emb, weight=EMB)
        y = emb(torch.tensor(IDS))
        (y * _t(GE)).sum().backward()
        res.update(emb_out=y, emb_dw=emb.weight.grad)

        lg = _t(_shard(LOGITS, (None, "mp"), mesh), True)
        loss = ParallelCrossEntropy()(lg, torch.tensor(LABELS))
        (loss[:, 0] * _t(GL)).sum().backward()
        res.update(pce_out=loss, pce_dlogits=lg.grad)

        h = _t(H, True)
        w = _t(_shard(WTE, ("mp", None), mesh), True)
        loss = port_loss._linear_cross_entropy(
            h, w, torch.tensor(HEAD_LABELS), reduction="mean",
            vocab_chunk=2, w_vocab_major=True, axis="mp")
        loss.backward()
        res.update(head_loss=loss, head_dh=h.grad, head_dw=w.grad)

        v = _t(np.full(3, rank + 1.0, np.float32), True)
        a = mp_layers.mp_allreduce(v)
        (a * (rank + 1)).sum().backward()
        res.update(ar_out=a, ar_grad=v.grad)
        v = _t(np.full(3, rank + 1.0, np.float32), True)
        (mp_layers.mp_identity(v) * (rank + 1)).sum().backward()
        res.update(id_grad=v.grad)

    # DataParallel over the world: each rank's own batch row, gradients
    # averaged in the backward
    lin = dist.DataParallel(torch.nn.Linear(8, 1, bias=False))
    with torch.no_grad():
        lin._layers.weight.copy_(torch.full((1, 8), float(rank)))
    lin(_t(X[rank:rank + 1])).sum().backward()
    res.update(ddp_grad=lin._layers.weight.grad)

    # LocalSGD averages the parameters over the (data-parallel) world
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        LocalSGDOptimizer
    from paddle_tpu_torch.optimizer import SGD

    w = torch.nn.Parameter(torch.full((3,), float(rank)))
    LocalSGDOptimizer(SGD(parameters=[w]), k_steps=1).sync_params()
    res.update(localsgd=w.detach())

    # GradScaler: one rank's inf gradient makes every rank skip
    from paddle_tpu_torch.amp import GradScaler

    w = torch.nn.Parameter(torch.ones(2))
    opt = SGD(learning_rate=1.0, parameters=[w])
    w.grad = torch.tensor([float("inf") if rank == 2 else 1.0, 1.0])
    scaler = GradScaler(init_loss_scaling=1.0)
    scaler.step(opt)
    scaler.update()
    res.update(scaler_w=w.detach(), scaler_skips=torch.tensor(
        scaler.num_skipped_steps))
    np.savez(f"{out}/mp{rank}.npz",
             **{k: v.detach().numpy() for k, v in res.items()})


def _build_gang(tmp):
    run_gang(_layers, WORLD, tmp, str(tmp))
    return [dict(np.load(tmp / f"mp{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return once_per_session(tmp_path_factory, "mp_layers_gang", _build_gang)


def _cat(gang, key, dim):
    return np.concatenate([g[key] for g in gang], axis=dim)


def _jax_mesh():
    import jax

    from paddle_tpu.distributed import build_mesh

    return build_mesh([WORLD], ["mp"], devices=jax.devices()[:WORLD])


def test_column_parallel_linear_matches_jax(gang):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def body(xv, wv, bv):
        out = jnp.matmul(xv, wv) + bv
        return jax.lax.all_gather(out, "mp", axis=out.ndim - 1, tiled=True)

    want = shard_map(body, mesh=_jax_mesh(),
                     in_specs=(P(), P(None, "mp"), P("mp")), out_specs=P(),
                     check_vma=False)(X, W1, B1)

    def dense(x, w, b):
        return jnp.sum((x @ w + b) * G1)

    dx, dw, db = jax.grad(dense, argnums=(0, 1, 2))(X, W1, B1)
    for g in gang:
        np.testing.assert_allclose(g["col_out"], want, atol=ATOL)
        np.testing.assert_allclose(g["col_dx"], dx, atol=ATOL)
    np.testing.assert_allclose(_cat(gang, "col_dw", 1), dw, atol=ATOL)
    np.testing.assert_allclose(_cat(gang, "col_db", 0), db, atol=ATOL)


def test_column_row_pair_matches_jax(gang):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def body(xv, wc, bc, wr, br):
        return jax.lax.psum(jnp.matmul(jnp.matmul(xv, wc) + bc, wr),
                            "mp") + br

    want = shard_map(
        body, mesh=_jax_mesh(),
        in_specs=(P(), P(None, "mp"), P("mp"), P("mp", None), P()),
        out_specs=P(), check_vma=False)(X, W1, B1, W2, B2)

    def dense(x, w1, w2, b2):
        return jnp.sum(((x @ w1 + B1) @ w2 + b2) * G2)

    dx, dw1, dw2, db2 = jax.grad(dense, argnums=(0, 1, 2, 3))(X, W1, W2, B2)
    for g in gang:
        np.testing.assert_allclose(g["pair_out"], want, atol=ATOL)
        np.testing.assert_allclose(g["pair_dx"], dx, atol=ATOL)
        np.testing.assert_allclose(g["pair_db2"], db2, atol=ATOL)
    np.testing.assert_allclose(_cat(gang, "pair_dw1", 1), dw1, atol=ATOL)
    np.testing.assert_allclose(_cat(gang, "pair_dw2", 0), dw2, atol=ATOL)


def test_row_parallel_linear_splits_a_whole_input(gang):
    import jax
    import jax.numpy as jnp

    h = np.tanh(X @ W1)

    def dense(hv, w):
        return jnp.sum((hv @ w + B2) * G2)

    dh, dw = jax.grad(dense, argnums=(0, 1))(h, W2)
    for g in gang:
        np.testing.assert_allclose(g["row_out"], h @ W2 + B2, atol=ATOL)
        np.testing.assert_allclose(g["row_dx"], dh, atol=ATOL)
    np.testing.assert_allclose(_cat(gang, "row_dw", 0), dw, atol=ATOL)


def test_vocab_parallel_embedding_matches_jax(gang):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def body(idv, wv):
        i = jax.lax.axis_index("mp")
        per = wv.shape[0]
        local = idv - i * per
        ok = (local >= 0) & (local < per)
        out = jnp.where(ok[..., None],
                        jnp.take(wv, jnp.where(ok, local, 0), axis=0), 0.0)
        return jax.lax.psum(out, "mp")

    want = shard_map(body, mesh=_jax_mesh(), in_specs=(P(), P("mp", None)),
                     out_specs=P(), check_vma=False)(IDS, EMB)
    dw = jax.grad(lambda w: jnp.sum(jnp.take(w, IDS, axis=0) * GE))(EMB)
    for g in gang:
        np.testing.assert_allclose(g["emb_out"], want, atol=ATOL)
    np.testing.assert_allclose(_cat(gang, "emb_dw", 0), dw, atol=ATOL)


def test_parallel_cross_entropy_matches_jax(gang):
    import jax
    import jax.numpy as jnp

    import paddle_tpu as jpaddle
    from paddle_tpu.distributed.meta_parallel import ParallelCrossEntropy

    want = np.asarray(ParallelCrossEntropy()(
        jpaddle.to_tensor(LOGITS), jpaddle.to_tensor(LABELS)).value)

    def dense(lg):
        logp = jax.nn.log_softmax(lg, axis=-1)
        lbl = jnp.asarray(LABELS)
        picked = jnp.take_along_axis(logp, jnp.maximum(lbl, 0)[:, None],
                                     axis=-1)[:, 0]
        return jnp.sum(jnp.where(lbl != -100, -picked, 0.0) * GL)

    dl = jax.grad(dense)(LOGITS)
    for g in gang:
        np.testing.assert_allclose(g["pce_out"], want, atol=ATOL)
    np.testing.assert_allclose(_cat(gang, "pce_dlogits", 1), dl, atol=ATOL)


def test_vocab_parallel_fused_head_matches_jax(gang):
    """The vocab-parallel online logsumexp over four shards of wte (two
    rows a chunk) against the JAX fused head on the whole table, with
    an ignored label."""
    import importlib

    import jax

    jloss = importlib.import_module("paddle_tpu.nn.functional.loss")

    def f(h, w):
        return jloss.linear_cross_entropy(h, w, HEAD_LABELS,
                                          reduction="mean", vocab_chunk=2,
                                          w_vocab_major=True)

    want = f(H, WTE)
    dh, dw = jax.grad(f, argnums=(0, 1))(H, WTE)
    for g in gang:
        np.testing.assert_allclose(g["head_loss"], want, atol=ATOL)
        np.testing.assert_allclose(g["head_dh"], dh, atol=ATOL)
    np.testing.assert_allclose(_cat(gang, "head_dw", 0), dw, atol=ATOL)


def test_mp_allreduce_and_mp_identity_are_conjugate(gang):
    """``mp_allreduce``: sum forward, identity backward; ``mp_identity``:
    identity forward, sum of the gradients backward."""
    for r, g in enumerate(gang):
        np.testing.assert_array_equal(g["ar_out"], [10.0] * 3)
        np.testing.assert_array_equal(g["ar_grad"], [float(r + 1)] * 3)
        np.testing.assert_array_equal(g["id_grad"], [10.0] * 3)


def test_localsgd_and_scaler_act_on_the_whole_world(gang):
    """LocalSGD's ``sync_params`` averages over the ranks (0..3 -> 1.5);
    the scaler's non-finite flag is max-reduced over the world, so the
    rank with finite gradients skips the step too."""
    for g in gang:
        np.testing.assert_array_equal(g["localsgd"], [1.5] * 3)
        np.testing.assert_array_equal(g["scaler_w"], [1.0, 1.0])
        assert int(g["scaler_skips"]) == 1


def test_data_parallel_averages_gradients(gang):
    """DataParallel broadcasts rank 0's weights, then averages each
    rank's gradient of its own row: the mean row of X."""
    for g in gang:
        np.testing.assert_allclose(g["ddp_grad"], X.mean(0, keepdims=True),
                                   atol=ATOL)
