"""The port's op library core (``paddle_tpu_torch.ops``: creation, math,
reduction, manipulation) against the JAX package's ops.

Every ported op runs on the same seeded numpy inputs in both packages
(JAX on ``Tensor`` inputs, the port on torch tensors) and the outputs
are held to each other: exact for integer, boolean and index results,
within 1e-6 (absolute and relative) for float ones, whose only
difference is the order of float operations. Integer widths differ
(JAX runs without 64-bit types), so dtypes are held by kind (float,
int, bool). The random creation ops draw from different generators, so
they are held by shape, kind and range. Under ``auto_cast`` each op
casts its inputs by the reference's op name: the output dtypes equal
the reference's.
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.amp import auto_cast as jax_auto_cast
from paddle_tpu.core.tensor import Tensor

from paddle_tpu_torch import ops
from paddle_tpu_torch.amp import auto_cast

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

JOPS = {m: importlib.import_module(f"paddle_tpu.ops.{m}")
        for m in ("creation", "math", "reduction", "manipulation")}

RS = np.random.RandomState(0)
X = RS.randn(3, 4, 5).astype(np.float32)
Y = RS.randn(3, 4, 5).astype(np.float32)
M = RS.randn(4, 4).astype(np.float32)
V = RS.randn(6).astype(np.float32)
P = (np.abs(X) + 0.1).astype(np.float32)            # positive
U = RS.uniform(-0.9, 0.9, (3, 4)).astype(np.float32)  # inside (-1, 1)
I = RS.randint(1, 9, (3, 4)).astype(np.int32)
J = RS.randint(1, 5, (3, 4)).astype(np.int32)
B = RS.rand(3, 4) > 0.5
C = RS.rand(3, 4) > 0.5
S = np.asarray([1.0, np.nan, np.inf, -np.inf, 0.0], np.float32)
TIES = np.asarray([[3, 1, 3, 2, 1], [0, 0, 5, 5, 0]], np.float32)
IDX = np.asarray([2, 0, 3, 3], np.int32)
IDX2 = np.asarray([[0, 1], [3, 2], [1, 1]], np.int32)
ROWS = np.asarray([[1, 0], [2, 3], [0, 0]], np.int32)


class _A:
    """An array argument: a ``Tensor`` for JAX, a torch tensor for the
    port."""

    def __init__(self, a):
        self.a = np.asarray(a)


def _jax(v):
    if isinstance(v, _A):
        return Tensor(jnp.asarray(v.a))
    if isinstance(v, list):
        return [_jax(x) for x in v]
    return v


def _port(v):
    if isinstance(v, _A):
        return torch.from_numpy(v.a.copy())
    if isinstance(v, list):
        return [_port(x) for x in v]
    return v


def _on_cpu(fn, kwargs):
    """``kwargs`` with the port's CPU opt-in: creation ops that make a
    tensor from nothing default to the card."""
    params = inspect.signature(fn).parameters
    for opt in ("device", "place"):
        if opt in params:
            return {**kwargs, opt: "cpu"}
    return kwargs


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    if isinstance(v, Tensor):
        return np.asarray(v.numpy())
    return np.asarray(v)


def _kind(a):
    return {"f": "f", "c": "c", "b": "b", "i": "i", "u": "i"}[a.dtype.kind]


x, y, m, v, p, u = _A(X), _A(Y), _A(M), _A(V), _A(P), _A(U)
i, j, b, c, s = _A(I), _A(J), _A(B), _A(C), _A(S)

# id -> (module, op, args, kwargs)
CASES = {
    # creation
    "zeros": ("creation", "zeros", ([2, 3],), {}),
    "ones-int32": ("creation", "ones", ([2, 3], "int32"), {}),
    "full": ("creation", "full", ([2, 2], 1.5), {}),
    "empty": ("creation", "empty", ([2],), {}),
    "zeros_like": ("creation", "zeros_like", (x,), {}),
    "ones_like-int32": ("creation", "ones_like", (x, "int32"), {}),
    "full_like": ("creation", "full_like", (x, 2.5), {}),
    "empty_like": ("creation", "empty_like", (i,), {}),
    "arange": ("creation", "arange", (5,), {}),
    "arange-step": ("creation", "arange", (1, 7, 2), {}),
    "arange-float": ("creation", "arange", (0.0, 1.0, 0.25), {}),
    "arange-int32": ("creation", "arange", (0, 6), {"dtype": "int32"}),
    "linspace": ("creation", "linspace", (0.0, 1.0, 5), {}),
    "eye": ("creation", "eye", (3,), {}),
    "eye-rect": ("creation", "eye", (2, 4), {}),
    "assign": ("creation", "assign", (x,), {}),
    "clone": ("creation", "clone", (x,), {}),
    "tril": ("creation", "tril", (m,), {}),
    "triu": ("creation", "triu", (m, 1), {}),
    "diag-vec": ("creation", "diag", (v,), {}),
    "diag-mat": ("creation", "diag", (m, 1), {}),
    "meshgrid": ("creation", "meshgrid", (v, _A(V[:3])), {}),
    "to_tensor": ("creation", "to_tensor", ([[1.0, 2.0], [3.0, 4.5]],), {}),
    # math: binary
    "add": ("math", "add", (x, y), {}),
    "add-scalar": ("math", "add", (x, 1.5), {}),
    "subtract": ("math", "subtract", (x, y), {}),
    "multiply": ("math", "multiply", (x, y), {}),
    "multiply-int": ("math", "multiply", (i, j), {}),
    "divide": ("math", "divide", (x, p), {}),
    "divide-int": ("math", "divide", (i, j), {}),
    "floor_divide": ("math", "floor_divide", (i, j), {}),
    "mod": ("math", "mod", (i, j), {}),
    "mod-float": ("math", "mod", (x, 0.7), {}),
    "maximum": ("math", "maximum", (x, y), {}),
    "minimum": ("math", "minimum", (x, y), {}),
    "atan2": ("math", "atan2", (x, y), {}),
    "pow": ("math", "pow", (p, 2.5), {}),
    "matmul": ("math", "matmul", (_A(X[0]), _A(Y[0].T)), {}),
    "matmul-batched": ("math", "matmul", (x, _A(Y.transpose(0, 2, 1))), {}),
    "matmul-transpose": ("math", "matmul", (x, y),
                         {"transpose_y": True}),
    "matmul-transpose-x": ("math", "matmul", (m, m),
                           {"transpose_x": True}),
    "scale": ("math", "scale", (x, 2.0, 1.0), {}),
    "scale-before": ("math", "scale", (x, 2.0, 1.0, False), {}),
    "equal": ("math", "equal", (i, j), {}),
    "not_equal": ("math", "not_equal", (i, j), {}),
    "greater_than": ("math", "greater_than", (x, y), {}),
    "greater_equal": ("math", "greater_equal", (i, j), {}),
    "less_than": ("math", "less_than", (x, 0.0), {}),
    "less_equal": ("math", "less_equal", (i, j), {}),
    "logical_and": ("math", "logical_and", (b, c), {}),
    "logical_or": ("math", "logical_or", (b, c), {}),
    "logical_xor": ("math", "logical_xor", (b, c), {}),
    "logical_not": ("math", "logical_not", (b,), {}),
    "bitwise_and": ("math", "bitwise_and", (i, j), {}),
    "bitwise_or": ("math", "bitwise_or", (i, j), {}),
    "bitwise_xor": ("math", "bitwise_xor", (i, j), {}),
    "bitwise_not": ("math", "bitwise_not", (i,), {}),
    "clip": ("math", "clip", (x, -0.5, 0.5), {}),
    "clip-max": ("math", "clip", (x,), {"max": 0.2}),
    "cumsum": ("math", "cumsum", (x, 1), {}),
    "cumsum-flat": ("math", "cumsum", (x,), {}),
    "cumprod": ("math", "cumprod", (u,), {"dim": 0}),
    "allclose": ("math", "allclose", (x, x), {}),
    "allclose-not": ("math", "allclose", (x, y), {}),
    "add_n": ("math", "add_n", ([x, y, x],), {}),
    "lerp": ("math", "lerp", (x, y, 0.3), {}),
    "stanh": ("math", "stanh", (x,), {}),
    "frac": ("math", "frac", (_A(X * 3),), {}),
    "isnan": ("math", "isnan", (s,), {}),
    "isinf": ("math", "isinf", (s,), {}),
    "isfinite": ("math", "isfinite", (s,), {}),
    # reduction
    "sum": ("reduction", "sum", (x,), {}),
    "sum-axis": ("reduction", "sum", (x, 1, True), {}),
    "sum-int": ("reduction", "sum", (i, 0), {}),
    "mean": ("reduction", "mean", (x, [0, 2]), {}),
    "mean-int": ("reduction", "mean", (i,), {}),
    "max": ("reduction", "max", (x, -1), {}),
    "min": ("reduction", "min", (x,), {}),
    "prod": ("reduction", "prod", (u, [0, 1]), {}),
    "amax": ("reduction", "amax", (x, 0, True), {}),
    "amin": ("reduction", "amin", (x, [1, 2]), {}),
    "all": ("reduction", "all", (b, 0), {}),
    "any": ("reduction", "any", (b,), {}),
    "any-keep": ("reduction", "any", (b, 1, True), {}),
    "argmax": ("reduction", "argmax", (x,), {}),
    "argmax-axis": ("reduction", "argmax", (x, 1), {}),
    "argmin-keep": ("reduction", "argmin", (x, 0, True), {}),
    "logsumexp": ("reduction", "logsumexp", (x, 1), {}),
    "std": ("reduction", "std", (x,), {}),
    "var-biased": ("reduction", "var", (x, 1, False), {}),
    "median-odd": ("reduction", "median", (x, 2), {}),
    "median-even": ("reduction", "median", (x, 1, True), {}),
    "median-all": ("reduction", "median", (x,), {}),
    "count_nonzero": ("reduction", "count_nonzero", (_A(I % 3), 1), {}),
    "sum-dtype": ("reduction", "sum", (b,), {"dtype": "int32"}),
    # manipulation
    "cast": ("manipulation", "cast", (x, "int32"), {}),
    "cast-bool": ("manipulation", "cast", (i, "float32"), {}),
    "reshape": ("manipulation", "reshape", (x, [4, -1]), {}),
    "transpose": ("manipulation", "transpose", (x, [1, 0, 2]), {}),
    "transpose-none": ("manipulation", "transpose", (x,), {}),
    "moveaxis": ("manipulation", "moveaxis", (x, 0, 2), {}),
    "concat": ("manipulation", "concat", ([x, y], 1), {}),
    "stack": ("manipulation", "stack", ([x, y], 2), {}),
    "unstack": ("manipulation", "unstack", (x, 1), {}),
    "split": ("manipulation", "split", (x, 2, 1), {}),
    "split-remainder": ("manipulation", "split", (x, 2, 2), {}),
    "split-sizes": ("manipulation", "split", (x, [1, -1, 2], 2), {}),
    "chunk": ("manipulation", "chunk", (x, 3), {}),
    "unbind": ("manipulation", "unbind", (x, 2), {}),
    "squeeze": ("manipulation", "squeeze", (_A(X[:1, :, :1]), [0, 1, 2]),
                {}),
    "squeeze-all": ("manipulation", "squeeze", (_A(X[:1, :, :1]),), {}),
    "unsqueeze": ("manipulation", "unsqueeze", (x, [0, 4]), {}),
    "unsqueeze-neg": ("manipulation", "unsqueeze", (x, -1), {}),
    "flatten": ("manipulation", "flatten", (x, 1, 2), {}),
    "flatten-all": ("manipulation", "flatten", (x,), {}),
    "gather": ("manipulation", "gather", (x, _A(IDX[:2]), 2), {}),
    "gather-2d-index": ("manipulation", "gather", (m, _A(ROWS)), {}),
    "gather_nd": ("manipulation", "gather_nd", (m, _A(IDX2)), {}),
    "scatter": ("manipulation", "scatter", (
        m, _A(np.asarray([3, 1], np.int32)), _A(Y[0, :2, :4])), {}),
    "scatter-accumulate": ("manipulation", "scatter", (
        m, _A(IDX), _A(Y[:, :4].reshape(-1, 4)[:4])), {"overwrite": False}),
    "scatter_nd_add": ("manipulation", "scatter_nd_add", (
        m, _A(IDX2), _A(V[:3])), {}),
    "index_select": ("manipulation", "index_select", (m, _A(IDX), 1), {}),
    "index_sample": ("manipulation", "index_sample", (
        _A(X[0, :3]), _A(ROWS)), {}),
    "take_along_axis": ("manipulation", "take_along_axis", (
        _A(X[0, :3]), _A(ROWS), 1), {}),
    "put_along_axis": ("manipulation", "put_along_axis", (
        _A(X[0, :3]), _A(ROWS[:, :1]), 9.0, 1), {}),
    "put_along_axis-add": ("manipulation", "put_along_axis", (
        _A(X[0, :3]), _A(ROWS[:, :1]), _A(V[:3, None]), 1, "add"), {}),
    "put_along_axis-multiply": ("manipulation", "put_along_axis", (
        _A(X[0, :3]), _A(ROWS[:, :1]), 3.0, 1, "multiply"), {}),
    "tile": ("manipulation", "tile", (m, [2, 1]), {}),
    "expand": ("manipulation", "expand", (v, [3, -1]), {}),
    "expand_as": ("manipulation", "expand_as", (v, _A(np.zeros((2, 6)))),
                  {}),
    "broadcast_to": ("manipulation", "broadcast_to", (v, [2, 6]), {}),
    "flip": ("manipulation", "flip", (x, [0, 2]), {}),
    "flip-int": ("manipulation", "flip", (x, 1), {}),
    "roll": ("manipulation", "roll", (x, 2), {}),
    "roll-axis": ("manipulation", "roll", (x, -1, 1), {}),
    "pad-all": ("manipulation", "pad", (m, [1, 0, 2, 1]), {"value": 3.0}),
    "pad-last": ("manipulation", "pad", (x, [1, 2]), {}),
    "pad-reflect": ("manipulation", "pad", (x, [2, 1]), {"mode": "reflect"}),
    "pad-replicate": ("manipulation", "pad", (x, [1, 1, 2, 0]),
                      {"mode": "replicate"}),
    "pad-circular": ("manipulation", "pad", (x, [0, 3]),
                     {"mode": "circular"}),
    "where": ("manipulation", "where", (_A(X > 0), x, y), {}),
    "where-nonzero": ("manipulation", "where", (b,), {}),
    "one_hot": ("manipulation", "one_hot", (_A(IDX), 5), {}),
    "topk": ("manipulation", "topk", (x, 2), {}),
    "topk-smallest": ("manipulation", "topk", (x, 2, 0, False), {}),
    "sort": ("manipulation", "sort", (x,), {}),
    "sort-desc": ("manipulation", "sort", (x, 1, True), {}),
    "argsort-ties": ("manipulation", "argsort", (_A(TIES),), {}),
    "argsort-ties-desc": ("manipulation", "argsort", (_A(TIES), -1, True),
                          {}),
    "unique": ("manipulation", "unique", (i,), {}),
    "unique-all": ("manipulation", "unique", (i, True, True, True), {}),
    "nonzero": ("manipulation", "nonzero", (b,), {}),
    "nonzero-tuple": ("manipulation", "nonzero", (b, True), {}),
    "masked_select": ("manipulation", "masked_select", (_A(X[0, :3, :4]), b),
                      {}),
    "slice": ("manipulation", "slice", (x, [0, 2], [1, -3], [3, 10]), {}),
    "strided_slice": ("manipulation", "strided_slice", (
        x, [1, 2], [0, 4], [4, 0], [2, -2]), {}),
    "getitem": ("manipulation", "getitem", (
        x, (slice(None), 0)), {}),
    "getitem-mixed": ("manipulation", "getitem", (
        x, (Ellipsis, None, slice(1, None, 2))), {}),
    "getitem-list": ("manipulation", "getitem", (x, [2, 0]), {}),
    "getitem-int": ("manipulation", "getitem", (x, (1, -1)), {}),
    "numel": ("manipulation", "numel", (x,), {}),
    "shard_index": ("manipulation", "shard_index", (
        _A(np.arange(12, dtype=np.int32).reshape(3, 4)), 12, 3, 1), {}),
    "repeat_interleave": ("manipulation", "repeat_interleave", (m, 2), {}),
    "repeat_interleave-axis": ("manipulation", "repeat_interleave",
                               (m, 2, 1), {}),
    "as_complex": ("manipulation", "as_complex", (_A(X[..., :2]),), {}),
    "as_real": ("manipulation", "as_real", (
        _A((X[0] + 1j * Y[0]).astype(np.complex64)),), {}),
    "crop": ("manipulation", "crop", (x, [2, 2, 3], [1, 0, 2]), {}),
    "crop-no-offsets": ("manipulation", "crop", (x, [1, 3, 2]), {}),
}
# unary math ops, on inputs inside each one's domain
for _name, _arg in [("neg", x), ("abs", x), ("sqrt", p), ("rsqrt", p),
                    ("square", x), ("exp", x), ("expm1", x), ("log", p),
                    ("log2", p), ("log10", p), ("log1p", p), ("floor", x),
                    ("ceil", x), ("round", _A(X * 3)), ("sign", x),
                    ("reciprocal", p), ("sin", x), ("cos", x), ("tan", u),
                    ("asin", u), ("acos", u), ("atan", x), ("sinh", x),
                    ("cosh", x), ("tanh", x), ("erf", x), ("sigmoid", x),
                    ("trunc", _A(X * 3))]:
    CASES[_name] = ("math", _name, (_arg,), {})


def _outputs(out):
    if isinstance(out, (list, tuple)):
        return [_np(o) for o in out]
    return [_np(out)]


@pytest.mark.parametrize("case", list(CASES))
def test_op_matches_jax(case):
    module, name, args, kwargs = CASES[case]
    want = _outputs(getattr(JOPS[module], name)(
        *[_jax(a) for a in args], **{k: _jax(v) for k, v in kwargs.items()}))
    fn = getattr(ops, name)
    got = _outputs(fn(*[_port(a) for a in args], **_on_cpu(
        fn, {k: _port(v) for k, v in kwargs.items()})))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        assert _kind(g) == _kind(w), (g.dtype, w.dtype)
        if _kind(w) in "fc":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


# id -> (op, args, kwargs, (low, high) the draws lie in, or None)
RANDOM = {
    "rand": ("rand", ([40, 50],), {}, (0.0, 1.0)),
    "randn": ("randn", ([40, 50],), {}, None),
    "uniform": ("uniform", ([40, 50],), {"min": -2.0, "max": 3.0},
                (-2.0, 3.0)),
    "uniform-seeded": ("uniform", ([40, 50], "float32", -1.0, 1.0, 7), {},
                       (-1.0, 1.0)),
    "normal": ("normal", (1.0, 2.0, [40, 50]), {}, None),
    "randint": ("randint", (3, 9, [40, 50]), {}, (3, 8)),
    "randperm": ("randperm", (30,), {}, (0, 29)),
}


@pytest.mark.parametrize("case", list(RANDOM))
def test_random_op_shape_kind_and_range_match_jax(case):
    name, args, kwargs, bounds = RANDOM[case]
    want = _np(getattr(JOPS["creation"], name)(*args, **kwargs))
    fn = getattr(ops, name)
    got = _np(fn(*args, **_on_cpu(fn, kwargs)))
    assert got.shape == want.shape and _kind(got) == _kind(want)
    if bounds is not None:
        for a in (got, want):
            assert bounds[0] <= a.min() and a.max() <= bounds[1]
    if name == "randperm":
        np.testing.assert_array_equal(np.sort(got), np.arange(30))
    if name == "uniform" and len(args) > 4:     # a nonzero seed repeats
        np.testing.assert_array_equal(
            got, _np(fn(*args, **_on_cpu(fn, kwargs))))


# op -> (module, args): each cast by its reference op name under AMP
AMP_OPS = {
    "matmul": ("math", (_A(X[0]), _A(Y[0].T))),      # white: bf16
    "sum": ("reduction", (x,)),                      # reduce_sum: fp32
    "mean": ("reduction", (x,)),                     # reduce_mean: gray
    "exp": ("math", (x,)),                           # black: fp32
    "log": ("math", (p,)),
    "sqrt": ("math", (p,)),
    "pow": ("math", (p, 2.0)),
    "cumsum": ("math", (x, 1)),
    "logsumexp": ("reduction", (x, 1)),
    "add": ("math", (x, y)),                         # gray
    "tanh": ("math", (x,)),
    "concat": ("manipulation", ([x, y],)),
    "transpose": ("manipulation", (x, [1, 0, 2])),
}


@pytest.mark.parametrize("name", list(AMP_OPS))
def test_op_casts_under_amp_as_the_reference(name):
    """bf16 and fp32 inputs mixed as a model mixes them: the output's
    dtype is the reference's."""
    module, args = AMP_OPS[name]

    def bf16(a):
        if isinstance(a, list):
            return [bf16(t) for t in a]
        return a.to(torch.bfloat16) if isinstance(a, torch.Tensor) else a

    half = [bf16(_port(a)) for a in args[:1]] + [_port(a) for a in args[1:]]
    with auto_cast(dtype="bfloat16"):
        got = getattr(ops, name)(*half).dtype
    jhalf = [Tensor(jnp.asarray(a.a, jnp.bfloat16)) if isinstance(a, _A)
             else [Tensor(jnp.asarray(t.a, jnp.bfloat16)) for t in a]
             if isinstance(a, list) else a for a in args[:1]]
    with jax_auto_cast(dtype="bfloat16"):
        want = getattr(JOPS[module], name)(
            *jhalf, *[_jax(a) for a in args[1:]]).dtype
    assert str(got).split(".")[1] == str(want)
