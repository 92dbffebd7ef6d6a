"""Elementwise, binary and matmul ops of the port (``paddle_tpu/ops/math.py``).

Plain functions on torch tensors; a Python scalar operand keeps the
tensor operand's dtype, as JAX's weak types do. Under ``auto_cast``
each op casts its inputs by the reference's op name
(``amp/auto_cast.py``): ``matmul`` is white-listed (bf16 under AMP);
``exp``, ``log``, ``sqrt``, ``rsqrt``, ``square``, ``pow``, ``cumsum``
and the logs are black-listed (fp32); the rest follow their inputs.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod", "pow",
    "matmul", "scale", "neg", "abs", "sqrt", "rsqrt", "square", "exp",
    "expm1", "log", "log2", "log10", "log1p", "floor", "ceil", "round",
    "sign", "reciprocal", "sin", "cos", "tan", "asin", "acos", "atan",
    "sinh", "cosh", "tanh", "erf", "sigmoid", "maximum", "minimum", "clip",
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_not", "logical_xor",
    "isnan", "isinf", "isfinite", "cumsum", "cumprod", "atan2",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "allclose", "add_n", "lerp", "trunc", "frac", "stanh", "multiply_",
]


def _as_tensors(x, y):
    """Both operands as tensors: a Python scalar takes the other
    operand's device, and its dtype where the kinds agree (a float
    scalar beside an int tensor stays float32)."""
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        return x, y
    if not isinstance(x, torch.Tensor):
        return _scalar_like(x, y), y
    return x, _scalar_like(y, x)


def _scalar_like(s, ref):
    if not isinstance(ref, torch.Tensor):
        ref = torch.as_tensor(ref)
    if isinstance(s, bool):
        dt = torch.bool if ref.dtype == torch.bool else ref.dtype
    elif isinstance(s, int):
        dt = ref.dtype if ref.dtype != torch.bool else torch.int64
    elif isinstance(s, float):
        dt = ref.dtype if ref.is_floating_point() else torch.float32
    else:
        return torch.as_tensor(s, device=ref.device)
    return torch.as_tensor(s, dtype=dt, device=ref.device)


def _binop(name, fn):
    def op(x, y, name_arg=None):
        x, y = maybe_cast_inputs(name, _as_tensors(x, y))
        return fn(x, y)

    op.__name__ = name
    return op


def _unop(name, fn):
    def op(x, name_arg=None):
        (x,) = maybe_cast_inputs(name, (x,))
        return fn(x)

    op.__name__ = name
    return op


def _true_divide(x, y):
    if not x.is_floating_point() and not y.is_floating_point():
        x, y = x.float(), y.float()
    return torch.true_divide(x, y)


add = _binop("add", torch.add)
subtract = _binop("subtract", torch.subtract)
multiply = _binop("multiply", torch.multiply)
divide = _binop("divide", _true_divide)
floor_divide = _binop("floor_divide", torch.floor_divide)
mod = _binop("mod", torch.remainder)
maximum = _binop("maximum", torch.maximum)
minimum = _binop("minimum", torch.minimum)
atan2 = _binop("atan2", lambda x, y: torch.atan2(
    *(t.float() if not t.is_floating_point() else t for t in (x, y))))


def pow(x, y, name=None):  # noqa: A001
    x, y = maybe_cast_inputs("pow", (x, y))
    return torch.pow(x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = maybe_cast_inputs("matmul", (x, y))
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, name=None):
    (x,) = maybe_cast_inputs("scale", (x,))
    s = torch.as_tensor(float(scale.item() if isinstance(scale, torch.Tensor)
                              else scale), dtype=x.dtype, device=x.device)
    b = torch.as_tensor(float(bias), dtype=x.dtype, device=x.device)
    return x * s + b if bias_after_scale else (x + b) * s


def _float_fn(fn):
    """``fn`` on x, ints promoted to float32 first as JAX promotes them."""
    return lambda x: fn(x if x.is_floating_point() or x.is_complex()
                        else x.float())


neg = _unop("neg", torch.neg)
abs = _unop("abs", torch.abs)  # noqa: A001
sqrt = _unop("sqrt", _float_fn(torch.sqrt))
rsqrt = _unop("rsqrt", _float_fn(torch.rsqrt))
square = _unop("square", torch.square)
exp = _unop("exp", _float_fn(torch.exp))
expm1 = _unop("expm1", _float_fn(torch.expm1))
log = _unop("log", _float_fn(torch.log))
log2 = _unop("log2", _float_fn(torch.log2))
log10 = _unop("log10", _float_fn(torch.log10))
log1p = _unop("log1p", _float_fn(torch.log1p))
floor = _unop("floor", torch.floor)
ceil = _unop("ceil", torch.ceil)
round = _unop("round", torch.round)  # noqa: A001
sign = _unop("sign", torch.sign)
reciprocal = _unop("reciprocal", _float_fn(torch.reciprocal))
sin = _unop("sin", _float_fn(torch.sin))
cos = _unop("cos", _float_fn(torch.cos))
tan = _unop("tan", _float_fn(torch.tan))
asin = _unop("asin", _float_fn(torch.asin))
acos = _unop("acos", _float_fn(torch.acos))
atan = _unop("atan", _float_fn(torch.atan))
sinh = _unop("sinh", _float_fn(torch.sinh))
cosh = _unop("cosh", _float_fn(torch.cosh))
tanh = _unop("tanh", _float_fn(torch.tanh))
erf = _unop("erf", _float_fn(torch.erf))
sigmoid = _unop("sigmoid", _float_fn(torch.sigmoid))
trunc = _unop("trunc", torch.trunc)


def frac(x, name=None):
    (x,) = maybe_cast_inputs("frac", (x,))
    return x - torch.trunc(x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    (x,) = maybe_cast_inputs("stanh", (x,))
    return scale_b * torch.tanh(scale_a * x)


def clip(x, min=None, max=None, name=None):  # noqa: A002
    (x,) = maybe_cast_inputs("clip", (x,))
    lo = None if min is None else float(
        min.item() if isinstance(min, torch.Tensor) else min)
    hi = None if max is None else float(
        max.item() if isinstance(max, torch.Tensor) else max)
    if lo is None and hi is None:
        return x.clone()
    return torch.clamp(x, lo, hi)


equal = _binop("equal", torch.eq)
not_equal = _binop("not_equal", torch.ne)
greater_than = _binop("greater_than", torch.gt)
greater_equal = _binop("greater_equal", torch.ge)
less_than = _binop("less_than", torch.lt)
less_equal = _binop("less_equal", torch.le)
logical_and = _binop("logical_and", torch.logical_and)
logical_or = _binop("logical_or", torch.logical_or)
logical_xor = _binop("logical_xor", torch.logical_xor)
logical_not = _unop("logical_not", torch.logical_not)
bitwise_and = _binop("bitwise_and", torch.bitwise_and)
bitwise_or = _binop("bitwise_or", torch.bitwise_or)
bitwise_xor = _binop("bitwise_xor", torch.bitwise_xor)
bitwise_not = _unop("bitwise_not", torch.bitwise_not)
isnan = _unop("isnan", torch.isnan)
isinf = _unop("isinf", torch.isinf)
isfinite = _unop("isfinite", torch.isfinite)


def cumsum(x, axis=None, dtype=None, name=None):
    """Over ``axis``, or over the flattened input when None; ``dtype`` is
    accepted and, as in the reference, not acted on."""
    (x,) = maybe_cast_inputs("cumsum", (x,))
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0)
    return torch.cumsum(x, axis)


def cumprod(x, dim=None, dtype=None, name=None):
    (x,) = maybe_cast_inputs("cumprod", (x,))
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0)
    return torch.cumprod(x, dim)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _as_tensors(x, y)
    return torch.tensor(torch.allclose(x, y.to(x.dtype), rtol=rtol,
                                       atol=atol, equal_nan=equal_nan))


def add_n(inputs, name=None):
    vals = maybe_cast_inputs("add_n", list(inputs))
    out = vals[0]
    for v in vals[1:]:
        out = out + v
    return out


def lerp(x, y, weight, name=None):
    x, y, weight = maybe_cast_inputs("lerp", (x, y, weight))
    return x + weight * (y - x)


def multiply_(x, y):
    """In-place multiply: ``x`` holds the product and is returned."""
    with torch.no_grad():
        return x.mul_(y)
