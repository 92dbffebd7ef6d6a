"""Autocast context — the port of ``paddle_tpu/amp/auto_cast.py``.

Paddle's AMP decides per OP NAME, in the dispatcher: white-list ops run
with their float inputs cast to the amp dtype, black-list ops force
float32, gray ops (on neither list) follow their inputs. The port keeps
its own copy of both lists and of that decision
(:func:`maybe_cast_inputs`), and its functionals consult it under the
op names the JAX dispatcher uses (``linear``, ``matmul``,
``column_parallel_linear``, ``row_parallel_linear``,
``scaled_dot_product_attention``, ``layer_norm``, ...).

``torch.autocast`` is deliberately not used: its op lists differ from
paddle's (it runs ``layer_norm`` in the input dtype, for one).
"""

from __future__ import annotations

import threading
from typing import Sequence, Set

import torch

__all__ = ["auto_cast", "amp_guard", "white_list", "black_list",
           "amp_state", "maybe_cast_inputs", "WHITE_LIST", "BLACK_LIST"]

# ops that are numerically safe and tensor-core profitable in low
# precision (auto_cast.py:22-29)
WHITE_LIST: Set[str] = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "bmm", "mv", "einsum",
    "scaled_dot_product_attention", "addmm",
    "column_parallel_linear", "row_parallel_linear",
}

# ops that must stay in float32 (auto_cast.py:35-47). cross_entropy and
# linear_cross_entropy are on neither list: they accumulate their
# logsumexp in fp32 themselves, so under O1 they follow their inputs.
BLACK_LIST: Set[str] = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "nll_loss",
    "kl_div", "mse_loss", "l1_loss", "smooth_l1_loss", "layer_norm",
    "group_norm", "instance_norm",
    "rms_norm", "reduce_sum", "sum", "mean", "cumsum", "logsumexp", "norm",
    "sigmoid_focal_loss", "cosine_similarity",
}

_FLOATS = (torch.float32, torch.float16, torch.bfloat16)
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def white_list() -> Set[str]:
    return set(WHITE_LIST)


def black_list() -> Set[str]:
    return set(BLACK_LIST)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white: Set[str] = set()
        self.custom_black: Set[str] = set()


_state = _AmpState()


def amp_state() -> _AmpState:
    return _state


def _to_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"auto_cast: unsupported dtype {dtype!r}; use one "
                         f"of {sorted(_DTYPES)}")
    return _DTYPES[dtype]


class auto_cast:
    """Context manager (``paddle.amp.auto_cast``); per thread, nestable."""

    def __init__(self, enable: bool = True, custom_white_list=None,
                 custom_black_list=None, level: str = "O1",
                 dtype="bfloat16"):
        self.enable = enable
        self.custom_white = set(custom_white_list or ())
        self.custom_black = set(custom_black_list or ())
        self.level = level
        self.dtype = _to_dtype(dtype)

    def __enter__(self):
        self._saved = (_state.enabled, _state.dtype, _state.level,
                       _state.custom_white, _state.custom_black)
        _state.enabled = self.enable
        _state.dtype = self.dtype
        _state.level = self.level
        _state.custom_white = self.custom_white
        _state.custom_black = self.custom_black
        return self

    def __exit__(self, *exc):
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = self._saved
        return False


amp_guard = auto_cast  # legacy fluid name


def maybe_cast_inputs(op_name: str, vals: Sequence) -> Sequence:
    """Cast the float tensors of ``vals`` per the amp policy for op
    ``op_name`` (auto_cast.py:107-130); everything else passes through,
    and with AMP off ``vals`` itself comes back (the serving path calls
    this per op, so the off path does nothing else).
    The casts are ordinary differentiable ``Tensor.to`` calls, so the
    gradients of fp32 parameters come back in fp32."""
    if not _state.enabled:
        return vals
    white = (op_name in WHITE_LIST or op_name in _state.custom_white) \
        and op_name not in _state.custom_black
    black = op_name in BLACK_LIST or op_name in _state.custom_black
    if _state.level == "O2" and not black:
        white = True
    if white:
        target = _state.dtype
    elif black:
        target = torch.float32
    else:
        return vals  # gray: leave as-is
    return [v.to(target) if isinstance(v, torch.Tensor)
            and v.dtype in _FLOATS and v.dtype != target else v
            for v in vals]
