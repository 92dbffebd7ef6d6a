"""Normalization functionals of the port.

Counterpart of ``paddle_tpu/nn/functional/norm.py``. :func:`layer_norm`
keeps the routing of ``layer_norm_pallas`` (``ops/pallas/layer_norm.py:
128-135``): the common last-axis case goes to K2's autograd Function
(kernel on CUDA tensors, its plain version on CPU tensors; the backward
is plain torch from K2's mean and rstd), and the shapes that
function hands to the composed op — a multi-axis ``normalized_shape``,
x of rank < 2, C < 8, or a non-1-D weight/bias — run the composed op
here too. That gate is part of the function's meaning, not a fallback
for failures. ``layer_norm`` is on AMP's black list: under
``auto_cast`` its inputs are cast to fp32, as the JAX dispatcher does.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs
from paddle_tpu_torch.ops.kernels import layer_norm as _k2

__all__ = ["layer_norm"]


def _layer_norm_composed(x, normalized_shape, weight, bias, epsilon):
    """``nn/functional/norm.py:132``: the composed op in x's dtype."""
    if normalized_shape is None or isinstance(normalized_shape, int):
        ndim = 1
    else:
        ndim = len(normalized_shape)
    axes = tuple(range(x.dim() - ndim, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    out = (x - mean) * torch.reciprocal(torch.sqrt(var + epsilon))
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon: float = 1e-5):
    x, weight, bias = maybe_cast_inputs("layer_norm", (x, weight, bias))
    ndim = (1 if normalized_shape is None or isinstance(normalized_shape, int)
            else len(normalized_shape))
    if ndim != 1 or x.dim() < 2 or x.shape[-1] < 8 \
            or (weight is not None and weight.dim() != 1) \
            or (bias is not None and bias.dim() != 1):
        return _layer_norm_composed(x, normalized_shape, weight, bias,
                                    epsilon)
    C = x.shape[-1]
    x2 = x.reshape(-1, C).contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2, weight, bias)):
        y = _k2.LayerNormFn.apply(x2, weight, bias, float(epsilon))
    else:
        # nothing to differentiate (serving): the kernel alone, without
        # the autograd Function's host cost (~20 us a call, 25 a step)
        y = _k2.layer_norm_fwd(x2, weight, bias, float(epsilon))[0]
    return y.reshape(x.shape)
