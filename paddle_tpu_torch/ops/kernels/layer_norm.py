"""K2: fused LayerNorm forward — CUDA kernel, plain version, counter.

Replaces ``paddle_tpu/ops/pallas/layer_norm.py`` (``_ln_fwd_kernel`` via
``_ln_forward`` / ``layer_norm_pallas``). The kernel is
``paddle_tpu_torch/csrc/layer_norm.cu``; its header note says what
bounds it on the H100 and how the design answers that.

:func:`layer_norm_fwd` is the wrapper: a CPU tensor takes
:func:`layer_norm_ref` (the plain version, same arithmetic in fp32); a
CUDA tensor launches the kernel or raises. ``launches`` counts kernel
launches and nothing else.

:class:`LayerNormFn` is the autograd Function of ``_fused_layer_norm``
(``layer_norm.py:91-117``): its forward is K2 and saves K2's fp32
``(mean, rstd)``; its backward is ``_fused_ln_bwd`` (:102-114) in plain
torch, because the JAX backward is XLA, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from paddle_tpu_torch.ops.kernels import _build

__all__ = ["layer_norm_fwd", "layer_norm_ref", "LayerNormFn", "launches",
           "reset_launches"]

launches = 0

# type codes of csrc/common.cuh
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 3}


def reset_launches():
    global launches
    launches = 0


def layer_norm_ref(x2: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel on (R, C) rows: fp32 mean,
    centred variance, rstd = rsqrt(var + eps), y in x's dtype, and the
    fp32 (R, 1) mean and rstd."""
    x = x2.float()
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x2.dtype), mean, rstd


def layer_norm_fwd(x2: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm over the last axis of (R, C) ``x2``; returns
    ``(y, mean, rstd)``."""
    if x2.device.type == "cpu":
        return layer_norm_ref(x2, weight, bias, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"layer_norm_fwd: unsupported device {x2.device}")
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError("layer_norm_fwd: x must be a contiguous (R, C) "
                         f"tensor, got shape {tuple(x2.shape)}")
    if x2.dtype not in _DTYPES:
        raise TypeError(f"layer_norm_fwd: dtype {x2.dtype} not supported "
                        "(float32, bfloat16, float16)")
    R, C = x2.shape
    for name, p in (("weight", weight), ("bias", bias)):
        if p is not None and (p.device != x2.device or p.dtype != x2.dtype
                              or tuple(p.shape) != (C,)
                              or not p.is_contiguous()):
            raise ValueError(
                f"layer_norm_fwd: {name} must be a contiguous ({C},) tensor "
                f"of x's dtype and device, got {tuple(p.shape)} {p.dtype} "
                f"on {p.device}")
    lib = _build.load_library()
    y = torch.empty_like(x2)
    mean = torch.empty((R, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty((R, 1), dtype=torch.float32, device=x2.device)
    err = lib.ptt_layer_norm_fwd(
        x2.data_ptr(), None if weight is None else weight.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), R, C, float(eps),
        _DTYPES[x2.dtype], torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "layer_norm kernel")
    global launches
    launches += 1
    return y, mean, rstd


class LayerNormFn(torch.autograd.Function):
    """LayerNorm over the last axis of (R, C) ``x2``; ``weight`` and
    ``bias`` may be None."""

    @staticmethod
    def forward(ctx, x2, weight, bias, eps: float):
        y, mean, rstd = layer_norm_fwd(x2, weight, bias, eps)
        ctx.save_for_backward(x2, weight, bias, mean, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x2, w, b, mean, rstd = ctx.saved_tensors
        g = dy.float()
        xhat = (x2.float() - mean) * rstd          # mean, rstd are (R, 1)
        gw = g * w.float()[None, :] if w is not None else g
        m1 = gw.mean(dim=-1, keepdim=True)
        m2 = (gw * xhat).mean(dim=-1, keepdim=True)
        dx = (rstd * (gw - m1 - xhat * m2)).to(x2.dtype)
        dw = (g * xhat).sum(dim=0).to(w.dtype) if w is not None else None
        db = g.sum(dim=0).to(b.dtype) if b is not None else None
        return dx, dw, db, None
