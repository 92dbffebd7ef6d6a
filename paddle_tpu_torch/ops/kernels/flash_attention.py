"""K1, K3a, K3b: flash attention — CUDA kernels, plain versions, counters.

Replaces ``paddle_tpu/ops/pallas/flash_attention.py``: the forward
kernels ``_fwd_kernel`` (:54) and ``_fwd_stream_kernel`` (:108), which
on Hopper are one entry point (``csrc/flash_fwd.cu``: a tensor-core
kernel for bf16, a CUDA-core one for fp32), the fused backward
``_bwd_fused_kernel`` (:362) and the streaming pair
``_bwd_dkv_stream_kernel`` (:162) / ``_bwd_dq_stream_kernel`` (:215)
(``csrc/flash_bwd.cu``: the fused kernel and the dK/dV pass are one
body, the dQ pass another, both on the tensor cores for bf16). The
kernels' header notes say what bounds each on the H100 and how the
design answers that.

Each wrapper takes paddle's (B, S, H, D) layout: a CPU tensor runs the
plain version (``flash_fwd_ref`` / ``flash_bwd_ref``, the same
arithmetic in fp32 with the same bf16 rounding points); a CUDA tensor
launches the kernel or raises. A view the kernels cannot take (a head
dim that is not contiguous, k and v with unequal strides; in bf16, where
every kernel runs on the tensor cores, also a base pointer not 16-byte
aligned or a stride not a multiple of 8) is copied first by
:func:`kernel_layout`. ``launches`` counts kernel launches, per
kernel, and nothing else.

:class:`FlashAttentionFn` is the autograd Function: its forward saves
``(o, lse)``; its backward computes ``delta = rowsum(dO * O)`` in torch
(as JAX does in XLA, :522) and takes JAX's route: the fused kernel up to
``_STREAM_THRESHOLD``, the two streaming passes beyond it.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from paddle_tpu_torch.ops.kernels import _build

__all__ = ["flash_fwd", "flash_fwd_ref", "flash_bwd_fused", "flash_bwd_dkv",
           "flash_bwd_dq", "flash_bwd_ref", "FlashAttentionFn", "kernel_layout",
           "launches", "reset_launches"]

# beyond this sequence length the JAX package streams K/V and splits the
# backward in two (flash_attention.py:38); the port keeps the same route
_STREAM_THRESHOLD = 8192

_MASKED = -1e30   # flash_attention.py:33: never -inf, so exp/max stay finite

launches = {"fwd": 0, "bwd_fused": 0, "bwd_dkv": 0, "bwd_dq": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def reset_launches():
    for name in launches:
        launches[name] = 0


def _pick_block(seq: int, preferred: int) -> int:
    """Largest divisor of ``seq`` that is <= preferred (>= 1)
    (``flash_attention.py:41-46``)."""
    b = min(preferred, seq)
    while seq % b:
        b -= 1
    return b


def _use_streaming(sq: int, sk: int) -> bool:
    return max(sq, sk) > _STREAM_THRESHOLD


# ------------------------------------------------------------ plain versions
def _scores(q, k, scale: float, causal: bool):
    """fp32 (B, H, Sq, Sk) logits, masked -1e30 where the causal mask
    (TOP-LEFT aligned, rows >= cols, :74-79) hides them."""
    s = torch.matmul(q.transpose(1, 2).float(),
                     k.transpose(1, 2).float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, _MASKED)
    return s


def flash_fwd_ref(q, k, v, scale: float, causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: O (B, Sq, H, D) in q's dtype and the fp32
    logsumexp (B, H, Sq). P is rounded to V's dtype before P.V (:85)."""
    s = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.transpose(1, 2).float()) / l
    return o.transpose(1, 2).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_bwd_ref(q, k, v, do, lse, delta, scale: float, causal: bool):
    """Plain backward from the saved lse and delta = rowsum(dO * O), both
    fp32 (B, H, Sq): (dQ, dK, dV) in the dtypes of q, k, v, with P and dS
    rounded where the Pallas kernels round them (:408, :417, :422)."""
    p = torch.exp(_scores(q, k, scale, causal) - lse[..., None])
    dof = do.transpose(1, 2).float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.transpose(1, 2).float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.transpose(1, 2).float())
    dq = torch.matmul(ds.to(k.dtype).float(), k.transpose(1, 2).float())
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


# ------------------------------------------------------------------ kernels
def _cuda_args(name: str, q, k, v):
    """Check what the kernels take and return q, k, v in their layout
    (:func:`kernel_layout`)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype of "
                        f"float32/bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"{name}: q (B, Sq, H, D) and k, v (B, Sk, H, D) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} not supported by "
                         f"the CUDA kernels (one of {_HEAD_DIMS})")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError(f"{name}: batch * heads must be <= 65535")
    return kernel_layout(q, k, v)


def _fits_kernel(t) -> bool:
    if t.stride(-1) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def kernel_layout(q, k, v):
    """q, k, v in the layout the flash kernels take, on any device: the
    head dim contiguous and k and v sharing strides; in bf16 also every
    base pointer 16-byte aligned and every stride on (B, S, H) a multiple
    of 8 elements, since every bf16 kernel runs on the tensor cores and
    stages 16-byte chunks by cp.async. Views that already fit are
    returned as they are (GPT's per-head slices of one qkv projection:
    strides 3HD, 3D, 1 at element offsets 0, D, 2D); the others are
    copied into fresh contiguous tensors, a layout copy that never
    changes the route. ``clone`` and not ``contiguous``: a contiguous
    view at a misaligned offset would come back as itself."""
    def fresh(t):
        return t.clone(memory_format=torch.contiguous_format)

    if not _fits_kernel(q):
        q = fresh(q)
    if not (_fits_kernel(k) and _fits_kernel(v)) or k.stride() != v.stride():
        k, v = fresh(k), fresh(v)
    return q, k, v


def _tail(q, k, scale: float, causal: bool):
    B, Sq, H, D = q.shape
    return (B, H, Sq, k.shape[1], D, *q.stride()[:3], *k.stride()[:3],
            float(scale), int(bool(causal)), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _grad_args(name: str, q, k, v, do, lse, delta):
    """The backward kernels' inputs in their layout: q, k, v by
    :func:`kernel_layout`; dO, lse and delta contiguous, and a bf16 dO at
    a 16-byte aligned base (a contiguous view at a misaligned offset is
    copied)."""
    q, k, v = _cuda_args(name, q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: dO must match q's shape and dtype")
    for t, what in ((lse, "lse"), (delta, "delta")):
        if t.dtype != torch.float32 or tuple(t.shape) != (
                q.shape[0], q.shape[2], q.shape[1]):
            raise ValueError(f"{name}: {what} must be fp32 (B, H, Sq)")
    do = do.contiguous()
    if not _fits_kernel(do):
        do = do.clone()
    return q, k, v, do, lse.contiguous(), delta.contiguous()


def flash_fwd(q, k, v, scale: float, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward (K1, both routes): ``(O, lse)``."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, scale, causal)
    q, k, v = _cuda_args("flash_fwd", q, k, v)
    B, Sq, H, D = q.shape
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = _build.load_library().ptt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_tail(q, k, scale, causal))
    _build.check(err, "flash forward kernel")
    launches["fwd"] += 1
    return o, lse


def flash_bwd_fused(q, k, v, do, lse, delta, scale: float, causal: bool):
    """K3a: ``(dQ, dK, dV)`` in one pass per key tile; dQ accumulates in
    fp32 by atomics (its last bits vary from run to run)."""
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, do, lse, delta, scale, causal)
    q, k, v, do, lse, delta = _grad_args("flash_bwd_fused", q, k, v, do,
                                         lse, delta)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = _build.load_library().ptt_flash_bwd_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *_tail(q, k, scale, causal))
    _build.check(err, "flash fused backward kernel")
    launches["bwd_fused"] += 1
    return dq.to(q.dtype), dk, dv


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float, causal: bool):
    """K3b, first pass: ``(dK, dV)``."""
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, do, lse, delta, scale, causal)[1:]
    q, k, v, do, lse, delta = _grad_args("flash_bwd_dkv", q, k, v, do, lse,
                                         delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = _build.load_library().ptt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_tail(q, k, scale, causal))
    _build.check(err, "flash dK/dV backward kernel")
    launches["bwd_dkv"] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float, causal: bool):
    """K3b, second pass: dQ, accumulated in registers and written once
    (the same from run to run: no atomics)."""
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, do, lse, delta, scale, causal)[0]
    q, k, v, do, lse, delta = _grad_args("flash_bwd_dq", q, k, v, do, lse,
                                         delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _build.load_library().ptt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_tail(q, k, scale, causal))
    _build.check(err, "flash dQ backward kernel")
    launches["bwd_dq"] += 1
    return dq


class FlashAttentionFn(torch.autograd.Function):
    """``jax.custom_vjp`` of ``_flash_attention`` (:569-579) in torch."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        o, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        if _use_streaming(q.shape[1], k.shape[1]):
            dk, dv = flash_bwd_dkv(*args)
            dq = flash_bwd_dq(*args)
        else:
            dq, dk, dv = flash_bwd_fused(*args)
        return dq, dk, dv, None, None
