"""MoE-aware global-norm gradient clipping — the port of
``paddle_tpu/incubate/distributed/models/moe/grad_clip.py``.

The global norm is taken as two fp32 sums of squares, one over the
expert parameters' gradients (``is_expert``, or
``is_expert_param_func``) and one over the rest, combined into one
clipping coefficient ``min(clip_norm / max(norm, 1e-12), 1)`` applied to
every clipped gradient in its own dtype. Parameters whose ``need_clip``
is false and pairs without a gradient pass through untouched. The norm
stays a device tensor (no read-back). The expert sum is reduced over the
expert-parallel group in the reference; with more than one rank that is
ROADMAP Queue 1 item 6 and refuses.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from paddle_tpu_torch.nn.clip import ClipGradBase

from .gate import _refuse_group

__all__ = ["ClipGradForMOEByGlobalNorm"]


def _default_is_expert(p) -> bool:
    return bool(getattr(p, "is_expert", False))


def _skipped(p, g) -> bool:
    return g is None or (hasattr(p, "need_clip") and not p.need_clip)


class ClipGradForMOEByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm: float,
                 is_expert_param_func: Optional[Callable] = None,
                 moe_group=None, group_name: str = "default_moe_group"):
        _refuse_group("ClipGradForMOEByGlobalNorm", moe_group)
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.moe_group = moe_group
        self.is_expert_param_func = is_expert_param_func or _default_is_expert

    @staticmethod
    def _norm_sq(grads):
        if not grads:
            return None
        return torch.stack([g.float().square().sum() for g in grads]).sum()

    def __call__(self, params_grads):
        normal, expert = [], []
        for p, g in params_grads:
            if not _skipped(p, g):
                (expert if self.is_expert_param_func(p) else normal).append(g)
        parts = [s for s in (self._norm_sq(normal), self._norm_sq(expert))
                 if s is not None]
        if not parts:
            return list(params_grads)
        global_norm = sum(parts).sqrt()
        scale = (self.clip_norm / global_norm.clamp(min=1e-12)).clamp(max=1.0)
        return [(p, g) if _skipped(p, g) else (p, g * scale.to(g.dtype))
                for p, g in params_grads]
