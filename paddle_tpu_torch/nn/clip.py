"""Gradient clipping — the port of ``paddle_tpu/nn/clip.py``.

The clippers take and return ``(param, grad)`` pairs of torch tensors,
as the optimizer hands them over before it folds in weight decay
(``Optimizer.step``). A parameter whose ``need_clip`` attribute is
false, or a pair whose grad is None, passes through untouched. Every
norm stays a device tensor: clipping never reads a value back to the
host, so a step still never waits for the card.

- :class:`ClipGradByValue`: each element into [min, max];
- :class:`ClipGradByNorm`: each gradient by its own L2 norm, taken in
  the gradient's dtype as the reference takes it;
- :class:`ClipGradByGlobalNorm`: every gradient by one L2 norm over all
  of them, summed in fp32 whatever the gradients' dtype, the scale cast
  to each gradient's dtype. Inside a bound mesh of ranks (the trainer
  binds its mesh around the optimizer's step) the norm is the global
  one, as the reference's compiled step takes it over the global
  gradient tree (:func:`_mesh_sq_sum`): each parameter's square sum
  counts once for each distinct slice of it (its ``_mesh_axes``: ``mp``
  for a tensor-parallel shard, ``sharding`` for a ZeRO shard), and a
  gradient replicated over an axis counts once, not once per rank;
- :func:`clip_grad_norm_`: the torch-style utility on ``.grad`` in place.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]


def _skip(p, g) -> bool:
    return g is None or (hasattr(p, "need_clip") and not p.need_clip)


class ClipGradBase:
    def __call__(self, params_grads: List[Tuple]):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max: float, min: float = None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g) if _skip(p, g) else (p, g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skip(p, g):
                out.append((p, g))
                continue
            norm = g.square().sum().sqrt()
            scale = (self.clip_norm / norm.clamp(min=1e-12)).clamp(max=1.0)
            out.append((p, g * scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm: float, group_name: str = "default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _global_norm_sq(self, params_grads):
        """The fp32 sum of squares over every clipped gradient (None if
        there is none): one multi-tensor norm launch for fp32 grads."""
        kept = [(p, g) for p, g in params_grads if not _skip(p, g)]
        if not kept:
            return None
        if _ranked_mesh() is not None:
            return _mesh_sq_sum(kept)
        grads = [g.float() for _, g in kept]
        return torch.stack(torch._foreach_norm(grads)).square().sum()

    def __call__(self, params_grads):
        sq = self._global_norm_sq(params_grads)
        if sq is None:
            return params_grads
        global_norm = sq.sqrt()
        scale = self.clip_norm / global_norm.clamp(min=self.clip_norm)
        return [(p, g) if _skip(p, g) else (p, g * scale.to(g.dtype))
                for p, g in params_grads]


def _ranked_mesh():
    """The bound mesh when it spans more than one rank, else None."""
    from paddle_tpu_torch.distributed import env

    mesh = env._bound_mesh()
    return mesh if mesh is not None and mesh.size > 1 else None


def _mesh_sq_sum(params_grads):
    """The fp32 sum of squares of the global gradients, over the bound
    mesh: each rank weighs a gradient's square sum by the number of
    distinct slices it is one of (the product of its ``_mesh_axes``'
    degrees) over the mesh's size, and one all-reduce over the whole
    mesh sums the weighted parts, so every slice counts once and a
    replicated gradient once, not once per rank."""
    from paddle_tpu_torch.distributed import collective

    mesh = _ranked_mesh()
    grads = [g.float() for _, g in params_grads]
    sq = torch.stack(torch._foreach_norm(grads)).square()
    if mesh is None:
        return sq.sum()
    weights = torch.tensor(
        [mesh.degree(getattr(p, "_mesh_axes", ())) / mesh.size
         for p, _ in params_grads], dtype=torch.float32, device=sq.device)
    total = (sq * weights).sum()
    collective.all_reduce(total, axis_name=mesh.axis_names)
    return total


def _stack(parts):
    """Per-gradient scalars stacked at their common (widest) dtype, as
    ``jnp.stack`` promotes them."""
    dtype = parts[0].dtype
    for t in parts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.stack([t.to(dtype) for t in parts])


def clip_grad_norm_(parameters, max_norm: float, norm_type: float = 2.0,
                    error_if_nonfinite: bool = False):
    """torch-style in-place utility (paddle.nn.utils.clip_grad_norm_):
    scales every ``.grad`` by min(max_norm / (total + 1e-6), 1) and
    returns the total norm, each gradient's part taken in its dtype.
    ``error_if_nonfinite`` is accepted and, as in the reference, not
    acted on."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = _stack([p.grad.abs().max() for p in params]).max()
    else:
        total = _stack([(p.grad.abs() ** norm_type).sum()
                        for p in params]).sum() ** (1.0 / norm_type)
    clip_coef = (max_norm / (total + 1e-6)).clamp(max=1.0)
    for p in params:
        p.grad = p.grad * clip_coef
    return total
