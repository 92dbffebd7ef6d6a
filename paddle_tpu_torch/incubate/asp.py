"""Automatic SParsity (ASP): n:m structured sparsity for weights.

The port of ``paddle_tpu/incubate/asp.py`` (the reference's
``fluid/contrib/sparsity/asp.py`` and the mask generators of its
``utils.py``). An ``n:m`` pattern places at least ``n`` zeros in every
``1 x m`` block (the default 2:4 keeps the 2 largest magnitudes of each
4). ``prune_model`` computes and applies the masks; ``decorate`` wraps
an optimizer so the masks are re-applied after every ``step()``,
keeping the pattern through training.

The mask generators (``get_mask_1d``, ``get_mask_2d_greedy``) are the
reference's numpy functions, copied: for the same array they give the
same mask, bit for bit. A parameter is pruned by the reference's rule
(``_supported``): not excluded by name, and its 2-D view (a weight; a
4-D conv kernel flattened to ``(O, I*kh*kw)``) at least 4 on each side
and 16 in all. The port's ``Linear`` keeps paddle's ``(in, out)``
layout, so its masks are the reference's on the same weights. Conv
layers are not ported yet (ROADMAP.md Queue 1 item 7), so no 4-D kernel
reaches ``prune_model`` from a port model. The masks live on the
parameter's device in its dtype; the pruned matmuls run dense.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["decorate", "prune_model", "set_excluded_layers",
           "reset_excluded_layers", "calculate_density", "check_sparsity",
           "get_mask_1d", "get_mask_2d_greedy",
           "OptimizerWithSparsityGuarantee"]

_excluded: set = set()
# id(param) -> (weakref, mask); an entry is dropped when its parameter
# dies (a reused id is also caught on access)
_param_masks: Dict[int, tuple] = {}


def _register_mask(param, mask) -> None:
    # the entry (and the mask's device memory) goes with the parameter
    key = id(param)
    _param_masks[key] = (weakref.ref(
        param, lambda _ref: _param_masks.pop(key, None)), mask)


def _mask_of(param):
    entry = _param_masks.get(id(param))
    if entry is None:
        return None
    ref, mask = entry
    target = ref()
    if target is None or target is not param:   # stale id reuse
        _param_masks.pop(id(param), None)
        return None
    return mask


def _numpy(tensor) -> np.ndarray:
    """A host array of ``tensor`` (bf16 widened to fp32, exactly)."""
    if isinstance(tensor, torch.Tensor):
        t = tensor.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(tensor.numpy() if hasattr(tensor, "numpy") else tensor)


def set_excluded_layers(param_names: List[str], main_program=None):
    """Exclude parameters (by name substring) from pruning."""
    _excluded.update(param_names)


def reset_excluded_layers(main_program=None):
    _excluded.clear()


def calculate_density(tensor) -> float:
    arr = _numpy(tensor)
    return float(np.count_nonzero(arr)) / max(arr.size, 1)


def get_mask_1d(mat: np.ndarray, n: int, m: int) -> np.ndarray:
    """Row-direction 1D n:m mask: >= n zeros per 1 x m block (keeps the
    m-n largest magnitudes). Pads the last dim to a multiple of m."""
    mat = np.asarray(mat)
    rows, cols = mat.shape
    pad = (-cols) % m
    padded = np.pad(np.abs(mat), [(0, 0), (0, pad)])
    blocks = padded.reshape(rows, -1, m)                       # (R, B, m)
    keep = m - n
    order = np.argsort(blocks, axis=-1)                        # ascending
    mask = np.zeros_like(blocks)
    np.put_along_axis(mask, order[..., m - keep:], 1.0, axis=-1)
    return mask.reshape(rows, cols + pad)[:, :cols]


def get_mask_2d_greedy(mat: np.ndarray, n: int, m: int) -> np.ndarray:
    """2D n:m mask on m x m tiles: every row AND column of each tile
    keeps m-n entries, chosen greedily by magnitude."""
    mat = np.asarray(mat)
    rows, cols = mat.shape
    pad_r, pad_c = (-rows) % m, (-cols) % m
    padded = np.pad(np.abs(mat), [(0, pad_r), (0, pad_c)])
    mask = np.zeros_like(padded)
    keep = m - n
    for r0 in range(0, padded.shape[0], m):
        for c0 in range(0, padded.shape[1], m):
            tile = padded[r0:r0 + m, c0:c0 + m]
            sub = np.zeros((m, m))
            order = np.argsort(-tile.reshape(-1))
            row_cnt = np.zeros(m, int)
            col_cnt = np.zeros(m, int)
            for idx in order:
                i, j = divmod(int(idx), m)
                if row_cnt[i] < keep and col_cnt[j] < keep:
                    sub[i, j] = 1.0
                    row_cnt[i] += 1
                    col_cnt[j] += 1
            mask[r0:r0 + m, c0:c0 + m] = sub
    return mask[:rows, :cols]


_MASK_ALGOS = {"mask_1d": get_mask_1d, "mask_2d_greedy": get_mask_2d_greedy}


def check_sparsity(tensor, n: int = 2, m: int = 4) -> bool:
    """True iff every 1 x m block (row-direction, flattened-2D view)
    has at least n zeros."""
    arr = _to_2d(_numpy(tensor))
    if arr is None:
        return False
    rows, cols = arr.shape
    pad = (-cols) % m
    blocks = np.pad(arr, [(0, 0), (0, pad)]).reshape(rows, -1, m)
    zeros = np.sum(blocks == 0, axis=-1)
    return bool(np.all(zeros >= n))


def _to_2d(arr: np.ndarray) -> Optional[np.ndarray]:
    if arr.ndim == 2:
        return arr
    if arr.ndim == 4:            # conv OIHW -> (O, I*kh*kw)
        return arr.reshape(arr.shape[0], -1)
    return None


def _supported(name: str, arr: np.ndarray) -> bool:
    if any(ex in name for ex in _excluded):
        return False
    flat = _to_2d(arr)
    if flat is None:
        return False
    # Linear/Conv weights, not biases or norm scales, by the 2D view the
    # mask works on
    return min(flat.shape) >= 4 and flat.size >= 16


def prune_model(model, n: int = 2, m: int = 4, mask_algo: str = "mask_1d",
                with_mask: bool = True):
    """Compute and apply n:m masks to every supported parameter of
    ``model``; returns ``{param_name: mask}`` (tensors on each
    parameter's device, in its dtype)."""
    if mask_algo not in _MASK_ALGOS:
        raise ValueError(f"mask_algo must be one of {sorted(_MASK_ALGOS)}")
    algo = _MASK_ALGOS[mask_algo]
    masks: Dict[str, torch.Tensor] = {}
    for name, p in model.named_parameters():
        arr = _numpy(p)
        if not _supported(name, arr):
            continue
        mask2d = algo(_to_2d(arr), n, m)
        mask = torch.from_numpy(mask2d.reshape(arr.shape).astype(
            np.float32)).to(device=p.device, dtype=p.dtype)
        masks[name] = mask
        with torch.no_grad():
            p.mul_(mask)
        if with_mask:
            _register_mask(p, mask)
    return masks


class OptimizerWithSparsityGuarantee:
    """Wraps an optimizer: after each ``step()`` the masks are re-applied
    (one in-place multiply a pruned parameter), so pruned weights stay
    zero through training."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def inner_opt(self):
        return self._inner

    def step(self):
        self._inner.step()
        with torch.no_grad():
            for p in self._inner._parameter_list:
                mask = _mask_of(p)
                if mask is not None:
                    p.mul_(mask)

    def clear_grad(self):
        self._inner.clear_grad()


def decorate(optimizer) -> OptimizerWithSparsityGuarantee:
    return OptimizerWithSparsityGuarantee(optimizer)
