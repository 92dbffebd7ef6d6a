"""Optimizer base — the port of ``paddle_tpu/optimizer/optimizer.py``.

Parameters come as paddle takes them: a list of tensors, or of groups
(dicts with ``"params"`` and optional ``"learning_rate"``, a multiplier
of the base rate, and ``"weight_decay"``). They may also come as the
``(name, tensor)`` pairs that ``Layer.named_parameters()`` yields: a
torch tensor has no paddle ``name``, and ``apply_decay_param_fun``
needs one.

Per-parameter state lives in ``_accumulators[id(param)]`` under the
JAX package's slot names. The updates are plain torch, in place
(``torch._foreach_*`` over each group): the JAX update is XLA, not a
Pallas kernel. They read no value back to the host, so a step never
waits for the card.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["Optimizer"]

_Named = List[Tuple[Optional[str], torch.Tensor]]


def _named(params) -> _Named:
    return [(p[0], p[1]) if isinstance(p, tuple) else (None, p)
            for p in params]


class Optimizer:
    # subclasses list their per-param state slot names
    _state_slots: Tuple[str, ...] = ()
    # AdamW: decay multiplies the parameter in the rule instead of being
    # folded into the gradient
    _decoupled = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision: bool = False):
        if parameters is None:
            raise ValueError("parameters is required; pass "
                             "model.parameters() or model.named_parameters()")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet; pass a float")
        if grad_clip is not None or multi_precision:
            raise NotImplementedError(
                "grad_clip and multi_precision are not ported yet")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError(
                "only a float weight_decay (L2) is ported")
        items = list(parameters)
        if items and isinstance(items[0], dict):
            self._param_groups = [dict(g, params=_named(g["params"]))
                                  for g in items]
        else:
            self._param_groups = [{"params": _named(items)}]
        self._learning_rate = float(learning_rate)
        self._weight_decay = weight_decay
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    # -- state --------------------------------------------------------------
    def _init_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {slot: torch.zeros_like(p) for slot in self._state_slots}

    def _states(self, params: List[torch.Tensor]):
        out = []
        for p in params:
            st = self._accumulators.get(id(p))
            if st is None:
                st = self._accumulators[id(p)] = self._init_state(p)
            out.append(st)
        return out

    # -- the update (override) ----------------------------------------------
    def _update(self, group: Dict[str, Any], named: _Named,
                grads: List[torch.Tensor], lr: float):
        """Update the parameters of ``named`` in place from ``grads``."""
        raise NotImplementedError

    # -- main entry ---------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient (paddle
        leaves the others out, optimizer.py:158-212)."""
        for group in self._param_groups:
            named = [(n, p) for n, p in group["params"]
                     if p.requires_grad and p.grad is not None]
            if not named:
                continue
            grads = [p.grad.to(p.dtype) for _, p in named]
            decay = group.get("weight_decay", self._weight_decay)
            if decay and not self._decoupled:
                # L2 folded into the gradient (optimizer.py:139-155)
                grads = torch._foreach_add(grads, [p for _, p in named],
                                           alpha=float(decay))
            lr = self.get_lr() * group.get("learning_rate", 1.0)
            self._update(group, named, grads, lr)

    def clear_grad(self, set_to_zero: bool = False):
        for group in self._param_groups:
            for _, p in group["params"]:
                if p.grad is None:
                    continue
                if set_to_zero:
                    p.grad.zero_()
                else:
                    p.grad = None
