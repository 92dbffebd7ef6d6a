"""Optimizer base — the port of ``paddle_tpu/optimizer/optimizer.py``.

Parameters come as paddle takes them: a list of tensors, or of groups
(dicts with ``"params"`` and optional ``"learning_rate"``, a multiplier
of the base rate, and ``"weight_decay"``). They may also come as the
``(name, tensor)`` pairs that ``Layer.named_parameters()`` yields: a
torch tensor has no paddle ``name``, and ``apply_decay_param_fun`` and
``state_dict`` need one (an unnamed parameter is ``param_<i>``, its
place in the optimizer's order).

``learning_rate`` is a float or an :class:`~paddle_tpu_torch.optimizer.
lr.LRScheduler`, read by :meth:`get_lr` at every step; the user steps
the scheduler, as in paddle.

A parameter made by ``Layer.create_parameter`` carries
``optimize_attr["learning_rate"]``, its ``ParamAttr``'s multiplier of
the group's rate (optimizer.py:197), and ``regularizer``, its
``ParamAttr``'s ``L1Decay``/``L2Decay`` (``paddle_tpu_torch.
regularizer``), which takes priority over the group's ``weight_decay``
(optimizer.py:147-152). ``weight_decay`` is a float (L2) or such a
regularizer.

One :meth:`step`, in the reference's order (optimizer.py:158-212):
``grad_clip`` over the raw gradients of every group at once, then the
gradients cast to the compute dtype, then the decay folded in: the
parameter's own regularizer, else the group's ``weight_decay`` (not for
AdamW, whose ``weight_decay`` is decoupled; a parameter's regularizer
is folded in under AdamW too, as the reference's trainer folds it,
trainer.py:457-466), then the rule. With
``multi_precision`` a bf16 or fp16 parameter is updated through an fp32
master copy with fp32 state (the reference's ``@master`` slot), and the
parameter receives the master rounded to its dtype.

Per-parameter state lives in ``_accumulators[id(param)]`` under the
JAX package's slot names; :meth:`_named_state` hands the same tensors
out by parameter name. The updates are plain torch, in place
(``torch._foreach_*`` over each group): the JAX update is XLA, not a
Pallas kernel. They read no value back to the host, so a step never
waits for the card.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import torch

from paddle_tpu_torch.optimizer.lr import LRScheduler
from paddle_tpu_torch.regularizer import WeightDecayRegularizer

__all__ = ["Optimizer"]

_Named = List[Tuple[Optional[str], torch.Tensor]]
_LOW = (torch.bfloat16, torch.float16)


def _named(params) -> _Named:
    return [(p[0], p[1]) if isinstance(p, tuple) else (None, p)
            for p in params]


def _decayed(decay, value, grad):
    """``grad`` with ``decay`` (a regularizer, an L2 coefficient, or
    None) folded in at ``value``."""
    if isinstance(decay, WeightDecayRegularizer):
        return decay.apply_to_grad(value, grad)
    return grad + float(decay) * value if decay else grad


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
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError("learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate)}")
        if weight_decay is not None and not isinstance(
                weight_decay, (int, float, WeightDecayRegularizer)):
            raise TypeError("weight_decay must be a float or an "
                            f"L1Decay/L2Decay, got {type(weight_decay)}")
        items = list(parameters)
        if items and isinstance(items[0], dict):
            self._param_groups = [dict(g, params=_named(g["params"]))
                                  for g in items]
        else:
            self._param_groups = [{"params": _named(items)}]
        self._learning_rate = learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate)
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._multi_precision = multi_precision
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._global_step = 0

    def _parameters(self):
        for group in self._param_groups:
            for name, p in group["params"]:
                yield group, name, p

    @property
    def _parameter_list(self) -> List[torch.Tensor]:
        return [p for _, _, p in self._parameters()]

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    # -- state --------------------------------------------------------------
    def _uses_master(self, p: torch.Tensor) -> bool:
        """Multi-precision: an fp32 master weight and fp32 state for a
        bf16 or fp16 parameter (the reference's ``MasterParam`` slots)."""
        return self._multi_precision and p.dtype in _LOW

    def _init_state_from_value(self, raw: torch.Tensor
                               ) -> Dict[str, torch.Tensor]:
        """The initial state of one parameter's compute value (the
        parameter, or its fp32 master)."""
        return {slot: torch.zeros_like(raw) for slot in self._state_slots}

    def _init_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self._uses_master(p):
            master = p.detach().float()
            st = self._init_state_from_value(master)
            st["@master"] = master
            return st
        return self._init_state_from_value(p.detach())

    def _state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._accumulators[id(p)] = self._init_state(p)
        return st

    def _named_state(self, names: Dict[int, str]
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
        """The live state of every parameter this optimizer holds whose
        ``id`` is in ``names`` (made now if it has had no step yet), keyed
        by ``names[id(param)]``. The slot tensors themselves, not copies:
        the trainer reads and writes its checkpoint's ``opt/<name>/<slot>``
        entries through them."""
        return {names[id(p)]: self._state(p)
                for _, _, p in self._parameters() if id(p) in names}

    # -- the update (override) ----------------------------------------------
    def _update(self, group: Dict[str, Any], named: _Named,
                grads: List[torch.Tensor],
                states: List[Dict[str, torch.Tensor]], lr: float):
        """Update the compute values of ``named`` (each parameter, or its
        fp32 master) in place from ``grads``, with their ``states``."""
        raise NotImplementedError

    # -- main entry ---------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient (paddle
        leaves the others out, optimizer.py:158-212)."""
        live = [(group, name, p) for group, name, p in self._parameters()
                if p.requires_grad and p.grad is not None]
        grads = [p.grad for _, _, p in live]
        if self._grad_clip is not None and live:
            # on the raw gradients of every group at once, before decay
            grads = [g for _, g in self._grad_clip(
                [(p, g) for (_, _, p), g in zip(live, grads)])]
        # one update per group and per-parameter rate multiplier
        # (``ParamAttr.learning_rate``, optimizer.py:197)
        by_group: Dict[tuple, list] = {}
        for (group, name, p), g in zip(live, grads):
            mult = float(getattr(p, "optimize_attr", {}).get(
                "learning_rate", 1.0))
            by_group.setdefault((id(group), mult), [group, mult, []])[2] \
                .append((name, p, g))
        for group, mult, items in by_group.values():
            states = [self._state(p) for _, p, _ in items]
            named = [(name, st.get("@master", p))
                     for (name, p, _), st in zip(items, states)]
            gs = [g.to(t.dtype) for (_, _, g), (_, t) in zip(items, named)]
            decay = None if self._decoupled else group.get(
                "weight_decay", self._weight_decay)
            own = [getattr(p, "regularizer", None) for _, p, _ in items]
            if isinstance(decay, WeightDecayRegularizer) or any(
                    r is not None for r in own):
                # a parameter's regularizer before the group's decay
                # (optimizer.py:147-152)
                gs = [_decayed(decay if r is None else r, t, g)
                      for r, (_, t), g in zip(own, named, gs)]
            elif decay:
                # L2 folded into the gradient (optimizer.py:139-155), on
                # the compute value (the master under multi_precision)
                gs = torch._foreach_add(gs, [t for _, t in named],
                                        alpha=float(decay))
            lr = self.get_lr() * group.get("learning_rate", 1.0) * mult
            self._update(group, named, gs, states, lr)
            masters = [(p, st["@master"]) for (_, p, _), st in
                       zip(items, states) if "@master" in st]
            if masters:
                # the master rounded to the parameter's dtype (to nearest)
                torch._foreach_copy_([p for p, _ in masters],
                                     [m for _, m in masters])
        self._global_step += 1

    def clear_grad(self, set_to_zero: bool = False):
        for _, _, p in self._parameters():
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- state dict ---------------------------------------------------------
    def _keys(self):
        """(key prefix, parameter): the parameter's name, else
        ``param_<i>`` by its place in the optimizer's order."""
        return [(name if name is not None else f"param_{i}", p)
                for i, (_, name, p) in enumerate(self._parameters())]

    def state_dict(self) -> Dict[str, Any]:
        """Every slot as ``"<name>.<slot>"`` (the master weight under
        ``"<name>.@master"``), ``"@global_step"``, and the scheduler's
        state under ``"@lr_scheduler"`` (optimizer.py:239-252)."""
        out = OrderedDict()
        for key, p in self._keys():
            st = self._accumulators.get(id(p))
            if st is None:
                continue
            for slot, val in st.items():
                out[f"{key}.{slot}"] = val
        out["@global_step"] = self._global_step
        if isinstance(self._learning_rate, LRScheduler):
            out["@lr_scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state: Dict[str, Any]):
        """Load :meth:`state_dict`'s output (tensors or arrays, copied
        onto each parameter's device); slots absent from ``state`` start
        fresh (optimizer.py:254-270)."""
        self._global_step = int(state.get("@global_step", 0))
        if "@lr_scheduler" in state and isinstance(self._learning_rate,
                                                   LRScheduler):
            self._learning_rate.set_state_dict(state["@lr_scheduler"])
        for key, p in self._keys():
            slots = list(self._state_slots)
            if self._uses_master(p):
                slots.append("@master")
            st = {slot: torch.as_tensor(state[f"{key}.{slot}"]).to(p.device)
                  for slot in slots if f"{key}.{slot}" in state}
            if st:
                base = self._init_state(p)
                for slot, v in st.items():
                    base[slot] = v.to(base[slot].dtype).clone()
                self._accumulators[id(p)] = base
