"""Mixture-of-Experts layer on one device — the port of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py`` (:96-444).

The flattened tokens ``x (S, d)`` go through the gate, into fixed-capacity
per-expert buffers ``(E, C, d)``, through the experts and back. Experts of
one structure are STACKED: their parameters become ``(E, ...)``
parameters registered under the reference's names
(``name.replace(".", "__")``: ``htoh4__weight (E, d, ffn)``,
``htoh4__bias (E, ffn)``, ``h4toh__weight (E, ffn, d)``, ``h4toh__bias
(E, d)``), marked ``is_expert``. An :class:`ExpertLayer` stack runs as two
``torch.bmm`` over the buffers (each a white-listed ``linear`` under
AMP, as the reference's per-expert ``Linear``); any other template runs
under ``torch.func.vmap`` of its ``functional_call``.

The forward has the reference's four routes:

- the compact plan (gates with ``dispatch_plan``, :410-444): each slot's
  source token (the dropped assignments all write the dummy slot ``E *
  C``, which is cut off), a gather into the buffers, and a weighted
  gather back — a deterministic combine;
- expert choice (gates with ``dispatch_plan_ec``, :336-359): a gather of
  each expert's picks and a scatter-add of the weighted outputs
  (``index_add_``: atomics on the card, so its order varies);
- the combine tensor (gates with only ``dispatch_info``, or inside
  ``moe_dispatch_mode("allreduce")``, :363-382): two einsums;
- the heterogeneous per-expert loop (:384-402).

``recompute_interval > 0`` wraps the expert body in
``fleet.utils.recompute``. Expert parallelism (a ``moe_group`` of more
than one rank, the all-to-all and allreduce schedules of :194-315) is
ROADMAP Queue 1 item 6 and refuses; on one device the ``"allreduce"``
mode only selects the combine route, as it does in the reference when no
expert-parallel axis is in scope.
"""

from __future__ import annotations

import copy
import threading
from contextlib import contextmanager

import torch

from paddle_tpu_torch.amp.auto_cast import maybe_cast_inputs
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.common import Linear
from paddle_tpu_torch.nn.layers.container import LayerList

from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate, _refuse_group

__all__ = ["MoELayer", "ExpertLayer", "moe_dispatch_mode",
           "get_moe_dispatch_mode"]

_dispatch_state = threading.local()
_DISPATCH_MODES = ("alltoall", "allreduce")


def get_moe_dispatch_mode() -> str:
    """The dispatch schedule in force: "alltoall" (the default) or
    "allreduce"."""
    return getattr(_dispatch_state, "mode", "alltoall")


@contextmanager
def moe_dispatch_mode(mode: str):
    """Select the dispatch schedule for forwards run inside the context
    (per thread). On one device "allreduce" routes through the combine
    tensor, as the reference does where its token buffers replicate."""
    if mode not in _DISPATCH_MODES:
        raise ValueError(f"moe_dispatch_mode: unknown mode {mode!r}; "
                         f"one of {_DISPATCH_MODES}")
    prev = get_moe_dispatch_mode()
    _dispatch_state.mode = mode
    try:
        yield
    finally:
        _dispatch_state.mode = prev


class ExpertLayer(Layer):
    """The default FFN expert (``moe_layer.py:96``): ``htoh4``, tanh GELU
    (else ReLU), ``h4toh``. ``out_weight_attr`` initializes the
    residual-stream write on its own."""

    def __init__(self, d_model: int, d_hidden: int, activation="gelu",
                 weight_attr=None, out_weight_attr=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.htoh4 = Linear(d_model, d_hidden, weight_attr=weight_attr, **kw)
        self.h4toh = Linear(d_hidden, d_model,
                            weight_attr=out_weight_attr or weight_attr, **kw)
        self._act = activation

    def forward(self, x):
        h = self.htoh4(x)
        h = F.gelu(h, approximate=True) if self._act == "gelu" else F.relu(h)
        return self.h4toh(h)


def _make_gate(gate, d_model: int, num_expert: int, world_size: int,
               device, dtype):
    if isinstance(gate, BaseGate):
        return gate
    cfg = dict(gate or {})
    top_k = cfg.get("top_k", 2)
    kind = cfg.get("type", "gshard")
    kw = dict(device=device, dtype=dtype)
    if "capacity" in cfg:  # (train, eval) factors, or one for both
        cap = cfg["capacity"]
        kw["capacity"] = (cap, cap) if isinstance(cap, (int, float)) else cap
    if kind in (None, "naive"):
        return NaiveGate(d_model, num_expert, world_size, topk=top_k, **kw)
    if kind == "gshard":
        return GShardGate(d_model, num_expert, world_size, topk=top_k, **kw)
    if kind == "switch":
        return SwitchGate(d_model, num_expert, world_size, topk=1, **kw)
    raise ValueError(f"unknown gate type {kind!r}")


def _linear_bmm(x, w, b):
    """``x (E, C, din) @ w (E, din, dout) + b (E, dout)``: E expert
    ``Linear``s at once, cast as the white-listed ``linear``."""
    x, w, b = maybe_cast_inputs("linear", (x, w, b))
    return torch.bmm(x, w) + b[:, None, :]


class MoELayer(Layer):
    """gate -> capacity dispatch -> experts -> combine (``moe_layer.py:
    121``). ``experts``: a list or ``LayerList`` of expert layers; ``gate``
    a config dict (``type`` naive / gshard / switch, ``top_k``,
    ``capacity``) or a ``BaseGate``; ``recompute_interval > 0``
    rematerializes the expert body in the backward. The gate a config
    builds lives on the experts' device in their dtype."""

    def __init__(self, d_model: int, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval: int = 0, **kwargs):
        super().__init__()
        _refuse_group("MoELayer", moe_group)
        experts = list(experts)
        self.d_model = d_model
        self.num_expert = len(experts)
        self.world_size = getattr(moe_group, "nranks", 1) if moe_group else 1
        self.recompute_interval = recompute_interval
        first = next(experts[0].parameters())
        self.gate = _make_gate(gate, d_model, self.num_expert, 1,
                               first.device, first.dtype)
        # expert-side gates (expert choice) have no token-side k
        self.top_k = getattr(self.gate, "top_k", 0)

        trees = [dict(e.named_parameters()) for e in experts]
        keys = list(trees[0])
        homogeneous = all(
            list(t) == keys and all(
                t[k].shape == trees[0][k].shape
                and t[k].dtype == trees[0][k].dtype for k in keys)
            for t in trees) and not any(
                dict(e.named_buffers()) for e in experts)
        if homogeneous and self.num_expert > 1:
            self._param_names = keys
            with torch.no_grad():
                for name in keys:
                    stacked = torch.nn.Parameter(
                        torch.stack([t[name].detach() for t in trees]),
                        requires_grad=trees[0][name].requires_grad)
                    stacked.is_distributed = True
                    stacked.is_expert = True
                    self.register_parameter(name.replace(".", "__"), stacked)
            template = experts[0]
            self._bmm = (isinstance(template, ExpertLayer)
                         and keys == ["htoh4.weight", "htoh4.bias",
                                      "h4toh.weight", "h4toh.bias"])
            # the template lends its structure, never its weights: an
            # ExpertLayer stack keeps only its activation, another
            # template a copy on the meta device
            self._act = getattr(template, "_act", None)
            object.__setattr__(self, "_template", None if self._bmm
                               else copy.deepcopy(template).to("meta"))
            self.experts = None
        else:
            self.experts = LayerList(experts)
            for p in self.experts.parameters():
                p.is_expert = True

    # -- the expert body ------------------------------------------------------
    def _run_stacked(self, buf):
        """The stacked experts on ``buf (E, C, d)``."""
        p = [getattr(self, n.replace(".", "__")) for n in self._param_names]
        if self._bmm:
            h = _linear_bmm(buf, p[0], p[1])
            h = F.gelu(h, approximate=True) \
                if self._act == "gelu" else F.relu(h)
            return _linear_bmm(h, p[2], p[3])

        names = self._param_names
        template = self._template

        def one(params, x):
            return torch.func.functional_call(
                template, dict(zip(names, params)), (x,))

        return torch.func.vmap(one, randomness="different")(tuple(p), buf)

    def _apply_stacked(self, buf):
        if self.recompute_interval:
            return recompute(self._run_stacked, buf)
        return self._run_stacked(buf)

    # -- forward --------------------------------------------------------------
    def forward(self, x):
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        compact_ok = get_moe_dispatch_mode() != "allreduce"
        E = self.num_expert

        if (self.experts is None and compact_ok
                and hasattr(self.gate, "dispatch_plan_ec")):
            # expert-major plan: gather each expert's picks, scatter-add
            idx, val, aux = self.gate.dispatch_plan_ec(flat)
            self.gate.set_loss(aux)
            C = idx.shape[1]
            pick = idx.reshape(-1).long()
            buf = flat.index_select(0, pick).reshape(E, C, flat.shape[1])
            out = self._apply_stacked(buf)
            weighted = out * val[..., None].to(out.dtype)
            res = out.new_zeros((flat.shape[0], out.shape[-1]))
            res = res.index_add(0, pick, weighted.reshape(E * C, -1))
            return res.reshape(shape[:-1] + (res.shape[-1],))

        if (self.experts is not None or not compact_ok
                or not hasattr(self.gate, "dispatch_plan")):
            # the combine tensor: custom gates with only dispatch_info,
            # the allreduce mode, and heterogeneous experts
            combine, aux = self.gate.dispatch_info(flat)
            self.gate.set_loss(aux)
            m = (combine > 0).to(flat.dtype)
            buf = torch.einsum("sec,sd->ecd", m, flat)
            if self.experts is None:
                out = self._apply_stacked(buf)
            else:
                out = torch.stack([self.experts[e](buf[e])
                                   for e in range(E)])
            res = torch.einsum("sec,ecd->sd", combine.to(out.dtype), out)
            return res.reshape(shape[:-1] + (res.shape[-1],))

        # the compact plan: move only the routed tokens
        loc, w, C, aux = self.gate.dispatch_plan(flat)
        self.gate.set_loss(aux)
        S, K, EC = flat.shape[0], loc.shape[1], E * C
        # slot -> source token; empty slots keep S (the zero pad row),
        # dropped assignments all land on the dummy slot EC (cut off),
        # every other slot is written once
        src = torch.full((EC + 1,), S, dtype=torch.long, device=flat.device)
        src[loc.reshape(-1)] = torch.arange(
            S, device=flat.device)[:, None].expand(S, K).reshape(-1)
        xpad = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
        buf = xpad.index_select(0, src[:EC]).reshape(E, C, flat.shape[1])
        out = self._apply_stacked(buf)
        outf = torch.cat([out.reshape(EC, -1),
                          out.new_zeros((1, out.shape[-1]))])
        # each token's K outputs, weighted and summed (the dummy row
        # reads zeros): a gather, deterministic
        res = (outf.index_select(0, loc.reshape(-1)).reshape(S, K, -1)
               * w[..., None].to(out.dtype)).sum(dim=1)
        return res.reshape(shape[:-1] + (res.shape[-1],))
