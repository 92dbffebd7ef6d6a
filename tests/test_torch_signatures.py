"""The port's public signatures take the reference's positional order.

A positional call binds the parameter at its position: where the port
put its own parameters (``device``, ``dtype``, ``seed``) or left out a
reference parameter, the same call bound something else with no error
(``nn.Embedding(V, D, 0)`` built the table on ``cuda:0`` instead of
setting ``padding_idx``; ``F.dropout(x, 0.1, None)`` was the identity).
For every public callable below, read from the reference's source with
``ast`` (no JAX import), these tests hold:

- the port's positional parameters are the reference's, in its order,
  under its names, with its defaults;
- the port's own parameters are keyword-only;
- each reference parameter the port does not implement raises
  ``NotImplementedError`` naming it off its default, and is accepted at
  its default;
- positional calls bind what they bind in the reference.
"""

import ast
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.meta_parallel import (ColumnParallelLinear,
                                                        RowParallelLinear,
                                                        VocabParallelEmbedding)
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.inference.serving import DecodeEngine
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.models.gpt import (GPTAttention, GPTBlock, GPTMLP,
                                         GPTModel)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear

REF = Path(__file__).resolve().parents[1] / "paddle_tpu"
_EMPTY = object()    # a parameter without a default


def _ref_params(relpath, qualname):
    """(positional, keyword-only) of the reference callable: lists of
    (name, default AST node or _EMPTY); a class means its ``__init__``
    (its fields, in order, for a dataclass)."""
    tree = ast.parse((REF / relpath).read_text())
    owner, _, method = qualname.partition(".")
    node = next(n for n in tree.body if getattr(n, "name", None) == owner)
    if isinstance(node, ast.ClassDef):
        fns = [f for f in node.body if isinstance(f, ast.FunctionDef)
               and f.name == (method or "__init__")]
        if not fns:      # a dataclass: its annotated fields
            return [(f.target.id, _EMPTY if f.value is None else f.value)
                    for f in node.body if isinstance(f, ast.AnnAssign)], []
        node = fns[0]
    a = node.args
    pos = a.posonlyargs + a.args
    defaults = [_EMPTY] * (len(pos) - len(a.defaults)) + list(a.defaults)
    params = [(p.arg, d) for p, d in zip(pos, defaults)]
    if params and params[0][0] == "self":
        params = params[1:]
    kwonly = [(p.arg, _EMPTY if d is None else d)
              for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    return params, kwonly


def _port_params(obj):
    import inspect

    sig = inspect.signature(obj)
    pos = [p for p in sig.parameters.values()
           if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    kw = [p for p in sig.parameters.values() if p.kind == p.KEYWORD_ONLY]
    return pos, kw


def _same_default(node, value):
    """Whether the port's default equals the reference's (literals, and
    dotted names such as ``time.perf_counter``; other expressions, such
    as ``field(default_factory=list)``, are not compared)."""
    import inspect

    if node is _EMPTY:
        return value is inspect.Parameter.empty
    try:
        want = ast.literal_eval(node)
    except ValueError:
        if isinstance(node, (ast.Name, ast.Attribute)):
            return f"{value.__module__}.{value.__name__}" == ast.unparse(node)
        return True
    return type(value) is type(want) and value == want


def _tiny():
    return GPTForCausalLM(gpt_tiny(), device="cpu", seed=0)


_X = torch.ones(4, 64)

# id -> (reference file, qualname, port callable (for a method, bound
# to a port layer), factory taking the unported parameters as keywords,
# {unported parameter: reference default}, the field of the reference
# the port's positional fields stop before)
CASES = {
    "ServingEngine": (
        "inference/serving.py", "ServingEngine", ServingEngine,
        lambda **kw: ServingEngine(_tiny(), max_batch_slots=1, max_len=64,
                                   block_size=8, device="cpu", **kw),
        {"spec": None, "telemetry": None, "mesh": None, "quarantine": True,
         "logit_guard": False, "dispatch_retries": 2,
         "dispatch_stall_s": None, "engine_failure_threshold": 3,
         "overlap": True, "host_tier_blocks": None, "swap_min_tokens": None,
         "profile": False, "seq_parallel": False, "adaptive": None,
         "adapter_pool": None}, None),
    "DecodeEngine": (
        "inference/serving.py", "DecodeEngine", DecodeEngine,
        lambda **kw: DecodeEngine(_tiny(), 1, 64, block_size=8, **kw),
        {"ids_dtype": None, "mesh": None, "logit_guard": False,
         "host_tier_blocks": None, "seq_parallel": False,
         "adapter_pool": None}, None),
    # the reference's engine-owned state past finish_reason
    # (cancel_requested, spill and constraint slots, logprobs) is not
    # the port's
    "Request": (
        "inference/serving.py", "Request", Request,
        lambda **kw: Request([1, 2], **kw),
        {"sampling": None, "deadline": None, "tenant": "default",
         "priority": None, "adapter": None, "kind": "generate",
         "response_format": None}, "cancel_requested"),
    "nn.Linear": (
        "nn/layers/common.py", "Linear", Linear,
        lambda **kw: Linear(4, 8, device="cpu", **kw),
        # bias_attr: None (a bias) and False (none) are ported, a
        # ParamAttr is not
        {"weight_attr": None, "bias_attr": None, "name": None}, None),
    "nn.Embedding": (
        "nn/layers/common.py", "Embedding", Embedding,
        lambda **kw: Embedding(10, 4, device="cpu", **kw),
        {"padding_idx": None, "sparse": False, "weight_attr": None,
         "name": None}, None),
    "nn.Dropout": (
        "nn/layers/common.py", "Dropout", Dropout,
        lambda **kw: Dropout(0.1, **kw),
        {"axis": None, "mode": "upscale_in_train", "name": None}, None),
    "nn.LayerNorm": (
        "nn/layers/norm.py", "LayerNorm", LayerNorm,
        lambda **kw: LayerNorm(8, device="cpu", **kw),
        {"weight_attr": None, "bias_attr": None, "name": None}, None),
    "VocabParallelEmbedding": (
        "distributed/meta_parallel/mp_layers.py", "VocabParallelEmbedding",
        VocabParallelEmbedding,
        lambda **kw: VocabParallelEmbedding(10, 4, device="cpu", **kw),
        {"weight_attr": None, "mp_group": None, "name": None}, None),
    "ColumnParallelLinear": (
        "distributed/meta_parallel/mp_layers.py", "ColumnParallelLinear",
        ColumnParallelLinear,
        lambda **kw: ColumnParallelLinear(4, 8, device="cpu", **kw),
        {"weight_attr": None, "mp_group": None, "name": None}, None),
    "RowParallelLinear": (
        "distributed/meta_parallel/mp_layers.py", "RowParallelLinear",
        RowParallelLinear,
        lambda **kw: RowParallelLinear(4, 8, device="cpu", **kw),
        {"weight_attr": None, "mp_group": None, "name": None}, None),
    "F.dropout": (
        "nn/functional/common.py", "dropout", F.dropout,
        lambda **kw: F.dropout(_X, 0.1, **kw),
        {"axis": None, "mode": "upscale_in_train", "name": None}, None),
    "GPTBlock": (
        "models/gpt.py", "GPTBlock", GPTBlock,
        lambda **kw: GPTBlock(gpt_tiny(), device="cpu", **kw),
        {"use_moe": False}, None),
    "GPTAttention": ("models/gpt.py", "GPTAttention", GPTAttention, None,
                     {}, None),
    "GPTMLP": ("models/gpt.py", "GPTMLP", GPTMLP, None, {}, None),
    "GPTModel": ("models/gpt.py", "GPTModel", GPTModel, None, {}, None),
    "GPTForCausalLM": ("models/gpt.py", "GPTForCausalLM", GPTForCausalLM,
                       None, {}, None),
    "Layer.set_state_dict": (
        "nn/layer.py", "Layer.set_state_dict",
        Linear(2, 2, device="cpu").set_state_dict,
        lambda **kw: Linear(2, 2, device="cpu").set_state_dict(
            {"weight": np.zeros((2, 2), np.float32),
             "bias": np.zeros(2, np.float32)}, **kw),
        {"use_structured_name": True}, None),
}


def _off(default):
    """A value other than the reference default."""
    if default is None:
        return 1
    if isinstance(default, bool):
        return not default
    if isinstance(default, (int, float)):
        return default + 1
    return default + "_other"


UNPORTED = [(case, name) for case, spec in CASES.items()
            for name in spec[4]]


@pytest.mark.parametrize("case", list(CASES))
def test_positional_parameters_follow_the_reference(case):
    relpath, qualname, _, _, _, stop = CASES[case]
    ref, _ = _ref_params(relpath, qualname)
    if stop is not None:
        ref = ref[:[n for n, _ in ref].index(stop)]
    pos, _ = _port_params(CASES[case][2])
    assert [p.name for p in pos] == [n for n, _ in ref]
    for p, (name, node) in zip(pos, ref):
        assert _same_default(node, p.default), (name, p.default)


@pytest.mark.parametrize("case", list(CASES))
def test_port_only_parameters_are_keyword_only(case):
    relpath, qualname = CASES[case][:2]
    ref_pos, ref_kw = _ref_params(relpath, qualname)
    ref_names = {n for n, _ in ref_pos + ref_kw}
    import inspect

    sig = inspect.signature(CASES[case][2])
    own = [p for p in sig.parameters.values() if p.name not in ref_names
           and not p.name.startswith("_")]
    assert all(p.kind == p.KEYWORD_ONLY for p in own), own


@pytest.mark.parametrize("case,name", UNPORTED)
def test_unported_parameter_refused_off_its_default(case, name):
    default = CASES[case][4][name]
    with pytest.raises(NotImplementedError, match=name):
        CASES[case][3](**{name: _off(default)})


@pytest.mark.parametrize("case,name", UNPORTED)
def test_unported_parameter_accepted_at_its_default(case, name):
    relpath, qualname = CASES[case][:2]
    ref_pos, ref_kw = _ref_params(relpath, qualname)
    node = dict(ref_pos + ref_kw)[name]
    default = CASES[case][4][name]
    assert _same_default(node, default)
    CASES[case][3](**{name: default})


def _dropped(out):
    kept = out != 0
    assert 0 < int(kept.sum()) < out.numel()
    assert torch.allclose(out[kept], _X[kept] / 0.9)
    return True


# positional calls, each binding the reference's parameter at its place
BINDS = {
    # padding_idx, not the device: refused, never built on cuda:0
    "Embedding(V, D, 0)": (lambda: Embedding(10, 4, 0), "padding_idx"),
    # axis=None, training=True: a dropout, not the identity
    "dropout(x, 0.1, None)": (
        lambda: _dropped(F.dropout(_X, 0.1, None)), None),
    "Dropout(0.1, 1)": (lambda: Dropout(0.1, 1), "axis"),
    "Linear(4, 8, None, False)": (
        lambda: Linear(4, 8, None, False, device="cpu").bias is None, None),
    "ColumnParallelLinear(4, 8, None, False)": (
        lambda: ColumnParallelLinear(4, 8, None, False,
                                     device="cpu").bias is None, None),
    "LayerNorm(8, 1e-5, 1)": (lambda: LayerNorm(8, 1e-5, 1), "weight_attr"),
    "VocabParallelEmbedding(10, 4, 1)": (
        lambda: VocabParallelEmbedding(10, 4, 1), "weight_attr"),
    "GPTBlock(config, True)": (lambda: GPTBlock(gpt_tiny(), True),
                               "use_moe"),
    "Request(prompt, 4, 1.0, True, None, None, sampling)": (
        lambda: Request([1], 4, 1.0, True, None, None, object()),
        "sampling"),
    "ServingEngine(model, 1, 64, None, None, 128, 0, clock, spec)": (
        lambda: ServingEngine(_tiny(), 1, 64, None, None, 128, 0,
                              time.perf_counter, object(), device="cpu"),
        "spec"),
    "DecodeEngine(model, 1, 64, None, ids_dtype)": (
        lambda: DecodeEngine(_tiny(), 1, 64, None, np.int32), "ids_dtype"),
    "set_state_dict(state, False)": (
        lambda: Linear(2, 2, device="cpu").set_state_dict({}, False),
        "use_structured_name"),
}


@pytest.mark.parametrize("call", list(BINDS))
def test_positional_call_binds_the_reference_parameter(call):
    fn, refused = BINDS[call]
    if refused is None:
        torch.manual_seed(0)
        assert fn()
    else:
        with pytest.raises(NotImplementedError, match=refused):
            fn()
