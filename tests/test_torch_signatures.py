"""The port's public signatures take the reference's positional order.

A positional call binds the parameter at its position: where the port
put its own parameters (``device``, ``dtype``, ``seed``) or left out a
reference parameter, the same call bound something else with no error
(``nn.Embedding(V, D, 0)`` built the table on ``cuda:0`` instead of
setting ``padding_idx``; ``F.dropout(x, 0.1, None)`` was the identity;
``DecodeEngine.step``'s 5th argument was a float uniform where the
reference takes uint32 ``keydata``). Every public function, class and
method of every port module is swept with ``ast`` against the reference
file at the same relative path (no JAX import), and these hold:

- the port's positional parameters are the reference's, in its order,
  under its names, with its defaults;
- the port's own parameters are keyword-only, and each is one of the
  stated additions (``KW_ONLY``); the reference's keyword-only
  parameters are the port's too;
- a callable the reference lacks at that path is a stated exception
  (``ABSENT``, ``ELSEWHERE``), each with its reason, and no exception is
  stale;
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
from paddle_tpu_torch.inference import (BlockAllocator, DraftModelDrafter,
                                        NgramDrafter, Request, ServingEngine,
                                        SpeculativeEngine)
from paddle_tpu_torch.inference.frontend import SamplingParams
from paddle_tpu_torch.inference.prefix_cache import PrefixCacheNode
from paddle_tpu_torch.inference.program_set import ProgramSet
from paddle_tpu_torch.inference.serving import DecodeEngine, ServingMetrics
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.models.gpt import (GPTAttention, GPTBlock, GPTMLP,
                                         GPTModel)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear

REF = Path(__file__).resolve().parents[1] / "paddle_tpu"
PORT = REF.parent / "paddle_tpu_torch"
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
_SP = SamplingParams(top_k=2)
_ENGINE = DecodeEngine(_tiny(), 2, 32, block_size=8)
_DENSE = DecodeEngine(_tiny(), 2, 32)
_DRAFTER = DraftModelDrafter(_tiny(), 3)
_SPEC = SpeculativeEngine(_tiny(), 2, 32, k=2, block_size=8)
_GREEDY = (np.zeros((2, 1), np.int64), np.zeros(2, np.int32),
           np.ones(2, np.float32), np.ones(2, bool), np.zeros((2, 2), np.uint32))
_CHUNK = (np.zeros((1, 32), np.int64), 0, 0, 3, np.ones(1, np.float32),
          np.ones(1, bool), np.zeros((1, 2), np.uint32))
_ROW = (np.arange(5), 0, 0, 5, np.ones(1, np.float32), np.ones(1, bool),
        np.zeros((1, 2), np.uint32))
_GPT = _tiny()
_IDS = torch.zeros(1, 3, dtype=torch.long)
_H = torch.zeros(1, 3, 64)
_ALLOC = BlockAllocator(4, 8, 64)
# a paged engine with a host tier: the spill and swap-back methods
_TIER = DecodeEngine(_tiny(), 2, 32, block_size=8, host_tier_blocks=2)

# id -> (reference file, qualname, port callable (for a method, bound
# to a port layer), factory taking the unported parameters as keywords,
# {unported parameter: reference default}, the field of the reference
# the port's positional fields stop before)
CASES = {
    "ServingEngine": (
        "inference/serving.py", "ServingEngine", ServingEngine,
        lambda **kw: ServingEngine(_tiny(), max_batch_slots=1, max_len=64,
                                   block_size=8, device="cpu", **kw),
        {"mesh": None, "seq_parallel": False, "adaptive": None}, None),
    "DecodeEngine": (
        "inference/serving.py", "DecodeEngine", DecodeEngine,
        lambda **kw: DecodeEngine(_tiny(), 1, 64, block_size=8, **kw),
        {"ids_dtype": None, "mesh": None, "seq_parallel": False}, None),
    # the reference's engine-owned state past finish_reason
    # (cancel_requested, spill and constraint slots, logprobs) is set by
    # the engine, never by the caller: not init fields in the port
    "Request": (
        "inference/serving.py", "Request", Request,
        lambda **kw: Request([1, 2], **kw), {}, "cancel_requested"),
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
    # methods and functions (the rest of the sweep covers them by ast)
    "DecodeEngine.step": (
        "inference/serving.py", "DecodeEngine.step", _ENGINE.step,
        None, {}, None),
    # the logit guard's chaos pair: one plane only
    "DecodeEngine.scrub_slot_kv": (
        "inference/serving.py", "DecodeEngine.scrub_slot_kv",
        _ENGINE.scrub_slot_kv,
        lambda **kw: _ENGINE.scrub_slot_kv(blocks=[1], **kw),
        {"replica": 0}, None),
    "ProgramSet": (
        "inference/program_set.py", "ProgramSet", ProgramSet,
        lambda **kw: ProgramSet(**kw), {"mesh": None}, None),
    "DecodeEngine.run_prefill_chunk": (
        "inference/serving.py", "DecodeEngine.run_prefill_chunk",
        _ENGINE.run_prefill_chunk,
        lambda **kw: _ENGINE.run_prefill_chunk(*_CHUNK, **kw), {}, None),
    "DecodeEngine.prefill_chunk_at": (
        "inference/serving.py", "DecodeEngine.prefill_chunk_at",
        _ENGINE.prefill_chunk_at,
        lambda **kw: _ENGINE.prefill_chunk_at(*_ROW, **kw), {}, None),
    # the dense arena, generate() and the draft-model drafter: no
    # unported parameter among them
    "DecodeEngine.prefill": (
        "inference/serving.py", "DecodeEngine.prefill", _DENSE.prefill,
        None, {}, None),
    "DecodeEngine.release_buffers": (
        "inference/serving.py", "DecodeEngine.release_buffers",
        _DENSE.release_buffers, None, {}, None),
    "DecodeEngine.refresh_params": (
        "inference/serving.py", "DecodeEngine.refresh_params",
        _DENSE.refresh_params, None, {}, None),
    "GPTForCausalLM.generate": (
        "models/gpt.py", "GPTForCausalLM.generate", _GPT.generate, None, {},
        None),
    "DraftModelDrafter": (
        "inference/speculative.py", "DraftModelDrafter", DraftModelDrafter,
        None, {}, None),
    "DraftModelDrafter.propose": (
        "inference/speculative.py", "DraftModelDrafter.propose",
        _DRAFTER.propose, None, {}, None),
    "DraftModelDrafter.admit": (
        "inference/speculative.py", "DraftModelDrafter.admit",
        _DRAFTER.admit, None, {}, None),
    "SpeculativeEngine": (
        "inference/speculative.py", "SpeculativeEngine", SpeculativeEngine,
        lambda **kw: SpeculativeEngine(_tiny(), 1, 64, 2, block_size=8,
                                       **kw),
        {"ids_dtype": None, "mesh": None, "seq_parallel": False}, None),
    "SpeculativeEngine.verify": (
        "inference/speculative.py", "SpeculativeEngine.verify",
        _SPEC.verify, None, {}, None),
    "ServingEngine.run": (
        "inference/serving.py", "ServingEngine.run",
        ServingEngine(_tiny(), 1, 64, block_size=8, device="cpu").run,
        lambda **kw: ServingEngine(_tiny(), 1, 64, block_size=8,
                                   device="cpu").run(**kw),
        {}, None),
    "ServingMetrics": (
        "inference/serving.py", "ServingMetrics", ServingMetrics, None, {},
        None),
    "ServingMetrics.record_step": (
        "inference/serving.py", "ServingMetrics.record_step",
        ServingMetrics(1).record_step, None, {}, None),
    "BlockAllocator": (
        "inference/block_pool.py", "BlockAllocator", BlockAllocator,
        lambda **kw: BlockAllocator(4, 8, 64, **kw),
        {"devices": 1, "replicas": 1}, None),
    # the host tier (one plane: ``replica`` at 0 only)
    "DecodeEngine.gather_blocks_to_host": (
        "inference/serving.py", "DecodeEngine.gather_blocks_to_host",
        _TIER.gather_blocks_to_host,
        lambda **kw: _TIER.gather_blocks_to_host([1], **kw),
        {"replica": 0}, None),
    "DecodeEngine.spill_blocks": (
        "inference/serving.py", "DecodeEngine.spill_blocks",
        _TIER.spill_blocks,
        lambda **kw: _TIER.host_tier.deref(_TIER.spill_blocks([1], **kw),
                                           restored=True),
        {"replica": 0}, None),
    "DecodeEngine.restore_blocks": (
        "inference/serving.py", "DecodeEngine.restore_blocks",
        _TIER.restore_blocks,
        lambda **kw: _TIER.restore_blocks([0], [1], **kw),
        {"replica": 0}, None),
    "BlockAllocator.alloc": (
        "inference/block_pool.py", "BlockAllocator.alloc", _ALLOC.alloc,
        lambda **kw: _ALLOC.deref(_ALLOC.alloc(1, **kw)), {"replica": 0},
        None),
    "BlockAllocator.free_count": (
        "inference/block_pool.py", "BlockAllocator.free_count",
        _ALLOC.free_count, lambda **kw: _ALLOC.free_count(**kw),
        {"replica": None}, None),
    "GPTAttention.forward": (
        "models/gpt.py", "GPTAttention.forward", _GPT.gpt.h[0].attn.forward,
        lambda **kw: _GPT.gpt.h[0].attn(_H, None, **kw), {}, None),
    "GPTMLP.forward": (
        "models/gpt.py", "GPTMLP.forward", _GPT.gpt.h[0].mlp.forward,
        lambda **kw: _GPT.gpt.h[0].mlp(_H, **kw), {}, None),
    "GPTBlock.forward": (
        "models/gpt.py", "GPTBlock.forward", _GPT.gpt.h[0].forward,
        lambda **kw: _GPT.gpt.h[0](_H, None, **kw), {}, None),
    "GPTModel.forward": (
        "models/gpt.py", "GPTModel.forward", _GPT.gpt.forward,
        lambda **kw: _GPT.gpt(_IDS, **kw), {}, None),
    "GPTForCausalLM.forward": (
        "models/gpt.py", "GPTForCausalLM.forward", _GPT.forward,
        lambda **kw: _GPT(_IDS, **kw), {}, None),
    "F.linear": ("nn/functional/common.py", "linear", F.linear, None, {},
                 None),
    "F.embedding": (
        "nn/functional/common.py", "embedding", F.embedding,
        lambda **kw: F.embedding(_IDS, _H[0], **kw), {"sparse": False},
        None),
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


# ------------------------------------------------------------ the sweep
# the port's own keyword-only parameters, each with its reason
KW_ONLY = {
    "device": "entry points run on the card unless the caller asks for "
              "the CPU",
    "dtype": "layers are built at a torch dtype (bf16 serving)",
    "seed": "GPTForCausalLM draws its weights from a seeded generator",
    "write_rows": "the commit plan one forward's layers share",
    "op_name": "the op name AMP casts the tensor-parallel layers by",
    "seconds": "the host step time behind decode_step_ms_p50",
    "pin_memory": "the host tier's blocks pinned for the card's copy "
                  "engines (numpy buffers in the reference)",
}
# port callables the reference file at the same path lacks
ABSENT = {
    "core/place.py::resolve_device": "the port's default-to-the-card "
        "device rule, raising without one",
    "core/place.py::module_device": "where a module's parameters live; "
        "the reference's get_device() arrives with device/",
    "core/random.py::generator": "torch.Generator for weight draws; the "
        "reference threads JAX keys",
    "core/random.py::request_seed": "a request's seed for its stream; "
        "JAX's threefry is not reproduced",
    "core/random.py::request_keydata": "a request's (2,) uint32 key data, "
        "the port's stand-in for its JAX key",
    "core/random.py::position_uniforms": "the counter-based draw standing "
        "in for fold_in(slot_key, P)",
    "core/unported.py::refuse_unported": "the port's refusal of reference "
        "parameters it does not implement",
}
# port modules that carry every public callable of their reference but
# the ``ABSENT`` entries named there
WHOLE = ["core/flags.py", "testing/fault_injection.py",
         "distributed/checkpoint.py", "distributed/resilience.py",
         "distributed/strategy.py", "inference/program_set.py",
         "observability/__init__.py", "observability/metrics.py",
         "observability/flight_recorder.py", "observability/trace.py",
         "observability/slo.py", "observability/profile.py",
         "observability/sentinel.py", "observability/ops_plane.py",
         "observability/dump.py", "inference/frontend/sampling.py",
         "inference/frontend/admission.py", "inference/fleet/client.py",
         "inference/frontend/server.py", "inference/frontend/ingest.py",
         "inference/fleet/router.py", "inference/fleet/engine_proc.py",
         "inference/adapter_pool.py", "inference/constrain.py"]
# port modules with no reference file at their path
ABSENT_MODULES = {
    "ops/kernels/_build.py": "nvcc build and ctypes binding of csrc/",
    "ops/kernels/chunk_prefill.py": "K5's wrapper; the TPU kernel is "
        "ops/pallas/chunk_prefill.py",
    "ops/kernels/flash_attention.py": "K1/K3's wrappers; the TPU kernels "
        "are ops/pallas/flash_attention.py",
    "ops/kernels/layer_norm.py": "K2's wrapper; the TPU kernel is "
        "ops/pallas/layer_norm.py",
    "ops/kernels/paged_attention.py": "K4's wrapper; the TPU kernel is "
        "ops/pallas/paged_attention.py",
}
# port callables whose reference sits in another file
ELSEWHERE = {
    "nn/functional/attention.py::flash_attention":
        "ops/pallas/flash_attention.py",
}
# reference parameters whose default the port sets otherwise: none in
# the reference, or one of another framework's types
DEFAULTED = {
    "distributed/trainer.py::ShardedTrainer.__init__": (
        {"loss_fn", "mesh"}, "the one-card trainer needs neither; every "
        "call the reference accepts binds the same"),
    "inference/block_pool.py::HostTier.__init__": (
        {"dtype"}, "the tier's blocks are torch tensors: np.float32 "
        "becomes torch.float32, the same element type"),
}


def _public(path):
    """{qualname: node} of a file's public functions, classes and their
    public methods (``__init__`` and ``__call__`` included)."""
    out = {}
    if not path.exists():
        return out
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)) \
                and not n.name.startswith("_"):
            out[n.name] = n
            if isinstance(n, ast.ClassDef):
                for f in n.body:
                    if isinstance(f, ast.FunctionDef) and (
                            not f.name.startswith("_")
                            or f.name in ("__init__", "__call__")):
                        out[f"{n.name}.{f.name}"] = f
    return out


SWEEP = {f"{f.relative_to(PORT).as_posix()}::{q}": node
         for f in sorted(PORT.rglob("*.py"))
         for q, node in _public(f).items()}


def _ref_node(sid):
    rel, qual = sid.split("::")
    return _public(REF / ELSEWHERE.get(sid, rel)).get(qual)


def _case_sid(relpath, qualname):
    sid = f"{relpath}::{qualname}"
    return sid + ".__init__" if f"{sid}.__init__" in SWEEP else sid


_COVERED = {_case_sid(c[0], c[1]) for c in CASES.values()}
_FUNCS = [sid for sid, n in SWEEP.items()
          if isinstance(n, ast.FunctionDef) and sid not in _COVERED]
_CLASSES = [sid for sid, n in SWEEP.items() if isinstance(n, ast.ClassDef)]
_IN_REF = [sid for sid in _FUNCS if _ref_node(sid) is not None]


def _ast_params(fn):
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [_EMPTY] * (len(pos) - len(a.defaults)) + list(a.defaults)
    params = [(p.arg, d) for p, d in zip(pos, defaults)]
    if params and params[0][0] in ("self", "cls", "ctx"):
        params = params[1:]
    return params, [p.arg for p in a.kwonlyargs]


def _sweep_positional(sid):
    rel = sid.split("::")[0]
    ref = _ref_node(sid)
    if rel in ABSENT_MODULES:
        assert not (REF / rel).exists(), f"{rel} has a reference now"
        return
    if ref is None:
        assert sid in ABSENT, (f"{sid}: the reference lacks it; state "
                               "why in ABSENT")
        return
    assert sid not in ABSENT, f"{sid} is in the reference: stale"
    if isinstance(ref, ast.ClassDef):
        return
    mine, _ = _ast_params(SWEEP[sid])
    theirs, _ = _ast_params(ref)
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    free = DEFAULTED.get(sid, (set(), ""))[0]
    for (name, d), (_, want) in zip(mine, theirs):
        if name in free:
            assert d is not _EMPTY, name
            continue
        assert (d is _EMPTY) == (want is _EMPTY), name
        if d is not _EMPTY:
            assert ast.dump(d) == ast.dump(want), (name, ast.unparse(d),
                                                   ast.unparse(want))


@pytest.mark.parametrize("case", list(CASES) + _FUNCS + _CLASSES)
def test_positional_parameters_follow_the_reference(case):
    if case not in CASES:
        _sweep_positional(case)
        return
    relpath, qualname, _, _, _, stop = CASES[case]
    ref, _ = _ref_params(relpath, qualname)
    if stop is not None:
        ref = ref[:[n for n, _ in ref].index(stop)]
    pos, _ = _port_params(CASES[case][2])
    assert [p.name for p in pos] == [n for n, _ in ref]
    for p, (name, node) in zip(pos, ref):
        assert _same_default(node, p.default), (name, p.default)


def _sweep_keyword_only(sid):
    mine, ref = SWEEP[sid], _ref_node(sid)
    _, my_kw = _ast_params(mine)
    ref_pos, ref_kw = _ast_params(ref)
    own = set(my_kw) - set(ref_kw) - {n for n, _ in ref_pos}
    assert own <= set(KW_ONLY), f"{sid}: state the reason for {own}"
    assert set(ref_kw) <= set(my_kw), f"{sid}: lacks {set(ref_kw)}"
    for kind in ("vararg", "kwarg"):
        assert (getattr(mine.args, kind) is None) == \
            (getattr(ref.args, kind) is None), kind


@pytest.mark.parametrize("case", list(CASES) + _IN_REF)
def test_port_only_parameters_are_keyword_only(case):
    if case not in CASES:
        _sweep_keyword_only(case)
        return
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
    # sampling, 7th: the SamplingParams bundle submit() folds in
    "Request(prompt, 4, 1.0, True, None, None, sampling)": (
        lambda: Request([1], 4, 1.0, True, None, None, _SP).sampling is _SP,
        None),
    # spec is ported: the drafter makes the engine speculative at its k
    "ServingEngine(model, 1, 64, None, None, 128, 0, clock, spec)": (
        lambda: ServingEngine(_tiny(), 1, 64, None, None, 128, 0,
                              time.perf_counter, NgramDrafter(k=2),
                              block_size=8, device="cpu").engine.k == 2,
        None),
    # keydata, not uniforms, 5th; topks, topps and defer defaulted
    "step(toks, t, temps, greedy, keydata)": (
        lambda: tuple(_ENGINE.step(*_GREEDY).shape) == (2, 1), None),
    "verify(pending, drafts, t, temps, greedy, keydata)": (
        lambda: tuple(_SPEC.verify(_GREEDY[0], np.zeros((2, 2), np.int64),
                                   *_GREEDY[1:])[0].shape) == (2, 3), None),
    # lora, not the port's write_rows, 3rd: a slice with no target
    # perturbs nothing
    "GPTAttention.forward(x, None, lora)": (
        lambda: torch.equal(_GPT.gpt.h[0].attn(_H, None, {"ids": None}),
                            _GPT.gpt.h[0].attn(_H)), None),
    # op_name is the port's own: a 4th positional is one too many
    "linear(x, w, b, 'linear')": (
        lambda: pytest.raises(TypeError, F.linear, _X, torch.ones(64, 2),
                              None, "linear") is not None, None),
    "embedding(x, w, None, True)": (
        lambda: F.embedding(_IDS, _H[0], None, True), "sparse"),
    # kseg, vseg: the dense arena's cached segment pair
    "PrefixCacheNode(key, parent, kseg, vseg)": (
        lambda: PrefixCacheNode((), None, _X, _X[:1]).kseg is _X, None),
    "spill_blocks(blocks, replica)": (
        lambda: _TIER.spill_blocks([1], 1), "replica"),
    "alloc(n, replica)": (lambda: _ALLOC.alloc(1, 1), "replica"),
    # the prompt rows, their slots and lengths, then the sampler's rows
    "prefill(ids, slots, prompt_lens, temps, greedy, keydata)": (
        lambda: tuple(_DENSE.prefill(np.ones((1, 3), np.int64), [1], [3],
                                     *_GREEDY[2:4], _GREEDY[4])[:1].shape)
        == (1, 1), None),
    # max_new_tokens, temperature, top_k, top_p, use_cache: greedy
    # through the concat caches equals the whole-sequence path
    "generate(ids, 3, 1.0, 1, None, False)": (
        lambda: torch.equal(_GPT.generate(_IDS, 3, 1.0, 1, None, False),
                            _GPT.generate(_IDS, 3, 1.0, 1, None, True)),
        None),
    "DraftModelDrafter(model, 3)": (lambda: _DRAFTER.accept_cap == 2, None),
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


EXCEPTIONS = ([("ABSENT", k) for k in ABSENT]
              + [("ABSENT_MODULES", k) for k in ABSENT_MODULES]
              + [("ELSEWHERE", k) for k in ELSEWHERE]
              + [("DEFAULTED", k) for k in DEFAULTED]
              + [("KW_ONLY", k) for k in KW_ONLY])


@pytest.mark.parametrize("kind,key", EXCEPTIONS)
def test_stated_exception_is_live(kind, key):
    """Every stated exception names something the sweep meets, with a
    reason."""
    table = globals()[kind]
    reason = table[key][1] if kind == "DEFAULTED" else table[key]
    assert isinstance(reason, str) and len(reason) > 20
    if kind == "ABSENT":
        # a port callable the reference lacks, or the reverse in a
        # module ported whole
        assert (key in SWEEP) != (_ref_node(key) is not None)
        if key not in SWEEP:
            assert key.split("::")[0] in WHOLE
    elif kind == "ABSENT_MODULES":
        assert (PORT / key).exists() and not (REF / key).exists()
    elif kind == "ELSEWHERE":
        assert key in SWEEP and _ref_node(key) is not None
    elif kind == "DEFAULTED":
        ref, _ = _ast_params(_ref_node(key))
        mine = dict(_ast_params(SWEEP[key])[0])
        # each named parameter lacks a default in the reference, or the
        # port's differs from it
        assert table[key][0] <= {
            n for n, d in ref if d is _EMPTY or (
                mine.get(n, _EMPTY) is not _EMPTY
                and ast.dump(mine[n]) != ast.dump(d))}
    else:
        assert any(key in _ast_params(n)[1] for n in SWEEP.values()
                   if isinstance(n, ast.FunctionDef))


@pytest.mark.parametrize("rel", WHOLE)
def test_whole_module_has_every_reference_callable(rel):
    mine = set(_public(PORT / rel))
    missing = {q for q in _public(REF / rel) if q not in mine}
    assert missing == {k.split("::")[1] for k in ABSENT
                       if k.startswith(rel + "::")}
