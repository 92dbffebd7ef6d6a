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
from paddle_tpu_torch.models import GPTForCausalLM, gpt_moe_tiny, gpt_tiny
from paddle_tpu_torch.models.gpt import (GPTAttention, GPTBlock, GPTMLP,
                                         GPTModel, GPTMoEMLP)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

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
        {"mesh": None, "seq_parallel": False}, None),
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
    # weight_attr, bias_attr (ParamAttr), padding_idx, sparse and name
    # are ported
    "nn.Linear": (
        "nn/layers/common.py", "Linear", Linear,
        lambda **kw: Linear(4, 8, device="cpu", **kw), {}, None),
    "nn.Embedding": (
        "nn/layers/common.py", "Embedding", Embedding,
        lambda **kw: Embedding(10, 4, device="cpu", **kw), {}, None),
    "nn.Dropout": (
        "nn/layers/common.py", "Dropout", Dropout,
        lambda **kw: Dropout(0.1, **kw),
        {"axis": None, "mode": "upscale_in_train", "name": None}, None),
    "nn.LayerNorm": (
        "nn/layers/norm.py", "LayerNorm", LayerNorm,
        lambda **kw: LayerNorm(8, device="cpu", **kw), {}, None),
    "VocabParallelEmbedding": (
        "distributed/meta_parallel/mp_layers.py", "VocabParallelEmbedding",
        VocabParallelEmbedding,
        lambda **kw: VocabParallelEmbedding(10, 4, device="cpu", **kw),
        {"mp_group": None}, None),
    "ColumnParallelLinear": (
        "distributed/meta_parallel/mp_layers.py", "ColumnParallelLinear",
        ColumnParallelLinear,
        lambda **kw: ColumnParallelLinear(4, 8, device="cpu", **kw),
        {"mp_group": None}, None),
    "RowParallelLinear": (
        "distributed/meta_parallel/mp_layers.py", "RowParallelLinear",
        RowParallelLinear,
        lambda **kw: RowParallelLinear(4, 8, device="cpu", **kw),
        {"mp_group": None}, None),
    "F.dropout": (
        "nn/functional/common.py", "dropout", F.dropout,
        lambda **kw: F.dropout(_X, 0.1, **kw),
        {"axis": None, "mode": "upscale_in_train", "name": None}, None),
    "GPTBlock": (
        "models/gpt.py", "GPTBlock", GPTBlock,
        lambda **kw: GPTBlock(gpt_tiny(), device="cpu", **kw), {}, None),
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
        lambda **kw: F.embedding(_IDS, _H[0], **kw), {}, None),
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
    "seed": "GPTForCausalLM draws its weights from a seeded generator; "
            "the graph samplers draw from a seeded numpy stream (the "
            "reference's is unseeded)",
    "write_rows": "the commit plan one forward's layers share",
    "op_name": "the op name AMP casts the tensor-parallel layers by",
    "seconds": "the host step time behind decode_step_ms_p50",
    "pin_memory": "the host tier's blocks pinned for the card's copy "
                  "engines (numpy buffers in the reference)",
    "generator": "the torch.Generator an initializer draws from; the "
                 "reference threads JAX keys",
    "multi_precision": "fp32 masters for bf16 and fp16 parameters, as "
                       "under the port's Adam (Adagrad, Adamax, RMSProp, "
                       "Lamb and Adadelta of the reference lack it)",
    "backend": "the torch.distributed backend a rank joins with: NCCL "
               "unless gloo is named (JAX has one coordination service)",
    "timeout": "the process group's timeout in seconds (JAX's "
               "coordination service has its own)",
    "process_group": "the torch.distributed group a Group runs on; the "
                     "reference's Group names a mesh axis only",
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
    "ops/manipulation.py::lax_complex": "a jax.lax helper the reference "
        "registers as as_complex's kernel; the port's as_complex is "
        "torch.complex",
    "distributed/pipeline.py::PipelineParallel.functional_call": "the "
        "reference's traced entry over substituted parameter values; the "
        "port's module runs on its own parameters (forward)",
    "distributed/pipeline_1f1b.py::Pipeline1F1B.functional_call": "the "
        "reference's traced entry over substituted parameter values; the "
        "port's module runs on its own parameters (forward)",
    "optimizer/optimizers.py::AdamW.step": "the reference's splits the "
        "groups by apply_decay_param_fun; the port's rule zeroes the "
        "decay of each parameter it excludes (Optimizer.step inherited)",
    "optimizer/optimizers.py::Lamb.step": "the reference's splits the "
        "groups by exclude_from_weight_decay_fn; the port's rule zeroes "
        "the decay of each parameter it excludes (Optimizer.step "
        "inherited)",
    "core/place.py::Place.torch_device": "the port's resolution of a "
        "place: gpu:i is cuda:i, cpu the CPU",
    "core/dtype.py::to_jax_dtype": "a JAX dtype: the port's dtypes are "
        "torch's (dtype() normalises a name or numpy dtype to one)",
    "distributed/env.py::ParallelEnv.local_rank": "the rank's index on its "
        "node (PADDLE_LOCAL_RANK), which picks its card; the reference "
        "has one process a host",
}
_MESH_WHY = ("the port's stand-in for jax.sharding.Mesh, which the "
             "reference imports: a grid of torch.distributed ranks and "
             "their process groups")
ABSENT.update({f"distributed/env.py::Mesh{m}": _MESH_WHY
               for m in ("", ".__init__", ".comm_list", ".group",
                         ".group_ranks", ".degree", ".index", ".window",
                         ".is_first_replica")})
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
         "inference/adapter_pool.py", "inference/constrain.py",
         "ops/creation.py", "ops/math.py", "ops/reduction.py",
         "ops/manipulation.py", "nn/initializer.py",
         "nn/functional/activation.py", "nn/layers/activation.py",
         "nn/functional/loss.py", "nn/layers/loss.py",
         "nn/layers/container.py", "nn/layers/transformer.py",
         "models/bert.py", "models/ernie.py", "regularizer.py",
         "inference/adaptive.py", "optimizer/optimizers.py",
         "distributed/fleet/meta_optimizers.py", "incubate/asp.py",
         "core/dtype.py", "core/memory.py",
         "device/__init__.py", "device/cuda.py", "framework/io.py",
         "framework/__init__.py", "incubate/__init__.py",
         "incubate/extras.py", "incubate/nn/__init__.py",
         "incubate/nn/fused_transformer.py",
         "incubate/distributed/models/moe/__init__.py",
         "incubate/distributed/models/moe/gate.py",
         "incubate/distributed/models/moe/moe_layer.py",
         "incubate/distributed/models/moe/grad_clip.py",
         "distributed/env.py", "distributed/collective.py",
         "distributed/topology.py", "distributed/parallel.py",
         "distributed/launch/main.py", "distributed/fleet/__init__.py",
         "distributed/meta_parallel/mp_layers.py",
         "distributed/meta_parallel/random.py",
         "distributed/meta_parallel/parallel_layers.py",
         "distributed/pipeline.py", "distributed/pipeline_1f1b.py",
         "distributed/ring_attention.py", "distributed/ulysses.py"]
# public names of the reference's top level (``import paddle_tpu``) that
# the port's (``import paddle_tpu_torch``) lacks, each with its reason and
# its ROADMAP Queue 1 item (tests/test_torch_surface.py holds the two
# namespaces to it)
_UNPORTED_OPS = {
    "controlflow": ["case", "cond", "switch_case", "while_loop"],
    "dispatch": ["apply_op", "get_op", "register_op", "unwrap"],
    "linalg": ["bmm", "cholesky", "cholesky_solve", "cross", "det", "dot",
               "eig", "eigh", "eigvals", "eigvalsh", "einsum", "histogram",
               "inv", "lstsq", "lu", "lu_unpack", "matrix_power",
               "matrix_rank", "multi_dot", "mv", "norm", "outer", "pinv",
               "qr", "slogdet", "solve", "svd", "t", "triangular_solve"],
    "manip_ext": ["as_strided", "atleast_1d", "atleast_2d", "atleast_3d",
                  "column_stack", "diag_embed", "diagflat", "diagonal",
                  "dsplit", "dstack", "fill_diagonal", "hsplit", "hstack",
                  "index_add", "index_fill", "index_put", "masked_fill",
                  "masked_scatter", "rot90", "row_stack", "swapaxes",
                  "swapdims", "take_along_dim", "tensor_split",
                  "unflatten", "unfold", "view", "view_as", "vsplit",
                  "vstack"],
    "math_ext": ["addmm", "angle", "bernoulli", "bincount", "bucketize",
                 "conj", "copysign", "corrcoef", "cov", "cummax", "cummin",
                 "cumulative_trapezoid", "deg2rad", "diff", "digamma",
                 "erfinv", "fmax", "fmin", "frexp", "gcd", "heaviside",
                 "hypot", "i0", "i0e", "i1", "i1e", "imag", "inner",
                 "isclose", "isneginf", "isposinf", "kron", "kthvalue",
                 "lcm", "ldexp", "lgamma", "logaddexp", "logcumsumexp",
                 "logit", "mode", "multinomial", "nan_to_num", "nanmean",
                 "nanmedian", "nanquantile", "nansum", "nextafter",
                 "poisson", "polygamma", "quantile", "rad2deg", "real",
                 "remainder", "renorm", "searchsorted", "sgn", "signbit",
                 "sinc", "take", "tensordot", "trapezoid", "vander"],
    "misc_tail": ["acosh", "asinh", "atanh", "batch", "broadcast_shape",
                  "broadcast_tensors", "broadcast_to_shape", "check_shape",
                  "complex", "create_parameter", "disable_signal_handler",
                  "disable_static", "dist", "enable_static", "equal_all",
                  "floor_mod", "flops", "get_cuda_rng_state",
                  "get_default_dtype", "in_dynamic_mode", "increment",
                  "is_complex", "is_empty", "is_floating_point",
                  "is_integer", "is_tensor", "mm", "multiplex",
                  "randint_like", "rank", "reshape_", "reverse", "scatter_",
                  "scatter_nd", "set_cuda_rng_state", "set_default_dtype",
                  "set_grad_enabled", "set_printoptions", "shape",
                  "squeeze_", "standard_gamma", "standard_normal", "tanh_",
                  "tolist", "trace", "unique_consecutive", "unsqueeze_"],
    "quant": ["dequantize_linear",
              "fake_channel_wise_quantize_dequantize_abs_max",
              "fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
              "fake_quantize_dequantize_moving_average_abs_max",
              "moving_average_abs_max_scale", "quantize_linear"],
    "sequence": ["sequence_mask", "sequence_pad", "sequence_unpad"],
}
ABSENT_TOP = {
    name: f"paddle_tpu/ops/{mod}.py is not ported yet (the op library's "
          "rest): ROADMAP Queue 1 item 7"
    for mod, names in _UNPORTED_OPS.items() for name in names + [mod]}
ABSENT_TOP.update({
    "autotune": "paddle_tpu/ops/autotune.py, the dispatch registry's "
                "autotuner: the port calls each op directly; ROADMAP Queue "
                "1 item 7",
    "enforce": "paddle_tpu/core/enforce.py, the reference's error types, "
               "is not ported yet: ROADMAP Queue 1 item 7",
    "errors": "paddle_tpu/core/enforce.py's error types are not ported "
              "yet: ROADMAP Queue 1 item 7",
    "hapi": "the high-level API (hapi/) is not ported yet: ROADMAP Queue 1 "
            "item 7",
    "Model": "hapi.Model is not ported yet: ROADMAP Queue 1 item 7",
    "summary": "hapi.summary is not ported yet: ROADMAP Queue 1 item 7",
    "metric": "paddle_tpu/metric/ is not ported yet: ROADMAP Queue 1 item "
              "7",
    "jax_compat": "paddle_tpu/core/jax_compat.py shims JAX versions: JAX "
                  "only, no Queue 1 item",
})

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
        {"loss_fn", "mesh"}, "the one-card trainer needs neither (no "
        "mesh, or a mesh of one rank, is one card); every call the "
        "reference accepts binds the same"),
    "inference/block_pool.py::HostTier.__init__": (
        {"dtype"}, "the tier's blocks are torch tensors: np.float32 "
        "becomes torch.float32, the same element type"),
}
# the initializers draw torch tensors: jnp.float32 becomes torch.float32
DEFAULTED.update({
    f"nn/initializer.py::{cls}.__call__": (
        {"dtype"}, "an initializer draws a torch tensor: jnp.float32 "
        "becomes torch.float32, the same element type")
    for cls in ("Initializer", "Constant", "Normal", "TruncatedNormal",
                "Uniform", "XavierNormal", "XavierUniform", "KaimingNormal",
                "KaimingUniform", "Assign", "Orthogonal", "Dirac")})


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


def _type_error(match, fn, *args):
    with pytest.raises(TypeError, match=match):
        fn(*args)
    return True


def _dropped(out):
    kept = out != 0
    assert 0 < int(kept.sum()) < out.numel()
    assert torch.allclose(out[kept], _X[kept] / 0.9)
    return True


# positional calls, each binding the reference's parameter at its place
BINDS = {
    # padding_idx, not the device: never built on cuda:0
    "Embedding(V, D, 0)": (
        lambda: Embedding(10, 4, 0, device="cpu").padding_idx == 0, None),
    # axis=None, training=True: a dropout, not the identity
    "dropout(x, 0.1, None)": (
        lambda: _dropped(F.dropout(_X, 0.1, None)), None),
    "Dropout(0.1, 1)": (lambda: Dropout(0.1, 1), "axis"),
    "Linear(4, 8, None, False)": (
        lambda: Linear(4, 8, None, False, device="cpu").bias is None, None),
    "ColumnParallelLinear(4, 8, None, False)": (
        lambda: ColumnParallelLinear(4, 8, None, False,
                                     device="cpu").bias is None, None),
    # weight_attr, third: 1 is no ParamAttr, as the reference says
    "LayerNorm(8, 1e-5, 1)": (
        lambda: _type_error("ParamAttr", LayerNorm, 8, 1e-5, 1), None),
    "VocabParallelEmbedding(10, 4, 1)": (
        lambda: _type_error("ParamAttr", VocabParallelEmbedding, 10, 4, 1),
        None),
    # use_moe, second: the block's FFN is the routed experts
    "GPTBlock(config, True)": (
        lambda: isinstance(GPTBlock(gpt_moe_tiny(), True, device="cpu").mlp,
                           GPTMoEMLP), None),
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
    # sparse, fourth: dense gradients, the same rows
    "embedding(x, w, None, True)": (
        lambda: torch.equal(F.embedding(_IDS, _H[0], None, True),
                            F.embedding(_IDS, _H[0])), None),
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
    # the module's ABSENT entries the port has are its own additions
    assert missing == {k.split("::")[1] for k in ABSENT
                       if k.startswith(rel + "::") and k not in SWEEP}
