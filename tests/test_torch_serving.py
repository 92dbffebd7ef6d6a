"""Port serving stack (``paddle_tpu_torch.inference``) against the JAX one.

The same weights (copied by name), the same traces: greedy tokens,
scheduler decisions and counted metrics must be IDENTICAL between the
two engines — the traces of ``tests/test_paged_kv.py``. A greedy
divergence would be tolerated only where the JAX top-2 logit gap at that
step is below 1e-4 (fp32 summation order); none occurs on these traces,
and the tests say so by asserting exact equality.

Temperature sampling cannot reproduce JAX's threefry stream, so the
port's sampler is held to the filtered softmax by a chi-square test.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as paddle
from paddle_tpu.inference.block_pool import BlockAllocator as JaxAllocator
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.inference.serving import apply_topk_topp as jax_topk_topp
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

from paddle_tpu_torch.inference import (BlockAllocator, PrefixCache,
                                        Request, ServingEngine,
                                        apply_topk_topp)
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

SYS = [7, 3, 9, 11, 2, 5, 8, 4] * 4          # 32-token shared prefix
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    """Both models with the same random weights, wide enough that greedy
    decoding produces varied tokens."""
    paddle.seed(1234)
    jm = JaxGPT(jax_gpt_tiny())
    rs = np.random.RandomState(0)
    state = {}
    for k, v in jm.state_dict().items():
        a = rs.randn(*v.shape).astype(np.float32) * (0.3 if v.ndim == 2
                                                     else 0.1)
        if ".ln_" in k and k.endswith("weight"):
            a += 1.0
        state[k] = a
    jm.set_state_dict(state)
    pm = GPTForCausalLM(gpt_tiny(), device="cpu")
    pm.set_state_dict(state)
    return jm, pm


def _serve_jax(jm, prompts, n=6, max_len=128, prefill_chunk=16,
               poison=False, **kw):
    eng = JaxEngine(jm, max_batch_slots=2, max_len=max_len, top_k=1,
                    prefill_chunk=prefill_chunk, **kw)
    if poison:
        # the reference's own poison discipline (tests/test_paged_kv.py)
        eng.engine._ensure_buffers()
        eng.engine.kbufs = [jnp.full_like(b, 1e9) for b in eng.engine.kbufs]
        eng.engine.vbufs = [jnp.full_like(b, 1e9) for b in eng.engine.vbufs]
    reqs = [eng.submit(JaxRequest(prompt=p, max_new_tokens=n, greedy=True))
            for p in prompts]
    m = eng.run(max_steps=800)
    assert all(r.status == "done" for r in reqs)
    return [r.tokens for r in reqs], m.aggregate()


def _serve_port(pm, prompts, n=6, max_len=128, prefill_chunk=16,
                poison=False, **kw):
    eng = ServingEngine(pm, max_batch_slots=2, max_len=max_len, top_k=1,
                        prefill_chunk=prefill_chunk, device="cpu", **kw)
    if poison:
        # 1e9 dominates any softmax it reaches: a single stray read of
        # another slot's block or of the scratch sink would diverge
        eng.engine.reset()
        for buf in eng.engine.kbufs + eng.engine.vbufs:
            buf.fill_(1e9)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=n, greedy=True))
            for p in prompts]
    m = eng.run(max_steps=800)
    assert all(r.status == "done" for r in reqs)
    assert eng._alloc.free_count() == eng._alloc.capacity
    return [r.tokens for r in reqs], m.aggregate()


def test_block_allocator_same_ops_same_state():
    """One op sequence through both allocators: identical grants, free
    lists, refcounts, counters and double-free behaviour."""
    ja = JaxAllocator(num_blocks=9, block_size=8, block_nbytes=64)
    pa = BlockAllocator(num_blocks=9, block_size=8, block_nbytes=64)
    ops = [("alloc", 3), ("alloc", 2), ("ref", [1, 4]), ("deref", [2, 3]),
           ("alloc", 4), ("alloc", 1), ("deref", [1, 4, 5]),
           ("alloc", 2), ("deref", [1, 4])]
    for op, arg in ops:
        jr = getattr(ja, op)(arg)
        pr = getattr(pa, op)(arg)
        assert jr == pr, (op, arg)
        assert ja._free[0] == pa._free
        np.testing.assert_array_equal(ja._refs[0], pa._refs)
        assert (ja.allocs, ja.freed, ja.peak, ja.free_count()) == \
            (pa.allocs, pa.freed, pa.peak, pa.free_count())
    live = [b for b in range(1, 9) if pa.refcount(b) == 1][:1]
    with pytest.raises(RuntimeError, match="double free"):
        pa.deref(live * 2)
    with pytest.raises(RuntimeError, match="free block"):
        pa.ref(pa._free[-1:])


def test_greedy_tokens_match_jax_on_poisoned_pool(models):
    """Mixed-length concurrent greedy decode (block_size 16): the port on
    a 1e9-poisoned pool emits exactly the JAX engine's tokens."""
    jm, pm = models
    prompts = [[5, 9, 2], SYS + [21, 22, 23], [3, 3, 7, 1, 8, 2, 6],
               list(range(1, 40))]
    jt, ja = _serve_jax(jm, prompts, block_size=16, poison=True)
    pt, pa = _serve_port(pm, prompts, block_size=16, poison=True)
    assert pt == jt
    assert len({t for toks in pt for t in toks}) > 4   # not a copy loop
    for k in ("prefill_chunks", "decode_steps", "blocks_in_use_peak",
              "block_allocs", "block_frees", "prompt_tokens"):
        assert pa[k] == ja[k], k


def test_preemption_trace_matches_jax(models):
    """A pool too small for two full requests (7 allocatable blocks of
    8, each request needs 5): the newest request is preempted and
    re-prefilled; tokens, preemptions and the block peak equal the JAX
    engine's, and the tokens equal a roomy pool's."""
    jm, pm = models
    prompts = [list(range(1, 25)), list(range(30, 54))]
    kw = dict(n=12, max_len=64, block_size=8)
    jt, ja = _serve_jax(jm, prompts, num_blocks=8, **kw)
    pt, pa = _serve_port(pm, prompts, num_blocks=8, **kw)
    roomy, _ = _serve_port(pm, prompts, **kw)
    assert pt == jt == roomy
    assert pa["preemptions"] == ja["preemptions"] >= 1
    assert pa["blocks_in_use_peak"] == ja["blocks_in_use_peak"]
    assert pa["block_allocs"] == ja["block_allocs"]
    assert pa["prefill_chunks"] == ja["prefill_chunks"]


def test_lazy_allocation_counts_match_jax(models):
    """Blocks grow only as the committed length crosses block
    boundaries: deepest row 12 + 20 - 2 = 30 -> 4 blocks of 8."""
    jm, pm = models
    je = JaxEngine(jm, max_batch_slots=1, max_len=128, top_k=1,
                   prefill_chunk=16, block_size=8)
    je.submit(JaxRequest(prompt=[2] * 12, max_new_tokens=20, greedy=True))
    ja = je.run(max_steps=200).aggregate()
    pe = ServingEngine(pm, max_batch_slots=1, max_len=128, top_k=1,
                       prefill_chunk=16, block_size=8, device="cpu")
    r = pe.submit(Request(prompt=[2] * 12, max_new_tokens=20, greedy=True))
    pa = pe.run(max_steps=200).aggregate()
    assert r.status == "done" and r.finish_reason == "length"
    for k in ("blocks_in_use_peak", "block_allocs", "block_frees"):
        assert pa[k] == ja[k] == 4.0, k


@pytest.mark.parametrize("case", [
    dict(prompt=[1] * 40, max_new_tokens=30),          # over max_len
    dict(prompt=[1] * 20, max_new_tokens=10),          # pool alone-fit
    dict(prompt=[], max_new_tokens=4),                 # empty prompt
    dict(prompt=[1] * 64, max_new_tokens=1),           # no generation row
    dict(prompt=[1] * 4, max_new_tokens=0),
    dict(prompt=[1] * 4, top_k=0),
    dict(prompt=[1] * 4, top_p=1.5),
    dict(prompt=[1] * 4, temperature="hot"),
])
def test_submit_raises_the_same_errors(models, case):
    jm, pm = models
    je = JaxEngine(jm, max_batch_slots=1, max_len=64, top_k=1,
                   block_size=8, num_blocks=4)
    pe = ServingEngine(pm, max_batch_slots=1, max_len=64, top_k=1,
                       block_size=8, num_blocks=4, device="cpu")
    with pytest.raises(ValueError) as jerr:
        je.submit(JaxRequest(**case))
    with pytest.raises(ValueError) as perr:
        pe.submit(Request(**case))
    assert str(perr.value) == str(jerr.value)


def test_resubmit_and_dense_arena_are_rejected(models):
    """A resubmitted request is rejected; the dense arena serves since
    the port took it (tests/test_torch_dense.py), with its prefix cache
    (tests/test_torch_dense_prefix.py), and rejects a cache bound to a
    paged engine's pool."""
    _, pm = models
    pe = ServingEngine(pm, max_batch_slots=1, max_len=64, block_size=8,
                       device="cpu")
    r = pe.submit(Request(prompt=[1, 2], max_new_tokens=2, greedy=True))
    with pytest.raises(ValueError, match="already queued"):
        pe.submit(r)
    assert ServingEngine(pm, max_batch_slots=1, max_len=64,
                         device="cpu").paged is False
    assert ServingEngine(pm, max_batch_slots=1, max_len=64, device="cpu",
                         prefix_cache=PrefixCache(chunk_tokens=8)).paged \
        is False
    bound = PrefixCache(chunk_tokens=8)
    ServingEngine(pm, max_batch_slots=1, max_len=64, block_size=8,
                  device="cpu", prefix_cache=bound)
    with pytest.raises(ValueError, match="bound to a paged engine"):
        ServingEngine(pm, max_batch_slots=1, max_len=64, device="cpu",
                      prefix_cache=bound)


def test_default_device_raises_without_a_card(models):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, pm = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(pm, max_batch_slots=1, max_len=64, block_size=8)


def test_topk_topp_filter_matches_jax():
    rs = np.random.RandomState(3)
    logits = rs.randn(4, 50).astype(np.float32) * 2
    topks = np.asarray([0, 5, 0, 3], np.int32)
    topps = np.asarray([0.9, 1.0, 1.0, 0.5], np.float32)
    ref = np.asarray(jax_topk_topp(paddle.to_tensor(logits).value,
                                   paddle.to_tensor(topks).value,
                                   paddle.to_tensor(topps).value))
    out = apply_topk_topp(torch.from_numpy(logits),
                          torch.from_numpy(topks).long(),
                          torch.from_numpy(topps)).numpy()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_array_equal(out[~np.isinf(out)], ref[~np.isinf(ref)])


@pytest.mark.parametrize("top_p", [1.0, 0.9])
def test_sampler_draws_follow_the_filtered_softmax(models, top_p):
    """20000 draws of the port's sampler at temperature 0.8 (and top-p
    0.9) against the filtered softmax computed in numpy: chi-square at
    p > 1e-3, and no draw outside the nucleus."""
    _, pm = models
    eng = ServingEngine(pm, max_batch_slots=1, max_len=64, block_size=8,
                        device="cpu").engine
    V, n, temp = 12, 20000, 0.8
    logits = np.random.RandomState(4).randn(V).astype(np.float32)
    z = logits / temp
    order = np.argsort(-z)
    p_sorted = np.exp(z[order] - z.max())
    p_sorted /= p_sorted.sum()
    keep_sorted = (np.cumsum(p_sorted) - p_sorted) < top_p
    keep = np.zeros(V, bool)
    keep[order[keep_sorted]] = True
    p = np.where(keep, np.exp(z - z.max()), 0.0)
    p /= p.sum()
    gen = torch.Generator().manual_seed(5)
    u = torch.rand(n, generator=gen).numpy()
    toks = eng._sample(torch.from_numpy(np.tile(logits, (n, 1))),
                       np.full(n, temp, np.float32), np.zeros(n, bool), u,
                       np.zeros(n, np.int64),
                       np.full(n, top_p, np.float32)).numpy()
    counts = np.bincount(toks, minlength=V)
    assert counts[~keep].sum() == 0
    chi2 = (((counts[keep] - n * p[keep]) ** 2) / (n * p[keep])).sum()
    assert chi2 < stats.chi2.ppf(0.999, keep.sum() - 1)


def test_sampled_requests_keep_their_stream_through_preemption(models):
    """Each request's draws are keyed by its key data and the position
    of the token: the same seeded temperature requests give the same
    tokens whether or not the pool forces a preemption, and streaming
    delivers every token once with done on the last."""
    _, pm = models
    prompts = [list(range(1, 25)), list(range(30, 54))]

    def run(num_blocks):
        eng = ServingEngine(pm, max_batch_slots=2, max_len=64,
                            prefill_chunk=16, block_size=8,
                            num_blocks=num_blocks, seed=7, device="cpu")
        seen = []
        reqs = [eng.submit(Request(
            prompt=p, max_new_tokens=12, temperature=0.8, top_p=0.9,
            on_token=lambda r, t, d: seen.append((r.id, t, d))))
            for p in prompts]
        agg = eng.run(max_steps=400).aggregate()
        return [r.tokens for r in reqs], agg, seen

    roomy, _, seen = run(None)
    tight, agg, _ = run(8)
    assert agg["preemptions"] >= 1
    assert tight == roomy
    assert [t for rid, t, _ in seen if rid == 0] == roomy[0]
    assert [d for rid, _, d in seen if rid == 1][-1] is True


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_a_card_or_the_repo(where, tmp_path):
    """chip_smoke.py exits non-zero and prints no result on a host with
    no CUDA device, and in a directory holding only itself."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":
        (tmp_path / script.name).write_bytes(script.read_bytes())
        script, cwd = tmp_path / script.name, tmp_path
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_port_never_imports_jax_or_the_jax_package():
    """Every file of paddle_tpu_torch/, chip_smoke.py, the fault
    checkers and the variant scripts: no import of jax or paddle_tpu (the
    card's host has no JAX)."""
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "k1_fault_check.py",
              REPO / "k3_fault_check.py", REPO / "k3_variants.py",
              REPO / "k4_fault_check.py", REPO / "k4_variants.py",
              REPO / "k5_fault_check.py", REPO / "k5_variants.py",
              REPO / "k2_fault_check.py", REPO / "k2_variants.py",
              REPO / "k45_f32_fault_check.py", REPO / "k45_f32_variants.py",
              REPO / "offload_fault_check.py",
              REPO / "fused_fault_check.py", REPO / "mesh_gang.py",
              REPO / "pipe_gang.py", REPO / "gloo_probe.py"]
    assert len(files) > 10
    for module in ("observability/__init__.py", "observability/metrics.py",
                   "observability/ops_plane.py", "inference/program_set.py",
                   "inference/fleet/engine_proc.py",
                   "inference/frontend/server.py",
                   "inference/adapter_pool.py", "inference/constrain.py",
                   "ops/creation.py", "ops/math.py", "ops/reduction.py",
                   "ops/manipulation.py", "core/tensor.py",
                   "nn/initializer.py", "nn/functional/activation.py",
                   "nn/layers/activation.py", "nn/layers/loss.py",
                   "nn/layers/container.py", "nn/layers/transformer.py",
                   "models/bert.py", "models/ernie.py", "regularizer.py",
                   "inference/adaptive.py", "optimizer/optimizers.py",
                   "distributed/fleet/meta_optimizers.py",
                   "distributed/fleet/__init__.py", "incubate/asp.py",
                   "incubate/__init__.py", "core/place.py",
                   "core/dtype.py", "core/memory.py", "core/autograd.py",
                   "device/__init__.py", "device/cuda.py",
                   "framework/__init__.py", "framework/io.py",
                   "incubate/extras.py", "incubate/nn/__init__.py",
                   "incubate/nn/fused_transformer.py",
                   "incubate/distributed/__init__.py",
                   "incubate/distributed/models/__init__.py",
                   "incubate/distributed/models/moe/__init__.py",
                   "incubate/distributed/models/moe/gate.py",
                   "incubate/distributed/models/moe/moe_layer.py",
                   "incubate/distributed/models/moe/grad_clip.py",
                   "distributed/env.py", "distributed/collective.py",
                   "distributed/topology.py", "distributed/compat.py",
                   "distributed/parallel.py", "distributed/launch/__init__.py",
                   "distributed/launch/__main__.py",
                   "distributed/launch/main.py",
                   "distributed/meta_parallel/mp_layers.py",
                   "distributed/meta_parallel/random.py"):
        assert REPO / "paddle_tpu_torch" / module in files
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "paddle_tpu"):
                    bad.append(f"{f.relative_to(REPO)}: {name}")
    assert not bad, bad
