"""The port's bf16 serving path against the JAX package's, on the CPU.

A bf16 model serves at its weight dtype in both packages
(``kv_cache_spec()["dtype"]``): bf16 pools, or int8 code pools with
``kv_dtype="int8"``, and chunk prefill with bf16 queries, the path whose
kernel on the card is K5's tensor-core body. Here both engines run the
same weights (copied by name, then cast to bf16) on the same greedy
traces. The two frameworks round bf16 at other places (their matmuls
accumulate and round differently): on this model's no-cache forward
their logits differ by up to ~0.4 of ~8, and each lies as far from an
fp32 evaluation of the same bf16 weights as the other. So greedy tokens
are held to the reference up to rounding: each request's tokens equal
the JAX engine's, or they agree up to a step where the JAX model's top-2
logits, from a teacher-forced no-cache forward of the shared prefix, lie
closer than what rounding moves them: twice the largest difference of
the two packages' no-cache logits at that step, plus two bf16 units in
the last place of the top one. The no-cache forward does not run the
serving path (the paged pools, the commit, the chunk prefill), so a
fault there shows as a divergence at a clear choice. And the port's
tokens agree with the JAX model's teacher-forced no-cache argmax at 0.9
of the steps or more, the reference's int8 contract
(``tests/test_paged_kv.py:502``). The int8 runs patch the reference's
int8 position read as ``tests/test_torch_int8.py`` does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from test_torch_int8 import _read_jax_positions_from_t

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

SYS = [7, 3, 9, 11, 2, 5, 8, 4] * 4          # 32-token shared prefix
PROMPTS = [SYS + [1, 2, 3], SYS + [4, 5], list(range(40, 90)),
           [17] * 5 + list(range(3, 60)), list(range(100, 103))]
NEAR_TIE = 2.0 ** -6


@pytest.fixture(scope="module")
def models():
    """Both models in bf16 with the same random weights, wide enough
    that greedy decoding produces varied tokens."""
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
    jm.bfloat16()
    jm.eval()
    pm = GPTForCausalLM(gpt_tiny(), device="cpu", dtype=torch.bfloat16)
    pm.set_state_dict(state)
    pm.eval()
    return jm, pm


def _serve(engine_cls, request_cls, model, kv_dtype, **kw):
    eng = engine_cls(model, max_batch_slots=2, max_len=128, top_k=1,
                     prefill_chunk=16, block_size=16, kv_dtype=kv_dtype,
                     **kw)
    reqs = [eng.submit(request_cls(prompt=p, max_new_tokens=12, greedy=True))
            for p in PROMPTS]
    eng.run()
    assert all(r.status == "done" for r in reqs)
    return [r.tokens for r in reqs]


_LOGITS = {}
# the JAX no-cache forwards run at one padded length, under the flash
# gate's 128 (the reference's plain attention), so each eager op of the
# forward compiles once for the module; the model is causal, so the
# padding after a sequence changes none of its logits
PAD = 127


def _jax_logits(jm, ids):
    """The JAX model's no-cache logits over ``ids`` (one sequence), run
    once per sequence: both cases of a test and the near-tie checks ask
    for the same sequences."""
    key = (id(jm), tuple(ids))
    if key not in _LOGITS:
        arr = np.zeros((1, PAD), np.int64)
        arr[0, :len(ids)] = ids
        _LOGITS[key] = np.asarray(jm(Tensor(jnp.asarray(arr))).value,
                                  np.float32)[0, :len(ids)]
    return _LOGITS[key]


def _near_tie(jm, pm, ids):
    """The JAX model's top-2 logits after ``ids`` (a no-cache forward),
    and their rounding limit: twice the largest difference from the
    port's no-cache logits, plus two bf16 units of the top one."""
    jl = _jax_logits(jm, ids)[-1]
    with torch.no_grad():
        pl = pm(torch.tensor([ids])).float().numpy()[0, -1]
    top = np.sort(jl)[::-1]
    limit = 2 * float(np.abs(jl - pl).max()) + NEAR_TIE * abs(top[0])
    return float(top[0] - top[1]), limit


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_bf16_greedy_tokens_match_jax_up_to_rounding(models, kv_dtype,
                                                     monkeypatch):
    jm, pm = models
    assert pm.kv_cache_spec()["dtype"] == torch.bfloat16
    if kv_dtype is not None:
        _read_jax_positions_from_t(monkeypatch)
    want = _serve(JaxEngine, JaxRequest, jm, kv_dtype)
    got = _serve(ServingEngine, Request, pm, kv_dtype, device="cpu")
    agree = total = 0
    for prompt, w, g in zip(PROMPTS, want, got):
        if w != g:
            step = next(i for i, (a, b) in enumerate(zip(w, g)) if a != b)
            gap, limit = _near_tie(jm, pm, prompt + w[:step])
            assert gap <= limit, (prompt[:4], step, w, g, gap, limit)
        arg = _jax_logits(jm, prompt + g[:-1])[len(prompt) - 1:].argmax(-1)
        agree += int((arg == np.asarray(g)).sum())
        total += len(g)
    assert agree >= 0.9 * total, (agree, total)
