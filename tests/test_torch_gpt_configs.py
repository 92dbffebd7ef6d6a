"""The port's GPT configs against the reference's
(``paddle_tpu/models/gpt.py``), and ``gpt_tiny8`` served by both.

Every config (``gpt_tiny``, ``gpt_tiny8``, ``gpt_moe_tiny``,
``gpt_moe_1p3b``, ``gpt2_small``, ``gpt3_1p3b``, ``gpt3_13b``) must equal
the reference's field for field, over every field of the port's
``GPTConfig`` (the MoE fields included), with the same ``num_params``
(the dense count for a MoE config, as the reference counts it). Then ``gpt_tiny8`` (8 heads of 8, the head dim the
card's K4 and K5 take at run time since this slice) serves greedy
requests through the paged engine of each framework on the CPU (the
port's plain versions, JAX's paged attention) from the same weights:
the tokens must be equal, exactly (both fp32).
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import gpt as ref_gpt

from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.models import GPTForCausalLM
from paddle_tpu_torch.models import gpt as port_gpt

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ["gpt_tiny", "gpt_tiny8", "gpt_moe_tiny", "gpt_moe_1p3b",
           "gpt2_small", "gpt3_1p3b", "gpt3_13b"]
# the reference's configs the port lacks, with the reason (none left)
ABSENT_CONFIGS = {}


@pytest.mark.parametrize("name", CONFIGS)
def test_config_equals_the_reference_field_for_field(name):
    mine = getattr(port_gpt, name)()
    theirs = getattr(ref_gpt, name)()
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert mine.ffn_size == theirs.ffn_size
    assert mine.num_params() == theirs.num_params()


def test_every_reference_config_is_ported_or_stated_absent():
    """Each config function of the reference's models/gpt.py (a function
    of no parameters returning a GPTConfig) is in the port's, or in
    ABSENT_CONFIGS; none of those is in the port."""
    tree = ast.parse((ROOT / "paddle_tpu/models/gpt.py").read_text())
    ref_configs = {n.name for n in tree.body
                   if isinstance(n, ast.FunctionDef) and n.returns is not None
                   and ast.unparse(n.returns) == "GPTConfig"}
    assert set(CONFIGS) <= ref_configs
    assert ref_configs - set(CONFIGS) == set(ABSENT_CONFIGS)
    for name in ABSENT_CONFIGS:
        assert not hasattr(port_gpt, name)


def test_head_dims_of_the_configs():
    dims = {n: getattr(port_gpt, n)().hidden_size
            // getattr(port_gpt, n)().num_heads for n in CONFIGS}
    assert dims == {"gpt_tiny": 16, "gpt_tiny8": 8, "gpt_moe_tiny": 16,
                    "gpt_moe_1p3b": 128, "gpt2_small": 64,
                    "gpt3_1p3b": 128, "gpt3_13b": 128}
    from paddle_tpu_torch.ops.kernels.flash_attention import HEAD_DIMS

    assert set(dims.values()) <= set(HEAD_DIMS)


def test_gpt_tiny8_serves_the_jax_engines_tokens():
    ref.seed(8)
    jm = ref.models.GPTForCausalLM(ref_gpt.gpt_tiny8())
    rs = np.random.RandomState(8)
    state = {}
    for k, v in jm.state_dict().items():
        a = rs.randn(*v.shape).astype(np.float32) * (0.3 if v.ndim == 2
                                                     else 0.1)
        if ".ln_" in k and k.endswith("weight"):
            a += 1.0
        state[k] = a
    jm.set_state_dict(state)
    pm = GPTForCausalLM(port_gpt.gpt_tiny8(), device="cpu")
    pm.set_state_dict(state)
    prompts = [[5, 9, 2], [7, 3, 9, 11, 2, 5, 8, 4] * 3, list(range(1, 30))]
    jeng = JaxEngine(jm, max_batch_slots=2, max_len=64, top_k=1,
                     prefill_chunk=16, block_size=16)
    jreqs = [jeng.submit(JaxRequest(prompt=p, max_new_tokens=6,
                                    greedy=True)) for p in prompts]
    jeng.run(max_steps=400)
    peng = ServingEngine(pm, max_batch_slots=2, max_len=64, top_k=1,
                         prefill_chunk=16, block_size=16, device="cpu")
    preqs = [peng.submit(Request(prompt=p, max_new_tokens=6, greedy=True))
             for p in prompts]
    peng.run(max_steps=400)
    assert all(r.status == "done" for r in jreqs + preqs)
    assert [r.tokens for r in preqs] == [r.tokens for r in jreqs]
    assert len({t for r in preqs for t in r.tokens}) > 3
