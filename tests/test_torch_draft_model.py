"""``DraftModelDrafter`` of the port against the JAX package's.

The target and a 1-layer draft model carry the same weights in both
packages (copied by name, dropout off, fp32 matmuls on both sides):

- ``admit`` + ``propose`` (the draft arena's prefill and k greedy steps
  on its private dense engine) give the reference drafter's proposals
  exactly, at full length and under ``set_draft_len`` (fewer steps, the
  rest padded with the last draft);
- ``ServingEngine(spec=DraftModelDrafter(...))`` behind a dense and
  behind a paged target (``tests/test_speculative.py:113``, ``:209``):
  greedy tokens equal to the JAX speculative engine's and to plain
  greedy decoding, the ``spec_*`` counts equal to the JAX engine's;
- the draft model being the target itself accepts ``accept_cap = k - 1``
  drafts at every verify (the draft arena mirrors the target's commits
  exactly);
- ``accept_cap``, ``k < 2`` refused, ``release()`` freeing the draft
  arena and ``begin`` keeping it for the same geometry.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.inference.speculative import \
    DraftModelDrafter as JaxDraftDrafter
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

from paddle_tpu_torch.inference import (DraftModelDrafter, Request,
                                        ServingEngine)
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from test_torch_serving import models  # noqa: F401  (fixture)

MIXED_PROMPTS = [[1, 2, 3, 4] * 5, [3, 3, 7, 1, 8, 2, 6], [9] * 11,
                 [10, 20, 30, 40, 50]]      # tests/test_speculative.py


@pytest.fixture(scope="module")
def drafts():
    """A 1-layer draft of gpt_tiny's vocabulary in both packages, with
    the same random weights: a bad predictor of the target."""
    paddle.seed(777)
    cfg = jax_gpt_tiny()
    cfg.num_layers = 1
    jd = JaxGPT(cfg)
    rs = np.random.RandomState(7)
    state = {k: (rs.randn(*v.shape) * (0.3 if len(v.shape) == 2 else 0.1)
                 + (1.0 if ".ln_" in k and k.endswith("weight") else 0.0)
                 ).astype(np.float32) for k, v in jd.state_dict().items()}
    jd.set_state_dict(state)
    pcfg = gpt_tiny()
    pcfg.num_layers = 1
    pd = GPTForCausalLM(pcfg, device="cpu")
    pd.set_state_dict(state)
    return jd, pd


def test_admit_and_propose_match_the_reference(drafts):
    jd, pd = drafts
    j, p = JaxDraftDrafter(jd, k=4, prefill_chunk=16), \
        DraftModelDrafter(pd, k=4, prefill_chunk=16)
    for d in (j, p):
        d.begin(3, 64)
    ids = np.zeros((2, 21), np.int32)
    ids[0] = np.arange(3, 24)
    ids[1, :6] = [8, 1, 8, 1, 5, 5]
    slots, plens = np.asarray([2, 0], np.int32), np.asarray([21, 6],
                                                            np.int32)
    for d in (j, p):
        d.admit(slots, ids, plens)
    pending = np.asarray([[7], [0], [4]])
    t = np.asarray([6, 0, 21], np.int32)
    want = np.asarray(j.propose(None, pending, t))
    got = p.propose(None, pending, t)
    assert got.dtype == np.int32 and got.shape == (3, 4)
    np.testing.assert_array_equal(got[slots], want[slots])
    assert len(set(got[slots].ravel().tolist())) > 2
    # k_eff 1: two draft steps, the last two columns padded
    calls = []
    step = p.engine.step
    p.engine.step = lambda *a, **kw: calls.append(1) or step(*a, **kw)
    for d in (j, p):
        d.set_draft_len(1)
    want = np.asarray(j.propose(None, pending, t))
    got = p.propose(None, pending, t)
    np.testing.assert_array_equal(got[slots], want[slots])
    assert len(calls) == 2 and (got[:, 2:] == got[:, 1:2]).all()
    with pytest.raises(ValueError, match="k_eff"):
        p.set_draft_len(5)


def _serve_port(pm, spec, prompts, n, **kw):
    eng = ServingEngine(pm, max_batch_slots=2, max_len=96, top_k=1,
                        prefill_chunk=16, spec=spec, device="cpu", **kw)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=n, greedy=True))
            for p in prompts]
    agg = eng.run(max_steps=400).aggregate()
    assert all(r.status == "done" for r in reqs)
    return [r.tokens for r in reqs], agg


@pytest.mark.parametrize("block_size", [None, 16], ids=["dense", "paged"])
def test_draft_model_serving_matches_jax_and_plain_greedy(models, drafts,
                                                          block_size):
    jm, pm = models
    jd, pd = drafts
    prompts, n = MIXED_PROMPTS[:3], 8
    kw = {} if block_size is None else dict(block_size=block_size)
    got, agg = _serve_port(pm, DraftModelDrafter(pd, k=3), prompts, n, **kw)
    jeng = JaxEngine(jm, max_batch_slots=2, max_len=96, top_k=1,
                     prefill_chunk=16, spec=JaxDraftDrafter(jd, k=3), **kw)
    jreqs = [jeng.submit(JaxRequest(prompt=p, max_new_tokens=n,
                                    greedy=True)) for p in prompts]
    jagg = jeng.run(max_steps=400).aggregate()
    plain, _ = _serve_port(pm, None, prompts, n, **kw)
    assert got == [r.tokens for r in jreqs] == plain
    for k in ("spec_verify_steps", "spec_mean_accepted_per_step",
              "spec_mean_tokens_per_step", "prefill_chunks"):
        assert agg[k] == jagg[k], k


def test_self_draft_accepts_up_to_the_cap(models):
    """The target as its own draft: every verify accepts accept_cap =
    k - 1 drafts, so the draft arena held the committed K/V exactly."""
    _, pm = models
    prompts = MIXED_PROMPTS
    got, agg = _serve_port(pm, DraftModelDrafter(pm, k=4), prompts, 9,
                           block_size=16)
    plain, _ = _serve_port(pm, None, prompts, 9, block_size=16)
    assert got == plain
    assert agg["spec_mean_accepted_per_step"] == 3.0
    assert agg["spec_mean_tokens_per_step"] > 2.5


def test_drafter_interface_and_release(drafts):
    _, pd = drafts
    with pytest.raises(ValueError, match="k >= 2"):
        DraftModelDrafter(pd, k=1)
    d = DraftModelDrafter(pd, k=5)
    assert (d.accept_cap, d.k_eff, d.engine) == (4, 5, None)
    d.begin(2, 64)
    eng = d.engine
    assert eng.paged is False and (eng.b, eng.max_len) == (2, 64)
    d.admit(np.asarray([1], np.int32), np.asarray([[4, 5, 6]]),
            np.asarray([3], np.int32))
    assert eng.kbufs is not None and eng.kbufs[0].shape == (2, 64, 4, 16)
    d.release()
    assert eng.kbufs is None and eng.vbufs is None
    d.begin(2, 64)
    assert d.engine is eng                # the same geometry: kept
    d.begin(2, 128)
    assert d.engine is not eng and d.engine.max_len == 128
    d.release()
    DraftModelDrafter(pd).release()       # never begun: nothing to free
