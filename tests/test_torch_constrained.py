"""Constrained decoding and the score and embed request kinds in the port
(``paddle_tpu_torch.inference.serving``) against the JAX package, on
gpt_tiny with the same weights.

- A mixed batch of grammars (regex, token allow-list, JSON schema, JSON
  object, a regex that dead-ends, one that ends on EOS) and an
  unconstrained request: the port's greedy tokens, finish reasons and
  constrained counters equal the JAX engine's. The constrained tokens
  also equal a post-hoc masked replay of the port's eager model, and a
  k = 4 speculative engine commits the same tokens. Sampled constrained
  tokens are all legal.
- ``score`` logprobs and ``embed`` hidden states equal the JAX engine's
  within ``TOL`` (absolute; fp32 summation order on both sides) and an
  eager forward's log-softmax; both kinds retire ``complete`` without a
  decode step, and the argument signatures stay at 2 across the mix.
- The ingest's ``/v1/score`` and ``/v1/embed`` answer 200 with the
  engine's numbers, and the fleet router places a second request for an
  adapter on the engine that served the first
  (``fleet_adapter_locality_total``).
- The reference's prefix cache splices a cached prefix into a score
  request, whose spliced positions then get no logprobs; the port
  computes them.

Every HTTP call and wait has an explicit timeout.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import constrain as jc
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxCache
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny

from paddle_tpu_torch.inference import PrefixCache, Request, ServingEngine
from paddle_tpu_torch.inference import constrain as pc
from paddle_tpu_torch.inference.adapter_pool import AdapterPool
from paddle_tpu_torch.inference.fleet import EngineRef, FleetRouter
from paddle_tpu_torch.inference.frontend import FrontDoor
from paddle_tpu_torch.inference.speculative import NgramDrafter
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

T = 30              # seconds: every HTTP call and wait below
TOL = 1e-4          # score and embed, absolute, against the JAX engine
ENGINE_KW = dict(max_batch_slots=2, max_len=64, top_k=1, prefill_chunk=16,
                 block_size=16, seed=7)
DIGITS = list(range(48, 58))
# (prompt, response_format, eos_id): digits, an allow-list, a schema, a
# JSON object, "ab" without EOS (dead end after two tokens) and with one
# (ends on EOS), and an unconstrained request
MIX = [
    ([5, 9, 2], {"type": "regex", "pattern": "[0-9]+"}, None),
    ([3, 3, 7, 1], {"type": "allowed_tokens", "tokens": DIGITS}, None),
    ([40, 41], {"type": "json_schema", "schema": {"type": "integer"}}, 1),
    ([123, 34], {"type": "json_object"}, 1),
    ([97], {"type": "regex", "pattern": "ab"}, None),
    ([97], {"type": "regex", "pattern": "ab"}, 1),
    ([3, 3, 7, 1, 8, 2, 6], None, None),
]
CON_KEYS = ("constrained_tokens", "mask_builds", "mask_in_window_fraction",
            "mask_fallback_syncs", "constraint_dead_ends")


def _state():
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
    return state


@pytest.fixture(scope="module")
def models():
    state = _state()
    paddle.seed(1234)
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict(state)
    pm = GPTForCausalLM(gpt_tiny(), device="cpu")
    pm.set_state_dict(state)
    pm.eval()
    return state, jm, pm


def _mix_requests(cls, n=6):
    return [cls(prompt=list(p), max_new_tokens=n, greedy=True,
                response_format=rf, eos_id=eos) for p, rf, eos in MIX]


@pytest.fixture(scope="module")
def jax_mix(models):
    _, jm, _ = models
    eng = JaxEngine(jm, **ENGINE_KW)
    reqs = [eng.submit(r) for r in _mix_requests(JaxRequest)]
    m = eng.run(max_steps=400)
    agg = m.aggregate()
    return ([(r.tokens, r.finish_reason) for r in reqs],
            {k: agg[k] for k in CON_KEYS},
            eng.telemetry.registry.snapshot()[
                "serving_constraint_dead_ends_total"])


def _serve_mix(pm, **kw):
    eng = ServingEngine(pm, device="cpu", **dict(ENGINE_KW, **kw))
    reqs = [eng.submit(r) for r in _mix_requests(Request)]
    m = eng.run(max_steps=400)
    assert all(r.status == "done" for r in reqs)
    return eng, reqs, m.aggregate()


def test_constrained_mix_equals_jax(models, jax_mix):
    _, _, pm = models
    eng, reqs, agg = _serve_mix(pm)
    assert [(r.tokens, r.finish_reason) for r in reqs] == jax_mix[0]
    assert {k: agg[k] for k in CON_KEYS} == jax_mix[1]
    assert eng.telemetry.registry.snapshot()[
        "serving_constraint_dead_ends_total"] == jax_mix[2] == 1.0
    reasons = [r.finish_reason for r in reqs]
    assert reasons[4] == "constraint_dead_end" and reasons[5] == "eos"
    assert eng.executable_count() == 2
    assert eng.telemetry.recompile_events() == 0
    # every retired lane is back on the identity row
    assert (eng.engine.vocab_masks == -1).all()


def test_constrained_greedy_equals_posthoc_masked_replay(models, jax_mix):
    """Eager logits of the port's model, the automaton's row, argmax:
    the engine's constrained tokens, request for request."""
    _, _, pm = models
    for (prompt, rf, eos), (toks, _) in zip(MIX, jax_mix[0]):
        if rf is None:
            continue
        cs = pc.ConstraintState(pc.from_response_format(rf).compile(256, eos))
        seq, out = list(prompt), []
        with torch.no_grad():
            for _ in range(6):
                logits = pm(torch.tensor([seq]))[0, -1].double().numpy()
                row = cs.mask_row()
                legal = np.array([pc.token_in_row(row, t)
                                  for t in range(256)])
                logits[~legal] = -np.inf
                t = int(np.argmax(logits))
                out.append(t)
                seq.append(t)
                nxt = cs.advance(t)
                if (eos is not None and t == eos) or nxt is None or \
                        not nxt.any():
                    break
        assert toks == out, (rf, toks, out)


def test_speculative_verify_commits_the_constrained_tokens(models, jax_mix):
    _, _, pm = models
    eng, reqs, agg = _serve_mix(pm, spec=NgramDrafter(k=4))
    assert [(r.tokens, r.finish_reason) for r in reqs] == jax_mix[0]
    assert agg["spec_verify_steps"] > 0
    assert agg["constraint_dead_ends"] == 1.0
    assert eng.executable_count() == 2
    assert (eng.engine.verify_masks == -1).all()


def test_sampled_constrained_tokens_are_legal(models):
    _, _, pm = models
    eng = ServingEngine(pm, device="cpu", **dict(ENGINE_KW, top_k=None))
    specs = [{"type": "regex", "pattern": "[a-f]{3}[0-9]+"},
             {"type": "json_schema", "schema": {"type": "boolean"}}]
    reqs = [eng.submit(Request(prompt=[5, 9, 2], max_new_tokens=8,
                               temperature=1.3, seed=s, response_format=rf,
                               eos_id=1))
            for s in range(3) for rf in specs]
    eng.run(max_steps=400)
    for r in reqs:
        cs = jc.ConstraintState(jc.from_response_format(
            r.response_format).compile(256, 1))
        for t in r.tokens:
            assert jc.token_in_row(cs.mask_row(), t), (r.tokens, t)
            if t == 1:
                break
            cs.advance(t)
    assert eng.executable_count() == 2


# -- score and embed ---------------------------------------------------------

SCORE_PROMPTS = [list(range(3, 40)), [3, 3, 7, 1, 8, 2, 6]]


def test_score_and_embed_equal_jax_and_eager(models):
    """37- and 7-token prompts at chunk 16: multi-chunk scores, the
    final chunk's hidden state."""
    _, jm, pm = models
    outs = []
    for eng_cls, req_cls, kw in ((JaxEngine, JaxRequest, {}),
                                 (ServingEngine, Request,
                                  {"device": "cpu"})):
        eng = eng_cls(jm if eng_cls is JaxEngine else pm,
                      **dict(ENGINE_KW, **kw))
        reqs = [eng.submit(req_cls(prompt=p, kind=k))
                for p in SCORE_PROMPTS for k in ("score", "embed")]
        gen = eng.submit(req_cls(prompt=[5, 9, 2], max_new_tokens=4,
                                 greedy=True))
        m = eng.run(max_steps=400)
        assert all(r.finish_reason == "complete" and r.tokens == []
                   for r in reqs)
        outs.append((reqs, gen.tokens, m.aggregate(), eng))
    (jr, jgen, _, _), (pr, pgen, pagg, peng) = outs
    assert pgen == jgen
    worst = 0.0
    for j, p in zip(jr, pr):
        if p.kind == "score":
            assert len(p.logprobs) == len(p.prompt) - 1
            d = np.abs(np.asarray(p.logprobs) - np.asarray(j.logprobs))
        else:
            assert p.embedding.shape == (gpt_tiny().hidden_size,)
            d = np.abs(p.embedding - np.asarray(j.embedding))
        worst = max(worst, float(d.max()))
    assert worst < TOL, worst
    # against an eager forward: log-softmax gathered at the next tokens,
    # and the final hidden state at the last prompt position
    for r in pr:
        with torch.no_grad():
            logits, hidden = pm(torch.tensor([r.prompt]), output_hidden=True)
        if r.kind == "score":
            lp = torch.log_softmax(logits[0, :-1].double(), -1)
            want = lp.gather(-1, torch.tensor(r.prompt[1:])[:, None])[:, 0]
            np.testing.assert_allclose(r.logprobs, want.numpy(), atol=TOL)
        else:
            np.testing.assert_allclose(r.embedding, hidden[0, -1].numpy(),
                                       atol=TOL)
    # the batch kinds never dispatched a decode step: 4 steps of the
    # generate request are all the decode steps there were
    assert pagg["decode_steps"] == 3.0
    assert peng.executable_count() == 2
    assert peng.telemetry.recompile_events() == 0


def test_kind_and_grammar_rejections_counted_as_the_reference(models):
    _, jm, pm = models
    bad = [dict(prompt=[1, 2], kind="classify"),
           dict(prompt=[1, 2], kind="score",
                response_format={"type": "json_object"}),
           dict(prompt=[1, 2], response_format={"type": "regex",
                                                "pattern": "(["}),
           dict(prompt=[1, 2], response_format={"type": "allowed_tokens",
                                                "tokens": [999]})]
    counts = []
    for eng, cls in ((JaxEngine(jm, **ENGINE_KW), JaxRequest),
                     (ServingEngine(pm, device="cpu", **ENGINE_KW),
                      Request)):
        for kw in bad:
            with pytest.raises(ValueError):
                eng.submit(cls(max_new_tokens=2, **kw))
        counts.append(eng.telemetry.registry.snapshot().get(
            "serving_constraint_rejected_total"))
    assert counts[0] == counts[1] == 3.0


def test_reference_prefix_cache_drops_a_score_requests_spliced_positions(
        models):
    """The same prompt scored twice with a prefix cache: the reference
    splices the first request's cached 32-token prefix into the second,
    which then returns logprobs for its suffix only. The port runs every
    position of a score request and returns them all."""
    _, jm, pm = models
    prompt = list(range(3, 40))
    got = []
    for eng in (JaxEngine(jm, prefix_cache=JaxCache(chunk_tokens=16),
                          **ENGINE_KW),
                ServingEngine(pm, prefix_cache=PrefixCache(chunk_tokens=16),
                              device="cpu", **ENGINE_KW)):
        cls = JaxRequest if isinstance(eng, JaxEngine) else Request
        first = eng.submit(cls(prompt=prompt, kind="score"))
        eng.run(max_steps=200)
        second = eng.submit(cls(prompt=prompt, kind="score"))
        eng.run(max_steps=200)
        got.append((first.logprobs, second.logprobs))
    (j1, j2), (p1, p2) = got
    assert len(j1) == len(prompt) - 1
    assert len(j2) < len(j1), "the reference's fault did not show"
    assert p1 == p2 and len(p2) == len(prompt) - 1
    np.testing.assert_allclose(p1, j1, atol=TOL)



def test_reference_migration_drops_the_grammar(models):
    """A live request under a digits-only allow-list moves to a peer
    engine mid-flight. The port's snapshot carries ``response_format``:
    the peer recompiles the grammar, re-walks it over the committed
    tokens and ends on the uninterrupted run's tokens, all digits. The
    reference's snapshot drops it (``serving.py:5748-5766``), so its
    peer decodes unconstrained and emits tokens outside the grammar."""
    _, jm, pm = models
    prompt = list(range(3, 20))             # one full block
    rf = {"type": "allowed_tokens", "tokens": DIGITS}
    kw = dict(ENGINE_KW, host_tier_blocks=8)
    got = []
    for make, cls in ((lambda: JaxEngine(jm, **kw), JaxRequest),
                      (lambda: ServingEngine(pm, device="cpu", **kw),
                       Request)):
        whole = make()
        full = whole.submit(cls(prompt=prompt, max_new_tokens=12,
                                greedy=True, response_format=rf))
        whole.run(max_steps=400)
        src = make()
        r = src.submit(cls(prompt=prompt, max_new_tokens=12, greedy=True,
                           response_format=rf))
        src.run(max_steps=4)
        before = list(r.tokens)
        assert 2 <= len(before) < 12
        peer = make()
        r2 = peer.restore_request(src.migrate_out_request(r.id))
        peer.run(max_steps=400)
        got.append((list(full.tokens), before, list(r2.tokens),
                    r2._restore_outcome))
    (jfull, jbefore, jtoks, _), (pfull, pbefore, ptoks, outcome) = got
    assert pfull == jfull and set(pfull) <= set(DIGITS)
    assert pbefore == jbefore == pfull[:len(pbefore)]
    assert ptoks == pfull and outcome == "swap_in"
    assert not set(jtoks) <= set(DIGITS), \
        "the reference's fault did not show"
    # a grammar given as an object, not the wire dict, has no form the
    # snapshot's JSON header can carry: refused, typed, and still live
    eng = ServingEngine(pm, device="cpu", **kw)
    r = eng.submit(Request(prompt=prompt, max_new_tokens=12, greedy=True,
                           response_format=pc.AllowedTokens(DIGITS)))
    eng.run(max_steps=4)
    with pytest.raises(ValueError, match="cannot carry"):
        eng.migrate_out_request(r.id)
    eng.run(max_steps=400)
    assert r.finish_reason == "length" and r.tokens == pfull


# -- the HTTP surfaces and the router ----------------------------------------

def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=T) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _door(state, pool=None):
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    m.set_state_dict(state)
    m.eval()
    return FrontDoor(m, ingest_port=0, ops_port=0, adapter_pool=pool,
                     **ENGINE_KW, device="cpu").start()


def test_ingest_score_and_embed_answer_with_the_engines_numbers(models):
    state, _, pm = models
    prompt = SCORE_PROMPTS[1]
    eng = ServingEngine(pm, device="cpu", **ENGINE_KW)
    s = eng.submit(Request(prompt=prompt, kind="score"))
    e = eng.submit(Request(prompt=prompt, kind="embed"))
    eng.run(max_steps=100)
    door = _door(state)
    try:
        code, body = _post(door.ingest.url + "/v1/score",
                           json.dumps({"prompt": prompt}).encode())
        assert code == 200 and body["prompt_len"] == len(prompt)
        np.testing.assert_allclose(body["logprobs"], s.logprobs, atol=1e-6)
        code, body = _post(door.ingest.url + "/v1/embed",
                           json.dumps({"prompt": prompt}).encode())
        assert code == 200
        np.testing.assert_allclose(body["embedding"], e.embedding,
                                   atol=1e-6)
        code, body = _post(door.ingest.url + "/v1/submit", json.dumps(
            {"prompt": [5, 9, 2], "max_new_tokens": 4, "sampling": {
                "greedy": True, "response_format": {
                    "type": "regex", "pattern": "[0-9]+"}}}).encode())
        assert code == 200
        # the constrained submit streams digits only
        deadline = time.monotonic() + T
        while time.monotonic() < deadline:
            with urllib.request.urlopen(
                    door.ingest.url + f"/v1/requests/{body['id']}",
                    timeout=T) as r:
                st = json.loads(r.read())
            if st["status"] == "done":
                break
            time.sleep(0.01)
        assert st["status"] == "done" and len(st["tokens"]) == 4
        assert all(48 <= t <= 57 for t in st["tokens"])
    finally:
        door.stop(drain=True)
    assert door.engine.audit()["leaked_blocks"] == 0


def test_router_places_an_adapter_on_the_engine_that_served_it(models):
    state, _, _ = models
    cfg = gpt_tiny()
    pools = {}
    doors = {}
    for name in ("E1", "E2"):
        pools[name] = AdapterPool(2, 4, cfg.num_layers, cfg.hidden_size,
                                  cfg.ffn_size)
        pools[name].register("a", pools[name].random_weights(
            seed=10, scale=0.2))
        doors[name] = _door(state, pools[name])
    router = FleetRouter([EngineRef(n, d.ingest.url, d.ops.url)
                          for n, d in doors.items()], seed=5)
    try:
        placed = []
        for _ in range(3):
            h = router.submit([5, 9, 2, 11], max_new_tokens=4,
                              sampling={"greedy": True}, adapter="a")
            toks = h.result(timeout=T)
            placed.append(h.engine)
        assert len(set(placed)) == 1, placed
        snap = router.registry.snapshot()["fleet_adapter_locality_total"]
        assert snap.get("locality", 0.0) >= 2.0, snap
        assert len(toks) == 4
    finally:
        router.shutdown(drain=True, timeout=T)
        for d in doors.values():
            d.stop(drain=False)
    for name in doors:
        assert pools[name].refcount("a") == 0
