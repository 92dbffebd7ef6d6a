"""Request-scoped resilience of the port's serving engine, held to the
JAX engine (the contracts of ``tests/test_serving_resilience.py``,
without its mesh arm).

Both engines serve the reference's tiny model (1 layer, hidden 16,
vocabulary 32) with the same weights, copied by name, and the same
faults through each package's own ``testing/fault_injection``. Every
case holds the port to the reference on:

- the finish reasons, request by request;
- every request's greedy tokens, exactly (a quarantined victim's
  included);
- the counted registry series below, label by label;
- the ``audit()`` report.

Contracts: a fault on one request's admission, prefix splice or copy,
or chunk prefill retires only that request (``finish_reason="error"``)
and the survivors are token-exact against a fault-free run; a transient
dispatch fault is absorbed by one counted retry and a persistent one
quarantines; the NaN/inf logit guard retires exactly the poisoned slot
on decode, on the speculative verify and at the first token of a
poisoned prefix, and a guard-off run is token-exact against a guard-on
one; the breaker absorbs one tick crash and trips on repeated ones;
``quarantine=False`` fails fast; ``audit()`` finds a manufactured leak
and an orphaned pin; a broken flight recorder never changes an outcome;
the watchdog records a stall; and all of it composes over int8 pools
with speculation and a prefix cache.
"""

import contextlib

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.testing.fault_injection as jfi
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxCache
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.inference.speculative import NgramDrafter as JaxDrafter
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT

import paddle_tpu_torch.testing.fault_injection as pfi
from paddle_tpu_torch.inference import NgramDrafter, PrefixCache, Request
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

PROMPTS = [[5, 9, 2, 11, 4, 7], [3, 3, 7, 1, 8], [17, 23, 2, 9],
           [1, 2, 3, 4, 5, 6, 7]]
SHARED = list(range(1, 17))
SPLICE = [SHARED + [20, 21], [3, 7, 1], SHARED + [25, 26]]
# the counted series both engines must agree on, label by label
COUNTERS = ["serving_request_errors_total",
            "serving_nonfinite_logit_events_total",
            "serving_engine_errors_total", "serving_breaker_trips_total",
            "serving_dispatch_retries_total",
            "serving_requests_completed_total",
            "serving_requests_dropped_total",
            "serving_requests_submitted_total",
            "serving_tokens_generated_total",
            "serving_prefill_chunks_total", "serving_decode_steps_total",
            "serving_prefix_hit_tokens_total", "serving_preemptions_total",
            "serving_swap_decisions_total", "serving_swap_fallbacks_total",
            "serving_leaked_blocks", "serving_orphaned_pins",
            "recompile_events_total"]


@pytest.fixture(scope="module")
def models():
    """The reference test's tiny model and the port's, same weights."""
    paddle.seed(1234)
    kw = dict(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2,
              max_position_embeddings=128, hidden_dropout=0.0,
              attention_dropout=0.0)
    jm = JaxGPT(JaxConfig(**kw))
    pm = GPTForCausalLM(GPTConfig(**kw), device="cpu")
    pm.set_state_dict({k: np.asarray(v) for k, v in jm.state_dict().items()})
    return {"jax": jm, "torch": pm}


SIDES = {
    "jax": dict(engine=JaxEngine, request=JaxRequest, fi=jfi,
                cache=JaxCache, drafter=JaxDrafter, kw={}),
    "torch": dict(engine=ServingEngine, request=Request, fi=pfi,
                  cache=PrefixCache, drafter=NgramDrafter,
                  kw={"device": "cpu"}),
}


def _engine(models, side, cache=False, spec=None, **kw):
    s = SIDES[side]
    kw.setdefault("max_batch_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("top_k", 1)
    kw.setdefault("prefill_chunk", 16)
    kw.setdefault("seed", 7)
    if cache:
        kw["prefix_cache"] = s["cache"](chunk_tokens=16, max_bytes=1 << 24)
    if spec is not None:
        kw["spec"] = s["drafter"](k=spec)
    return s["engine"](models[side], **kw, **s["kw"])


def _run(models, side, prompts=PROMPTS, n=6, arm=None, prep=None, **kw):
    """Serve ``prompts`` greedily on one side, with the injectors ``arm``
    arms (one or a list) through that side's fault_injection module;
    returns (requests, engine, how often each injector fired)."""
    eng = _engine(models, side, **kw)
    if prep is not None:
        prep(eng)
    req = SIDES[side]["request"]
    reqs = [eng.submit(req(prompt=p, max_new_tokens=n, greedy=True))
            for p in prompts]
    with contextlib.ExitStack() as stack:
        cms = [] if arm is None else arm(SIDES[side]["fi"])
        injs = [stack.enter_context(cm)
                for cm in (cms if isinstance(cms, list) else [cms])]
        eng.run(max_steps=1500)
    return reqs, eng, [i.fired for i in injs]


def _both(models, **kw):
    return {side: _run(models, side, **kw) for side in SIDES}


def _series(eng, name):
    m = eng.telemetry.registry.get(name)
    return None if m is None else m.snapshot()


def _agree(out):
    """The port and the reference agree on finish reasons, every token,
    the counted series and the audit; returns the port's (requests,
    engine)."""
    (jr, je, jf), (pr, pe, pf) = out["jax"], out["torch"]
    assert jf == pf
    assert [r.finish_reason for r in pr] == [r.finish_reason for r in jr]
    assert [r.tokens for r in pr] == [r.tokens for r in jr]
    for name in COUNTERS:
        assert _series(pe, name) == _series(je, name), name
    assert pe.audit(record=False) == je.audit(record=False)
    return pr, pe


_BASE = {}


def _base(models, **kw):
    """The fault-free port run of a configuration, memoized."""
    key = repr(sorted(kw.items()))
    if key not in _BASE:
        _BASE[key] = [r.tokens for r in _run(models, "torch", **kw)[0]]
    return _BASE[key]


def _survivors_exact(reqs, base):
    for r, b in zip(reqs, base):
        if r.finish_reason != "error":
            assert r.finish_reason == "length"
            assert r.tokens == b


def _errors(eng):
    return sum(_series(eng, "serving_request_errors_total").values())


# ------------------------------------------------------------ quarantine
def test_admit_fault_quarantines_only_victim(models):
    """An allocator fault at the first admission retires only that
    request; everyone else is served token-exact, the audit is clean."""
    out = _both(models, block_size=16, arm=lambda fi: fi.inject(
        "serving:alloc", fi.raise_(RuntimeError("injected alloc fault")),
        times=1))
    reqs, eng = _agree(out)
    assert [r.finish_reason for r in reqs] == ["error"] + ["length"] * 3
    _survivors_exact(reqs, _base(models, block_size=16))
    assert _series(eng, "serving_request_errors_total") == {"admit": 1.0}
    assert eng.telemetry.recorder.events(kind="request_error")
    report = eng.audit()
    assert report["leaked_blocks"] == report["orphaned_pins"] == 0
    assert report["slot_errors"] == 0
    assert eng.executable_count() == 2


@pytest.mark.parametrize("where", ["dispatch", "prefill_chunk"])
def test_prefill_fault_quarantines_the_owner(models, where):
    """A PERSISTENT chunk-prefill fault (3 raises at the dispatch > the 2
    bounded retries, or one at the request's prefill turn) quarantines
    the owning request; the rest of the trace is unharmed."""
    if where == "dispatch":
        def arm(fi):
            return fi.inject(
                "serving:dispatch", fi.raise_(RuntimeError("persistent")),
                when=lambda ctx: ctx["program"] == "chunk_prefill", times=3)
    else:
        def arm(fi):
            return fi.inject("serving:prefill_chunk",
                             fi.raise_(RuntimeError("prefill fault")),
                             when=lambda ctx: ctx["rid"] == 1, times=1)
    reqs, eng = _agree(_both(models, arm=arm))
    victim = 0 if where == "dispatch" else 1
    assert [r.finish_reason == "error" for r in reqs] == \
        [i == victim for i in range(4)]
    _survivors_exact(reqs, _base(models))
    retries = _series(eng, "serving_dispatch_retries_total")
    assert retries == (2.0 if where == "dispatch" else 0.0)
    assert _series(eng, "serving_request_errors_total") == {"prefill": 1.0}


def test_transient_dispatch_fault_absorbed_by_retry(models):
    """ONE dispatch error is retried away: every request served
    token-exact, one counted retry, no quarantine."""
    reqs, eng = _agree(_both(models, arm=lambda fi: fi.inject(
        "serving:dispatch", fi.raise_(RuntimeError("transient")),
        times=1)))
    assert all(r.finish_reason == "length" for r in reqs)
    assert [r.tokens for r in reqs] == _base(models)
    assert _series(eng, "serving_dispatch_retries_total") == 1.0
    assert _errors(eng) == 0
    retries = eng.telemetry.recorder.events(kind="dispatch_retry")
    assert retries and retries[0]["attempt"] == 1


@pytest.mark.parametrize("arena", ["paged", "dense"])
def test_seeding_fault_releases_refs_and_quarantines(models, arena):
    """A fault in the zero-copy prefix SPLICE (paged) or the segment
    COPY (dense) of the request that hits the trie tears down to zero
    leaked blocks and orphaned pins; the trie stays intact, so a fresh
    request with the same prefix still hits and serves token-exact."""
    point = "serving:prefix_splice" if arena == "paged" \
        else "serving:prefix_copy"
    kw = dict(prompts=SPLICE, cache=True)
    if arena == "paged":
        kw["block_size"] = 16
    out = _both(models, arm=lambda fi: fi.inject(
        point, fi.raise_(RuntimeError("seeding fault")),
        when=lambda ctx: ctx["rid"] == 2, times=1), **kw)
    reqs, eng = _agree(out)
    assert [r.finish_reason for r in reqs] == ["length", "length", "error"]
    base = _base(models, **kw)
    _survivors_exact(reqs, base)
    again = {}
    for side, (_, e, _) in out.items():
        again[side] = e.submit(SIDES[side]["request"](
            prompt=SHARED + [25, 26], max_new_tokens=6, greedy=True))
        e.run(max_steps=300)
    assert again["torch"].finish_reason == "length"
    assert again["torch"].tokens == again["jax"].tokens == base[2]
    assert eng.audit()["orphaned_pins"] == 0


def test_default_engine_quarantines_a_splice_fault(models):
    """At the resilience defaults (quarantine on, 2 retries, guard off)
    a raise at one request's prefix splice retires that request alone on
    both engines, and the others' greedy tokens equal each other's and a
    fault-free run's."""
    kw = dict(prompts=SPLICE, cache=True, block_size=16)
    out = {side: _run(models, side, arm=lambda fi: fi.inject(
        "serving:prefix_splice", fi.raise_(RuntimeError("splice")),
        when=lambda ctx: ctx["rid"] == 2, times=1), **kw)
        for side in SIDES}
    reqs, _ = _agree(out)
    assert reqs[2].finish_reason == "error"
    assert [r.tokens for r in reqs[:2]] == _base(models, **kw)[:2]


# -------------------------------------------------------- NaN logit guard
def _poison_first_live(fi):
    return fi.inject("serving:tick", fi.nan_kv(0),
                     when=lambda ctx: ctx["engine"]._slots[0] is not None
                     and ctx["engine"]._pf[0] is None, times=1)


def _jax_int8_positions_from_t(monkeypatch):
    """The JAX engine reads int8 positions from ``cl`` (ROADMAP Queue 3):
    its one read is patched to ``t``, as in ``test_torch_int8.py``."""
    from test_torch_int8 import _read_jax_positions_from_t

    _read_jax_positions_from_t(monkeypatch)


@pytest.mark.parametrize("pools", ["dense", "paged", "paged-int8"])
def test_nan_guard_retires_only_poisoned_slot(models, pools, monkeypatch):
    """NaN in one slot's committed KV (its int8 scales on quantized
    pools) retires exactly that request, counted; the others are
    token-exact against the guarded fault-free run and the engine still
    counts 2 programs. Blocks of 4 rows give the slot full blocks beside
    the one its next commit writes: a commit re-derives that block's
    int8 scale, and a NaN scale there turns into 1.0 on both sides
    (``test_torch_int8.py::test_nan_scale_hazard_is_the_reference_s``)."""
    kw = dict(logit_guard=True)
    if pools != "dense":
        kw["block_size"] = 4
    if pools == "paged-int8":
        kw["kv_dtype"] = "int8"
        _jax_int8_positions_from_t(monkeypatch)
    reqs, eng = _agree(_both(models, arm=_poison_first_live, **kw))
    assert sum(r.finish_reason == "error" for r in reqs) == 1
    _survivors_exact(reqs, _base(models, **kw))
    assert _series(eng, "serving_nonfinite_logit_events_total") == 1.0
    assert _series(eng, "serving_request_errors_total") == \
        {"logit_guard": 1.0}
    assert eng.telemetry.recorder.events(kind="nonfinite_logits")
    assert eng.executable_count() == 2
    if pools != "dense":
        # the released blocks were scrubbed: nothing NaN is left
        e = eng.engine
        for bufs in (e.kbufs, e.vbufs, e.kscales or [], e.vscales or []):
            assert all(not b.float().isnan().any() for b in bufs)


def test_nan_guard_spec_verify(models):
    """The guard composes with the speculative verify: the poisoned slot
    is flagged by the verify's finite mask and retired alone; chunk
    prefill and verify stay the only two programs."""
    kw = dict(spec=2, logit_guard=True, max_len=96)
    reqs, eng = _agree(_both(models, arm=_poison_first_live, **kw))
    assert sum(r.finish_reason == "error" for r in reqs) == 1
    _survivors_exact(reqs, _base(models, **kw))
    assert eng.executable_count() == 2
    assert _series(eng, "serving_nonfinite_logit_events_total") == 1.0


def test_guard_covers_first_token_from_poisoned_prefix(models):
    """A request splicing a poisoned shared prefix retires 'error' before
    its first token: nothing reaches its stream; a request that shares
    nothing is served."""
    out = {}
    for side, s in SIDES.items():
        eng = _engine(models, side, cache=True, block_size=16,
                      logit_guard=True)
        seeder = eng.submit(s["request"](prompt=SHARED + [20, 21],
                                         max_new_tokens=4, greedy=True))
        eng.run(max_steps=300)
        assert seeder.finish_reason == "length"
        node = next(eng._cache.iter_nodes())
        eng.engine.poison_slot_kv(0, table_row=node.blocks)
        streamed = []
        victim = eng.submit(s["request"](
            prompt=SHARED + [25, 26], max_new_tokens=4, greedy=True,
            on_token=lambda r, t, d: streamed.append(int(t))))
        fresh = eng.submit(s["request"](prompt=[9, 8, 7], max_new_tokens=4,
                                        greedy=True))
        eng.run(max_steps=300)
        out[side] = ([seeder, victim, fresh], eng, None)
        assert streamed == []
    reqs, eng = _agree(out)
    assert [r.finish_reason for r in reqs] == ["length", "error", "length"]
    assert reqs[1].tokens == []
    assert eng.executable_count() == 2
    assert eng.audit()["leaked_blocks"] == 0


def test_logit_guard_off_is_token_exact_vs_on(models):
    """Fault-free, guard on and off give the same tokens."""
    assert _base(models, logit_guard=True) == _base(models)
    assert _base(models, logit_guard=True, block_size=16) == \
        _base(models, block_size=16)


# --------------------------------------------------------------- breaker
def test_breaker_absorbs_isolated_tick_crash(models):
    """One crash mid-tick: a counted engine_error, the tick skipped,
    every request served token-exact."""
    reqs, eng = _agree(_both(models, arm=lambda fi: fi.inject(
        "serving:tick", fi.raise_(RuntimeError("tick crash")),
        when=lambda ctx: ctx["step"] == 4, times=1)))
    assert all(r.finish_reason == "length" for r in reqs)
    assert [r.tokens for r in reqs] == _base(models)
    assert _series(eng, "serving_engine_errors_total") == 1.0
    assert _series(eng, "serving_breaker_trips_total") == 0.0
    assert eng.breaker_state() == {"open": False, "failures": 0,
                                   "threshold": 3}


def test_breaker_trips_on_repeated_failures(models, tmp_path, monkeypatch):
    """Persistent engine-scoped failure: exactly threshold counted
    engine errors, one trip, then the fail-all path (flight dump, raise);
    a dump written by either package loads in the other."""
    out = {}
    for side, s in SIDES.items():
        # one directory a side: both dumps land in the same second
        monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path / side))
        (tmp_path / side).mkdir()
        eng = _engine(models, side, max_batch_slots=1,
                      engine_failure_threshold=3)
        eng.submit(s["request"](prompt=[1, 2, 3], max_new_tokens=4,
                                greedy=True))
        with s["fi"].inject("serving:tick",
                            s["fi"].raise_(RuntimeError("persistent"))):
            with pytest.raises(RuntimeError, match="persistent"):
                eng.run(max_steps=50)
        out[side] = eng
        assert eng.breaker_state()["open"]
    for eng in out.values():
        reg = eng.telemetry.registry
        assert reg.get("serving_engine_errors_total").value == 3
        assert reg.get("serving_breaker_trips_total").value == 1
        kinds = eng.telemetry.recorder.counts()
        assert kinds.get("engine_error") == 3
        assert kinds.get("breaker_trip") == 1
    assert out["torch"].telemetry.recorder.counts() == \
        out["jax"].telemetry.recorder.counts()
    dumps = sorted(tmp_path.glob("*/flight-*.jsonl"))
    assert len(dumps) == 2
    from paddle_tpu.observability.flight_recorder import load_dump as jload
    from paddle_tpu_torch.observability.flight_recorder import load_dump
    for d in dumps:
        assert load_dump(str(d)) == jload(str(d))


def test_quarantine_off_restores_fail_fast(models):
    """``quarantine=False``: the first injected fault propagates."""
    for side, s in SIDES.items():
        eng = _engine(models, side, max_batch_slots=1, block_size=16,
                      quarantine=False, dispatch_retries=0)
        eng.submit(s["request"](prompt=[1, 2, 3], max_new_tokens=4,
                                greedy=True))
        with s["fi"].inject("serving:alloc",
                            s["fi"].raise_(RuntimeError("alloc fault")),
                            times=1):
            with pytest.raises(RuntimeError, match="alloc fault"):
                eng.run(max_steps=50)


# ----------------------------------------------------------------- audit
def test_audit_detects_manufactured_leak(models):
    """Blocks granted outside any holder show up as leaked (counted and
    gauged) on both engines; returning them reconciles to zero."""
    out = _both(models, block_size=16)
    _agree(out)
    for side, (_, eng, _) in out.items():
        leak = eng._alloc.alloc(2)
        out[side] = eng.audit()
        assert eng.telemetry.registry.get(
            "serving_leaked_blocks").value == 2
        eng._alloc.deref(leak)
        assert eng.audit()["leaked_blocks"] == 0
        assert eng.audit_state()["leaked_blocks"] == 0
    assert out["torch"] == out["jax"]
    assert out["torch"]["leaked_blocks"] == 2


def test_audit_detects_orphaned_pin(models):
    """A trie reference no live slot accounts for is an orphaned pin."""
    out = _both(models, prompts=SPLICE[:2], cache=True)
    _agree(out)
    for side, (_, eng, _) in out.items():
        node = next(eng._cache.iter_nodes())
        node.refs += 1
        out[side] = eng.audit()
        node.refs -= 1
        assert eng.audit()["orphaned_pins"] == 0
    assert out["torch"] == out["jax"]
    assert out["torch"]["orphaned_pins"] == 1


def _break_recorder(eng):
    def broken(kind, **fields):
        raise OSError("ring backing store gone")

    eng.telemetry.recorder.record = broken


def test_broken_recorder_never_affects_request_outcomes(models, capsys):
    """With the flight recorder raising on EVERY write, requests still
    serve token-exact and nothing is quarantined or absorbed; the
    failures are counted and warned."""
    out = _both(models, prep=_break_recorder)
    reqs, eng = _agree(out)
    assert [r.tokens for r in reqs] == _base(models)
    failed = [e.telemetry.registry.get(
        "serving_flight_dump_failed_total").value
        for _, e, _ in out.values()]
    assert failed[0] == failed[1] >= 1
    assert _errors(eng) == 0
    assert "flight_dump_failed" in capsys.readouterr().err


def test_watchdog_records_dispatch_stall(models):
    """A warm dispatch overrunning the armed threshold leaves a counted
    ``dispatch_stall`` event, recorded by the watchdog timer while the
    dispatch is still running; tokens are unchanged."""
    def arm(fi):
        calls = {"n": 0}

        def third_warm_step(ctx):
            if ctx["program"] != "decode_step":
                return False
            calls["n"] += 1
            return calls["n"] == 3

        return fi.inject("serving:dispatch", fi.sleep_(0.2),
                         when=third_warm_step, times=1)

    out = _both(models, prompts=PROMPTS[:2], arm=arm, dispatch_stall_s=0.05)
    for side, (reqs, eng, fired) in out.items():
        assert fired == [1]
        assert all(r.finish_reason == "length" for r in reqs)
        assert eng.telemetry.registry.get(
            "serving_dispatch_stalls_total").value >= 1
        # the planted stall; a loaded host may add a natural one
        ev = [e for e in eng.telemetry.recorder.events(kind="dispatch_stall")
              if e["program"] == "decode_step"]
        assert ev and ev[0]["threshold_s"] == 0.05
        assert eng.dispatch_stalled() == 0
    assert [r.tokens for r in out["torch"][0]] == \
        [r.tokens for r in out["jax"][0]] == _base(models)[:2]


# ------------------------------------------------------------ composition
def _poison_pools(eng):
    """Fill every pool and scale buffer with values that would dominate
    any softmax they leaked into."""
    import jax

    e = eng.engine
    e._ensure_buffers()
    code = 127 if e.quantized else 1e9
    if hasattr(e.kbufs[0], "fill_"):
        for b in e.kbufs + e.vbufs:
            b.fill_(code)
        for b in (e.kscales or []) + (e.vscales or []):
            b.fill_(1e7)
        return

    def full(buf, val):
        return jax.device_put(
            np.full(buf.shape, val, dtype=np.dtype(str(buf.dtype))),
            buf.sharding)

    e.kbufs = [full(b, code) for b in e.kbufs]
    e.vbufs = [full(b, code) for b in e.vbufs]
    if e.quantized:
        e.kscales = [full(s, 1e7) for s in e.kscales]
        e.vscales = [full(s, 1e7) for s in e.vscales]


def test_composition_quarantine_paged_int8_spec(models, monkeypatch):
    """A splice fault on an engine with int8 paged pools, speculative
    verify and a prefix cache, pools poison-filled: the victim retires
    'error', the survivors equal the fault-free run, 2 programs, a clean
    audit."""
    _jax_int8_positions_from_t(monkeypatch)
    prompts = [SHARED + [20, 21], [3, 7, 1, 9], SHARED + [25, 26]]
    kw = dict(prompts=prompts, max_len=96, block_size=16, kv_dtype="int8",
              spec=2, cache=True, prep=_poison_pools)
    base = {side: _run(models, side, **kw) for side in SIDES}
    _agree(base)
    out = _both(models, arm=lambda fi: fi.inject(
        "serving:prefix_splice", fi.raise_(RuntimeError("splice")),
        when=lambda ctx: ctx["rid"] == 2, times=1), **kw)
    reqs, eng = _agree(out)
    assert [r.finish_reason for r in reqs] == ["length", "length", "error"]
    assert [r.tokens for r in reqs[:2]] == \
        [r.tokens for r in base["torch"][0][:2]]
    assert eng.executable_count() == 2
    report = eng.audit()
    assert report["leaked_blocks"] == report["orphaned_pins"] == 0
    assert eng.telemetry.recompile_events() == 0


def test_host_tier_faults_degrade_to_reprefill(models):
    """With a starved pool and a host tier, a spill-write fault falls
    back to recompute and a swap-back fault to a full re-prefill, both
    counted as the reference counts them; every request is still served
    token-exact and the tier reconciles to zero."""
    prompts = [[(7 * i + j) % 31 + 1 for j in range(20)] for i in range(3)]
    kw = dict(prompts=prompts, n=20, block_size=4, num_blocks=14,
              host_tier_blocks=16)
    base = _base(models, **kw)

    def arm(fi):
        return [fi.inject("serving:spill_write",
                          fi.raise_(RuntimeError("spill")), times=1),
                fi.inject("serving:swap_in",
                          fi.raise_(RuntimeError("swap in")), times=1)]

    reqs, eng = _agree(_both(models, arm=arm, **kw))
    assert all(r.finish_reason == "length" for r in reqs)
    assert [r.tokens for r in reqs] == base
    assert _series(eng, "serving_swap_fallbacks_total") == \
        {"spill": 1.0, "swap_in": 1.0}
    assert _series(eng, "serving_preemptions_total") >= 2
    assert eng.audit()["leaked_host_blocks"] == 0
