"""The port's ``observability/`` against the reference's.

Both packages' registry, request tracer, flight recorder, SLO tracker,
tick profiler and recompile sentinel are driven with the SAME event
sequence under ONE injected clock, then held to each other:

- the Prometheus text exposition, byte for byte;
- the chrome-trace JSON of the tracer and the tick lane, after parsing,
  and the gzipped saves of each;
- each package's flight dump, loaded by the other package;
- the SLO states, the profiler's coverage and snapshot, and the
  sentinel's counts for a forked signature;
- the ``Telemetry`` bundle's ``events_emitted()`` and
  ``recompile_events()``.

The ops plane serves a port engine on ``127.0.0.1`` at an ephemeral
port: ``/metrics``, ``/healthz``, ``/readyz`` and the debug endpoints.
The dump CLI renders a dump exactly as the reference's does, from a
file and from the live plane.
"""

import contextlib
import gzip
import io
import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu.observability as jobs
from paddle_tpu.observability.dump import main as jdump_main
from paddle_tpu.observability.flight_recorder import load_dump as jload

import paddle_tpu_torch.observability as pobs
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.observability.dump import main as pdump_main
from paddle_tpu_torch.observability.flight_recorder import load_dump
from paddle_tpu_torch.observability.ops_plane import (OpsPlane,
                                                      PROM_CONTENT_TYPE)

REPO = Path(__file__).resolve().parents[1]


class Clock:
    """A deterministic monotonic clock both packages share."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


class _Fn:
    """A program handle whose signature count the sentinel reads."""

    def __init__(self):
        self.n = 0

    def _cache_size(self):
        return self.n


def _drive(obs):
    """One scripted event sequence through every component of ``obs``
    (either package's ``observability``); returns the components."""
    clock = Clock()
    tel = obs.Telemetry(clock=clock, slo=None)
    reg = tel.registry
    # metrics: labeled and unlabeled families, escaping, every kind
    c = reg.counter("requests_total", "requests by code",
                    labelnames=("code",))
    c.labels(code="200").inc(3)
    c.labels(code='we"ird\\one\nx').inc()
    reg.counter("bare_total", "never incremented")
    g = reg.gauge("queue_depth", "queued requests")
    g.set(4)
    g.set(2)
    lg = reg.gauge("tier_depth", "per tier", labelnames=("tier",))
    lg.labels(tier="0").set(1.5)
    h = reg.histogram("latency_seconds", "latency",
                      obs.log_buckets(1e-3, 10.0))
    for v in (0.0004, 0.002, 0.002, 0.03, 0.7, 12.0):
        h.observe(v)
    hl = reg.histogram("span_seconds", "labeled", obs.PHASE_BUCKETS,
                       labelnames=("phase",))
    hl.labels(phase="a").observe(3e-6)
    hl.labels(phase="b").observe(0.5)
    # the tracer: two request lanes, one preempted and resumed
    tr = tel.tracer
    for rid in (0, 1):
        tr.lifecycle(rid, "submitted", prompt_len=5)
        clock.tick(0.01)
        tr.lifecycle(rid, "admitted", slot=rid, prefix_hit_tokens=0)
        tr.record_event_sink("serving:prefill_chunk", rid, clock(), 0.004)
        clock.tick(0.005)
        tr.lifecycle(rid, "first_token", token=7)
        tr.event(rid, "token", tok=7, n=1)
    tr.lifecycle(1, "preempted", slot=1, tokens_so_far=1)
    clock.tick(0.02)
    tr.lifecycle(1, "resumed", slot=0, prompt_len=6, prefix_hit_tokens=0)
    for rid in (0, 1):
        clock.tick(0.003)
        tr.lifecycle(rid, "finished", reason="length", new_tokens=2)
    # the flight recorder: past its capacity (the ring wraps)
    rec = obs.FlightRecorder(capacity=6, clock=clock)
    for i in range(9):
        clock.tick(0.001)
        rec.record("block_alloc", n=i, in_use=i + 1, free=9 - i)
    rec.record("preempt", rid=1, slot=1, tokens_so_far=1)
    tel.recorder.record("submit", rid=0, prompt_len=5)
    # SLOs: two tenants, one violating TTFT
    slo = obs.SLOTracker(reg, objectives={"gold": obs.SLOObjective(
        ttft_s=0.1, tpot_s=0.05, target=0.9)}, window_s=10.0, clock=clock)
    for tenant, ttft, tpot in (("gold", 0.05, 0.01), ("gold", 0.3, 0.02),
                               ("free", 1.0, None), ("gold", 0.02, 0.2)):
        clock.tick(0.5)
        slo.observe(tenant, ttft, tpot)
    # the tick profiler: three ticks, one uncommitted, nested phases
    prof = obs.TickProfiler(reg, clock=clock).enable()
    for commit in (True, False, True):
        tok = prof.tick_begin()
        with prof.phase("admission"):
            clock.tick(0.002)
            with prof.phase("trie_lookup"):
                clock.tick(0.001)
        with prof.phase("decode_dispatch"):
            clock.tick(0.004)
        clock.tick(0.0005)          # untracked
        with prof.phase("token_sync"):
            clock.tick(0.003)
        prof.tick_end(tok, commit=commit)
    # the sentinel: warmup, steady state, then a forked signature
    fn = _Fn()
    sent = tel.sentinel
    for n in (1, 1, 1, 2, 2, 3):
        fn.n = n
        sent.observe("decode_step", fn,
                     lambda: obs.describe_args(
                         toks=np.zeros((4, 1), np.int64), t=3))
    return dict(tel=tel, reg=reg, rec=rec, slo=slo, prof=prof, clock=clock)


@pytest.fixture(scope="module")
def driven():
    return _drive(jobs), _drive(pobs)


def test_prometheus_text_is_byte_identical(driven):
    j, p = driven
    text = p["reg"].to_prometheus_text()
    assert text == j["reg"].to_prometheus_text()
    assert 'code="we\\"ird\\\\one\\nx"' in text
    assert p["reg"].to_json() == j["reg"].to_json()
    assert p["reg"].snapshot() == j["reg"].snapshot()


def test_chrome_traces_agree(driven, tmp_path):
    j, p = driven
    for key, get in (("tracer", lambda d: d["tel"].tracer),
                     ("profiler", lambda d: d["prof"])):
        mine = get(p).to_chrome_trace()
        assert json.loads(json.dumps(mine)) == \
            json.loads(json.dumps(get(j).to_chrome_trace()))
        # the gzipped save of each side parses to the same trace
        saved = []
        for side, d in (("jax", j), ("torch", p)):
            path = get(d).save(str(tmp_path / f"{key}-{side}.json.gz"))
            with gzip.open(path, "rt") as f:
                saved.append(json.load(f))
        assert saved[0] == saved[1] == json.loads(json.dumps(mine))
    assert p["tel"].tracer.timeline(1) == j["tel"].tracer.timeline(1)


def test_flight_dumps_load_in_either_package(driven, tmp_path):
    j, p = driven
    assert p["rec"].events() == j["rec"].events()
    assert p["rec"].dropped == j["rec"].dropped == 4
    assert p["rec"].counts() == j["rec"].counts()
    paths = {}
    for side, d in (("jax", j), ("torch", p)):
        paths[side] = d["rec"].save(str(tmp_path / f"{side}.jsonl"),
                                    reason="test", context={"k": 1})
    for path in paths.values():
        assert load_dump(path) == jload(path)
    assert load_dump(paths["jax"]) == load_dump(paths["torch"])


def test_slo_states_agree(driven):
    j, p = driven
    for tenant in ("gold", "free"):
        for obj in ("ttft", "tpot"):
            assert p["slo"].attainment(tenant, obj) == \
                j["slo"].attainment(tenant, obj)
            assert p["slo"].burn_rate(tenant, obj) == \
                j["slo"].burn_rate(tenant, obj)
    assert p["slo"].worst_burn() == j["slo"].worst_burn()
    assert p["slo"].worst_burn()[1:] == ("gold", "ttft")
    assert p["slo"].total_events == j["slo"].total_events == 7
    # time passes beyond the window: attainment resets to 1.0
    for d in (j, p):
        d["clock"].tick(60.0)
    assert p["slo"].attainment("gold", "ttft") == 1.0 == \
        j["slo"].attainment("gold", "ttft")


def test_profiler_coverage_and_snapshot_agree(driven):
    j, p = driven
    snap = p["prof"].snapshot()
    assert snap == j["prof"].snapshot()
    assert snap["ticks"] == 2
    # 10 of the 10.5 ms of each tick sit in a top-level phase (the
    # nested trie_lookup counts inside admission)
    assert p["prof"].coverage_fraction() == pytest.approx(10.0 / 10.5)
    assert set(snap["phases"]) == {"admission", "trie_lookup",
                                   "decode_dispatch", "token_sync"}


def test_sentinel_counts_a_forked_signature(driven):
    j, p = driven
    for d in (j, p):
        assert d["tel"].recompile_events() == 2
        assert d["reg"].get("recompile_events_total").value == 2
        assert d["reg"].get("compiled_programs_total").value == 1
        ev = d["tel"].recorder.events(kind="recompile")
        assert [e["new_lowerings"] for e in ev] == [1, 1]
        assert ev[0]["argspec"] == {"toks": "(4,1):int64", "t": "int"}
    assert p["tel"].events_emitted() == j["tel"].events_emitted()
    strict = pobs.RecompileSentinel(strict=True)
    fn = _Fn()
    fn.n = 1
    strict.observe("p", fn)
    fn.n = 2
    with pytest.raises(pobs.RecompileError, match="re-lowered"):
        strict.observe("p", fn)


def test_describe_args_reads_torch_and_numpy_alike():
    import torch

    got = pobs.describe_args(a=torch.zeros(2, 3, dtype=torch.int32),
                             b=np.zeros((2, 3), np.int32), c=[1, 2],
                             d=None, e=1.5)
    assert got == {"a": "(2,3):torch.int32", "b": "(2,3):int32",
                   "c": "len=2", "d": "None", "e": "float"}
    assert {k: v for k, v in got.items() if k != "a"} == \
        {k: v for k, v in jobs.describe_args(
            b=np.zeros((2, 3), np.int32), c=[1, 2], d=None,
            e=1.5).items()}


# ------------------------------------------------------------- ops plane
def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@pytest.fixture(scope="module")
def served():
    """A port engine that served a few requests, profiled, behind an
    ops plane on an ephemeral loopback port."""
    eng = ServingEngine(GPTForCausalLM(gpt_tiny(), device="cpu", seed=0),
                        max_batch_slots=2, max_len=64, prefill_chunk=16,
                        block_size=16, profile=True, device="cpu")
    reqs = [eng.submit(Request(prompt=[3, 1, 4, 1, 5][:n + 2],
                               max_new_tokens=4, greedy=True))
            for n in range(3)]
    eng.run(max_steps=200)
    assert all(r.finish_reason == "length" for r in reqs)
    with OpsPlane(eng, port=0) as plane:
        yield eng, plane


def test_ops_plane_endpoints(served):
    eng, plane = served
    base = plane.url
    assert base.startswith("http://127.0.0.1:")
    code, headers, body = _get(base, "/metrics")
    assert code == 200 and headers["Content-Type"] == PROM_CONTENT_TYPE
    text = body.decode()
    for family in ("serving_requests_completed_total",
                   "serving_free_slots", "serving_request_errors_total",
                   "program_dispatches_total", "recompile_events_total",
                   "serving_tick_phase_seconds"):
        assert f"# TYPE {family} " in text
    assert 'serving_requests_completed_total{reason="length"} 3' in text
    assert "serving_free_slots 2" in text
    code, _, body = _get(base, "/healthz")
    assert code == 200 and json.loads(body)["alive"]
    code, _, body = _get(base, "/readyz")
    assert code == 200 and json.loads(body)["ready"]
    code, _, body = _get(base, "/debug/requests")
    assert code == 200
    assert json.loads(body) == json.loads(json.dumps(eng.debug_requests()))
    code, _, body = _get(base, "/debug/flight?last=3")
    lines = body.decode().splitlines()
    assert code == 200 and json.loads(lines[0])["kind"] == "_meta"
    assert len(lines) == 4
    code, _, body = _get(base, "/debug/trace")
    assert code == 200
    names = {e.get("name") for e in json.loads(body)["traceEvents"]}
    assert {"tick", "decode_dispatch", "token_sync"} <= names
    code, _, body = _get(base, "/debug/profile")
    prof = json.loads(body)
    assert code == 200 and prof["enabled"]
    assert {row["program"] for row in prof["top_programs"]} == \
        {"chunk_prefill", "decode_step"}
    assert _get(base, "/nope")[0] == 404
    assert _get(base, "/debug/flight?last=x")[0] == 400


def test_readyz_degrades_on_an_open_breaker(served):
    eng, plane = served
    eng._breaker_open = True
    try:
        code, _, body = _get(plane.url, "/readyz")
        assert code == 503
        assert json.loads(body)["reasons"][0].startswith("breaker_open")
    finally:
        eng._breaker_open = False
    assert _get(plane.url, "/readyz")[0] == 200


# -------------------------------------------------------------- dump CLI
def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("args", [[], ["--summary"], ["--kind", "block_alloc",
                                                       "--last", "2"],
                                  ["--request", "1"]])
def test_dump_cli_renders_as_the_reference(driven, tmp_path, args):
    _, p = driven
    path = p["rec"].save(str(tmp_path / "d.jsonl"), reason="test")
    rc, text = _cli(pdump_main, [path] + args)
    assert rc == 0
    assert (rc, text) == _cli(jdump_main, [path] + args)
    assert text.startswith("# dump: reason=test")


def test_dump_cli_reads_a_live_plane(served):
    _, plane = served
    rc, text = _cli(pdump_main, ["--url", plane.url, "--summary"])
    assert rc == 0 and "TOTAL" in text and "retire" in text
    assert _cli(jdump_main, ["--url", plane.url, "--summary"]) == (rc, text)


def test_dump_cli_runs_as_a_module(driven, tmp_path):
    _, p = driven
    path = p["rec"].save(str(tmp_path / "m.jsonl"))
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.observability.dump", path,
         "--summary"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == _cli(jdump_main, [path, "--summary"])[1]
