"""The port's HTTP ingest and fleet router against the JAX package
(``tests/test_fleet.py``, ``tests/test_disagg_fleet.py``).

Real engines (a small seeded GPT whose weights are copied by name from
the JAX model), real tick loops on pump threads, real loopback HTTP:

- the ingest plane: submit, SSE stream (and its resume from an offset),
  status, cancel, migrate out (409 once finished) and in, drain, every
  rejection typed and counted (400, 401, 404, 413, 429, 503), and
  ``/v1/score`` answering with the prompt's logprobs;
- the router: placement from scraped load serving the JAX engine's
  greedy tokens; a live migration token-identical under seeded
  temperature; a corrupt transfer falling back engine-side; a scrape
  blackhole tripping the breaker and routing around it; a killed
  engine failing over token-exact; the disaggregated prefill/decode
  handoff; and a shutdown that audits zero leaks;
- one engine process: ``engine_proc --oneshot-restore`` continues a
  request snapshotted here token-exact (``"device": "cpu"``).

Every HTTP call, stream read, join and wait has an explicit timeout.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT

from paddle_tpu_torch.inference.fleet import (EngineRef, FleetRouter,
                                              TransportError)
from paddle_tpu_torch.inference.fleet.client import (EngineClient,
                                                     SubmitRejected)
from paddle_tpu_torch.inference.frontend import FrontDoor, SamplingParams
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.testing.fault_injection import inject, raise_, sleep_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = [5, 9, 2, 11, 4, 7, 8, 3] * 3
SAMP = {"temperature": 0.9, "seed": 3}
GREEDY = {"greedy": True}
CFG = dict(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2,
           max_position_embeddings=128, hidden_dropout=0.0,
           attention_dropout=0.0)
ENGINE_KW = dict(max_batch_slots=2, max_len=64, prefill_chunk=16,
                 block_size=8, host_tier_blocks=8, seed=7)
T = 30          # seconds: every wait below


@pytest.fixture(scope="module")
def weights():
    """The JAX model's random weights (seeded) and its engine's greedy
    tokens on PROMPT."""
    paddle.seed(1234)
    jm = JaxGPT(JaxConfig(**CFG))
    state = {k: np.asarray(v.value if hasattr(v, "value") else v)
             for k, v in jm.state_dict().items()}
    eng = JaxEngine(jm, **ENGINE_KW)
    reqs = [eng.submit(JaxRequest(prompt=PROMPT[:n], max_new_tokens=24,
                                  greedy=True)) for n in (24, 8)]
    eng.run(max_steps=500)
    return state, [r.tokens for r in reqs]


def _model(state):
    """A port model of its own per engine (two engines tick at once)."""
    m = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    m.set_state_dict(state)
    m.eval()
    return m


def _door(state, **kw):
    return FrontDoor(_model(state), ingest_port=0, ops_port=0,
                     **{**ENGINE_KW, **kw}, device="cpu").start()


def _post(url, data, headers=None):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=T) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _stream(url):
    toks, final = [], None
    with urllib.request.urlopen(url, timeout=T) as r:
        for line in r:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            ev = json.loads(line[6:])
            if ev.get("done"):
                final = ev
                break
            toks.append(ev["token"])
    return toks, final


def _wait_tokens(h, n):
    t0 = time.monotonic()
    while len(h.tokens) < n and h.status == "running" \
            and time.monotonic() - t0 < T:
        time.sleep(0.005)
    return len(h.tokens) >= n


@pytest.fixture(scope="module")
def solo(weights):
    door = _door(weights[0])
    yield door
    door.stop(drain=False)
    door.stop()


@pytest.fixture(scope="module")
def site(weights):
    doors = {n: _door(weights[0]) for n in ("A", "B")}
    router = FleetRouter([EngineRef(n, d.ingest.url, d.ops.url)
                          for n, d in doors.items()],
                         seed=5, breaker_cooldown=30.0)
    yield doors, router
    router.shutdown(drain=False, timeout=T)
    for d in doors.values():
        d.stop(drain=False)


# ------------------------------------------------------------- ingest
def test_ingest_submit_stream_resume_status_cancel(solo, weights):
    base = solo.ingest.url
    code, body = _post(base + "/v1/submit", json.dumps(
        {"prompt": PROMPT, "max_new_tokens": 24,
         "sampling": GREEDY}).encode())
    assert code == 200, body
    rid = json.loads(body)["id"]
    toks, final = _stream(base + f"/v1/stream/{rid}")
    assert toks == weights[1][0]
    assert final["finish_reason"] == "length" and final["tokens"] == 24
    tail, final = _stream(base + f"/v1/stream/{rid}?from=20")
    assert tail == toks[20:] and final["tokens"] == 24
    with urllib.request.urlopen(base + f"/v1/requests/{rid}",
                                timeout=T) as r:
        st = json.loads(r.read())
    assert st["status"] == "done" and st["tokens"] == toks
    code, body = _post(base + "/v1/submit", json.dumps(
        {"prompt": PROMPT, "max_new_tokens": 40}).encode())
    rid = json.loads(body)["id"]
    code, body = _post(base + f"/v1/cancel/{rid}", b"")
    assert code == 200 and json.loads(body) == {"cancelled": True}
    _, final = _stream(base + f"/v1/stream/{rid}")
    assert final["finish_reason"] == "cancelled"
    assert _post(base + f"/v1/cancel/{rid}", b"")[1] == \
        b'{"cancelled": false}'


def test_ingest_rejections_typed_and_counted(solo, weights):
    base = solo.ingest.url
    reg = solo.engine.telemetry.registry
    before = dict(reg.get("ingest_rejections_total").snapshot())
    cases = [("/v1/submit", b"{not json", 400, "bad_json"),
             ("/v1/cancel/99999", b"", 404, "unknown_id"),
             ("/v1/submit", json.dumps({"prompt": "hi"}).encode(), 400,
              "bad_field"),
             ("/v1/submit", json.dumps({"prompt": [1, 2], "sampling": {
                 "temperature": -1}}).encode(), 400, "bad_field"),
             ("/v1/submit", json.dumps({"prompt": [1] * 80}).encode(), 400,
              "bad_field"),
             # the batch surfaces set kind themselves and take no
             # sampling; a grammar the compiler cannot read is typed
             ("/v1/score", json.dumps({"prompt": [1, 2],
                                       "kind": "score"}).encode(), 400,
              "bad_field"),
             ("/v1/embed", json.dumps({"prompt": [1, 2], "sampling": {
                 "greedy": True}}).encode(), 400, "bad_field"),
             ("/v1/submit", json.dumps({"prompt": [1], "sampling": {
                 "response_format": {"type": "nope"}}}).encode(),
              400, "bad_field"),
             ("/v1/migrate_out/99999", b"", 404, "unknown_id")]
    for path, data, code, reason in cases:
        got, body = _post(base + path, data)
        assert (got, json.loads(body)["reason"]) == (code, reason), path
    # the score and embed surfaces answer since the engine takes kinds
    got, body = _post(base + "/v1/score", json.dumps(
        {"prompt": [1, 2, 3]}).encode())
    assert got == 200 and len(json.loads(body)["logprobs"]) == 2
    try:
        assert _post(base + "/v1/submit", b"x" * (2 << 20))[0] == 413
    except urllib.error.URLError:
        pass    # the server may reset before reading the body
    after = dict(reg.get("ingest_rejections_total").snapshot())
    for reason in ("bad_json", "unknown_id", "bad_field",
                   "body_too_large"):
        assert after.get(reason, 0) > before.get(reason, 0), reason


def test_ingest_auth_backpressure_and_drain(weights):
    door = FrontDoor(_model(weights[0]), ingest_port=0, ops_port=0,
                     ingest_api_key="k3y", max_queue_depth=1,
                     **ENGINE_KW, device="cpu")
    door.start()
    try:
        base = door.ingest.url
        body = json.dumps({"prompt": PROMPT, "max_new_tokens": 4}).encode()
        code, out = _post(base + "/v1/submit", body)
        assert (code, json.loads(out)["reason"]) == (401, "unauthorized")
        auth = {"Authorization": "Bearer k3y"}
        with inject("serving:tick", sleep_(0.05)):
            codes = [_post(base + "/v1/submit", body, auth)[0]
                     for _ in range(4)]
        assert 429 in codes and codes[0] == 200
        client = EngineClient(base, door.ops.url, timeout=T, api_key="k3y")
        assert client.drain()["draining"] is True
        with pytest.raises(SubmitRejected) as ei:
            client.submit({"prompt": [1, 2]})
        assert (ei.value.code, ei.value.reason) == (503, "draining")
        with pytest.raises(SubmitRejected) as ei:
            client.migrate_in(b"not-a-frame", handoff=True)
        assert ei.value.reason == "draining_handoff"
        ready, reasons = EngineClient(base, door.ops.url,
                                      timeout=T).readyz()
        assert not ready and "draining" in reasons
        rej = door.engine.telemetry.registry.get(
            "ingest_rejections_total").snapshot()
        assert rej["unauthorized"] == 1.0 and rej["draining"] == 1.0
        assert rej["backpressure:global"] >= 1.0
    finally:
        door.stop(drain=True, timeout=T)


def test_ingest_migrate_out_then_in(solo, weights):
    """Migrate a live request out over HTTP (the frame is the body), in
    again on the same engine: the continuation is the uninterrupted
    greedy run's; a finished request answers 409."""
    base = solo.ingest.url
    client = EngineClient(base, solo.ops.url, timeout=T)
    with inject("serving:tick", sleep_(0.01)):
        rid = client.submit({"prompt": PROMPT, "max_new_tokens": 24,
                             "sampling": GREEDY})
        t0 = time.monotonic()
        while len(client.status(rid)["tokens"]) < 3 and \
                time.monotonic() - t0 < T:
            time.sleep(0.01)
        frame = client.migrate_out(rid, timeout=T)
    assert frame[:8] == b"PTRQSNP1"
    assert client.status(rid)["finish_reason"] == "migrated"
    with pytest.raises(SubmitRejected) as ei:
        client.migrate_out(rid)
    assert (ei.value.code, ei.value.reason) == (409, "not_live")
    res = client.migrate_in(frame, timeout=T)
    assert res["outcome"] == "swap_in" and res["tokens_done"] >= 3
    toks = [ev["token"] for ev in client.stream(res["id"], timeout=T)
            if "token" in ev]
    assert toks == weights[1][0]
    with pytest.raises(SubmitRejected) as ei:
        client.migrate_in(b"PTRQSNP1" + b"\xff" * 8)
    assert (ei.value.code, ei.value.reason) == (400, "bad_frame")


# ------------------------------------------------------------- router
def test_router_places_and_serves_the_reference_tokens(site, weights):
    doors, router = site
    hs = [router.submit(PROMPT[:n], max_new_tokens=24, sampling=GREEDY)
          for n in (24, 8)]
    assert [h.result(timeout=T) for h in hs] == weights[1]
    assert all(h.placements[0] in doors for h in hs)
    load = EngineClient(doors["A"].ingest.url, doors["A"].ops.url,
                        timeout=T).load()
    assert load["free_slots"] == 2 and load["queued"] == 0


def test_router_migration_token_identical_temperature(site):
    doors, router = site
    ref = router.submit(PROMPT, max_new_tokens=16,
                        sampling=SAMP).result(timeout=T)
    with inject("serving:tick", sleep_(0.01)):
        h = router.submit(PROMPT, max_new_tokens=16, sampling=SAMP)
        assert _wait_tokens(h, 2)
        assert router.migrate(h) == "swap_in"
    assert h.result(timeout=T) == ref
    assert len(set(h.placements)) == 2, h.placements


def test_router_corrupt_transfer_falls_back_engine_side(site):
    doors, router = site
    ref = router.submit(PROMPT, max_new_tokens=16,
                        sampling=SAMP).result(timeout=T)

    def flip(ctx):
        bad = bytearray(ctx["value"])
        bad[-50] ^= 0xFF
        return bytes(bad)

    with inject("serving:tick", sleep_(0.01)):
        h = router.submit(PROMPT, max_new_tokens=16, sampling=SAMP)
        assert _wait_tokens(h, 2)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with inject("fleet:transfer", flip, times=1):
                assert router.migrate(h) == "corrupt_fallback"
    assert h.result(timeout=T) == ref


def test_router_scrape_blackhole_trips_breaker_and_reroutes(site):
    doors, router = site
    trips0 = router.registry.get("fleet_breaker_trips_total").value
    with inject("fleet:scrape", raise_(TransportError("blackholed")),
                when=lambda ctx: ctx.get("engine") == "B"):
        placed = []
        for _ in range(3):
            h = router.submit(PROMPT, max_new_tokens=4, sampling=GREEDY)
            placed.append(h.engine)
            assert h.wait(timeout=T) and h.status == "done"
    assert placed == ["A", "A", "A"], placed
    assert router.registry.get("fleet_breaker_trips_total").value > trips0
    assert router.engine_health()["B"]["breaker"] == "open"
    with router._lock:
        router._states["B"].opened_at = 0.0
    h = router.submit(PROMPT, max_new_tokens=4, sampling=GREEDY)
    assert h.wait(timeout=T)
    assert router.engine_health()["B"]["breaker"] == "closed"


def test_kill_engine_failover_token_exact_and_audit_clean(weights):
    doors = {n: _door(weights[0]) for n in ("A", "B")}
    router = FleetRouter([EngineRef(n, d.ingest.url, d.ops.url)
                          for n, d in doors.items()],
                         seed=6, breaker_cooldown=30.0)
    try:
        # 50 ms a tick: the kill lands while the victim still decodes
        with inject("serving:tick", sleep_(0.05)):
            victim = router.submit(PROMPT, max_new_tokens=24,
                                   sampling=GREEDY)
            assert _wait_tokens(victim, 3)
            dead = victim.engine
            doors[dead].ingest.kill()
            doors[dead].stop(drain=False)
            assert victim.wait(timeout=T)
        assert victim.status == "done", victim.finish_reason
        assert victim.resubmits + victim.migrations >= 1
        assert list(victim.tokens) == weights[1][0]
        report = router.shutdown(drain=True, timeout=T)
        assert report["leaked_blocks"] == 0, report
        assert report["unterminated_streams"] == 0, report
        assert dead in report["unreachable_engines"], report
    finally:
        for d in doors.values():
            d.stop(drain=False)


def test_prefill_decode_handoff_token_identical(weights):
    """Long prompts prefill on the ``prefill`` engine and decode on the
    ``decode`` one: greedy and seeded-temperature tokens equal one mixed
    engine's, the whole prompt ships in full blocks, a short prompt
    never touches the prefill engine, and the shutdown audit is clean.
    The prefill door's backlog limit shows on its readiness."""
    state = weights[0]
    reqs = [{"max_new_tokens": 24, "sampling": GREEDY},
            {"max_new_tokens": 24, "sampling": SAMP}]
    mixed = _door(state)
    router = FleetRouter([EngineRef("M", mixed.ingest.url, mixed.ops.url)],
                         seed=5)
    refs = [router.submit(PROMPT, **spec).result(timeout=T)
            for spec in reqs]
    router.shutdown(drain=True, timeout=T)
    mixed.stop(drain=False)
    assert refs[0] == weights[1][0]
    with pytest.raises(ValueError, match="role"):
        FrontDoor(_model(state), role="router", device="cpu")
    with pytest.raises(ValueError, match="prefill_backlog_limit"):
        FrontDoor(_model(state), prefill_backlog_limit=8, device="cpu")
    dp = _door(state, role="prefill", prefill_backlog_limit=512)
    dd = _door(state, role="decode")
    router = FleetRouter(
        [EngineRef("P", dp.ingest.url, dp.ops.url, role="prefill"),
         EngineRef("D", dd.ingest.url, dd.ops.url, role="decode")],
        seed=5, handoff_min_tokens=16)
    try:
        for spec, ref in zip(reqs, refs):
            h = router.submit(PROMPT, **spec)
            assert h.result(timeout=T) == ref
            assert h.placements[0] == "P" and h.placements[-1] == "D"
        t0 = time.monotonic()
        while time.monotonic() - t0 < T:
            out = router.registry.snapshot().get("fleet_kv_handoffs_total")
            if isinstance(out, dict) and sum(out.values()) >= 2:
                break
            time.sleep(0.02)
        snap = router.registry.snapshot()
        assert snap["fleet_kv_handoffs_total"].get("shipped") == 2.0
        assert snap["fleet_handoff_tokens_shipped_total"] == \
            2.0 * len(PROMPT)
        h = router.submit(PROMPT[:8], max_new_tokens=4, sampling=GREEDY)
        assert h.wait(timeout=T) and h.placements == ["D"]
        report = router.shutdown(drain=True, timeout=T)
        assert report["leaked_blocks"] == 0 and \
            report["orphaned_pins"] == 0, report
    finally:
        dp.stop(drain=False)
        dd.stop(drain=False)


# ------------------------------------------------------- engine process
def test_engine_process_oneshot_restore_token_exact(solo, weights,
                                                    tmp_path):
    """A request snapshotted HERE continues token-exact in a fresh
    process that shares nothing but the config (``"device": "cpu"``);
    the model there comes from ``model_seed``, so the frame is taken
    from an engine built the same way."""
    from paddle_tpu_torch.inference.fleet.engine_proc import _build_model
    from paddle_tpu_torch.inference import Request, ServingEngine

    config = {"model": CFG, "model_seed": 11,
              "engine": dict(ENGINE_KW, seed=99, device="cpu")}
    model = _build_model(config)
    eng = ServingEngine(model, **ENGINE_KW, device="cpu")
    req = eng.submit(Request(prompt=PROMPT, max_new_tokens=12,
                             sampling=SamplingParams(temperature=0.9,
                                                     seed=3)))
    eng.run(max_steps=4)
    frame = eng.snapshot_request_bytes(req.id)
    eng.run()
    (tmp_path / "req.snap").write_bytes(frame)
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.inference.fleet."
         "engine_proc", "--config", json.dumps(config),
         "--oneshot-restore", str(tmp_path / "req.snap")],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT ")][0]
    res = json.loads(line[len("RESULT "):])
    assert res["outcome"] == "swap_in", res
    assert res["tokens"] == req.tokens
    assert res["finish_reason"] == "length"
    assert set(res["launches"]) == {"K2", "K4", "K5", "K4-int8", "K5-int8"}


def test_entry_points_default_to_the_card(weights):
    """Without ``device="cpu"`` the front door and the engine process
    ask for the card and raise on a host without one; nothing falls back
    to the CPU."""
    from paddle_tpu_torch.inference.fleet.engine_proc import _build_model

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is served")
    with pytest.raises(RuntimeError, match='device="cpu"|device=\'cpu\''):
        FrontDoor(_model(weights[0]), **ENGINE_KW)
    with pytest.raises(RuntimeError, match='device="cpu"|device=\'cpu\''):
        _build_model({"model": CFG, "model_seed": 0, "engine": {}})
