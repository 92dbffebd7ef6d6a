"""The port's request snapshots and tick-boundary jobs against the JAX
package (``tests/test_fleet.py``, ``tests/test_tiered_kv.py``).

Either package reads the other's snapshot: a live request snapshotted
mid-flight by the JAX engine restores in the port's, and the reverse,
as a byte frame (``PTRQSNP1``, a JSON header with the payload's sha256,
an npz payload) and as a checkpoint directory. The restored request
continues greedy TOKEN-EXACT against an uninterrupted run, its KV
spliced back through the host tier (``swap_in``). A bf16 frame of the
JAX engine parks its exact bits in the port's tier. A flipped payload
byte or shard byte degrades to ``corrupt_fallback`` with the same
tokens; a broken header is a ``ValueError`` with the reference's
message. ``at_tick_boundary`` runs a job inline on an idle engine and
on the tick loop's thread while ``run()`` is in flight, hands back its
result or its raise, and times out when no boundary comes.

Same weights (copied by name), dropout off, fp32 matmuls.
"""

import os
import threading
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine

from paddle_tpu_torch.inference import Request, ServingEngine
from test_torch_serving import models  # noqa: F401  (fixture)
from test_torch_serving_bf16 import models as bf16_models  # noqa: F401

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

PROMPTS = [[5, 9, 2, 11, 4, 7, 8, 3] * 3, [3, 3, 7, 1, 8, 2, 9, 4] * 2]
KW = dict(max_batch_slots=2, max_len=64, prefill_chunk=16, seed=7,
          block_size=8, host_tier_blocks=16)
N = 16


def _engine(pkg, model, **kw):
    if pkg == "jax":
        return JaxEngine(model, **{**KW, **kw})
    return ServingEngine(model, **{**KW, **kw}, device="cpu")


def _live(pkg, model, steps=5, **kw):
    """An engine mid-flight on PROMPTS (greedy): (engine, requests) after
    ``steps`` stepped ticks, request 0 past its prefill."""
    eng = _engine(pkg, model, **kw)
    R = JaxRequest if pkg == "jax" else Request
    reqs = [eng.submit(R(prompt=p, max_new_tokens=N, greedy=True))
            for p in PROMPTS]
    eng.run(max_steps=steps)
    assert 2 <= len(reqs[0].tokens) < N
    return eng, reqs


def _finish(eng, reqs):
    eng.run(max_steps=2000)
    assert all(r.status == "done" for r in reqs)
    return [list(r.tokens) for r in reqs]


def _restore_and_run(pkg, model, source, **kw):
    eng = _engine(pkg, model, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        req = eng.restore_request(source)
    outcome = req._restore_outcome
    _finish(eng, [req])
    assert eng._alloc.free_count() == eng._alloc.capacity
    assert eng._host.free_count() == eng._host.capacity
    return list(req.tokens), outcome, eng


@pytest.fixture(scope="module")
def jax_side(models):
    """The JAX engine's frame of a live request and both requests'
    uninterrupted tokens."""
    jm, _ = models
    eng, reqs = _live("jax", jm)
    frame = eng.snapshot_request_bytes(reqs[0].id)
    return frame, _finish(eng, reqs)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax",
                                       "port_to_port"])
def test_frame_restores_token_exact_across_packages(models, jax_side,
                                                    direction):
    """A live greedy request's byte frame restores on the other package's
    engine (or the port's own) with outcome ``swap_in`` and continues to
    the uninterrupted run's tokens; the snapshot and restore counters
    move by one."""
    jm, pm = models
    frame, full = jax_side
    if direction == "jax_to_port":
        toks, outcome, eng = _restore_and_run("port", pm, frame)
    else:
        src, reqs = _live("port", pm)
        pframe = src.snapshot_request_bytes(reqs[0].id)
        assert src.telemetry.registry.get(
            "serving_request_snapshots_total").value == 1
        assert _finish(src, reqs) == full
        toks, outcome, eng = _restore_and_run(
            "jax" if direction == "port_to_jax" else "port",
            jm if direction == "port_to_jax" else pm, pframe)
    assert outcome == "swap_in"
    assert toks == full[0]
    assert eng.telemetry.registry.get(
        "serving_request_restores_total").snapshot() == {"swap_in": 1.0}


def test_directory_snapshot_reads_in_both_packages(models, jax_side,
                                                   tmp_path):
    """``snapshot_request(rid, path)`` writes a checkpoint directory in
    the reference's format: the port and the JAX engine restore it
    token-exact; a flipped shard byte restores ``corrupt_fallback`` from
    the commit's metadata, with the same tokens."""
    jm, pm = models
    _, full = jax_side
    src, reqs = _live("port", pm)
    version = src.snapshot_request(reqs[0].id, str(tmp_path / "snap"))
    assert version == len(reqs[0].tokens)
    for pkg, model in (("port", pm), ("jax", jm)):
        toks, outcome, _ = _restore_and_run(pkg, model,
                                            str(tmp_path / "snap"))
        assert (toks, outcome) == (full[0], "swap_in"), pkg
    shard = next(os.path.join(d, f) for d, _, fs in
                 os.walk(tmp_path / "snap") for f in fs
                 if f.endswith(".npz"))
    raw = bytearray(open(shard, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(shard, "wb").write(bytes(raw))
    toks, outcome, _ = _restore_and_run("port", pm, str(tmp_path / "snap"))
    assert (toks, outcome) == (full[0], "corrupt_fallback")


def test_corrupt_payload_falls_back_with_the_same_tokens(models, jax_side):
    _, pm = models
    frame, full = jax_side
    bad = bytearray(frame)
    bad[-40] ^= 0xFF
    toks, outcome, eng = _restore_and_run("port", pm, bytes(bad))
    assert (toks, outcome) == (full[0], "corrupt_fallback")
    assert eng.telemetry.registry.get(
        "serving_request_restores_total").snapshot() == {
            "corrupt_fallback": 1.0}


@pytest.mark.parametrize("case", ["magic", "truncated", "not_json",
                                  "kind"])
def test_corrupt_header_raises_as_the_reference(models, jax_side, case):
    _, pm = models
    frame, _ = jax_side
    hlen = int.from_bytes(frame[8:16], "little")
    bad = {"magic": b"XXXXXXXX" + frame[8:],
           "truncated": frame[:16 + hlen // 2],
           "not_json": frame[:16] + b"{" * hlen + frame[16 + hlen:],
           "kind": frame.replace(b"paddle_tpu.request_snapshot.v1",
                                 b"paddle_tpu.request_snapshot.v0")}[case]
    eng = _engine("port", pm)
    with pytest.raises(ValueError) as got:
        eng.restore_request(bad)
    if case != "kind":
        with pytest.raises(ValueError) as want:
            JaxEngine._parse_snapshot_frame(bad)
        assert str(got.value) == str(want.value)
    assert eng.scheduler.depth() == 0
    assert eng._host.free_count() == eng._host.capacity


def test_snapshot_refusals_match_the_reference(models):
    """A prefilling request, a queued one and the dense arena refuse as
    the reference does; a frame for another block size or the int8 pool
    is refused before anything is parked."""
    jm, pm = models
    for pkg, model in (("jax", jm), ("port", pm)):
        R = JaxRequest if pkg == "jax" else Request
        eng = _engine(pkg, model)
        reqs = [eng.submit(R(prompt=p * 2, max_new_tokens=4, greedy=True))
                for p in PROMPTS]
        eng.run(max_steps=1)
        with pytest.raises(RuntimeError, match="still prefilling"):
            eng.snapshot_request_bytes(reqs[0].id)
        with pytest.raises(ValueError, match="holds no slot"):
            eng.snapshot_request_bytes(999)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        dense = (JaxEngine if pkg == "jax" else ServingEngine)(
            model, max_batch_slots=1, max_len=64, **kw)
        with pytest.raises(RuntimeError, match="paged pool blocks"):
            dense.snapshot_request_bytes(0)
    src, reqs = _live("port", pm)
    frame = src.snapshot_request_bytes(reqs[0].id)
    for kw, msg in (({"block_size": 16}, "block_size"),
                    ({"kv_dtype": "int8"}, "kv_dtype")):
        eng = _engine("port", pm, **kw)
        with pytest.raises(ValueError, match=msg):
            eng.restore_request(frame)
        assert eng._host.free_count() == eng._host.capacity


def test_int8_frame_restores_token_exact(models):
    _, pm = models
    src, reqs = _live("port", pm, kv_dtype="int8")
    frame = src.snapshot_request_bytes(reqs[0].id)
    full = _finish(src, reqs)
    toks, outcome, _ = _restore_and_run("port", pm, frame, kv_dtype="int8")
    assert (toks, outcome) == (full[0], "swap_in")


def test_bf16_frame_of_the_reference_parks_its_bits(bf16_models):
    """The JAX engine's bf16 pools ship as numpy's raw 2-byte elements:
    the port reads them through int16 and parks the very bits in its
    host tier, and the restored request serves to its budget with the
    frame's tokens as its prefix; a bf16 frame of the port restores in
    the port token-exact."""
    jm, pm = bf16_models
    eng, reqs = _live("jax", jm)
    frame = eng.snapshot_request_bytes(reqs[0].id)
    arrays, extra, corrupt = ServingEngine._parse_snapshot_frame(frame)
    assert corrupt is None and arrays["kv_k"].dtype.itemsize == 2
    port = _engine("port", pm)
    req = port.restore_request(frame)
    assert req._restore_outcome == "swap_in"
    kseg, vseg, _, _ = port._host.read(req._spill["host_blocks"])
    assert kseg.dtype == torch.bfloat16
    for got, want in ((kseg, arrays["kv_k"]), (vseg, arrays["kv_v"])):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    _finish(port, [req])
    assert req.tokens[:len(extra["tokens"])] == extra["tokens"]
    assert len(req.tokens) == N

    src, preqs = _live("port", pm)
    pframe = src.snapshot_request_bytes(preqs[0].id)
    full = _finish(src, preqs)
    toks, outcome, _ = _restore_and_run("port", pm, pframe)
    assert (toks, outcome) == (full[0], "swap_in")


def test_migrate_out_retires_and_reconciles(models, jax_side):
    """``migrate_out_request`` hands over the frame and retires the
    request ``migrated``: its blocks are back at once, the counter moves,
    and the frame continues on a peer to the uninterrupted tokens."""
    _, pm = models
    _, full = jax_side
    src, reqs = _live("port", pm)
    frame = src.migrate_out_request(reqs[0].id)
    assert reqs[0].finish_reason == "migrated"
    assert not {k: v for k, v in src.audit().items() if v}
    assert src.telemetry.registry.get(
        "serving_request_migrations_out_total").value == 1
    assert _finish(src, reqs[1:]) == full[1:]
    toks, outcome, _ = _restore_and_run("port", pm, frame)
    assert (toks, outcome) == (full[0], "swap_in")


def test_at_tick_boundary_idle_running_and_timeout(models):
    """Idle: the job runs inline, its raise re-raised. Running: the job
    runs on the tick loop's thread between ticks, and a migrate-out
    through it ends the request there. No boundary: ``TimeoutError`` and
    the job is taken back off the queue."""
    _, pm = models
    eng = _engine("port", pm)
    assert eng.at_tick_boundary(lambda: 41 + 1) == 42
    with pytest.raises(KeyError, match="boom"):
        eng.at_tick_boundary(lambda: {}["boom"])
    assert not eng.boundary_jobs_pending()

    reqs = [eng.submit(Request(prompt=p, max_new_tokens=40, greedy=True))
            for p in PROMPTS]
    seen, frames = {}, []
    started = threading.Event()

    def on_token(req, tok, done):
        started.set()

    reqs[0].on_token = on_token
    th = threading.Thread(target=lambda: seen.setdefault(
        "run", (threading.get_ident(), eng.run())), daemon=True)
    th.start()
    assert started.wait(timeout=30)

    def job():
        seen["job"] = threading.get_ident()
        frames.append(eng.migrate_out_request(reqs[0].id))
        return eng._running

    assert eng.at_tick_boundary(job, timeout=30) is True
    th.join(timeout=60)
    assert not th.is_alive()
    assert seen["job"] == seen["run"][0] != threading.get_ident()
    assert reqs[0].finish_reason == "migrated" and frames
    assert reqs[1].finish_reason == "length"

    eng._running = True         # a loop that never comes back
    with pytest.raises(TimeoutError, match="no tick boundary"):
        eng.at_tick_boundary(lambda: None, timeout=0.2)
    assert not eng.boundary_jobs_pending()
    eng._running = False
