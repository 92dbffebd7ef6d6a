"""The port's tick profiler and dispatch ledger, held to the reference's
(``tests/test_tick_profiler.py``).

- a profiled run is token-identical to an unprofiled one, and to the
  JAX engine's run of the same trace with the same weights;
- both packages emit the same set of phase names for the same trace;
- the top-level phases cover at least 0.95 of the tick wall (and never
  more than the wall), and ``executable_count()`` is 2 with 0
  recompiles, profiled or not;
- profiling moves no flight or tracer event (``events_emitted()``);
- a raising profiler is absorbed and counted, the run token-exact;
- the dispatch ledger counts every dispatch by program, and a warm
  dispatch's wall is its enqueue plus its device window.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.observability import Telemetry as JaxTelemetry

from paddle_tpu_torch.inference import NgramDrafter, Request, ServingEngine
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.observability import Telemetry

PROMPTS = [[7, 3, 11, 2], [5, 9], [13, 1, 4], [2, 8, 6, 10, 3],
           [9, 9, 2], [4, 12]]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    pm = GPTForCausalLM(gpt_tiny(), device="cpu")
    pm.set_state_dict({k: np.asarray(v) for k, v in jm.state_dict().items()})
    return jm, pm


def _run(pm, profile=False, telemetry=None, **kw):
    eng = ServingEngine(pm, max_batch_slots=2, max_len=64, top_k=1,
                        prefill_chunk=32, telemetry=telemetry,
                        profile=profile, device="cpu", **kw)
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=6,
                               greedy=True)) for p in PROMPTS]
    eng.run()
    assert all(r.finish_reason == "length" for r in reqs)
    return eng, [r.tokens for r in reqs]


@pytest.fixture(scope="module")
def run_off(models):
    return _run(models[1], telemetry=Telemetry())


@pytest.fixture(scope="module")
def run_on(models):
    return _run(models[1], profile=True, telemetry=Telemetry())


@pytest.fixture(scope="module")
def run_jax(models):
    tel = JaxTelemetry()
    eng = JaxEngine(models[0], max_batch_slots=2, max_len=64, top_k=1,
                    prefill_chunk=32, telemetry=tel, profile=True)
    reqs = [eng.submit(JaxRequest(prompt=list(p), max_new_tokens=6,
                                  greedy=True)) for p in PROMPTS]
    eng.run()
    return eng, [r.tokens for r in reqs]


def test_profiled_run_is_token_identical(run_on, run_off, run_jax):
    assert run_on[1] == run_off[1] == run_jax[1]


def test_same_phase_names_as_the_reference(run_on, run_jax):
    mine = run_on[0].telemetry.profiler.snapshot()["phases"]
    theirs = run_jax[0].telemetry.profiler.snapshot()["phases"]
    assert set(mine) == set(theirs)
    assert {"admission", "bookkeeping", "prefill_dispatch",
            "decode_dispatch", "overlap_window", "token_sync",
            "callbacks"} <= set(mine)
    # the same number of committed (stepped) ticks
    assert run_on[0].telemetry.profiler.ticks == \
        run_jax[0].telemetry.profiler.ticks


def test_coverage_and_flat_programs(run_on, run_off):
    eng = run_on[0]
    snap = eng.telemetry.profiler.snapshot()
    assert snap["enabled"] and snap["ticks"] > 0
    assert 0.95 <= snap["coverage_fraction"] <= 1.0 + 1e-9, snap
    for e in (run_on[0], run_off[0]):
        assert e.executable_count() == 2
        assert e.telemetry.recompile_events() == 0
    reg = eng.telemetry.registry
    prom = reg.to_prometheus_text()
    assert 'serving_tick_phase_seconds_total{phase="decode_dispatch"}' \
        in prom
    assert reg.get("serving_ticks_profiled_total").value == snap["ticks"]
    assert eng.telemetry.profiler.total_events > 0


def test_profiling_moves_no_event(run_on, run_off):
    on, off = run_on[0].telemetry, run_off[0].telemetry
    assert on.events_emitted() == off.events_emitted()
    assert on.recorder.counts() == off.recorder.counts()
    assert off.profiler.total_events == 0


def test_raising_profiler_is_absorbed(models, capsys):
    class Broken:
        enabled = True

        def tick_begin(self):
            return {}

        def tick_end(self, token, commit=True):
            raise RuntimeError("profiler gone")

        def phase(self, name):
            raise RuntimeError("profiler gone")

        def enable(self):
            return self

    tel = Telemetry()
    tel.profiler = Broken()
    eng, toks = _run(models[1], profile=True, telemetry=tel)
    assert toks == _run(models[1])[1]
    assert tel.registry.get("serving_profiler_errors_total").value > 0
    assert tel.registry.get("serving_engine_errors_total").value == 0
    assert "tick profiler raised" in capsys.readouterr().err


def test_dispatch_ledger(run_on):
    eng = run_on[0]
    stats = eng.engine.programs.dispatch_stats()
    assert set(stats) == {"chunk_prefill", "decode_step"}
    counter = eng.telemetry.registry.get("program_dispatches_total")
    assert counter.snapshot() == {name: st["dispatches"]
                                  for name, st in stats.items()}
    for st in stats.values():
        assert st["cold_dispatches"] == 1
        assert st["wall_s"] == pytest.approx(
            st["enqueue_s"] + st["device_window_s"], rel=1e-6, abs=1e-9)
    state = eng.profile_state()
    assert state["enabled"]
    assert {row["program"] for row in state["top_programs"]} == set(stats)
    util = state["replicas"]
    assert util["count"] == 1 and util["skew"] == 1.0
    assert 0.0 < util["utilization"][0] <= 1.0


def test_profiled_spec_int8_composition_is_token_identical(models):
    kw = dict(block_size=16, kv_dtype="int8", spec=NgramDrafter(k=2))
    _, on = _run(models[1], profile=True, **kw)
    kw["spec"] = NgramDrafter(k=2)
    eng, off = _run(models[1], **kw)
    assert on == off
    assert eng.executable_count() == 2


def test_draft_model_programs_keep_one_signature_each(models):
    """The draft model's arena dispatches its step with the previous
    step's device tokens and the first with host ones: one signature
    either way, so the target's chunk and verify and the draft's chunk
    and step count 4 programs and no recompile."""
    from paddle_tpu_torch.inference import DraftModelDrafter

    eng, _ = _run(models[1], block_size=16,
                  spec=DraftModelDrafter(models[1], k=3))
    assert eng.executable_count() == 4
    assert eng.telemetry.recompile_events() == 0
