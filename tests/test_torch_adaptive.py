"""The port's adaptive serving controllers (``paddle_tpu_torch.inference.
adaptive``) against the JAX package's, and the engine's three knobs.

Controller layer: each port controller and its reference counterpart
(``paddle_tpu.inference.adaptive``, pure Python) are fed the same
sequences of synthetic windows against twin stub engines and must make
the same decisions, one for one, leaving the same knob values: the walk
and the settling, the dead band and the idle decay, the device window
over a skewed wall, the dwell, the swap crossover and the accept signal
(the scenarios of ``tests/test_adaptive.py``), then long random window
streams.

Engine layer (``gpt_tiny`` on the CPU): an adapted run gives the pinned
run's tokens with the counters, flight events and
``profile_state()["adaptations"]`` of the reference's contract; a
raising controller is absorbed and counted, a raising suite is warned
once and dropped; the dump CLI filters ``adapt`` events; the draft
model runs fewer steps at a reduced ``k_eff`` and stays token-exact; the
host tier's copy meters equal what the tier counted. One test holds the
port's adapted greedy tokens equal to the reference engine's.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.inference import adaptive as ref
from paddle_tpu_torch.inference import adaptive as port
from paddle_tpu_torch.inference import (DraftModelDrafter, NgramDrafter,
                                        Request, ServingEngine)
from paddle_tpu_torch.observability import Telemetry
from test_torch_serving import models  # noqa: F401  (fixture)

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)


# -- controller layer ---------------------------------------------------------

class _StubInner:
    block_size = 16
    prefill_chunk = 32


class _Spec:
    def __init__(self, k):
        self.k_eff = k

    def set_draft_len(self, k):
        self.k_eff = k


class _StubEngine:
    """The attribute surface the controllers read and write."""

    def __init__(self, spec_k=0, host=True):
        self.engine = _StubInner()
        self.paged = True
        self.max_len = 256
        self.spec = _Spec(spec_k) if spec_k else None
        self._spec_k = spec_k
        self._k_eff = spec_k
        self._chunks_per_tick = 1
        self._swap_min = 16
        self._host = object() if host else None


def _window(programs=None, mean_accept=None, slot_steps=0,
            swap_seconds=0.0, swap_blocks=0, backlog=1):
    return {"programs": programs or {}, "mean_accept": mean_accept,
            "slot_steps": slot_steps, "swap_seconds": swap_seconds,
            "swap_blocks": swap_blocks, "prefill_backlog": backlog}


def _progs(pf=None, dc=None, name="decode_step"):
    out = {}
    if pf is not None:
        out["chunk_prefill"] = dict(zip(("dispatches", "wall_s",
                                         "device_window_s"), pf))
    if dc is not None:
        out[name] = dict(zip(("dispatches", "wall_s", "device_window_s"),
                             dc))
    return out


def _knobs(eng):
    return (eng._chunks_per_tick, eng._swap_min, eng._k_eff,
            eng.spec.k_eff if eng.spec is not None else None)


def _twin(make, windows, spec_k=0, setup=None):
    """Run the port's and the reference's controller (``make(module)``)
    over ``windows`` (each a window dict) on twin stubs whose knobs start
    at ``setup``: the decision trails, signals and knobs must agree at
    every window."""
    trails = []
    for mod in (port, ref):
        eng = _StubEngine(spec_k=spec_k)
        for k, v in (setup or {}).items():
            setattr(eng, k, v)
        c = make(mod)
        trail = []
        for w in windows:
            trail.append((c.step(eng, w), dict(c.last_signal), _knobs(eng)))
        trail.append((c.decisions, c.last, c.state(eng)))
        trails.append(trail)
    assert trails[0] == trails[1]
    return trails[0]


# name -> (controller of a module, windows, starting knobs, drafter k,
# the decisions the reference's own tests expect)
SCENARIOS = {
    "chunk walk and settle": (
        lambda m: m.ChunkBudgetController(stall_ratio=0.5, max_chunks=4,
                                          dwell=2),
        [_window(_progs((10, 0.10), (10, 1.60)))] * 20, {}, 0,
        [(1, 2), (2, 3), (3, 4)]),
    "chunk dead band then idle decay": (
        lambda m: m.ChunkBudgetController(stall_ratio=0.5, max_chunks=4,
                                          dwell=1),
        [_window(_progs((10, 0.2), (10, 0.8)))] * 5
        + [_window(backlog=0)] * 6, {"_chunks_per_tick": 2}, 0,
        [(2, 1)]),
    "chunk device window over a skewed wall": (
        lambda m: m.ChunkBudgetController(stall_ratio=0.5, max_chunks=4,
                                          dwell=1),
        [_window(_progs((10, 1.0, 0.10), (10, 1.0, 1.60)))] * 6, {}, 0,
        [(1, 2), (2, 3), (3, 4)]),
    "chunk falls back to the wall": (
        lambda m: m.ChunkBudgetController(stall_ratio=0.5, max_chunks=4,
                                          dwell=1),
        [_window(_progs((10, 1.0, w), (10, 1.0, 1.6)))
         for w in (0.0, 0.002, 0.0, 0.002, 0.0)], {}, 0,
        []),
    "chunk verify program": (
        lambda m: m.ChunkBudgetController(dwell=1),
        [_window(_progs((4, 0.04), (4, 0.4), name="verify"))] * 6, {}, 4,
        [(1, 2), (2, 3)]),
    "dwell blocks single-window noise": (
        lambda m: m.ChunkBudgetController(stall_ratio=0.5, max_chunks=4,
                                          dwell=3),
        [_window(_progs((5, 0.05), (5, 0.40)))] * 2
        + [_window(_progs((5, 0.40), (5, 0.40)))]
        + [_window(_progs((5, 0.05), (5, 0.40)))] * 3, {}, 0,
        [(1, 2)]),
    "swap crossover": (
        lambda m: m.SwapMinController(band=0.25, dwell=1),
        [_window(_progs((10, 0.32)), swap_seconds=0.0016, swap_blocks=1)]
        * 3
        + [_window(_progs((10, 0.32)), swap_seconds=0.16, swap_blocks=1)] * 3
        + [_window(_progs((10, 0.32)), swap_seconds=0.016,
                   swap_blocks=1)] * 3
        + [_window(_progs((10, 0.32)))], {"_swap_min": 32}, 0,
        [(32, 16), (16, 32), (32, 48), (48, 64)]),
    "swap capped by max_tokens": (
        lambda m: m.SwapMinController(dwell=1, max_tokens=48),
        [_window(_progs((10, 0.32)), swap_seconds=0.5, swap_blocks=1)] * 6,
        {}, 0,
        [(16, 32), (32, 48)]),
    "draft length tracks accept": (
        lambda m: m.DraftLenController(dwell=1),
        [_window(mean_accept=0.5, slot_steps=40)] * 6
        + [_window(mean_accept=3.8, slot_steps=40)] * 6 + [_window()],
        {}, 4,
        [(4, 3), (3, 2), (2, 1), (1, 2), (2, 3), (3, 4)]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_controllers_decide_as_the_reference(name):
    make, windows, setup, spec_k, want = SCENARIOS[name]
    trail = _twin(make, windows, spec_k=spec_k, setup=setup)
    # the decisions the reference's own tests expect of these windows
    assert [d for d, _, _ in trail[:-1] if d is not None] == want


def _random_windows(seed, n=300):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        progs = {}
        if rs.rand() < 0.85:
            d = int(rs.randint(1, 20))
            progs["chunk_prefill"] = {
                "dispatches": d, "wall_s": float(rs.uniform(0.001, 0.05) * d),
                "device_window_s": float(rs.choice([0.0, 1e-4, 0.01]) * d)}
        if rs.rand() < 0.85:
            d = int(rs.randint(1, 20))
            progs[rs.choice(["decode_step", "verify"])] = {
                "dispatches": d, "wall_s": float(rs.uniform(0.001, 0.2) * d),
                "device_window_s": float(rs.choice([0.0, 0.002, 0.05]) * d)}
        steps = int(rs.choice([0, 40]))
        out.append(_window(
            progs, mean_accept=float(rs.uniform(0, 4)) if steps else None,
            slot_steps=steps, swap_seconds=float(rs.uniform(0, 0.05)),
            swap_blocks=int(rs.choice([0, 1, 3])),
            backlog=int(rs.choice([0, 1, 2]))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_window_streams_decide_as_the_reference(seed):
    """Long random streams through the whole suite's controllers at dwell
    1 and 2: the same decisions window by window."""
    windows = _random_windows(seed)
    for dwell in (1, 2):
        for make in (
                lambda m: m.ChunkBudgetController(dwell=dwell),
                lambda m: m.SwapMinController(dwell=dwell),
                lambda m: m.DraftLenController(dwell=dwell)):
            _twin(make, windows, spec_k=4)


def test_suite_window_and_validation_as_the_reference():
    prev = {"programs": {"decode_step": {
                "dispatches": 10, "wall_s": 1.0, "device_window_s": 0.5},
                "verify": {"dispatches": 3, "wall_s": 0.3}},
            "metrics_id": 1, "accepted": 4.0, "slot_steps": 8,
            "swap_seconds": 0.25, "swap_blocks": 2}
    snap = {"programs": {"decode_step": {
                "dispatches": 30, "wall_s": 3.0, "device_window_s": 2.0},
                "chunk_prefill": {"dispatches": 2, "wall_s": 0.1},
                "verify": {"dispatches": 3, "wall_s": 0.3}},
            "metrics_id": 1, "accepted": 20.0, "slot_steps": 24,
            "swap_seconds": 1.0, "swap_blocks": 5}
    got = [m.AdaptiveSuite([m.ChunkBudgetController()])._window(prev, snap)
           for m in (port, ref)]
    assert got[0] == got[1]
    assert got[0]["programs"]["decode_step"] == {
        "dispatches": 20, "wall_s": 2.0, "device_window_s": 1.5}
    assert port.AdaptiveSuite()._window(
        prev, dict(snap, metrics_id=2)) is None
    for m in (port, ref):
        with pytest.raises(ValueError, match="interval"):
            m.AdaptiveSuite(interval=0)
        with pytest.raises(ValueError, match="duplicate"):
            m.AdaptiveSuite([m.ChunkBudgetController(),
                             m.ChunkBudgetController()])
        with pytest.raises(ValueError, match="dwell"):
            m.ChunkBudgetController(dwell=0)
        with pytest.raises(ValueError, match="stall_ratio"):
            m.ChunkBudgetController(stall_ratio=0)
    eng = _StubEngine(spec_k=0, host=False)
    assert set(port.AdaptiveSuite().state(eng)["controllers"]) == \
        set(ref.AdaptiveSuite().state(eng)["controllers"]) == \
        {"chunk_budget"}


# -- engine layer ---------------------------------------------------------------

PROMPTS = [[7, 3, 9, 11, 2, 5, 8, 4] * 3 + [21, 22],
           [7, 3, 9, 11, 2, 5, 8, 4] * 3 + [30],
           list(range(1, 30)), [17, 23, 4, 9]]
KW = dict(max_batch_slots=2, max_len=96, top_k=1, prefill_chunk=16,
          block_size=16)


def _serve(pm, adaptive=None, spec=None, n=8, **kw):
    eng = ServingEngine(pm, **{**KW, **kw}, adaptive=adaptive, spec=spec,
                        device="cpu")
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=n,
                               greedy=True)) for p in PROMPTS]
    eng.run(max_steps=2000)
    assert all(r.status == "done" for r in reqs), [r.status for r in reqs]
    return [r.tokens for r in reqs], eng


class _ForceChunk(port.AdaptiveController):
    """A deterministic decision source: the chunk budget to 2 once."""

    name = "chunk_budget"

    def __init__(self):
        super().__init__(dwell=1)

    def value(self, engine):
        return engine._chunks_per_tick

    def propose(self, engine, window):
        self.last_signal = {"forced": True,
                            "backlog": window["prefill_backlog"]}
        return 2 if engine._chunks_per_tick == 1 else None

    def apply(self, engine, value):
        engine._chunks_per_tick = int(value)


@pytest.fixture(scope="module")
def base(models):
    return _serve(models[1])[0]


def test_adapted_run_token_identical_and_flat(models, base):
    pm = models[1]
    suite = port.AdaptiveSuite([_ForceChunk()], interval=2)
    toks, eng = _serve(pm, adaptive=suite)
    assert toks == base
    assert eng._chunks_per_tick == 2 and suite.decisions_total == 1
    assert eng.telemetry.recompile_events() == 0
    assert eng.engine.executable_count() == 2
    reg = eng.telemetry.registry
    assert reg.get("serving_adaptive_decisions_total")._values == {
        ("chunk_budget",): 1.0}
    assert reg.get("serving_adaptive_value")._values[
        ("chunk_budget",)] == 2.0
    assert reg.get("serving_adaptive_errors_total").value == 0.0
    evs = eng.telemetry.recorder.events(kind="adapt")
    assert len(evs) == 1 and evs[0]["controller"] == "chunk_budget"
    assert (evs[0]["old"], evs[0]["new"]) == (1, 2)
    assert evs[0]["signal"]["forced"] is True
    ad = eng.profile_state()["adaptations"]
    assert ad["decisions_total"] == 1 and ad["interval"] == 2
    assert ad["controllers"]["chunk_budget"]["value"] == 2
    assert ad["controllers"]["chunk_budget"]["last"]["new"] == 2
    # without a suite the section is None and the knobs are pinned
    _, plain = _serve(pm)
    assert plain.profile_state()["adaptations"] is None
    assert plain._chunks_per_tick == 1 and plain._k_eff == 0


def test_chunk_budget_keeps_the_chunks_and_cuts_the_ticks(models, base):
    """A budget of 4 from the start: the same chunks and tokens in
    fewer ticks; set_telemetry re-arms the suite's families."""
    pm = models[1]
    toks1, e1 = _serve(pm)
    eng = ServingEngine(pm, **KW, device="cpu",
                        adaptive=port.AdaptiveSuite([_ForceChunk()]))
    eng._chunks_per_tick = 4
    tel = Telemetry()
    eng.set_telemetry(tel)
    assert tel.registry.get("serving_adaptive_decisions_total") is not None
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=8,
                               greedy=True)) for p in PROMPTS]
    agg = eng.run(max_steps=2000).aggregate()
    assert [r.tokens for r in reqs] == toks1 == base
    a1 = e1.metrics.aggregate()
    assert agg["prefill_chunks"] == a1["prefill_chunks"]
    assert eng._ticks_total < e1._ticks_total


def test_default_suite_converges_on_a_repeated_trace(models, base):
    pm = models[1]
    suite = port.AdaptiveSuite(interval=4)
    toks, eng = _serve(pm, adaptive=suite)
    assert toks == base
    settled = suite.decisions_total
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=8,
                               greedy=True)) for p in PROMPTS]
    eng.run(max_steps=2000)
    assert [r.tokens for r in reqs] == base
    assert suite.decisions_total == settled
    assert eng.telemetry.recompile_events() == 0


def test_raising_controller_absorbed_and_counted(models, base):
    class _Broken(port.AdaptiveController):
        name = "broken"

        def value(self, engine):
            return 0

        def propose(self, engine, window):
            raise RuntimeError("boom")

        def apply(self, engine, value):
            pass

    suite = port.AdaptiveSuite([_Broken()], interval=2)
    toks, eng = _serve(models[1], adaptive=suite)
    assert toks == base
    assert eng._adaptive is suite
    assert eng.telemetry.registry.get(
        "serving_adaptive_errors_total").value >= 1.0
    assert eng.telemetry.recorder.events(kind="adapt") == []


def test_raising_suite_is_warned_once_and_dropped(models, base):
    class _Bad(port.AdaptiveSuite):
        def on_tick(self, engine):
            raise RuntimeError("suite down")

    with pytest.warns(RuntimeWarning, match="adaptive suite disabled"):
        toks, eng = _serve(models[1], adaptive=_Bad([_ForceChunk()]))
    assert toks == base
    assert eng._adaptive is None and eng._adaptive_warned


def test_dump_cli_filters_adapt_events(models, tmp_path, capsys):
    suite = port.AdaptiveSuite([_ForceChunk()], interval=2)
    _, eng = _serve(models[1], adaptive=suite)
    path = str(tmp_path / "flight.jsonl")
    eng.telemetry.recorder.save(path)
    from paddle_tpu_torch.observability.dump import main

    assert main([path, "--kind", "adapt"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if not ln.startswith("#")]
    assert len(lines) == 1
    assert "adapt" in lines[0] and '"chunk_budget"' in lines[0]
    assert main([path, "--summary"]) == 0
    assert "adapt" in capsys.readouterr().out


def test_draft_model_k_eff_runs_fewer_steps_token_exact(models):
    pm = models[1]
    base6, _ = _serve(pm, n=6)
    toks_full, eng_full = _serve(
        pm, spec=DraftModelDrafter(pm, k=3, prefill_chunk=16), n=6)
    assert toks_full == base6
    spec = DraftModelDrafter(pm, k=3, prefill_chunk=16)
    eng = ServingEngine(pm, **KW, spec=spec, device="cpu")
    eng._k_eff = 1
    spec.set_draft_len(1)
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=6,
                               greedy=True)) for p in PROMPTS]
    eng.run(max_steps=2000)
    assert [r.tokens for r in reqs] == base6
    full_n = eng_full.spec.engine.programs.dispatch_stats()[
        "decode_step"]["dispatches"]
    cut_n = spec.engine.programs.dispatch_stats()[
        "decode_step"]["dispatches"]
    assert cut_n < full_n, (cut_n, full_n)
    # committed tokens a verify step never exceed k_eff + 1
    steps = [s for s in eng.metrics.step_samples if "accepted" in s]
    assert all(s["accepted"] <= s["active"] for s in steps)
    with pytest.raises(ValueError, match="k_eff"):
        spec.set_draft_len(5)
    with pytest.raises(ValueError, match="k_eff"):
        NgramDrafter(k=2).set_draft_len(0)


def test_ngram_k_eff_under_the_draft_len_controller(models):
    """An n-gram drafter at k 4 with the accept signal steering k_eff:
    the tokens of the plain run, every decision counted."""
    pm = models[1]
    base10, _ = _serve(pm, n=10)
    ctrl = port.DraftLenController(dwell=1)
    suite = port.AdaptiveSuite([ctrl], interval=2)
    toks, eng = _serve(pm, adaptive=suite, spec=NgramDrafter(k=4), n=10)
    assert toks == base10
    assert eng._k_eff == eng.spec.k_eff
    assert ctrl.decisions == suite.decisions_total
    assert len(eng.telemetry.recorder.events(kind="adapt")) == \
        ctrl.decisions


def test_host_tier_copy_meters_equal_the_tiers_counts(models):
    """Spills and swap-backs through the SwapMinController: the meters
    count every block the tier moved, their seconds are positive, and
    the tokens are the roomy run's."""
    pm = models[1]
    prompts = [[5, 9, 2, 11, 4, 7, 8, 3] * 3, [3, 3, 7, 1, 8, 2, 9, 4] * 3,
               [17, 23, 2, 9, 14, 6, 1, 12] * 3]
    kw = dict(max_batch_slots=3, max_len=64, top_k=1, prefill_chunk=16,
              seed=7, block_size=8, device="cpu")

    def run(**extra):
        eng = ServingEngine(pm, **kw, **extra)
        reqs = [eng.submit(Request(prompt=p, max_new_tokens=16,
                                   greedy=True)) for p in prompts]
        agg = eng.run(max_steps=3000).aggregate()
        return [r.tokens for r in reqs], agg, eng

    roomy, _, _ = run()
    toks, agg, eng = run(num_blocks=13, host_tier_blocks=16,
                         adaptive=port.AdaptiveSuite(
                             [port.SwapMinController(dwell=1)], interval=1))
    assert toks == roomy
    st = eng.host_tier_state()
    assert agg["blocks_spilled"] > 0
    assert eng._swap_cost_blocks == st["spills"] + st["swap_ins"]
    assert eng._swap_cost_s > 0 and eng._swap_cost_host_s > 0
    assert eng.profile_state()["adaptations"]["controllers"][
        "swap_min"]["value"] == eng._swap_min


def test_adapted_tokens_equal_the_reference_engines(models):
    """The same weights and trace through the reference engine with a
    forced budget of 2 and the port's: the same greedy tokens, and each
    made one decision."""
    from paddle_tpu.inference.serving import Request as JaxRequest
    from paddle_tpu.inference.serving import ServingEngine as JaxEngine

    jm, pm = models

    class _RefForce(ref.AdaptiveController):
        name = "chunk_budget"

        def __init__(self):
            super().__init__(dwell=1)

        def value(self, engine):
            return engine._chunks_per_tick

        def propose(self, engine, window):
            return 2 if engine._chunks_per_tick == 1 else None

        def apply(self, engine, value):
            engine._chunks_per_tick = int(value)

    jsuite = ref.AdaptiveSuite([_RefForce()], interval=2)
    jeng = JaxEngine(jm, **KW, adaptive=jsuite)
    jreqs = [jeng.submit(JaxRequest(prompt=list(p), max_new_tokens=8,
                                    greedy=True)) for p in PROMPTS]
    jeng.run(max_steps=2000)
    suite = port.AdaptiveSuite([_ForceChunk()], interval=2)
    toks, eng = _serve(pm, adaptive=suite)
    assert toks == [r.tokens for r in jreqs]
    assert jsuite.decisions_total == suite.decisions_total == 1
    assert eng.profile_state()["adaptations"]["controllers"][
        "chunk_budget"]["value"] == 2
