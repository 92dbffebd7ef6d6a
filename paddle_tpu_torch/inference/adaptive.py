"""Profile-driven adaptive serving controllers.

The port's copy of ``paddle_tpu/inference/adaptive.py``, pure Python:
for the same windows against the same engine knobs every controller
makes the reference's decisions, one for one.

Small hysteresis controllers read the engine's measured signals and
move HOST-SIDE knobs only:

- :class:`ChunkBudgetController` — the number of prefill chunks the
  tick dispatches (``engine._chunks_per_tick``), from the warm
  chunk-prefill to decode/verify ratio of the dispatch ledger: spend
  up to ``stall_ratio`` of a decode step on extra chunks (the
  Sarathi-Serve stall bound, arXiv:2403.02310, closed over live
  numbers). The ratio runs on the ledger's device windows (closed on a
  CUDA event on the card) when both programs report at least
  ``min_window_s`` a dispatch, else on the warm walls. The chunk's
  shape never changes, only how many times it launches a tick.
- :class:`SwapMinController` — ``engine._swap_min`` from the observed
  swap-versus-recompute crossover: the engine times its host tier's
  spill and swap-back copies (``engine._swap_cost_s`` over
  ``engine._swap_cost_blocks``), the ledger prices a recomputed token
  from the warm chunk-prefill wall, and the threshold walks one block
  toward the cheaper side.
- :class:`DraftLenController` — the speculative commit cap
  ``engine._k_eff`` (and the drafter's ``set_draft_len``) from the
  mean accepted length, within ``{1..k}``: the verify keeps its shape
  at the constructor's k.

Every applied change is a counted, flight-recorded decision
(``serving_adaptive_decisions_total{controller=}``, an ``adapt``
flight event with old -> new and the triggering signal, a
``serving_adaptive_value`` gauge). Hysteresis, shared by every
controller: evaluate once per ``interval`` ticks, step the knob by one
unit, only after ``dwell`` consecutive windows agree, and only past a
dead band on the signal.

Adaptation changes scheduling and commit pacing only; KV contents are
a function of token ids and sampling is keyed by position, so an
adapted run gives the tokens of a pinned-knob run.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

__all__ = ["AdaptiveController", "ChunkBudgetController",
           "SwapMinController", "DraftLenController", "AdaptiveSuite"]


class AdaptiveController:
    """One knob's closed loop: propose-with-hysteresis, step by one.

    Subclasses implement ``value(engine)`` (read the live knob),
    ``propose(engine, window)`` (the next value, or None for "hold" —
    already one step at most from current, past the dead band), and
    ``apply(engine, value)``. ``step()`` wraps them in the shared
    dwell discipline: a change applies only after ``dwell``
    consecutive windows propose the SAME target, so one noisy window
    can never move a knob."""

    name = "controller"
    unit = ""

    def __init__(self, dwell: int = 2):
        if dwell < 1:
            raise ValueError(f"dwell must be >= 1, got {dwell}")
        self.dwell = int(dwell)
        self.decisions = 0
        self.last: Optional[Dict[str, Any]] = None
        self.last_signal: Dict[str, Any] = {}
        self._proposed: Optional[Any] = None
        self._agree = 0

    # -- subclass surface --------------------------------------------------
    def applies(self, engine) -> bool:
        return True

    def value(self, engine):
        raise NotImplementedError

    def propose(self, engine, window):
        raise NotImplementedError

    def apply(self, engine, value):
        raise NotImplementedError

    # -- the shared loop ---------------------------------------------------
    def step(self, engine, window):
        """One evaluation window. Returns ``(old, new)`` when a change
        was applied this window, else None."""
        cur = self.value(engine)
        new = self.propose(engine, window)
        if new is None or new == cur:
            self._proposed, self._agree = None, 0
            return None
        if self._proposed == new:
            self._agree += 1
        else:
            self._proposed, self._agree = new, 1
        if self._agree < self.dwell:
            return None
        self._proposed, self._agree = None, 0
        self.apply(engine, new)
        self.decisions += 1
        self.last = {"old": cur, "new": new,
                     "signal": dict(self.last_signal)}
        return cur, new

    def state(self, engine) -> Dict[str, Any]:
        return {"value": self.value(engine), "unit": self.unit,
                "decisions": self.decisions, "last": self.last}


class ChunkBudgetController(AdaptiveController):
    """Prefill chunks per tick from the measured chunk/decode walls.

    Target: ``floor(stall_ratio * decode_wall / chunk_wall)`` clamped
    to ``[1, max_chunks]`` — dispatch as many chunk prefills per tick
    as fit in ``stall_ratio`` of one measured decode/verify step, the
    Sarathi stall bound closed over live numbers instead of a
    constant. Warm walls only (the ledger's cold split keeps compile
    ticks out of the loop); when both programs report a device-side
    window of at least ``min_window_s`` per dispatch the ratio runs on
    that instead of the enqueue-skewed wall; a dead ``band`` around
    the target absorbs measurement noise; the knob moves ONE chunk
    per decision."""

    name = "chunk_budget"
    unit = "chunks/tick"

    def __init__(self, stall_ratio: float = 0.5, max_chunks: int = 4,
                 band: float = 0.25, dwell: int = 2,
                 min_window_s: float = 1e-3):
        super().__init__(dwell=dwell)
        if not 0.0 < stall_ratio:
            raise ValueError(f"stall_ratio must be > 0, got {stall_ratio}")
        if max_chunks < 1:
            raise ValueError(f"max_chunks must be >= 1, got {max_chunks}")
        self.stall_ratio = float(stall_ratio)
        self.max_chunks = int(max_chunks)
        self.band = float(band)
        self.min_window_s = float(min_window_s)

    def value(self, engine) -> int:
        return int(engine._chunks_per_tick)

    def apply(self, engine, value):
        engine._chunks_per_tick = int(value)

    def propose(self, engine, window) -> Optional[int]:
        progs = window["programs"]
        pf = progs.get("chunk_prefill")
        dc = progs.get("verify") or progs.get("decode_step")
        self.last_signal = {
            "chunk_dispatches": pf["dispatches"] if pf else 0,
            "decode_dispatches": dc["dispatches"] if dc else 0,
            "prefill_backlog": window["prefill_backlog"],
        }
        cur = self.value(engine)
        if not pf or not dc or not pf["dispatches"] \
                or not dc["dispatches"]:
            # no measurable ratio this window: decay an idle budget
            # back toward 1 (nothing is prefilling, so an inflated
            # budget is stale state, not a measured verdict)
            if window["prefill_backlog"] == 0 and cur > 1:
                return cur - 1
            return None
        # the device-side window: the warm WALL of a deferred dispatch
        # is mostly host-side enqueue — skewed enqueue times would
        # steer the budget off what the device actually pays. The ratio runs on the
        # ``serving_program_device_window_seconds`` sums only when
        # BOTH programs report at least ``min_window_s`` per dispatch:
        # a synchronous dispatch closes its window inline, leaving
        # microseconds of bookkeeping residue in the sum, and steering
        # on that residue is steering on noise. Anything narrower
        # falls back to the historical warm wall.
        pf_w = pf.get("device_window_s", 0.0) / pf["dispatches"]
        dc_w = dc.get("device_window_s", 0.0) / dc["dispatches"]
        if pf_w >= self.min_window_s and dc_w >= self.min_window_s:
            per_chunk = pf_w
            per_decode = dc_w
            self.last_signal["source"] = "device_window"
        else:
            per_chunk = pf["wall_s"] / pf["dispatches"]
            per_decode = dc["wall_s"] / dc["dispatches"]
            self.last_signal["source"] = "wall"
        if per_chunk <= 0.0 or per_decode <= 0.0:
            return None
        ratio = self.stall_ratio * per_decode / per_chunk
        self.last_signal["wall_ratio"] = ratio
        lo = max(1, min(self.max_chunks,
                        int(math.floor(ratio * (1.0 - self.band)))))
        hi = max(1, min(self.max_chunks,
                        int(math.floor(ratio * (1.0 + self.band)))))
        if lo > cur:
            return cur + 1
        if hi < cur:
            return cur - 1
        return None


class SwapMinController(AdaptiveController):
    """``swap_min_tokens`` from the observed swap/recompute ratio.

    The engine times its spill + swap-back copies (cumulative counted
    seconds and blocks); the dispatch ledger prices a recomputed token
    from the warm chunk-prefill wall. When the measured per-token swap
    cost is cheaper than recompute past the dead ``band``, the
    threshold drops one block (spill more); when dearer, it rises one
    block (recompute more)."""

    name = "swap_min"
    unit = "tokens"

    def __init__(self, band: float = 0.25, dwell: int = 2,
                 max_tokens: Optional[int] = None):
        super().__init__(dwell=dwell)
        self.band = float(band)
        self.max_tokens = max_tokens

    def applies(self, engine) -> bool:
        return engine._host is not None

    def value(self, engine) -> int:
        return int(engine._swap_min)

    def apply(self, engine, value):
        engine._swap_min = int(value)

    def propose(self, engine, window) -> Optional[int]:
        bs = int(engine.engine.block_size) if engine.paged else 0
        if bs <= 0:
            return None
        pf = window["programs"].get("chunk_prefill")
        swap_s = window["swap_seconds"]
        swap_blocks = window["swap_blocks"]
        self.last_signal = {"swap_seconds": swap_s,
                            "swap_blocks": swap_blocks}
        if swap_blocks <= 0 or not pf or not pf["dispatches"] \
                or pf["wall_s"] <= 0.0:
            return None
        chunk_tokens = int(engine.engine.prefill_chunk)
        recompute_tok = pf["wall_s"] / (pf["dispatches"] * chunk_tokens)
        swap_tok = swap_s / (swap_blocks * bs)
        if recompute_tok <= 0.0:
            return None
        ratio = swap_tok / recompute_tok
        self.last_signal["cost_ratio"] = ratio
        cur = self.value(engine)
        cap = int(self.max_tokens) if self.max_tokens is not None \
            else int(engine.max_len)
        if ratio < 1.0 - self.band and cur - bs >= bs:
            return cur - bs
        if ratio > 1.0 + self.band and cur + bs <= cap:
            return cur + bs
        return None


class DraftLenController(AdaptiveController):
    """Effective draft length k_eff from the accept-length signal.

    The verify executable is compiled ONCE at the ctor's k; k_eff
    rides it as a host commit clamp (and the drafter stops proposing
    past it — compiled draft-model steps saved, the ngram drafter's
    host loop untouched), so the whole k-set {1..k} is pre-compiled
    by construction. Near-ceiling mean accept (drafts almost always
    fully taken) raises k_eff one step; mean accept under half the
    current length lowers it — wasted draft positions are wasted
    draft work every tick."""

    name = "draft_len"
    unit = "tokens"

    def __init__(self, raise_frac: float = 0.8, lower_frac: float = 0.5,
                 dwell: int = 2):
        super().__init__(dwell=dwell)
        self.raise_frac = float(raise_frac)
        self.lower_frac = float(lower_frac)

    def applies(self, engine) -> bool:
        return engine.spec is not None

    def value(self, engine) -> int:
        return int(engine._k_eff)

    def apply(self, engine, value):
        engine._k_eff = int(value)
        setter = getattr(engine.spec, "set_draft_len", None)
        if setter is not None:
            setter(int(value))

    def propose(self, engine, window) -> Optional[int]:
        mean_accept = window["mean_accept"]
        self.last_signal = {"mean_accept": mean_accept,
                            "slot_steps": window["slot_steps"]}
        if mean_accept is None or window["slot_steps"] <= 0:
            return None
        cur = self.value(engine)
        if mean_accept >= self.raise_frac * cur and \
                cur < int(engine._spec_k):
            return cur + 1
        if mean_accept < self.lower_frac * cur and cur > 1:
            return cur - 1
        return None


class AdaptiveSuite:
    """The engine's adaptation loop: windowed signal snapshots, one
    hysteresis step per controller per window, counted + recorded
    decisions.

    Pass to ``ServingEngine(adaptive=AdaptiveSuite())``; the engine
    calls :meth:`on_tick` once per tick behind an absorb-count-warn
    guard (adaptation is POLICY, never a crash source — an erroring
    controller is counted on ``serving_adaptive_errors_total`` and
    the tick continues on the knobs it had). Default controllers:
    chunk budget, swap-min (active only with a host tier), draft
    length (active only with speculation)."""

    def __init__(self,
                 controllers: Optional[List[AdaptiveController]] = None,
                 interval: int = 16):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self.interval = int(interval)
        self.controllers = list(controllers) if controllers is not None \
            else [ChunkBudgetController(), SwapMinController(),
                  DraftLenController()]
        names = [c.name for c in self.controllers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate controller names: {names}")
        self._ticks = 0
        self._snap: Optional[Dict[str, Any]] = None
        self.decisions_total = 0
        self._c_dec = self._g_val = self._c_err = None
        self._recorder = None

    # -- engine wiring -----------------------------------------------------
    def arm(self, engine):
        """Register the suite's counted families on the engine's
        registry (eager, so a scrape before the first decision shows
        explicit 0s / current values) and attach the flight ring.
        Re-armed by ``set_telemetry`` like every serving family."""
        r = engine.telemetry.registry
        self._c_dec = r.counter(
            "serving_adaptive_decisions_total",
            "controller knob changes applied (old != new, past "
            "hysteresis), by controller — a CONVERGED controller "
            "stops adding here", labelnames=("controller",))
        self._g_val = r.gauge(
            "serving_adaptive_value",
            "current adapted knob value per controller "
            "(chunk_budget: chunks/tick; swap_min: tokens; "
            "draft_len: k_eff tokens)", labelnames=("controller",))
        self._c_err = r.counter(
            "serving_adaptive_errors_total",
            "controller evaluations that raised and were absorbed "
            "(adaptation is policy, never control flow; the tick "
            "continues on the previous knob values)")
        self._recorder = engine.telemetry.recorder
        for c in self.controllers:
            if c.applies(engine):
                self._g_val.labels(controller=c.name).set(
                    c.value(engine))

    def on_tick(self, engine):
        """One tick's worth of the loop: every ``interval`` ticks,
        snapshot the counted signals, diff against the previous
        snapshot, and give each applicable controller one hysteresis
        step over the window."""
        self._ticks += 1
        if self._ticks % self.interval:
            return
        snap = self._snapshot(engine)
        prev, self._snap = self._snap, snap
        window = self._window(prev, snap)
        if window is None:
            return
        for c in self.controllers:
            if not c.applies(engine):
                continue
            try:
                res = c.step(engine, window)
            except Exception:
                if self._c_err is not None:
                    self._c_err.inc()
                continue
            if self._g_val is not None:
                self._g_val.labels(controller=c.name).set(
                    c.value(engine))
            if res is None:
                continue
            old, new = res
            self.decisions_total += 1
            if self._c_dec is not None:
                self._c_dec.labels(controller=c.name).inc()
            if self._recorder is not None:
                self._recorder.record(
                    "adapt", controller=c.name, old=old, new=new,
                    signal=dict(c.last_signal))

    # -- signals -----------------------------------------------------------
    def _snapshot(self, engine) -> Dict[str, Any]:
        """Cumulative counted signals at a window boundary: the warm
        per-program dispatch ledger (merged over every ProgramSet the
        engine dispatches through), the speculative accept stream,
        and the swap cost meters (the copies' own time: CUDA events on
        the card, the host clock on the CPU)."""
        programs: Dict[str, Dict[str, float]] = {}
        for ps in engine._program_sets():
            for name, st in ps.dispatch_stats().items():
                agg = programs.setdefault(
                    name, {"dispatches": 0, "wall_s": 0.0,
                           "device_window_s": 0.0})
                agg["dispatches"] += int(st.get("dispatches", 0)) \
                    - int(st.get("cold_dispatches", 0))
                agg["wall_s"] += float(st.get("wall_s", 0.0))
                agg["device_window_s"] += \
                    float(st.get("device_window_s", 0.0))
        samples = engine.metrics.step_samples
        acc = sum(s.get("accepted", 0.0) for s in samples
                  if "accepted" in s)
        slot_steps = sum(s["active"] for s in samples
                         if "accepted" in s)
        return {"programs": programs,
                "metrics_id": id(engine.metrics),
                "accepted": acc, "slot_steps": slot_steps,
                "swap_seconds": float(engine._swap_cost_s),
                "swap_blocks": int(engine._swap_cost_blocks)}

    def _window(self, prev, snap) -> Optional[Dict[str, Any]]:
        if prev is None or prev["metrics_id"] != snap["metrics_id"]:
            # first window, or run() opened a fresh metrics window
            # mid-interval: cumulative deltas would mix epochs
            return None
        programs: Dict[str, Dict[str, float]] = {}
        for name, st in snap["programs"].items():
            base = prev["programs"].get(
                name, {"dispatches": 0, "wall_s": 0.0,
                       "device_window_s": 0.0})
            d = int(st["dispatches"]) - int(base["dispatches"])
            w = float(st["wall_s"]) - float(base["wall_s"])
            dw = float(st.get("device_window_s", 0.0)) \
                - float(base.get("device_window_s", 0.0))
            if d > 0 and w >= 0.0:
                programs[name] = {"dispatches": d, "wall_s": w,
                                  "device_window_s": max(dw, 0.0)}
        slot_steps = snap["slot_steps"] - prev["slot_steps"]
        accepted = snap["accepted"] - prev["accepted"]
        return {
            "programs": programs,
            "slot_steps": slot_steps,
            "mean_accept": (accepted / slot_steps)
            if slot_steps > 0 else None,
            "swap_seconds": snap["swap_seconds"]
            - prev["swap_seconds"],
            "swap_blocks": snap["swap_blocks"] - prev["swap_blocks"],
            "prefill_backlog": self._prefill_backlog,
        }

    _prefill_backlog = 0

    def _snapshot_backlog(self, engine):
        self._prefill_backlog = sum(
            1 for st in engine._pf if st is not None)

    def state(self, engine) -> Dict[str, Any]:
        """The ``/debug/profile`` "adaptations" section: per-controller
        current value, last decision, decision counts — the live
        answer to "what has the engine tuned itself to"."""
        return {
            "interval": self.interval,
            "decisions_total": self.decisions_total,
            "controllers": {
                c.name: c.state(engine) for c in self.controllers
                if c.applies(engine)},
        }
