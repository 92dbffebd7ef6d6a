"""Recompile sentinel: the flat-program invariant as a live guard.

The serving engine's core contract — everything (offsets, block
tables, temperatures, accept lengths) is a *runtime argument* of a
flat set of programs — is enforced by ``executable_count()``
assertions inside tests. In production the failure mode it guards
against is silent: a code change that turns a runtime value into a
shape makes every new arrival pattern a new program.

The JAX reference watches each compiled program's jit cache. The port
compiles no program per call (PyTorch runs eagerly, and the CUDA
kernels are built once per source), so the sentinel watches what a
kernel's launch grid and a CUDA graph of the decode step would be keyed
on instead: the ARGUMENT SIGNATURE of every dispatch — the shapes and
dtypes of its tensors and arrays (:func:`describe_args`), the length of
its sequences, the type of its scalars. The engine's
:class:`~paddle_tpu_torch.inference.program_set.ProgramSet` hands each
dispatch's program handle to :meth:`RecompileSentinel.observe`; the
handle's ``_cache_size()`` is the number of distinct signatures that
``(program, handle)`` has been dispatched with. The FIRST signature per
program is the warmup; each new one past it is a recompile event:

- ``recompile_events_total`` increments in the metrics registry;
- the flight recorder captures the triggering call's argument
  shapes/dtypes — the dump answers *which* argument forked the
  program, not just that one did;
- ``strict=True`` raises :class:`RecompileError` at the dispatch site
  (CI and canary mode; production default keeps serving and pages
  through the counter instead).

So a plain engine's ``executable_count()`` is the number of distinct
``(program, signature)`` pairs: 2, the padded ``(1, prefill_chunk)``
chunk and the lockstep step, as in the reference. A handle without a
``_cache_size()`` disarms the sentinel (``enabled`` flips False)
rather than report a vacuous 0 forever.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

__all__ = ["RecompileSentinel", "RecompileError", "describe_args"]


class RecompileError(RuntimeError):
    """Raised in strict mode when a watched program re-lowers."""


def describe_args(**named) -> Dict[str, str]:
    """Compact shape/dtype signature of a dispatch's arguments:
    ``{"toks": "(4,1):int32", "t": "(4,):int32", ...}``. Works on
    numpy arrays and torch tensors (shape+dtype), sequences (length),
    and scalars (type name) — cheap enough to build per dispatch."""
    out: Dict[str, str] = {}
    for name, v in named.items():
        shape = getattr(v, "shape", None)
        dtype = getattr(v, "dtype", None)
        if shape is not None and dtype is not None:
            out[name] = (f"({','.join(str(int(d)) for d in shape)})"
                         f":{dtype}")
        elif isinstance(v, (list, tuple)):
            out[name] = f"len={len(v)}"
        elif v is None:
            out[name] = "None"
        else:
            out[name] = type(v).__name__
    return out


class RecompileSentinel:
    """Watches the signature counts of an engine's program registry;
    turns growth past the warmup signature into counted, dump-visible
    recompile events.

    Parameters
    ----------
    registry : MetricsRegistry, optional
        Receives ``recompile_events_total`` (and the per-program
        ``compiled_programs_total`` warmup counter).
    recorder : FlightRecorder, optional
        Receives one ``recompile`` event per detection, carrying the
        program name and the triggering argument shapes/dtypes.
    strict : bool
        Raise :class:`RecompileError` at the dispatch site instead of
        only counting — for CI and canaries.
    """

    def __init__(self, registry=None, recorder=None, strict: bool = False):
        self.registry = registry
        self.recorder = recorder
        self.strict = strict
        self.enabled = True
        self.events = 0           # local count, registry-independent
        # keyed by (program name, fn identity): two engines sharing one
        # sentinel (target + draft arenas, or a shared Telemetry) both
        # dispatch programs NAMED 'decode_step' — name-only keying
        # would hide the second engine's warmup and then count phantom
        # recompiles on every interleaved dispatch
        self._seen: Dict[tuple, int] = {}
        # register eagerly (a scrape must show an explicit 0 — "the
        # sentinel is armed and nothing recompiled" is distinguishable
        # from "nobody was watching") and cache the handles so a
        # detection doesn't pay a registry get-or-create
        self._c_recompile = self._counter(
            "recompile_events_total",
            "compiled-program cache growth past warmup (each one is "
            "a serving stall on real hardware)")
        self._c_programs = self._counter(
            "compiled_programs_total",
            "program lowerings observed at warmup (expected once "
            "per program)")

    def _counter(self, name: str, help: str):
        if self.registry is None:
            return None
        return self.registry.counter(name, help)

    def baseline(self) -> Dict[tuple, int]:
        """Snapshot of per-(program, fn) cache sizes seen so far."""
        return dict(self._seen)

    def adopt_baseline(self, baseline: Dict[tuple, int]):
        """Seed cache-size baselines from a previous sentinel's
        :meth:`baseline` — a telemetry swap on a WARM engine
        (``ServingEngine.set_telemetry``) must carry the warmup
        knowledge over, or the first post-swap dispatch would absorb a
        real recompile as this sentinel's warmup observation."""
        self._seen.update(baseline)

    def observe(self, program: str, fn: Any,
                context: Optional[Callable[[], Dict[str, str]]] = None
                ) -> int:
        """Check one program's signature count right after a dispatch
        through it. ``context`` builds the arg summary LAZILY — it only
        runs when a recompile is actually detected, so the steady-state
        cost is one ``_cache_size()`` call. Returns the number of NEW
        signatures detected (0 in the steady state)."""
        if not self.enabled or fn is None:
            return 0
        try:
            size = int(fn._cache_size())
        except Exception:
            # a fabricated count would let the invariant pass
            # vacuously — disarm instead
            self.enabled = False
            return 0
        key = (program, id(fn))
        prev = self._seen.get(key)
        self._seen[key] = size
        if prev is None:
            # warmup compile(s): expected exactly once per program —
            # counted so a dashboard can still see cold-start activity
            if self._c_programs is not None:
                self._c_programs.inc(size)
            return 0
        grew = size - prev
        if grew <= 0:
            return 0
        self.events += grew
        args = {}
        if context is not None:
            try:
                args = context()
            except Exception:
                args = {"error": "context capture failed"}
        if self._c_recompile is not None:
            self._c_recompile.inc(grew)
        if self.recorder is not None:
            self.recorder.record("recompile", program=program,
                                 new_lowerings=grew, cache_size=size,
                                 argspec=args)
        if self.strict:
            raise RecompileError(
                f"program {program!r} re-lowered ({prev} -> {size} "
                f"cache entries); triggering args: {args} — a runtime "
                "value leaked into a traced shape")
        return grew
