"""Exportable metrics registry: Counter / Gauge / Histogram.

The serving stack's observability was three disconnected fragments —
``ServingMetrics`` dicts computed once at window end, process-global
cumulative ``RecordEvent`` stats, and ``executable_count()`` assertions
living only in tests. This module is the common sink they emit into: a
process-local registry of named metrics with two export surfaces,
Prometheus text exposition (``to_prometheus_text()`` — what a scrape
endpoint or a node-exporter textfile collector ingests) and JSON
snapshots (``snapshot()`` — what benchmarks and CI gates diff).

Design rules, in the spirit of this repo's PERF.md discipline:

- **Counted first.** Counters and histogram bucket counts are pure
  functions of the code path taken — a CPU container under noisy
  neighbours reports exactly the same values as quiet hardware. Timing
  lives only in histogram *sample values* (e.g. TTFT seconds), never in
  the control decisions, so every gate built on these metrics can use
  the tight ±2% threshold.
- **Fixed log-spaced buckets.** Latency spans decades (µs decode steps
  to seconds of queue wait); log-spaced bounds keep resolution
  proportional everywhere and FIXED bounds keep two snapshots
  mergeable/diffable — no adaptive rebinning.
- **No background threads, no locks on the hot path beyond one
  ``threading.Lock`` per registry op** — the serving loop is
  single-threaded today; the lock is for scrapers reading concurrently.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "log_buckets", "get_registry", "DEFAULT_TIME_BUCKETS",
           "DEFAULT_SIZE_BUCKETS"]


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> Tuple[float, ...]:
    """Fixed log-spaced histogram bounds covering [lo, hi]:
    ``per_decade`` bounds per power of ten, rounded to one significant
    digit pattern (1, 2, 5 for per_decade=3) so the bounds read well in
    dashboards. Deterministic — same args, same buckets — which keeps
    exported histograms from two runs mergeable bucket for bucket."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    mantissas = {1: [1.0], 2: [1.0, 3.0], 3: [1.0, 2.0, 5.0]}.get(
        per_decade)
    if mantissas is None:
        # arbitrary density: evenly spaced in log10
        mantissas = [10 ** (i / per_decade) for i in range(per_decade)]
    out: List[float] = []
    exp = math.floor(math.log10(lo))
    while True:
        for m in mantissas:
            v = m * 10 ** exp
            if v < lo * (1 - 1e-12):
                continue
            out.append(float(f"{v:.6g}"))
            if v >= hi * (1 - 1e-12):
                return tuple(out)
        exp += 1


def _escape_label(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote and newline must be escaped or a scraper's parser splits the
    sample line mid-value (tenant names are caller-controlled strings,
    so the exporter cannot assume they are clean)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n",
                                                               "\\n")


# seconds: 100µs .. 100s — covers a CPU-container decode step through a
# saturated queue wait
DEFAULT_TIME_BUCKETS = log_buckets(1e-4, 100.0)
# token counts: 1 .. 100k — prompt/new-token length distributions
DEFAULT_SIZE_BUCKETS = log_buckets(1.0, 1e5)


class _Metric:
    """Base: a named metric family with optional labels. Labeled
    children are keyed by the label-value tuple; the unlabeled family
    uses the empty tuple."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "name, not both")
            values = tuple(kv[n] for n in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got "
                f"{values}")
        return self._child(tuple(str(v) for v in values))

    def _child(self, key: Tuple[str, ...]):
        raise NotImplementedError

    @staticmethod
    def _render_labels(pairs) -> str:
        """The ONE Prometheus label renderer (escaping included) —
        counters/gauges feed it their (name, value) pairs via
        ``_label_str``; histograms append the synthetic ``le`` pair."""
        if not pairs:
            return ""
        return "{" + ",".join(f'{n}="{_escape_label(v)}"'
                              for n, v in pairs) + "}"

    def _label_str(self, key: Tuple[str, ...]) -> str:
        return self._render_labels(tuple(zip(self.labelnames, key)))


class Counter(_Metric):
    """Monotonic event count. ``inc()`` only — a counter that can go
    down is a gauge, and Prometheus rate() depends on monotonicity."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    class _Child:
        __slots__ = ("_c", "_k")

        def __init__(self, c, k):
            self._c, self._k = c, k

        def inc(self, n: float = 1.0):
            self._c._inc(self._k, n)

        @property
        def value(self):
            return self._c._values.get(self._k, 0.0)

    def _child(self, key):
        return Counter._Child(self, key)

    def _inc(self, key, n):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def inc(self, n: float = 1.0):
        self._inc((), n)

    @property
    def value(self) -> float:
        return self._values.get((), 0.0)

    def collect(self):
        with self._lock:
            items = sorted(self._values.items())
        out = [(self.name + self._label_str(k), v) for k, v in items]
        if not out and not self.labelnames:
            # explicit 0 for an unlabeled family only: a labeled family
            # must never emit a label-less sample (it would vanish once
            # the first child appears — a broken series to Prometheus)
            out = [(self.name, 0.0)]
        return out

    def snapshot(self):
        with self._lock:
            if not self.labelnames:
                return self._values.get((), 0.0)
            return {",".join(k): v for k, v in sorted(
                self._values.items())}


class Gauge(_Metric):
    """Point-in-time level (queue depth, slots occupied, blocks in
    use). Tracks its own high-water mark (``high``, exported in JSON
    snapshots — the diffable surface CI gates consume) so within-window
    spikes survive sparse sampling — the allocator-peak lesson of the
    paged-KV round. Prometheus text carries only the current value
    (the exposition format has no slot for a companion sample in a
    gauge family); scrape-side max_over_time covers that surface.

    Labeled gauges (``labelnames=``, e.g. the ops plane's per-tier
    queue depth) follow the counter's child protocol: ``labels(...)``
    returns a per-key handle with its own value and high-water mark."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._high: Dict[Tuple[str, ...], float] = {}

    class _Child:
        __slots__ = ("_g", "_k")

        def __init__(self, g, k):
            self._g, self._k = g, k

        def set(self, v: float):
            self._g._set(self._k, v)

        def inc(self, n: float = 1.0):
            self._g._inc(self._k, n)

        def dec(self, n: float = 1.0):
            self._g._inc(self._k, -n)

        @property
        def value(self):
            return self._g._values.get(self._k, 0.0)

        @property
        def high(self):
            return self._g._high.get(self._k, 0.0)

    def _child(self, key):
        return Gauge._Child(self, key)

    def _set(self, key, v):
        with self._lock:
            self._values[key] = float(v)
            self._high[key] = max(self._high.get(key, float(v)),
                                  float(v))

    def _inc(self, key, n):
        with self._lock:
            v = self._values.get(key, 0.0) + n
            self._values[key] = v
            self._high[key] = max(self._high.get(key, v), v)

    def set(self, v: float):
        self._set((), v)

    def inc(self, n: float = 1.0):
        self._inc((), n)

    def dec(self, n: float = 1.0):
        self._inc((), -n)

    @property
    def value(self) -> float:
        return self._values.get((), 0.0)

    @property
    def high(self) -> float:
        return self._high.get((), 0.0)

    def collect(self):
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.labelnames:
            # explicit 0 for an unlabeled family only — same rule as
            # Counter: a labeled family must never emit a label-less
            # sample that would vanish once the first child appears
            items = [((), 0.0)]
        return [(self.name + self._label_str(k), v) for k, v in items]

    def snapshot(self):
        with self._lock:
            if not self.labelnames:
                return {"value": self._values.get((), 0.0),
                        "high": self._high.get((), 0.0)}
            return {",".join(k): {"value": v,
                                  "high": self._high.get(k, v)}
                    for k, v in sorted(self._values.items())}


class Histogram(_Metric):
    """Cumulative-bucket histogram over FIXED bounds (Prometheus
    semantics: ``bucket[i]`` counts samples <= bounds[i], the implicit
    ``+Inf`` bucket equals ``count``). Bucket counts + sum + count are
    the export; no per-sample storage, so a histogram observed a
    million times costs the same bytes as one observed once.

    Labeled histograms (``labelnames=``, e.g. the tick profiler's
    per-phase durations or the program-dispatch wall times) follow the
    counter's child protocol: ``labels(...)`` returns a per-key handle
    with its own bucket counts/sum/count; exposition renders each
    child's buckets with the key's label pairs plus ``le``."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        bounds = tuple(float(b) for b in
                       (buckets or DEFAULT_TIME_BUCKETS))
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram bounds must be strictly "
                             f"increasing, got {bounds}")
        self.bounds = bounds
        # per-key state; the unlabeled family lives at key ()
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._ns: Dict[Tuple[str, ...], int] = {}

    class _Child:
        __slots__ = ("_h", "_k")

        def __init__(self, h, k):
            self._h, self._k = h, k

        def observe(self, v: float):
            self._h._observe(self._k, v)

        @property
        def count(self):
            return self._h._ns.get(self._k, 0)

        @property
        def sum(self):
            return self._h._sums.get(self._k, 0.0)

    def _child(self, key):
        return Histogram._Child(self, key)

    def _observe(self, key, v):
        import bisect

        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.bounds) + 1)
            counts[bisect.bisect_left(self.bounds, float(v))] += 1
            self._sums[key] = self._sums.get(key, 0.0) + float(v)
            self._ns[key] = self._ns.get(key, 0) + 1

    def observe(self, v: float):
        self._observe((), v)

    @property
    def count(self) -> int:
        return self._ns.get((), 0)

    @property
    def sum(self) -> float:
        return self._sums.get((), 0.0)

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile of the UNLABELED family (upper
        bound of the bucket the q-th sample falls in; +inf if it lands
        in the overflow bucket). Coarse by design — the registry's
        percentiles are for dashboards/alerts; exact percentiles stay
        with the per-record ``ServingMetrics.aggregate()``."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            n = self._ns.get((), 0)
            if not n:
                return float("nan")
            counts = self._counts.get((), [0] * (len(self.bounds) + 1))
            rank = q * n
            acc = 0
            for i, c in enumerate(counts[:-1]):
                acc += c
                if acc >= rank and c:
                    return self.bounds[i]
            return float("inf")

    def collect(self):
        with self._lock:
            keys = sorted(self._counts)
            if not keys and not self.labelnames:
                # an unlabeled family exports explicit zero buckets
                # before its first observation (historical behavior);
                # a labeled family emits nothing until a child exists
                # — same rule as Counter/Gauge
                keys = [()]
            out = []
            for k in keys:
                counts = self._counts.get(
                    k, [0] * (len(self.bounds) + 1))
                n = self._ns.get(k, 0)
                pairs = list(zip(self.labelnames, k))
                acc = 0
                for b, c in zip(self.bounds, counts):
                    acc += c
                    out.append((self.name + "_bucket" + self._render_labels(
                        pairs + [("le", _fmt(b))]), float(acc)))
                out.append((self.name + "_bucket" + self._render_labels(
                    pairs + [("le", "+Inf")]), float(n)))
                out.append((self.name + "_sum" + self._render_labels(pairs),
                            self._sums.get(k, 0.0)))
                out.append((self.name + "_count"
                            + self._render_labels(pairs), float(n)))
            return out

    def snapshot(self):
        with self._lock:
            def one(k):
                counts = self._counts.get(
                    k, [0] * (len(self.bounds) + 1))
                return {"buckets": {_fmt(b): c for b, c in
                                    zip(self.bounds, counts)},
                        "overflow": counts[-1],
                        "sum": self._sums.get(k, 0.0),
                        "count": self._ns.get(k, 0)}

            if not self.labelnames:
                return one(())
            return {",".join(k): one(k)
                    for k in sorted(self._counts)}


def _fmt(v: float) -> str:
    return f"{v:.6g}"


class MetricsRegistry:
    """Named metric families with get-or-create accessors. A second
    ``counter()`` call with the same name returns the SAME family (the
    emit sites don't coordinate), but a name registered as one kind can
    never be re-registered as another — that would silently split the
    series."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif type(m) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames=labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames=labelnames)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  labelnames: Sequence[str] = ()) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets,
                         labelnames=labelnames)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # -- export -----------------------------------------------------------
    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4: one HELP/TYPE pair
        per family, then its samples. Ends with a newline (the format
        requires it)."""
        lines: List[str] = []
        for name in self.names():
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for sample, value in m.collect():
                lines.append(f"{sample} {_fmt_value(value)}")
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self) -> Dict[str, object]:
        """JSON-able dict: {name: scalar | labeled dict | histogram
        dict} — the diffable form benchmarks and CI gates consume."""
        return {name: self._metrics[name].snapshot()
                for name in self.names()}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """Process-default registry, for emit sites with no engine handle.
    Engines default to a PRIVATE registry (telemetry isolation across
    tests/tenants); pass ``Telemetry(registry=get_registry())`` to fold
    an engine into the process scrape."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
