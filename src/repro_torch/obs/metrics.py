"""Process-wide metrics registry (counterpart of ``repro.obs.metrics``,
DESIGN.md §10.2; pure Python, copied so that the port imports nothing
of ``repro``).

Three instrument kinds, all thread-safe and allocation-light on the hot
path:

- :class:`Counter` — monotonically increasing int (cache hits, all-reduce
  passes, reduced-element volume);
- :class:`Gauge` — last-written float (current batch capacity, live edge
  count);
- :class:`Histogram` — **fixed-bucket** latency histogram. Observations
  land in log-spaced buckets chosen at construction; quantiles
  (p50/p95/p99) are recovered by linear interpolation inside the
  containing bucket, clamped to the observed [min, max]. Fixed buckets
  keep ``observe()`` O(log #buckets) with zero per-sample allocation —
  the same trade every serving-metrics system makes (Prometheus,
  OpenTelemetry): quantiles are approximate to one bucket's width, while
  count/sum/min/max stay exact.

A process-global default registry backs the ``repro_torch.obs`` module-level
helpers (``counter()`` / ``gauge()`` / ``histogram()`` /
``metrics_snapshot()`` / ``metrics_reset()``); the span tracer feeds
span durations into it as ``span.<name>`` histograms whenever
observability is enabled (``repro_torch.obs.trace``).
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Tuple

#: Default latency buckets (seconds): log-spaced from 10 µs to ~100 s —
#: covers a fused query gather through a full distributed solve.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    10.0 ** (e / 3.0) for e in range(-15, 7)  # 1e-5 .. ~100 s, 3 per decade
)


class Counter:
    """Monotonic counter. ``inc`` accepts any non-negative increment."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge for deltas")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-written value."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated quantile summaries.

    ``bounds`` are the strictly-increasing upper edges of the first
    ``len(bounds)`` buckets; one overflow bucket catches everything
    beyond the last edge. Observations are O(log #buckets) (bisect) under
    a lock; no per-sample storage.
    """

    __slots__ = ("_lock", "bounds", "_counts", "_count", "_sum", "_min", "_max")

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or any(
            b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])
        ):
            raise ValueError("bucket bounds must be non-empty and increasing")
        self._lock = threading.Lock()
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, x: float) -> None:
        x = float(x)
        i = bisect.bisect_left(self.bounds, x)  # bucket i: value <= bounds[i]
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += x
            if x < self._min:
                self._min = x
            if x > self._max:
                self._max = x

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float:
        """Interpolated q-th percentile (q in [0, 100]).

        Walks the cumulative bucket counts to the bucket containing the
        target rank, linearly interpolates inside it (lower edge =
        previous bound, or the observed min for the first occupied
        bucket; upper edge = the bound, or the observed max for the
        overflow bucket), and clamps to [min, max] — so a single-valued
        stream reports that exact value at every quantile.
        """
        if not 0.0 <= q <= 100.0:
            raise ValueError("percentile q must be in [0, 100]")
        with self._lock:
            count = self._count
            counts = list(self._counts)
            lo_obs, hi_obs = self._min, self._max
        if count == 0:
            return 0.0
        rank = q / 100.0 * count
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else lo_obs
                hi = self.bounds[i] if i < len(self.bounds) else hi_obs
                frac = (rank - cum) / c if c else 0.0
                return float(min(max(lo + (hi - lo) * frac, lo_obs), hi_obs))
            cum += c
        return float(hi_obs)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            count, total = self._count, self._sum
            lo, hi = self._min, self._max
        if count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {
            "count": count,
            "sum": total,
            "min": lo,
            "max": hi,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Named instruments, created on first use. ``snapshot()`` renders
    every instrument to plain dicts (JSON-safe); ``reset()`` drops all
    instruments (callers re-create on next use — handles held across a
    reset keep recording into orphaned instruments, so re-fetch by
    name)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(
        self, name: str, bounds: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS
    ) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(bounds)
            return h

    def snapshot(self) -> Dict[str, Dict]:
        """{"counters": {name: int}, "gauges": {name: float},
        "histograms": {name: {count/sum/min/max/p50/p95/p99}}}."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {
                k: h.summary() for k, h in sorted(histograms.items())
            },
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


#: The process-global registry every instrumented module records into.
DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return DEFAULT_REGISTRY
