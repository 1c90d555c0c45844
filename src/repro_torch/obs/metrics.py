"""Counters, gauges and fixed-bucket latency histograms for the planner.

``MetricsRegistry`` is the numeric sibling of the tracer: where spans
answer "where did *this* request's time go", the registry answers "what
is the p50/p99 over *all* of them" — the tail-latency shape the
streaming-planner-service roadmap item gates on.  Snapshots are plain
dicts in the same JSON-friendly style as ``PlanningStats`` /
``PlanBroker.counters_snapshot`` so benches merge them side by side.

Histograms use **fixed** log-spaced bucket edges (4 per decade from
100 ns to 1000 s by default): observation is O(log buckets) with no
stored samples, merge is bucket-wise addition (same edges required), and
``percentile(p)`` interpolates inside the winning bucket — accurate to
bucket resolution (~78% width per bucket at 4/decade), which is plenty
for p50/p99 trend lines.  Exact ``min``/``max``/``sum``/``count`` ride
along and clamp the interpolation at the tails.

Thread-safe: each metric guards its state with one lock; the registry
guards its name table.  Like the tracer there is a process-wide
singleton (``get_metrics()``); hot call sites stay behind the tracer's
enabled flag so a disabled run never touches it.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

# 4 buckets per decade, 1e-7 s .. 1e3 s: plan-stack latencies span
# sub-microsecond cache hits to multi-second cold compiles
DEFAULT_EDGES: Tuple[float, ...] = tuple(
    10.0 ** (k / 4.0) for k in range(-28, 13))


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket latency histogram with interpolated percentiles."""

    __slots__ = ("edges", "counts", "count", "sum", "min", "max", "_lock")

    def __init__(self, edges: Optional[Tuple[float, ...]] = None):
        self.edges: Tuple[float, ...] = tuple(edges or DEFAULT_EDGES)
        # counts[i] covers (edges[i-1], edges[i]]; counts[0] is the
        # underflow bucket (-inf, edges[0]]; counts[-1] the overflow
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def _bucket(self, v: float) -> int:
        lo, hi = 0, len(self.edges)
        while lo < hi:                      # first edge >= v
            mid = (lo + hi) // 2
            if self.edges[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[self._bucket(v)] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def percentile(self, p: float) -> float:
        """Interpolated p-th percentile (p in [0, 100]); NaN when empty."""
        with self._lock:
            if self.count == 0:
                return math.nan
            target = (p / 100.0) * self.count
            cum = 0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                if cum + c >= target:
                    # interpolate within bucket i, clamped to the exact
                    # observed extremes at the tails
                    lo = self.edges[i - 1] if i > 0 else self.min
                    hi = self.edges[i] if i < len(self.edges) else self.max
                    lo = max(lo, self.min)
                    hi = min(hi, self.max)
                    if hi <= lo:
                        return lo
                    frac = (target - cum) / c
                    return lo + frac * (hi - lo)
                cum += c
            return self.max

    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self.count, self.sum
        if count == 0:
            return {"count": 0, "sum": 0.0}
        return {"count": count, "sum": total, "mean": total / count,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p99": self.percentile(99)}

    def merge(self, other: "Histogram") -> None:
        assert self.edges == other.edges, \
            "histogram merge requires identical bucket edges"
        with self._lock:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self.count += other.count
            self.sum += other.sum
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)


class MetricsRegistry:
    """Name -> metric table; get-or-create accessors, mergeable."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(*args)
            assert isinstance(m, cls), \
                f"metric {name!r} already registered as {type(m).__name__}"
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  edges: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(name, Histogram, edges)

    def reset(self) -> None:
        with self._lock:
            self._metrics = {}

    def snapshot(self) -> dict:
        """JSON-friendly {name: value | histogram-summary} dict in the
        ``PlanningStats`` / ``counters_snapshot`` style."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(items)}

    def merge(self, other: "MetricsRegistry") -> None:
        with other._lock:
            items = list(other._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                self.counter(name).inc(m.value)
            elif isinstance(m, Gauge):
                self.gauge(name).set(m.value)
            elif isinstance(m, Histogram):
                self.histogram(name, m.edges).merge(m)


_METRICS = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    """The process-wide registry singleton (see ``get_tracer``)."""
    return _METRICS
