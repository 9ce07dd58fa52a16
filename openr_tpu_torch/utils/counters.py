"""Shared counters + histogram primitives (the fb303 fbData equivalent).

Every module exposes a `counters` dict of monotonically increasing values
(naming convention `<module>.<counter>`, docs/Monitoring.md:19-31) and a
`histograms` dict of fixed log-bucket `Histogram`s for latency-style
distributions; the monitor module aggregates both across modules for the
ctrl API (`getCounters` / `getHistograms`).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple


class CountersMixin:
    counters: Dict[str, int]

    def _ensure_counters(self) -> Dict[str, int]:
        if not hasattr(self, "counters"):
            self.counters = {}
        return self.counters

    def _bump(self, counter: str, n: int = 1) -> None:
        counters = self._ensure_counters()
        counters[counter] = counters.get(counter, 0) + n


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------

# Log-bucket geometry: bucket 0 is [0, _LO); bucket i >= 1 is
# [_LO * 2**((i-1)/_SUB), _LO * 2**(i/_SUB)); the last bucket absorbs
# everything larger. _LO is in the recorded unit (milliseconds by
# convention), so one fixed geometry spans 1µs solver dispatches to
# multi-hour tails with <= 2**(1/_SUB)-1 ≈ 19% relative bucket error —
# no per-histogram bucket configuration, unlike the reference's linear
# fb303 ExportedHistogram (docs/Monitoring.md histogram section).
_LO = 1e-3
_SUB = 4
_NBUCKETS = 1 + _SUB * 40


class Histogram:
    """Fixed log-bucket histogram: O(1) record, mergeable, percentile export.

    Records are floats in a single unit (ms for every `*_ms` histogram).
    Percentiles interpolate linearly inside the target bucket and clamp to
    the exact observed min/max, so single-sample and edge percentiles are
    exact while the memory stays one small int list per histogram.
    """

    __slots__ = ("buckets", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self.buckets: List[int] = [0] * _NBUCKETS
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    @staticmethod
    def bucket_index(value: float) -> int:
        if value < _LO:
            return 0
        # the 1e-9 guard pins exact bucket edges to their own bucket: log2
        # of a representable edge can land a hair under its integer value
        # and would otherwise misfile the edge one bucket down
        idx = 1 + math.floor(math.log2(value / _LO) * _SUB + 1e-9)
        if idx < 1:
            return 1
        return idx if idx < _NBUCKETS else _NBUCKETS - 1

    @staticmethod
    def bucket_bounds(index: int) -> Tuple[float, float]:
        """[lower, upper) value range of a bucket."""
        if index <= 0:
            return (0.0, _LO)
        return (_LO * 2 ** ((index - 1) / _SUB), _LO * 2 ** (index / _SUB))

    def record(self, value: float) -> None:
        v = float(value)
        if v < 0.0 or v != v:  # negative clock skew / NaN: clamp out
            v = 0.0
        self.buckets[self.bucket_index(v)] += 1
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold `other` into self (cross-module aggregation); returns self."""
        for i, c in enumerate(other.buckets):
            if c:
                self.buckets[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.min is not None and (self.min is None or other.min < self.min):
            self.min = other.min
        if other.max is not None and (self.max is None or other.max > self.max):
            self.max = other.max
        return self

    def copy(self) -> "Histogram":
        out = Histogram()
        out.buckets = list(self.buckets)
        out.count = self.count
        out.sum = self.sum
        out.min = self.min
        out.max = self.max
        return out

    def reset(self) -> None:
        """Clear all recorded samples (the reset-on-read snapshot mode:
        dashboards export-then-reset to turn lifetime-cumulative
        histograms into per-window rates)."""
        for i in range(len(self.buckets)):
            self.buckets[i] = 0
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def percentile(self, p: float) -> float:
        """p-th percentile (0..100); 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = (p / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.buckets):
            if not c:
                continue
            if cum + c >= rank:
                lo, hi = self.bucket_bounds(i)
                val = lo + (hi - lo) * ((rank - cum) / c)
                return min(max(val, self.min), self.max)
            cum += c
        return self.max  # float-fuzz fallthrough: rank beyond last bucket

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    def to_dict(self) -> Dict[str, float]:
        """Export shape served by ctrl getHistograms / breeze rendering."""
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "avg": round(self.avg, 6),
            "min": round(self.min, 6) if self.min is not None else 0.0,
            "max": round(self.max, 6) if self.max is not None else 0.0,
            "p50": round(self.p50, 6),
            "p95": round(self.p95, 6),
            "p99": round(self.p99, 6),
        }

    def to_sparse(self) -> Dict[str, object]:
        """Lossless JSON-serializable form: only nonzero buckets ride. Unlike
        to_dict (stats only), a sparse export can be rehydrated with
        from_sparse and merged — the shape convergence-report rollups use to
        fold per-node windowed histograms network-wide."""
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "buckets": {
                str(i): c for i, c in enumerate(self.buckets) if c
            },
        }

    @classmethod
    def from_sparse(cls, data: Dict[str, object]) -> "Histogram":
        out = cls()
        for key, c in dict(data.get("buckets") or {}).items():
            out.buckets[int(key)] = int(c)
        out.count = int(data.get("count", 0))
        out.sum = float(data.get("sum", 0.0))
        out.min = None if data.get("min") is None else float(data["min"])
        out.max = None if data.get("max") is None else float(data["max"])
        return out


class Timer:
    """Context manager recording elapsed milliseconds into a histogram.

    Runs on time.perf_counter (monotonic), so wall-clock steps never skew
    latency stats — the same rule the convergence span path follows."""

    __slots__ = ("_observe", "_name", "_t0")

    def __init__(self, observe, name: str) -> None:
        self._observe = observe
        self._name = name
        self._t0 = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._observe(self._name, (time.perf_counter() - self._t0) * 1e3)


class HistogramsMixin:
    """Per-module histogram dict, the distribution sibling of CountersMixin
    (same `<module>.<name>` naming convention; `*_ms` suffix for latency)."""

    histograms: Dict[str, Histogram]

    def _ensure_histograms(self) -> Dict[str, Histogram]:
        if not hasattr(self, "histograms"):
            self.histograms = {}
        return self.histograms

    def _observe(self, name: str, value: float) -> None:
        histograms = self._ensure_histograms()
        hist = histograms.get(name)
        if hist is None:
            hist = histograms[name] = Histogram()
        hist.record(value)

    def _timer(self, name: str) -> Timer:
        return Timer(self._observe, name)
