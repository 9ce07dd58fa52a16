"""Structured event logging + counter aggregation.

Behavioral port of openr/monitor/: LogSample (monitor/LogSample.h) is a
typed key→value event record; merge_module_histograms folds the
histograms of a module set.

Port of the JAX package's monitor/monitor.py, less its `Monitor` class
(monitor/MonitorBase.h:26-62: the event-log ring and the counter
aggregation), which folds its spans into the convergence report's rollup
and comes with the report in the daemon shell (ROADMAP queue 1 item 12)."""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Iterable, List, Optional

from openr_tpu_torch.utils.counters import Histogram

EVENT_LOG_CATEGORY = "openr.event_logs"  # Constants::kEventLogCategory


def merge_module_histograms(
    modules: Iterable[object], reset: bool = False
) -> Dict[str, Histogram]:
    """Merge the `histograms` dicts of a module set into fresh Histogram
    objects (same-name histograms across modules fold together). Shared by
    Monitor.get_histograms and the ctrl server's monitor-less fallback.

    With `reset=True` (the reset-on-read snapshot mode) every merged
    source histogram is cleared after the copy, so consecutive exports
    describe disjoint windows and dashboards can compute rates from
    otherwise lifetime-cumulative distributions. Objects shared by
    reference across modules (e.g. Decision re-exporting the solver's
    decision.spf.* histograms) are reset exactly once — they were also
    merged from whichever module listed them first, and the id-dedup
    keeps the copy and the clear consistent."""
    merged: Dict[str, Histogram] = {}
    seen_ids = set()
    for module in modules:
        hists = getattr(module, "histograms", None)
        if not isinstance(hists, dict):
            continue
        for name, hist in hists.items():
            if not isinstance(hist, Histogram):
                continue
            if id(hist) in seen_ids:
                continue  # same object re-exported by another module
            seen_ids.add(id(hist))
            if name in merged:
                merged[name].merge(hist)
            else:
                merged[name] = hist.copy()
            if reset:
                hist.reset()
    return merged


class LogSample:
    """monitor/LogSample.h: typed structured event."""

    def __init__(self, timestamp: Optional[float] = None) -> None:
        self.timestamp = timestamp if timestamp is not None else time.time()
        self._values: Dict[str, Any] = {}

    def add_string(self, key: str, value: str) -> "LogSample":
        self._values[key] = value
        return self

    def add_int(self, key: str, value: int) -> "LogSample":
        self._values[key] = int(value)
        return self

    def add_double(self, key: str, value: float) -> "LogSample":
        self._values[key] = float(value)
        return self

    def add_string_vector(self, key: str, values: List[str]) -> "LogSample":
        self._values[key] = list(values)
        return self

    def get(self, key: str) -> Any:
        return self._values.get(key)

    def values(self) -> Dict[str, Any]:
        """Copy of the typed key→value map (the convergence-report
        aggregation reads whole samples, not single keys)."""
        return dict(self._values)

    def to_json(self) -> str:
        return json.dumps(
            {"time": int(self.timestamp), **self._values}, sort_keys=True
        )

    @staticmethod
    def from_json(text: str) -> "LogSample":
        data = json.loads(text)
        sample = LogSample(timestamp=data.pop("time", 0))
        sample._values = data
        return sample
