"""Convergence spans: structured stage traces of one LSDB event.

PerfEvents (types.py) ride LSDB values across nodes with wall-clock ms
stamps — right for cross-node convergence reports (`breeze perf view`),
wrong for local latency histograms: an NTP step mid-event skews every
duration derived from them. A Span is the local monotonic-clock sibling of
that trace: created when Decision keeps the oldest event of a debounce
batch (seeded from the KvStore publication stamp when one rode along),
marked at each pipeline stage —

    spark.neighbor_event → linkmonitor.adj_advertised
    → [kvstore.flood.origin → kvstore.flood.hop1..k]   (remote events)
    → kvstore.publish → decision recv → debounce fire → route build
    → fib recv → fib program

— and finished by Fib once routes are programmed. The pre-publish stages
arrive either as monotonic `Publication.span_stages` marks (the local
origin chain) or are reconstructed from wall-clock PerfEvents (flood-hop
traces from remote nodes); from kvstore.publish on, every mark is taken
live on this process's monotonic clock. Stage durations feed the `*_ms`
histograms (decision.debounce_ms, decision.spf.solve_ms, fib.program_ms,
convergence.e2e_ms) and the finished span is emitted as one
CONVERGENCE_TRACE LogSample through the monitor queue.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from openr_tpu_torch.monitor.monitor import LogSample

SPAN_EVENT = "CONVERGENCE_TRACE"

# finished-span sample keys that are not per-stage durations ("total_ms"
# is the end-to-end duration, exposed as the "total" pseudo-stage)
_NON_STAGE_KEYS = {"event", "span", "node_name"}


def sample_stage_durations(values: Dict[str, float]) -> Dict[str, float]:
    """stage -> ms from one finished span's LogSample value map (the
    CONVERGENCE_TRACE export shape produced by Span.to_log_sample).
    Shared by the point-in-time convergence report and the windowed
    rollup so both read the same stage vocabulary; the end-to-end
    `total_ms` field maps to the `total` pseudo-stage."""
    out: Dict[str, float] = {}
    for key, value in values.items():
        if (
            key.endswith("_ms")
            and key not in _NON_STAGE_KEYS
            and isinstance(value, (int, float))
        ):
            out[key[: -len("_ms")]] = float(value)
    return out


class Span:
    """Ordered (stage, monotonic-ts) marks over one event's pipeline pass.

    Spans never cross a process boundary (monotonic clocks don't compare
    across hosts) — they ride in-process queue payloads only, as the
    `span` attribute next to `perf_events`.
    """

    __slots__ = ("name", "t0", "marks")

    def __init__(self, name: str, t0: Optional[float] = None) -> None:
        self.name = name
        self.t0 = time.monotonic() if t0 is None else t0
        self.marks: List[Tuple[str, float]] = []

    def mark(self, stage: str, ts: Optional[float] = None) -> float:
        """Append a stage boundary; returns the stage's duration in ms
        (time since the previous mark, or since t0 for the first).

        `ts` replays a mark that already happened at a known monotonic
        time — the span-stage handoff (Publication.span_stages) and the
        reconstructed flood-hop stages use it. Marks are kept monotonic:
        a ts behind the previous mark (reconstruction jitter, cross-host
        wall-clock skew) is clamped to it, yielding a zero-length stage
        rather than a negative one."""
        now = time.monotonic() if ts is None else ts
        prev = self.marks[-1][1] if self.marks else self.t0
        if now < prev:
            now = prev
        self.marks.append((stage, now))
        return (now - prev) * 1e3

    def elapsed_ms(self) -> float:
        """End-to-end ms since the span started (t0 → now)."""
        return (time.monotonic() - self.t0) * 1e3

    def stage_durations_ms(self) -> Dict[str, float]:
        """stage -> ms from the previous mark (t0 for the first)."""
        out: Dict[str, float] = {}
        prev = self.t0
        for stage, ts in self.marks:
            out[stage] = (ts - prev) * 1e3
            prev = ts
        return out

    def to_log_sample(self) -> LogSample:
        sample = LogSample()
        sample.add_string("event", SPAN_EVENT)
        sample.add_string("span", self.name)
        total = 0.0
        for stage, ms in self.stage_durations_ms().items():
            sample.add_double(f"{stage}_ms", ms)
            total += ms
        sample.add_double("total_ms", total)
        return sample
