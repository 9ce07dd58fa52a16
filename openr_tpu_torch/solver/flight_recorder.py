"""Solver flight recorder: per-solve traces, sampled phase timing, and
fault-forensics dumps.

Port of the JAX package's solver/flight_recorder.py. What the device
demands changed: `device_digest` reads `torch.cuda` (card count, name,
mesh shape) and never raises; `PhaseClock.seam` synchronizes the cards of
the tensors it is given where the reference calls `block_until_ready` on
each array, one barrier per device (a tiled solve's ranks pass all their
tiles, which may lie on several cards).

Every solver path this repo has shipped — cold, warm-invalidation,
edge-list, tiled-halo, blocked-FW APSP — reported exactly one wall-clock
number per solve (`decision.spf.solve_ms`), so nothing could attribute an
event's latency to h2d upload, the relax fixpoint, delta extraction or
the lazy d2h mirror fetch; and when the fault domain fired, the
supervisor threw away exactly the context (the recent solve history)
needed to diagnose it. This module is the missing observability layer:

  - **SolveTrace** — one structured record per supervised solve: event
    class, layout kind (sell / bf / tile2d / cpu), warm/cold disposition,
    wall time, fixpoint rounds, transfer bytes, compile-cache deltas,
    breaker state, and (on sampled solves) a per-phase millisecond
    breakdown.
  - **PhaseClock** — the sampled phase timer. Every `sample_every`-th
    solve gets a live clock whose `seam(...)` calls synchronize the card
    at the phase boundaries, so the
    recorded per-phase times are real device time; the other solves get
    the shared `NULL_CLOCK`, whose `seam` is a single attribute check —
    the unsampled hot path never touches a device buffer it would not
    have touched anyway (the probe-effect contract,
    tests/test_flight_recorder.py).
  - **FlightRecorder** — a bounded per-area ring of traces with exact
    eviction accounting (`recorded == retained + evicted`), plus the
    forensics side: `dump(reason)` snapshots the rings, the solver
    config, a mesh/device digest and a counter snapshot into one JSON
    artifact, referenced by id from the breaker/audit LogSamples
    (`SOLVER_FORENSICS_DUMPED`, docs/Monitoring.md).

The recorder owns no registry: phase samples queue in a pending list the
owning backend drains into its `decision.spf.phase.*_ms` histograms on
the existing counter-sync path (solver/cuda.py:_sync_spf_counters), so
monitor/ctrl/exporter all see them through the normal substrate.
"""

from __future__ import annotations

import collections
import json
import os
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

# phase vocabulary, in dispatch order. The fused warm kernels run the
# invalidation-mark fixpoint and (on the tiled layout) the halo exchange
# inside the same dispatch as the relax rounds, so those phases are
# attributed inside `relax` with the per-trace round/exchange gauges
# splitting them (docs/Monitoring.md "Flight recorder & profiling").
PHASES = ("prepare", "h2d", "relax", "delta_extract", "d2h")

# phase -> registry histogram (docs/Monitoring.md histogram table); the
# full names live here as literals so the doc rows stay pinned to code
# by the registry-drift analyzer's string universe
PHASE_HISTOGRAMS: Dict[str, str] = {
    "prepare": "decision.spf.phase.prepare_ms",
    "h2d": "decision.spf.phase.h2d_ms",
    "relax": "decision.spf.phase.relax_ms",
    "delta_extract": "decision.spf.phase.delta_extract_ms",
    "d2h": "decision.spf.phase.d2h_ms",
}


class PhaseClock:
    """Per-solve phase timer; a live one exists only on sampled solves.

    `seam(phase, *values)` closes the current phase: it waits for the
    device of every tensor among `values` (so device execution up to the
    seam is inside the measured window, not smeared into the next phase
    by async dispatch) and credits the elapsed milliseconds to `phase`.
    The shared NULL_CLOCK instance short-circuits on `self.sampled`.

    Port: a value may be a tensor, a `Sharded` matrix (its blocks) or a
    list, tuple or dict of them. Each distinct device among them takes one
    barrier, counted in `barriers`: a card is synchronized, and a CPU
    tensor's work is done when its op returns (the barrier is counted, as
    the JAX package counts `block_until_ready` on a CPU array). Other
    values are skipped."""

    __slots__ = ("sampled", "phases", "barriers", "_last")

    def __init__(self, sampled: bool) -> None:
        self.sampled = sampled
        self.phases: Dict[str, float] = {}
        self.barriers = 0  # device barriers taken (probe-effect)
        self._last = time.perf_counter() if sampled else 0.0

    def seam(self, phase: str, *values: Any) -> None:
        if not self.sampled:
            return
        devices = set()
        _devices_of(values, devices)
        for dev in devices:
            if dev.type == "cuda":
                import torch

                torch.cuda.synchronize(dev)
            self.barriers += 1
        now = time.perf_counter()
        self.phases[phase] = (
            self.phases.get(phase, 0.0) + (now - self._last) * 1e3
        )
        self._last = now


def _devices_of(value: Any, out: set) -> None:
    """Collect the devices of the tensors in `value` (a tensor, a
    `Sharded`, or a list, tuple or dict of them) into `out`."""
    if isinstance(value, (list, tuple)):
        for v in value:
            _devices_of(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _devices_of(v, out)
    elif hasattr(value, "blocks"):  # ops.spf.Sharded
        _devices_of(value.blocks, out)
    elif hasattr(value, "is_cuda") and hasattr(value, "device"):
        out.add(value.device)


NULL_CLOCK = PhaseClock(False)


@dataclass
class SolveTrace:
    """One supervised solve, structured (docs/Monitoring.md field table)."""

    seq: int
    ts: float  # wall clock (forensics correlation across nodes)
    area: str
    node: str
    event: str  # solve | fallback_solve | fault
    layout: str  # sell | bf | tile2d | replicated | cpu | none
    warm: bool
    solve_ms: Optional[float]
    rounds: Optional[int]
    invalidation_rounds: Optional[int]
    halo_exchanges: Optional[int]
    h2d_bytes: int
    d2h_bytes: int
    halo_bytes: int
    delta_columns: Optional[int]
    compile_cache_misses: int  # executables compiled BY this solve
    breaker_state: str
    sampled: bool
    phases: Dict[str, float] = field(default_factory=dict)
    fault_kind: Optional[str] = None
    detail: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


class FlightRecorder:
    """Bounded per-area SolveTrace rings + forensics dump snapshots."""

    def __init__(
        self,
        ring_size: int = 64,
        sample_every: int = 16,
        forensics_dir: Optional[str] = None,
        forensics_last_n: int = 16,
        max_dumps: int = 8,
        node: str = "",
    ) -> None:
        self.ring_size = max(int(ring_size), 1)
        self.sample_every = max(int(sample_every), 0)  # 0 = never sample
        self.forensics_dir = forensics_dir
        self.forensics_last_n = max(int(forensics_last_n), 1)
        self.max_dumps = max(int(max_dumps), 1)
        self.node = node
        # stamped by the supervisor on breaker transitions so traces and
        # dumps carry the serving state they were recorded under
        self.breaker_state = "closed"
        self._rings: Dict[str, Deque[SolveTrace]] = {}
        self._seq = 0
        self.solves_seen = 0
        self.recorded = 0
        self.evicted = 0
        self.sampled_solves = 0
        self.barrier_calls = 0  # total sampled-seam barriers ever taken
        self._pending_obs: List[Tuple[str, float]] = []
        self.dumps: List[Dict[str, Any]] = []
        self.dumps_written = 0
        self.last_dump_id: Optional[str] = None
        self.last_dump_reason: Optional[str] = None

    # -- recording -------------------------------------------------------

    def begin(self) -> PhaseClock:
        """Per-solve sampling decision: every `sample_every`-th solve gets
        a live PhaseClock (barriers at phase seams), the rest share the
        no-op NULL_CLOCK."""
        self.solves_seen += 1
        if self.sample_every > 0 and (
            self.solves_seen % self.sample_every == 1
            or self.sample_every == 1
        ):
            self.sampled_solves += 1
            return PhaseClock(True)
        return NULL_CLOCK

    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def record(self, trace: SolveTrace, clock: Optional[PhaseClock] = None):
        """Append one trace to its area ring (evicting with accounting)
        and queue the sampled phase observations for the histogram
        drain."""
        ring = self._rings.get(trace.area)
        if ring is None:
            ring = self._rings[trace.area] = collections.deque()
        while len(ring) >= self.ring_size:
            ring.popleft()
            self.evicted += 1
        ring.append(trace)
        self.recorded += 1
        if clock is not None and clock.sampled:
            self.barrier_calls += clock.barriers
            for phase, ms in clock.phases.items():
                self.observe_phase(phase, ms)

    def observe_phase(self, phase: str, ms: float) -> None:
        """Queue one phase sample for the owning backend's histogram
        drain (also used post-hoc: the lazy d2h mirror fetch lands after
        the trace was recorded)."""
        name = PHASE_HISTOGRAMS.get(phase)
        if name is not None:
            self._pending_obs.append((name, ms))

    def drain_observations(self) -> List[Tuple[str, float]]:
        out, self._pending_obs = self._pending_obs, []
        return out

    # -- read surfaces ---------------------------------------------------

    def retained(self) -> int:
        return sum(len(r) for r in self._rings.values())

    def snapshot(
        self, area: Optional[str] = None, last_n: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        """Trace dicts, oldest first, optionally filtered/limited."""
        traces: List[SolveTrace] = []
        for ring_area, ring in sorted(self._rings.items()):
            if area is not None and ring_area != area:
                continue
            traces.extend(ring)
        traces.sort(key=lambda t: t.seq)
        if last_n is not None and last_n >= 0:
            traces = traces[-last_n:]
        return [t.to_dict() for t in traces]

    def stats(self) -> Dict[str, Any]:
        return {
            "ring_size": self.ring_size,
            "sample_every": self.sample_every,
            "areas": sorted(self._rings),
            "recorded": self.recorded,
            "retained": self.retained(),
            "evicted": self.evicted,
            "sampled_solves": self.sampled_solves,
            "barrier_calls": self.barrier_calls,
        }

    # -- forensics -------------------------------------------------------

    def dump(
        self,
        reason: str,
        *,
        solver_config: Optional[Dict[str, Any]] = None,
        counters: Optional[Dict[str, int]] = None,
        mesh_digest: Optional[Dict[str, Any]] = None,
        extra: Optional[Dict[str, Any]] = None,
        device_memory: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Snapshot the rings + context into one JSON-serializable
        forensics artifact; kept in a bounded in-memory list and, when
        `forensics_dir` is configured, written to
        `<dir>/<id>.json` (best-effort: an unwritable dir must never
        turn a breaker trip into a crash)."""
        self.dumps_written += 1
        dump_id = (
            f"forensics-{self.node or 'node'}-"
            f"{self.dumps_written:04d}-{int(time.time())}"
        )
        dump: Dict[str, Any] = {
            "id": dump_id,
            "reason": reason,
            "ts": time.time(),
            "node": self.node,
            "breaker_state": self.breaker_state,
            "trace_stats": self.stats(),
            "traces": {
                area: [t.to_dict() for t in list(ring)][
                    -self.forensics_last_n:
                ]
                for area, ring in sorted(self._rings.items())
            },
            "solver_config": solver_config or {},
            "mesh_digest": mesh_digest or device_digest(None),
            "counters": dict(counters or {}),
        }
        if extra:
            dump["extra"] = extra
        if device_memory is not None:
            # memory-ledger snapshot (monitor/memledger.py): resident
            # structures + capacity picture at dump time — the device_oom
            # post-mortem's primary evidence
            dump["device_memory"] = device_memory
        self.dumps.append(dump)
        while len(self.dumps) > self.max_dumps:
            self.dumps.pop(0)
        self.last_dump_id = dump_id
        self.last_dump_reason = reason
        dump["path"] = None
        if self.forensics_dir:
            try:
                os.makedirs(self.forensics_dir, exist_ok=True)
                path = os.path.join(self.forensics_dir, f"{dump_id}.json")
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as fh:
                    json.dump(dump, fh, sort_keys=True)
                os.replace(tmp, path)
                dump["path"] = path
            except OSError:
                pass
        return dump

    def dump_summaries(self) -> List[Dict[str, Any]]:
        """Compact dump index (getSolverHealth / getSolveTraces): id,
        reason, timestamp, trace count, artifact path."""
        return [
            {
                "id": d["id"],
                "reason": d["reason"],
                "ts": d["ts"],
                "breaker_state": d["breaker_state"],
                "traces": sum(len(ts) for ts in d["traces"].values()),
                "path": d.get("path"),
            }
            for d in self.dumps
        ]

    def forensics_stats(self) -> Dict[str, Any]:
        return {
            "dumps": self.dumps_written,
            "retained_dumps": len(self.dumps),
            "last_id": self.last_dump_id,
            "last_reason": self.last_dump_reason,
            "dir": self.forensics_dir,
        }


def device_digest(mesh) -> Dict[str, Any]:
    """Mesh/device context for forensics dumps, degrade-safe: a dead or
    absent backend yields an error string, never an exception (the dump
    runs exactly when the device is suspect)."""
    digest: Dict[str, Any] = {
        "mesh_shape": dict(mesh.shape) if mesh is not None else None,
    }
    try:
        import torch

        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        digest["devices"] = count
        digest["platform"] = "cuda" if count else "cpu"
        digest["device_kind"] = (
            torch.cuda.get_device_name(0) if count else None
        )
    except Exception as exc:  # device loss is exactly when dumps happen
        digest["error"] = f"{type(exc).__name__}: {exc}"
    return digest
