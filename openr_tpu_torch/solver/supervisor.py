"""Supervised solver layer: the solve path's explicit fault domain.

Sits between Decision and the solver backends so that a failing device
solve (kernel fault, runtime fault, device loss, deadline overrun)
degrades to the CPU oracle instead of unwinding into Decision's event loop
— degraded hardware means slower convergence, never wrong routes or a dead
Decision module (FatPaths correctness-under-failure posture, PAPERS.md).

Three cooperating mechanisms:

  1. **Supervised solves** — every `build_route_db` on the primary (card)
     backend is wrapped with error classification
     (compile / runtime / device_loss / deadline), bounded in-call retry,
     and per-solve deadline accounting stamped into the Watchdog's
     heartbeat map (`monitor/watchdog.py`) so a wedged solve is attributed
     to the solver, not generically to Decision.

  2. **Circuit breaker with CPU fallback** — `failure_threshold`
     consecutive primary failures trip the breaker OPEN: the primary's
     device-resident warm state is invalidated (it is untrustworthy after
     a device fault) and every solve is served by the CPU oracle
     (`decision.spf.fallback_active` = 1). Recovery is probe-driven with
     hysteresis: background health-probe solves re-run the primary on the
     live LSDB off the hot path, and only `probe_successes_to_close`
     consecutive successes close the breaker; any probe failure re-arms an
     `ExponentialBackoff` gate so a flapping device cannot oscillate the
     serving path.

  3. **Warm-state self-audit** — every `audit_interval`-th successful
     primary solve triggers a shadow cold solve (recomputed from the
     host-side graph truth) compared entrywise against the warm
     device-resident distance matrix. Divergence increments
     `decision.spf.audit_mismatches`, emits a `WARM_STATE_AUDIT` LogSample
     (CONVERGENCE_TRACE-style, through the monitor queue), forces a cold
     re-solve and re-serves the corrected routes — self-healing, not
     crash: a silently-diverged warm `D` would otherwise program wrong
     routes forever.

All counters live in the `decision.spf.*` namespace so they flow through
Decision's existing counter sync into Monitor/ctrl/breeze.

Port of the JAX package's solver/supervisor.py, over `CudaSpfSolver` with
the CPU oracle `SpfSolver` as the degraded path. What the device demands
changed:

  - `classify_solver_error` reads torch's CUDA error texts: the advice
    sentence torch appends to every CUDA error ("Compile with
    `TORCH_USE_CUDA_DSA` to enable device-side assertions.") is not
    evidence of a compile fault and is dropped before matching, and the
    CUDA runtime's own words for a lost card ("no CUDA-capable device",
    "busy or unavailable", "uncorrectable ECC error") classify as
    device loss. `torch.cuda.OutOfMemoryError` ("CUDA out of memory.
    Tried to allocate ...") lands in device_oom through the reference's
    own hint.
  - A kernel that does not build (`ops._cuda.KernelBuildError`: nvcc
    missing or refusing a source, a library that does not load), a launch
    that the CUDA runtime refuses (`ops._cuda.KernelLaunchError`) and a
    kernel that faults on the card (CUDA's words for an illegal address
    or instruction, a device-side assert, a launch failure) are faults of
    the kernels, not of the card's health: `is_kernel_fault` names them,
    and the supervisor re-raises them, never fed to the breaker, so the
    CPU oracle cannot hide a kernel that fails. The breaker and the oracle
    stay for device loss, device OOM, deadlines and injected faults.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from openr_tpu_torch.solver.routes import get_route_delta
from openr_tpu_torch.utils.backoff import ExponentialBackoff
from openr_tpu_torch.utils.counters import CountersMixin, HistogramsMixin

log = logging.getLogger(__name__)

# breaker states
CLOSED = "closed"  # primary serving
OPEN = "open"  # fallback serving, probes running
HALF_OPEN = "half_open"  # fallback serving, probe streak in progress

# fault kinds (classification buckets)
FAULT_COMPILE = "compile"
FAULT_RUNTIME = "runtime"
FAULT_DEVICE_LOSS = "device_loss"
FAULT_DEADLINE = "deadline"
FAULT_DEVICE_OOM = "device_oom"


class SolveDeadlineExceeded(RuntimeError):
    """A solve finished but blew its per-solve deadline budget."""


def classify_solver_error(exc: BaseException) -> str:
    """Map a raised solve exception onto a fault-kind bucket.

    Classification is by exception type name + message substrings rather
    than concrete torch types: the supervisor must not import device
    runtimes it is there to survive, and the exception taxonomy moves
    between releases. Unknown errors classify as runtime (the safe bucket:
    retry-then-fallback)."""
    if isinstance(exc, SolveDeadlineExceeded):
        return FAULT_DEADLINE
    names = {type(e).__name__ for e in _exc_chain(exc)}
    text = " ".join(
        f"{type(e).__name__}: {e}" for e in _exc_chain(exc)
    ).lower()
    # port: torch appends this advice to every CUDA error; its "compile"
    # says nothing of the fault's kind
    text = text.replace(_TORCH_CUDA_ADVICE, "")
    # allocator exhaustion FIRST: CUDA's out-of-memory wording and the
    # capacity model's predicted refusal both land here — the forensics
    # dump for this kind embeds the full memory-ledger snapshot so the
    # post-mortem names the structure that ate the chip
    if any(
        hint in text
        for hint in (
            "resource_exhausted",
            "resource exhausted",
            "out of memory",
            "out-of-memory",
            "memory allocation failure",
            "allocation failure",
        )
    ) or "DeviceCapacityError" in names:
        return FAULT_DEVICE_OOM
    if any(
        hint in text
        for hint in (
            "device_lost",
            "device lost",
            "device is lost",
            "failed to connect",
            "halted",
            "data transfer",
            "device unavailable",
            # port: the CUDA runtime's words for a card that is gone
            "no cuda-capable device",
            "busy or unavailable",
            "uncorrectable ecc error",
        )
    ):
        return FAULT_DEVICE_LOSS
    if (
        "XlaCompileError" in names
        or "compile" in text
        or "lowering" in text
        or isinstance(exc, (TypeError, NotImplementedError))
    ):
        return FAULT_COMPILE
    return FAULT_RUNTIME


# lower-cased, as classify_solver_error matches
_TORCH_CUDA_ADVICE = (
    "compile with `torch_use_cuda_dsa` to enable device-side assertions."
)


# lower-cased CUDA runtime texts of a kernel that faulted on the card or
# could not be launched there: the faults are sticky (the context cannot
# launch again) and the refusals repeat, so no retry or probe helps
_CUDA_KERNEL_FAULT_HINTS = (
    "illegal memory access",
    "illegal instruction",
    "misaligned address",
    "invalid program counter",
    "device-side assert triggered",
    "unspecified launch failure",
    "launch timed out",
    "hardware stack error",
    "no kernel image is available",
    "invalid device function",
    "too many resources requested for launch",
    "invalid configuration argument",
)


def is_kernel_fault(exc: BaseException) -> bool:
    """Port: a kernel that did not build or launch
    (`ops._cuda.KernelBuildError`, `KernelLaunchError` anywhere in the
    chain) or faulted on the card (a CUDA kernel-fault text). Matched by
    name and text, as the reference matches device errors: the supervisor
    imports no device runtime."""
    chain = _exc_chain(exc)
    if any(type(e).__name__ in ("KernelBuildError", "KernelLaunchError")
           for e in chain):
        return True
    text = " ".join(str(e) for e in chain).lower()
    return any(hint in text for hint in _CUDA_KERNEL_FAULT_HINTS)


def _exc_chain(exc: BaseException) -> List[BaseException]:
    out: List[BaseException] = []
    seen = set()
    cur: Optional[BaseException] = exc
    while cur is not None and id(cur) not in seen:
        out.append(cur)
        seen.add(id(cur))
        cur = cur.__cause__ or cur.__context__
    return out


@dataclass
class SupervisorConfig:
    """Knobs for the solver fault domain (docs/Robustness.md)."""

    # consecutive primary failures that trip the breaker OPEN
    failure_threshold: int = 3
    # in-call retry budget per build_route_db (1 = no retry)
    max_attempts: int = 2
    # per-solve wall-clock deadline; overruns classify as FAULT_DEADLINE
    # and count toward the breaker (the result, if any, is still served —
    # slow-but-correct beats no-route)
    solve_deadline_s: float = 30.0
    # health-probe cadence while the breaker is OPEN/HALF_OPEN; failures
    # back off exponentially from this base
    probe_interval_s: float = 5.0
    probe_backoff_max_s: float = 60.0
    # hysteresis: consecutive probe successes required to close the breaker
    probe_successes_to_close: int = 2
    # shadow cold-audit every Nth successful primary solve; 0 disables
    audit_interval: int = 0
    # partial-mesh degradation: when a device-loss streak reaches the
    # failure threshold on a multi-chip solver_mesh, re-resolve the mesh
    # over the surviving chips (smaller batch x graph factorization)
    # instead of tripping straight to the CPU oracle; the breaker only
    # opens when no viable mesh remains (docs/Robustness.md ladder)
    mesh_degrade: bool = True
    # watchdog heartbeat name stamped around solves
    watchdog_module: str = "decision"
    # flight recorder (solver/flight_recorder.py, docs/Monitoring.md
    # "Flight recorder & profiling"): per-area SolveTrace ring bound and
    # the phase-timing sampling cadence — every trace_sample_every-th
    # solve synchronizes the card at phase seams; 0 disables
    # sampling entirely (traces still record, without phase splits)
    trace_ring_size: int = 64
    trace_sample_every: int = 16
    # forensics dumps: traces per area snapshotted into each dump, and an
    # optional directory the JSON artifacts are also written to (None =
    # in-memory only, read via ctrl getSolveTraces)
    forensics_last_n: int = 16
    forensics_dir: Optional[str] = None


class SolverSupervisor(CountersMixin, HistogramsMixin):
    """Drop-in SpfSolver facade: primary backend under supervision, CPU
    oracle as the degraded path. Decision talks only to this object."""

    def __init__(
        self,
        primary,
        fallback,
        config: Optional[SupervisorConfig] = None,
        *,
        watchdog=None,
        log_sample_fn=None,
        clock=time.monotonic,
    ) -> None:
        self.primary = primary
        self.fallback = fallback
        self.config = config or SupervisorConfig()
        self.watchdog = watchdog
        self._log_sample_fn = log_sample_fn
        self._clock = clock
        self.my_node_name = primary.my_node_name

        self.state = CLOSED
        self.consecutive_failures = 0
        self.probe_streak = 0
        self.last_fault_kind: Optional[str] = None
        self._solves_since_audit = 0
        self._delta_builds_since_audit = 0
        self._probe_backoff = ExponentialBackoff(
            max(self.config.probe_interval_s, 1e-3),
            max(
                self.config.probe_backoff_max_s,
                self.config.probe_interval_s,
                1e-3,
            ),
            clock=clock,
        )
        self._next_probe_at = 0.0
        self._probe_task = None
        # last solve inputs, kept for probes/audits off the hot path
        self._last_inputs = None

        self.counters: Dict[str, int] = {}
        self.histograms: Dict = {}
        self.counters["decision.spf.fallback_active"] = 0

        # flight recorder: every supervised solve leaves a SolveTrace in
        # the bounded per-area ring, and the fault paths below snapshot
        # the ring into forensics dumps (docs/Monitoring.md)
        from openr_tpu_torch.solver.flight_recorder import FlightRecorder

        self.recorder = FlightRecorder(
            ring_size=self.config.trace_ring_size,
            sample_every=self.config.trace_sample_every,
            forensics_dir=self.config.forensics_dir,
            forensics_last_n=self.config.forensics_last_n,
            node=self.my_node_name,
        )
        attach_rec = getattr(primary, "attach_recorder", None)
        if attach_rec is not None:
            attach_rec(self.recorder)

        # non-solve device workloads owned by the primary (the APSP
        # closes) dispatch through this fault domain too: classified
        # faults feed the shared breaker, numpy FW is their degraded path
        attach = getattr(primary, "attach_supervisor", None)
        if attach is not None:
            attach(self)

    # ------------------------------------------------------------------
    # lifecycle (background probe loop; optional — probes also run
    # opportunistically from the solve path when no loop is attached)
    # ------------------------------------------------------------------

    def start(self, loop=None) -> None:
        import asyncio

        if self._probe_task is not None:
            return
        try:
            loop = loop or asyncio.get_event_loop()
        except RuntimeError:
            return
        self._probe_task = loop.create_task(self._probe_loop())

    def stop(self) -> None:
        if self._probe_task is not None:
            self._probe_task.cancel()
            self._probe_task = None

    def close(self) -> None:
        """Teardown passthrough: release the primary backend's ledger-
        registered device structures (the fallback oracle holds none)."""
        close = getattr(self.primary, "close", None)
        if close is not None:
            close()

    async def _probe_loop(self) -> None:
        import asyncio

        interval = max(self.config.probe_interval_s / 4.0, 0.01)
        try:
            while True:
                await asyncio.sleep(interval)
                if self.state != CLOSED:
                    self.maybe_probe()
        except asyncio.CancelledError:
            pass

    # ------------------------------------------------------------------
    # SpfSolver facade
    # ------------------------------------------------------------------

    def build_route_db(self, my_node_name, area_link_states, prefix_state):
        self._last_inputs = (my_node_name, area_link_states, prefix_state)
        if self.state != CLOSED:
            # opportunistic probe for loop-less embeddings: the breaker
            # must be able to recover even when nobody started the
            # background task (probe_due gates the cadence)
            if self._probe_task is None:
                self.maybe_probe()
        if self.state != CLOSED:
            return self._fallback_solve(
                my_node_name, area_link_states, prefix_state
            )

        attempts = 0
        while True:
            attempts += 1
            self._touch_watchdog()
            t0 = self._clock()
            try:
                db = self.primary.build_route_db(
                    my_node_name, area_link_states, prefix_state
                )
            except Exception as exc:
                if is_kernel_fault(exc):
                    raise
                self._record_failure(classify_solver_error(exc), exc)
                if self.state != CLOSED:
                    break
                if attempts >= max(self.config.max_attempts, 1):
                    # retry budget exhausted without tripping the breaker:
                    # serve this event degraded, keep the breaker counting
                    break
                self._bump("decision.spf.solver_retries")
                continue
            finally:
                self._touch_watchdog()
            elapsed = self._clock() - t0
            if elapsed > self.config.solve_deadline_s:
                # the solve completed but blew its budget: a deadline
                # fault feeds the breaker (repeated overruns mean the
                # device is degrading), yet the computed routes are valid
                # — serve them rather than discard correct work
                self._record_failure(
                    FAULT_DEADLINE,
                    SolveDeadlineExceeded(
                        f"solve took {elapsed:.3f}s "
                        f"(deadline {self.config.solve_deadline_s}s)"
                    ),
                    elapsed_s=elapsed,
                )
            else:
                self._record_success()
            self._sync_backend_stats(self.primary)
            db = self._maybe_audit(
                db, my_node_name, area_link_states, prefix_state
            )
            return db

        return self._fallback_solve(
            my_node_name, area_link_states, prefix_state
        )

    # ------------------------------------------------------------------
    # generic supervised device workloads (TE optimization etc.)
    # ------------------------------------------------------------------

    def supervised_call(
        self, op: str, primary_fn, fallback_fn=None, deadline_s=None
    ):
        """Run a non-SPF device workload inside this fault domain.

        Same contract as a supervised solve: raised errors are classified
        and feed the breaker (the workloads share the device — a TE
        dispatch fault is device evidence like any other), retries are
        bounded by `max_attempts`, and a completed-but-late call records a
        deadline fault while its result is still served. While the
        breaker is non-CLOSED, or when the retry budget is exhausted, the
        fallback serves. Returns (result, degraded); with no fallback the
        last primary error propagates."""
        deadline = (
            deadline_s if deadline_s is not None
            else self.config.solve_deadline_s
        )
        if self.state != CLOSED and self._probe_task is None:
            self.maybe_probe()  # loop-less embeddings still recover
        if self.state != CLOSED:
            if fallback_fn is None:
                raise RuntimeError(
                    f"supervised call {op}: breaker {self.state}, "
                    f"no fallback"
                )
            return fallback_fn(), True

        attempts = 0
        last_exc: Optional[BaseException] = None
        while True:
            attempts += 1
            self._touch_watchdog()
            t0 = self._clock()
            try:
                result = primary_fn()
            except Exception as exc:
                if is_kernel_fault(exc):
                    raise
                last_exc = exc
                self._record_failure(classify_solver_error(exc), exc)
                if self.state != CLOSED:
                    break
                if attempts >= max(self.config.max_attempts, 1):
                    break
                self._bump("decision.spf.solver_retries")
                continue
            finally:
                self._touch_watchdog()
            elapsed = self._clock() - t0
            if elapsed > deadline:
                self._record_failure(
                    FAULT_DEADLINE,
                    SolveDeadlineExceeded(
                        f"{op} took {elapsed:.3f}s (deadline {deadline}s)"
                    ),
                    elapsed_s=elapsed,
                )
            else:
                self._record_success()
            # the non-SPF device workloads leave ring evidence too: an
            # APSP close or TE dispatch sits in the same solve history a
            # forensics dump reconstructs
            self._record_event_trace(
                "device_call",
                layout="apsp" if "apsp" in op else "device",
                solve_ms=elapsed * 1e3,
                detail=op,
            )
            return result, False

        if fallback_fn is None:
            raise last_exc
        return fallback_fn(), True

    # ------------------------------------------------------------------
    # DeltaPath (device-side route-delta) fault domain
    # ------------------------------------------------------------------

    def poll_device_delta(self, area_link_states):
        """Supervised DeltaPath poll: while the breaker is non-CLOSED the
        primary's device state is not serving (and was invalidated on the
        trip), so the answer is always None — the route build takes the
        full path through the fallback. A solve fault inside the poll is
        classified and fed to the breaker exactly like a supervised solve
        failure, then reported as 'no delta' so the event is served by the
        (retrying, degradable) full build."""
        if self.state != CLOSED:
            return None
        poll = getattr(self.primary, "poll_device_delta", None)
        if poll is None:
            return None
        try:
            delta = poll(area_link_states)
        except Exception as exc:
            if is_kernel_fault(exc):
                raise
            self._record_failure(classify_solver_error(exc), exc)
            return None
        self._sync_backend_stats(self.primary)
        return delta

    def verify_route_delta(
        self, delta_db, my_node_name, area_link_states, prefix_state
    ):
        """Shadow audit of a delta-built route db: every `audit_interval`-th
        delta build, recompute the full db from the primary (plus the
        existing warm-state cold-mirror audit underneath it, via
        _maybe_audit) and compare. A mismatch means the partial rebuild
        dropped or fabricated a route: self-heal by invalidating the warm
        state and serving the full rebuild — returns the corrected db, or
        None when the delta-built db checks out (or no audit was due)."""
        if self.config.audit_interval <= 0:
            return None
        self._delta_builds_since_audit += 1
        if self._delta_builds_since_audit < self.config.audit_interval:
            return None
        self._delta_builds_since_audit = 0
        self._bump("decision.spf.delta_audit_runs")
        full_db = self.build_route_db(
            my_node_name, area_link_states, prefix_state
        )
        if full_db is None:
            return None
        diff = get_route_delta(full_db, delta_db)
        reverse = get_route_delta(delta_db, full_db)
        if diff.empty() and reverse.empty():
            return None
        self._bump("decision.spf.delta_audit_mismatches")
        log.error(
            "route-delta audit mismatch: %d updates / %d deletes missing "
            "from the delta-built db; forcing the full path",
            len(diff.unicast_routes_to_update) + len(diff.mpls_routes_to_update),
            len(diff.unicast_routes_to_delete) + len(diff.mpls_routes_to_delete),
        )
        forensics_id = self._forensics_dump("delta_audit_mismatch")
        self._emit_sample(
            "ROUTE_DELTA_AUDIT_MISMATCH",
            {"forensics_id": forensics_id or ""},
            {
                "unicast_diverged": len(diff.unicast_routes_to_update)
                + len(diff.unicast_routes_to_delete),
                "mpls_diverged": len(diff.mpls_routes_to_update)
                + len(diff.mpls_routes_to_delete),
            },
        )
        # the partial rebuild derives from the resident warm state: after a
        # route-level divergence it is not to be trusted either
        self._invalidate_primary_warm_state()
        return full_db

    # static-route pass-through: both backends ingest every push so the
    # fallback's static MPLS state is identical the moment it must serve
    def push_static_routes_delta(self, mpls_to_update, mpls_to_delete):
        self.primary.push_static_routes_delta(mpls_to_update, mpls_to_delete)
        self.fallback.push_static_routes_delta(mpls_to_update, mpls_to_delete)

    def static_routes_updated(self) -> bool:
        return self.primary.static_routes_updated()

    def process_static_route_updates(self):
        delta = self.primary.process_static_route_updates()
        self.fallback.process_static_route_updates()  # keep state in lockstep
        return delta

    @property
    def static_mpls_routes(self):
        return self.primary.static_mpls_routes

    def __getattr__(self, name: str):
        # drop-in facade: introspection attributes the supervisor does not
        # shadow (device_solves, mesh, warm_start, ...) read through to the
        # primary backend. Only called for attributes missing on self.
        if name.startswith("_") or name == "primary":
            raise AttributeError(name)
        return getattr(self.primary, name)

    # ------------------------------------------------------------------
    # breaker mechanics
    # ------------------------------------------------------------------

    def _fallback_solve(self, my_node_name, area_link_states, prefix_state):
        self._bump("decision.spf.fallback_solves")
        t0 = self._clock()
        db = self.fallback.build_route_db(
            my_node_name, area_link_states, prefix_state
        )
        self._record_event_trace(
            "fallback_solve",
            layout="cpu",
            solve_ms=(self._clock() - t0) * 1e3,
        )
        self._sync_backend_stats(self.fallback)
        return db

    def _record_event_trace(
        self,
        event: str,
        *,
        layout: str = "none",
        solve_ms: Optional[float] = None,
        fault_kind: Optional[str] = None,
        detail: Optional[str] = None,
    ) -> None:
        """Supervisor-level SolveTrace (fallback solves, classified
        faults): no per-phase detail — the device never ran — but the
        event lands in the same ring as the device traces, so a forensics
        dump shows the degraded serving next to the solves that led to
        it."""
        from openr_tpu_torch.solver.flight_recorder import SolveTrace

        rec = self.recorder
        rec.record(
            SolveTrace(
                seq=rec.next_seq(),
                ts=time.time(),
                area="*",
                node=self.my_node_name,
                event=event,
                layout=layout,
                warm=False,
                solve_ms=solve_ms,
                rounds=None,
                invalidation_rounds=None,
                halo_exchanges=None,
                h2d_bytes=0,
                d2h_bytes=0,
                halo_bytes=0,
                delta_columns=None,
                compile_cache_misses=0,
                breaker_state=self.state,
                sampled=False,
                fault_kind=fault_kind,
                detail=detail,
            )
        )

    def _forensics_dump(self, reason: str) -> Optional[str]:
        """Snapshot the flight-recorder rings + solver context into one
        forensics artifact; returns the dump id referenced from the
        breaker/audit LogSamples. Every fault-domain transition calls
        this BEFORE invalidating warm state, so the dump still holds the
        solve history that led to the fault."""
        import dataclasses

        from openr_tpu_torch.solver.flight_recorder import device_digest

        from openr_tpu_torch.monitor.memledger import get_ledger

        dump = self.recorder.dump(
            reason,
            solver_config=dataclasses.asdict(self.config),
            counters={
                k: v
                for k, v in self.counters.items()
                if k.startswith(("decision.spf.", "decision.mem."))
            },
            mesh_digest=device_digest(getattr(self.primary, "mesh", None)),
            # the full memory-ledger snapshot rides EVERY forensics dump:
            # an OOM post-mortem must name the structures that were
            # resident when the fault domain transitioned
            device_memory=get_ledger().snapshot(),
        )
        self._bump("decision.spf.forensics_dumps")
        self._emit_sample(
            "SOLVER_FORENSICS_DUMPED",
            {"forensics_id": dump["id"], "reason": reason},
            {"traces": sum(len(t) for t in dump["traces"].values())},
        )
        return dump["id"]

    def _record_failure(
        self, kind: str, exc: BaseException, elapsed_s: Optional[float] = None
    ) -> None:
        self.last_fault_kind = kind
        self.consecutive_failures += 1
        self._bump("decision.spf.solver_failures")
        self._bump(f"decision.spf.solver_failures.{kind}")
        self._record_event_trace(
            "fault",
            fault_kind=kind,
            detail=f"{type(exc).__name__}: {exc}"[:200],
        )
        log.warning(
            "supervised solve failure #%d (%s): %s",
            self.consecutive_failures,
            kind,
            exc,
        )
        if kind == FAULT_DEADLINE:
            # a deadline overrun serves its (valid) result but is device
            # evidence worth keeping: snapshot the solve history now,
            # while the slow solve's trace is still in the ring
            self._forensics_dump("deadline")
        if kind == FAULT_DEVICE_OOM:
            # allocator exhaustion: dump IMMEDIATELY, while the ledger
            # still shows the resident set that overflowed the chip —
            # retries and degradations below will start releasing it
            self._forensics_dump("device_oom")
        if elapsed_s is not None and self.watchdog is not None:
            note = getattr(self.watchdog, "note_slow", None)
            if note is not None:
                note(
                    self.config.watchdog_module,
                    elapsed_s,
                    self.config.solve_deadline_s,
                )
        if (
            self.state == CLOSED
            and self.consecutive_failures >= self.config.failure_threshold
        ):
            self._trip()

    def _record_success(self) -> None:
        self.consecutive_failures = 0

    def _trip(self) -> None:
        if self._try_mesh_degrade():
            return  # still CLOSED, serving from the smaller mesh
        log.error(
            "solver circuit breaker TRIPPED after %d consecutive failures "
            "(last fault: %s); serving from CPU oracle",
            self.consecutive_failures,
            self.last_fault_kind,
        )
        self.state = OPEN
        self.recorder.breaker_state = OPEN
        self._bump("decision.spf.breaker_trips")
        self.counters["decision.spf.fallback_active"] = 1
        self.probe_streak = 0
        self._probe_backoff.report_success()  # fresh probe schedule
        self._next_probe_at = self._clock() + self.config.probe_interval_s
        # forensics BEFORE the warm-state drop: the dump must hold the
        # solve history that led here, referenced by id from the sample
        forensics_id = self._forensics_dump("breaker_trip")
        # the device-resident warm state is untrustworthy after a fault:
        # dropping it forces the recovery path to rebuild from cold
        self._invalidate_primary_warm_state()
        self._emit_sample(
            "SOLVER_BREAKER_TRIPPED",
            {
                "fault_kind": self.last_fault_kind or "",
                "forensics_id": forensics_id or "",
            },
            {"consecutive_failures": self.consecutive_failures},
        )

    def _try_mesh_degrade(self) -> bool:
        """One rung of the partial-mesh degradation ladder: on a
        device-loss streak that would trip the breaker, ask the primary to
        re-resolve its mesh over the surviving chips first. A successful
        degradation resets the failure streak and keeps the breaker CLOSED
        — hardware loss costs capacity, not the device path; the CPU
        oracle is the LAST rung, reached only when no viable mesh remains
        (or the fault is not device loss, where a smaller mesh would not
        help)."""
        if not self.config.mesh_degrade:
            return False
        if self.last_fault_kind not in (FAULT_DEVICE_LOSS, FAULT_DEVICE_OOM):
            # a smaller mesh only helps faults that are about the devices
            # themselves: lost chips, or allocator exhaustion (fewer chips
            # = smaller replicated working set per remaining headroom —
            # the replicated->tiled->CPU degrade ladder's middle rungs)
            return False
        degrade = getattr(self.primary, "degrade_mesh", None)
        if degrade is None or not degrade():
            return False
        mesh = getattr(self.primary, "mesh", None)
        shape = dict(mesh.shape) if mesh is not None else None
        log.error(
            "solver mesh degraded after %d consecutive device-loss "
            "failures; re-resolved over surviving chips as %s",
            self.consecutive_failures,
            shape,
        )
        failures = self.consecutive_failures
        self.consecutive_failures = 0
        self._sync_backend_stats(self.primary)
        forensics_id = self._forensics_dump("mesh_degraded")
        self._emit_sample(
            "SOLVER_MESH_DEGRADED",
            {
                "mesh_shape": str(shape or {}),
                "forensics_id": forensics_id or "",
            },
            {
                "consecutive_failures": failures,
                "mesh_devices": int(mesh.devices.size) if mesh else 0,
            },
        )
        return True

    def _close(self) -> None:
        log.warning(
            "solver circuit breaker CLOSED after %d consecutive probe "
            "successes; primary backend restored",
            self.probe_streak,
        )
        self.state = CLOSED
        self.recorder.breaker_state = CLOSED
        self.counters["decision.spf.fallback_active"] = 0
        self.consecutive_failures = 0
        self.probe_streak = 0
        self._emit_sample("SOLVER_BREAKER_CLOSED", {}, {})

    # -- probes ---------------------------------------------------------

    def probe_due(self) -> bool:
        if self.state == CLOSED:
            return False
        if not self._probe_backoff.can_try_now():
            return False
        return self._clock() >= self._next_probe_at

    def maybe_probe(self) -> bool:
        """Run one health probe if the schedule says so; returns whether a
        probe ran. Exposed for tests and loop-less embeddings."""
        if not self.probe_due():
            return False
        self.probe_now()
        return True

    def probe_now(self) -> None:
        """One device health-probe solve against the live LSDB (off the hot
        path: results are discarded, only success/failure matters).
        Hysteresis: `probe_successes_to_close` consecutive successes close
        the breaker; one failure resets the streak and backs off."""
        if self._last_inputs is None or self.state == CLOSED:
            return
        self._bump("decision.spf.probe_attempts")
        my_node_name, area_link_states, prefix_state = self._last_inputs
        # a probe must prove the DEVICE works, not the cache: drop any
        # resident solve so this dispatch compiles + solves cold
        self._invalidate_primary_warm_state()
        self._touch_watchdog()
        try:
            self.primary.build_route_db(
                my_node_name, area_link_states, prefix_state
            )
        except Exception as exc:
            if is_kernel_fault(exc):
                raise
            self._bump("decision.spf.probe_failures")
            self.last_fault_kind = classify_solver_error(exc)
            self.probe_streak = 0
            self.state = OPEN
            self.recorder.breaker_state = OPEN
            self._probe_backoff.report_error()
            self._next_probe_at = (
                self._clock()
                + self._probe_backoff.get_time_remaining_until_retry()
            )
            log.warning("solver health probe failed (%s): %s",
                        self.last_fault_kind, exc)
            # a failed probe may have left partial device state around
            self._invalidate_primary_warm_state()
            return
        finally:
            self._touch_watchdog()
        self._bump("decision.spf.probe_successes")
        self._sync_backend_stats(self.primary)  # probe solve stats, live
        self.probe_streak += 1
        self._probe_backoff.report_success()
        self._next_probe_at = self._clock() + self.config.probe_interval_s
        if self.probe_streak >= self.config.probe_successes_to_close:
            self._close()
        else:
            self.state = HALF_OPEN
            self.recorder.breaker_state = HALF_OPEN

    # -- warm-state audit ------------------------------------------------

    def _maybe_audit(
        self, db, my_node_name, area_link_states, prefix_state
    ):
        if self.config.audit_interval <= 0:
            return db
        audit = getattr(self.primary, "audit_warm_state", None)
        if audit is None:
            return db
        self._solves_since_audit += 1
        if self._solves_since_audit < self.config.audit_interval:
            return db
        self._solves_since_audit = 0
        self._bump("decision.spf.audit_runs")
        mismatches = audit()
        if not mismatches:
            return db
        self._bump("decision.spf.audit_mismatches", len(mismatches))
        for m in mismatches:
            log.error(
                "warm-state audit mismatch in area %s (node %s): "
                "%d diverged entries, max |delta|=%d",
                m["area"], m["node"], m["entries"], m["max_abs_delta"],
            )
        forensics_id = self._forensics_dump("audit_mismatch")
        self._emit_sample(
            "WARM_STATE_AUDIT_MISMATCH",
            {
                "areas": ",".join(m["area"] for m in mismatches),
                "forensics_id": forensics_id or "",
            },
            {
                "mismatched_areas": len(mismatches),
                "mismatched_entries": sum(
                    m["entries"] for m in mismatches
                ),
            },
        )
        # self-heal: drop the diverged warm state and re-solve cold —
        # the corrected routes replace the suspect ones this same event
        self._invalidate_primary_warm_state()
        self._bump("decision.spf.audit_forced_cold_solves")
        db = self.primary.build_route_db(
            my_node_name, area_link_states, prefix_state
        )
        self._sync_backend_stats(self.primary)
        return db

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------

    def invalidate_warm_state(self) -> None:
        """Public warm-state drop, forwarded to the primary. Decision's
        start path calls this on every boot so a whole-node restart
        cold-starts its solves exactly like a resharding event would."""
        self._invalidate_primary_warm_state()

    def _invalidate_primary_warm_state(self) -> None:
        invalidate = getattr(self.primary, "invalidate_warm_state", None)
        if invalidate is not None:
            invalidate()
            # invalidations happen on background paths (trips, probes) —
            # sync immediately so monitor surfaces read them live
            self._sync_backend_stats(self.primary)

    def _touch_watchdog(self) -> None:
        if self.watchdog is not None:
            self.watchdog.touch(self.config.watchdog_module)

    def _sync_backend_stats(self, backend) -> None:
        """Fold the serving backend's decision.spf.* counters/histograms
        into this facade's dicts (Decision's sync loop reads only these)."""
        counters = getattr(backend, "counters", None)
        if isinstance(counters, dict):
            for key, value in counters.items():
                if key.startswith(("decision.spf.", "decision.mem.")):
                    self.counters[key] = value
        ensure = getattr(backend, "_ensure_histograms", None)
        if ensure is not None:
            for key, hist in ensure().items():
                if key.startswith("decision.spf."):
                    self._ensure_histograms()[key] = hist
        self._drain_capacity_refusals(backend)

    def _drain_capacity_refusals(self, backend) -> None:
        """Emit one SOLVER_CAPACITY_REFUSED LogSample per headroom-gated
        admission refusal the backend queued since the last sync: the
        capacity model said a layout would not fit and the solver refused
        or degraded residency instead of letting the allocator raise —
        an explicit, typed event instead of silent non-residency."""
        take = getattr(backend, "take_capacity_refusals", None)
        if take is None:
            return
        for refusal in take():
            self._emit_sample(
                "SOLVER_CAPACITY_REFUSED",
                {
                    "layout": str(refusal.get("layout", "")),
                    "capacity_source": str(refusal.get("source", "")),
                },
                {
                    "n_nodes": int(refusal.get("n_nodes") or 0),
                    "predicted_bytes": int(
                        refusal.get("predicted_bytes") or 0
                    ),
                    "headroom_bytes": int(
                        refusal.get("headroom_bytes") or 0
                    ),
                },
            )

    def _emit_sample(self, event: str, strings: Dict, ints: Dict) -> None:
        if self._log_sample_fn is None:
            return
        from openr_tpu_torch.monitor.monitor import LogSample

        sample = LogSample()
        sample.add_string("event", event)
        sample.add_string("breaker_state", self.state)
        for k, v in strings.items():
            sample.add_string(k, v)
        for k, v in ints.items():
            sample.add_int(k, v)
        try:
            self._log_sample_fn(sample)
        except Exception:  # a full/closed monitor queue must not hurt solves
            log.exception("failed to emit solver supervisor log sample")

    def health(self) -> Dict:
        """Degraded-flag surface served by ctrl getSolverHealth and
        `breeze decision solver-health`."""
        mesh = getattr(self.primary, "mesh", None)
        return {
            "degraded": self.state != CLOSED,
            "breaker_state": self.state,
            "solver_mesh": dict(mesh.shape) if mesh is not None else None,
            "mesh_degradations": self.counters.get(
                "decision.spf.mesh_degradations", 0
            ),
            "fallback_active": int(self.state != CLOSED),
            "consecutive_failures": self.consecutive_failures,
            "probe_streak": self.probe_streak,
            "last_fault_kind": self.last_fault_kind,
            "probe_attempts": self.counters.get(
                "decision.spf.probe_attempts", 0
            ),
            "probe_successes": self.counters.get(
                "decision.spf.probe_successes", 0
            ),
            "probe_failures": self.counters.get(
                "decision.spf.probe_failures", 0
            ),
            "audit_runs": self.counters.get("decision.spf.audit_runs", 0),
            "audit_mismatches": self.counters.get(
                "decision.spf.audit_mismatches", 0
            ),
            "delta_audit_runs": self.counters.get(
                "decision.spf.delta_audit_runs", 0
            ),
            "delta_audit_mismatches": self.counters.get(
                "decision.spf.delta_audit_mismatches", 0
            ),
            "apsp_closes": self.counters.get("decision.spf.apsp_closes", 0),
            "apsp_audit_mismatches": self.counters.get(
                "decision.spf.apsp_audit_mismatches", 0
            ),
            # last-solve timing picture (docs/Monitoring.md): the gauges
            # next to solve_ms_last so `breeze decision solver-health`
            # shows the full per-event latency split without waiting for
            # the phase histograms to fill
            "solve_ms_last": getattr(self.primary, "solve_ms_last", None),
            "delta_extract_ms_last": getattr(
                self.primary, "delta_extract_ms_last", None
            ),
            "apsp_close_ms_last": getattr(
                self.primary, "apsp_close_ms_last", None
            ),
            # flight-recorder ring + forensics state
            "traces": self.recorder.stats(),
            "forensics": self.recorder.forensics_stats(),
            # device-memory observatory rows (monitor/memledger.py):
            # resident totals, the exact-accounting verdict, and the last
            # headroom-gated capacity refusal
            "device_memory": self._device_memory_health(),
        }

    def _device_memory_health(self) -> Dict:
        from openr_tpu_torch.monitor.memledger import get_ledger

        ledger = get_ledger()
        return {
            "live_bytes": ledger.live_bytes,
            "peak_bytes": ledger.peak_bytes,
            "registered_bytes": ledger.registered_bytes,
            "freed_bytes": ledger.freed_bytes,
            "exact": ledger.check(),
            "structures": ledger.structure_bytes(),
            "capacity": ledger.capacity(),
            "capacity_refusals": ledger.capacity_refusals,
            "last_refusal": ledger.last_refusal,
        }
