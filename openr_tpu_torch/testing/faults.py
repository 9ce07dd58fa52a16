"""Deterministic fault-injection harness.

Production modules declare *named fault points* — `fault_point("fib.sync")`
— at the exact seams where real deployments fail (device solve dispatch,
FIB agent RPCs, KvStore flood sends). With no injector installed a fault
point is a single global-None check, so the serving path pays nothing.
Tests install a `FaultInjector` and arm schedules against those names:

    with injected(FaultInjector(seed=7)) as inj:
        inj.arm("solver.tpu.solve", times=3)          # next 3 solves raise
        inj.arm("fib.sync", probability=0.5, times=8) # seeded coin flips
        inj.arm("fib.keepalive", action=lambda fib: handler.restart())
        ...

Determinism rules:
  - trigger-count schedules (`after` skip + `times` budget) are exact;
  - probability schedules draw from the injector's own seeded RNG, so a
    given seed replays the same fault pattern;
  - every decision is recorded (`hits` / `fired`) for assertions.

The injector never fires on its own thread or timer — faults happen only
when execution reaches the instrumented seam, which keeps multi-module
failure scenarios (e.g. Decision(tpu)→Fib flap sequences) fully
reproducible without real hardware errors. This is the testing half of the
solver fault domain (docs/Robustness.md); `SolverSupervisor` et al. are
the serving half.
"""

from __future__ import annotations

import contextlib
import random
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional


class FaultInjected(RuntimeError):
    """Default exception raised by an armed fault point."""

    def __init__(self, point: str) -> None:
        super().__init__(f"injected fault at {point}")
        self.point = point


@dataclass
class FaultSpec:
    """One armed schedule for one named fault point.

    The fault fires when all of:
      - more than `after` hits have already been observed (skip-count);
      - the `times` budget (None = unlimited) is not exhausted;
      - the seeded coin flip passes (`probability`, default always).

    Firing raises `exc(point)` — or calls `action(ctx)` instead when an
    action is armed (state-mutating faults: agent restarts, warm-state
    corruption), in which case nothing is raised unless the action raises.
    """

    point: str
    times: Optional[int] = 1
    probability: float = 1.0
    after: int = 0
    exc: Callable[[str], BaseException] = FaultInjected
    action: Optional[Callable[[Any], None]] = None
    # instance targeting: hits whose ctx fails the predicate are ignored
    # entirely (multi-instance scenarios arm one module object, not all)
    when: Optional[Callable[[Any], bool]] = None
    # bookkeeping
    hits: int = 0
    fired: int = 0

    def exhausted(self) -> bool:
        return self.times is not None and self.fired >= self.times


@dataclass
class FaultInjector:
    """Named fault points with deterministic trigger schedules."""

    seed: int = 0
    _specs: Dict[str, FaultSpec] = field(default_factory=dict)
    _hits: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    # -- arming --------------------------------------------------------

    def arm(
        self,
        point: str,
        *,
        times: Optional[int] = 1,
        probability: float = 1.0,
        after: int = 0,
        exc: Callable[[str], BaseException] = FaultInjected,
        action: Optional[Callable[[Any], None]] = None,
        when: Optional[Callable[[Any], bool]] = None,
    ) -> FaultSpec:
        assert 0.0 <= probability <= 1.0, probability
        spec = FaultSpec(
            point=point,
            times=times,
            probability=probability,
            after=after,
            exc=exc,
            action=action,
            when=when,
        )
        self._specs[point] = spec
        return spec

    def disarm(self, point: str) -> None:
        self._specs.pop(point, None)

    def reset(self) -> None:
        self._specs.clear()
        self._hits.clear()

    # -- introspection -------------------------------------------------

    def hits(self, point: str) -> int:
        """How many times execution reached the point (armed or not)."""
        return self._hits.get(point, 0)

    def fired(self, point: str) -> int:
        spec = self._specs.get(point)
        return spec.fired if spec is not None else 0

    def spec(self, point: str) -> Optional[FaultSpec]:
        return self._specs.get(point)

    # -- the firing seam -----------------------------------------------

    def fire(self, point: str, ctx: Any = None) -> None:
        """Called by `fault_point`; raises/acts when the point is armed and
        its schedule says so."""
        self._hits[point] = self._hits.get(point, 0) + 1
        spec = self._specs.get(point)
        if spec is None or spec.exhausted():
            return
        if spec.when is not None and not spec.when(ctx):
            return
        spec.hits += 1
        if spec.hits <= spec.after:
            return
        if spec.probability < 1.0 and self._rng.random() >= spec.probability:
            return
        spec.fired += 1
        if spec.action is not None:
            spec.action(ctx)
            return
        raise spec.exc(spec.point)


# ---------------------------------------------------------------------------
# global installation (what production fault points consult)
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_installed: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    global _installed
    with _lock:
        _installed = injector
    return injector


def uninstall() -> None:
    global _installed
    with _lock:
        _installed = None


def installed() -> Optional[FaultInjector]:
    return _installed


def fault_point(name: str, ctx: Any = None) -> None:
    """Production seam: no-op unless an injector is installed AND has an
    armed, unexhausted schedule for `name`."""
    inj = _installed
    if inj is not None:
        inj.fire(name, ctx)


@contextlib.contextmanager
def injected(injector: Optional[FaultInjector] = None):
    """Install an injector for the scope of a with-block (always
    uninstalls, even when the injected fault propagates out)."""
    inj = injector if injector is not None else FaultInjector()
    install(inj)
    try:
        yield inj
    finally:
        uninstall()


# Fault-point catalog (docs/Robustness.md keeps the authoritative table).
# Port: the solver seams keep the JAX package's names, so one fault script
# arms both packages; `solver.tpu.*` sit in solver/cuda.py, the ops.spf
# seams in ops/spf.py, `solver.apsp.close` in apsp/state.py. The fib,
# kvstore, spark, ctrl, configstore and fleet seams come with those modules.
#
#   solver.tpu.solve      _AreaSolve device solve dispatch (solver/tpu.py)
#   solver.tpu.warm_d     post-solve hook, ctx=_AreaSolve — corrupt warm D
#   ops.spf.batched_spf   cold batched solve entry (ops/spf.py)
#   ops.spf.batched_spf_vw  per-row-weights solve entry (KSP path)
#   fib.program           route-delta programming RPC block (fib/fib.py)
#   fib.sync              full-state syncFib push (fib/fib.py)
#   fib.keepalive         agent aliveSince poll, ctx=Fib (fib/fib.py)
#   kvstore.flood_send    per-peer flood RPC, ctx=peer name (kvstore/store.py)
#   kvstore.full_sync     3-way full-sync dump RPC, ctx=peer name
#   kvstore.quarantine_probe  quarantined-peer probe dump RPC, ctx=peer name
#   kvstore.anti_entropy  adaptive anti-entropy digest sync, ctx=peer name
#   spark.packet_send     outbound datagram seam, ctx=iface (spark/spark.py)
#   spark.packet_recv     inbound datagram seam, ctx=ReceivedPacket
#   te.optimize           TE optimization device dispatch (te/service.py)
#   monitor.exporter.push metrics push-sink write, ctx=MetricsExporter
#                         (monitor/exporter.py)
#   ctrl.stream.publish   streaming fan-out dispatch, ctx=item
#                         (streaming/subscription.py)
#   ctrl.stream.deliver   per-frame stream delivery, ctx=subscription;
#                         actions may set sub.throttle_s (ctrl/server.py)
#   ctrl.admission.dispatch  admitted expensive-RPC dispatch, ctx=method
#                         (streaming/admission.py)
#   configstore.save      PersistentStore durable write (journal append or
#                         snapshot compaction), ctx=PersistentStore
#                         (configstore/persistent_store.py)
#   configstore.load      PersistentStore boot-time read, ctx=PersistentStore
#   fleet.scrape          fleet-observer per-node scrape, ctx=node name
#                         (fleet/observer.py)
