"""The solver fault domain on the port against the JAX package's, on the CPU.

The reference's `tests/test_solver_supervisor.py` classes
(TestClassification ... TestDecisionIntegration) run as fault scripts: the
same script, its faults armed through each package's own injector, drives
a SolverSupervisor over the port's CudaSpfSolver (device="cpu", the
kernels' plain PyTorch versions) and one over the JAX package's
TpuSpfSolver. Both must give the same served route dbs (canonical form),
the same breaker transitions, the same `decision.spf.*` and `decision.mem.*`
counters (less the compile-cache counters and the transfer bytes, as in
tests/test_torch_decision.py), the same sample counts of the
`decision.spf.phase.*_ms` histograms, the same LogSample event names and
the same `health()` less its device_memory and traces fields (the real
ledger's bytes and the barrier count, which differ by the named arrays
and by device), its timing gauges and its dumps' time-stamped ids. Each
package runs on a fresh process ledger, the port's a `PortLedger`
(tests/test_torch_memledger.py): its counters leave out the arrays the
port keeps and the JAX package does not, and the port's own ledger is
held against its `predict_fit`, structure by structure, for every live
solve. Two scripts set a capacity (source `override`, a verdict on the
CPU too): one refuses the all-pairs matrix, one the sliced layout.

Port-only cases: `classify_solver_error` on the errors torch raises (a real
`torch.cuda.OutOfMemoryError`, the CUDA runtime's texts with torch's
advice sentence), a kernel that does not build, launch or run passing
through the supervisor, Decision and `run_te_optimize` instead of being
served by the CPU oracle, and a faulted warm solve that is solved again
instead of serving a stale D.
"""

import dataclasses
import types as pytypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openr_tpu.decision as j_decision
import openr_tpu.lsdb as j_lsdb
import openr_tpu.messaging as j_messaging
import openr_tpu.monitor as j_monitor
import openr_tpu.solver as j_solver
import openr_tpu.solver.supervisor as j_sup
import openr_tpu.testing.decision_harness as j_harness
import openr_tpu.testing.faults as j_faults
import openr_tpu.topology as j_topology
import openr_tpu.types as j_types
import openr_tpu_torch.decision as t_decision
import openr_tpu_torch.lsdb as t_lsdb
import openr_tpu_torch.messaging as t_messaging
import openr_tpu_torch.monitor as t_monitor
import openr_tpu_torch.solver as t_solver
import openr_tpu_torch.solver.supervisor as t_sup
import openr_tpu_torch.testing.decision_harness as t_harness
import openr_tpu_torch.testing.faults as t_faults
import openr_tpu_torch.topology as t_topology
import openr_tpu_torch.types as t_types
from openr_tpu_torch import parallel
from openr_tpu_torch.ops import _cuda
from test_torch_decision import (  # noqa: F401 (an autouse fixture)
    _NOT_SHARED,
    canon,
    fresh_ledgers,
)
from test_torch_memory import release_memory_around_each_test  # noqa: F401


def _port_mesh(shape):
    if shape is None:
        return None
    return parallel.make_mesh([torch.device("cpu")] * (shape[0] * shape[1]),
                              shape)


JAX = pytypes.SimpleNamespace(
    name="jax",
    lsdb=j_lsdb, solver=j_solver, sup=j_sup, faults=j_faults,
    topology=j_topology, T=j_types, monitor=j_monitor,
    decision=j_decision, messaging=j_messaging, harness=j_harness,
    primary=lambda me, mesh=None, **kw: j_solver.TpuSpfSolver(
        me, mesh=mesh, **kw),
    backend={"solver_backend": "tpu"},
    to_device=jnp.asarray,
)
PORT = pytypes.SimpleNamespace(
    name="port",
    lsdb=t_lsdb, solver=t_solver, sup=t_sup, faults=t_faults,
    topology=t_topology, T=t_types, monitor=t_monitor,
    decision=t_decision, messaging=t_messaging, harness=t_harness,
    primary=lambda me, mesh=None, **kw: t_solver.CudaSpfSolver(
        me, device="cpu", mesh=_port_mesh(mesh), **kw),
    backend={"solver_backend": "cuda", "solver_device": "cpu"},
    to_device=lambda d: torch.as_tensor(d),
)



def assert_layouts_match_predict_fit(solver):
    """The port's registered bytes of every live solve, structure by
    structure, are its own predict_fit's components for the solve's
    layout, graph, batch and mesh (the host mirror is a consumer's, not
    the layout's)."""
    import openr_tpu_torch.monitor.memledger as t_memledger

    led = t_memledger.get_ledger()
    for _, solve in solver._solves.values():
        kind = (solve._dev or {}).get("kind")
        if kind is None:
            continue
        mesh = solve.mesh
        fit = led.predict_fit(
            solve.graph.n, kind, n_sources=len(solve.sources),
            graph=solve.graph,
            mesh_shape=(None if mesh is None else
                        (mesh.shape["batch"], mesh.shape["graph"])))
        got = {}
        for e in led.live_entries(solve._mem_area):
            if e.structure not in ("mirror", "ksp", "apsp"):
                got[e.structure] = got.get(e.structure, 0) + e.nbytes
        assert got == fit["components"], (kind, got, fit["components"])
_HEALTH_TIMES = ("solve_ms_last", "delta_extract_ms_last",
                 "apsp_close_ms_last")


class FakeClock:
    def __init__(self) -> None:
        self.t = 100.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


ANNOUNCERS = {"g2_2": ["10.1.0.0/16"], "g0_2": ["10.2.0.0/16"]}


def build_ls(K, edges=None):
    ls = K.lsdb.LinkState("0")
    for db in K.topology.build_adj_dbs(
        edges or K.topology.grid_edges(3)
    ).values():
        ls.update_adjacency_database(db)
    return ls


def make_ps(K):
    ps = K.lsdb.PrefixState()
    for node, pfxs in ANNOUNCERS.items():
        ps.update_prefix_database(K.T.PrefixDatabase(
            node, [K.T.PrefixEntry(K.T.IpPrefix(p)) for p in pfxs],
            area="0"))
    return ps


def solve_inputs(K):
    return "g0_0", {"0": build_ls(K)}, make_ps(K)


def oracle_db(K):
    me, states, ps = solve_inputs(K)
    return K.solver.SpfSolver(me).build_route_db(me, states, ps)


def assert_route_db_equal(a, b):
    assert a is not None and b is not None
    assert canon(a.unicast_entries) == canon(b.unicast_entries)
    assert canon(a.mpls_entries) == canon(b.mpls_entries)


def make_supervisor(K, me="g0_0", clock=None, watchdog=None, samples=None,
                    mesh=None, **cfg_kw):
    return K.sup.SolverSupervisor(
        K.primary(me, mesh=mesh),
        K.solver.SpfSolver(me),
        K.sup.SupervisorConfig(**cfg_kw),
        watchdog=watchdog,
        log_sample_fn=(samples.append if samples is not None else None),
        clock=clock or FakeClock(),
    )


def _device_lost(point):
    return RuntimeError(f"device is lost at {point}")


class Obs:
    """What one package's run of a fault script showed."""

    def __init__(self) -> None:
        self.dbs = []
        self.states = []
        self.final = {}

    def db(self, db):
        self.dbs.append(None if db is None else (
            canon(db.unicast_entries), canon(db.mpls_entries)))
        return db

    def state(self, sup):
        self.states.append(sup.state)

    def end(self, sup, samples=()):
        health = {k: v for k, v in sup.health().items()
                  if k not in ("device_memory", "traces", *_HEALTH_TIMES)}
        health["forensics"] = {k: v for k, v in health["forensics"].items()
                               if k != "last_id"}
        if isinstance(sup.primary, t_solver.CudaSpfSolver):
            assert_layouts_match_predict_fit(sup.primary)
        self.final = {
            "counters": {
                k: v for k, v in sup.counters.items()
                if k.startswith(("decision.spf.", "decision.mem."))
                and k not in _NOT_SHARED
            },
            "phase_samples": {
                k: h.count for k, h in sup.histograms.items()
                if k.startswith("decision.spf.phase.")
            },
            "samples": [s.get("event") for s in samples],
            "health": health,
            "times_set": {k: sup.health()[k] is not None
                          for k in _HEALTH_TIMES},
        }


def both(script):
    """Run script(K, obs) on the port and on the JAX package, each with its
    own injector installed; the observations must be equal."""
    got = {}
    for K in (PORT, JAX):
        obs = Obs()
        with K.faults.injected(K.faults.FaultInjector(seed=0)) as inj:
            script(K, obs, inj)
        got[K.name] = obs
    port, ref = got["port"], got["jax"]
    assert port.dbs == ref.dbs
    assert port.states == ref.states
    assert port.final == ref.final
    return port


# -- TestClassification ------------------------------------------------------


@pytest.mark.parametrize("K", [PORT, JAX], ids=["port", "jax"])
@pytest.mark.parametrize("exc,kind", [
    ("deadline", "deadline"),
    (RuntimeError("DEVICE_LOST: chip 3 went away"), "device_loss"),
    (RuntimeError("XLA compile failed: out of registers"), "compile"),
    (TypeError("bad avals"), "compile"),
    (RuntimeError("boom"), "runtime"),
    ("injected", "runtime"),
    ("chained", "device_loss"),
])
def test_classification_equals_the_reference(K, exc, kind):
    if exc == "deadline":
        exc = K.sup.SolveDeadlineExceeded("x")
    elif exc == "injected":
        exc = K.faults.FaultInjected("p")
    elif exc == "chained":
        try:
            try:
                raise RuntimeError("device is lost")
            except RuntimeError as inner:
                raise ValueError("wrapper") from inner
        except ValueError as err:
            exc = err
    assert K.sup.classify_solver_error(exc) == kind


def test_a_real_cuda_out_of_memory_error_classifies_as_device_oom():
    """The OOM pin: the error torch raises for an allocation past the
    card's memory (its class and its text, "CUDA out of memory. Tried to
    allocate ..."), made here as torch's allocator makes it."""
    text = (
        "CUDA out of memory. Tried to allocate 1024.00 GiB. GPU 0 has a "
        "total capacity of 79.18 GiB of which 78.57 GiB is free. Process 1 "
        "has 612.00 MiB memory in use. Of the allocated memory 0 bytes is "
        "allocated by PyTorch, and 0 bytes is reserved by PyTorch but "
        "unallocated. If reserved but unallocated memory is large try "
        "setting PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True to avoid "
        "fragmentation.  See documentation for Memory Management  "
        "(https://pytorch.org/docs/stable/notes/cuda.html#environment-"
        "variables)"
    )
    exc = torch.cuda.OutOfMemoryError(text)
    assert isinstance(exc, RuntimeError)
    assert t_sup.classify_solver_error(exc) == t_sup.FAULT_DEVICE_OOM
    # wrapped by a solve, the chain still names it
    try:
        try:
            raise exc
        except torch.cuda.OutOfMemoryError as inner:
            raise RuntimeError("area solve failed") from inner
    except RuntimeError as outer:
        assert t_sup.classify_solver_error(outer) == t_sup.FAULT_DEVICE_OOM


# torch's CUDA error text: "CUDA error: <the runtime's string>", then its
# advice, whose "Compile with" says nothing of the fault's kind
_TORCH_ADVICE = (
    "\nCUDA kernel errors might be asynchronously reported at some other "
    "API call, so the stacktrace below might be incorrect.\nFor debugging "
    "consider passing CUDA_LAUNCH_BLOCKING=1\nCompile with "
    "`TORCH_USE_CUDA_DSA` to enable device-side assertions.\n"
)


@pytest.mark.parametrize("runtime_text,kind,kernel_fault", [
    ("an illegal memory access was encountered", "runtime", True),
    ("device-side assert triggered", "runtime", True),
    ("unspecified launch failure", "runtime", True),
    ("no CUDA-capable device is detected", "device_loss", False),
    ("CUDA-capable device(s) is/are busy or unavailable", "device_loss",
     False),
    ("uncorrectable ECC error encountered", "device_loss", False),
    ("out of memory", "device_oom", False),
])
def test_torch_cuda_error_texts_classify_by_their_fault(runtime_text, kind,
                                                        kernel_fault):
    """Each text lands in its bucket; a kernel's fault is also a kernel
    fault, which the supervisor raises, while device loss and OOM keep the
    breaker and the oracle."""
    for cls in (RuntimeError, getattr(torch, "AcceleratorError",
                                      RuntimeError)):
        exc = cls(f"CUDA error: {runtime_text}{_TORCH_ADVICE}")
        assert t_sup.classify_solver_error(exc) == kind, cls
        assert t_sup.is_kernel_fault(exc) == kernel_fault, cls
    # the reference reads torch's advice as a compile fault
    exc = RuntimeError(f"CUDA error: {runtime_text}{_TORCH_ADVICE}")
    if kind == "runtime":
        assert j_sup.classify_solver_error(exc) == "compile"


def test_a_kernel_that_does_not_build_is_not_served_by_the_oracle():
    """An nvcc failure is the deployment's fault: it passes through the
    supervisor (no failure recorded, no fallback solve), through a
    supervised call, and is classified by name only."""
    err = _cuda.KernelBuildError("nvcc failed:\nsell_relax.cu: error")
    assert t_sup.is_kernel_fault(err)
    assert not t_sup.is_kernel_fault(RuntimeError("nvcc failed"))
    sup = make_supervisor(PORT, failure_threshold=1, max_attempts=2)

    def build_fails(point):
        return _cuda.KernelBuildError(f"nvcc failed at {point}")

    with t_faults.injected() as inj:
        inj.arm("solver.tpu.solve", times=None, exc=build_fails)
        with pytest.raises(_cuda.KernelBuildError):
            sup.build_route_db(*solve_inputs(PORT))
        with pytest.raises(_cuda.KernelBuildError):
            sup.supervised_call(
                "te.optimize", lambda: (_ for _ in ()).throw(
                    build_fails("te")), lambda: "cpu")
    assert sup.state == t_sup.CLOSED
    assert "decision.spf.solver_failures" not in sup.counters
    assert "decision.spf.fallback_solves" not in sup.counters


# what the card raises when a kernel fails: a launch the runtime refuses
# (ops/_cuda.py's Kernel.launch), and torch's text for a kernel that
# faulted, as RuntimeError and as the AcceleratorError of newer releases
_KERNEL_FAULTS = [
    lambda point: _cuda.KernelLaunchError(
        f"CUDA kernel sell_relax_round failed to launch: cudaError 9 "
        f"({point})"),
    *(
        (lambda cls, text: lambda point: cls(f"CUDA error: {text}"
                                             f"{_TORCH_ADVICE}"))(cls, text)
        for cls in (RuntimeError,
                    getattr(torch, "AcceleratorError", RuntimeError))
        for text in (
            "an illegal memory access was encountered",
            "device-side assert triggered",
            "unspecified launch failure",
            "misaligned address",
            "an illegal instruction was encountered",
            "no kernel image is available for execution on the device",
            "too many resources requested for launch",
        )
    ),
]


@pytest.mark.parametrize("make_exc", _KERNEL_FAULTS)
def test_a_kernel_that_fails_on_the_card_is_not_served_by_the_oracle(
    make_exc
):
    """A refused launch or a kernel fault passes the supervisor's solve,
    its supervised call and its probe: no failure recorded, no fallback,
    the breaker closed."""
    assert t_sup.is_kernel_fault(make_exc("x"))
    t = FakeClock()
    sup = make_supervisor(PORT, clock=t, failure_threshold=1, max_attempts=2,
                          probe_interval_s=1.0)
    with t_faults.injected() as inj:
        inj.arm("solver.tpu.solve", times=None, exc=make_exc)
        with pytest.raises(type(make_exc("x"))):
            sup.build_route_db(*solve_inputs(PORT))
        with pytest.raises(type(make_exc("x"))):
            sup.supervised_call(
                "te.optimize", lambda: (_ for _ in ()).throw(
                    make_exc("te")), lambda: "cpu")
    assert sup.state == t_sup.CLOSED
    assert "decision.spf.solver_failures" not in sup.counters
    assert "decision.spf.fallback_solves" not in sup.counters
    # a probe of an open breaker raises it too, instead of counting it
    with t_faults.injected() as inj:
        inj.arm("solver.tpu.solve", times=None)
        sup.build_route_db(*solve_inputs(PORT))
        assert sup.state == t_sup.OPEN
        inj.disarm("solver.tpu.solve")
        inj.arm("solver.tpu.solve", times=None, exc=make_exc)
        t.advance(2.0)
        with pytest.raises(type(make_exc("x"))):
            sup.maybe_probe()
    assert "decision.spf.probe_failures" not in sup.counters


def test_a_refused_launch_raises_out_of_decision_and_run_te_optimize():
    """Decision(cuda) on the CPU with a refused launch armed at the solve:
    the error reaches the loop's exception handler, no delta is emitted,
    the breaker stays closed; disarmed, the next publication's delta
    equals Decision(cpu)'s. run_te_optimize raises it as well."""
    import asyncio

    def refused(point):
        return _cuda.KernelLaunchError(f"refused at {point}")

    dbs = t_topology.build_adj_dbs(t_topology.grid_edges(3))
    pub = t_harness.lsdb_publication(dbs.values(), ANNOUNCERS)
    event = t_harness.lsdb_publication([
        dataclasses.replace(dbs[a], adjacencies=[
            dataclasses.replace(x, metric=5) if x.other_node_name == b
            else x for x in dbs[a].adjacencies])
        for a, b in (("g0_1", "g0_2"), ("g0_2", "g0_1"))
    ])
    raised = []

    async def body():
        asyncio.get_running_loop().set_exception_handler(
            lambda loop, ctx: raised.append(ctx.get("exception")))
        kv_q, route_q = t_messaging.RWQueue(), t_messaging.ReplicateQueue()
        decision = t_decision.Decision(
            t_decision.DecisionConfig(
                my_node_name="g0_0", debounce_min=0.005, debounce_max=0.02,
                **PORT.backend),
            t_messaging.RQueue(kv_q), route_q,
        )
        reader = route_q.get_reader()
        decision.start()
        try:
            with t_faults.injected() as inj:
                inj.arm("solver.tpu.solve", times=None, exc=refused)
                kv_q.push(pub)
                deadline = asyncio.get_running_loop().time() + 10.0
                while not raised:
                    assert asyncio.get_running_loop().time() < deadline
                    await asyncio.sleep(0.005)
                await asyncio.sleep(0.05)  # no timed retry follows
            assert reader.size() == 0
            kv_q.push(event)
            delta = await asyncio.wait_for(reader.get(), 10.0)
            with t_faults.injected() as inj:
                inj.arm("te.optimize", times=None, exc=refused)
                with pytest.raises(_cuda.KernelLaunchError):
                    decision.run_te_optimize({"steps": 2})
        finally:
            task = decision._task
            decision.stop()
            if task is not None:
                await asyncio.gather(task, return_exceptions=True)
        return decision, delta

    decision, delta = asyncio.new_event_loop().run_until_complete(body())
    assert len(raised) == 1
    assert isinstance(raised[0], _cuda.KernelLaunchError)
    c = decision.counters
    assert c["decision.route_build_errors"] == 1
    assert c["decision.te.optimize_errors"] == 1
    assert "decision.te.fallback_runs" not in c
    assert c["decision.spf.fallback_active"] == 0
    assert "decision.spf.solver_failures" not in c
    assert "decision.spf.fallback_solves" not in c
    assert decision.get_solver_health()["breaker_state"] == "closed"
    # the full build after the failed one, from the card's path
    want = asyncio.new_event_loop().run_until_complete(
        t_harness.decision_route_delta("g0_0", t_harness.lsdb_publication(
            [dataclasses.replace(db, adjacencies=[
                dataclasses.replace(x, metric=5)
                if (n, x.other_node_name) in (("g0_1", "g0_2"),
                                              ("g0_2", "g0_1"))
                else x for x in db.adjacencies])
             for n, db in dbs.items()], ANNOUNCERS), "cpu"))
    t_harness.assert_route_delta_equal(delta, want)


def test_meshless_primary_trips_as_before():
    def script(K, obs, inj):
        sup = make_supervisor(K, failure_threshold=1, max_attempts=1)
        inj.arm("solver.tpu.solve", times=None, exc=_device_lost)
        obs.db(sup.build_route_db(*solve_inputs(K)))
        obs.state(sup)
        assert sup.state == K.sup.OPEN
        assert sup.health()["solver_mesh"] is None
        obs.end(sup)

    both(script)


# -- TestSupervisedSolve -----------------------------------------------------


def test_clean_path_serves_primary():
    def script(K, obs, inj):
        sup = make_supervisor(K)
        db = obs.db(sup.build_route_db(*solve_inputs(K)))
        assert_route_db_equal(db, oracle_db(K))
        assert sup.state == K.sup.CLOSED
        assert "decision.spf.fallback_solves" not in sup.counters
        obs.end(sup)

    both(script)


def test_retry_within_call_heals_transient_fault():
    def script(K, obs, inj):
        sup = make_supervisor(K, failure_threshold=5, max_attempts=2)
        inj.arm("solver.tpu.solve", times=1)
        db = obs.db(sup.build_route_db(*solve_inputs(K)))
        assert_route_db_equal(db, oracle_db(K))
        assert sup.consecutive_failures == 0
        assert sup.counters["decision.spf.solver_retries"] == 1
        assert sup.counters["decision.spf.solver_failures.runtime"] == 1
        obs.end(sup)

    both(script)


def test_exhausted_retries_serve_fallback_without_trip():
    def script(K, obs, inj):
        sup = make_supervisor(K, failure_threshold=10, max_attempts=2)
        inj.arm("solver.tpu.solve", times=None)
        db = obs.db(sup.build_route_db(*solve_inputs(K)))
        assert_route_db_equal(db, oracle_db(K))
        obs.state(sup)
        assert sup.counters["decision.spf.fallback_solves"] == 1
        obs.end(sup)

    both(script)


def test_deadline_overrun_counts_but_serves_result():
    def script(K, obs, inj):
        clock = FakeClock()
        watchdog = K.monitor.Watchdog()
        sup = make_supervisor(K, clock=clock, watchdog=watchdog,
                              solve_deadline_s=0.0, failure_threshold=10)

        def ticking():
            clock.advance(1.0)
            return clock.t

        sup._clock = ticking
        sup._probe_backoff._clock = ticking
        samples = []
        sup._log_sample_fn = samples.append
        db = obs.db(sup.build_route_db(*solve_inputs(K)))
        assert_route_db_equal(db, oracle_db(K))
        assert sup.counters["decision.spf.solver_failures.deadline"] == 1
        assert watchdog.slow_sections.get("decision") == 1
        assert sup.recorder.last_dump_reason == "deadline"
        obs.state(sup)
        obs.end(sup, samples)

    both(script)


# -- TestCircuitBreaker ------------------------------------------------------


def test_persistent_failure_trips_to_cpu_fallback_and_probe_recovers():
    def script(K, obs, inj):
        clock = FakeClock()
        samples = []
        sup = make_supervisor(
            K, clock=clock, samples=samples, failure_threshold=2,
            max_attempts=1, probe_interval_s=5.0, probe_successes_to_close=2,
        )
        inj.arm("solver.tpu.solve", times=None)
        for _ in range(3):
            obs.db(sup.build_route_db(*solve_inputs(K)))
            obs.state(sup)
        assert sup.health()["degraded"] is True
        assert sup.primary.counters[
            "decision.spf.warm_state_invalidations"] >= 1
        inj.disarm("solver.tpu.solve")
        for _ in range(2):
            clock.advance(5.0)
            assert sup.maybe_probe()
            obs.state(sup)
        assert sup.state == K.sup.CLOSED
        db4 = obs.db(sup.build_route_db(*solve_inputs(K)))
        assert_route_db_equal(db4, oracle_db(K))
        assert sup.counters["decision.spf.fallback_solves"] == 3
        obs.end(sup, samples)

    obs = both(script)
    assert obs.states == ["closed", "open", "open", "half_open", "closed"]
    assert "SOLVER_BREAKER_TRIPPED" in obs.final["samples"]
    assert "SOLVER_BREAKER_CLOSED" in obs.final["samples"]


def test_probe_failure_resets_streak_and_backs_off():
    def script(K, obs, inj):
        clock = FakeClock()
        sup = make_supervisor(
            K, clock=clock, failure_threshold=1, max_attempts=1,
            probe_interval_s=5.0, probe_successes_to_close=2,
        )
        inj.arm("solver.tpu.solve", times=None)
        obs.db(sup.build_route_db(*solve_inputs(K)))
        obs.state(sup)
        clock.advance(5.0)
        assert sup.maybe_probe()
        obs.state(sup)
        assert sup.probe_streak == 0
        clock.advance(1.0)
        assert not sup.probe_due()
        inj.disarm("solver.tpu.solve")
        clock.advance(60.0)
        assert sup.maybe_probe()
        obs.state(sup)
        inj.arm("solver.tpu.solve", times=None)
        clock.advance(5.0)
        assert sup.maybe_probe()
        obs.state(sup)
        assert sup.probe_streak == 0
        obs.end(sup)

    obs = both(script)
    assert obs.states == ["open", "open", "half_open", "open"]


def test_opportunistic_probe_from_solve_path():
    def script(K, obs, inj):
        clock = FakeClock()
        sup = make_supervisor(
            K, clock=clock, failure_threshold=1, max_attempts=1,
            probe_interval_s=5.0, probe_successes_to_close=1,
        )
        inj.arm("solver.tpu.solve", times=1)
        obs.db(sup.build_route_db(*solve_inputs(K)))
        obs.state(sup)
        clock.advance(5.0)
        db = obs.db(sup.build_route_db(*solve_inputs(K)))
        obs.state(sup)
        assert_route_db_equal(db, oracle_db(K))
        obs.end(sup)

    assert both(script).states == ["open", "closed"]


def test_static_routes_flow_through_both_backends():
    def script(K, obs, inj):
        sup = make_supervisor(K, failure_threshold=1, max_attempts=1)
        nh = K.T.NextHop(address="fe80::1", iface="lo")
        sup.push_static_routes_delta({100: {nh}}, set())
        delta = sup.process_static_route_updates()
        assert delta is not None and delta.mpls_routes_to_update
        assert sup.fallback.static_mpls_routes == (
            sup.primary.static_mpls_routes)
        obs.dbs.append(canon(delta.mpls_routes_to_update))
        obs.end(sup)

    both(script)


# -- TestPartialMeshDegradation ----------------------------------------------


def test_device_loss_degrades_mesh_instead_of_tripping():
    def script(K, obs, inj):
        samples = []
        sup = make_supervisor(K, mesh=(2, 2), samples=samples,
                              failure_threshold=1, max_attempts=1)
        inj.arm("solver.tpu.solve", times=1, exc=_device_lost)
        obs.db(sup.build_route_db(*solve_inputs(K)))
        obs.state(sup)
        assert dict(sup.primary.mesh.shape) == {"batch": 1, "graph": 2}
        obs.db(sup.build_route_db(*solve_inputs(K)))
        obs.end(sup, samples)

    obs = both(script)
    assert obs.final["counters"]["decision.spf.mesh_degradations"] == 1
    assert "SOLVER_MESH_DEGRADED" in obs.final["samples"]


def test_ladder_walks_to_cpu_when_no_mesh_remains():
    def script(K, obs, inj):
        sup = make_supervisor(K, mesh=(1, 2), failure_threshold=1,
                              max_attempts=1)
        inj.arm("solver.tpu.solve", times=None, exc=_device_lost)
        for _ in range(3):
            obs.db(sup.build_route_db(*solve_inputs(K)))
            obs.state(sup)
        assert sup.health()["solver_mesh"] == {"batch": 1, "graph": 1}
        obs.end(sup)

    assert both(script).states == ["closed", "open", "open"]


@pytest.mark.parametrize("mesh_degrade,exc", [
    (True, None), (False, _device_lost)
], ids=["non_device_loss_faults_skip_the_ladder", "knob_disables_the_ladder"])
def test_faults_that_skip_the_ladder(mesh_degrade, exc):
    def script(K, obs, inj):
        sup = make_supervisor(K, mesh=(2, 2), failure_threshold=1,
                              max_attempts=1, mesh_degrade=mesh_degrade)
        if exc is None:
            inj.arm("solver.tpu.solve", times=None)
        else:
            inj.arm("solver.tpu.solve", times=None, exc=exc)
        obs.db(sup.build_route_db(*solve_inputs(K)))
        obs.state(sup)
        assert "decision.spf.mesh_degradations" not in sup.counters
        assert dict(sup.primary.mesh.shape) == {"batch": 2, "graph": 2}
        obs.end(sup)

    assert both(script).states == ["open"]


# -- TestWarmStateAudit ------------------------------------------------------


def _corrupt(K):
    """Perturb one warm D entry, device buffer and host mirror (the port's
    in torch)."""

    def corrupt(solve):
        d = np.array(solve.d)
        d[0, d.shape[1] // 2] += 3
        solve._d_host = d
        solve._d_dev = K.to_device(d)

    return corrupt


def test_corruption_caught_within_n_events_and_healed():
    def script(K, obs, inj):
        samples = []
        sup = make_supervisor(K, samples=samples, audit_interval=2)
        me, states, ps = solve_inputs(K)
        obs.db(sup.build_route_db(me, states, ps))
        inj.arm("solver.tpu.warm_d", action=_corrupt(K), times=1)
        db_b = K.topology.build_adj_dbs(K.topology.grid_edges(3))["g1_1"]
        states["0"].update_adjacency_database(dataclasses.replace(
            db_b, adjacencies=[dataclasses.replace(a, metric=4)
                               for a in db_b.adjacencies]))
        db2 = obs.db(sup.build_route_db(me, states, ps))
        assert sup.counters["decision.spf.audit_forced_cold_solves"] == 1
        oracle = K.solver.SpfSolver(me).build_route_db(me, states, ps)
        assert_route_db_equal(db2, oracle)
        assert_route_db_equal(obs.db(sup.build_route_db(me, states, ps)),
                              oracle)
        obs.end(sup, samples)

    obs = both(script)
    assert obs.final["counters"]["decision.spf.audit_mismatches"] >= 1
    assert "WARM_STATE_AUDIT_MISMATCH" in obs.final["samples"]


def test_clean_audit_reports_nothing():
    def script(K, obs, inj):
        sup = make_supervisor(K, audit_interval=1)
        for _ in range(3):
            obs.db(sup.build_route_db(*solve_inputs(K)))
        assert sup.counters["decision.spf.audit_runs"] == 3
        assert "decision.spf.audit_mismatches" not in sup.counters
        obs.end(sup)

    both(script)


def test_audit_direct_on_solver():
    records = {}
    for K in (PORT, JAX):
        solver = K.primary("g0_0")
        me, states, ps = solve_inputs(K)
        solver.build_route_db(me, states, ps)
        assert solver.audit_warm_state() == []
        (_, solve), = solver._solves.values()
        _corrupt(K)(solve)
        records[K.name] = solver.audit_warm_state()
        solver.invalidate_warm_state()
        assert solver._solves == {}
        assert solver.counters["decision.spf.warm_state_invalidations"] == 1
    assert records["port"] == records["jax"]
    assert [(r["entries"], r["max_abs_delta"]) for r in records["port"]] == [
        (1, 3)]


def test_route_delta_shadow_audit_heals_a_diverged_delta_build():
    """verify_route_delta: every Nth delta build is checked against a
    full rebuild; a delta-built db that lost a route is replaced by it."""
    def script(K, obs, inj):
        samples = []
        sup = make_supervisor(K, samples=samples, audit_interval=1)
        me, states, ps = solve_inputs(K)
        full = obs.db(sup.build_route_db(me, states, ps))
        assert sup.verify_route_delta(full, me, states, ps) is None
        bad = K.solver.DecisionRouteDb()
        for prefix, entry in full.unicast_entries.items():
            bad.unicast_entries[prefix] = entry
        bad.unicast_entries.pop(next(iter(bad.unicast_entries)))
        fixed = sup.verify_route_delta(bad, me, states, ps)
        assert_route_db_equal(obs.db(fixed), full)
        obs.end(sup, samples)

    obs = both(script)
    assert obs.final["counters"]["decision.spf.delta_audit_mismatches"] == 1
    assert "ROUTE_DELTA_AUDIT_MISMATCH" in obs.final["samples"]


def test_a_faulted_warm_solve_is_solved_again_not_served_stale():
    """A fault inside a warm refresh leaves the port's area solve marked,
    so the next build solves again and serves the new topology. (The JAX
    package's refresh has patched its graph, so its next build finds the
    graph current and serves the D, and routes, from before the event.)"""
    results = {}
    for K in (PORT, JAX):
        solver = K.primary("g0_0")
        me, states, ps = solve_inputs(K)
        solver.build_route_db(me, states, ps)
        db_b = K.topology.build_adj_dbs(K.topology.grid_edges(3))["g0_1"]
        states["0"].update_adjacency_database(dataclasses.replace(
            db_b, adjacencies=[dataclasses.replace(a, metric=9)
                               for a in db_b.adjacencies]))
        with K.faults.injected() as inj:
            inj.arm("solver.tpu.solve", times=1)
            with pytest.raises(K.faults.FaultInjected):
                solver.build_route_db(me, states, ps)
        got = solver.build_route_db(me, states, ps)
        want = K.solver.SpfSolver(me).build_route_db(me, states, ps)
        results[K.name] = canon(got.unicast_entries) == canon(
            want.unicast_entries)
    assert results == {"port": True, "jax": False}


# -- TestDecisionIntegration -------------------------------------------------


@pytest.mark.parametrize("K", [PORT, JAX], ids=["port", "jax"])
def test_decision_device_backend_is_supervised_by_default(K):
    decision = K.decision.Decision(
        K.decision.DecisionConfig(my_node_name="a", **K.backend),
        K.messaging.RQueue(K.messaging.RWQueue()),
        K.messaging.ReplicateQueue(),
    )
    assert isinstance(decision.solver, K.sup.SolverSupervisor)
    health = decision.get_solver_health()
    assert health["degraded"] is False
    assert health["breaker_state"] == K.sup.CLOSED


@pytest.mark.parametrize("K", [PORT, JAX], ids=["port", "jax"])
def test_decision_cpu_backend_reports_unsupervised(K):
    decision = K.decision.Decision(
        K.decision.DecisionConfig(my_node_name="a", solver_backend="cpu"),
        K.messaging.RQueue(K.messaging.RWQueue()),
        K.messaging.ReplicateQueue(),
    )
    health = decision.get_solver_health()
    assert health["degraded"] is False
    assert health["breaker_state"] == "unsupervised"
    assert decision.get_solve_traces()["enabled"] is False
    assert decision.get_device_memory()["supervised"] is False


def test_supervisor_counters_reach_decision_counters():
    import asyncio

    def script(K, obs, inj):
        async def body():
            kv_q = K.messaging.RWQueue()
            decision = K.decision.Decision(
                K.decision.DecisionConfig(
                    my_node_name="g0_0", solver_failure_threshold=1,
                    solver_max_attempts=1, debounce_min=0.005,
                    debounce_max=0.02, **K.backend,
                ),
                K.messaging.RQueue(kv_q),
                K.messaging.ReplicateQueue(),
            )
            decision.start()
            try:
                inj.arm("solver.tpu.solve", times=1)
                kv_q.push(K.harness.lsdb_publication(
                    K.topology.build_adj_dbs(
                        K.topology.grid_edges(3)).values(), ANNOUNCERS))
                deadline = asyncio.get_event_loop().time() + 10.0
                while not decision.have_computed_routes:
                    assert asyncio.get_event_loop().time() < deadline
                    await asyncio.sleep(0.005)
            finally:
                task = decision._task
                decision.stop()
                if task is not None:
                    await asyncio.gather(task, return_exceptions=True)
            return decision

        decision = asyncio.new_event_loop().run_until_complete(body())
        assert decision.counters["decision.spf.fallback_active"] == 1
        assert decision.counters["decision.spf.solver_failures"] == 1
        assert decision.get_solver_health()["degraded"] is True
        obs.db(decision.route_db)
        obs.end(decision.solver)

    both(script)


# -- capacity admission under an override (both packages have a verdict) ----


def _sell_prediction(K, edges, me):
    """The bytes the sliced layout's admission predicts for `me`'s batch
    (dist + sell + patch): the same in both packages on the sliced
    layout."""
    import openr_tpu_torch.monitor.memledger as t_memledger
    from openr_tpu_torch.ops.graph import compile_edges

    g = compile_edges(edges)
    sources = 1 + len({b for a, b, _ in edges if a == me}
                      | {a for a, b, _ in edges if b == me})
    return t_memledger.MemLedger().predict_fit(
        g.n, "sell", n_sources=sources, graph=g)["predicted_bytes"], g


def test_capacity_override_refuses_the_all_pairs_matrix_alike():
    """DecisionConfig.solver_mem_capacity_bytes with no headroom kept: room
    for the sliced layout's solves (each admission counts the live
    generation and the next), not for the all-pairs matrix. Under
    compute_lfa_paths a delta-eligible event asks lfa_delta_ready, whose
    all-pairs admission refuses once: one SOLVER_CAPACITY_REFUSED sample,
    the event built in full; a route db from a node outside the batch is
    answered by the LinkState's Dijkstra (the port counts it in
    host_spf_calls). Samples, breaker states, counters and route dbs equal
    the reference's."""
    import asyncio

    edges = PORT.topology.grid_edges(6)
    p_sell, g = _sell_prediction(PORT, edges, "g0_0")
    mirror = 8 * g.n_pad * 4
    apsp = g.n_pad * g.n_pad * 9
    cap = 2 * p_sell + mirror  # the solves' admissions fit
    assert cap + apsp > cap + p_sell and p_sell + apsp > cap

    def script(K, obs, inj):
        samples = []

        async def body():
            kv_q = K.messaging.RWQueue()
            route_q = K.messaging.ReplicateQueue()
            reader = route_q.get_reader()
            decision = K.decision.Decision(
                K.decision.DecisionConfig(
                    my_node_name="g0_0", debounce_min=0.005,
                    debounce_max=0.02, compute_lfa_paths=True,
                    solver_mem_capacity_bytes=cap,
                    solver_mem_headroom_frac=0.0, **K.backend,
                ),
                K.messaging.RQueue(kv_q), route_q,
                log_sample_fn=samples.append,
            )
            decision.start()
            try:
                dbs = K.topology.build_adj_dbs(edges)
                kv_q.push(K.harness.lsdb_publication(dbs.values(),
                                                     ANNOUNCERS))
                await asyncio.wait_for(reader.get(), 10.0)
                kv_q.push(K.harness.lsdb_publication([
                    dataclasses.replace(dbs[a], adjacencies=[
                        dataclasses.replace(x, metric=4)
                        if x.other_node_name == b else x
                        for x in dbs[a].adjacencies])
                    for a, b in (("g0_1", "g0_2"), ("g0_2", "g0_1"))]))
                await asyncio.wait_for(reader.get(), 10.0)
                obs.db(decision.route_db)
                other = decision.solver.build_route_db(
                    "g5_5", decision.area_link_states,
                    decision.prefix_state)
                obs.db(other)
                obs.state(decision.solver)
                assert_route_db_equal(other, K.solver.SpfSolver(
                    "g5_5", compute_lfa_paths=True).build_route_db(
                    "g5_5", decision.area_link_states,
                    decision.prefix_state))
                if K is PORT:
                    assert decision.solver.primary.host_spf_calls >= 1
            finally:
                task = decision._task
                decision.stop()
                if task is not None:
                    await asyncio.gather(task, return_exceptions=True)
            return decision

        decision = asyncio.new_event_loop().run_until_complete(body())
        refused = [x for x in samples
                   if x.get("event") == "SOLVER_CAPACITY_REFUSED"]
        assert [(x.get("layout"), x.get("capacity_source"))
                for x in refused] == [("apsp", "override")]
        assert decision.counters["decision.mem.capacity_refusals"] == 1
        assert decision.counters["decision.spf.fallback_active"] == 0
        obs.end(decision.solver, samples)

    obs = both(script)
    assert obs.states == ["closed"]


def test_capacity_override_refuses_the_layout_then_serves_when_lifted():
    """A capacity below the sliced layout's prediction: the solve raises
    DeviceCapacityError before anything is registered, classified
    device_oom (one SOLVER_CAPACITY_REFUSED sample, a forensics dump with
    the ledger), the breaker trips and the oracle serves; with the
    override lifted the probe closes the breaker and the card serves the
    next event. Equal in both packages."""

    def script(K, obs, inj):
        import openr_tpu.monitor.memledger as j_memledger
        import openr_tpu_torch.monitor.memledger as t_memledger

        led = (t_memledger if K is PORT else j_memledger).get_ledger()
        clock = FakeClock()
        samples = []
        sup = make_supervisor(K, clock=clock, samples=samples,
                              failure_threshold=1, max_attempts=1,
                              probe_interval_s=5.0,
                              probe_successes_to_close=1)
        led.set_capacity_override(1024)
        me, states, ps = solve_inputs(K)
        obs.db(sup.build_route_db(me, states, ps))
        obs.state(sup)
        assert sup.counters["decision.spf.solver_failures.device_oom"] == 1
        assert sup.recorder.last_dump_reason in ("device_oom",
                                                 "breaker_trip")
        assert led.live_entries() == []
        led.set_capacity_override(None)
        clock.advance(5.0)
        db = obs.db(sup.build_route_db(me, states, ps))
        obs.state(sup)
        assert_route_db_equal(db, oracle_db(K))
        assert led.live_entries()
        obs.end(sup, samples)

    obs = both(script)
    assert obs.states == ["open", "closed"]
    assert obs.final["samples"].count("SOLVER_CAPACITY_REFUSED") == 1
