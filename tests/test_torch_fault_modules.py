"""The fault domain's modules on the port against the JAX package's, on the
CPU: the fault injector (testing/faults.py), the flight recorder
(solver/flight_recorder.py) and the memory ledger (monitor/memledger.py).

The cases of tests/test_faults.py, tests/test_flight_recorder.py and
tests/test_memledger.py that touch only the module run on both packages'
copies (parametrized by package) and, where a case yields data, the two
copies' data must be equal. The flight recorder's supervisor-level
traces and dumps (the supervisor's own fault and fallback records; the
primary's per-solve traces wait for the recorder wiring) are compared
across the two packages' supervisors. The port's device-specific
changes get cases of their own: `device_digest` reads torch and never
raises, `PhaseClock.seam` synchronizes only CUDA tensors, and the
ledger's `reconcile` reports `unavailable` without a card.
"""

import json

import numpy as np
import pytest
import torch

import openr_tpu.monitor.memledger as j_memledger
import openr_tpu.solver.flight_recorder as j_recorder
import openr_tpu.testing.faults as j_faults
import openr_tpu_torch.monitor.memledger as t_memledger
import openr_tpu_torch.solver.flight_recorder as t_recorder
import openr_tpu_torch.testing.faults as t_faults
from test_torch_supervisor import (
    JAX,
    PORT,
    make_supervisor,
    solve_inputs,
)

FAULTS = pytest.mark.parametrize("F", [t_faults, j_faults],
                                 ids=["port", "jax"])
REC = pytest.mark.parametrize("R", [t_recorder, j_recorder],
                              ids=["port", "jax"])
LEDGER = pytest.mark.parametrize("M", [t_memledger, j_memledger],
                                 ids=["port", "jax"])


# -- faults: TestSchedules ---------------------------------------------------


@FAULTS
def test_uninstalled_fault_point_is_a_noop(F):
    F.uninstall()
    F.fault_point("anything.at.all")
    assert F.installed() is None


@FAULTS
def test_times_budget_is_exact(F):
    with F.injected() as inj:
        inj.arm("p", times=2)
        for _ in range(2):
            with pytest.raises(F.FaultInjected):
                F.fault_point("p")
        F.fault_point("p")
        assert (inj.fired("p"), inj.hits("p")) == (2, 3)


@FAULTS
def test_after_skips_initial_hits(F):
    with F.injected() as inj:
        inj.arm("p", times=1, after=2)
        F.fault_point("p")
        F.fault_point("p")
        with pytest.raises(F.FaultInjected):
            F.fault_point("p")


@FAULTS
def test_unlimited_times(F):
    with F.injected() as inj:
        inj.arm("p", times=None)
        for _ in range(5):
            with pytest.raises(F.FaultInjected):
                F.fault_point("p")


def _pattern(F, seed):
    out = []
    with F.injected(F.FaultInjector(seed=seed)) as inj:
        inj.arm("p", times=None, probability=0.5)
        for _ in range(32):
            try:
                F.fault_point("p")
                out.append(0)
            except F.FaultInjected:
                out.append(1)
    return out


def test_probability_is_seed_deterministic_and_equal_across_packages():
    a = _pattern(t_faults, 7)
    assert a == _pattern(t_faults, 7)
    assert 0 < sum(a) < 32
    assert _pattern(t_faults, 8) != a
    # one fault script replays the same pattern in both packages
    assert a == _pattern(j_faults, 7)
    assert _pattern(t_faults, 8) == _pattern(j_faults, 8)


@FAULTS
def test_action_mutates_instead_of_raising(F):
    box = []
    with F.injected() as inj:
        inj.arm("p", action=box.append, times=1)
        F.fault_point("p", "ctx-object")
        F.fault_point("p", "again")
    assert box == ["ctx-object"]


@FAULTS
def test_when_predicate_targets_one_instance(F):
    target, other = object(), object()
    with F.injected() as inj:
        inj.arm("p", times=1, when=lambda ctx: ctx is target)
        F.fault_point("p", other)
        with pytest.raises(F.FaultInjected):
            F.fault_point("p", target)
        assert inj.fired("p") == 1


@FAULTS
def test_custom_exception_factory(F):
    class DeviceGone(RuntimeError):
        def __init__(self, point):
            super().__init__(f"DEVICE_LOST at {point}")

    with F.injected() as inj:
        inj.arm("p", exc=DeviceGone)
        with pytest.raises(DeviceGone):
            F.fault_point("p")


@FAULTS
def test_injected_context_uninstalls_on_error(F):
    with pytest.raises(F.FaultInjected):
        with F.injected() as inj:
            inj.arm("p")
            F.fault_point("p")
    assert F.installed() is None


@FAULTS
def test_install_returns_injector_and_disarm(F):
    inj = F.install(F.FaultInjector())
    try:
        inj.arm("p")
        inj.disarm("p")
        F.fault_point("p")
        assert inj.spec("p") is None
    finally:
        F.uninstall()


def test_packages_keep_separate_injectors():
    """A script arms each package through its own injector: arming one
    leaves the other's seams quiet."""
    with t_faults.injected() as inj:
        inj.arm("p", times=None)
        j_faults.fault_point("p")
        with pytest.raises(t_faults.FaultInjected):
            t_faults.fault_point("p")


# -- faults: the named seams of the port fire --------------------------------


def test_solver_tpu_solve_seam_fires_in_the_port():
    solver = PORT.primary("g0_0")
    with t_faults.injected() as inj:
        inj.arm("solver.tpu.solve", times=1)
        with pytest.raises(t_faults.FaultInjected):
            solver.build_route_db(*solve_inputs(PORT))
        assert inj.hits("solver.tpu.solve") == 1
    assert solver.build_route_db(*solve_inputs(PORT)) is not None


@pytest.mark.parametrize("point", ["ops.spf.batched_spf",
                                   "ops.spf.batched_spf_vw"])
def test_ops_spf_seams_fire_in_the_port(point):
    from openr_tpu_torch.ops import spf
    from openr_tpu_torch.ops.graph import compile_edges
    from openr_tpu_torch.topology import grid_edges

    graph = compile_edges(grid_edges(3))
    rows = np.arange(2, dtype=np.int32)
    with t_faults.injected() as inj:
        inj.arm(point, times=1)
        with pytest.raises(t_faults.FaultInjected):
            if point.endswith("_vw"):
                spf.batched_spf_vw(graph, rows, graph.w[None, :],
                                   device="cpu")
            else:
                spf.batched_spf(graph, rows, device="cpu")
        # disarmed by its budget: the next dispatch solves
        d = spf.batched_spf(graph, rows, device="cpu")
        assert inj.hits(point) == (2 if point == "ops.spf.batched_spf"
                                   else 1)
    assert tuple(d.shape) == (2, graph.n_pad)


# -- flight recorder: ring semantics -----------------------------------------


def _trace(R, rec, area="0"):
    return R.SolveTrace(
        seq=rec.next_seq(), ts=0.0, area=area, node="n", event="solve",
        layout="sell", warm=False, solve_ms=1.0, rounds=1,
        invalidation_rounds=None, halo_exchanges=None, h2d_bytes=0,
        d2h_bytes=0, halo_bytes=0, delta_columns=None,
        compile_cache_misses=0, breaker_state="closed", sampled=False,
    )


@REC
def test_eviction_accounting_invariant(R):
    rec = R.FlightRecorder(ring_size=4, sample_every=0, node="n")
    for _ in range(11):
        rec.record(_trace(R, rec, area="0"))
    for _ in range(3):
        rec.record(_trace(R, rec, area="1"))
    stats = rec.stats()
    assert (stats["recorded"], stats["retained"], stats["evicted"]) == (
        14, 7, 7)
    seqs = [t["seq"] for t in rec.snapshot(area="0")]
    assert seqs == [8, 9, 10, 11]


@REC
def test_snapshot_last_n_is_global_order(R):
    rec = R.FlightRecorder(ring_size=8, sample_every=0)
    for area in ("0", "1", "0"):
        rec.record(_trace(R, rec, area=area))
    assert [t["seq"] for t in rec.snapshot(last_n=2)] == [2, 3]


@REC
def test_dump_index_is_bounded(R):
    rec = R.FlightRecorder(max_dumps=2)
    ids = [rec.dump(f"r{i}")["id"] for i in range(5)]
    assert [d["id"] for d in rec.dumps] == ids[-2:]
    assert rec.forensics_stats()["dumps"] == 5


@REC
def test_sample_every_zero_disables_sampling_not_recording(R):
    rec = R.FlightRecorder(sample_every=0)
    clock = rec.begin()
    assert clock is R.NULL_CLOCK
    clock.seam("relax")
    assert clock.phases == {}


def test_phase_clock_synchronizes_only_cuda_tensors(monkeypatch):
    """The port's seam: only a CUDA tensor's card is synchronized; a CPU
    tensor's work is done when its op returns, and it counts one barrier
    for its device (as the JAX package counts block_until_ready on a CPU
    array); other values are skipped; the phase is timed all the same."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    clock = t_recorder.PhaseClock(True)
    clock.seam("relax", torch.arange(8) * 2, object(), np.arange(3))
    assert clock.barriers == 1
    assert synced == []
    assert clock.phases["relax"] >= 0.0
    clock.seam("relax")
    assert clock.barriers == 1
    assert set(clock.phases) == {"relax"}


def test_device_digest_reads_torch_and_never_raises(monkeypatch):
    from openr_tpu_torch import parallel

    mesh = parallel.make_mesh([torch.device("cpu")] * 2, (2, 1))
    digest = t_recorder.device_digest(mesh)
    assert digest["mesh_shape"] == {"batch": 2, "graph": 1}
    if not torch.cuda.is_available():
        assert (digest["devices"], digest["platform"],
                digest["device_kind"]) == (0, "cpu", None)

    def lost():
        raise RuntimeError("CUDA driver error: device lost")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lost)
    digest = t_recorder.device_digest(None)
    assert digest["mesh_shape"] is None
    assert "device lost" in digest["error"]
    json.dumps(digest)


# -- flight recorder: the supervisor's traces and dumps ----------------------


def _flap(K, link_state, metric):
    """test_flight_recorder.py's flap: a far-side link metric moves, so
    the next build solves again (warm)."""
    import dataclasses

    db = K.topology.build_adj_dbs(K.topology.grid_edges(3))["g2_1"]
    link_state.update_adjacency_database(dataclasses.replace(
        db, adjacencies=[
            dataclasses.replace(a, metric=metric)
            if a.other_node_name == "g2_2" else a
            for a in db.adjacencies]))


def _supervisor_traces(K, tmp_path):
    """test_breaker_trip_dump_reconstructs_timeline's fault script: a
    clean solve, then a solver.tpu.solve streak that trips the breaker."""
    samples = []
    sup = make_supervisor(K, samples=samples, failure_threshold=2,
                          max_attempts=1, forensics_dir=str(tmp_path),
                          trace_sample_every=1)
    me, states, ps = solve_inputs(K)
    sup.build_route_db(me, states, ps)
    with K.faults.injected() as inj:
        inj.arm("solver.tpu.solve", times=None)
        for metric in (50, 51):
            _flap(K, states["0"], metric)
            sup.build_route_db(me, states, ps)
    sup.build_route_db(me, states, ps)  # served while open
    trip = next(s for s in samples
                if s.get("event") == "SOLVER_BREAKER_TRIPPED")
    fid = trip.get("forensics_id")
    dump = next(d for d in sup.recorder.dumps if d["id"] == fid)
    own = ("fault", "fallback_solve", "device_call")
    keep = ("event", "layout", "fault_kind", "breaker_state", "detail")
    timeline = [
        {k: t[k] for k in keep}
        for t in sup.recorder.snapshot() if t["event"] in own
    ]
    in_dump = [
        {k: t[k] for k in keep}
        for ts in dump["traces"].values() for t in ts if t["event"] in own
    ]
    on_disk = json.loads((tmp_path / f"{fid}.json").read_text())
    return {
        "reason": dump["reason"],
        "timeline": timeline,
        "in_dump": in_dump,
        "config": dump["solver_config"]["failure_threshold"],
        "counter_keys": "decision.spf.solver_failures" in dump["counters"],
        "digest_keys": "mesh_shape" in dump["mesh_digest"],
        "on_disk": (on_disk["reason"], on_disk["id"] == fid),
        "forensics": {k: v for k, v in sup.health()["forensics"].items()
                      if k not in ("last_id", "dir")},
        "samples": [s.get("event") for s in samples],
    }


def test_breaker_trip_dump_holds_the_supervisor_timeline(tmp_path):
    port = _supervisor_traces(PORT, tmp_path / "port")
    ref = _supervisor_traces(JAX, tmp_path / "jax")
    assert port == ref
    assert [t["event"] for t in port["timeline"]] == [
        "fault", "fallback_solve", "fault", "fallback_solve",
        "fallback_solve"]
    assert all(t["fault_kind"] == "runtime"
               for t in port["in_dump"] if t["event"] == "fault")
    assert port["reason"] == "breaker_trip"


def test_audit_mismatch_dump_references_id():
    seen = {}
    for K in (PORT, JAX):
        samples = []
        sup = make_supervisor(K, samples=samples, audit_interval=1)

        def corrupt(solve):
            solve.d
            solve._d_host[0, 1] += 7

        with K.faults.injected(K.faults.FaultInjector()) as inj:
            inj.arm("solver.tpu.warm_d", times=1, action=corrupt)
            sup.build_route_db(*solve_inputs(K))
        mism = next(s for s in samples
                    if s.get("event") == "WARM_STATE_AUDIT_MISMATCH")
        assert mism.get("forensics_id") == sup.recorder.last_dump_id
        seen[K.name] = (sup.recorder.last_dump_reason,
                        [s.get("event") for s in samples])
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == "audit_mismatch"


# -- memory ledger -----------------------------------------------------------


def _totals(led):
    return led.snapshot()["totals"]


def assert_exact(led):
    snap = led.snapshot()
    t = snap["totals"]
    assert snap["exact"], t
    assert t["registered_bytes"] == t["live_bytes"] + t["freed_bytes"], t
    assert sum(e["nbytes"] for e in snap["entries"]) == t["live_bytes"]


@LEDGER
def test_register_update_release_cycle(M):
    led = M.MemLedger()
    a = np.zeros((8, 16), np.int32)
    h = led.register("0/a", "dist", layout="sell", arrays=(a,))
    assert_exact(led)
    b = np.zeros((16, 16), np.int32)
    led.update(h, arrays=(b,))
    led.update(h, arrays=(a,))
    assert_exact(led)
    t = _totals(led)
    assert (t["live_bytes"], t["freed_bytes"], t["peak_bytes"]) == (
        a.nbytes, b.nbytes - a.nbytes, b.nbytes)
    assert led.release(h) is True
    assert led.release(h) is False and led.release(None) is False
    assert_exact(led)
    assert _totals(led)["live_bytes"] == 0


def test_torch_tensors_register_by_their_bytes():
    led = t_memledger.MemLedger()
    d = torch.zeros((8, 16), dtype=torch.int32)
    ov = torch.zeros(16, dtype=torch.bool)
    h = led.register("0/a", "dist", layout="sell", arrays=(d, ov, None))
    assert _totals(led)["live_bytes"] == 8 * 16 * 4 + 16
    led.release(h)
    assert_exact(led)


@LEDGER
def test_structure_and_area_folds(M):
    led = M.MemLedger()
    led.register("0/a", "dist", layout="sell",
                 arrays=(np.zeros(64, np.int32),))
    led.register("0/a", "sell", layout="sell", nbytes=100)
    led.register("0/b", "apsp", layout="apsp", nbytes=900)
    led.register("0/b", "weird", layout="host", nbytes=7)
    snap = led.snapshot()
    assert (snap["structures"]["dist"], snap["structures"]["other"]) == (
        256, 7)
    assert (snap["areas"]["0/a"], snap["areas"]["0/b"]) == (356, 907)
    sub = led.snapshot(area="0/b")
    assert {e["structure"] for e in sub["entries"]} == {"apsp", "weird"}
    # every snapshot reconciles: without a card the port's counts its
    # unreconcilable check in drift_events, so only that total moves
    drift = ("drift_events",)
    assert {k: v for k, v in sub["totals"].items() if k not in drift} == {
        k: v for k, v in snap["totals"].items() if k not in drift}


@LEDGER
def test_release_area(M):
    led = M.MemLedger()
    led.register("0/a", "dist", layout="sell", nbytes=10)
    led.register("0/a", "sell", layout="sell", nbytes=20)
    led.register("0/b", "dist", layout="sell", nbytes=30)
    assert led.release_area("0/a") == 2
    assert_exact(led)
    assert (_totals(led)["live_bytes"], _totals(led)["freed_bytes"]) == (
        30, 30)


def test_capacity_override_refusal_and_verdicts_equal_the_reference():
    verdicts = []
    for M in (t_memledger, j_memledger):
        led = M.MemLedger(capacity_bytes=1 << 20)
        assert led.capacity() == {"capacity_bytes": 1 << 20,
                                  "source": "override"}
        big = led.predict_fit(4096, "apsp")
        assert big["fits"] is False
        led.record_refusal(big)
        assert led.snapshot()["totals"]["capacity_refusals"] == 1
        assert led.snapshot()["last_refusal"]["layout"] == "apsp"
        small = led.predict_fit(16, "apsp")
        assert small["fits"] is True
        verdicts.append((big, small, led.predict_fit(1000, "bf", n_sources=9)))
    assert verdicts[0][:2] == verdicts[1][:2]
    # the edge-list layout: the port's model adds the csr it keeps
    # resident beside the JAX package's planes, int32 [n_pad + 1]
    port_bf, ref_bf = verdicts[0][2], verdicts[1][2]
    csr = (port_bf["n_pad"] + 1) * 4
    assert port_bf["components"]["bf"] == ref_bf["components"]["bf"] + csr
    assert port_bf["predicted_bytes"] == ref_bf["predicted_bytes"] + csr
    assert port_bf["headroom_bytes"] == ref_bf["headroom_bytes"] - csr
    assert {k: v for k, v in port_bf.items() if k not in (
        "components", "predicted_bytes", "headroom_bytes")} == {
        k: v for k, v in ref_bf.items() if k not in (
            "components", "predicted_bytes", "headroom_bytes")}


def test_no_card_means_no_capacity_source_and_an_unavailable_reconcile():
    """Without a card the port has no capacity source (fits is None: the
    callers' static caps gate) and reconcile cannot be made: its source
    reads unavailable and drift_events counts the check."""
    if torch.cuda.is_available():
        pytest.skip("needs a host with no CUDA card")
    led = t_memledger.MemLedger()
    assert led.capacity() == {"capacity_bytes": None, "source": "fallback"}
    assert led.predict_fit(64, "bf")["fits"] is None
    led.register("0/a", "dist", layout="sell", nbytes=64)
    rec = led.reconcile()
    assert rec == {"source": "unavailable", "backend_bytes": None,
                   "backend_peak_bytes": None, "ledger_bytes": 64,
                   "drift_bytes": None}
    led.reconcile()
    assert led.drift_events == 2


@LEDGER
def test_retain_pins_entry_live_and_stays_exact(M):
    F = t_faults if M is t_memledger else j_faults
    led = M.MemLedger()
    h = led.register("0/a", "dist", layout="sell", nbytes=512)
    led.register("0/a", "sell", layout="sell", nbytes=128)
    with F.injected(F.FaultInjector(seed=1)) as inj:
        inj.arm("solver.mem.retain", times=1,
                action=lambda ctx: setattr(ctx, "retain", True))
        assert led.release(h) is False
        assert inj.fired("solver.mem.retain") == 1
    assert_exact(led)
    t = _totals(led)
    assert (t["retained"], t["live_bytes"], t["freed_bytes"]) == (
        1, 640, 0)
    assert led.release(h) is False


@LEDGER
def test_unarmed_release_is_a_real_free(M):
    F = t_faults if M is t_memledger else j_faults
    led = M.MemLedger()
    h = led.register("0/a", "dist", layout="sell", nbytes=64)
    with F.injected(F.FaultInjector(seed=1)):
        assert led.release(h) is True
    t = _totals(led)
    assert t["retained"] == 0 and t["live_bytes"] == 0


def test_supervisor_health_reads_the_port_ledger():
    sup = make_supervisor(PORT)
    mem = sup.health()["device_memory"]
    assert mem["capacity"]["source"] in ("fallback", "memory_stats")
    assert mem["exact"] is True
    assert isinstance(mem["structures"], dict)
