"""The flight recorder wired into the port's solver, against the JAX
package's, on the CPU.

The solver-driving cases of tests/test_flight_recorder.py (the recorder's
module-only cases are in tests/test_torch_fault_modules.py; the ctrl
server, breeze and profiler cases have no port yet, ROADMAP queue 1 item
12), each driven through both packages with the same input where it
yields data: every solve records one `SolveTrace`, the sampled ones with
the phase split prepare / h2d / relax (/ delta_extract) and the mirror's
d2h; the traces' fields equal the reference's on the sliced, edge-list and
tiled layouts but for their times, the transfer bytes (each layout's own
buffers, tests/test_torch_solver.py) and the compile-cache misses (the
port's kernels are built ahead by nvcc; the JAX package compiles at first
use). The probe-effect contract: an unsampled solve takes no barrier, and
a seam takes one barrier per device, however many ranks' tiles it is
given. A solve that raises records nothing; its re-solve records the
trace and the ledger's `dist`.
"""

import dataclasses
import statistics
import time

import pytest
import torch

import openr_tpu_torch.solver.cuda as t_cuda
import openr_tpu_torch.solver.flight_recorder as t_recorder
from openr_tpu_torch.ops.spf import Sharded
from test_torch_decision import fresh_ledgers  # noqa: F401 (autouse)
from test_torch_memory import release_memory_around_each_test  # noqa: F401
from test_torch_supervisor import (
    ANNOUNCERS,
    JAX,
    PORT,
    build_ls,
    make_ps,
    make_supervisor,
    solve_inputs,
)

EDGES = PORT.topology.grid_edges(3)
LINE = [("a", "b", 1), ("b", "c", 1), ("c", "d", 1)]
# trace fields that are not compared across packages: clocks, the
# transfer bytes (each layout's own buffers) and the compile-cache
# misses (nvcc builds ahead; jit compiles at first use)
_UNSHARED_FIELDS = ("ts", "solve_ms", "phases", "h2d_bytes", "d2h_bytes",
                    "compile_cache_misses")


def sup_for(K, me="g0_0", mesh=None, **cfg_kw):
    cfg_kw.setdefault("trace_sample_every", 1)
    return make_supervisor(K, me=me, mesh=mesh, **cfg_kw)


def flap(K, ls, metric, edges=EDGES, a="g2_1", b="g2_2"):
    """A weight event on one link away from g0_0, both directions."""
    dbs = K.topology.build_adj_dbs(edges)
    for x, y in ((a, b), (b, a)):
        ls.update_adjacency_database(dataclasses.replace(
            dbs[x], adjacencies=[
                dataclasses.replace(adj, metric=metric)
                if adj.other_node_name == y else adj
                for adj in dbs[x].adjacencies]))


def shared(trace):
    out = {k: v for k, v in trace.items() if k not in _UNSHARED_FIELDS}
    out["phase_names"] = sorted(trace["phases"])
    return out


def run_both(script):
    """script(K) -> traces, for the port and the JAX package."""
    return script(PORT), script(JAX)


# -- the ring ----------------------------------------------------------------


def test_solver_ring_records_every_solve():
    def script(K):
        sup = sup_for(K, trace_ring_size=2)
        me, states, ps = solve_inputs(K)
        sup.build_route_db(me, states, ps)
        for i in range(4):
            flap(K, states["0"], 20 + i)
            sup.build_route_db(me, states, ps)
        stats = sup.recorder.stats()
        assert (stats["recorded"], stats["retained"], stats["evicted"]) == (
            5, 2, 3)
        assert sup.counters["decision.spf.traces_recorded"] == 5
        assert sup.counters["decision.spf.traces_evicted"] == 3
        assert sup.counters["decision.spf.traces_sampled"] == 5
        return [shared(t) for t in sup.recorder.snapshot()]

    got, want = run_both(script)
    assert got == want


# -- sampled phase timing ------------------------------------------------------


def test_sampled_solve_records_phase_split():
    def script(K):
        sup = sup_for(K)
        sup.build_route_db(*solve_inputs(K))
        (trace,) = sup.recorder.snapshot()
        assert trace["sampled"] is True and trace["event"] == "solve"
        assert trace["layout"] == "sell" and trace["warm"] is False
        assert {"prepare", "h2d", "relax", "d2h"} <= set(trace["phases"])
        assert all(v >= 0.0 for v in trace["phases"].values())
        assert trace["phases"]["relax"] > 0.0
        return shared(trace), {
            k: h.count for k, h in sup.histograms.items()
            if k.startswith("decision.spf.phase.")}

    got, want = run_both(script)
    assert got == want
    assert got[1]["decision.spf.phase.relax_ms"] == 1
    assert got[1]["decision.spf.phase.d2h_ms"] == 1


def test_warm_solve_phases_include_delta_extract():
    def script(K):
        sup = K.sup.SolverSupervisor(
            K.primary("a"), K.solver.SpfSolver("a"),
            K.sup.SupervisorConfig(trace_sample_every=1))
        states = {"0": build_ls(K, LINE)}
        ps = K.lsdb.PrefixState()
        ps.update_prefix_database(K.T.PrefixDatabase(
            "d", [K.T.PrefixEntry(K.T.IpPrefix("10.9.0.0/16"))], area="0"))
        sup.build_route_db("a", states, ps)
        flap(K, states["0"], 5, edges=LINE, a="c", b="d")
        sup.build_route_db("a", states, ps)
        warm = [t for t in sup.recorder.snapshot() if t["warm"]]
        assert warm
        trace = warm[-1]
        assert trace["invalidation_rounds"] is not None
        assert trace["delta_columns"] is not None
        assert "delta_extract" in trace["phases"]
        assert sup.histograms["decision.spf.phase.delta_extract_ms"].count == 1
        return [shared(t) for t in sup.recorder.snapshot()]

    got, want = run_both(script)
    assert got == want


def test_unsampled_solves_take_no_barriers():
    """The probe-effect contract: the solves the sampler skips run with
    the shared NULL_CLOCK, take no barrier and keep no phase split; the
    sampled ones take their barriers at the seams."""
    sup = sup_for(PORT, trace_sample_every=3)
    me, states, ps = solve_inputs(PORT)
    sup.build_route_db(me, states, ps)  # solve 1: sampled
    first = sup.recorder.barrier_calls
    assert first > 0
    for i in range(2):  # solves 2, 3: unsampled
        flap(PORT, states["0"], 40 + i)
        sup.build_route_db(me, states, ps)
    traces = sup.recorder.snapshot()
    assert [t["sampled"] for t in traces] == [True, False, False]
    for t in traces[1:]:
        assert t["phases"] == {}
    assert sup.recorder.barrier_calls == first
    assert t_recorder.NULL_CLOCK.barriers == 0
    assert t_recorder.NULL_CLOCK.phases == {}
    flap(PORT, states["0"], 77)
    sup.build_route_db(me, states, ps)  # solve 4: sampled again
    assert sup.recorder.snapshot()[-1]["sampled"] is True
    assert sup.recorder.barrier_calls > first


def test_probe_effect_bound_sampled_vs_unsampled():
    sampled = sup_for(PORT, trace_sample_every=1)
    unsampled = sup_for(PORT, trace_sample_every=0)
    me, states_a, ps = solve_inputs(PORT)
    _, states_b, _ = solve_inputs(PORT)
    sampled.build_route_db(me, states_a, ps)
    unsampled.build_route_db(me, states_b, ps)
    sampled_ms, unsampled_ms = [], []
    for i in range(4):
        flap(PORT, states_a["0"], 21 + i)
        flap(PORT, states_b["0"], 21 + i)
        sampled.build_route_db(me, states_a, ps)
        unsampled.build_route_db(me, states_b, ps)
        sampled_ms.append(sampled.recorder.snapshot()[-1]["solve_ms"])
        unsampled_ms.append(unsampled.recorder.snapshot()[-1]["solve_ms"])
    assert all(t["sampled"] for t in sampled.recorder.snapshot())
    assert not any(t["sampled"] for t in unsampled.recorder.snapshot())
    assert unsampled.recorder.barrier_calls == 0
    med_s = statistics.median(sampled_ms)
    med_u = statistics.median(unsampled_ms)
    assert med_s <= med_u * 20.0 + 100.0, (sampled_ms, unsampled_ms)


class _CardTensor:
    """Stands for a tensor on a card: what the seam reads of one."""

    is_cuda = True

    def __init__(self, index):
        self.device = torch.device("cuda", index)


def test_phase_clock_barriers_once_per_device(monkeypatch):
    """A seam synchronizes each card among its values once (tensors,
    Sharded blocks, lists, tuples and dicts of them), and counts one
    barrier per device, the CPU's included; other values are skipped."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    clock = t_recorder.PhaseClock(True)
    cpu = Sharded([[torch.zeros(2, 2), torch.zeros(2, 2)]])
    clock.seam("relax", cpu, [torch.ones(3)], {"x": (torch.ones(1),)},
               object(), 7)
    assert clock.barriers == 1 and synced == []
    clock.seam("h2d", [[_CardTensor(0), _CardTensor(0)], [_CardTensor(1)]],
               {"a": _CardTensor(1)})
    assert clock.barriers == 3
    assert sorted(d.index for d in synced) == [0, 1]
    assert set(clock.phases) == {"relax", "h2d"}
    t_recorder.NULL_CLOCK.seam("relax", _CardTensor(0))
    assert t_recorder.NULL_CLOCK.barriers == 0 and len(synced) == 2


# -- layouts -------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["sell", "bf", "tile2d"])
def test_traces_equal_the_reference_on_each_layout(layout, monkeypatch):
    """A cold solve and three weight events on each layout: the traces'
    shared fields (layout, warm, rounds, invalidation rounds, delta
    columns, halo exchanges and bytes, breaker state, sampling, the phase
    names) equal the JAX package's; on the tiled (2, 2) mesh of CPU ranks
    every seam takes one barrier, as many ranks as it waits for."""
    import openr_tpu.solver.tpu as j_tpu

    mesh = (2, 2) if layout == "tile2d" else None
    edges = PORT.topology.grid_edges(4)

    def script(K):
        if layout == "bf":
            mod = t_cuda if K is PORT else j_tpu
            real = mod.compile_graph

            def no_sell(ls):
                g = real(ls)
                g.sell = None
                return g

            monkeypatch.setattr(mod, "compile_graph", no_sell)
        sup = sup_for(K, mesh=mesh)
        states = {"0": build_ls(K, edges)}
        ps = make_ps(K)
        sup.build_route_db("g0_0", states, ps)
        barriers = [sup.recorder.barrier_calls]
        for i, (a, b) in enumerate((("g2_1", "g2_2"), ("g3_1", "g3_2"),
                                    ("g1_3", "g2_3"))):
            flap(K, states["0"], 3 + i, edges=edges, a=a, b=b)
            sup.build_route_db("g0_0", states, ps)
            barriers.append(sup.recorder.barrier_calls)
        traces = sup.recorder.snapshot()
        assert {t["layout"] for t in traces} == {layout}
        return [shared(t) for t in traces], barriers

    (got, barriers), (want, _) = run_both(script)
    assert got == want
    assert any(t["warm"] for t in got)
    if layout == "tile2d":
        assert all(t["halo_exchanges"] is not None for t in got)
        # the cold solve: h2d and relax, one barrier each (prepare waits
        # for nothing); each later solve adds its seams' barriers, never
        # one per round or per rank
        assert barriers[0] == 2
        steps = [b - a for a, b in zip(barriers, barriers[1:])]
        assert all(s <= 3 for s in steps), steps


# -- a solve that raises -------------------------------------------------------


def test_a_raised_solve_records_nothing_and_its_resolve_records_all(
    fresh_ledgers, monkeypatch
):
    """The port solves again after a solve that raised (ROADMAP queue 3):
    the raised solve leaves no trace and no new `dist`; the next build's
    re-solve records one trace and registers its D, and the ledger stays
    exact."""
    port, _ = fresh_ledgers
    sup = sup_for(PORT)
    solver = sup.primary
    me, states, ps = solve_inputs(PORT)
    solver.build_route_db(me, states, ps)
    (_, solve), = solver._solves.values()
    dist0 = solve._mem["dist"]
    recorded = sup.recorder.recorded
    real = t_cuda._sell_solver_warm

    def boom(*a, **kw):
        raise RuntimeError("injected warm solve failure")

    monkeypatch.setattr(t_cuda, "_sell_solver_warm", boom)
    flap(PORT, states["0"], 9)
    with pytest.raises(RuntimeError, match="injected"):
        solver.build_route_db(me, states, ps)
    assert sup.recorder.recorded == recorded
    assert solve._mem["dist"] == dist0
    monkeypatch.setattr(t_cuda, "_sell_solver_warm", real)
    solver.build_route_db(me, states, ps)
    assert sup.recorder.recorded == recorded + 1
    assert solve._mem["dist"] != dist0
    entry = next(e for e in port.live_entries() if e.structure == "dist")
    assert entry.nbytes == solve._d_dev.nbytes
    assert port.check()
    want = PORT.solver.SpfSolver(me).build_route_db(me, states, ps)
    got = solver.build_route_db(me, states, ps)
    assert got.unicast_entries == want.unicast_entries


# -- forensics -----------------------------------------------------------------


def test_breaker_trip_dump_holds_the_solves_phase_split(tmp_path):
    """A clean sampled solve, then a fault streak trips the breaker: the
    dump referenced from SOLVER_BREAKER_TRIPPED holds the clean solve's
    trace with its phase split beside the classified faults, and its
    device_memory section is the port's ledger."""
    samples = []
    sup = sup_for(PORT, samples=samples, failure_threshold=2,
                  max_attempts=1, forensics_dir=str(tmp_path))
    me, states, ps = solve_inputs(PORT)
    sup.build_route_db(me, states, ps)
    with PORT.faults.injected() as inj:
        inj.arm("solver.tpu.solve", times=None)
        flap(PORT, states["0"], 50)
        sup.build_route_db(me, states, ps)
        flap(PORT, states["0"], 51)
        sup.build_route_db(me, states, ps)
    assert sup.state != "closed"
    trip = next(s for s in samples
                if s.get("event") == "SOLVER_BREAKER_TRIPPED")
    dump = next(d for d in sup.recorder.dumps
                if d["id"] == trip.get("forensics_id"))
    events = [t for ts in dump["traces"].values() for t in ts]
    clean = [t for t in events if t["event"] == "solve"]
    faults = [t for t in events if t["event"] == "fault"]
    assert clean and faults
    assert {"prepare", "h2d", "relax", "d2h"} <= set(clean[0]["phases"])
    assert clean[0]["layout"] == "sell"
    structures = {e["structure"] for e in dump["device_memory"]["entries"]}
    assert {"dist", "sell", "patch"} <= structures
    assert (tmp_path / f"{dump['id']}.json").exists()


def test_deadline_overrun_dumps():
    samples = []
    sup = sup_for(PORT, samples=samples, solve_deadline_s=0.0,
                  failure_threshold=100, clock=time.monotonic)
    db = sup.build_route_db(*solve_inputs(PORT))
    assert db is not None
    assert sup.recorder.last_dump_reason == "deadline"
    assert any(s.get("event") == "SOLVER_FORENSICS_DUMPED"
               and s.get("reason") == "deadline" for s in samples)
    # the slow solve's own trace is in the dump
    dump = sup.recorder.dumps[-1]
    assert any(t["event"] == "solve" for ts in dump["traces"].values()
               for t in ts)


def test_decision_get_solve_traces_disabled_without_recorder():
    decision = PORT.decision.Decision(
        PORT.decision.DecisionConfig(my_node_name="n1",
                                     solver_backend="cpu"),
        PORT.messaging.ReplicateQueue().get_reader(),
        PORT.messaging.ReplicateQueue(),
    )
    report = decision.get_solve_traces()
    assert report["enabled"] is False and report["traces"] == []
    health = decision.get_solver_health()
    assert health["breaker_state"] == "unsupervised"
    assert "solve_ms_last" in health


def test_decision_solve_traces_carry_the_primarys_traces():
    """Decision(cuda)'s get_solve_traces reads the supervisor's ring: the
    primary's per-solve traces, sampled at solver_trace_sample_every."""
    import asyncio

    async def body():
        kv_q = PORT.messaging.RWQueue()
        route_q = PORT.messaging.ReplicateQueue()
        reader = route_q.get_reader()
        decision = PORT.decision.Decision(
            PORT.decision.DecisionConfig(
                my_node_name="g0_0", debounce_min=0.005, debounce_max=0.02,
                solver_trace_sample_every=1, **PORT.backend),
            PORT.messaging.RQueue(kv_q), route_q)
        decision.start()
        try:
            kv_q.push(PORT.harness.lsdb_publication(
                PORT.topology.build_adj_dbs(EDGES).values(), ANNOUNCERS))
            await asyncio.wait_for(reader.get(), 10.0)
            return decision.get_solve_traces()
        finally:
            task = decision._task
            decision.stop()
            if task is not None:
                await asyncio.gather(task, return_exceptions=True)

    report = asyncio.new_event_loop().run_until_complete(body())
    assert report["enabled"] is True
    (trace,) = report["traces"]
    assert trace["event"] == "solve" and trace["sampled"] is True
    assert {"prepare", "h2d", "relax", "d2h"} <= set(trace["phases"])
    assert report["stats"]["recorded"] == 1
