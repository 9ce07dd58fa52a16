"""The solver's consumers of the resident all-pairs matrix, against the JAX
package's, on the CPU.

CudaSpfSolver(apsp_max_nodes=4096, device="cpu") against
TpuSpfSolver(apsp_max_nodes=4096): SPF views and distances of sources
outside the solved batch, route dbs built from other nodes' perspectives
with LFA on, the TE borrow, the decision.spf.apsp_* counters through the
same build sequence, and DeltaPath under LFA on the grid and Clos
sequences of tests/test_route_delta.py::TestDeltaUnderLfa (the same event
generator, applied to both packages). Every answer
outside the batch comes from the matrix: `host_spf_calls` stays 0. Exact
equality throughout.
"""

import dataclasses
import random

import numpy as np
import pytest

from openr_tpu.solver import TpuSpfSolver
from openr_tpu_torch.ops.graph import INF
from openr_tpu_torch.solver import CudaSpfSolver, SpfSolver
from openr_tpu_torch.topology import fabric_edges, grid_edges, wan_edges
from test_torch_event_path import Pair
from test_torch_route_delta import DeltaHarness
from test_torch_solver import (
    J,
    T,
    assert_spf_counters,
    build_ls,
    canon,
    make_ps,
)

PFXS = ["10.1.0.0/16", "10.2.0.0/16", "10.3.0.0/16", "10.4.0.0/16"]
APSP = {"apsp_max_nodes": 4096}
LFA_KW = {"compute_lfa_paths": True, "apsp_max_nodes": 4096}


def solvers(me, edges, overloaded=None, **kw):
    """(port solver, JAX solver, port LinkState, JAX LinkState), both
    solvers built once from me's perspective with no prefixes."""
    ls_t = build_ls(T, edges, overloaded=overloaded)
    ls_j = build_ls(J, edges, overloaded=overloaded)
    port = CudaSpfSolver(me, device="cpu", **APSP, **kw)
    ref = TpuSpfSolver(me, **APSP, **kw)
    port.build_route_db(me, {"0": ls_t}, make_ps(T, {}))
    ref.build_route_db(me, {"0": ls_j}, make_ps(J, {}))
    return port, ref, ls_t, ls_j


@pytest.mark.parametrize("case", ["wan", "grid_overloaded"])
def test_other_source_views_match_jax_and_oracle(case):
    if case == "wan":
        edges, ov = wan_edges(18, degree=3, seed=9), None
    else:
        edges, ov = grid_edges(4), {"g1_1"}
    names = sorted({a for a, _, _ in edges} | {b for _, b, _ in edges})
    port, ref, ls_t, ls_j = solvers(names[0], edges, overloaded=ov)
    for src in names[1:]:
        view = port._spf(ls_t, src)
        ref_view = ref._spf(ls_j, src)
        oracle = ls_t.get_spf_result(src)
        for dest in names:
            assert (dest in view) == (dest in ref_view) == (dest in oracle)
            if dest in oracle:
                assert view[dest].metric == ref_view[dest].metric
                assert view[dest].metric == oracle[dest].metric
                assert view[dest].next_hops == ref_view[dest].next_hops
                assert view[dest].next_hops == oracle[dest].next_hops
    assert port.host_spf_calls == 0


def test_arbitrary_pair_dist_matches_jax_and_oracle():
    port, ref, ls_t, ls_j = solvers("g0_0", grid_edges(4))
    rng = random.Random(2)
    nodes = sorted(ls_t.node_names())
    for _ in range(40):
        a, b = rng.choice(nodes), rng.choice(nodes)
        want = ls_t.get_metric_from_a_to_b(a, b)
        assert port._dist(ls_t, a, b) == ref._dist(ls_j, a, b) == want
    assert port.host_spf_calls == 0


def test_neighbour_nexthops_come_from_the_matrix():
    """A batch row other than me (an up-neighbour) answers nexthop sets
    through the matrix; with APSP off it still fails fast."""
    port, _, ls_t, _ = solvers("g0_0", grid_edges(3))
    view = port._spf(ls_t, "g0_1")
    assert view["g2_2"].next_hops == ls_t.get_spf_result("g0_1")[
        "g2_2"].next_hops
    plain = CudaSpfSolver("g0_0", device="cpu")
    plain.build_route_db("g0_0", {"0": ls_t}, make_ps(T, {}))
    with pytest.raises(RuntimeError, match="only solved for g0_0"):
        plain._spf(ls_t, "g0_1")["g2_2"].next_hops


@pytest.mark.parametrize("topo", ["grid", "clos"])
def test_route_dbs_of_other_nodes_with_lfa(topo):
    """build_route_db(other) of a solver built for me, with LFA: equal to
    the CPU oracle built for other and to the JAX solver's, with no host
    Dijkstra."""
    if topo == "grid":
        edges, me = grid_edges(5), "g0_0"
        announcers = {"g4_4": [PFXS[0]], "g0_4": [PFXS[1]],
                      "g2_1": [PFXS[2]], "g3_2": [PFXS[3]]}
        others = ["g2_2", "g4_0", "g1_3"]
    else:
        edges = fabric_edges(pods=2, planes=2, ssw_per_plane=2,
                             fsw_per_pod=2, rsw_per_pod=3)
        me = "rsw0_0"
        announcers = {"rsw1_2": [PFXS[0]], "rsw0_2": [PFXS[1]],
                      "rsw1_0": [PFXS[2]]}
        others = ["rsw1_1", "fsw0_1", "ssw1_0"]
    ls_t, ls_j = build_ls(T, edges), build_ls(J, edges)
    ps_t = make_ps(T, {"0": announcers})
    ps_j = make_ps(J, {"0": announcers})
    port = CudaSpfSolver(me, device="cpu", **LFA_KW)
    ref = TpuSpfSolver(me, **LFA_KW)
    port.build_route_db(me, {"0": ls_t}, ps_t)
    ref.build_route_db(me, {"0": ls_j}, ps_j)
    for other in others:
        got = port.build_route_db(other, {"0": ls_t}, ps_t)
        want = SpfSolver(other, compute_lfa_paths=True).build_route_db(
            other, {"0": ls_t}, ps_t
        )
        jax_db = ref.build_route_db(other, {"0": ls_j}, ps_j)
        assert got.unicast_entries == want.unicast_entries
        assert got.mpls_entries == want.mpls_entries
        assert canon(got.unicast_entries) == canon(jax_db.unicast_entries)
        assert canon(got.mpls_entries) == canon(jax_db.mpls_entries)
    assert port.host_spf_calls == 0
    assert_spf_counters(port, ref)


def test_without_apsp_other_sources_use_host_dijkstra():
    ls_t = build_ls(T, grid_edges(3))
    port = CudaSpfSolver("g0_0", device="cpu")
    port.build_route_db("g0_0", {"0": ls_t}, make_ps(T, {}))
    assert port._dist(ls_t, "g2_2", "g2_0") == 2
    assert port.host_spf_calls == 1
    assert port.lfa_delta_ready() is False


def test_borrow_fresh_stale_and_drained():
    ls_t = build_ls(T, grid_edges(3))
    ls_j = build_ls(J, grid_edges(3))
    port = CudaSpfSolver("g0_0", device="cpu", **APSP)
    ref = TpuSpfSolver("g0_0", **APSP)
    port.build_route_db("g0_0", {"0": ls_t}, make_ps(T, {}))
    ref.build_route_db("g0_0", {"0": ls_j}, make_ps(J, {}))
    got = port.borrow_apsp("0", ls_t.version)
    want = ref.borrow_apsp("0", ls_j.version)
    assert got is not None and got.shape == (9, 9)
    np.testing.assert_array_equal(got, want)
    assert got.max() < INF
    assert port.borrow_apsp("0", ls_t.version + 1) is None  # stale
    assert port.borrow_apsp("missing", ls_t.version) is None
    # a drained (overloaded) node: the borrow refuses
    for ls, solver, pkg in ((ls_t, port, T), (ls_j, ref, J)):
        db = ls.get_adjacency_databases()["g1_1"]
        ls.update_adjacency_database(
            dataclasses.replace(db, is_overloaded=True))
        solver.build_route_db("g0_0", {"0": ls}, make_ps(pkg, {}))
    assert port.borrow_apsp("0", ls_t.version) is None
    assert ref.borrow_apsp("0", ls_j.version) is None
    # APSP off: nothing to borrow
    off = CudaSpfSolver("g0_0", device="cpu")
    off.build_route_db("g0_0", {"0": ls_t}, make_ps(T, {}))
    assert off.borrow_apsp("0", ls_t.version) is None


def test_apsp_counters_match_jax_through_builds():
    """The counters (decision.spf.apsp_* included) equal the reference's
    after every build of a sequence with cold, warm and poisoned closes."""
    pair = Pair(grid_edges(4), "g0_0", {"g3_3": [PFXS[0]]},
                compute_lfa_paths=True, **APSP, apsp_audit_interval=2)
    pair.build()

    def read_other():
        for name, solver in pair.solvers.items():
            solver._dist(pair.ls[name], "g3_2", "g0_1")

    read_other()  # the first close
    pair.set_adj("g2_2", "g2_1", metric=5)  # remote: warm
    pair.build()
    read_other()
    pair.set_adj("g3_3", "g3_2", is_overloaded=True)  # remote link down
    pair.build()
    read_other()
    # a link at me goes down: the batch's rows change and it solves cold,
    # which invalidates the matrix
    pair.set_adj("g0_0", "g0_1", is_overloaded=True)
    pair.build()
    read_other()
    pair.build()  # the last close's counters fold in at the next sync
    counters = pair.solvers["port"].counters
    assert counters["decision.spf.apsp_closes"] == 4
    assert counters["decision.spf.apsp_warm_closes"] == 2
    assert counters["decision.spf.apsp_cold_closes"] == 2
    assert counters["decision.spf.apsp_invalidations"] == 1
    assert counters["decision.spf.apsp_audit_runs"] == 2
    assert counters["decision.spf.apsp_d2h_bytes"] > 0
    assert counters["decision.spf.apsp_h2d_bytes"] > 0
    assert "decision.spf.apsp_close_ms" in pair.solvers[
        "port"]._ensure_histograms()
    assert_spf_counters(pair.solvers["port"], pair.solvers["jax"])
    assert pair.solve("port").apsp.health() == pair.solve("jax").apsp.health()


def test_lfa_delta_ready():
    ls_t = build_ls(T, grid_edges(3))
    port = CudaSpfSolver("g0_0", device="cpu", **LFA_KW)
    assert port.lfa_delta_ready() is False  # no area solve yet
    port.build_route_db("g0_0", {"0": ls_t}, make_ps(T, {}))
    assert port.lfa_delta_ready() is True
    small = CudaSpfSolver("g0_0", device="cpu", compute_lfa_paths=True,
                          apsp_max_nodes=4)
    small.build_route_db("g0_0", {"0": ls_t}, make_ps(T, {}))
    assert small.lfa_delta_ready() is False  # the area is past the cap


@pytest.mark.parametrize("seed", [5, 23, 41])
def test_grid_delta_under_lfa_matches_jax(seed):
    h = DeltaHarness(grid_edges(4), "g0_0", {
        "g3_3": [PFXS[0]], "g0_3": [PFXS[1]], "g2_1": [PFXS[2]],
        "g1_2": [PFXS[3]],
    }, solver_kwargs=LFA_KW)
    rng = random.Random(seed)
    links = list(grid_edges(4))
    for _ in range(14):
        before = h.pair.version
        h.pair.random_event(rng, links)
        if h.pair.version == before:
            continue
        h.step()
    assert h.port_builder.delta_builds > 0
    assert h.port_builder.full_builds > 1
    assert h.pair.solvers["port"].host_spf_calls == 0


def test_clos_delta_under_lfa_matches_jax():
    edges = fabric_edges(pods=2, planes=2, ssw_per_plane=2, fsw_per_pod=2,
                         rsw_per_pod=3)
    h = DeltaHarness(edges, "rsw0_0",
                     {"rsw1_2": [PFXS[0]], "rsw0_2": [PFXS[1]]},
                     solver_kwargs=LFA_KW)
    rng = random.Random(17)
    links = list(edges)
    for _ in range(10):
        before = h.pair.version
        h.pair.random_event(rng, links)
        if h.pair.version == before:
            continue
        h.step()
    assert h.port_builder.delta_builds > 0


def test_me_column_change_forces_full_under_lfa():
    h = DeltaHarness(grid_edges(4), "g0_0", {"g3_3": [PFXS[0]]},
                     solver_kwargs=LFA_KW)
    h.pair.set_adj("g0_1", "g0_0", metric=9)  # the far side INTO me
    assert h.step() is False
    h.pair.set_adj("g3_2", "g3_3", metric=7)  # remote, me column unmoved
    assert h.step() is True


def test_lfa_alternate_flips_through_delta_builds():
    h = DeltaHarness([("a", "b", 1), ("b", "d", 1), ("a", "c", 2),
                      ("c", "d", 2)], "a", {"d": [PFXS[0]]},
                     solver_kwargs=LFA_KW)
    entry = next(iter(h.db["port"].unicast_entries.values()))
    assert len(entry.nexthops) == 2  # b on the shortest path, c as LFA
    h.pair.set_adj("c", "d", metric=9)  # c is no longer loop-free
    h.step()
    entry = next(iter(h.db["port"].unicast_entries.values()))
    assert {nh.neighbor_node for nh in entry.nexthops} == {"b"}


# -- the all-pairs closes in the fault domain: tests/test_apsp.py
# TestFaultDomain, the same fault script armed in both packages ----------

import openr_tpu.apsp as j_apsp  # noqa: E402
import openr_tpu.ops.graph as j_graph  # noqa: E402
import openr_tpu.solver as j_solver  # noqa: E402
import openr_tpu.testing.faults as j_faults  # noqa: E402
import openr_tpu_torch.apsp as t_apsp  # noqa: E402
import openr_tpu_torch.ops.graph as t_graph  # noqa: E402
import openr_tpu_torch.solver as t_solver  # noqa: E402
import openr_tpu_torch.testing.faults as t_faults  # noqa: E402

FAULT_PKGS = {
    "port": (T, t_solver, t_faults,
             lambda me, **kw: t_solver.CudaSpfSolver(me, device="cpu", **kw)),
    "jax": (J, j_solver, j_faults,
            lambda me, **kw: j_solver.TpuSpfSolver(me, **kw)),
}


def _supervised_close(name, warm_event):
    """A supervised solver on grid_edges(3), its first close on the card
    (or, with warm_event, a clean close and then a weight event), with
    solver.apsp.close armed: what the fault domain served and counted."""
    pkg, solver, faults, primary_of = FAULT_PKGS[name]
    ls = build_ls(pkg, grid_edges(3))
    primary = primary_of("g0_0", apsp_max_nodes=64)
    sup = solver.SolverSupervisor(
        primary, solver.SpfSolver("g0_0"),
        solver.SupervisorConfig(failure_threshold=2, max_attempts=1),
    )
    sup.build_route_db("g0_0", {"0": ls}, make_ps(pkg, {}))
    solve = primary._solves[("0", "g0_0")][1]
    seen = []
    if warm_event:
        assert solve.ensure_apsp() and solve.apsp.backend == "device"
        ls_cls, _, build_adj_dbs, _ = pkg
        db = build_adj_dbs(grid_edges(3))["g1_1"]
        ls.update_adjacency_database(dataclasses.replace(
            db, adjacencies=[dataclasses.replace(a, metric=3)
                             for a in db.adjacencies]))
        sup.build_route_db("g0_0", {"0": ls}, make_ps(pkg, {}))
    with faults.injected() as inj:
        inj.arm("solver.apsp.close", times=3, exc=faults.FaultInjected)
        assert solve.ensure_apsp()  # degraded to numpy, no raise
        seen.append((solve.apsp.backend, sup.state,
                     solve.apsp.d[: solve.graph.n, : solve.graph.n].copy()))
        solve.apsp.invalidate("test")
        solve.ensure_apsp()
        seen.append((solve.apsp.backend, sup.state, None))
    # the breaker opened on the second faulted close; the solve that
    # serves the next build syncs the apsp counters
    health = solve.apsp.health()
    counters = {k: v for k, v in sup.counters.items()
                if k.startswith(("decision.spf.solver_failures",
                                 "decision.spf.breaker",
                                 "decision.spf.fallback_active"))}
    oracle = j_graph if name == "jax" else t_graph
    want = np.asarray(
        (j_apsp if name == "jax" else t_apsp).np_floyd_warshall(
            (j_apsp if name == "jax" else t_apsp).build_weight_matrix(
                oracle.compile_graph(ls)),
            oracle.compile_graph(ls).overloaded,
        ))[: solve.graph.n, : solve.graph.n]
    return seen, health, counters, want


@pytest.mark.parametrize("warm_event", [False, True], ids=["cold", "warm"])
def test_supervised_close_faults_feed_the_breaker_as_the_reference(
    warm_event
):
    port = _supervised_close("port", warm_event)
    ref = _supervised_close("jax", warm_event)
    (p_seen, p_health, p_counters, p_want) = port
    (j_seen, j_health, j_counters, _) = ref
    assert [s[:2] for s in p_seen] == [s[:2] for s in j_seen] == [
        ("numpy", "closed"), ("numpy", "open")]
    np.testing.assert_array_equal(p_seen[0][2], j_seen[0][2])
    np.testing.assert_array_equal(p_seen[0][2], p_want)
    assert p_health == j_health
    assert p_health["fallback_closes"] == 2
    assert p_counters == j_counters
    assert p_counters["decision.spf.fallback_active"] == 1


def test_supervised_numpy_resident_matrix_recovers_on_the_card():
    """A degraded (numpy-resident) matrix has no device base: the next
    close after the fault is cold and on the card again, as in the
    reference's test_injected_fault_falls_back_to_numpy."""
    ls = build_ls(T, grid_edges(3))
    graph = t_graph.compile_graph(ls)
    calls = []

    def dispatch(op, primary, fallback):
        calls.append(op)
        try:
            return primary(), False
        except t_faults.FaultInjected:
            return fallback(), True

    apsp = t_apsp.ApspState(max_nodes=64, dispatch=dispatch, device="cpu")
    with t_faults.injected() as inj:
        inj.arm("solver.apsp.close", times=1)
        assert apsp.ensure(graph)
    assert apsp.backend == "numpy" and apsp.fallback_closes == 1
    want = t_apsp.np_floyd_warshall(
        t_apsp.build_weight_matrix(graph), graph.overloaded)
    np.testing.assert_array_equal(apsp.d, want)
    apsp.invalidate("test")
    assert apsp.ensure(graph)
    assert apsp.backend == "device" and apsp.cold_closes == 2
    np.testing.assert_array_equal(apsp.d, want)
    assert calls == ["apsp.close", "apsp.close"]


@pytest.mark.parametrize("armed_at", ["cold", "warm"])
def test_unsupervised_apsp_close_raises_where_the_reference_degrades(
    armed_at
):
    """Without a dispatch hook (no supervisor) a faulted close raises in
    the port; the reference serves the numpy close behind a bare
    try/except."""
    ls_t, ls_j = build_ls(T, grid_edges(3)), build_ls(J, grid_edges(3))
    port = t_apsp.ApspState(max_nodes=64, device="cpu")
    ref = j_apsp.ApspState(max_nodes=64)
    g_t, g_j = t_graph.compile_graph(ls_t), j_graph.compile_graph(ls_j)
    if armed_at == "warm":
        assert port.ensure(g_t) and ref.ensure(g_j)
        for pkg, ls in ((T, ls_t), (J, ls_j)):
            db = pkg[2](grid_edges(3))["g1_1"]
            ls.update_adjacency_database(dataclasses.replace(
                db, adjacencies=[dataclasses.replace(a, metric=3)
                                 for a in db.adjacencies]))
        g_t = t_graph.refresh_graph(g_t, ls_t)
        g_j = j_graph.refresh_graph(g_j, ls_j)
    with j_faults.injected() as inj:
        inj.arm("solver.apsp.close", times=1)
        assert ref.ensure(g_j) and ref.backend == "numpy"
    with t_faults.injected() as inj:
        inj.arm("solver.apsp.close", times=1)
        with pytest.raises(t_faults.FaultInjected):
            port.ensure(g_t)
    assert port.fallback_closes == 0 and ref.fallback_closes == 1


def test_supervised_close_that_fails_its_kernel_is_not_served_by_numpy():
    """A close whose kernel launch is refused passes the supervisor's
    dispatch: it raises, the numpy Floyd-Warshall serves nothing, and the
    breaker stays closed."""
    from openr_tpu_torch.ops import _cuda

    ls = build_ls(T, grid_edges(3))
    primary = t_solver.CudaSpfSolver("g0_0", device="cpu", apsp_max_nodes=64)
    sup = t_solver.SolverSupervisor(
        primary, t_solver.SpfSolver("g0_0"),
        t_solver.SupervisorConfig(failure_threshold=1, max_attempts=2),
    )
    sup.build_route_db("g0_0", {"0": ls}, make_ps(T, {}))
    solve = primary._solves[("0", "g0_0")][1]
    with t_faults.injected() as inj:
        inj.arm("solver.apsp.close", times=None,
                exc=lambda point: _cuda.KernelLaunchError(point))
        with pytest.raises(_cuda.KernelLaunchError):
            solve.ensure_apsp()
    assert solve.apsp.fallback_closes == 0
    assert sup.state == "closed"
    assert "decision.spf.solver_failures" not in sup.counters
