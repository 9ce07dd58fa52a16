"""The port's TE service (openr_tpu_torch/te/service.py) against the JAX
package's, on the CPU.

The acceptance cases of tests/test_te_service.py that need neither the
solver supervisor nor a mesh, each run through both packages' `TeService`
on the same LSDB, the port's with device="cpu": the reports are equal, key
for key, except `solve_ms` (wall clock) and `loss_last`; `loss_first` to
rel 1e-5 (float32 sums in another order). The loss of the last step is
the end of a trajectory that Adam amplifies rounding along: where the
gradient is near zero or symmetric (the uniform grid) Adam's normalised
step turns a rounding-level difference into a step of up to lr, and at the
anneal's low temperatures the gradient itself jumps. On the congested
fixture two trajectories that agree to 1e-6 at step 23 part by about 1 at
step 45; on the 3x3 grid with uniform demands the 8th loss differs by 1.4%.
The 8-step trajectory is held to 2e-4 where the gradient is not degenerate
(tests/test_torch_te.py). The proposal, the hard scores and the hot-link
tables come from the rounded integer iterates and are equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from openr_tpu.lsdb import LinkState as JLinkState
from openr_tpu.solver import TpuSpfSolver
from openr_tpu.te import TeService as JTeService
from openr_tpu.topology import build_adj_dbs as j_build_adj_dbs
from openr_tpu_torch.lsdb import LinkState as TLinkState
from openr_tpu_torch.lsdb import PrefixState as TPrefixState
from openr_tpu_torch.ops.graph import compile_graph
from openr_tpu_torch.solver import CudaSpfSolver
from openr_tpu_torch.te import (
    TeService,
    build_demand_scenarios,
    congested_clos_fixture,
    hard_max_util,
    te_edge_arrays,
    uniform_demand_spec,
)
from openr_tpu_torch.te import kernels as tk
from openr_tpu_torch.topology import build_adj_dbs as t_build_adj_dbs
from openr_tpu_torch.topology import fabric_edges, grid_edges
from test_torch_memory import release_memory_around_each_test  # noqa: F401

PKGS = {"jax": (JLinkState, j_build_adj_dbs), "torch": (TLinkState,
                                                        t_build_adj_dbs)}


def build_ls(pkg, edges, drained=()):
    ls_cls, build_adj_dbs = PKGS[pkg]
    dbs = build_adj_dbs(edges)
    for node in drained:
        dbs[node] = dataclasses.replace(dbs[node], is_overloaded=True)
    ls = ls_cls("0")
    for db in dbs.values():
        ls.update_adjacency_database(db)
    return ls


def both_reports(me, edges, params, drained=()):
    want = JTeService(me, {"0": build_ls("jax", edges, drained)}).optimize(
        dict(params))
    svc = TeService(me, {"0": build_ls("torch", edges, drained)},
                    device="cpu")
    got = svc.optimize(dict(params))
    return want, got, svc


def assert_reports_equal(want, got):
    assert set(got) == set(want)
    for key in set(want) - {"solve_ms", "loss_last"}:
        if key == "loss_first" and want[key] is not None:
            assert got[key] == pytest.approx(want[key], rel=1e-5), key
        else:
            assert got[key] == want[key], key


def test_clos_fixture_strictly_reduces_max_util_as_the_reference():
    """The acceptance criterion: the skewed elephant on the 2-pod Clos
    drops from 6.0 to 2.0 with the reference's very proposal."""
    edges, spec = congested_clos_fixture()
    want, got, svc = both_reports("l0_0", edges,
                                  {"demands": spec, "steps": 60, "seed": 0})
    assert_reports_equal(want, got)
    assert got["improved"] is True and got["degraded"] is False
    assert got["initial_max_util"] == pytest.approx(6.0)
    assert got["optimized_max_util"] == pytest.approx(2.0)
    assert got["weight_changes"] and got["backend"] == "primary"

    # independent re-verification under exact SPF + fractional ECMP
    graph = compile_graph(build_ls("torch", edges))
    src_e, dst_e, w0, up = te_edge_arrays(graph)
    demands, caps, _ = build_demand_scenarios(graph, spec)
    w = np.rint(w0).astype(np.int64)
    for change in got["weight_changes"]:
        for link, (fwd, rev) in graph.link_edges.items():
            for pos, node in ((fwd, link.n1), (rev, link.n2)):
                if (node == change["node"]
                        and link.other_node_name(node) == change["neighbor"]):
                    assert w[pos] == change["metric_before"]
                    w[pos] = change["metric_after"]
    assert hard_max_util(w, demands[0], caps, src_e, dst_e, up,
                         graph.n) == pytest.approx(2.0)
    assert svc.counters["decision.te.optimize_runs"] == 1
    assert svc.counters["decision.te.improved_last"] == 1
    assert svc.counters.get("decision.te.fallback_runs", 0) == 0
    assert svc.histograms["decision.te.solve_ms"].count == 1


def test_report_shape_top_links_and_counters_as_the_reference():
    edges, spec = congested_clos_fixture()
    want, got, svc = both_reports("l0_0", edges,
                                  {"demands": spec, "steps": 16, "seed": 3})
    assert_reports_equal(want, got)
    hottest = got["top_links"]["initial"][0]
    assert {hottest["src"], hottest["dst"]} == {"l0_0", "l1_0"}
    assert hottest["util"] == pytest.approx(6.0)
    assert svc.counters["decision.te.steps"] == 16
    assert svc.counters["decision.te.d2h_bytes"] == (16 * 18 + 16) * 4


def test_uniform_default_demands_as_the_reference():
    want, got, _ = both_reports("g0_0", grid_edges(3), {"steps": 8})
    assert_reports_equal(want, got)
    assert got["scenarios"] == 1 and got["initial_max_util"] > 0


def test_scenarios_and_spread_as_the_reference():
    edges = fabric_edges(2, planes=2, ssw_per_plane=2, fsw_per_pod=2,
                         rsw_per_pod=3)
    spec = dict(uniform_demand_spec(["rsw0_0", "rsw1_2", "fsw0_1"], 2.5),
                scenarios=3, scenario_spread=0.4,
                capacities={"default": 1.5,
                            "links": [["fsw0_0", "rsw0_0", 4.0]]})
    want, got, _ = both_reports("rsw0_0", edges,
                                {"demands": spec, "steps": 12, "seed": 5})
    assert_reports_equal(want, got)
    assert got["scenarios"] == 3


def test_empty_topology_and_unknown_area_are_request_errors():
    svc = TeService("a", {"0": TLinkState("0")}, device="cpu")
    with pytest.raises(ValueError):
        svc.optimize({})
    assert svc.counters["decision.te.optimize_errors"] == 1
    svc = TeService("a", {"0": build_ls("torch", [("a", "b", 1)])},
                    device="cpu")
    with pytest.raises(ValueError, match="unknown area"):
        svc.optimize({"area": "nope"})


def test_drained_node_carries_no_transit_or_demand():
    edges = [("a", "b", 1), ("b", "c", 1)]
    params = {"demands": {"demands": [["a", "c", 5.0], ["a", "b", 1.0]]},
              "steps": 4}
    want, got, _ = both_reports("a", edges, params, drained=("b",))
    assert_reports_equal(want, got)
    assert got["initial_max_util"] == pytest.approx(0.0)
    assert got["improved"] is False and got["weight_changes"] == []


def test_scenarios_deterministic_by_seed():
    graph = compile_graph(build_ls("torch", grid_edges(3)))
    spec = dict(uniform_demand_spec(list(graph.names)), scenarios=4)
    d1, _, _ = build_demand_scenarios(graph, spec, seed=7)
    d2, _, _ = build_demand_scenarios(graph, spec, seed=7)
    d3, _, _ = build_demand_scenarios(graph, spec, seed=8)
    np.testing.assert_array_equal(d1, d2)
    assert not np.array_equal(d1, d3)


@pytest.mark.parametrize("wrapper", ["softmin_round", "te_adam"])
def test_a_failing_device_run_raises_and_counts_an_error(monkeypatch,
                                                         wrapper):
    """A kernel wrapper that fails (as a kernel that will not build or
    launch does) fails the optimization: the error reaches the caller and
    counts decision.te.optimize_errors. The work is not re-run on the CPU,
    so no fallback run is counted and the next clean run is not degraded."""
    edges, spec = congested_clos_fixture()
    params = {"demands": spec, "steps": 4, "seed": 0}
    svc = TeService("l0_0", {"0": build_ls("torch", edges)}, device="cpu")

    def fail(*args, **kwargs):
        raise RuntimeError(f"{wrapper}: launch failed")

    with monkeypatch.context() as m:
        m.setattr(tk, wrapper, fail)
        with pytest.raises(RuntimeError, match="launch failed"):
            svc.optimize(dict(params))
    assert svc.counters["decision.te.optimize_errors"] == 1
    assert svc.counters["decision.te.optimize_runs"] == 1
    assert "decision.te.fallback_runs" not in svc.counters
    report = svc.optimize(dict(params))
    assert report["degraded"] is False and report["backend"] == "primary"
    assert svc.counters["decision.te.optimize_errors"] == 1


def test_borrowed_apsp_matrix_as_the_reference():
    """With a solver holding a fresh all-pairs matrix, the initial hard
    scoring borrows it (decision.te.apsp_borrows), as the reference's does
    from its TpuSpfSolver."""
    edges = fabric_edges(2, planes=2, ssw_per_plane=2, fsw_per_pod=2,
                         rsw_per_pod=3)
    rng = np.random.default_rng(1)
    names = sorted({a for a, _, _ in edges} | {b for _, b, _ in edges})
    spec = {"demands": [[str(a), str(b), float(rng.uniform(0.5, 4))]
                        for a, b in rng.choice(names, size=(12, 2))
                        if a != b], "scenarios": 2}
    params = {"demands": spec, "steps": 8, "seed": 2}
    me = "rsw0_0"
    j_ls, t_ls = build_ls("jax", edges), build_ls("torch", edges)
    j_solver = TpuSpfSolver(me, apsp_max_nodes=4096)
    t_solver = CudaSpfSolver(me, apsp_max_nodes=4096, device="cpu")
    from openr_tpu.lsdb import PrefixState as JPrefixState

    j_solver.build_route_db(me, {"0": j_ls}, JPrefixState())
    t_solver.build_route_db(me, {"0": t_ls}, TPrefixState())
    want_svc = JTeService(me, {"0": j_ls}, solver=j_solver)
    want = want_svc.optimize(dict(params))
    svc = TeService(me, {"0": t_ls}, solver=t_solver, device="cpu")
    got = svc.optimize(dict(params))
    assert_reports_equal(want, got)
    assert svc.counters["decision.te.apsp_borrows"] == 1
    assert want_svc.counters["decision.te.apsp_borrows"] == 1
    assert svc.counters.get("decision.te.fallback_runs", 0) == 0


@pytest.mark.parametrize("case", ["metric_above_w_max", "stale_snapshot",
                                  "drained_node"])
def test_no_borrow_where_the_matrix_cannot_serve(case):
    """The initial scoring borrows the solver's matrix only where it holds
    the scored weights: not where the [w_min, w_max] projection clips a
    live metric, not after the LSDB moved past the solved snapshot, not
    with a drained node. There both services derive the distances
    themselves, and the reports are the reference's."""
    edges = fabric_edges(2, planes=2, ssw_per_plane=2, fsw_per_pod=2,
                         rsw_per_pod=3)
    if case == "metric_above_w_max":
        edges = [(a, b, 100 if (a, b) == ("fsw0_0", "ssw0_0") else m)
                 for a, b, m in edges]
    drained = ("fsw0_1",) if case == "drained_node" else ()
    spec = {"demands": [["rsw0_0", "rsw1_2", 3.0], ["rsw1_0", "rsw0_1", 2.0]],
            "scenarios": 2}
    params = {"demands": spec, "steps": 8, "seed": 2}
    me = "rsw0_0"
    from openr_tpu.lsdb import PrefixState as JPrefixState

    reports, services = [], []
    for pkg, solver, prefix_state, svc_cls, kw in (
        ("jax", TpuSpfSolver(me, apsp_max_nodes=4096), JPrefixState(),
         JTeService, {}),
        ("torch", CudaSpfSolver(me, apsp_max_nodes=4096, device="cpu"),
         TPrefixState(), TeService, {"device": "cpu"}),
    ):
        ls = build_ls(pkg, edges, drained)
        solver.build_route_db(me, {"0": ls}, prefix_state)
        if case == "stale_snapshot":
            db = PKGS[pkg][1](edges)["rsw1_0"]
            ls.update_adjacency_database(dataclasses.replace(
                db, adjacencies=[dataclasses.replace(adj, metric=2)
                                 for adj in db.adjacencies]))
        svc = svc_cls(me, {"0": ls}, solver=solver, **kw)
        reports.append(svc.optimize(dict(params)))
        services.append(svc)
    assert_reports_equal(*reports)
    for svc in services:
        assert "decision.te.apsp_borrows" not in svc.counters


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ls = build_ls("torch", [("a", "b", 1)])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TeService("a", {"0": ls})
    assert TeService("a", {"0": ls}, device="cpu").device.type == "cpu"


# -- the supervised run: tests/test_te_service.py TestFaultDomain and
# TestDecisionIntegration, the same fault script armed in both packages ---

import openr_tpu.solver as j_solver  # noqa: E402
import openr_tpu.testing.faults as j_faults  # noqa: E402
import openr_tpu_torch.solver as t_solver  # noqa: E402
import openr_tpu_torch.testing.faults as t_faults  # noqa: E402

SUPERVISED = {
    "jax": (j_solver, j_faults, lambda me: j_solver.TpuSpfSolver(me), None),
    "torch": (t_solver, t_faults,
              lambda me: t_solver.CudaSpfSolver(me, device="cpu"), "cpu"),
}


def make_supervised(pkg, me, edges, samples, **cfg_kw):
    solver, _, primary, device = SUPERVISED[pkg]
    sup = solver.SolverSupervisor(
        primary(me), solver.SpfSolver(me), solver.SupervisorConfig(**cfg_kw),
        log_sample_fn=samples.append,
    )
    kw = {} if device is None else {"device": device}
    svc = (JTeService if pkg == "jax" else TeService)(
        me, {"0": build_ls(pkg, edges)}, solver=sup,
        log_sample_fn=samples.append, **kw)
    return svc, sup


def supervised_both(script, cfg_kw):
    """script(svc, sup, inj) -> [report, ...] in both packages: the reports
    (less solve_ms and loss_last), the TE and spf fault counters and the
    LogSample event names must be equal."""
    seen = {}
    for pkg in ("torch", "jax"):
        edges, spec = congested_clos_fixture()
        samples = []
        svc, sup = make_supervised(pkg, "l0_0", edges, samples, **cfg_kw)
        with SUPERVISED[pkg][1].injected() as inj:
            reports = script(svc, sup, inj, spec)
        seen[pkg] = (reports, svc, sup, [s.get("event") for s in samples])
    (got, t_svc, t_sup, t_ev), (want, j_svc, j_sup, j_ev) = (
        seen["torch"], seen["jax"])
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert_reports_equal(a, b)
    assert t_svc.counters == j_svc.counters
    assert {k: v for k, v in t_sup.counters.items()
            if k.startswith("decision.spf.solver")
            or k.startswith("decision.spf.fallback")
            or k.startswith("decision.spf.breaker")} == {
        k: v for k, v in j_sup.counters.items()
        if k.startswith("decision.spf.solver")
        or k.startswith("decision.spf.fallback")
        or k.startswith("decision.spf.breaker")}
    assert t_ev == j_ev
    assert t_sup.state == j_sup.state
    return got, t_svc, t_sup, t_ev


def test_supervised_injected_fault_degrades_to_cpu_as_the_reference():
    def script(svc, sup, inj, spec):
        inj.arm("te.optimize", times=None)
        report = svc.optimize({"demands": spec, "steps": 40, "seed": 0})
        assert inj.fired("te.optimize") >= 1
        return [report]

    (report,), svc, sup, events = supervised_both(script, {"max_attempts": 2})
    assert report["degraded"] is True and report["backend"] == "cpu-fallback"
    assert report["improved"] is True
    assert svc.counters["decision.te.fallback_runs"] == 1
    assert sup.counters["decision.spf.solver_failures"] >= 1
    assert events.count("TE_OPTIMIZE_DEGRADED") == 1


def test_supervised_transient_fault_is_retried_in_call_as_the_reference():
    def script(svc, sup, inj, spec):
        inj.arm("te.optimize", times=1)
        return [svc.optimize({"demands": spec, "steps": 20})]

    (report,), _, sup, events = supervised_both(script, {"max_attempts": 3})
    assert report["degraded"] is False and report["backend"] == "primary"
    assert sup.counters["decision.spf.solver_retries"] >= 1
    assert "TE_OPTIMIZE_DEGRADED" not in events


def test_supervised_open_breaker_serves_fallback_as_the_reference():
    def script(svc, sup, inj, spec):
        inj.arm("te.optimize", times=None)
        first = svc.optimize({"demands": spec, "steps": 10})
        fired = inj.fired("te.optimize")
        second = svc.optimize({"demands": spec, "steps": 10})
        assert inj.fired("te.optimize") == fired
        return [first, second]

    reports, svc, sup, events = supervised_both(
        script, {"failure_threshold": 1, "max_attempts": 1})
    assert all(r["degraded"] for r in reports)
    assert svc.counters["decision.te.fallback_runs"] == 2
    assert sup.state == "open"
    assert events.count("TE_OPTIMIZE_DEGRADED") == 2


def test_unsupervised_service_raises_where_the_reference_degrades():
    """Without a supervisor the reference re-runs a failed device
    optimization on the CPU behind the caller's back; the port raises."""
    edges, spec = congested_clos_fixture()
    params = {"demands": spec, "steps": 20}
    with j_faults.injected() as inj:
        inj.arm("te.optimize", times=None)
        ref = JTeService("l0_0", {"0": build_ls("jax", edges)}).optimize(
            dict(params))
    assert ref["degraded"] is True
    svc = TeService("l0_0", {"0": build_ls("torch", edges)}, device="cpu")
    with t_faults.injected() as inj:
        inj.arm("te.optimize", times=None)
        with pytest.raises(t_faults.FaultInjected):
            svc.optimize(dict(params))
    assert svc.counters["decision.te.optimize_errors"] == 1
    assert "decision.te.fallback_runs" not in svc.counters


def _te_decision(pkg, edges):
    if pkg == "jax":
        from openr_tpu.decision import Decision, DecisionConfig
        from openr_tpu.messaging import ReplicateQueue, RQueue, RWQueue

        cfg = DecisionConfig(my_node_name="l0_0", solver_backend="tpu")
    else:
        from openr_tpu_torch.decision import Decision, DecisionConfig
        from openr_tpu_torch.messaging import ReplicateQueue, RQueue, RWQueue

        cfg = DecisionConfig(my_node_name="l0_0", solver_backend="cuda",
                             solver_device="cpu")
    decision = Decision(cfg, RQueue(RWQueue()), ReplicateQueue())
    ls = decision.area_link_states["0"]
    for db in PKGS[pkg][1](edges).values():
        ls.update_adjacency_database(db)
    return decision


@pytest.mark.parametrize("armed", [False, True],
                         ids=["run_te_optimize_through_decision",
                              "decision_level_fault_degrades"])
def test_run_te_optimize_through_decision_as_the_reference(armed):
    edges, spec = congested_clos_fixture()
    params = {"demands": spec, "steps": 20, "seed": 0}
    seen = {}
    for pkg, faults in (("torch", t_faults), ("jax", j_faults)):
        decision = _te_decision(pkg, edges)
        with faults.injected() as inj:
            if armed:
                inj.arm("te.optimize", times=None)
            report = decision.run_te_optimize(dict(params))
        svc = decision._te_service
        decision.run_te_optimize({"demands": spec, "steps": 4})
        assert decision._te_service is svc
        seen[pkg] = (report, {k: v for k, v in decision.counters.items()
                              if k.startswith("decision.te.")
                              or k == "decision.spf.solver_failures"})
    assert_reports_equal(seen["jax"][0], seen["torch"][0])
    assert seen["torch"][1] == seen["jax"][1]
    report, counters = seen["torch"]
    assert report["improved"] is True and report["degraded"] is armed
    assert counters["decision.te.optimize_runs"] == 2
    assert counters.get("decision.spf.solver_failures", 0) == (
        2 if armed else 0)
