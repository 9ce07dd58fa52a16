"""The port's event path against the JAX package's, at the solver level.

The counterpart of TestWarmStartDifferential and
test_solver_exposes_spf_counters (tests/test_tpu_solver.py): one LSDB per
package, the same event sequence applied to both, and after every event
CudaSpfSolver(device="cpu") must equal TpuSpfSolver(warm_start=True) in the
route db, the resident distance matrix, the warm/cold classification of
the solve and every shared decision.spf.* counter; the warm D must equal a
fresh cold solve of the same LSDB. Exact equality throughout.
"""

import dataclasses
import random

import numpy as np
import pytest

from openr_tpu.lsdb import LinkState as JLinkState
from openr_tpu.solver import TpuSpfSolver
from openr_tpu.topology import build_adj_dbs as j_build_adj_dbs
from openr_tpu_torch.lsdb import LinkState as TLinkState
from openr_tpu_torch.ops.graph import INF
from openr_tpu_torch.solver import CudaSpfSolver
from openr_tpu_torch.topology import build_adj_dbs as t_build_adj_dbs
from openr_tpu_torch.topology import fabric_edges, grid_edges
from test_torch_solver import J, T, assert_spf_counters, canon, make_ps

PFXS = ["10.1.0.0/16", "10.2.0.0/16", "10.3.0.0/16"]

# per-solve state the two area solves must agree on after every event
_SOLVE_ATTRS = (
    "incremental_solves", "full_solves", "rounds_last",
    "invalidation_rounds_last", "last_solve_warm", "delta_extracts",
    "delta_columns", "delta_bytes",
)


class Pair:
    """One topology, one LSDB per package, and a solver on each."""

    def __init__(self, edges, me, announcers, **solver_kw):
        self.me = me
        self.dbs = {
            "jax": j_build_adj_dbs(edges), "port": t_build_adj_dbs(edges)
        }
        self.ls = {"jax": JLinkState("0"), "port": TLinkState("0")}
        for name, ls in self.ls.items():
            for db in self.dbs[name].values():
                ls.update_adjacency_database(db)
        self.ps = {
            "jax": make_ps(J, {"0": announcers}),
            "port": make_ps(T, {"0": announcers}),
        }
        solver_kw.setdefault("warm_start", True)
        self.solvers = {
            "jax": TpuSpfSolver(me, **solver_kw),
            "port": CudaSpfSolver(me, device="cpu", **solver_kw),
        }

    @property
    def version(self):
        return self.ls["port"].version

    def solve(self, name):
        return self.solvers[name]._solves[("0", self.me)][1]

    def build(self):
        """One route build in each package, then every check."""
        dbs = {
            name: solver.build_route_db(
                self.me, {"0": self.ls[name]}, self.ps[name]
            )
            for name, solver in self.solvers.items()
        }
        assert canon(dbs["port"].unicast_entries) == canon(
            dbs["jax"].unicast_entries
        )
        assert canon(dbs["port"].mpls_entries) == canon(
            dbs["jax"].mpls_entries
        )
        js, ts = self.solve("jax"), self.solve("port")
        for attr in _SOLVE_ATTRS:
            assert getattr(ts, attr) == getattr(js, attr), attr
        np.testing.assert_array_equal(ts.d, js.d)
        assert_spf_counters(self.solvers["port"], self.solvers["jax"])
        # the resident (possibly warm) D is the cold fixpoint
        np.testing.assert_array_equal(ts.d, ts.cold_reference_d())
        assert self.solvers["port"].host_spf_calls == 0
        return ts

    def _replace_db(self, node, fn):
        for name in self.dbs:
            self.dbs[name][node] = fn(self.dbs[name][node])
            self.ls[name].update_adjacency_database(self.dbs[name][node])

    def set_adj(self, a, b, **changes):
        """Change a's adjacency toward b in both packages."""
        self._replace_db(a, lambda db: dataclasses.replace(
            db,
            adjacencies=[
                dataclasses.replace(adj, **changes)
                if adj.other_node_name == b else adj
                for adj in db.adjacencies
            ],
        ))

    def set_node(self, node, **changes):
        self._replace_db(node, lambda db: dataclasses.replace(db, **changes))

    def random_event(self, rng, links):
        """A link flap (adjacency overload), a metric change or a node
        overload toggle, as tests/test_tpu_solver.py:apply_random_event."""
        kind = rng.choice(("flap", "metric", "node_overload"))
        if kind in ("flap", "metric"):
            a, b, _ = links[rng.randrange(len(links))]
            adj = next(x for x in self.dbs["port"][a].adjacencies
                       if x.other_node_name == b)
            if kind == "flap":
                self.set_adj(a, b, is_overloaded=not adj.is_overloaded)
            else:
                self.set_adj(a, b, metric=rng.randint(1, 9))
        else:
            nodes = sorted(self.dbs["port"])
            node = nodes[rng.randrange(len(nodes))]
            self.set_node(
                node, is_overloaded=not self.dbs["port"][node].is_overloaded
            )


def run_sequence(pair, links, seed, n_events):
    rng = random.Random(seed)
    pair.build()
    applied = 0
    for _ in range(n_events):
        before = pair.version
        pair.random_event(rng, links)
        if pair.version == before:
            continue  # the event was a topology no-op
        pair.build()
        applied += 1
    assert applied > 0
    return pair.solve("port")


@pytest.mark.parametrize("seed", [3, 11])
def test_grid_random_sequences(seed):
    edges = grid_edges(4)
    pair = Pair(edges, "g0_0", {"g3_3": [PFXS[0]], "g0_3": [PFXS[1]]})
    solve = run_sequence(pair, list(edges), seed, 14)
    assert solve.incremental_solves > 0


def test_clos_random_sequence():
    edges = fabric_edges(pods=2, planes=2, ssw_per_plane=2, fsw_per_pod=2,
                         rsw_per_pod=3)
    pair = Pair(edges, "rsw0_0", {"rsw1_2": [PFXS[0]], "rsw0_2": [PFXS[1]]})
    solve = run_sequence(pair, list(edges), 7, 12)
    assert solve.incremental_solves > 0


def test_star_edge_list_sequence():
    """The edge-list layout: weight events ride the warm path (K6, K2),
    an overload toggle solves cold and reports no rounds."""
    star = [("hub", f"leaf{i:04d}", 1 + i % 5) for i in range(1100)]
    pair = Pair(star, "leaf0000", {"leaf0009": [PFXS[0]]})
    assert pair.build().graph.sell is None
    for leaf, metric in (("leaf0009", 7), ("leaf0003", 1), ("leaf0009", 2)):
        pair.set_adj("hub", leaf, metric=metric)
        assert pair.build().last_solve_warm
    pair.set_node("leaf0004", is_overloaded=True)
    solve = pair.build()
    assert not solve.last_solve_warm and solve.rounds_last is None
    assert solve.incremental_solves == 3 and solve.full_solves == 2


def test_increase_then_decrease_same_link():
    pair = Pair([("a", "b", 1), ("b", "c", 1), ("c", "d", 1), ("a", "d", 9)],
                "a", {"d": [PFXS[0]]})
    cold_rounds = pair.build().rounds_last
    for metric in (8, 1):  # an invalidation pass, then a warm decrease
        pair.set_adj("b", "c", metric=metric)
        solve = pair.build()
    assert solve.incremental_solves == 2
    assert solve.rounds_last < cold_rounds


def test_partition_flap_and_heal():
    edges = [
        ("a", "b", 1), ("b", "c", 1), ("c", "a", 1),
        ("c", "x", 2),  # bridge
        ("x", "y", 1), ("y", "z", 1), ("z", "x", 1),
    ]
    pair = Pair(edges, "a", {"z": [PFXS[0]]})
    pair.build()
    for down in (True, False):
        pair.set_adj("c", "x", is_overloaded=down)
        solve = pair.build()
        far = int(solve.d[0, solve.graph.node_index["z"]])
        assert (far >= INF) == down
    assert solve.incremental_solves == 2


@pytest.mark.parametrize("edges,me,toggles", [
    ([("a", "b", 1), ("b", "c", 1), ("a", "c", 5)], "a",
     [("b", True), ("b", False)]),
    (grid_edges(4), "g0_0",
     [("g1_1", True), ("g2_2", True), ("g1_1", False), ("g2_2", False)]),
], ids=["triangle", "grid4"])
def test_node_overload_toggle_rides_warm_path(edges, me, toggles):
    pair = Pair(edges, me, {sorted({n for e in edges for n in e[:2]})[-1]:
                            [PFXS[0]]})
    full_before = pair.build().full_solves
    for node, overloaded in toggles:
        pair.set_node(node, is_overloaded=overloaded)
        solve = pair.build()
    assert solve.incremental_solves == len(toggles)
    assert solve.full_solves == full_before


def test_oversized_event_falls_back_to_cold(monkeypatch):
    import openr_tpu.solver.tpu as jtpu
    import openr_tpu_torch.solver.cuda as tcuda

    # any non-empty patch overflows a zero-slot budget
    monkeypatch.setattr(jtpu, "_PATCH_SLOTS", 0)
    monkeypatch.setattr(tcuda, "_PATCH_SLOTS", 0)
    pair = Pair([("a", "b", 1), ("b", "c", 1), ("c", "d", 1), ("a", "d", 9)],
                "a", {"d": [PFXS[0]]})
    full_before = pair.build().full_solves
    pair._replace_db("b", lambda db: dataclasses.replace(
        db, adjacencies=[dataclasses.replace(adj, metric=4)
                         for adj in db.adjacencies]))
    solve = pair.build()
    assert solve.incremental_solves == 0
    assert solve.full_solves == full_before + 1


def test_solver_exposes_spf_counters():
    pair = Pair([("a", "b", 1), ("b", "c", 1), ("a", "c", 5)], "a",
                {"c": [PFXS[0]]})
    pair.build()
    port = pair.solvers["port"]
    assert port.counters["decision.spf.full_solves"] == 1
    cold_rounds = port.counters["decision.spf.rounds_last"]
    assert cold_rounds >= 1
    pair.set_adj("b", "c", metric=3)
    pair.build()
    assert port.counters["decision.spf.incremental_solves"] == 1
    assert port.counters["decision.spf.full_solves"] == 1
    assert port.counters["decision.spf.rounds_last"] <= cold_rounds
    assert port.histograms["decision.spf.solve_warm_ms"].count == 1
    assert port.histograms["decision.spf.solve_cold_ms"].count == 1


def test_warm_start_off_solves_every_event_cold():
    edges = grid_edges(4)
    pair = Pair(edges, "g0_0", {"g3_3": [PFXS[0]]}, warm_start=False)
    solve = run_sequence(pair, list(edges), 5, 6)
    assert solve.incremental_solves == 0
    counters = pair.solvers["port"].counters
    assert "decision.spf.incremental_solves" not in counters


def test_audit_and_invalidate_warm_state():
    edges = grid_edges(4)
    pair = Pair(edges, "g0_0", {"g3_3": [PFXS[0]]})
    run_sequence(pair, list(edges), 9, 6)
    port = pair.solvers["port"]
    assert port.audit_warm_state() == []
    solve = pair.solve("port")
    solve._d_host = solve.d.copy()
    solve._d_host[0, 5] += 1  # a diverged mirror is caught
    (bad,) = port.audit_warm_state()
    assert bad["entries"] == 1 and bad["max_abs_delta"] == 1
    port.invalidate_warm_state()
    assert port.counters["decision.spf.warm_state_invalidations"] == 1
    assert port._solves == {}
    full = port.counters["decision.spf.full_solves"]
    port.build_route_db("g0_0", {"0": pair.ls["port"]}, pair.ps["port"])
    assert port.counters["decision.spf.full_solves"] == full + 1
    assert port.audit_warm_state() == []
