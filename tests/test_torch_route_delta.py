"""DeltaPath route builds of the port against the JAX package's.

The counterpart of DeltaHarness, TestDeltaDifferential, TestTransferBudget
and test_lfa_without_apsp_keeps_force_full (tests/test_route_delta.py):
the port's DeltaRouteBuilder over CudaSpfSolver(device="cpu") and the JAX
DeltaRouteBuilder over TpuSpfSolver take the same event sequence. Each
step must give the same used_delta, equal route dbs (canonical form),
equal delta_builds / full_builds, a db equal to the port's CPU oracle, and
an update that folds the previous db into the new one.
"""

import random

import numpy as np
import pytest

from openr_tpu.solver import DeltaRouteBuilder as JDeltaRouteBuilder
from openr_tpu.solver import apply_route_delta as j_apply_route_delta
from openr_tpu_torch.ops.graph import _next_bucket
from openr_tpu_torch.solver import (
    CudaSpfSolver,
    DeltaRouteBuilder,
    SpfSolver,
    apply_route_delta,
)
from openr_tpu_torch.topology import fabric_edges, grid_edges
from openr_tpu_torch.types import IpPrefix, PrefixDatabase, PrefixEntry
from test_torch_event_path import Pair
from test_torch_solver import canon

PFXS = ["10.1.0.0/16", "10.2.0.0/16", "10.3.0.0/16", "10.4.0.0/16"]


def assert_db_equal(a, b):
    assert a is not None and b is not None
    assert a.unicast_entries == b.unicast_entries
    assert a.mpls_entries == b.mpls_entries


class DeltaHarness:
    """A DeltaRouteBuilder in each package over one Pair of LSDBs."""

    def __init__(self, edges, me, announcers, solver_kwargs=None):
        self.me = me
        self.solver_kwargs = dict(solver_kwargs or {})
        self.pair = Pair(edges, me, announcers, **self.solver_kwargs)
        self.builders = {
            "jax": JDeltaRouteBuilder(self.pair.solvers["jax"]),
            "port": DeltaRouteBuilder(self.pair.solvers["port"]),
        }
        self.db = {}
        for name, builder in self.builders.items():
            db, _, used = builder.build(
                me, self.als(name), self.pair.ps[name], None, force_full=True
            )
            assert not used and db is not None  # the first build is full
            self.db[name] = db

    def als(self, name):
        return {"0": self.pair.ls[name]}

    @property
    def solve(self):
        return self.pair.solve("port")

    def step(self, dirty=None, force_full=False):
        """One rebuild in each package; `dirty` maps package name to its
        dirty prefixes. Returns the port's used_delta."""
        used = {}
        for name, builder in self.builders.items():
            prev = self.db[name]
            new_db, update, used[name] = builder.build(
                self.me, self.als(name), self.pair.ps[name], prev,
                dirty_prefixes=(dirty or {}).get(name, frozenset()),
                force_full=force_full,
            )
            assert builder.last_error is None
            fold = apply_route_delta if name == "port" else j_apply_route_delta
            assert_db_equal(new_db, fold(prev, update))
            self.db[name] = new_db
        assert used["port"] == used["jax"]
        assert canon(self.db["port"].unicast_entries) == canon(
            self.db["jax"].unicast_entries
        )
        assert canon(self.db["port"].mpls_entries) == canon(
            self.db["jax"].mpls_entries
        )
        for count in ("delta_builds", "full_builds"):
            assert getattr(self.builders["port"], count) == getattr(
                self.builders["jax"], count
            )
        oracle = SpfSolver(self.me, **{
            k: v for k, v in self.solver_kwargs.items()
            if k not in ("warm_start", "apsp_max_nodes",
                         "apsp_audit_interval")
        }).build_route_db(self.me, self.als("port"), self.pair.ps["port"])
        assert_db_equal(oracle, self.db["port"])
        return used["port"]

    @property
    def port_builder(self):
        return self.builders["port"]


def random_weight_steps(h, links, seed, n_events):
    rng = random.Random(seed)
    applied = 0
    for _ in range(n_events):
        before = h.pair.version
        h.pair.random_event(rng, links)
        if h.pair.version == before:
            continue
        h.step()
        applied += 1
    assert applied > 0


@pytest.mark.parametrize("seed", [5, 23])
def test_grid_random_sequences(seed):
    h = DeltaHarness(grid_edges(4), "g0_0", {
        "g3_3": [PFXS[0]], "g0_3": [PFXS[1]], "g2_1": [PFXS[2]],
        "g1_2": [PFXS[3]],
    })
    random_weight_steps(h, list(grid_edges(4)), seed, 14)
    # the sequences mix qualifying and disqualifying events: both paths
    # must have served
    assert h.port_builder.delta_builds > 0
    assert h.port_builder.full_builds > 1


def test_clos_random_sequence():
    edges = fabric_edges(pods=2, planes=2, ssw_per_plane=2, fsw_per_pod=2,
                         rsw_per_pod=3)
    h = DeltaHarness(edges, "rsw0_0",
                     {"rsw1_2": [PFXS[0]], "rsw0_2": [PFXS[1]]})
    random_weight_steps(h, list(edges), 17, 10)
    assert h.port_builder.delta_builds > 0


def test_edge_list_events_ride_the_delta_path():
    star = [("hub", f"leaf{i:04d}", 1 + i % 5) for i in range(1100)]
    h = DeltaHarness(star, "leaf0000",
                     {"leaf0009": [PFXS[0]], "leaf0011": [PFXS[1]]})
    assert h.solve.graph.sell is None
    h.pair.set_adj("hub", "leaf0009", metric=8)
    assert h.step() is True
    h.pair.set_adj("hub", "leaf0011", is_overloaded=True)
    assert h.step() is True
    assert IpPrefix(PFXS[1]) not in h.db["port"].unicast_entries
    h.pair.set_node("leaf0011", is_overloaded=True)  # edge-list: cold
    assert h.step() is False


def test_batched_events_accumulate_columns():
    # several qualifying events between rebuilds: the accumulated
    # changed-column set must describe the union
    h = DeltaHarness(grid_edges(4), "g0_0",
                     {"g3_3": [PFXS[0]], "g0_3": [PFXS[1]]})
    h.pair.set_adj("g3_2", "g3_3", metric=7)
    for name in ("jax", "port"):  # solve event 1: the delta pends
        h.pair.solvers[name].poll_device_delta(h.als(name))
    h.pair.set_adj("g2_3", "g3_3", metric=7)
    h.pair.set_adj("g0_2", "g0_3", metric=5)
    assert h.step() is True
    assert h.port_builder.delta_builds == 1


def test_increase_then_decrease_same_link():
    h = DeltaHarness(
        [("a", "b", 1), ("b", "c", 1), ("c", "d", 1), ("a", "d", 9)],
        "a", {"d": [PFXS[0]], "c": [PFXS[1]]},
    )
    used = []
    for metric in (8, 1):  # invalidation pass, then warm decrease
        h.pair.set_adj("b", "c", metric=metric)
        used.append(h.step())
    assert used == [True, True]


def test_partition_flap_and_heal_deletes_and_restores():
    edges = [
        ("a", "b", 1), ("b", "c", 1), ("c", "a", 1),
        ("c", "x", 2),  # bridge
        ("x", "y", 1), ("y", "z", 1), ("z", "x", 1),
    ]
    h = DeltaHarness(edges, "a", {"z": [PFXS[0]], "b": [PFXS[1]]})
    far = IpPrefix(PFXS[0])
    assert far in h.db["port"].unicast_entries
    for down in (True, False):
        h.pair.set_adj("c", "x", is_overloaded=down)
        h.pair.set_adj("x", "c", is_overloaded=down)
        assert h.step() is True  # a remote flap rides the delta path
        assert (far in h.db["port"].unicast_entries) != down
        assert IpPrefix(PFXS[1]) in h.db["port"].unicast_entries


def test_node_overload_toggle_takes_full_path():
    # a transit-mask change cannot be described by changed D columns
    h = DeltaHarness(grid_edges(3), "g0_0",
                     {"g2_2": [PFXS[0]], "g0_2": [PFXS[1]]})
    for overloaded in (True, False):
        h.pair.set_node("g1_1", is_overloaded=overloaded)
        assert h.step() is False
    assert h.port_builder.delta_builds == 0


def test_event_incident_to_me_takes_full_path():
    # my own out-link metric is a route input no distance column reflects
    h = DeltaHarness(grid_edges(3), "g0_0", {"g2_2": [PFXS[0]]})
    h.pair.set_adj("g0_0", "g0_1", metric=4)
    assert h.step() is False


def test_patch_slots_overflow_takes_full_path(monkeypatch):
    import openr_tpu.solver.tpu as jtpu
    import openr_tpu_torch.solver.cuda as tcuda

    monkeypatch.setattr(jtpu, "_PATCH_SLOTS", 0)
    monkeypatch.setattr(tcuda, "_PATCH_SLOTS", 0)
    h = DeltaHarness([("a", "b", 1), ("b", "c", 1), ("c", "d", 1)], "a",
                     {"d": [PFXS[0]]})
    h.pair.set_adj("b", "c", metric=6)  # overflows the 0-slot budget
    assert h.step() is False
    assert h.port_builder.delta_builds == 0


def test_prefix_advertisement_change_rides_dirty_set():
    # a prefix event with no topology change: the dirty prefixes come in
    # explicitly, no solve delta pends, and the partial path serves it
    h = DeltaHarness(grid_edges(3), "g0_0", {"g2_2": [PFXS[0]]})
    from openr_tpu import types as jtypes

    def advertise(pfxs):
        return {
            "jax": h.pair.ps["jax"].update_prefix_database(
                jtypes.PrefixDatabase(
                    "g0_2", [jtypes.PrefixEntry(jtypes.IpPrefix(p))
                             for p in pfxs], area="0")),
            "port": h.pair.ps["port"].update_prefix_database(
                PrefixDatabase("g0_2", [PrefixEntry(IpPrefix(p))
                                        for p in pfxs], area="0")),
        }

    dirty = advertise([PFXS[1]])
    assert dirty["port"]
    assert h.step(dirty=dirty) is True
    assert IpPrefix(PFXS[1]) in h.db["port"].unicast_entries
    assert h.step(dirty=advertise([])) is True  # withdrawal deletes
    assert IpPrefix(PFXS[1]) not in h.db["port"].unicast_entries


def test_force_full_drains_pending_delta():
    h = DeltaHarness(grid_edges(3), "g0_0", {"g2_2": [PFXS[0]]})
    h.pair.set_adj("g1_2", "g2_2", metric=8)
    assert h.step(force_full=True) is False
    h.pair.set_adj("g1_2", "g2_2", metric=1)
    assert h.step() is True  # re-armed: the next event is delta-served


def test_lfa_without_apsp_keeps_force_full():
    h = DeltaHarness(grid_edges(4), "g0_0", {"g3_3": [PFXS[0]]},
                     solver_kwargs={"compute_lfa_paths": True})
    assert h.pair.solvers["port"].lfa_delta_ready() is False
    h.pair.set_adj("g3_2", "g3_3", metric=7)
    assert h.step() is False
    assert h.port_builder.delta_builds == 0


def test_single_link_warm_event_d2h_is_o_changes():
    """A warm single-link event copies back O(changes) bytes: bounded by
    the changed columns' compaction bucket, never by n_pad."""
    side = 12  # 144 nodes
    corner = f"g{side - 1}_{side - 1}"
    h = DeltaHarness(grid_edges(side), "g0_0", {corner: [PFXS[0]]})
    solve = h.solve
    s_pad, n_pad = solve.d.shape
    d2h_before = solve.d2h_bytes
    delta_bytes_before = solve.delta_bytes
    extracts_before = solve.delta_extracts
    cols_before = solve.delta_columns
    # both corner in-edges up: one leaves the other ECMP leg equal-cost,
    # the other moves exactly one column
    h.pair.set_adj(f"g{side - 2}_{side - 1}", corner, metric=9)
    h.pair.set_adj(f"g{side - 1}_{side - 2}", corner, metric=9)
    assert h.step() is True
    assert solve.delta_extracts == extracts_before + 1
    xfer = solve.d2h_bytes - d2h_before
    num = solve.delta_columns - cols_before
    cap = _next_bucket(num, minimum=8)
    l_pad = _next_bucket(max(len(solve._nh_link_arrays()[0]), 1), minimum=8)
    assert num < n_pad // 4
    assert xfer <= 4 + cap * (4 + 4 * s_pad + l_pad)
    assert xfer < s_pad * n_pad * 4 // 4
    # the event's whole copy-back is the extraction: no mirror fetch
    assert solve.delta_bytes - delta_bytes_before == xfer
    assert h.pair.solvers["port"].counters["decision.spf.delta_bytes"] == (
        h.pair.solvers["jax"].counters["decision.spf.delta_bytes"]
    )


def test_patched_mirror_matches_cold_fetch():
    h = DeltaHarness(grid_edges(6), "g0_0",
                     {"g5_5": [PFXS[0]], "g0_5": [PFXS[1]]})
    h.pair.set_adj("g4_5", "g5_5", metric=7)
    assert h.step() is True
    cold = CudaSpfSolver("g0_0", device="cpu")
    cold.build_route_db("g0_0", h.als("port"), h.pair.ps["port"])
    cold_solve = cold._solves[("0", "g0_0")][1]
    np.testing.assert_array_equal(h.solve.d, cold_solve.d)
    names, mask = h.solve.nh_mask()
    cold_names, cold_mask = cold_solve.nh_mask()
    assert names == cold_names
    np.testing.assert_array_equal(mask, cold_mask)
