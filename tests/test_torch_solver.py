"""CudaSpfSolver route dbs against the JAX TpuSpfSolver and the CPU oracle.

The port's solver runs on the CPU here (device="cpu": its kernels' plain
PyTorch versions). Its route db must equal the port's own SpfSolver oracle
(same classes, compared with ==) and the JAX package's
TpuSpfSolver(warm_start=False) (different classes: compared in a canonical
form of sorted plain tuples with enums as values). KSP2 is not ported yet
and is left out; every other case of the reference parity set is here,
plus a link-flap and metric-change sequence through refresh().
"""

import dataclasses
import enum
import random

import pytest

from openr_tpu.lsdb import LinkState as JLinkState
from openr_tpu.lsdb import PrefixState as JPrefixState
from openr_tpu.solver import TpuSpfSolver
from openr_tpu.topology import build_adj_dbs as j_build_adj_dbs
from openr_tpu import types as jtypes
from openr_tpu_torch.lsdb import LinkState as TLinkState
from openr_tpu_torch.lsdb import PrefixState as TPrefixState
from openr_tpu_torch.solver import CudaSpfSolver, SpfSolver
from openr_tpu_torch.topology import build_adj_dbs as t_build_adj_dbs
from openr_tpu_torch import types as ttypes
from openr_tpu_torch.topology import fabric_edges, grid_edges, wan_edges

PFXS = ["10.1.0.0/16", "10.2.0.0/16", "10.3.0.0/16"]
J = (JLinkState, JPrefixState, j_build_adj_dbs, jtypes)
T = (TLinkState, TPrefixState, t_build_adj_dbs, ttypes)


def canon(x):
    """Package-independent form of a route db value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return tuple(
            (f.name, canon(getattr(x, f.name))) for f in dataclasses.fields(x)
        )
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (set, frozenset)):
        return tuple(sorted((canon(v) for v in x), key=repr))
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted(((canon(k), canon(v)) for k, v in x.items()),
                            key=repr))
    return x


def build_ls(pkg, edges, area="0", overloaded=None):
    ls_cls, _, build_adj_dbs, _ = pkg
    ls = ls_cls(area)
    for db in build_adj_dbs(edges, area=area,
                            overloaded_nodes=overloaded).values():
        ls.update_adjacency_database(db)
    return ls


def make_ps(pkg, announcers):
    """announcers: {area: {node: [prefix]}}"""
    _, ps_cls, _, types = pkg
    ps = ps_cls()
    for area, ann in announcers.items():
        for node, pfxs in ann.items():
            ps.update_prefix_database(
                types.PrefixDatabase(
                    node,
                    [types.PrefixEntry(types.IpPrefix(p)) for p in pfxs],
                    area=area,
                )
            )
    return ps


class Trio:
    """One topology held by three solvers: the port's CudaSpfSolver (CPU),
    the port's SpfSolver oracle and the JAX TpuSpfSolver."""

    def __init__(self, areas, announcers, me, overloaded=None, lfa=False):
        # areas: {area: edges}; announcers: {area: {node: [prefix]}}
        self.me = me
        pkgs = (("cuda", T), ("oracle", T), ("jax", J))
        self.ls = {
            name: {a: build_ls(pkg, e, a, overloaded) for a, e in areas.items()}
            for name, pkg in pkgs
        }
        self.ps = {name: make_ps(pkg, announcers) for name, pkg in pkgs}
        self.solvers = {
            "cuda": CudaSpfSolver(me, compute_lfa_paths=lfa, device="cpu"),
            "oracle": SpfSolver(me, compute_lfa_paths=lfa),
            "jax": TpuSpfSolver(me, compute_lfa_paths=lfa, warm_start=False),
        }

    def build(self):
        dbs = {
            name: solver.build_route_db(self.me, self.ls[name], self.ps[name])
            for name, solver in self.solvers.items()
        }
        got, oracle, jax = dbs["cuda"], dbs["oracle"], dbs["jax"]
        assert got is not None and oracle is not None and jax is not None
        assert got.unicast_entries == oracle.unicast_entries
        assert got.mpls_entries == oracle.mpls_entries
        assert canon(got.unicast_entries) == canon(jax.unicast_entries)
        assert canon(got.mpls_entries) == canon(jax.mpls_entries)
        return got

    def edit(self, area, node, other, **changes):
        for name in self.ls:
            ls = self.ls[name][area]
            db = ls.get_adjacency_databases()[node]
            adjs = [
                dataclasses.replace(a, **changes)
                if a.other_node_name == other else a
                for a in db.adjacencies
            ]
            ls.update_adjacency_database(
                dataclasses.replace(db, adjacencies=adjs)
            )


def random_sweep_case(seed):
    rng = random.Random(seed)
    n = rng.randint(5, 14)
    nodes = [f"n{i}" for i in range(n)]
    edges = [
        (nodes[rng.randrange(i)], nodes[i], rng.randint(1, 9))
        for i in range(1, n)
    ]
    for _ in range(rng.randint(0, n // 2)):
        a, b = rng.sample(nodes, 2)
        if not any({a, b} == {x, y} for x, y, _ in edges):
            edges.append((a, b, rng.randint(1, 9)))
    announcers = {rng.choice(nodes[1:]): [PFXS[i % 3]] for i in range(3)}
    overloaded = {nodes[i] for i in range(1, n) if rng.random() < 0.15}
    return dict(edges=edges, announcers=announcers, me=nodes[0],
                overloaded=overloaded)


PARITY = {
    "line": dict(edges=[("a", "b", 1), ("b", "c", 2)],
                 announcers={"b": [PFXS[0]], "c": [PFXS[1]]}, me="a"),
    "grid_ecmp": dict(
        edges=grid_edges(4),
        announcers={"g3_3": [PFXS[0]], "g0_3": [PFXS[1]], "g2_1": [PFXS[2]]},
        me="g0_0"),
    "fabric": dict(
        edges=fabric_edges(pods=2, planes=2, ssw_per_plane=2, fsw_per_pod=2,
                           rsw_per_pod=4),
        announcers={"rsw1_0": [PFXS[0]], "rsw0_3": [PFXS[1]]}, me="rsw0_0"),
    "anycast": dict(
        edges=[("a", "b", 1), ("a", "c", 1), ("b", "d", 1), ("c", "d", 1)],
        announcers={"b": [PFXS[0]], "d": [PFXS[0]]}, me="a"),
    "overloaded_announcer": dict(
        edges=[("a", "b", 1), ("a", "c", 1)],
        announcers={"b": [PFXS[0]], "c": [PFXS[0]]}, me="a",
        overloaded={"b"}),
    "overloaded_transit": dict(
        edges=[("a", "b", 1), ("b", "c", 1), ("a", "c", 10)],
        announcers={"c": [PFXS[0]]}, me="a", overloaded={"b"}),
    "lfa": dict(edges=[("a", "b", 1), ("a", "c", 2), ("c", "b", 1)],
                announcers={"b": [PFXS[0]]}, me="a", lfa=True),
    "wan_random": dict(
        edges=wan_edges(24, degree=4, seed=7),
        announcers={"w3": [PFXS[0]], "w17": [PFXS[1]], "w9": [PFXS[2]]},
        me="w0"),
    **{f"random_sweep{i}": random_sweep_case(1234 + i) for i in range(4)},
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_route_db_parity(name):
    c = PARITY[name]
    trio = Trio({"0": c["edges"]}, {"0": c["announcers"]}, c["me"],
                overloaded=c.get("overloaded"), lfa=c.get("lfa", False))
    trio.build()
    solver = trio.solvers["cuda"]
    assert solver.device_solves == 1
    assert solver.host_spf_calls == 0


def test_multi_area_parity_with_absent_node():
    # me is in area A only: area B's SPF comes from the host oracle, and
    # host_spf_calls says so
    trio = Trio(
        {"A": [("a", "b", 1)], "B": [("x", "y", 1)]},
        {"A": {"b": [PFXS[0]]}, "B": {"y": [PFXS[1]]}},
        "a",
    )
    db = trio.build()
    assert ttypes.IpPrefix(PFXS[0]) in db.unicast_entries
    assert ttypes.IpPrefix(PFXS[1]) not in db.unicast_entries
    assert trio.solvers["cuda"].host_spf_calls > 0


def test_flap_and_metric_change_through_refresh():
    edges = fabric_edges(pods=2, planes=2, ssw_per_plane=2, fsw_per_pod=2,
                         rsw_per_pod=4)
    announcers = {"rsw1_0": [PFXS[0]], "rsw1_3": [PFXS[1]],
                  "ssw1_1": [PFXS[2]]}
    trio = Trio({"0": edges}, {"0": announcers}, "rsw0_0", lfa=True)
    trio.build()
    solve = trio.solvers["cuda"]._solves[("0", "rsw0_0")][1]
    src0 = solve.graph.src
    # spine link down, both directions
    trio.edit("0", "fsw1_0", "ssw0_0", is_overloaded=True)
    trio.edit("0", "ssw0_0", "fsw1_0", is_overloaded=True)
    trio.build()
    # rack uplink metric change
    trio.edit("0", "fsw1_1", "rsw1_0", metric=5)
    trio.edit("0", "rsw1_0", "fsw1_1", metric=5)
    trio.build()
    # my own uplink down: the source batch shrinks
    trio.edit("0", "rsw0_0", "fsw0_0", is_overloaded=True)
    trio.build()
    # and back up
    trio.edit("0", "rsw0_0", "fsw0_0", is_overloaded=False)
    trio.edit("0", "fsw1_0", "ssw0_0", is_overloaded=False)
    trio.edit("0", "ssw0_0", "fsw1_0", is_overloaded=False)
    db = trio.build()
    assert len(db.unicast_entries) == 3
    solver = trio.solvers["cuda"]
    assert solver.device_solves == 5
    assert solve.graph.src is src0  # weight patches only: no rebuild
    assert solver.counters["decision.spf.full_solves"] == 5
    assert solver.host_spf_calls == 0


def test_ksp_is_not_ported_yet():
    solver = CudaSpfSolver("a", device="cpu")
    ls = build_ls(T, [("a", "b", 1)])
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        solver._kth_paths(ls, "a", "b", 1)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        solver._prefetch_kth_paths(ls, "a", ["b"], 2)
