"""The port's solver under a mesh against the JAX package's, row-sharded.

The counterpart of tests/test_tpu_solver_mesh.py: CudaSpfSolver(mesh=...,
device="cpu") on a mesh that names the CPU at every position, against
TpuSpfSolver(mesh=...) on the 8-device virtual CPU mesh and the port's CPU
oracle. Meshes with a graph axis of one take the batch-sharded row layout
(sources split over 'batch', layout replicated); (4, 2) and (2, 2) tile the
destination axis where it divides n_pad, as in the reference. Route dbs,
KSP2 path sets, route deltas, the resident D and every shared
decision.spf.* counter are equal, exactly.
"""

import random

import numpy as np
import pytest

import test_torch_route_delta
from openr_tpu.solver import TpuSpfSolver
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops.graph import INF, compile_graph
from openr_tpu_torch.solver import CudaSpfSolver, SpfSolver
from openr_tpu_torch.topology import fabric_edges, grid_edges
from test_torch_event_path import run_sequence
from test_torch_memory import release_memory_around_each_test  # noqa: F401
from test_torch_solver import J, T, build_ls, canon, make_ps
from test_torch_tiled import MeshPair, port_mesh

MESHES = [(4, 2), (8, 1), (2, 2)]
ROW_MESHES = [(4, 1), (8, 1)]
PFXS = ["10.1.0.0/16", "10.2.0.0/16", "10.3.0.0/16"]


def run_parity(edges, announcers, me, shape, overloaded=None, lfa=False,
               **ps_kw):
    """One route build in the port on a mesh, the reference on a mesh and
    the port's CPU oracle: equal route dbs, no host Dijkstra."""
    ann = {"0": announcers}
    port_ls = build_ls(T, edges, overloaded=overloaded)
    ps = make_ps(T, ann, **ps_kw)
    port = CudaSpfSolver(me, device="cpu", compute_lfa_paths=lfa,
                         mesh=port_mesh(shape))
    got = port.build_route_db(me, {"0": port_ls}, ps)
    oracle = SpfSolver(me, compute_lfa_paths=lfa).build_route_db(
        me, {"0": port_ls}, ps)
    assert got.unicast_entries == oracle.unicast_entries
    assert got.mpls_entries == oracle.mpls_entries
    j_ls = build_ls(J, edges, overloaded=overloaded)
    want = TpuSpfSolver(me, compute_lfa_paths=lfa, mesh=shape).build_route_db(
        me, {"0": j_ls}, make_ps(J, ann, **ps_kw))
    assert canon(got.unicast_entries) == canon(want.unicast_entries)
    assert canon(got.mpls_entries) == canon(want.mpls_entries)
    assert port.host_spf_calls == 0
    solve = port._solves[("0", me)][1]
    assert solve.mesh is port.mesh
    # D lives on the mesh: one block per batch rank (and per graph rank
    # when tiled)
    assert isinstance(solve._d_dev, tspf.Sharded)
    assert len(solve._d_dev.blocks) == shape[0]
    return port


@pytest.mark.parametrize("shape", MESHES + [(4, 1)])
def test_grid(shape):
    run_parity(grid_edges(5), {"g4_4": [PFXS[0]], "g0_4": [PFXS[1]],
                               "g2_2": [PFXS[2]]}, "g0_0", shape)


@pytest.mark.parametrize("shape", MESHES[:2])
def test_fabric_lfa(shape):
    edges = fabric_edges(4, 4, 8)
    nodes = sorted({n for a, b, _ in edges for n in (a, b)})
    run_parity(edges, {nodes[-1]: [PFXS[0]], nodes[-2]: [PFXS[1]]},
               nodes[0], shape, lfa=True)


def test_overloaded_transit():
    run_parity([("a", "b", 1), ("b", "c", 1), ("a", "c", 10)],
               {"c": [PFXS[0]]}, "a", (4, 2), overloaded={"b"})


@pytest.mark.parametrize("shape", [(4, 2), (4, 1)])
def test_ksp2(shape):
    run_parity(grid_edges(4), {"g3_3": [PFXS[0]], "g0_3": [PFXS[1]]},
               "g0_0", shape, forwarding_type="SR_MPLS",
               forwarding_algorithm="KSP2_ED_ECMP")


def test_random_graphs():
    rng = random.Random(7)
    for _ in range(6):
        n = rng.randint(5, 14)
        nodes = [f"n{i}" for i in range(n)]
        edges = [(nodes[rng.randrange(i)], nodes[i], rng.randint(1, 5))
                 for i in range(1, n)]
        for _ in range(rng.randint(1, n)):
            a, b = rng.sample(nodes, 2)
            if not any({a, b} == {x, y} for x, y, _ in edges):
                edges.append((a, b, rng.randint(1, 5)))
        overloaded = {nodes[i] for i in range(1, n) if rng.random() < 0.15}
        run_parity(edges, {nodes[i]: [PFXS[i % 3]]
                           for i in range(1, n) if i % 2},
                   nodes[0], (4, 1), overloaded=overloaded)


def test_flap_patches_sharded_buffers():
    """A metric change after the first solve patches every replica of the
    layout and solves warm on the row layout."""
    pair = MeshPair([("a", "b", 1), ("b", "c", 1), ("a", "c", 5)], "a",
                    {"c": [PFXS[0]]}, (4, 1))
    assert pair.build()._dev["kind"] == "sell"
    pair.set_adj("a", "b", metric=9)
    solve = pair.build()
    assert solve.incremental_solves == 1
    for wgs in solve._dev["wgs"].values():  # one replica per device
        assert all(w.device.type == "cpu" for w in wgs)


@pytest.mark.parametrize("shape", ROW_MESHES)
def test_grid_random_sequence(shape):
    edges = grid_edges(4)
    pair = MeshPair(edges, "g0_0", {"g3_3": [PFXS[0]], "g0_3": [PFXS[1]]},
                    shape)
    solve = run_sequence(pair, list(edges), 13, 10)
    assert solve.incremental_solves > 0
    assert len(solve._d_dev.blocks) == shape[0]


def test_clos_random_sequence():
    edges = fabric_edges(pods=2, planes=2, ssw_per_plane=2, fsw_per_pod=2,
                         rsw_per_pod=3)
    pair = MeshPair(edges, "rsw0_0", {"rsw1_2": [PFXS[0]]}, (2, 1))
    assert run_sequence(pair, list(edges), 5, 8).incremental_solves > 0


def test_increase_then_decrease_route_parity():
    pair = MeshPair([("a", "b", 1), ("b", "c", 1), ("c", "d", 1),
                     ("a", "d", 9)], "a", {"d": [PFXS[0]]}, (4, 1))
    pair.build()
    for metric in (7, 1):
        pair.set_adj("b", "c", metric=metric)
        solve = pair.build()
    assert solve.incremental_solves == 2
    assert pair.solvers["port"].counters["decision.spf.rounds_last"] >= 1


def test_star_edge_list_under_a_mesh_solves_cold():
    """A graph too wide for the sliced layout: under a mesh the edge-list
    solve is cold and row-sharded every event, rounds untracked, as in the
    reference."""
    star = [("hub", f"leaf{i:04d}", 1 + i % 5) for i in range(1100)]
    pair = MeshPair(star, "leaf0000", {"leaf0009": [PFXS[0]]}, (2, 1))
    solve = pair.build()
    assert solve.graph.sell is None and solve.rounds_last is None
    pair.set_adj("hub", "leaf0009", metric=7)
    solve = pair.build()
    assert solve.incremental_solves == 0 and solve.full_solves == 2


@pytest.mark.parametrize("shape", [(4, 2), (4, 1)])
def test_all_pairs_ksp_grid(shape):
    """KSP under a mesh: cold, row-sharded masked solves, path sets equal
    to the LinkState's."""
    ls_oracle = build_ls(T, grid_edges(4))
    ls_dev = build_ls(T, grid_edges(4))
    solver = CudaSpfSolver("g0_0", device="cpu", mesh=port_mesh(shape))
    me = "g0_0"
    dests = sorted(set(ls_oracle.node_names()) - {me})
    for k in (1, 2):
        solver._prefetch_kth_paths(ls_dev, me, dests, k)
        for dest in dests:
            assert solver._kth_paths(ls_dev, me, dest, k) == (
                ls_oracle.get_kth_paths(me, dest, k)), (dest, k)
    solve = solver._solves[("0", me)][1]
    assert solve.ksp_device_batches == 1 and solve.ksp_warm_batches == 0


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
def test_route_delta_parity(shape, monkeypatch):
    """DeltaRouteBuilder over mesh solvers in both packages: equal route
    deltas, delta and full builds, and the CPU oracle's db after every
    event."""
    monkeypatch.setattr(
        test_torch_route_delta, "Pair",
        lambda edges, me, ann, **kw: MeshPair(edges, me, ann, shape, **kw))
    edges = grid_edges(4)
    h = test_torch_route_delta.DeltaHarness(edges, "g0_0", {
        "g3_3": [PFXS[0]], "g0_3": [PFXS[1]], "g2_1": [PFXS[2]]})
    test_torch_route_delta.random_weight_steps(h, list(edges), 5, 12)
    assert h.port_builder.delta_builds > 0


def test_batched_spf_vw_meshed_matches_single_device():
    g = compile_graph(build_ls(T, grid_edges(4)))
    rows = np.arange(8, dtype=np.int32)
    w_rows = np.tile(g.w, (8, 1))
    w_rows[3, :4] = INF  # one penalized row
    single = tspf.batched_spf_vw(g, rows, w_rows, device="cpu")
    meshed = tspf.batched_spf_vw(g, rows, w_rows, mesh=port_mesh((4, 2)))
    np.testing.assert_array_equal(meshed.numpy(), single.numpy())
    assert len(meshed.blocks) == 4
