"""The port's destination-tiled layout against the JAX package's.

The counterpart of tests/test_tpu_solver_tiled.py: the same inputs through
both packages on (batch, graph) meshes with a graph axis above one, the
reference's on the 8-device virtual CPU mesh of conftest.py and the port's
on a mesh that names the CPU at every position (one process drives every
rank, as the reference's one jitted shard_map does). Exact equality
throughout (min-plus on int32 does not depend on order):

  - the tiled ops: K19's, K20's and K21's plain versions against the
    reference's `_tile_seg_min`, `_tile_fold_min` and `_tile_d0_allow`;
    `_tile_solver` (D, rounds) and `_tile_solver_warm` (D, rounds,
    inv_rounds, col_changed, num_changed) on five mesh shapes, and the
    ring copies they count against the reference's halo formula;
  - the solver: CudaSpfSolver(mesh=..., device="cpu") against
    TpuSpfSolver(mesh=...) through random event sequences, overload
    toggles and a partition flap (route dbs, the resident D, the solve's
    warm/cold classification and delta stats, every shared decision.spf.*
    counter, the halo counters among them), route-db parity on random
    graphs against the reference and the CPU oracle, the halo counters, the
    tile sizes, the degrade ladder and DeltaPath on tiles.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.lsdb import LinkState as JLinkState
from openr_tpu.ops import spf as jspf
from openr_tpu.ops.graph import compile_graph as j_compile_graph
from openr_tpu.parallel import resolve_mesh as j_resolve_mesh
from openr_tpu.parallel import tile_graph as j_tile_graph
from openr_tpu.solver import TpuSpfSolver
from openr_tpu.topology import build_adj_dbs as j_build_adj_dbs
from openr_tpu_torch import convert
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops.graph import INF
from openr_tpu_torch.parallel import make_mesh
from openr_tpu_torch.solver import CudaSpfSolver, SpfSolver
from openr_tpu_torch.topology import fabric_edges, grid_edges, wan_edges
from test_torch_event_path import Pair, run_sequence
from test_torch_memory import release_memory_around_each_test  # noqa: F401
from test_torch_solver import T, build_ls, canon, make_ps

MESHES = [(1, 2), (2, 2), (1, 4), (2, 4), (1, 8)]
# the reference's tiled solver tests run these
TILED_MESHES = [(2, 4), (2, 2), (1, 2)]
PFXS = ["10.1.0.0/16", "10.2.0.0/16"]
SMALL_CLOS = dict(pods=2, planes=2, ssw_per_plane=2, fsw_per_pod=2,
                  rsw_per_pod=3)


def port_mesh(shape):
    return make_mesh([torch.device("cpu")] * (shape[0] * shape[1]), shape)


class MeshPair(Pair):
    """Pair (test_torch_event_path.py) with both solvers on a mesh of
    `shape`: the reference's on the virtual devices, the port's on the
    CPU."""

    def __init__(self, edges, me, announcers, shape, **solver_kw):
        super().__init__(edges, me, announcers, **solver_kw)
        solver_kw.setdefault("warm_start", True)
        self.solvers = {
            "jax": TpuSpfSolver(me, mesh=shape, **solver_kw),
            "port": CudaSpfSolver(me, device="cpu", mesh=port_mesh(shape),
                                  **solver_kw),
        }


# -- the tiled ops -----------------------------------------------------------


def j_graph(edges):
    ls = JLinkState("0")
    for db in j_build_adj_dbs(edges).values():
        ls.update_adjacency_database(db)
    return j_compile_graph(ls)


@pytest.fixture(scope="module")
def wan():
    """The ~100-node WAN, 8 sources, an overloaded source and transit."""
    g = j_graph(wan_edges(100, seed=2))
    rng = np.random.default_rng(0)
    rows = rng.choice(g.n, 8, replace=False).astype(np.int32)
    ov = np.array(g.overloaded)
    ov[rows[1]] = True
    ov[5] = True
    return g, rows, ov


def tiled_inputs(g, shape, rows, ov):
    b, gg = shape
    til = j_tile_graph(g, gg)
    tm = port_mesh(shape)
    ops = convert.tiling_ranks(til, tm)
    args = (convert.rank_sources(tm, rows), ops["src_l"], ops["hseg"],
            ops["hptr"], ops["w2"], ops["hcols"],
            convert.rank_replicas(tm, ov, bool))
    return til, tm, til.shape_key() + (g.n_pad,), args


@pytest.mark.parametrize("me", [0, 1, 3])
def test_tile_round_fold_and_init_equal_the_reference_expressions(wan, me):
    """K19's plain version (one round up to the frontier) against the
    reference's masked gather, clamped add and `_tile_seg_min`; K20's
    against `_tile_fold_min`; K21's tile_init against `_tile_d0_allow`'s
    d0; on partition `me` of a graph axis of 4, with the seed and mark
    masks of the warm path."""
    g, rows, ov = wan
    til = j_tile_graph(g, 4)
    n_tile, h = til.n_tile, til.h
    d0_j, allow_j = jspf._tile_d0_allow(jnp.asarray(rows), jnp.asarray(ov),
                                        me, n_tile)
    src = torch.as_tensor(rows)
    d0 = tspf.tile_init(src, me * n_tile, n_tile)
    np.testing.assert_array_equal(d0.numpy(), np.asarray(d0_j))
    rng = np.random.default_rng(me)
    d = rng.integers(0, 60, size=d0.shape).astype(np.int32)
    d[rng.random(d.shape) < 0.2] = INF
    hptr = convert.tiling_ranks(til, port_mesh((1, 4)))["hptr"][0][me]
    w_new = til.w[me].copy()
    w_new[: 40] += 3
    ov_new = ov.copy()
    ov_new[me * n_tile + 2] = True
    marks = rng.random(d.shape) < 0.3
    dt = np.where(np.asarray(allow_j), d, INF)
    cand = np.minimum(dt[:, til.src_l[me]] + til.w[me], INF)
    seed = (w_new > til.w[me]) | (ov_new & ~ov)[me * n_tile + til.src_l[me]]
    cases = [({}, cand),
             ({"w_new": torch.as_tensor(w_new),
               "ov_new": torch.as_tensor(ov_new)},
              np.where(seed[None, :], cand, INF)),
             ({"marks": torch.as_tensor(marks)},
              np.where(marks[:, til.src_l[me]], cand, INF))]
    for kw, vals in cases:
        want = np.asarray(jspf._tile_seg_min(jnp.asarray(vals),
                                             jnp.asarray(til.hseg[me]), h))
        got = tspf.tile_round(
            torch.as_tensor(d), src, torch.as_tensor(ov), me * n_tile,
            torch.as_tensor(til.src_l[me]), torch.as_tensor(til.hseg[me]),
            hptr, torch.as_tensor(til.w[me]), h, **kw)
        np.testing.assert_array_equal(got.numpy(), want)
        other = (me + 1) % 4  # a foreign frontier: only its own columns land
        for cols in (til.hcols[me], til.hcols[other]):
            base = torch.as_tensor(d)
            flag = torch.zeros(1, dtype=torch.int32)
            folded = tspf.tile_fold(base.clone(), got, torch.as_tensor(cols),
                                    me, flag)
            want_f = jspf._tile_fold_min(jnp.asarray(d), jnp.asarray(want),
                                         jnp.asarray(cols), me, n_tile)
            np.testing.assert_array_equal(folded.numpy(), np.asarray(want_f))
            assert bool(flag.item()) == bool((folded != base).any())


def test_tile_fold_with_every_slot_a_sentinel_changes_nothing():
    out = torch.full((3, 8), 7, dtype=torch.int32)
    flag = torch.zeros(1, dtype=torch.int32)
    cols = torch.full((16,), tspf.TILE_PAD, dtype=torch.int32)
    tspf.tile_fold(out, torch.zeros((3, 16), dtype=torch.int32), cols, 2,
                   flag)
    assert bool((out == 7).all()) and int(flag.item()) == 0


@pytest.mark.parametrize("ranks", [1, 2, 3])
def test_tile_col_changed_plain_rank_after_rank_equals_the_reference(ranks):
    """K21's tile_col_changed (plain) run over the batch ranks of one
    column block in turn against the reference's expressions in
    `_tile_solver_warm`: any(d != dp, 0) per rank, the pmax over 'batch'
    (under jax.vmap with that axis name) and the popcount; columns that
    differ only in the first row, only in the last, in one rank alone,
    and columns equal everywhere."""
    import jax

    s_l, n_tile = 6, 37
    rng = np.random.default_rng(ranks)
    dps = rng.integers(0, 50, (ranks, s_l, n_tile)).astype(np.int32)
    dps[rng.random(dps.shape) < 0.1] = INF
    ds = dps.copy()
    ds[0, 0, ::5] += 1
    ds[-1, s_l - 1, 2::7] -= 1
    for i in range(ranks):
        ds[i, i % s_l, rng.choice(n_tile, 3, replace=False)] = INF

    def ref(d, dp):
        cc = jnp.any(d != dp, axis=0)
        cc = jax.lax.pmax(cc.astype(jnp.int32), "batch") > 0
        return cc, jnp.sum(cc.astype(jnp.int32))

    cc_j, num_j = jax.vmap(ref, axis_name="batch")(jnp.asarray(ds),
                                                   jnp.asarray(dps))
    cc = torch.zeros(n_tile, dtype=torch.bool)
    count = torch.zeros(1, dtype=torch.int32)
    for d, dp in zip(ds, dps):
        tspf._tile_col_changed_plain(torch.as_tensor(d), torch.as_tensor(dp),
                                     cc, count)
    np.testing.assert_array_equal(cc.numpy(), np.asarray(cc_j)[0])
    assert int(count.item()) == int(np.asarray(num_j)[0])
    assert 0 < int(count.item()) < n_tile


@pytest.mark.parametrize("me", [0, 1, 2, 3])
def test_tile_init_and_reset_plain_drop_sources_outside_the_tile(me):
    """K21's tile_init and tile_reset (plain) on partition `me` of a graph
    axis of 4 against `_tile_d0_allow`'s d0 and the reference's reset in
    `_tile_solver_warm` (where(marks, INF, dp), then .at[].set(0,
    mode="drop") at each source's local column): sources inside the
    tile, just past its last column, just before its first, and far
    outside."""
    s_l, n_tile = 7, 37
    offset = me * n_tile
    rng = np.random.default_rng(me)
    sources = rng.integers(0, 4 * n_tile, s_l)
    sources[:4] = (offset + 3, offset + n_tile, max(offset - 1, 0),
                   offset + n_tile - 1)
    sources = sources.astype(np.int32)
    ov = np.zeros(4 * n_tile, dtype=bool)
    d0_j, _ = jspf._tile_d0_allow(jnp.asarray(sources), jnp.asarray(ov), me,
                                  n_tile)
    src = torch.as_tensor(sources)
    d0 = tspf._tile_init_plain(src, offset, n_tile)
    np.testing.assert_array_equal(d0.numpy(), np.asarray(d0_j))
    dp = rng.integers(0, 50, (s_l, n_tile)).astype(np.int32)
    dp[rng.random(dp.shape) < 0.1] = INF
    marks = rng.random(dp.shape) < 0.3
    marks[0, 3] = True  # a marked source column: the pin wins
    want = jnp.where(jnp.asarray(marks), INF, jnp.asarray(dp))
    local = jnp.asarray(sources) - offset
    local = jnp.where((local >= 0) & (local < n_tile), local, n_tile)
    want = want.at[jnp.arange(s_l), local].set(0, mode="drop")
    got = tspf._tile_reset_plain(torch.as_tensor(marks), torch.as_tensor(dp),
                                 src, offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pinned = int((d0 == 0).sum())
    assert pinned == int(((sources >= offset)
                          & (sources < offset + n_tile)).sum())
    assert 0 < pinned < s_l


def ascends_with_sentinels_last(hcols):
    """Each row of hcols [g, h] rises strictly up to its sentinels, which
    come last: K20's precondition."""
    hcols = np.asarray(hcols, dtype=np.int64)
    for row in hcols:
        real = row[row != tspf.TILE_PAD]
        if not (np.all(np.diff(real) > 0)
                and np.all(row[len(real):] == tspf.TILE_PAD)):
            return False
    return True


@pytest.mark.parametrize("g_axis", [2, 4, 8])
@pytest.mark.parametrize("graph", ["wan", "grid", "clos"])
def test_every_hcols_row_ascends_with_its_sentinels_last(graph, g_axis):
    """K20 folds only the stretch of a frontier's slots that a rank owns,
    which is one stretch because every partition's columns ascend: so on
    the file's graphs, in the JAX package's tiling and in the port's, and
    `convert.tiling_ranks` takes both."""
    from openr_tpu_torch.parallel import tile_graph

    edges = {"wan": wan_edges(100, seed=2), "grid": grid_edges(4),
             "clos": fabric_edges(**SMALL_CLOS)}[graph]
    jg = j_graph(edges)
    tg = convert.graph_from_arrays(convert.graph_arrays(jg))
    for til in (j_tile_graph(jg, g_axis), tile_graph(tg, g_axis)):
        assert ascends_with_sentinels_last(til.hcols)
        assert (np.asarray(til.hcols) != tspf.TILE_PAD).any()
        convert.tiling_ranks(til, port_mesh((1, g_axis)))


@pytest.mark.parametrize("fault", ["swapped", "repeated", "sentinel_first"])
def test_tiling_ranks_refuses_hcols_that_do_not_ascend(wan, fault):
    """A row out of order, a column named twice, or a sentinel before a
    real column: `convert.tiling_ranks` raises and names the row, before
    any rank gets a tensor."""
    import dataclasses

    from openr_tpu_torch.parallel import tile_graph

    g, _, _ = wan
    til = tile_graph(convert.graph_from_arrays(convert.graph_arrays(g)), 4)
    hcols = np.array(til.hcols)
    row = hcols[2]
    real = int(np.count_nonzero(row != tspf.TILE_PAD))
    assert real >= 3 and real < len(row)
    if fault == "swapped":
        row[[0, 1]] = row[[1, 0]]
    elif fault == "repeated":
        row[1] = row[0]
    else:
        row[[0, real]] = row[[real, 0]]
    assert not ascends_with_sentinels_last(hcols)
    bad = dataclasses.replace(til, hcols=hcols)
    with pytest.raises(ValueError, match="hcols row 2 does not ascend"):
        convert.tiling_ranks(bad, port_mesh((1, 4)))


@pytest.mark.parametrize("shape", MESHES)
def test_tile_solver_equals_the_reference(wan, shape):
    g, rows, ov = wan
    _, _, key, args = tiled_inputs(g, shape, rows, ov)
    til = j_tile_graph(g, shape[1])
    d, r = jspf._tile_solver(key, j_resolve_mesh(shape))(
        jnp.asarray(rows), til.src_l, til.hseg, til.w, til.hcols,
        jnp.asarray(ov))
    got, rounds, _ = tspf._tile_solver(key, port_mesh(shape), *args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(d))
    assert rounds == int(r)
    assert len(got.blocks) == shape[0] and len(got.blocks[0]) == shape[1]
    assert got.blocks[0][0].shape == (len(rows) // shape[0],
                                      g.n_pad // shape[1])


def warm_event(g, ov, kind, seed=1):
    rng = np.random.default_rng(seed)
    w_new = np.array(g.w)
    ov2 = ov.copy()
    idx = rng.choice(g.e, 10, replace=False)
    if kind in ("mixed", "increase"):
        w_new[idx[:5]] = np.minimum(w_new[idx[:5]] + 7, INF)
        w_new[idx[1]] = INF  # a link down
    if kind in ("mixed", "decrease"):
        w_new[idx[5:]] = np.maximum(w_new[idx[5:]] - 1, 1)
    if kind == "overload":
        ov2[7] = True
        ov2[5] = False
    return w_new, ov2


@pytest.mark.parametrize("kind", ["mixed", "decrease", "overload"])
@pytest.mark.parametrize("shape", MESHES)
def test_tile_solver_warm_equals_the_reference(wan, shape, kind):
    """All five outputs; a decrease-only event seeds nothing and skips the
    mark rounds (inv_rounds 0)."""
    g, rows, ov = wan
    til, tm, key, args = tiled_inputs(g, shape, rows, ov)
    jm = j_resolve_mesh(shape)
    d_prev, _ = jspf._tile_solver(key, jm)(
        jnp.asarray(rows), til.src_l, til.hseg, til.w, til.hcols,
        jnp.asarray(ov))
    d_prev = np.asarray(d_prev)
    w_new, ov2 = warm_event(g, ov, kind)
    w2n = til.tile_weights(w_new)
    jd, jr, jinv, jcc, jnum = jspf._tile_solver_warm(key, jm)(
        jnp.asarray(rows), til.src_l, til.hseg, w2n, til.w, til.hcols,
        jnp.asarray(ov2), jnp.asarray(ov), jnp.asarray(d_prev))
    src, src_l, hseg, hptr, w2, hcols, ov_r = args
    port_prev, _, _ = tspf._tile_solver(key, tm, *args)
    before = port_prev.numpy()
    d, rounds, inv, cc, num, _ = tspf._tile_solver_warm(
        key, tm, src, src_l, hseg, hptr,
        convert.rank_rows(tm, w2n, np.int32), w2, hcols,
        convert.rank_replicas(tm, ov2, bool), ov_r, port_prev)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert (rounds, inv) == (int(jr), int(jinv))
    np.testing.assert_array_equal(torch.cat(cc).numpy(), np.asarray(jcc))
    assert int(num) == int(jnum)
    np.testing.assert_array_equal(port_prev.numpy(), before)  # read only
    if kind == "decrease":
        assert inv == 0


def test_the_hops_copy_what_the_halo_counters_count(wan):
    """The ring copies a tiled solve counts where it makes them equal the
    reference's halo count (openr_tpu/solver/tpu.py `_account_halo`):
    g - 1 hops a round (the warm solve adds its seed and mark exchanges),
    and per hop every rank's frontier, ctr [S_l, h] and cols [h] int32."""
    g, rows, ov = wan
    shape = (2, 4)
    til, tm, key, args = tiled_inputs(g, shape, rows, ov)
    payload = (len(rows) // shape[0] * til.h + til.h) * 4
    d, rounds, copies = tspf._tile_solver(key, tm, *args)
    assert copies.hops == (shape[1] - 1) * rounds
    assert copies.bytes == copies.hops * shape[0] * shape[1] * payload
    w_new, ov2 = warm_event(g, ov, "mixed")
    src, src_l, hseg, hptr, w2, hcols, ov_r = args
    _, rounds, inv, _, _, copies = tspf._tile_solver_warm(
        key, tm, src, src_l, hseg, hptr,
        convert.rank_rows(tm, til.tile_weights(w_new), np.int32), w2, hcols,
        convert.rank_replicas(tm, ov2, bool), ov_r, d)
    assert inv > 0
    assert copies.hops == (shape[1] - 1) * (1 + inv + rounds)
    assert copies.bytes == copies.hops * shape[0] * shape[1] * payload


# -- the solver ---------------------------------------------------------------


@pytest.mark.parametrize("shape", TILED_MESHES)
def test_grid_random_sequences(shape):
    edges = grid_edges(4)
    pair = MeshPair(edges, "g0_0", {"g3_3": [PFXS[0]], "g0_3": [PFXS[1]]},
                    shape)
    solve = run_sequence(pair, list(edges), 23, 10)
    assert solve.incremental_solves > 0
    assert solve._dev["kind"] == "tile2d"
    # every rank holds a tile of its own
    blocks = solve._d_dev.blocks
    assert len(blocks) * len(blocks[0]) == shape[0] * shape[1]


def test_clos_random_sequence():
    edges = fabric_edges(**SMALL_CLOS)
    pair = MeshPair(edges, "rsw0_0", {"rsw1_2": [PFXS[0]]}, (2, 4))
    assert run_sequence(pair, list(edges), 5, 8).incremental_solves > 0


def test_wan_random_sequence():
    edges = wan_edges(24, seed=2)
    pair = MeshPair(edges, "w0", {"w9": [PFXS[0]]}, (2, 2))
    assert run_sequence(pair, list(edges), 9, 8).incremental_solves > 0


def test_overload_toggle_rides_warm_path():
    pair = MeshPair(grid_edges(4), "g0_0", {"g3_3": [PFXS[0]]}, (2, 2))
    pair.build()
    for node, on in (("g1_1", True), ("g2_2", True), ("g1_1", False)):
        pair.set_node(node, is_overloaded=on)
        solve = pair.build()
    assert solve.incremental_solves == 3  # every toggle stayed warm


def test_partition_flap():
    """Cut the one bridge between two grid islands, then heal it: the far
    columns read INF on the tiles and recover."""
    island = [
        (f"{p}{i}_{j}", n, 1)
        for p in "ab" for i in range(3) for j in range(3)
        for n in ([f"{p}{i + 1}_{j}"] if i < 2 else [])
        + ([f"{p}{i}_{j + 1}"] if j < 2 else [])
    ]
    pair = MeshPair(island + [("a2_2", "b0_0", 3)], "a0_0",
                    {"b2_2": [PFXS[0]]}, (2, 4))
    solve = pair.build()
    far = solve.graph.node_index["b2_2"]
    assert int(solve.d[0, far]) < INF
    for down in (True, False):
        pair.set_adj("a2_2", "b0_0", is_overloaded=down)
        solve = pair.build()
        assert (int(solve.d[0, far]) >= INF) == down
    assert solve.incremental_solves == 2


def route_parity(edges, announcers, me, shape, overloaded=None):
    """Route dbs of the port on a mesh, the reference on a mesh and the
    port's CPU oracle, equal."""
    port_ls = build_ls(T, edges, overloaded=overloaded)
    ps = make_ps(T, {"0": announcers})
    port = CudaSpfSolver(me, device="cpu", mesh=port_mesh(shape))
    got = port.build_route_db(me, {"0": port_ls}, ps)
    oracle = SpfSolver(me).build_route_db(me, {"0": port_ls}, ps)
    assert got.unicast_entries == oracle.unicast_entries
    assert got.mpls_entries == oracle.mpls_entries
    from test_torch_solver import J

    j_ls = build_ls(J, edges, overloaded=overloaded)
    want = TpuSpfSolver(me, mesh=shape).build_route_db(
        me, {"0": j_ls}, make_ps(J, {"0": announcers}))
    assert canon(got.unicast_entries) == canon(want.unicast_entries)
    assert canon(got.mpls_entries) == canon(want.mpls_entries)
    assert port.host_spf_calls == 0
    return port


def test_grid_routes():
    port = route_parity(grid_edges(5), {"g4_4": [PFXS[0]],
                                        "g0_4": [PFXS[1]]}, "g0_0", (2, 4))
    assert port._solves[("0", "g0_0")][1]._dev["kind"] == "tile2d"


def test_random_graphs():
    rng = random.Random(31)
    for _ in range(4):
        n = rng.randint(6, 13)
        nodes = [f"n{i}" for i in range(n)]
        edges = [(nodes[rng.randrange(i)], nodes[i], rng.randint(1, 5))
                 for i in range(1, n)]
        for _ in range(rng.randint(1, n)):
            a, b = rng.sample(nodes, 2)
            if not any({a, b} == {x, y} for x, y, _ in edges):
                edges.append((a, b, rng.randint(1, 5)))
        overloaded = {nodes[i] for i in range(1, n) if rng.random() < 0.15}
        route_parity(edges, {nodes[i]: [PFXS[i % 2]]
                             for i in range(1, n) if i % 2},
                     nodes[0], (2, 4), overloaded=overloaded)


def test_halo_counters_flow():
    """Tiled solves count their ring traffic, equal to the reference's:
    the exchanges of the last solve and the cumulative frontier bytes."""
    pair = MeshPair(grid_edges(4), "g0_0", {"g3_3": [PFXS[0]]}, (2, 2))
    pair.build()
    counters = pair.solvers["port"].counters
    assert counters["decision.spf.halo_exchanges_last"] > 0
    cold_bytes = counters["decision.spf.halo_bytes"]
    assert cold_bytes > 0
    pair.set_adj("g1_0", "g1_1", metric=7)
    pair.build()  # asserts every counter equal to the reference's
    assert counters["decision.spf.incremental_solves"] == 1
    assert counters["decision.spf.halo_bytes"] > cold_bytes


def test_tile_memory_is_fraction_of_replica():
    ls = build_ls(T, grid_edges(6))
    solver = CudaSpfSolver("g0_0", device="cpu", mesh=port_mesh((2, 4)))
    solve = solver._area_solve(ls, "g0_0")
    s_pad, n_pad = solve._d_dev.shape
    tiles = [t for row in solve._d_dev.blocks for t in row]
    assert len(tiles) == 8
    assert all(t.shape == (s_pad // 2, n_pad // 4) for t in tiles)


def test_degrade_mesh_cold_starts_never_silently_wrong():
    """Warm state is dropped on a mesh change (tile ownership follows the
    factorization); the next event solves cold on the smaller mesh, equal
    to the reference's degraded solver and the oracle."""
    pair = MeshPair(grid_edges(4), "g0_0", {"g3_3": [PFXS[0]]}, (2, 4))
    pair.build()
    for solver in pair.solvers.values():
        assert solver.degrade_mesh() is True
    port = pair.solvers["port"]
    assert port.counters["decision.spf.mesh_degradations"] == 1
    assert port.counters["decision.spf.mesh_devices"] == 4
    assert (port.mesh.shape["batch"], port.mesh.shape["graph"]) == (1, 4)
    assert not port._solves
    full = port.counters["decision.spf.full_solves"]
    pair.set_adj("g1_0", "g1_1", metric=5)
    pair.build()
    assert port.counters["decision.spf.full_solves"] == full + 1
    assert port.counters.get("decision.spf.incremental_solves", 0) == 0
    # down the ladder to one device, then no rung is left
    for shape in ((1, 2), (1, 1)):
        assert port.degrade_mesh() is True
        assert (port.mesh.shape["batch"], port.mesh.shape["graph"]) == shape
    assert port.degrade_mesh() is False


def test_qualifying_flap_yields_device_delta():
    """A warm event away from me gives a device delta on tiles: only the
    columns past the flap, and the patched mirror equals a cold fetch."""
    edges = [("a", "b", 1), ("b", "c", 1), ("c", "d", 1), ("d", "e", 1)]
    pair = MeshPair(edges, "a", {"e": [PFXS[0]]}, (2, 2))
    pair.build()
    solve = pair.solve("port")
    assert solve.take_route_delta() is None  # the cold solve poisons
    pair.set_adj("c", "d", metric=9)
    solve = pair.build()
    cols = solve.take_route_delta()
    assert {solve.graph.names[c] for c in cols} == {"d", "e"}
    assert solve.delta_extracts == 1 and solve.delta_bytes > 0
    np.testing.assert_array_equal(solve.d, solve.cold_reference_d())
