"""KSP's link-ignore solves of openr_tpu_torch against the JAX package's.

The port's `sell_fixpoint_masked` (cold, and warm from a base fixpoint),
its solver cores on raw mask arrays, the plain versions of K8 (bit-mask
build and warm seed) and `_bf_warm_vw_core` (K6's per-row seed, K6, K2)
take the same inputs as their JAX counterparts, and their outputs must be
equal; the masked distances must also equal the CPU oracle's link-ignore
Dijkstra (`LinkState.run_spf(me, True, ignore)`). Then KSP2 route dbs:
CudaSpfSolver (on the CPU, so through the plain versions) against the
port's oracle and the JAX TpuSpfSolver, with warm_start the same on both
sides and the decision.spf.* counters equal. Tolerance is exact equality:
min-plus on int32 does not depend on order, and marks are boolean.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.lsdb import LinkState as JLinkState
from openr_tpu.ops import graph as jgraph
from openr_tpu.ops import spf as jspf
from openr_tpu.topology import build_adj_dbs as j_build_adj_dbs
from openr_tpu_torch.lsdb import LinkState as TLinkState
from openr_tpu_torch.ops import graph as tgraph
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops.graph import INF
from openr_tpu_torch.topology import build_adj_dbs as t_build_adj_dbs
from openr_tpu_torch.topology import grid_edges, wan_edges

from test_torch_memory import release_memory_around_each_test  # noqa: F401
from test_torch_solver import PFXS, Trio, assert_spf_counters

CPU = torch.device("cpu")
KSP = dict(forwarding_type="SR_MPLS", forwarding_algorithm="KSP2_ED_ECMP")


def t32(a):
    return torch.as_tensor(np.array(a, dtype=np.int32))


def star_ring(leaves):
    """A hub with `leaves` leaves (past the sliced layout's unroll cap at
    1,100) and a ring through the leaves, so second paths exist."""
    star = [("hub", f"leaf{i:04d}", 1 + i % 5) for i in range(leaves)]
    ring = [(f"leaf{i:04d}", f"leaf{(i + 1) % leaves:04d}", 1 + i % 5)
            for i in range(leaves)]
    return star + ring


def link_states(edges, overloaded=None):
    """The same topology in both packages: (JAX LinkState, port's)."""
    out = []
    for ls_cls, build in ((JLinkState, j_build_adj_dbs),
                          (TLinkState, t_build_adj_dbs)):
        ls = ls_cls("0")
        for db in build(edges, overloaded_nodes=overloaded).values():
            ls.update_adjacency_database(db)
        out.append(ls)
    return out


def compiled_pair(edges, overloaded=None):
    """(jls, tls, jg, tg, links): both packages' compiled graphs of one
    topology (equal arrays) and the links in sorted order as (JAX link,
    port link, (fwd, rev) positions)."""
    jls, tls = link_states(edges, overloaded)
    jg, tg = jgraph.compile_graph(jls), tgraph.compile_graph(tls)
    for a in ("src", "dst", "w", "overloaded"):
        np.testing.assert_array_equal(getattr(jg, a), getattr(tg, a))
    links = []
    for jl, tl in zip(sorted(jg.link_edges), sorted(tg.link_edges)):
        assert jg.link_edges[jl] == tg.link_edges[tl]
        links.append((jl, tl, tg.link_edges[tl]))
    return jls, tls, jg, tg, links


def assert_oracle(tls, tg, d, sources, ignores):
    """Row i of d is the oracle's Dijkstra from sources[i] ignoring
    ignores[i] (a set of port links)."""
    for i, (src, ig) in enumerate(zip(sources, ignores)):
        res = tls.run_spf(tg.names[src], True, ig)
        want = np.full(tg.n_pad, INF, dtype=np.int64)
        for name, node in res.items():
            want[tg.node_index[name]] = node.metric
        np.testing.assert_array_equal(d[i].astype(np.int64), want)


def grid_case():
    rng = random.Random(9)
    jls, tls, jg, tg, links = compiled_pair(grid_edges(4))
    picks = [[], [0], [1, 5], rng.sample(range(len(links)), 4)]
    rows = np.full(len(picks), tg.node_index["g0_0"], dtype=np.int32)
    return tls, jg, tg, links, rows, picks


def wan_case(s):
    """A seeded 200-node WAN with an overloaded node; s batch rows from
    distinct sources (the overloaded node among them), row 1 masks nothing,
    the others up to five links each."""
    edges = wan_edges(200, degree=4, seed=13)
    jls, tls, jg, tg, links = compiled_pair(edges, overloaded={"w7"})
    assert tg.sell is not None and tg.overloaded[tg.node_index["w7"]]
    rng = np.random.default_rng(s)
    rows = rng.choice(tg.n, size=s, replace=s > tg.n).astype(np.int32)
    rows[0] = tg.node_index["w7"]
    picks = [
        [] if i == 1 else list(rng.choice(len(links), size=int(
            rng.integers(1, 6)), replace=False))
        for i in range(s)
    ]
    return tls, jg, tg, links, rows, picks


CASES = ["grid", "wan1", "wan3", "wan8", "wan33"]


def make_case(name):
    return grid_case() if name == "grid" else wan_case(int(name[3:]))


# -- (i) masked solves ------------------------------------------------------


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("name", CASES)
def test_sell_fixpoint_masked_matches_jax_and_oracle(name, warm):
    tls, jg, tg, links, rows, picks = make_case(name)
    positions = [[p for i in pk for p in links[i][2]] for pk in picks]
    d_prev = jd_prev = None
    if warm:
        # the UNPENALIZED base fixpoint of the same sources and weights
        base = tspf.sell_fixpoint(tg.sell, rows, tg.sell.wg, tg.overloaded,
                                  device=CPU)
        d_prev, jd_prev = base, jnp.asarray(base.numpy())
    got = tspf.sell_fixpoint_masked(
        tg.sell, rows, tg.overloaded, positions, d_prev=d_prev, device=CPU
    ).numpy()
    want = np.asarray(jspf.sell_fixpoint_masked(
        jg.sell, rows, jg.overloaded, positions, d_prev=jd_prev
    ))
    np.testing.assert_array_equal(got, want)
    assert_oracle(tls, tg, got, rows, [{links[i][1] for i in pk}
                                       for pk in picks])


def test_mask_arrays_equal_reference(monkeypatch):
    """`sell_mask_arrays` packs exactly the arrays the reference builds
    (captured from its solver call), padding included."""
    _, jg, tg, links, rows, picks = wan_case(8)
    positions = [[p for i in pk for p in links[i][2]] for pk in picks]
    seen = {}

    def capture(key, mesh=None):
        def solve(sources, nbrs, wgs, masks, overloaded):
            seen["masks"] = [np.asarray(m) for m in masks]
            return jnp.zeros((len(rows), jg.n_pad), dtype=jnp.int32)
        return solve

    monkeypatch.setattr(jspf, "_sell_solver_vw", capture)
    jspf.sell_fixpoint_masked(jg.sell, rows, jg.overloaded, positions)
    got = tspf.sell_mask_arrays(tg.sell, positions)
    assert len(got) == len(seen["masks"])
    for a, b in zip(got, seen["masks"]):
        np.testing.assert_array_equal(a, b)
    assert any((a[:, 0] == tspf.PATCH_PAD).any() for a in got)


def test_packed_masks_equal_the_reference_arrays_end_to_end(monkeypatch):
    """`sell_mask_packed` lays the reference's per-bucket arrays (captured
    from its solver call) end to end, with offsets at the reference's
    bucket boundaries; `mask_views` of one upload gives back each bucket's
    array, and K8's launch arguments read those views as one array (no
    concatenation) with one table row per bucket."""
    _, jg, tg, links, rows, picks = wan_case(8)
    positions = [[p for i in pk for p in links[i][2]] for pk in picks]
    seen = {}

    def capture(key, mesh=None):
        def solve(sources, nbrs, wgs, masks, overloaded):
            seen["masks"] = [np.asarray(m) for m in masks]
            return jnp.zeros((len(rows), jg.n_pad), dtype=jnp.int32)
        return solve

    monkeypatch.setattr(jspf, "_sell_solver_vw", capture)
    jspf.sell_fixpoint_masked(jg.sell, rows, jg.overloaded, positions)
    want = seen["masks"]
    packed, offsets = tspf.sell_mask_packed(tg.sell, positions)
    assert packed.dtype == np.int32 and packed.shape[1] == 3
    np.testing.assert_array_equal(packed, np.concatenate(want))
    np.testing.assert_array_equal(
        offsets, np.cumsum([0] + [len(m) for m in want]))
    up = torch.as_tensor(packed)
    views = tspf.mask_views(up, offsets)
    assert len(views) == len(want) == len(tg.sell.nbr)
    for v, m in zip(views, want):
        assert v.is_contiguous()
        np.testing.assert_array_equal(v.numpy(), m)
    nbrs = [t32(a) for a in tg.sell.nbr]
    wgs = [t32(a) for a in tg.sell.wg]
    entries, table, m_total = tspf._mask_launch_args(
        views, nbrs, wgs, tg.sell.starts, 2)
    assert entries.data_ptr() == up.data_ptr() and m_total == len(packed)
    words = np.cumsum([0] + [a.size * 2 for a in tg.sell.nbr])[:-1]
    for k, (nbr_k, start) in enumerate(zip(tg.sell.nbr, tg.sell.starts)):
        assert table[k, :5].tolist() == [offsets[k], *nbr_k.shape, start,
                                         words[k]]
        assert table[k, 5:7].tolist() == [nbrs[k].data_ptr(),
                                          wgs[k].data_ptr()]
    # separate tensors are concatenated into one array of the same rows
    entries, _, _ = tspf._mask_launch_args(
        [t32(m) for m in want], nbrs, wgs, tg.sell.starts, 2)
    np.testing.assert_array_equal(entries.numpy(), packed)


def raw_masks(tg, s, seed):
    """Per-bucket [Mk, 3] mask lists as the solver would send them, plus a
    padding entry, an entry out of range in the slot only and one out of
    range in the column only (dropped by the build, clipped by the seed)."""
    rng = np.random.default_rng(seed)
    sell = tg.sell
    pos = rng.choice(tg.e, size=3 * s, replace=False)
    cols = rng.integers(0, s, size=3 * s)
    masks = []
    for k, nbr_k in enumerate(sell.nbr):
        sel = sell.edge_bucket[pos] == k
        entries = np.stack([sell.edge_row[pos[sel]], sell.edge_slot[pos[sel]],
                            cols[sel]], axis=1).astype(np.int32)
        extra = np.array([
            [tspf.PATCH_PAD] * 3,
            [nbr_k.shape[0] - 1, nbr_k.shape[1] + 3, 0],
            [0, 0, s + 2],
        ], dtype=np.int32)
        masks.append(np.concatenate([entries, extra]))
    return masks


def solver_inputs(tg, rows):
    sell = tg.sell
    return (
        sell.shape_key(),
        [t32(a) for a in sell.nbr],
        [t32(a) for a in sell.wg],
        torch.as_tensor(tg.overloaded),
    )


@pytest.mark.parametrize("s", [1, 3, 33])
def test_masked_solvers_on_raw_entries(s):
    _, jg, tg, _, rows, _ = wan_case(s)
    masks = raw_masks(tg, s, seed=s)
    key, nbrs, wgs, ov = solver_inputs(tg, rows)
    tmasks = [t32(m) for m in masks]
    jmasks = tuple(jnp.asarray(m) for m in masks)
    jnbrs = tuple(jnp.asarray(a) for a in jg.sell.nbr)
    jwgs = tuple(jnp.asarray(a) for a in jg.sell.wg)
    jov = jnp.asarray(jg.overloaded)
    src = t32(rows)
    cold = tspf._sell_solver_vw(key, src, nbrs, wgs, tmasks, ov)
    jcold = jspf._sell_solver_vw(jg.sell.shape_key())(
        jnp.asarray(rows), jnbrs, jwgs, jmasks, jov)
    np.testing.assert_array_equal(cold.numpy(), np.asarray(jcold))
    base = tspf.sell_fixpoint(tg.sell, rows, tg.sell.wg, tg.overloaded,
                              device=CPU)
    warm = tspf._sell_solver_vw_warm(key, src, nbrs, wgs, tmasks, ov, base)
    jwarm = jspf._sell_solver_vw_warm(jg.sell.shape_key())(
        jnp.asarray(rows), jnbrs, jwgs, jmasks, jov, jnp.asarray(base.numpy()))
    np.testing.assert_array_equal(warm.numpy(), np.asarray(jwarm))
    np.testing.assert_array_equal(warm.numpy(), cold.numpy())


# -- (iii) the plain versions against the JAX expressions they replace ------


@pytest.mark.parametrize("s", [1, 3, 32, 33])
def test_plain_mask_build_expands_to_reference_weights(s):
    _, _, tg, _, rows, _ = wan_case(max(s, 2))
    masks = raw_masks(tg, s, seed=s + 100)
    for nbr_k, wg_k, m in zip(tg.sell.nbr, tg.sell.wg, masks):
        nk, dk = nbr_k.shape
        bits = tspf._sell_mask_bits([t32(m)], [t32(nbr_k)], s)[0]
        assert tuple(bits.shape) == (nk, dk, (s + 31) // 32)
        got = torch.where(tspf._sell_mask_expand(bits, s), INF,
                          t32(wg_k)[:, :, None])
        full = jnp.broadcast_to(jnp.asarray(wg_k)[:, :, None], (nk, dk, s))
        m_j = jnp.asarray(m)
        full = full.at[m_j[:, 0], m_j[:, 1], m_j[:, 2]].set(INF, mode="drop")
        np.testing.assert_array_equal(got.numpy(), np.asarray(full))
        assert torch.equal(
            tspf._sell_masked_wgs_plain([t32(wg_k)], [bits], s)[0], got)


@pytest.mark.parametrize("s", [1, 3, 33])
def test_plain_mask_seed_equals_reference_expression(s):
    _, _, tg, _, rows, _ = wan_case(s)
    sell = tg.sell
    masks = raw_masks(tg, s, seed=s + 200)
    # seed on the shortest-path DAG: pick masked slots from the base DAG
    base = tspf.sell_fixpoint(sell, rows, sell.wg, tg.overloaded, device=CPU)
    marks, seeded = tspf._sell_mask_seed(
        base, [t32(a) for a in sell.nbr], [t32(a) for a in sell.wg],
        [t32(m) for m in masks], sell.starts)
    dp = jnp.asarray(base.numpy()).T  # dest-major, as the reference has it
    want = jnp.zeros(dp.shape, dtype=jnp.bool_)
    for k, (nbr_k, wg_k) in enumerate(zip(sell.nbr, sell.wg)):
        nk, dk = nbr_k.shape
        m = jnp.asarray(masks[k])
        valid = m[:, 0] < (1 << 29)
        r = jnp.clip(m[:, 0], 0, nk - 1)
        j = jnp.clip(m[:, 1], 0, dk - 1)
        c = jnp.clip(m[:, 2], 0, s - 1)
        u = jnp.asarray(nbr_k)[r, j]
        w_old = jnp.asarray(wg_k)[r, j]
        v = sell.starts[k] + r
        dv = dp[v, c]
        cond = valid & (dv < INF) & (jnp.minimum(dp[u, c] + w_old, INF) == dv)
        want = want.at[v, c].max(cond)
    np.testing.assert_array_equal(marks.numpy(), np.asarray(want).T)
    assert seeded == bool(np.asarray(want).any())


def test_plain_mask_seed_clips_where_the_build_drops():
    """An entry out of range in its slot and its column: the build drops
    it, the seed clips it onto the last slot and column, and marks the
    head there when that slot lies on the column's base DAG."""
    _, _, tg, _, rows, _ = wan_case(3)
    sell = tg.sell
    base = tspf.sell_fixpoint(sell, rows, sell.wg, tg.overloaded, device=CPU)
    b = base.numpy()
    src, dst, w = tg.src[: tg.e], tg.dst[: tg.e], tg.w[: tg.e]
    on_dag = (np.minimum(b[2][src] + w, INF) == b[2][dst]) & (b[2][dst] < INF)
    last = np.array([sell.nbr[k].shape[1] - 1 for k in sell.edge_bucket])
    p = int(np.nonzero(on_dag & (sell.edge_slot == last))[0][0])
    k = int(sell.edge_bucket[p])
    masks = [np.full((1, 3), tspf.PATCH_PAD, dtype=np.int32)
             for _ in sell.nbr]
    masks[k] = np.array([[sell.edge_row[p], last[p] + 3, 5]], np.int32)
    nbrs = [t32(a) for a in sell.nbr]
    tmasks = [t32(m) for m in masks]
    marks, seeded = tspf._sell_mask_seed(
        base, nbrs, [t32(a) for a in sell.wg], tmasks, sell.starts)
    assert seeded and bool(marks[2, dst[p]]) and int(marks.sum()) == 1
    bits = tspf._sell_mask_bits(tmasks, nbrs, 3)
    assert not any(bool(b_k.any()) for b_k in bits)


# -- (ii) the edge-list warm form --------------------------------------------


@pytest.mark.parametrize("k_rows", [1, 4])
def test_bf_warm_vw_core_matches_jax_on_star_ring(k_rows):
    jls, tls, jg, tg, links = compiled_pair(star_ring(1100))
    assert tg.sell is None and jg.sell is None
    rng = np.random.default_rng(k_rows)
    me = tg.node_index["leaf0000"]
    s = k_rows
    rows = np.full(s, me, dtype=np.int32)
    w_rows = np.tile(tg.w, (s, 1))
    ignores = []
    for i in range(s):
        pick = rng.choice(len(links), size=3, replace=False)
        pick[0] = [n for n, (_, tl, _) in enumerate(links)
                   if {tl.n1, tl.n2} == {"hub", "leaf0000"}][0]
        for n in pick:
            w_rows[i, list(links[n][2])] = INF
        ignores.append({links[n][1] for n in pick})
    base = tspf.batched_spf(tg, rows, device=CPU)
    csr = t32(tspf.edge_csr(tg))
    d, rounds, inv = tspf._bf_warm_vw_core(
        t32(rows), t32(tg.src), t32(tg.dst), t32(w_rows), t32(tg.w),
        torch.as_tensor(tg.overloaded), base.clone(), csr)
    jd, jrounds, jinv = jspf._bf_solver_warm_vw(
        jnp.asarray(rows), jnp.asarray(jg.src), jnp.asarray(jg.dst),
        jnp.asarray(w_rows), jnp.asarray(jg.w), jnp.asarray(jg.overloaded),
        jnp.asarray(base.numpy()))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert (rounds, inv) == (int(jrounds), int(jinv))
    assert inv >= 1
    cold = tspf.batched_spf_vw(tg, rows, w_rows, device=CPU)
    np.testing.assert_array_equal(d.numpy(), cold.numpy())
    assert_oracle(tls, tg, d.numpy(), rows, ignores)


# -- (iv) route dbs through Trio ---------------------------------------------


def ksp_trio(edges, announcers, me, warm):
    return Trio({"0": edges}, {"0": announcers}, me, warm_start=warm,
                port_warm_start=warm, **KSP)


def check_trio(trio, warm):
    db = trio.build()
    port, ref = trio.solvers["cuda"], trio.solvers["jax"]
    assert_spf_counters(port, ref)
    assert port.host_spf_calls == 0
    solve = port._solves[("0", trio.me)][1]
    jsolve = ref._solves[("0", trio.me)][1]
    assert solve.ksp_device_batches == jsolve.ksp_device_batches >= 1
    assert solve.ksp_warm_batches == jsolve.ksp_warm_batches
    assert (solve.ksp_warm_batches > 0) == warm
    return db, solve


WARM = pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])


@WARM
def test_ksp2_parity(warm):
    trio = ksp_trio([("a", "b", 1), ("a", "c", 1), ("c", "b", 1)],
                    {"b": [PFXS[0]]}, "a", warm)
    db, _ = check_trio(trio, warm)
    assert len(db.unicast_entries) == 1


@WARM
def test_ksp2_anycast_grid_parity(warm):
    trio = ksp_trio(grid_edges(4), {
        "g3_3": [PFXS[0]],
        "g0_3": [PFXS[0], PFXS[1]],
        "g2_1": [PFXS[1], PFXS[2]],
        "g1_2": [PFXS[2]],
    }, "g0_0", warm)
    db, _ = check_trio(trio, warm)
    assert len(db.unicast_entries) == 3


@WARM
def test_ksp_warm_seeding_matches_cold_and_oracle(warm):
    trio = ksp_trio(grid_edges(4), {"g3_3": ["10.9.0.0/16"]}, "g0_0", warm)
    db, solve = check_trio(trio, warm)
    entry = next(iter(db.unicast_entries.values()))
    # shortest and second edge-disjoint paths: two first hops
    assert len(entry.nexthops) == 2
    # the counter reaches decision.spf.* at the next area solve
    trio.build()
    counters = trio.solvers["cuda"].counters
    assert counters.get("decision.spf.ksp_warm_batches", 0) == (
        solve.ksp_warm_batches)


# -- (v) further route-db cases ----------------------------------------------


@WARM
def test_ksp2_on_edge_list_star_ring(warm):
    trio = ksp_trio(star_ring(1100), {
        "leaf0003": [PFXS[0]], "leaf0550": [PFXS[1]],
        "leaf0207": [PFXS[2]], "leaf0801": [PFXS[2]],
    }, "leaf0000", warm)
    _, solve = check_trio(trio, warm)
    assert solve.graph.sell is None


@WARM
def test_ksp_cache_cleared_by_link_down(warm):
    trio = ksp_trio(wan_edges(40, degree=4, seed=21),
                    {"w17": [PFXS[0]], "w30": [PFXS[1]]}, "w0", warm)
    _, solve = check_trio(trio, warm)
    first = solve.kth_paths("w17", 1)[0]
    link = first[len(first) // 2]
    trio.edit("0", link.n1, link.n2, is_overloaded=True)
    trio.edit("0", link.n2, link.n1, is_overloaded=True)
    _, solve = check_trio(trio, warm)
    # a stale cache would still hand out the path over the down link
    assert all(link not in path for path in solve.kth_paths("w17", 1))
