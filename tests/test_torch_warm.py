"""The event-path ops of openr_tpu_torch against the JAX package's, on the CPU.

`_sell_solver_patched`, `_sell_solver_warm`, `_bf_solver_warm` and
`_delta_extract` of both packages take the same inputs: one graph compiled
by the JAX package and handed to the port, a cold fixpoint for a batch of
sources, and a seeded event (weight increases, decreases, both, none, an
overload toggle). On CPU tensors the port's wrappers run the plain versions
of K1, K2 and K4-K7. Tolerance is exact equality: min-plus on int32 gives
the same answer in any order, the mark fixpoint is boolean, and the round
counts are of the same Jacobi rounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.ops import graph as jgraph
from openr_tpu.ops import spf as jspf
from openr_tpu_torch.convert import graph_arrays, graph_from_arrays, to_device
from openr_tpu_torch.ops import _cuda
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops.graph import INF, _next_bucket
from openr_tpu_torch.topology import fabric_edges, grid_edges, wan_edges

CPU = torch.device("cpu")
PAD = tspf.PATCH_PAD
SLOTS = 64

GRAPHS = {
    "grid4": grid_edges(4),
    "grid6": grid_edges(6),
    "wan": wan_edges(100, degree=4, seed=5),
    "clos": fabric_edges(pods=2, planes=2, ssw_per_plane=2, fsw_per_pod=2,
                         rsw_per_pod=3),
    # hub in-degree past the sliced layout's cap: edge-list form only
    "star": [("hub", f"leaf{i:04d}", 1 + i % 5) for i in range(1100)],
}
EVENTS = ("increase", "decrease", "mixed", "none", "overload_on",
          "overload_off")


def t32(a):
    return torch.as_tensor(np.array(a, dtype=np.int32))


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    jg = jgraph.compile_edges(GRAPHS[request.param])
    tg = graph_from_arrays(graph_arrays(jg))
    rng = np.random.default_rng(len(request.param))
    s_real = min(12, jg.n)
    rows = rng.choice(jg.n, size=s_real, replace=False).astype(np.int32)
    # a padded batch repeats its first source, as the area solve does
    rows = np.concatenate([rows, np.full(16 - s_real, rows[0], np.int32)])
    return {"name": request.param, "jg": jg, "tg": tg, "rows": rows}


def make_event(g, kind, seed):
    """(w_old, w_new, ov_old, ov_new, changed, inc_edges) for one seeded
    event on compiled graph g; inc_edges are the increased positions plus,
    for overload_on, the newly overloaded node's live out-edges."""
    rng = np.random.default_rng(seed)
    w_old = g.w.copy()
    ov_old = g.overloaded.copy()
    w_new, ov_new = w_old.copy(), ov_old.copy()
    real = np.arange(g.e)
    if kind == "overload_off":
        node = int(rng.integers(g.n))
        ov_old[node] = True
    k = min(10, g.e)
    changed = rng.choice(real, size=k, replace=False)
    if kind == "increase":
        w_new[changed] = w_old[changed] + rng.integers(1, 9, size=k)
        w_new[changed[: k // 3]] = INF  # links down
    elif kind == "decrease":
        w_new[changed] = np.maximum(1, w_old[changed] - rng.integers(1, 5, k))
    elif kind == "mixed":
        half = k // 2
        w_new[changed[:half]] = w_old[changed[:half]] + 7
        w_new[changed[half:]] = np.maximum(1, w_old[changed[half:]] - 2)
    else:
        changed = changed[:0]
    if kind == "overload_on":
        node = int(g.dst[rng.integers(g.e)])  # a node with in-edges
        ov_new[node] = True
    changed = changed[w_new[changed] != w_old[changed]]
    inc = changed[w_new[changed] > w_old[changed]]
    newly_on = np.nonzero(ov_new & ~ov_old)[0]
    if len(newly_on):
        out = np.nonzero(np.isin(g.src[: g.e], newly_on))[0]
        inc = np.concatenate([inc, out[w_old[out] < INF]])
    return w_old, w_new, ov_old, ov_new, changed, inc


def patch_arrays(sell, positions, w, width=SLOTS, interleave=False):
    """Per-bucket (idx [B, width, 2], vals [B, width]) padded with PAD
    rows, as the area solve builds them; `interleave` puts a padding row
    before every real one."""
    nb = len(sell.nbr)
    idx = np.full((nb, width, 2), PAD, dtype=np.int32)
    vals = np.zeros((nb, width), dtype=np.int32)
    for k in range(nb):
        sel = positions[sell.edge_bucket[positions] == k]
        at = np.arange(len(sel)) * (2 if interleave else 1) + int(interleave)
        idx[k, at, 0] = sell.edge_row[sel]
        idx[k, at, 1] = sell.edge_slot[sel]
        vals[k, at] = w[sel]
    return idx, vals


def cold_d(case, w, ov):
    """Row-major cold fixpoint from the JAX package for weights w."""
    jg, rows = case["jg"], case["rows"]
    return np.asarray(
        jspf._bf_fixpoint(rows, jg.src, jg.dst, w, ov)
    )


def sell_inputs(case, kind, seed):
    jg = case["jg"]
    w_old, w_new, ov_old, ov_new, changed, inc = make_event(jg, kind, seed)
    sell = jg.sell
    wg_old = sell.patched_wg(w_old[: jg.e])
    idx, vals = patch_arrays(sell, changed, w_new,
                             interleave=kind == "mixed")
    inc_idx, _ = patch_arrays(sell, inc, w_new)
    return {
        "w_old": w_old, "w_new": w_new, "ov_old": ov_old, "ov_new": ov_new,
        "wg_old": wg_old, "idx": idx, "vals": vals, "inc_idx": inc_idx,
        "d_prev": cold_d(case, w_old, ov_old),
    }


def run_sell_warm(case, ev):
    """Both packages' _sell_solver_warm on the same inputs: (jax, port)."""
    jg, tg, rows = case["jg"], case["tg"], case["rows"]
    key = jg.sell.shape_key()
    jout = jspf._sell_solver_warm(key)(
        jnp.asarray(rows), tuple(jnp.asarray(a) for a in jg.sell.nbr),
        tuple(jnp.asarray(a) for a in ev["wg_old"]),
        jnp.asarray(ev["ov_new"]), jnp.asarray(ev["idx"]),
        jnp.asarray(ev["vals"]), jnp.asarray(ev["inc_idx"]),
        jnp.asarray(ev["d_prev"]),
    )
    st = to_device(tg, CPU)
    wgs = tuple(t32(a) for a in ev["wg_old"])
    d_prev = t32(ev["d_prev"])
    tout = tspf._sell_solver_warm(
        key, t32(rows), st["nbrs"], wgs, torch.as_tensor(ev["ov_new"]),
        t32(ev["idx"]), t32(ev["vals"]), t32(ev["inc_idx"]), d_prev,
    )
    # d_prev is read, never written
    np.testing.assert_array_equal(d_prev.numpy(), ev["d_prev"])
    return jout, tout


@pytest.mark.parametrize("kind", EVENTS)
def test_sell_solver_warm_matches_jax(graph, kind):
    if graph["jg"].sell is None:
        assert graph["tg"].sell is None
        return
    ev = sell_inputs(graph, kind, seed=7)
    (jd, jw, jr, jir, jcc, jnc), (td, tw, tr, tir, tcc, tnc) = run_sell_warm(
        graph, ev
    )
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (int(jr), int(jir)) == (tr, tir)
    np.testing.assert_array_equal(np.asarray(jcc), tcc.numpy())
    assert int(jnc) == int(tnc) == int(tcc.sum())
    # the warm fixpoint is the cold one on the patched weights
    np.testing.assert_array_equal(
        td.numpy(), cold_d(graph, ev["w_new"], ev["ov_new"])
    )
    if kind in ("decrease", "none", "overload_off"):
        assert tir == 0  # nothing seeded: the mark loop never runs
    if kind == "none":
        assert int(tnc) == 0 and tr == 1


def test_sell_invalidation_marks_on_increases(graph):
    """The increase events really invalidate: some entries are marked, and
    the mark fixpoint takes at least one round."""
    if graph["jg"].sell is None:
        return
    ev = sell_inputs(graph, "increase", seed=7)
    tg = graph["tg"]
    st = to_device(tg, CPU)
    marks, rounds = tspf._sell_invalidate(
        t32(ev["d_prev"]), st["nbrs"], tuple(t32(a) for a in ev["wg_old"]),
        t32(ev["inc_idx"]), tg.sell.zero_end, tg.sell.starts,
    )
    assert rounds >= 1 and bool(marks.any())


@pytest.mark.parametrize("kind", ["increase", "mixed", "none"])
def test_sell_solver_patched_matches_jax(graph, kind):
    jg, tg, rows = graph["jg"], graph["tg"], graph["rows"]
    if jg.sell is None:
        return
    ev = sell_inputs(graph, kind, seed=11)
    key = jg.sell.shape_key()
    jd, jw, jr = jspf._sell_solver_patched(key)(
        jnp.asarray(rows), tuple(jnp.asarray(a) for a in jg.sell.nbr),
        tuple(jnp.asarray(a) for a in ev["wg_old"]),
        jnp.asarray(ev["ov_old"]), jnp.asarray(ev["idx"]),
        jnp.asarray(ev["vals"]),
    )
    st = to_device(tg, CPU)
    wgs = tuple(t32(a) for a in ev["wg_old"])
    td, tw, tr = tspf._sell_solver_patched(
        key, t32(rows), st["nbrs"], wgs, torch.as_tensor(ev["ov_old"]),
        t32(ev["idx"]), t32(ev["vals"]),
    )
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert int(jr) == tr
    for a, b, w_in in zip(jw, tw, wgs):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert b is w_in  # patched in place
    np.testing.assert_array_equal(
        tw[0].numpy(), jg.sell.patched_wg(ev["w_new"][: jg.e])[0]
    )


@pytest.mark.parametrize("kind", ["increase", "decrease", "mixed", "none"])
def test_bf_solver_warm_matches_jax(graph, kind):
    jg, tg, rows = graph["jg"], graph["tg"], graph["rows"]
    w_old, w_new, ov_old, _, _, _ = make_event(jg, kind, seed=13)
    d_prev = cold_d(graph, w_old, ov_old)
    jd, jr, jir, jcc, jnc = jspf._bf_solver_warm(
        jnp.asarray(rows), jnp.asarray(jg.src), jnp.asarray(jg.dst),
        jnp.asarray(w_new), jnp.asarray(w_old), jnp.asarray(ov_old),
        jnp.asarray(d_prev),
    )
    td, tr, tir, tcc, tnc = tspf._bf_solver_warm(
        t32(rows), t32(tg.src), t32(tg.dst), t32(w_new), t32(w_old),
        torch.as_tensor(ov_old), t32(d_prev), t32(tspf.edge_csr(tg)),
    )
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert (int(jr), int(jir)) == (tr, tir)
    np.testing.assert_array_equal(np.asarray(jcc), tcc.numpy())
    assert int(jnc) == int(tnc)
    np.testing.assert_array_equal(td.numpy(), cold_d(graph, w_new, ov_old))
    if kind == "increase":
        assert tir >= 1


@pytest.mark.parametrize("kind", ["increase", "mixed"])
@pytest.mark.parametrize("cap_kind", ["bucket", "short"])
def test_delta_extract_matches_jax(graph, kind, cap_kind):
    jg, rows = graph["jg"], graph["rows"]
    w_old, w_new, ov_old, _, _, _ = make_event(jg, kind, seed=17)
    d_prev = cold_d(graph, w_old, ov_old)
    d = cold_d(graph, w_new, ov_old)
    col_changed = np.any(d != d_prev, axis=0)
    num = int(col_changed.sum())
    # "short" truncates to fewer columns than changed, as nonzero(size=)
    cap = _next_bucket(num, minimum=8) if cap_kind == "bucket" else 4
    # five up-links padded to eight: padding rows point at row 0 with INF
    nh_rows = np.zeros(8, dtype=np.int32)
    nh_ws = np.full(8, INF, dtype=np.int32)
    nh_rows[:5] = [1, 2, 3, 4, 5]
    nh_ws[:5] = [1, 2, 3, 1, 9]
    jout = jspf._delta_extract(
        jnp.asarray(col_changed), jnp.asarray(d), jnp.asarray(nh_rows),
        jnp.asarray(nh_ws), cap=cap,
    )
    tout = tspf._delta_extract(
        torch.as_tensor(col_changed), t32(d), t32(nh_rows), t32(nh_ws),
        cap=cap,
    )
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    cols, dcols, nh = tout
    assert cols.dtype == torch.int32 and dcols.dtype == torch.int32
    assert nh.dtype == torch.bool
    if cap_kind == "bucket":
        assert int((cols < jg.n_pad).sum()) == num


def test_delta_columns_matches_warm_outputs():
    d_prev = t32([[0, 1, 2, INF], [1, 0, 5, INF]])
    d = t32([[0, 1, 3, INF], [1, 0, 5, 7]])
    col_changed, num = tspf.delta_columns(d, d_prev)
    assert col_changed.tolist() == [False, False, True, True]
    assert int(num) == 2 and num.dtype == torch.int32


def test_patches_out_of_range_are_dropped():
    """K4's plain version drops a patch whose row or slot lies outside its
    bucket (JAX's mode="drop"), and leaves the rest of the bucket alone."""
    wg = t32([[5, 6], [7, 8], [9, 10]])
    idx = t32([[[1, 1], [PAD, 0], [3, 0], [0, 2], [2, 0]]])
    vals = t32([[40, 41, 42, 43, 44]])
    (out,) = tspf._sell_apply_patches((wg,), idx, vals)
    assert out is wg
    assert wg.tolist() == [[5, 6], [7, 40], [44, 10]]
    jw = jspf._sell_apply_patches(
        (jnp.asarray([[5, 6], [7, 8], [9, 10]], dtype=jnp.int32),),
        jnp.asarray(idx.numpy()), jnp.asarray(vals.numpy()),
    )[0]
    np.testing.assert_array_equal(np.asarray(jw), wg.numpy())


@pytest.mark.parametrize("name", ["grid4", "grid6", "wan", "clos"])
def test_patch_table_drives_k4_like_the_plain_version(name):
    """K4's host table has one row (data pointer, nk, dk, 0) per bucket, in
    bucket order; and the plain version applies an event from
    `sell_patch_arrays`, with a row and a slot out of range, as the JAX
    package does."""
    jg = jgraph.compile_edges(GRAPHS[name])
    tg = graph_from_arrays(graph_arrays(jg))
    rng = np.random.default_rng(len(name))
    changed = rng.choice(tg.e, size=min(12, tg.e), replace=False)
    w_new = tg.w.copy()
    w_new[changed] += rng.integers(1, 9, size=len(changed))
    idx, vals = tspf.sell_patch_arrays(tg.sell, changed, w_new, SLOTS)
    idx[0, -1] = [tg.sell.nbr[0].shape[0] + 3, 0]  # row out of range
    idx[-1, -1] = [0, tg.sell.nbr[-1].shape[1]]  # slot out of range
    wgs = to_device(tg, CPU)["wgs"]
    table = tspf._patch_table(wgs, CPU)
    assert table.dtype == np.int64 and table.shape == (len(wgs), 4)
    assert table.tolist() == [
        [wg.data_ptr(), *wg.shape, 0] for wg in wgs
    ]
    plain = tspf._sell_apply_patches_plain(
        tuple(wg.clone() for wg in wgs), t32(idx), t32(vals))
    want = jspf._sell_apply_patches(
        tuple(jnp.asarray(wg.numpy()) for wg in wgs), jnp.asarray(idx),
        jnp.asarray(vals))
    for got, ref in zip(plain, want):
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_k4_takes_at_most_64_buckets():
    """sell_patch.cu's table holds 64 buckets (the sliced layout has at most
    44): the wrapper patches 64 and refuses 65, on the CPU as on the
    card."""
    wgs = tuple(t32([[k, k]]) for k in range(64))
    idx = t32(np.zeros((64, 1, 2)))
    tspf._sell_apply_patches(wgs, idx, t32(np.full((64, 1), 9)))
    assert all(wg.tolist() == [[9, k]] for k, wg in enumerate(wgs))
    with pytest.raises(ValueError, match="at most 64 buckets"):
        tspf._sell_apply_patches(wgs + (t32([[0]]),),
                                 t32(np.zeros((65, 1, 2))),
                                 t32(np.zeros((65, 1))))


def test_invalidation_seed_clips_rows_below_the_pad():
    """K5's seed clips a row or slot outside the bucket into it (only rows
    at or above 1 << 29 are padding), as the reference's seeding does,
    while K4 drops such a patch: both against the JAX package."""
    jg = jgraph.compile_edges(grid_edges(3))
    tg = graph_from_arrays(graph_arrays(jg))
    rows = np.arange(8, dtype=np.int32)
    d_prev = np.asarray(jspf._bf_fixpoint(rows, jg.src, jg.dst, jg.w,
                                          jg.overloaded))
    sell = jg.sell
    nb = len(sell.nbr)
    inc = np.full((nb, 4, 2), PAD, dtype=np.int32)
    inc[:, 0] = [sell.nbr[0].shape[0] + 3, 0]  # past the bucket: clipped
    inc[:, 1] = [-2, 9]  # below and past: clipped
    st = to_device(tg, CPU)
    marks, rounds = tspf._sell_invalidate(
        t32(d_prev), st["nbrs"], st["wgs"], t32(inc), sell.zero_end,
        sell.starts,
    )
    jmarks, jrounds = jspf._sell_invalidate(
        jnp.asarray(d_prev.T), tuple(jnp.asarray(a) for a in sell.nbr),
        tuple(jnp.asarray(a) for a in sell.wg), jnp.asarray(inc),
        sell.zero_end, sell.starts, tuple(a.shape for a in sell.nbr),
    )
    np.testing.assert_array_equal(
        np.asarray(jmarks).T, tspf.marks_bool(marks, len(rows)).numpy()
    )
    assert int(jrounds) == rounds


def test_event_ops_never_launch_kernels_on_cpu(graph):
    before = [k.launches for k in _cuda.KERNELS]
    if graph["jg"].sell is not None:
        run_sell_warm(graph, sell_inputs(graph, "mixed", seed=3))
    assert [k.launches for k in _cuda.KERNELS] == before


def test_nh_rows_are_checked_on_the_host():
    """K7 reads its up-link rows unchecked on the card (checking the device
    copy would make the host wait for the card), so the rows are checked
    where they are host numpy: `check_nh_rows`, and on CPU tensors
    `_delta_extract` itself, both raising ValueError as the reference's
    bounds do not (a JAX gather clamps)."""
    tspf.check_nh_rows(np.array([0, 3, 1], dtype=np.int32), 4)
    tspf.check_nh_rows(np.zeros(0, dtype=np.int32), 4)
    for bad in ([0, 4], [-1, 2]):
        with pytest.raises(ValueError, match="nh_rows"):
            tspf.check_nh_rows(np.array(bad, dtype=np.int32), 4)
    d = t32([[0, 1, 2], [1, 0, 1]])
    cc = torch.tensor([False, True, True])
    with pytest.raises(ValueError, match="nh_rows"):
        tspf._delta_extract(cc, d, t32([1, 2]), t32([1, 1]), cap=4)
    cols, dcols, nh = tspf._delta_extract(cc, d, t32([1, 0]), t32([1, 1]),
                                          cap=4)
    jout = jspf._delta_extract(jnp.asarray(cc.numpy()), jnp.asarray(d),
                               jnp.asarray([1, 0], dtype=jnp.int32),
                               jnp.asarray([1, 1], dtype=jnp.int32), cap=4)
    for a, b in zip(jout, (cols, dcols, nh)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_a_bad_up_link_row_raises_before_the_delta_is_used(monkeypatch,
                                                          request):
    """The solver checks its up-link rows on the host before K7 runs: a row
    outside the batch raises ValueError on device="cpu" and no extraction
    is counted. The failed solve moved the resident weights but not D, so
    the next solve is cold: its route db is the JAX package's and its D
    the cold fixpoint."""
    from test_torch_event_path import Pair
    from test_torch_memory import release_memory
    from test_torch_solver import canon

    # this file keeps JAX's compiled executables between tests; the solvers
    # here compile more, handed back when the test ends
    request.addfinalizer(release_memory)
    pair = Pair(grid_edges(6), "g0_0", {"g5_5": ["10.1.0.0/16"]})
    pair.build()
    solve = pair.solve("port")
    true_rows = solve._nh_link_arrays

    def bad_rows():
        names, rows, ws, ids = true_rows()
        return names, rows[:-1] + [solve.d.shape[0]], ws, ids

    def corner_metric(metric):  # moves the corner's column
        pair.set_adj("g4_5", "g5_5", metric=metric)
        pair.set_adj("g5_4", "g5_5", metric=metric)

    monkeypatch.setattr(solve, "_nh_link_arrays", bad_rows)
    corner_metric(7)
    extracts = solve.delta_extracts
    port = pair.solvers["port"]
    with pytest.raises(ValueError, match="nh_rows"):
        port.build_route_db("g0_0", {"0": pair.ls["port"]}, pair.ps["port"])
    assert solve.delta_extracts == extracts
    monkeypatch.setattr(solve, "_nh_link_arrays", true_rows)
    corner_metric(8)
    full = solve.full_solves
    dbs = {name: solver.build_route_db("g0_0", {"0": pair.ls[name]},
                                       pair.ps[name])
           for name, solver in pair.solvers.items()}
    assert canon(dbs["port"].unicast_entries) == canon(
        dbs["jax"].unicast_entries)
    assert solve.full_solves == full + 1 and not solve.last_solve_warm
    np.testing.assert_array_equal(solve.d, solve.cold_reference_d())


def test_event_wrappers_check_inputs():
    d = t32([[0, 1], [1, 0]])
    with pytest.raises(ValueError):
        tspf.delta_columns(d, t32([[0, 1, 2]]))
    with pytest.raises(ValueError):
        tspf._delta_extract(torch.zeros(2, dtype=torch.bool), d, t32([0, 2]),
                            t32([1, 1]), cap=8)
    with pytest.raises(ValueError):
        tspf._sell_apply_patches((t32([[1]]),), t32([[[0, 0]]]),
                                 t32([[1, 2]]))
    with pytest.raises(ValueError):
        tspf._bf_warm_d0(d, torch.zeros((2, 3), dtype=torch.bool),
                         t32([0, 1]))


# -- K1's and K5's round bookkeeping on the card, modelled on the CPU -------
#
# The kernels run only on the card; what they keep between rounds (row
# stamps by round parity, the newly marked bits, the write-through of a
# skipped row) is modelled here in numpy, step for step as sell_relax.cu
# and sell_mark.cu take it, and held against the JAX package on the same
# inputs, rounds included. These tests give the JAX package many new
# shapes, so JAX's compiled executables are dropped (`released`) before
# each group of cases that shares a graph, and so its shapes, and after
# the file, which keeps this file's peak memory where it was before them.

MODEL_GRAPHS = ("grid6", "wan", "clos", "gadgets")
_released_group = [None]


@pytest.fixture
def released(request):
    from test_torch_memory import release_memory

    callspec = getattr(request.node, "callspec", None)
    group = (request.node.originalname,
             callspec.params.get("name") if callspec else None)
    if group != _released_group[0]:
        release_memory()
        _released_group[0] = group
    yield


@pytest.fixture(scope="module", autouse=True)
def released_after_the_file():
    yield
    from test_torch_memory import release_memory

    release_memory()
    _released_group[0] = None


def gadget_edges(count=6):
    """Hub h; node v_i on a heavy direct link and on a light path of i
    hops: v_i changes in round 1 and again in round i + 1."""
    edges = []
    for i in range(1, count + 1):
        prev = "h"
        for j in range(i):
            edges.append((prev, f"p{i}_{j}", 1))
            prev = f"p{i}_{j}"
        edges += [(prev, f"v{i}", 1), ("h", f"v{i}", 10 * i + 7)]
    return edges


def model_case(name):
    jg = jgraph.compile_edges(gadget_edges() if name == "gadgets"
                              else GRAPHS[name])
    rng = np.random.default_rng(len(name))
    rows = (np.full(4, jg.node_index["h"]) if name == "gadgets"
            else rng.choice(jg.n, size=min(12, jg.n), replace=False))
    return {"name": name, "jg": jg,
            "tg": graph_from_arrays(graph_arrays(jg)),
            "rows": rows.astype(np.int32)}


def k1_model(d0, sources, ov, nbrs, wgs, starts, cold, write_through=True):
    """sell_relax.cu's fixpoint: round t reads buffer (t - 1) & 1, gathers
    only from tails stamped t in stamps[(t - 1) & 1] (every slot in a warm
    round 1; a cold start stamps the source rows 1), writes a row that went
    down or was stamped t itself, and stamps it t + 1; done when a round
    moves nothing, or at n rounds. (dest-major D, rounds). The kernel's
    first pass lists exactly the rows this model can write: a taken slot
    or the row's own stamp t."""
    n, s = d0.shape
    bufs = [d0.copy(), d0.copy()]
    stamps = np.zeros((2, n), dtype=np.int64)
    if cold:
        stamps[0, sources] = 1
    allow = ~ov[:, None] | (np.arange(n)[:, None] == sources[None, :])
    for t in range(1, n + 1):
        full = t == 1 and not cold
        d_old, d_new = bufs[(t - 1) & 1], bufs[t & 1]
        cp, cq = stamps[(t - 1) & 1], stamps[t & 1]
        dt = np.where(allow, d_old, INF)
        moved_any = False
        for bs, nb, wg in zip(starts, nbrs, wgs):
            rows = bs + np.arange(nb.shape[0])
            take = np.ones(nb.shape, bool) if full else cp[nb] == t
            cand = np.minimum(dt[nb] + wg[:, :, None], INF)
            cand = np.where(take[:, :, None], cand, INF).min(axis=1,
                                                             initial=INF)
            new = np.minimum(d_old[rows], cand)
            moved = (new < d_old[rows]).any(axis=1)
            write = moved | (write_through and not full) & (cp[rows] == t)
            d_new[rows[write]] = new[write]
            cq[rows[moved]] = t + 1
            moved_any |= bool(moved.any())
        if not moved_any:
            return bufs[t & 1], t
    return bufs[n & 1], n


def k5_model(dp, seeds, nbrs, wgs, starts):
    """sell_mark.cu's fixpoint from round 0's marks (row-major [S, n]):
    round t visits the rows with a tail stamped t in F[(t - 1) & 1], tests
    only the tails' bits N[(t - 1) & 1] not yet in M, writes N[t & 1] for
    the visited rows alone, ORs into M in place and stamps a row that grew
    t + 1; done when a round marks nothing, or at n rounds. (marks,
    rounds)"""
    s, n = dp.shape
    m = seeds.copy()
    new = [seeds.copy(), np.zeros_like(seeds)]
    f = np.zeros((2, n), dtype=np.int64)
    f[0, seeds.any(axis=0)] = 1
    if not seeds.any():
        return m, 0
    for t in range(1, n + 1):
        np_, nq = new[(t - 1) & 1], new[t & 1]
        fp, fq = f[(t - 1) & 1], f[t & 1]
        grew_any = False
        for bs, nb, wg in zip(starts, nbrs, wgs):
            rows = bs + np.arange(nb.shape[0])
            front = fp[nb] == t  # [nk, dk]
            visit = front.any(axis=1)
            dv = dp[:, rows]
            on_dag = (np.minimum(dp[:, nb] + wg[None], INF)
                      == dv[:, :, None]) & (dv < INF)[:, :, None]
            add = (np_[:, nb] & front[None] & on_dag
                   & ~m[:, rows][:, :, None]).any(axis=2)
            nq[:, rows[visit]] = add[:, visit]
            m[:, rows] |= add
            grew = add.any(axis=0)
            fq[rows[grew]] = t + 1
            grew_any |= bool(grew.any())
        if not grew_any:
            return m, t
    return m, n


def jax_relax(jg, d0, rows, ov, wgs):
    sell = jg.sell
    allow = ~ov[:, None] | (np.arange(jg.n_pad)[:, None] == rows[None, :])
    jd, jr = jspf._sell_relax(
        jnp.asarray(d0), jnp.asarray(allow),
        tuple(jnp.asarray(a) for a in sell.nbr),
        tuple(jnp.asarray(a) for a in wgs), sell.zero_end, sell.starts,
        tuple(a.shape for a in sell.nbr))
    return np.asarray(jd), int(jr)


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("name", MODEL_GRAPHS)
@pytest.mark.usefixtures("released")
def test_k1_round_bookkeeping_matches_jax(name, start):
    """K1's skipped slots, parity stamps and write-through give the JAX
    package's `_sell_relax` D and rounds, from a cold start and from an
    event's repaired state (a warm round 1 over every slot)."""
    case = model_case(name)
    jg, rows = case["jg"], case["rows"]
    sell = jg.sell
    if start == "cold":
        d0 = np.full((jg.n_pad, len(rows)), INF, dtype=np.int32)
        d0[rows, np.arange(len(rows))] = 0
        wgs = sell.wg
    else:
        ev = sell_inputs(case, "mixed", seed=5)
        marks = tspf._sell_invalidate(
            t32(ev["d_prev"]), tuple(t32(a) for a in sell.nbr),
            tuple(t32(a) for a in ev["wg_old"]), t32(ev["inc_idx"]),
            sell.zero_end, sell.starts)[0]
        d0 = tspf._sell_warm_d0(t32(ev["d_prev"]), marks,
                                t32(rows)).numpy()
        wgs = sell.patched_wg(ev["w_new"][: jg.e])
    jd, jr = jax_relax(jg, d0, rows, jg.overloaded, wgs)
    md, mr = k1_model(d0.copy(), rows, jg.overloaded, sell.nbr, wgs,
                      sell.starts, cold=start == "cold")
    np.testing.assert_array_equal(md, jd)
    assert mr == jr


@pytest.mark.usefixtures("released")
def test_k1_write_through_is_what_the_gadgets_need():
    """Without the write-through of a row that changed in the previous
    round, the gadget graph's fixpoint comes out wrong: the case above
    exercises the two-buffer trap."""
    case = model_case("gadgets")
    jg, rows = case["jg"], case["rows"]
    d0 = np.full((jg.n_pad, len(rows)), INF, dtype=np.int32)
    d0[rows, np.arange(len(rows))] = 0
    jd, _ = jax_relax(jg, d0, rows, jg.overloaded, jg.sell.wg)
    md, _ = k1_model(d0.copy(), rows, jg.overloaded, jg.sell.nbr,
                     jg.sell.wg, jg.sell.starts, cold=True,
                     write_through=False)
    assert not np.array_equal(md, jd)


@pytest.mark.parametrize("kind", ["increase", "mixed", "overload_on"])
@pytest.mark.parametrize("name", MODEL_GRAPHS)
@pytest.mark.usefixtures("released")
def test_k5_frontier_bookkeeping_matches_jax(name, kind):
    """K5's frontier rounds (tails stamped in the previous round, their new
    bits only) give the JAX package's `_sell_invalidate` marks and
    rounds."""
    case = model_case(name)
    jg = case["jg"]
    sell = jg.sell
    ev = sell_inputs(case, kind, seed=7)
    seeds = tspf._sell_seed_plain(
        t32(ev["d_prev"]), tuple(t32(a) for a in sell.nbr),
        tuple(t32(a) for a in ev["wg_old"]), t32(ev["inc_idx"]),
        sell.starts).numpy()
    jmarks, jrounds = jspf._sell_invalidate(
        jnp.asarray(ev["d_prev"].T), tuple(jnp.asarray(a) for a in sell.nbr),
        tuple(jnp.asarray(a) for a in ev["wg_old"]),
        jnp.asarray(ev["inc_idx"]), sell.zero_end, sell.starts,
        tuple(a.shape for a in sell.nbr))
    m, r = k5_model(ev["d_prev"], seeds, sell.nbr, ev["wg_old"],
                    sell.starts)
    np.testing.assert_array_equal(m, np.asarray(jmarks).T)
    assert r == int(jrounds)


@functools.lru_cache(maxsize=None)
def wan_increase_marks():
    """The JAX package's marks of an increase event on the WAN case for
    128 random sources: bool [128, n_pad] row-major."""
    case = model_case("wan")
    jg = case["jg"]
    rows = np.random.default_rng(128).choice(jg.n, size=128)
    ev = sell_inputs({**case, "rows": rows.astype(np.int32)}, "increase",
                     seed=3)
    jmarks, _ = jspf._sell_invalidate(
        jnp.asarray(ev["d_prev"].T),
        tuple(jnp.asarray(a) for a in jg.sell.nbr),
        tuple(jnp.asarray(a) for a in ev["wg_old"]),
        jnp.asarray(ev["inc_idx"]), jg.sell.zero_end, jg.sell.starts,
        tuple(a.shape for a in jg.sell.nbr))
    return np.asarray(jmarks).T.copy()


@pytest.mark.parametrize("s", [1, 16, 31, 32, 33, 65, 128])
@pytest.mark.usefixtures("released")
def test_k5_bit_layout_round_trips_jax_marks(s):
    """K5's node-major bits: column c of node v is bit c % 32 of word
    c // 32 of row v; `marks_bits` packs the JAX package's marks into it
    and `marks_bool` reads them back. A column's marks depend on its
    source alone, so the first s columns of one 128-source event are
    the JAX package's marks for those s sources."""
    jmarks = wan_increase_marks()
    n_pad = jmarks.shape[1]
    marks = torch.as_tensor(jmarks[:s].copy())
    marks[s - 1, 0] = True  # the last column's bit: the sign bit at 32
    bits = tspf.marks_bits(marks)
    assert bits.dtype == torch.int32
    assert tuple(bits.shape) == (n_pad, (s + 31) // 32)
    word = bits[0, (s - 1) // 32].item() & 0xFFFFFFFF
    assert word >> ((s - 1) % 32) & 1
    assert torch.equal(tspf.marks_bool(bits, s), marks)
    v, c = np.nonzero(marks.numpy().T)
    for vi, ci in list(zip(v, c))[:50]:
        assert bits[vi, ci // 32].item() >> (ci % 32) & 1


def test_bucket_table_rows_and_cap():
    """K1's and K5's host table has one row (nbr pointer, wg pointer,
    start, nk, dk) per bucket, in bucket order; 64 buckets at most."""
    tg = graph_from_arrays(graph_arrays(jgraph.compile_edges(GRAPHS["clos"])))
    st = to_device(tg, CPU)
    table = tspf._bucket_table(st["nbrs"], st["wgs"], tg.sell.starts)
    assert table.dtype == np.int64 and table.shape == (len(st["nbrs"]), 5)
    assert table.tolist() == [
        [nb.data_ptr(), wg.data_ptr(), bs, *nb.shape]
        for bs, nb, wg in zip(tg.sell.starts, st["nbrs"], st["wgs"])
    ]
    many = tuple(t32([[0]]) for _ in range(65))
    with pytest.raises(ValueError, match="at most 64 buckets"):
        tspf._bucket_table(many, many, range(65))


@pytest.mark.parametrize("rounds,cap", [(0, 512), (1, 512), (8, 512),
                                        (9, 512), (31, 131072), (16, 16),
                                        (5, 4)])
def test_fixpoint_rounds_reads_the_state_once_a_chunk(rounds, cap):
    """The host side of the round protocol: rounds go out ROUND_CHUNK a
    host call, the state is read once a chunk, and the count is the device's
    (the final no-change round included), or the cap; `round_launches`
    counts the launches it makes."""
    state = torch.zeros(8, dtype=torch.int32)
    launched, reads, calls = [], [], []

    def launch(t0, count):  # a fixpoint whose round `rounds` moves nothing
        calls.append(count)
        for t in range(t0, t0 + count):
            launched.append(t)
            if state[0] == 0 and t <= rounds:
                state[1] = t
                state[0] = int(t == rounds)

    if rounds == 0:
        state[0] = 1  # round 0 marked nothing
    real_tolist = torch.Tensor.tolist

    class Counting(torch.Tensor):
        def tolist(self):
            reads.append(1)
            return real_tolist(self)

    got = tspf._fixpoint_rounds(launch, state.as_subclass(Counting), cap)
    assert got == min(rounds, cap)
    assert launched == list(range(1, len(launched) + 1))
    assert len(launched) == tspf.round_launches(min(rounds, cap), cap)
    assert len(reads) == len(calls) == -(-len(launched) // tspf.ROUND_CHUNK)


# -- K2's and K6's round bookkeeping on the card, modelled on the CPU -------
#
# bf_relax.cu and bf_mark.cu keep K1's and K5's round protocol on the
# edge-list layout: a round's first pass lists, a thread an edge, the heads
# of the edges whose tail carries the round's stamp (and, for K2, the rows
# stamped themselves), each into the list of its slot split; the second
# pass splits a listed row's in-edges over P lanes. The models below take
# those steps in numpy, lane by lane, and are held against the JAX package
# on the model graphs and the star, whose hub has 1,100 in-edges (past the
# sliced layout's cap of 1,024: 32 lanes of 35 edges).

EDGE_GRAPHS = MODEL_GRAPHS + ("star",)


def lane_split(deg):
    """sell_rounds.cuh slot_split_log2 as P: the least power of two that
    leaves a lane at most 8 of a row's deg slots, at most 32."""
    lp = 0
    while lp < 5 and (8 << lp) < deg:
        lp += 1
    return 1 << lp


def k2_model(d0, sources, ov, src, dst, w, csr, cold, write_through=True):
    """bf_relax.cu's fixpoint on dest-major d0 [n, S]: round t lists the
    heads of the edges whose tail carries stamp t in stamps[(t - 1) & 1]
    and, for the write-through, the rows stamped t themselves (every row
    with in-edges in a warm round 1); lane p of a listed row's P lanes
    takes its in-edges p, p + P, ... from tails stamped t (every edge in a
    warm round 1); the lanes' minima meet, and a row is written when it
    went down or was stamped t, and stamped t + 1 when it went down. w:
    shared [E] or per column [E, S]. (D dest-major, rounds, the largest P
    a round used)"""
    n, s = d0.shape
    m = int(csr[-1])
    bufs = [d0.copy(), d0.copy()]
    stamps = np.zeros((2, n), dtype=np.int64)
    if cold:
        stamps[0, sources] = 1
    allow = ~ov[:, None] | (np.arange(n)[:, None] == sources[None, :])
    wc = w[:m] if w.ndim == 2 else w[:m, None]
    deg = np.diff(csr)
    widest = 1
    for t in range(1, n + 1):
        full = t == 1 and not cold
        d_old, d_new = bufs[(t - 1) & 1], bufs[t & 1]
        cp, cq = stamps[(t - 1) & 1], stamps[t & 1]
        listed = np.zeros(n, dtype=bool)
        if full:
            listed[deg > 0] = True
        else:
            listed[dst[:m][cp[src[:m]] == t]] = True
            if write_through:
                listed |= cp == t
        dt = np.where(allow, d_old, INF)
        moved_any = False
        for v in np.flatnonzero(listed):
            lo, hi = int(csr[v]), int(csr[v + 1])
            p_lanes = lane_split(hi - lo)
            widest = max(widest, p_lanes)
            acc = np.full(s, INF, dtype=np.int64)
            for p in range(p_lanes):
                es = np.arange(lo + p, hi, p_lanes)
                if not full:
                    es = es[cp[src[es]] == t]
                cand = np.minimum(dt[src[es]] + wc[es], INF)
                acc = np.minimum(acc, cand.min(axis=0, initial=INF))
            new = np.minimum(d_old[v], acc)
            moved = bool((new < d_old[v]).any())
            if moved or (write_through and not full and cp[v] == t):
                d_new[v] = new
            if moved:
                cq[v] = t + 1
                moved_any = True
        if not moved_any:
            return bufs[t & 1], t, widest
    return bufs[n & 1], n, widest


def k6_model(dp, seeds, src, dst, w_old, csr):
    """bf_mark.cu's fixpoint from round 0's marks (row-major bool [S, n]):
    round t lists the heads of the edges whose tail carries stamp t in
    F[(t - 1) & 1], tests a listed row's in-edges from those tails alone
    and only the tails' bits N[(t - 1) & 1] the row lacks, writes N[t & 1]
    for the listed rows, ORs into M in place and stamps a row that grew
    t + 1; done when a round marks nothing, or at n rounds. (marks,
    rounds)"""
    s, n = dp.shape
    m = int(csr[-1])
    src_m, dst_m = src[:m], dst[:m]
    dv = dp[:, dst_m]
    on_old = (np.minimum(dp[:, src_m] + w_old[:m], INF) == dv) & (dv < INF)
    marks = seeds.copy()
    new = [seeds.copy(), np.zeros_like(seeds)]
    f = np.zeros((2, n), dtype=np.int64)
    f[0, seeds.any(axis=0)] = 1
    if not seeds.any():
        return marks, 0
    for t in range(1, n + 1):
        np_, nq = new[(t - 1) & 1], new[t & 1]
        fp, fq = f[(t - 1) & 1], f[t & 1]
        front = np.flatnonzero(fp[src_m] == t)
        listed = np.unique(dst_m[front])
        add = np.zeros((s, n), dtype=np.int64)
        hit = (np_[:, src_m[front]] & on_old[:, front]
               & ~marks[:, dst_m[front]])
        np.add.at(add.T, dst_m[front], hit.T.astype(np.int64))
        add = add > 0
        nq[:, listed] = add[:, listed]
        marks |= add
        grew = add.any(axis=0)
        fq[grew] = t + 1
        if not grew.any():
            return marks, t
    return marks, n


jax_bf_relax = jax.jit(jspf._bf_relax)


def edge_case(name, weights, seed=5):
    """(case, w_rows [1 or S, e_pad], csr) for the K2 and K6 models: the
    graph's weights, or per row random metrics with a tenth of the real
    edges at INF (a KSP-like row each), padding INF."""
    case = model_case(name)
    jg = case["jg"]
    if weights == "shared":
        w_rows = jg.w[None, :].copy()
    else:
        rng = np.random.default_rng(seed)
        w_rows = rng.integers(1, 30, size=(len(case["rows"]), jg.e_pad))
        w_rows = w_rows.astype(np.int32)
        w_rows[rng.random(w_rows.shape) < 0.1] = INF
        w_rows[:, jg.e:] = INF
    return case, w_rows, tspf.edge_csr(case["tg"])


@pytest.mark.parametrize("weights", ["shared", "per_row"])
@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("name", EDGE_GRAPHS)
@pytest.mark.usefixtures("released")
def test_k2_round_bookkeeping_matches_jax(name, start, weights):
    """K2's dest-major rounds (the lists of the heads of stamped tails, the
    write-through, the lane split) give the JAX package's `_bf_relax` D
    and rounds, from a cold start and from an event's repaired state (a
    warm round 1 over every edge), with shared and per-row weights."""
    case, w_rows, csr = edge_case(name, weights)
    jg, rows = case["jg"], case["rows"]
    s = len(rows)
    if start == "cold":
        d0 = np.full((s, jg.n_pad), INF, dtype=np.int32)
        d0[np.arange(s), rows] = 0
    else:
        w_old, _, ov_old, _, _, _ = make_event(jg, "mixed", seed=5)
        w_base = w_rows.copy()
        w_base[:, : jg.e] = w_old[: jg.e]
        d_prev = np.asarray(jspf._bf_fixpoint_vw(
            rows, jg.src, jg.dst, w_base, ov_old))
        args = (t32(jg.src), t32(jg.dst))
        w_new = w_rows[0] if weights == "shared" else w_rows
        marks, _ = tspf._bf_invalidate(t32(d_prev), *args, t32(w_new),
                                       t32(w_old), t32(csr))
        d0 = tspf._bf_warm_d0(t32(d_prev), marks,
                              t32(rows)).t().contiguous().numpy()
    allow = np.asarray(jspf._bf_allow(rows, jg.overloaded))
    jd, jr = jax_bf_relax(d0, allow, jg.src, jg.dst, w_rows)
    md, mr, widest = k2_model(
        d0.T.copy(), rows, jg.overloaded, jg.src, jg.dst,
        w_rows[0] if weights == "shared" else w_rows.T.copy(), csr,
        cold=start == "cold")
    np.testing.assert_array_equal(md.T, np.asarray(jd))
    assert mr == int(jr)
    if name == "star":
        assert widest == 32  # the hub's 1,100 in-edges over 32 lanes


@pytest.mark.usefixtures("released")
def test_k2_write_through_is_what_the_gadgets_need():
    """Without the write-through of a row that changed in the previous
    round, K2's model of the gadget graph comes out wrong: the case above
    exercises the two-buffer trap on the edge-list layout too."""
    case, w_rows, csr = edge_case("gadgets", "shared")
    jg, rows = case["jg"], case["rows"]
    d0 = np.full((jg.n_pad, len(rows)), INF, dtype=np.int32)
    d0[rows, np.arange(len(rows))] = 0
    allow = np.asarray(jspf._bf_allow(rows, jg.overloaded))
    jd, _ = jax_bf_relax(d0.T.copy(), allow, jg.src, jg.dst, w_rows)
    md, _, _ = k2_model(d0, rows, jg.overloaded, jg.src, jg.dst, w_rows[0],
                        csr, cold=True, write_through=False)
    assert not np.array_equal(md.T, np.asarray(jd))


@pytest.mark.parametrize("kind", ["increase", "mixed", "per_row"])
@pytest.mark.parametrize("name", EDGE_GRAPHS)
@pytest.mark.usefixtures("released")
def test_k6_frontier_bookkeeping_matches_jax(name, kind):
    """K6's frontier rounds (heads of the tails stamped in the previous
    round, those tails' new bits only) give the plain version's marks and
    rounds, and the JAX package's `_bf_warm_core` (`_bf_warm_vw_core` for
    per-row seeds) inv_rounds."""
    case = model_case(name)
    jg, rows = case["jg"], case["rows"]
    csr = tspf.edge_csr(case["tg"])
    if kind == "per_row":
        w_old, ov_old = jg.w.copy(), jg.overloaded
        rng = np.random.default_rng(9)
        w_new = np.tile(w_old, (len(rows), 1))
        for i in range(len(rows)):
            w_new[i, rng.choice(jg.e, size=min(5, jg.e), replace=False)] = INF
    else:
        w_old, w_new, ov_old, _, _, _ = make_event(jg, kind, seed=7)
    d_prev = cold_d(case, w_old, ov_old)
    args = (t32(jg.src), t32(jg.dst), t32(w_new), t32(w_old), t32(csr))
    pm, pr = tspf._bf_invalidate_plain(t32(d_prev), *args)
    m = int(csr[-1])
    dv = d_prev[:, jg.dst[:m]]
    on_old = (np.minimum(d_prev[:, jg.src[:m]] + w_old[:m], INF) == dv) & (
        dv < INF)
    raised = on_old & (w_new[..., :m] > w_old[:m])
    seeds = np.zeros(d_prev.shape, dtype=bool)
    for e in np.flatnonzero(raised.any(axis=0)):
        seeds[:, jg.dst[e]] |= raised[:, e]
    mm, mr = k6_model(d_prev, seeds, jg.src, jg.dst, w_old, csr)
    np.testing.assert_array_equal(mm, pm.numpy())
    assert mr == pr
    jargs = (jnp.asarray(rows), jnp.asarray(jg.src), jnp.asarray(jg.dst),
             jnp.asarray(w_new), jnp.asarray(w_old), jnp.asarray(ov_old),
             jnp.asarray(d_prev))
    warm = jspf._bf_solver_warm_vw if kind == "per_row" else (
        jspf._bf_solver_warm)
    assert mr == int(warm(*jargs)[2])
    bits, r = tspf._bf_invalidate(t32(d_prev), *args)
    assert r == mr and torch.equal(tspf.marks_bool(bits, len(rows)),
                                   torch.as_tensor(mm))
