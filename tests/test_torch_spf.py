"""openr_tpu_torch batched SPF ops against the JAX package's, on the CPU.

Each case compiles one graph with the JAX package and hands the same arrays
to the port (convert.graph_from_arrays), so both solve identical inputs.
On CPU tensors the port's wrappers run their kernels' plain PyTorch
versions. Tolerance is exact equality everywhere: min-plus on int32 gives
the same answer in any order, and `rounds` counts the same Jacobi rounds.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.lsdb import LinkState as JLinkState
from openr_tpu.ops import graph as jgraph
from openr_tpu.ops import spf as jspf
from openr_tpu.solver import tpu as jtpu
from openr_tpu.topology import build_adj_dbs as j_build_adj_dbs
from openr_tpu_torch.convert import graph_arrays, graph_from_arrays, to_device
from openr_tpu_torch.lsdb import LinkState as TLinkState
from openr_tpu_torch.ops import _cuda
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops.graph import INF
from openr_tpu_torch.solver import cuda as tcuda
from openr_tpu_torch.topology import build_adj_dbs as t_build_adj_dbs
from openr_tpu_torch.topology import grid_edges, wan_edges

CPU = torch.device("cpu")


def random_case(seed):
    rng = random.Random(seed)
    n = rng.randint(6, 16)
    nodes = [f"n{i}" for i in range(n)]
    edges = [
        (nodes[rng.randrange(i)], nodes[i], rng.randint(1, 20))
        for i in range(1, n)
    ]
    for _ in range(rng.randint(0, n)):
        a, b = rng.sample(nodes, 2)
        if not any({a, b} == {x, y} for x, y, _ in edges):
            edges.append((a, b, rng.randint(1, 20)))
    overloaded = {nodes[i] for i in range(n) if rng.random() < 0.2}
    return edges, overloaded, nodes[0]


CASES = {
    "line": ([("a", "b", 1), ("b", "c", 2), ("c", "d", 3)], None, "a"),
    "grid": (grid_edges(4), None, "g0_0"),
    "ring": (
        [(f"r{i}", f"r{(i + 1) % 8}", (i % 3) + 1) for i in range(8)],
        None,
        "r0",
    ),
    "disconnected": ([("a", "b", 1), ("x", "y", 2)], None, "a"),
    "overloaded_transit": (
        [("a", "b", 1), ("b", "c", 1), ("a", "c", 10)], {"b"}, "a"
    ),
    "cut_vertex": ([("a", "b", 1), ("b", "c", 1)], {"b"}, "a"),
    "random0": random_case(42),
    "random1": random_case(43),
    "random2": random_case(44),
    "wan": (wan_edges(40, degree=4, seed=2), {"w5"}, "w0"),
    # hub in-degree past the reference's unroll threshold (dk > 32)
    "star_hub": (
        [("hub", f"leaf{i:03d}", 1 + i % 5) for i in range(40)],
        None,
        "leaf000",
    ),
    # hub in-degree past the sliced layout's cap: edge-list form only
    "extreme_degree": (
        [("hub", f"leaf{i:04d}", 1 + i % 3) for i in range(1100)],
        {"leaf0003"},
        "hub",
    ),
}


def build_both(edges, overloaded):
    j, t = JLinkState("0"), TLinkState("0")
    for db in j_build_adj_dbs(edges, overloaded_nodes=overloaded).values():
        j.update_adjacency_database(db)
    for db in t_build_adj_dbs(edges, overloaded_nodes=overloaded).values():
        t.update_adjacency_database(db)
    return j, t


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    edges, overloaded, me = CASES[request.param]
    j_ls, t_ls = build_both(edges, overloaded)
    jg = jgraph.compile_graph(j_ls)
    tg = graph_from_arrays(graph_arrays(jg))
    # all-pairs sources for the smaller graphs, a strided subset on the
    # 1,101-node star (keeps the JAX side's CPU solve small)
    step = 1 if jg.n_pad <= 64 else 97
    rows = np.arange(0, jg.n_pad, step, dtype=np.int32)
    return {
        "name": request.param, "j_ls": j_ls, "t_ls": t_ls, "jg": jg,
        "tg": tg, "rows": rows, "me": me,
    }


def t32(a):
    return torch.as_tensor(np.asarray(a, dtype=np.int32))


def test_sell_solver_counted_matches_jax(case):
    jg, tg, rows = case["jg"], case["tg"], case["rows"]
    if jg.sell is None:
        assert tg.sell is None
        return
    jd, jrounds = jspf._sell_solver_counted(jg.sell.shape_key())(
        jnp.asarray(rows), tuple(jg.sell.nbr), tuple(jg.sell.wg),
        jnp.asarray(jg.overloaded),
    )
    st = to_device(tg, CPU)
    td, trounds = tspf._sell_solver_counted(
        tg.sell.shape_key(), t32(rows), st["nbrs"], st["wgs"], st["ov"]
    )
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert int(jrounds) == trounds
    assert td.is_contiguous() and td.shape == (len(rows), tg.n_pad)


def test_batched_spf_matches_jax(case):
    jg, tg, rows = case["jg"], case["tg"], case["rows"]
    jd = np.asarray(jspf.batched_spf(jg, rows))
    td = tspf.batched_spf(tg, rows, device="cpu")
    np.testing.assert_array_equal(jd, td.numpy())


def test_edge_list_matches_jax(case):
    jg, tg, rows = case["jg"], case["tg"], case["rows"]
    jd = np.asarray(
        jspf._bf_fixpoint(rows, jg.src, jg.dst, jg.w, jg.overloaded)
    )
    args = (t32(tg.src), t32(tg.dst))
    ov = torch.as_tensor(tg.overloaded)
    # the in-edge ranges cover the real edges only: the padding edges the
    # reference relaxes too carry INF and change nothing
    td = tspf._bf_fixpoint(
        t32(rows), *args, t32(tg.w), ov, t32(tspf.edge_csr(tg))
    )
    np.testing.assert_array_equal(jd, td.numpy())
    # per-row weights: random metrics, INF for a random tenth of the edges
    # (links ignored per row), INF on padding
    rng = np.random.default_rng(len(rows) + tg.e)
    w_rows = rng.integers(1, 30, size=(len(rows), tg.e_pad)).astype(np.int32)
    w_rows[rng.random(w_rows.shape) < 0.1] = INF
    w_rows[:, tg.e:] = INF
    jd_vw = np.asarray(
        jspf._bf_fixpoint_vw(
            jnp.asarray(rows), jnp.asarray(jg.src), jnp.asarray(jg.dst),
            jnp.asarray(w_rows), jnp.asarray(jg.overloaded),
        )
    )
    td_vw = tspf.batched_spf_vw(tg, rows, w_rows, device="cpu")
    np.testing.assert_array_equal(jd_vw, td_vw.numpy())


def test_relax_rounds_match_between_layouts(case):
    """The edge-list fixpoint counts the same Jacobi rounds as the JAX
    sliced-ELL solve on the same batch."""
    jg, tg, rows = case["jg"], case["tg"], case["rows"]
    if jg.sell is None:
        return
    _, jrounds = jspf._sell_solver_counted(jg.sell.shape_key())(
        jnp.asarray(rows), tuple(jg.sell.nbr), tuple(jg.sell.wg),
        jnp.asarray(jg.overloaded),
    )
    src = t32(rows)
    st = to_device(tg, CPU)
    _, trounds = tspf._bf_relax(
        tspf._bf_d0(src, tg.n_pad), src, st["ov"], st["src"], st["dst"],
        st["w"][None, :], st["csr"],
    )
    assert trounds == int(jrounds)


def test_ecmp_dag_matches_jax(case):
    jg, tg = case["jg"], case["tg"]
    if jg.n_pad > 64:
        return  # all-pairs DAG only on the small graphs
    full = np.arange(jg.n_pad, dtype=np.int32)
    jd = jspf.batched_spf(jg, full)
    jdag = np.asarray(jspf.ecmp_dag(jg, jd))
    td = tspf.batched_spf(tg, full, device="cpu")
    tdag = tspf.ecmp_dag(tg, td, device="cpu")
    assert tdag.dtype == torch.bool
    np.testing.assert_array_equal(jdag, tdag.numpy())


def test_nh_mask_matches_jax(case):
    j_ls, t_ls, me = case["j_ls"], case["t_ls"], case["me"]
    ja = jtpu._AreaSolve(j_ls, me, warm_start=False)
    ta = tcuda._AreaSolve(t_ls, me, CPU)
    assert ja.sources == ta.sources
    np.testing.assert_array_equal(ja.d, ta.d)
    assert ja.rounds_last in (None, ta.rounds_last)
    j_names, j_mask = ja.nh_mask()
    t_names, t_mask = ta.nh_mask()
    assert j_names == t_names
    np.testing.assert_array_equal(j_mask, t_mask)


def test_cpu_tensors_never_launch_kernels(case):
    before = [k.launches for k in _cuda.KERNELS]
    tspf.batched_spf(case["tg"], case["rows"], device="cpu")
    assert [k.launches for k in _cuda.KERNELS] == before


def test_triangle_with_overloaded_heads():
    """K3's plain version on hand-made rows: an overloaded head is a first
    hop only toward itself, an unreachable column never is."""
    d = t32([[0, 1, 2, INF], [1, 0, 1, INF], [2, 1, 0, INF]])
    ru = t32([0, 0])
    rv = t32([1, 2])
    ve = t32([1, 2])
    w = t32([1, 2])
    ov = torch.tensor([False, True, False, False])
    out = tspf.ecmp_triangle(d, ru, rv, ve, w, ov)
    # edge 0 -> node 1 (overloaded): only toward column 1
    assert out[0].tolist() == [False, True, False, False]
    # edge 1 -> node 2 with weight 2: toward column 2 only (2 + 0 == 2)
    assert out[1].tolist() == [False, False, True, False]


@pytest.mark.parametrize("n,seed", [(37, 0), (50, 1), (21, 2), (48, 3)])
def test_triangle_plain_matches_ecmp_dag_at_odd_widths(n, seed):
    """K3's plain version against the reference's `_ecmp_dag` on the same
    seeded [n, n] matrix and edge list, sorted by head as a
    CompiledGraph's, at widths K3's 16-column groups do not divide (and
    one they do), with overloaded heads (one heading a run of edges) and
    down links (INF weights)."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 4, (n, n)).astype(np.int32)
    d[rng.random(d.shape) < 0.1] = INF
    e = 3 * n
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    w = rng.integers(0, 4, e).astype(np.int32)
    w[::7] = INF
    ov = rng.random(n) < 0.15
    ov[dst[e // 2]] = True
    want = np.asarray(jspf._ecmp_dag(
        jnp.asarray(d), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
        jnp.asarray(ov)))
    got = tspf._ecmp_triangle_plain(t32(d), t32(src), t32(dst), t32(dst),
                                    t32(w), torch.as_tensor(ov))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size
    heads = dst == dst[e // 2]
    assert not want[heads][:, np.arange(n) != dst[e // 2]].any()


def test_wrappers_check_inputs():
    d0 = torch.zeros((4, 2), dtype=torch.int32)
    src = t32([0, 1])
    ov = torch.zeros(4, dtype=torch.bool)
    nbr = t32([[1], [0]])
    with pytest.raises(ValueError):
        tspf._sell_relax(d0.t(), src, ov, (nbr,), (nbr,), 0, (0,))
    with pytest.raises(ValueError):
        tspf._sell_relax(d0, src, ov, (nbr,), (nbr.long(),), 0, (0,))
    with pytest.raises(ValueError):
        tspf._sell_relax(d0, src, ov, (nbr,), (nbr,), 0, (3,))
    with pytest.raises(ValueError):
        tspf._bf_relax(d0.t().contiguous(), src, ov, t32([0]), t32([1]),
                       t32([[1], [2], [3]]), t32([0, 0, 1, 1, 1]))
    with pytest.raises(ValueError):
        tspf._bf_relax(d0.t().contiguous(), src, ov, t32([0]), t32([1]),
                       t32([[1]]), t32([0, 0, 1]))
    with pytest.raises(ValueError):
        tspf.batched_spf(
            graph_from_arrays(graph_arrays(jgraph.compile_edges(
                [("a", "b", 1)]))),
            [0, 99], device="cpu",
        )
