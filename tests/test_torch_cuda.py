"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and nvcc and skips elsewhere. This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The graphs are small but cover what the main path's shapes do not: an
overloaded transit node, a bucket wider than 32 slots, a graph too wide for
the sliced layout, per-row weights, a batch padded with repeated sources,
out-of-range patches. The event-path kernels (K4-K7) are held against their
plain versions and the warm solves against cold ones on the new weights;
KSP's kernels (K8 build and seed, K9, K6's per-row seed) against their plain
versions, the masked solve warm against cold, and a KSP2 route db against
the CPU's. The all-pairs kernels (K10 tile product, K11 close, K12 seed, K13
re-close round) against their plain versions with overloaded nodes at one,
four and 32 blocks, warm re-closes against cold closes, `ApspState` against
the numpy Floyd-Warshall, and route dbs from other nodes' perspectives with
LFA against the CPU's. Tolerance is exact equality, except for
differentiable TE: its kernels (K14 softmin round, K15 its backward, K16
gate, flow round and utilization, K17 their backward, K18 MLU, its seed and
the Adam step) sum float32 in another order than their plain versions, so
they agree within 1e-5 of the largest magnitude (F_INF entries exactly),
given the same forward decisions (K14's fold outcome); and the whole chain,
`SoftminRound` and `SoftFlow` under autograd and a 4-step Adam run, agrees
with the CPU's within 1e-4 of the largest gradient and 1e-3 on the weights
(Adam normalises each step, so rounding moves a weight by up to lr times
the relative gradient difference per step). On the pendant-node input of
ROADMAP queue 3 item 1 the strict cases are expected failures with their
measured gaps, beside the cases that pin what does hold. The tiled layout's
kernels (K19 tile round, K20 halo fold, K21's four entries) against their
plain versions at odd shapes, and the tiled and row-sharded solves on a
mesh of ranks sharing the card against the same on the CPU, exactly. With
two cards or more, the same meshes with their ranks spread over the cards
against one card, and route dbs on such meshes against the CPU's; with one
card those tests skip.
"""

import dataclasses

import numpy as np
import pytest
import torch

from openr_tpu_torch.apsp import ApspState
from openr_tpu_torch.apsp import kernels as fw
from openr_tpu_torch.convert import to_device
from openr_tpu_torch.lsdb import LinkState, PrefixState
from openr_tpu_torch.ops import _cuda
from openr_tpu_torch.ops import spf
from openr_tpu_torch.ops.graph import (
    INF,
    compile_edges,
    compile_graph,
    refresh_graph,
)
from openr_tpu_torch.solver import CudaSpfSolver, SpfSolver
from openr_tpu_torch.topology import (
    build_adj_dbs,
    fabric_edges,
    grid_edges,
    wan_edges,
)
from openr_tpu_torch.types import (
    IpPrefix,
    PrefixDatabase,
    PrefixEntry,
    PrefixForwardingAlgorithm,
    PrefixForwardingType,
)

GRAPHS = {
    "grid": (grid_edges(6), {"g2_2", "g3_1"}),
    "wan": (wan_edges(300, degree=4, seed=11), {"w3", "w40"}),
    "clos": (fabric_edges(pods=3, planes=2, ssw_per_plane=3,
                          fsw_per_pod=4, rsw_per_pod=40), {"fsw0_1"}),
    "star": ([("hub", f"l{i:02d}", 1 + i % 5) for i in range(40)], None),
    "extreme": ([("hub", f"l{i:04d}", 1 + i % 3) for i in range(1100)],
                {"l0007"}),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def sources_for(graph, n=24, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.choice(graph.n, size=min(n, graph.n), replace=False)
    # a padded batch repeats its first source, as the area solve does
    rows = np.concatenate([rows, np.full(8, rows[0])]).astype(np.int32)
    return rows


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sell_relax_kernel_equals_plain(dev, name):
    edges, ov = GRAPHS[name]
    g = compile_edges(edges, ov)
    if g.sell is None:
        pytest.skip(f"{name} has no sliced layout (edge-list graph)")
    st = to_device(g, dev)
    src = torch.as_tensor(sources_for(g), device=dev)
    d0 = spf._sell_d0(src, g.n_pad)
    before = _cuda.SELL_RELAX.launches
    d_k, r_k = spf._sell_relax(
        d0.clone(), src, st["ov"], st["nbrs"], st["wgs"], g.sell.zero_end,
        g.sell.starts,
    )
    assert _cuda.SELL_RELAX.launches - before == r_k * len(g.sell.starts)
    d_p, r_p = spf._sell_relax_plain(
        d0, src, st["ov"], st["nbrs"], st["wgs"], g.sell.starts
    )
    torch.cuda.synchronize()
    assert r_k == r_p
    assert torch.equal(d_k, d_p)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("per_row", [False, True])
def test_bf_relax_kernel_equals_plain(dev, name, per_row):
    edges, ov = GRAPHS[name]
    g = compile_edges(edges, ov)
    st = to_device(g, dev)
    rows = sources_for(g)
    src = torch.as_tensor(rows, device=dev)
    if per_row:
        rng = np.random.default_rng(5)
        w = rng.integers(1, 40, size=(len(rows), g.e_pad)).astype(np.int32)
        w[rng.random(w.shape) < 0.1] = INF
        w[:, g.e:] = INF
        w_rows = torch.as_tensor(w, device=dev)
    else:
        w_rows = st["w"][None, :]
    d0 = spf._bf_d0(src, g.n_pad)
    d_k, r_k = spf._bf_relax(
        d0.clone(), src, st["ov"], st["src"], st["dst"], w_rows, st["csr"]
    )
    d_p, r_p = spf._bf_relax_plain(
        d0, src, st["ov"], st["src"], st["dst"], w_rows, st["csr"]
    )
    torch.cuda.synchronize()
    assert r_k == r_p
    assert torch.equal(d_k, d_p)


@pytest.mark.parametrize("name", ["grid", "star", "clos"])
def test_ecmp_triangle_kernel_equals_plain(dev, name):
    edges, ov = GRAPHS[name]
    g = compile_edges(edges, ov)
    d = spf.batched_spf(g, np.arange(g.n_pad), device=dev)
    st = to_device(g, dev)
    args = (d, st["src"], st["dst"], st["dst"], st["w"], st["ov"])
    before = _cuda.ECMP_TRIANGLE.launches
    out = spf.ecmp_triangle(*args)
    assert _cuda.ECMP_TRIANGLE.launches == before + 1
    assert torch.equal(out, spf._ecmp_triangle_plain(*args))


def test_route_db_on_card_equals_cpu(dev):
    edges, _ = GRAPHS["clos"]
    dbs = {}
    for device in ("cpu", dev):
        ls = LinkState("0")
        for db in build_adj_dbs(edges, overloaded_nodes={"fsw1_2"}).values():
            ls.update_adjacency_database(db)
        ps = PrefixState()
        for i, node in enumerate(sorted(ls.node_names())):
            ps.update_prefix_database(PrefixDatabase(
                node, [PrefixEntry(IpPrefix(f"10.0.{i}.0/24"))], area="0"
            ))
        solver = CudaSpfSolver("fsw0_0", device=device, compute_lfa_paths=True)
        dbs[str(device)] = solver.build_route_db("fsw0_0", {"0": ls}, ps)
        assert solver.host_spf_calls == 0
    assert dbs["cpu"].unicast_entries == dbs["cuda"].unicast_entries
    assert dbs["cpu"].mpls_entries == dbs["cuda"].mpls_entries


# -- the event path: K4-K7 and the warm solves -----------------------------


def event_for(g, seed=0, k=24):
    """A seeded weight event on compiled graph g: (w_new, changed,
    increased), a third of the changes up (some to INF), the rest down."""
    rng = np.random.default_rng(seed)
    changed = rng.choice(g.e, size=min(k, g.e), replace=False)
    w_new = g.w.copy()
    up = changed[: len(changed) // 3]
    down = changed[len(changed) // 3:]
    w_new[up] = g.w[up] + rng.integers(1, 9, size=len(up))
    w_new[up[:2]] = INF
    w_new[down] = np.maximum(1, g.w[down] - 2)
    changed = changed[w_new[changed] != g.w[changed]]
    return w_new, changed, changed[w_new[changed] > g.w[changed]]


def sell_graphs():
    return [n for n in sorted(GRAPHS) if n != "extreme"]


@pytest.mark.parametrize("name", sell_graphs())
def test_sell_patch_kernel_equals_plain(dev, name):
    edges, ov = GRAPHS[name]
    g = compile_edges(edges, ov)
    w_new, changed, _ = event_for(g)
    idx, vals = spf.sell_patch_arrays(g.sell, changed, w_new, 64)
    idx[0, -1] = [g.sell.nbr[0].shape[0] + 5, 0]  # out of range: dropped
    st = to_device(g, dev)
    wk = tuple(a.clone() for a in st["wgs"])
    wp = tuple(a.clone() for a in st["wgs"])
    before = _cuda.SELL_PATCH.launches
    spf._sell_apply_patches(wk, torch.as_tensor(idx, device=dev),
                            torch.as_tensor(vals, device=dev))
    assert _cuda.SELL_PATCH.launches - before == 1
    spf._sell_apply_patches_plain(wp, torch.as_tensor(idx, device=dev),
                                  torch.as_tensor(vals, device=dev))
    torch.cuda.synchronize()
    for a, b, want in zip(wk, wp, g.sell.patched_wg(w_new[: g.e])):
        assert torch.equal(a, b)
        assert np.array_equal(a.cpu().numpy(), want)


PATCH_CASES = {
    "three_buckets": ([(50, 4), (20, 8), (3, 32)], 64),
    "64_buckets": ([(1 + k % 37, 1 + k % 9) for k in range(64)], 64),
    "empty_buckets": ([(10, 4), (0, 8), (5, 0), (7, 3)], 16),
    "no_patches": ([(10, 4), (6, 2)], 0),
    "wide_list": ([(100, 4), (30, 16)], 200),
}


def patch_case(shapes, p, seed):
    """Buckets of the given (nk, dk) shapes with seeded weights, and [nb, p]
    patch lists: distinct in-range slots in each bucket, then a row out of
    range, a slot out of range and both (dropped), then PATCH_PAD rows."""
    rng = np.random.default_rng(seed)
    wgs = [rng.integers(1, 100, size=s, dtype=np.int32) for s in shapes]
    idx = np.full((len(shapes), p, 2), spf.PATCH_PAD, dtype=np.int32)
    vals = rng.integers(100, 200, size=(len(shapes), p), dtype=np.int32)
    for k, (nk, dk) in enumerate(shapes):
        slots = rng.permutation(nk * dk)[: p // 2]
        rows = [(q // dk, q % dk) for q in slots]
        rows += [(nk, 0), (0, dk), (nk + 7, dk + 3)]
        rows = rows[:p]
        if rows:
            idx[k, : len(rows)] = rows
    return wgs, idx, vals


@pytest.mark.parametrize("case", sorted(PATCH_CASES))
def test_sell_patch_kernel_cases(dev, case):
    """K4 patches every bucket in one launch (none without patches),
    bit for bit as its plain version: up to 64 buckets, empty buckets,
    rows and slots out of range in every bucket, lists wider than a
    block."""
    shapes, p = PATCH_CASES[case]
    wgs, idx, vals = patch_case(shapes, p, seed=len(shapes) + p)
    idx_t = torch.as_tensor(idx, device=dev)
    vals_t = torch.as_tensor(vals, device=dev)
    wk = tuple(torch.as_tensor(w, device=dev) for w in wgs)
    wp = tuple(torch.as_tensor(w, device=dev) for w in wgs)
    before = _cuda.SELL_PATCH.launches
    out = spf._sell_apply_patches(wk, idx_t, vals_t)
    assert _cuda.SELL_PATCH.launches - before == (1 if p else 0)
    spf._sell_apply_patches_plain(wp, idx_t, vals_t)
    torch.cuda.synchronize()
    changed = 0
    for a, b, w, o in zip(wk, wp, wgs, out):
        assert o is a and torch.equal(a, b)
        changed += int((a.cpu().numpy() != w).sum())
    assert changed > 0 or p == 0


def test_sell_patch_kernel_refuses_65_buckets(dev):
    wgs, idx, vals = patch_case([(4, 2)] * 65, 8, 0)
    before = _cuda.SELL_PATCH.launches
    with pytest.raises(ValueError, match="at most 64 buckets"):
        spf._sell_apply_patches(
            tuple(torch.as_tensor(w, device=dev) for w in wgs),
            torch.as_tensor(idx, device=dev),
            torch.as_tensor(vals, device=dev))
    assert _cuda.SELL_PATCH.launches == before


@pytest.mark.parametrize("name", sell_graphs())
def test_sell_mark_kernel_equals_plain(dev, name):
    edges, ov = GRAPHS[name]
    g = compile_edges(edges, ov)
    _, _, inc = event_for(g)
    inc_idx, _ = spf.sell_patch_arrays(g.sell, inc, g.w, 64)
    st = to_device(g, dev)
    src = torch.as_tensor(sources_for(g), device=dev)
    d_prev = spf._sell_solver_counted(
        g.sell.shape_key(), src, st["nbrs"], st["wgs"], st["ov"]
    )[0]
    inc_t = torch.as_tensor(inc_idx, device=dev)
    args = (d_prev, st["nbrs"], st["wgs"], inc_t, g.sell.zero_end,
            g.sell.starts)
    m_k, r_k = spf._sell_invalidate(*args)
    m_p = spf._sell_seed_plain(d_prev, st["nbrs"], st["wgs"], args[3],
                               g.sell.starts)
    m_p, r_p = spf._sell_mark_fixpoint_plain(
        d_prev, m_p, st["nbrs"], st["wgs"], g.sell.starts
    ) if bool(m_p.any()) else (m_p, 0)
    torch.cuda.synchronize()
    assert r_k == r_p and r_k >= 1
    assert torch.equal(m_k, m_p)
    d0_k = spf._sell_warm_d0(d_prev, m_k, src)
    d0_p = spf._bf_warm_d0_plain(d_prev, m_p, src).t().contiguous()
    assert torch.equal(d0_k, d0_p)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bf_mark_kernel_equals_plain(dev, name):
    edges, ov = GRAPHS[name]
    g = compile_edges(edges, ov)
    w_new, _, _ = event_for(g)
    st = to_device(g, dev)
    src = torch.as_tensor(sources_for(g), device=dev)
    d_prev = spf._bf_relax(spf._bf_d0(src, g.n_pad), src, st["ov"],
                           st["src"], st["dst"], st["w"][None, :],
                           st["csr"])[0]
    args = (d_prev, st["src"], st["dst"],
            torch.as_tensor(w_new, device=dev), st["w"], st["csr"])
    before = _cuda.BF_MARK.launches
    m_k, r_k = spf._bf_invalidate(*args)
    assert _cuda.BF_MARK.launches - before == 1 + r_k
    m_p, r_p = spf._bf_invalidate_plain(*args)
    torch.cuda.synchronize()
    assert r_k == r_p
    assert torch.equal(m_k, m_p)
    assert torch.equal(spf._bf_warm_d0(d_prev, m_k, src),
                       spf._bf_warm_d0_plain(d_prev, m_p, src))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_delta_extract_kernel_equals_plain(dev, name):
    edges, ov = GRAPHS[name]
    g = compile_edges(edges, ov)
    w_new, _, _ = event_for(g)
    rows = sources_for(g)
    d_prev = spf.batched_spf_vw(g, rows, g.w[None, :], device=dev)
    d = spf.batched_spf_vw(g, rows, w_new[None, :], device=dev)
    cc_k, num_k = spf.delta_columns(d, d_prev)
    cc_p = (d != d_prev).any(dim=0)
    assert torch.equal(cc_k, cc_p) and int(num_k) == int(cc_p.sum())
    nh_rows = torch.tensor([1, 2, 3, 0, 0, 0, 0, 0], dtype=torch.int32,
                           device=dev)
    nh_ws = torch.tensor([1, 3, 2, INF, INF, INF, INF, INF],
                         dtype=torch.int32, device=dev)
    for cap in (8, max(8, 1 << int(num_k).bit_length())):
        out_k = spf._delta_extract(cc_k, d, nh_rows, nh_ws, cap=cap)
        out_p = spf._delta_extract_plain(cc_p, d, nh_rows, nh_ws, cap)
        torch.cuda.synchronize()
        for a, b in zip(out_k, out_p):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_warm_solves_equal_cold(dev, name):
    edges, ov = GRAPHS[name]
    g = compile_edges(edges, ov)
    w_new, changed, inc = event_for(g, seed=3)
    rows = sources_for(g)
    src = torch.as_tensor(rows, device=dev)
    st = to_device(g, dev)
    cold_new = spf.batched_spf_vw(g, rows, w_new[None, :], device=dev)
    d_prev = spf.batched_spf_vw(g, rows, g.w[None, :], device=dev)
    d_bf, _, inv_bf, cc_bf, _ = spf._bf_solver_warm(
        src, st["src"], st["dst"], torch.as_tensor(w_new, device=dev),
        st["w"], st["ov"], d_prev, st["csr"],
    )
    assert torch.equal(d_bf, cold_new)
    assert torch.equal(cc_bf, (cold_new != d_prev).any(dim=0))
    if g.sell is None:
        return
    idx, vals = spf.sell_patch_arrays(g.sell, changed, w_new, 64)
    inc_idx, _ = spf.sell_patch_arrays(g.sell, inc, w_new, 64)
    d_s, wgs, _, inv_s, cc_s, num_s = spf._sell_solver_warm(
        g.sell.shape_key(), src, st["nbrs"], st["wgs"], st["ov"],
        torch.as_tensor(idx, device=dev), torch.as_tensor(vals, device=dev),
        torch.as_tensor(inc_idx, device=dev), d_prev,
    )
    assert torch.equal(d_s, cold_new)
    assert inv_s == inv_bf
    assert torch.equal(cc_s, cc_bf) and int(num_s) == int(cc_bf.sum())


def test_event_path_on_card_equals_cpu(dev):
    """The DeltaRouteBuilder over the solver on the card and on the CPU
    through remote events (delta path) and one at me (full path)."""
    from openr_tpu_torch.solver import DeltaRouteBuilder
    import dataclasses

    edges, _ = GRAPHS["clos"]
    runs = {}
    for device in ("cpu", dev):
        ls = LinkState("0")
        dbs = build_adj_dbs(edges)
        for db in dbs.values():
            ls.update_adjacency_database(db)
        ps = PrefixState()
        for i, node in enumerate(sorted(ls.node_names())):
            ps.update_prefix_database(PrefixDatabase(
                node, [PrefixEntry(IpPrefix(f"10.0.{i}.0/24"))], area="0"
            ))
        builder = DeltaRouteBuilder(CudaSpfSolver("rsw0_0", device=device))
        db, _, _ = builder.build("rsw0_0", {"0": ls}, ps, None)
        used = []
        # a rack link of one of my uplink switches moves that rack's
        # column in the switch's batch row; the last event is at me
        for a, b, metric in (("fsw0_1", "rsw0_7", 7), ("rsw0_7", "fsw0_1", 7),
                             ("fsw0_1", "rsw0_7", 1), ("rsw0_0", "fsw0_0", 4)):
            dbs[a] = dataclasses.replace(dbs[a], adjacencies=[
                dataclasses.replace(x, metric=metric)
                if x.other_node_name == b else x for x in dbs[a].adjacencies
            ])
            ls.update_adjacency_database(dbs[a])
            db, _, u = builder.build("rsw0_0", {"0": ls}, ps, db)
            used.append(u)
        runs[str(device)] = (db, used, builder.solver.counters)
    assert runs["cpu"][0].unicast_entries == runs["cuda"][0].unicast_entries
    assert runs["cpu"][1] == runs["cuda"][1] == [True, True, True, False]
    assert runs["cpu"][2]["decision.spf.delta_columns"] > 0
    for key in ("decision.spf.incremental_solves", "decision.spf.full_solves",
                "decision.spf.delta_columns", "decision.spf.delta_bytes"):
        assert runs["cpu"][2][key] == runs["cuda"][2][key], key


# -- KSP: K8, K9, K6's per-row seed and the masked solves -------------------


def ksp_masks(g, s, seed=0):
    """Per-bucket [Mk, 3] mask lists for s batch columns: links of the
    graph masked per column (both directions), a padding row, and entries
    out of range in the slot and in the column (the build drops them, the
    seed clips them)."""
    rng = np.random.default_rng(seed)
    links = sorted(g.link_edges) if g.link_edges else []
    positions = []
    for c in range(s):
        if links and c % 3 != 1:  # every third column masks nothing
            pick = rng.choice(len(links), size=min(4, len(links)),
                              replace=False)
            positions.append([p for i in pick for p in g.link_edges[links[i]]])
        else:
            positions.append(
                list(rng.choice(g.e, size=min(6, g.e), replace=False))
                if c % 3 != 1 else [])
    masks = spf.sell_mask_arrays(g.sell, positions)
    for k, nbr_k in enumerate(g.sell.nbr):
        extra = np.array([[nbr_k.shape[0] - 1, nbr_k.shape[1] + 2, 0],
                          [0, 0, s + 4]], dtype=np.int32)
        masks[k] = np.concatenate([masks[k], extra])
    return positions, masks


@pytest.mark.parametrize("s", [1, 3, 33])
@pytest.mark.parametrize("name", sell_graphs())
def test_sell_mask_and_masked_relax_kernels_equal_plain(dev, name, s):
    edges, ov = GRAPHS[name]
    g = compile_edges(edges, ov)
    _, masks = ksp_masks(g, s)
    st = to_device(g, dev)
    rows = sources_for(g)[:s]
    if len(rows) < s:
        rows = np.resize(rows, s)
    src = torch.as_tensor(rows.astype(np.int32), device=dev)
    m_t = [torch.as_tensor(m, device=dev) for m in masks]
    before = _cuda.SELL_MASK.launches
    bits = spf._sell_mask_bits(m_t, st["nbrs"], s)
    assert _cuda.SELL_MASK.launches - before == 1  # one for every bucket
    for m, b, nbr_k in zip(m_t, bits, st["nbrs"]):
        assert torch.equal(b, spf._sell_mask_bits_plain(m, *nbr_k.shape, s))
    d0 = spf._sell_d0(src, g.n_pad)
    before = _cuda.SELL_RELAX_MASKED.launches
    d_k, r_k = spf._sell_relax(
        d0.clone(), src, st["ov"], st["nbrs"], st["wgs"], g.sell.zero_end,
        g.sell.starts, bits,
    )
    assert (_cuda.SELL_RELAX_MASKED.launches - before
            == r_k * len(g.sell.starts))
    d_p, r_p = spf._sell_relax_plain(
        d0, src, st["ov"], st["nbrs"],
        spf._sell_masked_wgs_plain(st["wgs"], bits, s), g.sell.starts,
    )
    torch.cuda.synchronize()
    assert r_k == r_p and torch.equal(d_k, d_p)
    base = spf.sell_fixpoint(g.sell, rows, g.sell.wg, g.overloaded,
                             device=dev)
    marks, seeded = spf._sell_mask_seed(base, st["nbrs"], st["wgs"], m_t,
                                        g.sell.starts)
    want = spf._sell_mask_seed_plain(base, st["nbrs"], st["wgs"], m_t,
                                     g.sell.starts)
    torch.cuda.synchronize()
    assert torch.equal(marks, want) and seeded == bool(want.any())


@pytest.mark.parametrize("s", [1, 3, 33])
@pytest.mark.parametrize("name", sell_graphs())
def test_masked_solve_warm_equals_cold(dev, name, s):
    edges, ov = GRAPHS[name]
    g = compile_edges(edges, ov)
    positions, _ = ksp_masks(g, s, seed=1)
    rows = np.resize(sources_for(g), s).astype(np.int32)
    st = to_device(g, dev)
    arrays = (st["nbrs"], st["wgs"], st["ov"])
    base = spf.sell_fixpoint(g.sell, rows, g.sell.wg, g.overloaded,
                             device=dev)
    cold = spf.sell_fixpoint_masked(g.sell, rows, g.overloaded, positions,
                                    device_arrays=arrays, device=dev)
    warm = spf.sell_fixpoint_masked(g.sell, rows, g.overloaded, positions,
                                    device_arrays=arrays, d_prev=base,
                                    device=dev)
    cpu = spf.sell_fixpoint_masked(g.sell, rows, g.overloaded, positions,
                                   device="cpu")
    torch.cuda.synchronize()
    assert torch.equal(warm, cold)
    assert torch.equal(cold.cpu(), cpu)
    for a, want in zip(st["wgs"], g.sell.wg):  # the base weights stay
        assert np.array_equal(a.cpu().numpy(), want)


# -- K7 and K8 at odd shapes, and what they cost the host -------------------


def delta_case(case):
    """(d_prev, d, cap list) on the CPU for one K7 case: d_prev seeded
    int32 [S, n], d equal to it but in the changed columns, where one
    seeded row differs."""
    tile = spf._COMPACT_TILE
    rng = np.random.default_rng(sum(map(ord, case)))
    s, n = {
        "many_tiles": (4, 40 * tile + 123), "tile_edges": (5, 5 * tile),
        "none": (3, 3 * tile + 5), "all": (3, 3 * tile + 5),
        "n1": (2, 1), "n3": (4, 3), "n4097": (9, 4097),
        "sharded_width": (128, 37), "unaligned": (8, 2 * tile),
    }[case]
    if case == "many_tiles":
        changed = np.flatnonzero(rng.random(n) < 0.03)
    elif case == "tile_edges":  # both sides of every tile and load boundary
        edges = np.arange(tile, n, tile)
        changed = np.concatenate([[0, 15, 16, n - 1], edges - 1, edges])
    elif case == "none":
        changed = np.zeros(0, dtype=np.int64)
    elif case in ("all", "n1", "n3", "sharded_width"):
        changed = np.arange(n)
    else:
        changed = np.flatnonzero(rng.random(n) < 0.5)
    d_prev = rng.integers(0, INF, size=(s, n), dtype=np.int32)
    d = d_prev.copy()
    rows = rng.integers(0, s, size=len(changed))
    d[rows, changed] = d_prev[rows, changed] + 1
    num = len(np.unique(changed))
    caps = sorted({0, max(num - 1, 0), num, num + 5, 2 * n + 3})
    return torch.as_tensor(d_prev), torch.as_tensor(d), caps


def on_card(t, dev, offset=0):
    """t on the card, `offset` int32 elements into its allocation (a
    contiguous tensor whose rows are not 16-byte aligned)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("case", [
    "many_tiles", "tile_edges", "none", "all", "n1", "n3", "n4097",
    "sharded_width", "unaligned",
])
def test_delta_extract_kernel_cases(dev, case):
    """K7's columns pass, compaction and gather against their plain versions
    and against `torch.nonzero_static`: n over 40 look-back tiles, changed
    columns either side of every tile and 16-flag load boundary, none and
    all changed, odd widths (1, 3, 4,097: the scalar path), the [S, num]
    all-changed matrix `_delta_extract_sharded` builds, rows and flags not
    16-byte aligned, and cap below, equal to and above the changed count."""
    d_prev, d, caps = delta_case(case)
    off = 1 if case == "unaligned" else 0
    dp_c, d_c = on_card(d_prev, dev, off), on_card(d, dev, off)
    cc, num = spf.delta_columns(d_c, dp_c)
    want_cc = (d != d_prev).any(dim=0)
    torch.cuda.synchronize()
    assert torch.equal(cc.cpu(), want_cc) and int(num) == int(want_cc.sum())
    if case == "unaligned":  # flags one byte off their allocation
        cc = on_card(want_cc, dev, 1)
    n = d.shape[1]
    nh_rows = torch.tensor([d.shape[0] - 1, 0, 0], dtype=torch.int32,
                           device=dev)
    nh_ws = torch.tensor([1, 0, INF], dtype=torch.int32, device=dev)
    for cap in caps:
        cols = spf._delta_compact(cc, cap)
        lib = torch.nonzero_static(cc, size=cap, fill_value=n).flatten()
        out = spf._delta_extract(cc, d_c, nh_rows, nh_ws, cap=cap)
        want = spf._delta_extract_plain(want_cc, d, nh_rows.cpu(),
                                        nh_ws.cpu(), cap)
        torch.cuda.synchronize()
        assert torch.equal(cols.cpu(), lib.to(torch.int32).cpu()), cap
        assert torch.equal(out[0], cols), cap
        for a, b in zip(out, want):
            assert torch.equal(a.cpu(), b), cap


def mask_cases(g, s, seed):
    """Per-bucket [Mk, 3] lists for K8 at batch width s: seeded entries in
    range, the first of them twice (a duplicate), one entry out of range
    in the row only, one in the slot only, one in the column only, a
    padding row; the second bucket left empty."""
    rng = np.random.default_rng(seed)
    masks = []
    for k, nbr_k in enumerate(g.sell.nbr):
        nk, dk = nbr_k.shape
        if k == 1:
            masks.append(np.zeros((0, 3), dtype=np.int32))
            continue
        m = 4 * s + 8
        real = np.stack([rng.integers(0, nk, m), rng.integers(0, dk, m),
                         rng.integers(0, s, m)], axis=1)
        odd = [real[0], [nk, 0, 0], [0, dk, 0], [0, 0, s],
               [spf.PATCH_PAD] * 3]
        masks.append(np.concatenate([real, odd]).astype(np.int32))
    return masks


@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed"])
@pytest.mark.parametrize("s", [1, 31, 32, 33, 65])
def test_sell_mask_kernel_cases(dev, s, packed):
    """K8's build and seed, one launch each for all buckets, against their
    plain versions: entries out of range in each dimension (the build
    drops them, the seed clips all but the padding row), duplicates, batch
    widths around the 32-column word (S in 1, 31, 32, 33, 65), an empty
    bucket, the masks as separate tensors or as views of one upload."""
    g = compile_edges(*GRAPHS["wan"])
    assert len(g.sell.nbr) > 2
    masks = mask_cases(g, s, seed=s)
    st = to_device(g, dev)
    if packed:
        sizes = np.cumsum([0] + [len(m) for m in masks])
        m_t = spf.mask_views(
            torch.as_tensor(np.concatenate(masks), device=dev), sizes)
    else:
        m_t = [torch.as_tensor(m, device=dev) for m in masks]
    rows = np.resize(sources_for(g), s).astype(np.int32)
    base = spf.sell_fixpoint(g.sell, rows, g.sell.wg, g.overloaded,
                             device=dev)
    before = _cuda.SELL_MASK.launches
    bits = spf._sell_mask_bits(m_t, st["nbrs"], s)
    assert _cuda.SELL_MASK.launches - before == 1
    marks, seeded = spf._sell_mask_seed(base, st["nbrs"], st["wgs"], m_t,
                                        g.sell.starts)
    assert _cuda.SELL_MASK.launches - before == 2
    want = spf._sell_mask_seed_plain(base, st["nbrs"], st["wgs"], m_t,
                                     g.sell.starts)
    torch.cuda.synchronize()
    for m, b, nbr_k in zip(m_t, bits, st["nbrs"]):
        assert torch.equal(b, spf._sell_mask_bits_plain(m, *nbr_k.shape, s))
    assert torch.equal(marks, want) and seeded == bool(want.any())
    assert seeded


def test_delta_extract_and_mask_build_never_sync(dev):
    """K7 (columns, and the extraction with its cap given) and K8's build
    queue their work without a host sync: under sync debug mode "error"
    any PyTorch call that waits for the card raises."""
    d_prev, d, _ = delta_case("many_tiles")
    d_prev, d = d_prev.to(dev), d.to(dev)
    g = compile_edges(*GRAPHS["wan"])
    st = to_device(g, dev)
    m_t = [torch.as_tensor(m, device=dev) for m in mask_cases(g, 33, 0)]
    nh_rows = torch.tensor([1, 2, 0, 0], dtype=torch.int32, device=dev)
    nh_ws = torch.tensor([3, 1, INF, INF], dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cc, num = spf.delta_columns(d, d_prev)
        out = spf._delta_extract(cc, d, nh_rows, nh_ws, cap=8192)
        bits = spf._sell_mask_bits(m_t, st["nbrs"], 33)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with pytest.raises(RuntimeError):  # the mode does catch a sync
        torch.cuda.set_sync_debug_mode("error")
        try:
            int(num)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    want = spf._delta_extract_plain(cc.cpu(), d.cpu(), nh_rows.cpu(),
                                    nh_ws.cpu(), 8192)
    for a, b in zip(out, want):
        assert torch.equal(a.cpu(), b)
    for m, b, nbr_k in zip(m_t, bits, st["nbrs"]):
        assert torch.equal(b, spf._sell_mask_bits_plain(m, *nbr_k.shape, 33))


def test_delta_extract_and_mask_launches_per_call(dev):
    """Launches per call: K7's columns pass 1, its extraction 2 (compaction
    and gather; none when cap is 0); K8's build 1 and its seed 1 whatever
    the bucket count."""
    d_prev, d, _ = delta_case("many_tiles")
    d_prev, d = d_prev.to(dev), d.to(dev)
    nh = torch.zeros(8, dtype=torch.int32, device=dev)
    k7 = _cuda.DELTA_EXTRACT
    before = k7.launches
    cc, _ = spf.delta_columns(d, d_prev)
    assert k7.launches - before == 1
    spf._delta_extract(cc, d, nh, nh, cap=1024)
    assert k7.launches - before == 3
    spf._delta_extract(cc, d, nh, nh, cap=0)
    assert k7.launches - before == 3
    g = compile_edges(*GRAPHS["wan"])
    st = to_device(g, dev)
    rows = sources_for(g)
    s = len(rows)
    positions, _ = ksp_masks(g, s)
    packed, offsets = spf.sell_mask_packed(g.sell, positions)
    m_t = spf.mask_views(torch.as_tensor(packed, device=dev), offsets)
    base = spf.sell_fixpoint(g.sell, rows, g.sell.wg, g.overloaded,
                             device=dev)
    k8 = _cuda.SELL_MASK
    before = k8.launches
    spf._sell_mask_bits(m_t, st["nbrs"], s)
    assert k8.launches - before == 1
    spf._sell_mask_seed(base, st["nbrs"], st["wgs"], m_t, g.sell.starts)
    assert k8.launches - before == 2 and len(m_t) > 2


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bf_mark_per_row_seed_equals_plain(dev, name):
    edges, ov = GRAPHS[name]
    g = compile_edges(edges, ov)
    rows = sources_for(g)
    s = len(rows)
    rng = np.random.default_rng(4)
    w_rows = np.tile(g.w, (s, 1))
    for i in range(s):
        w_rows[i, rng.choice(g.e, size=min(5, g.e), replace=False)] = INF
    st = to_device(g, dev)
    src = torch.as_tensor(rows, device=dev)
    w_rows_t = torch.as_tensor(w_rows, device=dev)
    d_prev = spf.batched_spf(g, rows, device=dev)
    args = (d_prev, st["src"], st["dst"], w_rows_t, st["w"], st["csr"])
    m_k, r_k = spf._bf_invalidate(*args)
    m_p, r_p = spf._bf_invalidate_plain(*args)
    torch.cuda.synchronize()
    assert r_k == r_p and torch.equal(m_k, m_p)
    d, _, _ = spf._bf_warm_vw_core(src, st["src"], st["dst"], w_rows_t,
                                   st["w"], st["ov"], d_prev, st["csr"])
    cold = spf.batched_spf_vw(g, rows, w_rows, device=dev)
    torch.cuda.synchronize()
    assert torch.equal(d, cold)


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("name", ["wan", "extreme"])
def test_ksp2_route_db_on_card_equals_cpu(dev, name, warm):
    edges, ov = GRAPHS[name]
    if name == "extreme":  # a ring through the leaves: second paths exist
        leaves = sorted({b for _, b, _ in edges})
        edges = edges + [(a, b, 2) for a, b in zip(leaves, leaves[1:])]
    ls = LinkState("0")
    for db in build_adj_dbs(edges, overloaded_nodes=ov).values():
        ls.update_adjacency_database(db)
    names = sorted(ls.node_names())
    me = names[0]
    ps = PrefixState()
    for i, node in enumerate(names[1::max(1, len(names) // 6)]):
        ps.update_prefix_database(PrefixDatabase(node, [PrefixEntry(
            IpPrefix(f"10.0.{i}.0/24"),
            forwarding_type=PrefixForwardingType.SR_MPLS,
            forwarding_algorithm=PrefixForwardingAlgorithm.KSP2_ED_ECMP,
        )], area="0"))
    solver = CudaSpfSolver(me, device=dev, warm_start=warm)
    before = {k.name: k.launches for k in _cuda.KERNELS}
    got = solver.build_route_db(me, {"0": ls}, ps)
    torch.cuda.synchronize()
    want = SpfSolver(me).build_route_db(me, {"0": ls}, ps)
    assert got.unicast_entries == want.unicast_entries
    assert got.mpls_entries == want.mpls_entries
    assert solver.host_spf_calls == 0
    solve = solver._solves[("0", me)][1]
    assert solve.ksp_device_batches >= 1
    assert (solve.ksp_warm_batches > 0) == warm
    if solve.graph.sell is not None:
        k = _cuda.SELL_RELAX_MASKED
        assert k.launches > before[k.name]


# -- all-pairs matrix (K11-K13) ---------------------------------------------


def fw_inputs(n, seed, ov_frac=0.02):
    """A sparse direct-edge matrix (INF holes, 0 diagonal) and its allow
    mask with some overloaded nodes."""
    rng = np.random.default_rng(seed)
    w = np.full((n, n), INF, dtype=np.int32)
    mask = rng.random((n, n)) < 4.0 / n
    w[mask] = rng.integers(1, 50, size=int(mask.sum()))
    np.fill_diagonal(w, 0)
    ov = rng.random(n) < ov_frac
    ov[:2] = True
    return w, ov, rng


@pytest.mark.parametrize("n", [64, 512, 4096])
def test_fw_close_kernel_equals_plain(dev, n):
    w, ov, _ = fw_inputs(n, n)
    wt = torch.as_tensor(w, device=dev)
    at = torch.as_tensor(fw.build_allow_matrix(ov), device=dev)
    nb = fw.fw_block_shape(n)[0]
    before = _cuda.FW_CLOSE.launches
    d, probe = fw.fw_close(wt, at)
    assert _cuda.FW_CLOSE.launches - before == (3 * nb if nb > 1 else 1) + 1
    d_p, probe_p = fw._fw_close_plain(wt, at)
    torch.cuda.synchronize()
    assert torch.equal(d, d_p) and int(probe) == int(probe_p)
    assert torch.equal(wt, torch.as_tensor(w, device=dev))
    if n <= 512:
        assert np.array_equal(d.cpu().numpy(), fw.np_floyd_warshall(w, ov))


def _fw_event(w, rng, n_inc, n_dec):
    present = np.argwhere((w < INF) & (w > 0))
    pick = present[rng.choice(len(present), n_inc + n_dec, replace=False)]
    w_new = w.copy()
    p = 64
    iu = np.full(p, fw.INCREASE_PAD, dtype=np.int32)
    iv = np.zeros(p, dtype=np.int32)
    iw = np.zeros(p, dtype=np.int32)
    for i, (u, v) in enumerate(pick):
        if i < n_inc:
            iu[i], iv[i], iw[i] = u, v, w[u, v]
            w_new[u, v] = INF if i % 3 == 0 else w[u, v] + rng.integers(1, 30)
        else:
            w_new[u, v] = max(1, w[u, v] - rng.integers(1, 30))
    iu[n_inc], iv[n_inc], iw[n_inc] = 1, w.shape[0] + 5, 3  # v clipped
    return w_new, iu, iv, iw


@pytest.mark.parametrize("n", [64, 512, 4096])
def test_fw_seed_and_reclose_kernels_equal_plain(dev, n):
    """K12 and every K13 round against their plain versions, and the warm
    fixpoint against a cold close of the new weights."""
    w, ov, rng = fw_inputs(n, n + 1)
    at = torch.as_tensor(fw.build_allow_matrix(ov), device=dev)
    d_prev, _ = fw.fw_close(torch.as_tensor(w, device=dev), at)
    w_new, iu, iv, iw = _fw_event(w, rng, 24, 8)
    nb, bsz = fw.fw_block_shape(n)
    args = (d_prev, torch.as_tensor(w_new, device=dev),
            *(torch.as_tensor(x, device=dev) for x in (iu, iv, iw)), nb, bsz)
    before = _cuda.FW_SEED.launches
    d0, dirty, num = fw.fw_seed(*args)
    assert _cuda.FW_SEED.launches == before + 2
    d0_p, dirty_p, num_p = fw._fw_seed_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(d0, d0_p) and torch.equal(dirty, dirty_p)
    assert int(num) == int(num_p) > 0
    d_k, dirty_k, d_p, dirty_pl = d0, dirty, d0.clone(), dirty.clone()
    nd, rounds = int(num), 0
    while nd:
        kb = min(1 << (nd - 1).bit_length(), nb)
        d_k, dirty_k, counts = fw.fw_reclose(d_k, at, dirty_k, nb, bsz, kb)
        d_p, dirty_pl, num_p, changed_p = fw._fw_reclose_plain(
            d_p, at, dirty_pl, nb, bsz, kb)
        torch.cuda.synchronize()
        rounds += 1
        assert torch.equal(d_k, d_p) and torch.equal(dirty_k, dirty_pl)
        assert counts.tolist() == [int(num_p), int(changed_p)]
        nd, changed = counts.tolist()
        if changed == 0:
            break
        assert rounds <= nb + 4
    cold, _ = fw.fw_close(torch.as_tensor(w_new, device=dev), at)
    assert torch.equal(d_k, cold)


def test_apsp_state_on_card_equals_numpy(dev):
    edges = wan_edges(400, degree=4, seed=21)
    ls = LinkState("0")
    dbs = build_adj_dbs(edges)
    for db in dbs.values():
        ls.update_adjacency_database(db)
    graph = compile_graph(ls)
    card = ApspState(4096, device=dev)
    cpu = ApspState(4096, device="cpu")
    rng = np.random.default_rng(4)
    for step in range(6):
        if step:
            a, b, _ = edges[rng.integers(len(edges))]
            db = dbs[a]
            dbs[a] = dataclasses.replace(db, adjacencies=[
                dataclasses.replace(x, metric=int(rng.integers(1, 60)))
                if x.other_node_name == b else x for x in db.adjacencies
            ])
            ls.update_adjacency_database(dbs[a])
            graph = refresh_graph(graph, ls)
        assert card.ensure(graph) and cpu.ensure(graph)
        want = fw.np_floyd_warshall(fw.build_weight_matrix(graph),
                                    graph.overloaded)
        assert np.array_equal(card.d, want)
        assert card.health() == cpu.health()
    assert card.warm_closes > 0 and card.backend == "device"


def test_other_node_route_dbs_on_card_equal_cpu(dev):
    edges = grid_edges(6)
    ls = LinkState("0")
    for db in build_adj_dbs(edges, overloaded_nodes={"g2_2"}).values():
        ls.update_adjacency_database(db)
    ps = PrefixState()
    for i, node in enumerate(["g5_5", "g0_5", "g3_1"]):
        ps.update_prefix_database(PrefixDatabase(
            node, [PrefixEntry(IpPrefix(f"10.0.{i}.0/24"))], area="0"))
    solver = CudaSpfSolver("g0_0", device=dev, compute_lfa_paths=True,
                           apsp_max_nodes=4096)
    solver.build_route_db("g0_0", {"0": ls}, ps)
    before = _cuda.FW_CLOSE.launches
    for other in ("g3_3", "g5_0", "g1_4"):
        got = solver.build_route_db(other, {"0": ls}, ps)
        want = SpfSolver(other, compute_lfa_paths=True).build_route_db(
            other, {"0": ls}, ps)
        assert got.unicast_entries == want.unicast_entries
        assert got.mpls_entries == want.mpls_entries
    assert solver.host_spf_calls == 0
    assert _cuda.FW_CLOSE.launches > before


# -- differentiable TE (K14-K18) ----------------------------------------------


def te_case(name, seed=3, in_edge=False):
    """(n, src, dst, w, up): a Clos or a grid with seeded weights, a pendant
    node (gap exactly 0), one link down in one direction, and weights on
    both sides of 32 (the candidate clamps' tie at F_INF); with in_edge,
    also the position of the one edge into the pendant node."""
    from openr_tpu_torch.te import te_edge_arrays

    rng = np.random.default_rng(seed)
    base = fabric_edges(pods=2) if name == "clos" else grid_edges(6)
    edges = [(a, b, int(rng.integers(1, 9))) for a, b, _ in base]
    edges.append(("pendant", edges[0][0], 3))
    dbs = build_adj_dbs(edges)
    a, b = edges[1][:2]
    dbs[a] = dataclasses.replace(dbs[a], adjacencies=[
        dataclasses.replace(x, is_overloaded=True)
        if x.other_node_name == b else x for x in dbs[a].adjacencies])
    ls = LinkState("0")
    for db in dbs.values():
        ls.update_adjacency_database(db)
    graph = compile_graph(ls)
    src, dst, w, up = te_edge_arrays(graph)
    w[np.flatnonzero(up)[:4]] = [31.0, 32.0, 33.5, 40.0]
    if in_edge:
        pendant = graph.node_index["pendant"]
        return (graph.n, src, dst, w, up,
                int(np.flatnonzero(dst == pendant)[0]))
    return graph.n, src, dst, w, up


def rel_err(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def te_state(dev, name, tau, rounds=4, b=3):
    from openr_tpu_torch.convert import te_inputs
    from openr_tpu_torch.te import objective as to

    n, src, dst, w, up = te_case(name)
    rng = np.random.default_rng(5)
    dem = (rng.uniform(0, 2, (b, n, n)) * (1 - np.eye(n))).astype(np.float32)
    caps = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    inp = te_inputs(src, dst, w, up, dem, caps, dev)
    we = to.edge_weights(inp["w"], inp["up"])
    d = to.softmin_core(we, inp["graph"], tau, rounds)
    return inp, we, d


@pytest.mark.parametrize("name", ["clos", "grid"])
@pytest.mark.parametrize("tau", [2.0, 0.5, 0.05])
def test_softmin_round_kernels_equal_plain(dev, name, tau):
    from openr_tpu_torch.te import kernels as tk

    inp, we, d = te_state(dev, name, tau)
    graph = inp["graph"]
    before = (_cuda.SOFTMIN_ROUND.launches, _cuda.SOFTMIN_BWD.launches)
    new, keep = tk.softmin_round(d, we, graph, tau)
    new_p, _ = tk._softmin_round_plain(d, we, graph, tau)
    fin = new_p < tk.F_INF / 2
    assert torch.equal(new[~fin], new_p[~fin])
    assert rel_err(new[fin], new_p[fin]) <= 1e-5
    g = torch.randn(d.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    g_prev, g_we = tk.softmin_round_bwd(g, d, keep, we, graph, tau)
    g_prev_p, g_we_p = tk._softmin_round_bwd_plain(g, d, keep, we, graph, tau)
    torch.cuda.synchronize()
    assert rel_err(g_prev, g_prev_p) <= 1e-5
    assert rel_err(g_we, g_we_p) <= 1e-5
    assert (_cuda.SOFTMIN_ROUND.launches, _cuda.SOFTMIN_BWD.launches) == (
        before[0] + 1, before[1] + 3)


@pytest.mark.parametrize("name", ["clos", "grid"])
@pytest.mark.parametrize("tau", [2.0, 0.5, 0.05])
@pytest.mark.parametrize("b", [3, 6])
def test_soft_flow_kernels_equal_plain(dev, name, tau, b):
    """b = 6 takes the flow kernels' second pass over scenarios (4 a
    pass)."""
    from openr_tpu_torch.te import kernels as tk

    inp, we, d = te_state(dev, name, tau, rounds=inp_rounds(name), b=b)
    graph, up, caps = inp["graph"], inp["up"], inp["caps"]
    p = tk.soft_gate(d, we, up, graph, tau)
    p_p = tk._soft_gate_plain(d, we, up, graph, tau)
    assert rel_err(p, p_p) <= 1e-5
    x = inp["demands"]
    xsum, xsum_p = torch.zeros_like(x), torch.zeros_like(x)
    x1 = tk.soft_flow_round(p, x, xsum, graph)
    x1_p = tk._soft_flow_round_plain(p, x, xsum_p, graph)
    assert rel_err(x1, x1_p) <= 1e-5 and torch.equal(xsum, xsum_p)
    util = tk.soft_flow_util(p, xsum, caps, graph)
    assert rel_err(util, tk._soft_flow_util_plain(p, xsum, caps, graph)) \
        <= 1e-5
    g_util = torch.randn(util.shape, device=dev,
                         generator=torch.Generator(dev).manual_seed(2))
    g_p, g_p_p = torch.empty_like(p), torch.empty_like(p)
    lam = tk.soft_flow_bwd_round(p, g_util, caps, None, x1, g_p, graph, True)
    lam_p = tk._soft_flow_bwd_round_plain(p, g_util, caps, None, x1, g_p_p,
                                          graph, True)
    lam = tk.soft_flow_bwd_round(p, g_util, caps, lam, x, g_p, graph, False)
    lam_p = tk._soft_flow_bwd_round_plain(p, g_util, caps, lam_p, x, g_p_p,
                                          graph, False)
    assert rel_err(lam, lam_p) <= 1e-5 and rel_err(g_p, g_p_p) <= 1e-5
    g_d, g_we = tk.soft_gate_bwd(g_p, d, we, up, graph, tau)
    g_d_p, g_we_p = tk._soft_gate_bwd_plain(g_p_p, d, we, up, graph, tau)
    torch.cuda.synchronize()
    assert rel_err(g_d, g_d_p) <= 1e-5 and rel_err(g_we, g_we_p) <= 1e-5


ADJOINT_CASES = {
    # name: (n, scenarios, out-edges of the hub node 0, misaligned rows)
    "n1_b1": (1, 1, 0, False),
    "n3_b3": (3, 3, 150, False),
    "n37_b5": (37, 5, 150, False),
    "n256_b4": (256, 4, 150, False),
    "n256_b4_misaligned": (256, 4, 150, True),
    "n1028_b6": (1028, 6, 300, False),
    "n1030_b4": (1030, 4, 150, False),
}


def hub_graph(dev, n, hub_out, hub_in, seed=0):
    """A seeded TE graph on n nodes: 1 to 3 out-edges a node, node n - 1
    without out-edges and, where n > 2, node n - 2 without in-edges; the
    hub node 0 with `hub_out` more out-edges and `hub_in` more in-edges
    (repeats allowed, edge order shuffled); n = 1 has one self-loop."""
    from openr_tpu_torch.convert import te_graph

    rng = np.random.default_rng(seed)
    if n == 1:
        pairs = np.array([(0, 0)])
    else:
        targets = np.array([v for v in range(n) if n < 3 or v != n - 2])
        pairs = []
        for u in range(n - 1):
            pairs += [(u, int(v)) for v in
                      rng.choice(targets, rng.integers(1, 4))]
        pairs += [(0, int(v)) for v in rng.choice(targets, hub_out)]
        pairs += [(int(u), 0) for u in rng.integers(0, n - 1, hub_in)]
        pairs = np.array(pairs)[rng.permutation(len(pairs))]
    return te_graph(pairs[:, 0], pairs[:, 1], n, dev)


def misaligned(t):
    """A copy of t that starts 4 bytes into its buffer: no row of it is
    16-byte aligned."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return out.view(t.shape).copy_(t)


def adjoint_case(dev, n, b, hub, mis, seed=0):
    """`hub_graph` with `hub` more out-edges from node 0 and none more into
    it, and the adjoint round's inputs; with `mis`, x_r and lam_next are
    `misaligned`."""
    graph = hub_graph(dev, n, hub, 0, seed)
    e = graph.e
    gen = torch.Generator(dev).manual_seed(seed)

    def batch(t):
        return misaligned(t) if mis else t

    p = torch.rand((e, n), device=dev, generator=gen)
    p[p < 0.2] = 0.0
    x_r = torch.rand((b, n, n), device=dev, generator=gen)
    lam_next = torch.randn((b, n, n), device=dev, generator=gen)
    return {
        "graph": graph, "p": p, "x_r": batch(x_r),
        "lam_next": batch(lam_next),
        "g_util": torch.randn((b, e), device=dev, generator=gen),
        "caps": torch.rand(e, device=dev, generator=gen) * 1.5 + 0.5,
        "g_p": torch.randn((e, n), device=dev, generator=gen),
    }


@pytest.mark.parametrize("lam_given", [False, True],
                         ids=["lam_none", "lam_next"])
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("case", sorted(ADJOINT_CASES))
def test_adjoint_round_kernel_cases(dev, case, first, lam_given):
    """K17's adjoint round against its plain version within 1e-5 of the
    largest magnitude: widths 1, 3, 37 and 1,030 (the scalar path) and 256
    and 1,028 (16-byte rows), misaligned rows, 1 to 6 scenarios (a second
    pass at 5 and 6), a node without out-edges, a hub staged in two or
    three passes (128 out-edges a pass), g_p set or added to, lam_next
    given or 0. Two launches a call (scale and round); the round alone
    with the scale given is one, with the same bits."""
    from openr_tpu_torch.te import kernels as tk

    n, b, hub, misaligned = ADJOINT_CASES[case]
    a = adjoint_case(dev, n, b, hub, misaligned)
    graph, lam_next = a["graph"], a["lam_next"] if lam_given else None
    g_p, g_p_p = a["g_p"].clone(), a["g_p"].clone()
    before = _cuda.SOFT_FLOW_BWD.launches
    lam = tk.soft_flow_bwd_round(a["p"], a["g_util"], a["caps"], lam_next,
                                 a["x_r"], g_p, graph, first)
    assert _cuda.SOFT_FLOW_BWD.launches - before == 2
    lam_p = tk._soft_flow_bwd_round_plain(a["p"], a["g_util"], a["caps"],
                                          lam_next, a["x_r"], g_p_p, graph,
                                          first)
    torch.cuda.synchronize()
    assert rel_err(lam, lam_p) <= 1e-5 and rel_err(g_p, g_p_p) <= 1e-5
    c = tk.soft_flow_bwd_scale(a["g_util"], a["caps"])
    assert torch.equal(c, a["g_util"] / a["caps"].clamp_min(1e-9))
    g_p2 = a["g_p"].clone()
    before = _cuda.SOFT_FLOW_BWD.launches
    lam2 = tk.soft_flow_adjoint_round(a["p"], c, lam_next, a["x_r"], g_p2,
                                      graph, first)
    assert _cuda.SOFT_FLOW_BWD.launches - before == 1
    assert torch.equal(lam2, lam) and torch.equal(g_p2, g_p)


@pytest.mark.parametrize("n", [256, 1028])
def test_adjoint_round_paths_agree_bit_for_bit(dev, n):
    """The 16-byte path and the scalar path (taken for misaligned rows) of
    K17's adjoint round sum in the same order: equal bits."""
    from openr_tpu_torch.te import kernels as tk

    a = adjoint_case(dev, n, 4, 150, False)
    m = adjoint_case(dev, n, 4, 150, True)
    assert torch.equal(a["x_r"], m["x_r"]) and m["x_r"].data_ptr() % 16
    outs = []
    for case in (a, m):
        g_p = case["g_p"].clone()
        lam = tk.soft_flow_bwd_round(case["p"], case["g_util"], case["caps"],
                                     case["lam_next"], case["x_r"], g_p,
                                     case["graph"], False)
        outs.append((lam, g_p))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


SOFTMIN_BWD_CASES = {
    # name: (n, out-edges and in-edges of the hub node 0, misaligned D)
    "n1": (1, 0, 0, False),
    "n3": (3, 150, 150, False),
    "n37": (37, 150, 300, False),
    "n256": (256, 150, 150, False),
    "n256_misaligned": (256, 300, 150, True),
    "n1028": (1028, 300, 300, False),
    "n1030": (1030, 150, 300, False),
}


def softmin_bwd_case(dev, n, hub_out, hub_in, mis, seed=0):
    """K15's inputs on `hub_graph`: D of small integers (ties) with F_INF
    entries and a zero diagonal, weights 1 to 40 (at or below 32 a
    candidate through an F_INF entry totals F_INF exactly: the clamps'
    quarter), keep 0, 1 or 2, and g_new with zero rows and rows whose keep
    is all 2 (c = 0 there)."""
    from openr_tpu_torch.te import kernels as tk

    graph = hub_graph(dev, n, hub_out, hub_in, seed)
    rng = np.random.default_rng(seed + 1)
    d = rng.integers(0, 12, (n, n)).astype(np.float32)
    d[rng.random((n, n)) < 0.15] = tk.F_INF
    np.fill_diagonal(d, 0.0)
    keep = rng.integers(0, 3, (n, n)).astype(np.uint8)
    g = rng.standard_normal((n, n)).astype(np.float32)
    rows = rng.choice(n, max(1, n // 8), replace=False)
    g[rows[::2]] = 0.0
    keep[rows[1::2]] = 2
    we = rng.integers(1, 41, graph.e).astype(np.float32)
    d_t = torch.as_tensor(d, device=dev)
    return {
        "graph": graph, "d": misaligned(d_t) if mis else d_t,
        "keep": torch.as_tensor(keep, device=dev),
        "g_new": torch.as_tensor(g, device=dev),
        "we": torch.as_tensor(we, device=dev),
    }


@pytest.mark.parametrize("tau", [2.0, 0.5])
@pytest.mark.parametrize("case", sorted(SOFTMIN_BWD_CASES))
def test_softmin_bwd_kernel_cases(dev, case, tau):
    """K15 against its plain version within 1e-5 of the largest magnitude:
    widths 1, 3, 37 and 1,030 (the pull's scalar path) and 256 and 1,028
    (16-byte rows), a misaligned D (the scalar path at 256), a node
    without out-edges and one without in-edges, a hub whose out- and
    in-edges are staged in two or three passes (128 edges a pass), keep 0,
    1 and 2, F_INF candidates at weights up to 32 (the clamps' quarter),
    rows whose c is 0. Three launches a call (rows, pull, edges); a second
    call gives the same bits."""
    from openr_tpu_torch.te import kernels as tk

    n = SOFTMIN_BWD_CASES[case][0]
    a = softmin_bwd_case(dev, *SOFTMIN_BWD_CASES[case])
    args = (a["g_new"], a["d"], a["keep"], a["we"], a["graph"], tau)
    before = _cuda.SOFTMIN_BWD.launches
    g_prev, g_we = tk.softmin_round_bwd(*args)
    assert _cuda.SOFTMIN_BWD.launches - before == 3
    g_prev2, g_we2 = tk.softmin_round_bwd(*args)
    g_prev_p, g_we_p = tk._softmin_round_bwd_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(g_prev).all())
    # one node has only its diagonal, whose gradient is 0
    assert n == 1 or bool(g_prev.abs().max() > 0)
    assert rel_err(g_prev, g_prev_p) <= 1e-5
    assert rel_err(g_we, g_we_p) <= 1e-5
    assert torch.equal(g_prev, g_prev2) and torch.equal(g_we, g_we2)


@pytest.mark.parametrize("n", [256, 1028])
def test_softmin_bwd_paths_agree_bit_for_bit(dev, n):
    """K15's pull reads D with 16-byte loads where its rows are aligned and
    column by column where not, in the same order: equal bits."""
    from openr_tpu_torch.te import kernels as tk

    a = softmin_bwd_case(dev, n, 150, 300, False)
    m = dict(a, d=misaligned(a["d"]))
    assert torch.equal(a["d"], m["d"]) and m["d"].data_ptr() % 16
    outs = [tk.softmin_round_bwd(c["g_new"], c["d"], c["keep"], c["we"],
                                 c["graph"], 0.5) for c in (a, m)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_softmin_quotient_bits_equal_the_correctly_rounded_division(dev):
    """K14-K17 divide by tau through tau's reciprocal (a product and two
    fused corrections) before an exp, where the first designs used
    __fdiv_rn: at every temperature of the annealing schedules of 8 and 48
    steps and at the tests' 2.0, 0.5 and 0.05, exp of the two quotients has
    the same bits for every exponent they can meet (each float a <= 0, |a|
    <= 2^32)."""
    from openr_tpu_torch.te import kernels as tk
    from openr_tpu_torch.te.optimizer import TeOptConfig, anneal_tau

    cfg = TeOptConfig()
    taus = sorted({tk.f32(anneal_tau(cfg, i, s)) for s in (8, 48)
                   for i in range(s)} | {2.0, 0.5, 0.05})
    before = _cuda.SOFTMIN_DIV_CHECK.launches
    differ = {tau: tk.softmin_div_check(tau, dev) for tau in taus}
    assert differ == {tau: 0 for tau in taus}
    assert _cuda.SOFTMIN_DIV_CHECK.launches - before == len(taus)
    with pytest.raises(ValueError):
        tk.softmin_div_check(0.5, "cpu")


@pytest.mark.parametrize("tau", [2.0, 0.5])
@pytest.mark.parametrize("case", sorted(SOFTMIN_BWD_CASES))
def test_softmin_round_kernel_cases(dev, case, tau):
    """K14 against its plain version on K15's cases: widths 1, 3, 37 and
    1,030 (the scalar path) and 256 and 1,028 (16-byte rows), a misaligned
    D (the scalar path at 256), a node without out-edges and one without
    in-edges, hubs of 150 and 300 out-edges (staged in two or three
    passes), F_INF entries and small-integer D (ties of the fold). D'
    within 1e-5 of the largest magnitude with its F_INF entries equal; the
    fold's outcome consistent with D and D' (1 or 2: D' = D, 0: D' < D off
    the diagonal, the diagonal 0); one launch a call; a second call gives
    the same bits."""
    from openr_tpu_torch.te import kernels as tk

    n = SOFTMIN_BWD_CASES[case][0]
    a = softmin_bwd_case(dev, *SOFTMIN_BWD_CASES[case])
    d = a["d"]
    args = (d, a["we"], a["graph"], tau)
    before = _cuda.SOFTMIN_ROUND.launches
    new, keep = tk.softmin_round(*args)
    assert _cuda.SOFTMIN_ROUND.launches - before == 1
    new2, keep2 = tk.softmin_round(*args)
    new_p, _ = tk._softmin_round_plain(*args)
    torch.cuda.synchronize()
    fin = new_p < tk.F_INF / 2
    assert torch.equal(new[~fin], new_p[~fin])
    assert rel_err(new[fin], new_p[fin]) <= 1e-5
    assert torch.equal(new, new2) and torch.equal(keep, keep2)
    off = ~torch.eye(n, dtype=torch.bool, device=dev)
    held, taken = off & (keep > 0), off & (keep == 0)
    assert bool((keep <= 2).all())
    assert torch.equal(new[held], d[held])
    assert bool((new[taken] < d[taken]).all())
    assert bool((new.diagonal() == 0).all())


@pytest.mark.parametrize("n", [256, 1028])
def test_softmin_round_paths_agree_bit_for_bit(dev, n):
    """K14 reads D with 16-byte loads and writes D' and keep 16 and 4 bytes
    at a time where the rows are aligned, and column by column where not,
    in the same order: equal bits."""
    from openr_tpu_torch.te import kernels as tk

    a = softmin_bwd_case(dev, n, 150, 300, False)
    d_m = misaligned(a["d"])
    assert torch.equal(a["d"], d_m) and d_m.data_ptr() % 16
    outs = [tk.softmin_round(d, a["we"], a["graph"], 0.5)
            for d in (a["d"], d_m)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def gate_case(dev, n, hub_out, hub_in, mis, seed=0):
    """The gate's inputs on `hub_graph`: D of small integers (gap == 0
    ties) with F_INF entries (where D[dst, t] >= F_INF / 2 the score is 0)
    and a zero diagonal, integer weights 1 to 8, a tenth of the edges down,
    node 1's out-edges all down and node 2's weighted 200 (both
    denominators <= 1e-20 at tau 2.0 and 0.5), g_p from a seeded normal;
    with `mis`, D and g_p misaligned (the pull's scalar path)."""
    from openr_tpu_torch.te import kernels as tk

    graph = hub_graph(dev, n, hub_out, hub_in, seed)
    rng = np.random.default_rng(seed + 3)
    d = rng.integers(0, 12, (n, n)).astype(np.float32)
    d[rng.random((n, n)) < 0.15] = tk.F_INF
    np.fill_diagonal(d, 0.0)
    we = rng.integers(1, 9, graph.e).astype(np.float32)
    up = rng.random(graph.e) >= 0.1
    if n > 2:
        src = graph.src.cpu().numpy()
        up[src == 1] = False
        we[src == 2] = 200.0
    g_p = rng.standard_normal((graph.e, n)).astype(np.float32)

    def on(x):
        t = torch.as_tensor(x, device=dev)
        return misaligned(t) if mis else t

    return {"graph": graph, "d": on(d), "g_p": on(g_p),
            "we": torch.as_tensor(we, device=dev),
            "up": torch.as_tensor(up, device=dev)}


@pytest.mark.parametrize("tau", [2.0, 0.5])
@pytest.mark.parametrize("case", sorted(SOFTMIN_BWD_CASES))
def test_soft_gate_and_its_backward_kernel_cases(dev, case, tau):
    """The gate (K16) and its backward (K17) against their plain versions
    within 1e-5 of the largest magnitude on K15's cases (widths 1 to
    1,030, misaligned rows, a node without out-edges and one without
    in-edges, hubs of 150 and 300 out- and in-edges staged in two or three
    passes), with down edges, F_INF entries of D, gap == 0 ties and nodes
    whose denominator is <= 1e-20. The backward: three launches a call (rows,
    pull, edges); a second call on a fresh g_p gives the same bits, g_p's
    overwritten gap gradients too."""
    from openr_tpu_torch.te import kernels as tk

    a = gate_case(dev, *SOFTMIN_BWD_CASES[case])
    args = (a["d"], a["we"], a["up"], a["graph"], tau)
    p = tk.soft_gate(*args)
    assert rel_err(p, tk._soft_gate_plain(*args)) <= 1e-5
    g1, g2 = a["g_p"].clone(), a["g_p"].clone()
    before = _cuda.SOFT_FLOW_BWD.launches
    g_d, g_we = tk.soft_gate_bwd(g1, *args)
    assert _cuda.SOFT_FLOW_BWD.launches - before == 3
    g_d2, g_we2 = tk.soft_gate_bwd(g2, *args)
    g_d_p, g_we_p = tk._soft_gate_bwd_plain(a["g_p"], *args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(g_d).all()) and bool(torch.isfinite(g1).all())
    assert rel_err(g_d, g_d_p) <= 1e-5 and rel_err(g_we, g_we_p) <= 1e-5
    assert torch.equal(g_d, g_d2) and torch.equal(g_we, g_we2)
    assert torch.equal(g1, g2)


@pytest.mark.parametrize("n", [256, 1028])
def test_soft_gate_bwd_paths_agree_bit_for_bit(dev, n):
    """The gate backward's pull moves 4 columns with 16-byte loads where the
    rows are aligned and column by column where not, in the same order:
    equal bits of g_d, g_we and the overwritten g_p."""
    from openr_tpu_torch.te import kernels as tk

    a = gate_case(dev, n, 150, 300, False)
    m = gate_case(dev, n, 150, 300, True)
    assert torch.equal(a["g_p"], m["g_p"]) and m["g_p"].data_ptr() % 16
    outs = []
    for c in (a, m):
        g = c["g_p"].clone() if c is a else c["g_p"]
        outs.append((*tk.soft_gate_bwd(g, c["d"], c["we"], c["up"],
                                       c["graph"], 0.5), g))
    for x, y in zip(*outs):
        assert torch.equal(x, y)


FLOW_CASES = {
    # name: (n, scenarios, in-edges of the hub node 0, misaligned x)
    "n1_b1": (1, 1, 0, False),
    "n3_b2": (3, 2, 150, False),
    "n37_b5": (37, 5, 150, False),
    "n256_b4": (256, 4, 150, False),
    "n256_b4_misaligned": (256, 4, 300, True),
    "n1028_b6": (1028, 6, 300, False),
    "n1030_b3": (1030, 3, 300, False),
}


def flow_case(dev, n, b, hub_in, mis, seed=0):
    """K16's round inputs on `hub_graph`: p with zeros and all-zero rows,
    x and xsum non-negative (x misaligned with `mis`)."""
    graph = hub_graph(dev, n, 3, hub_in, seed)
    rng = np.random.default_rng(seed + 2)
    p = rng.random((graph.e, n)).astype(np.float32)
    p[p < 0.2] = 0.0
    p[rng.random(graph.e) < 0.1] = 0.0
    x = rng.random((b, n, n)).astype(np.float32)
    xs = rng.random((b, n, n)).astype(np.float32)
    x_t = torch.as_tensor(x, device=dev)
    return {
        "graph": graph, "p": torch.as_tensor(p, device=dev),
        "x": misaligned(x_t) if mis else x_t,
        "xsum": torch.as_tensor(xs, device=dev),
    }


@pytest.mark.parametrize("xsum_given", [True, False],
                         ids=["xsum", "xsum_none"])
@pytest.mark.parametrize("case", sorted(FLOW_CASES))
def test_soft_flow_round_kernel_cases(dev, case, xsum_given):
    """K16's flow round against its plain version within 1e-5 of the
    largest magnitude (xsum exactly: one add an entry): widths 1 to 1,030,
    1 to 6 scenarios (a second pass at 5 and 6), misaligned x (the scalar
    path), xsum given or None, all-zero p rows, a hub whose in-edges are
    staged in two or three passes. One launch a call; a second call gives
    the same bits."""
    from openr_tpu_torch.te import kernels as tk

    a = flow_case(dev, *FLOW_CASES[case])
    graph, p, x = a["graph"], a["p"], a["x"]
    xs = a["xsum"].clone() if xsum_given else None
    xs2 = a["xsum"].clone() if xsum_given else None
    xs_p = a["xsum"].clone() if xsum_given else None
    before = _cuda.SOFT_FLOW.launches
    x1 = tk.soft_flow_round(p, x, xs, graph)
    assert _cuda.SOFT_FLOW.launches - before == 1
    x1_2 = tk.soft_flow_round(p, x, xs2, graph)
    x1_p = tk._soft_flow_round_plain(p, x, xs_p, graph)
    torch.cuda.synchronize()
    assert FLOW_CASES[case][0] == 1 or bool(x1.abs().max() > 0)
    assert rel_err(x1, x1_p) <= 1e-5
    assert torch.equal(x1, x1_2)
    if xsum_given:
        assert torch.equal(xs, xs_p) and torch.equal(xs2, xs_p)


@pytest.mark.parametrize("n", [256, 1028])
def test_soft_flow_round_paths_agree_bit_for_bit(dev, n):
    """K16's flow round moves 4 columns with 16-byte loads where the rows
    are aligned and columns kThreads apart where not, in the same order:
    equal bits, x_next and xsum."""
    from openr_tpu_torch.te import kernels as tk

    a = flow_case(dev, n, 4, 300, False)
    x_m = misaligned(a["x"])
    assert torch.equal(a["x"], x_m) and x_m.data_ptr() % 16
    outs = []
    for x in (a["x"], x_m):
        xs = a["xsum"].clone()
        outs.append((tk.soft_flow_round(a["p"], x, xs, a["graph"]), xs))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def inp_rounds(name):
    return 6 if name == "clos" else 8


def test_te_step_kernels_equal_plain(dev):
    from openr_tpu_torch.te import kernels as tk
    from openr_tpu_torch.te.optimizer import TeOptConfig

    gen = torch.Generator(dev).manual_seed(3)
    util = torch.rand((4, 3000), device=dev, generator=gen) * 3
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0], device=dev)
    loss, lse = tk.te_mlu(util, mask, 0.25)
    loss_p, lse_p = tk._te_mlu_plain(util, mask, 0.25)
    assert rel_err(loss, loss_p) <= 1e-6 and rel_err(lse, lse_p) <= 1e-6
    g_loss = torch.ones(1, device=dev)
    g = tk.te_mlu_bwd(g_loss, util, lse, mask, 0.25)
    assert rel_err(g, tk._te_mlu_bwd_plain(g_loss, util, lse, mask, 0.25)) \
        <= 1e-5
    assert not bool(g[2].any())
    e = 3000
    w = torch.rand(e, device=dev, generator=gen) * 60 + 1
    m = torch.randn(e, device=dev, generator=gen) * 1e-2
    v = torch.rand(e, device=dev, generator=gen) * 1e-4
    gr = torch.randn(e, device=dev, generator=gen)
    up = torch.rand(e, device=dev, generator=gen) > 0.1
    hp = tk.adam_hparams(TeOptConfig(), 5)
    state = [t.clone() for t in (w, m, v)]
    row, row_p = torch.empty(e, device=dev), torch.empty(e, device=dev)
    tk.te_adam(*state, gr, up, row, hp)
    plain = [t.clone() for t in (w, m, v)]
    tk._te_adam_plain(*plain, gr, up, row_p, hp)
    for a, b in zip(state + [row], plain + [row_p]):
        assert rel_err(a, b) <= 1e-6


@pytest.mark.parametrize("name", ["clos", "grid"])
def test_te_autograd_on_card_equals_cpu(dev, name):
    """SoftminRound and SoftFlow under autograd (K14-K17 and their launch
    counts) against the same chain on the CPU's plain versions."""
    from openr_tpu_torch.te import objective as to

    out = {}
    for device in (dev, torch.device("cpu")):
        inp, _, _ = te_state(device, name, 0.5, rounds=0, b=5)
        w = inp["w"].clone().requires_grad_(True)
        we = to.edge_weights(w, inp["up"])
        util = to.utilization_core(we, inp["up"], inp["demands"],
                                   inp["caps"], inp["graph"], 0.5, 24)
        (g,) = torch.autograd.grad(util.sum(), w)
        out[device.type] = (util.detach().cpu(), g.cpu())
    assert rel_err(out["cuda"][0], out["cpu"][0]) <= 1e-5
    assert rel_err(out["cuda"][1], out["cpu"][1]) <= 1e-4


def test_adam_solve_on_card_equals_cpu(dev):
    """Four Adam steps on a Clos with seeded metrics, on the card and on the
    CPU. No pendant node and no weight at 32 here: a triangle gap of
    exactly 0 (a node with one out-edge) is a tie that float32 rounding may
    decide either way once D is computed in another order, and Adam turns
    a flipped half-gradient on a small component into a different step."""
    from openr_tpu_torch.convert import te_inputs
    from openr_tpu_torch.te import te_edge_arrays
    from openr_tpu_torch.te.optimizer import TeOptConfig, adam_solve

    rng = np.random.default_rng(4)
    edges = [(a, b, int(rng.integers(1, 10))) for a, b, _ in
             fabric_edges(pods=2)]
    ls = LinkState("0")
    for db in build_adj_dbs(edges).values():
        ls.update_adjacency_database(db)
    graph = compile_graph(ls)
    src, dst, w, up = te_edge_arrays(graph)
    n = graph.n
    dem = (rng.uniform(0, 2, (3, n, n)) * (1 - np.eye(n))).astype(np.float32)
    caps = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    runs = {}
    for device in (dev, torch.device("cpu")):
        inp = te_inputs(src, dst, w, up, dem, caps, device)
        mask = torch.tensor([1.0, 0.0, 1.0], device=device)
        before = _cuda.TE_STEP.launches
        runs[device.type] = adam_solve(
            inp["w"], inp["demands"], mask, inp["caps"], inp["graph"],
            inp["up"], TeOptConfig(), 16, 4)
        if device.type == "cuda":
            assert _cuda.TE_STEP.launches - before == 3 * 4
    (_, wh_k, ls_k), (_, wh_c, ls_c) = runs["cuda"], runs["cpu"]
    assert float((wh_k.cpu() - wh_c).abs().max()) <= 1e-3
    assert rel_err(ls_k, ls_c) <= 1e-4


def test_te_service_on_card_equals_cpu(dev):
    """The acceptance fixture (one scenario): 6.0 -> 2.0 on the card with
    the CPU run's proposal; at the bench's 4 scenarios the worst scenario
    scales the elephant, and the card's scores still equal the CPU's."""
    from openr_tpu_torch.te import TeService, congested_clos_fixture

    edges, spec = congested_clos_fixture()
    for params, scores in (({"steps": 48, "seed": 0}, (6.0, 2.0)),
                           ({"steps": 48, "scenarios": 4}, None)):
        reports = []
        for device in (dev, "cpu"):
            ls = LinkState("0")
            for db in build_adj_dbs(edges).values():
                ls.update_adjacency_database(db)
            svc = TeService("l0_0", {"0": ls}, device=device)
            reports.append(svc.optimize(dict(params, demands=spec)))
            assert svc.counters.get("decision.te.fallback_runs", 0) == 0
        card, cpu = reports
        assert card["degraded"] is False and card["improved"] is True
        for key in ("initial_max_util", "optimized_max_util",
                    "weight_changes", "top_links"):
            assert card[key] == cpu[key], key
        if scores is not None:
            assert (card["initial_max_util"],
                    card["optimized_max_util"]) == scores


# -- the pendant-node TE input (ROADMAP queue 3, item 1) ---------------------


def pendant_adam(device, name, rounds=16, steps=4):
    """4 Adam steps on te_case(name) with 3 scenarios, the middle one
    masked: the input of the CPU cases in tests/test_torch_te.py. Returns
    (weight trajectory, losses, the edge into the pendant node)."""
    from openr_tpu_torch.convert import te_inputs
    from openr_tpu_torch.te.optimizer import TeOptConfig, adam_solve

    n, src, dst, w, up, in_edge = te_case(name, in_edge=True)
    rng = np.random.default_rng(5)
    dem = (rng.uniform(0, 2, (3, n, n)) * (1 - np.eye(n))).astype(np.float32)
    caps = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    inp = te_inputs(src, dst, w, up, dem, caps, device)
    mask = torch.tensor([1.0, 0.0, 1.0], device=device)
    _, wh, ls = adam_solve(inp["w"], inp["demands"], mask, inp["caps"],
                           inp["graph"], inp["up"], TeOptConfig(), rounds,
                           steps)
    return wh.cpu(), ls.cpu(), in_edge


# measured on an NVIDIA H100 80GB HBM3 (700 W): the largest weight gap,
# all of it on the edge into the pendant node
_CARD_PENDANT_GAPS = {"clos": 0.483, "grid": 2.06}


@pytest.mark.parametrize("name", ["clos", "grid"])
def test_adam_solve_on_the_pendant_case_card_equals_cpu(dev, name, request):
    """adam_solve on te_case, the card against the CPU, at PERF.md's
    tolerances (5e-3 on the weights, 1e-4 on the losses). It fails on the
    edge into the pendant node alone, as the CPU path fails against the
    reference (tests/test_torch_te.py): that edge's gradient is at float32
    rounding level, and Adam normalises it to a step of up to lr."""
    request.node.add_marker(pytest.mark.xfail(strict=True, reason=(
        f"the pendant's in-edge departs by {_CARD_PENDANT_GAPS[name]} "
        "(rounding-level gradient, Adam-normalised); ROADMAP queue 3 "
        "item 1")))
    card, cpu = pendant_adam(dev, name), pendant_adam("cpu", name)
    assert float((card[0] - cpu[0]).abs().max()) <= 5e-3
    assert rel_err(card[1], cpu[1]) <= 1e-4


@pytest.mark.parametrize("name", ["clos", "grid"])
def test_the_pendant_case_card_departs_on_the_pendant_edge_alone(dev, name):
    """The finding behind the strict xfail above: every weight but the edge
    into the pendant node within 5e-3 of the CPU's over 4 steps, and the
    losses within 1e-4."""
    card, cpu = pendant_adam(dev, name), pendant_adam("cpu", name)
    rest = torch.ones(card[0].shape[1], dtype=torch.bool)
    rest[card[2]] = False
    assert float((card[0] - cpu[0])[:, rest].abs().max()) <= 5e-3
    assert rel_err(card[1], cpu[1]) <= 1e-4


def softmin_chain(device, name, tau, rounds=40):
    """K14's chain of rounds from the cold D on te_case (on the CPU: the
    plain version's): per round the fold outcome and the gate's gap == 0
    set, both on the CPU."""
    from openr_tpu_torch.convert import te_inputs
    from openr_tpu_torch.te import kernels as tk
    from openr_tpu_torch.te import objective as to

    n, src, dst, w, up = te_case(name)
    inp = te_inputs(src, dst, w, up, np.zeros((1, n, n), np.float32),
                    np.ones(len(src), np.float32), device)
    we = to.edge_weights(inp["w"], inp["up"])
    d = torch.full((n, n), tk.F_INF, device=device)
    d.fill_diagonal_(0.0)
    out = []
    for _ in range(rounds):
        d, keep = tk.softmin_round(d, we, inp["graph"], tau)
        gap, _ = tk._gate_score(d, we, inp["up"], inp["graph"], tau)
        out.append((keep.cpu(), (gap == 0).cpu()))
    return out


@pytest.mark.parametrize("tau", [2.0, 0.5, 0.05])
@pytest.mark.parametrize("name", ["clos", "grid"])
def test_tie_sets_of_the_card_chain_equal_the_cpu_chain(dev, name, tau,
                                                        request):
    """The forward decisions the backward reads, bit for bit, round by
    round over 40 rounds: K14's recorded fold outcome and the gate's
    gap == 0 set along the card's chain against the plain versions' along
    the CPU's. At tau 0.5 the chains' D differ by one float32 spacing
    after about a dozen rounds and near-converged entries tie on one side
    and not the other (as the CPU path's do against the reference's)."""
    if tau == 0.5:
        request.node.add_marker(pytest.mark.xfail(strict=True, reason={
            "clos": "measured: up to 530 fold outcomes a round (round 30) "
                    "and up to 7 gap == 0 entries differ from round 20 on",
            "grid": "measured: up to 2 fold outcomes and 1 gap == 0 entry "
                    "differ in rounds 12-14",
        }[name] + "; D one float32 spacing apart"))
    card, cpu = softmin_chain(dev, name, tau), softmin_chain("cpu", name, tau)
    for r, ((k_a, g_a), (k_b, g_b)) in enumerate(zip(card, cpu)):
        assert torch.equal(k_a, k_b), ("fold outcome", r)
        assert torch.equal(g_a, g_b), ("gap == 0", r)


@pytest.mark.xfail(strict=True, reason=(
    "measured: 16,715 fold outcomes over 40 rounds at tau 2.0 on the Clos: "
    "the plain version's softmin on the card rounds otherwise (torch's exp "
    "and index_add's atomic order), while a converged entry ties with "
    "K14's own recomputation"))
def test_k14_fold_outcome_equals_the_plain_version_on_the_same_d(dev):
    """K14's recorded fold outcome against the plain version's on the same
    D, on the card."""
    from openr_tpu_torch.convert import te_inputs
    from openr_tpu_torch.te import kernels as tk
    from openr_tpu_torch.te import objective as to

    n, src, dst, w, up = te_case("clos")
    inp = te_inputs(src, dst, w, up, np.zeros((1, n, n), np.float32),
                    np.ones(len(src), np.float32), dev)
    we = to.edge_weights(inp["w"], inp["up"])
    d = torch.full((n, n), tk.F_INF, device=dev)
    d.fill_diagonal_(0.0)
    for r in range(40):
        new, keep = tk.softmin_round(d, we, inp["graph"], 2.0)
        _, keep_p = tk._softmin_round_plain(d, we, inp["graph"], 2.0)
        assert torch.equal(keep, keep_p), r
        d = new


# -- the tiled layout (K19-K21) ----------------------------------------------


def tile_inputs(dev, name, g, s=6, seed=0):
    """Partition j = 1 of a graph axis of g over a small graph, with a
    random tile, an overloaded source and transit node, seed and mark
    masks: (tiling, kwargs of tile_round, offset, d)."""
    from openr_tpu_torch.parallel import tile_graph

    edges, overloaded = GRAPHS[name]
    graph = compile_edges(edges, overloaded_nodes=overloaded)
    tiling = tile_graph(graph, g)
    rng = np.random.default_rng(seed)
    j = 1
    n_tile = tiling.n_tile
    sources = rng.choice(graph.n, s).astype(np.int32)
    sources[0] = j * n_tile  # a source whose column this tile holds
    d = rng.integers(0, 90, (s, n_tile)).astype(np.int32)
    d[rng.random(d.shape) < 0.2] = INF
    ov = graph.overloaded.copy()
    ov[j * n_tile] = True
    ov_new = ov.copy()
    ov_new[j * n_tile + 1] = True
    w_new = tiling.w[j].copy()
    w_new[::3] = np.minimum(w_new[::3] + 2, INF)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    base = dict(sources=t(sources), overloaded=t(ov, torch.bool),
                offset=j * n_tile, src_l=t(tiling.src_l[j]),
                hseg=t(tiling.hseg[j]), hptr=t(tiling.hptr[j]),
                w2=t(tiling.w[j]), h=tiling.h)
    masks = [{}, {"w_new": t(w_new), "ov_new": t(ov_new, torch.bool)},
             {"marks": t(rng.random(d.shape) < 0.4, torch.bool)}]
    return tiling, base, masks, t(d), j


@pytest.mark.parametrize("g", [2, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tile_round_and_fold_kernels_equal_plain(dev, name, g):
    """K19 (plain, seed and mark masks) and K20 (own and foreign
    frontiers) against their plain versions, on tiles whose h is not a
    multiple of 32 on most graphs, and partitions with no edges at g = 8
    on the small ones."""
    tiling, base, masks, d, j = tile_inputs(dev, name, g)
    for kw in masks:
        before = _cuda.TILE_ROUND.launches
        ctr = spf.tile_round(d, **base, **kw)
        assert _cuda.TILE_ROUND.launches == before + 1
        want = spf._tile_round_plain(d, **base, **kw)
        torch.cuda.synchronize()
        assert torch.equal(ctr, want)
        for k in (j, (j + 1) % g):
            cols = torch.as_tensor(tiling.hcols[k], device=dev)
            flag, flag_p = (torch.zeros(1, dtype=torch.int32, device=dev)
                            for _ in range(2))
            out = spf.tile_fold(d.clone(), ctr, cols, j, flag)
            out_p = spf._tile_fold_plain(d.clone(), ctr, cols, j, flag_p)
            torch.cuda.synchronize()
            assert torch.equal(out, out_p) and torch.equal(flag, flag_p)


def test_tile_kernels_at_odd_shapes(dev):
    """K19 with h = 13 and a partition without edges (all slots INF); K20
    with every slot a sentinel and with nothing to lower; K21's entries
    on a 5 x 7 tile."""
    rng = np.random.default_rng(3)
    d = torch.as_tensor(rng.integers(0, 50, (5, 7)).astype(np.int32),
                        device=dev)
    src = torch.as_tensor(np.array([7, 8, 3, 9, 13], np.int32), device=dev)
    ov = torch.zeros(14, dtype=torch.bool, device=dev)
    ov[9] = True
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    hptr = torch.zeros(14, dtype=torch.int32, device=dev)
    ctr = spf.tile_round(d, src, ov, 7, empty, empty, hptr, empty, 13)
    torch.cuda.synchronize()
    assert ctr.shape == (5, 13) and bool((ctr == INF).all())
    sentinel = torch.full((13,), spf.TILE_PAD, dtype=torch.int32, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    out = spf.tile_fold(d.clone(), torch.zeros_like(ctr), sentinel, 1, flag)
    torch.cuda.synchronize()
    assert torch.equal(out, d) and int(flag.item()) == 0
    cols = torch.arange(7, 20, dtype=torch.int32, device=dev)
    spf.tile_fold(out, ctr, cols, 1, flag)  # INF lowers nothing
    assert torch.equal(out, d) and int(flag.item()) == 0
    check_tile_mark_kernel(dev, d, src, 7)


def check_tile_mark_kernel(dev, dp, src, offset):
    """K21's four entries against their plain versions on one tile."""
    s_l, n_tile = dp.shape
    cpu = torch.device("cpu")
    rng = np.random.default_rng(5)
    recv_h = dp.cpu().clone()
    recv_h[torch.as_tensor(rng.random(dp.shape) < 0.7)] += 1
    m_h = torch.as_tensor(rng.random(dp.shape) < 0.2)
    cc_h = torch.as_tensor(rng.random(n_tile) < 0.3)
    got, want = {}, {}
    for device, out in ((dev, got), (cpu, want)):
        s_d, dp_d = src.to(device), dp.to(device)
        out["init"] = spf.tile_init(s_d, offset, n_tile)
        for m in (None, m_h.to(device)):
            recv = recv_h.clone().to(device)  # tile_mark resets it
            flag = torch.zeros(1, dtype=torch.int32, device=device)
            new = spf.tile_mark(m, recv, dp_d, flag)
            out["mark", m is None] = (new, int(flag.item()),
                                      bool((recv == INF).all()))
        out["reset"] = spf.tile_reset(m_h.to(device), dp_d, s_d, offset)
        cc = cc_h.clone().to(device)
        count = torch.zeros(1, dtype=torch.int32, device=device)
        d2 = dp_d.clone()
        d2[s_l - 1, ::2] += 1
        spf.tile_col_changed(d2, dp_d, cc, count)
        out["cols"] = (cc, int(count.item()))
    torch.cuda.synchronize()
    assert torch.equal(got["init"].cpu(), want["init"])
    assert torch.equal(got["reset"].cpu(), want["reset"])
    for key in (("mark", True), ("mark", False)):
        assert torch.equal(got[key][0].cpu(), want[key][0])
        assert got[key][1:] == want[key][1:]
    assert torch.equal(got["cols"][0].cpu(), want["cols"][0])
    assert got["cols"][1] == want["cols"][1]


def tiled_case(name, g):
    """A graph, its tiling on a graph axis of g, 16 sources and a warm
    event (weights and one newly overloaded source)."""
    from openr_tpu_torch.parallel import tile_graph

    edges, overloaded = GRAPHS[name]
    graph = compile_edges(edges, overloaded_nodes=overloaded)
    tiling = tile_graph(graph, g)
    rows = sources_for(graph, 14)[:16]
    w_new, _, _ = event_for(graph, seed=1)
    ov_new = graph.overloaded.copy()
    ov_new[rows[3]] = True
    return graph, tiling, rows, w_new, ov_new


def tiled_run(devices, shape, graph, tiling, rows, w_new, ov_new):
    """`_tile_solver`, then `_tile_solver_warm` on the event, on a mesh of
    `devices`: (D, rounds, ring copies, warm D, rounds, inv_rounds,
    col_changed, num_changed, warm ring copies), on the host."""
    from openr_tpu_torch import convert
    from openr_tpu_torch.parallel import make_mesh

    key = tiling.shape_key() + (graph.n_pad,)
    mesh = make_mesh(devices, shape)
    ops = convert.tiling_ranks(tiling, mesh)
    src = convert.rank_sources(mesh, rows)
    ov = convert.rank_replicas(mesh, graph.overloaded, bool)
    d, rounds, copies = spf._tile_solver(key, mesh, src, ops["src_l"],
                                         ops["hseg"], ops["hptr"], ops["w2"],
                                         ops["hcols"], ov)
    dw = spf._tile_solver_warm(
        key, mesh, src, ops["src_l"], ops["hseg"], ops["hptr"],
        convert.rank_rows(mesh, tiling.tile_weights(w_new), np.int32),
        ops["w2"], ops["hcols"],
        convert.rank_replicas(mesh, ov_new, bool), ov, d)
    return (d.numpy(), rounds, copies, dw[0].numpy(), dw[1], dw[2],
            torch.cat([c.cpu() for c in dw[3]]).numpy(), int(dw[4]), dw[5])


def assert_runs_equal(got, want):
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("name", ["wan", "clos", "grid"])
def test_tiled_solves_on_card_equal_cpu(dev, name, shape):
    """`_tile_solver` and `_tile_solver_warm` on a mesh of ranks sharing
    the card against the same on the CPU (the plain versions), all five
    warm outputs, and D against K1's unsharded solve."""
    case = tiled_case(name, shape[1])
    n = shape[0] * shape[1]
    card = tiled_run([dev] * n, shape, *case)
    cpu = tiled_run([torch.device("cpu")] * n, shape, *case)
    assert_runs_equal(card, cpu)
    graph, rows = case[0], case[2]
    want = spf.batched_spf(graph, rows, device=dev).cpu().numpy()
    np.testing.assert_array_equal(card[0], want)


# -- meshes across cards ------------------------------------------------------


@pytest.fixture
def cards(dev):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more NVIDIA cards (device_count() is {n})")
    return [torch.device("cuda", i) for i in range(n)]


def spread(cards, n):
    """n mesh positions dealt over the cards in turn: neighbours on a ring
    lie on different cards, and with more positions than cards a card
    holds several ranks."""
    return [cards[k % len(cards)] for k in range(n)]


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2), (2, 4)])
@pytest.mark.parametrize("name", ["wan", "clos", "grid"])
def test_tiled_solves_across_cards_equal_one_card(cards, name, shape):
    """The tiled solves with the ranks spread over the cards: each rank's
    kernels run on its own card and the ring hops are copies between
    cards. Every output, the ring copies among them, equals the same mesh
    on one card, and D equals K1's unsharded solve."""
    case = tiled_case(name, shape[1])
    n = shape[0] * shape[1]
    got = tiled_run(spread(cards, n), shape, *case)
    want = tiled_run([cards[0]] * n, shape, *case)
    assert_runs_equal(got, want)
    graph, rows = case[0], case[2]
    k1 = spf.batched_spf(graph, rows, device=cards[0]).cpu().numpy()
    np.testing.assert_array_equal(got[0], k1)


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_row_sharded_step_across_cards_equals_one_card(cards, name, shape):
    """`sharded_spf_step` with the batch ranks spread over the cards (K1
    on the sliced layout, K2 on the edge-list one, then K3 on each graph
    rank's edge slice): D and the DAG equal the same mesh on one card,
    and D equals the unsharded solve."""
    from openr_tpu_torch.parallel import make_mesh, sharded_spf_step

    edges, overloaded = GRAPHS[name]
    graph = compile_edges(edges, overloaded_nodes=overloaded)
    rows = np.arange(graph.n, dtype=np.int32)
    n = shape[0] * shape[1]
    out = []
    for devices in (spread(cards, n), [cards[0]] * n):
        d, dag = sharded_spf_step(graph, rows, make_mesh(devices, shape))
        out.append((d.numpy()[: graph.n], [t.cpu() for t in dag]))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    want = spf.batched_spf(graph, rows, device=cards[0]).cpu().numpy()
    np.testing.assert_array_equal(out[0][0], want[: graph.n])


@pytest.mark.parametrize("shape", [(1, 4), (4, 1), (2, 2)])
def test_mesh_route_db_across_cards_equals_cpu(cards, shape):
    """CudaSpfSolver on a mesh spread over the cards, tiled and
    row-sharded: route dbs cold and after a warm event equal the CPU
    oracle's. With as many cards as ranks the mesh is the shape itself,
    laid over distinct cards by `resolve_mesh`."""
    from openr_tpu_torch.parallel import make_mesh

    edges, _ = GRAPHS["clos"]
    ls = LinkState("0")
    for db in build_adj_dbs(edges).values():
        ls.update_adjacency_database(db)
    ps = PrefixState()
    for i, node in enumerate(sorted(ls.node_names())):
        ps.update_prefix_database(PrefixDatabase(
            node, [PrefixEntry(IpPrefix(f"10.0.{i}.0/24"))], area="0"))
    me = "rsw0_0"
    n = shape[0] * shape[1]
    mesh = shape if len(cards) >= n else make_mesh(spread(cards, n), shape)
    solver = CudaSpfSolver(me, device=cards[0], mesh=mesh)
    assert len(set(solver.mesh.devices.flat)) == min(n, len(cards))
    for metric in (None, 7):
        if metric is not None:
            db = ls.get_adjacency_databases()["fsw0_1"]
            ls.update_adjacency_database(dataclasses.replace(
                db, adjacencies=[dataclasses.replace(a, metric=metric)
                                 for a in db.adjacencies]))
        got = solver.build_route_db(me, {"0": ls}, ps)
        want = SpfSolver(me).build_route_db(me, {"0": ls}, ps)
        assert got.unicast_entries == want.unicast_entries
        assert got.mpls_entries == want.mpls_entries
    assert solver.counters["decision.spf.incremental_solves"] == 1
    solve = solver._solves[("0", me)][1]
    np.testing.assert_array_equal(solve.d, solve.cold_reference_d())


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("name", ["wan", "extreme"])
def test_ksp2_route_db_across_cards_equals_cpu(cards, name, shape):
    """KSP2 under a mesh spread over the cards: the cold masked solves
    split over the batch ranks (K8 and K9, or K2 per row on the edge-list
    layout); the route db equals the CPU oracle's."""
    from openr_tpu_torch.parallel import make_mesh

    edges, ov = GRAPHS[name]
    if name == "extreme":  # a ring through the leaves: second paths exist
        leaves = sorted({b for _, b, _ in edges})
        edges = edges + [(a, b, 2) for a, b in zip(leaves, leaves[1:])]
    ls = LinkState("0")
    for db in build_adj_dbs(edges, overloaded_nodes=ov).values():
        ls.update_adjacency_database(db)
    names = sorted(ls.node_names())
    me = names[0]
    ps = PrefixState()
    for i, node in enumerate(names[1::max(1, len(names) // 6)]):
        ps.update_prefix_database(PrefixDatabase(node, [PrefixEntry(
            IpPrefix(f"10.0.{i}.0/24"),
            forwarding_type=PrefixForwardingType.SR_MPLS,
            forwarding_algorithm=PrefixForwardingAlgorithm.KSP2_ED_ECMP,
        )], area="0"))
    mesh = make_mesh(spread(cards, shape[0] * shape[1]), shape)
    solver = CudaSpfSolver(me, device=cards[0], mesh=mesh)
    got = solver.build_route_db(me, {"0": ls}, ps)
    want = SpfSolver(me).build_route_db(me, {"0": ls}, ps)
    assert got.unicast_entries == want.unicast_entries
    assert got.mpls_entries == want.mpls_entries
    assert solver._solves[("0", me)][1].ksp_device_batches >= 1


@pytest.mark.parametrize("shape", [(1, 4), (4, 1)])
def test_mesh_route_db_on_card_equals_cpu(dev, shape):
    """CudaSpfSolver on a mesh of ranks sharing the card, tiled and
    row-sharded: route dbs cold and after a warm event equal the CPU
    oracle's, with the tile kernels launched on the tiled one."""
    from openr_tpu_torch.parallel import make_mesh

    edges, _ = GRAPHS["clos"]
    ls = LinkState("0")
    for db in build_adj_dbs(edges).values():
        ls.update_adjacency_database(db)
    ps = PrefixState()
    for i, node in enumerate(sorted(ls.node_names())):
        ps.update_prefix_database(PrefixDatabase(
            node, [PrefixEntry(IpPrefix(f"10.0.{i}.0/24"))], area="0"))
    me = "rsw0_0"
    mesh = make_mesh([dev] * 4, shape)
    solver = CudaSpfSolver(me, device=dev, mesh=mesh)
    before = _cuda.TILE_ROUND.launches
    for metric in (None, 7):
        if metric is not None:
            db = ls.get_adjacency_databases()["fsw0_1"]
            ls.update_adjacency_database(dataclasses.replace(
                db, adjacencies=[dataclasses.replace(a, metric=metric)
                                 for a in db.adjacencies]))
        got = solver.build_route_db(me, {"0": ls}, ps)
        want = SpfSolver(me).build_route_db(me, {"0": ls}, ps)
        assert got.unicast_entries == want.unicast_entries
        assert got.mpls_entries == want.mpls_entries
    assert solver.counters["decision.spf.incremental_solves"] == 1
    assert (_cuda.TILE_ROUND.launches > before) == (shape[1] > 1)
