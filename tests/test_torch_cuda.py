"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and nvcc and skips elsewhere. This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The graphs are small but cover what the main path's shapes do not: an
overloaded transit node, a bucket wider than 32 slots, a graph too wide for
the sliced layout, per-row weights, a batch padded with repeated sources.
Tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from openr_tpu_torch.convert import to_device
from openr_tpu_torch.lsdb import LinkState, PrefixState
from openr_tpu_torch.ops import _cuda
from openr_tpu_torch.ops import spf
from openr_tpu_torch.ops.graph import INF, compile_edges
from openr_tpu_torch.solver import CudaSpfSolver
from openr_tpu_torch.topology import (
    build_adj_dbs,
    fabric_edges,
    grid_edges,
    wan_edges,
)
from openr_tpu_torch.types import IpPrefix, PrefixDatabase, PrefixEntry

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
