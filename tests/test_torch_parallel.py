"""The port's mesh helpers and graph-axis tiling against the JAX package's.

The counterpart of tests/test_parallel.py and the ladder tests of
tests/test_tpu_solver_tiled.py: the degradation ladder and its plan,
`tile_graph` and `tile_weights` array for array at graph axes 2, 4 and 8
(and the port's one derived array, hptr, checked against hseg), the
carry-across of a tiling onto a mesh's ranks, and the row-sharded batched
solve and solver step against the reference's on the 8-device virtual CPU
mesh. Exact equality throughout.
"""

import numpy as np
import pytest
import torch

from openr_tpu import parallel as jpar
from openr_tpu.lsdb import LinkState as JLinkState
from openr_tpu.ops import batched_spf as j_batched_spf
from openr_tpu.ops.graph import compile_graph as j_compile_graph
from openr_tpu.topology import build_adj_dbs as j_build_adj_dbs
from openr_tpu_torch import convert, parallel
from openr_tpu_torch.ops.graph import INF
from openr_tpu_torch.topology import fabric_edges, grid_edges, wan_edges
from test_torch_memory import release_memory_around_each_test  # noqa: F401

GRAPHS = {
    "grid6": grid_edges(6),
    "wan100": wan_edges(100, seed=2),
    "clos": fabric_edges(pods=2, planes=2, ssw_per_plane=2, fsw_per_pod=2,
                         rsw_per_pod=3),
}
SHAPES = [(4, 2), (2, 4), (1, 1), (8, 1), (2, 2), (1, 8)]


def graphs(edges):
    """(the reference's compiled graph, the port's from its arrays)."""
    ls = JLinkState("0")
    for db in j_build_adj_dbs(edges).values():
        ls.update_adjacency_database(db)
    g = j_compile_graph(ls)
    return g, convert.graph_from_arrays(convert.graph_arrays(g))


def cpu_mesh(shape):
    return parallel.make_mesh([torch.device("cpu")] * (shape[0] * shape[1]),
                              shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_shrink_candidates_equal_the_reference(shape):
    assert parallel.shrink_candidates(shape) == jpar.shrink_candidates(shape)


def test_ladder_shapes():
    assert parallel.shrink_candidates((4, 2)) == [(2, 2), (1, 2), (1, 1)]
    assert parallel.shrink_candidates((2, 4)) == [(1, 4), (1, 2), (1, 1)]
    assert parallel.shrink_candidates((1, 1)) == []


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 2), (1, 1)])
def test_plan_degraded_mesh_equals_the_reference(shape):
    got = parallel.plan_degraded_mesh(cpu_mesh(shape))
    want = jpar.plan_degraded_mesh(jpar.resolve_mesh(shape))
    if want is None:
        assert got is None  # no rung below one device
    else:
        assert got.shape == dict(want.shape)
        assert got.devices.shape == want.devices.shape


def test_surviving_devices_and_a_dead_one():
    devs = [torch.device("cpu")] * 4
    assert parallel.surviving_devices(devs) == devs
    # a device that cannot take the probe is left out of the next mesh
    assert parallel.surviving_devices([torch.device("meta"), *devs]) == devs


def test_make_and_resolve_mesh():
    mesh = cpu_mesh((2, 4))
    assert mesh.shape == {"batch": 2, "graph": 4}
    assert mesh.devices.shape == (2, 4)
    assert parallel.resolve_mesh(mesh) is mesh
    assert parallel.resolve_mesh(None) is None
    one = parallel.resolve_mesh((1, 1), device="cpu")
    assert one.shape == {"batch": 1, "graph": 1}
    # one CPU device cannot hold eight ranks of distinct devices
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        parallel.resolve_mesh((2, 4), device="cpu")
    with pytest.raises(ValueError, match=r"must be \(batch, graph\)"):
        parallel.resolve_mesh((8,), device="cpu")
    with pytest.raises(ValueError, match="does not hold"):
        parallel.make_mesh([torch.device("cpu")] * 3, (2, 2))


@pytest.mark.parametrize("g", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tile_graph_equals_the_reference(name, g):
    jg, tg = graphs(GRAPHS[name])
    want = jpar.tile_graph(jg, g)
    got = parallel.tile_graph(tg, g)
    assert got.shape_key() == want.shape_key()
    assert (got.e, got.tile_bytes(), got.halo_bytes()) == (
        want.e, want.tile_bytes(), want.halo_bytes())
    for field in ("src_l", "hseg", "w", "hcols", "edge_tile", "edge_pos"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    rng = np.random.default_rng(g)
    w_new = np.array(tg.w)
    w_new[: tg.e] = rng.integers(1, 50, size=tg.e)
    np.testing.assert_array_equal(got.tile_weights(w_new),
                                  want.tile_weights(w_new))
    # hptr: slot k's range holds exactly the real edges of slot k, and the
    # padding slot h - 1 holds none
    counts = np.bincount(got.edge_tile, minlength=g)
    for t in range(g):
        k = counts[t]
        assert got.hptr[t, 0] == 0 and got.hptr[t, -1] == k
        slot = np.repeat(np.arange(got.h), np.diff(got.hptr[t]))
        np.testing.assert_array_equal(slot, got.hseg[t, :k])
        assert got.hptr[t, -2] == k  # slot h - 1 is empty


def test_tiling_ranks_from_either_package_agree():
    jg, tg = graphs(GRAPHS["wan100"])
    mesh = cpu_mesh((2, 4))
    got = convert.tiling_ranks(parallel.tile_graph(tg, 4), mesh)
    want = convert.tiling_ranks(jpar.tile_graph(jg, 4), mesh)
    for name in ("src_l", "hseg", "w2", "hcols", "hptr"):
        for i in range(2):
            for j in range(4):
                assert torch.equal(got[name][i][j], want[name][i][j]), name
        # ranks of one graph rank on one device share one upload
        assert got[name][0][1] is got[name][1][1]


def test_row_sharded_matches_single_device():
    jg, tg = graphs(grid_edges(5))
    rows = np.arange(tg.n_pad, dtype=np.int32)
    d = parallel.sharded_batched_spf(tg, rows, cpu_mesh((8, 1)))
    assert len(d.blocks) == 8
    want = np.asarray(jpar.sharded_batched_spf(
        jg, rows, jpar.make_mesh(shape=(8, 1))))
    np.testing.assert_array_equal(d.numpy(), want)
    np.testing.assert_array_equal(d.numpy()[: tg.n_pad],
                                  np.asarray(j_batched_spf(jg, rows)))


def test_uneven_batch_padding():
    jg, tg = graphs(grid_edges(3))  # 9 nodes, 16 padded
    rows = np.arange(tg.n, dtype=np.int32)  # 9 sources, not a multiple of 8
    d = parallel.sharded_batched_spf(tg, rows, cpu_mesh((8, 1)))
    assert d.shape == (16, tg.n_pad)
    np.testing.assert_array_equal(d.numpy()[: tg.n],
                                  np.asarray(j_batched_spf(jg, rows)))


def test_edge_list_row_sharded_matches_the_reference():
    star = [("hub", f"leaf{i:04d}", 1 + i % 5) for i in range(1100)]
    jg, tg = graphs(star)
    assert tg.sell is None
    rows = np.arange(12, dtype=np.int32)
    d = parallel.sharded_batched_spf(tg, rows, cpu_mesh((4, 1)))
    want = np.asarray(jpar.sharded_batched_spf(
        jg, rows, jpar.make_mesh(jpar.resolve_mesh((4, 1)).devices.flat,
                                 (4, 1))))
    np.testing.assert_array_equal(d.numpy(), want)
    assert int(d.numpy()[0, 1]) < INF


def test_two_axis_step():
    jg, tg = graphs(grid_edges(4))
    rows = np.arange(tg.n_pad, dtype=np.int32)
    d, dag = parallel.sharded_spf_step(tg, rows, cpu_mesh((4, 2)))
    jd, jdag = jpar.sharded_spf_step(jg, rows, jpar.make_mesh(shape=(4, 2)))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert len(dag) == 2  # the edges split over 'graph'
    np.testing.assert_array_equal(torch.cat(dag).numpy(), np.asarray(jdag))
