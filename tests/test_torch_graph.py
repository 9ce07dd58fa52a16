"""openr_tpu_torch graph compiler against the JAX package's.

The same topology, built with each package's own LinkState, must compile to
identical arrays: node renumbering by in-degree, the destination-sorted
edge list, the sliced-ELL buckets and the link -> edge-position map; and a
refresh after a weight or overload event must patch them identically.
Exact equality throughout: the compiler is integer numpy code.
"""

import dataclasses

import numpy as np
import pytest

from openr_tpu.lsdb import LinkState as JLinkState
from openr_tpu.ops import graph as jgraph
from openr_tpu.topology import build_adj_dbs as j_build_adj_dbs
from openr_tpu_torch.convert import graph_arrays, graph_from_arrays
from openr_tpu_torch.lsdb import LinkState as TLinkState
from openr_tpu_torch.ops import graph as tgraph
from openr_tpu_torch.topology import (
    build_adj_dbs as t_build_adj_dbs,
    fabric_edges,
    grid_edges,
    ring_edges,
    wan_edges,
)

TOPOLOGIES = {
    "grid": grid_edges(4),
    "ring": [(f"r{i}", f"r{(i + 1) % 8}", 1 + i % 3) for i in range(8)],
    "clos": fabric_edges(
        pods=2, planes=2, ssw_per_plane=2, fsw_per_pod=2, rsw_per_pod=4
    ),
    "wan": wan_edges(200, degree=4, seed=5),
    "star": [("hub", f"leaf{i:03d}", 1 + i % 5) for i in range(40)],
}


def both_ls(edges, overloaded=None):
    j, t = JLinkState("0"), TLinkState("0")
    for db in j_build_adj_dbs(edges, overloaded_nodes=overloaded).values():
        j.update_adjacency_database(db)
    for db in t_build_adj_dbs(edges, overloaded_nodes=overloaded).values():
        t.update_adjacency_database(db)
    return j, t


def assert_graph_equal(jg, tg):
    a, b = graph_arrays(jg), graph_arrays(tg)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], tuple) and a[k] and isinstance(a[k][0], np.ndarray):
            assert len(a[k]) == len(b[k]), k
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y, err_msg=k)
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def link_positions(graph):
    return {link.key: pos for link, pos in graph.link_edges.items()}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_compile_graph_matches_jax(name):
    j, t = both_ls(TOPOLOGIES[name], overloaded={"g1_1", "r3", "w7"})
    jg, tg = jgraph.compile_graph(j), tgraph.compile_graph(t)
    assert_graph_equal(jg, tg)
    assert link_positions(jg) == link_positions(tg)
    assert (jg.version, jg.log_pos) == (tg.version, tg.log_pos)


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_compile_edges_matches_jax(name):
    edges = TOPOLOGIES[name]
    ov = {edges[0][0]}
    assert_graph_equal(
        jgraph.compile_edges(edges, ov), tgraph.compile_edges(edges, ov)
    )


def test_extreme_degree_has_no_sliced_layout():
    edges = [("hub", f"leaf{i:04d}", 1) for i in range(1100)]
    jg, tg = jgraph.compile_edges(edges), tgraph.compile_edges(edges)
    assert jg.sell is None and tg.sell is None
    assert_graph_equal(jg, tg)


def test_graph_from_arrays_round_trip():
    jg = jgraph.compile_edges(TOPOLOGIES["clos"])
    tg = graph_from_arrays(graph_arrays(jg))
    assert isinstance(tg, tgraph.CompiledGraph)
    assert_graph_equal(jg, tg)
    assert tg.sell.shape_key() == jg.sell.shape_key()


def edit(link_states, node, other, **changes):
    for ls in link_states:
        db = ls.get_adjacency_databases()[node]
        adjs = [
            dataclasses.replace(a, **changes) if a.other_node_name == other
            else a
            for a in db.adjacencies
        ]
        ls.update_adjacency_database(dataclasses.replace(db, adjacencies=adjs))


def test_refresh_matches_jax():
    j, t = both_ls(grid_edges(4))
    jg, tg = jgraph.compile_graph(j), tgraph.compile_graph(t)
    edit((j, t), "g1_1", "g1_2", metric=7)
    edit((j, t), "g2_2", "g3_2", is_overloaded=True)  # link down
    jg2, tg2 = jgraph.refresh_graph(jg, j), tgraph.refresh_graph(tg, t)
    assert tg2.src is tg.src  # weight patch, not a rebuild
    assert_graph_equal(jg2, tg2)
    np.testing.assert_array_equal(jg2.changed_edges, tg2.changed_edges)
    assert tg2.parent_version == jg2.parent_version
    # a node drain is an overload patch
    for ls in (j, t):
        db = ls.get_adjacency_databases()["g0_1"]
        ls.update_adjacency_database(
            dataclasses.replace(db, is_overloaded=True)
        )
    jg3, tg3 = jgraph.refresh_graph(jg2, j), tgraph.refresh_graph(tg2, t)
    assert_graph_equal(jg3, tg3)
    assert tg3.overloaded[tg3.node_index["g0_1"]]
