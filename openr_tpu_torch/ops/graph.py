"""LSDB graph → padded device arrays.

The dynamic string-keyed LinkState graph becomes static-shaped int32 arrays:
directed edge list (src, dst, w) sorted by destination, plus a per-node
overload mask. Node and edge counts are padded to power-of-two buckets so
that incremental topology changes (single link flap) keep every buffer's
shape and the device buffers can be patched in place.

Node ids are assigned by ascending in-degree ("sliced-ELL" renumbering): the
relaxation kernel can then process nodes in contiguous equal-degree slices,
each slice being pure row-gathers + vector mins with zero scatter and
near-zero slot padding (ops/spf.py:_sell_relax).

Reference semantics compiled in:
  - only up links participate (LinkState.cpp:844 skips !link->isUp())
  - per-direction metrics (Link::getMetricFromNode)
  - overloaded nodes carry no transit traffic (LinkState.cpp:829-836); the
    mask is applied per-source inside the solver since a source's own edges
    remain usable
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from openr_tpu_torch.lsdb.link_state import LinkState
from openr_tpu_torch.lsdb.link_state import Link

# int32-safe infinity: INF + max edge weight must not overflow int32
INF = 1 << 29


def _next_bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class SlicedEll:
    """Degree-bucketed pull layout (node ids pre-sorted by in-degree).

    Rows [0, zero_end) have no in-edges (isolated nodes); row range k is
    [starts[k], starts[k] + nbr[k].shape[0]) and relaxes via dk =
    nbr[k].shape[1] row-gathers; rows [starts[-1] + nbr[-1].shape[0], n_pad)
    are array padding. Degree classes merge adjacent in-degrees when the
    slot padding stays under _SELL_WASTE_FRAC of the edge count.
    """

    zero_end: int
    starts: Tuple[int, ...]
    nbr: Tuple[np.ndarray, ...]  # int32 [nk, dk] in-neighbor ids
    wg: Tuple[np.ndarray, ...]  # int32 [nk, dk]; INF for slot padding
    # edge position p in the dst-sorted arrays -> its (bucket, row-within-
    # bucket, slot) for incremental weight patches
    edge_bucket: np.ndarray  # int32 [e]
    edge_row: np.ndarray  # int32 [e]
    edge_slot: np.ndarray  # int32 [e]

    def shape_key(self) -> Tuple:
        """Static structure key: two graphs with equal keys share every
        device buffer shape (weight patches never change it)."""
        return (
            self.zero_end,
            self.starts,
            tuple(a.shape for a in self.nbr),
        )

    def patched_wg(self, w_edges: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Fresh wg bucket arrays carrying `w_edges` (length e, dst-sorted
        edge order) — the weight-variant path for benches/KSP rows."""
        out = [a.copy() for a in self.wg]
        for k in range(len(out)):
            sel = self.edge_bucket == k
            out[k][self.edge_row[sel], self.edge_slot[sel]] = w_edges[sel]
        return tuple(out)


@dataclass
class CompiledGraph:
    """Static-shaped arrays for one LinkState snapshot.

    Down links are present in the arrays with INF weight (they never relax),
    so link flaps and metric changes are pure weight patches — the arrays
    keep their shape and identity.
    """

    names: List[str]  # index -> node name (real nodes only)
    node_index: Dict[str, int]
    n: int  # real node count
    e: int  # real directed edge count (up and down links)
    n_pad: int
    e_pad: int
    src: np.ndarray  # int32 [e_pad], padded entries point at 0 with INF w
    dst: np.ndarray  # int32 [e_pad], sorted ascending (real entries)
    w: np.ndarray  # int32 [e_pad]; INF for down links and padding
    overloaded: np.ndarray  # bool [n_pad]
    # Link object -> its two directed-edge positions in the padded arrays
    # (forward = n1->n2, reverse = n2->n1); lets callers mask individual
    # links out of a solve (KSP link-ignore semantics, LinkState.cpp:760-789)
    link_edges: Dict[Link, Tuple[int, int]] = field(default_factory=dict)
    # snapshot markers for incremental refresh (refresh_graph)
    version: int = -1  # LinkState.version at compile time
    log_pos: int = 0  # LinkState.graph_log_pos at compile time
    # sliced-ELL pull layout; None when the degree profile disqualifies it
    # (_SELL_UNROLL_CAP) and the edge-list segment-min form is used instead
    sell: Optional[SlicedEll] = None
    # provenance of a weight-patch refresh: the version this graph was
    # patched FROM and the edge positions whose weights differ — lets the
    # device-buffer layer skip its O(E) diff when its snapshot matches
    # parent_version. None/-2 for full builds.
    parent_version: int = -2
    changed_edges: Optional[np.ndarray] = None


# Degree-class merging: adjacent in-degrees merge while the extra padded
# slots stay under this fraction of the real edge count; the unroll cap
# bounds trace/compile cost (sum of class degrees = relaxation ops per
# round), beyond it the edge-list form wins anyway.
_SELL_WASTE_FRAC = 0.25
_SELL_UNROLL_CAP = 1024


def _build_sell(
    dst_sorted: np.ndarray,  # int32 [e] (real edges, ids ascending by degree)
    src_sorted: np.ndarray,
    w_sorted: np.ndarray,
    n: int,
    indeg: np.ndarray,  # int32 [n] in-degree per (renumbered) node id
) -> Optional[SlicedEll]:
    e = len(dst_sorted)
    if e == 0:
        return None
    zero_end = int(np.searchsorted(indeg, 1))
    # unique degrees ascending + node counts (ids are degree-sorted)
    degs, counts = np.unique(indeg[zero_end:], return_counts=True)

    # merge adjacent degrees into classes under the waste budget
    classes: List[Tuple[int, int]] = []  # (class_degree, node_count)
    waste_budget = _SELL_WASTE_FRAC * e
    cum_nodes = cum_edges = 0
    start_i = 0
    for i, (d, c) in enumerate(zip(degs, counts)):
        if i > start_i and cum_nodes * int(d) - cum_edges > waste_budget:
            classes.append((int(degs[i - 1]), cum_nodes))
            start_i = i
            cum_nodes = cum_edges = 0
        cum_nodes += int(c)
        cum_edges += int(c) * int(d)
    classes.append((int(degs[-1]), cum_nodes))
    if sum(d for d, _ in classes) > _SELL_UNROLL_CAP:
        return None

    starts: List[int] = []
    nbrs: List[np.ndarray] = []
    wgs: List[np.ndarray] = []
    edge_bucket = np.empty(e, dtype=np.int32)
    edge_row = np.empty(e, dtype=np.int32)
    edge_slot = np.empty(e, dtype=np.int32)

    csr_starts = np.concatenate([[0], np.cumsum(indeg)])
    row_lo = zero_end
    for k, (dk, nk) in enumerate(classes):
        row_hi = row_lo + nk
        lo_e, hi_e = int(csr_starts[row_lo]), int(csr_starts[row_hi])
        nbr_k = np.zeros((nk, dk), dtype=np.int32)
        wg_k = np.full((nk, dk), INF, dtype=np.int32)
        rows = dst_sorted[lo_e:hi_e] - row_lo
        slots = np.arange(lo_e, hi_e) - csr_starts[dst_sorted[lo_e:hi_e]]
        nbr_k[rows, slots] = src_sorted[lo_e:hi_e]
        wg_k[rows, slots] = w_sorted[lo_e:hi_e]
        edge_bucket[lo_e:hi_e] = k
        edge_row[lo_e:hi_e] = rows
        edge_slot[lo_e:hi_e] = slots
        starts.append(row_lo)
        nbrs.append(nbr_k)
        wgs.append(wg_k)
        row_lo = row_hi

    return SlicedEll(
        zero_end=zero_end,
        starts=tuple(starts),
        nbr=tuple(nbrs),
        wg=tuple(wgs),
        edge_bucket=edge_bucket,
        edge_row=edge_row,
        edge_slot=edge_slot,
    )


def _compile_arrays(
    names_sorted: List[str],
    srcs: np.ndarray,  # int32 [e] preliminary ids (sorted-name order)
    dsts: np.ndarray,
    ws: np.ndarray,
    overloaded_by_prelim: np.ndarray,  # bool [n]
    version: int = -1,
    log_pos: int = 0,
) -> Tuple[CompiledGraph, np.ndarray]:
    """Shared core: renumber nodes by in-degree, sort edges by destination,
    build the sliced-ELL layout. Returns (graph, pos) where pos[i] is the
    final array position of input edge i."""
    n = len(names_sorted)
    e = len(srcs)
    n_pad = _next_bucket(max(n, 1))
    e_pad = _next_bucket(max(e, 1))

    indeg_prelim = np.bincount(dsts, minlength=n) if e else np.zeros(n, int)
    order_nodes = np.argsort(indeg_prelim, kind="stable")
    perm = np.empty(n, dtype=np.int32)
    perm[order_nodes] = np.arange(n, dtype=np.int32)
    names = [names_sorted[i] for i in order_nodes]
    node_index = {name: i for i, name in enumerate(names)}
    indeg = indeg_prelim[order_nodes].astype(np.int32)

    src = np.zeros(e_pad, dtype=np.int32)
    dst = np.zeros(e_pad, dtype=np.int32)
    w = np.full(e_pad, INF, dtype=np.int32)
    pos = np.empty(e, dtype=np.int64)
    sell = None
    if e:
        psrc = perm[srcs]
        pdst = perm[dsts]
        order = np.argsort(pdst, kind="stable")
        src[:e] = psrc[order]
        dst[:e] = pdst[order]
        w[:e] = np.asarray(ws, dtype=np.int32)[order]
        # padded edges must not break sorted-segment assumptions: point them
        # at the last real destination
        dst[e:] = dst[e - 1]
        pos[order] = np.arange(e)
        sell = _build_sell(dst[:e], src[:e], w[:e], n, indeg)

    overloaded = np.zeros(n_pad, dtype=bool)
    overloaded[:n] = overloaded_by_prelim[order_nodes]

    graph = CompiledGraph(
        names=names,
        node_index=node_index,
        n=n,
        e=e,
        n_pad=n_pad,
        e_pad=e_pad,
        src=src,
        dst=dst,
        w=w,
        overloaded=overloaded,
        version=version,
        log_pos=log_pos,
        sell=sell,
    )
    return graph, pos


def compile_graph(link_state: LinkState) -> CompiledGraph:
    names_sorted = sorted(
        set(link_state.get_adjacency_databases().keys())
        | {n for link in link_state.all_links for n in (link.n1, link.n2)}
    )
    prelim_index = {name: i for i, name in enumerate(names_sorted)}

    srcs: List[int] = []
    dsts: List[int] = []
    ws: List[int] = []
    links: List[Link] = []
    for link in sorted(link_state.all_links):
        # down links stay in the arrays at INF weight (LinkState.cpp:844
        # semantics — they never relax) so a flap is a weight patch, not a
        # structural rebuild
        up = link.is_up()
        links.append(link)
        i1, i2 = prelim_index[link.n1], prelim_index[link.n2]
        srcs.append(i1)
        dsts.append(i2)
        ws.append(link.metric_from_node(link.n1) if up else INF)
        srcs.append(i2)
        dsts.append(i1)
        ws.append(link.metric_from_node(link.n2) if up else INF)

    overloaded = np.array(
        [link_state.is_node_overloaded(name) for name in names_sorted],
        dtype=bool,
    )
    graph, pos = _compile_arrays(
        names_sorted,
        np.asarray(srcs, dtype=np.int32),
        np.asarray(dsts, dtype=np.int32),
        np.asarray(ws, dtype=np.int32),
        overloaded,
        version=link_state.version,
        log_pos=link_state.graph_log_pos,
    )
    for i, link in enumerate(links):
        graph.link_edges[link] = (int(pos[2 * i]), int(pos[2 * i + 1]))
    return graph


def compile_edges(
    edges: Sequence[Tuple[str, str, int]],
    overloaded_nodes: Optional[set] = None,
) -> CompiledGraph:
    """Edge list -> CompiledGraph, numpy-vectorized: the fast path for
    synthetic benchmark topologies where building a LinkState (a python
    object graph) would dominate setup time at 100k+ nodes. No link_edges
    mapping and no refresh support (version stays -1)."""
    names_sorted = sorted({n for a, b, _ in edges for n in (a, b)})
    prelim_index = {name: i for i, name in enumerate(names_sorted)}
    a = np.fromiter((prelim_index[x] for x, _, _ in edges), np.int32)
    b = np.fromiter((prelim_index[y] for _, y, _ in edges), np.int32)
    m = np.fromiter((wt for _, _, wt in edges), np.int32)
    overloaded = np.zeros(len(names_sorted), dtype=bool)
    for name in overloaded_nodes or ():
        overloaded[prelim_index[name]] = True
    graph, _ = _compile_arrays(
        names_sorted,
        np.concatenate([a, b]),
        np.concatenate([b, a]),
        np.concatenate([m, m]),
        overloaded,
    )
    return graph


def refresh_graph(graph: CompiledGraph, link_state: LinkState) -> CompiledGraph:
    """Bring a compiled snapshot up to date with its LinkState.

    Replays the LinkState graph changelog since the snapshot: pure
    weight/overload changes (link flap, metric change, drain) patch copies of
    the w/overloaded arrays in place — same shapes, no recompilation and no
    O(E) Python rebuild; structural changes (link/node add/remove) or a
    dropped changelog fall back to a full compile_graph. This is the
    single-link-flap incremental event path (BASELINE.md config 2)."""
    if graph.version == link_state.version:
        return graph
    changes = link_state.graph_changes_since(graph.log_pos)
    if changes is None or any(kind == "structure" for kind, _ in changes):
        return compile_graph(link_state)

    w = graph.w.copy()
    sell = graph.sell
    wgs = [a.copy() for a in sell.wg] if sell is not None else None
    overloaded = graph.overloaded.copy()
    touched: List[int] = []
    for kind, obj in changes:
        if kind == "link":
            pos = graph.link_edges.get(obj)
            if pos is None:  # changelog raced a structural entry we missed
                return compile_graph(link_state)
            up = obj.is_up()
            for p, metric in (
                (pos[0], obj.metric_from_node(obj.n1)),
                (pos[1], obj.metric_from_node(obj.n2)),
            ):
                w[p] = metric if up else INF
                touched.append(p)
                if wgs is not None:
                    wgs[sell.edge_bucket[p]][
                        sell.edge_row[p], sell.edge_slot[p]
                    ] = w[p]
        else:  # "node"
            i = graph.node_index.get(obj)
            if i is None:
                return compile_graph(link_state)
            overloaded[i] = link_state.is_node_overloaded(obj)

    new_sell = None
    if sell is not None:
        new_sell = SlicedEll(
            zero_end=sell.zero_end,
            starts=sell.starts,
            nbr=sell.nbr,
            wg=tuple(wgs),
            edge_bucket=sell.edge_bucket,
            edge_row=sell.edge_row,
            edge_slot=sell.edge_slot,
        )
    return CompiledGraph(
        names=graph.names,
        node_index=graph.node_index,
        n=graph.n,
        e=graph.e,
        n_pad=graph.n_pad,
        e_pad=graph.e_pad,
        src=graph.src,
        dst=graph.dst,
        w=w,
        overloaded=overloaded,
        link_edges=graph.link_edges,
        version=link_state.version,
        log_pos=link_state.graph_log_pos,
        sell=new_sell,
        parent_version=graph.version,
        changed_edges=np.unique(np.asarray(touched, dtype=np.int64)),
    )
