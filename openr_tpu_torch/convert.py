"""Carry a compiled graph across packages and onto the card.

The system has no weights: its state is the compiled graph. A compiled graph
from any producer (the JAX package included) travels as a dict of plain
Python values and numpy arrays, which `graph_from_arrays` turns into the
port's `CompiledGraph`. `to_device` uploads the persistent tensors a solve
reads.

Under a solver mesh every rank of the (batch, graph) grid holds its own
tensors on its device: `per_rank` builds such a grid, `rank_rows` the
tiled layout's per-partition rows (one row of each [g, ...] array on each
graph rank), and `tiling_ranks` carries a GraphTiling of either package
across, its numpy arrays in, the port's per-rank tensors out.

Traffic engineering's "weights" are the edge arrays, demands and
capacities of `te.objective.te_edge_arrays` and `te.scenarios`, numpy in
both packages: `te_inputs` uploads them with the two edge-range layouts
(`TeGraph`) the TE kernels walk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.ops.graph import CompiledGraph, SlicedEll
from openr_tpu_torch.ops.spf import TILE_PAD, edge_csr
from openr_tpu_torch.parallel.mesh import tile_hptr

_SCALARS = ("n", "e", "n_pad", "e_pad")
_ARRAYS = {"src": np.int32, "dst": np.int32, "w": np.int32, "overloaded": bool}
_SELL_ARRAYS = ("edge_bucket", "edge_row", "edge_slot")


def graph_arrays(graph) -> Dict:
    """The fields `graph_from_arrays` takes, read from any object with a
    CompiledGraph's attributes."""
    out = {
        "names": list(graph.names),
        "node_index": dict(graph.node_index),
        **{k: int(getattr(graph, k)) for k in _SCALARS},
        **{k: np.asarray(getattr(graph, k)) for k in _ARRAYS},
    }
    sell = graph.sell
    if sell is not None:
        out["sell.zero_end"] = int(sell.zero_end)
        out["sell.starts"] = tuple(int(s) for s in sell.starts)
        out["sell.nbr"] = tuple(np.asarray(a) for a in sell.nbr)
        out["sell.wg"] = tuple(np.asarray(a) for a in sell.wg)
        for k in _SELL_ARRAYS:
            out[f"sell.{k}"] = np.asarray(getattr(sell, k))
    return out


def graph_from_arrays(arrays: Dict) -> CompiledGraph:
    """Build the port's CompiledGraph from plain values and numpy arrays
    (keys as produced by `graph_arrays`; the `sell.*` keys are absent for a
    graph without the sliced-ELL layout). No link_edges mapping, so the
    result does not support refresh_graph."""
    sell = None
    if "sell.zero_end" in arrays:
        sell = SlicedEll(
            zero_end=int(arrays["sell.zero_end"]),
            starts=tuple(int(s) for s in arrays["sell.starts"]),
            nbr=tuple(
                np.array(a, dtype=np.int32) for a in arrays["sell.nbr"]
            ),
            wg=tuple(np.array(a, dtype=np.int32) for a in arrays["sell.wg"]),
            **{
                k: np.array(arrays[f"sell.{k}"], dtype=np.int32)
                for k in _SELL_ARRAYS
            },
        )
    graph = CompiledGraph(
        names=list(arrays["names"]),
        node_index=dict(arrays["node_index"]),
        **{k: int(arrays[k]) for k in _SCALARS},
        **{k: np.array(arrays[k], dtype=t) for k, t in _ARRAYS.items()},
        sell=sell,
    )
    if graph.src.shape != (graph.e_pad,) or graph.overloaded.shape != (
        graph.n_pad,
    ):
        raise ValueError("array lengths do not match e_pad / n_pad")
    return graph


def upload(a, dtype, device: torch.device) -> torch.Tensor:
    """An owned device copy of a host array, never a view of it: on the CPU
    a view would share memory with the compiled graph, and the event path
    patches the resident weight buckets in place."""
    return torch.tensor(np.ascontiguousarray(a, dtype=dtype), device=device)


def to_device(
    graph: CompiledGraph, device: DeviceLike = "cuda"
) -> Dict[str, object]:
    """Persistent device tensors of one graph: `src`, `dst` [e_pad] int32,
    `csr` [n_pad + 1] int32 (in-edge ranges of the destination-sorted real
    edges; the padding edges past `e` carry INF and are left out), `w`
    [e_pad] int32, `ov` [n_pad] bool, and per sliced-ELL bucket `nbrs` and
    `wgs` [nk, dk] int32 (empty tuples without the sliced layout)."""
    dev = resolve_device(device)
    sell = graph.sell
    return {
        "src": upload(graph.src, np.int32, dev),
        "dst": upload(graph.dst, np.int32, dev),
        "csr": upload(edge_csr(graph), np.int32, dev),
        "w": upload(graph.w, np.int32, dev),
        "ov": upload(graph.overloaded, bool, dev),
        "nbrs": tuple(upload(a, np.int32, dev) for a in sell.nbr)
        if sell else (),
        "wgs": tuple(upload(a, np.int32, dev) for a in sell.wg)
        if sell else (),
    }


def per_rank(mesh, make: Callable, key: Callable = None) -> List[List]:
    """[b][g] grid of make(i, j, device) over the mesh's ranks. Ranks on one
    device with the same key(i, j) share one value (default key: the
    position, so nothing is shared)."""
    key = key or (lambda i, j: (i, j))
    made: Dict = {}
    b, g = mesh.devices.shape
    out = []
    for i in range(b):
        row = []
        for j in range(g):
            dev = mesh.devices[i, j]
            k = (dev, key(i, j))
            if k not in made:
                made[k] = make(i, j, dev)
            row.append(made[k])
        out.append(row)
    return out


def rank_rows(mesh, a, dtype) -> List[List[torch.Tensor]]:
    """Row j of the [g, ...] array `a` on every rank (i, j): the tiled
    layout's P('graph', None) placement, one upload per device and row."""
    return per_rank(mesh, lambda i, j, dev: upload(a[j], dtype, dev),
                    key=lambda i, j: j)


def rank_replicas(mesh, a, dtype) -> List[List[torch.Tensor]]:
    """The whole array on every rank (P()), one upload per device."""
    return per_rank(mesh, lambda i, j, dev: upload(a, dtype, dev),
                    key=lambda i, j: None)


def rank_sources(mesh, rows) -> List[List[torch.Tensor]]:
    """Batch rank i's slice of the source rows on every rank (i, j)
    (P('batch')); the batch must split evenly."""
    rows = np.asarray(rows, dtype=np.int32)
    b = mesh.devices.shape[0]
    if len(rows) % b:
        raise ValueError(f"{len(rows)} sources do not split over {b}")
    s_l = len(rows) // b
    return per_rank(
        mesh, lambda i, j, dev: upload(rows[i * s_l : (i + 1) * s_l],
                                       np.int32, dev),
        key=lambda i, j: i)


def tiling_ranks(tiling, mesh) -> Dict[str, List[List[torch.Tensor]]]:
    """A GraphTiling's arrays (the port's, or the JAX package's: any object
    with its fields; hptr is derived where it is missing) as per-rank int32
    tensors: `src_l`, `hseg`, `w2` (the tiling's weights), `hcols` and
    `hptr`, partition j's row on every graph rank j. Raises where an hcols
    row does not ascend with its sentinels (TILE_PAD) last: K20 folds only
    the stretch of a frontier's slots that a rank owns."""
    hcols = np.asarray(tiling.hcols, dtype=np.int64)
    step = np.diff(hcols, axis=1)
    bad = (step < 0) | ((step == 0) & (hcols[:, 1:] != TILE_PAD))
    bad = bad.any(axis=1)
    if bad.any():
        raise ValueError(
            f"hcols row {int(np.argmax(bad))} does not ascend with its "
            "sentinels last"
        )
    hptr = getattr(tiling, "hptr", None)
    if hptr is None:
        counts = np.bincount(np.asarray(tiling.edge_tile), minlength=tiling.g)
        hptr = tile_hptr(np.asarray(tiling.hseg), counts, int(tiling.h))
    arrays = {"src_l": tiling.src_l, "hseg": tiling.hseg, "w2": tiling.w,
              "hcols": tiling.hcols, "hptr": hptr}
    return {name: rank_rows(mesh, np.asarray(a), np.int32)
            for name, a in arrays.items()}


@dataclass(frozen=True)
class TeGraph:
    """The TE edge list on the card with its two range layouts.

    Edge e runs src[e] -> dst[e] (int32 [E]). The out-edges of node u are
    out_perm[out_ptr[u]:out_ptr[u + 1]], its in-edges
    in_perm[in_ptr[u]:in_ptr[u + 1]], each a stable sort of the edge ids, so
    a segment keeps the edge order the reference's segment sums see. The
    compiled edge order is by destination, not by source, so the out-edge
    layout is a permutation even there."""

    n: int
    src: torch.Tensor
    dst: torch.Tensor
    out_ptr: torch.Tensor  # int32 [n + 1]
    out_perm: torch.Tensor  # int32 [E]
    in_ptr: torch.Tensor  # int32 [n + 1]
    in_perm: torch.Tensor  # int32 [E]
    out_order: torch.Tensor  # int32 [n]: by out-degree, largest first

    @property
    def e(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device


def edge_ranges(keys: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(perm [E], ptr [n + 1]): a stable argsort of the edges by `keys` and
    each node's range in it."""
    keys = np.asarray(keys, dtype=np.int64)
    perm = np.argsort(keys, kind="stable")
    ptr = np.searchsorted(keys[perm], np.arange(n + 1), side="left")
    return perm, ptr


def te_graph(src_e, dst_e, n: int, device: DeviceLike = "cuda") -> TeGraph:
    """The `TeGraph` of numpy edge arrays (src_e, dst_e [E], ids in [0, n))
    on `device`."""
    dev = resolve_device(device)
    src = np.asarray(src_e, dtype=np.int64)
    dst = np.asarray(dst_e, dtype=np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("src_e and dst_e must be 1-d of one length")
    if len(src) and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= n):
        raise ValueError(f"edge endpoints outside [0, {n})")
    out_perm, out_ptr = edge_ranges(src, n)
    in_perm, in_ptr = edge_ranges(dst, n)
    out_order = np.argsort(-np.diff(out_ptr), kind="stable")
    return TeGraph(
        n=int(n),
        src=upload(src, np.int32, dev),
        dst=upload(dst, np.int32, dev),
        out_ptr=upload(out_ptr, np.int32, dev),
        out_perm=upload(out_perm, np.int32, dev),
        in_ptr=upload(in_ptr, np.int32, dev),
        in_perm=upload(in_perm, np.int32, dev),
        out_order=upload(out_order, np.int32, dev),
    )


def te_inputs(
    src_e, dst_e, w, up, demands, caps, device: DeviceLike = "cuda"
) -> Dict[str, object]:
    """TE's inputs on `device`: `w` [E] float32, `up` [E] bool, `demands`
    [B, n, n] float32 (a single [n, n] matrix becomes B = 1), `caps` [E]
    float32, and `graph`, the `TeGraph` of the edge arrays (n from the
    demands)."""
    dev = resolve_device(device)
    dem = np.asarray(demands, dtype=np.float32)
    if dem.ndim == 2:
        dem = dem[None]
    if dem.ndim != 3 or dem.shape[1] != dem.shape[2]:
        raise ValueError(f"demands must be [B, n, n], got {dem.shape}")
    n = dem.shape[1]
    graph = te_graph(src_e, dst_e, n, dev)
    out = {
        "w": upload(w, np.float32, dev),
        "up": upload(up, bool, dev),
        "demands": upload(dem, np.float32, dev),
        "caps": upload(caps, np.float32, dev),
        "graph": graph,
    }
    for key in ("w", "up", "caps"):
        if out[key].shape != (graph.e,):
            raise ValueError(f"{key} must be [{graph.e}]")
    return out
