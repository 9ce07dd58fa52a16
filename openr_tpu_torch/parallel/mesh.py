"""Solver meshes, the graph-axis tiling and the sharded SPF steps.

A `Mesh` is a (batch, graph) grid of torch devices. One process drives
every rank of it, as one jitted `shard_map` drives every device of the
reference's `jax.sharding.Mesh`: each rank's tensors live on its device and
the port's code loops over the ranks. A device may appear at several
positions (`make_mesh([torch.device("cuda:0")] * 4, (1, 4))`): its ranks
then share one card, the counterpart of the reference's virtual CPU
devices, which is how one card and the CPU tests run a (1, 4) or (2, 4)
mesh.

The batched solve splits its source batch over 'batch': with a graph axis
of one each batch rank relaxes its row slice against a replica of the
layout, with no traffic between ranks inside a round (`ops/spf.py`'s
`mesh=` arguments). With a graph axis above one, `GraphTiling` splits the
node axis into `graph` contiguous column tiles and regroups the edges by
the tile that owns their SOURCE, so every tail a rank reads is in its own
tile; between rounds the compact per-partition frontiers move one hop at a
time around the graph ring and each rank folds them into its own columns
(`ops/spf.py:_tile_solver`). The ECMP DAG step splits its edges over
'graph'.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.ops.graph import INF, CompiledGraph, _next_bucket
from openr_tpu_torch.ops.spf import (
    Sharded,
    _bf_fixpoint,
    _ecmp_dag,
    _sell_solver_counted,
    batch_devices,
    edge_csr,
    mesh_devices,
)


class Mesh:
    """A (batch, graph) grid of torch devices: `devices` is an object
    ndarray of shape (batch, graph), `shape` maps "batch" and "graph" to
    the axis sizes, as `jax.sharding.Mesh` does."""

    def __init__(
        self,
        devices: np.ndarray,
        axis_names: Tuple[str, str] = ("batch", "graph"),
    ) -> None:
        if devices.ndim != 2:
            raise ValueError("a mesh is a 2-d grid of devices")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def _normalize(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _cards(device: DeviceLike = "cuda") -> List[torch.device]:
    """The distinct devices of `device`'s type: every card, or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(
    devices: Optional[Sequence] = None,
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("batch", "graph"),
) -> Mesh:
    """2-d device mesh; by default every card on the batch axis. The device
    list may repeat a device: its ranks then share it."""
    devices = [_normalize(d) for d in (
        devices if devices is not None else _cards("cuda"))]
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axis_names)


def resolve_mesh(spec, device: DeviceLike = "cuda") -> Optional[Mesh]:
    """Mesh | (batch, graph) shape | None -> Mesh | None: a shape is laid
    over the first batch * graph distinct devices of `device`'s type, and
    raises when there are fewer; a Mesh passes unchanged."""
    if spec is None or isinstance(spec, Mesh):
        return spec
    shape = tuple(int(x) for x in spec)
    if len(shape) != 2:
        raise ValueError(f"solver_mesh must be (batch, graph), got {spec!r}")
    n = shape[0] * shape[1]
    devices = _cards(device)
    if len(devices) < n:
        raise ValueError(
            f"solver_mesh {shape} needs {n} devices, have {len(devices)}"
        )
    return make_mesh(devices[:n], shape=shape)


def shrink_candidates(shape: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The degradation ladder below a (batch, graph) shape: every strictly
    smaller power-of-two factorization, largest first, keeping the graph
    axis where it can (the destination tiling is the memory win; batch rows
    re-pad cheaply)."""
    b, g = shape
    out: List[Tuple[int, int]] = []
    total = (b * g) // 2
    while total >= 1:
        new_g = min(g, total)
        out.append((total // new_g, new_g))
        total //= 2
    return out


def surviving_devices(devices: Sequence) -> List:
    """The devices of `devices` that still answer a one-element put and
    read: the partial-mesh degradation probe. A failing device is left
    out of the next mesh."""
    alive = []
    for dev in devices:
        try:
            x = torch.ones(1, dtype=torch.int32, device=dev)
            if int(x.item()) == 1:
                alive.append(dev)
        except Exception:  # noqa: BLE001 - any failure means "not viable"
            continue
    return alive


def plan_degraded_mesh(mesh: Mesh) -> Optional[Mesh]:
    """The next rung of the ladder: the largest strictly smaller (batch,
    graph) mesh over the devices that still answer; None when none is left
    (a one-device mesh has no rung below it)."""
    shape = (mesh.shape["batch"], mesh.shape["graph"])
    alive = surviving_devices(list(mesh.devices.flat))
    for b, g in shrink_candidates(shape):
        if b * g <= len(alive):
            return make_mesh(alive[: b * g], shape=(b, g))
    return None


@dataclass
class GraphTiling:
    """Destination-tiled edge layout of the (batch, graph) solve, a host
    copy of the reference's.

    The node axis is split into `g` contiguous column tiles of `n_tile`
    ids. Edges are grouped by the tile that owns their SOURCE and padded to
    `e_tile` per partition; each partition's distinct destination columns
    are compacted into `h` frontier slots: `hseg` maps each edge to its
    slot, `hcols` each slot to its global column (1 << 30: unused). Slot
    h - 1 is reserved for padding edges. `hptr` is the port's one derived
    array: slot k of partition t covers the real edges [hptr[t, k],
    hptr[t, k + 1]) of its dst-sorted order, which the tile round kernel
    walks instead of the padded edge slots."""

    g: int
    n_tile: int
    e_tile: int
    h: int
    e: int
    src_l: np.ndarray  # int32 [g, e_tile] tile-local source ids (pad 0)
    hseg: np.ndarray  # int32 [g, e_tile] per-edge frontier slot (pad h-1)
    w: np.ndarray  # int32 [g, e_tile] edge weights (pad INF)
    hcols: np.ndarray  # int32 [g, h] global column per slot (pad 1<<30)
    edge_tile: np.ndarray  # int32 [e] dst-sorted edge pos -> partition
    edge_pos: np.ndarray  # int32 [e] dst-sorted edge pos -> slot in e_tile
    hptr: np.ndarray  # int32 [g, h + 1] per-slot ranges of real edges

    def shape_key(self) -> Tuple:
        """Static structure key (weight patches never change it)."""
        return (self.g, self.n_tile, self.e_tile, self.h)

    def tile_bytes(self) -> int:
        """Device bytes of the tiled edge planes src_l + hseg + w."""
        return 3 * self.g * self.e_tile * 4

    def halo_bytes(self) -> int:
        """Device bytes of the halo's slot -> column table hcols [g, h]."""
        return self.g * self.h * 4

    def tile_weights(self, w_edges: np.ndarray) -> np.ndarray:
        """[e_pad] dst-sorted edge weights -> the [g, e_tile] tiled form
        (padding slots stay INF), the per-event weight upload."""
        out = np.full((self.g, self.e_tile), INF, dtype=np.int32)
        out[self.edge_tile, self.edge_pos] = w_edges[: self.e]
        return out


def tile_hptr(hseg: np.ndarray, counts: Sequence[int], h: int) -> np.ndarray:
    """[g, h + 1] slot ranges over each partition's first counts[t] (real)
    edges, whose slots are non-decreasing."""
    g = hseg.shape[0]
    out = np.empty((g, h + 1), dtype=np.int32)
    for t in range(g):
        out[t] = np.searchsorted(
            hseg[t, : int(counts[t])], np.arange(h + 1), side="left")
    return out


def tile_graph(graph: CompiledGraph, g: int) -> GraphTiling:
    """Partition a compiled graph's edge list by source tile for a graph
    axis of size g (g must divide n_pad; both are powers of two in
    practice)."""
    n_pad = graph.n_pad
    if n_pad % g:
        raise ValueError(f"graph axis {g} does not divide n_pad {n_pad}")
    n_tile = n_pad // g
    e = graph.e
    src = graph.src[:e]
    dst = graph.dst[:e]
    w = graph.w[:e]
    tile_of = (src // n_tile).astype(np.int64) if e else np.empty(0, np.int64)
    counts = np.bincount(tile_of, minlength=g) if e else np.zeros(g, int)
    e_tile = _next_bucket(int(counts.max()) if e else 1, minimum=8)
    per_tile = []
    max_u = 0
    for t in range(g):
        idx = np.nonzero(tile_of == t)[0]
        # the edges are dst-sorted, so each partition's subsequence is too:
        # slots ascend with the destination and hseg is non-decreasing
        uniq, seg = np.unique(dst[idx], return_inverse=True)
        per_tile.append((idx, uniq, seg))
        max_u = max(max_u, len(uniq))
    h = _next_bucket(max_u + 1, minimum=8)  # + 1 reserves the padding slot
    src_l = np.zeros((g, e_tile), dtype=np.int32)
    hseg = np.full((g, e_tile), h - 1, dtype=np.int32)
    w2 = np.full((g, e_tile), INF, dtype=np.int32)
    hcols = np.full((g, h), 1 << 30, dtype=np.int32)
    edge_tile = np.zeros(e, dtype=np.int32)
    edge_pos = np.zeros(e, dtype=np.int32)
    for t, (idx, uniq, seg) in enumerate(per_tile):
        k = len(idx)
        if not k:
            continue
        src_l[t, :k] = src[idx] - t * n_tile
        hseg[t, :k] = seg.reshape(-1)
        w2[t, :k] = w[idx]
        hcols[t, : len(uniq)] = uniq
        edge_tile[idx] = t
        edge_pos[idx] = np.arange(k, dtype=np.int32)
    return GraphTiling(
        g=g, n_tile=n_tile, e_tile=e_tile, h=h, e=e, src_l=src_l, hseg=hseg,
        w=w2, hcols=hcols, edge_tile=edge_tile, edge_pos=edge_pos,
        hptr=tile_hptr(hseg, counts, h),
    )


def _pad_sources(source_rows: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the source batch to a multiple of the batch axis; padding rows
    re-solve the first source (discarded by the caller)."""
    s = len(source_rows)
    rem = (-s) % multiple
    rows = np.asarray(source_rows, dtype=np.int32)
    if rem == 0:
        return rows
    return np.concatenate(
        [rows, np.full(rem, source_rows[0] if s else 0, dtype=np.int32)])


def replicate(mesh: Mesh, make) -> Dict[torch.device, object]:
    """{device: make(device)} over the distinct devices of the mesh: an
    operand replicated on every rank (P()), one copy per device."""
    return {dev: make(dev) for dev in mesh_devices(mesh)}


def sharded_batched_spf(
    graph: CompiledGraph, source_rows: np.ndarray, mesh: Mesh
) -> Sharded:
    """Batched SPF with the sources split over the batch axis: each batch
    rank solves its row slice (K1 on the sliced layout, else K2) against
    the layout on its device. Returns D [S_padded, n_pad] `Sharded` by
    rows."""
    sources = _pad_sources(source_rows, mesh.shape["batch"])
    if graph.sell is not None:
        sell = graph.sell
        nbrs = replicate(mesh, lambda d: tuple(
            torch.tensor(a, dtype=torch.int32, device=d) for a in sell.nbr))
        wgs = replicate(mesh, lambda d: tuple(
            torch.tensor(a, dtype=torch.int32, device=d) for a in sell.wg))
        ov = replicate(mesh, lambda d: torch.tensor(graph.overloaded,
                                                    device=d))
        d, _ = _sell_solver_counted(
            sell.shape_key(), torch.as_tensor(sources), nbrs, wgs, ov, mesh)
        return d
    csr = edge_csr(graph)
    b = mesh.shape["batch"]
    s_l = len(sources) // b
    shards = []
    for i, dev in enumerate(batch_devices(mesh)):
        shards.append([_bf_fixpoint(
            torch.as_tensor(sources[i * s_l : (i + 1) * s_l], device=dev),
            torch.as_tensor(graph.src, device=dev),
            torch.as_tensor(graph.dst, device=dev),
            torch.as_tensor(graph.w, device=dev),
            torch.as_tensor(graph.overloaded, device=dev),
            torch.as_tensor(csr.astype(np.int32), device=dev),
        )])
    return Sharded(shards)


def sharded_spf_step(
    graph: CompiledGraph, source_rows: np.ndarray, mesh: Mesh
) -> Tuple[Sharded, List[torch.Tensor]]:
    """The full solver step over the mesh: the row-sharded batched solve,
    then the ECMP first-hop DAG (K3) with its edges split over 'graph':
    graph rank j tests its slice of the edge list against the distance
    rows it reads, gathered onto its device. source_rows must cover every
    node id (the DAG reads D rows by node id). Returns (D `Sharded`, the
    DAG as a list over graph ranks of bool [e_pad / graph, n_pad])."""
    d = sharded_batched_spf(graph, source_rows, mesh)
    g = mesh.shape["graph"]
    if graph.e_pad % g:
        raise ValueError(f"e_pad {graph.e_pad} does not split over {g}")
    step = graph.e_pad // g
    dag = []
    for j in range(g):
        dev = mesh.devices[0, j]
        lo, hi = j * step, (j + 1) * step
        dag.append(_ecmp_dag(
            d.gather(dev)[: graph.n_pad],
            torch.as_tensor(graph.src[lo:hi], device=dev),
            torch.as_tensor(graph.dst[lo:hi], device=dev),
            torch.as_tensor(graph.w[lo:hi], device=dev),
            torch.as_tensor(graph.overloaded, device=dev),
        ))
    return d, dag


__all__ = [
    "GraphTiling",
    "Mesh",
    "make_mesh",
    "plan_degraded_mesh",
    "replicate",
    "resolve_mesh",
    "sharded_batched_spf",
    "sharded_spf_step",
    "shrink_candidates",
    "surviving_devices",
    "tile_graph",
    "tile_hptr",
]
