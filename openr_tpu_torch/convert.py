"""Carry a compiled graph across packages and onto the card.

The system has no weights: its state is the compiled graph. A compiled graph
from any producer (the JAX package included) travels as a dict of plain
Python values and numpy arrays, which `graph_from_arrays` turns into the
port's `CompiledGraph`. `to_device` uploads the persistent tensors a solve
reads.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.ops.graph import CompiledGraph, SlicedEll
from openr_tpu_torch.ops.spf import edge_csr

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


def _up(a, dtype, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=dev)


def weights_to_device(
    graph: CompiledGraph, device: DeviceLike = "cuda"
) -> Dict[str, object]:
    """The tensors a weight or overload patch changes: `w` [e_pad] int32,
    `ov` [n_pad] bool and per sliced-ELL bucket `wgs` [nk, dk] int32."""
    dev = resolve_device(device)
    sell = graph.sell
    return {
        "w": _up(graph.w, np.int32, dev),
        "ov": _up(graph.overloaded, bool, dev),
        "wgs": tuple(_up(a, np.int32, dev) for a in sell.wg) if sell else (),
    }


def to_device(
    graph: CompiledGraph, device: DeviceLike = "cuda"
) -> Dict[str, object]:
    """Persistent device tensors of one graph: `src`, `dst` [e_pad] int32,
    `csr` [n_pad + 1] int32 (in-edge ranges of the destination-sorted real
    edges; the padding edges past `e` carry INF and are left out), per
    sliced-ELL bucket `nbrs` [nk, dk] int32 (an empty tuple without the
    sliced layout), and the weight tensors of `weights_to_device`."""
    dev = resolve_device(device)
    sell = graph.sell
    csr = edge_csr(graph)
    return {
        "src": _up(graph.src, np.int32, dev),
        "dst": _up(graph.dst, np.int32, dev),
        "csr": _up(csr, np.int32, dev),
        "nbrs": tuple(_up(a, np.int32, dev) for a in sell.nbr) if sell else (),
        **weights_to_device(graph, dev),
    }
