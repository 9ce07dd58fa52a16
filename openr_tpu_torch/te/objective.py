"""Differentiable routing core: softmin-relaxed SPF over the edge list.

The counterpart of the JAX package's te/objective.py. The hard shortest
paths of ops/spf.py relax, with a temperature tau, into a function of the
edge weights that autograd can differentiate:

  - **softmin distances** (`softmin_distances`): the inner min of the
    Bellman-Ford recursion becomes softmin_tau(x) = -tau * log(sum exp(-x /
    tau)) across each node's out-edges, with the incumbent folded in by a
    hard minimum. As tau -> 0 it approaches the hard SPF distances.
  - **soft traffic splitting** (`soft_utilization`): at each node, traffic
    toward t splits over the out-edges by a softmax of the negated triangle
    gap (w(u, v) + D[v, t] - D[u, t]) / tau, the relaxation of the ECMP
    first-hop DAG; flows propagate for a fixed number of rounds.
  - **soft max-link-utilization** (`soft_mlu`): tau_obj * logsumexp(util /
    tau_obj).

Each round runs on the card in a hand-written kernel with a backward kernel
beside it (te/kernels.py: K14-K18), so all three are differentiable in `w`
by `torch.autograd`. Relaxation rounds are a fixed count, as in the
reference (its scan cannot differentiate a while loop).

The hard counterparts (`hard_distances`, `hard_utilization`,
`hard_max_util`) score candidate integer weights under exact SPF and
fractional ECMP: host-side numpy, copies of the reference's.

Public functions take numpy edge arrays, `w`, `demands` and `caps` as
arrays or tensors, and `device`, "cuda" by default; a tensor `w` that
requires grad keeps its graph.
"""

from __future__ import annotations

import numpy as np
import torch

from openr_tpu_torch.convert import TeGraph, te_graph
from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.ops.graph import INF, CompiledGraph
from openr_tpu_torch.te.kernels import (
    F_INF,
    SoftFlow,
    SoftminRound,
    SoftMlu,
    f32,
)

__all__ = [
    "F_INF",
    "hard_distances",
    "hard_max_util",
    "hard_utilization",
    "soft_mlu",
    "soft_utilization",
    "softmin_distances",
    "te_edge_arrays",
]


def te_edge_arrays(graph: CompiledGraph):
    """(src, dst, w0, up) real-edge arrays for the TE relaxation.

    Down links (weight INF in the compiled arrays) stay in the edge list
    with up=False so the optimizer's weight vector keeps the compiled
    graph's edge positions — proposed changes map back to Link objects via
    CompiledGraph.link_edges without index translation."""
    e = graph.e
    src = graph.src[:e].astype(np.int32)
    dst = graph.dst[:e].astype(np.int32)
    up = graph.w[:e] < INF
    w0 = np.where(up, graph.w[:e], 1).astype(np.float32)
    return src, dst, w0, up


# -- the device chain --------------------------------------------------------


def edge_weights(w: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """we [E]: w on the up edges, F_INF on the down ones (they never relax);
    the gradient reaches w only through the up edges."""
    return torch.where(up, w, F_INF)


def softmin_core(we: torch.Tensor, graph: TeGraph, tau: float,
                 rounds: int) -> torch.Tensor:
    """`rounds` softmin rounds (K14 each, K15 in the backward) from the cold
    state: D [N, N] float32, differentiable in we."""
    n = graph.n
    d = torch.full((n, n), F_INF, dtype=torch.float32, device=we.device)
    d.fill_diagonal_(0.0)
    tau = f32(tau)
    for _ in range(int(rounds)):
        d = SoftminRound.apply(d, we, graph, tau)
    return d


def utilization_core(we, up, demands, caps, graph: TeGraph, tau: float,
                     rounds: int) -> torch.Tensor:
    """Per-link utilization [B, E] of each demand matrix [B, N, N] under
    soft routing (K14-K17), differentiable in we."""
    d = softmin_core(we, graph, tau, rounds)
    return SoftFlow.apply(d, we, up, demands, caps, graph, f32(tau),
                          int(rounds))


# -- public functions --------------------------------------------------------


def _tensor(x, dtype, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)


def softmin_distances(w, src_e, dst_e, up, tau, n: int, rounds: int,
                      device: DeviceLike = "cuda") -> torch.Tensor:
    """Softmin distance-to-destination matrix D [n, n] float32 after
    `rounds` relaxations: D[v, t] is the relaxed distance from v to t,
    F_INF where unreachable. Differentiable in w."""
    dev = resolve_device(device)
    graph = te_graph(src_e, dst_e, n, dev)
    we = edge_weights(_tensor(w, torch.float32, dev),
                      _tensor(up, torch.bool, dev))
    return softmin_core(we, graph, tau, rounds)


def soft_utilization(w, demands, caps, src_e, dst_e, up, tau, n: int,
                     rounds: int, device: DeviceLike = "cuda") -> torch.Tensor:
    """Per-link utilization [E] of one demand matrix [n, n] (row = origin,
    column = destination) under soft routing; caps [E] are per-directed-edge
    capacities. Differentiable in w."""
    dev = resolve_device(device)
    graph = te_graph(src_e, dst_e, n, dev)
    up_t = _tensor(up, torch.bool, dev)
    we = edge_weights(_tensor(w, torch.float32, dev), up_t)
    dem = _tensor(demands, torch.float32, dev)[None]
    util = utilization_core(we, up_t, dem, _tensor(caps, torch.float32, dev),
                            graph, tau, rounds)
    return util[0]


def soft_mlu(w, demands, caps, src_e, dst_e, up, tau, tau_obj, n: int,
             rounds: int, device: DeviceLike = "cuda") -> torch.Tensor:
    """Softmax-relaxed max link utilization of one demand matrix (a 0-d
    tensor), differentiable in w."""
    util = soft_utilization(w, demands, caps, src_e, dst_e, up, tau, n,
                            rounds, device=device)
    mask = torch.ones(1, dtype=torch.float32, device=util.device)
    return SoftMlu.apply(util[None].contiguous(), mask, f32(tau_obj))[0]


# ---------------------------------------------------------------------------
# hard counterparts (numpy, host-side): the acceptance metric the rounded
# candidate weights are scored with — exact SPF + fractional ECMP splits
# ---------------------------------------------------------------------------


def hard_distances(w, src_e, dst_e, up, n) -> np.ndarray:
    """Integer distance-to-destination matrix D [N, N] by Bellman-Ford.

    Matches the hard SPF semantics the solvers share: down edges never
    relax, unreachable stays at INF. (No overload/transit pruning: the TE
    service excludes overloaded nodes' transit by pinning their out-edge
    weights, same as the compiled-graph convention.)"""
    big = np.int64(INF)
    we = np.where(up, w.astype(np.int64), big)
    d = np.full((n, n), big, dtype=np.int64)
    np.fill_diagonal(d, 0)
    for _ in range(n):
        cand = np.minimum(we[:, None] + d[dst_e], big)  # [E, N]
        upd = np.full((n, n), big, dtype=np.int64)
        np.minimum.at(upd, src_e, cand)
        new_d = np.minimum(d, upd)
        if np.array_equal(new_d, d):
            break
        d = new_d
    return d


def hard_utilization(w, demands, caps, src_e, dst_e, up, n, d=None) -> np.ndarray:
    """Per-link utilization [E] under exact SPF + fractional ECMP.

    At every node, traffic toward t splits equally over the out-edges on
    the shortest-path DAG (the triangle condition of ops/spf.py:_ecmp_dag),
    the idealized ECMP model TE optimizes for. Pass `d` to skip the BF
    re-derivation with a precomputed exact distance matrix for `w` — the
    solver's resident APSP matrix serves the live-weight scoring
    (docs/Apsp.md TE consumer)."""
    if d is None:
        d = hard_distances(w, src_e, dst_e, up, n)
    else:
        d = d.astype(np.int64)
    big = np.int64(INF)
    we = np.where(up, w.astype(np.int64), big)
    node_t = np.arange(n)
    on_dag = (
        (we[:, None] + d[dst_e] == d[src_e])
        & (d[src_e] < big)
        & up[:, None]
        & (src_e[:, None] != node_t[None, :])
    )
    deg = np.zeros((n, n), dtype=np.int64)
    np.add.at(deg, src_e, on_dag.astype(np.int64))
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(deg[src_e] > 0, on_dag / np.maximum(deg[src_e], 1), 0.0)

    x = demands * (1.0 - np.eye(n))
    flow = np.zeros((len(src_e), n), dtype=np.float64)
    for _ in range(n):
        ef = p * x[src_e]
        if not ef.any():
            break
        flow += ef
        x = np.zeros((n, n), dtype=np.float64)
        np.add.at(x, dst_e, ef)
    return flow.sum(axis=1) / np.maximum(caps, 1e-9)


def hard_max_util(w, demands, caps, src_e, dst_e, up, n, d=None) -> float:
    """Max link utilization of one demand matrix under hard SPF routing."""
    util = hard_utilization(w, demands, caps, src_e, dst_e, up, n, d=d)
    return float(util.max()) if len(util) else 0.0
