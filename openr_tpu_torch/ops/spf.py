"""Batched multi-source shortest paths as min-plus relaxation on the card.

The per-source Dijkstra of the reference (openr/decision/LinkState.cpp:806-880)
becomes Bellman-Ford relaxation rounds over a whole batch of sources:

    D[s, v] <- min(D[s, v], min over edges (u->v): Dt[s, u] + w(u, v))

where Dt masks transit through overloaded nodes per source (a source's own
row keeps its outgoing edges — LinkState.cpp:829-836 semantics). Rounds are
Jacobi (each reads the previous round's D) and run until nothing changes,
capped at n rounds; the final no-change round is counted, so `rounds`
equals the JAX package's count.

Three hand-written CUDA kernels carry the device work (ops/csrc/):

  K1 sell_relax_round  one round of the sliced-ELL pull, per degree bucket
  K2 bf_relax_round    one round of the edge-list form (no sliced layout)
  K3 ecmp_triangle     per-edge first-hop test w(u,v) + D[v,t] == D[u,t]

Each wrapper checks device, dtype, shape and contiguity; on a CUDA tensor
it launches its kernel (and counts the launch), on a CPU tensor it runs the
plain PyTorch version beside it. The plain versions are the CPU tests' path
and the card's reference; nothing on the main path calls them on the card.

The ECMP first-hop DAG falls out of the triangle condition, which reproduces
the Dijkstra nexthop-union semantics of LinkState.cpp:855-871.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.ops._cuda import BF_RELAX, ECMP_TRIANGLE, SELL_RELAX
from openr_tpu_torch.ops.graph import INF, CompiledGraph

_INT32_MAX = int(np.iinfo(np.int32).max)


def _i32(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).contiguous()
    return torch.as_tensor(
        np.ascontiguousarray(x, dtype=np.int32), device=device
    )


def _bool(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.bool).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x, dtype=bool), device=device)


def _rows(source_rows, n_pad: int, device: torch.device) -> torch.Tensor:
    """Source node ids as int32 on `device`, checked against [0, n_pad):
    the kernels index with them unchecked."""
    rows = _i32(source_rows, device)
    if rows.dim() != 1:
        raise ValueError("source_rows must be 1-d")
    if rows.numel() and (
        int(rows.min()) < 0 or int(rows.max()) >= n_pad
    ):
        raise ValueError(f"source_rows outside [0, {n_pad})")
    return rows


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(
            f"{name}: expected {ndim}-d {dtype}, got {t.dim()}-d {t.dtype}"
        )
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# -- cold initial states and transit masks ---------------------------------


def _sell_d0(sources: torch.Tensor, n: int) -> torch.Tensor:
    """Cold-start destination-major state [n, S]: 0 on each source's own
    entry, INF elsewhere."""
    s = sources.shape[0]
    d0 = torch.full((n, s), INF, dtype=torch.int32, device=sources.device)
    d0[sources.long(), torch.arange(s, device=sources.device)] = 0
    return d0


def _sell_d0_allow(
    sources: torch.Tensor, overloaded: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cold-start dest-major initial state [N, S] plus the per-source
    transit mask (overloaded nodes relay nothing unless they are the
    source itself)."""
    (n,) = overloaded.shape
    node_ids = torch.arange(n, dtype=torch.int32, device=sources.device)
    allow = (~overloaded)[:, None] | (node_ids[:, None] == sources[None, :])
    return _sell_d0(sources, n), allow


def _bf_allow(sources: torch.Tensor, overloaded: torch.Tensor) -> torch.Tensor:
    """Row-major [S, N] transit mask: transit allowed through u for source
    row i unless u is overloaded and u is not the source itself."""
    n = overloaded.shape[0]
    node_ids = torch.arange(n, dtype=torch.int32, device=sources.device)
    return (~overloaded)[None, :] | (node_ids[None, :] == sources[:, None])


def edge_csr(graph: CompiledGraph) -> np.ndarray:
    """[n_pad + 1] in-edge ranges over the real (destination-sorted) edges.
    The padding edges past graph.e carry INF weight and never relax, and all
    point at the last real destination: counting them would give that one
    node an in-edge range of e_pad - e entries for a thread to walk."""
    bounds = np.arange(graph.n_pad + 1)
    return np.searchsorted(graph.dst[: graph.e], bounds, side="left")


# -- K1: sliced-ELL pull relaxation ----------------------------------------


def _sell_relax(
    d0: torch.Tensor,  # int32 [n_pad, S] dest-major
    sources: torch.Tensor,  # int32 [S]
    overloaded: torch.Tensor,  # bool [n_pad]
    nbrs: Sequence[torch.Tensor],  # int32 [nk, dk] per bucket
    wgs: Sequence[torch.Tensor],  # int32 [nk, dk] per bucket
    zero_end: int,
    starts: Sequence[int],
) -> Tuple[torch.Tensor, int]:
    """Min-plus relaxation from dest-major initial state d0 to the fixpoint.

    Returns (d [n_pad, S], rounds). Valid for any d0 that is an entrywise
    upper bound of the true distances with the source diagonal pinned to 0.
    Rows [0, zero_end) and the padding rows past the last bucket never
    change. zero_end is implied by starts and kept for the reference's
    signature. d0 is consumed: on the card it is one of the two round
    buffers, so a caller that needs it afterwards passes a copy."""
    dev = d0.device
    _check("d0", d0, torch.int32, 2, dev)
    n, s = d0.shape
    _check("sources", sources, torch.int32, 1, dev)
    _check("overloaded", overloaded, torch.bool, 1, dev)
    if sources.shape[0] != s or overloaded.shape[0] != n:
        raise ValueError("sources/overloaded do not match d0's shape")
    if len(nbrs) != len(wgs) or len(nbrs) != len(starts):
        raise ValueError("nbrs, wgs and starts differ in bucket count")
    for k, (nbr_k, wg_k) in enumerate(zip(nbrs, wgs)):
        _check(f"nbrs[{k}]", nbr_k, torch.int32, 2, dev)
        _check(f"wgs[{k}]", wg_k, torch.int32, 2, dev)
        if nbr_k.shape != wg_k.shape or starts[k] + nbr_k.shape[0] > n:
            raise ValueError(f"bucket {k}: bad shape {tuple(nbr_k.shape)}")
    if starts and starts[0] < zero_end:
        raise ValueError("first bucket starts below zero_end")
    if dev.type == "cuda":
        return _sell_relax_cuda(d0, sources, overloaded, nbrs, wgs, starts)
    return _sell_relax_plain(d0, sources, overloaded, nbrs, wgs, starts)


def _sell_relax_plain(d0, sources, overloaded, nbrs, wgs, starts):
    """Plain PyTorch version of K1's fixpoint (the JAX body, vectorised over
    each bucket's dk slots)."""
    n = d0.shape[0]
    allow = _sell_d0_allow(sources, overloaded)[1]
    idx = [nbr_k.long() for nbr_k in nbrs]
    d, rounds = d0, 0
    while True:
        dt = torch.where(allow, d, INF)
        new_d = d.clone()
        for bs, nbr_k, wg_k in zip(starts, idx, wgs):
            nk = nbr_k.shape[0]
            cand = (dt[nbr_k] + wg_k[:, :, None]).clamp_max(INF).amin(dim=1)
            new_d[bs : bs + nk] = torch.minimum(d[bs : bs + nk], cand)
        rounds += 1
        changed = not torch.equal(new_d, d)
        d = new_d
        if not changed or rounds >= n:
            return d, rounds


def _sell_relax_cuda(d0, sources, overloaded, nbrs, wgs, starts):
    """K1 rounds: one launch per bucket per round into the second buffer,
    one 4-byte changed flag read per round. d0 is the first buffer; the
    second starts as its copy, so the rows outside the buckets hold their
    values in both."""
    n, s = d0.shape
    cur, nxt = d0, d0.clone()
    flag = torch.zeros(1, dtype=torch.int32, device=d0.device)
    rounds = 0
    while True:
        flag.zero_()
        for bs, nbr_k, wg_k in zip(starts, nbrs, wgs):
            nk, dk = nbr_k.shape
            SELL_RELAX.launch(
                cur.data_ptr(), nxt.data_ptr(), flag.data_ptr(),
                sources.data_ptr(), overloaded.data_ptr(),
                nbr_k.data_ptr(), wg_k.data_ptr(), int(bs), nk, dk, s,
            )
        rounds += 1
        cur, nxt = nxt, cur
        if not int(flag.item()) or rounds >= n:
            return cur, rounds


def _sell_fixpoint_core(sources, nbrs, wgs, overloaded, zero_end, starts):
    """Cold-start fixpoint (distances only), row-major [S, N]."""
    return _sell_solver_counted(
        (zero_end, tuple(starts), None), sources, nbrs, wgs, overloaded
    )[0]


def _sell_solver_counted(
    key: Tuple, sources, nbrs, wgs, overloaded
) -> Tuple[torch.Tensor, int]:
    """Cold sliced-ELL solve for the structure `key` (SlicedEll.shape_key()):
    (D [S, n_pad] row-major and contiguous, relaxation rounds)."""
    zero_end, starts, _ = key
    d0 = _sell_d0(sources, overloaded.shape[0])
    d, rounds = _sell_relax(
        d0, sources, overloaded, nbrs, wgs, zero_end, starts
    )
    return d.t().contiguous(), rounds


# -- K2: edge-list relaxation ----------------------------------------------


def _bf_relax(
    d0: torch.Tensor,  # int32 [S, n_pad] row-major
    sources: torch.Tensor,  # int32 [S]
    overloaded: torch.Tensor,  # bool [n_pad]
    src_e: torch.Tensor,  # int32 [E]
    dst_e: torch.Tensor,  # int32 [E], sorted ascending
    w_rows: torch.Tensor,  # int32 [1, E] (shared) or [S, E] (per row)
    csr: torch.Tensor,  # int32 [n_pad + 1] in-edge ranges (edge_csr)
) -> Tuple[torch.Tensor, int]:
    """Edge-list min-plus relaxation from row-major d0 to the fixpoint;
    returns (d [S, n_pad], rounds). Only the edges [0, csr[n_pad]) that the
    in-edge ranges cover relax; the padding edges past them carry INF.
    d0 is consumed, as in _sell_relax."""
    dev = d0.device
    _check("d0", d0, torch.int32, 2, dev)
    s, n = d0.shape
    _check("sources", sources, torch.int32, 1, dev)
    _check("overloaded", overloaded, torch.bool, 1, dev)
    _check("src_e", src_e, torch.int32, 1, dev)
    _check("dst_e", dst_e, torch.int32, 1, dev)
    _check("w_rows", w_rows, torch.int32, 2, dev)
    e = src_e.shape[0]
    if sources.shape[0] != s or overloaded.shape[0] != n:
        raise ValueError("sources/overloaded do not match d0's shape")
    if dst_e.shape[0] != e or w_rows.shape[1] != e:
        raise ValueError("edge arrays differ in length")
    if w_rows.shape[0] not in (1, s):
        raise ValueError(f"w_rows has {w_rows.shape[0]} rows, batch is {s}")
    _check("csr", csr, torch.int32, 1, dev)
    if csr.shape[0] != n + 1:
        raise ValueError("csr must have n_pad + 1 entries")
    if dev.type == "cuda":
        return _bf_relax_cuda(d0, sources, overloaded, src_e, csr, w_rows)
    return _bf_relax_plain(d0, sources, overloaded, src_e, dst_e, w_rows, csr)


def _bf_relax_plain(d0, sources, overloaded, src_e, dst_e, w_rows, csr):
    """Plain PyTorch version of K2's fixpoint over the edges csr covers:
    [S, E] gather, then a segment-min by destination as
    scatter_reduce(amin)."""
    s, n = d0.shape
    m = int(csr[-1])
    allow = _bf_allow(sources, overloaded)
    src = src_e[:m].long()
    dst = dst_e[:m].long()[None, :].expand(s, -1)
    w_rows = w_rows[:, :m]
    d, rounds = d0, 0
    while True:
        dt = torch.where(allow, d, INF)
        contrib = (dt[:, src] + w_rows).clamp_max(INF)
        upd = torch.full_like(d, _INT32_MAX).scatter_reduce(
            1, dst, contrib, reduce="amin"
        )
        new_d = torch.minimum(d, upd)
        rounds += 1
        changed = not torch.equal(new_d, d)
        d = new_d
        if not changed or rounds >= n:
            return d, rounds


def _bf_relax_cuda(d0, sources, overloaded, src_e, csr, w_rows):
    s, n = d0.shape
    w_stride = 0 if w_rows.shape[0] == 1 else w_rows.shape[1]
    cur, nxt = d0, torch.empty_like(d0)
    flag = torch.zeros(1, dtype=torch.int32, device=d0.device)
    rounds = 0
    while True:
        flag.zero_()
        BF_RELAX.launch(
            cur.data_ptr(), nxt.data_ptr(), flag.data_ptr(),
            sources.data_ptr(), overloaded.data_ptr(), src_e.data_ptr(),
            csr.data_ptr(), w_rows.data_ptr(), w_stride, s, n,
        )
        rounds += 1
        cur, nxt = nxt, cur
        if not int(flag.item()) or rounds >= n:
            return cur, rounds


def _bf_d0(sources: torch.Tensor, n: int) -> torch.Tensor:
    s = sources.shape[0]
    d0 = torch.full((s, n), INF, dtype=torch.int32, device=sources.device)
    d0[torch.arange(s, device=sources.device), sources.long()] = 0
    return d0


def _bf_fixpoint_vw_core(
    sources: torch.Tensor,  # int32 [S]
    src_e: torch.Tensor,  # int32 [E]
    dst_e: torch.Tensor,  # int32 [E]
    w_rows: torch.Tensor,  # int32 [S, E] or [1, E] (broadcast) edge weights
    overloaded: torch.Tensor,  # bool [N]
    csr: torch.Tensor,  # int32 [N + 1] in-edge ranges (edge_csr)
) -> torch.Tensor:
    """Distance matrix D [S, N]; each batch row may solve with its own
    edge-weight vector (KSP link-ignore re-solves as extra batch rows)."""
    d0 = _bf_d0(sources, overloaded.shape[0])
    return _bf_relax(d0, sources, overloaded, src_e, dst_e, w_rows, csr)[0]


def _bf_fixpoint(
    sources, src_e, dst_e, w_e, overloaded, csr
) -> torch.Tensor:
    """Shared-weights solve: one weight row for the whole batch."""
    return _bf_fixpoint_vw_core(
        sources, src_e, dst_e, w_e[None, :].contiguous(), overloaded, csr
    )


# -- K3: ECMP triangle -----------------------------------------------------


def ecmp_triangle(
    d: torch.Tensor,  # int32 [R, T]
    ru: torch.Tensor,  # int32 [E] rows of d for each edge's tail
    rv: torch.Tensor,  # int32 [E] rows of d for each edge's head
    ve: torch.Tensor,  # int32 [E] node id of each edge's head
    w: torch.Tensor,  # int32 [E]
    overloaded: torch.Tensor,  # bool [>= max(ve) + 1]
) -> torch.Tensor:
    """out[e, t] = min(w[e] + d[rv[e], t], INF) == d[ru[e], t]
    and d[ru[e], t] < INF and (not overloaded[ve[e]] or t == ve[e]);
    bool [E, T]."""
    dev = d.device
    _check("d", d, torch.int32, 2, dev)
    for name, t in (("ru", ru), ("rv", rv), ("ve", ve), ("w", w)):
        _check(name, t, torch.int32, 1, dev)
        if t.shape[0] != ru.shape[0]:
            raise ValueError(f"{name}: length differs from ru")
    _check("overloaded", overloaded, torch.bool, 1, dev)
    e, t_cols = ru.shape[0], d.shape[1]
    if dev.type != "cuda":
        return _ecmp_triangle_plain(d, ru, rv, ve, w, overloaded)
    out = torch.empty((e, t_cols), dtype=torch.bool, device=dev)
    ECMP_TRIANGLE.launch(
        d.data_ptr(), ru.data_ptr(), rv.data_ptr(), ve.data_ptr(),
        w.data_ptr(), overloaded.data_ptr(), out.data_ptr(), e, t_cols,
    )
    return out


def _ecmp_triangle_plain(d, ru, rv, ve, w, overloaded):
    du = d[ru.long()]
    dv = d[rv.long()]
    triangle = (w[:, None] + dv).clamp_max(INF) == du
    cols = torch.arange(d.shape[1], dtype=torch.int32, device=d.device)
    transit_ok = (~overloaded[ve.long()])[:, None] | (
        cols[None, :] == ve[:, None]
    )
    return triangle & (du < INF) & transit_ok


def _ecmp_dag(d, src_e, dst_e, w_e, overloaded) -> torch.Tensor:
    """Per-edge shortest-DAG membership: out[e, t] == True iff directed edge
    e = (u -> v) is the first hop of some shortest path u -> t."""
    return ecmp_triangle(d, src_e, dst_e, dst_e, w_e, overloaded)


# -- public entry points ---------------------------------------------------


def sell_fixpoint(
    sell,  # ops.graph.SlicedEll
    sources,  # int32 [S]
    wgs,  # tuple of [nk, dk] weight arrays
    overloaded,  # bool [n_pad]
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Distance matrix D [S, N] via the sliced-ELL pull relaxation."""
    dev = resolve_device(device)
    with record_function("spf.sell_fixpoint"):
        return _sell_fixpoint_core(
            _rows(sources, len(overloaded), dev),
            tuple(_i32(a, dev) for a in sell.nbr),
            tuple(_i32(a, dev) for a in wgs),
            _bool(overloaded, dev),
            sell.zero_end,
            sell.starts,
        )


def batched_spf(
    graph: CompiledGraph, source_rows, device: DeviceLike = "cuda"
) -> torch.Tensor:
    """Run the batched solve for the given source node indices: the
    sliced-ELL pull kernel when the graph's degree profile qualifies
    (ops.graph._build_sell), else the edge-list form. D [S, n_pad]."""
    dev = resolve_device(device)
    if graph.sell is not None:
        return sell_fixpoint(
            graph.sell, source_rows, graph.sell.wg, graph.overloaded, dev
        )
    with record_function("spf.batched_cold"):
        return _bf_fixpoint(
            _rows(source_rows, graph.n_pad, dev),
            _i32(graph.src, dev),
            _i32(graph.dst, dev),
            _i32(graph.w, dev),
            _bool(graph.overloaded, dev),
            _i32(edge_csr(graph), dev),
        )


def batched_spf_vw(
    graph: CompiledGraph, source_rows, w_rows, device: DeviceLike = "cuda"
) -> torch.Tensor:
    """Batched solve with per-row weight vectors (shape [S, e_pad], or
    [1, e_pad] shared by every row). Positions past graph.e are padding
    and must hold INF, as they do in graph.w."""
    dev = resolve_device(device)
    with record_function("spf.batched_vw"):
        return _bf_fixpoint_vw_core(
            _rows(source_rows, graph.n_pad, dev),
            _i32(graph.src, dev),
            _i32(graph.dst, dev),
            _i32(w_rows, dev),
            _bool(graph.overloaded, dev),
            _i32(edge_csr(graph), dev),
        )


def ecmp_dag(
    graph: CompiledGraph, d, device: DeviceLike = "cuda"
) -> torch.Tensor:
    """First-hop DAG [e_pad, n_pad] for all-pairs distance matrix d (rows
    indexed by node id, i.e. solved with source_rows = arange(n_pad))."""
    dev = resolve_device(device)
    with record_function("spf.ecmp_dag"):
        return _ecmp_dag(
            _i32(d, dev),
            _i32(graph.src, dev),
            _i32(graph.dst, dev),
            _i32(graph.w, dev),
            _bool(graph.overloaded, dev),
        )
