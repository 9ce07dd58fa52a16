"""Batched multi-source shortest paths as min-plus relaxation on the card.

The per-source Dijkstra of the reference (openr/decision/LinkState.cpp:806-880)
becomes Bellman-Ford relaxation rounds over a whole batch of sources:

    D[s, v] <- min(D[s, v], min over edges (u->v): Dt[s, u] + w(u, v))

where Dt masks transit through overloaded nodes per source (a source's own
row keeps its outgoing edges — LinkState.cpp:829-836 semantics). Rounds are
Jacobi (each reads the previous round's D) and run until nothing changes,
capped at n rounds; the final no-change round is counted, so `rounds`
equals the JAX package's count.

Nine hand-written CUDA kernels carry the device work (ops/csrc/):

  K1 sell_relax_round    one round of the sliced-ELL pull over every bucket
  K2 bf_relax_round      the rounds of the edge-list form (no sliced layout)
  K3 ecmp_triangle       per-edge first-hop test w(u,v) + D[v,t] == D[u,t]
  K4 sell_apply_patches  an event's weight patches into the resident buckets
  K5 sell_mark           warm-start invalidation on the sliced layout
  K6 bf_mark             warm-start invalidation on the edge-list layout
  K7 delta_extract       changed destination columns and their copy-back
  K8 sell_mask           KSP link-ignore masks: bit-mask build, warm seed
  K9 sell_relax_masked_round  K1's round with K8's per-column masks

and three more carry the destination-tiled layout of a (batch, graph) mesh:

  K19 tile_round          one tiled round: masked gather of the tile-local
                          tails, clamped add, segment-min into the frontier
  K20 tile_fold           fold one frontier into the columns a rank owns
  K21 tile_mark           the tiled cold start, the warm path's marks and
                          reset, and the changed columns

The warm event path (an LSDB event answered from the previous fixpoint)
is K5 -> K4 -> K5 reset -> K1 -> K7 on the sliced layout and K6 -> K6
reset -> K2 -> K7 on the edge-list one: entries whose old shortest path
may cross an increased edge are reset to INF (Ramalingam-Reps
invalidation), everything else keeps its old distance, which is an upper
bound of the new one, and the relaxation repairs the rest.

Under a solver mesh (`parallel/mesh.py`) the same kernels run once per rank.
With a graph axis of one, the source batch is split into row slices, one per
batch rank, against layout arrays replicated on each rank's device (the
reference's `_mesh_shardings` placements). With a graph axis above one, each
rank keeps a [S/batch, n_pad/graph] tile of D and relaxes only the edges
whose tail it owns (`parallel/mesh.py:GraphTiling`); between rounds the
compact per-partition frontiers move one hop at a time around the graph
ring and each rank folds them into its own columns (K19 -> K20 per hop, the
halo exchange). One process drives every rank, as one jitted `shard_map`
does in the reference.

KSP's link-ignore re-solves (one batch row per destination, each with its
own links at INF) are K8 build -> K9 cold on the sliced layout, or K8
build + seed -> K5 rounds and reset -> K9 when warm-started from the base
fixpoint; on the edge-list layout K2 with per-row weights, or K6 with a
per-row seed -> K2 warm.

The fixpoints of K1, K5 and K9 (sliced layout) and of K2 and K6
(edge-list layout) keep their round state on the card
(ops/csrc/sell_rounds.cuh): the host enqueues rounds in chunks of
ROUND_CHUNK, a round after the fixpoint returns at once, and the host reads
the state once a chunk instead of a flag after every round. All five skip
the rows none of whose in-neighbours changed in the previous round, and
count the same Jacobi rounds as the reference. K1 and K2 keep D
destination-major [n_pad, S]; the edge-list entry points take and give the
reference's row-major [S, n_pad] and transpose once each way a solve.

Each wrapper checks device, dtype, shape and contiguity; on a CUDA tensor
it launches its kernel (and counts the launch), on a CPU tensor it runs the
plain PyTorch version beside it. The plain versions are the CPU tests' path
and the card's reference; nothing on the main path calls them on the card.

The ECMP first-hop DAG falls out of the triangle condition, which reproduces
the Dijkstra nexthop-union semantics of LinkState.cpp:855-871.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.ops._cuda import (
    BF_MARK,
    BF_RELAX,
    DELTA_EXTRACT,
    ECMP_TRIANGLE,
    SELL_MARK,
    SELL_MASK,
    SELL_PATCH,
    SELL_RELAX,
    SELL_RELAX_MASKED,
    TILE_FOLD,
    TILE_MARK,
    TILE_ROUND,
)
from openr_tpu_torch.ops.graph import INF, CompiledGraph, _next_bucket
from openr_tpu_torch.testing.faults import fault_point

_INT32_MAX = int(np.iinfo(np.int32).max)
# row index of a padding patch or KSP mask entry: out of range of every
# bucket, so K4 and K8's build drop it and the seeds skip it (valid = row
# < 1 << 29)
PATCH_PAD = 1 << 30


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


# -- mesh placements --------------------------------------------------------


def _on(x, device: torch.device):
    """`x` on `device`: a replicated operand (a dict device -> copy) gives
    its copy there, a tensor is moved (a no-op where it already lies), a
    tuple maps over its items."""
    if isinstance(x, dict):
        return x[device]
    if isinstance(x, tuple):
        return tuple(_on(a, device) for a in x)
    return x.to(device)


def mesh_devices(mesh) -> List[torch.device]:
    """The distinct devices of a mesh, in its order (a mesh may name one
    device several times: ranks sharing a card)."""
    out: List[torch.device] = []
    for dev in mesh.devices.flat:
        if dev not in out:
            out.append(dev)
    return out


def batch_devices(mesh) -> List[torch.device]:
    """The device of each batch rank of the row layout, graph rank 0: the
    row layout replicates over 'graph' (P('batch'))."""
    return [mesh.devices[i, 0] for i in range(mesh.shape["batch"])]


def split_rows(x: torch.Tensor, parts: int) -> List[torch.Tensor]:
    """`parts` equal row slices of x (contiguous): the 'batch' sharding."""
    if x.shape[0] % parts:
        raise ValueError(
            f"{x.shape[0]} rows do not split over a batch axis of {parts}"
        )
    step = x.shape[0] // parts
    return [x[i * step : (i + 1) * step].contiguous() for i in range(parts)]


class Sharded:
    """A row-major int32 matrix [S, N] held as a grid of blocks on a mesh:
    blocks[i][j] holds row block i and column block j on
    mesh.devices[i, j]. The row layout has one column block (its rank
    (i, 0) holds whole rows); the tiled layout has `graph` of them."""

    __slots__ = ("blocks",)

    def __init__(self, blocks: List[List[torch.Tensor]]) -> None:
        self.blocks = blocks

    @property
    def shape(self) -> Tuple[int, int]:
        rows = sum(row[0].shape[0] for row in self.blocks)
        return rows, sum(t.shape[1] for t in self.blocks[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0][0].dtype

    @property
    def nbytes(self) -> int:
        """The whole matrix's bytes, each block once (the memory ledger's
        logical size, as a sharded array's `nbytes` in the JAX package)."""
        return sum(t.nbytes for row in self.blocks for t in row)

    def numpy(self) -> np.ndarray:
        """The whole matrix on the host (an owned array)."""
        return np.concatenate([
            np.concatenate([t.cpu().numpy() for t in row], axis=1)
            for row in self.blocks
        ], axis=0)

    def gather(self, device: torch.device) -> torch.Tensor:
        """The whole matrix on `device`: an all-gather."""
        return torch.cat([
            torch.cat([t.to(device) for t in row], dim=1)
            for row in self.blocks
        ], dim=0).contiguous()

    def rows(self, idx: Sequence[int], device: torch.device) -> torch.Tensor:
        """Rows `idx` of the matrix, whole, gathered onto `device` (int32
        [len(idx), N]); only those rows move."""
        s_l = self.blocks[0][0].shape[0]
        out = [
            torch.cat([
                t[r % s_l : r % s_l + 1].to(device)
                for t in self.blocks[r // s_l]
            ], dim=1)
            for r in idx
        ]
        return torch.cat(out, dim=0).contiguous()


def to_host(d) -> np.ndarray:
    """A solve's distance matrix on the host: a tensor or a `Sharded`."""
    if isinstance(d, Sharded):
        return d.numpy()
    return d.cpu().numpy()


def _or_columns(col_changed: Sequence[torch.Tensor], device: torch.device):
    """The OR over ranks of per-rank changed-column masks, on `device`,
    and its popcount: the reference's pmax over 'batch' with its psum."""
    out = col_changed[0].to(device)
    for c in col_changed[1:]:
        out = out | c.to(device)
    return out, out.sum(dtype=torch.int32)


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
    bits: Optional[Sequence[torch.Tensor]] = None,  # int32 [nk, dk, W]
    cold: bool = False,
) -> Tuple[torch.Tensor, int]:
    """Min-plus relaxation from dest-major initial state d0 to the fixpoint.

    Returns (d [n_pad, S], rounds). Valid for any d0 that is an entrywise
    upper bound of the true distances with the source diagonal pinned to 0.
    Rows [0, zero_end) and the padding rows past the last bucket never
    change. zero_end is implied by starts and kept for the reference's
    signature. d0 is consumed: on the card it is one of the two round
    buffers, so a caller that needs it afterwards passes a copy. `cold`
    says that d0 is `_sell_d0(sources, n_pad)`: K1's first round then
    gathers only from the source rows, the only rows off INF. (Stamping
    the rows of any d0 below INF on the host, `(d0 < INF).any(1)`, would
    serve both starts with one round 1, but that extra pass made the
    Clos's cold solve at S = 8 and the WAN event's warm relax about a
    tenth slower on an H100; `PERF.md` §6.)

    With `bits` (K8's per-bucket bit masks, `_sell_mask_bits`), slot (r, j)
    weighs INF for batch column s where bit s of bits[k][r, j] is set: the
    reference's per-row wg [nk, dk, S] form, relaxed by K9 on the card."""
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
    if bits is not None:
        if len(bits) != len(nbrs):
            raise ValueError("bits and nbrs differ in bucket count")
        words = _mask_words(s)
        for k, (nbr_k, bits_k) in enumerate(zip(nbrs, bits)):
            _check(f"bits[{k}]", bits_k, torch.int32, 3, dev)
            if tuple(bits_k.shape) != (*nbr_k.shape, words):
                raise ValueError(f"bits[{k}]: bad shape {tuple(bits_k.shape)}")
    if dev.type == "cuda":
        return _sell_relax_cuda(
            d0, sources, overloaded, nbrs, wgs, starts, cold, bits
        )
    if bits is not None:
        wgs = _sell_masked_wgs_plain(wgs, bits, s)
    return _sell_relax_plain(d0, sources, overloaded, nbrs, wgs, starts)


def _sell_relax_plain(d0, sources, overloaded, nbrs, wgs, starts):
    """Plain PyTorch version of K1's fixpoint (the JAX body, vectorised over
    each bucket's dk slots); a bucket's wg is [nk, dk] (shared) or
    [nk, dk, S] (per batch column: K9's)."""
    n = d0.shape[0]
    allow = _sell_d0_allow(sources, overloaded)[1]
    idx = [nbr_k.long() for nbr_k in nbrs]
    wcols = [wg_k if wg_k.dim() == 3 else wg_k[:, :, None] for wg_k in wgs]
    d, rounds = d0, 0
    while True:
        dt = torch.where(allow, d, INF)
        new_d = d.clone()
        for bs, nbr_k, wg_k in zip(starts, idx, wcols):
            nk = nbr_k.shape[0]
            cand = (dt[nbr_k] + wg_k).clamp_max(INF).amin(dim=1)
            new_d[bs : bs + nk] = torch.minimum(d[bs : bs + nk], cand)
        rounds += 1
        changed = not torch.equal(new_d, d)
        d = new_d
        if not changed or rounds >= n:
            return d, rounds


# K1's, K2's, K5's, K6's and K9's rounds per host read of their round
# state on the card
ROUND_CHUNK = 8
# K1's and K9's kernel launches a round: the active rows, then the round
# over them
K1_ROUND_KERNELS = 2
# K2's and K6's: the rows that can move (a thread an edge), then the round
K2_ROUND_KERNELS = 2
K6_ROUND_KERNELS = 2
_BUCKET_TABLE_MAX = 64  # sell_rounds.cuh kMaxBuckets: the layout has <= 44
_STATE_WORDS = 8  # sell_rounds.cuh RoundState


def _bucket_table(nbrs, wgs, starts) -> np.ndarray:
    """K1's and K5's host bucket table, int64 [nb, 5]: row k is (nbrs[k]'s
    and wgs[k]'s data pointers, starts[k], nk, dk), which sell_rounds.cuh
    copies into its kernel parameter. Raises above 64 buckets."""
    if len(nbrs) > _BUCKET_TABLE_MAX:
        raise ValueError(
            f"K1 and K5 take at most {_BUCKET_TABLE_MAX} buckets, got "
            f"{len(nbrs)}"
        )
    rows = [
        (nbr_k.data_ptr(), wg_k.data_ptr(), int(bs), *nbr_k.shape)
        for bs, nbr_k, wg_k in zip(starts, nbrs, wgs)
    ]
    return np.array(rows, dtype=np.int64).reshape(len(nbrs), 5)


def _fixpoint_rounds(launch: Callable[[int, int], None],
                     state: torch.Tensor, cap: int) -> int:
    """Drive a fixpoint whose rounds keep their state on the card
    (sell_rounds.cuh): enqueue rounds t = 1, 2, ... ROUND_CHUNK at a time
    (`launch(t0, count)`: one host call for rounds t0 .. t0 + count - 1),
    read (done, rounds) once a chunk, stop when done or at `cap` rounds.
    Returns the rounds that ran, the final no-change round included."""
    t = 0
    while t < cap:
        count = min(ROUND_CHUNK, cap - t)
        launch(t + 1, count)
        t += count
        done, rounds = state[:2].tolist()
        if done:
            return rounds
    return cap


def round_launches(rounds: int, cap: int) -> int:
    """The rounds `_fixpoint_rounds` enqueues for a fixpoint of `rounds`
    rounds capped at `cap`: whole chunks, at least one. K5 launches a
    kernel a round; K1, K9, K2 and K6 two (K1_ROUND_KERNELS,
    K2_ROUND_KERNELS, K6_ROUND_KERNELS)."""
    chunks = max(1, -(-rounds // ROUND_CHUNK))
    return min(cap, chunks * ROUND_CHUNK)


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _sell_relax_cuda(d0, sources, overloaded, nbrs, wgs, starts, cold,
                     bits=None):
    """K1's fixpoint, or K9's with K8's bit masks `bits`: two launches a
    round (the rows that can move, then the round over them), each for
    every bucket, rounds enqueued a chunk a host call (`_fixpoint_rounds`).
    d0 is round buffer 0; buffer 1 starts as its copy, so the rows outside
    the buckets hold their values in both. `aux` holds the row stamps [2,
    n], the active-row lists [n], their counts [64] and the round state,
    all 0; a cold start stamps the source rows as changed by the initial
    state, any other start takes every slot in round 1. K9's mask pointers
    go to the kernel in a host array beside the bucket table."""
    n, s = d0.shape
    if s == 0 or not any(nbr_k.shape[0] for nbr_k in nbrs):
        return d0, 1  # one round, nothing to relax
    table = _bucket_table(nbrs, wgs, starts)
    nxt = d0.clone()
    at = 3 * n + _BUCKET_TABLE_MAX
    aux = torch.zeros(at + _STATE_WORDS, dtype=torch.int32, device=d0.device)
    if cold:
        aux[sources.long()] = 1
    vec = int(s % 4 == 0 and _aligned(d0, nxt))
    args = (d0.data_ptr(), nxt.data_ptr(), aux.data_ptr(),
            sources.data_ptr(), overloaded.data_ptr(), table.ctypes.data)
    kernel, entry = SELL_RELAX, "sell_relax_rounds"
    if bits is not None:
        masks = np.array([b_k.data_ptr() for b_k in bits], dtype=np.int64)
        kernel, entry = SELL_RELAX_MASKED, "sell_relax_masked_rounds"
        args += (masks.ctypes.data,)
    args += (len(nbrs), s, n)

    def launch(t0, count):
        kernel.launch(d0.device, *args, t0, count, int(not cold), vec,
                      entry=entry, kernels=K1_ROUND_KERNELS * count)

    rounds = _fixpoint_rounds(launch, aux[at:], n)
    return (d0, nxt)[rounds & 1], rounds


def _sell_fixpoint_core(sources, nbrs, wgs, overloaded, zero_end, starts):
    """Cold-start fixpoint (distances only), row-major [S, N]."""
    return _sell_solver_counted(
        (zero_end, tuple(starts), None), sources, nbrs, wgs, overloaded
    )[0]


def _sell_solver_counted(
    key: Tuple, sources, nbrs, wgs, overloaded, mesh=None
) -> Tuple[torch.Tensor, int]:
    """Cold sliced-ELL solve for the structure `key` (SlicedEll.shape_key()):
    (D [S, n_pad] row-major and contiguous, relaxation rounds).

    With a mesh, the sources split into one row slice per batch rank and
    each rank solves its slice (K1) against the layout on its device
    (nbrs, wgs and overloaded: dicts device -> copy, or tensors to move):
    D comes back `Sharded`, and rounds is the most any rank ran, which is
    the count of the reference's one loop over the whole batch (a rank that
    has converged changes nothing in the rounds the others still run)."""
    if mesh is not None:
        shards, rounds = [], 0
        for dev, src in zip(
            batch_devices(mesh), split_rows(sources, mesh.shape["batch"])
        ):
            d, r = _sell_solver_counted(
                key, src.to(dev), _on(nbrs, dev), _on(wgs, dev),
                _on(overloaded, dev),
            )
            shards.append([d])
            rounds = max(rounds, r)
        return Sharded(shards), rounds
    zero_end, starts, _ = key
    d0 = _sell_d0(sources, overloaded.shape[0])
    d, rounds = _sell_relax(
        d0, sources, overloaded, nbrs, wgs, zero_end, starts, cold=True
    )
    return d.t().contiguous(), rounds


# -- K2: edge-list relaxation ----------------------------------------------


def _dest_major(d: torch.Tensor) -> torch.Tensor:
    """A new dest-major copy [n, S] of row-major d [S, n]: its own memory
    even where d.t() is already contiguous (S or n of 1), since K2's
    rounds and K6's reset write into it."""
    out = torch.empty((d.shape[1], d.shape[0]), dtype=d.dtype,
                      device=d.device)
    return out.copy_(d.t())


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
    The fixpoint runs dest-major (`_bf_relax_dm`): d0 is transposed in
    once and D out once; d0 itself is read, never written."""
    _check("d0", d0, torch.int32, 2, d0.device)
    d, rounds = _bf_relax_dm(
        _dest_major(d0), sources, overloaded, src_e, dst_e, w_rows, csr
    )
    return d.t().contiguous(), rounds


def _bf_relax_dm(
    d0: torch.Tensor,  # int32 [n_pad, S] dest-major
    sources: torch.Tensor,  # int32 [S]
    overloaded: torch.Tensor,  # bool [n_pad]
    src_e: torch.Tensor,  # int32 [E]
    dst_e: torch.Tensor,  # int32 [E], sorted ascending
    w_rows: torch.Tensor,  # int32 [1, E] (shared) or [S, E] (per row)
    csr: torch.Tensor,  # int32 [n_pad + 1] in-edge ranges (edge_csr)
    cold: bool = False,
    w_t: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, int]:
    """K2's fixpoint in its own layout: dest-major d0 [n_pad, S] to (d
    [n_pad, S], rounds), as `_sell_relax` takes K1's. d0 is consumed: on
    the card it is one of the two round buffers. `cold` says that d0 is
    `_sell_d0(sources, n_pad)`: round 1 then gathers only from the source
    rows. `w_t`: per-row weights already in K2's form (`_bf_weights_t`), so
    that a warm solve transposes them once for K6's seed and K2."""
    dev = d0.device
    _check("d0", d0, torch.int32, 2, dev)
    n, s = d0.shape
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
        if w_rows.shape[0] > 1 and w_t is None:
            w_t = _bf_weights_t(w_rows)
        return _bf_relax_cuda(d0, sources, overloaded, src_e, dst_e, csr,
                              w_rows[0] if w_t is None else w_t, cold)
    d, rounds = _bf_relax_plain(d0.t().contiguous(), sources, overloaded,
                                src_e, dst_e, w_rows, csr)
    return d.t().contiguous(), rounds


def _bf_relax_plain(d0, sources, overloaded, src_e, dst_e, w_rows, csr):
    """Plain PyTorch version of K2's fixpoint over the edges csr covers,
    row-major as the reference: [S, E] gather, then a segment-min by
    destination as scatter_reduce(amin)."""
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


_LANE_SPLITS = 6  # sell_rounds.cuh kClasses: a row list per slot split


def _csr_list_words(n: int) -> int:
    """The int32 words of K2's and K6's row lists (sell_rounds.cuh
    CsrLists), zeroed by the host: a claim word a row, a list a slot
    split, the lists' counts."""
    return (1 + _LANE_SPLITS) * n + 8


def _bf_weights_t(w_rows: torch.Tensor) -> torch.Tensor:
    """Per-row weights [S, E] in K2's and K6's form [E, S]: an edge's 4
    columns are 16 contiguous bytes. All E edges: the real ones end at
    csr[n_pad], which lies on the card."""
    return w_rows.t().contiguous()


def _bf_relax_cuda(d0, sources, overloaded, src_e, dst_e, csr, w, cold):
    """K2's fixpoint: two launches a round (the rows that can move, then
    the round over them), rounds enqueued a chunk a host call
    (`_fixpoint_rounds`). d0 is round buffer 0; buffer 1 starts as its
    copy, so the rows no round writes hold their values in both. `aux`
    holds the row stamps [2, n], the round state and the row lists, all 0;
    a cold start stamps the source rows as changed by the initial state,
    any other start takes every in-edge in round 1. w: the shared [E]
    weights, or per-row ones as `_bf_weights_t` gives them."""
    n, s = d0.shape
    if s == 0 or src_e.shape[0] == 0:
        return d0, 1  # one round, nothing to relax
    per_col = int(w.dim() == 2)
    nxt = d0.clone()
    aux = torch.zeros(2 * n + _STATE_WORDS + _csr_list_words(n),
                      dtype=torch.int32, device=d0.device)
    if cold:
        aux[sources.long()] = 1
    vec = int(s % 4 == 0 and _aligned(d0, nxt, *((w,) if per_col else ())))
    args = (d0.data_ptr(), nxt.data_ptr(), aux.data_ptr(),
            sources.data_ptr(), overloaded.data_ptr(), csr.data_ptr(),
            src_e.data_ptr(), dst_e.data_ptr(), w.data_ptr(), per_col, s, n,
            src_e.shape[0])

    def launch(t0, count):
        BF_RELAX.launch(d0.device, *args, t0, count, int(not cold), vec,
                        kernels=K2_ROUND_KERNELS * count)

    rounds = _fixpoint_rounds(launch, aux[2 * n :], n)
    return (d0, nxt)[rounds & 1], rounds


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
    edge-weight vector (KSP link-ignore re-solves as extra batch rows).
    The cold state is built dest-major, K2's layout, and D transposed out
    once."""
    d0 = _sell_d0(sources, overloaded.shape[0])
    d, _ = _bf_relax_dm(d0, sources, overloaded, src_e, dst_e, w_rows, csr,
                        cold=True)
    return d.t().contiguous()


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
    if e * t_cols:
        ECMP_TRIANGLE.launch(
            dev,
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


# -- K4: weight patches ----------------------------------------------------


def _sell_apply_patches(
    wgs: Sequence[torch.Tensor],  # int32 [nk, dk] per bucket, patched in place
    patch_idx: torch.Tensor,  # int32 [B, P, 2] (row, slot) per bucket
    patch_vals: torch.Tensor,  # int32 [B, P]
) -> Tuple[torch.Tensor, ...]:
    """Scatter per-bucket weight patches into the bucket arrays IN PLACE
    and return them. The reference returns new buffers and donates the old
    ones; every caller here keeps its handles, so writing in place saves a
    copy of every bucket per event. A patch whose row or slot lies outside
    its bucket is dropped, as JAX's mode="drop" does: padding rows carry
    PATCH_PAD (the host never sends a negative index or two patches for one
    slot). On the card one launch patches every bucket."""
    dev = patch_idx.device
    _check("patch_idx", patch_idx, torch.int32, 3, dev)
    _check("patch_vals", patch_vals, torch.int32, 2, dev)
    b, p, two = patch_idx.shape
    if two != 2 or tuple(patch_vals.shape) != (b, p) or b != len(wgs):
        raise ValueError("patch_idx/patch_vals do not match the buckets")
    table = _patch_table(wgs, dev)
    if dev.type != "cuda":
        return _sell_apply_patches_plain(wgs, patch_idx, patch_vals)
    if p and b:
        SELL_PATCH.launch(
            dev, patch_idx.data_ptr(), patch_vals.data_ptr(),
            table.ctypes.data, b, p,
        )
    return tuple(wgs)


_PATCH_BUCKETS = 64  # sell_patch.cu kMaxBuckets: the layout has at most 44


def _patch_table(wgs: Sequence[torch.Tensor], dev) -> np.ndarray:
    """K4's host table, int64 [nb, 4]: row k is (wgs[k]'s data pointer, nk,
    dk, 0), which sell_patch.cu copies into its kernel parameter. Checks
    every bucket in the same one pass; raises above _PATCH_BUCKETS."""
    if len(wgs) > _PATCH_BUCKETS:
        raise ValueError(
            f"K4 takes at most {_PATCH_BUCKETS} buckets, got {len(wgs)}"
        )
    rows = []
    for k, wg_k in enumerate(wgs):
        _check(f"wgs[{k}]", wg_k, torch.int32, 2, dev)
        rows.append((wg_k.data_ptr(), *wg_k.shape, 0))
    return np.array(rows, dtype=np.int64).reshape(len(wgs), 4)


def sell_patch_arrays(
    sell, positions: np.ndarray, w: np.ndarray, width: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host side of K4: (idx [B, width, 2], vals [B, width]) int32 for the
    edge positions `positions` (dst-sorted order) of a sliced layout, split
    by bucket and padded with PATCH_PAD rows; vals[k, i] = w[position]. A
    bucket with more than `width` positions raises."""
    nb = len(sell.nbr)
    idx = np.full((nb, width, 2), PATCH_PAD, dtype=np.int32)
    vals = np.zeros((nb, width), dtype=np.int32)
    positions = np.asarray(positions, dtype=np.int64)
    for k in range(nb):
        sel = positions[sell.edge_bucket[positions] == k]
        if len(sel) > width:
            raise ValueError(f"bucket {k}: {len(sel)} patches > {width}")
        idx[k, : len(sel), 0] = sell.edge_row[sel]
        idx[k, : len(sel), 1] = sell.edge_slot[sel]
        vals[k, : len(sel)] = w[sel]
    return idx, vals


def _sell_apply_patches_plain(wgs, patch_idx, patch_vals):
    for k, wg_k in enumerate(wgs):
        nk, dk = wg_k.shape
        r = patch_idx[k, :, 0].long()
        j = patch_idx[k, :, 1].long()
        keep = (r >= 0) & (r < nk) & (j >= 0) & (j < dk)
        wg_k[r[keep], j[keep]] = patch_vals[k][keep]
    return tuple(wgs)


def _sell_solver_patched(
    key: Tuple, sources, nbrs, wgs, overloaded, patch_idx, patch_vals,
    mesh=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...], int]:
    """Patch the resident weights (K4), then solve cold (K1): (D [S, n_pad]
    row-major, the patched wgs, rounds). With a mesh, wgs is a dict device
    -> buckets: each device's copy is patched once, then every batch rank
    solves its row slice (`_sell_solver_counted`)."""
    if mesh is not None:
        for dev in mesh_devices(mesh):
            _sell_apply_patches(
                wgs[dev], _on(patch_idx, dev), _on(patch_vals, dev)
            )
        d, rounds = _sell_solver_counted(
            key, sources, nbrs, wgs, overloaded, mesh
        )
        return d, wgs, rounds
    wgs = _sell_apply_patches(wgs, patch_idx, patch_vals)
    d, rounds = _sell_solver_counted(key, sources, nbrs, wgs, overloaded)
    return d, wgs, rounds


# -- K5: invalidation on the sliced layout ---------------------------------


def _sell_invalidate(
    d_prev: torch.Tensor,  # int32 [S, n_pad] row-major OLD fixpoint
    nbrs: Sequence[torch.Tensor],
    wgs: Sequence[torch.Tensor],  # the OLD bucket weights
    inc_idx: torch.Tensor,  # int32 [B, P, 2] (row, slot) of increased edges
    zero_end: int,
    starts: Sequence[int],
) -> Tuple[torch.Tensor, int]:
    """Ramalingam-Reps invalidation on the sliced layout: (marks, rounds of
    the mark fixpoint). The marks are K5's bits int32 [n_pad, ceil(S / 32)]
    on either device (`marks_bool` reads them as bool [S, n_pad]).

    Seeds mark the entries where an increased edge satisfies the triangle
    equality against the OLD weights (so this runs before the patch); the
    marks then propagate down the old shortest-path DAG to a fixpoint.
    Over-marking is safe (marked entries are recomputed from INF); every
    true DAG edge passes the unmasked triangle test, so nothing that needs
    recomputing is left unmarked. Padding rows (PATCH_PAD) seed nothing;
    other rows and slots are clipped into their bucket, as the reference
    does. On the card one launch seeds every bucket and the rounds follow
    it with no host read in between."""
    dev = d_prev.device
    _check("d_prev", d_prev, torch.int32, 2, dev)
    n = d_prev.shape[1]
    if len(nbrs) != len(wgs) or len(nbrs) != len(starts):
        raise ValueError("nbrs, wgs and starts differ in bucket count")
    for k, (nbr_k, wg_k) in enumerate(zip(nbrs, wgs)):
        _check(f"nbrs[{k}]", nbr_k, torch.int32, 2, dev)
        _check(f"wgs[{k}]", wg_k, torch.int32, 2, dev)
        if nbr_k.shape != wg_k.shape or starts[k] + nbr_k.shape[0] > n:
            raise ValueError(f"bucket {k}: bad shape {tuple(nbr_k.shape)}")
    _check("inc_idx", inc_idx, torch.int32, 3, dev)
    if inc_idx.shape[0] != len(nbrs) or inc_idx.shape[2] != 2:
        raise ValueError("inc_idx must be [buckets, P, 2]")
    s, n = d_prev.shape
    p = inc_idx.shape[1]
    if dev.type != "cuda":
        marks = _sell_seed_plain(d_prev, nbrs, wgs, inc_idx, starts)
        return _sell_mark_fixpoint(
            d_prev, marks, nbrs, wgs, zero_end, starts, bool(marks.any())
        )
    buf = _mark_buffer(s, n, dev)
    marks = _mark_words(buf, s, n)
    if not (p and s and any(a.numel() for a in nbrs)):
        return marks, 0  # nothing can seed
    table = _bucket_table(nbrs, wgs, starts)
    SELL_MARK.launch(
        dev,
        d_prev.data_ptr(), buf.data_ptr(), inc_idx.data_ptr(),
        table.ctypes.data, len(nbrs), p, s, n, _mask_words(s),
        entry="sell_mark_seed",
    )
    return marks, _sell_mark_rounds(d_prev, buf, table, s, n)


def _mark_buffer(s: int, n: int, dev) -> torch.Tensor:
    """K5's zeroed fixpoint buffer (sell_mark.cu): the marks M [n, W], the
    newly marked bits N [2, n, W], the row stamps F [2, n] and the round
    state, W = ceil(s / 32) int32 words a row."""
    w = _mask_words(s)
    return torch.zeros(3 * n * w + 2 * n + _STATE_WORDS, dtype=torch.int32,
                       device=dev)


def _mark_words(buf: torch.Tensor, s: int, n: int) -> torch.Tensor:
    """The marks M [n, W] of a K5 buffer, as a view."""
    w = _mask_words(s)
    return buf[: n * w].view(n, w)


def _sell_mark_rounds(d_prev, buf, table, s: int, n: int) -> int:
    """K5's mark rounds after its round 0 (seed or pack), enqueued a chunk
    at a time; returns their count (0 when round 0 marked nothing)."""
    w = _mask_words(s)
    state = buf[3 * n * w + 2 * n :]
    args = (d_prev.data_ptr(), buf.data_ptr(), table.ctypes.data,
            table.shape[0], s, n, w)

    def launch(t0, count):
        SELL_MARK.launch(d_prev.device, *args, t0, count,
                         entry="sell_mark_rounds", kernels=count)

    return _fixpoint_rounds(launch, state, n)


def marks_bool(marks: torch.Tensor, s: int) -> torch.Tensor:
    """K5's bits int32 [n, ceil(s / 32)] as bool [s, n] row-major marks:
    column c's mark of node v is bit c % 32 of marks[v, c // 32]."""
    cols = torch.arange(s, device=marks.device)
    bits = marks[:, cols // 32] >> (cols % 32).to(torch.int32)
    return (bits & 1).bool().t().contiguous()


def marks_bits(marks: torch.Tensor) -> torch.Tensor:
    """Bool [S, n] row-major marks as K5's bits int32 [n, ceil(S / 32)]:
    the plain version of sell_mark.cu's pack."""
    s, n = marks.shape
    w = _mask_words(s)
    padded = torch.zeros((w * 32, n), dtype=torch.int64, device=marks.device)
    padded[:s] = marks.long()
    shifts = torch.arange(32, dtype=torch.int64, device=marks.device)
    words = (padded.view(w, 32, n) << shifts[None, :, None]).sum(dim=1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.t().to(torch.int32).contiguous()


def _sell_seed_plain(d_prev, nbrs, wgs, inc_idx, starts):
    s, n = d_prev.shape
    hits = torch.zeros((s, n), dtype=torch.int32, device=d_prev.device)
    for k, (bs, nbr_k, wg_k) in enumerate(zip(starts, nbrs, wgs)):
        nk, dk = nbr_k.shape
        rows = inc_idx[k, :, 0]
        valid = rows < (1 << 29)
        r = rows.clamp(0, nk - 1).long()
        j = inc_idx[k, :, 1].clamp(0, dk - 1).long()
        u = nbr_k[r, j].long()
        w_old = wg_k[r, j]
        v = bs + r
        dv = d_prev[:, v]  # [S, P]
        cond = (
            valid[None, :]
            & (dv < INF)
            & ((d_prev[:, u] + w_old[None, :]).clamp_max(INF) == dv)
        )
        hits.index_add_(1, v, cond.int())
    return hits > 0


def _sell_mark_fixpoint(
    d_prev, marks, nbrs, wgs, zero_end, starts, seeded: bool
) -> Tuple[torch.Tensor, int]:
    """Propagate marks down the old shortest-path DAG: an entry marks when
    one of its old-DAG in-edges carries a marked tail. Jacobi rounds until
    nothing changes, capped at n_pad; no round runs when nothing was seeded
    (`seeded`, read from the seed pass, so a decrease-only event pays
    nothing). Takes bool [S, n_pad] marks; returns (marks, rounds), the
    marks as `_sell_invalidate` gives them (K5's bits; on the card K5's
    pack turns the bools into its round 0). zero_end is implied by starts
    and kept for the reference's signature."""
    s, n = d_prev.shape
    dev = d_prev.device
    _check("marks", marks, torch.bool, 2, dev)
    if marks.shape != d_prev.shape:
        raise ValueError("marks do not match d_prev's shape")
    if dev.type != "cuda":
        rounds = 0
        if seeded:
            marks, rounds = _sell_mark_fixpoint_plain(
                d_prev, marks, nbrs, wgs, starts
            )
        return marks_bits(marks), rounds
    buf = _mark_buffer(s, n, dev)
    if not (seeded and s and any(a.numel() for a in nbrs)):
        return _mark_words(buf, s, n), 0
    SELL_MARK.launch(
        dev, marks.data_ptr(), buf.data_ptr(), s, n, _mask_words(s),
        entry="sell_mark_pack",
    )
    table = _bucket_table(nbrs, wgs, starts)
    return _mark_words(buf, s, n), _sell_mark_rounds(d_prev, buf, table, s, n)


def _sell_mark_fixpoint_plain(d_prev, marks, nbrs, wgs, starts):
    n = d_prev.shape[1]
    idx = [nbr_k.long() for nbr_k in nbrs]
    m, rounds = marks, 0
    while True:
        new_m = m.clone()
        for bs, nbr_k, wg_k in zip(starts, idx, wgs):
            nk = nbr_k.shape[0]
            dv = d_prev[:, bs : bs + nk]  # [S, nk]
            cand = (d_prev[:, nbr_k] + wg_k[None]).clamp_max(INF)
            on_dag = cand == dv[:, :, None]  # [S, nk, dk]
            hit = (m[:, nbr_k] & on_dag).any(dim=2) & (dv < INF)
            new_m[:, bs : bs + nk] |= hit
        rounds += 1
        changed = not torch.equal(new_m, m)
        m = new_m
        if not changed or rounds >= n:
            return m, rounds


def _sell_warm_d0(
    d_prev: torch.Tensor, marks: torch.Tensor, sources: torch.Tensor
) -> torch.Tensor:
    """The repaired initial state in K1's layout: dest-major [n_pad, S] of
    where(marks, INF, d_prev) with every source's own entry pinned to 0.
    `marks`: K5's bits, as `_sell_invalidate` gives them."""
    dev = d_prev.device
    s, n = d_prev.shape
    _check("sources", sources, torch.int32, 1, dev)
    if sources.shape[0] != s:
        raise ValueError("sources do not match d_prev's shape")
    _check("marks", marks, torch.int32, 2, dev)
    if tuple(marks.shape) != (n, _mask_words(s)):
        raise ValueError(
            f"marks must be K5's bits [{n}, {_mask_words(s)}], got "
            f"{tuple(marks.shape)}"
        )
    if dev.type != "cuda":
        return _bf_warm_d0_plain(
            d_prev, marks_bool(marks, s), sources
        ).t().contiguous()
    d0 = torch.empty((n, s), dtype=torch.int32, device=dev)
    SELL_MARK.launch(
        dev,
        d_prev.data_ptr(), marks.data_ptr(), sources.data_ptr(),
        d0.data_ptr(), s, n, _mask_words(s), entry="sell_mark_reset",
    )
    return d0


def _sell_solver_warm(
    key: Tuple,
    sources,  # int32 [S]
    nbrs,
    wgs,  # resident buckets, patched in place
    overloaded,  # bool [n_pad], the mask after the event
    patch_idx,  # int32 [B, P, 2]
    patch_vals,  # int32 [B, P]
    inc_idx,  # int32 [B, P, 2]: increased edges and newly-overloaded out-edges
    d_prev,  # int32 [S, n_pad] row-major previous fixpoint
    mesh=None,
):
    """Warm-start event solve on the sliced layout: invalidate against the
    OLD weights (K5 seed + rounds), patch (K4), reset to the repaired
    dest-major state (K5 reset), relax from it (K1) and mark the columns
    that moved (K7 columns). Returns (D [S, n_pad] row-major, wgs, rounds,
    inv_rounds, col_changed bool [n_pad], num_changed int32 scalar tensor).
    Rounds scale with the event's affected radius, not the graph's
    diameter. d_prev is read, never written.

    With a mesh, d_prev is the `Sharded` row layout of the previous solve
    and nbrs, wgs and overloaded are dicts device -> copy. Every rank
    invalidates its row slice against the OLD weights before any device's
    copy is patched (ranks may share a device and so a copy), then each
    rank resets and relaxes. D comes back `Sharded`; rounds and inv_rounds
    are the most any rank ran (the reference's loops run over the whole
    batch); col_changed is the OR over ranks, on the first mesh device."""
    zero_end, starts, _ = key
    if mesh is not None:
        devs = batch_devices(mesh)
        srcs = split_rows(sources, len(devs))
        inv = [
            _sell_invalidate(
                blk[0], _on(nbrs, dev), _on(wgs, dev), _on(inc_idx, dev),
                zero_end, starts,
            )
            for dev, blk in zip(devs, d_prev.blocks)
        ]
        for dev in mesh_devices(mesh):
            _sell_apply_patches(
                wgs[dev], _on(patch_idx, dev), _on(patch_vals, dev)
            )
        shards, changed, rounds = [], [], 0
        for dev, src, blk, (marks, _) in zip(devs, srcs, d_prev.blocks, inv):
            src = src.to(dev)
            d0 = _sell_warm_d0(blk[0], marks, src)
            del marks
            d, r = _sell_relax(
                d0, src, _on(overloaded, dev), _on(nbrs, dev),
                _on(wgs, dev), zero_end, starts,
            )
            d = d.t().contiguous()
            changed.append(delta_columns(d, blk[0])[0])
            shards.append([d])
            rounds = max(rounds, r)
        col_changed, num_changed = _or_columns(changed, devs[0])
        inv_rounds = max(r for _, r in inv)
        return (Sharded(shards), wgs, rounds, inv_rounds, col_changed,
                num_changed)
    marks, inv_rounds = _sell_invalidate(
        d_prev, nbrs, wgs, inc_idx, zero_end, starts
    )
    wgs = _sell_apply_patches(wgs, patch_idx, patch_vals)
    d0 = _sell_warm_d0(d_prev, marks, sources)
    del marks
    d, rounds = _sell_relax(
        d0, sources, overloaded, nbrs, wgs, zero_end, starts
    )
    d = d.t().contiguous()
    col_changed, num_changed = delta_columns(d, d_prev)
    return d, wgs, rounds, inv_rounds, col_changed, num_changed


# -- K8 + K9: KSP link-ignore masks on the sliced layout -------------------


def _mask_words(s: int) -> int:
    """32-bit words per slot of K8's bit mask for a batch of s columns."""
    return (s + 31) // 32


def sell_mask_arrays(sell, mask_positions) -> List[np.ndarray]:
    """Host half of `sell_fixpoint_masked`: mask_positions[c] lists the edge
    positions (dst-sorted order) that batch column c ignores. Returns one
    int32 [Mk, 3] array of (row-in-bucket, slot, column) per bucket, in the
    order the positions come, padded to _next_bucket(max(Mk, 1)) rows of
    PATCH_PAD in all three columns: the reference's arrays exactly."""
    per_bucket: List[list] = [[] for _ in sell.nbr]
    for col, positions in enumerate(mask_positions):
        for p in positions:
            per_bucket[sell.edge_bucket[p]].append(
                (sell.edge_row[p], sell.edge_slot[p], col)
            )
    masks = []
    for entries in per_bucket:
        arr = np.full(
            (_next_bucket(max(len(entries), 1)), 3), PATCH_PAD, dtype=np.int32
        )
        if entries:
            arr[: len(entries)] = np.asarray(entries, dtype=np.int32)
        masks.append(arr)
    return masks


def sell_mask_packed(
    sell, mask_positions
) -> Tuple[np.ndarray, np.ndarray]:
    """`sell_mask_arrays` laid end to end for one upload: (int32 [sum Mk,
    3] the per-bucket arrays in bucket order, int64 [nb + 1] offsets;
    bucket k's entries are rows offsets[k]:offsets[k + 1]). `mask_views`
    turns the uploaded array back into the per-bucket arrays K8 takes."""
    masks = sell_mask_arrays(sell, mask_positions)
    offsets = np.zeros(len(masks) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([m.shape[0] for m in masks])
    return np.concatenate(masks), offsets


def mask_views(
    packed: torch.Tensor, offsets: np.ndarray
) -> Tuple[torch.Tensor, ...]:
    """The per-bucket [Mk, 3] views of a packed mask array: consecutive
    rows of one buffer, which K8's launches read as one array."""
    return tuple(
        packed[int(a) : int(b)] for a, b in zip(offsets[:-1], offsets[1:])
    )


def _check_masks(masks, nbrs, dev) -> None:
    if len(masks) != len(nbrs):
        raise ValueError("masks and nbrs differ in bucket count")
    for k, (m_k, nbr_k) in enumerate(zip(masks, nbrs)):
        _check(f"masks[{k}]", m_k, torch.int32, 2, dev)
        _check(f"nbrs[{k}]", nbr_k, torch.int32, 2, dev)
        if m_k.shape[1] != 3:
            raise ValueError(f"masks[{k}] must be [M, 3]")


_MASK_BUCKETS = 64  # sell_mask.cu kMaxBuckets: the layout has at most 44


def _mask_launch_args(masks, nbrs, wgs, starts, words: int):
    """What one K8 launch over every bucket takes: (entries, the host table
    of sell_mask.cu, M). `entries` is the buckets' [Mk, 3] lists as one
    int32 [M, 3] array: their own memory where they lie end to end (the
    views of `mask_views`), else a concatenation. Table row k: (first
    entry, nk, dk, row0, first word of its bit mask, nbr, wg, 0)."""
    nb = len(masks)
    if nb > _MASK_BUCKETS:
        raise ValueError(f"K8 takes at most {_MASK_BUCKETS} buckets, got {nb}")
    rows, first, word = [], 0, 0
    base, adjacent = None, True
    for k, (m_k, nbr_k) in enumerate(zip(masks, nbrs)):
        nk, dk = nbr_k.shape
        ptrs = (0, 0)
        if wgs is not None:
            if wgs[k].shape != nbr_k.shape:
                raise ValueError(f"wgs[{k}] and nbrs[{k}] differ in shape")
            ptrs = (nbr_k.data_ptr(), wgs[k].data_ptr())
        rows.append((first, nk, dk, starts[k] if starts else 0, word, *ptrs,
                     0))
        if m_k.shape[0]:
            if base is None:
                base = m_k  # the first bucket with entries starts at 0
            elif m_k.data_ptr() != base.data_ptr() + 12 * first:
                adjacent = False
        first += m_k.shape[0]
        word += nk * dk * words
    entries = base if adjacent else torch.cat(list(masks))
    return entries, np.array(rows, dtype=np.int64).reshape(nb, 8), first


def _sell_mask_bits(
    masks: Sequence[torch.Tensor],  # int32 [Mk, 3] per bucket
    nbrs: Sequence[torch.Tensor],  # int32 [nk, dk] per bucket
    s: int,  # batch columns
) -> Tuple[torch.Tensor, ...]:
    """K8 build: per bucket the int32 [nk, dk, W] bit mask (W = ceil(s /
    32)) of masks[k]'s (row-in-bucket, slot, column) entries; bit c of word
    [r, j, c // 32] set means slot (r, j) weighs INF for column c. An entry
    with any index out of range is dropped, as the reference's mode="drop"
    scatter drops it (the host never sends a negative index). The kernels
    read the words as uint32; bit 31 is the int32 sign bit. On the card
    the masks are views of one zeroed buffer, filled by one launch over
    every bucket's entries, with no host sync."""
    dev = masks[0].device if masks else torch.device("cpu")
    _check_masks(masks, nbrs, dev)
    if dev.type != "cuda":
        return tuple(
            _sell_mask_bits_plain(m_k, *nbr_k.shape, s)
            for m_k, nbr_k in zip(masks, nbrs)
        )
    words = _mask_words(s)
    entries, table, m_total = _mask_launch_args(masks, nbrs, None, None, words)
    size = int(table[-1, 4]) + int(table[-1, 1] * table[-1, 2]) * words
    if m_total and s:
        flat = torch.empty(size, dtype=torch.int32, device=dev)  # zeroed there
        SELL_MASK.launch(
            dev,
            entries.data_ptr(), flat.data_ptr(), table.ctypes.data,
            len(masks), m_total, s, words, entry="sell_mask_build",
        )
    else:
        flat = torch.zeros(size, dtype=torch.int32, device=dev)
    return tuple(
        flat.as_strided((nk, dk, words), (dk * words, words, 1), word0)
        for _, nk, dk, _, word0, *_ in table.tolist()
    )


def _sell_mask_bits_plain(m_k, nk, dk, s):
    words = _mask_words(s)
    r, j, c = (m_k[:, i].long() for i in range(3))
    keep = (r >= 0) & (r < nk) & (j >= 0) & (j < dk) & (c >= 0) & (c < s)
    dense = torch.zeros(
        (nk, dk, words * 32), dtype=torch.bool, device=m_k.device
    )
    dense[r[keep], j[keep], c[keep]] = True
    shifts = torch.arange(32, device=m_k.device)
    v = (dense.view(nk, dk, words, 32).long() << shifts).sum(dim=3)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _sell_mask_expand(bits_k: torch.Tensor, s: int) -> torch.Tensor:
    """bool [nk, dk, s]: the slots K8's bit mask pins to INF, per column."""
    nk, dk, words = bits_k.shape
    shifts = torch.arange(32, dtype=torch.int32, device=bits_k.device)
    bit = (bits_k[..., None] >> shifts) & 1
    return bit.bool().reshape(nk, dk, words * 32)[..., :s]


def _sell_masked_wgs_plain(wgs, bits, s):
    """The reference's per-row weights: wg [nk, dk, s], INF where masked."""
    return tuple(
        torch.where(_sell_mask_expand(b_k, s), INF, wg_k[:, :, None])
        for wg_k, b_k in zip(wgs, bits)
    )


def _sell_mask_seed(
    d_prev: torch.Tensor,  # int32 [S, n_pad] row-major base fixpoint
    nbrs: Sequence[torch.Tensor],
    wgs: Sequence[torch.Tensor],  # the base (unmasked) bucket weights
    masks: Sequence[torch.Tensor],  # int32 [Mk, 3] per bucket
    starts: Sequence[int],
) -> Tuple[torch.Tensor, bool]:
    """K8 seed: (marks bool [S, n_pad] row-major, seeded). An entry marks
    (column, head) where its slot lies on the column's base shortest-path
    DAG. Its rules are the reference's, and differ from the build's:
    validity is tested on the row only (row < 1 << 29), then row and slot
    are clipped into the bucket and the column into [0, S), not dropped.
    `seeded` is read from the kernel's flag (the one host sync), so no mark
    round runs when nothing was seeded. On the card one launch seeds every
    bucket."""
    dev = d_prev.device
    _check("d_prev", d_prev, torch.int32, 2, dev)
    _check_masks(masks, nbrs, dev)
    s, n = d_prev.shape
    if dev.type != "cuda":
        marks = _sell_mask_seed_plain(d_prev, nbrs, wgs, masks, starts)
        return marks, bool(marks.any())
    for k, wg_k in enumerate(wgs):
        _check(f"wgs[{k}]", wg_k, torch.int32, 2, dev)
    entries, table, m_total = _mask_launch_args(
        masks, nbrs, wgs, starts, 0
    )
    if not (m_total and s):
        return torch.zeros((s, n), dtype=torch.bool, device=dev), False
    # the marks and the int32 flag in one buffer, zeroed by the entry point
    # (the flag 4-aligned; the kernel sets it to 1, so its first byte reads
    # as the bool)
    at = (s * n + 3) // 4 * 4
    buf = torch.empty(at + 4, dtype=torch.bool, device=dev)
    SELL_MASK.launch(
        dev,
        d_prev.data_ptr(), buf.data_ptr(), entries.data_ptr(),
        table.ctypes.data, len(masks), m_total, s, n, entry="sell_mask_seed",
    )
    return buf.as_strided((s, n), (n, 1)), bool(buf[at])


def _sell_mask_seed_plain(d_prev, nbrs, wgs, masks, starts):
    s, n = d_prev.shape
    hits = torch.zeros((s, n), dtype=torch.int32, device=d_prev.device)
    for bs, nbr_k, wg_k, m_k in zip(starts, nbrs, wgs, masks):
        nk, dk = nbr_k.shape
        valid = m_k[:, 0] < (1 << 29)
        r = m_k[:, 0].clamp(0, nk - 1).long()
        j = m_k[:, 1].clamp(0, dk - 1).long()
        c = m_k[:, 2].clamp(0, s - 1).long()
        u = nbr_k[r, j].long()
        v = bs + r
        dv = d_prev[c, v]
        cond = (
            valid
            & (dv < INF)
            & ((d_prev[c, u] + wg_k[r, j]).clamp_max(INF) == dv)
        )
        hits.index_put_((c, v), cond.int(), accumulate=True)
    return hits > 0


def _sell_solver_vw(
    key: Tuple, sources, nbrs, wgs, masks, overloaded
) -> torch.Tensor:
    """Per-row-weights sliced-ELL fixpoint, the device form of KSP's
    link-ignore re-solves (LinkState.cpp:760-789): K8 builds each bucket's
    bit mask from masks[k] ([Mk, 3] (row-in-bucket, slot, batch column)
    positions to pin to INF), K9 relaxes from the cold state. The expanded
    [nk, dk, S] weights are never built. Returns D [S, n_pad] row-major."""
    zero_end, starts, _ = key
    bits = _sell_mask_bits(masks, nbrs, sources.shape[0])
    d0 = _sell_d0(sources, overloaded.shape[0])
    d, _ = _sell_relax(
        d0, sources, overloaded, nbrs, wgs, zero_end, starts, bits, cold=True
    )
    return d.t().contiguous()


def _sell_solver_vw_warm(
    key: Tuple, sources, nbrs, wgs, masks, overloaded, d_prev
) -> torch.Tensor:
    """Warm per-row-weights sliced-ELL solve: the KSP layer-seeding form.

    The masked slots are the increased edges (base weight -> INF), so the
    penalized solve starts from the unpenalized base fixpoint d_prev
    (int32 [S, n_pad] row-major and contiguous, for the same sources and
    the base weights `wgs`): K8 seeds marks where a masked slot lies on a
    column's base DAG, K5 propagates them down the base DAG (its rounds
    read `wgs`) and resets the marked entries to INF with the sources
    re-pinned, and K9 relaxes with the masked weights. Returns D [S, n_pad]
    row-major. d_prev is read, never written, and `wgs` are never patched:
    the masks live only in K8's bit masks."""
    zero_end, starts, _ = key
    s = sources.shape[0]
    if tuple(d_prev.shape) != (s, overloaded.shape[0]):
        raise ValueError(f"d_prev must be [{s}, n_pad]")
    bits = _sell_mask_bits(masks, nbrs, s)
    marks, seeded = _sell_mask_seed(d_prev, nbrs, wgs, masks, starts)
    marks, _ = _sell_mark_fixpoint(
        d_prev, marks, nbrs, wgs, zero_end, starts, seeded
    )
    d0 = _sell_warm_d0(d_prev, marks, sources)
    del marks
    d, _ = _sell_relax(
        d0, sources, overloaded, nbrs, wgs, zero_end, starts, bits
    )
    return d.t().contiguous()


# -- K6: invalidation on the edge-list layout ------------------------------


def _bf_invalidate(
    d_prev: torch.Tensor,  # int32 [S, n_pad] row-major OLD fixpoint
    src_e: torch.Tensor,  # int32 [E]
    dst_e: torch.Tensor,  # int32 [E], sorted ascending
    w_new: torch.Tensor,  # int32 [E] (shared) or [S, E] (per row)
    w_old: torch.Tensor,  # int32 [E]
    csr: torch.Tensor,  # int32 [n_pad + 1] in-edge ranges (edge_csr)
    dp_t: Optional[torch.Tensor] = None,  # int32 [n_pad, S] d_prev's copy
    w_t: Optional[torch.Tensor] = None,  # per-row w_new as _bf_weights_t
) -> Tuple[torch.Tensor, int]:
    """Edge-list invalidation: seeds where an edge on the old shortest-path
    DAG got heavier (w_new > w_old, classified here, not by the host), then
    the Jacobi mark fixpoint over the old DAG. Returns (marks, rounds), the
    marks as K5's bits int32 [n_pad, ceil(S / 32)] on either device
    (`marks_bool` reads them as bool [S, n_pad]). Per-row w_new [S, E] seeds
    each row against its own weights (KSP's link-ignore rows against the
    shared base). Only the edges csr covers are walked; the padding edges
    carry INF in both weight vectors and can neither seed nor propagate.

    On the card K6 reads the old fixpoint dest-major: `dp_t` is the copy a
    warm solve makes once an event (made here when not given), `w_t` the
    per-row weights it shares with K2. The seed is round 0; when it marks
    nothing no round runs."""
    dev = d_prev.device
    _check("d_prev", d_prev, torch.int32, 2, dev)
    s, n = d_prev.shape
    for name, t in (("src_e", src_e), ("dst_e", dst_e), ("w_old", w_old)):
        _check(name, t, torch.int32, 1, dev)
        if t.shape[0] != src_e.shape[0]:
            raise ValueError(f"{name}: length differs from src_e")
    _check("w_new", w_new, torch.int32, w_new.dim(), dev)
    e = src_e.shape[0]
    if tuple(w_new.shape) not in ((e,), (s, e)):
        raise ValueError(f"w_new must be [{e}] or [{s}, {e}]")
    _check("csr", csr, torch.int32, 1, dev)
    if csr.shape[0] != n + 1:
        raise ValueError("csr must have n_pad + 1 entries")
    if dev.type != "cuda":
        marks, rounds = _bf_invalidate_plain(d_prev, src_e, dst_e, w_new,
                                             w_old, csr)
        return marks_bits(marks), rounds
    if dp_t is None:
        dp_t = _dest_major(d_prev)
    _check("dp_t", dp_t, torch.int32, 2, dev)
    if tuple(dp_t.shape) != (n, s):
        raise ValueError("dp_t is not d_prev's dest-major copy")
    buf = _mark_buffer(s, n, dev)
    marks = _mark_words(buf, s, n)
    if not (s and e):
        return marks, 0
    if w_new.dim() == 2 and w_t is None:
        w_t = _bf_weights_t(w_new)
    w = w_new if w_new.dim() == 1 else w_t
    words = _mask_words(s)
    BF_MARK.launch(
        dev,
        dp_t.data_ptr(), buf.data_ptr(), w.data_ptr(), w_old.data_ptr(),
        csr.data_ptr(), src_e.data_ptr(), dst_e.data_ptr(),
        int(w_new.dim() == 2), s, n, e, words, entry="bf_mark_seed",
    )
    state = buf[3 * n * words + 2 * n :]
    if int(state[0]):
        return marks, 0  # round 0 marked nothing
    lists = torch.zeros(_csr_list_words(n), dtype=torch.int32, device=dev)
    args = (dp_t.data_ptr(), buf.data_ptr(), lists.data_ptr(),
            csr.data_ptr(), src_e.data_ptr(), dst_e.data_ptr(),
            w_old.data_ptr(), s, n, e, words)

    def launch(t0, count):
        BF_MARK.launch(dev, *args, t0, count, entry="bf_mark_rounds",
                       kernels=K6_ROUND_KERNELS * count)

    return marks, _fixpoint_rounds(launch, state, n)


def _bf_invalidate_plain(d_prev, src_e, dst_e, w_new, w_old, csr):
    """The reference's [S, E] form over the edges csr covers, with the
    segment-max as index_add on int32: (bool [S, n_pad] marks, rounds)."""
    s, n = d_prev.shape
    m_e = int(csr[-1])
    src = src_e[:m_e].long()
    dst = dst_e[:m_e].long()
    w_o = w_old[:m_e]
    dv = d_prev[:, dst]
    on_old = ((d_prev[:, src] + w_o[None, :]).clamp_max(INF) == dv) & (
        dv < INF
    )

    def seg_any(rows):  # bool [S, E] -> bool [S, n] (OR per destination)
        out = torch.zeros((s, n), dtype=torch.int32, device=d_prev.device)
        return out.index_add_(1, dst, rows.int()) > 0

    marks = seg_any(on_old & (w_new[..., :m_e] > w_o))
    if not bool(marks.any()):
        return marks, 0
    rounds = 0
    while True:
        new_m = marks | seg_any(marks[:, src] & on_old)
        rounds += 1
        changed = not torch.equal(new_m, marks)
        marks = new_m
        if not changed or rounds >= n:
            return marks, rounds


def _bf_warm_d0(
    d_prev: torch.Tensor,
    marks: torch.Tensor,
    sources: torch.Tensor,
    dp_t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The repaired initial state in K2's layout: dest-major [n_pad, S] of
    where(marks, INF, d_prev) with every source's own entry pinned to 0.
    `marks`: K5's bits, as `_bf_invalidate` gives them. On the card K6's
    reset works in place on d_prev's dest-major copy `dp_t` (made here
    when not given), which it consumes: it reads the marks' bits and writes
    the marked entries alone."""
    dev = d_prev.device
    _check("d_prev", d_prev, torch.int32, 2, dev)
    s, n = d_prev.shape
    _check("marks", marks, torch.int32, 2, dev)
    _check("sources", sources, torch.int32, 1, dev)
    if sources.shape[0] != s:
        raise ValueError("sources do not match d_prev's shape")
    if tuple(marks.shape) != (n, _mask_words(s)):
        raise ValueError(
            f"marks must be K5's bits [{n}, {_mask_words(s)}], got "
            f"{tuple(marks.shape)}"
        )
    if dev.type != "cuda":
        return _bf_warm_d0_plain(
            d_prev, marks_bool(marks, s), sources
        ).t().contiguous()
    if dp_t is None:
        dp_t = _dest_major(d_prev)
    _check("dp_t", dp_t, torch.int32, 2, dev)
    if tuple(dp_t.shape) != (n, s):
        raise ValueError("dp_t is not d_prev's dest-major copy")
    if s * n:
        BF_MARK.launch(
            dev, marks.data_ptr(), sources.data_ptr(), dp_t.data_ptr(), s, n,
            _mask_words(s), entry="bf_mark_reset",
        )
    return dp_t


def _bf_warm_d0_plain(d_prev, marks, sources):
    """Row-major where(marks, INF, d_prev), sources pinned to 0, from bool
    [S, n_pad] marks: the reference's reset."""
    d0 = torch.where(marks, INF, d_prev)
    s = d_prev.shape[0]
    d0[torch.arange(s, device=d0.device), sources.long()] = 0
    return d0


def _bf_warm(sources, src_e, dst_e, w_new, w_old, overloaded, d_prev,
                csr, w_rows):
    """The edge-list warm solve's device work (K6 seed + rounds, K6 reset,
    K2 from the repaired state with weights `w_rows`), with d_prev
    transposed in once, to K2's layout, and D out once. Returns (d [S,
    n_pad], rounds, inv_rounds)."""
    on_card = d_prev.device.type == "cuda"
    dp_t = _dest_major(d_prev) if on_card else None
    w_t = (_bf_weights_t(w_rows)
           if on_card and w_rows.shape[0] > 1 else None)
    marks, inv_rounds = _bf_invalidate(
        d_prev, src_e, dst_e, w_new, w_old, csr, dp_t=dp_t, w_t=w_t
    )
    d0 = _bf_warm_d0(d_prev, marks, sources, dp_t=dp_t)
    del marks, dp_t
    d, rounds = _bf_relax_dm(
        d0, sources, overloaded, src_e, dst_e, w_rows, csr, w_t=w_t
    )
    return d.t().contiguous(), rounds, inv_rounds


def _bf_solver_warm(
    sources: torch.Tensor,  # int32 [S]
    src_e: torch.Tensor,  # int32 [E]
    dst_e: torch.Tensor,  # int32 [E] (sorted ascending)
    w_new: torch.Tensor,  # int32 [E] weights after the event
    w_old: torch.Tensor,  # int32 [E] weights that produced d_prev
    overloaded: torch.Tensor,  # bool [n_pad]
    d_prev: torch.Tensor,  # int32 [S, n_pad] previous fixpoint (read only)
    csr: torch.Tensor,  # int32 [n_pad + 1] in-edge ranges (edge_csr)
):
    """Warm-start event solve on the edge-list layout (the reference's
    `_bf_warm_core`): invalidate (K6 seed + rounds), reset (K6), relax with
    the new weights (K2) and mark the moved columns (K7). Returns (d,
    rounds, inv_rounds, col_changed, num_changed), the sliced path's delta
    outputs, so `_delta_extract` serves both."""
    d, rounds, inv_rounds = _bf_warm(
        sources, src_e, dst_e, w_new, w_old, overloaded, d_prev, csr,
        w_new[None, :],
    )
    col_changed, num_changed = delta_columns(d, d_prev)
    return d, rounds, inv_rounds, col_changed, num_changed


def _bf_warm_vw_core(
    sources: torch.Tensor,  # int32 [S]
    src_e: torch.Tensor,  # int32 [E]
    dst_e: torch.Tensor,  # int32 [E] (sorted ascending)
    w_rows: torch.Tensor,  # int32 [S, E] per-row weights
    w_base: torch.Tensor,  # int32 [E] shared weights that produced d_prev
    overloaded: torch.Tensor,  # bool [n_pad]
    d_prev: torch.Tensor,  # int32 [S, n_pad] base fixpoint (read only)
    csr: torch.Tensor,  # int32 [n_pad + 1] in-edge ranges (edge_csr)
) -> Tuple[torch.Tensor, int, int]:
    """Per-row-weights warm solve on the edge-list layout: the KSP
    layer-seeding form of `_bf_solver_warm`. A link-ignore row only raises
    weights (ignored links -> INF), so each row warm-starts from the shared
    base fixpoint: K6 seeds where a row's raised edge lies on the base DAG
    (per-row seed against w_base), K6 rounds propagate down the base DAG,
    K6 resets, and K2 relaxes with the per-row weights, which the card
    transposes once for both. Returns (d [S, n_pad], rounds,
    inv_rounds)."""
    return _bf_warm(sources, src_e, dst_e, w_rows, w_base, overloaded,
                       d_prev, csr, w_rows)


# -- K7: delta extraction --------------------------------------------------


def delta_columns(
    d: torch.Tensor, d_prev: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(col_changed bool [n], num_changed int32 scalar tensor): the
    destination columns of row-major d [S, n] that differ from d_prev. The
    count stays on the device until the caller reads it (4 bytes)."""
    dev = d.device
    _check("d", d, torch.int32, 2, dev)
    _check("d_prev", d_prev, torch.int32, 2, dev)
    if d.shape != d_prev.shape:
        raise ValueError("d and d_prev differ in shape")
    s, n = d.shape
    if dev.type != "cuda":
        col_changed = (d != d_prev).any(dim=0)
        return col_changed, col_changed.sum(dtype=torch.int32)
    col_changed = torch.empty(n, dtype=torch.bool, device=dev)
    if not n:
        return col_changed, torch.zeros((), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)  # zeroed there
    DELTA_EXTRACT.launch(
        dev,
        d.data_ptr(), d_prev.data_ptr(), col_changed.data_ptr(),
        count.data_ptr(), s, n, entry="delta_columns",
    )
    return col_changed, count


_COMPACT_TILE = 4096  # delta_extract.cu kTile: flags per look-back tile


def _delta_extract(
    col_changed: torch.Tensor,  # bool [n] changed-destination mask
    d: torch.Tensor,  # int32 [S, n] distance matrix
    nh_rows: torch.Tensor,  # int32 [L] batch row of each up-link neighbour
    nh_ws: torch.Tensor,  # int32 [L] metric of each up-link from me
    *,
    cap: int,  # compacted column capacity (power-of-two bucket)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact the changed destinations and gather what the route build
    needs of them: (cols int32 [cap], ascending, padded with n, as
    `jnp.nonzero(size=cap, fill_value=n)`; dcols int32 [S, cap] their
    distance columns; nh bool [L, cap], nh[l, c] = nh_ws[l] +
    dcols[nh_rows[l], c] == dcols[0, c], the reference's unclamped formula
    with no reachability term). The host applies the overloaded-neighbour
    rule, as the reference does.

    nh_rows must lie in [0, S). On the CPU that is checked here; on the card
    the caller checks its host copy (`check_nh_rows`): reading the device
    copy would make the host wait for the card, and the extraction queues
    its two launches with no host sync. The kernel clamps a bad row into
    [0, S)."""
    dev = d.device
    _check("col_changed", col_changed, torch.bool, 1, dev)
    _check("d", d, torch.int32, 2, dev)
    _check("nh_rows", nh_rows, torch.int32, 1, dev)
    _check("nh_ws", nh_ws, torch.int32, 1, dev)
    s, n = d.shape
    if col_changed.shape[0] != n or nh_ws.shape[0] != nh_rows.shape[0]:
        raise ValueError("col_changed/nh_ws do not match d/nh_rows")
    if cap < 0 or n == 0:
        raise ValueError(f"bad cap {cap} or empty d")
    if dev.type != "cuda":
        check_nh_rows(nh_rows.numpy(), s)
        return _delta_extract_plain(col_changed, d, nh_rows, nh_ws, cap)
    cols = _delta_compact(col_changed, cap)
    return (cols, *_delta_gather(cols, d, nh_rows, nh_ws))


def check_nh_rows(nh_rows: np.ndarray, s: int) -> None:
    """Raise ValueError unless every up-link row lies in [0, s): the rows
    `_delta_extract` takes, checked on the host."""
    if len(nh_rows) and (nh_rows.min() < 0 or nh_rows.max() >= s):
        raise ValueError(f"nh_rows outside [0, {s})")


def _delta_compact(col_changed: torch.Tensor, cap: int) -> torch.Tensor:
    """K7's compaction on the card: cols int32 [cap], the set columns of
    col_changed ascending, padded with n: `torch.nonzero_static(col_changed,
    size=cap, fill_value=n)` flattened. One launch; the entry point zeroes
    the look-back status words and the ticket for each call."""
    dev = col_changed.device
    n = col_changed.shape[0]
    cols = torch.empty(cap, dtype=torch.int32, device=dev)
    if cap and n:
        tiles = -(-n // _COMPACT_TILE)
        status = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
        DELTA_EXTRACT.launch(
            dev,
            col_changed.data_ptr(), cols.data_ptr(), status.data_ptr(), n,
            cap, tiles, entry="delta_compact",
        )
    return cols


def _delta_gather(
    cols: torch.Tensor, d: torch.Tensor, nh_rows: torch.Tensor,
    nh_ws: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's gather on the card: (dcols int32 [S, cap], nh bool [L, cap]) of
    the columns `_delta_compact` gave. One launch."""
    dev = d.device
    s, n = d.shape
    cap, l_pad = cols.shape[0], nh_rows.shape[0]
    dcols = torch.empty((s, cap), dtype=torch.int32, device=dev)
    nh = torch.empty((l_pad, cap), dtype=torch.bool, device=dev)
    if cap and s:
        DELTA_EXTRACT.launch(
            dev,
            d.data_ptr(), cols.data_ptr(), nh_rows.data_ptr(),
            nh_ws.data_ptr(), dcols.data_ptr(), nh.data_ptr(), s, n, cap,
            l_pad, entry="delta_gather",
        )
    return dcols, nh


def _delta_extract_plain(col_changed, d, nh_rows, nh_ws, cap):
    n = d.shape[1]
    hits = torch.nonzero(col_changed).flatten()[:cap].to(torch.int32)
    cols = torch.full((cap,), n, dtype=torch.int32, device=d.device)
    cols[: hits.shape[0]] = hits
    dcols = d[:, cols.clamp(0, n - 1).long()]
    nh = (nh_ws[:, None] + dcols[nh_rows.long()]) == dcols[0][None, :]
    return cols, dcols, nh


def _delta_extract_sharded(
    col_changed: Sequence[torch.Tensor],  # bool per column block
    d: Sharded,
    nh_rows: torch.Tensor,  # int32 [L] on `device`
    nh_ws: torch.Tensor,  # int32 [L] on `device`
    *,
    cap: int,
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`_delta_extract` over a `Sharded` matrix, without assembling it:
    each block compacts and gathers its own changed columns (K7, no
    nexthop rows), only those columns move to `device`, and K7 runs once
    more there over the [S, changed] matrix they form, for the nexthop
    test. col_changed[j] is column block j's mask (ORed over the batch
    ranks). Returns what `_delta_extract` returns on the whole matrix:
    cols [cap] ascending, padded with n; dcols [S, cap]; nh [L, cap]."""
    none = torch.empty(0, dtype=torch.int32, device=device)
    n = d.shape[1]
    parts, gcols, offset = [], [], 0
    for j, cc in enumerate(col_changed):
        width = d.blocks[0][j].shape[1]
        num = int(cc.sum())
        if num:
            blocks = []
            for row in d.blocks:
                t = row[j]
                cols, dcols, _ = _delta_extract(
                    cc.to(t.device), t, none.to(t.device),
                    none.to(t.device), cap=num,
                )
                blocks.append(dcols.to(device))
            parts.append(torch.cat(blocks, dim=0))
            gcols.append(cols.to(device) + offset)
        offset += width
    if not parts:
        raise ValueError("no changed column to extract")
    x = torch.cat(parts, dim=1).contiguous()
    gcols = torch.cat(gcols)
    num = x.shape[1]
    pos, dcols, nh = _delta_extract(
        torch.ones(num, dtype=torch.bool, device=device), x, nh_rows,
        nh_ws, cap=cap,
    )
    cols = torch.where(
        pos < num, gcols[pos.clamp_max(num - 1).long()], n
    ).to(torch.int32)
    return cols, dcols, nh


# -- K19-K21: the destination-tiled layout ----------------------------------

TILE_PAD = 1 << 30  # hcols sentinel of an unused frontier slot


class HaloCopies(NamedTuple):
    """The ring traffic of one tiled solve, counted where the copies are
    made: hops around the graph ring, and the frontier bytes (ctr and
    cols) every rank copied into the next one's buffers over them."""

    hops: int
    bytes: int


def _tile_ids(offset: int, n_tile: int, device) -> torch.Tensor:
    return offset + torch.arange(n_tile, dtype=torch.int32, device=device)


def _tile_seg_min(vals: torch.Tensor, hseg: torch.Tensor, h: int):
    """Per-frontier-slot minima of per-edge values [S_l, e_tile] -> [S_l,
    h]; an empty slot gives the int32 maximum, clamped to INF."""
    s_l = vals.shape[0]
    out = torch.full((s_l, h), _INT32_MAX, dtype=torch.int32,
                     device=vals.device)
    out.scatter_reduce_(
        1, hseg.long()[None, :].expand(s_l, -1), vals, reduce="amin"
    )
    return out.clamp_max(INF)


def _tile_round_plain(d, sources, overloaded, offset, src_l, hseg, hptr, w2,
                      h, *, w_new=None, ov_new=None, marks=None, out=None):
    """Plain version of K19, `tile_round`'s signature, over every edge slot
    of the partition with hseg (the padding edges weigh INF and land in the
    padding slot h - 1); hptr is not read."""
    n_tile = d.shape[1]
    ids = _tile_ids(offset, n_tile, d.device)
    allow = (~overloaded[offset : offset + n_tile])[None, :] | (
        ids[None, :] == sources[:, None]
    )
    src = src_l.long()
    vals = (torch.where(allow, d, INF)[:, src] + w2[None, :]).clamp_max(INF)
    if w_new is not None:
        newly_on = ov_new & ~overloaded
        seed = (w_new > w2) | newly_on[offset + src]
        vals = torch.where(seed[None, :], vals, INF)
    if marks is not None:
        vals = torch.where(marks[:, src], vals, INF)
    ctr = _tile_seg_min(vals, hseg, h)
    return ctr if out is None else out.copy_(ctr)


def tile_round(
    d: torch.Tensor,  # int32 [S_l, n_tile] this rank's tile
    sources: torch.Tensor,  # int32 [S_l] this batch rank's sources
    overloaded: torch.Tensor,  # bool [n_pad]
    offset: int,  # first column of the tile (me * n_tile)
    src_l: torch.Tensor,  # int32 [e_tile] tile-local tails
    hseg: torch.Tensor,  # int32 [e_tile] frontier slot of each edge
    hptr: torch.Tensor,  # int32 [h + 1] each slot's range of real edges
    w2: torch.Tensor,  # int32 [e_tile] weights (INF on padding)
    h: int,
    *,
    w_new: Optional[torch.Tensor] = None,  # int32 [e_tile]: seed mask
    ov_new: Optional[torch.Tensor] = None,  # bool [n_pad]: seed mask
    marks: Optional[torch.Tensor] = None,  # bool [S_l, n_tile]: mark mask
    out: Optional[torch.Tensor] = None,  # int32 [S_l, h] to write into
) -> torch.Tensor:
    """K19, one tiled round up to the frontier (the reference's
    `_tile_relax` body before the halo, and `_tile_solver_warm`'s seed and
    mark exchanges): ctr [S_l, h], ctr[s, k] = min over the partition's
    edges e in slot k of min(dt[s, src_l[e]] + w2[e], INF), INF for an
    empty slot, where dt masks transit through an overloaded node that is
    not the row's source. With w_new and ov_new only the seed edges count
    (w_new[e] > w2[e], or a tail that is overloaded in ov_new and not in
    `overloaded`); with marks only the edges whose tail is marked in the
    row. The plain version walks hseg, the kernel hptr's real edges. On
    the card, two launches: a node-major copy of the masked tile, then the
    slots."""
    dev = d.device
    _check("d", d, torch.int32, 2, dev)
    s_l, n_tile = d.shape
    _check("sources", sources, torch.int32, 1, dev)
    _check("overloaded", overloaded, torch.bool, 1, dev)
    for name, t in (("src_l", src_l), ("hseg", hseg), ("w2", w2)):
        _check(name, t, torch.int32, 1, dev)
        if t.shape[0] != src_l.shape[0]:
            raise ValueError(f"{name}: length differs from src_l")
    _check("hptr", hptr, torch.int32, 1, dev)
    if hptr.shape[0] != h + 1 or sources.shape[0] != s_l:
        raise ValueError("hptr/sources do not match h/the tile")
    if offset < 0 or offset + n_tile > overloaded.shape[0]:
        raise ValueError(f"tile [{offset}, +{n_tile}) outside overloaded")
    if (w_new is None) != (ov_new is None):
        raise ValueError("w_new and ov_new come together")
    if w_new is not None:
        _check("w_new", w_new, torch.int32, 1, dev)
        _check("ov_new", ov_new, torch.bool, 1, dev)
        if w_new.shape != w2.shape or ov_new.shape != overloaded.shape:
            raise ValueError("w_new/ov_new do not match w2/overloaded")
    if marks is not None:
        _check("marks", marks, torch.bool, 2, dev)
        if marks.shape != d.shape:
            raise ValueError("marks do not match the tile")
    if out is not None:
        _check("out", out, torch.int32, 2, dev)
        if tuple(out.shape) != (s_l, h):
            raise ValueError(f"out must be [{s_l}, {h}]")
    if dev.type != "cuda":
        return _tile_round_plain(d, sources, overloaded, offset, src_l, hseg,
                                 hptr, w2, h, w_new=w_new, ov_new=ov_new,
                                 marks=marks, out=out)
    if out is None:
        out = torch.empty((s_l, h), dtype=torch.int32, device=dev)
    if s_l * h:
        # the kernel's node-major copy of the masked tile, rows padded to 32
        nodes = torch.empty((n_tile, -(-s_l // 32) * 32), dtype=torch.int32,
                            device=dev)
        TILE_ROUND.launch(
            dev,
            d.data_ptr(), out.data_ptr(), sources.data_ptr(),
            overloaded.data_ptr(), src_l.data_ptr(), hptr.data_ptr(),
            w2.data_ptr(),
            None if w_new is None else w_new.data_ptr(),
            None if ov_new is None else ov_new.data_ptr(),
            None if marks is None else marks.data_ptr(),
            nodes.data_ptr(), offset, s_l, n_tile, h, kernels=2,
        )
    return out


def _tile_fold_plain(out, ctr, cols, me, flag=None):
    n_tile = out.shape[1]
    local = cols.long() - me * n_tile
    keep = (local >= 0) & (local < n_tile)
    idx = local[keep]
    new = torch.minimum(out[:, idx], ctr[:, keep])
    if flag is not None and bool((new != out[:, idx]).any()):
        flag.fill_(1)
    out[:, idx] = new
    return out


def tile_fold(
    out: torch.Tensor,  # int32 [S_l, n_tile], folded into in place
    ctr: torch.Tensor,  # int32 [S_l, h] a frontier
    cols: torch.Tensor,  # int32 [h] its columns (1 << 30: unused)
    me: int,  # this rank's graph index
    flag: Optional[torch.Tensor] = None,  # int32 [1], set where out drops
) -> torch.Tensor:
    """K20, the reference's `_tile_fold_min` in place: out[s, cols[k] - me *
    n_tile] = min(that, ctr[s, k]) for the slots whose column this rank
    owns; the others, the sentinel among them, are dropped before ctr is
    read. A partition's slots name distinct columns, so one fold has no
    write conflict. Sets flag[0] = 1 when an entry went down, the
    reference's any(new_d != d). Returns out.

    Precondition: cols ascends, the sentinels last, as every partition's
    columns do (`tile_graph`; `convert.tiling_ranks` checks it), so the
    slots this rank owns form one stretch and the kernel walks only that;
    the plain version takes any order. The kernel drops an owned slot that
    lies outside the stretch of an order that does not ascend."""
    dev = out.device
    _check("out", out, torch.int32, 2, dev)
    _check("ctr", ctr, torch.int32, 2, dev)
    _check("cols", cols, torch.int32, 1, dev)
    s_l, n_tile = out.shape
    h = cols.shape[0]
    if tuple(ctr.shape) != (s_l, h):
        raise ValueError(f"ctr must be [{s_l}, {h}]")
    if flag is not None:
        _check("flag", flag, torch.int32, 1, dev)
    if dev.type != "cuda":
        return _tile_fold_plain(out, ctr, cols, me, flag)
    if s_l * h:
        TILE_FOLD.launch(
            dev,
            out.data_ptr(), ctr.data_ptr(), cols.data_ptr(),
            None if flag is None else flag.data_ptr(),
            me * n_tile, s_l, n_tile, h,
        )
    return out


def tile_init(sources: torch.Tensor, offset: int, n_tile: int):
    """K21 tile_init: the cold tile [S_l, n_tile] of the reference's
    `_tile_d0_allow`, INF with each source's own column pinned to 0 where
    the tile holds it (the transit mask is K19's, computed in the
    kernel)."""
    dev = sources.device
    _check("sources", sources, torch.int32, 1, dev)
    s_l = sources.shape[0]
    if dev.type != "cuda":
        return _tile_init_plain(sources, offset, n_tile)
    d0 = torch.empty((s_l, n_tile), dtype=torch.int32, device=dev)
    if s_l * n_tile:
        TILE_MARK.launch(dev, d0.data_ptr(), sources.data_ptr(), offset, s_l,
                         n_tile, entry="tile_init")
    return d0


def tile_reset(marks: torch.Tensor, dp: torch.Tensor, sources: torch.Tensor,
               offset: int) -> torch.Tensor:
    """K21 tile_reset: where(marks, INF, dp) with the sources re-pinned to
    0 where the tile holds their column (a source outside it is dropped)."""
    dev = dp.device
    _check("dp", dp, torch.int32, 2, dev)
    _check("marks", marks, torch.bool, 2, dev)
    _check("sources", sources, torch.int32, 1, dev)
    s_l, n_tile = dp.shape
    if marks.shape != dp.shape or sources.shape[0] != s_l:
        raise ValueError("marks/sources do not match dp")
    if dev.type != "cuda":
        return _tile_reset_plain(marks, dp, sources, offset)
    d0 = torch.empty_like(dp)
    if s_l * n_tile:
        TILE_MARK.launch(dev, d0.data_ptr(), marks.data_ptr(), dp.data_ptr(),
                         sources.data_ptr(), offset, s_l, n_tile,
                         entry="tile_reset")
    return d0


def tile_mark(m: Optional[torch.Tensor], recv: torch.Tensor,
              dp: torch.Tensor, flag: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K21 tile_mark: new_m = m | ((recv == dp) & (dp < INF)) (m None: no
    marks yet, the seed), with flag[0] = 1 where an entry was newly
    marked, the reference's any(new_m != m). recv is reset to INF for the
    next exchange. Returns new_m (into `out` when given)."""
    dev = dp.device
    _check("dp", dp, torch.int32, 2, dev)
    _check("recv", recv, torch.int32, 2, dev)
    _check("flag", flag, torch.int32, 1, dev)
    if m is not None:
        _check("m", m, torch.bool, 2, dev)
    for t in (recv, m, out):
        if t is not None and t.shape != dp.shape:
            raise ValueError("m/recv/out do not match dp")
    if out is None:
        out = torch.empty(dp.shape, dtype=torch.bool, device=dev)
    _check("out", out, torch.bool, 2, dev)
    if dev.type != "cuda":
        return _tile_mark_plain(m, recv, dp, flag, out)
    if dp.numel():
        TILE_MARK.launch(dev, None if m is None else m.data_ptr(),
                         recv.data_ptr(), dp.data_ptr(), out.data_ptr(),
                         flag.data_ptr(), dp.numel(), entry="tile_mark")
    return out


def tile_col_changed(d: torch.Tensor, dp: torch.Tensor,
                     col_changed: torch.Tensor, count: torch.Tensor) -> None:
    """K21 tile_col_changed: col_changed[t] |= any(d[:, t] != dp[:, t]),
    and count[0] += 1 for each column this call newly sets: run rank after
    rank over the batch ranks of a column block, it gives their OR (the
    reference's pmax over 'batch') and its popcount."""
    dev = d.device
    _check("d", d, torch.int32, 2, dev)
    _check("dp", dp, torch.int32, 2, dev)
    _check("col_changed", col_changed, torch.bool, 1, dev)
    _check("count", count, torch.int32, 1, dev)
    s_l, n_tile = d.shape
    if dp.shape != d.shape or col_changed.shape[0] != n_tile:
        raise ValueError("dp/col_changed do not match d")
    if dev.type != "cuda":
        _tile_col_changed_plain(d, dp, col_changed, count)
        return
    if n_tile:
        TILE_MARK.launch(dev, d.data_ptr(), dp.data_ptr(),
                         col_changed.data_ptr(), count.data_ptr(), s_l, n_tile,
                         entry="tile_col_changed")


def _tile_init_plain(sources, offset: int, n_tile: int) -> torch.Tensor:
    ids = _tile_ids(offset, n_tile, sources.device)
    return torch.full((sources.shape[0], n_tile), INF, dtype=torch.int32,
                      device=sources.device).masked_fill_(
        ids[None, :] == sources[:, None], 0)


def _tile_reset_plain(marks, dp, sources, offset: int) -> torch.Tensor:
    ids = _tile_ids(offset, dp.shape[1], dp.device)
    return torch.where(marks, INF, dp).masked_fill_(
        ids[None, :] == sources[:, None], 0)


def _tile_mark_plain(m, recv, dp, flag, out=None) -> torch.Tensor:
    hit = (recv == dp) & (dp < INF)
    new = hit if m is None else m | hit
    if bool((hit if m is None else hit & ~m).any()):
        flag.fill_(1)
    recv.fill_(INF)
    return new if out is None else out.copy_(new)


def _tile_col_changed_plain(d, dp, col_changed, count) -> None:
    hit = (d != dp).any(dim=0) & ~col_changed
    count += hit.sum(dtype=torch.int32)
    col_changed |= hit


class TileOps(NamedTuple):
    """The per-rank steps of the tiled solves: the kernels' wrappers
    (`TILE_KERNELS`), or the plain versions on any device (`TILE_PLAIN`,
    the comparison of a whole tiled solve on the card)."""

    round: Callable
    fold: Callable
    init: Callable
    mark: Callable
    reset: Callable
    col_changed: Callable


TILE_KERNELS = TileOps(tile_round, tile_fold, tile_init, tile_mark,
                       tile_reset, tile_col_changed)
TILE_PLAIN = TileOps(_tile_round_plain, _tile_fold_plain, _tile_init_plain,
                     _tile_mark_plain, _tile_reset_plain,
                     _tile_col_changed_plain)


class _Flags:
    """The change flag of a tiled round: one int32 per distinct device of
    the mesh, shared by the ranks there. `any()` reads each once, 4 bytes:
    the reference's psum over ('batch', 'graph'), once a round."""

    def __init__(self, mesh) -> None:
        self.by_dev = {
            dev: torch.zeros(1, dtype=torch.int32, device=dev)
            for dev in mesh_devices(mesh)
        }

    def zero(self) -> None:
        for f in self.by_dev.values():
            f.zero_()

    def any(self) -> bool:
        return any([bool(f.item()) for f in self.by_dev.values()])


class _Ring:
    """The frontier buffers of one tiled solve, allocated once: per rank
    two ctr [S_l, h] and two cols [h] buffers, written in turn (K19 writes
    ctr[0]; hop k copies parity k % 2 of rank j into parity (k + 1) % 2 of
    rank j + 1, so no hop overwrites what it reads). `copies` counts the
    hops it made and the bytes they moved."""

    def __init__(self, mesh, s_l: int, h: int) -> None:
        b, g = mesh.shape["batch"], mesh.shape["graph"]
        self.copies = HaloCopies(0, 0)
        self.ctr = [[[torch.empty((s_l, h), dtype=torch.int32,
                                  device=mesh.devices[i, j])
                      for _ in range(2)] for j in range(g)]
                    for i in range(b)]
        self.cols = [[[torch.empty(h, dtype=torch.int32,
                                   device=mesh.devices[i, j])
                       for _ in range(2)] for j in range(g)]
                     for i in range(b)]

    def halo(self, hcols, n_tile: int, dst, flags: Optional[_Flags],
             ops: TileOps = TILE_KERNELS) -> None:
        """The halo exchange of one round: each rank folds its own frontier
        (its K19 output in ctr[i][j][0], columns hcols[i][j]) into dst[i][j]
        (K20), then the frontiers rotate g - 1 hops around each batch row's
        graph ring and every rank folds each one that passes. A hop is a
        copy into the next rank's buffer: across cards a peer copy, on one
        card a device copy of the same bytes."""
        b, g = len(dst), len(dst[0])

        def fold(p):
            for i in range(b):
                for j in range(g):
                    cols = hcols[i][j] if p == 0 else self.cols[i][j][p % 2]
                    ops.fold(dst[i][j], self.ctr[i][j][p % 2], cols, j,
                             None if flags is None
                             else flags.by_dev[dst[i][j].device])

        fold(0)
        for hop in range(g - 1):
            p, q = hop % 2, (hop + 1) % 2
            moved = 0
            for i in range(b):
                for j in range(g):
                    k = (j + 1) % g
                    src_cols = hcols[i][j] if hop == 0 else self.cols[i][j][p]
                    self.ctr[i][k][q].copy_(self.ctr[i][j][p])
                    self.cols[i][k][q].copy_(src_cols)
                    moved += 4 * (self.ctr[i][k][q].numel() + src_cols.numel())
            self.copies = HaloCopies(self.copies.hops + 1,
                                     self.copies.bytes + moved)
            fold(hop + 1)


def _tile_relax(mesh, d0, sources, overloaded, src_l, hseg, hptr, w2, hcols,
                n_pad: int, ops: TileOps = TILE_KERNELS):
    """The tiled relaxation from the per-rank initial tiles d0 [b][g] to the
    global fixpoint; returns (tiles [b][g], rounds, HaloCopies). Each round
    launches every rank's K19 on the old tiles before any fold lands, then
    folds the halo into the tiles in place and reads the change flag once.
    That is Jacobi across ranks: K19 has read each old tile into its
    frontier before a fold is queued, and a rank's folds touch only its own
    tile, on the stream of the device its K19 ran on. Capped at n_pad
    rounds. The operands are nested lists [b][g] of each rank's tensors on
    its device. The tiles of d0 are folded into and returned."""
    s_l, n_tile = d0[0][0].shape
    h = hcols[0][0].shape[0]
    b, g = len(d0), len(d0[0])
    ring = _Ring(mesh, s_l, h)
    flags = _Flags(mesh)
    rounds = 0
    while True:
        flags.zero()
        for i in range(b):
            for j in range(g):
                ops.round(d0[i][j], sources[i][j], overloaded[i][j],
                          j * n_tile, src_l[i][j], hseg[i][j], hptr[i][j],
                          w2[i][j], h, out=ring.ctr[i][j][0])
        ring.halo(hcols, n_tile, d0, flags, ops)
        rounds += 1
        if not flags.any() or rounds >= n_pad:
            return d0, rounds, ring.copies


def _tile_check_key(key: Tuple, mesh, src_l) -> Tuple[int, int, int, int]:
    g, n_tile, e_tile, h, n_pad = key
    if mesh.shape["graph"] != g or len(src_l[0]) != g:
        raise ValueError(f"mesh {dict(mesh.shape)} does not match g = {g}")
    if len(src_l) != mesh.shape["batch"]:
        raise ValueError("operands do not match the mesh's batch axis")
    return g, n_tile, h, n_pad


def _tile_solver(key: Tuple, mesh, sources, src_l, hseg, hptr, w2, hcols,
                 overloaded, ops: TileOps = TILE_KERNELS):
    """Cold destination-tiled solve for key = GraphTiling.shape_key() +
    (n_pad,): (D `Sharded` [b][g] tiles [S/batch, n_pad/graph], rounds,
    the `HaloCopies` its ring made).
    Every operand is a nested list [b][g] of rank (i, j)'s tensor on
    mesh.devices[i, j]: its batch slice of the sources, partition j's
    src_l, hseg, hptr, w2 and hcols, and the [n_pad] overload mask. The
    cold tile is K21's tile_init; the rounds are K19 and the halo's K20
    (`_tile_relax`). `ops` picks the kernels or the plain versions."""
    g, n_tile, h, n_pad = _tile_check_key(key, mesh, src_l)
    d0 = [[ops.init(sources[i][j], j * n_tile, n_tile) for j in range(g)]
          for i in range(len(src_l))]
    tiles, rounds, copies = _tile_relax(mesh, d0, sources, overloaded, src_l,
                                        hseg, hptr, w2, hcols, n_pad, ops)
    return Sharded(tiles), rounds, copies


def _tile_solver_warm(key: Tuple, mesh, sources, src_l, hseg, hptr, w2_new,
                      w2_old, hcols, ov_new, ov_old, d_prev: Sharded,
                      ops: TileOps = TILE_KERNELS):
    """Warm event on the tiled layout, the reference's `_tile_solver_warm`:
    (D `Sharded`, rounds, inv_rounds, col_changed, num_changed), and the
    `HaloCopies` of the seed, mark and relax rings together.

    Invalidation runs receiver-side on the frontier machinery: the seed
    exchange is K19 over the seed edges (w2_new > w2_old, or a tail newly
    overloaded) with the OLD weights and transit mask, folded (K20) into an
    INF tile, then K21 tile_mark against d_prev; a decrease-only event
    seeds nothing and skips the mark rounds whole. Each mark round is K19
    over the marked tails, the halo into the INF tile, and tile_mark, all
    ranks Jacobi. Then tile_reset, and `_tile_relax` with the NEW weights
    and mask. col_changed is a list over graph ranks of bool [n_tile], each
    the OR over the batch ranks that share the column block (K21
    tile_col_changed, rank after rank); num_changed an int32 scalar
    tensor, their popcounts summed, on the first mesh device. The
    operands are nested lists [b][g] as `_tile_solver` takes them; d_prev
    is read, never written. `ops` picks the kernels or the plain
    versions."""
    g, n_tile, h, n_pad = _tile_check_key(key, mesh, src_l)
    b = len(src_l)
    dp = d_prev.blocks
    s_l = dp[0][0].shape[0]
    ring = _Ring(mesh, s_l, h)
    flags = _Flags(mesh)
    recv = [[torch.full_like(t, INF) for t in row] for row in dp]
    ranks = [(i, j) for i in range(b) for j in range(g)]

    def exchange(marks):
        for i, j in ranks:
            seed = {} if marks is not None else {
                "w_new": w2_new[i][j], "ov_new": ov_new[i][j]}
            ops.round(dp[i][j], sources[i][j], ov_old[i][j], j * n_tile,
                      src_l[i][j], hseg[i][j], hptr[i][j], w2_old[i][j], h,
                      marks=None if marks is None else marks[i][j],
                      out=ring.ctr[i][j][0], **seed)
        ring.halo(hcols, n_tile, recv, None, ops)

    flags.zero()
    exchange(None)
    m = [[ops.mark(None, recv[i][j], dp[i][j], flags.by_dev[dp[i][j].device])
          for j in range(g)] for i in range(b)]
    m_nxt = [[torch.empty_like(t) for t in row] for row in m]
    changed = flags.any()  # any_seed
    inv_rounds = 0
    while changed and inv_rounds < n_pad:
        flags.zero()
        exchange(m)
        for i, j in ranks:
            ops.mark(m[i][j], recv[i][j], dp[i][j],
                     flags.by_dev[dp[i][j].device], out=m_nxt[i][j])
        m, m_nxt = m_nxt, m
        inv_rounds += 1
        changed = flags.any()
    mark_copies = ring.copies
    del m_nxt, recv, ring
    d0 = [[ops.reset(m[i][j], dp[i][j], sources[i][j], j * n_tile)
           for j in range(g)] for i in range(b)]
    del m
    tiles, rounds, copies = _tile_relax(mesh, d0, sources, ov_new, src_l,
                                        hseg, hptr, w2_new, hcols, n_pad, ops)
    col_changed, num_changed = [], None
    dev0 = mesh.devices[0, 0]
    for j in range(g):
        cc = torch.zeros(n_tile, dtype=torch.bool, device=mesh.devices[0, j])
        cnt = torch.zeros(1, dtype=torch.int32, device=cc.device)
        for i in range(b):
            dev = mesh.devices[i, j]
            cc, cnt = cc.to(dev), cnt.to(dev)
            ops.col_changed(tiles[i][j], dp[i][j], cc, cnt)
        col_changed.append(cc)
        num_changed = cnt.to(dev0) if num_changed is None else (
            num_changed + cnt.to(dev0))
    return (Sharded(tiles), rounds, inv_rounds, col_changed,
            num_changed.reshape(()),
            HaloCopies(mark_copies.hops + copies.hops,
                       mark_copies.bytes + copies.bytes))


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


def sell_fixpoint_masked(
    sell,  # ops.graph.SlicedEll
    sources,  # int32 [S]
    overloaded,  # bool [n_pad]
    mask_positions,  # per batch row: edge positions to pin to INF
    device_arrays=None,  # optional (nbrs, wgs, ov) already on `device`
    d_prev=None,  # optional int32 [S, n_pad] base fixpoint on `device`
    device: DeviceLike = "cuda",
    mesh=None,  # optional solver mesh: sources split over 'batch'
) -> torch.Tensor:
    """Per-row link-ignore solve on the sliced layout: D [S, n_pad].

    mask_positions[i] lists edge positions (dst-sorted, e.g. from
    CompiledGraph.link_edges) whose weight becomes INF for batch row i
    only; `sell_mask_packed` packs them per bucket, for one upload.
    device_arrays (an area solve's resident buffers) saves uploading the
    layout. With d_prev, the UNPENALIZED base fixpoint for the same sources
    and weights (row-major, contiguous), the penalized solve warm-starts by
    increase invalidation (`_sell_solver_vw_warm`) instead of relaxing from
    INF: sound because masking only raises weights.

    With a mesh, every batch rank solves its row slice of the sources and
    of mask_positions, cold (K8 build + K9), against device_arrays given as
    dicts device -> copy (or the layout uploaded to each device); D comes
    back `Sharded`. The warm form has no mesh variant, as in the
    reference."""
    if mesh is not None:
        if d_prev is not None:
            raise ValueError("the warm-seeded masked solve takes no mesh")
        devs = batch_devices(mesh)
        b = len(devs)
        if len(sources) % b:
            raise ValueError(f"{len(sources)} sources do not split over {b}")
        s_l = len(sources) // b
        shards = []
        for i, dev in enumerate(devs):
            arrays = None
            if device_arrays is not None:
                arrays = tuple(_on(a, dev) for a in device_arrays)
            shards.append([sell_fixpoint_masked(
                sell, np.asarray(sources)[i * s_l : (i + 1) * s_l],
                overloaded, mask_positions[i * s_l : (i + 1) * s_l],
                device_arrays=arrays, device=dev,
            )])
        return Sharded(shards)
    dev = resolve_device(device)
    packed, offsets = sell_mask_packed(sell, mask_positions)
    masks = mask_views(torch.as_tensor(packed, device=dev), offsets)
    if device_arrays is not None:
        nbrs, wgs, ov = device_arrays
    else:
        nbrs = tuple(_i32(a, dev) for a in sell.nbr)
        wgs = tuple(_i32(a, dev) for a in sell.wg)
        ov = _bool(overloaded, dev)
    src = _rows(sources, len(overloaded), dev)
    if d_prev is not None:
        with record_function("spf.ksp_masked_warm"):
            return _sell_solver_vw_warm(
                sell.shape_key(), src, nbrs, wgs, masks, ov, d_prev
            )
    with record_function("spf.ksp_masked"):
        return _sell_solver_vw(sell.shape_key(), src, nbrs, wgs, masks, ov)


def batched_spf(
    graph: CompiledGraph, source_rows, device: DeviceLike = "cuda"
) -> torch.Tensor:
    """Run the batched solve for the given source node indices: the
    sliced-ELL pull kernel when the graph's degree profile qualifies
    (ops.graph._build_sell), else the edge-list form. D [S, n_pad]."""
    # named fault seam for injected dispatch failures (docs/Robustness.md)
    fault_point("ops.spf.batched_spf", graph)
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
    graph: CompiledGraph, source_rows, w_rows, device: DeviceLike = "cuda",
    mesh=None,
) -> torch.Tensor:
    """Batched solve with per-row weight vectors (shape [S, e_pad], or
    [1, e_pad] shared by every row). Positions past graph.e are padding
    and must hold INF, as they do in graph.w. With a mesh, the sources and
    the weight rows split over 'batch' (S must be a multiple of the batch
    axis) and D comes back `Sharded`."""
    fault_point("ops.spf.batched_spf_vw", graph)
    if mesh is not None:
        devs = batch_devices(mesh)
        rows = np.asarray(source_rows)
        w_rows = np.asarray(w_rows)
        b = len(devs)
        if len(rows) % b:
            raise ValueError(f"{len(rows)} sources do not split over {b}")
        s_l = len(rows) // b
        return Sharded([
            [batched_spf_vw(
                graph, rows[i * s_l : (i + 1) * s_l],
                w_rows if w_rows.shape[0] == 1
                else w_rows[i * s_l : (i + 1) * s_l],
                device=dev,
            )]
            for i, dev in enumerate(devs)
        ])
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
