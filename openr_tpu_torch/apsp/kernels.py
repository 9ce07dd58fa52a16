"""Blocked (min,+) Floyd–Warshall for the dense all-pairs matrix, on the card.

The [N, N] int32 distance matrix (INF = 1 << 29 for unreachable) is cut
into B x B blocks, B = min(128, n_pad), and closed by the three-phase
blocked sweep: per diagonal stage k, close block (k, k), update the row and
column panels through it, then every other block through the panels. The
transit mask of overloaded nodes (allow[i, m] = not overloaded[m] or m ==
i) applies to the LEFT operand of every (min,+) product only; shortest
paths are simple under metrics >= 1, so the masked sweep is exact.

A weight event is answered warm: the seed resets the rows whose old
shortest-path witness may cross an increased (u, v) pair and folds the new
weight matrix in as an entrywise min, and re-close rounds rebuild only the
dirty block rows (rule a: through every intermediate) and relax every row
through the dirty blocks (rule b), until a round changes nothing.

Three hand-written CUDA kernels carry the device work (ops/csrc/):

  K11 fw_close     the cold close: diagonal block, panels, outer sweep
  K12 fw_seed      the warm seed: affected rows, fold, dirty blocks
  K13 fw_reclose   one re-close round over the dirty blocks

The (min,+) tile product (`_mp` below; K10 in the port's numbering) has no
launch of its own: it is the device routine of fw_minplus.cuh that K13 runs
inside its body, and it is held against `_mp` through it. K11 carries its
own register-blocked product (fw_close.cu), held against `_mp` through the
close.

Each wrapper runs under a `torch.profiler.record_function` seam named as
the JAX package's profiling spans are (`apsp.fw_close.{nb}x{bsz}`,
`apsp.fw_seed.{nb}x{bsz}`, `apsp.fw_reclose.{nb}x{bsz}`), so a profiler
trace names the all-pairs work as it names ops/spf.py's.

Each wrapper checks device, dtype, shape and contiguity; on a CUDA tensor
it launches its kernel (and counts the launch), on a CPU tensor it runs the
plain PyTorch version beside it. The plain versions are the CPU tests' path
and the card's reference; nothing on the path calls them on the card.

The numpy helpers at the top are copies of the JAX package's host half:
the weight and allow matrices and the numpy Floyd–Warshall that the shadow
audit compares with.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.profiler import record_function

from openr_tpu_torch.ops._cuda import FW_CLOSE, FW_RECLOSE, FW_SEED
from openr_tpu_torch.ops.graph import INF, CompiledGraph
from openr_tpu_torch.ops.spf import _check

# block edge: blocks are B x B with B = min(128, n_pad); n_pad is a power of
# two (ops/graph.py bucket padding), so B always divides it
_FW_BLOCK = 128

# fixed warm-patch width: events increasing more (u, v) pair minima than
# this close cold (the ApspState staleness guard)
_APSP_PATCH_SLOTS = 64

# u of a padding increase slot: out of range, so the seed drops it
INCREASE_PAD = 1 << 30

# elements of the largest temporary the plain (min,+) product makes
_MP_CHUNK = 1 << 24

_INT32_MAX = int(np.iinfo(np.int32).max)


# -- host half (numpy) ------------------------------------------------------


def fw_block_shape(n_pad: int) -> Tuple[int, int]:
    """(nb, bsz): block count and block edge for a padded node count."""
    bsz = min(_FW_BLOCK, n_pad)
    assert n_pad % bsz == 0, (n_pad, bsz)  # bucket padding: power of two
    return n_pad // bsz, bsz


def _to_blocks(x, nb: int, bsz: int):
    """[N, N] -> block-major [nb, nb, B, B]."""
    return x.reshape(nb, bsz, nb, bsz).transpose(0, 2, 1, 3)


def _from_blocks(x4, nb: int, bsz: int):
    """Block-major [nb, nb, B, B] -> [N, N]."""
    return x4.transpose(0, 2, 1, 3).reshape(nb * bsz, nb * bsz)


def build_weight_matrix(graph: CompiledGraph) -> np.ndarray:
    """Dense [n_pad, n_pad] int32 direct-edge matrix from the compiled
    arrays: parallel edges collapse to their pair minimum, down links stay
    at INF (they carry INF in graph.w), the diagonal is 0, and padding
    nodes are isolated (INF rows/columns) so they never perturb real
    distances."""
    n = graph.n_pad
    w = np.full((n, n), INF, dtype=np.int32)
    e = graph.e
    if e:
        np.minimum.at(w, (graph.src[:e], graph.dst[:e]), graph.w[:e])
    np.fill_diagonal(w, 0)
    return w


def build_allow_matrix(overloaded: np.ndarray) -> np.ndarray:
    """[N, N] bool per-source transit mask: allow[i, k] — source i may
    relay through k — unless k is overloaded and k is not i itself."""
    n = overloaded.shape[0]
    return (~overloaded)[None, :] | np.eye(n, dtype=bool)


def np_floyd_warshall(w: np.ndarray, overloaded: np.ndarray) -> np.ndarray:
    """Numpy masked Floyd–Warshall: the shadow audit's oracle. One
    vectorized rank-1
    relaxation per intermediate k, int64 internally so the INF sums cannot
    wrap, clamped back to the int32 sentinel."""
    n = w.shape[0]
    d = w.astype(np.int64).copy()
    np.fill_diagonal(d, 0)
    allow = build_allow_matrix(overloaded)
    big = np.int64(INF)
    for k in range(n):
        dk = np.where(allow[:, k], d[:, k], big)
        d = np.minimum(d, np.minimum(dk[:, None] + d[k][None, :], big))
    return d.astype(np.int32)


# -- plain PyTorch versions -------------------------------------------------


def _mp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(min,+) product, INF-clamped: out[..., i, j] = min_m min(a[..., i,
    m] + b[..., m, j], INF), for [..., M, K] x [..., K, N] int32 (the
    plain version of fw_minplus.cuh's tile product). The K dimension is
    walked in chunks so that the [..., M, chunk, N] sums stay below
    _MP_CHUNK elements."""
    k = a.shape[-1]
    per_m = a[..., :, :1].numel() * b.shape[-1]
    step = max(1, _MP_CHUNK // max(per_m, 1))
    out = None
    for m0 in range(0, k, step):
        part = (
            (a[..., :, m0 : m0 + step, None] + b[..., None, m0 : m0 + step, :])
            .clamp_max_(INF)
            .amin(dim=-2)
        )
        out = part if out is None else torch.minimum(out, part)
    return out


def _fw_close_plain(
    w: torch.Tensor, allow: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11's plain version: the masked per-k relaxation of
    np_floyd_warshall in int32 with the min(., INF) clamp, from w (which
    carries its 0 diagonal). Returns (d, probe = d.min())."""
    d = w.clone()
    for k in range(d.shape[0]):
        dk = torch.where(allow[:, k], d[:, k], INF)
        cand = (dk[:, None] + d[k][None, :]).clamp_max_(INF)
        torch.minimum(d, cand, out=d)
    return d, d.min()


def _fw_seed_plain(
    d_prev: torch.Tensor,
    w_new: torch.Tensor,
    inc_u: torch.Tensor,
    inc_v: torch.Tensor,
    inc_w: torch.Tensor,
    nb: int,
    bsz: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K12's plain version: (d0, dirty [nb] bool, num_dirty). Row i is
    affected when min(min(D[i, u] + w_old, INF) + D[v, j], INF) == D[i, j]
    < INF for a valid slot (u < n; u and v clipped) and some j."""
    n = d_prev.shape[0]
    ok = inc_u < n
    us = inc_u.clamp(0, n - 1).long()
    vs = inc_v.clamp(0, n - 1).long()
    aff = torch.zeros(n, dtype=torch.bool, device=d_prev.device)
    finite = d_prev < INF
    for p in range(inc_u.shape[0]):
        du = d_prev.index_select(1, us[p : p + 1])[:, 0]
        dv = d_prev.index_select(0, vs[p : p + 1])[0]
        a = (du + inc_w[p]).clamp_max_(INF)
        cand = (a[:, None] + dv[None, :]).clamp_max_(INF)
        hit = ((cand == d_prev) & finite).any(dim=1)
        aff |= ok[p] & hit
    d0 = torch.where(aff[:, None], INF, d_prev)
    d0 = torch.minimum(d0, w_new)
    dirty_rows = aff | (d0 != d_prev).any(dim=1)
    dirty = dirty_rows.reshape(nb, bsz).any(dim=1)
    return d0, dirty, dirty.sum(dtype=torch.int32)


def _compact_blocks(dirty: torch.Tensor, nb: int, kb: int) -> torch.Tensor:
    """nonzero(dirty, size=kb, fill_value=nb), ascending."""
    idx = torch.nonzero(dirty).flatten()[:kb].to(torch.int32)
    blk = torch.full((kb,), nb, dtype=torch.int32, device=dirty.device)
    blk[: idx.shape[0]] = idx
    return blk


def _fw_reclose_plain(
    d: torch.Tensor,
    allow: torch.Tensor,
    dirty: torch.Tensor,
    nb: int,
    bsz: int,
    kb: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K13's plain version, in the reference's block form: (d_new,
    dirty_new, num_dirty, changed_blocks); d is updated in place and
    returned.

    Rule (a) rebuilds each compacted dirty block row from the pre-round
    matrix (Jacobi); rule (b) then runs one step per compacted dirty block
    in ascending order, each from snapshots of the masked column block and
    the row block taken at the step's start."""
    before = d.clone()
    blk = _compact_blocks(dirty, nb, kb).tolist()
    valid = [k for k in blk if k < nb]
    rows_new = []
    for k in valid:
        rows = slice(k * bsz, (k + 1) * bsz)
        left = torch.where(allow[rows], before[rows], INF)
        rows_new.append(torch.minimum(before[rows], _mp(left, before)))
    for k, new in zip(valid, rows_new):
        rows = slice(k * bsz, (k + 1) * bsz)
        torch.minimum(d[rows], new, out=d[rows])
    for k in valid:
        cols = slice(k * bsz, (k + 1) * bsz)
        colm = torch.where(allow[:, cols], d[:, cols], INF)
        row_k = d[cols].clone()
        torch.minimum(d, _mp(colm, row_k), out=d)
    changed = (d != before).any(dim=1).reshape(nb, bsz).any(dim=1)
    dirty_new = dirty | changed
    return (
        d,
        dirty_new,
        dirty_new.sum(dtype=torch.int32),
        changed.sum(dtype=torch.int32),
    )


# -- wrappers: the kernel on the card, the plain version on the CPU ---------


def _square(name: str, t: torch.Tensor, dtype, dev) -> int:
    _check(name, t, dtype, 2, dev)
    if t.shape[0] != t.shape[1]:
        raise ValueError(f"{name}: must be square, got {tuple(t.shape)}")
    return t.shape[0]


def fw_close(
    w: torch.Tensor, allow: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cold masked blocked Floyd–Warshall close (K11): w [N, N] int32 with
    a 0 diagonal, allow [N, N] bool -> (d, probe), probe = d.min() as a
    one-element tensor. w is not modified. On the card, 2 nb + 2 launches
    (nb blocks a side; 2 with one block): block (0, 0)'s close, the panels
    and the outer sweep of each stage, the probe."""
    dev = w.device
    n = _square("w", w, torch.int32, dev)
    if _square("allow", allow, torch.bool, dev) != n:
        raise ValueError("w and allow differ in size")
    nb, bsz = fw_block_shape(n)
    with record_function(f"apsp.fw_close.{nb}x{bsz}"):
        return _fw_close(w, allow, nb, bsz)


def _fw_close(w, allow, nb: int, bsz: int):
    dev, n = w.device, w.shape[0]
    if dev.type != "cuda":
        return _fw_close_plain(w, allow)
    d = w.clone()
    if nb == 1:
        FW_CLOSE.launch(dev, d.data_ptr(), allow.data_ptr(), None, n, bsz,
                        entry="fw_close_diag")
    else:
        # the closed diagonal block, masked and transposed, and the column
        # panel, masked and transposed: each stage's operands
        ct = torch.empty((bsz, bsz), dtype=torch.int32, device=dev)
        colm = torch.empty((bsz, n), dtype=torch.int32, device=dev)
        FW_CLOSE.launch(dev, d.data_ptr(), allow.data_ptr(), ct.data_ptr(),
                        n, bsz, entry="fw_close_diag")
        for k in range(nb):
            for entry in ("fw_close_panels", "fw_close_outer"):
                FW_CLOSE.launch(dev, d.data_ptr(), allow.data_ptr(),
                                ct.data_ptr(), colm.data_ptr(), k, n,
                                entry=entry)
    probe = torch.full((1,), _INT32_MAX, dtype=torch.int32, device=dev)
    FW_CLOSE.launch(dev, d.data_ptr(), probe.data_ptr(), n,
                    entry="fw_close_probe")
    return d, probe[0]


# K12's scratch per card and stream: each block row's arrivals and dirty
# arrivals, then the completed block rows and the dirty ones (fw_seed.cu).
# Zeroed once; the kernel leaves it at 0 again. Seeds on one stream run in
# order, so only seeds on different streams could overlap, and each stream
# has its own
_seed_scratch = {}


def _seed_scratch_for(dev, nb: int) -> torch.Tensor:
    key = (dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    buf = _seed_scratch.get(key)
    if buf is None or buf.numel() < nb + 1:
        buf = torch.zeros(nb + 1, dtype=torch.int32, device=dev)
        _seed_scratch[key] = buf
    return buf


def fw_seed(
    d_prev: torch.Tensor,
    w_new: torch.Tensor,
    inc_u: torch.Tensor,
    inc_v: torch.Tensor,
    inc_w: torch.Tensor,
    nb: int,
    bsz: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warm re-close seed (K12): (d0 [N, N], dirty [nb] bool, num_dirty
    one-element int32). d_prev and w_new are not modified. On the card, one
    launch a seed: the affected rows, the fold and the dirty blocks."""
    dev = d_prev.device
    n = _square("d_prev", d_prev, torch.int32, dev)
    if _square("w_new", w_new, torch.int32, dev) != n or nb * bsz != n:
        raise ValueError("d_prev, w_new and (nb, bsz) differ in size")
    for name, t in (("inc_u", inc_u), ("inc_v", inc_v), ("inc_w", inc_w)):
        _check(name, t, torch.int32, 1, dev)
    p = inc_u.shape[0]
    if inc_v.shape[0] != p or inc_w.shape[0] != p:
        raise ValueError("increase slot arrays differ in length")
    with record_function(f"apsp.fw_seed.{nb}x{bsz}"):
        return _fw_seed(d_prev, w_new, inc_u, inc_v, inc_w, nb, bsz)


def _fw_seed(d_prev, w_new, inc_u, inc_v, inc_w, nb: int, bsz: int):
    dev, n, p = d_prev.device, d_prev.shape[0], inc_u.shape[0]
    if dev.type != "cuda":
        d0, dirty, num = _fw_seed_plain(d_prev, w_new, inc_u, inc_v, inc_w,
                                        nb, bsz)
        return d0, dirty, num.reshape(1)
    d0 = torch.empty_like(d_prev)
    dirty = torch.empty(nb, dtype=torch.bool, device=dev)
    num = torch.empty(1, dtype=torch.int32, device=dev)
    FW_SEED.launch(
        dev,
        d_prev.data_ptr(), w_new.data_ptr(), inc_u.data_ptr(),
        inc_v.data_ptr(), inc_w.data_ptr(), d0.data_ptr(), dirty.data_ptr(),
        num.data_ptr(), _seed_scratch_for(dev, nb).data_ptr(), p, n, nb, bsz,
    )
    return d0, dirty, num


def fw_reclose(
    d: torch.Tensor,
    allow: torch.Tensor,
    dirty: torch.Tensor,
    nb: int,
    bsz: int,
    kb: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One warm re-close round (K13) over at most kb dirty blocks: (d_new,
    dirty_new [nb] bool, counts int32 [2] = (num_dirty, changed_blocks)).
    d is updated in place and returned as d_new."""
    dev = d.device
    n = _square("d", d, torch.int32, dev)
    if _square("allow", allow, torch.bool, dev) != n or nb * bsz != n:
        raise ValueError("d, allow and (nb, bsz) differ in size")
    _check("dirty", dirty, torch.bool, 1, dev)
    if dirty.shape[0] != nb or not 1 <= kb <= nb:
        raise ValueError(f"dirty has {dirty.shape[0]} blocks, kb {kb}")
    with record_function(f"apsp.fw_reclose.{nb}x{bsz}"):
        return _fw_reclose(d, allow, dirty, nb, bsz, kb)


def _fw_reclose(d, allow, dirty, nb: int, bsz: int, kb: int):
    dev, n = d.device, d.shape[0]
    if dev.type != "cuda":
        d, dirty_new, num, changed = _fw_reclose_plain(d, allow, dirty, nb,
                                                       bsz, kb)
        return d, dirty_new, torch.stack([num, changed])
    blk = torch.empty(kb, dtype=torch.int32, device=dev)
    changed = torch.empty(nb, dtype=torch.bool, device=dev)
    scratch = torch.empty((kb, bsz, n), dtype=torch.int32, device=dev)
    colm = torch.empty((n, bsz), dtype=torch.int32, device=dev)
    rowk = torch.empty((bsz, n), dtype=torch.int32, device=dev)
    dirty_new = torch.empty(nb, dtype=torch.bool, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    FW_RECLOSE.launch(dev, dirty.data_ptr(), blk.data_ptr(),
                      changed.data_ptr(), nb, kb, entry="fw_reclose_compact")
    FW_RECLOSE.launch(dev, d.data_ptr(), allow.data_ptr(), blk.data_ptr(),
                      scratch.data_ptr(), kb, nb, bsz, entry="fw_reclose_rows")
    FW_RECLOSE.launch(dev, d.data_ptr(), scratch.data_ptr(), blk.data_ptr(),
                      changed.data_ptr(), kb, nb, bsz,
                      entry="fw_reclose_rows_apply")
    for c in range(kb):
        FW_RECLOSE.launch(dev, d.data_ptr(), allow.data_ptr(), blk.data_ptr(),
                          colm.data_ptr(), rowk.data_ptr(), c, nb, bsz,
                          entry="fw_reclose_snapshot")
        FW_RECLOSE.launch(dev, d.data_ptr(), colm.data_ptr(), rowk.data_ptr(),
                          blk.data_ptr(), changed.data_ptr(), c, nb, bsz,
                          entry="fw_reclose_step")
    FW_RECLOSE.launch(dev, dirty.data_ptr(), changed.data_ptr(),
                      dirty_new.data_ptr(), counts.data_ptr(), nb,
                      entry="fw_reclose_finish")
    return d, dirty_new, counts
