"""The resident all-pairs shortest-path state of one area graph, on the card.

`ApspState` keeps one [n_pad, n_pad] distance matrix resident on its
device per area (the blocked Floyd–Warshall close of the compiled graph's
weight matrix) and serves every consumer that needs arbitrary-pair
distances — the SPF views and LFA checks of sources outside the solved
batch, and the TE borrow — from that one matrix.

  - **Residency and a lazy host mirror.** The matrix stays on the device
    between events; host readers go through the `d` mirror, an owned copy
    counted in `d2h_bytes`.
  - **Warm re-close.** A weight event patches the resident weight matrix
    with the changed (u, v) pair minima (in place) and re-closes only the
    block rows and columns the change can reach (K12 seed, then K13
    rounds). A structural rebuild, an overload-mask change or more than
    `_APSP_PATCH_SLOTS` increased pairs close cold (K11).
  - **Staleness guard.** `invalidate()` drops the matrix; the owning
    `_AreaSolve` calls it whenever its own warm solve was poisoned.
  - **Degraded closes through the supervisor only.** A close runs
    through the `dispatch` hook when one is given (`CudaSpfSolver`
    installs `SolverSupervisor.supervised_call` under a supervisor):
    classified faults feed the shared breaker, and the numpy
    Floyd–Warshall serves the close degraded, counted in
    `fallback_closes` and kept host-resident until the next cold close.
    Without a hook a failed close raises: the JAX package's bare
    try/except fallback is not copied, so nothing hides the kernel. A
    kernel fault (`supervisor.is_kernel_fault`: no build, a refused
    launch, a fault on the card) raises through the hook too.
  - **Shadow audit.** Every `audit_interval`-th close compares the matrix
    with `np_floyd_warshall` of the host-side graph; a mismatch
    invalidates and closes cold in place.

Admission is the memory ledger's (monitor/memledger.py): the [n_pad,
n_pad] triple is admitted when `predict_fit` says it fits the headroom
left on the card; a definite no-fit is a refusal, counted once per graph
snapshot and passed to `on_refusal` (the owning solver queues it for the
supervisor's SOLVER_CAPACITY_REFUSED sample). Without a capacity source
(no card, or the card's CUDA context not made yet, and no override) the
static node cap (`graph.n <= max_nodes`) is the gate. The resident triple
registers with the ledger after every close and is released when it
drops (invalidation, a degraded close, `close`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from openr_tpu_torch.apsp.kernels import (
    _APSP_PATCH_SLOTS,
    INCREASE_PAD,
    build_allow_matrix,
    build_weight_matrix,
    fw_block_shape,
    fw_close,
    fw_reclose,
    fw_seed,
    np_floyd_warshall,
)
from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.ops.graph import CompiledGraph, _next_bucket
from openr_tpu_torch.testing.faults import fault_point

# re-close safety margin: the restricted fixpoint stitches at least one
# old-path segment per round, so rounds beyond the block count mean a bug
_RECLOSE_ROUND_MARGIN = 4


class ApspState:
    """One resident blocked-FW APSP matrix, warm-re-closed per event."""

    def __init__(
        self,
        max_nodes: int,
        dispatch: Optional[Callable] = None,
        audit_interval: int = 0,
        warm: bool = True,
        device: DeviceLike = "cuda",
        area: str = "",
        on_refusal: Optional[Callable] = None,
    ) -> None:
        self.max_nodes = max_nodes
        self.device = resolve_device(device)
        # device-memory ledger: the resident triple registers under this
        # area tag; admission asks the ledger's capacity model first
        from openr_tpu_torch.monitor.memledger import get_ledger

        self._ledger = get_ledger()
        self._mem_area = area or "apsp"
        self._mem_handle: Optional[int] = None
        self._on_refusal = on_refusal
        self.last_refusal: Optional[Dict] = None
        self._refused_version: Optional[int] = None
        # dispatch(op, primary_fn, fallback_fn) -> (result, degraded): the
        # SolverSupervisor.supervised_call signature; None = the close
        # raises on failure
        self._dispatch = dispatch
        self.audit_interval = audit_interval
        self.warm = warm

        # decision.spf.apsp_* counters
        self.closes = 0
        self.warm_closes = 0
        self.cold_closes = 0
        self.fallback_closes = 0  # closes served by the numpy FW fallback
        self.invalidations = 0
        self.audit_runs = 0
        self.audit_mismatches = 0
        self.reclose_rounds_last: Optional[int] = None
        self.close_ms_last: Optional[float] = None
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.backend: Optional[str] = None  # "device" | "numpy"
        self.stale_reason: Optional[str] = None
        # counter-sync bookmarks (CudaSpfSolver._sync_apsp_counters)
        self._closes_synced = 0
        self._sync_marks: Dict[str, int] = {}

        # resident state
        self._src_ref: Optional[np.ndarray] = None
        self._version = -2
        self._nb = 0
        self._bsz = 0
        self._w_host: Optional[np.ndarray] = None  # edge-array snapshot
        self._ov_host: Optional[np.ndarray] = None
        self._pair_pos: Dict[Tuple[int, int], np.ndarray] = {}
        self._d_dev: Optional[torch.Tensor] = None
        self._w_dev: Optional[torch.Tensor] = None
        self._allow_dev: Optional[torch.Tensor] = None
        self._d_host: Optional[np.ndarray] = None
        self._closes_since_audit = 0

    # ------------------------------------------------------------------

    def enabled_for(self, graph: CompiledGraph) -> bool:
        """Dense FW residency admission: the ledger's `predict_fit` verdict
        when a capacity source exists, else the static node cap. A definite
        no-fit is a refusal: counted, remembered, and passed to
        `on_refusal`, once per graph snapshot."""
        if graph.n <= 0:
            return False
        verdict = self._ledger.predict_fit(graph.n, "apsp", graph=graph)
        if verdict["fits"] is None:
            # no capacity source: the static node cap is the gate
            return graph.n <= self.max_nodes
        if verdict["fits"]:
            return True
        if self._refused_version != graph.version:
            # one refusal per graph snapshot: every later probe of the same
            # snapshot rides the remembered verdict
            self._refused_version = graph.version
            self._ledger.record_refusal(verdict)
            self.last_refusal = dict(verdict)
            if self._on_refusal is not None:
                self._on_refusal(verdict)
        return False

    def resident(self) -> bool:
        return self._d_dev is not None or self._d_host is not None

    def fresh_for(self, graph: CompiledGraph) -> bool:
        return (
            self.resident()
            and self._src_ref is graph.src
            and self._version == graph.version
        )

    def invalidate(self, reason: str) -> None:
        """Staleness guard: drop the resident matrix so the next ensure()
        closes cold."""
        if self.resident():
            self.invalidations += 1
        self._d_dev = None
        self._d_host = None
        self._w_dev = None
        self._src_ref = None
        self._version = -2
        self.stale_reason = reason
        self._mem_register_resident()

    def _mem_register_resident(self) -> None:
        """Ledger seam: register the resident triple (d, w, allow) after a
        close, or release it when the matrix dropped (invalidation, a
        degraded close, teardown)."""
        self._ledger.release(self._mem_handle)
        self._mem_handle = None
        if self._d_dev is not None:
            self._mem_handle = self._ledger.register(
                self._mem_area,
                "apsp",
                layout="apsp",
                arrays=(self._d_dev, self._w_dev, self._allow_dev),
            )

    def close(self) -> None:
        """Teardown: release the ledger entry (the owning solve dropped)."""
        self._ledger.release(self._mem_handle)
        self._mem_handle = None

    # ------------------------------------------------------------------

    def ensure(self, graph: CompiledGraph) -> bool:
        """Bring the resident matrix up to date with the graph snapshot;
        False when the graph exceeds the node cap."""
        if not self.enabled_for(graph):
            if self.resident():
                self.invalidate("graph_too_large")
            return False
        if self.fresh_for(graph):
            return True
        structural = (
            not self.resident()
            or self._src_ref is not graph.src
            or self._d_dev is None  # numpy-resident: no device warm base
        )
        ov_changed = not structural and not np.array_equal(
            self._ov_host, graph.overloaded
        )
        if structural or ov_changed or not self.warm:
            # an overload toggle re-masks every pair: it closes cold
            self._close_cold(graph)
            return True
        changed = np.nonzero(self._w_host[: graph.e] != graph.w[: graph.e])[0]
        if not len(changed):
            self._version = graph.version  # snapshot is current, no diff
            return True
        inc, patch = self._classify_pairs(graph, changed)
        if len(inc) > _APSP_PATCH_SLOTS:
            self.invalidate("patch_overflow")
            self._close_cold(graph)
            return True
        self._close_warm(graph, inc, patch)
        return True

    # ------------------------------------------------------------------

    def _classify_pairs(self, graph: CompiledGraph, changed: np.ndarray):
        """Changed edge positions -> per-(u, v)-pair weight-minimum moves:
        (increases [(u, v, old_min)], patches [(u, v, new_min)]). Parallel
        edges collapse to the pair minimum, so an edge change only counts
        when it moves the pair's min."""
        pairs = {
            (int(graph.src[p]), int(graph.dst[p])) for p in changed
        }
        inc = []
        patch = []
        for u, v in sorted(pairs):
            pos = self._pair_pos[(u, v)]
            old = int(self._w_host[pos].min())
            new = int(graph.w[pos].min())
            if new == old:
                continue
            patch.append((u, v, new))
            if new > old:
                inc.append((u, v, old))
        return inc, patch

    def _run_close(self, op: str, primary, fallback):
        if self._dispatch is not None:
            return self._dispatch(op, primary, fallback)
        return primary(), False

    def _fallback_close(self, graph: CompiledGraph):
        self.fallback_closes += 1
        d_np = np_floyd_warshall(build_weight_matrix(graph), graph.overloaded)
        return d_np, None, None

    def _close_cold(self, graph: CompiledGraph, audit: bool = True) -> None:
        t0 = time.perf_counter()
        self._compile(graph)

        def primary():
            # named fault seam: the supervisor's all-pairs fault tests
            # inject faults here, where a kernel launch would raise
            fault_point("solver.apsp.close", self)
            w_np = build_weight_matrix(graph)
            allow_np = build_allow_matrix(graph.overloaded)
            w_dev = torch.as_tensor(w_np, device=self.device)
            allow_dev = torch.as_tensor(allow_np, device=self.device)
            self.h2d_bytes += w_np.nbytes + allow_np.nbytes
            d, probe = fw_close(w_dev, allow_dev)
            int(probe)  # 4-byte read: the timing covers the card's work
            return d, w_dev, allow_dev

        (d, w_dev, allow_dev), degraded = self._run_close(
            "apsp.close", primary, lambda: self._fallback_close(graph)
        )
        if degraded or w_dev is None:
            self._d_dev = None
            self._d_host = np.asarray(d)
            self._w_dev = None
            self._allow_dev = None
            self.backend = "numpy"
        else:
            self._d_dev = d
            self._d_host = None
            self._w_dev = w_dev
            self._allow_dev = allow_dev
            self.backend = "device"
        self._mem_register_resident()
        self._snapshot(graph)
        self.closes += 1
        self.cold_closes += 1
        self.reclose_rounds_last = None
        self.close_ms_last = (time.perf_counter() - t0) * 1e3
        self.stale_reason = None
        if audit:
            self._maybe_audit(graph)

    def _close_warm(self, graph: CompiledGraph, inc, patch) -> None:
        t0 = time.perf_counter()
        nb, bsz = self._nb, self._bsz
        dev = self.device

        def primary():
            fault_point("solver.apsp.close", self)
            us = np.array([u for u, _, _ in patch], dtype=np.int32)
            vs = np.array([v for _, v, _ in patch], dtype=np.int32)
            vals = np.array([w for _, _, w in patch], dtype=np.int32)
            # the resident weights are patched in place: they are this
            # state's own buffer and describe the new snapshot from here
            # on (the set is idempotent, so a retried close patches alike;
            # a degraded close drops the buffer)
            self._w_dev.index_put_(
                (
                    torch.as_tensor(us, device=dev).long(),
                    torch.as_tensor(vs, device=dev).long(),
                ),
                torch.as_tensor(vals, device=dev),
            )
            self.h2d_bytes += us.nbytes + vs.nbytes + vals.nbytes
            p = _next_bucket(max(len(inc), 1), minimum=8)
            iu = np.full(p, INCREASE_PAD, dtype=np.int32)
            iv = np.zeros(p, dtype=np.int32)
            iw = np.zeros(p, dtype=np.int32)
            for i, (u, v, old) in enumerate(inc):
                iu[i], iv[i], iw[i] = u, v, old
            self.h2d_bytes += iu.nbytes + iv.nbytes + iw.nbytes
            d, dirty, num_dirty = fw_seed(
                self._d_dev,
                self._w_dev,
                torch.as_tensor(iu, device=dev),
                torch.as_tensor(iv, device=dev),
                torch.as_tensor(iw, device=dev),
                nb,
                bsz,
            )
            rounds = 0
            nd = int(num_dirty)  # 4-byte read
            while nd:
                if rounds > nb + _RECLOSE_ROUND_MARGIN:
                    raise RuntimeError(
                        f"APSP re-close did not converge in {rounds} "
                        f"rounds ({nd} dirty blocks)"
                    )
                kb = min(_next_bucket(nd, minimum=1), nb)
                d, dirty, counts = fw_reclose(
                    d, self._allow_dev, dirty, nb, bsz, kb
                )
                rounds += 1
                nd, changed = counts.tolist()  # the round's two scalars
                if changed == 0:
                    break
            return d, self._w_dev, rounds

        (d, w_dev, rounds), degraded = self._run_close(
            "apsp.close", primary, lambda: self._fallback_close(graph)
        )
        if degraded or w_dev is None:
            self._d_dev = None
            self._d_host = np.asarray(d)
            self._w_dev = None
            self.backend = "numpy"
            self.cold_closes += 1
            self.reclose_rounds_last = None
        else:
            self._d_dev = d
            self._d_host = None
            self.backend = "device"
            self.warm_closes += 1
            self.reclose_rounds_last = rounds
        self._mem_register_resident()
        self._snapshot(graph)
        self.closes += 1
        self.close_ms_last = (time.perf_counter() - t0) * 1e3
        self.stale_reason = None
        self._maybe_audit(graph)

    # ------------------------------------------------------------------

    def _compile(self, graph: CompiledGraph) -> None:
        """(Re)derive the per-structure layout: block shape and the
        (u, v) -> edge-position index the pair-minimum patches need."""
        self._nb, self._bsz = fw_block_shape(graph.n_pad)
        if self._src_ref is not graph.src:
            pair_pos: Dict[Tuple[int, int], list] = {}
            for p in range(graph.e):
                pair_pos.setdefault(
                    (int(graph.src[p]), int(graph.dst[p])), []
                ).append(p)
            self._pair_pos = {
                k: np.asarray(v, dtype=np.int64)
                for k, v in pair_pos.items()
            }

    def _snapshot(self, graph: CompiledGraph) -> None:
        self._src_ref = graph.src
        self._version = graph.version
        self._w_host = graph.w.copy()
        self._ov_host = graph.overloaded.copy()

    # ------------------------------------------------------------------

    @property
    def d(self) -> np.ndarray:
        """Host mirror of the resident [n_pad, n_pad] matrix, fetched on
        first access after each close. An OWNED copy: on the CPU device
        `.numpy()` would alias the buffer the next close overwrites."""
        if self._d_host is None:
            self._d_host = self._d_dev.cpu().numpy().copy()
            self.d2h_bytes += self._d_host.nbytes
        return self._d_host

    def row(self, i: int) -> np.ndarray:
        """One source row of the resident matrix (through the mirror)."""
        return self.d[i]

    # ------------------------------------------------------------------

    def _maybe_audit(self, graph: CompiledGraph) -> None:
        """Every `audit_interval`-th close, compare the resident matrix
        with the numpy FW oracle of the host-side graph; a mismatch
        invalidates and closes cold in place (the corrected matrix serves
        the same event)."""
        if self.audit_interval <= 0:
            return
        self._closes_since_audit += 1
        if self._closes_since_audit < self.audit_interval:
            return
        self._closes_since_audit = 0
        self.audit_runs += 1
        ref = np_floyd_warshall(build_weight_matrix(graph), graph.overloaded)
        if np.array_equal(self.d, ref):
            return
        self.audit_mismatches += 1
        self.invalidate("audit_mismatch")
        self._close_cold(graph, audit=False)

    def health(self) -> Dict:
        """Introspection record (tests, solver health)."""
        return {
            "resident": self.resident(),
            "backend": self.backend,
            "closes": self.closes,
            "warm_closes": self.warm_closes,
            "cold_closes": self.cold_closes,
            "fallback_closes": self.fallback_closes,
            "invalidations": self.invalidations,
            "reclose_rounds_last": self.reclose_rounds_last,
            "audit_runs": self.audit_runs,
            "audit_mismatches": self.audit_mismatches,
            "stale_reason": self.stale_reason,
        }
