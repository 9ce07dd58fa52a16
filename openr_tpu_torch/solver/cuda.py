"""Batched SPF solver backend on the card: cold solves and the event path.

Drop-in replacement for the CPU oracle: inherits the whole route-assembly
pipeline from SpfSolver and overrides the SPF access seam so that distances
and ECMP nexthop sets come from one batched min-plus solve on the card
(ops/spf.py) instead of per-source Dijkstra runs.

Per (area, topology version, node) the solver compiles the LinkState to
padded arrays and solves for sources = {me} ∪ up-neighbours(me) in one
device solve — exactly the rows the route pipeline reads:
  - reachability and metric from me (best-announcer selection)
  - dist(neighbour, t) for the triangle-condition ECMP nexthops and for the
    RFC 5286 LFA inequality
Nexthop sets come from the ECMP triangle kernel over me's up-links,
w(me, n) + D[n, t] == D[me, t], which reproduces Dijkstra's nexthop-union
semantics (LinkState.cpp:855-871) without tracing paths.

The distance matrix stays on the card between events. A weight-only LSDB
event (link flap, metric change, overload toggle on the sliced layout) is
answered from the previous fixpoint: the entries whose old shortest path
may cross a heavier edge are invalidated, the changed weight slots are
patched, and the relaxation repairs the rest (ops/spf.py
`_sell_solver_warm`, `_bf_solver_warm`). The same solve names the
destination columns that moved, and a qualifying event copies back only
those columns (`_finish_delta`), which `solver/delta.py` turns into a route
delta. A structural rebuild, a source-batch change, a patch overflow or an
overload change on the edge-list layout solves cold (from D0 = INF).

KSP2 (the k-edge-disjoint second paths of SR-MPLS prefixes) runs on the
card too: `prefetch_ksp` solves every destination's link-ignore re-solve as
one batch row of a masked solve (ops/spf.py `sell_fixpoint_masked` on the
sliced layout, `_bf_warm_vw_core` or `batched_spf_vw` on the edge-list
one), warm-started from me's resident base row, and the paths are traced
greedily on the host from the copied-back rows (`_trace_paths`).

With `apsp_max_nodes` > 0 an area of at most that many nodes also keeps a
resident all-pairs matrix (apsp/state.py `ApspState`: the blocked
Floyd–Warshall close K11, warm re-closes K12 + K13), closed at the first
read and re-closed warm per weight event. It answers every source outside
the batch: `_spf` views (`_ApspSpfResult`, nexthops by the triangle test
against its rows), `_dist`, route dbs built from another node's
perspective, the LFA checks of those, and `borrow_apsp`; and it opens
DeltaPath under LFA (`lfa_delta_ready`). An event that poisons the batch's
warm solve invalidates it too. A source outside the batch that the matrix
cannot answer (APSP off, or the area past the cap) is answered by the
LinkState's own Dijkstra, and each such answer is counted in
`host_spf_calls`.

With a solver mesh (`parallel/mesh.py`, a (batch, graph) grid of devices)
the same solves run on every rank. A graph axis above one that divides
n_pad takes the destination-tiled layout: each rank keeps a [S/batch,
n_pad/graph] tile of D, the rounds exchange frontiers around the graph ring
(K19, K20; K21 for the cold tile and the warm path's marks), cold and warm,
with DeltaPath (`_tile_solve_resident`), and the ring's traffic lands in
`halo_bytes` and `halo_exchanges_last`. Otherwise the source batch is split
into row slices over 'batch' against replicated layout buffers. KSP's
masked solves run cold and row-sharded under a mesh, as in the reference.

Every resident structure registers with the device-memory ledger
(monitor/memledger.py) under the area's tag ("{area}/{me}") and is released
when it is replaced or dropped: D (`dist`), the layout (`sell` with its
`patch` slots, `bf`, or the tiled layout's `tile` and `halo`), the host
mirror (`mirror`) and KSP's per-row weights while a batch runs (`ksp`).
Before a layout's first dispatch `_admit_layout` asks the ledger's
`predict_fit` whether it fits the card's headroom; a definite no-fit
raises `DeviceCapacityError` before anything is allocated, which the
supervisor classifies as `device_oom`. With a flight recorder attached
(`attach_recorder`), every solve records a `SolveTrace`, and every
sampled solve's `PhaseClock` splits it at the seams prepare, h2d, relax,
delta_extract and (at the mirror's fetch) d2h.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from openr_tpu_torch.apsp import ApspState
from openr_tpu_torch.convert import (
    rank_replicas,
    rank_rows,
    rank_sources,
    tiling_ranks,
    to_device,
    upload,
)
from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.lsdb.link_state import Link, LinkState, Path
from openr_tpu_torch.monitor.memledger import get_ledger
from openr_tpu_torch.ops import _cuda
from openr_tpu_torch.ops.graph import (
    INF,
    CompiledGraph,
    _next_bucket,
    compile_graph,
    refresh_graph,
)
from openr_tpu_torch.ops.spf import (
    _bf_fixpoint,
    _bf_solver_warm,
    _bf_warm_vw_core,
    _delta_extract,
    _delta_extract_sharded,
    _sell_apply_patches,
    _sell_solver_counted,
    _sell_solver_patched,
    _sell_solver_warm,
    _tile_solver,
    _tile_solver_warm,
    HaloCopies,
    Sharded,
    batched_spf,
    batched_spf_vw,
    check_nh_rows,
    ecmp_triangle,
    sell_fixpoint_masked,
    sell_patch_arrays,
    to_host,
)
from openr_tpu_torch.parallel.mesh import (
    Mesh,
    plan_degraded_mesh,
    replicate,
    resolve_mesh,
    sharded_batched_spf,
    tile_graph,
)
from openr_tpu_torch.solver.cpu import Metric, SpfSolver
from openr_tpu_torch.solver.flight_recorder import NULL_CLOCK, SolveTrace
from openr_tpu_torch.testing.faults import fault_point


class DeviceCapacityError(RuntimeError):
    """Predicted out-of-memory: the memory ledger's capacity model says the
    chosen layout cannot fit the card's headroom. Raised before the first
    dispatch, so the supervisor classifies it as `device_oom` and walks its
    degrade ladder (a smaller mesh, then the CPU oracle) instead of the
    allocator failing in the middle of a solve. Its message keeps the JAX
    package's words ("predicted RESOURCE_EXHAUSTED: ..."), which the
    supervisor's classifier also reads as out of memory."""


# fixed per-bucket patch width of the fused patch + solve; an event that
# changes more slots in one bucket is patched by standalone scatters and
# solved cold
_PATCH_SLOTS = 64

# DeltaPath cutoff: when more than this fraction of the destination columns
# changed, the full [S, n_pad] mirror is the cheaper copy-back and the event
# is served as a full rebuild instead
_DELTA_MAX_FRAC = 0.5


def _first(placed):
    """A layout buffer as one copy: under a mesh `_place` keeps one per
    device (a dict), and the ledger counts one of them."""
    return next(iter(placed.values())) if isinstance(placed, dict) else placed


class _NodeView:
    """NodeSpfResult-compatible view over the device distance matrix."""

    __slots__ = ("metric", "_result", "_dest")

    def __init__(self, metric: Metric, result: "_CudaSpfResult", dest: str):
        self.metric = metric
        self._result = result
        self._dest = dest

    @property
    def next_hops(self) -> Set[str]:
        return self._result.next_hops_of(self._dest)


class _CudaSpfResult:
    """SpfResult-compatible mapping dest -> _NodeView, backed by D rows."""

    def __init__(self, area: "_AreaSolve", source: str):
        self._area = area
        self._source = source
        self._src_row = area.row_map[source]
        self._nh_cache: Dict[str, Set[str]] = {}

    def __contains__(self, dest: str) -> bool:
        col = self._area.graph.node_index.get(dest)
        if col is None:
            return False
        return self._area.d[self._src_row, col] < INF

    def get(self, dest: str) -> Optional[_NodeView]:
        col = self._area.graph.node_index.get(dest)
        if col is None:
            return None
        metric = int(self._area.d[self._src_row, col])
        if metric >= INF:
            return None
        return _NodeView(metric, self, dest)

    def __getitem__(self, dest: str) -> _NodeView:
        view = self.get(dest)
        if view is None:
            raise KeyError(dest)
        return view

    def next_hops_of(self, dest: str) -> Set[str]:
        """ECMP nexthop node set for source -> dest. The batch solves
        nexthop sets from the primary node's perspective only; for any
        other source the resident all-pairs matrix answers (the same
        triangle against its rows), and without one the call fails fast
        rather than serve a partial answer."""
        if self._source != self._area.sources[0]:
            cached = self._nh_cache.get(dest)
            if cached is not None:
                return cached
            if self._area.ensure_apsp():
                nhs = _ApspSpfResult(
                    self._area, self._source
                ).next_hops_of(dest)
                self._nh_cache[dest] = nhs
                return nhs
            raise RuntimeError(
                f"nexthop sets are only solved for {self._area.sources[0]}, "
                f"requested for {self._source}"
            )
        cached = self._nh_cache.get(dest)
        if cached is not None:
            return cached
        area = self._area
        nhs: Set[str] = set()
        if dest != self._source:
            col = area.graph.node_index.get(dest)
            if col is not None:
                names, mask = area.nh_mask()
                nhs = {n for n, hit in zip(names, mask[:, col]) if hit}
        self._nh_cache[dest] = nhs
        return nhs


class _ApspSpfResult:
    """SpfResult-compatible view for a source OUTSIDE the solved batch,
    backed by the area's resident all-pairs matrix.

    Metrics read the source's row; nexthop sets come from the triangle
    test the batch path uses, w(s, n) + D[n, t] == D[s, t] over s's
    ordered up-links, with an overloaded neighbour valid only as the
    destination itself, against rows of the one resident matrix."""

    def __init__(self, area: "_AreaSolve", source: str):
        self._area = area
        self._source = source
        self._src_row = area.graph.node_index[source]
        self._nh_cache: Dict[str, Set[str]] = {}

    def __contains__(self, dest: str) -> bool:
        col = self._area.graph.node_index.get(dest)
        if col is None:
            return False
        return self._area.apsp.d[self._src_row, col] < INF

    def get(self, dest: str) -> Optional[_NodeView]:
        col = self._area.graph.node_index.get(dest)
        if col is None:
            return None
        metric = int(self._area.apsp.d[self._src_row, col])
        if metric >= INF:
            return None
        return _NodeView(metric, self, dest)

    def __getitem__(self, dest: str) -> _NodeView:
        view = self.get(dest)
        if view is None:
            raise KeyError(dest)
        return view

    def next_hops_of(self, dest: str) -> Set[str]:
        cached = self._nh_cache.get(dest)
        if cached is not None:
            return cached
        nhs: Set[str] = set()
        area = self._area
        idx = area.graph.node_index
        col = idx.get(dest)
        d = area.apsp.d
        if (
            dest != self._source
            and col is not None
            and d[self._src_row, col] < INF
        ):
            ls = area.link_state
            for link in ls.ordered_links_from_node(self._source):
                if not link.is_up():
                    continue
                n = link.other_node_name(self._source)
                ni = idx.get(n)
                if ni is None:
                    continue
                # an overloaded neighbour relays nothing: valid only when it
                # is itself the destination
                if ls.is_node_overloaded(n) and n != dest:
                    continue
                w = link.metric_from_node(self._source)
                if w + int(d[ni, col]) == int(d[self._src_row, col]):
                    nhs.add(n)
        self._nh_cache[dest] = nhs
        return nhs


class _AreaSolve:
    """One batched device solve: sources = [me] + up-neighbours(me).

    The layout buffers and the distance matrix stay on the card between
    events; host readers go through the lazy `d` mirror. On a topology
    change `refresh()` patches the compiled arrays through the LinkState
    changelog and solves again: warm from the resident D when the event is
    a pure weight patch (same source batch, fits _PATCH_SLOTS; on the
    sliced layout an overload toggle too), cold otherwise. A warm event
    that qualifies for DeltaPath patches the host mirrors in place with the
    changed columns only and queues them for `take_route_delta`."""

    def __init__(
        self,
        link_state: LinkState,
        me: str,
        device: torch.device,
        warm_start: bool = True,
        apsp_max_nodes: int = 0,
        apsp_audit_interval: int = 0,
        mesh: Optional[Mesh] = None,
        apsp_dispatch=None,
        recorder=None,
        on_capacity_refusal=None,
    ) -> None:
        self.link_state = link_state
        self.me = me
        # device-memory ledger: every resident structure registers under
        # this area tag and close() releases it
        self._ledger = get_ledger()
        self._mem_area = f"{link_state.area}/{me}"
        self._mem: Dict[str, int] = {}
        self._on_capacity_refusal = on_capacity_refusal
        # flight recorder: every solve records a SolveTrace; a sampled one
        # gets a live PhaseClock (barriers at the phase seams), the others
        # the shared NULL_CLOCK, whose seams do nothing
        self._recorder = recorder
        self._pclock = NULL_CLOCK
        self._last_trace: Optional[SolveTrace] = None
        # under a mesh the sources split over 'batch' and, with a graph
        # axis above one, D is tiled; host-side work (the delta extraction,
        # the nexthop mask) lands on the mesh's first device
        self.mesh = mesh
        self.device = device if mesh is None else mesh.devices[0, 0]
        self.warm_start = warm_start
        self.graph: CompiledGraph = compile_graph(link_state)
        # resident all-pairs matrix: closed at the first consumer read,
        # re-closed warm per weight event, poisoned with the batch's warm
        # state; None when the apsp knob is off
        self.apsp: Optional[ApspState] = None
        if apsp_max_nodes > 0:
            self.apsp = ApspState(
                apsp_max_nodes,
                dispatch=apsp_dispatch,
                audit_interval=apsp_audit_interval,
                warm=warm_start,
                device=device,
                area=self._mem_area,
                on_refusal=self._note_capacity_refusal,
            )
        self.device_solves = 0
        # decision.spf.* convergence counters
        self.incremental_solves = 0  # warm-started weight-patch solves
        self.full_solves = 0  # cold solves (from D0 = INF)
        # relaxation rounds of the last solve; None after a cold edge-list
        # solve, whose rounds the reference does not track
        self.rounds_last: Optional[int] = None
        # mark-fixpoint rounds of the last WARM solve (0 when nothing was
        # invalidated)
        self.invalidation_rounds_last: Optional[int] = None
        self.solve_ms_last: Optional[float] = None
        self.last_solve_warm = False
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        # DeltaPath: changed columns and copy-back bytes of the extractions;
        # d2h_bytes grows by delta_bytes on the delta path and by the full
        # mirror on the cold path
        self.delta_extracts = 0
        self.delta_columns = 0
        self.delta_bytes = 0
        self.delta_extract_ms_last: Optional[float] = None
        # changed destination columns accumulated for take_route_delta;
        # None = poisoned: a solve since the last take had no device delta
        self._delta_pending: Optional[set] = set()
        self._last_solve_delta: Optional[np.ndarray] = None
        # _sync_spf_counters bookmarks
        self._h2d_synced = 0
        self._d2h_synced = 0
        self._delta_cols_synced = 0
        self._delta_bytes_synced = 0
        self._delta_extracts_synced = 0
        # halo exchange of the tiled layout: ring hops of the last solve and
        # the frontier bytes they moved, cumulative
        self.halo_bytes = 0
        self.halo_exchanges_last: Optional[int] = None
        self._halo_synced = 0
        # KSP: device batches of link-ignore re-solves, and those of them
        # warm-started from the base row (decision.spf.ksp_warm_batches)
        self.ksp_device_batches = 0
        self.ksp_warm_batches = 0
        self._ksp_warm_synced = 0
        self._dev: Optional[dict] = None
        # the distance matrix: a tensor, or `Sharded` under a mesh
        self._d_dev = None
        self._d_host: Optional[np.ndarray] = None
        self._nh_links: Optional[List[str]] = None
        self._nh_mask: Optional[np.ndarray] = None
        # set while a solve runs: one that raised is run again by refresh
        self._solve_failed = False
        self._solve()

    @property
    def d(self) -> np.ndarray:
        """Host mirror of the device distance matrix [s_pad, n_pad], fetched
        on first access after a cold or non-qualifying solve (a DeltaPath
        event patches it in place). An owned copy: on the CPU device the
        tensor's numpy view would alias the solver's own buffer."""
        if self._d_host is None:
            t0 = time.perf_counter()
            self._d_host = to_host(self._d_dev).copy()
            self.d2h_bytes += self._d_host.nbytes
            trace = self._last_trace
            if trace is not None and trace.sampled:
                # the mirror fetch is the solve's d2h phase; it comes after
                # the trace was recorded, so it is added to the trace (the
                # ring holds the object) and queued for the next sync
                ms = (time.perf_counter() - t0) * 1e3
                trace.phases["d2h"] = trace.phases.get("d2h", 0.0) + ms
                trace.d2h_bytes += self._d_host.nbytes
                self._recorder.observe_phase("d2h", ms)
            self._mem_register("mirror", "host", arrays=(self._d_host,))
        return self._d_host

    # -- device-memory ledger seams (monitor/memledger.py) -------------

    def _mem_register(
        self, structure: str, layout: str, arrays=(), nbytes=None
    ) -> None:
        """Register one named resident structure under this area, releasing
        its previous generation first (a rebuild frees the old buffers when
        the new upload replaces them)."""
        self._ledger.release(self._mem.pop(structure, None))
        self._mem[structure] = self._ledger.register(
            self._mem_area, structure, layout=layout, arrays=arrays,
            nbytes=nbytes,
        )

    def _mem_release(self, structure: str) -> None:
        self._ledger.release(self._mem.pop(structure, None))

    def close(self) -> None:
        """Area teardown: release every registered structure and the
        all-pairs state's. Called when the owning solver drops or replaces
        this solve."""
        if self.apsp is not None:
            self.apsp.close()
        for structure in list(self._mem):
            self._mem_release(structure)

    def _note_capacity_refusal(self, verdict: Dict) -> None:
        """Pass an admission refusal up to the owning solver (the
        supervisor's SOLVER_CAPACITY_REFUSED sample)."""
        if self._on_capacity_refusal is not None:
            self._on_capacity_refusal(verdict)

    def _admit_layout(self, layout: str, tiling=None) -> None:
        """Capacity admission before a layout's dispatch: the ledger's
        forward model against the card's headroom. No capacity source (no
        card and no override) gives no verdict and admits; a definite
        no-fit is recorded and raises DeviceCapacityError before anything
        is allocated. `tiling`: the resident tiled layout's, when current,
        so a tiled event does not tile the graph again to be admitted."""
        verdict = self._ledger.predict_fit(
            self.graph.n,
            layout,
            n_sources=len(getattr(self, "sources", ())) or 1,
            graph=self.graph,
            tiling=tiling,
            mesh_shape=(
                (self.mesh.shape["batch"], self.mesh.shape["graph"])
                if self.mesh is not None
                else None
            ),
        )
        if verdict["fits"] is False:
            self._ledger.record_refusal(verdict)
            self._note_capacity_refusal(verdict)
            raise DeviceCapacityError(
                f"predicted RESOURCE_EXHAUSTED: layout {layout} for area "
                f"{self._mem_area} needs {verdict['predicted_bytes']} bytes, "
                f"headroom {verdict['headroom_bytes']} "
                f"(capacity {verdict['capacity_bytes']}, "
                f"source {verdict['source']})"
            )

    def _batch_pad(self, n: int, minimum: int = 8) -> int:
        """Source-batch pad: a power-of-two bucket, rounded up to a multiple
        of the mesh's batch axis so the row slices are equal."""
        s_pad = _next_bucket(n, minimum=minimum)
        if self.mesh is not None:
            s_pad += (-s_pad) % self.mesh.shape["batch"]
        return s_pad

    def _place(self, make):
        """A persistent layout buffer: make(device) on the solve's device,
        or under a mesh one copy per distinct mesh device (a dict)."""
        if self.mesh is None:
            return make(self.device)
        return replicate(self.mesh, make)

    def _ov0(self) -> torch.Tensor:
        """The resident overload mask on the solve's (first) device."""
        st = self._dev
        if st is None:
            return upload(self.graph.overloaded, bool, self.device)
        ov = st["ov"]
        if isinstance(ov, list):  # tiled: one per rank
            return ov[0][0]
        return ov[self.device] if isinstance(ov, dict) else ov

    def _source_rows(self) -> np.ndarray:
        """Node ids of the batch, bucket-padded; padding rows repeat me's
        row (and so solve with me's transit mask)."""
        rows = np.array(
            [self.graph.node_index[s] for s in self.sources], dtype=np.int32
        )
        s_pad = self._batch_pad(len(rows), minimum=8)
        return np.concatenate(
            [rows, np.full(s_pad - len(rows), rows[0], dtype=np.int32)]
        )

    def _solve(self) -> None:
        # named fault seam: the supervisor's error-classification and
        # breaker tests inject faults here, where a kernel launch would
        # raise (the JAX package's name, so one fault script arms both)
        fault_point("solver.tpu.solve", self)
        me = self.me
        neighbors = sorted(
            {
                link.other_node_name(me)
                for link in self.link_state.links_from_node(me)
                if link.is_up()
            }
        )
        self.sources: List[str] = [me] + neighbors
        self.row_map: Dict[str, int] = {
            name: i for i, name in enumerate(self.sources)
        }
        rows = self._source_rows()
        inc_before = self.incremental_solves
        self._last_solve_delta = None  # set by a qualifying warm solve
        rec = self._recorder
        pc = self._pclock = rec.begin() if rec is not None else NULL_CLOCK
        h2d0, d2h0, halo0 = self.h2d_bytes, self.d2h_bytes, self.halo_bytes
        misses0 = (
            _cuda.compile_cache_stats()["misses"] if rec is not None else 0
        )
        t0 = time.perf_counter()
        self.h2d_bytes += rows.nbytes
        pc.seam("prepare")
        if self._use_tiled():
            st = self._dev
            self._admit_layout("tile2d", tiling=(
                st["tiling"] if st is not None and st["kind"] == "tile2d"
                and st["src_ref"] is self.graph.src else None))
            self._d_dev, self.rounds_last = self._tile_solve_resident(rows)
        elif self.graph.sell is not None:
            self._admit_layout("sell")
            self._d_dev, self.rounds_last = self._sell_solve_resident(rows)
        elif self.mesh is not None:
            # the edge-list layout under a mesh: cold, row-sharded, rounds
            # untracked, as in the reference
            self._admit_layout("replicated")
            self._d_dev = sharded_batched_spf(self.graph, rows, self.mesh)
            self.rounds_last = None
            self.full_solves += 1
            pc.seam("relax", self._d_dev)
        else:
            self._admit_layout("bf")
            self._d_dev, self.rounds_last = self._bf_solve_resident(rows)
        self._mem_register(
            "dist",
            (self._dev or {}).get("kind", "none"),
            arrays=(self._d_dev,),
        )
        # the round loops read a flag from the card every round, so the wall
        # time covers the device work
        self.solve_ms_last = (time.perf_counter() - t0) * 1e3
        self.last_solve_warm = self.incremental_solves > inc_before
        self.device_solves += 1
        if self._last_solve_delta is None:
            # cold or non-qualifying event: the host mirrors are stale and
            # the accumulated delta cannot describe the event; poison it
            # until the consumer takes it (and rebuilds in full)
            self._d_host = None
            self._mem_release("mirror")
            self._nh_links = None
            self._nh_mask = None
            self._delta_pending = None
        elif self._delta_pending is not None:
            self._delta_pending.update(int(c) for c in self._last_solve_delta)
        # KSP: (dest, k) -> traced edge-disjoint path set for src == me;
        # reset with the snapshot, so topology changes invalidate it
        self._ksp: Dict[Tuple[str, int], List[Path]] = {}
        # APSP staleness guard: an event that poisons the batch's warm
        # solve (cold start, patch overflow, structural rebuild, overload
        # change, a source-batch change) invalidates the resident all-pairs
        # matrix too; a warm event leaves it, and its own ensure() re-closes
        # the touched blocks
        if self.apsp is not None and not self.last_solve_warm:
            self.apsp.invalidate("batch_warm_poisoned")
        if rec is not None:
            kind = (self._dev or {}).get("kind") or (
                "replicated" if self.mesh is not None else "none"
            )
            self._last_trace = SolveTrace(
                seq=rec.next_seq(),
                ts=time.time(),
                area=self.link_state.area,
                node=self.me,
                event="solve",
                layout=kind,
                warm=self.last_solve_warm,
                solve_ms=self.solve_ms_last,
                rounds=self.rounds_last,
                invalidation_rounds=(
                    self.invalidation_rounds_last
                    if self.last_solve_warm
                    else None
                ),
                halo_exchanges=(
                    self.halo_exchanges_last if kind == "tile2d" else None
                ),
                h2d_bytes=self.h2d_bytes - h2d0,
                d2h_bytes=self.d2h_bytes - d2h0,
                halo_bytes=self.halo_bytes - halo0,
                delta_columns=(
                    len(self._last_solve_delta)
                    if self._last_solve_delta is not None
                    else None
                ),
                compile_cache_misses=(
                    _cuda.compile_cache_stats()["misses"] - misses0
                ),
                breaker_state=rec.breaker_state,
                sampled=pc.sampled,
                phases=dict(pc.phases),
            )
            rec.record(self._last_trace, pc)
        # corruption seam (ctx = this solve): the warm-state audit tests
        # perturb the resident D here to prove divergence detection works
        fault_point("solver.tpu.warm_d", self)

    def ensure_apsp(self) -> bool:
        """Bring the resident all-pairs matrix current with this solve's
        graph snapshot; False when APSP is off or the area exceeds the
        node cap."""
        if self.apsp is None:
            return False
        return self.apsp.ensure(self.graph)

    def _changed_edges(self, st: dict) -> np.ndarray:
        """Positions whose weight differs from the snapshot that produced
        the resident state: only the changelog's positions when the graph
        was patched from that snapshot, else a diff of the real edges."""
        g = self.graph
        if g.changed_edges is not None and g.parent_version == st["w_ver"]:
            cand = g.changed_edges
            changed = cand[st["w_host"][cand] != g.w[cand]]
        else:
            changed = np.nonzero(st["w_host"][: g.e] != g.w[: g.e])[0]
        st["w_ver"] = g.version  # the snapshot is current even if no diff
        return changed

    def _delta_ok(self, changed: np.ndarray, rows: np.ndarray) -> bool:
        """DeltaPath qualification: the route inputs besides D are my own
        out-link metrics (the nexthop triangle's weight column) and the
        transit mask, so an event touching either cannot be described by
        changed D columns alone."""
        return not np.any(self.graph.src[changed] == rows[0])

    def _sell_solve_resident(self, rows: np.ndarray):
        """Sliced-ELL solve against the resident buffers: (D [s_pad, n_pad]
        on the device, rounds).

        The first call (or a structural rebuild, seen by the identity of
        the src array) uploads the layout. Later events diff the weights
        and the overload mask against the resident snapshot and upload only
        the changed slots. A pure weight patch warm-starts (K5, K4, K1, K7);
        an overload toggle rides the same path, as weight increases on the
        newly overloaded nodes' out-edges."""
        g = self.graph
        sell = g.sell
        st = self._dev
        rows_t = torch.as_tensor(rows, device=self.device)
        if st is None or st["kind"] != "sell" or st["src_ref"] is not g.src:
            st = self._dev = {
                "kind": "sell",
                "src_ref": g.src,
                "nbrs": self._place(lambda dev: tuple(
                    upload(a, np.int32, dev) for a in sell.nbr)),
                "wgs": self._place(lambda dev: tuple(
                    upload(a, np.int32, dev) for a in sell.wg)),
                "ov": self._place(
                    lambda dev: upload(g.overloaded, bool, dev)),
                "w_host": g.w.copy(),
                "w_ver": g.version,
                "ov_host": g.overloaded.copy(),
                "rows": rows.copy(),
            }
            self.h2d_bytes += (
                sum(a.nbytes for a in sell.nbr)
                + sum(a.nbytes for a in sell.wg)
                + g.overloaded.nbytes
            )
            # under a mesh one copy per device: the ledger counts one, as
            # the JAX package counts a replicated array's logical size
            self._mem_register(
                "sell",
                "sell",
                arrays=(*_first(st["nbrs"]), *_first(st["wgs"]),
                        _first(st["ov"])),
            )
            # the fixed-capacity weight-patch slots (rowcol [nb, 64, 2] +
            # vals [nb, 64], int32): uploaded per patched event, but the
            # capacity is the layout's, so the ledger carries one entry
            # per sell generation
            self._mem_register(
                "patch", "sell", nbytes=len(sell.nbr) * _PATCH_SLOTS * 3 * 4
            )
        else:
            ov_changed = not np.array_equal(st["ov_host"], g.overloaded)
            ov_seed_edges = np.empty(0, dtype=np.int64)
            if ov_changed:
                # a newly overloaded node relays nothing: for every other
                # source its out-edges just rose to INF, so they seed the
                # invalidation like a metric increase; un-overloading only
                # adds paths and warm-starts as it is
                newly_on = np.nonzero(g.overloaded & ~st["ov_host"])[0]
                if len(newly_on):
                    ov_seed_edges = np.nonzero(
                        np.isin(g.src[: g.e], newly_on)
                    )[0]
                    # down edges (old weight INF) are never on the old DAG
                    ov_seed_edges = ov_seed_edges[
                        st["w_host"][ov_seed_edges] < INF
                    ]
                st["ov"] = self._place(
                    lambda dev: upload(g.overloaded, bool, dev))
                st["ov_host"] = g.overloaded.copy()
                self.h2d_bytes += g.overloaded.nbytes
            # the previous fixpoint describes the same problem only for the
            # same source batch (a flap next to me changes the rows)
            rows_same = np.array_equal(st["rows"], rows)
            st["rows"] = rows.copy()
            changed = self._changed_edges(st)
            if len(changed) or ov_changed:
                # classify against the weights that produced the resident D
                increased = changed[g.w[changed] > st["w_host"][changed]]
                st["w_host"][changed] = g.w[changed]
                inc_edges = (
                    np.concatenate([increased, ov_seed_edges])
                    if len(ov_seed_edges)
                    else increased
                )
                nb = len(sell.nbr)
                per_bucket = [
                    changed[sell.edge_bucket[changed] == k] for k in range(nb)
                ]
                fits_inc = all(
                    np.count_nonzero(sell.edge_bucket[inc_edges] == k)
                    <= _PATCH_SLOTS
                    for k in range(nb)
                )
                if all(len(sel) <= _PATCH_SLOTS for sel in per_bucket):
                    idx, vals = sell_patch_arrays(
                        sell, changed, g.w, _PATCH_SLOTS
                    )
                    self.h2d_bytes += idx.nbytes + vals.nbytes
                    idx_t = torch.as_tensor(idx, device=self.device)
                    vals_t = torch.as_tensor(vals, device=self.device)
                    if (
                        self.warm_start
                        and rows_same
                        and fits_inc
                        and self._d_dev is not None
                    ):
                        inc_idx, _ = sell_patch_arrays(
                            sell, inc_edges, g.w, _PATCH_SLOTS
                        )
                        self.h2d_bytes += inc_idx.nbytes
                        delta_ok = not ov_changed and self._delta_ok(
                            changed, rows
                        )
                        self._pclock.seam("h2d", idx_t, vals_t)
                        (
                            d,
                            st["wgs"],
                            rounds,
                            inv_rounds,
                            col_changed,
                            num_changed,
                        ) = _sell_solver_warm(
                            sell.shape_key(),
                            rows_t,
                            st["nbrs"],
                            st["wgs"],
                            st["ov"],
                            idx_t,
                            vals_t,
                            torch.as_tensor(inc_idx, device=self.device),
                            self._d_dev,
                            mesh=self.mesh,
                        )
                        self.incremental_solves += 1
                        self.invalidation_rounds_last = inv_rounds
                        self._pclock.seam("relax", d)
                        self._finish_delta(
                            col_changed, num_changed, d, delta_ok
                        )
                        return d, rounds
                    if len(changed):
                        self._pclock.seam("h2d", idx_t, vals_t)
                        d, st["wgs"], rounds = _sell_solver_patched(
                            sell.shape_key(),
                            rows_t,
                            st["nbrs"],
                            st["wgs"],
                            st["ov"],
                            idx_t,
                            vals_t,
                            mesh=self.mesh,
                        )
                        self.full_solves += 1
                        self._pclock.seam("relax", d)
                        return d, rounds
                    # overload-only event without a warm start: nothing to
                    # patch, plain cold solve below
                elif len(changed):
                    # more than _PATCH_SLOTS in some bucket: standalone
                    # scatters (K4 at this event's width), then cold
                    width = max(len(sel) for sel in per_bucket)
                    idx, vals = sell_patch_arrays(sell, changed, g.w, width)
                    self.h2d_bytes += idx.nbytes + vals.nbytes
                    for wgs in (st["wgs"].values() if self.mesh is not None
                                else (st["wgs"],)):
                        _sell_apply_patches(
                            wgs,
                            torch.as_tensor(idx, device=wgs[0].device),
                            torch.as_tensor(vals, device=wgs[0].device),
                        )
        self._pclock.seam("h2d", st["ov"], st["wgs"])
        d, rounds = _sell_solver_counted(
            sell.shape_key(), rows_t, st["nbrs"], st["wgs"], st["ov"],
            mesh=self.mesh,
        )
        self.full_solves += 1
        self._pclock.seam("relax", d)
        return d, rounds

    def _bf_solve_resident(self, rows: np.ndarray):
        """Edge-list solve against the resident buffers: (D [s_pad, n_pad]
        on the device, rounds or None). A weight-only event uploads the
        whole weight vector (the layout's native patch unit) and
        warm-starts (K6, K2, K7), with the increased edges classified on
        the card. The cold solve reports no rounds, as the reference's does
        not; an overload change solves cold."""
        g = self.graph
        st = self._dev
        rows_t = torch.as_tensor(rows, device=self.device)
        if st is None or st["kind"] != "bf" or st["src_ref"] is not g.src:
            up = to_device(g, self.device)
            st = self._dev = {
                "kind": "bf",
                "src_ref": g.src,
                **{k: up[k] for k in ("src", "dst", "csr", "w", "ov")},
                "w_host": g.w.copy(),
                "w_ver": g.version,
                "ov_host": g.overloaded.copy(),
                "rows": rows.copy(),
            }
            self.h2d_bytes += sum(
                st[k].numel() * st[k].element_size()
                for k in ("src", "dst", "csr", "w", "ov")
            )
            # the JAX package's planes and mask, and the port's csr
            self._mem_register(
                "bf",
                "bf",
                arrays=tuple(st[k] for k in ("src", "dst", "csr", "w", "ov")),
            )
        else:
            ov_changed = not np.array_equal(st["ov_host"], g.overloaded)
            rows_same = np.array_equal(st["rows"], rows)
            st["rows"] = rows.copy()
            changed = self._changed_edges(st)
            if ov_changed:
                st["ov"] = upload(g.overloaded, bool, self.device)
                st["ov_host"] = g.overloaded.copy()
                self.h2d_bytes += g.overloaded.nbytes
            if (
                self.warm_start
                and rows_same
                and not ov_changed
                and len(changed)
                and self._d_dev is not None
            ):
                w_new = upload(g.w, np.int32, self.device)
                self.h2d_bytes += g.w.nbytes
                delta_ok = self._delta_ok(changed, rows)
                self._pclock.seam("h2d", w_new)
                d, rounds, inv_rounds, col_changed, num_changed = (
                    _bf_solver_warm(
                        rows_t,
                        st["src"],
                        st["dst"],
                        w_new,
                        st["w"],
                        st["ov"],
                        self._d_dev,
                        st["csr"],
                    )
                )
                st["w"] = w_new
                st["w_host"] = g.w.copy()
                self.incremental_solves += 1
                self.invalidation_rounds_last = inv_rounds
                self._pclock.seam("relax", d)
                self._finish_delta(col_changed, num_changed, d, delta_ok)
                return d, rounds
            if len(changed):
                st["w"] = upload(g.w, np.int32, self.device)
                st["w_host"] = g.w.copy()
                self.h2d_bytes += g.w.nbytes
        self._pclock.seam("h2d", st["w"], st["ov"])
        d = _bf_fixpoint(
            rows_t, st["src"], st["dst"], st["w"], st["ov"], st["csr"]
        )
        self.full_solves += 1
        self._pclock.seam("relax", d)
        return d, None

    def _use_tiled(self) -> bool:
        """The destination-tiled layout serves when the mesh has a graph
        axis above one that divides n_pad; a graph axis of one has nothing
        to tile, and the row-sharded layouts keep it."""
        return (
            self.mesh is not None
            and self.mesh.shape["graph"] > 1
            and self.graph.n_pad % self.mesh.shape["graph"] == 0
        )

    def _account_halo(self, copies: HaloCopies) -> None:
        """Fold one tiled solve's ring traffic, as its ring counted the
        copies, into the halo counters: per hop every rank forwarded its
        frontier (ctr [S_l, h] int32) and its slot -> column map ([h]
        int32)."""
        self.halo_exchanges_last = copies.hops
        self.halo_bytes += copies.bytes

    def _tile_solve_resident(self, rows: np.ndarray):
        """Destination-tiled solve against resident per-rank buffers:
        (D `Sharded` [b][g] tiles [s_pad / batch, n_pad / graph], rounds).

        Each rank holds its tile and its partition's slice of the tiled
        edge arrays; no device holds the full destination axis. A weight or
        overload event uploads the whole [g, e_tile] tiled weights (the
        layout's patch unit) and answers warm (`_tile_solver_warm`: the
        device classifies increases against the resident weights; a newly
        overloaded node's out-edges seed like increases, and the repair
        uses the new transit mask). A structural rebuild or a source-batch
        change solves cold."""
        g = self.graph
        mesh = self.mesh
        g_ax = mesh.shape["graph"]
        st = self._dev
        if st is None or st["kind"] != "tile2d" or st["src_ref"] is not g.src:
            tiling = tile_graph(g, g_ax)
            st = self._dev = {
                "kind": "tile2d",
                "src_ref": g.src,
                "tiling": tiling,
                **tiling_ranks(tiling, mesh),
                "ov": rank_replicas(mesh, g.overloaded, bool),
                "w_host": g.w.copy(),
                "w_ver": g.version,
                "ov_host": g.overloaded.copy(),
                "rows": rows.copy(),
            }
            self.h2d_bytes += (
                tiling.src_l.nbytes + tiling.hseg.nbytes + tiling.w.nbytes
                + tiling.hcols.nbytes + tiling.hptr.nbytes
                + g.overloaded.nbytes
            )
            # the logical size, each partition's rows once (the ranks of a
            # graph column hold the same rows, and ov is replicated), as
            # the JAX package counts its sharded arrays; the tiling's host
            # arrays are the ranks' uploads, byte for byte. `tile` holds
            # the JAX package's planes and ov, and the port's hptr
            self._mem_register(
                "tile",
                "tile2d",
                arrays=(tiling.src_l, tiling.hseg, tiling.w, tiling.hptr,
                        g.overloaded),
            )
            self._mem_register("halo", "tile2d", arrays=(tiling.hcols,))
        else:
            tiling = st["tiling"]
            ov_changed = not np.array_equal(st["ov_host"], g.overloaded)
            rows_same = np.array_equal(st["rows"], rows)
            st["rows"] = rows.copy()
            changed = self._changed_edges(st)
            if (
                self.warm_start
                and rows_same
                and (len(changed) or ov_changed)
                and self._d_dev is not None
            ):
                w2_new = rank_rows(mesh, tiling.tile_weights(g.w), np.int32)
                self.h2d_bytes += tiling.w.nbytes
                ov_new = st["ov"]
                if ov_changed:
                    ov_new = rank_replicas(mesh, g.overloaded, bool)
                    self.h2d_bytes += g.overloaded.nbytes
                delta_ok = not ov_changed and self._delta_ok(changed, rows)
                # every rank's uploads and tiles: the ranks may lie on
                # several cards, and each of them is waited for
                self._pclock.seam("h2d", w2_new, ov_new)
                d, rounds, inv_rounds, col_changed, num_changed, copies = (
                    _tile_solver_warm(
                        tiling.shape_key() + (g.n_pad,), mesh,
                        rank_sources(mesh, rows), st["src_l"], st["hseg"],
                        st["hptr"], w2_new, st["w2"], st["hcols"], ov_new,
                        st["ov"], self._d_dev,
                    )
                )
                st["w2"] = w2_new
                st["w_host"] = g.w.copy()
                st["ov"] = ov_new
                st["ov_host"] = g.overloaded.copy()
                self.incremental_solves += 1
                self.invalidation_rounds_last = inv_rounds
                self._pclock.seam("relax", d)
                # the seed exchange, then one ring per mark and relax round
                self._account_halo(copies)
                self._finish_delta(col_changed, num_changed, d, delta_ok)
                return d, rounds
            if len(changed):
                st["w2"] = rank_rows(mesh, tiling.tile_weights(g.w), np.int32)
                st["w_host"] = g.w.copy()
                self.h2d_bytes += tiling.w.nbytes
            if ov_changed:
                st["ov"] = rank_replicas(mesh, g.overloaded, bool)
                st["ov_host"] = g.overloaded.copy()
                self.h2d_bytes += g.overloaded.nbytes
        self._pclock.seam("h2d", st["w2"], st["ov"])
        d, rounds, copies = _tile_solver(
            tiling.shape_key() + (g.n_pad,), mesh, rank_sources(mesh, rows),
            st["src_l"], st["hseg"], st["hptr"], st["w2"], st["hcols"],
            st["ov"],
        )
        self.full_solves += 1
        self._pclock.seam("relax", d)
        self._account_halo(copies)
        return d, rounds

    def _finish_delta(self, col_changed, num_changed, d_dev, delta_ok) -> None:
        """Complete a qualifying warm solve's DeltaPath extraction: read the
        changed-column count (4 bytes), size a compacted `_delta_extract`
        (K7), and patch the host mirrors (distance matrix and nexthop mask)
        in place. Sets self._last_solve_delta to the changed columns;
        leaving it None makes _solve treat the event as full (mirrors
        reset, accumulated delta poisoned)."""
        if not delta_ok:
            return
        num = int(num_changed)
        if num == 0:
            self._last_solve_delta = np.empty(0, dtype=np.int64)
            return
        g = self.graph
        if num > max(_PATCH_SLOTS, int(g.n_pad * _DELTA_MAX_FRAC)):
            return  # the full mirror is the cheaper copy-back
        names, rows_l, ws_l, _ = self._nh_link_arrays()
        ls = self.link_state
        ov_l = [ls.is_node_overloaded(nm) for nm in names]
        l_pad = _next_bucket(max(len(rows_l), 1), minimum=8)
        nh_rows = np.zeros(l_pad, dtype=np.int32)
        nh_ws = np.full(l_pad, INF, dtype=np.int32)  # padding never matches
        nh_rows[: len(rows_l)] = rows_l
        nh_ws[: len(ws_l)] = ws_l
        try:  # on the host copy: K7 reads the device copy unchecked
            check_nh_rows(nh_rows, d_dev.shape[0])
        except ValueError:
            # the solve has moved the resident weights but not D: the next
            # solve starts cold
            self._d_dev = None
            raise
        cap = _next_bucket(num, minimum=8)
        t0 = time.perf_counter()
        self.h2d_bytes += nh_rows.nbytes + nh_ws.nbytes
        nh_rows_t = torch.as_tensor(nh_rows, device=self.device)
        nh_ws_t = torch.as_tensor(nh_ws, device=self.device)
        if isinstance(d_dev, Sharded):
            # only the changed columns leave their ranks (per column block:
            # the tiled layout's graph ranks, or the row layout's one)
            cols_d, dcols_d, nh_d = _delta_extract_sharded(
                col_changed if isinstance(col_changed, list)
                else [col_changed],
                d_dev, nh_rows_t, nh_ws_t, cap=cap, device=self.device,
            )
        else:
            cols_d, dcols_d, nh_d = _delta_extract(
                col_changed, d_dev, nh_rows_t, nh_ws_t, cap=cap
            )
        cols = cols_d.cpu().numpy().copy()
        dcols = dcols_d.cpu().numpy().copy()
        nh = nh_d.cpu().numpy().copy()
        self.delta_extract_ms_last = (time.perf_counter() - t0) * 1e3
        self._pclock.seam("delta_extract")  # the copies above waited
        xfer = cols.nbytes + dcols.nbytes + nh.nbytes + 4  # + the count
        self.d2h_bytes += xfer
        self.delta_bytes += xfer
        self.delta_columns += num
        self.delta_extracts += 1
        valid = cols < g.n_pad
        cols_real = cols[valid].astype(np.int64)
        if self._d_host is not None:
            self._d_host[:, cols_real] = dcols[:, valid]
        if self._nh_mask is not None and self._nh_links == names:
            mask_cols = nh[: len(names)][:, valid]
            for i, (nm, is_ov) in enumerate(zip(names, ov_l)):
                if is_ov:
                    # an overloaded neighbour relays nothing: a first hop
                    # only toward itself
                    mask_cols[i] &= cols_real == g.node_index[nm]
            self._nh_mask[:, cols_real] = mask_cols
        elif self._nh_mask is not None:
            self._nh_mask = None  # the up-link set moved: rebuild lazily
            self._nh_links = None
        self._last_solve_delta = cols_real

    def take_route_delta(self) -> Optional[set]:
        """One-shot consumer handshake for the DeltaPath route build: the
        changed destination columns accumulated since the last take (empty
        when nothing moved), or None when a solve in between had no device
        delta, and the caller must rebuild in full (which re-arms the
        accumulation)."""
        out = self._delta_pending
        self._delta_pending = set()
        return out

    def _nh_link_arrays(
        self,
    ) -> Tuple[List[str], List[int], List[int], List[int]]:
        """(names, batch rows, metrics, node ids) of my ordered up-links —
        the nh_mask triangle inputs."""
        ls = self.link_state
        names: List[str] = []
        rows: List[int] = []
        ws: List[int] = []
        ids: List[int] = []
        for link in ls.ordered_links_from_node(self.me):
            if not link.is_up():
                continue
            n = link.other_node_name(self.me)
            r = self.row_map.get(n)
            if r is None:
                continue
            names.append(n)
            rows.append(r)
            ws.append(link.metric_from_node(self.me))
            ids.append(self.graph.node_index[n])
        return names, rows, ws, ids

    def nh_mask(self) -> Tuple[List[str], np.ndarray]:
        """(neighbour names, [L, n_pad] bool): entry [i, t] is True iff the
        i-th up-link from me is an ECMP first hop toward node t.

        Computed on the card by the triangle kernel over the solved rows
        (w(me,v) + D[v, t] == D[me, t], with overloaded neighbours valid
        only as final destinations); the host gets the [L, n_pad] mask."""
        if self._nh_mask is None:
            names, rows, ws, ids = self._nh_link_arrays()
            if not names:
                self._nh_links = []
                self._nh_mask = np.zeros((0, self.graph.n_pad), dtype=bool)
                return self._nh_links, self._nh_mask

            def up(a):
                return torch.as_tensor(
                    np.asarray(a, dtype=np.int32), device=self.device
                )

            d, ru, rv = self._d_dev, np.zeros(len(rows)), rows
            if isinstance(d, Sharded):
                # only me's row and the up-link rows leave their ranks
                d = d.rows([0, *rows], self.device)
                rv = np.arange(1, len(rows) + 1)
            mask = ecmp_triangle(
                d, up(ru), up(rv), up(ids), up(ws), self._ov0(),
            )
            self._nh_mask = mask.cpu().numpy().copy()
            self._nh_links = names
            self.h2d_bytes += 16 * len(names)
            self.d2h_bytes += self._nh_mask.nbytes
        return self._nh_links, self._nh_mask

    # -- KSP (k-edge-disjoint shortest paths), device-batched ------------

    def kth_paths(self, dest: str, k: int) -> List[Path]:
        cached = self._ksp.get((dest, k))
        if cached is None:
            self.prefetch_ksp([dest], k)
            cached = self._ksp[(dest, k)]
        return cached

    def prefetch_ksp(self, dests: List[str], k: int) -> None:
        """Solve and trace the k-th path set of every dest in one device
        call. The reference runs one penalized Dijkstra per destination
        (LinkState.cpp:777-780); here each destination's penalized solve is
        one batch row of a per-row-weights fixpoint, all rows sourced at me.

        Warm (`warm_start`): every row starts from me's resident base row,
        materialised as a contiguous [s_pad, n_pad] copy of row 0 of the
        resident D (s_pad * n_pad * 4 bytes) because K5, K6 and K8 read a
        row-major buffer. The resident weights are the base weights of
        that D and are never patched here."""
        assert k >= 1
        idx = self.graph.node_index
        todo = [
            d
            for d in dests
            if (d, k) not in self._ksp and d != self.me and d in idx
        ]
        for d in dests:
            if (d, k) not in self._ksp and (d == self.me or d not in idx):
                self._ksp[(d, k)] = []
        if not todo:
            return
        if k == 1:
            # row 0 of the base solve is me with the unpenalized weights
            for dest in todo:
                self._ksp[(dest, 1)] = _trace_paths(
                    self.link_state, self.graph, self.d[0], self.me, dest,
                    set(),
                )
            return
        self.prefetch_ksp(todo, k - 1)

        # per-dest ignore set = links used by path sets 1..k-1
        ignores: List[Set[Link]] = []
        for dest in todo:
            ig: Set[Link] = set()
            for i in range(1, k):
                for path in self._ksp[(dest, i)]:
                    ig.update(path)
            ignores.append(ig)

        # the batch is padded to a power of two (and to a multiple of the
        # mesh's batch axis); filler rows solve unpenalized
        s_pad = self._batch_pad(len(todo), minimum=1)
        sources = np.full(s_pad, idx[self.me], dtype=np.int32)
        st = self._dev
        warm_prev = None
        if self.warm_start and self.mesh is None and self._d_dev is not None:
            warm_prev = self._d_dev[0:1].expand(s_pad, -1).contiguous()
        if self.mesh is not None:
            # cold and row-sharded, as in the reference: the tiled layout
            # keeps no sliced buffers, so its masked solve uploads them
            if self.graph.sell is not None:
                mask_positions = []
                for ig in ignores:
                    pos = []
                    for link in ig:
                        pos.extend(self.graph.link_edges[link])
                    mask_positions.append(pos)
                mask_positions.extend([[] for _ in range(s_pad - len(todo))])
                d_dev = sell_fixpoint_masked(
                    self.graph.sell,
                    sources,
                    self.graph.overloaded,
                    mask_positions,
                    device_arrays=(
                        (st["nbrs"], st["wgs"], st["ov"])
                        if st is not None and st["kind"] == "sell" else None
                    ),
                    mesh=self.mesh,
                )
            else:
                w_rows = np.tile(self.graph.w, (s_pad, 1))
                for row, ig in enumerate(ignores):
                    for link in ig:
                        fwd, rev = self.graph.link_edges[link]
                        w_rows[row, fwd] = INF
                        w_rows[row, rev] = INF
                self.h2d_bytes += w_rows.nbytes
                self._mem_register("ksp", "vw", arrays=(w_rows,))
                d_dev = batched_spf_vw(
                    self.graph, sources, w_rows, mesh=self.mesh
                )
        elif self.graph.sell is not None:
            # sliced layout: the ignores become per-column masks on the
            # resident buffers (uploaded as [Mk, 3] lists, not counted in
            # h2d_bytes, as the reference does not count them)
            mask_positions: List[List[int]] = []
            for ig in ignores:
                pos: List[int] = []
                for link in ig:
                    fwd, rev = self.graph.link_edges[link]
                    pos.extend((fwd, rev))
                mask_positions.append(pos)
            mask_positions.extend([[] for _ in range(s_pad - len(todo))])
            d_dev = sell_fixpoint_masked(
                self.graph.sell,
                sources,
                self.graph.overloaded,
                mask_positions,
                device_arrays=(st["nbrs"], st["wgs"], st["ov"]),
                d_prev=warm_prev,
                device=self.device,
            )
            if warm_prev is not None:
                self.ksp_warm_batches += 1
        else:
            w_rows = np.tile(self.graph.w, (s_pad, 1))
            for row, ig in enumerate(ignores):
                for link in ig:
                    fwd, rev = self.graph.link_edges[link]
                    w_rows[row, fwd] = INF
                    w_rows[row, rev] = INF
            self.h2d_bytes += w_rows.nbytes
            # the per-row weights [s_pad, e_pad] are the batch's transient
            # structure, registered while it runs
            self._mem_register("ksp", "vw", arrays=(w_rows,))
            if warm_prev is not None:
                fault_point("ops.spf.batched_spf_vw", self.graph)
                d_dev, _rounds, _inv = _bf_warm_vw_core(
                    torch.as_tensor(sources, device=self.device),
                    st["src"],
                    st["dst"],
                    torch.as_tensor(w_rows, device=self.device),
                    st["w"],
                    st["ov"],
                    warm_prev,
                    st["csr"],
                )
                self.ksp_warm_batches += 1
            else:
                d_dev = batched_spf_vw(
                    self.graph, sources, w_rows, device=self.device
                )
        # the penalized rows are consumed on the host by the greedy
        # back-trace: a real copy-back
        d_rows = to_host(d_dev)
        self.d2h_bytes += d_rows.nbytes
        self._mem_release("ksp")
        self.ksp_device_batches += 1

        for row, (dest, ig) in enumerate(zip(todo, ignores)):
            self._ksp[(dest, k)] = _trace_paths(
                self.link_state, self.graph, d_rows[row], self.me, dest, ig
            )

    def refresh(self) -> None:
        """Re-solve against the current LinkState snapshot if it moved, or
        if the last solve raised: the graph was patched before that solve,
        so without the mark the next call would find it current and serve
        the D from before the event (the JAX package's refresh does)."""
        if self.graph.version != self.link_state.version:
            self.graph = refresh_graph(self.graph, self.link_state)
        elif not self._solve_failed:
            return
        self._solve_failed = True
        self._solve()
        self._solve_failed = False

    def cold_reference_d(self) -> np.ndarray:
        """A cold solve from the host-side graph (the compiled arrays that
        refresh_graph keeps current), independent of the resident buffers
        and distances: the warm-state audit's comparator."""
        rows = self._source_rows()
        cold = (
            batched_spf(self.graph, rows, device=self.device)
            .cpu()
            .numpy()
            .copy()
        )
        self.d2h_bytes += cold.nbytes
        return cold


def _trace_paths(
    link_state: LinkState,
    graph: CompiledGraph,
    d_row: np.ndarray,
    src: str,
    dest: str,
    ignore: Set[Link],
) -> List[Path]:
    """Greedy edge-disjoint path enumeration from a single-source distance
    row, equivalent to tracing the Dijkstra SPF DAG (LinkState.cpp:398-419):
    path links into v are the up, non-ignored links from nodes u with d(u)
    + w(u->v) == d(v) that offer transit, ordered by u's settle order
    ((d(u), u), valid since metrics are >= 1) then by u's sorted link
    order."""
    idx = graph.node_index
    dd = d_row.tolist()
    dcol = idx.get(dest)
    if dcol is None or dd[dcol] >= INF:
        return []

    path_links: Dict[str, List[Tuple[Link, str]]] = {}

    def pl(v: str) -> List[Tuple[Link, str]]:
        cached = path_links.get(v)
        if cached is not None:
            return cached
        vi = idx[v]
        out: List[Tuple[Link, str]] = []
        for link in link_state.ordered_links_from_node(v):
            if not link.is_up() or link in ignore:
                continue
            u = link.other_node_name(v)
            ui = idx.get(u)
            if ui is None or dd[ui] >= INF:
                continue
            if u != src and link_state.is_node_overloaded(u):
                continue
            if dd[ui] + link.metric_from_node(u) == dd[vi]:
                out.append((link, u))
        out.sort(key=lambda t: (dd[idx[t[1]]], t[1], t[0]))
        path_links[v] = out
        return out

    visited: Set[Link] = set()

    def trace_one(node: str) -> Optional[Path]:
        if node == src:
            return []
        for link, prev in pl(node):
            if link not in visited:
                visited.add(link)
                sub = trace_one(prev)
                if sub is not None:
                    sub.append(link)
                    return sub
        return None

    paths: List[Path] = []
    path = trace_one(dest)
    while path:
        paths.append(path)
        path = trace_one(dest)
    return paths


class CudaSpfSolver(SpfSolver):
    """SpfSolver with the batched device distance backend.

    device: "cuda" (default) runs the hand-written kernels and raises when
    no card is present; "cpu" runs their plain PyTorch versions.
    warm_start: answer weight-only events from the resident fixpoint
    (default), or solve every event cold.
    apsp_max_nodes: areas of up to this many nodes keep a resident
    all-pairs matrix, which answers sources outside the batch (0: off).
    apsp_audit_interval: shadow-audit every Nth close of that matrix
    against the numpy Floyd–Warshall (0: never).
    mesh: None (one device), a `parallel.Mesh`, or a (batch, graph) shape
    laid over the first batch * graph cards; resolved here, so a shape that
    does not fit the cards fails at construction. Its devices must be of
    `device`'s type.

    What degrades, and through what: nothing here falls back by itself. A
    failing solve or all-pairs close raises. Under `SolverSupervisor`
    (Decision's default) the supervisor classifies the fault, retries,
    trips its breaker and serves the CPU oracle's route dbs; the all-pairs
    closes run through `attach_supervisor`'s dispatch hook, with the numpy
    Floyd–Warshall as their degraded path (`fallback_closes`); every
    degraded answer is counted (`decision.spf.fallback_*`) and shown by
    `health()`. A kernel fault (a kernel that does not build, a launch the
    runtime refuses, a fault on the card: `supervisor.is_kernel_fault`)
    degrades nothing: the supervisor raises it to the caller.

    Capacity: the ledger reads the card's memory only once CUDA is
    initialised on it. On the card the solver initialises CUDA when it is
    made, so every layout admission, the first included, is judged against
    the card's total memory; without a card (and without an override) no
    admission has a verdict and the all-pairs gate is the node cap. A
    refused layout raises DeviceCapacityError (the supervisor's
    `device_oom`); refusals queue for `take_capacity_refusals`."""

    def __init__(
        self,
        *args,
        device: DeviceLike = "cuda",
        warm_start: bool = True,
        apsp_max_nodes: int = 0,
        apsp_audit_interval: int = 0,
        mesh=None,
        **kwargs,
    ) -> None:
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)
        self.mesh = resolve_mesh(mesh, self.device)
        if self.mesh is not None and any(
            d.type != self.device.type for d in self.mesh.devices.flat
        ):
            raise ValueError(
                f"mesh devices {list(self.mesh.devices.flat)} are not "
                f"{self.device.type} devices"
            )
        if self.device.type == "cuda":
            # the ledger's capacity source is the card's memory once CUDA
            # is initialised: do it before the first admission
            torch.cuda.init()
        # device-memory ledger, with the kernel libraries as an
        # informational row; capacity refusals queue here until the
        # supervisor drains them into SOLVER_CAPACITY_REFUSED samples
        self._ledger = get_ledger()
        self._ledger.attach_external(
            "compile_cache", _cuda.compile_cache_memory
        )
        self._capacity_refusals: List[Dict] = []
        # flight recorder, attached by the supervisor before the first
        # solve; every _AreaSolve records its SolveTraces into it
        self._recorder = None
        self.warm_start = warm_start
        self.apsp_max_nodes = apsp_max_nodes
        self.apsp_audit_interval = apsp_audit_interval
        self.apsp_close_ms_last: Optional[float] = None
        # (area name, node) -> (LinkState identity, solve); keyed by the
        # stable area name so a replaced LinkState for the same area
        # overwrites its predecessor
        self._solves: Dict[Tuple[str, str], Tuple[int, _AreaSolve]] = {}
        self.device_solves = 0  # counter: batched device solves
        # SPF answers served by host Dijkstra (sources outside the batch,
        # areas without me); the main path keeps this at 0
        self.host_spf_calls = 0
        self.solve_ms_last: Optional[float] = None
        self.delta_extract_ms_last: Optional[float] = None
        # set by SolverSupervisor.attach_supervisor: the all-pairs closes
        # dispatch through its fault domain (classified errors feed the
        # shared breaker, the numpy Floyd–Warshall is their degraded path)
        self._supervisor = None

    def attach_supervisor(self, supervisor) -> None:
        """Wire the solver fault domain into the non-solve device work of
        this backend (the all-pairs closes). Called by
        SolverSupervisor.__init__, before the first solve."""
        self._supervisor = supervisor

    def attach_recorder(self, recorder) -> None:
        """Wire the solver flight recorder into every area solve. Called by
        SolverSupervisor.__init__ before the first solve."""
        self._recorder = recorder

    def _note_capacity_refusal(self, verdict: Dict) -> None:
        """Queue an admission refusal for the supervisor's
        SOLVER_CAPACITY_REFUSED sample."""
        self._capacity_refusals.append(dict(verdict))

    def take_capacity_refusals(self) -> List[Dict]:
        """Drain the queued capacity refusals."""
        out, self._capacity_refusals = self._capacity_refusals, []
        return out

    def _apsp_dispatch(self, op: str, primary_fn, fallback_fn):
        """ApspState dispatch hook, installed only under a supervisor:
        classified faults feed the shared breaker and the numpy close
        serves degraded. The JAX package's bare try/except for the
        unsupervised case is not copied: without a supervisor no hook is
        installed and a failed close raises."""
        return self._supervisor.supervised_call(op, primary_fn, fallback_fn)

    def _area_solve(
        self, link_state: LinkState, node: str
    ) -> Optional[_AreaSolve]:
        """The cached device solve for this area, or None when the node is
        not present in this area's graph (multi-area: host fallback)."""
        if not link_state.has_node(node) and not link_state.links_from_node(
            node
        ):
            return None
        key = (link_state.area, node)
        cached = self._solves.get(key)
        if cached is not None and cached[0] == id(link_state):
            solve = cached[1]
            before = solve.device_solves
            inc0, full0 = solve.incremental_solves, solve.full_solves
            solve.refresh()
            self.device_solves += solve.device_solves - before
            self._sync_spf_counters(solve, inc0, full0)
            return solve
        if cached is not None:
            # a replaced LinkState for the same area: release the stale
            # solve's structures before the rebuild
            cached[1].close()
        solve = _AreaSolve(
            link_state,
            node,
            self.device,
            warm_start=self.warm_start,
            apsp_max_nodes=self.apsp_max_nodes,
            apsp_audit_interval=self.apsp_audit_interval,
            mesh=self.mesh,
            apsp_dispatch=(
                self._apsp_dispatch if self._supervisor is not None else None
            ),
            recorder=self._recorder,
            on_capacity_refusal=self._note_capacity_refusal,
        )
        self.device_solves += solve.device_solves
        self._sync_spf_counters(solve, 0, 0)
        self._solves[key] = (id(link_state), solve)
        return solve

    def _sync_spf_counters(
        self, solve: _AreaSolve, inc0: int, full0: int
    ) -> None:
        """Fold an _AreaSolve's stats into the decision.spf.* counters and
        histograms: incremental and full solves, transfer and delta bytes
        are monotonic; rounds and invalidation rounds are gauges of the
        most recent solve that reported them; solve wall time lands in the
        warm/cold-split latency histograms."""
        counters = self._ensure_counters()
        d_inc = solve.incremental_solves - inc0
        d_full = solve.full_solves - full0
        if d_inc:
            self._bump("decision.spf.incremental_solves", d_inc)
        if d_full:
            self._bump("decision.spf.full_solves", d_full)
        if solve.rounds_last is not None:
            counters["decision.spf.rounds_last"] = solve.rounds_last
        if solve.invalidation_rounds_last is not None:
            counters["decision.spf.invalidation_rounds_last"] = (
                solve.invalidation_rounds_last
            )
        if (d_inc or d_full) and solve.solve_ms_last is not None:
            self.solve_ms_last = solve.solve_ms_last
            self._observe("decision.spf.solve_ms", solve.solve_ms_last)
            self._observe(
                "decision.spf.solve_warm_ms"
                if solve.last_solve_warm
                else "decision.spf.solve_cold_ms",
                solve.solve_ms_last,
            )
        # the lazy d mirror fetch lands on the NEXT sync: it happens after
        # this call, when the route pipeline first reads solve.d
        d_h2d = solve.h2d_bytes - solve._h2d_synced
        if d_h2d:
            solve._h2d_synced = solve.h2d_bytes
            self._bump("decision.spf.host_to_device_bytes", d_h2d)
        d_d2h = solve.d2h_bytes - solve._d2h_synced
        if d_d2h:
            solve._d2h_synced = solve.d2h_bytes
            self._bump("decision.spf.device_to_host_bytes", d_d2h)
        d_cols = solve.delta_columns - solve._delta_cols_synced
        if d_cols:
            solve._delta_cols_synced = solve.delta_columns
            self._bump("decision.spf.delta_columns", d_cols)
        d_bytes = solve.delta_bytes - solve._delta_bytes_synced
        if d_bytes:
            solve._delta_bytes_synced = solve.delta_bytes
            self._bump("decision.spf.delta_bytes", d_bytes)
        # the tiled layout's halo traffic: ring hops of the last solve
        # (gauge) and the frontier bytes moved between ranks (cumulative)
        d_halo = solve.halo_bytes - solve._halo_synced
        if d_halo:
            solve._halo_synced = solve.halo_bytes
            self._bump("decision.spf.halo_bytes", d_halo)
        if solve.halo_exchanges_last is not None:
            counters["decision.spf.halo_exchanges_last"] = (
                solve.halo_exchanges_last
            )
        if (
            solve.delta_extracts > solve._delta_extracts_synced
            and solve.delta_extract_ms_last is not None
        ):
            solve._delta_extracts_synced = solve.delta_extracts
            self.delta_extract_ms_last = solve.delta_extract_ms_last
            self._observe(
                "decision.spf.delta_extract_ms", solve.delta_extract_ms_last
            )
        # the recorder's sampled phases land in the decision.spf.phase.*_ms
        # histograms, and its ring accounting rides the counters
        rec = self._recorder
        if rec is not None:
            for hist_name, value in rec.drain_observations():
                self._observe(hist_name, value)
            counters["decision.spf.traces_recorded"] = rec.recorded
            counters["decision.spf.traces_evicted"] = rec.evicted
            counters["decision.spf.traces_sampled"] = rec.sampled_solves
        self._sync_apsp_counters(solve)
        # the kernel libraries this process built (misses) and loaded
        # built already (hits): ops/_cuda.py
        stats = _cuda.compile_cache_stats()
        counters["decision.spf.compile_cache_hits"] = stats["hits"]
        counters["decision.spf.compile_cache_misses"] = stats["misses"]
        # the ledger's decision.mem.* counters, on the same cadence
        self._ledger.fold_counters(counters)

    def _sync_apsp_counters(self, solve: _AreaSolve) -> None:
        """Fold the solve's APSP and KSP-warm stats into the decision.spf.*
        counters, at the end of every sync as the reference does: close
        counts split warm/cold/fallback, staleness invalidations, shadow
        audits, transfer bytes (monotonic), the re-close round gauge and
        the close-latency histogram. KSP batches and APSP closes run during
        the route build, after the sync: they reach the counters at the
        next one."""
        counters = self._ensure_counters()
        d_ksp = solve.ksp_warm_batches - solve._ksp_warm_synced
        if d_ksp:
            solve._ksp_warm_synced = solve.ksp_warm_batches
            self._bump("decision.spf.ksp_warm_batches", d_ksp)
        apsp = solve.apsp
        if apsp is None:
            return
        if apsp.close_ms_last is not None:
            self.apsp_close_ms_last = apsp.close_ms_last
        d_closes = apsp.closes - apsp._closes_synced
        if d_closes:
            apsp._closes_synced = apsp.closes
            self._bump("decision.spf.apsp_closes", d_closes)
            if apsp.close_ms_last is not None:
                self._observe(
                    "decision.spf.apsp_close_ms", apsp.close_ms_last
                )
        for attr, name in (
            ("warm_closes", "decision.spf.apsp_warm_closes"),
            ("cold_closes", "decision.spf.apsp_cold_closes"),
            ("fallback_closes", "decision.spf.apsp_fallback_closes"),
            ("invalidations", "decision.spf.apsp_invalidations"),
            ("audit_runs", "decision.spf.apsp_audit_runs"),
            ("audit_mismatches", "decision.spf.apsp_audit_mismatches"),
            ("h2d_bytes", "decision.spf.apsp_h2d_bytes"),
            ("d2h_bytes", "decision.spf.apsp_d2h_bytes"),
        ):
            value = getattr(apsp, attr)
            synced = apsp._sync_marks.get(attr, 0)
            if value > synced:
                apsp._sync_marks[attr] = value
                self._bump(name, value - synced)
        if apsp.reclose_rounds_last is not None:
            counters["decision.spf.apsp_reclose_rounds_last"] = (
                apsp.reclose_rounds_last
            )

    def poll_device_delta(
        self, area_link_states: Dict[str, LinkState]
    ) -> Optional[Set[str]]:
        """Refresh every area's device solve against the current LSDB and
        return the union of changed destination node names, if every area
        event since the last poll rode the device delta path. None means
        some event had no device delta (cold solve, overload change, an
        event at me, a bulk event): the caller must rebuild the full route
        db, which re-arms the accumulation. Areas without this node are
        skipped.

        Under `compute_lfa_paths` the ME column feeds every destination's
        RFC 5286 threshold, so a changed set that contains me answers None."""
        me = self.my_node_name
        changed: Set[str] = set()
        ok = True
        for link_state in area_link_states.values():
            solve = self._area_solve(link_state, me)
            if solve is None:
                continue
            cols = solve.take_route_delta()
            if cols is None:
                ok = False  # keep draining the other areas' pending state
                continue
            names = solve.graph.names
            changed.update(names[c] for c in cols if c < len(names))
        if ok and self.compute_lfa_paths and me in changed:
            return None
        return changed if ok else None

    def lfa_delta_ready(self) -> bool:
        """DeltaPath-under-LFA gate (solver/delta.py): True when every
        resident area solve carries an all-pairs state within its node cap
        (the LFA checks of alternate neighbours read its rows, and
        poll_device_delta poisons an event that moves the me column).
        Otherwise the delta build keeps the force-full behaviour under
        LFA."""
        if self.apsp_max_nodes <= 0 or not self._solves:
            return False
        return all(
            solve.apsp is not None and solve.apsp.enabled_for(solve.graph)
            for _, solve in self._solves.values()
        )

    def borrow_apsp(self, area: str, version: int) -> Optional[np.ndarray]:
        """TE hard-scoring borrow: the exact [n, n] distance matrix for this
        area's CURRENT weights, or None when no fresh matrix can serve:
        another snapshot version, APSP off or the area past the node cap,
        or overloaded (drained) nodes present, whose per-source transit
        masks TE's pinned out-edges do not reproduce."""
        cached = self._solves.get((area, self.my_node_name))
        if cached is None:
            return None
        solve = cached[1]
        g = solve.graph
        if g.version != version or np.any(g.overloaded[: g.n]):
            return None
        if not solve.ensure_apsp():
            return None
        return solve.apsp.d[: g.n, : g.n]

    def degrade_mesh(self) -> bool:
        """Partial-mesh degradation: move to the largest strictly smaller
        (batch, graph) mesh over the devices still answering a probe.
        Returns whether one was installed; False when none is left (no
        mesh, or a one-device mesh). Warm state cannot be re-tiled across
        mesh shapes (tile ownership and frontier slots follow the
        factorization), so every cached solve is dropped and the next event
        solves cold on the new mesh."""
        if self.mesh is None:
            return False
        new_mesh = plan_degraded_mesh(self.mesh)
        if new_mesh is None:
            return False
        self.mesh = new_mesh
        self._close_solves()
        counters = self._ensure_counters()
        self._bump("decision.spf.mesh_degradations")
        counters["decision.spf.mesh_devices"] = int(new_mesh.devices.size)
        return True

    def invalidate_warm_state(self) -> None:
        """Drop every cached device solve: the next build_route_db compiles
        the graph again and solves cold. The supervisor calls this on
        breaker trips, probes and audit mismatches: after a device fault or
        a detected divergence the resident buffers are not to be
        trusted."""
        self._close_solves()
        self._bump("decision.spf.warm_state_invalidations")

    def close(self) -> None:
        """Solver teardown (Decision.stop): drop every resident solve and
        its all-pairs matrix, so the card's buffers are freed and the
        ledger's entries released. Entries pinned by the
        `solver.mem.retain` fault survive by design: that is the leak the
        ledger exists to show."""
        self._close_solves()

    def _close_solves(self) -> None:
        """Drop every cached solve, releasing its ledger entries first:
        teardown returns the ledger to its baseline."""
        for _, solve in self._solves.values():
            solve.close()
        self._solves.clear()
        self._ledger.fold_counters(self._ensure_counters())

    def audit_warm_state(self) -> List[dict]:
        """Shadow cold audit of every resident solve: recompute each area's
        distance matrix from the host-side graph and compare it entrywise
        with the warm one. Returns one record per diverged area (empty when
        all are clean)."""
        mismatches: List[dict] = []
        for (area, node), (_, solve) in self._solves.items():
            cold = solve.cold_reference_d()
            warm = solve.d
            if warm.shape == cold.shape and np.array_equal(warm, cold):
                continue
            if warm.shape != cold.shape:
                entries = max_abs = -1
            else:
                entries = int((warm != cold).sum())
                max_abs = int(
                    np.abs(
                        warm.astype(np.int64) - cold.astype(np.int64)
                    ).max()
                )
            mismatches.append(
                {
                    "area": area,
                    "node": node,
                    "entries": entries,
                    "max_abs_delta": max_abs,
                }
            )
        return mismatches

    # -- SPF access seam -------------------------------------------------

    def _spf(self, link_state: LinkState, node: str):
        solve = self._area_solve(link_state, self.my_node_name)
        if solve is not None and node in solve.row_map:
            return _CudaSpfResult(solve, node)
        # a source outside the batch: the resident all-pairs matrix serves
        # its whole row
        if (
            solve is not None
            and node in solve.graph.node_index
            and solve.ensure_apsp()
        ):
            return _ApspSpfResult(solve, node)
        self.host_spf_calls += 1
        return link_state.get_spf_result(node)

    def _dist(self, link_state: LinkState, a: str, b: str) -> Optional[Metric]:
        if a == b:
            return 0
        solve = self._area_solve(link_state, self.my_node_name)
        if solve is not None:
            row = solve.row_map.get(a)
            col = solve.graph.node_index.get(b)
            if row is not None and col is not None:
                metric = int(solve.d[row, col])
                return metric if metric < INF else None
            if (
                col is not None
                and a in solve.graph.node_index
                and solve.ensure_apsp()
            ):
                metric = int(solve.apsp.d[solve.graph.node_index[a], col])
                return metric if metric < INF else None
        self.host_spf_calls += 1
        return link_state.get_metric_from_a_to_b(a, b)

    def _kth_paths(
        self, link_state: LinkState, src: str, dest: str, k: int
    ) -> List[Path]:
        solve = self._area_solve(link_state, self.my_node_name)
        if solve is None or src != self.my_node_name:
            self.host_spf_calls += 1
            return link_state.get_kth_paths(src, dest, k)
        return solve.kth_paths(dest, k)

    def _prefetch_kth_paths(
        self, link_state: LinkState, src: str, dests: List[str], k: int
    ) -> None:
        solve = self._area_solve(link_state, self.my_node_name)
        if solve is not None and src == self.my_node_name:
            solve.prefetch_ksp(dests, k)
