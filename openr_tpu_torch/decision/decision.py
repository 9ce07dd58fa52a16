"""Decision module: consumes KvStore publications, maintains per-area
LinkState + global PrefixState, debounces, solves, emits route deltas.

Behavioral port of openr/decision/Decision.{h,cpp} module shell:
  - processPublication (Decision.cpp:1631-1763): 'adj:<node>' values update
    the area's LinkState (with ordered-FIB holds when enabled);
    'prefix:...' values update PrefixState (per-node or per-prefix keys);
    expired keys delete the corresponding db.
  - pending-updates batch tracker (Decision.h:95-207): counts + the perf
    event trace of the oldest event in the batch.
  - debounced rebuild (AsyncDebounce, Decision.cpp:1406) between
    debounce_min and debounce_max.
  - cold-start timer (eor_time_s) delays the first computation so the LSDB
    can fill after restart (Decision.cpp:1353-1359).
  - RibPolicy applied to unicast routes before emission
    (Decision.cpp:1831-1865), with TTL expiry re-emission.
  - solver backend selected by config: 'cpu' oracle or 'cuda' batched
    (the BASELINE.json north-star plugin seam).

Port of the JAX package's decision/decision.py. What the device demands
changed: `solver_backend` takes "cpu" or "cuda" and raises ValueError on
any other string (the reference gives the CPU oracle to any string that
is not "tpu", which in the port would hide the card); "cuda" builds
`CudaSpfSolver` on `solver_device` ("cuda" by default, "cpu" runs its
plain PyTorch versions), under the `SolverSupervisor` unless
`solver_supervised` is off; "cuda" is the default. TE runs on the same
device. Degraded answers come from the supervisor alone; unsupervised, a
device fault raises into `rebuild_routes`, which counts and retries it as
the reference does. A kernel fault (one that does not build, a refused
launch, a fault on the card: `solver.supervisor.is_kernel_fault`) passes
the supervisor and raises out of `rebuild_routes` and `run_te_optimize`,
counted in `decision.route_build_errors` / `decision.te.optimize_errors`:
no answer of the host stands in for a kernel that fails.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from openr_tpu_torch.lsdb import LinkState, PrefixState
from openr_tpu_torch.messaging import QueueClosedError, RQueue, ReplicateQueue
from openr_tpu_torch.monitor.spans import Span
from openr_tpu_torch.solver import (
    DecisionRouteDb,
    DecisionRouteUpdate,
    DeltaRouteBuilder,
    CudaSpfSolver,
    SolverSupervisor,
    SpfSolver,
    SupervisorConfig,
    get_route_delta,
)
from openr_tpu_torch.solver.rib_policy import RibPolicy
from openr_tpu_torch.solver.supervisor import is_kernel_fault
from openr_tpu_torch.types import (
    ADJ_DB_MARKER,
    PREFIX_DB_MARKER,
    AdjacencyDatabase,
    PerfEvents,
    PrefixDatabase,
    Publication,
    parse_prefix_key,
)
from openr_tpu_torch.utils import AsyncDebounce
from openr_tpu_torch.utils.counters import CountersMixin, HistogramsMixin
from openr_tpu_torch.utils.ownership import owned_by
from openr_tpu_torch.utils import serializer

import dataclasses
import functools


@functools.lru_cache(maxsize=65536)
def _loads_cached(data: bytes):
    """Shared LSDB value decode cache.

    KvStore re-floods the same serialized value many times (full syncs
    after restart; every node of an in-process emulation decoding the same
    bytes). Decoded objects MUST be treated as immutable by all consumers
    — Decision copies before its one mutation (area stamping)."""
    return serializer.loads(data)


def _adjacencies_to_me_changed(
    prior_db: Optional[AdjacencyDatabase],
    adj_db: AdjacencyDatabase,
    me: str,
) -> bool:
    """DeltaPath qualification for a neighbor's adjacency update.

    My route inputs beyond distances (nexthop addresses, my link up/down,
    my triangle weights) can only move when the neighbor's adjacencies TO
    ME changed: the LinkState ordered diff applies only the advertising
    node's own direction, so a far-side-only update leaves every link to
    me byte-identical. Compares exactly the fields that diff consumes; a
    node with no prior advertisement is structural and forces the full
    path through the comparison (None != [...])."""

    def to_me(db: Optional[AdjacencyDatabase]):
        if db is None:
            return None
        return sorted(
            (
                adj.if_name,
                adj.other_if_name,
                adj.metric,
                adj.adj_label,
                adj.is_overloaded,
                adj.nexthop_v4,
                adj.nexthop_v6,
            )
            for adj in db.adjacencies
            if adj.other_node_name == me
        )

    new = to_me(adj_db)
    if not new and not (prior_db is not None and to_me(prior_db)):
        return False  # no adjacency to me on either side of the update
    return to_me(prior_db) != new


def _load_adj_db(data: bytes, area: str) -> AdjacencyDatabase:
    adj_db = _loads_cached(data)
    assert isinstance(adj_db, AdjacencyDatabase)
    if adj_db.area != area:
        # copy-on-write: never stamp the shared cached object
        adj_db = dataclasses.replace(adj_db, area=area)
    return adj_db


@dataclass
class DecisionConfig:
    my_node_name: str
    areas: List[str] = field(default_factory=lambda: ["0"])
    solver_backend: str = "cuda"  # 'cuda' | 'cpu' (the CPU oracle)
    # the cuda backend's device: "cuda" runs the hand-written kernels (and
    # raises without a card), "cpu" their plain PyTorch versions; TE runs
    # on the same device
    solver_device: str = "cuda"
    # (batch, graph) device-mesh shape or a parallel.Mesh for the cuda
    # backend; None = single device. Resolved by CudaSpfSolver at
    # construction (parallel.resolve_mesh).
    solver_mesh: Optional[tuple] = None
    enable_v4: bool = True
    compute_lfa_paths: bool = False
    enable_ordered_fib: bool = False
    bgp_dry_run: bool = False
    bgp_use_igp_metric: bool = False
    debounce_min: float = 0.01  # 10ms (docs/Runbook.md:425-435)
    debounce_max: float = 0.25  # 250ms
    eor_time_s: float = 0.0  # cold-start hold; 0 = no hold
    # solver fault domain (docs/Robustness.md): the cuda backend runs under
    # a SolverSupervisor — error-classified retries, a circuit breaker
    # falling back to the CPU oracle, probe-driven recovery, and an
    # every-Nth-solve warm-state audit (0 disables the audit)
    solver_supervised: bool = True
    solver_failure_threshold: int = 3
    solver_max_attempts: int = 2
    solver_deadline_s: float = 30.0
    solver_probe_interval_s: float = 5.0
    solver_probe_successes: int = 2
    solver_audit_interval: int = 0
    # partial-mesh degradation ladder: a device-loss streak re-resolves
    # the solver mesh over surviving chips before the breaker may open
    solver_mesh_degrade: bool = True
    # resident blocked-FW all-pairs matrix (docs/Apsp.md): areas up to
    # solver_apsp_max_nodes real nodes keep a device-resident APSP matrix
    # serving LFA qualification, KSP layer seeding and TE hard-scoring —
    # and keeping DeltaPath enabled under compute_lfa_paths; solver_apsp
    # off disables it wholesale (big areas fall back per-area regardless)
    solver_apsp: bool = True
    solver_apsp_max_nodes: int = 4096
    # flight recorder (solver/flight_recorder.py, docs/Monitoring.md):
    # per-area SolveTrace ring bound, the sampled phase-timing cadence
    # (every Nth solve synchronizes the card at its phase seams; 0
    # disables sampling), and an optional directory forensics dumps are
    # written to as JSON artifacts
    solver_trace_ring: int = 64
    solver_trace_sample_every: int = 16
    solver_forensics_dir: Optional[str] = None
    # device-memory observatory (monitor/memledger.py,
    # docs/Monitoring.md "Device-memory observatory"): capacity admission
    # keeps this fraction of device capacity free when gating layouts
    # (predict_fit headroom), and an explicit capacity override in bytes
    # stands in for backends that expose no memory_stats (0 = auto-detect:
    # the card's total memory; without a card the static caps like
    # solver_apsp_max_nodes remain the only gate)
    solver_mem_headroom_frac: float = 0.10
    solver_mem_capacity_bytes: int = 0


# wall-clock PerfEvent descriptors mapped onto convergence-span stages:
# the origin's pre-publish chain rides the advertised AdjacencyDatabase
# (linkmonitor/link_monitor.py), the flood-hop trace rides the publication
# itself (kvstore/store.py) — remote nodes reconstruct the monotonic span
# from these, so every node's CONVERGENCE_TRACE covers spark→fib
_PRE_STAGE_EVENTS = {
    "NEIGHBOR_EVENT_RECVD": "spark.neighbor_event",
    "ADJ_DB_ADVERTISED": "linkmonitor.adj_advertised",
}
_FLOOD_ORIGINATED = "KVSTORE_FLOOD_ORIGINATED"
_FLOOD_RECEIVED = "KVSTORE_FLOOD_RECEIVED"


class _PendingUpdates:
    """Batch tracker (Decision.h:95-207), extended with the DeltaPath dirty
    set: the prefixes whose advertisements this batch touched, and whether
    anything in the batch disqualifies the partial route rebuild (label
    moves, adjacency changes incident to me, structural deletes)."""

    def __init__(self) -> None:
        self.count = 0
        self.perf_events: Optional[PerfEvents] = None
        self.needs_route_update = False
        self.span: Optional[Span] = None
        self.dirty_prefixes: Set = set()
        self.force_full = False

    def apply(
        self,
        perf_events: Optional[PerfEvents],
        publication: Optional[Publication] = None,
    ) -> None:
        if self.count == 0:
            # the batch's oldest event is the one convergence is measured
            # from: stamp it on the MONOTONIC clock (seeded from the local
            # KvStore publication stamp when one rode along) so
            # convergence.e2e_ms is immune to wall-clock jumps — the
            # PerfEvents trace below stays wall-clock for cross-node
            # reporting, the span owns all local latency math
            self.span = _build_span(perf_events, publication)
            self.span.mark("decision.recv")
        self.count += 1
        self.needs_route_update = True
        # keep the OLDEST event trace in the batch (Decision.h:174-191)
        if perf_events is not None and (
            self.perf_events is None
            or (
                perf_events.events
                and self.perf_events.events
                and perf_events.events[0].unix_ts
                < self.perf_events.events[0].unix_ts
            )
        ):
            self.perf_events = perf_events.copy()

    def reset(self) -> None:
        self.count = 0
        self.perf_events = None
        self.needs_route_update = False
        self.span = None
        self.dirty_prefixes = set()
        self.force_full = False


def _build_span(
    perf_events: Optional[PerfEvents],
    publication: Optional[Publication],
) -> Span:
    """Seed one convergence Span with every stage known to predate the
    local publish stamp.

    On the ORIGINATING node the pre-publish chain arrives as exact
    monotonic marks (Publication.span_stages). On REMOTE nodes the same
    chain — plus the flood hops in between — is reconstructed from the
    wall-clock PerfEvents: each event's monotonic time is `now_mono -
    (now_wall - event_wall)`, exact inside one emulator host and
    NTP-accurate across real hosts (which is the precision cross-node
    measurement has anyway). From kvstore.publish on, every mark is live.
    """
    pub_ts = publication.ts_monotonic if publication is not None else None
    stages: List = []
    span_stages = (
        publication.span_stages if publication is not None else None
    )
    wall: List = []
    if span_stages:
        stages.extend(span_stages)
    elif perf_events is not None:
        for ev in perf_events.events:
            stage = _PRE_STAGE_EVENTS.get(ev.event_descr)
            if stage is not None:
                wall.append((stage, ev.unix_ts))
    flood = publication.perf_events if publication is not None else None
    if flood is not None:
        hop = 0
        for ev in flood.events:
            if ev.event_descr == _FLOOD_ORIGINATED:
                wall.append(("kvstore.flood.origin", ev.unix_ts))
            elif ev.event_descr == _FLOOD_RECEIVED:
                hop += 1
                wall.append((f"kvstore.flood.hop{hop}", ev.unix_ts))
    if wall:
        now_mono = time.monotonic()
        now_wall_ms = time.time() * 1e3
        stages.extend(
            (stage, now_mono - max(0.0, now_wall_ms - ts) / 1e3)
            for stage, ts in wall
        )
    stages.sort(key=lambda s: s[1])
    if pub_ts is not None:
        # the publish stamp bounds every pre-publish stage
        stages = [(stage, min(ts, pub_ts)) for stage, ts in stages]
    t0 = stages[0][1] if stages else pub_ts
    span = Span("convergence", t0=t0)
    for stage, ts in stages:
        span.mark(stage, ts=ts)
    if pub_ts is not None:
        span.mark("kvstore.publish", ts=pub_ts)
    return span


@owned_by("decision-loop")
class Decision(CountersMixin, HistogramsMixin):
    def __init__(
        self,
        config: DecisionConfig,
        kvstore_updates: RQueue,
        route_updates_queue: ReplicateQueue,
        static_routes_updates: Optional[RQueue] = None,
        loop: Optional[asyncio.AbstractEventLoop] = None,
        watchdog=None,
        log_sample_fn=None,
    ) -> None:
        self.config = config
        self.kvstore_updates = kvstore_updates
        self.route_updates_queue = route_updates_queue
        self.static_routes_updates = static_routes_updates
        self._loop = loop
        self._log_sample_fn = log_sample_fn
        # lazy TE engine (te/): built on the first runTeOptimize
        self._te_service = None

        solver_kwargs = dict(
            enable_v4=config.enable_v4,
            compute_lfa_paths=config.compute_lfa_paths,
            enable_ordered_fib=config.enable_ordered_fib,
            bgp_dry_run=config.bgp_dry_run,
            bgp_use_igp_metric=config.bgp_use_igp_metric,
        )
        # device-memory observatory knobs apply to the process-wide ledger
        # before any backend registers resident state
        from openr_tpu_torch.monitor.memledger import get_ledger

        ledger = get_ledger()
        ledger.set_headroom_frac(config.solver_mem_headroom_frac)
        ledger.set_capacity_override(
            config.solver_mem_capacity_bytes
            if config.solver_mem_capacity_bytes > 0
            else None
        )
        if config.solver_backend not in ("cpu", "cuda"):
            raise ValueError(
                f"solver_backend {config.solver_backend!r}: "
                f"expected 'cpu' or 'cuda'"
            )
        if config.solver_backend == "cuda":
            primary = CudaSpfSolver(
                config.my_node_name,
                device=config.solver_device,
                mesh=config.solver_mesh,
                apsp_max_nodes=(
                    config.solver_apsp_max_nodes if config.solver_apsp else 0
                ),
                # the APSP shadow audit shares the warm-state audit cadence
                apsp_audit_interval=config.solver_audit_interval,
                **solver_kwargs,
            )
            if config.solver_supervised:
                # the solve path's fault domain: device faults degrade to
                # the CPU oracle behind a circuit breaker instead of
                # unwinding into this module's event loop
                self.solver = SolverSupervisor(
                    primary,
                    SpfSolver(config.my_node_name, **solver_kwargs),
                    SupervisorConfig(
                        failure_threshold=config.solver_failure_threshold,
                        max_attempts=config.solver_max_attempts,
                        solve_deadline_s=config.solver_deadline_s,
                        probe_interval_s=config.solver_probe_interval_s,
                        probe_successes_to_close=(
                            config.solver_probe_successes
                        ),
                        audit_interval=config.solver_audit_interval,
                        mesh_degrade=config.solver_mesh_degrade,
                        trace_ring_size=config.solver_trace_ring,
                        trace_sample_every=(
                            config.solver_trace_sample_every
                        ),
                        forensics_dir=config.solver_forensics_dir,
                    ),
                    watchdog=watchdog,
                    log_sample_fn=log_sample_fn,
                )
            else:
                self.solver = primary
        else:
            self.solver = SpfSolver(config.my_node_name, **solver_kwargs)
        self.area_link_states: Dict[str, LinkState] = {
            area: LinkState(area) for area in config.areas
        }
        self.prefix_state = PrefixState()
        # per-prefix-key aggregation (Decision.cpp:1584-1629), keyed by
        # (node, area): per-prefix entries override full-db entries
        self._per_prefix_entries: Dict[tuple, Dict] = {}
        self._full_db_entries: Dict[tuple, Dict] = {}
        self.route_db = DecisionRouteDb()
        self.rib_policy: Optional[RibPolicy] = None
        # DeltaPath: builds DecisionRouteUpdates directly from the device
        # delta's changed destinations when the event qualifies, falling
        # back to the classic full build + get_route_delta diff
        self._delta_builder = DeltaRouteBuilder(self.solver)
        self._pending = _PendingUpdates()
        self._rebuild_debounce = AsyncDebounce(
            config.debounce_min,
            config.debounce_max,
            self.rebuild_routes,
            loop=loop,
        )
        self._cold_start_until: Optional[float] = None
        self._cold_start_timer: Optional[asyncio.TimerHandle] = None
        self._retry_timer: Optional[asyncio.TimerHandle] = None
        self._rib_policy_timer: Optional[asyncio.TimerHandle] = None
        self._task: Optional[asyncio.Task] = None
        self.counters: Dict[str, int] = {}
        self.histograms: Dict = {}
        if isinstance(self.solver, SolverSupervisor):
            # breaker trips, probes and audits happen in the BACKGROUND,
            # between rebuilds — the supervisor records straight into this
            # module's monitor-registered dicts so getCounters/ctrl always
            # read live fault-domain state, not the last rebuild's copy
            self.solver.counters = self.counters
            self.solver.histograms = self.histograms
            self.counters["decision.spf.fallback_active"] = 0
        self.have_computed_routes = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def loop(self) -> asyncio.AbstractEventLoop:
        return self._loop or asyncio.get_event_loop()

    def start(self) -> None:
        # warm-boot hygiene: any device-resident warm state surviving into
        # this start (an in-process emulator restart hands the same
        # process — and its compile caches — a fresh daemon) is dropped
        # exactly like a resharding event drops it: the first solve after
        # a whole-node restart must be a cold start, never a warm
        # continuation of pre-restart buffers (docs/Robustness.md)
        invalidate = getattr(self.solver, "invalidate_warm_state", None)
        if invalidate is not None:
            invalidate()
        if self.config.eor_time_s > 0:
            self._cold_start_until = (
                self.loop().time() + self.config.eor_time_s
            )
            self._cold_start_timer = self.loop().call_later(
                self.config.eor_time_s, self._end_cold_start
            )
        if isinstance(self.solver, SolverSupervisor):
            self.solver.start(self.loop())  # background health-probe loop
        self._task = self.loop().create_task(self._run())

    def stop(self) -> None:
        if isinstance(self.solver, SolverSupervisor):
            self.solver.stop()
        # device-memory observatory: daemon stop releases every ledger-
        # registered structure (teardown returns the ledger to baseline)
        solver_close = getattr(self.solver, "close", None)
        if solver_close is not None:
            solver_close()
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self._rebuild_debounce.cancel()
        if self._cold_start_timer is not None:
            self._cold_start_timer.cancel()
            self._cold_start_timer = None
        if self._rib_policy_timer is not None:
            self._rib_policy_timer.cancel()
        if self._retry_timer is not None:
            self._retry_timer.cancel()
            self._retry_timer = None

    def _retry_rebuild(self) -> None:
        self._retry_timer = None
        self.rebuild_routes()

    def _end_cold_start(self) -> None:
        self._cold_start_until = None
        self._pending.needs_route_update = True
        self._pending.force_full = True
        self.rebuild_routes()

    async def _run(self) -> None:
        tasks = [self._consume_kvstore()]
        if self.static_routes_updates is not None:
            tasks.append(self._consume_static())
        await asyncio.gather(*tasks, return_exceptions=True)

    async def _consume_kvstore(self) -> None:
        while True:
            try:
                pub = await self.kvstore_updates.get()
            except (QueueClosedError, asyncio.CancelledError):
                return
            self.process_publication(pub)

    async def _consume_static(self) -> None:
        try:
            while True:
                update = await self.static_routes_updates.get()
                mpls_to_update, mpls_to_delete = update
                self.solver.push_static_routes_delta(
                    mpls_to_update, mpls_to_delete
                )
                static = self.solver.process_static_route_updates()
                if static is not None and not static.empty():
                    self.route_updates_queue.push(static)
        except (QueueClosedError, asyncio.CancelledError):
            pass

    # ------------------------------------------------------------------
    # publication processing
    # ------------------------------------------------------------------

    # minimum adj keys in one publication for the bulk cold-start ingest;
    # small batches gain nothing over the incremental diff path
    _BULK_ADJ_THRESHOLD = 8

    def process_publication(self, publication: Publication) -> None:
        area = publication.area
        link_state = self.area_link_states.get(area)
        if link_state is None:
            # unknown area: create on the fly (config-less area discovery)
            link_state = LinkState(area)
            self.area_link_states[area] = link_state

        changed = False
        bulk_keys = self._bulk_adj_keys(publication, link_state)
        if bulk_keys:
            changed |= self._bulk_ingest_adj(
                publication, bulk_keys, area, link_state
            )
        for key, value in publication.key_vals.items():
            if value.value is None or key in bulk_keys:
                continue  # ttl refresh only / already bulk-ingested
            try:
                changed |= self._process_key(
                    key, value, area, link_state, publication
                )
            except Exception:
                # a malformed value must not poison the rest of the batch
                # (Decision.cpp:1726-1729 catches per-key)
                import logging

                logging.getLogger(__name__).exception(
                    "failed to process key %s", key
                )
                self._bump("decision.errors")

        for key in publication.expired_keys:
            if key.startswith(ADJ_DB_MARKER):
                node = key[len(ADJ_DB_MARKER):]
                if link_state.delete_adjacency_database(node).topology_changed:
                    changed = True
                    self._pending.force_full = True  # structural delete
                    self._pending.apply(None, publication)
            elif key.startswith(PREFIX_DB_MARKER):
                node, _, _ = parse_prefix_key(key)
                delete_db = PrefixDatabase(
                    this_node_name=node, delete_prefix=True
                )
                node_db = self._update_node_prefix_database(
                    key, delete_db, area
                )
                if node_db is None:
                    continue
                node_db.area = area
                dirty = self.prefix_state.update_prefix_database(node_db)
                if dirty:
                    changed = True
                    self._pending.dirty_prefixes |= dirty
                    self._pending.apply(None, publication)

        if changed:
            self._schedule_rebuild()

    def _bulk_adj_keys(
        self, publication: Publication, link_state: LinkState
    ) -> Set[str]:
        """Keys eligible for the cold-start bulk adjacency ingest: the area
        LinkState is empty (a KvStore full sync after restart) and the
        publication carries a batch of adj keys. Ordered-FIB holds are
        irrelevant here — with an empty graph every hop-distance lookup
        yields zero holds, which is what the bulk path applies."""
        if link_state.num_nodes() or link_state.get_adjacency_databases():
            return set()
        keys = {
            key
            for key, value in publication.key_vals.items()
            if key.startswith(ADJ_DB_MARKER) and value.value is not None
        }
        return keys if len(keys) >= self._BULK_ADJ_THRESHOLD else set()

    def _bulk_ingest_adj(
        self,
        publication: Publication,
        keys: Set[str],
        area: str,
        link_state: LinkState,
    ) -> bool:
        """Deserialize + ingest a full-sync batch of adj dbs in one pass
        (LinkState.bulk_update_adjacency_databases). Per-key malformed
        values are dropped with the same error accounting as the
        incremental path."""
        adj_dbs: List[AdjacencyDatabase] = []
        for key in sorted(keys):  # deterministic ingest order
            try:
                adj_dbs.append(
                    _load_adj_db(publication.key_vals[key].value, area)
                )
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "failed to process key %s", key
                )
                self._bump("decision.errors")
        change = link_state.bulk_update_adjacency_databases(adj_dbs)
        self._bump("decision.adj_db_update", len(adj_dbs))
        self._bump("decision.bulk_adj_ingests")
        self._pending.force_full = True  # cold-start ingest
        if not (
            change.topology_changed
            or change.link_attributes_changed
            or change.node_label_changed
        ):
            return False
        for db in adj_dbs:
            self._pending.apply(db.perf_events, publication)
        return True

    def _process_key(
        self,
        key: str,
        value,
        area: str,
        link_state: LinkState,
        publication: Optional[Publication] = None,
    ) -> bool:
        """Apply one LSDB key; returns True if state changed."""
        changed = False
        if key.startswith(ADJ_DB_MARKER):
            adj_db = _load_adj_db(value.value, area)
            # snapshot the previous advertisement before the LinkState
            # diff replaces it: the DeltaPath qualification below compares
            # the adjacencies-to-me across the update
            prior_db = link_state.get_adjacency_databases().get(
                adj_db.this_node_name
            )
            hold_up = hold_down = 0
            if self.config.enable_ordered_fib:
                # hold TTLs from hop distance (Decision.cpp:1669-1679)
                maybe_hops = link_state.get_hops_from_a_to_b(
                    self.config.my_node_name, adj_db.this_node_name
                )
                if maybe_hops is not None:
                    hold_up = maybe_hops
                    hold_down = (
                        link_state.get_max_hops_to_node(adj_db.this_node_name)
                        - hold_up
                    )
            change = link_state.update_adjacency_database(
                adj_db, hold_up, hold_down
            )
            self._bump("decision.adj_db_update")
            if (
                change.topology_changed
                or change.link_attributes_changed
                or change.node_label_changed
            ):
                changed = True
                # DeltaPath qualification: a label move re-arbitrates the
                # whole node-label table, my own advertisement changes my
                # links wholesale, and a neighbor whose adjacency TO ME
                # changed moves route inputs (nexthop addresses, link
                # up/down, my triangle weights) no distance column
                # reflects. A neighbor update where the adjacency to me is
                # byte-identical — only FAR-side links changed — leaves
                # the link to me untouched and stays on the delta path
                # (the narrowed ROADMAP refusal; the ordered diff only
                # applies the advertising node's own direction).
                me = self.config.my_node_name
                if (
                    change.node_label_changed
                    or adj_db.this_node_name == me
                    or _adjacencies_to_me_changed(prior_db, adj_db, me)
                ):
                    self._pending.force_full = True
                self._pending.apply(adj_db.perf_events, publication)
        elif key.startswith(PREFIX_DB_MARKER):
            # cached decode: prefix dbs are never mutated by this module
            # (aggregation builds fresh node_db objects)
            prefix_db = _loads_cached(value.value)
            assert isinstance(prefix_db, PrefixDatabase)
            node_db = self._update_node_prefix_database(key, prefix_db, area)
            if node_db is None:
                return False
            node_db.area = area
            self._bump("decision.prefix_db_update")
            dirty = self.prefix_state.update_prefix_database(node_db)
            if dirty:
                changed = True
                self._pending.dirty_prefixes |= dirty
                self._pending.apply(prefix_db.perf_events, publication)
        return changed

    def _update_node_prefix_database(
        self, key: str, prefix_db: PrefixDatabase, pub_area: str
    ) -> Optional[PrefixDatabase]:
        """Merge a per-prefix or full-db key into the node's aggregated
        PrefixDatabase (Decision.cpp:1584-1629). Per-prefix entries override
        full-db entries; aggregation is per (node, area) so one node's
        advertisements in different areas never bleed into each other."""
        node = prefix_db.this_node_name
        _, key_area, key_prefix = parse_prefix_key(key)
        agg_key = (node, key_area if key_area is not None else pub_area)
        per_prefix = self._per_prefix_entries.setdefault(agg_key, {})
        full_db = self._full_db_entries.setdefault(agg_key, {})
        if key_prefix is not None:
            # per-prefix key
            if prefix_db.delete_prefix:
                per_prefix.pop(key_prefix, None)
            else:
                assert len(prefix_db.prefix_entries) == 1, key
                entry = prefix_db.prefix_entries[0]
                # ignore self-redistributed route reflection
                # (Decision.cpp:1598-1604)
                if (
                    node == self.config.my_node_name
                    and entry.area_stack
                    and entry.area_stack[0] in self.area_link_states
                ):
                    return None
                per_prefix[key_prefix] = entry
        else:
            full_db.clear()
            for entry in prefix_db.prefix_entries:
                full_db[entry.prefix] = entry

        node_db = PrefixDatabase(
            this_node_name=node, perf_events=prefix_db.perf_events
        )
        node_db.prefix_entries.extend(per_prefix.values())
        node_db.prefix_entries.extend(
            entry
            for prefix, entry in full_db.items()
            if prefix not in per_prefix
        )
        return node_db

    def _schedule_rebuild(self) -> None:
        if self._cold_start_until is not None:
            return  # waiting for LSDB fill after restart
        self._rebuild_debounce()

    # ------------------------------------------------------------------
    # route computation + emission
    # ------------------------------------------------------------------

    def rebuild_routes(self) -> None:
        """Debounced batch solve + delta emission (Decision.cpp:1771-1814).

        DeltaPath: when every LSDB event in the batch rode the device
        delta-extraction path, the DecisionRouteUpdate is built directly
        from the changed destinations (DeltaRouteBuilder) — no full table
        rebuild, no full-db diff — and streamed into Fib's incremental
        programming path like any other update."""
        if self._cold_start_until is not None:
            return
        if not self._pending.needs_route_update:
            return
        perf_events = self._pending.perf_events
        span = self._pending.span
        dirty_prefixes = self._pending.dirty_prefixes
        force_full = self._pending.force_full or not self.have_computed_routes
        self._bump("decision.batched_updates", self._pending.count)
        self._pending.reset()
        self._bump("decision.route_build_runs")
        if span is not None:
            # oldest-event recv -> debounce fire, on the monotonic clock
            self._observe("decision.debounce_ms", span.mark("decision.debounce"))

        t0 = time.perf_counter()
        try:
            new_db, delta, used_delta = self._delta_builder.build(
                self.config.my_node_name,
                self.area_link_states,
                self.prefix_state,
                self.route_db,
                dirty_prefixes=dirty_prefixes,
                force_full=force_full,
                policy_fn=self._rib_policy_entry_fn(),
            )
        except Exception as exc:
            # rebuild_routes runs from a loop timer callback: an uncaught
            # exception here vanishes into the loop's exception handler and
            # the daemon silently stops converging. Log + count + schedule a
            # retry at the debounce MAX (a direct timer: re-arming the
            # debouncer would fire at debounce_min again — its backoff
            # resets on every fire — and a persistent failure would then
            # burn the loop with ~100 failed full rebuilds per second).
            import logging

            logging.getLogger(__name__).exception("route build failed")
            self._bump("decision.route_build_errors")
            self._pending.needs_route_update = True
            # the dirty snapshot was consumed: the retry must not trust it
            self._pending.force_full = True
            if is_kernel_fault(exc):
                # port: a kernel that does not build, launch or run raises
                # to the caller (the loop's exception handler); no timed
                # retry, since it fails the same way, and no answer from
                # the host in its place. The next publication retries.
                raise
            if self._retry_timer is not None:
                self._retry_timer.cancel()
            self._retry_timer = self.loop().call_later(
                self.config.debounce_max, self._retry_rebuild
            )
            return
        build_ms = (time.perf_counter() - t0) * 1e3
        self._observe("decision.route_build_ms", build_ms)
        if used_delta:
            self._bump("decision.route_build_delta_runs")
            self._observe("decision.route_build_delta_ms", build_ms)
        if self._delta_builder.last_error is not None:
            self._bump("decision.route_build_delta_errors")
        if span is not None:
            span.mark("decision.route_build")
        # surface the solver's SPF convergence counters (warm vs cold solve
        # split, relaxation + invalidation rounds of the last solve) and
        # profiling histograms (solve latency, warm/cold split) through this
        # module's registered dicts so getCounters/getHistograms see them;
        # histogram objects are shared by reference — the solver keeps
        # recording into them, the monitor merges copies on export
        for key, value in self.solver.counters.items():
            if key.startswith(("decision.spf.", "decision.mem.")):
                self.counters[key] = value
        for key, hist in self.solver._ensure_histograms().items():
            if key.startswith("decision.spf."):
                self._ensure_histograms()[key] = hist
        if new_db is None:
            return
        if used_delta:
            corrected = self._verify_delta_build(new_db)
            if corrected is not None:
                # shadow audit caught a divergence: serve the corrected
                # full rebuild (the partial update is superseded)
                delta = get_route_delta(corrected, self.route_db)
                new_db = corrected
        self.route_db = new_db
        self.have_computed_routes = True
        if not delta.empty():
            delta.perf_events = perf_events
            delta.span = span
            self.route_updates_queue.push(delta)
            self._bump("decision.route_updates_published")

    def _rib_policy_entry_fn(self):
        """Per-entry RibPolicy hook for the route builder (applied to every
        computed entry before diffing, on both the full and delta paths)."""
        if self.rib_policy is None or not self.rib_policy.is_active():
            return None

        def apply(entry) -> None:
            if self.rib_policy is not None and self.rib_policy.apply_action(
                entry
            ):
                self._bump("decision.rib_policy_applied")

        return apply

    def _verify_delta_build(self, new_db) -> Optional[DecisionRouteDb]:
        """Run the supervisor's route-delta shadow audit when available.
        Skipped while a RibPolicy is active: the audit's comparator is a
        raw full rebuild, which would flag every policy-transformed entry
        as divergence."""
        verify = getattr(self.solver, "verify_route_delta", None)
        if verify is None or self._rib_policy_entry_fn() is not None:
            return None
        return verify(
            new_db,
            self.config.my_node_name,
            self.area_link_states,
            self.prefix_state,
        )

    # analysis: shared — sync ctrl handler, loop-serialized with the owner
    def set_rib_policy(self, policy: RibPolicy) -> None:
        """OpenrCtrl setRibPolicy (Decision.cpp:1517-1550): apply now and
        schedule re-application at expiry. A policy change transforms
        entries everywhere, so the rebuild is forced down the full path."""
        self.rib_policy = policy
        if self._rib_policy_timer is not None:
            self._rib_policy_timer.cancel()
        self._rib_policy_timer = self.loop().call_later(
            max(0.0, policy.get_ttl_duration()), self._on_rib_policy_expiry
        )
        self._pending.needs_route_update = True
        self._pending.force_full = True
        self.rebuild_routes()

    def get_rib_policy(self) -> Optional[RibPolicy]:
        return self.rib_policy

    def _on_rib_policy_expiry(self) -> None:
        # re-emit routes without the expired policy (full path: the expiry
        # un-transforms entries everywhere)
        self._pending.needs_route_update = True
        self._pending.force_full = True
        self.rebuild_routes()

    # ------------------------------------------------------------------
    # read APIs (OpenrCtrl surface)
    # ------------------------------------------------------------------

    def get_decision_route_db(
        self, node: Optional[str] = None
    ) -> Optional[DecisionRouteDb]:
        """Computed routes from this node's (or any node's) perspective
        (Decision.cpp:1437-1448)."""
        if node is None or node == self.config.my_node_name:
            return self.route_db
        solver = SpfSolver(
            node,
            enable_v4=self.config.enable_v4,
            compute_lfa_paths=self.config.compute_lfa_paths,
            enable_ordered_fib=self.config.enable_ordered_fib,
            bgp_dry_run=self.config.bgp_dry_run,
            bgp_use_igp_metric=self.config.bgp_use_igp_metric,
        )
        return solver.build_route_db(
            node, self.area_link_states, self.prefix_state
        )

    # analysis: shared — sync ctrl handler, loop-serialized with the owner
    def run_te_optimize(self, params: Optional[Dict] = None) -> Dict:
        """What-if differentiable-TE optimization over the live LSDB
        (ctrl `runTeOptimize` / `breeze decision te-optimize`,
        docs/TrafficEngineering.md). Read-only against routing state: the
        report proposes weight changes, nothing is programmed. Runs
        supervised when the solver is a SolverSupervisor — a device fault
        degrades the optimization to the CPU backend and feeds the same
        breaker as SPF solves."""
        if self._te_service is None:
            from openr_tpu_torch.te import TeService

            self._te_service = TeService(
                self.config.my_node_name,
                self.area_link_states,
                solver=self.solver,
                device=(
                    self.config.solver_device
                    if self.config.solver_backend == "cuda"
                    else "cpu"
                ),
                log_sample_fn=self._log_sample_fn,
            )
            # TE counters/histograms record straight into this module's
            # monitor-registered dicts (same pattern as the supervisor)
            self._te_service.counters = self.counters
            self._te_service.histograms = self.histograms
        return self._te_service.optimize(params)

    def get_solver_health(self) -> Dict:
        """Solver fault-domain state (ctrl getSolverHealth / `breeze
        decision solver-health`): the degraded flag, breaker state and
        probe/audit stats when supervised; a static healthy record when
        the backend runs bare (cpu oracle or supervision disabled)."""
        if isinstance(self.solver, SolverSupervisor):
            return self.solver.health()
        return {
            "degraded": False,
            "breaker_state": "unsupervised",
            "fallback_active": 0,
            "backend": self.config.solver_backend,
            "solve_ms_last": getattr(self.solver, "solve_ms_last", None),
            "delta_extract_ms_last": getattr(
                self.solver, "delta_extract_ms_last", None
            ),
            "apsp_close_ms_last": getattr(
                self.solver, "apsp_close_ms_last", None
            ),
        }

    def get_device_memory(self, area: Optional[str] = None) -> Dict:
        """Device-memory observatory surface (ctrl `getDeviceMemory` /
        `breeze decision memory`): the resident-state ledger snapshot —
        per-structure live bytes, exact-accounting totals, watermark
        reconciliation, the capacity verdict and the last admission
        refusal (docs/Monitoring.md "Device-memory observatory"). The
        ledger is process-global, so this answers even when the backend
        runs bare; `area` narrows the entry listing only."""
        from openr_tpu_torch.monitor.memledger import get_ledger

        snap = get_ledger().snapshot(area=area)
        snap["supervised"] = isinstance(self.solver, SolverSupervisor)
        return snap

    def get_solve_traces(
        self, area: Optional[str] = None, last_n: Optional[int] = None
    ) -> Dict:
        """Flight-recorder surface (ctrl `getSolveTraces` / `breeze
        decision solve-traces`): the per-area SolveTrace rings with
        eviction accounting plus the forensics-dump index
        (docs/Monitoring.md "Flight recorder & profiling"). Recording
        rides the SolverSupervisor; an unsupervised backend reports
        enabled=False with empty surfaces."""
        recorder = getattr(self.solver, "recorder", None)
        if not isinstance(self.solver, SolverSupervisor) or recorder is None:
            return {
                "enabled": False,
                "traces": [],
                "stats": {},
                "forensics": [],
            }
        return {
            "enabled": True,
            "traces": recorder.snapshot(area=area, last_n=last_n),
            "stats": recorder.stats(),
            "forensics": recorder.dump_summaries(),
        }

    def get_adjacency_databases(self) -> Dict[str, AdjacencyDatabase]:
        out: Dict[str, AdjacencyDatabase] = {}
        for link_state in self.area_link_states.values():
            out.update(link_state.get_adjacency_databases())
        return out

    def get_prefix_databases(self) -> Dict[tuple, PrefixDatabase]:
        return self.prefix_state.get_prefix_databases()

    def decrement_ordered_fib_holds(self) -> None:
        """Tick ordered-FIB holds on all areas (Decision.cpp hold timer)."""
        changed = False
        for link_state in self.area_link_states.values():
            if link_state.decrement_holds().topology_changed:
                changed = True
        if changed:
            self._pending.needs_route_update = True
            self._pending.force_full = True  # hold expiry flips visibility
            self._pending.count += 1
            self._schedule_rebuild()

