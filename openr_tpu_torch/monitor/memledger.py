"""Device-memory observatory: resident-state ledger + predictive capacity.

The repo's other observability layers (spans, exporter, flight recorder,
fleet observer, journal) watch *time* and *bytes moved* — h2d/d2h/halo
transfer counters, phase clocks, convergence spans. None of them watch
*bytes resident*: an area that does not fit device memory simply dies in
RESOURCE_EXHAUSTED with no forecast, no attribution, and no forensics.
This module closes that gap with three cooperating pieces:

  1. **The ledger** (`MemLedger`): every device-resident structure
     registers at allocation and releases at teardown — `_AreaSolve`'s
     distance matrix and sliced-ELL / bf / tile2d layout buffers, the
     `_PATCH_SLOTS` weight-patch slots, the lazy D host mirrors,
     `ApspState`'s [n_pad, n_pad] matrices, TE scenario tensors, KSP
     layer rows — tagged by (area, structure, layout, dtype, shape).
     Accounting is EXACT, and pinned by test:

         registered_bytes == live_bytes + freed_bytes

     always, across solve / teardown / degrade cycles. The release seam
     carries the `solver.mem.retain` fault point: an armed injector can
     pin entries live (skip the free) to simulate the buffer-leak bug
     class the ledger exists to see — the leak shows up as monotonic
     `live_bytes` growth and a widening live-vs-freed gap, never as an
     accounting violation.

  2. **Watermark reconciliation** (`reconcile()`): on the card the
     ledger's live_bytes is compared against the caching allocator's
     `torch.cuda.memory_stats()` (`allocated_bytes.all.current`); without
     a card (the CPU tests) the `drift_events` counter records the
     unreconcilable check instead of guessing. (The JAX package's
     `jax.live_arrays()` secondary source has no torch counterpart.)

  3. **Predictive capacity** (`predict_fit()`): a forward model of
     resident bytes derived from the SAME padding/bucketing arithmetic
     the solvers use (`_next_bucket` buckets, mesh batch-axis rounding,
     `GraphTiling` tile/halo shapes, FW block shapes) — so admission
     decisions (`ApspState.enabled_for`, tile2d layout selection) become
     measured, headroom-gated verdicts that refuse or degrade BEFORE the
     allocator raises, not after. `solver_apsp_max_nodes` demotes to the
     fallback gate used only when no capacity source exists.

Surfaces (docs/Monitoring.md "Device-memory observatory"): the
`decision.mem.*` counters/gauges folded into the solver facade by
`fold_counters()`, ctrl `getDeviceMemory` / `breeze decision memory`,
ledger rows in `getSolverHealth`, the snapshot embedded in every
flight-recorder forensics dump, and the fleet observer's `device_memory`
SLO rule (headroom budget + leak trend over the live-bytes series).

A process-global default ledger (`get_ledger()`) mirrors the process-
wide compile caches: bench's raw-jit paths and the module-level solver
factories share one accounting domain. Tests that need isolation
construct their own `MemLedger` and pass it down.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from openr_tpu_torch.testing.faults import fault_point

# fixed structure vocabulary: per-structure gauge names must be string
# literals (registry-drift resolves docs/Monitoring.md rows against the
# code's string universe), so unknown structures fold into "other"
STRUCT_GAUGES = {
    "dist": "decision.mem.dist_bytes_last",
    "sell": "decision.mem.sell_bytes_last",
    "bf": "decision.mem.bf_bytes_last",
    "tile": "decision.mem.tile_bytes_last",
    "halo": "decision.mem.halo_bytes_last",
    "patch": "decision.mem.patch_bytes_last",
    "mirror": "decision.mem.mirror_bytes_last",
    "apsp": "decision.mem.apsp_bytes_last",
    "te": "decision.mem.te_bytes_last",
    "ksp": "decision.mem.ksp_bytes_last",
    "other": "decision.mem.other_bytes_last",
}

_INT32 = 4
_BOOL = 1


@dataclass
class MemEntry:
    """One registered device-resident (or accounted host-mirror)
    structure. `retained` marks entries pinned live by the
    `solver.mem.retain` fault — released by the caller but never freed,
    the exact signature of a real buffer leak."""

    handle: int
    area: str
    structure: str
    layout: str
    dtype: str
    shape: Tuple[int, ...]
    nbytes: int
    retained: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "handle": self.handle,
            "area": self.area,
            "structure": self.structure,
            "layout": self.layout,
            "dtype": self.dtype,
            "shape": list(self.shape),
            "nbytes": int(self.nbytes),
            "retained": bool(self.retained),
        }


class _ReleaseCtx:
    """fault_point context for `solver.mem.retain`: an armed action sets
    `retain = True` and the ledger keeps the entry live (leak injection
    for MEM_SMOKE / the fleet `device_memory` rule)."""

    __slots__ = ("ledger", "entry", "retain")

    def __init__(self, ledger: "MemLedger", entry: MemEntry) -> None:
        self.ledger = ledger
        self.entry = entry
        self.retain = False


def _cuda_devices_in_use() -> List[int]:
    """Indices of the cards this process has initialised (none without
    a card, or before the first CUDA call: reading a card's stats must
    not create a context on it)."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    return list(range(torch.cuda.device_count()))


def _arrays_bytes(arrays: Iterable[Any]) -> int:
    total = 0
    for a in arrays:
        if a is None:
            continue
        nb = getattr(a, "nbytes", None)
        if nb is None:
            continue
        total += int(nb)
    return total


class MemLedger:
    """Exact-accounting resident-bytes ledger (thread-safe; the solver,
    APSP closer and TE optimizer touch it from the decision loop while
    ctrl handlers snapshot it from the server loop)."""

    def __init__(self, capacity_bytes: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[int, MemEntry] = {}
        self._next_handle = 1
        # exact accounting: registered == live + freed, always
        self.registered_bytes = 0  # monotonic: every byte ever registered
        self.freed_bytes = 0  # monotonic: every byte ever freed
        self.live_bytes = 0
        self.peak_bytes = 0
        self.registers = 0
        self.releases = 0
        self.retained = 0  # releases pinned live by solver.mem.retain
        self.drift_events = 0  # reconcile() checks with no backend source
        self.capacity_refusals = 0
        self.last_refusal: Optional[Dict[str, Any]] = None
        self._capacity_override = capacity_bytes
        self._headroom_frac = 0.10
        self._externals: Dict[str, Callable[[], Dict[str, Any]]] = {}
        # per-structure live/peak, folded onto the fixed gauge vocabulary
        # (bench lines report the structure peak next to predict_fit)
        self._struct_live: Dict[str, int] = {}
        self._struct_peak: Dict[str, int] = {}

    @staticmethod
    def _fold_structure(structure: str) -> str:
        key = structure.split(".", 1)[0]
        return key if key in STRUCT_GAUGES else "other"

    def _struct_delta(self, structure: str, delta: int) -> None:
        """Adjust one structure's live bytes (caller holds the lock)."""
        key = self._fold_structure(structure)
        live = self._struct_live.get(key, 0) + delta
        self._struct_live[key] = live
        if live > self._struct_peak.get(key, 0):
            self._struct_peak[key] = live

    # -- registration ---------------------------------------------------

    def register(
        self,
        area: str,
        structure: str,
        *,
        layout: str = "none",
        arrays: Iterable[Any] = (),
        nbytes: Optional[int] = None,
        dtype: str = "int32",
        shape: Tuple[int, ...] = (),
    ) -> int:
        """Register one device-resident structure; returns the handle the
        owner must `release()` at teardown. Bytes come from the actual
        arrays when given (`sum(a.nbytes)` — the logical global size, so
        sharded and replicated placements account identically)."""
        if nbytes is None:
            nbytes = _arrays_bytes(arrays)
            first = next((a for a in arrays if a is not None), None)
            if first is not None:
                dtype = str(getattr(first, "dtype", dtype))
                shape = tuple(int(s) for s in getattr(first, "shape", shape))
        nbytes = int(nbytes)
        with self._lock:
            handle = self._next_handle
            self._next_handle += 1
            self._entries[handle] = MemEntry(
                handle=handle,
                area=area,
                structure=structure,
                layout=layout,
                dtype=dtype,
                shape=tuple(shape),
                nbytes=nbytes,
            )
            self.registers += 1
            self.registered_bytes += nbytes
            self.live_bytes += nbytes
            self._struct_delta(structure, nbytes)
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
        return handle

    def release(self, handle: Optional[int]) -> bool:
        """Release a registered structure. The `solver.mem.retain` fault
        seam sits HERE: an armed action pins the entry live (the free is
        skipped), modeling a teardown path that forgot a buffer — the
        accounting stays exact while live_bytes stops returning to
        baseline, which is what the fleet leak-trend rule watches."""
        if handle is None:
            return False
        with self._lock:
            entry = self._entries.get(handle)
        if entry is None or entry.retained:
            return False
        ctx = _ReleaseCtx(self, entry)
        fault_point("solver.mem.retain", ctx)
        with self._lock:
            if ctx.retain:
                entry.retained = True
                self.retained += 1
                return False
            self._entries.pop(handle, None)
            self.releases += 1
            self.freed_bytes += entry.nbytes
            self.live_bytes -= entry.nbytes
            self._struct_delta(entry.structure, -entry.nbytes)
        return True

    def release_area(self, area: str) -> int:
        """Release every live entry tagged with `area` (area teardown:
        `TpuSpfSolver` dropping a solve, mesh degradation rebuilds)."""
        with self._lock:
            handles = [
                h for h, e in self._entries.items() if e.area == area
            ]
        released = 0
        for handle in handles:
            if self.release(handle):
                released += 1
        return released

    def update(self, handle: Optional[int], arrays: Iterable[Any]) -> None:
        """Re-size an existing entry in place (persistent buffers whose
        contents re-upload without changing identity — e.g. the sell `ov`
        refresh). Byte delta flows through registered/freed so the exact-
        accounting invariant holds through the resize."""
        if handle is None:
            return
        nbytes = _arrays_bytes(arrays)
        with self._lock:
            entry = self._entries.get(handle)
            if entry is None:
                return
            delta = nbytes - entry.nbytes
            entry.nbytes = nbytes
            if delta >= 0:
                self.registered_bytes += delta
                self.live_bytes += delta
            else:
                self.freed_bytes += -delta
                self.live_bytes += delta
            self._struct_delta(entry.structure, delta)
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes

    # -- introspection --------------------------------------------------

    def check(self) -> bool:
        """The exact-accounting invariant, pinned by test."""
        with self._lock:
            return self.registered_bytes == self.live_bytes + self.freed_bytes

    def live_entries(
        self, area: Optional[str] = None
    ) -> List[MemEntry]:
        with self._lock:
            entries = list(self._entries.values())
        if area is not None:
            entries = [e for e in entries if e.area == area]
        return sorted(entries, key=lambda e: e.handle)

    def area_bytes(self, area: str) -> int:
        with self._lock:
            return sum(
                e.nbytes for e in self._entries.values() if e.area == area
            )

    def structure_bytes(self) -> Dict[str, int]:
        """Live bytes per structure, folded onto the fixed gauge
        vocabulary (unknown structures roll into `other`)."""
        out = {name: 0 for name in STRUCT_GAUGES}
        with self._lock:
            out.update(self._struct_live)
        return out

    def structure_peak_bytes(self) -> Dict[str, int]:
        """Peak live bytes per structure over the ledger's lifetime (the
        bench lines' mem_peak_bytes source)."""
        out = {name: 0 for name in STRUCT_GAUGES}
        with self._lock:
            out.update(self._struct_peak)
        return out

    def attach_external(
        self, name: str, provider: Callable[[], Dict[str, Any]]
    ) -> None:
        """Attach an informational source folded into snapshots WITHOUT
        entering the exact accounting (the compile caches: entry counts
        and size estimates live behind `lru_cache`, not our allocations)."""
        self._externals[name] = provider

    def fold_counters(self, counters: Dict[str, Any]) -> None:
        """Fold the ledger's counters + gauges into a module counter dict
        (the solver facade's — rides the established decision.spf sync
        into the Monitor and the Prometheus exporter). Counters are
        absolute monotonic totals like every decision.* counter; gauges
        carry the `_last`/`_active` suffixes the exporter types by."""
        with self._lock:
            counters["decision.mem.registers"] = self.registers
            counters["decision.mem.releases"] = self.releases
            counters["decision.mem.registered_bytes"] = self.registered_bytes
            counters["decision.mem.freed_bytes"] = self.freed_bytes
            counters["decision.mem.retained"] = self.retained
            counters["decision.mem.drift_events"] = self.drift_events
            counters["decision.mem.capacity_refusals"] = (
                self.capacity_refusals
            )
            counters["decision.mem.live_bytes_last"] = self.live_bytes
            counters["decision.mem.peak_bytes_last"] = self.peak_bytes
            counters["decision.mem.structures_active"] = len(self._entries)
        headroom = self.headroom_bytes()
        counters["decision.mem.headroom_bytes_last"] = (
            -1 if headroom is None else headroom
        )
        for structure, nbytes in self.structure_bytes().items():
            counters[STRUCT_GAUGES[structure]] = nbytes

    def snapshot(self, area: Optional[str] = None) -> Dict[str, Any]:
        """The full ledger picture: totals, invariant, per-structure and
        per-area live bytes, entry rows, reconciliation, capacity. Served
        by ctrl getDeviceMemory and embedded in every forensics dump."""
        entries = self.live_entries(area)
        per_area: Dict[str, int] = {}
        for e in entries:
            per_area[e.area] = per_area.get(e.area, 0) + e.nbytes
        with self._lock:
            totals = {
                "registered_bytes": self.registered_bytes,
                "live_bytes": self.live_bytes,
                "freed_bytes": self.freed_bytes,
                "peak_bytes": self.peak_bytes,
                "registers": self.registers,
                "releases": self.releases,
                "retained": self.retained,
                "drift_events": self.drift_events,
                "capacity_refusals": self.capacity_refusals,
            }
            last_refusal = dict(self.last_refusal) if self.last_refusal else None
        snap: Dict[str, Any] = {
            "totals": totals,
            "exact": totals["registered_bytes"]
            == totals["live_bytes"] + totals["freed_bytes"],
            "structures": self.structure_bytes(),
            "areas": per_area,
            "entries": [e.to_dict() for e in entries],
            "reconcile": self.reconcile(),
            "capacity": self.capacity(),
            "last_refusal": last_refusal,
        }
        external: Dict[str, Any] = {}
        for name, provider in list(self._externals.items()):
            try:
                external[name] = provider()
            except Exception:
                external[name] = {"error": "provider failed"}
        if external:
            snap["external"] = external
        return snap

    # -- watermark reconciliation --------------------------------------

    def reconcile(self) -> Dict[str, Any]:
        """Compare ledger live bytes against the backend's own view: the
        caching allocator's `torch.cuda.memory_stats(dev)`
        (`allocated_bytes.all.current` / `.peak`) summed over every card
        this process has initialised. Without a card the check cannot be
        made: the source reads `unavailable` and `drift_events` is bumped
        (the unreconcilable check is itself a signal worth counting).

        Port note: the JAX package falls back to `jax.live_arrays()` on its
        CPU backend; torch keeps no registry of live CPU tensors, so the
        port has no secondary source."""
        backend_bytes: Optional[int] = None
        peak: Optional[int] = None
        source = "unavailable"
        try:
            devices = _cuda_devices_in_use()
            if devices:
                import torch

                stats_total = 0
                peak_total = 0
                for dev in devices:
                    stats = torch.cuda.memory_stats(dev)
                    cur = int(stats.get("allocated_bytes.all.current", 0))
                    stats_total += cur
                    peak_total += int(
                        stats.get("allocated_bytes.all.peak", cur)
                    )
                backend_bytes = stats_total
                peak = peak_total
                source = "memory_stats"
        except Exception:
            source = "unavailable"
        if source == "unavailable":
            with self._lock:
                self.drift_events += 1
        with self._lock:
            ledger_bytes = self.live_bytes
        drift = (
            backend_bytes - ledger_bytes if backend_bytes is not None else None
        )
        return {
            "source": source,
            "backend_bytes": backend_bytes,
            "backend_peak_bytes": peak,
            "ledger_bytes": ledger_bytes,
            "drift_bytes": drift,
        }

    # -- capacity model -------------------------------------------------

    def set_capacity_override(self, capacity_bytes: Optional[int]) -> None:
        self._capacity_override = capacity_bytes

    def set_headroom_frac(self, frac: float) -> None:
        self._headroom_frac = max(0.0, min(float(frac), 1.0))

    def capacity(self) -> Dict[str, Any]:
        """Total device capacity and where the number came from:
        `override` (config / tests) > `memory_stats` bytes_limit >
        `fallback` (no capacity source — admission gates must fall back
        to their static caps, e.g. `solver_apsp_max_nodes`)."""
        if self._capacity_override is not None:
            return {
                "capacity_bytes": int(self._capacity_override),
                "source": "override",
            }
        try:
            devices = _cuda_devices_in_use()
            if devices:
                import torch

                total = sum(
                    int(torch.cuda.get_device_properties(d).total_memory)
                    for d in devices
                )
                return {"capacity_bytes": total, "source": "memory_stats"}
        except Exception:
            pass
        return {"capacity_bytes": None, "source": "fallback"}

    def headroom_bytes(self) -> Optional[int]:
        cap = self.capacity()["capacity_bytes"]
        if cap is None:
            return None
        with self._lock:
            return cap - self.live_bytes

    def predict_fit(
        self,
        n_nodes: int,
        layout: str,
        *,
        n_sources: int = 1,
        graph: Any = None,
        tiling: Any = None,
        mesh_shape: Optional[Tuple[int, int]] = None,
        consumers: Tuple[str, ...] = (),
    ) -> Dict[str, Any]:
        """Forward model of resident bytes for a layout, built from the
        SAME arithmetic the solvers use — `_next_bucket` power-of-two
        buckets, mesh batch-axis rounding, the sliced-ELL bucket sums,
        `GraphTiling` tile/halo shapes, the [n_pad, n_pad] FW triple —
        plus a headroom verdict against current capacity and live bytes.
        Pass the `CompiledGraph` for exact sell/tile components (the
        bucket structure depends on the degree distribution); without it
        the edge-count estimate carries the documented sell waste bound.

        Returns {layout, predicted_bytes, components, capacity_bytes,
        headroom_bytes, fits, source}; `fits is None` means no capacity
        source exists and the caller must use its fallback gate.

        Port: the components are what the port keeps resident between
        solves, which is the JAX package's set plus two derived arrays,
        named where they are added (the edge-list `csr`, the tiling's
        `hptr`). The kernels' per-solve buffers (the round protocol's
        second D buffer and state, K5's and K6's bit marks, K19's
        node-major tile copy, K11's and K13's operand panels) are
        allocated inside one call and freed when it returns: they are
        transient, like the JAX package's XLA temporaries, and neither
        model counts them."""
        from openr_tpu_torch.ops.graph import _next_bucket

        n = int(n_nodes)
        n_pad = (
            int(graph.n_pad) if graph is not None else _next_bucket(max(n, 1))
        )
        e = int(graph.e) if graph is not None else 0
        e_pad = (
            int(graph.e_pad)
            if graph is not None
            else _next_bucket(max(e, 1))
        )
        b, g = (1, 1)
        if mesh_shape is not None:
            b, g = int(mesh_shape[0]), int(mesh_shape[1])
        s_pad = _next_bucket(max(int(n_sources), 1), minimum=8)
        s_pad += (-s_pad) % max(b, 1)

        components: Dict[str, int] = {}
        if layout == "apsp":
            # the FW triple: d + w (int32) and allow (bool), all [n_pad,n_pad]
            components["apsp.d"] = n_pad * n_pad * _INT32
            components["apsp.w"] = n_pad * n_pad * _INT32
            components["apsp.allow"] = n_pad * n_pad * _BOOL
        elif layout == "te":
            # TE runs on the REAL node/edge counts (te/scenarios.py builds
            # [B, n, n] float32 demands, unpadded); n_sources carries the
            # scenario batch width B
            batch = max(int(n_sources), 1)
            components["te.demands"] = batch * n * n * 4
            components["te.caps"] = max(e, 1) * 4
        else:
            components["dist"] = s_pad * n_pad * _INT32
            if layout == "sell":
                sell = getattr(graph, "sell", None) if graph is not None else None
                if sell is not None:
                    sell_bytes = sum(
                        int(a.nbytes) for a in (*sell.nbr, *sell.wg)
                    )
                    nb = len(sell.nbr)
                else:
                    # no graph: bound by the sell builder's waste contract
                    # (total slots <= edges * (1 + _SELL_WASTE_FRAC)), two
                    # int32 planes (nbr + wg)
                    sell_bytes = int(e_pad * 2 * _INT32 * 1.25)
                    nb = 4
                components["sell"] = sell_bytes + n_pad * _BOOL
                # fixed-capacity weight-patch slots: rowcol [nb,64,2] +
                # vals [nb,64], int32
                components["patch"] = nb * 64 * 3 * _INT32
            elif layout in ("bf", "replicated"):
                # edge-list planes (src/dst/w int32 [e_pad]) + the
                # overload mask; the mesh-replicated edge-list layout has
                # the same logical footprint. Port: + `csr` int32
                # [n_pad + 1], the in-edge ranges of the dst-sorted real
                # edges that K2 and K6 walk (convert.to_device), resident
                # beside the planes; the JAX package keeps no such array
                components["bf"] = (
                    3 * e_pad * _INT32 + (n_pad + 1) * _INT32
                    + n_pad * _BOOL
                )
            elif layout == "tile2d":
                if tiling is None and graph is not None and g > 1:
                    from openr_tpu_torch.parallel.mesh import tile_graph

                    try:
                        tiling = tile_graph(graph, g)
                    except Exception:
                        tiling = None
                if tiling is not None:
                    # port: + `hptr` int32 [g, h + 1], each frontier slot's
                    # range of real edges that K19 walks (the tiling's one
                    # derived array; the JAX package keeps no such array)
                    components["tile"] = (
                        tiling.tile_bytes() + g * (tiling.h + 1) * _INT32
                        + n_pad * _BOOL
                    )
                    components["halo"] = tiling.halo_bytes()
                else:
                    # estimate: 3 int32 planes of [g, e_tile≈e_pad/g] + the
                    # ov mask, halo slots bounded by n_pad (port: + hptr,
                    # bounded like the halo)
                    components["tile"] = (
                        3 * e_pad * _INT32 + g * (_next_bucket(n_pad) + 1)
                        * _INT32 + n_pad * _BOOL
                    )
                    components["halo"] = g * _next_bucket(n_pad) * _INT32
        for extra in consumers:
            if extra == "mirror":
                components["mirror"] = s_pad * n_pad * _INT32
            elif extra == "ksp":
                components["ksp"] = s_pad * n_pad * _INT32

        predicted = int(sum(components.values()))
        cap = self.capacity()
        capacity_bytes = cap["capacity_bytes"]
        fits: Optional[bool] = None
        headroom: Optional[int] = None
        if capacity_bytes is not None:
            with self._lock:
                live = self.live_bytes
            budget = int(capacity_bytes * (1.0 - self._headroom_frac))
            headroom = budget - live - predicted
            fits = headroom >= 0
        return {
            "layout": layout,
            "n_nodes": n,
            "n_pad": n_pad,
            "predicted_bytes": predicted,
            "components": components,
            "capacity_bytes": capacity_bytes,
            "headroom_bytes": headroom,
            "headroom_frac": self._headroom_frac,
            "fits": fits,
            "source": cap["source"],
        }

    def record_refusal(self, verdict: Dict[str, Any]) -> None:
        """Count + remember a headroom-gated admission refusal (surfaced
        through getSolverHealth and the SOLVER_CAPACITY_REFUSED sample)."""
        with self._lock:
            self.capacity_refusals += 1
            self.last_refusal = {
                "layout": verdict.get("layout"),
                "n_nodes": verdict.get("n_nodes"),
                "predicted_bytes": verdict.get("predicted_bytes"),
                "capacity_bytes": verdict.get("capacity_bytes"),
                "headroom_bytes": verdict.get("headroom_bytes"),
                "source": verdict.get("source"),
            }


# -- process-global default ledger -------------------------------------

_LEDGER = MemLedger()


def get_ledger() -> MemLedger:
    """The process-global ledger (the default accounting domain — the
    compile caches and bench's raw-jit paths are process-wide, so the
    default ledger is too). Tests needing isolation construct their own
    `MemLedger` and pass it to the structures they build."""
    return _LEDGER
