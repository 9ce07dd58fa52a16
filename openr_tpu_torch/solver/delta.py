"""DeltaPath route build: O(changes) per event instead of O(table).

The warm solver repairs only the distance entries an LSDB event touched
(ops/spf.py:_sell_solver_warm) and reports exactly WHICH destination
columns moved (`_AreaSolve.take_route_delta`). This module closes the
remaining host-side gap: instead of rebuilding the whole RouteDatabase and diffing it against
the previous one (`get_route_delta`, O(prefixes) per event even for a
single link flap), `DeltaRouteBuilder` recomputes only the prefixes and
node-label routes the device delta names and emits the
`DecisionRouteUpdate` directly — the DeltaPath end-to-end difference
propagation (PAPERS.md, arxiv 1808.06893) on the host side.

This is the port's copy of the JAX package's DeltaRouteBuilder; it drives
`CudaSpfSolver` (solver/cuda.py) the same way.

Soundness: a route entry from `my_node_name`'s perspective is a function of
(a) the distance columns of its announcers / label targets, (b) my own
out-link attributes (the nexthop triangle's weight column, link up/down,
addresses), (c) the transit/overload mask, (d) node labels, and (e) the
prefix advertisements themselves. The device delta covers (a) exactly; the
solver refuses to produce a delta for events touching (b) or (c)
(`_AreaSolve._finish_delta` qualification), Decision forces the full path
for (d) and batches that structurally change the LSDB, and Decision feeds
(e) in as explicit dirty prefixes. SR_MPLS-forwarding prefixes (KSP2 path
traces can move on edges no distance column reflects) are always dirty via
`PrefixState.mpls_forwarding_prefixes`. RFC 5286 LFA adds exactly one
input beyond the announcer columns — the ME column, read by every
alt-neighbor row's inequality threshold — so with an APSP-capable solver
(`lfa_delta_ready`, docs/Apsp.md) the delta path stays enabled under
`compute_lfa_paths`: the solver's poll answers None whenever the changed
set contains me (poisoning exactly the events whose LFA thresholds moved),
and every other LFA input is a changed-announcer column the dirty set
already covers. Solvers without a resident APSP state keep the historical
force-full behavior. Everything else is provably unchanged and is neither
recomputed nor diffed.

The correctness backstop is the SolverSupervisor's route-delta shadow audit
(`verify_route_delta`, solver/supervisor.py), which Decision reaches after
every delta build: every Nth delta-built db is compared against a full
rebuild, and a mismatch self-heals exactly like a warm-state audit hit
(the warm state is dropped and the full db is served). While the breaker is
open the supervisor's `poll_device_delta` answers None, so every event
takes the full path through the CPU oracle. A kernel fault
(`supervisor.is_kernel_fault`) opens no breaker: it raises out of the full
build to Decision.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Set, Tuple

from openr_tpu_torch.solver.routes import (
    DecisionRouteDb,
    DecisionRouteUpdate,
    apply_route_delta,
    get_route_delta,
)
from openr_tpu_torch.types import is_mpls_label_valid

log = logging.getLogger(__name__)


class DeltaRouteBuilder:
    """Builds (new route db, update) per rebuild, taking the O(changes)
    partial path whenever the solver offers a device delta and the event
    class qualifies, else the classic full build + diff. Owned by Decision;
    drivable synchronously by tests without an event loop."""

    def __init__(self, solver) -> None:
        self.solver = solver
        # label -> set of nodes advertising it (collision detection for the
        # partial node-label rebuild); rebuilt lazily after any full build,
        # so it can never span a structural change
        self._label_index: Optional[Dict[int, Set[str]]] = None
        self.last_error: Optional[BaseException] = None
        self.delta_builds = 0
        self.full_builds = 0

    # ------------------------------------------------------------------

    def build(
        self,
        my_node_name: str,
        area_link_states: Dict,
        prefix_state,
        prev_db: Optional[DecisionRouteDb],
        *,
        dirty_prefixes: Set = frozenset(),
        force_full: bool = False,
        policy_fn: Optional[Callable] = None,
    ) -> Tuple[Optional[DecisionRouteDb], Optional[DecisionRouteUpdate], bool]:
        """Returns (new_db, update, used_delta). new_db is None when this
        node is in no area's graph (build_route_db contract). policy_fn, if
        given, is applied to every (re)computed unicast entry before
        diffing — the RibPolicy hook."""
        self.last_error = None
        changed_nodes: Optional[Set[str]] = None
        try:
            # always drain the solver's accumulated delta, even when this
            # rebuild is forced full — a stale column set left pending
            # would otherwise ride into a later event's dirty set
            changed_nodes = self.solver.poll_device_delta(area_link_states)
        except Exception as exc:  # solve fault: the full path's supervised
            self.last_error = exc  # build_route_db owns retry/fallback
            log.warning("device delta poll failed: %s", exc)
        lfa_on = getattr(self.solver, "compute_lfa_paths", False)
        lfa_ready = getattr(self.solver, "lfa_delta_ready", None)
        if (
            changed_nodes is not None
            and not force_full
            and prev_db is not None
            and (not lfa_on or (lfa_ready is not None and lfa_ready()))
        ):
            try:
                out = self._build_delta(
                    my_node_name,
                    area_link_states,
                    prefix_state,
                    prev_db,
                    changed_nodes,
                    set(dirty_prefixes),
                    policy_fn,
                )
                if out is not None:
                    self.delta_builds += 1
                    return out[0], out[1], True
            except Exception as exc:
                # a delta-path bug must degrade to the full build, never
                # wedge convergence
                self.last_error = exc
                log.exception("delta route build failed; falling back")
        return self._build_full(
            my_node_name, area_link_states, prefix_state, prev_db, policy_fn
        )

    # ------------------------------------------------------------------

    def _build_full(
        self, my_node_name, area_link_states, prefix_state, prev_db, policy_fn
    ):
        new_db = self.solver.build_route_db(
            my_node_name, area_link_states, prefix_state
        )
        self._label_index = None  # labels may have moved; rebuild lazily
        self.full_builds += 1
        if new_db is None:
            return None, None, False
        if policy_fn is not None:
            for entry in new_db.unicast_entries.values():
                policy_fn(entry)
        delta = get_route_delta(new_db, prev_db or DecisionRouteDb())
        return new_db, delta, False

    def _build_delta(
        self,
        my_node_name: str,
        area_link_states: Dict,
        prefix_state,
        prev_db: DecisionRouteDb,
        changed_nodes: Set[str],
        dirty_prefixes: Set,
        policy_fn: Optional[Callable],
    ) -> Optional[Tuple[DecisionRouteDb, DecisionRouteUpdate]]:
        """The partial rebuild; None bails to the full path (collision
        cases whose arbitration needs the whole table)."""
        dirty = dirty_prefixes
        dirty |= prefix_state.prefixes_for_nodes(changed_nodes)
        dirty |= set(prefix_state.mpls_forwarding_prefixes)

        update = DecisionRouteUpdate()
        scratch: Dict = {}
        for prefix in sorted(dirty):
            prefix_entries = prefix_state.prefixes.get(prefix)
            new_entry = None
            if prefix_entries:
                self.solver.build_unicast_route(
                    scratch,
                    my_node_name,
                    prefix,
                    prefix_entries,
                    area_link_states,
                    prefix_state,
                )
                new_entry = scratch.pop(prefix, None)
            old_entry = prev_db.unicast_entries.get(prefix)
            if new_entry is None:
                if old_entry is not None:
                    update.unicast_routes_to_delete.append(prefix)
                continue
            if policy_fn is not None:
                policy_fn(new_entry)
            if old_entry is None or old_entry != new_entry:
                update.unicast_routes_to_update.append(new_entry)

        # node-label routes of the changed destinations (their distance /
        # nexthop set moved); adjacency-label routes depend only on my own
        # links, which never qualify for the delta path
        label_index = self._ensure_label_index(area_link_states)
        for area, link_state in sorted(area_link_states.items()):
            adj_dbs = link_state.get_adjacency_databases()
            for node in sorted(changed_nodes):
                adj_db = adj_dbs.get(node)
                if adj_db is None:
                    continue
                label = adj_db.node_label
                if label == 0 or not is_mpls_label_valid(label):
                    continue
                if len(label_index.get(label, ())) > 1:
                    # duplicate-label arbitration scans the whole table:
                    # leave it to the full path
                    return None
                entry = self.solver.build_node_label_route(
                    my_node_name, area, adj_db, area_link_states
                )
                old = prev_db.mpls_entries.get(label)
                if entry is None:
                    if old is not None:
                        update.mpls_routes_to_delete.append(label)
                elif old is None or old != entry:
                    update.mpls_routes_to_update.append(entry)

        return apply_route_delta(prev_db, update), update

    def _ensure_label_index(self, area_link_states) -> Dict[int, Set[str]]:
        """node-label -> advertising nodes, across areas. Built once per
        full build (labels only move in batches that force the full path),
        so delta events pay O(changes) lookups, not an O(n) scan."""
        if self._label_index is None:
            index: Dict[int, Set[str]] = {}
            for link_state in area_link_states.values():
                for adj_db in link_state.get_adjacency_databases().values():
                    if adj_db.node_label:
                        index.setdefault(adj_db.node_label, set()).add(
                            adj_db.this_node_name
                        )
            self._label_index = index
        return self._label_index
