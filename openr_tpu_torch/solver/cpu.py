"""CPU SpfSolver — the faithful route-computation oracle.

Behavioral port of openr/decision/Decision.cpp SpfSolver/SpfSolverImpl
(:90-1271): per-prefix best-announcer selection, ECMP (openr + BGP
metric-vector), LFA (RFC 5286), 2-edge-disjoint K-shortest-path routes with
MPLS label stacks, node-label (SWAP/PHP/POP) and adjacency-label routes, and
drained-node filtering. The TPU solver must match this output bit-for-bit on
every topology; tests enforce it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from openr_tpu_torch.lsdb.link_state import Link, LinkState, Path, path_a_in_path_b
from openr_tpu_torch.utils.counters import CountersMixin, HistogramsMixin
from openr_tpu_torch.lsdb.prefix_state import PrefixState
from openr_tpu_torch.solver.metric_vector import (
    CompareResult,
    compare_metric_vectors,
    create_igp_cost_entity,
    get_metric_entity_by_type,
    OPENR_IGP_COST_TYPE,
)
from openr_tpu_torch.solver.routes import (
    DecisionRouteDb,
    DecisionRouteUpdate,
    RibMplsEntry,
    RibUnicastEntry,
)
from openr_tpu_torch.types import (
    IpPrefix,
    MetricVector,
    MplsAction,
    MplsActionCode,
    NextHop,
    PrefixEntry,
    PrefixForwardingAlgorithm,
    PrefixForwardingType,
    PrefixType,
    is_mpls_label_valid,
)

Metric = int
INF_METRIC = 1 << 62


@dataclass
class BestPathCalResult:
    """Result of best-announcing-node selection (Decision.h BestPathCalResult)."""

    success: bool = False
    nodes: Set[str] = field(default_factory=set)
    best_node: str = ""
    best_area: str = ""
    areas: Set[str] = field(default_factory=set)
    best_vector: Optional[MetricVector] = None
    best_igp_metric: Optional[int] = None


def get_prefix_forwarding_type(
    prefix_entries: Dict[str, Dict[str, PrefixEntry]],
) -> PrefixForwardingType:
    """Minimum forwarding type across advertisements: every announcer must
    support SR_MPLS for it to be used (openr/common/Util.cpp semantics)."""
    result = PrefixForwardingType.SR_MPLS
    for areas in prefix_entries.values():
        for entry in areas.values():
            if entry.forwarding_type == PrefixForwardingType.IP:
                return PrefixForwardingType.IP
    return result


def get_prefix_forwarding_algorithm(
    prefix_entries: Dict[str, Dict[str, PrefixEntry]],
) -> PrefixForwardingAlgorithm:
    """Minimum forwarding algorithm across advertisements."""
    for areas in prefix_entries.values():
        for entry in areas.values():
            if entry.forwarding_algorithm == PrefixForwardingAlgorithm.SP_ECMP:
                return PrefixForwardingAlgorithm.SP_ECMP
    return PrefixForwardingAlgorithm.KSP2_ED_ECMP


class SpfSolver(CountersMixin, HistogramsMixin):
    """Route computation from one node's perspective (Decision.cpp:90)."""

    def __init__(
        self,
        my_node_name: str,
        enable_v4: bool = True,
        compute_lfa_paths: bool = False,
        enable_ordered_fib: bool = False,
        bgp_dry_run: bool = False,
        bgp_use_igp_metric: bool = False,
    ) -> None:
        self.my_node_name = my_node_name
        self.enable_v4 = enable_v4
        self.compute_lfa_paths = compute_lfa_paths
        self.enable_ordered_fib = enable_ordered_fib
        self.bgp_dry_run = bgp_dry_run
        self.bgp_use_igp_metric = bgp_use_igp_metric
        # static MPLS routes pushed from the plugin seam (Decision.cpp:868-907)
        self._static_mpls_routes: Dict[int, Set[NextHop]] = {}
        self._static_updates: List[Tuple[Dict[int, Set[NextHop]], Set[int]]] = []
        self.counters: Dict[str, int] = {}
        self.histograms: Dict = {}

    # ------------------------------------------------------------------
    # SPF access seam — the TPU backend overrides these two methods to
    # serve distances/nexthop-sets from the batched device solve while the
    # whole route-assembly pipeline below is shared between backends
    # ------------------------------------------------------------------

    def _spf(self, link_state: LinkState, node: str):
        """SpfResult-like mapping dest -> object with .metric/.next_hops."""
        with self._timer("decision.spf.solve_ms"):
            return link_state.get_spf_result(node)

    def _dist(self, link_state: LinkState, a: str, b: str) -> Optional[Metric]:
        return link_state.get_metric_from_a_to_b(a, b)

    def _kth_paths(
        self, link_state: LinkState, src: str, dest: str, k: int
    ) -> List[Path]:
        """k-th edge-disjoint shortest path set (LinkState.cpp:760-789)."""
        return link_state.get_kth_paths(src, dest, k)

    def _prefetch_kth_paths(
        self, link_state: LinkState, src: str, dests: List[str], k: int
    ) -> None:
        """Batching hook: the TPU backend solves all penalized re-runs for
        `dests` in one device call before the per-dest loop reads them."""

    # ------------------------------------------------------------------
    # static routes (plugin seam)
    # ------------------------------------------------------------------

    def push_static_routes_delta(
        self,
        mpls_to_update: Dict[int, Set[NextHop]],
        mpls_to_delete: Set[int],
    ) -> None:
        self._static_updates.append(
            (
                {label: set(nhs) for label, nhs in mpls_to_update.items()},
                set(mpls_to_delete),
            )
        )

    def static_routes_updated(self) -> bool:
        return bool(self._static_updates)

    def process_static_route_updates(self) -> Optional[DecisionRouteUpdate]:
        to_update: Dict[int, Set[NextHop]] = {}
        to_delete: Set[int] = set()
        for upd, dels in self._static_updates:
            for label, nhs in upd.items():
                to_update[label] = nhs
                to_delete.discard(label)
            for label in dels:
                to_delete.add(label)
                to_update.pop(label, None)
        self._static_updates.clear()
        if not to_update and not to_delete:
            return None
        ret = DecisionRouteUpdate()
        for label, nhs in to_update.items():
            self._static_mpls_routes[label] = nhs
            ret.mpls_routes_to_update.append(RibMplsEntry(label, set(nhs)))
        for label in to_delete:
            self._static_mpls_routes.pop(label, None)
            ret.mpls_routes_to_delete.append(label)
        return ret

    @property
    def static_mpls_routes(self) -> Dict[int, Set[NextHop]]:
        return self._static_mpls_routes

    # ------------------------------------------------------------------
    # main pipeline
    # ------------------------------------------------------------------

    def build_route_db(
        self,
        my_node_name: str,
        area_link_states: Dict[str, LinkState],
        prefix_state: PrefixState,
    ) -> Optional[DecisionRouteDb]:
        """Decision.cpp:291-542. None if this node is in no area's graph."""
        if not any(
            ls.has_node(my_node_name) for ls in area_link_states.values()
        ):
            return None

        route_db = DecisionRouteDb()
        self._bump("decision.route_build_runs")

        # ---- unicast best paths (IP and IP2MPLS) ----
        for prefix, prefix_entries in prefix_state.prefixes.items():
            self.build_unicast_route(
                route_db.unicast_entries,
                my_node_name,
                prefix,
                prefix_entries,
                area_link_states,
                prefix_state,
            )

        # ---- MPLS node-label routes (Decision.cpp:415-501) ----
        label_to_node: Dict[int, Tuple[str, RibMplsEntry]] = {}
        for area, link_state in area_link_states.items():
            for adj_db in link_state.get_adjacency_databases().values():
                top_label = adj_db.node_label
                if top_label == 0:
                    continue
                if not is_mpls_label_valid(top_label):
                    self._bump("decision.skipped_mpls_route")
                    continue
                # node-label collision: bigger node name keeps the label
                existing = label_to_node.get(top_label)
                if existing is not None:
                    self._bump("decision.duplicate_node_label")
                    if existing[0] < adj_db.this_node_name:
                        continue
                entry = self.build_node_label_route(
                    my_node_name, area, adj_db, area_link_states
                )
                if entry is None:
                    continue
                label_to_node[top_label] = (adj_db.this_node_name, entry)
        for label, (_, entry) in label_to_node.items():
            route_db.mpls_entries[label] = entry

        # ---- MPLS adjacency-label routes (Decision.cpp:503-534) ----
        for link_state in area_link_states.values():
            for link in link_state.ordered_links_from_node(my_node_name):
                top_label = link.adj_label_from_node(my_node_name)
                if top_label == 0:
                    continue
                if not is_mpls_label_valid(top_label):
                    self._bump("decision.skipped_mpls_route")
                    continue
                route_db.mpls_entries[top_label] = RibMplsEntry(
                    top_label,
                    {
                        NextHop(
                            address=link.nh_v6_from_node(my_node_name),
                            iface=link.iface_from_node(my_node_name),
                            metric=link.metric_from_node(my_node_name),
                            mpls_action=MplsAction(MplsActionCode.PHP),
                            area=link.area,
                            neighbor_node=link.other_node_name(my_node_name),
                        )
                    },
                )
        return route_db

    def build_unicast_route(
        self,
        unicast_entries: Dict[IpPrefix, RibUnicastEntry],
        my_node_name: str,
        prefix: IpPrefix,
        prefix_entries: Dict[str, Dict[str, PrefixEntry]],
        area_link_states: Dict[str, LinkState],
        prefix_state: PrefixState,
    ) -> None:
        """One prefix's best-path selection + nexthop assembly (the body of
        build_route_db's unicast loop), writing the entry — if any — into
        `unicast_entries`. Exposed as a seam so the DeltaPath route build
        (solver/delta.py) can recompute exactly the prefixes a device
        delta names instead of looping the whole table."""
        has_bgp = has_non_bgp = missing_mv = False
        for node, areas in prefix_entries.items():
            for entry in areas.values():
                is_bgp = entry.type == PrefixType.BGP
                has_bgp |= is_bgp
                has_non_bgp |= not is_bgp
                if is_bgp and entry.mv is None:
                    missing_mv = True
        if has_bgp:
            if has_non_bgp or missing_mv:
                # mixed-type or malformed BGP advertisement: skip route
                self._bump("decision.skipped_unicast_route")
                return

        # prefixes advertised by me (non-BGP): no route needed
        if my_node_name in prefix_entries and not has_bgp:
            return

        is_v4 = prefix.is_v4
        if is_v4 and not self.enable_v4:
            self._bump("decision.skipped_unicast_route")
            return

        fwd_algo = get_prefix_forwarding_algorithm(prefix_entries)
        fwd_type = get_prefix_forwarding_type(prefix_entries)

        if fwd_type == PrefixForwardingType.SR_MPLS:
            # SP_ECMP or KSP2 on the MPLS data plane
            nodes = self.get_best_announcing_nodes(
                my_node_name,
                prefix,
                prefix_entries,
                has_bgp,
                True,
                area_link_states,
            )
            if not nodes.success or not nodes.nodes:
                return
            self._select_ksp2(
                unicast_entries,
                prefix,
                my_node_name,
                nodes,
                prefix_entries,
                has_bgp,
                area_link_states,
                prefix_state,
                fwd_algo,
            )
        elif fwd_algo == PrefixForwardingAlgorithm.SP_ECMP:
            if has_bgp:
                self._select_ecmp_bgp(
                    unicast_entries,
                    my_node_name,
                    prefix,
                    prefix_entries,
                    is_v4,
                    area_link_states,
                    prefix_state,
                )
            else:
                self._select_ecmp_openr(
                    unicast_entries,
                    my_node_name,
                    prefix,
                    prefix_entries,
                    is_v4,
                    area_link_states,
                )
        else:
            self._bump("decision.incompatible_forwarding_type")

    def build_node_label_route(
        self,
        my_node_name: str,
        area: str,
        adj_db,
        area_link_states: Dict[str, LinkState],
    ) -> Optional[RibMplsEntry]:
        """One node's MPLS node-label route (POP_AND_LOOKUP for my own
        label, SWAP/PHP nexthops toward everyone else's), or None when the
        node is unreachable. Collision arbitration stays with the caller.
        Shared by build_route_db and the DeltaPath partial rebuild."""
        top_label = adj_db.node_label
        if adj_db.this_node_name == my_node_name:
            # our own label: POP_AND_LOOKUP
            return RibMplsEntry(
                top_label,
                {
                    NextHop(
                        address="::",
                        area=area,
                        mpls_action=MplsAction(
                            MplsActionCode.POP_AND_LOOKUP
                        ),
                    )
                },
            )
        min_metric, nh_nodes = self.get_next_hops_with_metric(
            my_node_name,
            {adj_db.this_node_name},
            False,
            area_link_states,
        )
        if not nh_nodes:
            self._bump("decision.no_route_to_label")
            return None
        return RibMplsEntry(
            top_label,
            self.get_next_hops(
                my_node_name,
                {adj_db.this_node_name},
                False,
                False,
                min_metric,
                nh_nodes,
                top_label,
                area_link_states,
                {area},
            ),
        )

    def poll_device_delta(self, area_link_states) -> Optional[set]:
        """DeltaPath seam: backends without device-resident distance state
        have no device delta to offer — the route build always takes the
        full path (the TPU backend overrides this)."""
        return None

    # ------------------------------------------------------------------
    # best announcing nodes
    # ------------------------------------------------------------------

    def get_best_announcing_nodes(
        self,
        my_node_name: str,
        prefix: IpPrefix,
        prefix_entries: Dict[str, Dict[str, PrefixEntry]],
        has_bgp: bool,
        use_ksp2: bool,
        area_link_states: Dict[str, LinkState],
    ) -> BestPathCalResult:
        """Decision.cpp:544-630."""
        ret = BestPathCalResult()

        if not has_bgp:
            # openr routes: all reachable announcers are "best"
            if my_node_name in prefix_entries:
                return BestPathCalResult()
            for node, areas in sorted(prefix_entries.items()):
                for area in sorted(areas):
                    link_state = area_link_states.get(area)
                    if link_state is None:
                        continue
                    spf = self._spf(link_state, my_node_name)
                    if node not in spf:
                        continue  # unreachable
                    if not ret.best_node or node < ret.best_node:
                        ret.best_node = node
                        ret.best_area = area
                    ret.nodes.add(node)
                    ret.areas.add(area)
            ret.success = True
            return self._maybe_filter_drained_nodes(ret, area_link_states)

        ret = self._run_best_path_selection_bgp(
            my_node_name, prefix, prefix_entries, area_link_states
        )
        if not ret.success:
            self._bump("decision.no_route_to_prefix")
            return BestPathCalResult()

        if not use_ksp2:
            if my_node_name in ret.nodes:
                # best path originated by self: no route
                return BestPathCalResult()
            return self._maybe_filter_drained_nodes(ret, area_link_states)

        # ksp2: self-originated prefixes still get routes when other
        # announcers exist and we have a prepend label (anycast case)
        label_exists_for_me = False
        if my_node_name in prefix_entries:
            label_exists_for_me = any(
                e.prepend_label is not None
                for e in prefix_entries[my_node_name].values()
            )
        if my_node_name not in ret.nodes or (
            len(ret.nodes) > 1 and label_exists_for_me
        ):
            return self._maybe_filter_drained_nodes(ret, area_link_states)
        return BestPathCalResult()

    def _run_best_path_selection_bgp(
        self,
        my_node_name: str,
        prefix: IpPrefix,
        prefix_entries: Dict[str, Dict[str, PrefixEntry]],
        area_link_states: Dict[str, LinkState],
    ) -> BestPathCalResult:
        """Metric-vector tournament across announcers (Decision.cpp:714-800)."""
        ret = BestPathCalResult()
        for node, areas in sorted(prefix_entries.items()):
            for area, entry in sorted(areas.items()):
                link_state = area_link_states.get(area)
                if link_state is None:
                    continue
                spf = self._spf(link_state, my_node_name)
                if node not in spf:
                    continue
                assert entry.mv is not None
                if get_metric_entity_by_type(entry.mv, OPENR_IGP_COST_TYPE):
                    # unexpected pre-existing IGP entity: ignore announcer
                    continue
                metric_vector = entry.mv
                if self.bgp_use_igp_metric:
                    igp_metric = spf[node].metric
                    if ret.best_igp_metric is None or ret.best_igp_metric > igp_metric:
                        ret.best_igp_metric = igp_metric
                    metric_vector = MetricVector(
                        version=entry.mv.version,
                        metrics=entry.mv.metrics
                        + (create_igp_cost_entity(igp_metric),),
                    )
                if ret.best_vector is None:
                    result = CompareResult.WINNER
                else:
                    result = compare_metric_vectors(
                        metric_vector, ret.best_vector
                    )
                if result == CompareResult.WINNER:
                    ret.nodes.clear()
                    ret.best_vector = metric_vector
                    ret.best_node = node
                    ret.best_area = area
                    ret.nodes.add(node)
                    ret.areas.add(area)
                elif result == CompareResult.TIE_WINNER:
                    ret.best_vector = metric_vector
                    ret.best_node = node
                    ret.best_area = area
                    ret.nodes.add(node)
                    ret.areas.add(area)
                elif result == CompareResult.TIE_LOOSER:
                    ret.nodes.add(node)
                    ret.areas.add(area)
                elif result in (CompareResult.TIE, CompareResult.ERROR):
                    # ambiguous ordering: no route (Decision.cpp:784-792)
                    return ret
        ret.success = True
        return self._maybe_filter_drained_nodes(ret, area_link_states)

    def _maybe_filter_drained_nodes(
        self,
        result: BestPathCalResult,
        area_link_states: Dict[str, LinkState],
    ) -> BestPathCalResult:
        """Drop overloaded announcers unless all are overloaded
        (Decision.cpp:651-666)."""
        filtered = set(result.nodes)
        for link_state in area_link_states.values():
            filtered = {
                n for n in filtered if not link_state.is_node_overloaded(n)
            }
        if filtered and filtered != result.nodes:
            out = BestPathCalResult(
                success=result.success,
                nodes=filtered,
                best_node=result.best_node,
                best_area=result.best_area,
                areas=result.areas,
                best_vector=result.best_vector,
                best_igp_metric=result.best_igp_metric,
            )
            return out
        return result

    # ------------------------------------------------------------------
    # ECMP
    # ------------------------------------------------------------------

    def _select_ecmp_openr(
        self,
        unicast_entries: Dict[IpPrefix, RibUnicastEntry],
        my_node_name: str,
        prefix: IpPrefix,
        prefix_entries: Dict[str, Dict[str, PrefixEntry]],
        is_v4: bool,
        area_link_states: Dict[str, LinkState],
    ) -> None:
        """Decision.cpp:668-712."""
        ret = self.get_best_announcing_nodes(
            my_node_name, prefix, prefix_entries, False, False, area_link_states
        )
        if not ret.success:
            return
        per_destination = (
            get_prefix_forwarding_type(prefix_entries)
            == PrefixForwardingType.SR_MPLS
        )
        min_metric, nh_nodes = self.get_next_hops_with_metric(
            my_node_name, ret.nodes, per_destination, area_link_states
        )
        if not nh_nodes:
            self._bump("decision.no_route_to_prefix")
            return
        unicast_entries[prefix] = RibUnicastEntry(
            prefix=prefix,
            nexthops=self.get_next_hops(
                my_node_name,
                ret.nodes,
                is_v4,
                per_destination,
                min_metric,
                nh_nodes,
                None,
                area_link_states,
                ret.areas,
            ),
            best_prefix_entry=prefix_entries[ret.best_node][ret.best_area],
            best_area=ret.best_area,
        )

    def _select_ecmp_bgp(
        self,
        unicast_entries: Dict[IpPrefix, RibUnicastEntry],
        my_node_name: str,
        prefix: IpPrefix,
        prefix_entries: Dict[str, Dict[str, PrefixEntry]],
        is_v4: bool,
        area_link_states: Dict[str, LinkState],
        prefix_state: PrefixState,
    ) -> None:
        """Decision.cpp:802-866."""
        dst_info = self.get_best_announcing_nodes(
            my_node_name, prefix, prefix_entries, True, False, area_link_states
        )
        if not dst_info.success:
            return
        if not dst_info.nodes or my_node_name in dst_info.nodes:
            if my_node_name not in dst_info.nodes:
                self._bump("decision.no_route_to_prefix")
            return
        best_next_hop = prefix_state.get_loopback_vias(
            {dst_info.best_node}, is_v4, dst_info.best_igp_metric
        )
        if len(best_next_hop) != 1:
            self._bump("decision.missing_loopback_addr")
            return
        min_metric, nh_nodes = self.get_next_hops_with_metric(
            my_node_name, dst_info.nodes, False, area_link_states
        )
        if not nh_nodes:
            self._bump("decision.no_route_to_prefix")
            return
        unicast_entries[prefix] = RibUnicastEntry(
            prefix=prefix,
            nexthops=self.get_next_hops(
                my_node_name,
                dst_info.nodes,
                is_v4,
                False,
                min_metric,
                nh_nodes,
                None,
                area_link_states,
                dst_info.areas,
            ),
            best_prefix_entry=prefix_entries[dst_info.best_node][
                dst_info.best_area
            ],
            best_area=dst_info.best_area,
            do_not_install=self.bgp_dry_run,
            best_nexthop=best_next_hop[0],
        )

    # ------------------------------------------------------------------
    # KSP2
    # ------------------------------------------------------------------

    def _select_ksp2(
        self,
        unicast_entries: Dict[IpPrefix, RibUnicastEntry],
        prefix: IpPrefix,
        my_node_name: str,
        best_path_result: BestPathCalResult,
        prefix_entries: Dict[str, Dict[str, PrefixEntry]],
        has_bgp: bool,
        area_link_states: Dict[str, LinkState],
        prefix_state: PrefixState,
        fwd_algo: PrefixForwardingAlgorithm,
    ) -> None:
        """Decision.cpp:909-1066: shortest + second-shortest edge-disjoint
        paths with MPLS PUSH label stacks."""
        entry = RibUnicastEntry(prefix=prefix)
        self_node_contained = False
        paths: List[List[Link]] = []

        dests = sorted(n for n in best_path_result.nodes if n != my_node_name)
        for link_state in area_link_states.values():
            self._prefetch_kth_paths(link_state, my_node_name, dests, 1)
            for node in sorted(best_path_result.nodes):
                if node == my_node_name:
                    self_node_contained = True
                    continue
                paths.extend(self._kth_paths(link_state, my_node_name, node, 1))

            if fwd_algo == PrefixForwardingAlgorithm.KSP2_ED_ECMP:
                self._prefetch_kth_paths(link_state, my_node_name, dests, 2)
                first_paths_len = len(paths)
                for node in sorted(best_path_result.nodes):
                    if node == my_node_name:
                        continue
                    for sec_path in self._kth_paths(
                        link_state, my_node_name, node, 2
                    ):
                        # avoid double-spray: drop second paths containing a
                        # first path (anycast full-mesh case)
                        if not any(
                            path_a_in_path_b(paths[i], sec_path)
                            for i in range(first_paths_len)
                        ):
                            paths.append(sec_path)

        if not paths:
            return

        for path in paths:
            # walk the path to accumulate cost and the label stack
            area = path[0].area
            link_state = area_link_states[area]
            adj_dbs = link_state.get_adjacency_databases()
            cost = 0
            labels: List[int] = []  # front = bottom of stack
            next_node = my_node_name
            for link in path:
                cost += link.metric_from_node(next_node)
                next_node = link.other_node_name(next_node)
                labels.insert(0, adj_dbs[next_node].node_label)
            labels.pop()  # drop first-hop node's label (PHP)
            dest_entry = prefix_entries.get(next_node, {}).get(area)
            if dest_entry is None:
                # path traced through an area where the destination did not
                # advertise this prefix (multi-area): skip this path
                continue
            if dest_entry.prepend_label is not None:
                labels.insert(0, dest_entry.prepend_label)

            first_link = path[0]
            mpls_action = (
                MplsAction(MplsActionCode.PUSH, push_labels=tuple(labels))
                if labels
                else None
            )
            entry.nexthops.add(
                NextHop(
                    address=(
                        first_link.nh_v4_from_node(my_node_name)
                        if prefix.is_v4
                        else first_link.nh_v6_from_node(my_node_name)
                    ),
                    iface=first_link.iface_from_node(my_node_name),
                    metric=cost,
                    mpls_action=mpls_action,
                    use_non_shortest_route=True,
                    area=first_link.area,
                    neighbor_node=first_link.other_node_name(my_node_name),
                )
            )

        static_nexthops = 0
        if self_node_contained:
            # anycast advertised by us too: include the static nexthops the
            # destination prepared behind our prepend label
            my_entries = prefix_entries[my_node_name]
            my_entry = next(iter(my_entries.values()))
            label = my_entry.prepend_label
            static_nhs = (
                self._static_mpls_routes.get(label) if label is not None else None
            )
            if static_nhs:
                for nh in static_nhs:
                    static_nexthops += 1
                    entry.nexthops.add(
                        NextHop(
                            address=nh.address,
                            metric=0,
                            use_non_shortest_route=True,
                            area=next(iter(my_entries.keys())),
                        )
                    )

        # minNexthop threshold (Decision.cpp:1041-1051)
        min_next_hop = self._get_min_nexthop_threshold(
            best_path_result, prefix_entries
        )
        dynamic = len(entry.nexthops) - static_nexthops
        if min_next_hop is not None and min_next_hop > dynamic:
            return

        if has_bgp:
            best_next_hop = prefix_state.get_loopback_vias(
                {best_path_result.best_node},
                prefix.is_v4,
                best_path_result.best_igp_metric,
            )
            if len(best_next_hop) == 1:
                entry.best_nexthop = best_next_hop[0]
                entry.best_prefix_entry = prefix_entries[
                    best_path_result.best_node
                ][best_path_result.best_area]
                entry.do_not_install = self.bgp_dry_run
        else:
            entry.best_prefix_entry = prefix_entries.get(
                best_path_result.best_node, {}
            ).get(best_path_result.best_area)
            entry.best_area = best_path_result.best_area

        unicast_entries[prefix] = entry

    def _get_min_nexthop_threshold(
        self,
        nodes: BestPathCalResult,
        prefix_entries: Dict[str, Dict[str, PrefixEntry]],
    ) -> Optional[int]:
        """Max of announcers' minNexthop requirements (Decision.cpp:632-649)."""
        result: Optional[int] = None
        for node in nodes.nodes:
            for entry in prefix_entries.get(node, {}).values():
                if entry.min_nexthop is not None and (
                    result is None or entry.min_nexthop > result
                ):
                    result = entry.min_nexthop
        return result

    # ------------------------------------------------------------------
    # nexthop computation
    # ------------------------------------------------------------------

    @staticmethod
    def get_min_cost_nodes(
        spf_result, dst_nodes: Set[str]
    ) -> Tuple[Metric, Set[str]]:
        """Closest subset of dst_nodes (Decision.cpp:1068-1091)."""
        shortest = INF_METRIC
        min_cost_nodes: Set[str] = set()
        for dst in dst_nodes:
            res = spf_result.get(dst)
            if res is None:
                continue
            if shortest >= res.metric:
                if shortest > res.metric:
                    shortest = res.metric
                    min_cost_nodes = set()
                min_cost_nodes.add(dst)
        return shortest, min_cost_nodes

    def get_next_hops_with_metric(
        self,
        my_node_name: str,
        dst_node_names: Set[str],
        per_destination: bool,
        area_link_states: Dict[str, LinkState],
    ) -> Tuple[Metric, Dict[Tuple[str, str], Metric]]:
        """Nexthop-node candidates with their distance-to-destination
        (Decision.cpp:1093-1179): shortest-path neighbors plus, if enabled,
        RFC 5286 loop-free alternates."""
        next_hop_nodes: Dict[Tuple[str, str], Metric] = {}
        shortest_metric = INF_METRIC

        for link_state in area_link_states.values():
            spf_from_here = self._spf(link_state, my_node_name)
            min_metric, min_cost_nodes = self.get_min_cost_nodes(
                spf_from_here, dst_node_names
            )
            # lowest metric wins across areas; ties merge (ECMP across areas)
            if shortest_metric < min_metric:
                continue
            if shortest_metric > min_metric:
                shortest_metric = min_metric
                next_hop_nodes = {}
            if not min_cost_nodes:
                continue

            for dst in min_cost_nodes:
                dst_ref = dst if per_destination else ""
                for nh in spf_from_here[dst].next_hops:
                    next_hop_nodes[(nh, dst_ref)] = (
                        shortest_metric
                        - self._dist(link_state, my_node_name, nh)
                    )

            if self.compute_lfa_paths:
                for link in link_state.ordered_links_from_node(my_node_name):
                    if not link.is_up():
                        continue
                    neighbor = link.other_node_name(my_node_name)
                    spf_from_neighbor = self._spf(link_state, neighbor)
                    if my_node_name not in spf_from_neighbor:
                        continue
                    neighbor_to_here = spf_from_neighbor[my_node_name].metric
                    for dst in dst_node_names:
                        res = spf_from_neighbor.get(dst)
                        if res is None:
                            continue
                        dist_from_neighbor = res.metric
                        # RFC 5286 LFA condition (Decision.cpp:1163)
                        if dist_from_neighbor < shortest_metric + neighbor_to_here:
                            key = (neighbor, dst if per_destination else "")
                            prev = next_hop_nodes.get(key)
                            if prev is None or prev > dist_from_neighbor:
                                next_hop_nodes[key] = dist_from_neighbor
        return shortest_metric, next_hop_nodes

    def get_next_hops(
        self,
        my_node_name: str,
        dst_node_names: Set[str],
        is_v4: bool,
        per_destination: bool,
        min_metric: Metric,
        next_hop_nodes: Dict[Tuple[str, str], Metric],
        swap_label: Optional[int],
        area_link_states: Dict[str, LinkState],
        prefix_areas: Set[str],
    ) -> Set[NextHop]:
        """Resolve nexthop nodes to concrete adjacency nexthops with MPLS
        actions (Decision.cpp:1181-1271)."""
        assert next_hop_nodes
        next_hops: Set[NextHop] = set()
        dst_refs = sorted(dst_node_names) if per_destination else [""]
        for area, link_state in area_link_states.items():
            if area not in prefix_areas:
                continue
            for link in link_state.ordered_links_from_node(my_node_name):
                for dst_node in dst_refs:
                    neighbor = link.other_node_name(my_node_name)
                    dist_to_dst = next_hop_nodes.get((neighbor, dst_node))
                    if dist_to_dst is None or not link.is_up():
                        continue
                    # don't route to dstA via neighbor dstB (both are dests)
                    if (
                        dst_node
                        and neighbor in dst_node_names
                        and neighbor != dst_node
                    ):
                        continue
                    dist_over_link = (
                        link.metric_from_node(my_node_name) + dist_to_dst
                    )
                    # without LFA only shortest-path links qualify
                    if not self.compute_lfa_paths and dist_over_link != min_metric:
                        continue

                    mpls_action: Optional[MplsAction] = None
                    if swap_label is not None:
                        if neighbor in dst_node_names:
                            mpls_action = MplsAction(MplsActionCode.PHP)
                        else:
                            mpls_action = MplsAction(
                                MplsActionCode.SWAP, swap_label=swap_label
                            )
                    if dst_node and dst_node != neighbor:
                        dst_db = link_state.get_adjacency_databases().get(
                            dst_node
                        )
                        if dst_db is None or not is_mpls_label_valid(
                            dst_db.node_label
                        ):
                            continue
                        dst_label = dst_db.node_label
                        assert mpls_action is None
                        mpls_action = MplsAction(
                            MplsActionCode.PUSH, push_labels=(dst_label,)
                        )

                    next_hops.add(
                        NextHop(
                            address=(
                                link.nh_v4_from_node(my_node_name)
                                if is_v4
                                else link.nh_v6_from_node(my_node_name)
                            ),
                            iface=link.iface_from_node(my_node_name),
                            metric=dist_over_link,
                            mpls_action=mpls_action,
                            area=link.area,
                            neighbor_node=neighbor,
                        )
                    )
        return next_hops

    # ------------------------------------------------------------------

