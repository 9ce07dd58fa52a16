"""Link-state graph with memoized shortest paths — the CPU oracle.

Behavioral port of openr/decision/LinkState.{h,cpp} (structure re-designed for
Python; semantics preserved and cross-checked by tests):
  - HoldableValue (LinkState.h:36-58, LinkState.cpp:54-125): ordered-FIB
    (RFC 6976) value holds — a metric/overload change is masked for a TTL
    chosen by the direction (up vs down) of the change.
  - Link (LinkState.h:82-175): one bidirectional link, keyed by the unordered
    pair of (node, iface) endpoints, carrying per-direction metric/overload
    holds, adjacency labels and nexthop addresses.
  - LinkState (LinkState.h:177-469): graph over Links +
    update_adjacency_database ordered-diff (LinkState.cpp:564-717), Dijkstra
    run_spf with ECMP nexthop-set union and overloaded-node transit pruning
    (LinkState.cpp:806-880), memoization invalidated on topology change
    (LinkState.cpp:712-715), and k-edge-disjoint path enumeration
    get_kth_paths/trace_one_path (LinkState.cpp:760-789, 398-419).

This oracle defines the exact tie-breaking the TPU solver must reproduce:
  - Dijkstra extract-min orders by (metric, nodeName)  (LinkState.h:488-498)
  - relaxation with >= unions nexthop sets for equal-cost paths
    (LinkState.cpp:855-871)
  - overloaded nodes terminate expansion but are themselves reachable
    (LinkState.cpp:829-836)
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from openr_tpu_torch.types import Adjacency, AdjacencyDatabase

Metric = int


class HoldableValue:
    """A value whose previous state can be held for an ordered-FIB TTL."""

    __slots__ = ("_val", "_held_val", "_has_held", "_hold_ttl")

    def __init__(self, val) -> None:
        self._val = val
        self._held_val = None
        self._has_held = False
        self._hold_ttl = 0

    @property
    def value(self):
        return self._held_val if self._has_held else self._val

    def has_hold(self) -> bool:
        return self._has_held

    def assign(self, val) -> None:
        """Unconditional set, clearing any hold (operator= in the reference)."""
        self._val = val
        self._held_val = None
        self._has_held = False
        self._hold_ttl = 0

    def decrement_ttl(self) -> bool:
        """Returns True if an expiring hold changed the visible value."""
        if self._has_held:
            self._hold_ttl -= 1
            if self._hold_ttl == 0:
                self._held_val = None
                self._has_held = False
                return True
        return False

    def update_value(self, val, hold_up_ttl: int, hold_down_ttl: int) -> bool:
        """Returns True if the visible value changed immediately."""
        if val == self._val:
            return False
        if self._has_held:
            # a hold was already pending: fall back to fast update to avoid
            # prolonging transient loops (LinkState.cpp:93-98)
            self._held_val = None
            self._has_held = False
            self._hold_ttl = 0
        else:
            ttl = (
                hold_up_ttl if self._is_change_bringing_up(val) else hold_down_ttl
            )
            self._hold_ttl = ttl
            if ttl != 0:
                self._held_val = self._val
                self._has_held = True
        self._val = val
        return not self._has_held

    def _is_change_bringing_up(self, val) -> bool:
        if isinstance(self._val, bool):
            # clearing an overload is a "bringing up" event
            return self._val and not val
        # lower metric is a "bringing up" event
        return val < self._val


def _hv_value(x):
    """Visible value of a maybe-held slot.

    Link attribute slots hold PLAIN values until a hold is first requested
    (then a HoldableValue) — cold-start ingest builds ~4 slots per link, and
    at 100k-link scale eagerly allocating HoldableValues dominated the
    whole-LSDB ingest profile."""
    return x.value if type(x) is HoldableValue else x


def _hv_update(cur, val, hold_up_ttl: int, hold_down_ttl: int):
    """update_value on a maybe-held slot; returns (new_slot, visible_changed).

    Plain slots with zero hold TTLs stay plain (straight assignment); a
    nonzero TTL promotes the slot to a HoldableValue carrying the hold."""
    if type(cur) is HoldableValue:
        return cur, cur.update_value(val, hold_up_ttl, hold_down_ttl)
    if val == cur:
        return cur, False
    if hold_up_ttl == 0 and hold_down_ttl == 0:
        return val, True
    hv = HoldableValue(cur)
    return hv, hv.update_value(val, hold_up_ttl, hold_down_ttl)


class Link:
    """A single bidirectional network link (LinkState.h:82)."""

    __slots__ = (
        "area",
        "n1",
        "n2",
        "if1",
        "if2",
        "_metric1",
        "_metric2",
        "_overload1",
        "_overload2",
        "_adj_label1",
        "_adj_label2",
        "_nh_v4_1",
        "_nh_v4_2",
        "_nh_v6_1",
        "_nh_v6_2",
        "_hold_up_ttl",
        "key",
        "_hash",
    )

    def __init__(
        self,
        area: str,
        node1: str,
        adj1: Adjacency,
        node2: str,
        adj2: Adjacency,
    ) -> None:
        self.area = area
        self.n1 = node1
        self.n2 = node2
        self.if1 = adj1.if_name
        self.if2 = adj2.if_name
        # plain values; promoted to HoldableValue on first held update
        # (_hv_update) — see _hv_value for why
        self._metric1 = adj1.metric
        self._metric2 = adj2.metric
        self._overload1 = adj1.is_overloaded
        self._overload2 = adj2.is_overloaded
        self._adj_label1 = adj1.adj_label
        self._adj_label2 = adj2.adj_label
        self._nh_v4_1 = adj1.nexthop_v4
        self._nh_v4_2 = adj2.nexthop_v4
        self._nh_v6_1 = adj1.nexthop_v6
        self._nh_v6_2 = adj2.nexthop_v6
        self._hold_up_ttl = 0
        # essential identity: unordered pair of (node, iface) ordered pairs
        # (LinkState.h:107-110); deterministic across processes (the reference
        # additionally orders by an in-process hash, which is arbitrary)
        p1, p2 = (node1, adj1.if_name), (node2, adj2.if_name)
        self.key: Tuple[Tuple[str, str], Tuple[str, str]] = (
            (p1, p2) if p1 <= p2 else (p2, p1)
        )
        # links live in many sets (link_map, all_links, SPF visited/ignore
        # sets); hashing the nested string tuple per membership op is the
        # single hottest line at 100k-link ingest scale, so cache it
        self._hash = hash(self.key)

    # -- identity ----------------------------------------------------------

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return isinstance(other, Link) and self.key == other.key

    def __lt__(self, other: "Link") -> bool:
        return self.key < other.key

    def first_node_name(self) -> str:
        return self.key[0][0]

    def second_node_name(self) -> str:
        return self.key[1][0]

    # -- directional accessors --------------------------------------------

    def _dir(self, node: str) -> int:
        if node == self.n1:
            return 1
        if node == self.n2:
            return 2
        raise ValueError(f"{node} is not an endpoint of {self}")

    def other_node_name(self, node: str) -> str:
        return self.n2 if self._dir(node) == 1 else self.n1

    def iface_from_node(self, node: str) -> str:
        return self.if1 if self._dir(node) == 1 else self.if2

    def metric_from_node(self, node: str) -> Metric:
        return _hv_value(
            self._metric1 if self._dir(node) == 1 else self._metric2
        )

    def adj_label_from_node(self, node: str) -> int:
        return self._adj_label1 if self._dir(node) == 1 else self._adj_label2

    def overload_from_node(self, node: str) -> bool:
        return _hv_value(
            self._overload1 if self._dir(node) == 1 else self._overload2
        )

    def nh_v4_from_node(self, node: str) -> str:
        return self._nh_v4_1 if self._dir(node) == 1 else self._nh_v4_2

    def nh_v6_from_node(self, node: str) -> str:
        return self._nh_v6_1 if self._dir(node) == 1 else self._nh_v6_2

    def set_nh_v4_from_node(self, node: str, nh: str) -> None:
        if self._dir(node) == 1:
            self._nh_v4_1 = nh
        else:
            self._nh_v4_2 = nh

    def set_nh_v6_from_node(self, node: str, nh: str) -> None:
        if self._dir(node) == 1:
            self._nh_v6_1 = nh
        else:
            self._nh_v6_2 = nh

    def set_metric_from_node(
        self, node: str, metric: Metric, hold_up_ttl: int, hold_down_ttl: int
    ) -> bool:
        if self._dir(node) == 1:
            self._metric1, changed = _hv_update(
                self._metric1, metric, hold_up_ttl, hold_down_ttl
            )
        else:
            self._metric2, changed = _hv_update(
                self._metric2, metric, hold_up_ttl, hold_down_ttl
            )
        return changed

    def set_adj_label_from_node(self, node: str, label: int) -> None:
        if self._dir(node) == 1:
            self._adj_label1 = label
        else:
            self._adj_label2 = label

    def set_overload_from_node(
        self, node: str, overload: bool, hold_up_ttl: int, hold_down_ttl: int
    ) -> bool:
        was_up = self.is_up()
        if self._dir(node) == 1:
            self._overload1, _ = _hv_update(
                self._overload1, overload, hold_up_ttl, hold_down_ttl
            )
        else:
            self._overload2, _ = _hv_update(
                self._overload2, overload, hold_up_ttl, hold_down_ttl
            )
        # simplex overloads unsupported: only a change in effective up-ness is
        # a topology change (LinkState.cpp:342-344)
        return was_up != self.is_up()

    # -- holds -------------------------------------------------------------

    def set_hold_up_ttl(self, ttl: int) -> None:
        self._hold_up_ttl = ttl

    def is_up(self) -> bool:
        return (
            self._hold_up_ttl == 0
            and not _hv_value(self._overload1)
            and not _hv_value(self._overload2)
        )

    def decrement_holds(self) -> bool:
        expired = False
        if self._hold_up_ttl != 0:
            self._hold_up_ttl -= 1
            expired |= self._hold_up_ttl == 0
        for slot in (
            self._metric1, self._metric2, self._overload1, self._overload2
        ):
            if type(slot) is HoldableValue:
                expired |= slot.decrement_ttl()
        return expired

    def has_holds(self) -> bool:
        if self._hold_up_ttl != 0:
            return True
        return any(
            type(slot) is HoldableValue and slot.has_hold()
            for slot in (
                self._metric1, self._metric2, self._overload1, self._overload2
            )
        )

    def __repr__(self) -> str:
        return f"{self.area} - {self.n1}%{self.if1} <---> {self.n2}%{self.if2}"

    def directional_str(self, from_node: str) -> str:
        other = self.other_node_name(from_node)
        return (
            f"{self.area} - {from_node}%{self.iface_from_node(from_node)}"
            f" ---> {other}%{self.iface_from_node(other)}"
        )


class NodeSpfResult:
    """SPF result for one destination: metric, path links, nexthop set.

    path_links is the list of (link, prev_node) pairs on shortest paths into
    this node — enough to trace every shortest path back to the source
    (LinkState.h:203-257).
    """

    __slots__ = ("metric", "path_links", "next_hops")

    def __init__(self, metric: Metric) -> None:
        self.metric: Metric = metric
        self.path_links: List[Tuple[Link, str]] = []
        self.next_hops: Set[str] = set()

    def reset(self, new_metric: Metric) -> None:
        self.metric = new_metric
        self.path_links = []
        self.next_hops = set()


SpfResult = Dict[str, NodeSpfResult]
Path = List[Link]


@dataclass
class LinkStateChange:
    """What an LSDB mutation changed (LinkState.h:306-325)."""

    topology_changed: bool = False
    link_attributes_changed: bool = False
    node_label_changed: bool = False

    def __or__(self, other: "LinkStateChange") -> "LinkStateChange":
        return LinkStateChange(
            self.topology_changed or other.topology_changed,
            self.link_attributes_changed or other.link_attributes_changed,
            self.node_label_changed or other.node_label_changed,
        )


class LinkState:
    """Per-area link-state graph with memoized SPF (LinkState.h:177)."""

    def __init__(self, area: str = "0") -> None:
        self.area = area
        self._link_map: Dict[str, Set[Link]] = {}
        # per-node sorted link lists; SPF iterates these so relaxation order
        # (and thus path_links/kth-path selection) is hash-seed independent
        self._ordered_links: Dict[str, List[Link]] = {}
        self._all_links: Set[Link] = set()
        self._node_overloads: Dict[str, HoldableValue] = {}
        self._adjacency_databases: Dict[str, AdjacencyDatabase] = {}
        # memoization: (node, use_link_metric) -> SpfResult
        self._spf_results: Dict[Tuple[str, bool], SpfResult] = {}
        # memoization: (src, dest, k) -> [Path]
        self._kth_path_results: Dict[Tuple[str, str, int], List[Path]] = {}
        # graph changelog for incremental compiled-graph refresh: entries are
        # ("link", Link) weight/up-down change, ("node", name) node-overload
        # change, ("structure", None) link/node add/remove. Consumers remember
        # their read position (graph_log_pos); on overflow old entries are
        # dropped and stale consumers rebuild from scratch
        self._graph_log: List[Tuple[str, object]] = []
        self._graph_log_base = 0
        # counters (fb303 equivalents)
        self.spf_runs = 0
        # monotonically bumped on every topology change; lets external
        # solvers (TPU backend) cache compiled graphs per snapshot
        self.version = 0

    # -- read API ----------------------------------------------------------

    def has_node(self, node: str) -> bool:
        return node in self._adjacency_databases

    def links_from_node(self, node: str) -> Set[Link]:
        return self._link_map.get(node, set())

    def ordered_links_from_node(self, node: str) -> List[Link]:
        cached = self._ordered_links.get(node)
        if cached is None:
            cached = sorted(self._link_map.get(node, set()))
            self._ordered_links[node] = cached
        return cached

    def is_node_overloaded(self, node: str) -> bool:
        hv = self._node_overloads.get(node)
        return hv is not None and hv.value

    def num_links(self) -> int:
        return len(self._all_links)

    def num_nodes(self) -> int:
        return len(self._link_map)

    @property
    def all_links(self) -> Set[Link]:
        return self._all_links

    def get_adjacency_databases(self) -> Dict[str, AdjacencyDatabase]:
        return self._adjacency_databases

    def has_holds(self) -> bool:
        return any(l.has_holds() for l in self._all_links) or any(
            hv.has_hold() for hv in self._node_overloads.values()
        )

    def node_names(self) -> List[str]:
        return list(self._adjacency_databases.keys())

    # -- mutation ----------------------------------------------------------

    def update_adjacency_database(
        self,
        new_adj_db: AdjacencyDatabase,
        hold_up_ttl: int = 0,
        hold_down_ttl: int = 0,
    ) -> LinkStateChange:
        """Ordered diff of a node's links vs. its previous advertisement.

        Mirrors LinkState.cpp:564-717: walk old and new link lists in sorted
        order; insert/remove mismatches; for matches, carry attribute changes
        onto the existing Link object (preserving its holds).
        """
        assert new_adj_db.area == self.area, (
            f"adjacency db area {new_adj_db.area} != link state area {self.area}"
        )
        change = LinkStateChange()
        node = new_adj_db.this_node_name

        prior = self._adjacency_databases.get(node)
        self._adjacency_databases[node] = new_adj_db
        if prior is None:
            self._log_graph("structure")  # node-name set may change

        old_links = self.ordered_links_from_node(node)
        new_links = sorted(self._make_bidirectional_links(new_adj_db))

        overload_changed = self._update_node_overloaded(
            node, new_adj_db.is_overloaded, hold_up_ttl, hold_down_ttl
        )
        if overload_changed:
            self._log_graph("node", node)
        change.topology_changed |= overload_changed
        change.node_label_changed = (
            prior is None and new_adj_db.node_label != 0
        ) or (prior is not None and prior.node_label != new_adj_db.node_label)

        i = j = 0
        while i < len(new_links) or j < len(old_links):
            if i < len(new_links) and (
                j >= len(old_links) or new_links[i] < old_links[j]
            ):
                link = new_links[i]
                link.set_hold_up_ttl(hold_up_ttl)
                change.topology_changed |= link.is_up()
                self._add_link(link)
                self._log_graph("structure")
                i += 1
                continue
            if j < len(old_links) and (
                i >= len(new_links) or old_links[j] < new_links[i]
            ):
                link = old_links[j]
                change.topology_changed |= link.is_up()
                self._remove_link(link)
                self._log_graph("structure")
                j += 1
                continue
            # same link on both sides: diff attributes in place
            new_link, old_link = new_links[i], old_links[j]
            if new_link.metric_from_node(node) != old_link.metric_from_node(
                node
            ):
                if old_link.set_metric_from_node(
                    node,
                    new_link.metric_from_node(node),
                    hold_up_ttl,
                    hold_down_ttl,
                ):
                    change.topology_changed = True
                    self._log_graph("link", old_link)
            if new_link.overload_from_node(node) != old_link.overload_from_node(
                node
            ):
                if old_link.set_overload_from_node(
                    node,
                    new_link.overload_from_node(node),
                    hold_up_ttl,
                    hold_down_ttl,
                ):
                    change.topology_changed = True
                    self._log_graph("link", old_link)
            if new_link.adj_label_from_node(node) != old_link.adj_label_from_node(
                node
            ):
                change.link_attributes_changed = True
                old_link.set_adj_label_from_node(
                    node, new_link.adj_label_from_node(node)
                )
            if new_link.nh_v4_from_node(node) != old_link.nh_v4_from_node(node):
                change.link_attributes_changed = True
                old_link.set_nh_v4_from_node(
                    node, new_link.nh_v4_from_node(node)
                )
            if new_link.nh_v6_from_node(node) != old_link.nh_v6_from_node(node):
                change.link_attributes_changed = True
                old_link.set_nh_v6_from_node(
                    node, new_link.nh_v6_from_node(node)
                )
            i += 1
            j += 1

        if change.topology_changed:
            self._invalidate()
        return change

    def bulk_update_adjacency_databases(
        self, adj_dbs: List[AdjacencyDatabase]
    ) -> LinkStateChange:
        """Cold-start ingest: apply many adjacency databases in one pass.

        Equivalent to calling update_adjacency_database(db) for each db (no
        ordered-FIB holds — cold start predates any FIB state to order
        against), but O(E) instead of O(sum deg(u)*deg(v)): bidirectional
        matching uses one descriptor map over all adjacencies instead of
        the per-adjacency linear scan of the other node's list
        (_maybe_make_link, mirroring LinkState.cpp:531-547). This is the
        KvStore full-sync ingest path (reference hot path:
        LinkState.cpp:564-717 run once per node at cold start).

        Falls back to the incremental path when any incoming node already
        exists — the fast path's correctness argument is only written for
        fresh nodes (no prior links to diff against, no holds to carry).
        """
        adj_dbs = list(adj_dbs)
        if any(
            db.this_node_name in self._adjacency_databases for db in adj_dbs
        ) or len({db.this_node_name for db in adj_dbs}) != len(adj_dbs):
            change = LinkStateChange()
            for db in adj_dbs:
                change |= self.update_adjacency_database(db)
            return change

        change = LinkStateChange()
        for db in adj_dbs:
            assert db.area == self.area, (db.area, self.area)
            node = db.this_node_name
            self._adjacency_databases[node] = db
            self._node_overloads.setdefault(
                node, HoldableValue(db.is_overloaded)
            )
            change.node_label_changed |= db.node_label != 0
        self._log_graph("structure")  # consumers rebuild wholesale

        # descriptor map over ALL known adjacencies (pre-existing nodes
        # included: an incoming node may peer with one). First-wins per
        # descriptor reproduces _maybe_make_link's first-match scan.
        descr: Dict[Tuple[str, str, str, str], Adjacency] = {}
        for other_db in self._adjacency_databases.values():
            other = other_db.this_node_name
            for adj in other_db.adjacencies:
                descr.setdefault(
                    (other, adj.if_name, adj.other_node_name,
                     adj.other_if_name),
                    adj,
                )

        incoming = {db.this_node_name for db in adj_dbs}
        new_links: List[Link] = []
        any_up = False
        for db in adj_dbs:
            node = db.this_node_name
            for adj in db.adjacencies:
                other = adj.other_node_name
                # both-incoming pairs are discovered from each side; keep
                # exactly the side whose (node, iface) sorts first so each
                # link is constructed once
                if other in incoming and (other, adj.other_if_name) < (
                    node, adj.if_name
                ):
                    continue
                other_adj = descr.get(
                    (other, adj.other_if_name, node, adj.if_name)
                )
                if other_adj is None:
                    continue
                link = Link(self.area, node, adj, other, other_adj)
                new_links.append(link)
                if not any_up:
                    any_up = link.is_up()

        # bulk insertion (the set adds dedupe degenerate duplicate
        # adjacencies the same way repeated _add_link calls would)
        self._all_links.update(new_links)
        link_map = self._link_map
        for link in new_links:
            link_map.setdefault(link.n1, set()).add(link)
            link_map.setdefault(link.n2, set()).add(link)
        # sorted-order caches may exist for pre-existing peer nodes; a bulk
        # event is rare enough that dropping them all is cheaper than
        # tracking which endpoints were touched
        self._ordered_links.clear()

        change.topology_changed |= any_up
        if change.topology_changed:
            self._invalidate()
        return change

    def delete_adjacency_database(self, node: str) -> LinkStateChange:
        change = LinkStateChange()
        if node in self._adjacency_databases:
            self._remove_node(node)
            del self._adjacency_databases[node]
            self._log_graph("structure")
            self._invalidate()
            change.topology_changed = True
        return change

    def decrement_holds(self) -> LinkStateChange:
        change = LinkStateChange()
        for link in self._all_links:
            if link.decrement_holds():
                change.topology_changed = True
                self._log_graph("link", link)
        for node, hv in self._node_overloads.items():
            if hv.decrement_ttl():
                change.topology_changed = True
                self._log_graph("node", node)
        if change.topology_changed:
            self._invalidate()
        return change

    # -- shortest paths ----------------------------------------------------

    def get_spf_result(
        self, node: str, use_link_metric: bool = True
    ) -> SpfResult:
        key = (node, use_link_metric)
        result = self._spf_results.get(key)
        if result is None:
            result = self.run_spf(node, use_link_metric)
            self._spf_results[key] = result
        return result

    def get_metric_from_a_to_b(
        self, a: str, b: str, use_link_metric: bool = True
    ) -> Optional[Metric]:
        if a == b:
            return 0
        res = self.get_spf_result(a, use_link_metric)
        return res[b].metric if b in res else None

    def get_hops_from_a_to_b(self, a: str, b: str) -> Optional[Metric]:
        return self.get_metric_from_a_to_b(a, b, use_link_metric=False)

    def get_max_hops_to_node(self, node: str) -> Metric:
        return max(
            (r.metric for r in self.get_spf_result(node, False).values()),
            default=0,
        )

    def run_spf(
        self,
        src: str,
        use_link_metric: bool = True,
        links_to_ignore: Optional[Set[Link]] = None,
    ) -> SpfResult:
        """Dijkstra with ECMP nexthop-set union (LinkState.cpp:806-880).

        Tie-breaking: extract-min orders by (metric, nodeName). Relaxation with
        '>=': an equal-cost path contributes its path link and unions its
        nexthop set. Overloaded nodes are reachable but do not offer transit.
        """
        self.spf_runs += 1
        ignore = links_to_ignore or set()
        result: SpfResult = {}

        # lazy-deletion binary heap keyed by (metric, nodeName); an entry is
        # stale when the node's current best metric differs
        best: Dict[str, NodeSpfResult] = {src: NodeSpfResult(0)}
        heap: List[Tuple[Metric, str]] = [(0, src)]
        while heap:
            metric, node = heapq.heappop(heap)
            if node in result:
                continue
            node_res = best[node]
            if metric != node_res.metric:
                continue  # stale entry
            result[node] = node_res

            if node != src and self.is_node_overloaded(node):
                # reachable, but offers no transit (drained)
                continue

            for link in self.ordered_links_from_node(node):
                other = link.other_node_name(node)
                if not link.is_up() or other in result or link in ignore:
                    continue
                step = link.metric_from_node(node) if use_link_metric else 1
                new_metric = node_res.metric + step
                other_res = best.get(other)
                if other_res is None:
                    other_res = NodeSpfResult(new_metric)
                    best[other] = other_res
                    heapq.heappush(heap, (new_metric, other))
                if other_res.metric >= new_metric:
                    if other_res.metric > new_metric:
                        other_res.reset(new_metric)
                        heapq.heappush(heap, (new_metric, other))
                    other_res.path_links.append((link, node))
                    if node_res.next_hops:
                        other_res.next_hops |= node_res.next_hops
                    else:
                        # directly connected to the source
                        other_res.next_hops.add(other)
        return result

    def get_kth_paths(self, src: str, dest: str, k: int) -> List[Path]:
        """k-th set of edge-disjoint shortest paths (LinkState.cpp:760-789).

        Paths in set k avoid every link used by sets 1..k-1; within a set,
        paths are edge-disjoint, greedily traced from the SPF DAG.
        """
        assert k >= 1
        key = (src, dest, k)
        cached = self._kth_path_results.get(key)
        if cached is not None:
            return cached

        links_to_ignore: Set[Link] = set()
        for i in range(1, k):
            for path in self.get_kth_paths(src, dest, i):
                links_to_ignore.update(path)

        paths: List[Path] = []
        res = (
            self.get_spf_result(src, True)
            if not links_to_ignore
            else self.run_spf(src, True, links_to_ignore)
        )
        if dest in res:
            visited: Set[Link] = set()
            path = self._trace_one_path(src, dest, res, visited)
            while path:  # non-empty path found
                paths.append(path)
                path = self._trace_one_path(src, dest, res, visited)
        self._kth_path_results[key] = paths
        return paths

    def _trace_one_path(
        self, src: str, dest: str, result: SpfResult, visited: Set[Link]
    ) -> Optional[Path]:
        """Greedy back-trace of one path dest→src over unvisited path links
        (LinkState.cpp:398-419). Marks every considered link visited."""
        if src == dest:
            return []
        for link, prev_node in result[dest].path_links:
            if link not in visited:
                visited.add(link)
                sub = self._trace_one_path(src, prev_node, result, visited)
                if sub is not None:
                    sub.append(link)
                    return sub
        return None

    # -- graph changelog (incremental compiled-graph refresh) --------------

    _GRAPH_LOG_CAP = 4096

    @property
    def graph_log_pos(self) -> int:
        """Absolute position of the changelog tail; snapshot at compile."""
        return self._graph_log_base + len(self._graph_log)

    def graph_changes_since(
        self, pos: int
    ) -> Optional[List[Tuple[str, object]]]:
        """Changelog entries since `pos`, or None when they were dropped
        (consumer too stale: rebuild from scratch)."""
        if pos < self._graph_log_base:
            return None
        return self._graph_log[pos - self._graph_log_base :]

    def _log_graph(self, kind: str, obj: object = None) -> None:
        if len(self._graph_log) >= self._GRAPH_LOG_CAP:
            self._graph_log_base += len(self._graph_log)
            self._graph_log = []
        self._graph_log.append((kind, obj))

    # -- internals ---------------------------------------------------------

    def _invalidate(self) -> None:
        self._spf_results.clear()
        self._kth_path_results.clear()
        self.version += 1

    def _update_node_overloaded(
        self, node: str, overloaded: bool, hold_up_ttl: int, hold_down_ttl: int
    ) -> bool:
        hv = self._node_overloads.get(node)
        if hv is not None:
            return hv.update_value(overloaded, hold_up_ttl, hold_down_ttl)
        self._node_overloads[node] = HoldableValue(overloaded)
        return False  # new node: not a link-state change

    def _maybe_make_link(self, node: str, adj: Adjacency) -> Optional[Link]:
        """Create a Link only when the reverse adjacency is also advertised
        (LinkState.cpp:531-547)."""
        other_db = self._adjacency_databases.get(adj.other_node_name)
        if other_db is None:
            return None
        for other_adj in other_db.adjacencies:
            if (
                other_adj.other_node_name == node
                and adj.other_if_name == other_adj.if_name
                and adj.if_name == other_adj.other_if_name
            ):
                return Link(
                    self.area, node, adj, adj.other_node_name, other_adj
                )
        return None

    def _make_bidirectional_links(self, adj_db: AdjacencyDatabase) -> List[Link]:
        links = []
        for adj in adj_db.adjacencies:
            link = self._maybe_make_link(adj_db.this_node_name, adj)
            if link is not None:
                links.append(link)
        return links

    def _add_link(self, link: Link) -> None:
        self._link_map.setdefault(link.first_node_name(), set()).add(link)
        self._link_map.setdefault(link.second_node_name(), set()).add(link)
        self._ordered_links.pop(link.first_node_name(), None)
        self._ordered_links.pop(link.second_node_name(), None)
        self._all_links.add(link)

    def _remove_link(self, link: Link) -> None:
        self._link_map[link.first_node_name()].discard(link)
        self._link_map[link.second_node_name()].discard(link)
        self._ordered_links.pop(link.first_node_name(), None)
        self._ordered_links.pop(link.second_node_name(), None)
        self._all_links.discard(link)

    def _remove_node(self, node: str) -> None:
        links = self._link_map.pop(node, set())
        self._ordered_links.pop(node, None)
        for link in links:
            other = link.other_node_name(node)
            self._link_map.get(other, set()).discard(link)
            self._ordered_links.pop(other, None)
            self._all_links.discard(link)
        self._node_overloads.pop(node, None)


def path_a_in_path_b(a: Path, b: Path) -> bool:
    """True if path A appears contiguously inside path B (LinkState.h:395)."""
    if len(a) > len(b):
        return False
    for i in range(len(b) - len(a) + 1):
        if all(a[x] == b[i + x] for x in range(len(a))):
            return True
    return False
