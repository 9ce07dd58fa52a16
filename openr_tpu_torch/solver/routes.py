"""RIB value types and route-db diffing.

Equivalents of openr/decision/RibEntry.h (RibUnicastEntry:37, RibMplsEntry:93),
openr/decision/RouteUpdate.h (DecisionRouteUpdate) and the getRouteDelta diff
in openr/decision/Decision.cpp:47-85.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from openr_tpu_torch.types import (
    IpPrefix,
    MplsRoute,
    NextHop,
    PrefixEntry,
    UnicastRoute,
)


@dataclass
class RibUnicastEntry:
    """A computed unicast route: prefix + ECMP nexthop set + best-path info."""

    prefix: IpPrefix
    nexthops: Set[NextHop] = field(default_factory=set)
    best_prefix_entry: Optional[PrefixEntry] = None
    best_area: Optional[str] = None
    do_not_install: bool = False
    best_nexthop: Optional[NextHop] = None  # for BGP route re-advertising

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, RibUnicastEntry)
            and self.prefix == other.prefix
            and self.nexthops == other.nexthops
            and self.best_prefix_entry == other.best_prefix_entry
            and self.best_nexthop == other.best_nexthop
            and self.do_not_install == other.do_not_install
        )

    def to_unicast_route(self) -> UnicastRoute:
        return UnicastRoute(self.prefix, tuple(sorted(
            self.nexthops, key=lambda nh: (nh.address, nh.iface or "")
        )))


@dataclass
class RibMplsEntry:
    """A computed MPLS label route: top label + nexthop set."""

    label: int
    nexthops: Set[NextHop] = field(default_factory=set)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, RibMplsEntry)
            and self.label == other.label
            and self.nexthops == other.nexthops
        )

    def to_mpls_route(self) -> MplsRoute:
        return MplsRoute(self.label, tuple(sorted(
            self.nexthops, key=lambda nh: (nh.address, nh.iface or "")
        )))


@dataclass
class DecisionRouteDb:
    """Full computed RIB from one node's perspective."""

    unicast_entries: Dict[IpPrefix, RibUnicastEntry] = field(
        default_factory=dict
    )
    mpls_entries: Dict[int, RibMplsEntry] = field(default_factory=dict)


@dataclass
class DecisionRouteUpdate:
    """Incremental route delta published to Fib (RouteUpdate.h)."""

    unicast_routes_to_update: List[RibUnicastEntry] = field(
        default_factory=list
    )
    unicast_routes_to_delete: List[IpPrefix] = field(default_factory=list)
    mpls_routes_to_update: List[RibMplsEntry] = field(default_factory=list)
    mpls_routes_to_delete: List[int] = field(default_factory=list)
    perf_events: Optional[object] = None
    # monotonic stage trace riding the delta to Fib (monitor.spans.Span);
    # host-local only — never serialized, never compared
    span: Optional[object] = None

    def empty(self) -> bool:
        return not (
            self.unicast_routes_to_update
            or self.unicast_routes_to_delete
            or self.mpls_routes_to_update
            or self.mpls_routes_to_delete
        )


def apply_route_delta(
    old_db: DecisionRouteDb, delta: DecisionRouteUpdate
) -> DecisionRouteDb:
    """The diff's inverse: fold an update into a route db, returning a new
    db that shares unchanged entry objects with the old one. The DeltaPath
    route build uses this to keep Decision's full RouteDatabase current
    without rebuilding it — apply_route_delta(old, get_route_delta(new,
    old)) == new for any pair of dbs."""
    unicast = dict(old_db.unicast_entries)
    mpls = dict(old_db.mpls_entries)
    for prefix in delta.unicast_routes_to_delete:
        unicast.pop(prefix, None)
    for entry in delta.unicast_routes_to_update:
        unicast[entry.prefix] = entry
    for label in delta.mpls_routes_to_delete:
        mpls.pop(label, None)
    for entry in delta.mpls_routes_to_update:
        mpls[entry.label] = entry
    return DecisionRouteDb(unicast_entries=unicast, mpls_entries=mpls)


def get_route_delta(
    new_db: DecisionRouteDb, old_db: DecisionRouteDb
) -> DecisionRouteUpdate:
    """Diff two route dbs (Decision.cpp:47-85)."""
    delta = DecisionRouteUpdate()
    for prefix, entry in new_db.unicast_entries.items():
        old = old_db.unicast_entries.get(prefix)
        if old is not None and old == entry:
            continue
        delta.unicast_routes_to_update.append(entry)
    for prefix in old_db.unicast_entries:
        if prefix not in new_db.unicast_entries:
            delta.unicast_routes_to_delete.append(prefix)
    for label, entry in new_db.mpls_entries.items():
        old = old_db.mpls_entries.get(label)
        if old is not None and old == entry:
            continue
        delta.mpls_routes_to_update.append(entry)
    for label in old_db.mpls_entries:
        if label not in new_db.mpls_entries:
            delta.mpls_routes_to_delete.append(label)
    return delta
