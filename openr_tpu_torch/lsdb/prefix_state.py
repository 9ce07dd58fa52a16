"""Prefix reachability table: prefix → {node → {area → PrefixEntry}}.

Behavioral port of openr/decision/PrefixState.{h,cpp}: update_prefix_database
returns the set of changed prefixes (withdrawals + new/updated advertisements),
and per-node host loopbacks are tracked for BGP bestNexthop resolution
(PrefixState.cpp:36-125, getLoopbackVias :145-163).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from openr_tpu_torch.types import (
    IpPrefix,
    NextHop,
    PrefixDatabase,
    PrefixEntry,
    PrefixForwardingType,
    PrefixType,
)

# prefix -> node -> area -> PrefixEntry
PrefixEntries = Dict[IpPrefix, Dict[str, Dict[str, PrefixEntry]]]


class PrefixState:
    def __init__(self) -> None:
        self._prefixes: PrefixEntries = {}
        # node -> area -> set of prefixes
        self._node_to_prefixes: Dict[str, Dict[str, Set[IpPrefix]]] = {}
        self._node_host_loopbacks_v4: Dict[str, str] = {}
        self._node_host_loopbacks_v6: Dict[str, str] = {}
        # prefixes with any SR_MPLS-forwarding advertisement: their routes
        # (KSP2 path traces, label stacks) can move on ANY edge change, so
        # the DeltaPath partial rebuild must always recompute them — kept
        # as an index so the delta path never scans the full table
        self._mpls_fwd_prefixes: Set[IpPrefix] = set()

    @property
    def prefixes(self) -> PrefixEntries:
        return self._prefixes

    def update_prefix_database(self, prefix_db: PrefixDatabase) -> Set[IpPrefix]:
        """Apply a node's (per-area) prefix advertisement; return changed set."""
        changed: Set[IpPrefix] = set()
        node = prefix_db.this_node_name
        area = prefix_db.area

        old_set = set(
            self._node_to_prefixes.get(node, {}).get(area, set())
        )
        new_set = {e.prefix for e in prefix_db.prefix_entries}
        self._node_to_prefixes.setdefault(node, {})[area] = new_set

        # withdrawals
        for prefix in old_set - new_set:
            by_originator = self._prefixes.get(prefix)
            if by_originator is None or node not in by_originator:
                continue
            by_originator[node].pop(area, None)
            if not by_originator[node]:
                del by_originator[node]
            if not by_originator:
                del self._prefixes[prefix]
            self._delete_loopback_prefix(prefix, node)
            changed.add(prefix)

        # advertisements / updates
        for entry in prefix_db.prefix_entries:
            by_originator = self._prefixes.setdefault(entry.prefix, {})
            if by_originator.get(node, {}).get(area) == entry:
                continue  # unchanged
            by_originator.setdefault(node, {})[area] = entry
            changed.add(entry.prefix)

            if entry.type == PrefixType.LOOPBACK:
                net = entry.prefix.network
                if net.prefixlen == net.max_prefixlen:
                    host = str(net.network_address)
                    if entry.prefix.is_v4:
                        self._node_host_loopbacks_v4[node] = host
                    else:
                        self._node_host_loopbacks_v6[node] = host

        if not new_set:
            areas = self._node_to_prefixes.get(node)
            if areas is not None:
                areas.pop(area, None)
                if not areas:
                    del self._node_to_prefixes[node]

        # maintain the SR_MPLS-forwarding index for exactly the prefixes
        # this update touched (O(announcers-of-changed-prefixes))
        for prefix in changed:
            by_originator = self._prefixes.get(prefix)
            is_mpls = by_originator is not None and any(
                entry.forwarding_type == PrefixForwardingType.SR_MPLS
                for areas_ in by_originator.values()
                for entry in areas_.values()
            )
            if is_mpls:
                self._mpls_fwd_prefixes.add(prefix)
            else:
                self._mpls_fwd_prefixes.discard(prefix)

        return changed

    def _delete_loopback_prefix(self, prefix: IpPrefix, node: str) -> None:
        net = prefix.network
        if net.prefixlen != net.max_prefixlen:
            return
        host = str(net.network_address)
        table = (
            self._node_host_loopbacks_v4
            if prefix.is_v4
            else self._node_host_loopbacks_v6
        )
        if table.get(node) == host:
            del table[node]

    def get_prefix_databases(self) -> Dict[tuple, PrefixDatabase]:
        """Reconstruct per-(node, area) PrefixDatabases.

        PrefixState.cpp:127-143 keys by node only and silently drops all but
        one area for multi-area nodes; keying by (node, area) is lossless.
        """
        out: Dict[tuple, PrefixDatabase] = {}
        for node, area_to_prefixes in self._node_to_prefixes.items():
            for area, prefixes in area_to_prefixes.items():
                db = PrefixDatabase(this_node_name=node, area=area)
                for prefix in sorted(prefixes):
                    db.prefix_entries.append(
                        self._prefixes[prefix][node][area]
                    )
                out[(node, area)] = db
        return out

    def get_loopback_vias(
        self,
        nodes: Set[str],
        is_v4: bool,
        igp_metric: Optional[int] = None,
    ) -> List[NextHop]:
        """Loopback-address nexthops for BGP best-path (PrefixState.cpp:145)."""
        table = (
            self._node_host_loopbacks_v4
            if is_v4
            else self._node_host_loopbacks_v6
        )
        return [
            NextHop(address=table[node], metric=igp_metric or 0)
            for node in sorted(nodes)
            if node in table
        ]

    def has_prefix(self, prefix: IpPrefix) -> bool:
        return prefix in self._prefixes

    def prefixes_for_nodes(self, nodes: Set[str]) -> Set[IpPrefix]:
        """Prefixes advertised (in any area) by any of `nodes` — the
        DeltaPath dirty set of a changed-destination list, read off the
        node index in O(changes) instead of scanning the table."""
        out: Set[IpPrefix] = set()
        for node in nodes:
            for prefixes in self._node_to_prefixes.get(node, {}).values():
                out.update(prefixes)
        return out

    @property
    def mpls_forwarding_prefixes(self) -> Set[IpPrefix]:
        """Prefixes with any SR_MPLS-forwarding advertisement (their KSP2
        path traces can change on edges no distance column reflects)."""
        return self._mpls_fwd_prefixes
