"""Wire types for openr-tpu.

Python-native equivalents of the reference thrift IDL (field semantics match;
representation is idiomatic Python dataclasses):
  - openr/if/Lsdb.thrift: Adjacency:44, AdjacencyDatabase:108, PrefixEntry:231,
    PrefixDatabase:337, PerfEvent/PerfEvents:23-34
  - openr/if/KvStore.thrift: Value:20, KeyVals, Publication:228
  - openr/if/Network.thrift: IpPrefix, BinaryAddress, MplsAction, NextHopThrift,
    UnicastRoute, MplsRoute
These are the LSDB/RIB value types that flow between modules and across nodes.
"""

from __future__ import annotations

import enum
import ipaddress
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Constants (openr/common/Constants.h)
# ---------------------------------------------------------------------------

TTL_INFINITY = -(2**31)  # Constants::kTtlInfinity (Constants.h:96)


# ---------------------------------------------------------------------------
# Network types (openr/if/Network.thrift)
# ---------------------------------------------------------------------------


def _normalize_prefix(prefix: str) -> str:
    """Canonicalize an 'addr/len' prefix string (host bits zeroed)."""
    return str(ipaddress.ip_network(prefix, strict=False))


@dataclass(frozen=True, order=True)
class IpPrefix:
    """An IP prefix, e.g. '10.0.0.0/24' or 'fc00::/64'.

    Reference: openr/if/Network.thrift IpPrefix (prefixAddress + prefixLength).
    """

    prefix: str

    def __post_init__(self) -> None:
        net = ipaddress.ip_network(self.prefix, strict=False)
        object.__setattr__(self, "prefix", str(net))
        object.__setattr__(self, "_net", net)  # parsed once; not a field

    @property
    def is_v4(self) -> bool:
        return isinstance(self._net, ipaddress.IPv4Network)

    @property
    def prefix_length(self) -> int:
        return self._net.prefixlen

    @property
    def network(self) -> ipaddress._BaseNetwork:
        return self._net

    def contains(self, addr: str) -> bool:
        return ipaddress.ip_address(addr) in self.network

    def __str__(self) -> str:
        return self.prefix


class MplsActionCode(enum.Enum):
    """openr/if/Network.thrift MplsActionCode."""

    PUSH = "PUSH"
    SWAP = "SWAP"
    PHP = "PHP"  # pop and forward
    POP_AND_LOOKUP = "POP_AND_LOOKUP"


@dataclass(frozen=True)
class MplsAction:
    """openr/if/Network.thrift MplsAction."""

    action: MplsActionCode
    swap_label: Optional[int] = None
    push_labels: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if self.action == MplsActionCode.SWAP:
            assert self.swap_label is not None
        if self.action == MplsActionCode.PUSH:
            assert len(self.push_labels) > 0


MPLS_LABEL_MIN = 16  # valid MPLS label range (RFC 3032 reserved below 16)
MPLS_LABEL_MAX = (1 << 20) - 1


def is_mpls_label_valid(label: int) -> bool:
    """openr/common/Util: isMplsLabelValid."""
    return MPLS_LABEL_MIN <= label <= MPLS_LABEL_MAX


@dataclass(frozen=True)
class NextHop:
    """A resolved nexthop: address + outgoing interface + attributes.

    Reference: openr/if/Network.thrift NextHopThrift (address, weight, metric,
    useNonShortestRoute, mplsAction, area).
    """

    address: str  # link-local or loopback address of the neighbor
    iface: Optional[str] = None
    metric: int = 0
    mpls_action: Optional[MplsAction] = None
    use_non_shortest_route: bool = False
    area: Optional[str] = None
    weight: int = 0
    neighbor_node: Optional[str] = None  # convenience (not on the wire)


@dataclass(frozen=True)
class UnicastRoute:
    """openr/if/Network.thrift UnicastRoute: dest prefix + nexthop set."""

    dest: IpPrefix
    nexthops: Tuple[NextHop, ...]


@dataclass(frozen=True)
class MplsRoute:
    """openr/if/Network.thrift MplsRoute: top label + nexthop set."""

    top_label: int
    nexthops: Tuple[NextHop, ...]


# ---------------------------------------------------------------------------
# LSDB types (openr/if/Lsdb.thrift)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PerfEvent:
    """openr/if/Lsdb.thrift PerfEvent:23 — (node, event-name, unix ts ms).

    unix_ts is wall-clock milliseconds; the reference truncates to int, but
    sub-ms producers (the KvStore flood-hop trace, LinkMonitor's
    adjacency-advertise stamps) may stamp floats — consumers only subtract
    stamps, so both representations interoperate.
    """

    node_name: str
    event_descr: str
    unix_ts: float


@dataclass
class PerfEvents:
    """openr/if/Lsdb.thrift PerfEvents:31 — ordered trace of events."""

    events: List[PerfEvent] = field(default_factory=list)

    def add(self, node_name: str, descr: str) -> None:
        self.events.append(
            PerfEvent(node_name, descr, int(time.time() * 1000))
        )

    def add_fine(self, node_name: str, descr: str) -> None:
        """Stamp with sub-ms (float) resolution — per-hop flood latencies
        inside one emulator host are well under a millisecond."""
        self.events.append(PerfEvent(node_name, descr, time.time() * 1000.0))

    def copy(self) -> "PerfEvents":
        return PerfEvents(list(self.events))


@dataclass(frozen=True)
class Adjacency:
    """One directed adjacency advertised by a node.

    Reference: openr/if/Lsdb.thrift Adjacency:44 — otherNodeName, ifName,
    otherIfName, metric, adjLabel, isOverloaded, rtt, nextHopV4/V6.
    """

    other_node_name: str
    if_name: str
    other_if_name: str = ""
    metric: int = 1
    adj_label: int = 0
    is_overloaded: bool = False
    rtt: int = 0  # microseconds
    timestamp: int = 0
    weight: int = 1
    nexthop_v4: str = "0.0.0.0"
    nexthop_v6: str = "fe80::"


@dataclass
class AdjacencyDatabase:
    """All adjacencies advertised by one node in one area.

    Reference: openr/if/Lsdb.thrift AdjacencyDatabase:108 — thisNodeName,
    isOverloaded, adjacencies, nodeLabel, perfEvents, area.
    """

    this_node_name: str
    adjacencies: List[Adjacency] = field(default_factory=list)
    is_overloaded: bool = False
    node_label: int = 0
    area: str = "0"
    perf_events: Optional[PerfEvents] = None


class PrefixType(enum.Enum):
    """openr/if/Network.thrift PrefixType."""

    LOOPBACK = "LOOPBACK"
    DEFAULT = "DEFAULT"
    BGP = "BGP"
    PREFIX_ALLOCATOR = "PREFIX_ALLOCATOR"
    BREEZE = "BREEZE"
    RIB = "RIB"
    CONFIG = "CONFIG"
    VIP = "VIP"


class PrefixForwardingType(enum.Enum):
    """openr/if/OpenrConfig.thrift PrefixForwardingType — IP or SR_MPLS."""

    IP = 0
    SR_MPLS = 1


class PrefixForwardingAlgorithm(enum.Enum):
    """openr/if/OpenrConfig.thrift PrefixForwardingAlgorithm."""

    SP_ECMP = 0
    KSP2_ED_ECMP = 1


# --- BGP metric vectors (openr/if/Lsdb.thrift MetricVector:199-229) ---------


class CompareType(enum.Enum):
    """openr/if/Lsdb.thrift CompareType: tie-break behavior when an entity is
    present in one vector but not the other."""

    WIN_IF_PRESENT = 1
    WIN_IF_NOT_PRESENT = 2
    IGNORE_IF_NOT_PRESENT = 3


@dataclass(frozen=True)
class MetricEntity:
    """openr/if/Lsdb.thrift MetricEntity:199."""

    id: int
    priority: int
    op: CompareType = CompareType.WIN_IF_PRESENT
    is_best_path_tiebreaker: bool = False
    metric: Tuple[int, ...] = ()


@dataclass(frozen=True)
class MetricVector:
    """openr/if/Lsdb.thrift MetricVector:222 — versioned list of entities."""

    version: int = 1
    metrics: Tuple[MetricEntity, ...] = ()


@dataclass(frozen=True)
class PrefixEntry:
    """One prefix advertisement by one node.

    Reference: openr/if/Lsdb.thrift PrefixEntry:231 — prefix, type, data, mv,
    forwardingType, forwardingAlgorithm, minNexthop, prependLabel, tags,
    area_stack, metrics.
    """

    prefix: IpPrefix
    type: PrefixType = PrefixType.LOOPBACK
    forwarding_type: PrefixForwardingType = PrefixForwardingType.IP
    forwarding_algorithm: PrefixForwardingAlgorithm = (
        PrefixForwardingAlgorithm.SP_ECMP
    )
    mv: Optional[MetricVector] = None  # metric vector, required for BGP
    min_nexthop: Optional[int] = None
    prepend_label: Optional[int] = None
    tags: Tuple[str, ...] = ()
    area_stack: Tuple[str, ...] = ()
    data: bytes = b""


@dataclass
class PrefixDatabase:
    """All prefixes advertised by one node.

    Reference: openr/if/Lsdb.thrift PrefixDatabase:337 — thisNodeName,
    prefixEntries, area, deletePrefix, perfEvents.
    """

    this_node_name: str
    prefix_entries: List[PrefixEntry] = field(default_factory=list)
    area: str = "0"
    delete_prefix: bool = False
    perf_events: Optional[PerfEvents] = None


# ---------------------------------------------------------------------------
# LinkMonitor types (openr/if/LinkMonitor.thrift)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InterfaceInfo:
    """openr/if/LinkMonitor.thrift InterfaceInfo — isUp, ifIndex, networks."""

    is_up: bool
    if_index: int = 0
    networks: Tuple[str, ...] = ()


@dataclass
class InterfaceDatabase:
    """openr/if/LinkMonitor.thrift InterfaceDatabase — thisNodeName +
    ifName → InterfaceInfo map + perfEvents; published by LinkMonitor,
    consumed by Spark (discovery) and Fib (fast nexthop shrink)."""

    this_node_name: str
    interfaces: Dict[str, InterfaceInfo] = field(default_factory=dict)
    perf_events: Optional[PerfEvents] = None


# ---------------------------------------------------------------------------
# KvStore types (openr/if/KvStore.thrift)
# ---------------------------------------------------------------------------


@dataclass
class Value:
    """A versioned value in the replicated store.

    Reference: openr/if/KvStore.thrift Value:20 — version, originatorId,
    value (optional binary), ttl, ttlVersion, hash.
    CRDT ordering: version > originatorId > value bytes; ttlVersion refreshes.
    """

    version: int
    originator_id: str
    value: Optional[bytes] = None
    ttl: int = TTL_INFINITY  # milliseconds; TTL_INFINITY = never expires
    ttl_version: int = 0
    hash: Optional[int] = None

    def copy(self) -> "Value":
        return Value(
            self.version,
            self.originator_id,
            self.value,
            self.ttl,
            self.ttl_version,
            self.hash,
        )


KeyVals = Dict[str, Value]


def generate_hash(version: int, originator_id: str, value: Optional[bytes]) -> int:
    """Stable hash of (version, originatorId, value).

    Reference: openr/common/Util.cpp generateHash — used so full-sync can
    compare values by hash without shipping bodies; int64 like the reference.
    """
    import hashlib

    h = hashlib.blake2b(digest_size=8)
    h.update(str(version).encode())
    h.update(b"\x00")
    h.update(originator_id.encode())
    h.update(b"\x00")
    if value is not None:
        h.update(value)
    return int.from_bytes(h.digest(), "little", signed=True)


@dataclass
class Publication:
    """A batch of key/value updates flooded between stores.

    Reference: openr/if/KvStore.thrift Publication:228 — keyVals, expiredKeys,
    nodeIds (path vector for loop prevention), tobeUpdatedKeys, area.
    """

    key_vals: KeyVals = field(default_factory=dict)
    expired_keys: List[str] = field(default_factory=list)
    node_ids: Optional[List[str]] = None
    tobe_updated_keys: Optional[List[str]] = None
    area: str = "0"
    # time.monotonic() stamp set by the local KvStore when it hands this
    # publication to internal subscribers — seeds Decision's convergence
    # span (monitor/spans.py). Host-local only: never serialized (wire.py
    # rebuilds publications without it) and meaningless across processes.
    ts_monotonic: Optional[float] = None
    # monotonic (stage, ts) marks that happened BEFORE the publish stamp —
    # spark.neighbor_event → linkmonitor.adj_advertised, handed through the
    # module chain on the originating node so Decision's span covers
    # hello-to-programmed-route. Host-local like ts_monotonic: never
    # serialized, dropped at process boundaries.
    span_stages: Optional[List[Tuple[str, float]]] = None
    # wall-clock flood-hop trace (KVSTORE_FLOOD_ORIGINATED + one
    # KVSTORE_FLOOD_RECEIVED per hop): unlike the two fields above this DOES
    # cross nodes — it rides the KEY_SET RPC next to node_ids (wire.py), so
    # every hop can measure per-hop flood latency and remote nodes can
    # reconstruct the origin stages of their convergence spans.
    perf_events: Optional[PerfEvents] = None


# ---------------------------------------------------------------------------
# Key naming (openr/common/Constants.h kAdjDbMarker/kPrefixDbMarker)
# ---------------------------------------------------------------------------

ADJ_DB_MARKER = "adj:"
PREFIX_DB_MARKER = "prefix:"


def adj_key(node_name: str) -> str:
    return f"{ADJ_DB_MARKER}{node_name}"


def prefix_key(
    node_name: str, prefix: Optional[IpPrefix] = None, area: Optional[str] = None
) -> str:
    """Per-node or per-prefix key naming (openr/common/Util.h parsePrefixKey)."""
    if prefix is None:
        return f"{PREFIX_DB_MARKER}{node_name}"
    area_part = area if area is not None else "0"
    return f"{PREFIX_DB_MARKER}{node_name}:{area_part}:[{prefix}]"


def parse_prefix_key(key: str) -> Tuple[str, Optional[str], Optional[IpPrefix]]:
    """Parse 'prefix:<node>[:<area>:[<prefix>]]' → (node, area, prefix)."""
    assert key.startswith(PREFIX_DB_MARKER)
    rest = key[len(PREFIX_DB_MARKER):]
    if ":[" not in rest:
        return rest, None, None
    node_area, _, pfx = rest.partition(":[")
    node, _, area = node_area.rpartition(":")
    if not node:
        node, area = area, None
    return node, area, IpPrefix(pfx.rstrip("]"))


__all__ = [
    "TTL_INFINITY",
    "IpPrefix",
    "MplsActionCode",
    "MplsAction",
    "is_mpls_label_valid",
    "NextHop",
    "UnicastRoute",
    "MplsRoute",
    "PerfEvent",
    "PerfEvents",
    "Adjacency",
    "AdjacencyDatabase",
    "PrefixType",
    "PrefixForwardingType",
    "PrefixForwardingAlgorithm",
    "CompareType",
    "MetricEntity",
    "MetricVector",
    "PrefixEntry",
    "PrefixDatabase",
    "InterfaceInfo",
    "InterfaceDatabase",
    "Value",
    "KeyVals",
    "generate_hash",
    "Publication",
    "ADJ_DB_MARKER",
    "PREFIX_DB_MARKER",
    "adj_key",
    "prefix_key",
    "parse_prefix_key",
    "replace",
]
