"""Topology-as-code builders for tests and benchmarks.

Equivalent of the fixture builders in openr/decision/tests/DecisionTestUtils.h
(createGrid, createAdjacency) and the grid/fabric generators in
openr/decision/tests/DecisionBenchmark.cpp:640-728 (grid n×n; 3-tier fabric
with ssw spines per plane and fsw/rsw pods).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from openr_tpu_torch.types import Adjacency, AdjacencyDatabase

Edge = Tuple[str, str, int]  # (node_a, node_b, metric)


def make_adj_pair(
    a: str, b: str, metric_ab: int = 1, metric_ba: Optional[int] = None
) -> Tuple[Adjacency, Adjacency]:
    """Two directed adjacencies forming one bidirectional link a<->b.

    Interface naming convention: 'if-<local>-<remote>' so every (node, iface)
    pair is unique, letting parallel links between the same node pair use
    explicit interface names instead.
    """
    import zlib

    def _h(s: str) -> int:  # hash-seed-independent digest
        return zlib.crc32(s.encode())

    if_ab = f"if-{a}-{b}"
    if_ba = f"if-{b}-{a}"
    adj_a = Adjacency(
        other_node_name=b,
        if_name=if_ab,
        other_if_name=if_ba,
        metric=metric_ab,
        nexthop_v6=f"fe80::{_h(b) % 0xFFFF:x}",
        nexthop_v4=f"169.254.{_h(b) % 255}.{_h(if_ba) % 255}",
    )
    adj_b = Adjacency(
        other_node_name=a,
        if_name=if_ba,
        other_if_name=if_ab,
        metric=metric_ba if metric_ba is not None else metric_ab,
        nexthop_v6=f"fe80::{_h(a) % 0xFFFF:x}",
        nexthop_v4=f"169.254.{_h(a) % 255}.{_h(if_ab) % 255}",
    )
    return adj_a, adj_b


def build_adj_dbs(
    edges: List[Edge],
    area: str = "0",
    node_labels: bool = True,
    overloaded_nodes: Optional[set] = None,
) -> Dict[str, AdjacencyDatabase]:
    """Build per-node AdjacencyDatabases from an undirected edge list."""
    adjs: Dict[str, List[Adjacency]] = {}
    for edge in edges:
        a, b, metric = edge
        adj_a, adj_b = make_adj_pair(a, b, metric)
        adjs.setdefault(a, []).append(adj_a)
        adjs.setdefault(b, []).append(adj_b)
    overloaded = overloaded_nodes or set()
    dbs = {}
    for i, node in enumerate(sorted(adjs)):
        dbs[node] = AdjacencyDatabase(
            this_node_name=node,
            adjacencies=adjs.get(node, []),
            area=area,
            node_label=(i + 100) if node_labels else 0,
            is_overloaded=node in overloaded,
        )
    return dbs


def grid_edges(n: int, metric: int = 1) -> List[Edge]:
    """n×n grid; node name 'g<row>_<col>' (DecisionBenchmark grid topology)."""
    edges: List[Edge] = []
    for r in range(n):
        for c in range(n):
            if c + 1 < n:
                edges.append((f"g{r}_{c}", f"g{r}_{c+1}", metric))
            if r + 1 < n:
                edges.append((f"g{r}_{c}", f"g{r+1}_{c}", metric))
    return edges


def ring_edges(n: int, metric: int = 1) -> List[Edge]:
    return [(f"r{i}", f"r{(i + 1) % n}", metric) for i in range(n)]


def fabric_edges(
    pods: int,
    planes: int = 4,
    ssw_per_plane: int = 9,
    fsw_per_pod: int = 8,
    rsw_per_pod: int = 48,
) -> List[Edge]:
    """3-tier Clos fabric (DecisionBenchmark.cpp:51-56 style):
    rsw (rack) — fsw (fabric, per pod) — ssw (spine, per plane).
    fsw i in each pod connects to all ssw of plane (i mod planes)."""
    edges: List[Edge] = []
    for p in range(pods):
        for f in range(fsw_per_pod):
            fsw = f"fsw{p}_{f}"
            for r in range(rsw_per_pod):
                edges.append((fsw, f"rsw{p}_{r}", 1))
            plane = f % planes
            for s in range(ssw_per_plane):
                edges.append((fsw, f"ssw{plane}_{s}", 1))
    return edges


def wan_edges(n: int, degree: int = 4, seed: int = 0) -> List[Edge]:
    """Synthetic WAN: ring + deterministic pseudo-random chords with varied
    metrics (connected, degree ≈ 2+chords)."""
    import random

    rng = random.Random(seed)
    edges = [
        (f"w{i}", f"w{(i + 1) % n}", rng.randint(1, 100)) for i in range(n)
    ]
    seen = {(min(i, (i + 1) % n), max(i, (i + 1) % n)) for i in range(n)}
    available_pairs = n * (n - 1) // 2 - len(seen)
    target_chords = min(n * max(0, degree - 2) // 2, available_pairs)
    while len(edges) < n + target_chords:
        a, b = rng.randrange(n), rng.randrange(n)
        if a == b:
            continue
        key = (min(a, b), max(a, b))
        if key in seen:
            continue
        seen.add(key)
        edges.append((f"w{a}", f"w{b}", rng.randint(1, 100)))
    return edges
