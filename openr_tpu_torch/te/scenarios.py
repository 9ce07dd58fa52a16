"""Demand-matrix and fixture builders for the TE service, bench and tests.

Demand specs are plain JSON (the `breeze decision te-optimize --demands
file.json` format):

    {
      "demands": [["src", "dst", 6.0], ...],
      "capacities": {"default": 1.0, "links": [["a", "b", 4.0], ...]},
      "scenarios": 4,
      "scenario_spread": 0.5
    }

`demands` rows are directed node-to-node offered loads; `capacities.links`
set both directions of a link. Scenario k > 0 scales each origin row by a
deterministic factor drawn from [1 - spread, 1 + spread] (seeded rng), so
the optimizer sees a batch of candidate load patterns around the operator's
estimate instead of overfitting weights to a single matrix.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from openr_tpu_torch.ops.graph import CompiledGraph
from openr_tpu_torch.topology import Edge


def congested_clos_fixture() -> Tuple[List[Edge], Dict]:
    """Deterministic 2-pod Clos with an express link and a skewed demand
    matrix — the acceptance fixture (tests/test_te_service.py) and the
    bench topology (bench.py te_optimize_ms).

    Two spines, two leaves per pod, every leaf dual-homed at metric 1,
    plus a direct l0_0—l1_0 express link. Under uniform weights the big
    l0_0→l1_0 demand rides the 1-hop express link alone (util 6.0) while
    both spine paths idle; weighting the express link up to 2 makes all
    three paths equal cost, ECMP 3-way-splits the elephant and the max
    link utilization drops to 2.0 — a strict improvement hard SPF can
    verify, reachable by integer weights."""
    leaves = ["l0_0", "l0_1", "l1_0", "l1_1"]
    edges: List[Edge] = [
        (leaf, spine, 1) for leaf in leaves for spine in ("s0", "s1")
    ]
    edges.append(("l0_0", "l1_0", 1))  # the express link the elephant rides
    spec = {
        "demands": [
            ["l0_0", "l1_0", 6.0],
            ["l0_1", "l1_1", 1.0],
        ],
        "scenarios": 1,
    }
    return edges, spec


def uniform_demand_spec(names: List[str], load: float = 1.0) -> Dict:
    """All-pairs uniform demands — the synthetic default when the operator
    supplies no matrix (what-if sweep over an unweighted traffic prior)."""
    return {
        "demands": [
            [a, b, load] for a in names for b in names if a != b
        ],
        "scenarios": 1,
    }


def build_demand_scenarios(
    graph: CompiledGraph,
    spec: Optional[Dict],
    scenarios: Optional[int] = None,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """(demands [B, n, n], caps [E], scenario count) from a spec (n = real
    node count: TE solves run on the real-edge arrays, unpadded).

    Unknown node names are ignored (the LSDB may have moved since the
    operator wrote the file); capacities default to 1.0 per directed edge.
    """
    spec = dict(spec or {})
    if not spec.get("demands"):
        spec.update(uniform_demand_spec(list(graph.names)))
    n = graph.n
    base = np.zeros((n, n), dtype=np.float32)
    for row in spec["demands"]:
        a, b, load = row[0], row[1], float(row[2])
        ia = graph.node_index.get(a)
        ib = graph.node_index.get(b)
        if ia is None or ib is None or ia == ib:
            continue
        base[ia, ib] += load

    caps = np.ones(graph.e, dtype=np.float32)
    cap_spec = spec.get("capacities") or {}
    default_cap = float(cap_spec.get("default", 1.0))
    caps[:] = default_cap
    by_pair: Dict[Tuple[int, int], float] = {}
    for row in cap_spec.get("links", ()):
        a, b, cap = row[0], row[1], float(row[2])
        ia = graph.node_index.get(a)
        ib = graph.node_index.get(b)
        if ia is None or ib is None:
            continue
        by_pair[(ia, ib)] = cap
        by_pair[(ib, ia)] = cap
    if by_pair:
        for e in range(graph.e):
            cap = by_pair.get((int(graph.src[e]), int(graph.dst[e])))
            if cap is not None:
                caps[e] = cap

    b_count = int(scenarios or spec.get("scenarios") or 1)
    b_count = max(1, min(b_count, 64))
    spread = float(spec.get("scenario_spread", 0.5))
    mats = [base]
    rng = np.random.default_rng(seed)
    for _ in range(b_count - 1):
        row_scale = rng.uniform(
            max(0.0, 1.0 - spread), 1.0 + spread, size=(n, 1)
        ).astype(np.float32)
        mats.append(base * row_scale)
    return np.stack(mats), caps, b_count
