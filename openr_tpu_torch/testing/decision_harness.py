"""Shared Decision parity harness.

Feed the same publication to Decision(backend=X) and Decision(backend=Y)
and compare the emitted route deltas. Port of the JAX package's
testing/decision_harness.py, its publication builder, one-shot Decision
driver, delta comparison and backend parity gate; the Fib, Monitor,
convergence and bench smokes come with the modules they drive. What
changed: the device backend is "cuda" on `device` ("cuda" by default,
"cpu" for its plain PyTorch versions), and `mesh` may be a `parallel.Mesh`
(ranks that share a card, or the CPU) as well as a (batch, graph) shape.
"""

from __future__ import annotations

import asyncio
from typing import Iterable, Optional, Tuple

from openr_tpu_torch.decision import Decision, DecisionConfig
from openr_tpu_torch.messaging import ReplicateQueue, RQueue, RWQueue
from openr_tpu_torch.types import (
    IpPrefix,
    PrefixDatabase,
    PrefixEntry,
    Publication,
    Value,
    adj_key,
    prefix_key,
)
from openr_tpu_torch.utils import serializer


def lsdb_publication(
    adj_dbs: Iterable, announcers: Optional[dict] = None, area: str = "0"
) -> Publication:
    """One KvStore publication carrying full adjacency databases plus
    per-node prefix announcements ({node: [prefix_str, ...]})."""
    pub = Publication(area=area)
    for db in adj_dbs:
        pub.key_vals[adj_key(db.this_node_name)] = Value(
            1, db.this_node_name, serializer.dumps(db)
        )
    for node, pfxs in (announcers or {}).items():
        pdb = PrefixDatabase(
            node, [PrefixEntry(IpPrefix(p)) for p in pfxs]
        )
        pub.key_vals[prefix_key(node)] = Value(
            1, node, serializer.dumps(pdb)
        )
    return pub


async def decision_route_delta(
    my_node: str,
    publication: Publication,
    backend: str,
    mesh=None,
    timeout: float = 30.0,
    device: str = "cuda",
):
    """Boot a Decision, push one publication, await + return the emitted
    route delta, and shut the module down cleanly (task awaited)."""
    kv_q: RWQueue = RWQueue()
    route_q: ReplicateQueue = ReplicateQueue()
    decision = Decision(
        DecisionConfig(
            my_node_name=my_node,
            solver_backend=backend,
            solver_device=device,
            solver_mesh=mesh,
            debounce_min=0.005,
            debounce_max=0.02,
        ),
        RQueue(kv_q),
        route_q,
    )
    reader = route_q.get_reader()
    decision.start()
    try:
        kv_q.push(publication)
        return await asyncio.wait_for(reader.get(), timeout)
    finally:
        task = decision._task
        decision.stop()
        if task is not None:
            await asyncio.gather(task, return_exceptions=True)


def assert_route_delta_equal(a, b) -> Tuple[int, int]:
    """Compare two DecisionRouteUpdates; returns (n_unicast, n_mpls)."""
    a_uni = {e.prefix: e for e in a.unicast_routes_to_update}
    b_uni = {e.prefix: e for e in b.unicast_routes_to_update}
    assert a_uni == b_uni, "unicast route delta mismatch"
    a_mpls = {e.label: e for e in a.mpls_routes_to_update}
    b_mpls = {e.label: e for e in b.mpls_routes_to_update}
    assert a_mpls == b_mpls, "mpls route delta mismatch"
    assert sorted(a.unicast_routes_to_delete) == sorted(
        b.unicast_routes_to_delete
    )
    assert sorted(a.mpls_routes_to_delete) == sorted(b.mpls_routes_to_delete)
    return len(a_uni), len(a_mpls)


def run_decision_backend_parity(
    my_node: str,
    publication: Publication,
    mesh,
    device: str = "cuda",
) -> Tuple[int, int]:
    """Decision(cuda, mesh) vs Decision(cpu) on one publication; returns
    (n_unicast, n_mpls) on success, raises AssertionError on divergence.
    Creates and closes its own event loop (callers are sync entry points).
    """

    async def body():
        cpu = await decision_route_delta(my_node, publication, "cpu")
        cuda = await decision_route_delta(
            my_node, publication, "cuda", mesh=mesh, device=device
        )
        return assert_route_delta_equal(cpu, cuda)

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(body())
    finally:
        loop.close()
