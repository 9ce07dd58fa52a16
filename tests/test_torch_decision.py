"""Decision on the port against the JAX package's Decision, on the CPU.

Every scenario of the reference's `tests/test_decision.py` (TestDecision,
TestOrderedFib, TestRebuildErrorResilience) runs, as its own reference
test body, through four Decisions fed the same publications:

  - the port's Decision(solver_backend="cuda", solver_device="cpu"), its
    CudaSpfSolver under the SolverSupervisor running the kernels' plain
    PyTorch versions;
  - the JAX package's Decision(solver_backend="tpu") on JAX's CPU;
  - both packages' Decision(solver_backend="cpu"), the CPU oracle.

Their route deltas must be equal in canonical form (every route field,
objects of either package compared as plain data), and their `decision.*`
counters equal, the CPU pair's all of them, the device pair's all but the
four of `_NOT_SHARED`: the compile-cache counters, which count different
things (the kernel libraries the port's process built with nvcc or loaded
built, against the JAX package's jit traces and reuses), and the transfer
bytes, which depend on each layout's own buffers
(tests/test_torch_solver.py). The compared set holds the flight
recorder's `decision.spf.traces_*` and the sample counts of the
`decision.spf.phase.*_ms` histograms (their times are not compared), and
the memory ledger's `decision.mem.*` counters. Each package runs on a
fresh process ledger, the port's a `PortLedger`
(tests/test_torch_memledger.py), whose counters leave out the arrays the
port keeps and the JAX package does not (none on these graphs, which all
take the sliced layout), and both ledgers are back to their baseline,
exact, after Decision.stop.
"""

import asyncio
import dataclasses
import enum
import types as pytypes

import pytest

import openr_tpu.decision as j_decision
import openr_tpu.messaging as j_messaging
import openr_tpu.solver.rib_policy as j_rib
import openr_tpu.testing.decision_harness as j_harness
import openr_tpu.topology as j_topology
import openr_tpu.types as j_types
import openr_tpu.utils.serializer as j_serializer
import openr_tpu_torch.decision as t_decision
import openr_tpu_torch.messaging as t_messaging
import openr_tpu_torch.solver.rib_policy as t_rib
import openr_tpu_torch.testing.decision_harness as t_harness
import openr_tpu_torch.topology as t_topology
import openr_tpu_torch.types as t_types
import openr_tpu_torch.utils.serializer as t_serializer
from openr_tpu_torch import parallel
from test_torch_memory import release_memory_around_each_test  # noqa: F401

import torch


def _pkg(decision, messaging, rib, harness, topology, types, serializer):
    return pytypes.SimpleNamespace(
        Decision=decision.Decision,
        DecisionConfig=decision.DecisionConfig,
        RWQueue=messaging.RWQueue,
        RQueue=messaging.RQueue,
        ReplicateQueue=messaging.ReplicateQueue,
        rib=rib,
        harness=harness,
        build_adj_dbs=topology.build_adj_dbs,
        grid_edges=topology.grid_edges,
        T=types,
        serializer=serializer,
    )


JAX = _pkg(j_decision, j_messaging, j_rib, j_harness, j_topology, j_types,
           j_serializer)
PORT = _pkg(t_decision, t_messaging, t_rib, t_harness, t_topology, t_types,
            t_serializer)

# (name, package, backend config)
DECISIONS = (
    ("port_cuda", PORT, {"solver_backend": "cuda", "solver_device": "cpu"}),
    ("jax_tpu", JAX, {"solver_backend": "tpu"}),
    ("port_cpu", PORT, {"solver_backend": "cpu"}),
    ("jax_cpu", JAX, {"solver_backend": "cpu"}),
)

# the device pair's decision.* counters that are not compared
_NOT_SHARED = (
    # the port's kernel libraries built by nvcc (misses) or loaded built
    # (hits) in this process (ops/_cuda.py), against the JAX package's jit
    # traces and reuses
    "decision.spf.compile_cache_hits",
    "decision.spf.compile_cache_misses",
    # each layout's own buffers and mirror copies (tests/test_torch_solver.py)
    "decision.spf.host_to_device_bytes",
    "decision.spf.device_to_host_bytes",
)


@pytest.fixture(autouse=True)
def fresh_ledgers(monkeypatch):
    """Each package on a fresh process ledger, the port's a `PortLedger`
    (tests/test_torch_memledger.py): the ledgers are process-global, and
    the decision.mem.* counters are their absolute totals. Autouse here
    and in the files that import it."""
    import openr_tpu.monitor.memledger as j_memledger
    import openr_tpu_torch.monitor.memledger as t_memledger
    from test_torch_memledger import PortLedger

    port, ref = PortLedger(), j_memledger.MemLedger()
    monkeypatch.setattr(t_memledger, "_LEDGER", port)
    monkeypatch.setattr(j_memledger, "_LEDGER", ref)
    return port, ref

PFX = "10.9.0.0/16"


def canon(obj):
    """Plain, package-free form of a route object: dataclasses by class
    name and fields, enums by name, sets sorted."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__, tuple(
            (f.name, canon(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)
        ))
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.name)
    if isinstance(obj, (set, frozenset)):
        return ("set", tuple(sorted((canon(x) for x in obj), key=repr)))
    if isinstance(obj, (list, tuple)):
        return tuple(canon(x) for x in obj)
    if isinstance(obj, dict):
        return ("dict", tuple(sorted(
            ((canon(k), canon(v)) for k, v in obj.items()), key=repr)))
    return obj


def canon_delta(delta):
    """A DecisionRouteUpdate's routes (its perf events and span carry
    clocks and are left out)."""
    return (
        tuple(sorted((canon(e) for e in delta.unicast_routes_to_update),
                     key=repr)),
        tuple(sorted((canon(p) for p in delta.unicast_routes_to_delete),
                     key=repr)),
        tuple(sorted((canon(e) for e in delta.mpls_routes_to_update),
                     key=repr)),
        tuple(sorted(canon(x) for x in delta.mpls_routes_to_delete)),
    )


def counters(decision, device: bool):
    out = {
        k: v for k, v in decision.counters.items()
        if k.startswith("decision.") and not (device and k in _NOT_SHARED)
    }
    # the phase histograms' sample counts (their times are not compared)
    out.update({
        f"{k}.count": h.count for k, h in decision.histograms.items()
        if k.startswith("decision.spf.phase.")
    })
    return out


class Run:
    """One Decision of one package, as the reference's tests make it, and
    the route deltas it emitted."""

    def __init__(self, P, backend_cfg, **cfg_kw):
        self.P = P
        self.kv_q = P.RWQueue()
        self.route_q = P.ReplicateQueue()
        self.decision = P.Decision(
            P.DecisionConfig(
                my_node_name="a", debounce_min=0.005, debounce_max=0.02,
                **backend_cfg, **cfg_kw,
            ),
            P.RQueue(self.kv_q),
            self.route_q,
        )
        self.reader = self.route_q.get_reader()
        self.deltas = []

    async def get(self, timeout=None):
        coro = self.reader.get()
        delta = await (asyncio.wait_for(coro, timeout) if timeout else coro)
        self.deltas.append(canon_delta(delta))
        return delta

    def pub(self, adj_dbs=(), prefix_dbs=(), expired=(), version=1):
        """make_publication of the reference's tests."""
        T, ser = self.P.T, self.P.serializer
        pub = T.Publication(area="0")
        for db in adj_dbs:
            pub.key_vals[T.adj_key(db.this_node_name)] = T.Value(
                version, db.this_node_name, ser.dumps(db))
        for db in prefix_dbs:
            pub.key_vals[T.prefix_key(db.this_node_name)] = T.Value(
                version, db.this_node_name, ser.dumps(db))
        pub.expired_keys.extend(expired)
        return pub

    def pdb(self, node, prefix=PFX):
        T = self.P.T
        return T.PrefixDatabase(node, [T.PrefixEntry(T.IpPrefix(prefix))])


# -- the scenarios: the reference's test bodies, one per test --------------


async def publication_to_route_delta(r):
    r.decision.start()
    dbs = r.P.build_adj_dbs([("a", "b", 1), ("b", "c", 1)])
    r.kv_q.push(r.pub(dbs.values(), [r.pdb("c")]))
    delta = await r.get()
    assert [e.prefix for e in delta.unicast_routes_to_update] == [
        r.P.T.IpPrefix(PFX)]
    nh = next(iter(delta.unicast_routes_to_update[0].nexthops))
    assert nh.neighbor_node == "b"
    assert delta.mpls_routes_to_update


async def debounce_batches_publications(r):
    r.decision.start()
    dbs = r.P.build_adj_dbs([("a", "b", 1), ("b", "c", 1), ("c", "d", 1)])
    for db in dbs.values():
        r.kv_q.push(r.pub([db]))
    r.kv_q.push(r.pub(prefix_dbs=[r.pdb("d")]))
    await r.get()
    assert r.decision.counters["decision.route_build_runs"] == 1
    assert r.decision.counters["decision.adj_db_update"] == 4


async def link_flap_reroutes(r):
    r.decision.start()
    dbs = r.P.build_adj_dbs([("a", "b", 1), ("b", "c", 1), ("a", "c", 5)])
    r.kv_q.push(r.pub(dbs.values(), [r.pdb("c")]))
    d1 = await r.get()
    assert next(iter(
        d1.unicast_routes_to_update[0].nexthops)).neighbor_node == "b"
    b_down = r.P.T.AdjacencyDatabase(
        "b", [x for x in dbs["b"].adjacencies if x.other_node_name != "c"],
        node_label=dbs["b"].node_label,
    )
    r.kv_q.push(r.pub([b_down], version=2))
    d2 = await r.get()
    route = next(e for e in d2.unicast_routes_to_update
                 if e.prefix == r.P.T.IpPrefix(PFX))
    assert {nh.neighbor_node for nh in route.nexthops} == {"c"}


async def adj_expiry_removes_routes(r):
    r.decision.start()
    dbs = r.P.build_adj_dbs([("a", "b", 1), ("b", "c", 1)])
    r.kv_q.push(r.pub(dbs.values(), [r.pdb("c")]))
    await r.get()
    r.kv_q.push(r.pub(expired=[r.P.T.adj_key("c")]))
    d2 = await r.get()
    assert r.P.T.IpPrefix(PFX) in d2.unicast_routes_to_delete


async def prefix_expiry(r):
    r.decision.start()
    dbs = r.P.build_adj_dbs([("a", "b", 1)])
    r.kv_q.push(r.pub(dbs.values(), [r.pdb("b")]))
    await r.get()
    r.kv_q.push(r.pub(expired=[r.P.T.prefix_key("b")]))
    d2 = await r.get()
    assert d2.unicast_routes_to_delete == [r.P.T.IpPrefix(PFX)]


async def cold_start_holds_computation(r):
    r.decision.start()
    dbs = r.P.build_adj_dbs([("a", "b", 1)])
    r.kv_q.push(r.pub(dbs.values(), [r.pdb("b")]))
    await asyncio.sleep(0.05)
    assert not r.decision.have_computed_routes
    delta = await r.get()
    assert r.decision.have_computed_routes
    assert delta.unicast_routes_to_update


def _policy(r, action):
    rib = r.P.rib
    return rib.RibPolicy(
        [rib.RibPolicyStatement("s1", {r.P.T.IpPrefix(PFX)}, action)],
        ttl_secs=60,
    )


async def rib_policy_weights(r):
    r.decision.start()
    dbs = r.P.build_adj_dbs([("a", "b", 1)])
    r.kv_q.push(r.pub(dbs.values(), [r.pdb("b")]))
    await r.get()
    r.decision.set_rib_policy(_policy(r, r.P.rib.SetWeightAction(
        default_weight=1, area_to_weight={"0": 7})))
    delta = await r.get()
    assert {nh.weight for nh in delta.unicast_routes_to_update[0].nexthops
            } == {7}


async def rib_policy_zero_weight_drops_nexthop(r):
    r.decision.start()
    dbs = r.P.build_adj_dbs([("a", "b", 1)])
    r.kv_q.push(r.pub(dbs.values(), [r.pdb("b")]))
    await r.get()
    r.decision.set_rib_policy(
        _policy(r, r.P.rib.SetWeightAction(default_weight=0)))
    delta = await r.get()
    assert delta.unicast_routes_to_update[0].nexthops == set()


async def get_decision_route_db_other_node(r):
    r.decision.start()
    dbs = r.P.build_adj_dbs([("a", "b", 1), ("b", "c", 1)])
    r.kv_q.push(r.pub(dbs.values(), [r.pdb("a")]))
    await r.get()
    c_db = r.decision.get_decision_route_db("c")
    r.deltas.append(canon(c_db.unicast_entries))
    nh = next(iter(c_db.unicast_entries[r.P.T.IpPrefix(PFX)].nexthops))
    assert nh.neighbor_node == "b"


async def device_backend_end_to_end(r):
    r.decision.start()
    dbs = r.P.build_adj_dbs(
        [("a", "b", 1), ("a", "c", 1), ("b", "d", 1), ("c", "d", 1)])
    r.kv_q.push(r.pub(dbs.values(), [r.pdb("d")]))
    delta = await r.get()
    route = delta.unicast_routes_to_update[0]
    assert {nh.neighbor_node for nh in route.nexthops} == {"b", "c"}
    solves = getattr(r.decision.solver, "device_solves", None)
    assert solves is None or solves >= 1


async def per_prefix_keys_accumulate(r):
    T = r.P.T
    r.decision.start()
    dbs = r.P.build_adj_dbs([("a", "b", 1)])
    p1, p2 = T.IpPrefix("10.1.0.0/16"), T.IpPrefix("10.2.0.0/16")
    pub = r.pub(dbs.values())
    for p in (p1, p2):
        pub.key_vals[T.prefix_key("b", p, "0")] = T.Value(
            1, "b", r.P.serializer.dumps(
                T.PrefixDatabase("b", [T.PrefixEntry(p)])))
    r.kv_q.push(pub)
    delta = await r.get()
    assert {e.prefix for e in delta.unicast_routes_to_update} == {p1, p2}
    r.kv_q.push(r.pub(expired=[T.prefix_key("b", p1, "0")]))
    d2 = await r.get()
    assert d2.unicast_routes_to_delete == [p1]
    assert r.decision.get_decision_route_db().unicast_entries.keys() == {p2}


async def node_label_only_change_rebuilds(r):
    r.decision.start()
    dbs = r.P.build_adj_dbs([("a", "b", 1)])
    r.kv_q.push(r.pub(dbs.values()))
    d1 = await r.get()
    assert {e.label for e in d1.mpls_routes_to_update} == {100, 101}
    b2 = r.P.T.AdjacencyDatabase("b", dbs["b"].adjacencies, node_label=555)
    r.kv_q.push(r.pub([b2], version=2))
    d2 = await r.get()
    assert {e.label for e in d2.mpls_routes_to_update} == {555}
    assert d2.mpls_routes_to_delete == [101]


async def malformed_value_does_not_kill_consumer(r):
    T = r.P.T
    r.decision.start()
    bad = T.Publication(area="0")
    bad.key_vals[T.adj_key("evil")] = T.Value(1, "evil", b"not-json")
    r.kv_q.push(bad)
    await asyncio.sleep(0.05)
    assert r.decision.counters.get("decision.errors") == 1
    dbs = r.P.build_adj_dbs([("a", "b", 1)])
    r.kv_q.push(r.pub(dbs.values(), [r.pdb("b")]))
    delta = await r.get()
    assert delta.unicast_routes_to_update


async def link_up_held_by_hop_distance_then_released(r):
    r.decision.start()
    dbs = r.P.build_adj_dbs([("a", "b", 1), ("b", "c", 1), ("c", "d", 1)])
    r.kv_q.push(r.pub(dbs.values(), [r.pdb("d")]))
    delta = await r.get()
    assert r.P.T.IpPrefix(PFX) in {
        e.prefix for e in delta.unicast_routes_to_update}
    dbs2 = r.P.build_adj_dbs([("a", "b", 1), ("b", "c", 5), ("c", "d", 1)])
    r.kv_q.push(r.pub([dbs2["b"]], version=2))
    with pytest.raises(asyncio.TimeoutError):
        await asyncio.wait_for(r.reader.get(), 0.15)
    r.decision.decrement_ordered_fib_holds()
    delta2 = await r.get(timeout=5)
    updated = {e.prefix: e for e in delta2.unicast_routes_to_update}
    nh = next(iter(updated[r.P.T.IpPrefix(PFX)].nexthops))
    assert nh.metric == 7, nh


async def solver_exception_does_not_kill_the_module(r):
    r.decision.start()
    boom = {"armed": True}
    real_build = r.decision.solver.build_route_db

    def flaky(*args, **kwargs):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected solver failure")
        return real_build(*args, **kwargs)

    r.decision.solver.build_route_db = flaky
    dbs = r.P.build_adj_dbs([("a", "b", 1), ("b", "c", 1)])
    r.kv_q.push(r.pub(dbs.values(), [r.pdb("c")]))
    delta = await r.get(timeout=5)
    assert r.decision.counters.get("decision.route_build_errors") == 1
    assert r.P.T.IpPrefix(PFX) in {
        e.prefix for e in delta.unicast_routes_to_update}


# (reference test, scenario, DecisionConfig keywords)
SCENARIOS = (
    ("TestDecision::test_publication_to_route_delta",
     publication_to_route_delta, {}),
    ("TestDecision::test_debounce_batches_publications",
     debounce_batches_publications, {}),
    ("TestDecision::test_link_flap_reroutes", link_flap_reroutes, {}),
    ("TestDecision::test_adj_expiry_removes_routes",
     adj_expiry_removes_routes, {}),
    ("TestDecision::test_prefix_expiry", prefix_expiry, {}),
    ("TestDecision::test_cold_start_holds_computation",
     cold_start_holds_computation, {"eor_time_s": 0.15}),
    ("TestDecision::test_rib_policy_weights", rib_policy_weights, {}),
    ("TestDecision::test_rib_policy_zero_weight_drops_nexthop",
     rib_policy_zero_weight_drops_nexthop, {}),
    ("TestDecision::test_get_decision_route_db_other_node",
     get_decision_route_db_other_node, {}),
    ("TestDecision::test_tpu_backend_end_to_end",
     device_backend_end_to_end, {}),
    ("TestDecision::test_per_prefix_keys_accumulate",
     per_prefix_keys_accumulate, {}),
    ("TestDecision::test_node_label_only_change_rebuilds",
     node_label_only_change_rebuilds, {}),
    ("TestDecision::test_malformed_value_does_not_kill_consumer",
     malformed_value_does_not_kill_consumer, {}),
    ("TestOrderedFib::test_link_up_held_by_hop_distance_then_released",
     link_up_held_by_hop_distance_then_released,
     {"enable_ordered_fib": True}),
    ("TestRebuildErrorResilience::"
     "test_solver_exception_does_not_kill_the_module",
     solver_exception_does_not_kill_the_module, {}),
)


def run_scenario(scenario, P, backend_cfg, cfg_kw) -> Run:
    async def body():
        r = Run(P, backend_cfg, **cfg_kw)
        try:
            await asyncio.wait_for(scenario(r), 20.0)
        finally:
            task = r.decision._task
            r.decision.stop()
            if task is not None:
                await asyncio.gather(task, return_exceptions=True)
        return r

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(body())
    finally:
        loop.close()


@pytest.mark.parametrize(
    "name,scenario,cfg_kw", SCENARIOS, ids=[s[0] for s in SCENARIOS]
)
def test_decision_scenario_equal_across_packages_and_backends(
    name, scenario, cfg_kw, fresh_ledgers
):
    runs = {
        label: run_scenario(scenario, P, backend_cfg, cfg_kw)
        for label, P, backend_cfg in DECISIONS
    }
    port = runs["port_cuda"]
    assert port.deltas, name
    for label, r in runs.items():
        assert r.deltas == port.deltas, f"{name}: {label} != port_cuda"
    assert counters(port.decision, True) == counters(
        runs["jax_tpu"].decision, True)
    assert counters(runs["port_cpu"].decision, False) == counters(
        runs["jax_cpu"].decision, False)
    # the recorder and the ledger were wired: the first solve is sampled
    got = counters(port.decision, True)
    assert got["decision.spf.traces_recorded"] >= 1
    assert got["decision.spf.traces_sampled"] >= 1
    assert got["decision.spf.phase.relax_ms.count"] >= 1
    assert got["decision.mem.registers"] >= 1
    # Decision.stop returned both ledgers to their (empty) baseline
    for led in fresh_ledgers:
        assert led.live_entries() == [] and led.check()
    assert fresh_ledgers[0].stripped == {}
    # the port's device Decision ran its solver under the supervisor
    from openr_tpu_torch.solver import CudaSpfSolver, SolverSupervisor

    assert isinstance(port.decision.solver, SolverSupervisor)
    assert isinstance(port.decision.solver.primary, CudaSpfSolver)
    assert port.decision.counters["decision.spf.fallback_active"] == 0


def test_serializer_gives_the_same_bytes_in_both_packages():
    """TestDecision::test_serializer_roundtrip_deterministic, and one
    publication's values serialized by each package byte for byte."""
    blobs = []
    for P in (PORT, JAX):
        T, ser = P.T, P.serializer
        dbs = P.build_adj_dbs(P.grid_edges(3))
        pdb = T.PrefixDatabase("g2_2", [T.PrefixEntry(T.IpPrefix(PFX))])
        pub = P.harness.lsdb_publication(
            dbs.values(), {"g2_2": [PFX], "g0_1": ["10.8.0.0/16"]})
        blob = ser.dumps(dbs["g0_0"])
        assert ser.dumps(ser.loads(blob)) == blob
        assert ser.loads(ser.dumps(pdb)) == pdb
        blobs.append({k: v.value for k, v in pub.key_vals.items()})
    assert blobs[0] == blobs[1]


def test_backend_string_other_than_cpu_or_cuda_raises():
    P = PORT
    for backend in ("tpu", "gpu", ""):
        with pytest.raises(ValueError, match="solver_backend"):
            P.Decision(
                P.DecisionConfig(my_node_name="a", solver_backend=backend),
                P.RQueue(P.RWQueue()), P.ReplicateQueue(),
            )


def test_default_backend_is_the_card_under_the_supervisor():
    """DecisionConfig's default backend is "cuda": CudaSpfSolver behind the
    SolverSupervisor; the CPU oracle only when asked for."""
    P = PORT
    assert P.DecisionConfig(my_node_name="a").solver_backend == "cuda"
    decision = P.Decision(
        P.DecisionConfig(my_node_name="a", solver_device="cpu"),
        P.RQueue(P.RWQueue()), P.ReplicateQueue(),
    )
    from openr_tpu_torch.solver import CudaSpfSolver, SolverSupervisor

    assert isinstance(decision.solver, SolverSupervisor)
    assert isinstance(decision.solver.primary, CudaSpfSolver)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host with "
                    "no CUDA card")
def test_cuda_backend_raises_without_a_card_unless_device_is_cpu():
    P = PORT
    for cfg in ({"solver_backend": "cuda"}, {}):
        with pytest.raises(RuntimeError):
            P.Decision(
                P.DecisionConfig(my_node_name="a", **cfg),
                P.RQueue(P.RWQueue()), P.ReplicateQueue(),
            )
    decision = P.Decision(
        P.DecisionConfig(my_node_name="a", solver_backend="cuda",
                         solver_device="cpu"),
        P.RQueue(P.RWQueue()), P.ReplicateQueue(),
    )
    assert decision.get_solver_health()["breaker_state"] == "closed"


def _grid_publication(P):
    dbs = P.build_adj_dbs(P.grid_edges(6))
    return P.harness.lsdb_publication(
        dbs.values(), {"g5_5": ["10.1.0.0/16"], "g0_5": ["10.2.0.0/16"],
                       "g3_2": ["10.3.0.0/16"]})


@pytest.mark.parametrize("shape", [None, (4, 2)])
def test_backend_parity_gate_on_a_mesh_of_cpu_ranks(shape):
    """run_decision_backend_parity: Decision(cuda) == Decision(cpu), bare
    and under a (4, 2) mesh of ranks that share the CPU, and its counts
    equal the JAX package's gate (Decision(tpu) == Decision(cpu))."""
    mesh = None
    if shape is not None:
        mesh = parallel.make_mesh([torch.device("cpu")] * 8, shape)
    got = t_harness.run_decision_backend_parity(
        "g0_0", _grid_publication(PORT), mesh, device="cpu")
    assert got == j_harness.run_decision_backend_parity(
        "g0_0", _grid_publication(JAX), None)
    assert got == (3, 36)
