"""The device-memory ledger wired into the port's solver, all-pairs state
and TE service, against the JAX package's, on the CPU.

The solver-driving cases of tests/test_memledger.py (the standalone
ledger's cases are in tests/test_torch_fault_modules.py), each driven
through both packages with the same input: the exact-accounting invariant
(registered == live + freed) after every solve, KSP batch, all-pairs close
and TE run; teardown, mesh degradation and invalidation returning the
ledger to its baseline; `predict_fit` against the registered bytes (sell,
bf and tile2d within 10%, apsp exact); capacity admission of the layouts
and of the all-pairs matrix, and the order in which the capacity source
appears.

Where the port keeps more than the JAX package, the difference is named:
the edge-list layout's `csr` (int32 [n_pad + 1], K2's and K6's in-edge
ranges) inside `bf`, and the tiling's `hptr` (int32 [g, h + 1], K19's
slot ranges) inside `tile`. `PortLedger` is the port's ledger with a
shadow of the JAX package's shape: every registration is mirrored less
its port-only array, and its `fold_counters` folds the shadow, so the
`decision.mem.*` counters of the two packages compare equal
(tests/test_torch_decision.py, tests/test_torch_supervisor.py) while the
port's own ledger stays exact and is held against its own `predict_fit`.
"""

import dataclasses

import pytest
import torch

import openr_tpu.apsp as j_apsp
import openr_tpu.monitor.memledger as j_memledger
import openr_tpu.solver.tpu as j_tpu
import openr_tpu_torch.apsp as t_apsp
import openr_tpu_torch.monitor.memledger as t_memledger
import openr_tpu_torch.solver.cuda as t_cuda
from openr_tpu.ops.graph import compile_edges as j_compile_edges
from openr_tpu_torch import parallel
from openr_tpu_torch.ops.graph import compile_edges as t_compile_edges
from openr_tpu_torch.parallel.mesh import tile_graph
from test_torch_decision import fresh_ledgers  # noqa: F401 (autouse)
from test_torch_memory import release_memory_around_each_test  # noqa: F401
from test_torch_supervisor import JAX, PORT, build_ls, make_ps

# structure -> (name, index in the registration's arrays) of the array the
# port keeps resident and the JAX package does not
PORT_ONLY = {"bf": ("csr", 2), "tile": ("hptr", 3)}


class _Shadow(t_memledger.MemLedger):
    """Accounting only: releases skip the `solver.mem.retain` seam, which
    the real ledger's release already passed."""

    def release(self, handle):
        with self._lock:
            entry = self._entries.pop(handle, None)
            if entry is None:
                return False
            self.releases += 1
            self.freed_bytes += entry.nbytes
            self.live_bytes -= entry.nbytes
            self._struct_delta(entry.structure, -entry.nbytes)
        return True


class PortLedger(t_memledger.MemLedger):
    """The port's ledger with a shadow in the JAX package's shape.

    Every registration is mirrored into `ref` less the port-only array of
    PORT_ONLY (bytes stripped, by structure, in `stripped`), every real
    release releases the mirror, and `fold_counters` folds the shadow:
    what the JAX package counts for the same structures. The port's CPU
    `reconcile` has no source and counts a drift event where the JAX
    package's CPU backend reads `jax.live_arrays()`; the shadow leaves
    those checks out (`unreconciled`)."""

    def __init__(self):
        super().__init__()
        self.ref = _Shadow()
        self._ref_handles = {}
        self.stripped = {}
        self.unreconciled = 0

    def register(self, area, structure, *, layout="none", arrays=(),
                 nbytes=None, **kw):
        arrays = tuple(arrays)
        handle = super().register(area, structure, layout=layout,
                                  arrays=arrays, nbytes=nbytes, **kw)
        nb = self._entries[handle].nbytes
        if structure in PORT_ONLY and arrays:
            extra = int(arrays[PORT_ONLY[structure][1]].nbytes)
            nb -= extra
            self.stripped[structure] = self.stripped.get(structure, 0) + extra
        self._ref_handles[handle] = self.ref.register(
            area, structure, layout=layout, nbytes=nb)
        return handle

    def release(self, handle):
        freed = super().release(handle)
        if freed:
            self.ref.release(self._ref_handles.pop(handle))
        return freed

    def reconcile(self):
        out = super().reconcile()
        if out["source"] == "unavailable":
            self.unreconciled += 1
        return out

    def fold_counters(self, counters):
        ref = self.ref
        ref._capacity_override = self._capacity_override
        ref._headroom_frac = self._headroom_frac
        ref.retained = self.retained
        ref.capacity_refusals = self.capacity_refusals
        ref.drift_events = self.drift_events - self.unreconciled
        ref.fold_counters(counters)


def assert_exact(ledger):
    snap = ledger.snapshot()
    t = snap["totals"]
    assert snap["exact"], t
    assert t["registered_bytes"] == t["live_bytes"] + t["freed_bytes"], t
    assert sum(e["nbytes"] for e in snap["entries"]) == t["live_bytes"], t


def live(ledger):
    """The live entries as (area, structure, layout, nbytes), in order."""
    return [(e.area, e.structure, e.layout, e.nbytes)
            for e in ledger.live_entries()]


def assert_same_as_reference(port, ref):
    """The port's live entries, less the port-only arrays, are the JAX
    package's entries; both ledgers are exact."""
    assert_exact(port)
    assert_exact(ref)
    assert live(port.ref) == live(ref)
    assert port.ref.check()


def both(fn):
    """fn(K) for the port and the JAX package: (port's, reference's)."""
    return fn(PORT), fn(JAX)


def _metric_event(K, ls, edges, a, b, metric):
    db = K.topology.build_adj_dbs(edges)[a]
    ls.update_adjacency_database(dataclasses.replace(db, adjacencies=[
        dataclasses.replace(x, metric=metric) if x.other_node_name == b
        else x for x in db.adjacencies]))


def _events(edges, me):
    """Three weight events on links away from me, the same for both
    packages."""
    far = [(a, b) for a, b, _ in edges if me not in (a, b)]
    return [(a, b, m) for (a, b), m in zip(far[:3], (7, 3, 9))]


# -- leak regression: solver lifecycles return the ledger to baseline ------


def test_warm_solves_and_teardown_return_to_baseline(fresh_ledgers):
    port, ref = fresh_ledgers
    edges = JAX.topology.wan_edges(16, seed=3)
    me = edges[0][0]

    def run(K):
        led = t_memledger.get_ledger() if K is PORT else j_memledger.get_ledger()
        ls = build_ls(K, edges)
        solver = K.primary(me)
        states = {"0": ls}
        solver.build_route_db(me, states, make_ps(K))
        assert led.live_entries(), "the solver registered nothing"
        assert_exact(led)
        for a, b, m in _events(edges, me):
            _metric_event(K, ls, edges, a, b, m)
            solver.build_route_db(me, states, make_ps(K))
            assert_exact(led)
        return solver

    t_solver, j_solver = both(run)
    assert_same_as_reference(port, ref)
    assert {e.structure for e in port.live_entries()} >= {"dist", "mirror"}
    t_solver.close()
    j_solver.close()
    assert port.live_entries() == [] and ref.live_entries() == []
    assert_same_as_reference(port, ref)


def test_mesh_degrade_and_invalidation_return_to_baseline(fresh_ledgers):
    port, ref = fresh_ledgers
    edges = JAX.topology.grid_edges(4)

    def run(K):
        led = t_memledger.get_ledger() if K is PORT else j_memledger.get_ledger()
        states = {"0": build_ls(K, edges)}
        solver = K.primary("g0_0", mesh=(2, 2))
        solver.build_route_db("g0_0", states, make_ps(K))
        assert {e.structure for e in led.live_entries()} >= {"tile", "halo"}
        out = [live(led.ref if K is PORT else led)]
        assert solver.degrade_mesh() is True
        assert led.live_entries() == []
        solver.build_route_db("g0_0", states, make_ps(K))
        assert led.live_entries()
        out.append(live(led.ref if K is PORT else led))
        solver.invalidate_warm_state()
        assert led.live_entries() == []
        solver.build_route_db("g0_0", states, make_ps(K))
        solver.close()
        assert led.live_entries() == []
        assert_exact(led)
        return out

    got, want = both(run)
    assert got == want
    # the tiles' hptr is the whole difference, once per tiled generation
    assert set(port.stripped) == {"tile"} and port.stripped["tile"] > 0
    assert_same_as_reference(port, ref)


def test_apsp_invalidation_returns_to_baseline(fresh_ledgers):
    port, ref = fresh_ledgers
    edges = JAX.topology.wan_edges(32, degree=4, seed=7)
    states = []
    for K, make, compile_edges in (
        (PORT, lambda: t_apsp.ApspState(64, device="cpu", area="test/apsp"),
         t_compile_edges),
        (JAX, lambda: j_apsp.ApspState(max_nodes=64, area="test/apsp"),
         j_compile_edges),
    ):
        led = t_memledger.get_ledger() if K is PORT else j_memledger.get_ledger()
        g = compile_edges(edges)
        apsp = make()
        assert apsp.ensure(g) is True
        assert [e.structure for e in led.live_entries()] == ["apsp"]
        assert_exact(led)
        apsp.invalidate("test_staleness")
        assert led.live_entries() == []
        assert apsp.ensure(g) is True
        states.append(live(led))
        apsp.close()
        assert led.live_entries() == []
        assert_exact(led)
    assert states[0] == states[1]
    assert_same_as_reference(port, ref)


# -- predict_fit against the registered bytes -------------------------------


def _area_bytes(ledger, area, skip=("mirror",)):
    return sum(e.nbytes for e in ledger.live_entries(area)
               if e.structure not in skip)


def assert_within(predicted, live_bytes, frac=0.10):
    assert live_bytes > 0
    assert abs(predicted - live_bytes) <= frac * live_bytes, (
        predicted, live_bytes)


def _port_solve(edges, me, mesh=None):
    return t_cuda._AreaSolve(build_ls(PORT, edges), me, torch.device("cpu"),
                             mesh=mesh)


def _fit_both(solve, j_graph, kind, mesh_shape=None):
    """The port's and the JAX package's predictions for the solve's graph
    and batch."""
    kw = dict(n_sources=len(solve.sources), mesh_shape=mesh_shape)
    port = t_memledger.get_ledger().predict_fit(
        solve.graph.n, kind, graph=solve.graph, **kw)
    ref = j_memledger.MemLedger().predict_fit(
        j_graph.n, kind, graph=j_graph, **kw)
    return port, ref


def test_sell_layout_within_ten_percent(fresh_ledgers):
    port, _ = fresh_ledgers
    edges = JAX.topology.wan_edges(24, seed=2)
    solve = _port_solve(edges, edges[0][0])
    try:
        assert solve._dev["kind"] == "sell"
        fit, ref_fit = _fit_both(solve, j_compile_edges(edges), "sell")
        assert_within(fit["predicted_bytes"],
                      _area_bytes(port, solve._mem_area))
        # component by component: the same arrays as the JAX package's
        assert fit["components"] == ref_fit["components"]
        by = {e.structure: e.nbytes for e in port.live_entries()}
        for name in ("dist", "sell", "patch"):
            assert by[name] == fit["components"][name], name
    finally:
        solve.close()
    assert port.live_entries() == []


def test_edge_list_layout_within_ten_percent(fresh_ledgers, monkeypatch):
    """The resident edge-list planes: the sliced layout is stripped from
    the compiled graph to force it, as the reference's case does. The
    port's `bf` also holds csr, [n_pad + 1] int32."""
    port, _ = fresh_ledgers
    real_compile = t_cuda.compile_graph

    def no_sell(ls):
        g = real_compile(ls)
        g.sell = None
        return g

    monkeypatch.setattr(t_cuda, "compile_graph", no_sell)
    edges = JAX.topology.wan_edges(24, seed=2)
    solve = _port_solve(edges, edges[0][0])
    try:
        assert solve._dev["kind"] == "bf"
        j_graph = j_compile_edges(edges)
        j_graph.sell = None
        fit, ref_fit = _fit_both(solve, j_graph, "bf")
        assert_within(fit["predicted_bytes"],
                      _area_bytes(port, solve._mem_area))
        csr = (solve.graph.n_pad + 1) * 4
        assert fit["components"]["bf"] == ref_fit["components"]["bf"] + csr
        assert fit["components"]["dist"] == ref_fit["components"]["dist"]
        by = {e.structure: e.nbytes for e in port.live_entries()}
        assert by["bf"] == fit["components"]["bf"]
        assert port.stripped == {"bf": csr}
        # the replicated edge-list layout has the same logical footprint
        repl = port.predict_fit(solve.graph.n, "replicated",
                                n_sources=len(solve.sources),
                                graph=solve.graph)
        assert repl["predicted_bytes"] == fit["predicted_bytes"]
    finally:
        solve.close()
    assert port.live_entries() == []


def test_tile2d_layout_within_ten_percent(fresh_ledgers):
    """The tiled layout on a (2, 2) mesh of CPU ranks: `tile` holds the
    JAX package's three planes and ov plus hptr [g, h + 1] int32."""
    port, _ = fresh_ledgers
    edges = JAX.topology.grid_edges(4)
    mesh = parallel.make_mesh([torch.device("cpu")] * 4, (2, 2))
    solve = _port_solve(edges, "g0_0", mesh=mesh)
    try:
        assert solve._dev["kind"] == "tile2d"
        fit, ref_fit = _fit_both(solve, j_compile_edges(edges), "tile2d",
                                 mesh_shape=(2, 2))
        assert_within(fit["predicted_bytes"],
                      _area_bytes(port, solve._mem_area))
        tiling = tile_graph(solve.graph, 2)
        hptr = tiling.hptr.nbytes
        assert hptr == 2 * (tiling.h + 1) * 4
        assert fit["components"]["tile"] == ref_fit["components"]["tile"] + hptr
        for name in ("dist", "halo"):
            assert fit["components"][name] == ref_fit["components"][name]
        by = {e.structure: e.nbytes for e in port.live_entries()}
        for name in ("dist", "tile", "halo"):
            assert by[name] == fit["components"][name], name
        assert port.stripped == {"tile": hptr}
    finally:
        solve.close()
    assert port.live_entries() == []


def test_apsp_layout_is_exact(fresh_ledgers):
    port, _ = fresh_ledgers
    edges = JAX.topology.wan_edges(48, degree=4, seed=7)
    g = t_compile_edges(edges)
    apsp = t_apsp.ApspState(64, device="cpu", area="test/apsp-fit")
    try:
        assert apsp.ensure(g) is True
        fit = port.predict_fit(g.n, "apsp", graph=g)
        assert fit["predicted_bytes"] == _area_bytes(port, "test/apsp-fit")
        ref_fit = j_memledger.MemLedger().predict_fit(
            g.n, "apsp", graph=j_compile_edges(edges))
        assert fit["components"] == ref_fit["components"]
    finally:
        apsp.close()
    assert port.live_entries() == []


# -- KSP's transient structure and TE's working set --------------------------


def test_ksp_batch_registers_its_rows_and_releases_them(fresh_ledgers,
                                                        monkeypatch):
    """The edge-list layout's per-row weights [s_pad, e_pad] register for
    the batch and release with it, in both packages; the ledger is exact
    after the batch, and the batch's peak equals the reference's."""
    port, ref = fresh_ledgers
    edges = JAX.topology.grid_edges(4)
    got = []
    for K, mod in ((PORT, t_cuda), (JAX, j_tpu)):
        real_compile = mod.compile_graph

        def no_sell(ls, real_compile=real_compile):
            g = real_compile(ls)
            g.sell = None
            return g

        monkeypatch.setattr(mod, "compile_graph", no_sell)
        ls = build_ls(K, edges)
        if K is PORT:
            solve = t_cuda._AreaSolve(ls, "g0_0", torch.device("cpu"))
            led = port
        else:
            solve = j_tpu._AreaSolve(ls, "g0_0")
            led = ref
        solve.prefetch_ksp(["g3_3", "g2_3", "g3_1"], 2)
        assert "ksp" not in {e.structure for e in led.live_entries()}
        assert_exact(led)
        got.append((led.structure_peak_bytes()["ksp"], solve.ksp_device_batches))
        solve.close()
    assert got[0] == got[1] and got[0][0] > 0
    assert_same_as_reference(port, ref)


def _te_pair(edges, params, mesh=None):
    """Both packages' TeService on the same LSDB; each records the ledger's
    `te` bytes while its optimization runs."""
    import openr_tpu.te.service as j_service
    import openr_tpu_torch.te.service as t_service
    from openr_tpu.te import TeService as JTeService
    from openr_tpu_torch.te import TeService

    seen = {}
    for name, mod, make in (
        ("port", t_service, lambda: TeService(
            "g0_0", {"0": build_ls(PORT, edges)}, device="cpu", mesh=mesh)),
        ("jax", j_service, lambda: JTeService(
            "g0_0", {"0": build_ls(JAX, edges)})),
    ):
        led = (t_memledger if name == "port" else j_memledger).get_ledger()
        real = mod.optimize_weights

        def spy(*a, real=real, led=led, name=name, **kw):
            seen[name] = (dict(led.structure_bytes()), [
                (e.area, e.structure) for e in led.live_entries()])
            return real(*a, **kw)

        mod.optimize_weights = spy
        try:
            report = make().optimize(dict(params))
        finally:
            mod.optimize_weights = real
        assert report["degraded"] is False
        assert led.live_entries() == []
        assert_exact(led)
    return seen


def test_te_run_registers_its_working_set_for_its_duration(fresh_ledgers):
    port, ref = fresh_ledgers
    seen = _te_pair(JAX.topology.grid_edges(3), {"steps": 2, "scenarios": 2})
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == [("0/te", "te")]
    assert seen["port"][0]["te"] > 0
    assert_same_as_reference(port, ref)


@pytest.mark.parametrize("b,expect", [(3, 1), (4, 0)])
def test_te_shards_register_their_own_memory_on_a_mesh(fresh_ledgers, b,
                                                       expect):
    """Under a (2, 1) mesh of CPU ranks a shard's slice of the uploaded
    batch is a view on its card and counts nothing; a batch padded to the
    axis is new memory, counted once, for rank 0. Released with the run."""
    from openr_tpu_torch.te import optimizer as topt
    from openr_tpu_torch.te.scenarios import build_demand_scenarios
    from openr_tpu_torch.te.objective import te_edge_arrays
    from openr_tpu_torch.ops.graph import compile_graph

    port, _ = fresh_ledgers
    graph = compile_graph(build_ls(PORT, JAX.topology.grid_edges(3)))
    src_e, dst_e, w0, up = te_edge_arrays(graph)
    demands, caps, _ = build_demand_scenarios(graph, None, scenarios=b)
    mesh = parallel.make_mesh([torch.device("cpu")] * 2, (2, 1))
    regs = []
    real = port.register

    def spy(area, structure, **kw):
        regs.append((area, structure, kw.get("nbytes")))
        return real(area, structure, **kw)

    port.register = spy
    topt.optimize_weights(src_e, dst_e, up, w0, demands, caps, graph.n,
                          config=topt.TeOptConfig(steps=2), mesh=mesh,
                          device="cpu", mem_area="0/te")
    shard_regs = [r for r in regs if r[1] == "te.shard"]
    assert len(shard_regs) == expect
    if expect:
        n = graph.n
        assert shard_regs[0][0] == "0/te/rank0@cpu"
        assert shard_regs[0][2] == 4 * n * n * 4 + 4 * 4  # padded batch, mask
    assert port.live_entries() == []
    assert_exact(port)


# -- capacity admission --------------------------------------------------------


def test_layout_refusal_raises_before_anything_is_registered(fresh_ledgers):
    """A capacity below the sliced layout's prediction: both packages
    raise their DeviceCapacityError with the same message before any
    registration, record the refusal, and queue it for the supervisor."""
    port, ref = fresh_ledgers
    edges = JAX.topology.grid_edges(4)
    got = []
    for K, led, mod in ((PORT, port, t_cuda), (JAX, ref, j_tpu)):
        led.set_capacity_override(1024)
        solver = K.primary("g0_0")
        with pytest.raises(mod.DeviceCapacityError,
                           match="predicted RESOURCE_EXHAUSTED: layout sell"
                           ) as err:
            solver.build_route_db("g0_0", {"0": build_ls(K, edges)},
                                  make_ps(K))
        assert led.live_entries() == []
        assert led.capacity_refusals == 1
        refusals = solver.take_capacity_refusals()
        assert solver.take_capacity_refusals() == []
        got.append((str(err.value), refusals, led.last_refusal))
    assert got[0] == got[1]
    assert got[0][1][0]["fits"] is False


def test_apsp_refusal_once_per_snapshot_with_the_batch_served(fresh_ledgers):
    """A capacity that holds the solve's structures but not the all-pairs
    matrix (one byte short): the all-pairs admission refuses once per
    graph snapshot, the refusal is queued, and a source outside the batch
    is answered by the LinkState's Dijkstra (the port counts it in
    host_spf_calls). Equal verdicts and answers in both packages."""
    port, ref = fresh_ledgers
    edges = JAX.topology.grid_edges(4)
    got = []
    for K, led in ((PORT, port), (JAX, ref)):
        solver = K.primary("g0_0", apsp_max_nodes=4096)
        ls = build_ls(K, edges)
        solver.build_route_db("g0_0", {"0": ls}, make_ps(K))
        (_, solve), = solver._solves.values()
        apsp_bytes = 16 * 16 * 9  # d, w int32 and allow bool, n_pad 16
        led.set_headroom_frac(0.0)
        led.set_capacity_override(led.live_bytes + apsp_bytes - 1)
        assert solve.ensure_apsp() is False
        assert solve.ensure_apsp() is False
        dist = solver._dist(ls, "g3_3", "g0_2")
        refusals = solver.take_capacity_refusals()
        assert len(refusals) == 1 and refusals[0]["layout"] == "apsp"
        assert refusals[0]["headroom_bytes"] == -1
        assert led.capacity_refusals == 1
        assert "apsp" not in {e.structure for e in led.live_entries()}
        got.append((refusals, solve.apsp.last_refusal, dist))
        if K is PORT:
            assert solver.host_spf_calls == 1
        solver.close()
        assert led.live_entries() == []
    assert got[0] == got[1]
    assert got[0][2] == 4


def test_capacity_source_appears_with_the_cards_context(monkeypatch):
    """The order: until CUDA is initialised the ledger has no capacity
    source, and the all-pairs gate is the node cap; once it is, capacity
    is the card's total memory and admission is predict_fit's. On the card
    CudaSpfSolver initialises CUDA when it is made, before any admission
    (here the card is emulated: torch.cuda's entry points are replaced)."""
    led = t_memledger.MemLedger()
    g = t_compile_edges(JAX.topology.wan_edges(48, degree=4, seed=7))
    monkeypatch.setattr(t_memledger, "_LEDGER", led)
    apsp = t_apsp.ApspState(16, device="cpu")
    assert led.capacity()["source"] == "fallback"
    assert apsp.enabled_for(g) is False  # 48 nodes past the cap of 16
    state = {"initialised": False}
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized",
                        lambda: state["initialised"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def init():
        calls.append("init")
        state["initialised"] = True

    monkeypatch.setattr(torch.cuda, "init", init)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda d: type("P", (), {"total_memory": 1 << 30})())
    # made, not initialised: still no source
    assert led.capacity()["source"] == "fallback"
    t_cuda.CudaSpfSolver("a", device="cuda")
    assert calls == ["init"]
    assert led.capacity() == {"capacity_bytes": 1 << 30,
                              "source": "memory_stats"}
    # now the all-pairs gate is the model's: 1 GiB holds the 48-node
    # matrix the node cap refused, and refuses a 16,384-node one
    assert apsp.enabled_for(g) is True
    # a 16,384-node graph's matrix, 2.25 GiB, is refused (only the sizes
    # that predict_fit reads are given)
    big = type("G", (), {"n": 16000, "n_pad": 16384, "e": 64000,
                         "e_pad": 65536, "version": 1})()
    assert apsp.enabled_for(big) is False
    assert apsp.enabled_for(big) is False  # once per snapshot
    assert led.capacity_refusals == 1
