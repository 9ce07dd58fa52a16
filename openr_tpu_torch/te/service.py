"""TE engine: what-if gradient-descent weight optimization over the live
LSDB.

The counterpart of the JAX package's te/service.py. `TeService` snapshots an
area's `LinkState` into the compiled graph arrays (ops/graph.py), builds
the demand-scenario batch (te/scenarios.py), and runs the annealed GD loop
(te/optimizer.py) on `device`, "cuda" by default.

What degrades, and through what: when the solver is a `SolverSupervisor`
the run is a supervised call (classified errors, bounded retry, a per-call
deadline, the shared breaker), and a failing or degraded device run is
re-run on the CPU (`optimize_weights(..., device="cpu")`), counted in
`decision.te.fallback_runs`, reported as `"backend": "cpu-fallback"`,
`"degraded": true`, and logged as a `TE_OPTIMIZE_DEGRADED` sample; a
kernel fault (`supervisor.is_kernel_fault`: no build, a refused launch, a
fault on the card) is not re-run but raises, as it does without the
supervisor, counted in `decision.te.optimize_errors`. Without
a supervisor a failing device run raises (and counts
`decision.te.optimize_errors`): the JAX package's bare try/except fallback
is not copied, so the work never moves to the CPU behind the caller's back.

This is a REPORTING service: it proposes per-link metric changes plus the
predicted hard-SPF max-link-utilization delta; nothing is programmed.

With a mesh (given, or the solver's) the scenario batch is sharded over
its 'batch' axis (te/optimizer.py). The run's working set registers with
the device-memory ledger for its duration: the scenario batch and the
capacities under "{area}/te", as the JAX package registers them, and under
a mesh each rank's shard on its own card (`adam_solve(mem_area=)`).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np

from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.ops.graph import compile_graph
from openr_tpu_torch.te.objective import hard_utilization, te_edge_arrays
from openr_tpu_torch.te.optimizer import TeOptConfig, optimize_weights
from openr_tpu_torch.te.scenarios import build_demand_scenarios
from openr_tpu_torch.testing.faults import fault_point
from openr_tpu_torch.utils.counters import CountersMixin, HistogramsMixin

log = logging.getLogger(__name__)

# report at most this many hottest links per utilization table
_TOP_LINKS = 8


class TeService(CountersMixin, HistogramsMixin):
    """Differentiable-TE optimization over Decision's LSDB snapshot."""

    def __init__(
        self,
        my_node_name: str,
        area_link_states: Dict,
        solver=None,
        device: DeviceLike = "cuda",
        mesh=None,
        log_sample_fn=None,
    ) -> None:
        self.my_node_name = my_node_name
        self.area_link_states = area_link_states
        # the Decision solver facade; when it is a SolverSupervisor the
        # optimization runs as a supervised call and shares the breaker,
        # and when it offers borrow_apsp the initial scoring reads its
        # resident all-pairs matrix
        self.solver = solver
        self._log_sample_fn = log_sample_fn
        self.device = resolve_device(device)
        # the scenario batch rides the solver's mesh unless one is given
        self.mesh = mesh if mesh is not None else getattr(solver, "mesh", None)
        self.counters: Dict[str, int] = {}
        self.histograms: Dict = {}

    # ------------------------------------------------------------------

    def optimize(self, params: Optional[Dict] = None) -> Dict:
        """One what-if optimization; returns the JSON-shaped report served
        by ctrl `runTeOptimize`. Raises ValueError on an empty topology
        (per-request ctrl error, not a degraded run)."""
        params = dict(params or {})
        t0 = time.perf_counter()
        self._bump("decision.te.optimize_runs")
        try:
            report = self._optimize(params, t0)
        except Exception:
            self._bump("decision.te.optimize_errors")
            raise
        self._observe("decision.te.solve_ms", report["solve_ms"])
        return report

    def _optimize(self, params: Dict, t0: float) -> Dict:
        area, link_state = self._pick_area(params.get("area"))
        graph = compile_graph(link_state)
        if graph.n < 2 or graph.e == 0:
            raise ValueError(f"area {area}: no usable topology to optimize")
        src_e, dst_e, w0, up = te_edge_arrays(graph)
        # overloaded (drained) nodes carry no transit traffic: their
        # out-edges leave the optimization and their originating demands
        # are zeroed (a drained node is not a TE source either)
        drained = graph.overloaded[src_e]
        up = up & ~drained
        demands, caps, scenarios = build_demand_scenarios(
            graph,
            params.get("demands"),
            scenarios=params.get("scenarios"),
            seed=int(params.get("seed", 0)),
        )
        drained_rows = np.flatnonzero(graph.overloaded[: graph.n])
        if len(drained_rows):
            demands[:, drained_rows, :] = 0.0
            demands[:, :, drained_rows] = 0.0
        # device-memory ledger seam: the [B, N, N] scenario batch and the
        # capacity vector are the run's resident working set, registered
        # for the optimization's duration (the JAX package's structure;
        # the loop's own state, activations and gradients, is not counted
        # by either package)
        from openr_tpu_torch.monitor.memledger import get_ledger

        ledger = get_ledger()
        mem_handle = ledger.register(
            f"{area}/te", "te", layout="te", arrays=(demands, caps)
        )

        cfg = TeOptConfig(
            steps=int(params.get("steps", TeOptConfig.steps)),
            lr=float(params.get("lr", TeOptConfig.lr)),
            tau0=float(params.get("tau0", TeOptConfig.tau0)),
            tau_min=float(params.get("tau_min", TeOptConfig.tau_min)),
            tau_obj=float(params.get("tau_obj", TeOptConfig.tau_obj)),
            w_min=float(params.get("w_min", TeOptConfig.w_min)),
            w_max=float(params.get("w_max", TeOptConfig.w_max)),
            rounds=params.get("rounds"),
        )
        initial_d = self._borrow_initial_distances(
            area, link_state, graph, w0, up, cfg
        )

        def primary():
            # named fault seam: the supervisor's TE fault tests raise here,
            # where a kernel launch would
            fault_point("te.optimize", self)
            return optimize_weights(
                src_e, dst_e, up, w0, demands, caps, graph.n,
                config=cfg, mesh=self.mesh, initial_d=initial_d,
                device=self.device, mem_area=f"{area}/te",
            )

        def fallback():
            # the identical optimization on the CPU: the degraded path
            self._bump("decision.te.fallback_runs")
            return optimize_weights(
                src_e, dst_e, up, w0, demands, caps, graph.n,
                config=cfg, initial_d=initial_d, device="cpu",
            )

        supervised = getattr(self.solver, "supervised_call", None)
        try:
            if supervised is not None:
                result, degraded = supervised(
                    "te.optimize", primary, fallback
                )
            else:
                result, degraded = primary(), False
        finally:
            ledger.release(mem_handle)
        if degraded:
            self._emit_degraded(area)

        self._bump("decision.te.steps", result.steps)
        self._bump("decision.te.d2h_bytes", result.d2h_bytes)
        self.counters["decision.te.steps_last"] = result.steps
        self.counters["decision.te.scenarios_last"] = scenarios
        improved = result.best_max_util < result.initial_max_util
        self.counters["decision.te.improved_last"] = int(improved)
        solve_ms = (time.perf_counter() - t0) * 1e3
        return self._build_report(
            area, graph, src_e, dst_e, up, demands, caps, result,
            scenarios, degraded, improved, solve_ms, initial_d=initial_d,
        )

    # ------------------------------------------------------------------

    def _pick_area(self, area: Optional[str]):
        if area is not None:
            link_state = self.area_link_states.get(area)
            if link_state is None:
                raise ValueError(f"unknown area {area!r}")
            return area, link_state
        for name, link_state in sorted(self.area_link_states.items()):
            if link_state.num_links():
                return name, link_state
        raise ValueError("no area holds any links")

    def _borrow_initial_distances(
        self, area, link_state, graph, w0, up, cfg
    ):
        """Borrow the solver's resident APSP matrix for the live weights
        (docs/Apsp.md TE consumer): the exact [n, n] distances the initial
        hard-scoring would otherwise re-derive by Bellman-Ford. Only valid
        when the scored integer weights are EXACTLY the live graph weights
        (the [w_min, w_max] projection can clip extreme metrics) and the
        solver holds a fresh matrix for this snapshot — anything else
        returns None and the optimizer derives distances itself."""
        borrow = getattr(self.solver, "borrow_apsp", None)
        if borrow is None:
            return None
        w0_int = np.clip(np.rint(w0), cfg.w_min, cfg.w_max).astype(np.int64)
        live = graph.w[: graph.e].astype(np.int64)
        if not np.array_equal(w0_int[up], live[up]):
            return None
        d = borrow(area, link_state.version)
        if d is None or d.shape[0] < graph.n:
            return None
        self._bump("decision.te.apsp_borrows")
        return np.asarray(d[: graph.n, : graph.n])

    def _build_report(
        self,
        area,
        graph,
        src_e,
        dst_e,
        up,
        demands,
        caps,
        result,
        scenarios,
        degraded,
        improved,
        solve_ms,
        initial_d=None,
    ) -> Dict:
        names = graph.names

        def top_links(w_int, d=None) -> List[Dict]:
            worst = np.zeros(len(src_e))
            for k in range(demands.shape[0]):
                worst = np.maximum(
                    worst,
                    hard_utilization(
                        w_int, demands[k], caps, src_e, dst_e, up, graph.n,
                        d=d,
                    ),
                )
            order = np.argsort(-worst)[:_TOP_LINKS]
            return [
                {
                    "src": names[int(src_e[e])],
                    "dst": names[int(dst_e[e])],
                    "util": round(float(worst[e]), 4),
                }
                for e in order
                if worst[e] > 0
            ]

        w0_int = np.rint(result.w0).astype(np.int64)
        changes: List[Dict] = []
        for link, (fwd, rev) in sorted(
            graph.link_edges.items(), key=lambda kv: kv[0].key
        ):
            for pos, node in ((fwd, link.n1), (rev, link.n2)):
                if pos >= len(w0_int) or not up[pos]:
                    continue
                before = int(w0_int[pos])
                after = int(result.w_best[pos])
                if before != after:
                    changes.append(
                        {
                            "node": node,
                            "neighbor": link.other_node_name(node),
                            "iface": link.iface_from_node(node),
                            "metric_before": before,
                            "metric_after": after,
                        }
                    )

        return {
            "node": self.my_node_name,
            "area": area,
            "nodes": graph.n,
            "links": int(np.count_nonzero(up)),
            "scenarios": scenarios,
            "steps": result.steps,
            "best_step": result.best_step,
            "backend": "cpu-fallback" if degraded else "primary",
            "degraded": bool(degraded),
            "improved": bool(improved),
            "initial_max_util": round(float(result.initial_max_util), 6),
            "optimized_max_util": round(float(result.best_max_util), 6),
            "max_util_delta": round(
                float(result.best_max_util - result.initial_max_util), 6
            ),
            "weight_changes": changes if improved else [],
            "top_links": {
                "initial": top_links(w0_int, d=initial_d),
                "optimized": top_links(
                    result.w_best if improved else w0_int,
                    d=None if improved else initial_d,
                ),
            },
            "loss_first": round(float(result.losses[0]), 6)
            if len(result.losses)
            else None,
            "loss_last": round(float(result.losses[-1]), 6)
            if len(result.losses)
            else None,
            "solve_ms": round(solve_ms, 3),
        }

    # ------------------------------------------------------------------

    def _emit_degraded(self, area: str) -> None:
        if self._log_sample_fn is None:
            return
        from openr_tpu_torch.monitor.monitor import LogSample

        sample = LogSample()
        sample.add_string("event", "TE_OPTIMIZE_DEGRADED")
        sample.add_string("area", area)
        try:
            self._log_sample_fn(sample)
        except Exception:  # a closed monitor queue must not fail the run
            log.exception("failed to emit TE degraded log sample")
