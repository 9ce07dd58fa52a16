"""Batched SPF solver backend on the card: the cold path.

Drop-in replacement for the CPU oracle: inherits the whole route-assembly
pipeline from SpfSolver and overrides the SPF access seam so that distances
and ECMP nexthop sets come from one batched min-plus solve on the card
(ops/spf.py) instead of per-source Dijkstra runs.

Per (area, topology version, node) the solver compiles the LinkState to
padded arrays and solves for sources = {me} ∪ up-neighbours(me) in one
device solve — exactly the rows the route pipeline reads:
  - reachability and metric from me (best-announcer selection)
  - dist(neighbour, t) for the triangle-condition ECMP nexthops and for the
    RFC 5286 LFA inequality
Nexthop sets come from the ECMP triangle kernel over me's up-links,
w(me, n) + D[n, t] == D[me, t], which reproduces Dijkstra's nexthop-union
semantics (LinkState.cpp:855-871) without tracing paths.

Every solve is cold (from D0 = INF). A source outside the solved batch is
answered by the LinkState's own Dijkstra, and each such answer is counted
in `host_spf_calls`. KSP is not on the card yet and raises.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from openr_tpu_torch.convert import to_device, weights_to_device
from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.lsdb.link_state import LinkState, Path
from openr_tpu_torch.ops.graph import (
    INF,
    CompiledGraph,
    _next_bucket,
    compile_graph,
    refresh_graph,
)
from openr_tpu_torch.ops.spf import (
    _bf_d0,
    _bf_relax,
    _sell_solver_counted,
    ecmp_triangle,
)
from openr_tpu_torch.solver.cpu import Metric, SpfSolver

_KSP_TODO = "KSP on device: ROADMAP queue 1 item 7"


class _NodeView:
    """NodeSpfResult-compatible view over the device distance matrix."""

    __slots__ = ("metric", "_result", "_dest")

    def __init__(self, metric: Metric, result: "_CudaSpfResult", dest: str):
        self.metric = metric
        self._result = result
        self._dest = dest

    @property
    def next_hops(self) -> Set[str]:
        return self._result.next_hops_of(self._dest)


class _CudaSpfResult:
    """SpfResult-compatible mapping dest -> _NodeView, backed by D rows."""

    def __init__(self, area: "_AreaSolve", source: str):
        self._area = area
        self._source = source
        self._src_row = area.row_map[source]
        self._nh_cache: Dict[str, Set[str]] = {}

    def __contains__(self, dest: str) -> bool:
        col = self._area.graph.node_index.get(dest)
        if col is None:
            return False
        return self._area.d[self._src_row, col] < INF

    def get(self, dest: str) -> Optional[_NodeView]:
        col = self._area.graph.node_index.get(dest)
        if col is None:
            return None
        metric = int(self._area.d[self._src_row, col])
        if metric >= INF:
            return None
        return _NodeView(metric, self, dest)

    def __getitem__(self, dest: str) -> _NodeView:
        view = self.get(dest)
        if view is None:
            raise KeyError(dest)
        return view

    def next_hops_of(self, dest: str) -> Set[str]:
        """ECMP nexthop node set for source -> dest. Only solved from the
        primary node's perspective, which is the only one the route
        pipeline reads nexthop sets from; any other source fails fast
        rather than serve a partial answer."""
        if self._source != self._area.sources[0]:
            raise RuntimeError(
                f"nexthop sets are only solved for {self._area.sources[0]}, "
                f"requested for {self._source}"
            )
        cached = self._nh_cache.get(dest)
        if cached is not None:
            return cached
        area = self._area
        nhs: Set[str] = set()
        if dest != self._source:
            col = area.graph.node_index.get(dest)
            if col is not None:
                names, mask = area.nh_mask()
                nhs = {n for n, hit in zip(names, mask[:, col]) if hit}
        self._nh_cache[dest] = nhs
        return nhs


class _AreaSolve:
    """One batched cold solve on the card: sources = [me] + up-neighbours(me).

    The layout buffers and the distance matrix stay on the card between
    reads; host readers go through the lazy `d` mirror. On a topology
    change `refresh()` patches the compiled arrays through the LinkState
    changelog, re-uploads the weight buffers (the index buffers are kept
    while the structure is unchanged) and solves cold again."""

    def __init__(
        self, link_state: LinkState, me: str, device: torch.device
    ) -> None:
        self.link_state = link_state
        self.me = me
        self.device = device
        self.graph: CompiledGraph = compile_graph(link_state)
        # every solve is cold and full: this one count feeds both
        # device_solves and decision.spf.full_solves
        self.device_solves = 0
        self.rounds_last: Optional[int] = None
        self.solve_ms_last: Optional[float] = None
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self._h2d_synced = 0
        self._d2h_synced = 0
        self._dev: Optional[dict] = None
        self._dev_graph: Optional[CompiledGraph] = None
        self._d_dev: Optional[torch.Tensor] = None
        self._d_host: Optional[np.ndarray] = None
        self._nh_links: Optional[List[str]] = None
        self._nh_mask: Optional[np.ndarray] = None
        self._solve()

    @property
    def d(self) -> np.ndarray:
        """Host mirror of the device distance matrix [s_pad, n_pad], fetched
        on first access after each solve. An owned copy: on the CPU device
        the tensor's numpy view would alias the solver's own buffer."""
        if self._d_host is None:
            self._d_host = self._d_dev.cpu().numpy().copy()
            self.d2h_bytes += self._d_host.nbytes
        return self._d_host

    def _upload(self) -> dict:
        """Persistent device buffers for the current graph: everything on a
        structural rebuild (new src array), only the weight and overload
        buffers on a weight or overload patch."""
        g = self.graph
        st = self._dev
        if st is None or st["src_ref"] is not g.src:
            up = to_device(g, self.device)
            st = self._dev = dict(up, src_ref=g.src)
        elif self._dev_graph is not g:
            up = weights_to_device(g, self.device)
            st.update(up)
        else:
            up = {}
        self.h2d_bytes += sum(
            t.numel() * t.element_size()
            for v in up.values()
            for t in (v if isinstance(v, tuple) else (v,))
        )
        self._dev_graph = g
        return st

    def _solve(self) -> None:
        me = self.me
        neighbors = sorted(
            {
                link.other_node_name(me)
                for link in self.link_state.links_from_node(me)
                if link.is_up()
            }
        )
        self.sources: List[str] = [me] + neighbors
        self.row_map: Dict[str, int] = {
            name: i for i, name in enumerate(self.sources)
        }
        rows = np.array(
            [self.graph.node_index[s] for s in self.sources], dtype=np.int32
        )
        # bucket-padded batch; padding rows repeat me's row (and so solve
        # with me's transit mask)
        s_pad = _next_bucket(len(rows), minimum=8)
        rows = np.concatenate(
            [rows, np.full(s_pad - len(rows), rows[0], dtype=np.int32)]
        )
        t0 = time.perf_counter()
        st = self._upload()
        g = self.graph
        sources = torch.as_tensor(rows, device=self.device)
        self.h2d_bytes += rows.nbytes
        if g.sell is not None:
            d, rounds = _sell_solver_counted(
                g.sell.shape_key(), sources, st["nbrs"], st["wgs"], st["ov"]
            )
        else:
            d, rounds = _bf_relax(
                _bf_d0(sources, g.n_pad),
                sources,
                st["ov"],
                st["src"],
                st["dst"],
                st["w"][None, :],
                st["csr"],
            )
        # `rounds` is read from the card every round, so the wall time
        # covers the device work
        self.solve_ms_last = (time.perf_counter() - t0) * 1e3
        self._d_dev = d
        self.rounds_last = rounds
        self.device_solves += 1
        self._d_host = None
        self._nh_links = None
        self._nh_mask = None

    def _nh_link_arrays(
        self,
    ) -> Tuple[List[str], List[int], List[int], List[int]]:
        """(names, batch rows, metrics, node ids) of my ordered up-links —
        the nh_mask triangle inputs."""
        ls = self.link_state
        names: List[str] = []
        rows: List[int] = []
        ws: List[int] = []
        ids: List[int] = []
        for link in ls.ordered_links_from_node(self.me):
            if not link.is_up():
                continue
            n = link.other_node_name(self.me)
            r = self.row_map.get(n)
            if r is None:
                continue
            names.append(n)
            rows.append(r)
            ws.append(link.metric_from_node(self.me))
            ids.append(self.graph.node_index[n])
        return names, rows, ws, ids

    def nh_mask(self) -> Tuple[List[str], np.ndarray]:
        """(neighbour names, [L, n_pad] bool): entry [i, t] is True iff the
        i-th up-link from me is an ECMP first hop toward node t.

        Computed on the card by the triangle kernel over the solved rows
        (w(me,v) + D[v, t] == D[me, t], with overloaded neighbours valid
        only as final destinations); the host gets the [L, n_pad] mask."""
        if self._nh_mask is None:
            names, rows, ws, ids = self._nh_link_arrays()
            if not names:
                self._nh_links = []
                self._nh_mask = np.zeros((0, self.graph.n_pad), dtype=bool)
                return self._nh_links, self._nh_mask

            def up(a):
                return torch.as_tensor(
                    np.asarray(a, dtype=np.int32), device=self.device
                )

            mask = ecmp_triangle(
                self._d_dev,
                up(np.zeros(len(rows))),
                up(rows),
                up(ids),
                up(ws),
                self._dev["ov"],
            )
            self._nh_mask = mask.cpu().numpy().copy()
            self._nh_links = names
            self.h2d_bytes += 16 * len(names)
            self.d2h_bytes += self._nh_mask.nbytes
        return self._nh_links, self._nh_mask

    def refresh(self) -> None:
        """Re-solve against the current LinkState snapshot if it moved."""
        if self.graph.version == self.link_state.version:
            return
        self.graph = refresh_graph(self.graph, self.link_state)
        self._solve()


class CudaSpfSolver(SpfSolver):
    """SpfSolver with the batched device distance backend.

    device: "cuda" (default) runs the hand-written kernels and raises when
    no card is present; "cpu" runs their plain PyTorch versions."""

    def __init__(self, *args, device: DeviceLike = "cuda", **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)
        # (area name, node) -> (LinkState identity, solve); keyed by the
        # stable area name so a replaced LinkState for the same area
        # overwrites its predecessor
        self._solves: Dict[Tuple[str, str], Tuple[int, _AreaSolve]] = {}
        self.device_solves = 0  # counter: batched device solves
        # SPF answers served by host Dijkstra (sources outside the batch,
        # areas without me); the main path keeps this at 0
        self.host_spf_calls = 0
        self.solve_ms_last: Optional[float] = None

    def _area_solve(
        self, link_state: LinkState, node: str
    ) -> Optional[_AreaSolve]:
        """The cached device solve for this area, or None when the node is
        not present in this area's graph (multi-area: host fallback)."""
        if not link_state.has_node(node) and not link_state.links_from_node(
            node
        ):
            return None
        key = (link_state.area, node)
        cached = self._solves.get(key)
        if cached is not None and cached[0] == id(link_state):
            solve = cached[1]
            before = solve.device_solves
            solve.refresh()
            self.device_solves += solve.device_solves - before
            self._sync_spf_counters(solve, before)
            return solve
        solve = _AreaSolve(link_state, node, self.device)
        self.device_solves += solve.device_solves
        self._sync_spf_counters(solve, 0)
        self._solves[key] = (id(link_state), solve)
        return solve

    def _sync_spf_counters(self, solve: _AreaSolve, solves0: int) -> None:
        """Fold an _AreaSolve's stats into the decision.spf.* counters and
        histograms: full solves and transfer bytes are monotonic, rounds is
        a gauge of the most recent solve."""
        counters = self._ensure_counters()
        d_full = solve.device_solves - solves0
        if d_full:
            self._bump("decision.spf.full_solves", d_full)
            self.solve_ms_last = solve.solve_ms_last
            self._observe("decision.spf.solve_ms", solve.solve_ms_last)
            self._observe("decision.spf.solve_cold_ms", solve.solve_ms_last)
        if solve.rounds_last is not None:
            counters["decision.spf.rounds_last"] = solve.rounds_last
        d_h2d = solve.h2d_bytes - solve._h2d_synced
        if d_h2d:
            solve._h2d_synced = solve.h2d_bytes
            self._bump("decision.spf.host_to_device_bytes", d_h2d)
        d_d2h = solve.d2h_bytes - solve._d2h_synced
        if d_d2h:
            solve._d2h_synced = solve.d2h_bytes
            self._bump("decision.spf.device_to_host_bytes", d_d2h)

    # -- SPF access seam -------------------------------------------------

    def _spf(self, link_state: LinkState, node: str):
        solve = self._area_solve(link_state, self.my_node_name)
        if solve is not None and node in solve.row_map:
            return _CudaSpfResult(solve, node)
        self.host_spf_calls += 1
        return link_state.get_spf_result(node)

    def _dist(self, link_state: LinkState, a: str, b: str) -> Optional[Metric]:
        if a == b:
            return 0
        solve = self._area_solve(link_state, self.my_node_name)
        if solve is not None:
            row = solve.row_map.get(a)
            col = solve.graph.node_index.get(b)
            if row is not None and col is not None:
                metric = int(solve.d[row, col])
                return metric if metric < INF else None
        self.host_spf_calls += 1
        return link_state.get_metric_from_a_to_b(a, b)

    def _kth_paths(
        self, link_state: LinkState, src: str, dest: str, k: int
    ) -> List[Path]:
        raise NotImplementedError(_KSP_TODO)

    def _prefetch_kth_paths(
        self, link_state: LinkState, src: str, dests: List[str], k: int
    ) -> None:
        raise NotImplementedError(_KSP_TODO)
