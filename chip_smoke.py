#!/usr/bin/env python3
"""Build and run the openr_tpu_torch port on one CUDA card, and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases, one JSON line each:

  environment  the card's name and power limit (nvidia-smi) and versions
  build        nvcc builds every kernel of ops/csrc/ for sm_90a, in parallel
  main_path    the port's entry points at full width, with every kernel's
               launch count set to 0 just before and read just after:
                 batched_spf      100k-node WAN, 128 sources        (K1)
                 batched_spf_vw   the same solve, edge-list form    (K2)
                 batched_spf +    all-pairs on a 32x32 grid         (K1)
                 ecmp_dag         its first-hop DAG                 (K3)
                 CudaSpfSolver    route dbs on the 9,556-node Clos,
                                  before and after a flap + metric
                                  change (K1, K3), and on a star too
                                  wide for the sliced layout (K2, K3)
               route dbs must equal the port's CPU oracle, and no SPF may
               be answered by host Dijkstra
  k1 / k2 / k3 each kernel against its plain PyTorch version on the card at
               the main path's shapes (exact equality: min-plus on int32
               does not depend on order), with times
  kernels      one line for all kernels: launches, error, ms, bounds

The card's name and power limit print on their own line before the last,
and the last line is {"ok": true, "device": {...}}. Any failed check raises,
and the script then exits non-zero without that line. It imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# HBM rates from NVIDIA's data sheets; the SXM part is the default
_HBM_BYTES_PER_S = (
    ("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
)
_HBM_DEFAULT = 3.35e12
# int32 add/min outside the tensor cores: 64 lanes/SM/clock x 132 SMs x
# 1.98 GHz boost (the data sheet's 67 TFLOP/s fp32 counts an FMA as two)
_INT32_OPS_PER_S = 64 * 132 * 1.98e9

# the main path's sizes: the north-star WAN, the grid of the ECMP bench and
# the Clos of the 9,556-node fabric configuration
DEVICE = "cuda"
WAN_N = 100000
GRID_SIDE = 32
CLOS_PODS = 170
CLOS_NODES = 9556
STAR_LEAVES = 1100  # hub in-degree past the sliced layout's cap


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    for key, rate in _HBM_BYTES_PER_S:
        if key in name:
            return rate
    return _HBM_DEFAULT


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median of `reps` timed calls, CUDA events around each."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a, b) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def bound(bytes_: float, ops: float, rate: float):
    t_bytes = bytes_ / rate * 1e3
    t_ops = ops / _INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- topology events --------------------------------------------------------


def build_ls(edges, ls_cls, build_adj_dbs):
    ls = ls_cls("0")
    for db in build_adj_dbs(edges).values():
        ls.update_adjacency_database(db)
    return ls


def edit_adjacency(link_states, node: str, other: str, **changes) -> None:
    """Re-advertise `node`'s adjacency database with its adjacency toward
    `other` changed (is_overloaded=True takes the link down)."""
    for ls in link_states:
        db = ls.get_adjacency_databases()[node]
        adjs = [
            dataclasses.replace(a, **changes)
            if a.other_node_name == other else a
            for a in db.adjacencies
        ]
        ls.update_adjacency_database(
            dataclasses.replace(db, adjacencies=adjs)
        )


def one_prefix_per_node(names, ps_cls, PrefixDatabase, PrefixEntry, IpPrefix):
    ps = ps_cls()
    for i, name in enumerate(names):
        pfx = IpPrefix(f"10.{i // 256}.{i % 256}.0/24")
        ps.update_prefix_database(
            PrefixDatabase(name, [PrefixEntry(pfx)], area="0")
        )
    return ps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "openr_tpu_torch")):
        print("chip_smoke: openr_tpu_torch/ not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)

    import numpy as np

    from openr_tpu_torch.convert import to_device
    from openr_tpu_torch.lsdb import LinkState, PrefixState
    from openr_tpu_torch.ops import _cuda
    from openr_tpu_torch.ops import spf
    from openr_tpu_torch.ops.graph import INF, compile_edges
    from openr_tpu_torch.solver import CudaSpfSolver, SpfSolver
    from openr_tpu_torch.topology import (
        build_adj_dbs, fabric_edges, grid_edges, wan_edges,
    )
    from openr_tpu_torch.types import IpPrefix, PrefixDatabase, PrefixEntry

    dev = torch.device(DEVICE)
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    rate = hbm_rate(card)

    # -- 1. environment --------------------------------------------------
    emit({
        "phase": "environment", "card": card, "kind": kind,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "hbm_bytes_per_s": rate,
    })

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    libs = _cuda.build()
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "libraries": {
            k: os.path.relpath(str(v), HERE) for k, v in libs.items()
        },
        "card": card,
    })

    # -- inputs ----------------------------------------------------------
    t0 = time.perf_counter()
    wan = compile_edges(wan_edges(WAN_N, degree=4, seed=3))
    check(wan.sell is not None, "WAN must qualify for the sliced layout")
    check(wan.n == WAN_N, f"WAN n {wan.n}")
    rng = np.random.default_rng(7)
    wan_src = rng.choice(wan.n, size=128, replace=False).astype(np.int32)
    grid_side = GRID_SIDE
    grid = compile_edges(grid_edges(grid_side))
    grid_rows = np.arange(grid.n_pad, dtype=np.int32)
    clos_edges = fabric_edges(pods=CLOS_PODS)
    clos_ls = [build_ls(clos_edges, LinkState, build_adj_dbs) for _ in "ab"]
    check(clos_ls[0].num_nodes() == CLOS_NODES, "Clos node count")
    clos_ps = one_prefix_per_node(
        sorted(clos_ls[0].node_names()), PrefixState,
        PrefixDatabase, PrefixEntry, IpPrefix,
    )
    star_edges = [
        ("hub", f"leaf{i:04d}", 1 + i % 7) for i in range(STAR_LEAVES)
    ]
    star_ls = [build_ls(star_edges, LinkState, build_adj_dbs) for _ in "ab"]
    star_ps = one_prefix_per_node(
        sorted(star_ls[0].node_names()), PrefixState,
        PrefixDatabase, PrefixEntry, IpPrefix,
    )
    emit({
        "phase": "inputs", "seconds": time.perf_counter() - t0,
        "wan": {"n": wan.n, "e": wan.e, "n_pad": wan.n_pad,
                "e_pad": wan.e_pad,
                "buckets": [list(a.shape) for a in wan.sell.nbr]},
        "grid": {"n": grid.n, "e": grid.e},
        "clos_nodes": clos_ls[0].num_nodes(),
    })

    # -- 3. main path ----------------------------------------------------
    route_ms, solve_ms = [], []

    def route_build(solver, oracle, link_states, ps, me):
        t = time.perf_counter()
        got = solver.build_route_db(me, {"0": link_states[1]}, ps)
        route_ms.append((time.perf_counter() - t) * 1e3)
        solve_ms.append(solver.solve_ms_last)
        want = oracle.build_route_db(me, {"0": link_states[0]}, ps)
        check(got is not None and want is not None, f"{me}: no route db")
        check(got.unicast_entries == want.unicast_entries,
              f"{me}: unicast routes differ from the CPU oracle")
        check(got.mpls_entries == want.mpls_entries,
              f"{me}: MPLS routes differ from the CPU oracle")
        return len(got.unicast_entries)

    for k in _cuda.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    d_wan = spf.batched_spf(wan, wan_src, device=dev)
    d_wan_vw = spf.batched_spf_vw(wan, wan_src, wan.w[None, :], device=dev)
    d_all = spf.batched_spf(grid, grid_rows, device=dev)
    dag = spf.ecmp_dag(grid, d_all, device=dev)
    solvers = {}
    n_routes = {}
    for me in ("rsw0_0", "fsw1_1"):
        solvers[me] = CudaSpfSolver(me, device=dev)
        n_routes[me] = route_build(
            solvers[me], SpfSolver(me), clos_ls, clos_ps, me
        )
    # a spine link down and a rack metric change: weight patches, then a
    # cold re-solve through refresh
    edit_adjacency(clos_ls, "fsw0_1", "ssw1_0", is_overloaded=True)
    edit_adjacency(clos_ls, "ssw1_0", "fsw0_1", is_overloaded=True)
    edit_adjacency(clos_ls, "fsw0_2", "rsw0_5", metric=3)
    edit_adjacency(clos_ls, "rsw0_5", "fsw0_2", metric=3)
    for me in ("rsw0_0", "fsw1_1"):
        route_build(solvers[me], SpfSolver(me), clos_ls, clos_ps, me)
    star = CudaSpfSolver("leaf0000", device=dev)
    route_build(star, SpfSolver("leaf0000"), star_ls, star_ps, "leaf0000")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _cuda.KERNELS}
    host_calls = sum(s.host_spf_calls for s in (*solvers.values(), star))
    full_solves = sum(s.device_solves for s in (*solvers.values(), star))
    emit({
        "phase": "main_path", "seconds": main_s, "launches": launches,
        "host_spf_calls": host_calls, "device_solves": full_solves,
        "route_build_ms": route_ms, "device_solve_ms": solve_ms,
        "routes": n_routes,
        "clos_rounds": {
            me: s.counters.get("decision.spf.rounds_last")
            for me, s in solvers.items()
        },
        "card": card,
    })
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    check(host_calls == 0, f"{host_calls} SPF answers came from host Dijkstra")
    check(full_solves == 5, f"expected 5 device solves, got {full_solves}")

    results = []

    # -- 4. K1 on the north-star solve -----------------------------------
    st = to_device(wan, dev)
    src_t = torch.as_tensor(wan_src, device=dev)
    key = wan.sell.shape_key()

    def k1():
        return spf._sell_solver_counted(
            key, src_t, st["nbrs"], st["wgs"], st["ov"]
        )

    def k1_plain():
        d0 = spf._sell_d0(src_t, wan.n_pad)
        d, r = spf._sell_relax_plain(
            d0, src_t, st["ov"], st["nbrs"], st["wgs"], wan.sell.starts
        )
        return d.t().contiguous(), r

    d_k1, rounds = k1()
    d_plain, rounds_plain = k1_plain()
    err = max_abs_err(d_k1, d_plain)
    check(err == 0 and rounds == rounds_plain,
          f"K1 differs from its plain version: err {err}, rounds "
          f"{rounds} vs {rounds_plain}")
    check(torch.equal(d_k1, d_wan), "K1 differs from the main path's D")
    t0 = time.perf_counter()
    wan_ls = build_ls(wan_edges(WAN_N, degree=4, seed=3), LinkState,
                      build_adj_dbs)
    d_host = d_k1.cpu().numpy()
    for i in (0, 64, 127):
        res = wan_ls.get_spf_result(wan.names[wan_src[i]])
        want = np.full(wan.n_pad, INF, dtype=np.int64)
        for name, node in res.items():
            want[wan.node_index[name]] = node.metric
        check(np.array_equal(d_host[i].astype(np.int64), want),
              f"K1 row {i} differs from LinkState Dijkstra")
    oracle_s = time.perf_counter() - t0
    del wan_ls
    ms = time_ms(k1)
    plain_ms = time_ms(k1_plain, reps=5, warmup=1)
    s_cols = len(wan_src)
    slots = sum(a.shape[0] * a.shape[1] for a in wan.sell.nbr)
    rows_k = sum(a.shape[0] for a in wan.sell.nbr)
    gather_bytes = 4 * s_cols * (slots + 2 * rows_k) + 8 * slots
    # each input once, each output once, per round
    round_bytes = 4 * s_cols * (wan.n + rows_k) + 8 * slots + wan.n_pad
    round_ops = 3 * slots * s_cols
    b_ms, b_by = bound(rounds * round_bytes, rounds * round_ops, rate)
    emit({
        "phase": "k1_sell_relax", "graph": f"wan_edges({WAN_N}, 4, 3)",
        "sources": s_cols, "rounds": rounds, "equal_plain": True,
        "oracle_rows_checked": 3, "oracle_seconds": oracle_s,
        "ms": ms, "plain_ms": plain_ms, "spf_per_s": s_cols / (ms / 1e3),
        "bytes_per_round_gathers": gather_bytes,
        "bytes_per_round_once": round_bytes,
        "bound_ms": b_ms,
        "bound_gathers_ms": rounds * gather_bytes / rate * 1e3,
        "card": card,
    })
    results.append({
        "name": _cuda.SELL_RELAX.name, "route": "cuda",
        "source": "openr_tpu_torch/ops/csrc/sell_relax.cu",
        "replaces": _cuda.SELL_RELAX.replaces,
        "launches": launches[_cuda.SELL_RELAX.name], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "rounds": rounds,
    })
    del d_plain

    # -- 5. K2 on the same graph -----------------------------------------
    w_row = st["w"][None, :]

    def k2():
        return spf._bf_relax(
            spf._bf_d0(src_t, wan.n_pad), src_t, st["ov"], st["src"],
            st["dst"], w_row, st["csr"],
        )

    def k2_plain():
        return spf._bf_relax_plain(
            spf._bf_d0(src_t, wan.n_pad), src_t, st["ov"], st["src"],
            st["dst"], w_row, st["csr"],
        )

    d_k2, rounds2 = k2()
    d_k2_plain, rounds2_plain = k2_plain()
    err2 = max_abs_err(d_k2, d_k2_plain)
    check(err2 == 0 and rounds2 == rounds2_plain,
          f"K2 differs from its plain version: err {err2}")
    check(torch.equal(d_k2, d_k1), "K2 differs from K1's D")
    check(torch.equal(d_wan_vw, d_k1), "batched_spf_vw differs from K1's D")
    ms2 = time_ms(k2)
    plain_ms2 = time_ms(k2_plain, reps=5, warmup=1)
    # per round: D read and written once, src + w of the real edges, csr, ov
    round_bytes2 = 8 * s_cols * wan.n_pad + 8 * wan.e + 5 * wan.n_pad
    b2_ms, b2_by = bound(
        rounds2 * round_bytes2, rounds2 * 3 * wan.e * s_cols, rate
    )
    emit({
        "phase": "k2_bf_relax", "graph": f"wan_edges({WAN_N}, 4, 3)",
        "rounds": rounds2, "equal_plain": True, "equal_k1": True,
        "ms": ms2, "plain_ms": plain_ms2, "bound_ms": b2_ms, "card": card,
    })
    results.append({
        "name": _cuda.BF_RELAX.name, "route": "cuda",
        "source": "openr_tpu_torch/ops/csrc/bf_relax.cu",
        "replaces": _cuda.BF_RELAX.replaces,
        "launches": launches[_cuda.BF_RELAX.name], "max_abs_err": err2,
        "ms": ms2, "plain_ms": plain_ms2, "bound_ms": b2_ms,
        "bound_by": b2_by, "library_ms": None, "rounds": rounds2,
    })
    del d_k2, d_k2_plain, st

    # -- 6. K3 on the grid's all-pairs DAG -------------------------------
    gt = to_device(grid, dev)
    d_all_t = d_all.contiguous()

    def k3():
        return spf.ecmp_triangle(
            d_all_t, gt["src"], gt["dst"], gt["dst"], gt["w"], gt["ov"]
        )

    def k3_plain():
        return spf._ecmp_triangle_plain(
            d_all_t, gt["src"], gt["dst"], gt["dst"], gt["w"], gt["ov"]
        )

    dag_k3 = k3()
    err3 = max_abs_err(dag_k3, k3_plain())
    check(err3 == 0, f"K3 differs from its plain version: {err3} entries")
    check(torch.equal(dag_k3, dag), "K3 differs from the main path's DAG")
    a = grid.node_index["g0_0"]
    z = grid.node_index[f"g{grid_side - 1}_{grid_side - 1}"]
    corner = int(d_all[a, z])
    check(corner == 2 * (grid_side - 1), f"corner distance {corner}")
    from_a = torch.as_tensor(grid.src[: grid.e] == a, device=dev)
    first_hops = int(dag[: grid.e][from_a, z].sum())
    check(first_hops == 2, f"corner-to-corner ECMP first hops {first_hops}")
    ms3 = time_ms(k3, reps=9)
    plain_ms3 = time_ms(k3_plain, reps=9)
    e3, t3 = grid.e_pad, grid.n_pad
    b3_ms, b3_by = bound(
        4 * grid.n_pad * t3 + e3 * t3 + 12 * e3 + grid.n_pad,
        6 * e3 * t3, rate,
    )
    emit({
        "phase": "k3_ecmp_triangle", "graph": f"grid_edges({grid_side})",
        "edges": e3, "columns": t3, "equal_plain": True,
        "corner_distance": corner, "corner_first_hops": first_hops,
        "ms": ms3, "plain_ms": plain_ms3, "bound_ms": b3_ms, "card": card,
    })
    results.append({
        "name": _cuda.ECMP_TRIANGLE.name, "route": "cuda",
        "source": "openr_tpu_torch/ops/csrc/ecmp_triangle.cu",
        "replaces": _cuda.ECMP_TRIANGLE.replaces,
        "launches": launches[_cuda.ECMP_TRIANGLE.name], "max_abs_err": err3,
        "ms": ms3, "plain_ms": plain_ms3, "bound_ms": b3_ms,
        "bound_by": b3_by, "library_ms": None,
    })

    # -- 7. kernels line, card, result -----------------------------------
    emit({"kernels": results})
    print(card, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
