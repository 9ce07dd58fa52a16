"""`chip_smoke.py`'s main path on the Clos, timed: do the fault seams cost?

The solver's fault seams (`fault_point("solver.tpu.solve")` at the top of
every area solve, `solver.tpu.warm_d` after it, the ops.spf seams) cost a
global None check with no injector installed, and a dict lookup with one
installed and nothing armed. This script times what main_path times with
them: `CudaSpfSolver("rsw0_0")` route dbs on the 9,556-node Clos
(`fabric_edges(170)`, one prefix a node), a cold build and then the warm
build after main_path's event (fsw0_1<->ssw1_0 overloaded, fsw0_2<->rsw0_5
at metric 3); `route_build_ms` on the host clock around build_route_db,
`solve_ms` the solver's `solve_ms_last`. Each of 4 repetitions builds a
fresh LinkState and solver; the first one (its first launches) is
reported apart, the medians are over the other 3.

With `--installed`, an injector with nothing armed is installed for the
run (on a tree that has `openr_tpu_torch.testing.faults`).

Run it from the root of a checkout, whose `openr_tpu_torch` it imports, so
that two trees can be timed with one script:

    python3 tools/main_path_times.py [--installed]
    cd _parent && python3 ../tools/main_path_times.py

It prints the card's name and power limit, then one JSON object. It needs
a card and exits 1 without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

CLOS_PODS = 170
ME = "rsw0_0"
REPS = 4
EVENT = (
    ("fsw0_1", "ssw1_0", {"is_overloaded": True}),
    ("ssw1_0", "fsw0_1", {"is_overloaded": True}),
    ("fsw0_2", "rsw0_5", {"metric": 3}),
    ("rsw0_5", "fsw0_2", {"metric": 3}),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--installed", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("main_path_times: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from openr_tpu_torch.lsdb import LinkState, PrefixState
    from openr_tpu_torch.ops import _cuda
    from openr_tpu_torch.solver import CudaSpfSolver
    from openr_tpu_torch.topology import build_adj_dbs, fabric_edges
    from openr_tpu_torch.types import IpPrefix, PrefixDatabase, PrefixEntry

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _cuda.build()
    if args.installed:
        from openr_tpu_torch.testing import faults

        faults.install(faults.FaultInjector())

    dbs = build_adj_dbs(fabric_edges(pods=CLOS_PODS))
    ps = PrefixState()
    for i, name in enumerate(sorted(dbs)):
        ps.update_prefix_database(PrefixDatabase(
            name, [PrefixEntry(IpPrefix(f"10.{i // 256}.{i % 256}.0/24"))],
            area="0"))
    dev = torch.device("cuda")
    runs = []
    for _ in range(REPS):
        ls = LinkState("0")
        for db in dbs.values():
            ls.update_adjacency_database(db)
        solver = CudaSpfSolver(ME, device=dev)
        row = {}
        for phase in ("cold", "warm"):
            if phase == "warm":
                for node, other, changes in EVENT:
                    db = ls.get_adjacency_databases()[node]
                    ls.update_adjacency_database(dataclasses.replace(
                        db, adjacencies=[
                            dataclasses.replace(a, **changes)
                            if a.other_node_name == other else a
                            for a in db.adjacencies]))
            torch.cuda.synchronize()
            t = time.perf_counter()
            solver.build_route_db(ME, {"0": ls}, ps)
            torch.cuda.synchronize()
            row[f"{phase}_route_build_ms"] = (time.perf_counter() - t) * 1e3
            row[f"{phase}_solve_ms"] = solver.solve_ms_last
        runs.append(row)
    out = {"tree": os.getcwd(), "installed": args.installed,
           "graph": f"fabric_edges({CLOS_PODS})", "me": ME,
           "first": runs[0], "reps": runs[1:]}
    for key in runs[0]:
        out[f"median_{key}"] = statistics.median(r[key] for r in runs[1:])
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
