"""K12, the all-pairs warm seed, on the card: span, device and host times.

The input is `chip_smoke.py`'s apsp_wan seed: bench.py's APSP graph
`wan_edges(4096, 4, 7)` (n_pad 4,096, 32 block rows of 128), d_prev the
closed matrix after the `raise_one` event, w_new the weights after
`raise_40`, its raised pairs in slots bucketed as `ApspState` buckets
them (`chip_smoke.apsp_events`, `increase_slots`). The seed is first held
equal to its plain version. The timings are `chip_smoke.py`'s own
(`seed_times`, which this script loads from the `chip_smoke.py` beside its
`tools/` directory): the span of one call between CUDA events (21 calls),
the device time of 20 calls replayed in a CUDA graph, the host time of 50
calls enqueued back to back, and the device time of each entry point under
the profiler; beside them the data's work (`chip_smoke.seed_work`:
rows_scanned) and both terms of the bound, and the registers and spills
that `nvcc -Xptxas -v` reports for the tree's `fw_seed.cu`.

Run it from the root of a checkout, whose `openr_tpu_torch` it imports, so
that two trees can be timed with one script:

    python3 tools/fw_seed_times.py                  # this checkout
    cd _parent && python3 ../tools/fw_seed_times.py

It prints the card's name and power limit, then one JSON object. It needs
a card and exits 1 without one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "..", "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_report(kernel) -> dict:
    """Registers, spill stores and loads, and shared memory of each kernel
    function of `kernel`'s source, from `nvcc -Xptxas -v`."""
    from openr_tpu_torch.ops import _cuda

    out = _cuda._BUILD / "ptxas.tmp.so"
    cmd = kernel.compile_command(out) + ["-Xptxas", "-v"]
    log = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    out.unlink(missing_ok=True)
    report, fn = {}, None
    for line in log.stderr.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            report[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            report[fn]["spill_stores"] = int(m.group(1))
            report[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            report[fn]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            report[fn]["static_smem"] = int(smem.group(1)) if smem else 0
    return report if report else {"not_measured": log.stderr[-2000:]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fw_seed_times: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())

    from openr_tpu_torch.apsp import kernels as fw
    from openr_tpu_torch.lsdb import LinkState
    from openr_tpu_torch.ops import _cuda
    from openr_tpu_torch.ops.graph import compile_edges, compile_graph
    from openr_tpu_torch.topology import build_adj_dbs, wan_edges

    cs = load_chip_smoke()
    dev = torch.device(cs.DEVICE)
    card = cs.smi_line()
    rate = cs.hbm_rate(card)
    t0 = time.perf_counter()
    _cuda.build([_cuda.FW_CLOSE, _cuda.FW_SEED])
    out = {"tree": os.getcwd(), "card": card,
           "build_seconds": time.perf_counter() - t0,
           "entries": list(_cuda.FW_SEED.entries)}

    # the seed of apsp_wan's raise_40 event, as chip_smoke.py makes it
    edges = wan_edges(cs.APSP_N, degree=4, seed=7)
    ls = cs.build_ls(edges, LinkState, build_adj_dbs)

    def dense():
        g = compile_graph(ls)
        return (torch.as_tensor(fw.build_weight_matrix(g), device=dev),
                torch.as_tensor(fw.build_allow_matrix(g.overloaded),
                                device=dev))

    w0, a0 = dense()
    events = cs.apsp_events(edges, compile_edges(edges),
                            fw.fw_close(w0, a0)[0])
    for a, b, changes in events[0][1]:
        cs.edit_adjacency([ls], a, b, **changes)
    w1, a1 = dense()
    d_prev = fw.fw_close(w1, a1)[0]
    for a, b, changes in events[1][1]:
        cs.edit_adjacency([ls], a, b, **changes)
    w2, _ = dense()
    slots = cs.increase_slots(w1, w2)
    nb, bsz = fw.fw_block_shape(w2.shape[0])
    seed_args = (d_prev, w2, *slots, nb, bsz)
    want = fw._fw_seed_plain(*seed_args)
    got = fw.fw_seed(*seed_args)
    cs.check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
             and int(got[2]) == int(want[2]),
             "K12 differs from its plain version")
    work = cs.seed_work(d_prev, *slots)
    out.update({
        "n_pad": int(w2.shape[0]), "slots": int(slots[0].numel()),
        "valid": int((slots[0] < w2.shape[0]).sum()),
        "dirty_blocks": int(want[2]), "rows_scanned": work["rows_scanned"],
        "bound_bytes_ms": work["bytes"] / rate * 1e3,
        "bound_ops_ms": work["ops"] / cs._INT32_OPS_PER_S * 1e3,
        "k12": cs.seed_times(fw, _cuda.FW_SEED, seed_args),
        "ptxas": ptxas_report(_cuda.FW_SEED),
    })
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
