"""Where the host time of two once-a-step TE entries goes, on the card.

The entries are K17's scale (`te.kernels.soft_flow_bwd_scale`) and K18's
Adam step (`te.kernels.te_adam`), at te_clos's width in `chip_smoke.py`
(4 scenarios, 63,840 edges; seeded random inputs). Each piece of a
wrapper's host path is called back to back on the host clock
(`time.perf_counter_ns`), 100 calls a batch with the card synchronised
between batches outside the clock, and the median over 21 batches is
printed in microseconds. The pieces are the whole wrapper, its checks,
its output's allocation, the Adam constants (per step with `adam_hparams`,
or packed once a solve with `adam_schedule`), `Kernel.launch` with the
wrapper's arguments, the bare ctypes call, and the card and stream lookups
inside `Kernel.launch`.

Run it from the root of a checkout, whose `openr_tpu_torch` it imports:

    python3 tools/te_tail_host.py

It prints the card's name and power limit, then one JSON object. It needs
a card and exits 1 without one.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def per_call_us(fn, calls: int = 100, batches: int = 21) -> float:
    import torch

    fn()
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter_ns() - t0) / calls / 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("te_tail_host: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from openr_tpu_torch.ops import _cuda
    from openr_tpu_torch.ops.spf import _check
    from openr_tpu_torch.te import kernels as tk
    from openr_tpu_torch.te.optimizer import TeOptConfig

    b, e = 4, 63840
    gen = torch.Generator("cuda").manual_seed(0)
    g_util = torch.randn((b, e), device="cuda", generator=gen)
    caps = torch.rand(e, device="cuda", generator=gen) + 0.5
    w = torch.rand(e, device="cuda", generator=gen) * 60 + 1
    m = torch.randn(e, device="cuda", generator=gen) * 1e-2
    v = torch.rand(e, device="cuda", generator=gen) * 1e-4
    g = torch.randn(e, device="cuda", generator=gen)
    up = torch.rand(e, device="cuda", generator=gen) > 0.1
    dev = g.device  # the wrappers compare with a tensor's own device
    w_hist = torch.empty((8, e), device="cuda")
    row = w_hist[3]
    cfg = TeOptConfig()
    hp = tk.adam_hparams(cfg, 3)
    f32 = torch.float32
    c = torch.empty_like(g_util)
    k17, k18 = _cuda.SOFT_FLOW_BWD, _cuda.TE_STEP
    scale_fn = k17._bind()["soft_flow_bwd_scale"]
    adam_fn = k18._bind()["te_adam"]
    scale_args = (g_util.data_ptr(), caps.data_ptr(), c.data_ptr(), e, b)
    # step 3's constants as adam_solve makes them, packed once a solve
    step = tk.adam_schedule(cfg, 8)[3]
    adam_args = (w.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                 up.data_ptr(), row.data_ptr(), e, step.packed)
    raw = torch._C._cuda_getCurrentRawStream

    def adam_checks():
        for name, t in (("w", w), ("m", m), ("v", v), ("g", g),
                        ("w_row", row)):
            tk._check_edges(name, t, e, f32, dev)
        tk._check_edges("up", up, e, torch.bool, dev)

    pieces = {
        "scale.wrapper": lambda: tk.soft_flow_bwd_scale(g_util, caps),
        "scale.check_g_util": lambda: _check("g_util", g_util, f32, 2, dev),
        "scale.check_caps": lambda: tk._check_edges("caps", caps, e, f32,
                                                    dev),
        "scale.empty_like": lambda: torch.empty_like(g_util),
        "scale.launch": lambda: k17.launch(dev, *scale_args,
                                           entry="soft_flow_bwd_scale"),
        "scale.ctypes": lambda: scale_fn(*scale_args, raw(0)),
        "adam.wrapper": lambda: tk.te_adam(w, m, v, g, up, row, hp),
        "adam.wrapper_schedule": lambda: tk.te_adam(w, m, v, g, up, row,
                                                    step),
        "adam.checks_6": adam_checks,
        "adam.check_1": lambda: tk._check_edges("g", g, e, f32, dev),
        "adam.hparams": lambda: tk.adam_hparams(cfg, 3),
        "adam.pack": lambda: _cuda.AdamConsts(*hp),
        "adam.launch": lambda: k18.launch(dev, *adam_args, entry="te_adam"),
        "adam.ctypes": lambda: adam_fn(*adam_args, raw(0)),
        "adam.row_select": lambda: w_hist[3],
        "launch.current_device": torch.cuda.current_device,
        "launch.raw_stream": lambda: raw(0),
        "tensor.data_ptr": g.data_ptr,
        "tensor.device": lambda: g.device,
        "launch.get_device": torch._C._cuda_getDevice,
        "scale.empty": lambda: torch.empty((b, e), device=dev),
        "torch.div": lambda: torch.div(g_util, caps),
    }
    out = {name: per_call_us(fn) for name, fn in pieces.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"probe": "te_tail_host", "unit": "us a call",
                      "b": b, "e": e, "adam_ctypes_args":
                      len(k18.entries["te_adam"]), "pieces": out,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
