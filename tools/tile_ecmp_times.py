"""K21's four entries and K3 on the card: spans, device and host times.

The shapes are `chip_smoke.py`'s: K21 on rank 1's tile of the tiled
north-star WAN (`wan_edges(100000, 4, 3)`, 128 sources, a (1, 4) mesh of
ranks sharing the card; S_l 128 x n_tile 32,768), after the cold tiled
solve and the warm solve of `chip_smoke.wan_event`'s 48-edge event, the
mark on two frontiers (`k21`: one round from the fixpoint, where most
entries match dp; `k21_first_round`: the cold first round's, as
`chip_smoke.py` times it, where few do); K3 on
the all-pairs DAG of `grid_edges(32)` and of `wan_edges(4096, 4, 7)` (the
apsp_wan graph, its matrix from K1's solve of every source). Each kernel is
first held equal to its plain version. The timings are `chip_smoke.py`'s
own (`tile_mark_times`, `ecmp_times`, which this script loads from the
`chip_smoke.py` beside its `tools/` directory): the span of one call
between CUDA events, the device time of 20 calls replayed in a CUDA graph,
the host time of 50 calls enqueued back to back.

Run it from the root of a checkout, whose `openr_tpu_torch` it imports, so
that two trees can be timed with one script:

    python3 tools/tile_ecmp_times.py              # this checkout
    cd _parent && python3 ../tools/tile_ecmp_times.py

It prints the card's name and power limit, then one JSON object. It needs
a card and exits 1 without one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "..", "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(cs=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("tile_ecmp_times: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import numpy as np

    from openr_tpu_torch import convert
    from openr_tpu_torch.convert import to_device
    from openr_tpu_torch.ops import _cuda
    from openr_tpu_torch.ops import spf
    from openr_tpu_torch.ops.graph import INF, compile_edges
    from openr_tpu_torch.parallel import make_mesh, tile_graph
    from openr_tpu_torch.topology import grid_edges, wan_edges

    cs = cs or load_chip_smoke()
    dev = torch.device(cs.DEVICE)
    card = cs.smi_line()
    rate = cs.hbm_rate(card)
    t0 = time.perf_counter()
    _cuda.build()
    out = {"tree": os.getcwd(), "card": card,
           "build_seconds": time.perf_counter() - t0}

    # K21: rank 1's tile of the tiled WAN, as chip_smoke's tile_wan takes it
    wan = compile_edges(wan_edges(cs.WAN_N, degree=4, seed=3))
    rng = np.random.default_rng(7)
    wan_src = rng.choice(wan.n, size=128, replace=False).astype(np.int32)
    g = cs.TILE_G
    tmesh = make_mesh([dev] * g, (1, g))
    tiling = tile_graph(wan, g)
    tkey = tiling.shape_key() + (wan.n_pad,)
    n_tile, h = tiling.n_tile, tiling.h
    tops = convert.tiling_ranks(tiling, tmesh)
    tsrc = convert.rank_sources(tmesh, wan_src)
    tov = convert.rank_replicas(tmesh, wan.overloaded, bool)
    d_t, _, _ = spf._tile_solver(tkey, tmesh, tsrc, tops["src_l"],
                                 tops["hseg"], tops["hptr"], tops["w2"],
                                 tops["hcols"], tov)
    w_new = cs.wan_event(wan, d_t.gather(dev), torch, np, INF)[0]
    w2n = convert.rank_rows(tmesh, tiling.tile_weights(w_new), np.int32)
    d_tw = spf._tile_solver_warm(
        tkey, tmesh, tsrc, tops["src_l"], tops["hseg"], tops["hptr"], w2n,
        tops["w2"], tops["hcols"], tov, tov, d_t)[0]
    j = 1
    off = j * n_tile
    dpt, dwt = d_t.blocks[0][j], d_tw.blocks[0][j]
    marks = (dpt % 3) == 0

    def frontier(tile):
        """The halo of one K19 round from `tile`, folded into an INF tile:
        a mark round's recv."""
        ctr = spf.tile_round(tile, tsrc[0][j], tov[0][j], off,
                             tops["src_l"][0][j], tops["hseg"][0][j],
                             tops["hptr"][0][j], tops["w2"][0][j], h)
        return spf.tile_fold(torch.full_like(dpt, INF), ctr,
                             tops["hcols"][0][j], j)

    # the mark on two frontiers: the fixpoint's, where most entries match
    # dp, and the cold first round's (chip_smoke's tile_wan), where few do
    recvs = {"k21": frontier(dpt),
             "k21_first_round": frontier(spf.tile_init(tsrc[0][j], off,
                                                       n_tile))}
    recv = recvs["k21"]
    for m in (None, marks):
        flags = [torch.zeros(1, dtype=torch.int32, device=dev)
                 for _ in "kp"]
        got = spf.tile_mark(m, recv.clone(), dpt, flags[0])
        want = spf._tile_mark_plain(m, recv.clone(), dpt, flags[1])
        cs.check(torch.equal(got, want) and torch.equal(*flags),
                 "K21 tile_mark differs from its plain version")
    cs.check(torch.equal(spf.tile_init(tsrc[0][j], off, n_tile),
                         spf._tile_init_plain(tsrc[0][j], off, n_tile))
             and torch.equal(spf.tile_reset(marks, dpt, tsrc[0][j], off),
                             spf._tile_reset_plain(marks, dpt, tsrc[0][j],
                                                   off)),
             "K21 tile_init or tile_reset differs from its plain version")
    cols = []
    for fn in (spf.tile_col_changed, spf._tile_col_changed_plain):
        cc = torch.zeros(n_tile, dtype=torch.bool, device=dev)
        cnt = torch.zeros(1, dtype=torch.int32, device=dev)
        fn(dwt, dpt, cc, cnt)
        cols.append((cc, cnt))
    cs.check(torch.equal(cols[0][0], cols[1][0])
             and torch.equal(cols[0][1], cols[1][1]),
             "K21 tile_col_changed differs from its plain version")
    for label, rv in recvs.items():
        hit = (rv == dpt) & (dpt < INF)
        k21 = cs.tile_mark_times(spf, _cuda.TILE_MARK, tsrc[0][j], off,
                                 marks, rv, dpt, dwt)
        for name, nbytes in cs.tile_mark_bytes(dwt, dpt).items():
            k21[name]["bound_ms"] = nbytes / rate * 1e3
        out[label] = {"s_l": dpt.shape[0], "n_tile": n_tile,
                      "changed_columns": int(cols[1][1]),
                      "mark_hits": int(hit.sum()),
                      "mark_new": int((hit & ~marks).sum()), **k21}
        for key in ("ms", "graph_ms", "host_ms", "bound_ms"):
            vals = [v[key] for v in k21.values()]
            if all(isinstance(v, float) for v in vals):
                out[label][f"sum_{key}"] = sum(vals)
    del d_t, d_tw, dpt, dwt, recv, recvs, marks, tops, w2n

    # K3 on the all-pairs DAGs of the grid and of the apsp_wan graph
    for label, edges in (("grid_32", grid_edges(cs.GRID_SIDE)),
                         ("dag_4096", wan_edges(cs.APSP_N, degree=4,
                                                seed=7))):
        gr = compile_edges(edges)
        d = spf.batched_spf(gr, np.arange(gr.n_pad, dtype=np.int32),
                            device=dev).contiguous()
        st = to_device(gr, dev)
        t3 = cs.ecmp_times(spf, _cuda.ECMP_TRIANGLE, d, st["src"],
                           st["dst"], st["dst"], st["w"], st["ov"])
        nbytes, ops, gathers = cs.ecmp_bytes(gr.n_pad, gr.e_pad, gr.n_pad)
        out["k3_" + label] = {
            "edges": gr.e_pad, "columns": gr.n_pad, **t3,
            "bound_ms": cs.bound(nbytes, ops, rate)[0],
            "bound_gathers_ms": gathers / rate * 1e3,
        }
        del d, st
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
