#!/usr/bin/env python3
"""Build and run the openr_tpu_torch port on one CUDA card, and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases, one JSON line each:

  environment  the card's name and power limit (nvidia-smi) and versions
  build        nvcc builds every kernel of ops/csrc/ for sm_90a, in parallel
  main_path    the port's entry points at full width:
                 batched_spf      100k-node WAN, 128 sources        (K1)
                 batched_spf_vw   the same solve, edge-list form    (K2)
                 batched_spf +    all-pairs on a 32x32 grid         (K1)
                 ecmp_dag         its first-hop DAG                 (K3)
                 CudaSpfSolver    route dbs on the 9,556-node Clos,
                                  cold, then warm after a flap +
                                  metric change (K1, K3, K4, K5,
                                  K7), and cold on a star too wide
                                  for the sliced layout (K2, K3)
               route dbs must equal the port's CPU oracle, and no SPF may
               be answered by host Dijkstra
  k1 / k2 / k3 each kernel against its plain PyTorch version on the card at
               the main path's shapes (exact equality: min-plus on int32
               does not depend on order), with times (K3's also in a CUDA
               graph and on the host clock); K1 also at the
               product's own batch widths on the 9,556-node Clos (rsw0_0's
               area solve: S = 16, and S = 8); K2 (dest-major rounds,
               equal to K1's D and rounds) also cold on the star at its
               solver's batch, the transposes in and out of K2's layout
               timed alone
  event_wan    one seeded 48-edge event on the 100k-node WAN's 128-source
               fixpoint: the sliced warm solve (K5, K4, K1, K7), its delta
               extraction (K7) and the edge-list warm solve (K6, K2, K7);
               D equals a cold K1 solve on the patched weights and the
               plain versions' results, rounds and inv_rounds included;
               the warm solve's time split into K5, K4, K1's warm rounds
               and K7's columns, the edge-list one's into K6 (d_prev into
               K2's layout, seed, rounds, reset), K2's warm rounds, D's
               transpose out and K7's columns; K6's marks and d0 equal K5's
  k4 .. k7     each event kernel against its plain version on that event;
               K4 beside index_put_ (its library call), with its launches
               a call (one for all buckets) and 10 calls under the
               profiler; K7 also per stage (columns, compaction, gather)
               and its launches a call, its columns equal to
               torch.nonzero_static's (the compaction's library call) on
               the same flags
  event_clos   DeltaRouteBuilder for rsw0_0 on the Clos through six remote
               events (delta path) and one at rsw0_0 (full path); every db
               equals the CPU oracle's, and a delta event copies back only
               its changed columns
  star_flap    a remote weight change on the star: the solver's edge-list
               warm path (K6, K2, K7)
  ksp_wan      KSP2 on the 50k-node WAN of BASELINE config 4
               (wan_edges(50000, 4, seed=5), me = w0): K8 build + K9 (cold)
               and K8 seed + K5 + K9 (warm from the base rows) against their
               plain versions and each other at the bench's batch (me, its
               neighbours, 15 rows of 8 masked edges); then 16 SR-MPLS KSP2
               prefixes through CudaSpfSolver, warm and cold, and again
               after a link on a first path goes down: route dbs equal the
               CPU oracle's
  k8 / k9      those kernels' times, bounds and plain times; K8's build
               (beside index_put_, its library call) and seed apart, and
               its launches a call (one each, for all buckets)
  ksp_star     KSP2 on the star with a ring through its leaves (edge-list
               layout): K6's per-row seed against its plain version, and
               route dbs warm (K6, K2) and cold (K2 per row); K2 with those
               per-row weights, cold, against its plain version, timed,
               with the weights' transpose into K2's form timed alone
  apsp_wan     the resident all-pairs matrix at the production cap, on
               bench.py's APSP graph wan_edges(4096, degree=4, seed=7)
               (n_pad 4,096, 32 blocks of 128): the
               cold close K11 against its plain version and against K1's
               solve of all 4,096 sources, without and with 16 overloaded
               nodes; then, counted, CudaSpfSolver("w0", apsp_max_nodes=
               4096, compute_lfa_paths=True) builds route dbs from 8 other
               nodes' perspectives (256 prefixes), each equal to the CPU
               oracle's with no host Dijkstra, and answers four events
               (one raised edge on a shortest path, about 40 raised pairs
               with links down and decreases, more than 64 raised pairs,
               an overload toggle), each matrix equal to a fresh cold close
               and to the plain versions' composition, with their round
               count; K3 on the all-pairs DAG of the closed matrix
               (16,384 edges by 4,096 columns) against its plain version,
               its span, device and host times beside its bounds; then
               K11-K13's times, bounds and plain times, K12's (one launch
               a seed) on the raise_40 seed also as device time (a CUDA
               graph of 20 seeds), host time and device time by entry
               point (profiler), beside the data's rows_scanned and both
               terms of its bound, K11's device time by entry point over
               one close (profiler)
               and the DPX add-and-min (VIADDMNMX) and shared-load counts
               of K11's and K13's built code (cuobjdump -sass)
  lfa_clos     DeltaRouteBuilder over CudaSpfSolver(compute_lfa_paths=True,
               apsp_max_nodes=4096) on the 3,956-node Clos through six
               remote events and one into me's column: delta builds occur
               under LFA, every db equals a full build and the CPU oracle's,
               and the me-column event builds in full
  te_clos      differentiable TE at full width on the same 3,956-node Clos
               (fabric_edges(70), 63,840 directed edges, metric 1), 4,096
               seeded rsw->rsw demands in 4 scenarios, 128 rounds: first,
               not counted, one launch each of K14 (softmin round), K15
               (its backward), K16 (gate, flow round, utilization), K17
               (scale, adjoint round, gate backward) and K18 (MLU, seed,
               Adam) against their plain versions on the card at a
               mid-anneal tau (0.5) from the D of 128 rounds, with times
               (K17's adjoint round timed alone, one launch with the
               scale given; each entry run once a step apart, with its
               bound, the gate and the utilization beside their plain
               versions, the MLU, its seed, K17's scale (also on a seed
               with a masked scenario's row of zeros) and the Adam step
               also replayed in a CUDA graph (device time) and timed on
               the host clock alone (host time), the MLU beside
               torch.logsumexp, its seed beside torch.softmax, K17's
               scale beside torch.div and the Adam step beside fused
               Adam, both also in a CUDA graph); K14's (D', keep), the
               gate's p, the utilization, the gate backward's outputs,
               the MLU's (loss, lse), its seed's g_util, K17's scale and
               the Adam step's (w, m, v, row) against the sha256 digests
               of the first designs; the
               quotient by tau against the correctly rounded division at
               the run's temperatures; then, counted, adam_solve
               for 8 steps (per-step ms, launches per step, peak memory,
               first and last loss, all finite, the last beside the
               earlier adjoint round's); then one step under
               torch.profiler (device busy share, kernel time by name);
               then, not counted,
               8 steps on fabric_edges(4) (260 nodes, seeded metrics)
               against the plain versions differentiated by autograd on
               the card
  te_mesh      te_clos's batch (4 scenarios, 128 rounds) sharded over a
               (4, 1) mesh of ranks sharing the card, 2 Adam steps,
               counted: each rank's forward and backward in turn, the
               gradients summed onto rank 0, one Adam step there; weights
               within 5e-3 and losses within 1e-4 of the unsharded
               adam_solve of the same steps; step time and peak memory of
               both (under 48 GiB), K14-K18 launches a step (K14-K17 four
               times te_clos's, K18 an MLU and a seed a rank and one Adam
               step)
  te_service   TeService(device="cuda") on the bench's congested 6-node
               fixture: at the bench's settings (48 steps, 4 scenarios)
               the CPU run's proposal and scores, best of 3 timed runs
               after a first; at the acceptance test's (one scenario) 6.0
               -> 2.0 with the CPU run's proposal; and
               TeService over CudaSpfSolver(apsp_max_nodes=4096) on
               fabric_edges(2) (148 nodes) after a route build: one
               all-pairs borrow (K11), the initial scores equal the CPU
               run's (a failed card run raises: the service has no CPU
               fallback)
  te_pendant   a measurement, not a path: adam_solve on the pendant-node
               TE input (seeded Clos and grid, weights 31-40), card
               against CPU: the weight gaps (the pendant's in-edge apart),
               and per softmin round the fold outcomes and gap == 0 sets
               of the card's chain against the CPU's
  nccl         NCCL between cards: not measured (one card)
  tile_wan     the destination-tiled layout on the north-star WAN over a
               (1, 4) mesh of ranks sharing the card: K19 (tile round),
               K20 (halo fold) and K21's entries (tile init, mark, reset,
               changed columns) against their plain versions on one round
               of the real state (exact); the cold tiled solve (D and
               rounds equal to K1's) and event_wan's event on the tiles (D
               equal to a cold K1 solve of the new weights; rounds,
               inv_rounds, col_changed and num_changed equal to the plain
               tiled warm); the halo bytes against the bytes the ring hops
               copied; h, n_tile and e_tile; times, K19's, K20's and
               K21's entries also replayed in a CUDA graph (device time),
               K21's entries also on the host clock alone (host time)
  tile_clos    DeltaRouteBuilder over CudaSpfSolver(mesh=(1, 4) Mesh) on
               the 9,556-node Clos through the seven events of
               event_clos: every db equal to a mesh=None solver's and the
               CPU oracle's; the halo counters; delta against full builds
  mesh_rows    the batch-sharded row layout, a (4, 1) mesh on the WAN:
               cold and event_wan's event, D and rounds equal to the
               unsharded K1 / K5 path; 16 KSP2 prefixes of ksp_wan under a
               (2, 1) mesh, the route db equal to the unsharded solver's
  decision_clos  Decision(cuda) for rsw0_0 on the 9,556-node Clos (one
               prefix a node), behind its SolverSupervisor, fed live
               publications beside Decision(cpu): the first route delta
               and then main_path's event as adjacency publications
               (fsw0_1<->ssw1_0 overloaded, fsw0_2<->rsw0_5 at metric 3),
               which takes DeltaPath, each equal to the CPU's; K1, K3, K4,
               K5 and K7 launched; route_build_ms, route_build_delta_ms,
               debounce_ms and solve_ms_last, and each publication's time
               to its delta split into the ingest (process_publication),
               the rebuild callback (rebuild_routes) and, inside it, the
               solver's poll_device_delta (Decision(cuda)'s first poll
               builds the area's graph and layout and solves) and its
               build_route_db, and the cyclic garbage collector's passes
               and time in it, for both Decisions; the process-wide
               decode cache is cleared before each delivery, so each
               Decision pays its own parse
  decision_drill  the fault domain on the card, on lfa_clos's 3,956-node
               Clos: solver.tpu.solve armed until the breaker trips, the
               CPU oracle's deltas equal to Decision(cpu)'s while degraded;
               disarmed, probes close the breaker and the next delta comes
               from the card; a real allocation past the card's memory
               classifies as device_oom; on fabric_edges(4) a clean
               run_te_optimize (primary, its proposals equal to
               TeService's direct run on the card; K14-K18) and one with
               te.optimize armed once (degraded, one TE_OPTIMIZE_DEGRADED
               sample); then every kernel's launch refused: the error
               raises out of the rebuild and out of run_te_optimize, no
               delta and no report come from the CPU, the breaker stays
               closed, and once the launches are restored the card serves
               the next event, its route db equal to Decision(cpu)'s
  decision_mesh  the gate under a (4, 2) mesh of ranks sharing the card:
               Decision(cuda, mesh) == Decision(cpu) on the 3,956-node Clos
               and an event (tiled layout: K19, K20, K21)
  decision_ledger  the memory ledger and the flight recorder on the card's
               solver: (a) Decision(cuda) with solver_trace_sample_every=1
               through decision_clos's first publication and event, each
               solve's phase split (prepare, h2d, relax, delta_extract,
               d2h ms) beside solve_ms_last, deltas equal to Decision(cpu);
               (b) after every solve registered == live + freed, and
               predict_fit's bytes (structure by structure equal to the
               registered ones) beside the caching allocator's change across
               the first dispatch (within 10%) for sell (the 9,556-node
               Clos), tile2d (decision_mesh's (4, 2)), apsp (apsp_wan's
               4,096 nodes, one cold close) and te (te_clos's working set
               through TeService: its upload and one Adam step measured by a
               spy in place of optimize_weights, skipping the host scoring;
               the step's peak beside the model); (c) a capacity drill on the
               3,956-node Clos under compute_lfa_paths: room for the sliced
               layout's solves, not for the all-pairs matrix: one
               SOLVER_CAPACITY_REFUSED sample (apsp, override), deltas equal
               to Decision(cpu)'s, another node's route db from the host's
               Dijkstra (host_spf_calls) equal to the CPU oracle's; (d) a
               capacity below the sliced layout's model: DeviceCapacityError
               before any allocation (the ledger and the allocator
               unchanged), solver_failures.device_oom, the oracle's delta;
               the override lifted, the probes close the breaker and the card
               serves the next event; (e) after Decision.stop the ledger's
               live handles and the allocator are back to the phase's
               baseline (a remainder is named or fails)
               A Decision phase fails if the supervisor served a delta
               outside the drill (fallback_active, an open breaker, a
               decision.spf fault counter), if device_solves did not rise,
               if an SPF answer came from host Dijkstra, or if an error
               reached the loop outside the drill.
  kernels      one line for all kernels: launches, error, ms, bounds;
               what `ms` times (`timed_unit`) and the kernel's launches
               in one such call, counted beside its timing
               (`launches_per_call`); for K16-K18 the entries run once a
               step (`side`: ms, bound, launches a call, library_ms and
               graph_ms where taken)

Every path (main_path, event_wan, event_clos, star_flap, ksp_wan,
ksp_star, apsp_wan, lfa_clos, te_clos, te_mesh, te_service, tile_wan,
tile_clos, mesh_rows, decision_clos, decision_drill, decision_mesh,
decision_ledger) runs
with all launch
counts set to 0 just before it and read just after, and fails if a kernel
it drives was not launched. The (min,+) tile product of fw_minplus.cuh
(K10 in the port's numbering) has no launch and no row of its own: it
runs inside K13, whose results are held against its plain version at
full width, so it is checked through it (K11 carries its own product). The card's name and power limit print on
their own line before the last, and the last line is {"ok": true,
"device": {...}}. Any failed check raises, and the script then exits
non-zero without that line. It imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
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
# float32 exp/log in the special function units: 16/SM/clock (CUDA C
# Programming Guide throughput table, compute capability 9.0)
_MUFU_OPS_PER_S = 16 * 132 * 1.98e9

# the main path's sizes: the north-star WAN, the grid of the ECMP bench and
# the Clos of the 9,556-node fabric configuration
DEVICE = "cuda"
WAN_N = 100000
GRID_SIDE = 32
CLOS_PODS = 170
CLOS_NODES = 9556
STAR_LEAVES = 1100  # hub in-degree past the sliced layout's cap
# KSP2: BASELINE.json config 4's WAN, and the star with a ring through it
KSP_WAN_N = 50000
KSP_STAR_LEAVES = 1100
# APSP: bench.py's _bench_apsp graph at the production node cap
# (DecisionConfig.solver_apsp_max_nodes), and a Clos under it for LFA
APSP_N = 4096
LFA_CLOS_PODS = 70
LFA_CLOS_NODES = 3956
# differentiable TE: the LFA Clos at full width, and the smaller Closes of
# the whole-chain check and the borrow
TE_CLOS_PODS = 70
TE_CLOS_NODES = 3956
TE_STEPS = 8
TE_DEMANDS = 4096
TE_CHAIN_PODS = 4
# te_mesh: te_clos's batch of 4 scenarios over a (4, 1) mesh of ranks
# sharing the card, 2 Adam steps
TE_MESH_B = 4
TE_MESH_STEPS = 2
# te_clos's last loss on an H100 80GB HBM3 with the first designs of K15,
# K16 and K17 (one thread a column; K17 divided g_util by the capacity per
# column): the redesigned K15 (softmin backward), K16 (flow round) and
# K17 (adjoint round) sum in the same orders, and K15's quotient by tau has
# the correctly rounded bits, so equal bits show it
LOSS_LAST_COLUMN_ROUND = 4.251302719116211
# sha256 digests, on an H100 80GB HBM3 with the first designs of K14 (one
# thread a column) and of K17's gate backward (one thread a column, a block
# reduction an out-edge), at te_clos's state with tau 0.5 (`digest`): K14's
# (D', keep) on the D of te_rounds rounds, and the gate backward's (g_d,
# g_we, the overwritten g_p) on that D and the g_p of two seeded adjoint
# rounds. The redesigns sum in the same orders and divide by tau with the
# correctly rounded bits, so equal digests show it
K14_DIGEST_FIRST_DESIGN = (
    "44a775da155787da790e22d298afb3decc3eb1e84d608079a4d3868b05a9f445")
GATE_BWD_DIGEST_FIRST_DESIGN = (
    "3ac6d31c030ff082ddf18c22bfd38842a091955e2646582e0cc5251a73d86ff5")
# sha256 digests, on an H100 80GB HBM3 with the first designs of K16's
# gate (one thread a column, each walking its node's out-edges twice) and
# utilization (a block an edge, a block reduction a scenario), at the same
# state (`digest`): the gate's p on the D of te_rounds rounds, and the
# utilization on that p and the xsum of one flow round. The redesigns sum
# in the same orders and divide with __fdiv_rn, so equal digests show it
GATE_DIGEST_FIRST_DESIGN = (
    "c3d6c6985a7ed302a9ca876ac1a8b0ce39cffcc59bdd7c21103f25b59151300e")
UTIL_DIGEST_FIRST_DESIGN = (
    "a3c331bb53c55c0e7b06eb7d849429ba6d10e533ccf57495a3f96e2c2af32350")
# sha256 digests, on an H100 80GB HBM3 with the first designs of K18's MLU
# (one block of 1,024 threads walking the scenarios in turn, the row read
# twice) and its seed (a thread an element), at the same state
# (`digest`): the MLU's (loss, lse) on the utilization of
# UTIL_DIGEST_FIRST_DESIGN, every scenario unmasked, tau_obj 0.25, and the
# seed's g_util for g_loss = 1 on that lse. The redesigns keep the first
# designs' sum order and expressions, so equal digests show it
MLU_DIGEST_FIRST_DESIGN = (
    "cbe7fdaff3c2490fbff9f58cfebd817ea56d6d97919b3ec9789fe7c37146fcbb")
SEED_DIGEST_FIRST_DESIGN = (
    "0e67f3e713e4cdce0c668f0082f38b22bb1d9fd951974befc03976e453ca7dae")
# sha256 digests, on an H100 80GB HBM3 with the first designs of K17's
# scale (a thread an element, caps[i % E] read again for every scenario)
# and of K18's Adam step (a thread an edge, scalar loads), at the same
# state (`digest`): the scale's c on the seeded g_util of the adjoint
# rounds and on the MLU's seed with scenario 1's row zeroed (a masked
# scenario), and the Adam step's (w, m, v, row) after step 3's update
# with a seeded gradient. Any later design of either must keep these bits
SCALE_DIGEST_FIRST_DESIGN = (
    "0a77621a9cf3b2e9e7c3830f73e1a2e586822db0c4520dd79dd4dde4975225e4")
ADAM_DIGEST_FIRST_DESIGN = (
    "b7a7e813bb0a28f2ccbfaa6e828534dd3604225303152817754c883c09d50dd4")
TE_BORROW_PODS = 2
# the multi-device layouts: a graph axis of 4 over the north-star WAN and
# the Clos (ranks sharing the one card), a batch axis of 4 over the WAN
TILE_G = 4
ROW_B = 4
# SASS opcodes counted in the all-pairs kernels' built code: the DPX
# add-and-min, the plain min and add it replaces, shared-memory loads and
# the asynchronous global-to-shared copy (cp.async)
SASS_OPCODES = ("VIADDMNMX", "VIMNMX", "IMNMX", "IADD3", "LDS", "LDGSTS")


# what each kernel's `ms` in the kernels line times; its launches in one
# such call are counted beside it (`launches_per_call`), so that `ms` and
# the kernel's path `launches` can be set in one unit
TIMED_UNIT = {
    "sell_relax_round": "a cold solve (WAN, 128 sources): two launches a "
                        "round (active rows, round) for every bucket, in "
                        "chunks of 8 rounds",
    "bf_relax_round": "a cold edge-list solve (WAN, 128 sources): the "
                      "dest-major cold state, two launches a round (rows "
                      "that can move, round), in chunks of 8 rounds, D "
                      "transposed out",
    "ecmp_triangle": "one call (grid 32)",
    "sell_apply_patches": "one call (WAN event, every bucket)",
    "sell_mark": "the WAN event's invalidation and warm start: the seed, a "
                 "launch a mark round for every bucket, in chunks of 8 "
                 "rounds, the reset",
    "bf_mark": "the WAN event's edge-list invalidation and warm start: "
               "d_prev transposed into K2's layout, the seed, two launches a "
               "mark round in chunks of 8 rounds, the reset in place",
    "delta_extract": "one extraction (WAN event): columns, compaction, "
                     "gather",
    "sell_mask": "KSP's masks (50k WAN): the build and the seed",
    "sell_relax_masked_round": "a masked cold solve (50k WAN, KSP batch): "
                               "two launches a round (active rows, masked "
                               "round) for every bucket, in chunks of 8 "
                               "rounds",
    "fw_close": "a cold close (n_pad 4,096): block (0, 0)'s close, panels "
                "and outer a stage, the probe",
    "fw_seed": "one seed (n_pad 4,096, apsp_wan's raise_40 event)",
    "fw_reclose": "one re-close round (the event's dirty blocks)",
    "softmin_round": "one softmin round (te_clos)",
    "softmin_round_bwd": "one softmin round's backward (te_clos): rows, "
                         "pull, edges",
    "soft_flow": "one flow round (te_clos)",
    "soft_flow_bwd": "one adjoint round, the scale given (te_clos)",
    "te_step": "one Adam step (te_clos's [E]), as adam_solve runs it: "
               "its constants packed once a solve",
    "tile_round": "one tile round of one rank (WAN on (1, 4)): the tile's "
                  "node-major copy, the slots",
    "tile_fold": "one halo fold of one rank (WAN on (1, 4))",
    "tile_mark": "init, mark, reset and changed columns of one rank (WAN on "
                 "(1, 4)), one call each",
}


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


def time_ms(fn, reps: int = 7, warmup: int = 2, setup=None) -> float:
    """Median of `reps` timed calls, CUDA events around each. `setup`, if
    given, makes each call's arguments outside the timed span (fresh
    copies of buffers the call updates in place)."""
    import torch

    for _ in range(warmup):
        fn(*(setup() if setup else ()))
    times = []
    for _ in range(reps):
        args = setup() if setup else ()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls: int):
    """The device time of one call of `fn`, its host time left out: `calls`
    calls captured in a CUDA graph, the graph replayed 5 times between CUDA
    events, the median over the calls. The inputs stay the same, so the
    card's L2 is warm. Where the capture fails, "not measured" and why."""
    import torch

    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        return time_ms(graph.replay, reps=5, warmup=1) / calls
    except RuntimeError as exc:
        torch.cuda.synchronize()
        return {"not_measured": f"CUDA graph capture failed: {exc}"}


def host_ms(fn, calls: int = 50, reps: int = 7) -> float:
    """The host time of one call of `fn`: `calls` calls enqueued back to
    back on the host clock, the card synchronised before each batch and
    after it outside the clock, the median over `reps` batches. A call's
    span as timed (`time_ms`) less its device time (`graph_ms`) should come
    near it where the card waits on the host."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter_ns() - t0) / calls / 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def launches_a_call(kernel, fn, setup=None) -> int:
    """`kernel`'s launches in one call of `fn`, read from its count before
    and after (`setup`, if given, makes the call's arguments first): the
    timed unit of the kernel's `ms`, in launches."""
    args = setup() if setup else ()
    l0 = kernel.launches
    fn(*args)
    return kernel.launches - l0


def seed_times(fw, kernel, args) -> dict:
    """K12 on one seed's inputs (`fw_seed(*args)`): its launches a call,
    its span (`time_ms`, 21 calls), device time (`graph_ms`, 20 calls),
    host time (`host_ms`) and, under the profiler, the device time of each
    of its entry points (`profile.split_ms`)."""

    def k12():
        return fw.fw_seed(*args)

    return {
        "launches_per_call": launches_a_call(kernel, k12),
        "ms": time_ms(k12, reps=21), "graph_ms": graph_ms(k12, 20),
        "host_ms": host_ms(k12),
        "profile": profile_window(k12, split=tuple(kernel.entries)),
    }


def ecmp_bytes(rows: int, e: int, t: int):
    """K3's bound on an [rows, t] matrix and e edges: (bytes, operations,
    bytes with every row gather from device memory). The matrix read once,
    the [e, t] bytes written once, four int32 and the overload byte an
    edge; six operations an output."""
    scalars = 12 * e + rows
    return (4 * rows * t + e * t + scalars, 6 * e * t,
            8 * e * t + e * t + scalars)


def ecmp_times(spf, kernel, d, ru, rv, ve, w, ov) -> dict:
    """K3 on one DAG, after a check that it equals its plain version
    exactly: its launches a call, its span (`time_ms`), device time
    (`graph_ms`, 20 calls), host time (`host_ms`) and the plain version's
    span."""
    args = (d, ru, rv, ve, w, ov)

    def k3():
        return spf.ecmp_triangle(*args)

    err = max_abs_err(k3(), spf._ecmp_triangle_plain(*args))
    check(err == 0, f"K3 differs from its plain version: {err} entries "
          f"([{ru.shape[0]}, {d.shape[1]}])")
    return {
        "max_abs_err": err, "launches_per_call": launches_a_call(kernel, k3),
        "ms": time_ms(k3, reps=9), "graph_ms": graph_ms(k3, 20),
        "host_ms": host_ms(k3),
        "plain_ms": time_ms(lambda: spf._ecmp_triangle_plain(*args), reps=9),
    }


def tile_mark_bytes(d_new, dp) -> dict:
    """K21's bound on one rank's [S_l, n_tile] tile, by entry: each input
    read once and each output written once; the changed columns read down
    to each column's first difference (all rows where it has none)."""
    s_l, n_tile = dp.shape
    tile_b = 4 * s_l * n_tile
    diff = d_new != dp
    first = (diff.int().argmax(0) + 1).masked_fill_(~diff.any(0), s_l)
    return {
        "init": tile_b + 4 * s_l,
        "mark": tile_b * 14 // 4,
        "reset": tile_b * 9 // 4 + 4 * s_l,
        "col_changed": 8 * int(first.sum()) + n_tile + 4,
    }


def tile_mark_times(spf, kernel, src, off, marks, recv, dp, d_new) -> dict:
    """K21's four entries on one rank's tile, by entry: launches a call,
    span (`time_ms`, fresh buffers made outside it), the plain version's
    span, device time and host time (`host_ms`). The mark and the changed
    columns update their operands, so their graphs restore them before
    each call (recv copied back, col_changed and count zeroed) and their
    device time is the graph's less that of the restoring alone
    (`restore_graph_ms`); init and reset are 20 calls in a CUDA graph."""
    import torch

    n_tile = dp.shape[1]
    dev = dp.device
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    m_out = torch.empty(dp.shape, dtype=torch.bool, device=dev)
    recv_g = recv.clone()
    cc = torch.zeros(n_tile, dtype=torch.bool, device=dev)
    cnt = torch.zeros(1, dtype=torch.int32, device=dev)

    def fresh_cols():
        return (torch.zeros(n_tile, dtype=torch.bool, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))

    def zero_cols():
        cc.zero_()
        cnt.zero_()

    entries = (
        ("init", lambda: spf.tile_init(src, off, n_tile),
         lambda: spf._tile_init_plain(src, off, n_tile), None, None, None),
        ("mark", lambda r: spf.tile_mark(marks, r, dp, flag),
         lambda r: spf._tile_mark_plain(marks, r, dp, flag),
         lambda: (recv.clone(),),
         lambda: spf.tile_mark(marks, recv_g, dp, flag, out=m_out),
         lambda: recv_g.copy_(recv)),
        ("reset", lambda: spf.tile_reset(marks, dp, src, off),
         lambda: spf._tile_reset_plain(marks, dp, src, off), None, None,
         None),
        ("col_changed",
         lambda c, n: spf.tile_col_changed(d_new, dp, c, n),
         lambda c, n: spf._tile_col_changed_plain(d_new, dp, c, n),
         fresh_cols, lambda: spf.tile_col_changed(d_new, dp, cc, cnt),
         zero_cols),
    )
    out = {}
    for name, fn_k, fn_p, setup, again, restore in entries:
        again = again or fn_k
        row = {
            "launches_per_call": launches_a_call(kernel, fn_k, setup=setup),
            "ms": time_ms(fn_k, setup=setup),
            "plain_ms": time_ms(fn_p, setup=setup),
            "host_ms": host_ms(again),
        }
        if restore is None:
            row["graph_ms"] = graph_ms(again, 20)
        else:
            both = graph_ms(lambda: (restore(), again()), 20)
            alone = graph_ms(restore, 20)
            row["restore_graph_ms"] = alone
            row["graph_with_restore_ms"] = both
            row["graph_ms"] = (both - alone if isinstance(both, float)
                               and isinstance(alone, float) else both)
        out[name] = row
    return out


def profile_window(fn, split=()) -> dict:
    """One call of `fn` under torch.profiler: its wall ms (the profiler's
    host cost included), the device time of its kernels and copies summed
    by name, and the device's busy share, their sum over the wall time;
    with `split`, also the device time of the kernels whose name holds
    each of its strings (`split_ms`). The call runs all the same; where
    the profiler fails or records no device time, the result says "not
    measured" and why."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the first device activities of a window can go unrecorded (a
            # close's copy and first kernel did, after one fill and a sync):
            # warm-up fills take them
            for _ in range(3):
                torch.zeros(1, device=DEVICE)
                torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    except RuntimeError as exc:  # a profiler that cannot trace the card
        fn()
        return {"not_measured": f"torch.profiler failed: {exc}"}
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
    if not by_name:
        return {"not_measured": "torch.profiler recorded no device time"}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_ms": busy,
           "busy_share": busy / wall_ms, "top_ms": dict(top)}
    if split:
        out["split_ms"] = {key: sum(ms for name, ms in by_name.items()
                                    if key in name) for key in split}
    return out


def sass_counts(kernel, opcodes) -> dict:
    """Per kernel function of `kernel`'s built library, how many SASS
    instructions carry each opcode in `opcodes` (`cuobjdump -sass`, from
    beside nvcc), and all its instructions; "not measured" where cuobjdump
    is missing or fails."""
    from openr_tpu_torch.ops import _cuda

    try:
        tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
        sass = subprocess.run(
            [tool, "-sass", str(kernel.library_path())], capture_output=True,
            text=True, timeout=120, check=True).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        return {"not_measured": f"cuobjdump failed: {exc}"}
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = {op: 0 for op in opcodes} | {"all": 0}
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(@!?U?P\w+\s+)?([A-Z]\w*)",
                       line)
        if fn is not None and ins:
            counts[fn]["all"] += 1
            op = ins.group(2)
            if op in counts[fn]:
                counts[fn][op] += 1
    return counts


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes, one after the other, as they lie on the
    host (row-major)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy())
    return h.hexdigest()


def apsp_events(apsp_edges, ag, d_now):
    """apsp_wan's four events on `wan_edges(4096, 4, 7)` (`ag` its
    compiled graph, `d_now` the closed matrix before them): (name, edits
    for `edit_adjacency` or None for the overload toggle, warm expected)."""
    import numpy as np

    # 1: one directed edge on a shortest path raised (bench.py's event
    # position, moved to the next edge that is a shortest path itself)
    pos = ag.e // 2
    while int(ag.w[pos]) != int(d_now[ag.src[pos], ag.dst[pos]]):
        pos += 1
    u1, v1 = ag.names[ag.src[pos]], ag.names[ag.dst[pos]]
    ev1 = [(u1, v1, {"metric": int(ag.w[pos]) + 20})]
    # 2: about 40 raised pairs: 30 metrics up, 5 links down (both
    # directions), and 15 metrics down
    erng = np.random.default_rng(11)
    dirs = [(a, b) for a, b, _ in apsp_edges] + [
        (b, a) for a, b, _ in apsp_edges]
    pick = erng.choice(len(dirs), size=50, replace=False)
    metric = {(a, b): m for a, b, m in apsp_edges}
    metric.update({(b, a): m for a, b, m in apsp_edges})
    ev2 = []
    for j, idx in enumerate(pick):
        a, b = dirs[idx]
        if j < 30:
            ev2.append((a, b, {"metric": metric[(a, b)]
                               + int(erng.integers(1, 60))}))
        elif j < 35:
            ev2.append((a, b, {"is_overloaded": True}))
        else:
            ev2.append((a, b, {"metric": max(1, metric[(a, b)]
                                             - int(erng.integers(1, 60)))}))
    # 3: more than 64 raised pairs: the warm patch overflows, cold close
    pick3 = erng.choice(len(dirs), size=80, replace=False)
    ev3 = [(dirs[i][0], dirs[i][1], {"metric": 101 + int(erng.integers(
        0, 50))}) for i in pick3]
    return [("raise_one", ev1, True), ("raise_40", ev2, True),
            ("raise_80", ev3, False), ("overload_toggle", None, False)]


def increase_slots(w_prev, w_new):
    """The warm seed's slot arrays (inc_u, inc_v, inc_w) on w_new's device
    for the pairs whose weight rose, as `ApspState` fills them: p bucketed
    (at least 8), padding slots u = INCREASE_PAD."""
    import numpy as np
    import torch

    from openr_tpu_torch.apsp import kernels as fw
    from openr_tpu_torch.ops.graph import _next_bucket

    pairs = torch.nonzero(w_new > w_prev).cpu().numpy()
    check(len(pairs) <= fw._APSP_PATCH_SLOTS, "warm event too wide")
    p = _next_bucket(max(len(pairs), 1), minimum=8)
    slots = np.zeros((3, p), dtype=np.int32)
    slots[0] = fw.INCREASE_PAD
    w_prev_h = w_prev.cpu().numpy()
    for i, (u, v) in enumerate(pairs):
        slots[:, i] = (u, v, w_prev_h[u, v])
    return tuple(torch.as_tensor(x, device=w_new.device) for x in slots)


def seed_work(d_prev, iu, iv, iw) -> dict:
    """K12's work on this data, for its bound: a row scans D once for each
    valid slot whose u it reaches, up to and including its first hit, an
    add, a min and a compare per entry (`rows_scanned`, `ops`); D and
    w_new read once, d0 written once, the slots read and the flags written
    (`bytes`)."""
    import torch

    from openr_tpu_torch.ops.graph import INF

    n = d_prev.shape[0]
    done = torch.zeros(n, dtype=torch.bool, device=d_prev.device)
    rows_scanned = 0
    for q in torch.nonzero(iu < n).flatten().tolist():
        a_q = (d_prev[:, int(iu[q])] + iw[q]).clamp_max(INF)
        live = (a_q < INF) & ~done
        rows_scanned += int(live.sum())
        cand = (a_q[:, None] + d_prev[int(iv[q])][None, :]).clamp_max(INF)
        done |= live & ((cand == d_prev) & (d_prev < INF)).any(dim=1)
    return {"rows_scanned": rows_scanned, "ops": 3 * rows_scanned * n,
            "bytes": 12 * n * n + n + 12 * iu.numel()}


def max_abs_err(a, b) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def rel_err(a, b) -> float:
    """max |a - b| over max |b|, in float64: the float32 kernels' error."""
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    diff = (a.double() - b.double()).abs().max()
    return float(diff / b.double().abs().max().clamp_min(1e-30))


def te_demand_spec(names, count, seed):
    """A seeded spec of `count` rsw -> rsw demands, loads uniform in [0.5,
    4], 4 scenarios with spread 0.5, capacities 1.0."""
    import numpy as np

    rsw = [x for x in names if x.startswith("rsw")]
    rng = np.random.default_rng(seed)
    pairs = rng.choice(len(rsw), size=(count, 2))
    loads = rng.uniform(0.5, 4.0, size=count)
    return {
        "demands": [[rsw[a], rsw[b], float(x)]
                    for (a, b), x in zip(pairs, loads) if a != b],
        "capacities": {"default": 1.0},
        "scenarios": 4, "scenario_spread": 0.5,
    }


def bound(bytes_: float, ops: float, rate: float,
          ops_rate: float = _INT32_OPS_PER_S):
    t_bytes = bytes_ / rate * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Launches:
    """Launch counts per driven path. `start()` sets every kernel's count
    to 0 just before a path, `read(path, ...)` takes the counts just after
    it. Inside a path, `pause()` banks the counts so far and `resume()`
    sets them to 0 again, so comparison runs in between are not counted."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.by_path = {}
        self._bank = {}

    def _zero(self) -> None:
        for k in self.kernels:
            k.launches = 0

    def start(self) -> None:
        self._bank = {k.name: 0 for k in self.kernels}
        self._zero()

    def pause(self) -> None:
        for k in self.kernels:
            self._bank[k.name] += k.launches
        self._zero()

    resume = _zero

    def read(self, path: str, expect) -> dict:
        self.pause()
        counts = dict(self._bank)
        self.by_path[path] = counts
        for k in expect:
            check(counts[k.name] > 0,
                  f"kernel {k.name} was not launched on path {path}")
        return counts

    def total(self, name: str) -> int:
        return sum(c[name] for c in self.by_path.values())


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


def wan_event(g, d, torch, np, INF):
    """One seeded 48-edge weight event on compiled graph g with row-major
    fixpoint d [S, n_pad] on the card: 20 increases on the old
    shortest-path DAG of some source (4 of them links down), 20 decreases
    and 8 new random metrics. Returns (w_new, changed, increased, the
    positions raised on the DAG)."""
    src = torch.as_tensor(g.src[: g.e].astype(np.int64), device=d.device)
    dst = torch.as_tensor(g.dst[: g.e].astype(np.int64), device=d.device)
    w = torch.as_tensor(g.w[: g.e], device=d.device)
    dv = d[:, dst]
    on_dag = (((d[:, src] + w).clamp_max(INF) == dv) & (dv < INF)).any(0)
    on_dag = on_dag.cpu().numpy()
    rng = np.random.default_rng(11)
    w_new = g.w.copy()
    up = rng.choice(np.nonzero(on_dag)[0], size=20, replace=False)
    rest = np.setdiff1d(np.nonzero(g.w[: g.e] > 1)[0], up)
    down = rng.choice(rest, size=28, replace=False)
    w_new[up] = g.w[up] + rng.integers(1, 50, size=20)
    w_new[up[:4]] = INF
    w_new[down[:20]] = g.w[down[:20]] - rng.integers(
        1, g.w[down[:20]], size=20)
    w_new[down[20:]] = rng.integers(1, 101, size=8)
    changed = np.sort(np.concatenate([up, down]))
    changed = changed[w_new[changed] != g.w[changed]]
    return w_new, changed, changed[w_new[changed] > g.w[changed]], up


def sell_warm_plain(spf, key, src, st, wgs, idx, vals, inc, d_prev):
    """_sell_solver_warm composed of the plain versions (K5, K4, K5 reset,
    K1, K7 columns): (D, rounds, inv_rounds, num_changed, col_changed)."""
    zero_end, starts, _ = key
    marks = spf._sell_seed_plain(d_prev, st["nbrs"], wgs, inc, starts)
    marks, inv = spf._sell_mark_fixpoint_plain(
        d_prev, marks, st["nbrs"], wgs, starts
    ) if bool(marks.any()) else (marks, 0)
    wgs = spf._sell_apply_patches_plain(wgs, idx, vals)
    d0 = spf._bf_warm_d0_plain(d_prev, marks, src).t().contiguous()
    d, rounds = spf._sell_relax_plain(d0, src, st["ov"], st["nbrs"], wgs,
                                      starts)
    d = d.t().contiguous()
    cc = (d != d_prev).any(dim=0)
    return d, rounds, inv, int(cc.sum()), cc


def clos_events():
    """(name, [(node, other, adjacency changes)], expect the delta path):
    six events away from rsw0_0, then one at it."""
    link = [("fsw0_3", "rsw0_9"), ("rsw0_9", "fsw0_3")]
    spine = [("fsw5_2", "ssw2_4"), ("ssw2_4", "fsw5_2")]
    plane = [(a, b) for k in range(9)
             for a, b in (("fsw5_2", f"ssw2_{k}"), (f"ssw2_{k}", "fsw5_2"))]
    return [
        ("metric_up", [(a, b, {"metric": 5}) for a, b in link], True),
        ("metric_down", [(a, b, {"metric": 1}) for a, b in link], True),
        ("spine_link_down",
         [(a, b, {"is_overloaded": True}) for a, b in spine], True),
        ("spine_link_up",
         [(a, b, {"is_overloaded": False}) for a, b in spine], True),
        ("fsw_plane_down",
         [(a, b, {"is_overloaded": True}) for a, b in plane], True),
        ("fsw_plane_up",
         [(a, b, {"is_overloaded": False}) for a, b in plane], True),
        ("at_me", [("rsw0_0", "fsw0_1", {"metric": 3}),
                   ("fsw0_1", "rsw0_0", {"metric": 3})], False),
    ]


# -- Decision on the card ---------------------------------------------------

DECISION_ME = "rsw0_0"
DECISION_TIMEOUT_S = 300.0
# the spf fault counters a clean Decision phase must not show
DECISION_FAULT_COUNTERS = (
    "decision.spf.solver_failures", "decision.spf.solver_retries",
    "decision.spf.fallback_solves", "decision.spf.breaker_trips",
    "decision.spf.probe_failures", "decision.spf.audit_mismatches",
    "decision.spf.delta_audit_mismatches",
    "decision.spf.apsp_fallback_closes",
)


def edited_adj_dbs(dbs: dict, edits) -> dict:
    """Apply [(node, other, adjacency changes)] to the advertised
    databases `dbs` (in place) and return the re-advertised ones."""
    changed = {}
    for node, other, changes in edits:
        db = changed.get(node, dbs[node])
        changed[node] = dataclasses.replace(db, adjacencies=[
            dataclasses.replace(a, **changes)
            if a.other_node_name == other else a
            for a in db.adjacencies
        ])
    dbs.update(changed)
    return changed


def timed_calls(obj, attr: str, into: dict, key: str):
    """Replace obj.attr by a wrapper that adds each call's wall time in ms
    to into[key]; returns the wrapper."""
    fn = getattr(obj, attr)

    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            into[key] = into.get(key, 0.0) + (time.perf_counter() - t) * 1e3

    setattr(obj, attr, timed)
    return timed


class GcTime:
    """The cyclic garbage collector's time and passes while installed (a
    `gc.callbacks` entry): `ms`, and `passes` by generation."""

    def __init__(self) -> None:
        self.ms = 0.0
        self.passes = [0, 0, 0]
        self._t = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t) * 1e3
            self.passes[info["generation"]] += 1

    def reset(self) -> None:
        self.ms, self.passes = 0.0, [0, 0, 0]


class DecisionLoop:
    """Decisions on one asyncio loop, each with its own queues, fed the
    same publications one Decision at a time (so one's route build does not
    delay another's debounce)."""

    def __init__(self, dev) -> None:
        import asyncio

        from openr_tpu_torch.decision import Decision, DecisionConfig
        from openr_tpu_torch.messaging import (
            ReplicateQueue, RQueue, RWQueue,
        )

        self.asyncio = asyncio
        self.loop = asyncio.new_event_loop()
        # what raises out of a Decision's callbacks reaches the loop
        self.raised = []

        def handler(loop, ctx) -> None:
            self.raised.append(ctx.get("exception"))
            loop.default_exception_handler(ctx)

        self.loop.set_exception_handler(handler)
        self.dev = dev
        self._mods = (Decision, DecisionConfig, ReplicateQueue, RQueue,
                      RWQueue)
        self.nodes = []

    def boot(self, backend: str, me: str = DECISION_ME, **cfg):
        Decision, DecisionConfig, ReplicateQueue, RQueue, RWQueue = self._mods
        kv_q, route_q, samples = RWQueue(), ReplicateQueue(), []
        dec = Decision(
            DecisionConfig(
                my_node_name=me, solver_backend=backend,
                solver_device=str(self.dev), debounce_min=0.005,
                debounce_max=0.05, **cfg,
            ),
            RQueue(kv_q), route_q, loop=self.loop,
            log_sample_fn=samples.append,
        )
        node = {"dec": dec, "kv": kv_q, "reader": route_q.get_reader(),
                "samples": samples, "ms": {}}
        # the split of publication to delta: the ingest, the rebuild
        # callback (the debouncer's and the retry's) and inside it the
        # solver's route db build
        timed_calls(dec, "process_publication", node["ms"], "ingest_ms")
        dec._rebuild_debounce._callback = timed_calls(
            dec, "rebuild_routes", node["ms"], "rebuild_ms")
        timed_calls(dec.solver, "build_route_db", node["ms"],
                    "solver_build_ms")
        timed_calls(dec.solver, "poll_device_delta", node["ms"], "poll_ms")
        dec.start()
        self.nodes.append(node)
        return node

    def deliver(self, node, pub):
        """Push one publication to one Decision; its route delta."""
        node["kv"].push(pub)
        return self.loop.run_until_complete(self.asyncio.wait_for(
            node["reader"].get(), DECISION_TIMEOUT_S))

    def wait(self, cond, what: str, timeout: float = 120.0) -> None:
        async def poll():
            t_end = time.monotonic() + timeout
            while not cond():
                check(time.monotonic() < t_end, f"timed out: {what}")
                await self.asyncio.sleep(0.02)

        self.loop.run_until_complete(poll())

    def stop(self) -> None:
        for node in self.nodes:
            task = node["dec"]._task
            node["dec"].stop()
            if task is not None:
                self.loop.run_until_complete(
                    self.asyncio.gather(task, return_exceptions=True))
        self.nodes = []
        self.loop.close()


def hist_sum(dec, name: str):
    h = dec.histograms.get(name)
    return (h.count, h.sum) if h is not None else (0, 0.0)


def same_delta(cuda_delta, cpu_delta, what: str):
    from openr_tpu_torch.testing.decision_harness import (
        assert_route_delta_equal,
    )

    try:
        return assert_route_delta_equal(cuda_delta, cpu_delta)
    except AssertionError as exc:
        check(False, f"{what}: Decision(cuda) differs from Decision(cpu): "
              f"{exc}")


def decision_clean(node, what: str, solves_before: int) -> dict:
    """The no-hidden-fallback gate of a Decision phase: the card served
    every delta. Returns the supervisor's health less its ledger rows."""
    from openr_tpu_torch.solver.supervisor import CLOSED

    dec = node["dec"]
    health = dec.get_solver_health()
    prim = dec.solver.primary
    check(health["fallback_active"] == 0 and health["breaker_state"] == CLOSED
          and dec.counters.get("decision.spf.fallback_active") == 0,
          f"{what}: the supervisor served degraded ({health['breaker_state']})")
    faults_seen = {
        k: v for k, v in dec.counters.items()
        if k.startswith(DECISION_FAULT_COUNTERS) and v
    }
    check(not faults_seen, f"{what}: fault counters {faults_seen}")
    check(prim.device_solves > solves_before,
          f"{what}: device_solves did not rise ({prim.device_solves})")
    check(prim.host_spf_calls == 0,
          f"{what}: {prim.host_spf_calls} SPF answers from host Dijkstra")
    errors = dec.counters.get("decision.route_build_errors", 0)
    check(errors == 0, f"{what}: {errors} route builds raised")
    return {k: v for k, v in health.items()
            if k not in ("device_memory", "traces", "forensics")}


def refused_launch_drill(drv, cu, cp, te, dbs, flap, params, inj,
                         on_card: bool) -> dict:
    """decision_drill's last step: every kernel's launch refused (without
    a card, the solve and TE seams armed with the error a refused launch
    raises). The KernelLaunchError raises out of Decision(cuda)'s rebuild
    (to the loop) and out of run_te_optimize; nothing is served from the
    CPU; restored, the card serves the next event."""
    import contextlib

    from openr_tpu_torch.ops._cuda import KernelLaunchError
    from openr_tpu_torch.solver.supervisor import CLOSED
    from openr_tpu_torch.testing.decision_harness import lsdb_publication
    from openr_tpu_torch.testing.kernel_faults import refused_launches

    dec, sup = cu["dec"], cu["dec"].solver
    c, tc = dec.counters, te["dec"].counters
    before = {k: c.get(k, 0) for k in (
        "decision.spf.solver_failures", "decision.spf.fallback_solves",
        "decision.route_build_errors")}
    te_before = {k: tc.get(k, 0) for k in (
        "decision.te.fallback_runs", "decision.te.optimize_errors")}
    drv.raised.clear()
    pubs = [lsdb_publication(edited_adj_dbs(
        dbs, [(a, b, {"metric": m}) for a, b in flap]).values())
        for m in (7, 8)]
    if on_card:
        refusing = refused_launches()
    else:
        refusing = contextlib.nullcontext()
        for point in ("solver.tpu.solve", "te.optimize"):
            inj.arm(point, times=None, exc=KernelLaunchError)
    with refusing:
        cu["kv"].push(pubs[0])
        drv.wait(lambda: drv.raised, "the refused launch reaching the loop")
        te_exc = None
        try:
            te["dec"].run_te_optimize(params)
        except KernelLaunchError as exc:
            te_exc = exc
    if not on_card:
        for point in ("solver.tpu.solve", "te.optimize"):
            inj.disarm(point)
    raised = list(drv.raised)
    drv.raised.clear()
    check(len(raised) == 1 and isinstance(raised[0], KernelLaunchError),
          f"decision_drill: a refused launch raised {raised}")
    check(te_exc is not None,
          "decision_drill: run_te_optimize served a refused launch")
    check(cu["reader"].size() == 0,
          "decision_drill: a delta came out of a refused launch")
    check(sup.state == CLOSED
          and c.get("decision.spf.solver_failures", 0)
          == before["decision.spf.solver_failures"]
          and c.get("decision.spf.fallback_solves", 0)
          == before["decision.spf.fallback_solves"]
          and c.get("decision.route_build_errors", 0)
          == before["decision.route_build_errors"] + 1,
          f"decision_drill: the refused launch reached the breaker {c}")
    check(tc.get("decision.te.fallback_runs", 0)
          == te_before["decision.te.fallback_runs"]
          and tc.get("decision.te.optimize_errors", 0)
          == te_before["decision.te.optimize_errors"] + 1,
          f"decision_drill: TE counted the refused launch as {tc}")
    # restored: the next event's full build comes from the card
    solves0 = sup.primary.device_solves
    drv.deliver(cu, pubs[1])
    # Decision(cpu) takes the last event alone (metric 8 after 7 moves no
    # route, so it would emit no delta); both end in the same LSDB
    drv.deliver(cp, pubs[1])
    for kind in ("unicast_entries", "mpls_entries"):
        check(getattr(dec.route_db, kind)
              == getattr(cp["dec"].route_db, kind),
              f"decision_drill: after the refused launch, {kind} differ "
              f"from Decision(cpu)'s")
    check(sup.primary.device_solves > solves0 and not drv.raised
          and c["decision.spf.fallback_active"] == 0,
          "decision_drill: the card did not serve the event after the "
          "refused launch")
    return {"raised": type(raised[0]).__name__, "text": str(raised[0]),
            "te_raised": type(te_exc).__name__,
            "route_build_errors": c["decision.route_build_errors"],
            "breaker": sup.state}


def decision_phases(dev, card, paths, expect, clos_edges, lfa_edges,
                    te_edges) -> None:
    """decision_clos, decision_drill and decision_mesh (see the module
    docstring). `expect` maps a phase to the kernels it must launch;
    `paths` counts launches as every path does."""
    import torch

    from openr_tpu_torch.decision.decision import _loads_cached
    from openr_tpu_torch.parallel import make_mesh
    from openr_tpu_torch.solver.supervisor import (
        CLOSED, FAULT_DEVICE_OOM, classify_solver_error,
    )
    from openr_tpu_torch.te import TeService
    from openr_tpu_torch.testing import faults
    from openr_tpu_torch.testing.decision_harness import lsdb_publication
    from openr_tpu_torch.topology import build_adj_dbs

    me = DECISION_ME

    def announce(dbs):
        return {name: [f"10.{i // 256}.{i % 256}.0/24"]
                for i, name in enumerate(sorted(dbs))}

    main_event = [
        ("fsw0_1", "ssw1_0", {"is_overloaded": True}),
        ("ssw1_0", "fsw0_1", {"is_overloaded": True}),
        ("fsw0_2", "rsw0_5", {"metric": 3}),
        ("rsw0_5", "fsw0_2", {"metric": 3}),
    ]

    # -- decision_clos ---------------------------------------------------
    import gc

    t0 = time.perf_counter()
    gc_time = GcTime()
    gc.callbacks.append(gc_time)
    dbs = build_adj_dbs(clos_edges)
    pub0 = lsdb_publication(dbs.values(), announce(dbs))
    drv = DecisionLoop(dev)
    cu, cp = drv.boot("cuda"), drv.boot("cpu")
    prim = cu["dec"].solver.primary
    events = []
    for name, pub in (
        ("first", pub0),
        ("main_event", lsdb_publication(
            edited_adj_dbs(dbs, main_event).values())),
    ):
        solves0 = prim.device_solves
        h0 = {k: hist_sum(cu["dec"], k) for k in (
            "decision.route_build_ms", "decision.route_build_delta_ms",
            "decision.debounce_ms")}
        delta_runs0 = cu["dec"].counters.get(
            "decision.route_build_delta_runs", 0)
        inc0 = cu["dec"].counters.get("decision.spf.incremental_solves", 0)
        cu["ms"].clear()
        cp["ms"].clear()
        _loads_cached.cache_clear()
        gc_time.reset()
        paths.resume()
        t = time.perf_counter()
        got = drv.deliver(cu, pub)
        cuda_ms = (time.perf_counter() - t) * 1e3
        paths.pause()
        cu["ms"].update(gc_ms=gc_time.ms, gc_passes=gc_time.passes)
        _loads_cached.cache_clear()
        gc_time.reset()
        t = time.perf_counter()
        want = drv.deliver(cp, pub)
        cpu_ms = (time.perf_counter() - t) * 1e3
        cp["ms"].update(gc_ms=gc_time.ms, gc_passes=gc_time.passes)
        n_uni, n_mpls = same_delta(got, want, f"decision_clos {name}")
        decision_clean(cu, f"decision_clos {name}", solves0)
        ev = {"event": name, "unicast": n_uni, "mpls": n_mpls,
              "publication_to_delta_ms": cuda_ms,
              "cpu_publication_to_delta_ms": cpu_ms,
              "solve_ms_last": prim.solve_ms_last}
        for side, node, total in (("", cu, cuda_ms), ("cpu_", cp, cpu_ms)):
            split = dict(node["ms"])
            # what is left: the debounce timer's wait and the loop's wake
            split["wait_ms"] = total - split.get("ingest_ms", 0.0) \
                - split.get("rebuild_ms", 0.0)
            ev[side + "split"] = split
        for k, (c0, s0) in h0.items():
            c1, s1 = hist_sum(cu["dec"], k)
            ev[k] = (s1 - s0) if c1 > c0 else None
        ev["delta_path"] = cu["dec"].counters.get(
            "decision.route_build_delta_runs", 0) > delta_runs0
        ev["incremental_solve"] = cu["dec"].counters.get(
            "decision.spf.incremental_solves", 0) > inc0
        events.append(ev)
    check(events[1]["delta_path"] and events[1]["incremental_solve"],
          "decision_clos: main_event did not take DeltaPath on an "
          "incremental solve")
    gc.callbacks.remove(gc_time)
    launches = paths.read("decision_clos", expect["decision_clos"])
    health = decision_clean(cu, "decision_clos", 0)
    check(not drv.raised, f"decision_clos: the loop saw {drv.raised}")
    drv.stop()
    emit({
        "phase": "decision_clos", "me": me, "nodes": len(dbs),
        "graph": f"fabric_edges({CLOS_PODS})", "events": events,
        "route_build_delta_runs": cu["dec"].counters.get(
            "decision.route_build_delta_runs", 0),
        "device_solves": prim.device_solves, "health": health,
        "seconds": time.perf_counter() - t0, "launches": launches,
        "card": card,
    })
    del cu, cp, prim, drv

    # -- decision_drill --------------------------------------------------
    t0 = time.perf_counter()
    paths.start()
    dbs = build_adj_dbs(lfa_edges)
    pub0 = lsdb_publication(dbs.values(), announce(dbs))
    drv = DecisionLoop(dev)
    cu = drv.boot("cuda", solver_probe_interval_s=0.05)
    cp = drv.boot("cpu")
    sup = cu["dec"].solver
    prim = sup.primary
    same_delta(drv.deliver(cu, pub0), drv.deliver(cp, pub0),
               "decision_drill first")
    decision_clean(cu, "decision_drill first", 0)
    flap = [("fsw0_3", "rsw0_9"), ("rsw0_9", "fsw0_3")]
    inj = faults.install(faults.FaultInjector(seed=0))
    try:
        inj.arm("solver.tpu.solve", times=None)
        degraded_events = 0
        for k in range(8):
            metric = 5 if k % 2 == 0 else 1
            pub = lsdb_publication(edited_adj_dbs(
                dbs, [(a, b, {"metric": metric}) for a, b in flap]).values())
            got = drv.deliver(cu, pub)
            if sup.state != CLOSED:
                # disarm while the trip's forensics are fresh: the probes
                # must recover the card, not back off against a held fault
                inj.disarm("solver.tpu.solve")
            same_delta(got, drv.deliver(cp, pub),
                       f"decision_drill armed event {k}")
            degraded_events += 1
            if sup.state != CLOSED:
                break
        health = cu["dec"].get_solver_health()
        check(health["degraded"] and health["breaker_state"] != CLOSED,
              "decision_drill: the breaker did not trip")
        c = cu["dec"].counters
        check(c.get("decision.spf.breaker_trips") == 1
              and c.get("decision.spf.fallback_solves", 0) > 0
              and c.get("decision.spf.solver_failures", 0)
              >= cu["dec"].config.solver_failure_threshold,
              f"decision_drill: trip counters {c}")
        trips = {k: v for k, v in c.items()
                 if k.startswith("decision.spf.") and "fail" in k
                 or k.endswith(("breaker_trips", "fallback_solves"))}
        t = time.perf_counter()
        drv.wait(lambda: sup.state == CLOSED, "probes closing the breaker")
        close_s = time.perf_counter() - t
        solves0 = prim.device_solves
        fallback0 = c.get("decision.spf.fallback_solves", 0)
        # the flap back: a route change, so a delta is emitted
        pub = lsdb_publication(edited_adj_dbs(
            dbs, [(a, b, {"metric": 6 - metric}) for a, b in flap]).values())
        same_delta(drv.deliver(cu, pub), drv.deliver(cp, pub),
                   "decision_drill recovered event")
        check(sup.state == CLOSED and prim.device_solves > solves0
              and c.get("decision.spf.fallback_solves", 0) == fallback0
              and c["decision.spf.fallback_active"] == 0,
              "decision_drill: the recovered event was not served by the "
              "card")
        # a real allocation past the card's memory
        oom_kind = oom_text = None
        if dev.type == "cuda":
            try:
                torch.empty(1 << 40, dtype=torch.uint8, device=dev)
            except torch.cuda.OutOfMemoryError as exc:
                oom_kind, oom_text = classify_solver_error(exc), str(exc)
            check(oom_kind == FAULT_DEVICE_OOM,
                  f"decision_drill: a 1 TiB allocation classified as "
                  f"{oom_kind}")
        # TE through the supervisor on fabric_edges(TE_CHAIN_PODS)
        te_dbs = build_adj_dbs(te_edges)
        te = drv.boot("cuda", solver_max_attempts=1)
        te_cpu = drv.boot("cpu")
        te_pub = lsdb_publication(te_dbs.values(), announce(te_dbs))
        same_delta(drv.deliver(te, te_pub), drv.deliver(te_cpu, te_pub),
                   "decision_drill TE area")
        params = {"steps": 2, "seed": 0}
        clean = te["dec"].run_te_optimize(params)
        tc = te["dec"].counters
        check(clean["backend"] == "primary" and not clean["degraded"]
              and tc.get("decision.te.fallback_runs", 0) == 0,
              f"decision_drill: clean TE run {clean['backend']}")
        paths.pause()  # the direct run is a comparison
        direct = TeService(me, te["dec"].area_link_states,
                           device=dev).optimize(params)
        paths.resume()
        keys = ("weight_changes", "initial_max_util", "optimized_max_util",
                "improved", "steps")
        check(all(clean[k] == direct[k] for k in keys),
              "decision_drill: run_te_optimize's proposals differ from "
              "TeService's direct run")
        inj.arm("te.optimize", times=1)
        degraded = te["dec"].run_te_optimize(params)
        te_samples = [s for s in te["samples"]
                      if s.get("event") == "TE_OPTIMIZE_DEGRADED"]
        check(degraded["degraded"]
              and degraded["backend"] == "cpu-fallback"
              and tc.get("decision.te.fallback_runs") == 1
              and len(te_samples) == 1,
              "decision_drill: the armed TE run was not degraded once")
        refused = refused_launch_drill(drv, cu, cp, te, dbs, flap, params,
                                       inj, dev.type == "cuda")
    finally:
        faults.uninstall()
    launches = paths.read("decision_drill", expect["decision_drill"])
    emit({
        "phase": "decision_drill", "me": me, "nodes": len(dbs),
        "graph": f"fabric_edges({LFA_CLOS_PODS})",
        "armed_events": degraded_events, "trip_counters": trips,
        "breaker_close_s": close_s,
        "probe_successes": cu["dec"].counters.get(
            "decision.spf.probe_successes"),
        "samples": sorted({s.get("event") for s in cu["samples"]}),
        "oom": {"kind": oom_kind, "text": (oom_text or "")[:160]},
        "te": {"graph": f"fabric_edges({TE_CHAIN_PODS})", "params": params,
               "clean_backend": clean["backend"],
               "degraded_backend": degraded["backend"],
               "fallback_runs": tc.get("decision.te.fallback_runs"),
               "degraded_samples": len(te_samples),
               "equal_direct": True},
        "refused_launch": refused,
        "seconds": time.perf_counter() - t0, "launches": launches,
        "card": card,
    })
    drv.stop()
    del cu, cp, te, te_cpu, sup, prim, drv

    # -- decision_mesh ---------------------------------------------------
    t0 = time.perf_counter()
    paths.start()
    dbs = build_adj_dbs(lfa_edges)
    pub0 = lsdb_publication(dbs.values(), announce(dbs))
    drv = DecisionLoop(dev)
    cu = drv.boot("cuda", solver_mesh=make_mesh([dev] * 8, (4, 2)))
    cp = drv.boot("cpu")
    prim = cu["dec"].solver.primary
    counts = []
    for name, pub in (
        ("first", pub0),
        ("main_event", lsdb_publication(
            edited_adj_dbs(dbs, main_event).values())),
    ):
        solves0 = prim.device_solves
        paths.resume()
        got = drv.deliver(cu, pub)
        paths.pause()
        counts.append(same_delta(got, drv.deliver(cp, pub),
                                 f"decision_mesh {name}"))
        decision_clean(cu, f"decision_mesh {name}", solves0)
    solve = prim._solves[("0", me)][1]
    check(solve._dev["kind"] == "tile2d", "decision_mesh: not tiled")
    launches = paths.read("decision_mesh", expect["decision_mesh"])
    check(not drv.raised, f"decision_mesh: the loop saw {drv.raised}")
    drv.stop()
    emit({
        "phase": "decision_mesh", "me": me, "mesh": [4, 2],
        "nodes": len(dbs), "graph": f"fabric_edges({LFA_CLOS_PODS})",
        "deltas": counts, "device_solves": prim.device_solves,
        "halo_bytes": prim.counters.get("decision.spf.halo_bytes"),
        "seconds": time.perf_counter() - t0, "launches": launches,
        "card": card,
    })


class _Measured(Exception):
    """decision_ledger's TE step: raised by the spy in place of
    optimize_weights once the working set is measured, so the service's
    host scoring of the full-width Clos (minutes) is not run."""


def _alloc(dev) -> int:
    """The caching allocator's allocated bytes, after a garbage collection
    (so an earlier step's cyclic garbage is not freed inside a measured
    window) and the card's work."""
    import gc

    import torch

    if dev.type != "cuda":
        return 0
    gc.collect()
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev)


def _area_live(ledger, area: str, exclude=frozenset(),
               skip=("mirror",)) -> dict:
    """Live bytes of one ledger area by structure, less the handles in
    `exclude` (earlier phases' solvers, never closed, may hold entries
    under the same area) and the host mirror (not on the card)."""
    out = {}
    for e in ledger.live_entries(area):
        if e.handle not in exclude and e.structure not in skip:
            out[e.structure] = out.get(e.structure, 0) + e.nbytes
    return out


def _fit_row(dev, ledger, name: str, fit: dict, registered: dict,
             alloc_delta: int) -> dict:
    """One (b) row: predict_fit's bytes, the ledger's registered bytes and
    the caching allocator's change across the first dispatch. The model is
    held to the registered bytes, structure by structure (exact), and on
    the card the registered bytes to the allocator's change (10%)."""
    predicted, reg = fit["predicted_bytes"], sum(registered.values())
    check(reg > 0, f"decision_ledger: {name} registered nothing")
    folded = {}
    for key, nbytes in fit["components"].items():
        key = key.split(".", 1)[0]  # "apsp.d" is the structure "apsp"
        folded[key] = folded.get(key, 0) + nbytes
    check(folded == registered,
          f"decision_ledger: {name} predict_fit {fit['components']} "
          f"against the registered {registered}")
    row = {"layout": name, "predicted_bytes": predicted,
           "registered_bytes": reg, "components": fit["components"],
           "registered": registered,
           "allocated_delta_bytes": alloc_delta if dev.type == "cuda"
           else "not measured"}
    if dev.type == "cuda":
        row["allocated_over_registered"] = alloc_delta / reg
        check(abs(alloc_delta - reg) <= 0.10 * reg,
              f"decision_ledger: {name}: the allocator moved {alloc_delta} "
              f"bytes, the ledger registered {reg}")
    return row


def decision_ledger(dev, card, paths, expect, clos_edges, lfa_edges,
                    apsp_edges) -> None:
    """decision_ledger (see the module docstring): the memory ledger and the
    flight recorder on the card's solver. Every check raises."""
    import gc

    import torch

    from openr_tpu_torch.apsp import ApspState
    from openr_tpu_torch.lsdb import LinkState
    from openr_tpu_torch.monitor.memledger import get_ledger
    from openr_tpu_torch.ops.graph import compile_graph
    from openr_tpu_torch.parallel import make_mesh
    from openr_tpu_torch.solver import SpfSolver
    from openr_tpu_torch.solver.supervisor import CLOSED, OPEN
    from openr_tpu_torch.te import kernels as tk
    from openr_tpu_torch.te import service as te_service
    from openr_tpu_torch.te import TeService
    from openr_tpu_torch.te import optimizer as teopt
    from openr_tpu_torch.testing.decision_harness import lsdb_publication
    from openr_tpu_torch.topology import build_adj_dbs
    from openr_tpu_torch.convert import te_inputs

    me = DECISION_ME
    t0 = time.perf_counter()
    ledger = get_ledger()
    gc.collect()
    # the baseline: what earlier phases' solvers left registered (none of
    # them is closed) and allocated
    base_handles = {e.handle for e in ledger.live_entries()}
    base_live = ledger.live_bytes
    alloc_start = _alloc(dev)
    scratch0 = (len(tk._mlu_scratch),)
    out = {"phase": "decision_ledger", "me": me,
           "baseline": {"handles": len(base_handles),
                        "live_bytes": base_live,
                        "allocated_bytes": alloc_start
                        if dev.type == "cuda" else "not measured"}}

    def announce(dbs):
        return {name: [f"10.{i // 256}.{i % 256}.0/24"]
                for i, name in enumerate(sorted(dbs))}

    main_event = [
        ("fsw0_1", "ssw1_0", {"is_overloaded": True}),
        ("ssw1_0", "fsw0_1", {"is_overloaded": True}),
        ("fsw0_2", "rsw0_5", {"metric": 3}),
        ("rsw0_5", "fsw0_2", {"metric": 3}),
    ]

    def exact(what):
        check(ledger.check(), f"decision_ledger: {what}: registered "
              f"{ledger.registered_bytes} != live {ledger.live_bytes} + "
              f"freed {ledger.freed_bytes}")

    def solve_of(node):
        return node["dec"].solver.primary._solves[("0", me)][1]

    steps = {}
    t_step = time.perf_counter()

    def step_done(name):
        nonlocal t_step
        now = time.perf_counter()
        steps[name] = now - t_step
        t_step = now

    # (a) the phase split, every solve sampled, on the 9,556-node Clos
    dbs = build_adj_dbs(clos_edges)
    pub0 = lsdb_publication(dbs.values(), announce(dbs))
    drv = DecisionLoop(dev)
    cp = drv.boot("cpu")
    alloc0 = _alloc(dev)
    cu = drv.boot("cuda", solver_trace_sample_every=1)
    rec = cu["dec"].solver.recorder
    split = []
    for name, pub in (("first", pub0), ("main_event", lsdb_publication(
            edited_adj_dbs(dbs, main_event).values()))):
        seen = rec.recorded
        paths.resume()
        t = time.perf_counter()
        got = drv.deliver(cu, pub)
        ms = (time.perf_counter() - t) * 1e3
        paths.pause()
        same_delta(got, drv.deliver(cp, pub), f"decision_ledger {name}")
        exact(name)
        traces = [x for x in rec.snapshot() if x["event"] == "solve"]
        check(rec.recorded > seen and traces and traces[-1]["sampled"],
              f"decision_ledger: {name} recorded no sampled solve")
        tr = traces[-1]
        check({"prepare", "h2d", "relax"} <= set(tr["phases"]),
              f"decision_ledger: {name} phases {tr['phases']}")
        split.append({
            "event": name, "publication_to_delta_ms": ms,
            "solve_ms_last": cu["dec"].solver.primary.solve_ms_last,
            "trace_solve_ms": tr["solve_ms"], "phases_ms": tr["phases"],
            "warm": tr["warm"], "rounds": tr["rounds"],
            "delta_columns": tr["delta_columns"],
            "h2d_bytes": tr["h2d_bytes"], "d2h_bytes": tr["d2h_bytes"],
        })
        if name == "first":
            solve = solve_of(cu)
            alloc_sell = _alloc(dev) - alloc0
            fit = ledger.predict_fit(
                solve.graph.n, "sell", n_sources=len(solve.sources),
                graph=solve.graph)
            sell_row = _fit_row(
                dev, ledger, "sell", fit,
                _area_live(ledger, solve._mem_area, base_handles),
                alloc_sell)
            # the patch slots are the layout's capacity, not on the card
            # until an event patches: the allocator's change has no such
            # buffer
            sell_row["not_on_card_yet"] = {"patch": fit["components"][
                "patch"]}
    decision_clean(cu, "decision_ledger (a)", 0)
    out["split"] = split
    out["traces"] = {k: cu["dec"].counters.get(k) for k in (
        "decision.spf.traces_recorded", "decision.spf.traces_sampled",
        "decision.spf.traces_evicted")}
    out["phase_samples"] = {k: v.count for k, v in cu["dec"].histograms.items()
                            if k.startswith("decision.spf.phase.")}
    drv.stop()
    del cu, cp, drv, rec, solve
    gc.collect()
    exact("(a) stopped")
    step_done("a_split")

    # (b) tile2d: decision_mesh's (4, 2) ranks on the 3,956-node Clos
    dbs = build_adj_dbs(lfa_edges)
    pub0 = lsdb_publication(dbs.values(), announce(dbs))
    drv = DecisionLoop(dev)
    alloc0 = _alloc(dev)
    cu = drv.boot("cuda", solver_mesh=make_mesh([dev] * 8, (4, 2)))
    paths.resume()
    drv.deliver(cu, pub0)
    paths.pause()
    exact("tile2d")
    solve = solve_of(cu)
    check(solve._dev["kind"] == "tile2d", "decision_ledger: not tiled")
    fit = ledger.predict_fit(solve.graph.n, "tile2d",
                             n_sources=len(solve.sources), graph=solve.graph,
                             mesh_shape=(4, 2))
    tile_row = _fit_row(dev, ledger, "tile2d", fit,
                        _area_live(ledger, solve._mem_area, base_handles),
                        _alloc(dev) - alloc0)
    decision_clean(cu, "decision_ledger tile2d", 0)
    drv.stop()
    del cu, drv, solve
    gc.collect()

    # (b) apsp: apsp_wan's 4,096 nodes, one cold close
    ag = compile_graph(build_ls(apsp_edges, LinkState, build_adj_dbs))
    alloc0 = _alloc(dev)
    apsp = ApspState(APSP_N, device=dev, area="ledger/apsp")
    paths.resume()
    check(apsp.ensure(ag), "decision_ledger: the all-pairs matrix refused")
    paths.pause()
    exact("apsp")
    apsp_row = _fit_row(dev, ledger, "apsp",
                        ledger.predict_fit(ag.n, "apsp", graph=ag),
                        _area_live(ledger, "ledger/apsp", base_handles),
                        _alloc(dev) - alloc0)
    apsp.close()
    del apsp
    exact("apsp closed")

    # (b) te: te_clos's working set through TeService; the spy measures
    # the upload and one Adam step in place of optimize_weights
    te_ls = build_ls(lfa_edges, LinkState, build_adj_dbs)
    te_g = compile_graph(te_ls)
    spec = te_demand_spec(te_g.names[: te_g.n], TE_DEMANDS, seed=11)
    seen = {}
    real = te_service.optimize_weights

    def spy(src_e, dst_e, up, w0, demands, caps, n, config=None, mesh=None,
            initial_d=None, device="cuda", mem_area=None):
        seen["registered"] = _area_live(ledger, mem_area, base_handles)
        seen["fit"] = ledger.predict_fit(n, "te", n_sources=demands.shape[0],
                                         graph=te_g)
        a0 = _alloc(dev)
        inp = te_inputs(src_e, dst_e, w0, up, demands, caps, dev)
        seen["upload"] = _alloc(dev) - a0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        b = demands.shape[0]
        paths.resume()
        teopt.adam_solve(
            inp["w"], inp["demands"], torch.ones(b, device=dev), inp["caps"],
            inp["graph"], inp["up"], config, max(2, min(n, 128)), 1,
            mem_area=mem_area)
        paths.pause()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            seen["peak"] = torch.cuda.max_memory_allocated(dev) - a0
        raise _Measured()

    te_service.optimize_weights = spy
    try:
        TeService(me, {"0": te_ls}, device=dev).optimize(
            {"demands": spec, "seed": 0, "steps": 1, "rounds": 128})
        check(False, "decision_ledger: the TE spy did not run")
    except _Measured:
        pass
    finally:
        te_service.optimize_weights = real
    check(not _area_live(ledger, "0/te", base_handles),
          "decision_ledger: the TE working set was not released")
    exact("te")
    te_row = _fit_row(dev, ledger, "te", seen["fit"], seen["registered"],
                      seen["upload"])
    te_row["peak_step_bytes"] = seen.get("peak", "not measured")
    if dev.type == "cuda":
        # the reference's model is the scenario batch and the capacities;
        # one step's activations and gradients are not in it
        te_row["peak_over_predicted"] = seen["peak"] / seen["fit"][
            "predicted_bytes"]
    out["fit"] = [sell_row, tile_row, apsp_row, te_row]
    del te_ls, te_g
    step_done("b_tile_apsp_te")

    # (c) the capacity drill: room for the sliced layout's solves (each
    # admission counts the live generation and the next), not for the
    # 4,096 all-pairs matrix; LFA asks for it on a delta event
    g = compile_graph(build_ls(lfa_edges, LinkState, build_adj_dbs))
    sources = 1 + len({b for a, b, _ in lfa_edges if a == me}
                      | {a for a, b, _ in lfa_edges if b == me})
    p_sell = ledger.predict_fit(g.n, "sell", n_sources=sources,
                                graph=g)["predicted_bytes"]
    p_apsp = ledger.predict_fit(g.n, "apsp", graph=g)["predicted_bytes"]
    mirror = 64 * g.n_pad * 4
    cap = ledger.live_bytes + 2 * p_sell + mirror + p_apsp // 2
    check(cap < ledger.live_bytes + p_sell + p_apsp,
          "decision_ledger: no capacity refuses the matrix alone")
    drv = DecisionLoop(dev)
    cp = drv.boot("cpu", compute_lfa_paths=True)
    cu = drv.boot("cuda", compute_lfa_paths=True,
                  solver_mem_capacity_bytes=cap,
                  solver_mem_headroom_frac=0.0)
    paths.resume()
    for name, pub in (("first", pub0), ("event", lsdb_publication(
            edited_adj_dbs(dbs, main_event).values()))):
        same_delta(drv.deliver(cu, pub), drv.deliver(cp, pub),
                   f"decision_ledger drill {name}")
        exact(f"drill {name}")
    paths.pause()
    decision_clean(cu, "decision_ledger drill", 0)
    refused = [x for x in cu["samples"]
               if x.get("event") == "SOLVER_CAPACITY_REFUSED"]
    check([(x.get("layout"), x.get("capacity_source")) for x in refused]
          == [("apsp", "override")],
          f"decision_ledger: drill refusals {refused}")
    others = [x for x in sorted(dbs) if x.startswith("rsw1_")][:1]
    prim = cu["dec"].solver.primary
    for other in others:
        got = cu["dec"].solver.build_route_db(
            other, cu["dec"].area_link_states, cu["dec"].prefix_state)
        want = SpfSolver(other, compute_lfa_paths=True).build_route_db(
            other, cp["dec"].area_link_states, cp["dec"].prefix_state)
        check(got.unicast_entries == want.unicast_entries
              and got.mpls_entries == want.mpls_entries,
              f"decision_ledger: {other}'s route db differs from the CPU's")
    check(prim.host_spf_calls > 0,
          "decision_ledger: no out-of-batch answer came from the host")
    out["drill"] = {
        "graph": f"fabric_edges({LFA_CLOS_PODS})", "capacity_bytes": cap,
        "sell_predicted_bytes": p_sell, "apsp_predicted_bytes": p_apsp,
        "refusals": len(refused),
        "refused_headroom_bytes": refused[0].get("headroom_bytes"),
        "other_nodes": others, "host_spf_calls": prim.host_spf_calls,
        "fallback_active": cu["dec"].counters.get(
            "decision.spf.fallback_active"),
    }
    drv.stop()
    del cu, cp, drv, prim
    step_done("c_drill")

    # (d) the layout refused: a capacity below the sliced layout's model
    drv = DecisionLoop(dev)
    cp = drv.boot("cpu")
    cu = drv.boot("cuda", solver_mem_capacity_bytes=ledger.live_bytes
                  + p_sell // 2, solver_mem_headroom_frac=0.0,
                  solver_failure_threshold=1, solver_max_attempts=1,
                  solver_probe_interval_s=0.05)
    sup = cu["dec"].solver
    alloc0 = _alloc(dev)
    live0 = ledger.live_bytes
    same_delta(drv.deliver(cu, pub0), drv.deliver(cp, pub0),
               "decision_ledger refused layout")
    c = cu["dec"].counters
    refused = [x for x in cu["samples"]
               if x.get("event") == "SOLVER_CAPACITY_REFUSED"]
    # (the breaker's probes, every 0.05 s, are refused alike until the
    # override is lifted, each with its sample)
    check(c.get("decision.spf.solver_failures.device_oom") == 1
          and sup.state == OPEN and c.get("decision.spf.fallback_solves")
          and refused and {x.get("layout") for x in refused} == {"sell"},
          f"decision_ledger: the refused layout gave {sup.state}, {c}")
    alloc1 = _alloc(dev)
    check(ledger.live_bytes == live0 and alloc1 == alloc0,
          f"decision_ledger: the refused layout allocated before raising: "
          f"the ledger {ledger.live_bytes - live0} bytes, the allocator "
          f"{alloc1 - alloc0}")
    exact("refused layout")
    ledger.set_capacity_override(None)
    drv.wait(lambda: sup.state == CLOSED, "probes closing the breaker")
    solves0 = sup.primary.device_solves
    fallback0 = c.get("decision.spf.fallback_solves", 0)
    pub = lsdb_publication(edited_adj_dbs(dbs, main_event).values())
    paths.resume()
    same_delta(drv.deliver(cu, pub), drv.deliver(cp, pub),
               "decision_ledger after the override")
    paths.pause()
    check(sup.primary.device_solves > solves0
          and c.get("decision.spf.fallback_solves", 0) == fallback0
          and c["decision.spf.fallback_active"] == 0,
          "decision_ledger: the card did not serve the event after the "
          "override was lifted")
    exact("override lifted")
    out["refused_layout"] = {
        "device_oom": c.get("decision.spf.solver_failures.device_oom"),
        "refusal_samples": len(refused),
        "refusal": {k: refused[0].get(k) for k in (
            "layout", "capacity_source", "predicted_bytes",
            "headroom_bytes")},
        "allocated_while_refused": 0, "breaker": sup.state,
        "served_by_card_after": True,
    }
    drv.stop()
    del cu, cp, drv, sup
    ledger.set_headroom_frac(0.10)
    ledger.set_capacity_override(None)
    step_done("d_refused_layout")

    # (e) teardown: back to the baseline
    gc.collect()
    left = [(e.area, e.structure, e.nbytes) for e in ledger.live_entries()
            if e.handle not in base_handles]
    check(not left, f"decision_ledger: live after stop {left}")
    check({e.handle for e in ledger.live_entries()} == base_handles,
          "decision_ledger: a baseline entry was released")
    exact("teardown")
    remainder = _alloc(dev) - alloc_start
    named = {}
    if len(tk._mlu_scratch) > scratch0[0]:
        named["te.kernels._mlu_scratch"] = (len(tk._mlu_scratch)
                                            - scratch0[0])
    out["teardown"] = {
        "live_handles_over_baseline": len(left),
        "allocated_remainder_bytes": remainder
        if dev.type == "cuda" else "not measured",
        "named": named,
    }
    check(remainder == 0 or named,
          f"decision_ledger: {remainder} bytes still allocated after stop")
    step_done("e_teardown")
    launches = paths.read("decision_ledger", expect)
    out.update(seconds=time.perf_counter() - t0, seconds_by_step=steps,
               launches=launches, card=card)
    emit(out)


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

    from openr_tpu_torch import convert
    from openr_tpu_torch.apsp import kernels as fw
    from openr_tpu_torch.convert import te_inputs, to_device
    from openr_tpu_torch.lsdb import LinkState, PrefixState
    from openr_tpu_torch.ops import _cuda
    from openr_tpu_torch.ops import spf
    from openr_tpu_torch.ops.graph import (
        INF, _next_bucket, compile_edges, compile_graph,
    )
    from openr_tpu_torch.parallel import make_mesh, tile_graph
    from openr_tpu_torch.parallel.mesh import replicate
    from openr_tpu_torch.solver import (
        CudaSpfSolver, DeltaRouteBuilder, SpfSolver,
    )
    from openr_tpu_torch.te import (
        TeService, build_demand_scenarios, congested_clos_fixture,
        te_edge_arrays,
    )
    from openr_tpu_torch.te import kernels as tk
    from openr_tpu_torch.te import objective as teo
    from openr_tpu_torch.te import optimizer as teopt
    from openr_tpu_torch.topology import (
        build_adj_dbs, fabric_edges, grid_edges, wan_edges,
    )
    from openr_tpu_torch.types import (
        IpPrefix, PrefixDatabase, PrefixEntry, PrefixForwardingAlgorithm,
        PrefixForwardingType,
    )

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

    K1, K2, K3 = _cuda.SELL_RELAX, _cuda.BF_RELAX, _cuda.ECMP_TRIANGLE
    K4, K5, K6, K7 = (
        _cuda.SELL_PATCH, _cuda.SELL_MARK, _cuda.BF_MARK, _cuda.DELTA_EXTRACT
    )
    paths = Launches(_cuda.KERNELS)
    paths.start()
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
    # a spine link down and a rack metric change: weight patches, answered
    # warm from the resident fixpoint through refresh
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
    launches = paths.read("main_path", (K1, K2, K3, K4, K5, K7))
    main_solvers = (*solvers.values(), star)
    host_calls = sum(s.host_spf_calls for s in main_solvers)
    full_solves = sum(
        s.counters.get("decision.spf.full_solves", 0) for s in main_solvers
    )
    warm_solves = sum(
        s.counters.get("decision.spf.incremental_solves", 0)
        for s in main_solvers
    )
    emit({
        "phase": "main_path", "seconds": main_s, "launches": launches,
        "host_spf_calls": host_calls, "full_solves": full_solves,
        "incremental_solves": warm_solves,
        "route_build_ms": route_ms, "device_solve_ms": solve_ms,
        "routes": n_routes,
        "clos_rounds": {
            me: s.counters.get("decision.spf.rounds_last")
            for me, s in solvers.items()
        },
        "clos_invalidation_rounds": {
            me: s.counters.get("decision.spf.invalidation_rounds_last")
            for me, s in solvers.items()
        },
        "card": card,
    })
    check(host_calls == 0, f"{host_calls} SPF answers came from host Dijkstra")
    # two cold Clos solves, the two warm answers to the event, the star cold
    check((full_solves, warm_solves) == (3, 2),
          f"expected 3 full + 2 incremental solves, got {full_solves} + "
          f"{warm_solves}")

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
    per_call1 = launches_a_call(K1, k1)
    check(per_call1 == spf.K1_ROUND_KERNELS
          * spf.round_launches(rounds, wan.n_pad),
          f"K1 launched {per_call1} times a solve, not twice a round for "
          "every bucket in chunks")
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
        "launches": None, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "rounds": rounds,
        "launches_per_call": per_call1, "bound_gathers_ms":
            rounds * gather_bytes / rate * 1e3,
    })
    del d_plain

    # K1 at the product's own batch widths on the 9,556-node Clos: rsw0_0's
    # area solve batches rsw0_0 and its 8 neighbours, padded to 16 with
    # rsw0_0's row; S = 8 takes rsw0_0 and 7 of them
    clos_g = compile_edges(clos_edges)
    me_row = clos_g.node_index["rsw0_0"]
    me_nbrs = np.unique(clos_g.src[: clos_g.e][clos_g.dst[: clos_g.e]
                                               == me_row])
    batch = np.concatenate([[me_row], me_nbrs]).astype(np.int32)
    batch = np.concatenate([batch, np.full(
        _next_bucket(len(batch)) - len(batch), me_row, dtype=np.int32)])
    cst = to_device(clos_g, dev)
    ckey = clos_g.sell.shape_key()
    clos_k1 = {}
    for width in (8, len(batch)):
        src_c = torch.as_tensor(batch[:width], device=dev)

        def k1_clos():
            return spf._sell_solver_counted(
                ckey, src_c, cst["nbrs"], cst["wgs"], cst["ov"])

        def k1_clos_plain():
            d, r = spf._sell_relax_plain(
                spf._sell_d0(src_c, clos_g.n_pad), src_c, cst["ov"],
                cst["nbrs"], cst["wgs"], clos_g.sell.starts)
            return d.t().contiguous(), r

        (dc, rc), (dcp, rcp) = k1_clos(), k1_clos_plain()
        check(torch.equal(dc, dcp) and rc == rcp,
              f"K1 at S = {width} on the Clos differs from its plain version")
        cslots = sum(a.size for a in clos_g.sell.nbr)
        crows = sum(a.shape[0] for a in clos_g.sell.nbr)
        cb_ms, cb_by = bound(
            rc * (4 * width * (clos_g.n + crows) + 8 * cslots
                  + clos_g.n_pad),
            rc * 3 * cslots * width, rate)
        clos_k1[width] = {
            "rounds": rc, "ms": time_ms(k1_clos, reps=9),
            "plain_ms": time_ms(k1_clos_plain, reps=5, warmup=1),
            "bound_ms": cb_ms, "bound_by": cb_by,
            "launches_per_call": launches_a_call(K1, k1_clos),
        }
        check(clos_k1[width]["launches_per_call"] == spf.K1_ROUND_KERNELS
              * spf.round_launches(rc, clos_g.n_pad),
              f"K1 at S = {width} launched other than twice a round in "
              "chunks")
    emit({"phase": "k1_sell_relax_clos",
          "graph": f"fabric_edges({CLOS_PODS})", "me": "rsw0_0",
          "equal_plain": True, "by_width": clos_k1, "card": card})
    del cst, clos_g

    # -- 5. K2 on the same graph -----------------------------------------
    w_row = st["w"][None, :]

    def k2_cold(g_, src_, st_, w_rows_):
        """The cold edge-list solve as `_bf_fixpoint_vw_core` runs it (the
        dest-major cold state, the rounds, D transposed out), with its
        rounds."""
        d, r = spf._bf_relax_dm(
            spf._sell_d0(src_, g_.n_pad), src_, st_["ov"], st_["src"],
            st_["dst"], w_rows_, st_["csr"], cold=True,
        )
        return d.t().contiguous(), r

    def k2():
        return k2_cold(wan, src_t, st, w_row)

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
    check(torch.equal(d_k2, d_k1) and rounds2 == rounds,
          "K2 differs from K1's D or rounds")
    check(torch.equal(d_wan_vw, d_k1), "batched_spf_vw differs from K1's D")
    per_call2 = launches_a_call(K2, k2)
    check(per_call2 == spf.K2_ROUND_KERNELS
          * spf.round_launches(rounds2, wan.n_pad),
          f"K2 launched {per_call2} times a solve, not twice a round in "
          "chunks")
    ms2 = time_ms(k2)
    plain_ms2 = time_ms(k2_plain, reps=5, warmup=1)
    # the transposes, timed alone: D out of K2's layout (a solve's last
    # step) and into it (the first of a warm one or of `_bf_relax`)
    d2_dm = d_k2.t().contiguous()
    transpose2 = {"out_ms": time_ms(lambda: d2_dm.t().contiguous()),
                  "in_ms": time_ms(lambda: spf._dest_major(d_k2))}
    del d2_dm
    # per round: D read and written once, src + w of the real edges, csr, ov
    round_bytes2 = 8 * s_cols * wan.n_pad + 8 * wan.e + 5 * wan.n_pad
    b2_ms, b2_by = bound(
        rounds2 * round_bytes2, rounds2 * 3 * wan.e * s_cols, rate
    )
    # as K1's: every in-edge's gathered row and each row read and written,
    # a round
    gather_bytes2 = 4 * s_cols * (wan.e + 2 * wan.n) + 8 * wan.e
    # K2 cold on the star whose hub is past the sliced layout's cap (the
    # main path's star solver's batch), and its transposes alone
    star_g = compile_edges(star_edges)
    check(star_g.sell is None, "the star has a sliced layout")
    star_st = to_device(star_g, dev)
    star_rows = torch.as_tensor(
        star._solves[("0", "leaf0000")][1]._source_rows(), device=dev)
    star_w = star_st["w"][None, :]

    def k2_star():
        return k2_cold(star_g, star_rows, star_st, star_w)

    def k2_star_plain():
        return spf._bf_relax_plain(
            spf._bf_d0(star_rows, star_g.n_pad), star_rows, star_st["ov"],
            star_st["src"], star_st["dst"], star_w, star_st["csr"])

    (d2s, r2s), (d2sp, r2sp) = k2_star(), k2_star_plain()
    check(torch.equal(d2s, d2sp) and r2s == r2sp,
          "K2 on the star differs from its plain version")
    star2 = {
        "sources": int(star_rows.shape[0]), "n_pad": star_g.n_pad,
        "rounds": r2s, "ms": time_ms(k2_star, reps=9),
        "plain_ms": time_ms(k2_star_plain, reps=5, warmup=1),
        "transpose_ms": time_ms(lambda: d2s.t().contiguous()),
        "launches_per_call": launches_a_call(K2, k2_star),
        "bound_ms": bound(
            r2s * (8 * int(star_rows.shape[0]) * star_g.n_pad
                   + 8 * star_g.e + 5 * star_g.n_pad),
            r2s * 3 * star_g.e * int(star_rows.shape[0]), rate)[0],
    }
    check(star2["launches_per_call"] == spf.K2_ROUND_KERNELS
          * spf.round_launches(r2s, star_g.n_pad),
          "K2 on the star launched other than twice a round in chunks")
    emit({
        "phase": "k2_bf_relax", "graph": f"wan_edges({WAN_N}, 4, 3)",
        "rounds": rounds2, "equal_plain": True, "equal_k1": True,
        "ms": ms2, "plain_ms": plain_ms2, "bound_ms": b2_ms,
        "bound_gathers_ms": rounds2 * gather_bytes2 / rate * 1e3,
        "transpose_ms": transpose2,
        "launches_per_call": per_call2,
        "star": {"graph": f"star({STAR_LEAVES})", **star2},
        "card": card,
    })
    results.append({
        "name": _cuda.BF_RELAX.name, "route": "cuda",
        "source": "openr_tpu_torch/ops/csrc/bf_relax.cu",
        "replaces": _cuda.BF_RELAX.replaces,
        "launches": None, "max_abs_err": err2,
        "ms": ms2, "plain_ms": plain_ms2, "bound_ms": b2_ms,
        "bound_by": b2_by, "library_ms": None, "rounds": rounds2,
        "launches_per_call": per_call2,
        "bound_gathers_ms": rounds2 * gather_bytes2 / rate * 1e3,
        "star_ms": star2["ms"],
    })
    del d_k2, d_k2_plain, st, d2s, d2sp, star_st

    # -- 6. K3 on the grid's all-pairs DAG -------------------------------
    gt = to_device(grid, dev)
    d_all_t = d_all.contiguous()

    dag_k3 = spf.ecmp_triangle(
        d_all_t, gt["src"], gt["dst"], gt["dst"], gt["w"], gt["ov"])
    check(torch.equal(dag_k3, dag), "K3 differs from the main path's DAG")
    a = grid.node_index["g0_0"]
    z = grid.node_index[f"g{grid_side - 1}_{grid_side - 1}"]
    corner = int(d_all[a, z])
    check(corner == 2 * (grid_side - 1), f"corner distance {corner}")
    from_a = torch.as_tensor(grid.src[: grid.e] == a, device=dev)
    first_hops = int(dag[: grid.e][from_a, z].sum())
    check(first_hops == 2, f"corner-to-corner ECMP first hops {first_hops}")
    t3 = ecmp_times(spf, K3, d_all_t, gt["src"], gt["dst"], gt["dst"],
                    gt["w"], gt["ov"])
    check(t3["launches_per_call"] == 1,
          f"K3 launched {t3['launches_per_call']} times a call, not 1")
    e3, n3 = grid.e_pad, grid.n_pad
    b3_bytes, b3_ops, _ = ecmp_bytes(n3, e3, n3)
    b3_ms, b3_by = bound(b3_bytes, b3_ops, rate)
    emit({
        "phase": "k3_ecmp_triangle", "graph": f"grid_edges({grid_side})",
        "edges": e3, "columns": n3, "equal_plain": True,
        "corner_distance": corner, "corner_first_hops": first_hops,
        **t3, "bound_ms": b3_ms, "card": card,
    })
    results.append({
        "name": _cuda.ECMP_TRIANGLE.name, "route": "cuda",
        "source": "openr_tpu_torch/ops/csrc/ecmp_triangle.cu",
        "replaces": _cuda.ECMP_TRIANGLE.replaces,
        "launches": None, "max_abs_err": t3["max_abs_err"],
        "ms": t3["ms"], "plain_ms": t3["plain_ms"], "bound_ms": b3_ms,
        "bound_by": b3_by, "library_ms": None,
        "launches_per_call": t3["launches_per_call"],
        "graph_ms": t3["graph_ms"], "host_ms": t3["host_ms"],
    })
    k3_row = results[-1]  # apsp_wan adds the all-pairs DAG at n_pad 4,096

    # -- 7. event_wan: one LSDB event on the north-star fixpoint ---------
    st = to_device(wan, dev)
    n_e = wan.e
    w_old = wan.w.copy()
    w_new, changed, inc, up_on_dag = wan_event(wan, d_k1, torch, np, INF)
    wan_w_new = w_new  # the same event on the multi-device layouts
    n_inc = int(np.count_nonzero(w_new[changed] > w_old[changed]))
    n_dec = int(np.count_nonzero(w_new[changed] < w_old[changed]))
    idx, vals = spf.sell_patch_arrays(wan.sell, changed, w_new, 64)
    inc_idx, _ = spf.sell_patch_arrays(wan.sell, inc, w_new, 64)
    idx_t = torch.as_tensor(idx, device=dev)
    vals_t = torch.as_tensor(vals, device=dev)
    inc_t = torch.as_tensor(inc_idx, device=dev)
    w_new_t = torch.as_tensor(w_new, device=dev)
    wgs_old = st["wgs"]
    # up-link rows and metrics for the nexthop gather: seven batch rows as
    # neighbours of row 0, padded to eight with INF
    nh_rows = torch.tensor([1, 2, 3, 4, 5, 6, 7, 0], dtype=torch.int32,
                           device=dev)
    nh_ws = torch.tensor([3, 17, 40, 8, 99, 1, 25, INF], dtype=torch.int32,
                         device=dev)
    d_prev = d_k1  # the resident 128-source fixpoint before the event

    def fresh_wgs():
        return (tuple(a.clone() for a in wgs_old),)

    def sell_warm(wgs):
        return spf._sell_solver_warm(
            key, src_t, st["nbrs"], wgs, st["ov"], idx_t, vals_t, inc_t,
            d_prev,
        )

    def bf_warm():
        return spf._bf_solver_warm(
            src_t, st["src"], st["dst"], w_new_t, st["w"], st["ov"], d_prev,
            st["csr"],
        )

    (wgs_run,) = fresh_wgs()
    torch.cuda.synchronize()
    paths.start()
    t0 = time.perf_counter()
    d_w, wgs_w, rounds_w, inv_w, cc_w, num_t = sell_warm(wgs_run)
    num = int(num_t)
    cap = _next_bucket(num, minimum=8)
    cols, dcols, nh = spf._delta_extract(cc_w, d_w, nh_rows, nh_ws, cap=cap)
    d_bf, rounds_bf, inv_bf, cc_bf, num_bf = bf_warm()
    torch.cuda.synchronize()
    event_s = time.perf_counter() - t0
    ev_launches = paths.read("event_wan", (K1, K2, K4, K5, K6, K7))

    # the warm D is the cold fixpoint on the patched weights, on both
    # layouts, and the plain versions' composition gives the same results
    for a, want in zip(wgs_w, wan.sell.patched_wg(w_new[:n_e])):
        check(np.array_equal(a.cpu().numpy(), want),
              "K4 did not leave the buckets at the new weights")
    d_cold, rounds_cold = spf._sell_solver_counted(
        key, src_t, st["nbrs"], wgs_w, st["ov"]
    )
    check(torch.equal(d_w, d_cold),
          "sliced warm D differs from a cold solve on the patched weights")
    check(torch.equal(d_bf, d_w), "edge-list warm D differs from sliced")
    check(torch.equal(cc_bf, cc_w) and int(num_bf) == num,
          "edge-list changed columns differ from sliced")
    plain = sell_warm_plain(spf, key, src_t, st, fresh_wgs()[0], idx_t,
                            vals_t, inc_t, d_prev)
    err_warm = max(max_abs_err(d_w, plain[0]), max_abs_err(cc_w, plain[4]))
    check(err_warm == 0 and (rounds_w, inv_w, num) == plain[1:4],
          f"sliced warm solve differs from its plain version: err "
          f"{err_warm}, (rounds, inv, num) {(rounds_w, inv_w, num)} vs "
          f"{plain[1:4]}")
    check(inv_w >= 1, "the event's increases marked nothing")
    check(len(np.intersect1d(up_on_dag, inc)) >= 16 and n_dec >= 16,
          "the event needs 16 increases on the old DAG and 16 decreases")
    check(int(cc_w.sum()) == num, "num_changed differs from col_changed")
    emit({
        "phase": "event_wan", "graph": f"wan_edges({WAN_N}, 4, 3)",
        "sources": int(src_t.shape[0]), "changed_edges": int(len(changed)),
        "increases": n_inc,
        "increases_on_dag": int(len(np.intersect1d(up_on_dag, inc))),
        "decreases": n_dec, "seconds": event_s, "launches": ev_launches,
        "rounds_warm": rounds_w, "rounds_cold": rounds_cold,
        "inv_rounds": inv_w, "rounds_edge_list": rounds_bf,
        "inv_rounds_edge_list": inv_bf, "num_changed": num, "cap": cap,
        "equal_cold": True, "equal_plain": True, "card": card,
    })

    # -- 8. K4-K7 against their plain versions on that event -------------
    s_rows, n_pad = d_prev.shape
    slots = sum(a.shape[0] * a.shape[1] for a in wan.sell.nbr)

    # K4: the patches into copies of the pre-event buckets
    wk, wp = fresh_wgs()[0], fresh_wgs()[0]
    spf._sell_apply_patches(wk, idx_t, vals_t)
    spf._sell_apply_patches_plain(wp, idx_t, vals_t)
    err4 = max(max_abs_err(a, b) for a, b in zip(wk, wp))
    check(err4 == 0, f"K4 differs from its plain version: {err4}")
    lib_idx = []
    for k, a in enumerate(wk):
        r, j = idx_t[k, :, 0].long(), idx_t[k, :, 1].long()
        ok = r < a.shape[0]
        lib_idx.append(((r[ok], j[ok]), vals_t[k][ok]))

    def index_put():
        for a, (ij, v) in zip(wk, lib_idx):
            a.index_put_(ij, v)

    def k4():
        return spf._sell_apply_patches(wk, idx_t, vals_t)

    per_call4 = launches_a_call(K4, k4)
    check(per_call4 == 1, f"K4 launched {per_call4} times a call, not 1")
    ms4 = time_ms(k4)
    plain_ms4 = time_ms(lambda: spf._sell_apply_patches_plain(
        wp, idx_t, vals_t))
    lib_ms4 = time_ms(index_put)
    n_valid = int(sum(v.numel() for _, v in lib_idx))
    # every patch slot's index pair and value read once, the valid ones
    # written once
    b4_ms, b4_by = bound(12 * idx.shape[0] * idx.shape[1] + 4 * n_valid,
                         2 * n_valid, rate)
    # K5: seed + mark fixpoint + reset, against the OLD buckets
    inv_args = (d_prev, st["nbrs"], wgs_old, inc_t, wan.sell.zero_end,
                wan.sell.starts)

    def k5():
        marks, r = spf._sell_invalidate(*inv_args)
        return marks, r, spf._sell_warm_d0(d_prev, marks, src_t)

    def k5_plain():
        marks = spf._sell_seed_plain(d_prev, st["nbrs"], wgs_old, inc_t,
                                     wan.sell.starts)
        marks, r = spf._sell_mark_fixpoint_plain(
            d_prev, marks, st["nbrs"], wgs_old, wan.sell.starts)
        return marks, r, spf._bf_warm_d0_plain(
            d_prev, marks, src_t).t().contiguous()

    m5, r5, d05 = k5()
    m5p, r5p, d05p = k5_plain()
    m5_bits, m5 = m5, spf.marks_bool(m5, s_rows)  # as the plain's bools
    err5 = max(max_abs_err(m5, m5p), max_abs_err(d05, d05p))
    check(err5 == 0 and r5 == r5p == inv_w,
          f"K5 differs from its plain version: err {err5}, rounds "
          f"{r5} vs {r5p}")
    n_marked = int(m5.sum())
    per_call5 = launches_a_call(K5, k5)
    check(per_call5 == 2 + spf.round_launches(r5, n_pad),
          f"K5 launched {per_call5} times a call, not the seed, a round "
          "for every bucket in chunks and the reset")
    ms5 = time_ms(k5)
    plain_ms5 = time_ms(k5_plain, reps=3, warmup=1)
    # per round: the marks, a bit an entry, read and written once, the
    # buckets read once, a word op a slot and mark word (the tails' new
    # bits ANDed with the slot's on-DAG bits, ORed into the row); the
    # on-DAG test of a slot and column, which no round changes, once; the
    # reset reads D and the marks' bits, writes d0 once, 2 ops an entry
    mark_bytes = s_rows * n_pad / 8
    b5_ms, b5_by = bound(
        r5 * (2 * mark_bytes + 8 * slots) + 8 * s_rows * n_pad + mark_bytes,
        r5 * 2 * slots * spf._mask_words(s_rows) + 2 * slots * s_rows
        + 2 * s_rows * n_pad, rate,
    )
    emit({"phase": "k5_sell_mark", "rounds": r5, "marked": n_marked,
          "equal_plain": True, "ms": ms5, "launches_per_call": per_call5,
          "plain_ms": plain_ms5,
          "bound_ms": b5_ms, "card": card})

    # K6: the same event on the edge-list layout, as the warm solve runs it:
    # d_prev transposed once into K2's layout, the seed and rounds on that
    # copy, the reset in place on it
    bf_args = (d_prev, st["src"], st["dst"], w_new_t, st["w"], st["csr"])

    def k6():
        dp_t = spf._dest_major(d_prev)
        marks, r = spf._bf_invalidate(*bf_args, dp_t=dp_t)
        return marks, r, spf._bf_warm_d0(d_prev, marks, src_t, dp_t=dp_t)

    def k6_plain():
        marks, r = spf._bf_invalidate_plain(*bf_args)
        return marks, r, spf._bf_warm_d0_plain(
            d_prev, marks, src_t).t().contiguous()

    m6, r6, d06 = k6()
    m6p, r6p, d06p = k6_plain()
    err6 = max(max_abs_err(spf.marks_bool(m6, s_rows), m6p),
               max_abs_err(d06, d06p))
    check(err6 == 0 and r6 == r6p == inv_bf,
          f"K6 differs from its plain version: err {err6}, rounds "
          f"{r6} vs {r6p}")
    check(torch.equal(m6, m5_bits), "K6's marks differ from K5's bits")
    check(torch.equal(d06, d05), "K6's d0 differs from K5's")
    per_call6 = launches_a_call(K6, k6)
    check(per_call6 == 2 + spf.K6_ROUND_KERNELS
          * spf.round_launches(r6, n_pad),
          f"K6 launched {per_call6} times a call, not the seed, two a round "
          "in chunks and the reset")
    ms6 = time_ms(k6)
    plain_ms6 = time_ms(k6_plain, reps=3, warmup=1)
    # as K5's: per round, the marks (a bit an entry) read and written once,
    # the real edges' tails and old weights and csr read once, a word op an
    # edge and mark word; the on-DAG test of an edge and column, which no
    # round changes, once; the seed reads the edges' four arrays once; the
    # reset reads D and the marks' bits and writes d0 once, 2 ops an entry
    b6_ms, b6_by = bound(
        r6 * (2 * mark_bytes + 8 * n_e + 4 * n_pad) + 16 * n_e
        + 8 * s_rows * n_pad + mark_bytes,
        r6 * 2 * n_e * spf._mask_words(s_rows) + 2 * n_e * s_rows
        + 2 * s_rows * n_pad, rate,
    )
    emit({"phase": "k6_bf_mark", "rounds": r6, "equal_plain": True,
          "equal_k5_marks": True, "equal_k5_d0": True, "ms": ms6,
          "launches_per_call": per_call6, "plain_ms": plain_ms6,
          "transpose_in_ms": time_ms(lambda: spf._dest_major(d_prev)),
          "bound_ms": b6_ms, "card": card})

    # K7: the changed columns and their extraction
    def k7():
        cc, count = spf.delta_columns(d_w, d_prev)
        return (cc, count, *spf._delta_extract(cc, d_w, nh_rows, nh_ws,
                                               cap=cap))

    def k7_plain():
        cc = (d_w != d_prev).any(dim=0)
        return (cc, cc.sum(dtype=torch.int32),
                *spf._delta_extract_plain(cc, d_w, nh_rows, nh_ws, cap))

    out7, out7p = k7(), k7_plain()
    err7 = max(max_abs_err(a, b) for a, b in zip(out7, out7p))
    check(err7 == 0, f"K7 differs from its plain version: {err7}")
    check(torch.equal(out7[2], cols) and torch.equal(out7[4], nh),
          "K7 differs from the event path's extraction")
    cols_h = cols.cpu().numpy()
    check(bool(np.all(np.diff(cols_h[:num]) > 0))
          and bool(np.all(cols_h[num:] == n_pad)),
          "K7 columns are not ascending and padded with n_pad")
    # the compaction against the one library call that computes it exactly
    # (jnp.nonzero(size=cap, fill_value=n) of the reference), on the same
    # flags: the like-for-like yardstick of K7's compaction stage
    def nonzero7():
        return torch.nonzero_static(cc_w, size=cap, fill_value=n_pad)

    check(torch.equal(nonzero7().flatten().to(torch.int32), cols),
          "K7's columns differ from torch.nonzero_static's")
    per_call7 = launches_a_call(K7, k7)
    check(per_call7 == 3, f"K7 launched {per_call7} times a call, not 3")
    ms7 = time_ms(k7)
    stages7 = {
        "columns_ms": time_ms(lambda: spf.delta_columns(d_w, d_prev)),
        "compact_ms": time_ms(lambda: spf._delta_compact(cc_w, cap)),
        "gather_ms": time_ms(
            lambda: spf._delta_gather(cols, d_w, nh_rows, nh_ws)),
    }
    plain_ms7 = time_ms(k7_plain)
    lib_ms7 = time_ms(nonzero7)
    # the device's share of those times: 10 calls under torch.profiler
    prof7 = profile_window(lambda: [k7() for _ in range(10)])
    prof4 = profile_window(lambda: [k4() for _ in range(10)])
    l_pad = nh_rows.shape[0]
    b7_ms, b7_by = bound(
        8 * s_rows * n_pad + 2 * n_pad + 4
        + 4 * cap * (1 + 2 * s_rows) + l_pad * (8 + cap),
        s_rows * n_pad + n_pad, rate,
    )
    emit({"phase": "k7_delta_extract", "num_changed": num, "cap": cap,
          "equal_plain": True, "equal_nonzero_static": True, "ms": ms7,
          **stages7, "launches_per_call": per_call7,
          "plain_ms": plain_ms7, "nonzero_static_ms": lib_ms7,
          "bound_ms": b7_ms, "profile_10_calls": prof7, "card": card})
    emit({"phase": "k4_sell_apply_patches", "patches": n_valid,
          "buckets": len(wk), "equal_plain": True, "ms": ms4,
          "launches_per_call": per_call4, "plain_ms": plain_ms4,
          "index_put_ms": lib_ms4, "profile_10_calls": prof4, "card": card})

    warm_ms = time_ms(sell_warm, setup=fresh_wgs)
    warm_bf_ms = time_ms(bf_warm)

    # the warm sliced solve's stages, each timed alone on its own inputs:
    # K5 (seed, rounds, reset), K4, K1's warm rounds from K5's d0 on the
    # patched weights, K7's columns
    def k1_warm(d0c):
        return spf._sell_relax(d0c, src_t, st["ov"], st["nbrs"], wgs_w,
                               wan.sell.zero_end, wan.sell.starts)

    d1w, r1w = k1_warm(d05.clone())
    check(torch.equal(d1w.t(), d_w) and r1w == rounds_w,
          "K1's warm rounds from K5's d0 differ from the warm solve")
    del d1w
    split = {
        "k5_ms": ms5, "k4_ms": time_ms(
            lambda w: spf._sell_apply_patches(w, idx_t, vals_t),
            setup=fresh_wgs),
        "k1_warm_ms": time_ms(k1_warm, setup=lambda: (d05.clone(),)),
        "k7_columns_ms": stages7["columns_ms"],
        "k1_warm_launches": launches_a_call(
            K1, k1_warm, setup=lambda: (d05.clone(),)),
    }
    check(split["k1_warm_launches"]
          == spf.K1_ROUND_KERNELS * spf.round_launches(rounds_w, n_pad),
          "K1's warm rounds launched other than twice a round in chunks")
    # the warm edge-list solve's stages, each timed alone: K6 (d_prev into
    # K2's layout, seed, rounds, reset), K2's warm rounds from K6's d0 on the
    # new weights, D out of K2's layout, K7's columns
    def k2_warm(d0c):
        return spf._bf_relax_dm(d0c, src_t, st["ov"], st["src"], st["dst"],
                                w_new_t[None, :], st["csr"])

    d2w, r2w = k2_warm(d06.clone())
    check(torch.equal(d2w.t(), d_bf) and r2w == rounds_bf,
          "K2's warm rounds from K6's d0 differ from the warm solve")
    split_bf = {
        "k6_ms": ms6,
        "k2_warm_ms": time_ms(k2_warm, setup=lambda: (d06.clone(),)),
        "transpose_out_ms": time_ms(lambda: d2w.t().contiguous()),
        "k7_columns_ms": stages7["columns_ms"],
        "k2_warm_launches": launches_a_call(
            K2, k2_warm, setup=lambda: (d06.clone(),)),
    }
    check(split_bf["k2_warm_launches"]
          == spf.K2_ROUND_KERNELS * spf.round_launches(rounds_bf, n_pad),
          "K2's warm rounds launched other than twice a round in chunks")
    del d2w
    emit({"phase": "event_wan_times", "warm_ms": warm_ms,
          "warm_rounds": rounds_w, "cold_ms": ms, "cold_rounds": rounds,
          "warm_split": split,
          "warm_edge_list_ms": warm_bf_ms, "cold_edge_list_ms": ms2,
          "warm_edge_list_rounds": rounds_bf,
          "warm_edge_list_split": split_bf,
          "card": card})
    for name, k, e, m_, pm, lm, bm, bb, lpc in (
        ("sell_patch.cu", K4, err4, ms4, plain_ms4, lib_ms4, b4_ms, b4_by,
         per_call4),
        ("sell_mark.cu", K5, err5, ms5, plain_ms5, None, b5_ms, b5_by,
         per_call5),
        ("bf_mark.cu", K6, err6, ms6, plain_ms6, None, b6_ms, b6_by,
         per_call6),
        ("delta_extract.cu", K7, err7, ms7, plain_ms7, lib_ms7, b7_ms, b7_by,
         per_call7),
    ):
        results.append({
            "name": k.name, "route": "cuda",
            "source": f"openr_tpu_torch/ops/csrc/{name}",
            "replaces": k.replaces, "launches": None, "max_abs_err": e,
            "ms": m_, "plain_ms": pm, "bound_ms": bm, "bound_by": bb,
            "library_ms": lm, "launches_per_call": lpc,
        })
    # K7's library call (nonzero_static) does the compaction stage's work
    results[-1].update(stages7)
    del (st, d_w, d_bf, d_cold, plain, m5p, d05p, m6p, d06p, out7, out7p,
         d05, d06, wk, wp, wgs_w, wgs_run)

    # -- 9. event_clos: DeltaRouteBuilder on the Clos -------------------
    me = "rsw0_0"
    t0 = time.perf_counter()
    paths.start()
    builder = DeltaRouteBuilder(CudaSpfSolver(me, device=dev))
    db, _, used = builder.build(me, {"0": clos_ls[1]}, clos_ps, None)
    paths.pause()  # the full-build solver and the oracle are not counted
    check(not used, "the first delta-builder build must be full")
    solve = builder.solver._solves[("0", me)][1]
    mirror_bytes = solve.d.nbytes
    full_solver = CudaSpfSolver(me, device=dev)
    full_solver.build_route_db(me, {"0": clos_ls[1]}, clos_ps)
    per_event = []
    for name, edits, want_delta in clos_events():
        for a, b, changes in edits:
            edit_adjacency(clos_ls, a, b, **changes)
        d2h0, dbytes0 = solve.d2h_bytes, solve.delta_bytes
        cols0 = solve.delta_columns
        paths.resume()
        t = time.perf_counter()
        db, _, used = builder.build(me, {"0": clos_ls[1]}, clos_ps, db)
        delta_ms = (time.perf_counter() - t) * 1e3
        paths.pause()
        t = time.perf_counter()
        full_db = full_solver.build_route_db(me, {"0": clos_ls[1]}, clos_ps)
        full_ms = (time.perf_counter() - t) * 1e3
        want = SpfSolver(me).build_route_db(me, {"0": clos_ls[0]}, clos_ps)
        for got in (db, full_db):
            check(got.unicast_entries == want.unicast_entries
                  and got.mpls_entries == want.mpls_entries,
                  f"{name}: route db differs from the CPU oracle")
        check(used == want_delta,
              f"{name}: used_delta {used}, expected {want_delta}")
        d2h = solve.d2h_bytes - d2h0
        dbytes = solve.delta_bytes - dbytes0
        ncols = solve.delta_columns - cols0
        if used:
            # the copy-back is the extraction alone, bounded by its bucket
            cap_e = _next_bucket(max(ncols, 1), minimum=8)
            l_pad = _next_bucket(len(solve._nh_link_arrays()[0]), minimum=8)
            check(d2h == dbytes and d2h <= 4 + cap_e * (
                4 + 4 * solve.d.shape[0] + l_pad),
                f"{name}: d2h {d2h} bytes is not O(changes)")
        per_event.append({
            "event": name, "used_delta": used, "delta_ms": delta_ms,
            "full_ms": full_ms, "delta_columns": ncols, "d2h_bytes": d2h,
            "delta_builds": builder.delta_builds,
            "full_builds": builder.full_builds,
            "warm": solve.last_solve_warm,
            "inv_rounds": solve.invalidation_rounds_last,
            "rounds": solve.rounds_last,
        })
    clos_s = time.perf_counter() - t0
    paths.resume()  # drops the last comparison builds' launches
    clos_launches = paths.read("event_clos", (K1, K3, K4, K5, K7))
    check(builder.delta_builds >= 6,
          f"only {builder.delta_builds} delta builds")
    emit({
        "phase": "event_clos", "me": me, "seconds": clos_s,
        "events": per_event, "delta_builds": builder.delta_builds,
        "full_builds": builder.full_builds, "mirror_bytes": mirror_bytes,
        "launches": clos_launches,
        "host_spf_calls": builder.solver.host_spf_calls, "card": card,
    })
    check(builder.solver.host_spf_calls == 0, "host Dijkstra on event_clos")

    # -- 10. star_flap: the solver's edge-list warm path -----------------
    paths.start()
    edit_adjacency(star_ls, "hub", "leaf0003", metric=9)
    edit_adjacency(star_ls, "leaf0003", "hub", metric=9)
    route_build(star, SpfSolver("leaf0000"), star_ls, star_ps, "leaf0000")
    torch.cuda.synchronize()
    star_launches = paths.read("star_flap", (K2, K6, K7))
    star_solve = star._solves[("0", "leaf0000")][1]
    check(star_solve.graph.sell is None and star_solve.last_solve_warm,
          "the star flap did not ride the edge-list warm path")
    check(star.host_spf_calls == 0, "host Dijkstra on the star")
    emit({"phase": "star_flap", "launches": star_launches,
          "rounds": star_solve.rounds_last,
          "inv_rounds": star_solve.invalidation_rounds_last,
          "delta_columns": star_solve.delta_columns,
          "route_build_ms": route_ms[-1], "solve_ms": solve_ms[-1],
          "card": card})

    # -- 11. ksp_wan: KSP2 on BASELINE config 4 ---------------------------
    K8, K9 = _cuda.SELL_MASK, _cuda.SELL_RELAX_MASKED
    ksp_algo = dict(
        forwarding_type=PrefixForwardingType.SR_MPLS,
        forwarding_algorithm=PrefixForwardingAlgorithm.KSP2_ED_ECMP,
    )

    class KspRecorder(SpfSolver):
        """The CPU oracle, recording the destinations of each k = 2
        prefetch of its route builds (a no-op hook on the host)."""

        def __init__(self, me):
            super().__init__(me)
            self.k2_dests = []

        def _prefetch_kth_paths(self, link_state, src, dests, k):
            if k == 2:
                self.k2_dests.append(list(dests))

        def device_batches(self) -> int:
            """k = 2 prefetches with a destination not traced before in
            the build: one device batch each on the card."""
            seen, n = {self.my_node_name}, 0
            for dests in self.k2_dests:
                n += any(d not in seen for d in dests)
                seen.update(dests)
            return n

    class TimedKsp(CudaSpfSolver):
        """CudaSpfSolver timing its k = 2 prefetches: the masked device
        solve (its round loop reads the round state once a chunk of 8
        rounds, and the copy-back waits for the last, so the wall time
        covers the device work), the copy-back and the host trace."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.k2_ms = []

        def _prefetch_kth_paths(self, link_state, src, dests, k):
            t = time.perf_counter()
            super()._prefetch_kth_paths(link_state, src, dests, k)
            if k == 2:
                self.k2_ms.append((time.perf_counter() - t) * 1e3)

    t0 = time.perf_counter()
    ksp_edges = wan_edges(KSP_WAN_N, degree=4, seed=5)
    kg = compile_edges(ksp_edges)
    check(kg.sell is not None, "the KSP WAN must have the sliced layout")
    me_row = kg.node_index["w0"]
    mine = np.nonzero((kg.src == me_row) & (kg.w < INF))[0]
    deg = len(mine)
    k_rows = 15
    # the bench's batch (benchmarks/scale_bench.py bench_wan_ksp): me, its
    # neighbours, and 15 me rows each masking 8 edges drawn by
    # default_rng(11)
    ksp_src = np.concatenate([
        [me_row], kg.dst[mine], np.full(k_rows, me_row),
    ]).astype(np.int32)
    s_k = len(ksp_src)
    rng = np.random.default_rng(11)
    positions = [[] for _ in range(1 + deg)] + [
        list(rng.choice(kg.e, size=8, replace=False)) for _ in range(k_rows)
    ]
    masks_h = spf.sell_mask_arrays(kg.sell, positions)
    kst = to_device(kg, dev)
    knb, kwg, kov = kst["nbrs"], kst["wgs"], kst["ov"]
    ksrc = torch.as_tensor(ksp_src, device=dev)
    # one upload of every bucket's entries, as sell_fixpoint_masked does
    kpacked, koffsets = spf.sell_mask_packed(kg.sell, positions)
    kmasks = spf.mask_views(torch.as_tensor(kpacked, device=dev), koffsets)
    kkey = kg.sell.shape_key()
    kstarts = kg.sell.starts
    # the unpenalized base fixpoint of the batch (me's base row in the 16
    # me rows): the warm solve's d_prev
    base, base_rounds = spf._sell_solver_counted(kkey, ksrc, knb, kwg, kov)

    # K8: the bit masks and the warm seed against their plain versions
    def k8():
        return (spf._sell_mask_bits(kmasks, knb, s_k),
                *spf._sell_mask_seed(base, knb, kwg, kmasks, kstarts))

    def k8_plain():
        marks = spf._sell_mask_seed_plain(base, knb, kwg, kmasks, kstarts)
        return (tuple(spf._sell_mask_bits_plain(m, *nb.shape, s_k)
                      for m, nb in zip(kmasks, knb)),
                marks, bool(marks.any()))

    bits, marks8, seeded = k8()
    bits_p, marks8_p, seeded_p = k8_plain()
    err8 = max(max(max_abs_err(a, b) for a, b in zip(bits, bits_p)),
               max_abs_err(marks8, marks8_p))
    check(err8 == 0 and seeded == seeded_p,
          f"K8 differs from its plain version: err {err8}")
    check(seeded, "no masked edge lies on the base DAG: nothing to seed")
    # the library's form of the build: index_put_ of the valid entries into
    # the expanded [nk, dk, S] weights; it must equal the bit mask's
    lib_full, lib_idx = [], []
    for m, nb, wg_k in zip(kmasks, knb, kwg):
        nk, dk = nb.shape
        r, j, c = m[:, 0].long(), m[:, 1].long(), m[:, 2].long()
        ok = (r < nk) & (j < dk) & (c < s_k)
        lib_idx.append((r[ok], j[ok], c[ok]))
        lib_full.append(wg_k[:, :, None].expand(nk, dk, s_k).contiguous())
    inf_t = torch.tensor(INF, dtype=torch.int32, device=dev)

    def index_put8():
        for full, ij in zip(lib_full, lib_idx):
            full.index_put_(ij, inf_t)

    index_put8()
    wv_p = spf._sell_masked_wgs_plain(kwg, bits_p, s_k)
    check(all(torch.equal(a, b) for a, b in zip(lib_full, wv_p)),
          "K8's bit mask differs from index_put_'s expanded weights")

    # K9: the masked relaxation from the cold state
    d0k = spf._sell_d0(ksrc, kg.n_pad)

    def k9(d0c):
        return spf._sell_relax(d0c, ksrc, kov, knb, kwg, kg.sell.zero_end,
                               kstarts, bits, cold=True)

    def k9_plain(d0c):
        return spf._sell_relax_plain(d0c, ksrc, kov, knb, wv_p, kstarts)

    def fresh_d0():
        return (d0k.clone(),)

    d9, r9 = k9(*fresh_d0())
    d9p, r9p = k9_plain(*fresh_d0())
    err9 = max_abs_err(d9, d9p)
    check(err9 == 0 and r9 == r9p,
          f"K9 differs from its plain version: err {err9}, rounds {r9} vs "
          f"{r9p}")
    del d9p

    # the masked solvers: cold (K8 build, K9) and warm (K8 build + seed,
    # K5 rounds and reset, K9), against each other and the plain warm
    def cold_vw():
        return spf._sell_solver_vw(kkey, ksrc, knb, kwg, kmasks, kov)

    def warm_vw():
        return spf._sell_solver_vw_warm(kkey, ksrc, knb, kwg, kmasks, kov,
                                        base)

    def warm_vw_plain():
        m = spf._sell_mask_seed_plain(base, knb, kwg, kmasks, kstarts)
        m, inv = spf._sell_mark_fixpoint_plain(
            base, m, knb, kwg, kstarts) if bool(m.any()) else (m, 0)
        d0w = spf._bf_warm_d0_plain(base, m, ksrc).t().contiguous()
        d, r = spf._sell_relax_plain(d0w, ksrc, kov, knb, wv_p, kstarts)
        return d.t().contiguous(), r, inv

    d_cold = cold_vw()
    d_warm = warm_vw()
    d_warm_p, warm_rounds, warm_inv = warm_vw_plain()
    check(torch.equal(d_cold, d9.t()), "cold masked solve differs from K9")
    check(torch.equal(d_warm, d_warm_p),
          "warm masked solve differs from its plain version")
    check(torch.equal(d_warm, d_cold), "warm masked solve differs from cold")
    check(torch.equal(d_cold[: 1 + deg], base[: 1 + deg]),
          "an unmasked row differs from the base solve")
    check(bool((d_cold[1 + deg:] >= base[1 + deg:]).all())
          and not torch.equal(d_cold[1 + deg:], base[1 + deg:]),
          "masking must raise distances, and did not move any")
    del d_warm_p, d9
    ksp_inputs_s = time.perf_counter() - t0

    per_call8 = launches_a_call(K8, k8)
    check(per_call8 == 2,
          f"K8 launched {per_call8} times for a build and a seed, not 2")
    ms8 = time_ms(k8)
    stages8 = {
        "build_ms": time_ms(lambda: spf._sell_mask_bits(kmasks, knb, s_k)),
        "seed_ms": time_ms(lambda: spf._sell_mask_seed(
            base, knb, kwg, kmasks, kstarts)),
    }
    plain_ms8 = time_ms(k8_plain, reps=5, warmup=1)
    lib_ms8 = time_ms(index_put8)
    prof8 = profile_window(lambda: [k8() for _ in range(10)])
    per_call9 = launches_a_call(K9, k9, setup=fresh_d0)
    check(per_call9 == spf.K1_ROUND_KERNELS * spf.round_launches(
              r9, kg.n_pad),
          f"K9 launched {per_call9} times a solve, not two a round in "
          f"chunks of {spf.ROUND_CHUNK} rounds")
    ms9 = time_ms(k9, setup=fresh_d0)
    prof9 = profile_window(lambda: k9(d0k.clone()))
    plain_ms9 = time_ms(k9_plain, setup=fresh_d0, reps=3, warmup=1)
    cold_vw_ms = time_ms(cold_vw)
    warm_vw_ms = time_ms(warm_vw)
    base_ms = time_ms(lambda: spf._sell_solver_counted(
        kkey, ksrc, knb, kwg, kov))
    m_total = sum(m.shape[0] for m in masks_h)
    m_valid = int(sum(np.count_nonzero(m[:, 0] < nb.shape[0])
                      for m, nb in zip(masks_h, kg.sell.nbr)))
    words = spf._mask_words(s_k)
    kslots = sum(a.shape[0] * a.shape[1] for a in kg.sell.nbr)
    krows = sum(a.shape[0] for a in kg.sell.nbr)
    # K8: each entry read by both entries; the bit masks and the marks
    # written once; the seed gathers two distances and one slot's nbr and
    # weight per valid entry
    b8_ms, b8_by = bound(
        2 * 12 * m_total + 4 * kslots * words + s_k * kg.n_pad
        + 16 * m_valid, 4 * m_valid, rate,
    )
    # K9 per round: K1's bytes plus the mask words of every slot
    k9_round_bytes = (4 * s_k * (kg.n + krows) + 8 * kslots + kg.n_pad
                      + 4 * kslots * words)
    b9_ms, b9_by = bound(r9 * k9_round_bytes, r9 * 3 * kslots * s_k, rate)
    emit({
        "phase": "k8_k9_ksp_wan", "graph": f"wan_edges({KSP_WAN_N}, 4, 5)",
        "n": kg.n, "n_pad": kg.n_pad, "e": kg.e,
        "buckets": [list(a.shape) for a in kg.sell.nbr],
        "batch": s_k, "neighbours": deg, "masked_rows": k_rows,
        "mask_entries": m_valid, "mask_words": words,
        "marked": int(marks8.sum()), "equal_plain": True,
        "equal_index_put": True, "warm_equals_cold": True,
        "base_rounds": base_rounds, "masked_rounds": r9,
        "warm_rounds": warm_rounds, "warm_inv_rounds": warm_inv,
        "k8_ms": ms8, "k8_build_ms": stages8["build_ms"],
        "k8_seed_ms": stages8["seed_ms"], "k8_launches_per_call": per_call8,
        "k8_profile_10_calls": prof8,
        "k8_plain_ms": plain_ms8, "k8_index_put_ms": lib_ms8,
        "k8_bound_ms": b8_ms, "k9_ms": ms9, "k9_plain_ms": plain_ms9,
        "k9_bound_ms": b9_ms, "k9_profile_1_call": prof9,
        "cold_masked_solve_ms": cold_vw_ms,
        "warm_masked_solve_ms": warm_vw_ms, "base_solve_ms": base_ms,
        "seconds": ksp_inputs_s, "card": card,
    })
    results.append({
        "name": K8.name, "route": "cuda",
        "source": "openr_tpu_torch/ops/csrc/sell_mask.cu",
        "replaces": K8.replaces, "launches": None, "max_abs_err": err8,
        "ms": ms8, "plain_ms": plain_ms8, "bound_ms": b8_ms,
        "bound_by": b8_by, "library_ms": lib_ms8,  # index_put_: the build's
        **stages8, "launches_per_call": per_call8,
    })
    results.append({
        "name": K9.name, "route": "cuda",
        "source": "openr_tpu_torch/ops/csrc/sell_relax.cu",
        "replaces": K9.replaces, "launches": None, "max_abs_err": err9,
        "ms": ms9, "plain_ms": plain_ms9, "bound_ms": b9_ms,
        "bound_by": b9_by, "library_ms": None, "rounds": r9,
        "launches_per_call": per_call9,
    })
    del (kst, knb, kwg, kov, base, d_cold, d_warm, bits, bits_p, wv_p,
         lib_full)

    # through the solver: 16 SR-MPLS KSP2 prefixes, 12 single-node and 4
    # anycast over 2 nodes, at 20 nodes drawn by default_rng(11)
    t0 = time.perf_counter()
    ksp_ls = build_ls(ksp_edges, LinkState, build_adj_dbs)
    others = sorted(n for n in ksp_ls.node_names() if n != "w0")
    picked = list(np.random.default_rng(11).choice(others, size=20,
                                                   replace=False))
    groups = [[n] for n in picked[:12]] + [
        picked[12 + 2 * i: 14 + 2 * i] for i in range(4)
    ]
    ksp_ps = PrefixState()
    for i, nodes in enumerate(groups):
        for node in nodes:
            ksp_ps.update_prefix_database(PrefixDatabase(node, [PrefixEntry(
                IpPrefix(f"10.250.{i}.0/24"), **ksp_algo)], area="0"))
    ls_s = time.perf_counter() - t0

    def ksp_build(solver, ls, ps, me):
        """(route db, build ms, solve ms, ms in the k = 2 prefetches)."""
        n0 = len(solver.k2_ms)
        t = time.perf_counter()
        db = solver.build_route_db(me, {"0": ls}, ps)
        ms_ = (time.perf_counter() - t) * 1e3
        return db, ms_, solver.solve_ms_last, sum(solver.k2_ms[n0:])

    def ksp_oracle(ls, ps, me, got_dbs, what, n_prefixes):
        """The CPU oracle's route db, which every db of got_dbs must equal,
        with a route for each prefix: (device batches expected, seconds)."""
        t = time.perf_counter()
        oracle = KspRecorder(me)
        want = oracle.build_route_db(me, {"0": ls}, ps)
        for got in got_dbs:
            check(got.unicast_entries == want.unicast_entries
                  and got.mpls_entries == want.mpls_entries,
                  f"{what}: KSP2 route db differs from the CPU oracle")
        check(len(want.unicast_entries) == n_prefixes,
              f"{what}: {len(want.unicast_entries)} routes for "
              f"{n_prefixes} prefixes")
        return oracle.device_batches(), time.perf_counter() - t

    paths.start()
    warm_solver = TimedKsp("w0", device=dev, warm_start=True)
    db_w, ms_w, solve_w, k2_w = ksp_build(warm_solver, ksp_ls, ksp_ps, "w0")
    paths.pause()
    batches1, oracle1_s = ksp_oracle(ksp_ls, ksp_ps, "w0", [db_w], "warm",
                                     len(groups))
    paths.resume()
    cold_solver = TimedKsp("w0", device=dev, warm_start=False)
    db_c, ms_c, solve_c, k2_c = ksp_build(cold_solver, ksp_ls, ksp_ps, "w0")
    paths.pause()
    check(db_c.unicast_entries == db_w.unicast_entries
          and db_c.mpls_entries == db_w.mpls_entries,
          "cold KSP2 route db differs from the warm one")
    # a link in the middle of a first path of the first destination goes
    # down; the warm solver answers the event and traces anew
    wsolve = warm_solver._solves[("0", "w0")][1]
    first = wsolve.kth_paths(groups[0][0], 1)[0]
    down = first[len(first) // 2]
    edit_adjacency([ksp_ls], down.n1, down.n2, is_overloaded=True)
    edit_adjacency([ksp_ls], down.n2, down.n1, is_overloaded=True)
    paths.resume()
    db_d, ms_d, solve_d, k2_d = ksp_build(warm_solver, ksp_ls, ksp_ps, "w0")
    torch.cuda.synchronize()
    ksp_launches = paths.read("ksp_wan", (K1, K5, K8, K9))
    batches2, oracle2_s = ksp_oracle(ksp_ls, ksp_ps, "w0", [db_d],
                                     "link down", len(groups))
    check(all(down not in p for p in wsolve.kth_paths(groups[0][0], 1)),
          "the KSP cache kept a path over the down link")
    csolve = cold_solver._solves[("0", "w0")][1]
    host_calls = warm_solver.host_spf_calls + cold_solver.host_spf_calls
    check(host_calls == 0, f"{host_calls} KSP answers from host Dijkstra")
    check(wsolve.ksp_warm_batches > 0 and csolve.ksp_warm_batches == 0,
          f"ksp_warm_batches warm {wsolve.ksp_warm_batches}, cold "
          f"{csolve.ksp_warm_batches}")
    check(wsolve.ksp_device_batches == batches1 + batches2
          and csolve.ksp_device_batches == batches1,
          f"KSP device batches warm {wsolve.ksp_device_batches}, cold "
          f"{csolve.ksp_device_batches}; expected {batches1} + {batches2} "
          f"and {batches1}")
    emit({
        "phase": "ksp_wan", "graph": f"wan_edges({KSP_WAN_N}, 4, 5)",
        "me": "w0", "prefixes": len(groups),
        "destinations": sum(len(g_) for g_ in groups),
        "routes": len(db_w.unicast_entries),
        "mpls_routes": len(db_w.mpls_entries),
        "route_build_ms": {"warm": ms_w, "cold": ms_c, "link_down": ms_d},
        "solve_ms": {"warm": solve_w, "cold": solve_c, "link_down": solve_d},
        "k2_prefetch_ms": {"warm": k2_w, "cold": k2_c, "link_down": k2_d},
        "k2_prefetches": {"warm": len(warm_solver.k2_ms),
                          "cold": len(cold_solver.k2_ms)},
        "ksp_device_batches": {"warm": wsolve.ksp_device_batches,
                               "cold": csolve.ksp_device_batches},
        "ksp_warm_batches": {"warm": wsolve.ksp_warm_batches,
                             "cold": csolve.ksp_warm_batches},
        "down_link": [down.n1, down.n2], "host_spf_calls": host_calls,
        "launches": {k.name: ksp_launches[k.name] for k in (K1, K5, K8, K9)},
        "oracle_seconds": oracle1_s + oracle2_s, "linkstate_seconds": ls_s,
        "card": card,
    })
    del warm_solver, cold_solver, wsolve, csolve, ksp_ls

    # -- 12. ksp_star: KSP2 on the edge-list layout ----------------------
    leaves = [f"leaf{i:04d}" for i in range(KSP_STAR_LEAVES)]
    ring_edges = [("hub", leaf, 1 + i % 7) for i, leaf in enumerate(leaves)]
    ring_edges += [(leaves[i], leaves[(i + 1) % len(leaves)], 1 + i % 5)
                   for i in range(len(leaves))]
    ring_ls = build_ls(ring_edges, LinkState, build_adj_dbs)
    ring_dests = list(np.random.default_rng(11).choice(
        leaves[1:], size=8, replace=False))
    ring_ps = PrefixState()
    for i, node in enumerate(ring_dests):
        ring_ps.update_prefix_database(PrefixDatabase(node, [PrefixEntry(
            IpPrefix(f"10.251.{i}.0/24"), **ksp_algo)], area="0"))
    paths.start()
    ring_warm = TimedKsp("leaf0000", device=dev, warm_start=True)
    dbr_w, msr_w, _, k2r_w = ksp_build(ring_warm, ring_ls, ring_ps,
                                       "leaf0000")
    ring_cold = TimedKsp("leaf0000", device=dev, warm_start=False)
    dbr_c, msr_c, _, k2r_c = ksp_build(ring_cold, ring_ls, ring_ps,
                                       "leaf0000")
    torch.cuda.synchronize()
    ring_launches = paths.read("ksp_star", (K2, K6))
    ring_batches, _ = ksp_oracle(ring_ls, ring_ps, "leaf0000",
                                 [dbr_w, dbr_c], "star ring", len(ring_dests))
    rsolve = ring_warm._solves[("0", "leaf0000")][1]
    rcold = ring_cold._solves[("0", "leaf0000")][1]
    check(rsolve.graph.sell is None, "the star ring has a sliced layout")
    check(rsolve.ksp_warm_batches == rsolve.ksp_device_batches
          == rcold.ksp_device_batches == ring_batches > 0
          and rcold.ksp_warm_batches == 0,
          "star ring KSP batches: warm "
          f"{rsolve.ksp_warm_batches}/{rsolve.ksp_device_batches}, cold "
          f"{rcold.ksp_warm_batches}/{rcold.ksp_device_batches}, expected "
          f"{ring_batches}")
    check(ring_warm.host_spf_calls + ring_cold.host_spf_calls == 0,
          "host Dijkstra on the star ring")

    # K6's per-row seed: all 8 destinations' first-path links masked, one
    # row each, against me's base row (the solver's form, one batch)
    rg, rst = rsolve.graph, rsolve._dev
    w_rows = np.tile(rg.w, (len(ring_dests), 1))
    for row, dest in enumerate(ring_dests):
        for path in rsolve.kth_paths(dest, 1):
            for link in path:
                w_rows[row, list(rg.link_edges[link])] = INF
    w_rows_t = torch.as_tensor(w_rows, device=dev)
    ring_src = torch.full((len(ring_dests),), rg.node_index["leaf0000"],
                          dtype=torch.int32, device=dev)
    d_base = rsolve._d_dev[0:1].expand(len(ring_dests), -1).contiguous()
    seed_args = (d_base, rst["src"], rst["dst"], w_rows_t, rst["w"],
                 rst["csr"])
    m6r, r6r = spf._bf_invalidate(*seed_args)
    m6rp, r6rp = spf._bf_invalidate_plain(*seed_args)
    err6r = max_abs_err(spf.marks_bool(m6r, len(ring_dests)), m6rp)
    check(err6r == 0 and r6r == r6rp and r6r >= 1,
          f"K6's per-row seed differs from its plain version: err {err6r}, "
          f"rounds {r6r} vs {r6rp}")
    d_vw, rounds_vw, inv_vw = spf._bf_warm_vw_core(
        ring_src, rst["src"], rst["dst"], w_rows_t, rst["w"], rst["ov"],
        d_base, rst["csr"])
    d_vw_cold = spf.batched_spf_vw(rg, ring_src.cpu().numpy(), w_rows,
                                   device=dev)
    check(torch.equal(d_vw, d_vw_cold),
          "edge-list warm per-row solve differs from the cold one")
    ms6r = time_ms(lambda: spf._bf_invalidate(*seed_args))
    plain_ms6r = time_ms(lambda: spf._bf_invalidate_plain(*seed_args),
                         reps=3, warmup=1)
    s6, n6, e6 = len(ring_dests), rg.n_pad, rg.e
    # as K6's on event_wan: marks as bits, the on-DAG test once; the seed
    # reads D, the per-row weights and the edges' three arrays once
    mb6 = s6 * n6 / 8
    b6r_ms, _ = bound(
        4 * s6 * n6 + 4 * s6 * e6 + 12 * e6 + mb6
        + r6r * (2 * mb6 + 8 * e6 + 4 * n6),
        r6r * 2 * e6 * spf._mask_words(s6) + 2 * e6 * s6, rate,
    )
    # K2 with per-row weights: the cold per-row solve of those rows, with
    # the weights' transpose into K2's form and D's out, timed alone too
    def k2_rows():
        return k2_cold(rg, ring_src, rst, w_rows_t)

    def k2_rows_plain():
        return spf._bf_relax_plain(
            spf._bf_d0(ring_src, n6), ring_src, rst["ov"], rst["src"],
            rst["dst"], w_rows_t, rst["csr"])

    (d2r, r2r), (d2rp, r2rp) = k2_rows(), k2_rows_plain()
    check(torch.equal(d2r, d2rp) and r2r == r2rp and torch.equal(
        d2r, d_vw_cold), "K2 with per-row weights differs from its plain "
          "version")
    d2r_dm = d2r.t().contiguous()
    k2_rows_t = {
        "rows": s6, "rounds": r2r, "ms": time_ms(k2_rows, reps=9),
        "plain_ms": time_ms(k2_rows_plain, reps=5, warmup=1),
        "weights_transpose_ms": time_ms(
            lambda: spf._bf_weights_t(w_rows_t)),
        "d_transpose_out_ms": time_ms(lambda: d2r_dm.t().contiguous()),
        "launches_per_call": launches_a_call(K2, k2_rows),
        "bound_ms": bound(
            r2r * (8 * s6 * n6 + 4 * s6 * e6 + 4 * e6 + 5 * n6),
            r2r * 3 * e6 * s6, rate)[0],
    }
    check(k2_rows_t["launches_per_call"] == spf.K2_ROUND_KERNELS
          * spf.round_launches(r2r, n6),
          "K2 with per-row weights launched other than twice a round in "
          "chunks")
    del d2r, d2rp, d2r_dm
    emit({
        "phase": "ksp_star", "leaves": KSP_STAR_LEAVES, "me": "leaf0000",
        "prefixes": len(ring_dests), "launches": ring_launches,
        "route_build_ms": {"warm": msr_w, "cold": msr_c},
        "k2_prefetch_ms": {"warm": k2r_w, "cold": k2r_c},
        "ksp_device_batches": rsolve.ksp_device_batches,
        "k6_per_row_seed": {
            "rows": s6, "inv_rounds": r6r, "equal_plain": True,
            "ms": ms6r, "plain_ms": plain_ms6r, "bound_ms": b6r_ms,
            "warm_rounds": rounds_vw, "warm_inv_rounds": inv_vw,
            "warm_equals_cold": True,
        },
        "k2_per_row": k2_rows_t,
        "card": card,
    })

    # -- 13. apsp_wan: the resident all-pairs matrix at the cap -----------
    K11, K12, K13 = _cuda.FW_CLOSE, _cuda.FW_SEED, _cuda.FW_RECLOSE
    t0 = time.perf_counter()
    apsp_edges = wan_edges(APSP_N, degree=4, seed=7)
    ag = compile_edges(apsp_edges)
    n_a = ag.n_pad
    nb_a, bsz_a = fw.fw_block_shape(n_a)
    check(ag.n == APSP_N and n_a == APSP_N, f"APSP WAN n {ag.n}, n_pad {n_a}")
    rng = np.random.default_rng(7)

    def dense(g):
        return (
            torch.as_tensor(fw.build_weight_matrix(g), device=dev),
            torch.as_tensor(fw.build_allow_matrix(g.overloaded), device=dev),
        )

    # the cold close K11, against its plain version and K1's solve of every
    # source (the bench's crossover comparison), without and with 16
    # overloaded nodes
    ov_nodes = set(rng.choice(ag.names[: ag.n], size=16, replace=False))
    ag_ov = compile_edges(apsp_edges, ov_nodes)
    check(int(ag_ov.overloaded.sum()) == 16, "16 overloaded nodes")
    err11, cold_checks, closed = 0, {}, []
    for label, g in (("open", ag), ("overloaded_16", ag_ov)):
        w_t, allow_t = dense(g)
        d_k, probe_k = fw.fw_close(w_t, allow_t)
        d_p, probe_p = fw._fw_close_plain(w_t, allow_t)
        err = max_abs_err(d_k, d_p)
        check(err == 0 and int(probe_k) == int(probe_p),
              f"K11 ({label}) differs from its plain version: {err}")
        err11 = max(err11, err)
        d_b = spf.batched_spf(g, np.arange(g.n, dtype=np.int32), device=dev)
        check(torch.equal(d_k[: g.n], d_b),
              f"K11 ({label}) differs from K1's all-sources solve")
        cold_checks[label] = {
            "unreachable": int((d_k[: g.n, : g.n] >= INF).sum()),
            "max_finite": int(d_k[d_k < INF].max()),
        }
        closed.append(d_k)
        del d_p, d_b
    # the transit mask matters at full width: overloaded nodes relay
    # nothing, so some distances rise and none falls
    raised = int((closed[1] > closed[0]).sum())
    check(raised > 0 and bool((closed[1] >= closed[0]).all()),
          f"16 overloaded nodes raised {raised} distances")
    cold_checks["overloaded_16"]["raised"] = raised
    del closed, d_k
    kernel_checks_s = time.perf_counter() - t0

    # the solver: route dbs from 8 other perspectives, then four events
    t0 = time.perf_counter()
    apsp_ls = [build_ls(apsp_edges, LinkState, build_adj_dbs) for _ in "ab"]
    a_names = sorted(apsp_ls[0].node_names())
    apsp_ps = PrefixState()
    for i, node in enumerate(sorted(rng.choice(a_names, size=256,
                                               replace=False))):
        apsp_ps.update_prefix_database(PrefixDatabase(
            node, [PrefixEntry(IpPrefix(f"10.240.{i}.0/24"))], area="0"))
    others = list(rng.choice([x for x in a_names if x != "w0"], size=8,
                             replace=False))
    apsp_setup_s = time.perf_counter() - t0

    def apsp_oracle(other, got, what):
        want = SpfSolver(other, compute_lfa_paths=True).build_route_db(
            other, {"0": apsp_ls[0]}, apsp_ps)
        check(got.unicast_entries == want.unicast_entries
              and got.mpls_entries == want.mpls_entries,
              f"{what}: route db of {other} differs from the CPU oracle")
        return len(got.unicast_entries)

    t0 = time.perf_counter()
    paths.start()
    asolver = CudaSpfSolver("w0", device=dev, apsp_max_nodes=APSP_N,
                            compute_lfa_paths=True)
    asolver.build_route_db("w0", {"0": apsp_ls[1]}, apsp_ps)
    other_ms, other_routes = [], []
    for other in others:
        t = time.perf_counter()
        got = asolver.build_route_db(other, {"0": apsp_ls[1]}, apsp_ps)
        other_ms.append((time.perf_counter() - t) * 1e3)
        paths.pause()
        other_routes.append(apsp_oracle(other, got, "apsp_wan"))
        paths.resume()
    asolve = asolver._solves[("0", "w0")][1]
    apsp = asolve.apsp
    check(apsp.backend == "device" and apsp.cold_closes == 1,
          f"the first close: backend {apsp.backend}, {apsp.cold_closes} cold")
    first_close_ms = apsp.close_ms_last

    def plain_warm(d_prev, w_prev, w_new):
        """The plain versions' composition of a warm close: the seed, then
        rounds until nothing changes. (d, rounds, slots, dirty0)."""
        iu, iv, iw = increase_slots(w_prev, w_new)
        d, dirty, num = fw._fw_seed_plain(d_prev, w_new, iu, iv, iw, nb_a,
                                          bsz_a)
        nd, rounds, dirty0 = int(num), 0, int(num)
        while nd:
            kb = min(_next_bucket(nd, minimum=1), nb_a)
            d, dirty, nd_t, changed = fw._fw_reclose_plain(
                d, allow_a, dirty, nb_a, bsz_a, kb)
            rounds += 1
            if int(changed) == 0:
                break
            nd = int(nd_t)
        return d, rounds, (iu, iv, iw), dirty0

    d_now = apsp._d_dev
    # K3 on the all-pairs DAG of this closed matrix, timed after the path
    dag_d, dag_g = d_now.clone(), to_device(asolve.graph, dev)
    events = apsp_events(apsp_edges, ag, d_now)
    per_event = []
    seed2 = None
    for k, (name, edits, want_warm) in enumerate(events):
        paths.pause()
        d_prev, w_prev = apsp._d_dev.clone(), apsp._w_dev.clone()
        inv0, warm0 = apsp.invalidations, apsp.warm_closes
        if edits is None:
            node = others[0]
            for ls in apsp_ls:
                db = ls.get_adjacency_databases()[node]
                ls.update_adjacency_database(
                    dataclasses.replace(db, is_overloaded=True))
        else:
            for a, b, changes in edits:
                edit_adjacency(apsp_ls, a, b, **changes)
        other = others[(k + 1) % len(others)]
        paths.resume()
        t = time.perf_counter()
        got = asolver.build_route_db(other, {"0": apsp_ls[1]}, apsp_ps)
        ev_ms = (time.perf_counter() - t) * 1e3
        paths.pause()
        apsp_oracle(other, got, name)
        g_new = asolve.graph
        w_new, allow_a = dense(g_new)
        check(torch.equal(apsp._w_dev, w_new),
              f"{name}: resident weights differ from the new graph's")
        cold, _ = fw.fw_close(w_new, allow_a)
        check(torch.equal(apsp._d_dev, cold),
              f"{name}: the matrix differs from a fresh cold close")
        warm = apsp.warm_closes > warm0
        check(warm == want_warm, f"{name}: warm {warm}, want {want_warm}")
        inc_pairs = int((w_new > w_prev).sum())
        rec = {"event": name, "warm": warm, "increased_pairs": inc_pairs,
               "decreased_pairs": int((w_new < w_prev).sum()),
               "close_ms": apsp.close_ms_last, "route_build_ms": ev_ms,
               "rounds": apsp.reclose_rounds_last,
               "invalidations": apsp.invalidations - inv0}
        if warm:
            d_pl, rounds_pl, slots, dirty0 = plain_warm(d_prev, w_prev, w_new)
            check(torch.equal(d_pl, apsp._d_dev)
                  and rounds_pl == apsp.reclose_rounds_last,
                  f"{name}: warm close differs from the plain composition "
                  f"(rounds {apsp.reclose_rounds_last} vs {rounds_pl})")
            rec["dirty_blocks_seeded"] = dirty0
            if name == "raise_40":
                seed2 = (d_prev, w_new, slots, dirty0, allow_a)
            del d_pl
        else:
            d_pl, _ = fw._fw_close_plain(w_new, allow_a)
            check(torch.equal(d_pl, apsp._d_dev) and rec["rounds"] is None,
                  f"{name}: cold close differs from the plain close")
            del d_pl
        per_event.append(rec)
        paths.resume()
    torch.cuda.synchronize()
    apsp_s = time.perf_counter() - t0
    apsp_launches = paths.read("apsp_wan",
                               (K1, K3, K4, K5, K7, K11, K12, K13))
    check(per_event[1]["increased_pairs"] >= 30
          and per_event[2]["increased_pairs"] > fw._APSP_PATCH_SLOTS
          and per_event[2]["invalidations"] == 1,
          f"event sizes {[e['increased_pairs'] for e in per_event]}")
    check(asolver.host_spf_calls == 0,
          f"{asolver.host_spf_calls} SPF answers from host Dijkstra")
    counters = {k: v for k, v in asolver.counters.items()
                if k.startswith("decision.spf.apsp_")}

    # K11-K13's times beside their bounds and plain versions. A (min,+)
    # product counts one operation per (i, j, m): its add and min are one
    # DPX instruction (__viaddmin_s32) at the int32 lane rate
    t3a = ecmp_times(spf, K3, dag_d, dag_g["src"], dag_g["dst"],
                     dag_g["dst"], dag_g["w"], dag_g["ov"])
    e3a, n3a = dag_g["src"].shape[0], dag_d.shape[1]
    b3a_bytes, b3a_ops, b3a_gathers = ecmp_bytes(dag_d.shape[0], e3a, n3a)
    k3_dag = {
        "edges": e3a, "columns": n3a, "equal_plain": True, **t3a,
        "bound_ms": bound(b3a_bytes, b3a_ops, rate)[0],
        "bound_gathers_ms": b3a_gathers / rate * 1e3,
    }
    k3_row["dag_4096"] = k3_dag
    del dag_d, dag_g
    w_t, allow_t = dense(asolve.graph)
    per_call11 = launches_a_call(K11, lambda: fw.fw_close(w_t, allow_t))
    nb11 = fw.fw_block_shape(w_t.shape[0])[0]
    check(per_call11 == (2 * nb11 + 2 if nb11 > 1 else 2), f"K11 launched "
          f"{per_call11} times a close, not block (0, 0)'s close, 2 a "
          "stage and the probe")
    ms11 = time_ms(lambda: fw.fw_close(w_t, allow_t), reps=5, warmup=1)
    plain_ms11 = time_ms(lambda: fw._fw_close_plain(w_t, allow_t), reps=1,
                         warmup=0)
    # the close's device time by entry point, summed over its stages, and
    # the (min,+) step's instructions in the built code of K11 and K13
    prof11 = profile_window(lambda: fw.fw_close(w_t, allow_t),
                            split=tuple(K11.entries))
    dev11 = graph_ms(lambda: fw.fw_close(w_t, allow_t), 2)
    # block (0, 0)'s close alone, timed with events (one launch a close;
    # the profiler may miss a window's first kernel), on a copy of w
    d_diag = w_t.clone()
    ct_diag = torch.empty((bsz_a, bsz_a), dtype=torch.int32, device=dev)
    diag11 = time_ms(lambda: K11.launch(
        dev, d_diag.data_ptr(), allow_t.data_ptr(), ct_diag.data_ptr(), n_a,
        bsz_a, entry="fw_close_diag"))
    del d_diag, ct_diag
    sass_fw = {k.name: sass_counts(k, SASS_OPCODES) for k in (K11, K13)}
    # the blocked sweep does nb^2 * B^3 = N^2 * B per stage, N^3 in all
    b11_ms, b11_by = bound(9 * n_a * n_a + 4, n_a ** 3, rate)
    d_prev2, w_new2, slots2, dirty02, allow2 = seed2
    seed_args = (d_prev2, w_new2, *slots2, nb_a, bsz_a)
    d0_2, dirty_2, num_2 = fw.fw_seed(*seed_args)
    d0p, dirtyp, nump = fw._fw_seed_plain(*seed_args)
    err12 = max(max_abs_err(d0_2, d0p), max_abs_err(dirty_2, dirtyp))
    check(err12 == 0 and int(num_2) == int(nump) == dirty02,
          f"K12 differs from its plain version: {err12}")
    t12 = seed_times(fw, K12, seed_args)
    per_call12, ms12 = t12["launches_per_call"], t12["ms"]
    check(per_call12 == 1, f"K12 launched {per_call12} times a seed, not 1")
    plain_ms12 = time_ms(lambda: fw._fw_seed_plain(*seed_args), reps=3,
                         warmup=1)
    iu2 = slots2[0]
    valid2 = iu2 < n_a
    w12 = seed_work(d_prev2, *slots2)
    rows_scanned = w12["rows_scanned"]
    b12_ms, b12_by = bound(w12["bytes"], w12["ops"], rate)
    kb2 = min(_next_bucket(dirty02, minimum=1), nb_a)

    def fresh_round():
        return (d0_2.clone(), dirty_2.clone())

    def k13(d, dirty):
        return fw.fw_reclose(d, allow2, dirty, nb_a, bsz_a, kb2)

    def k13_plain(d, dirty):
        return fw._fw_reclose_plain(d, allow2, dirty, nb_a, bsz_a, kb2)

    d13, dirty13, counts13 = k13(*fresh_round())
    d13p, dirty13p, num13p, ch13p = k13_plain(*fresh_round())
    err13 = max(max_abs_err(d13, d13p), max_abs_err(dirty13, dirty13p))
    check(err13 == 0 and counts13.tolist() == [int(num13p), int(ch13p)],
          f"K13 differs from its plain version: {err13}")
    del d13, d13p
    per_call13 = launches_a_call(K13, k13, setup=fresh_round)
    check(per_call13 == 2 * kb2 + 4, f"K13 launched {per_call13} times a "
          "round, not 2 a dirty block and 4")
    ms13 = time_ms(k13, setup=fresh_round, reps=5)
    plain_ms13 = time_ms(k13_plain, setup=fresh_round, reps=1, warmup=0)
    # rule (a) and rule (b) are each a B * N^2 product per dirty block
    b13_ms, b13_by = bound(9 * n_a * n_a + 3 * nb_a,
                           2 * bsz_a * n_a * n_a * dirty02, rate)
    emit({
        "phase": "apsp_wan", "graph": f"wan_edges({APSP_N}, 4, 7)",
        "n": ag.n, "n_pad": n_a, "e": ag.e, "blocks": nb_a, "block": bsz_a,
        "overloaded": len(ov_nodes), "cold_checks": cold_checks,
        "equal_plain": True, "equal_k1_all_sources": True,
        "kernel_checks_seconds": kernel_checks_s,
        "setup_seconds": apsp_setup_s, "seconds": apsp_s,
        "other_nodes": others, "prefixes": 256,
        "other_route_build_ms": other_ms, "routes": other_routes,
        "first_close_ms": first_close_ms, "events": per_event,
        "counters": counters, "launches": apsp_launches,
        "host_spf_calls": asolver.host_spf_calls,
        "k11": {"ms": ms11, "graph_ms": dev11, "diag_ms": diag11,
                "plain_ms": plain_ms11, "bound_ms": b11_ms,
                "profile": prof11, "sass": sass_fw},
        "k12": {"slots": int(iu2.numel()), "valid": int(valid2.sum()),
                "rows_scanned": rows_scanned, "dirty_blocks": dirty02,
                **t12, "plain_ms": plain_ms12, "bound_ms": b12_ms,
                "bound_bytes_ms": w12["bytes"] / rate * 1e3,
                "bound_ops_ms": w12["ops"] / _INT32_OPS_PER_S * 1e3},
        "k13": {"kb": kb2, "dirty_blocks": dirty02, "ms": ms13,
                "plain_ms": plain_ms13, "bound_ms": b13_ms},
        "k3_dag": k3_dag, "card": card,
    })
    for name, k, e, m_, pm, bm, bb, lpc, extra in (
        ("fw_close.cu", K11, err11, ms11, plain_ms11, b11_ms, b11_by,
         per_call11, {"graph_ms": dev11}),
        ("fw_seed.cu", K12, err12, ms12, plain_ms12, b12_ms, b12_by,
         per_call12, {
             "graph_ms": t12["graph_ms"], "host_ms": t12["host_ms"],
             "rows_scanned": rows_scanned,
             "bound_bytes_ms": w12["bytes"] / rate * 1e3,
             "bound_ops_ms": w12["ops"] / _INT32_OPS_PER_S * 1e3}),
        ("fw_reclose.cu", K13, err13, ms13, plain_ms13, b13_ms, b13_by,
         per_call13, {}),
    ):
        results.append({
            "name": k.name, "route": "cuda",
            "source": f"openr_tpu_torch/ops/csrc/{name}",
            "replaces": k.replaces, "launches": None, "max_abs_err": e,
            "ms": m_, "plain_ms": pm, "bound_ms": bm, "bound_by": bb,
            "library_ms": None, "launches_per_call": lpc, **extra,
        })
    del (asolver, asolve, apsp, apsp_ls, w_t, allow_t, seed2,
         d_prev2, w_new2, allow2, d0_2, d0p, d_prev, w_prev, w_new, cold)

    # -- 14. lfa_clos: DeltaPath under LFA on the Clos --------------------
    t0 = time.perf_counter()
    lfa_edges = fabric_edges(pods=LFA_CLOS_PODS)
    lfa_ls = [build_ls(lfa_edges, LinkState, build_adj_dbs) for _ in "ab"]
    check(lfa_ls[0].num_nodes() == LFA_CLOS_NODES, "LFA Clos node count")
    l_names = sorted(lfa_ls[0].node_names())
    lfa_ps = PrefixState()
    for i, node in enumerate(sorted(np.random.default_rng(11).choice(
            l_names, size=256, replace=False))):
        lfa_ps.update_prefix_database(PrefixDatabase(
            node, [PrefixEntry(IpPrefix(f"10.241.{i}.0/24"))], area="0"))
    me = "rsw0_0"
    lfa_kw = dict(device=dev, compute_lfa_paths=True, apsp_max_nodes=4096)
    paths.start()
    lbuilder = DeltaRouteBuilder(CudaSpfSolver(me, **lfa_kw))
    ldb, _, used = lbuilder.build(me, {"0": lfa_ls[1]}, lfa_ps, None)
    paths.pause()
    check(not used, "the first LFA delta-builder build must be full")
    check(lbuilder.solver.lfa_delta_ready(), "lfa_delta_ready is False")
    lfull = CudaSpfSolver(me, **lfa_kw)
    lfull.build_route_db(me, {"0": lfa_ls[1]}, lfa_ps)
    lfa_events = [(name, edits) for name, edits, _ in clos_events()[:6]]
    # the far side of one of me's links, INTO me: the me column moves, so
    # every prefix's LFA threshold may move; the delta path must refuse it
    lfa_events.append(("into_me", [("fsw0_1", me, {"metric": 3})]))
    lfa_per_event = []
    for name, edits in lfa_events:
        for a, b, changes in edits:
            edit_adjacency(lfa_ls, a, b, **changes)
        paths.resume()
        t = time.perf_counter()
        ldb, _, used = lbuilder.build(me, {"0": lfa_ls[1]}, lfa_ps, ldb)
        delta_ms = (time.perf_counter() - t) * 1e3
        paths.pause()
        t = time.perf_counter()
        full_db = lfull.build_route_db(me, {"0": lfa_ls[1]}, lfa_ps)
        full_ms = (time.perf_counter() - t) * 1e3
        want = SpfSolver(me, compute_lfa_paths=True).build_route_db(
            me, {"0": lfa_ls[0]}, lfa_ps)
        for got in (ldb, full_db):
            check(got.unicast_entries == want.unicast_entries
                  and got.mpls_entries == want.mpls_entries,
                  f"lfa_clos {name}: route db differs from the CPU oracle")
        lfa_per_event.append({"event": name, "used_delta": used,
                              "delta_ms": delta_ms, "full_ms": full_ms})
    lfa_s = time.perf_counter() - t0
    paths.resume()  # drops the last comparison builds' launches
    lfa_launches = paths.read("lfa_clos", (K1, K4, K5, K7))
    check(lbuilder.delta_builds >= 1,
          f"no delta build under LFA ({lbuilder.full_builds} full)")
    check(not lfa_per_event[-1]["used_delta"],
          "the event into me's column rode the delta path")
    check(lbuilder.solver.host_spf_calls == 0, "host Dijkstra on lfa_clos")
    emit({
        "phase": "lfa_clos", "me": me, "nodes": LFA_CLOS_NODES,
        "prefixes": 256, "seconds": lfa_s, "events": lfa_per_event,
        "delta_builds": lbuilder.delta_builds,
        "full_builds": lbuilder.full_builds, "launches": lfa_launches,
        "host_spf_calls": lbuilder.solver.host_spf_calls, "card": card,
    })
    del lbuilder, lfull, lfa_ls

    # -- 15. te_clos: differentiable TE at full width --------------------
    K14, K15, K16, K17, K18 = (
        _cuda.SOFTMIN_ROUND, _cuda.SOFTMIN_BWD, _cuda.SOFT_FLOW,
        _cuda.SOFT_FLOW_BWD, _cuda.TE_STEP,
    )
    t0 = time.perf_counter()
    te_ls = build_ls(fabric_edges(pods=TE_CLOS_PODS), LinkState,
                     build_adj_dbs)
    te_g = compile_graph(te_ls)
    check(te_g.n == TE_CLOS_NODES, f"TE Clos n {te_g.n}")
    te_src, te_dst, te_w0, te_up = te_edge_arrays(te_g)
    te_spec = te_demand_spec(te_g.names[: te_g.n], TE_DEMANDS, seed=11)
    te_dem, te_caps, te_b = build_demand_scenarios(te_g, te_spec, seed=0)
    inp = te_inputs(te_src, te_dst, te_w0, te_up, te_dem, te_caps, dev)
    del te_dem
    graph, up_t, caps_t, dem_t = (inp["graph"], inp["up"], inp["caps"],
                                  inp["demands"])
    n_t, e_t = graph.n, graph.e
    te_setup_s = time.perf_counter() - t0
    cfg = teopt.TeOptConfig()
    te_rounds = max(2, min(n_t, 128))

    # one launch of each entry against its plain version on the card, at
    # tau 0.5 from the D of te_rounds rounds, the state each step's gate,
    # flow and backward see (K14's fold outcome feeds both backward
    # versions, so they decide the same ties); tolerance 1e-5 of the
    # largest magnitude (float32 sums in another order), F_INF entries
    # exactly
    t0 = time.perf_counter()
    tau = 0.5
    we = teo.edge_weights(inp["w"], up_t)
    with torch.no_grad():
        d_run = teo.softmin_core(we, graph, tau, te_rounds)
    d_run_unreached = int((d_run >= tk.F_INF / 2).sum())
    te_err, te_abs = {}, {}

    def te_cmp(key, a, b):
        """Fold one output's errors into kernel `key`'s: (max |a - b|, and
        that over max |b|)."""
        te_abs[key] = max(te_abs.get(key, 0.0), float(
            (a.double() - b.double()).abs().max()) if a.numel() else 0.0)
        te_err[key] = max(te_err.get(key, 0.0), rel_err(a, b))
        return te_err[key]

    new_k, keep = tk.softmin_round(d_run, we, graph, tau)
    k14_digest = digest(new_k, keep)
    check(k14_digest == K14_DIGEST_FIRST_DESIGN,
          f"K14's (D', keep) differ from the first design's: {k14_digest}")
    new_p, _ = tk._softmin_round_plain(d_run, we, graph, tau)
    fin = new_p < tk.F_INF / 2
    check(torch.equal(new_k[~fin], new_p[~fin]),
          "K14: F_INF entries differ from the plain version")
    te_cmp("K14", new_k[fin], new_p[fin])
    del new_p, fin
    gen = torch.Generator(dev).manual_seed(5)
    g_new = torch.randn((n_t, n_t), device=dev, generator=gen)
    gk = tk.softmin_round_bwd(g_new, d_run, keep, we, graph, tau)
    gp = tk._softmin_round_bwd_plain(g_new, d_run, keep, we, graph, tau)
    te_cmp("K15", gk[0], gp[0])
    te_cmp("K15", gk[1], gp[1])
    del gk, gp
    # K14-K17 divide by tau through tau's reciprocal before an exp: at
    # this run's temperatures, exp of that quotient has the bits of exp of
    # the correctly rounded division at every exponent they can meet
    div_taus = sorted({tk.f32(tau)} | {
        tk.f32(teopt.anneal_tau(cfg, i, TE_STEPS)) for i in range(TE_STEPS)})
    div_differ = {repr(t_): tk.softmin_div_check(t_, dev) for t_ in div_taus}
    check(not any(div_differ.values()),
          f"the quotient by tau differs from the correctly rounded one: "
          f"{div_differ}")
    p_k = tk.soft_gate(d_run, we, up_t, graph, tau)
    gate_digest = digest(p_k)
    check(gate_digest == GATE_DIGEST_FIRST_DESIGN,
          f"the gate's p differs from the first design's: {gate_digest}")
    p_p = tk._soft_gate_plain(d_run, we, up_t, graph, tau)
    err16 = {"gate": te_cmp("K16", p_k, p_p)}
    del p_p
    eye = torch.eye(n_t, dtype=torch.bool, device=dev)
    x0 = dem_t.masked_fill(eye, 0.0)
    del eye
    xs_k, xs_p = torch.zeros_like(x0), torch.zeros_like(x0)
    x1_k = tk.soft_flow_round(p_k, x0, xs_k, graph)
    x1_p = tk._soft_flow_round_plain(p_k, x0, xs_p, graph)
    te_cmp("K16", xs_k, xs_p)
    err16["round"] = te_cmp("K16", x1_k, x1_p)
    del x1_p, xs_p
    util_k = tk.soft_flow_util(p_k, xs_k, caps_t, graph)
    util_digest = digest(util_k)
    check(util_digest == UTIL_DIGEST_FIRST_DESIGN,
          f"the utilization differs from the first design's: {util_digest}")
    err16["util"] = te_cmp(
        "K16", util_k, tk._soft_flow_util_plain(p_k, xs_k, caps_t, graph))
    g_util = torch.randn(util_k.shape, device=dev, generator=gen)
    gpk, gpp = torch.empty_like(p_k), torch.empty_like(p_k)
    lam_k = tk.soft_flow_bwd_round(p_k, g_util, caps_t, None, x1_k, gpk,
                                   graph, True)
    lam_p = tk._soft_flow_bwd_round_plain(p_k, g_util, caps_t, None, x1_k,
                                          gpp, graph, True)
    lam_k = tk.soft_flow_bwd_round(p_k, g_util, caps_t, lam_k, x0, gpk,
                                   graph, False)
    lam_p = tk._soft_flow_bwd_round_plain(p_k, g_util, caps_t, lam_p, x0,
                                          gpp, graph, False)
    te_cmp("K17", lam_k, lam_p)
    err17 = {"round": te_cmp("K17", gpk, gpp)}
    del lam_p
    g_gap = gpk.clone()
    gd_k = tk.soft_gate_bwd(g_gap, d_run, we, up_t, graph, tau)
    gate_bwd_digest = digest(gd_k[0], gd_k[1], g_gap)
    del g_gap
    check(gate_bwd_digest == GATE_BWD_DIGEST_FIRST_DESIGN,
          f"the gate backward's (g_d, g_we, g_p) differ from the first "
          f"design's: {gate_bwd_digest}")
    gd_p = tk._soft_gate_bwd_plain(gpp, d_run, we, up_t, graph, tau)
    te_cmp("K17", gd_k[0], gd_p[0])
    err17["gate"] = te_cmp("K17", gd_k[1], gd_p[1])
    del gd_k, gd_p, gpp
    # the utilization's exact zeros: the MLU's quotients of 0 (PERF.md)
    util_zero_share = float((util_k == 0).float().mean())
    mask_t = torch.ones(te_b, dtype=torch.float32, device=dev)
    loss_k, lse_k = tk.te_mlu(util_k, mask_t, cfg.tau_obj)
    loss_p, lse_p = tk._te_mlu_plain(util_k, mask_t, cfg.tau_obj)
    one = torch.ones(1, device=dev)
    gu_k = tk.te_mlu_bwd(one, util_k, lse_k, mask_t, cfg.tau_obj)
    mlu_digest, seed_digest = digest(loss_k, lse_k), digest(gu_k)
    check(mlu_digest == MLU_DIGEST_FIRST_DESIGN,
          f"the MLU's (loss, lse) differ from the first design's: "
          f"{mlu_digest}")
    check(seed_digest == SEED_DIGEST_FIRST_DESIGN,
          f"the MLU's seed differs from the first design's: {seed_digest}")
    gu_p = tk._te_mlu_bwd_plain(one, util_k, lse_k, mask_t, cfg.tau_obj)
    # K17's scale on the adjoint rounds' seeded g_util and on the MLU's
    # seed with scenario 1's row zeroed, as a masked scenario's is; its
    # quotients are correctly rounded divisions, so it equals true
    # division by the clamped capacities bit for bit
    gu_zero = gu_k.clone()
    gu_zero[1] = 0.0
    c_k = tk.soft_flow_bwd_scale(g_util, caps_t)
    c_zero = tk.soft_flow_bwd_scale(gu_zero, caps_t)
    scale_digest = digest(c_k, c_zero)
    check(scale_digest == SCALE_DIGEST_FIRST_DESIGN,
          f"K17's scale differs from the first design's: {scale_digest}")
    for g_, c_ in ((g_util, c_k), (gu_zero, c_zero)):
        c_p = tk._soft_flow_bwd_scale_plain(g_, caps_t)
        te_cmp("K17", c_, c_p)
        check(torch.equal(c_, c_p), "K17's scale differs from g_util / "
              "caps.clamp_min(1e-9)")
    del c_zero, c_p, g_, c_
    g_w = torch.randn(e_t, device=dev, generator=gen)

    def adam_state():
        return [inp["w"].clone(), torch.full_like(inp["w"], 0.01),
                torch.full_like(inp["w"], 1e-4), torch.empty_like(inp["w"])]

    ad_k, ad_p = adam_state(), adam_state()
    # step 3's constants, as adam_solve makes them: once a solve, packed
    # for the kernel (adam_schedule); a tree without it (the parent of the
    # change that added it, run under this script to compare) passes
    # adam_hparams' tuple, the only form its te_adam takes
    hp = (tk.adam_schedule(cfg, 4)[3] if hasattr(tk, "adam_schedule")
          else tk.adam_hparams(cfg, 3))
    tk.te_adam(*ad_k[:3], g_w, up_t, ad_k[3], hp)
    adam_digest = digest(*ad_k)
    check(adam_digest == ADAM_DIGEST_FIRST_DESIGN,
          f"the Adam step's (w, m, v, row) differ from the first "
          f"design's: {adam_digest}")
    tk._te_adam_plain(*ad_p[:3], g_w, up_t, ad_p[3], hp)
    for a, b in ((loss_k, loss_p), (lse_k, lse_p), (gu_k, gu_p),
                 *zip(ad_k, ad_p)):
        te_cmp("K18", a, b)
    torch.cuda.synchronize()
    for name, err in te_err.items():
        check(err <= 1e-5, f"{name} differs from its plain version: {err}")

    # times at this size: the kernels, their plain versions, their bounds
    te_ms, te_plain_ms, te_bound, te_lib = {}, {}, {}, {}
    # K17's timed unit: one adjoint round with the scale given (c_k), as
    # SoftFlow's backward runs it; the scale, once a backward, apart
    te_calls = {  # each kernel's timed call and its launches in that call
        "K14": (K14, lambda: tk.softmin_round(d_run, we, graph, tau), 1),
        "K15": (K15, lambda: tk.softmin_round_bwd(g_new, d_run, keep, we,
                                                  graph, tau), 3),
        "K16": (K16, lambda: tk.soft_flow_round(p_k, x0, xs_k, graph), 1),
        "K17": (K17, lambda: tk.soft_flow_adjoint_round(
            p_k, c_k, lam_k, x0, gpk, graph, False), 1),
        "K18": (K18, lambda: tk.te_adam(*ad_k[:3], g_w, up_t, ad_k[3], hp),
                1),
    }
    te_per_call = {}
    for key, (k, fn, want) in te_calls.items():
        te_per_call[key] = launches_a_call(k, fn)
        check(te_per_call[key] == want, f"{key} launched "
              f"{te_per_call[key]} times a timed call, not {want}")
    te_ms["K14"] = time_ms(te_calls["K14"][1])
    te_plain_ms["K14"] = time_ms(
        lambda: tk._softmin_round_plain(d_run, we, graph, tau), reps=3,
        warmup=1)
    te_ms["K15"] = time_ms(te_calls["K15"][1])
    te_plain_ms["K15"] = time_ms(
        lambda: tk._softmin_round_bwd_plain(g_new, d_run, keep, we, graph,
                                            tau), reps=3, warmup=1)
    te_ms["K16"] = time_ms(te_calls["K16"][1])
    te_plain_ms["K16"] = time_ms(
        lambda: tk._soft_flow_round_plain(p_k, x0, None, graph), reps=3,
        warmup=1)
    te_ms["K17"] = time_ms(te_calls["K17"][1])
    te_plain_ms["K17"] = time_ms(lambda: tk._soft_flow_bwd_round_plain(
        p_k, g_util, caps_t, lam_k, x0, gpk.clone(), graph, False), reps=3,
        warmup=1)
    te_ms["K18"] = time_ms(te_calls["K18"][1])
    te_plain_ms["K18"] = time_ms(
        lambda: tk._te_adam_plain(*ad_p[:3], g_w, up_t, ad_p[3], hp))
    side_calls = {  # the other entries of K16-K18, each once a step
        "K16_gate": (K16, lambda: tk.soft_gate(d_run, we, up_t, graph,
                                               tau)),
        "K16_util": (K16, lambda: tk.soft_flow_util(p_k, xs_k, caps_t,
                                                    graph)),
        "K17_scale": (K17, lambda: tk.soft_flow_bwd_scale(g_util, caps_t)),
        "K17_gate_bwd": (K17, lambda g: tk.soft_gate_bwd(
            g, d_run, we, up_t, graph, tau)),
        "K18_mlu": (K18, lambda: tk.te_mlu(util_k, mask_t, cfg.tau_obj)),
        "K18_mlu_bwd": (K18, lambda: tk.te_mlu_bwd(
            one, util_k, lse_k, mask_t, cfg.tau_obj)),
    }
    # the gate backward overwrites g_p: each call gets a fresh copy, made
    # outside the timed span
    side_setup = {"K17_gate_bwd": lambda: (gpk.clone(),)}
    side_ms, side_launches = {}, {}
    for name_, (k, fn) in side_calls.items():
        setup = side_setup.get(name_)
        side_launches[name_] = launches_a_call(k, fn, setup)
        want = 3 if name_ == "K17_gate_bwd" else 1
        check(side_launches[name_] == want, f"{name_} launched "
              f"{side_launches[name_]} times a call, not {want}")
        side_ms[name_] = time_ms(fn, setup=setup)
    # the plain versions of K16's once-a-step entries
    side_plain_ms = {
        "K16_gate": time_ms(lambda: tk._soft_gate_plain(
            d_run, we, up_t, graph, tau), reps=3, warmup=1),
        "K16_util": time_ms(lambda: tk._soft_flow_util_plain(
            p_k, xs_k, caps_t, graph), reps=3, warmup=1),
    }
    # the device time of the MLU, its seed, K17's scale and the Adam step:
    # 20 calls replayed in a CUDA graph (L2 warm); their host time on the
    # host clock alone
    side_graph_ms = {name_: graph_ms(side_calls[name_][1], calls=20)
                     for name_ in ("K18_mlu", "K18_mlu_bwd", "K17_scale")}
    side_host_ms = {name_: host_ms(side_calls[name_][1])
                    for name_ in ("K18_mlu", "K18_mlu_bwd", "K17_scale")}
    te_graph_ms = {"K18": graph_ms(te_calls["K18"][1], calls=20)}
    te_host_ms = {"K18": host_ms(te_calls["K18"][1])}
    # the scale on the seed with a masked scenario's row of zeros: the
    # correctly rounded division's slow path takes a zero numerator
    scale_zero = {
        "ms": time_ms(lambda: tk.soft_flow_bwd_scale(gu_zero, caps_t)),
        "graph_ms": graph_ms(
            lambda: tk.soft_flow_bwd_scale(gu_zero, caps_t), calls=20),
        "host_ms": host_ms(lambda: tk.soft_flow_bwd_scale(gu_zero,
                                                          caps_t)),
    }
    # library yardsticks of the once-a-step entries, each one PyTorch call
    # on the same inputs, its operands made outside the timing (the port
    # never calls them): logsumexp for the MLU's lse and softmax for the
    # softmax its seed scales, on z = util / tau_obj; the division by the
    # clamped capacities for K17's scale
    z_lib = util_k / tk.f32(cfg.tau_obj)
    caps_c = caps_t.clamp_min(1e-9)
    side_lib_ms = {
        "K18_mlu": time_ms(lambda: torch.logsumexp(z_lib, dim=1)),
        "K18_mlu_bwd": time_ms(lambda: torch.softmax(z_lib, dim=1)),
        "K17_scale": time_ms(lambda: torch.div(g_util, caps_c)),
    }
    side_lib_graph_ms = {
        "K17_scale": graph_ms(lambda: torch.div(g_util, caps_c), calls=20)}
    side_lib_host_ms = {
        "K17_scale": host_ms(lambda: torch.div(g_util, caps_c))}
    del z_lib, caps_c
    # the library yardstick of the Adam step: PyTorch's fused Adam on [E]
    # (the port never calls it)
    lib_w = inp["w"].clone().requires_grad_(True)
    lib_w.grad = g_w.clone()
    lib_opt = torch.optim.Adam([lib_w], lr=cfg.lr, betas=(cfg.beta1,
                                                         cfg.beta2),
                               eps=cfg.eps, fused=True)
    te_lib["K18"] = time_ms(lib_opt.step)
    te_lib_host_ms = {"K18": host_ms(lib_opt.step)}
    del lib_opt
    # its device time: a CUDA graph needs the capturable form, its state
    # made by one step before the capture
    lib_opt = torch.optim.Adam([lib_w], lr=cfg.lr, betas=(cfg.beta1,
                                                         cfg.beta2),
                               eps=cfg.eps, fused=True, capturable=True)
    lib_opt.step()
    te_lib_graph_ms = {"K18": graph_ms(lib_opt.step, calls=20)}
    del lib_opt, lib_w
    # bounds: each input read once, each output written once; exp and log
    # at the special-function rate. K14: D, we and the edge layout in, D'
    # and keep out, E*N exp; K15: g', D, keep, we in, g_prev and g_we out,
    # E*N exp (the softmax weights, once); K16 (a flow round): p and B x in,
    # B xsum read and written, B x' out; K17 (an adjoint round): p, B g_util,
    # B lam', B x_r and g_p in, B lam and g_p out; K18 (Adam): w, m, v, g,
    # up in, w, m, v and the trajectory row out
    nn_t, b_t = n_t * n_t, te_b
    topo = 4 * (3 * e_t + 2 * (n_t + 1))
    te_bound["K14"] = bound(9 * nn_t + 4 * e_t + topo, e_t * n_t + nn_t,
                            rate, _MUFU_OPS_PER_S)
    te_bound["K15"] = bound(13 * nn_t + 8 * e_t + topo, e_t * n_t + nn_t,
                            rate, _MUFU_OPS_PER_S)
    te_bound["K16"] = bound(4 * e_t * n_t + 16 * b_t * nn_t + topo, 0, rate)
    te_bound["K17"] = bound(12 * e_t * n_t + 12 * b_t * nn_t
                            + 4 * b_t * e_t + topo, 0, rate)
    te_bound["K18"] = bound(33 * e_t, 0, rate)
    # the entries once a step: the gate (K16): D, we, up and the edge
    # layout in, p out, E*N exp; the utilization (K16): p, B xsum, caps and
    # src in, B util out; the scale (K17): B g_util and caps in, B c out;
    # the gate backward (K17): g_p, D, we, up and the layouts in, g_p
    # (overwritten), g_d and g_we out, E*N exp; the MLU (K18): B util and
    # the mask in, B lse and the loss out, B*E exp; its seed (K18): the
    # loss, B util, B lse and the mask in, B g_util out, B*E exp
    side_bound = {
        "K16_gate": bound(4 * nn_t + 4 * e_t * n_t + 5 * e_t + topo,
                          e_t * n_t, rate, _MUFU_OPS_PER_S),
        "K16_util": bound(4 * e_t * n_t + 4 * b_t * nn_t + 8 * e_t
                          + 4 * b_t * e_t, 0, rate),
        "K17_scale": bound(8 * b_t * e_t + 4 * e_t, 0, rate),
        "K17_gate_bwd": bound(8 * e_t * n_t + 8 * nn_t + 9 * e_t + topo,
                              e_t * n_t, rate, _MUFU_OPS_PER_S),
        "K18_mlu": bound(4 * b_t * e_t + 12 * b_t + 4, b_t * e_t, rate,
                         _MUFU_OPS_PER_S),
        "K18_mlu_bwd": bound(8 * b_t * e_t + 8 * b_t + 4, b_t * e_t, rate,
                             _MUFU_OPS_PER_S),
    }
    gate_share = float((p_k > 0).float().mean())
    del (d_run, new_k, keep, g_new, p_k, x0, xs_k, x1_k, util_k, g_util,
         gpk, lam_k, ad_k, ad_p, c_k, gu_zero, hp)
    torch.cuda.empty_cache()
    te_checks_s = time.perf_counter() - t0

    # counted: adam_solve for TE_STEPS steps at full width
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paths.start()
    t0 = time.perf_counter()
    w_fin, w_hist, losses = teopt.adam_solve(
        inp["w"], dem_t, mask_t, caps_t, graph, up_t, cfg, te_rounds,
        TE_STEPS)
    torch.cuda.synchronize()
    te_solve_s = time.perf_counter() - t0
    te_launches = paths.read("te_clos", (K14, K15, K16, K17, K18))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses_h = losses.cpu().numpy()
    check(bool(np.isfinite(losses_h).all())
          and bool(torch.isfinite(w_hist).all()),
          "te_clos: a loss or a weight is not finite")
    check(peak_gb < 48, f"te_clos peak memory {peak_gb:.1f} GiB")
    moved = int((w_hist[-1] != inp["w"]).sum())
    del w_fin, w_hist, losses
    # one more step under torch.profiler, outside the counted run
    te_profile = profile_window(lambda: teopt.adam_solve(
        inp["w"], dem_t, mask_t, caps_t, graph, up_t, cfg, te_rounds, 1))
    del we
    torch.cuda.empty_cache()

    # the whole chain on a smaller Clos with seeded metrics 1..9: kernels
    # against the plain versions differentiated by autograd on the card;
    # losses within 1e-4, weights within 5e-3. Adam normalises each step by
    # the gradient's root mean square, so a component whose gradient is
    # small moves by up to lr (0.4) times its relative rounding difference
    # per step (1.1e-3 after 8 steps on a 148-node Clos between the two on
    # the CPU); with uniform metrics the Clos is symmetric, its exact
    # gradient is zero on many edges, and both versions step on rounding
    # alone, so the chain uses seeded metrics
    t0 = time.perf_counter()
    ch_rng = np.random.default_rng(4)
    ch_g = compile_graph(build_ls(
        [(a, b, int(ch_rng.integers(1, 10)))
         for a, b, _ in fabric_edges(pods=TE_CHAIN_PODS)],
        LinkState, build_adj_dbs))
    ch_src, ch_dst, ch_w0, ch_up = te_edge_arrays(ch_g)
    ch_spec = te_demand_spec(ch_g.names[: ch_g.n], 256, seed=12)
    ch_dem, ch_caps, ch_b = build_demand_scenarios(ch_g, ch_spec, seed=1)
    ch = te_inputs(ch_src, ch_dst, ch_w0, ch_up, ch_dem, ch_caps, dev)
    ch_mask = torch.ones(ch_b, dtype=torch.float32, device=dev)
    ch_rounds = max(2, min(ch_g.n, 128))
    runs = {}
    for plain in (False, True):
        runs[plain] = teopt.adam_solve(
            ch["w"], ch["demands"], ch_mask, ch["caps"], ch["graph"],
            ch["up"], cfg, ch_rounds, TE_STEPS, plain=plain)
    torch.cuda.synchronize()
    chain_w_err = float((runs[False][1] - runs[True][1]).abs().max())
    chain_loss_err = rel_err(runs[False][2], runs[True][2])
    check(chain_w_err <= 5e-3 and chain_loss_err <= 1e-4,
          f"te chain: weights differ by {chain_w_err}, losses by "
          f"{chain_loss_err} from the plain versions")
    del runs, ch
    chain_s = time.perf_counter() - t0
    per_step = {
        k.name: te_launches[k.name] / TE_STEPS for k in (K14, K15, K16, K17,
                                                          K18)
    }
    emit({
        "phase": "te_clos", "graph": f"fabric_edges({TE_CLOS_PODS})",
        "n": n_t, "e": e_t, "scenarios": te_b, "demands": TE_DEMANDS,
        "rounds": te_rounds, "steps": TE_STEPS,
        "setup_seconds": te_setup_s, "kernel_checks_seconds": te_checks_s,
        "max_rel_err": te_err, "max_abs_err": te_abs, "k16_rel_err": err16,
        "tau_quotient_differ": div_differ,
        "k14_digest": k14_digest, "gate_bwd_digest": gate_bwd_digest,
        "gate_digest": gate_digest, "util_digest": util_digest,
        "mlu_digest": mlu_digest, "seed_digest": seed_digest,
        "scale_digest": scale_digest, "adam_digest": adam_digest,
        "k17_rel_err": err17,
        "seconds": te_solve_s, "step_ms": te_solve_s * 1e3 / TE_STEPS,
        "launches": te_launches, "launches_per_step": per_step,
        "launches_per_call": te_per_call,
        "kernel_ms": te_ms, "plain_ms": te_plain_ms, "side_ms": side_ms,
        "side_bound_ms": {k_: b_[0] for k_, b_ in side_bound.items()},
        "side_plain_ms": side_plain_ms, "side_library_ms": side_lib_ms,
        "side_graph_ms": side_graph_ms, "side_host_ms": side_host_ms,
        "side_library_graph_ms": side_lib_graph_ms,
        "side_library_host_ms": side_lib_host_ms,
        "scale_zero_row": scale_zero, "graph_ms": te_graph_ms,
        "host_ms": te_host_ms, "library_ms": te_lib,
        "library_graph_ms": te_lib_graph_ms,
        "library_host_ms": te_lib_host_ms,
        "side_launches_per_call": side_launches,
        "est_kernel_ms_per_step": {
            key: te_ms[key] * (per_step[k.name] - sum(
                n_ for name_, n_ in side_launches.items()
                if name_.startswith(key))) / max(te_per_call[key], 1)
            + sum(ms_ for name_, ms_ in side_ms.items()
                  if name_.startswith(key))
            for key, k in (("K14", K14), ("K15", K15), ("K16", K16),
                           ("K17", K17), ("K18", K18))
        },
        "d_unreached_share": d_run_unreached / (n_t * n_t),
        "util_zero_share": util_zero_share,
        "gate_nonzero_share": gate_share, "profiled_1_step": te_profile,
        "peak_memory_gib": peak_gb, "loss_first": float(losses_h[0]),
        "loss_last": float(losses_h[-1]),
        "loss_last_column_round": LOSS_LAST_COLUMN_ROUND,
        "loss_last_equal_column_round":
            float(losses_h[-1]) == LOSS_LAST_COLUMN_ROUND,
        "weights_moved": moved,
        "chain": {"graph": f"fabric_edges({TE_CHAIN_PODS})", "n": ch_g.n,
                  "rounds": ch_rounds, "steps": TE_STEPS,
                  "max_weight_err": chain_w_err,
                  "max_loss_rel_err": chain_loss_err, "seconds": chain_s},
        "card": card,
    })
    for key, k, src_name in (("K14", K14, "te_softmin.cu"),
                             ("K15", K15, "te_softmin.cu"),
                             ("K16", K16, "te_flow.cu"),
                             ("K17", K17, "te_flow.cu"),
                             ("K18", K18, "te_step.cu")):
        results.append({
            "name": k.name, "route": "cuda",
            "source": f"openr_tpu_torch/ops/csrc/{src_name}",
            "replaces": k.replaces, "launches": None,
            "max_abs_err": te_abs[key], "max_rel_err": te_err[key],
            "ms": te_ms[key],
            "plain_ms": te_plain_ms[key], "bound_ms": te_bound[key][0],
            "bound_by": te_bound[key][1], "library_ms": te_lib.get(key),
            "graph_ms": te_graph_ms.get(key), "host_ms": te_host_ms.get(key),
            "library_graph_ms": te_lib_graph_ms.get(key),
            "launches_per_call": te_per_call[key],
            # the entries run once a step: time, bound, launches a call
            "side": {
                name_[4:]: {"ms": side_ms[name_], "bound_ms": b_[0],
                            "bound_by": b_[1],
                            "plain_ms": side_plain_ms.get(name_),
                            "library_ms": side_lib_ms.get(name_),
                            "graph_ms": side_graph_ms.get(name_),
                            "host_ms": side_host_ms.get(name_),
                            "library_graph_ms":
                                side_lib_graph_ms.get(name_),
                            "launches_per_call": side_launches[name_]}
                for name_, b_ in side_bound.items()
                if name_.startswith(key)},
        })

    # -- 15b. te_mesh: TE's scenario batch sharded over 'batch' ----------
    # te_clos's batch over a (TE_MESH_B, 1) mesh of ranks sharing the card,
    # counted, against the unsharded adam_solve of the same steps (not
    # counted); PERF.md §2's TE limits. Each rank runs K14-K17 on its own
    # scenario and K18's MLU and seed; the one Adam step runs on rank 0
    t0 = time.perf_counter()
    bmesh = make_mesh([dev] * TE_MESH_B, (TE_MESH_B, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    _, wh_one, ls_one = teopt.adam_solve(
        inp["w"], dem_t, mask_t, caps_t, graph, up_t, cfg, te_rounds,
        TE_MESH_STEPS)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t1
    one_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    paths.start()
    t1 = time.perf_counter()
    _, wh_mesh, ls_mesh = teopt.adam_solve(
        inp["w"], dem_t, mask_t, caps_t, graph, up_t, cfg, te_rounds,
        TE_MESH_STEPS, mesh=bmesh)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t1
    mesh_launches = paths.read("te_mesh", (K14, K15, K16, K17, K18))
    mesh_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(bool(torch.isfinite(wh_mesh).all())
          and bool(torch.isfinite(ls_mesh).all()),
          "te_mesh: a loss or a weight is not finite")
    mesh_w_err = float((wh_mesh - wh_one).abs().max())
    mesh_loss_err = rel_err(ls_mesh, ls_one)
    check(mesh_w_err <= 5e-3 and mesh_loss_err <= 1e-4,
          f"te_mesh: weights differ by {mesh_w_err}, losses by "
          f"{mesh_loss_err} from the unsharded run")
    check(mesh_peak < 48, f"te_mesh peak memory {mesh_peak:.1f} GiB")
    mesh_per_step = {k.name: mesh_launches[k.name] / TE_MESH_STEPS
                     for k in (K14, K15, K16, K17, K18)}
    # every rank runs a step's K14-K17 launches, each on fewer scenarios;
    # K18: an MLU and a seed a rank, one Adam step
    for k in (K14, K15, K16, K17):
        check(mesh_per_step[k.name] == TE_MESH_B * per_step[k.name],
              f"te_mesh: {k.name} launched {mesh_per_step[k.name]} times a "
              f"step, not {TE_MESH_B} x {per_step[k.name]}")
    check(mesh_per_step[K18.name] == 2 * TE_MESH_B + 1,
          f"te_mesh: {K18.name} launched {mesh_per_step[K18.name]} times a "
          f"step, not {2 * TE_MESH_B + 1}")
    emit({
        "phase": "te_mesh", "mesh": [TE_MESH_B, 1],
        "graph": f"fabric_edges({TE_CLOS_PODS})", "n": n_t, "e": e_t,
        "scenarios": te_b, "rounds": te_rounds, "steps": TE_MESH_STEPS,
        "step_ms": mesh_s * 1e3 / TE_MESH_STEPS,
        "unsharded_step_ms": one_s * 1e3 / TE_MESH_STEPS,
        "peak_memory_gib": mesh_peak, "unsharded_peak_memory_gib": one_peak,
        "launches": mesh_launches, "launches_per_step": mesh_per_step,
        "max_weight_err": mesh_w_err, "max_loss_rel_err": mesh_loss_err,
        "losses": ls_mesh.tolist(), "unsharded_losses": ls_one.tolist(),
        "seconds": time.perf_counter() - t0, "card": card,
    })
    del dem_t, inp, mask_t, wh_one, ls_one, wh_mesh, ls_mesh
    torch.cuda.empty_cache()

    # -- 16. te_service: the TE service on the card ----------------------
    t0 = time.perf_counter()
    fx_edges, fx_spec = congested_clos_fixture()
    fx_params = {"demands": fx_spec, "steps": 48, "scenarios": 4}
    paths.start()
    fx_svc = TeService("l0_0", {"0": build_ls(fx_edges, LinkState,
                                             build_adj_dbs)}, device=dev)
    fx_reports = [fx_svc.optimize(dict(fx_params)) for _ in range(4)]
    # the acceptance run of the fixture: its one scenario, 6.0 -> 2.0
    acc_params = {"demands": fx_spec, "steps": 48, "seed": 0}
    acc = fx_svc.optimize(dict(acc_params))
    paths.pause()
    fx_cpu, acc_cpu = (
        TeService("l0_0", {"0": build_ls(fx_edges, LinkState,
                                         build_adj_dbs)},
                  device="cpu").optimize(dict(params))
        for params in (fx_params, acc_params))
    fx = fx_reports[-1]
    check(all(r["improved"] for r in (*fx_reports, acc)),
          "te_service: a fixture run did not improve")
    check(acc["initial_max_util"] == 6.0 and acc["optimized_max_util"] == 2.0,
          f"te_service: {acc['initial_max_util']} -> "
          f"{acc['optimized_max_util']}, want 6.0 -> 2.0")
    for got, want in ((fx, fx_cpu), (acc, acc_cpu)):
        check(got["weight_changes"] == want["weight_changes"]
              and got["initial_max_util"] == want["initial_max_util"]
              and got["optimized_max_util"] == want["optimized_max_util"],
              "te_service: the card's proposal differs from the CPU run's")
    fx_ms = min(r["solve_ms"] for r in fx_reports[1:])

    # the all-pairs borrow: a solver holding the matrix serves the initial
    # hard scoring
    b_edges = fabric_edges(pods=TE_BORROW_PODS)
    b_ls = build_ls(b_edges, LinkState, build_adj_dbs)
    b_names = sorted(b_ls.node_names())
    b_params = {"demands": dict(te_demand_spec(b_names, 256, seed=13),
                                scenarios=2),
                "steps": 16, "seed": 0}
    b_me = "rsw0_0"
    paths.resume()
    b_solver = CudaSpfSolver(b_me, device=dev, apsp_max_nodes=4096)
    b_solver.build_route_db(b_me, {"0": b_ls}, PrefixState())
    b_svc = TeService(b_me, {"0": b_ls}, solver=b_solver, device=dev)
    b_report = b_svc.optimize(dict(b_params))
    torch.cuda.synchronize()
    svc_launches = paths.read("te_service", (K11, K14, K15, K16, K17, K18))
    b_cpu = TeService(b_me, {"0": b_ls}, device="cpu").optimize(
        dict(b_params))
    check(b_svc.counters.get("decision.te.apsp_borrows") == 1,
          "te_service: the all-pairs matrix was not borrowed")
    check(b_report["initial_max_util"] == b_cpu["initial_max_util"]
          and b_report["top_links"]["initial"]
          == b_cpu["top_links"]["initial"],
          "te_service: the borrowed initial scores differ from the CPU run's")
    emit({
        "phase": "te_service", "seconds": time.perf_counter() - t0,
        "fixture": {"nodes": fx["nodes"], "scenarios": fx["scenarios"],
                    "steps": fx["steps"], "te_optimize_ms": fx_ms,
                    "solve_ms": [r["solve_ms"] for r in fx_reports],
                    "initial_max_util": fx["initial_max_util"],
                    "optimized_max_util": fx["optimized_max_util"],
                    "weight_changes": len(fx["weight_changes"]),
                    "cpu_solve_ms": fx_cpu["solve_ms"],
                    "acceptance": {
                        "scenarios": acc["scenarios"],
                        "initial_max_util": acc["initial_max_util"],
                        "optimized_max_util": acc["optimized_max_util"],
                        "weight_changes": acc["weight_changes"]}},
        "borrow": {"graph": f"fabric_edges({TE_BORROW_PODS})",
                   "nodes": b_report["nodes"],
                   "scenarios": b_report["scenarios"],
                   "steps": b_report["steps"],
                   "apsp_borrows": b_svc.counters["decision.te.apsp_borrows"],
                   "improved": b_report["improved"],
                   "initial_max_util": b_report["initial_max_util"],
                   "optimized_max_util": b_report["optimized_max_util"],
                   "solve_ms": b_report["solve_ms"],
                   "cpu_solve_ms": b_cpu["solve_ms"]},
        "launches": svc_launches, "card": card,
    })
    del fx_svc, b_svc, b_solver

    # -- te_pendant: the pendant-node TE input, card against CPU --------
    # (a measurement, not counted: ROADMAP queue 3 item 1)
    t0 = time.perf_counter()
    pendant = {}
    for pname in ("clos", "grid"):
        rng = np.random.default_rng(3)
        base = fabric_edges(pods=2) if pname == "clos" else grid_edges(6)
        p_edges = [(a, b, int(rng.integers(1, 9))) for a, b, _ in base]
        p_edges.append(("pendant", p_edges[0][0], 3))
        p_dbs = build_adj_dbs(p_edges)
        a_, b_ = p_edges[1][:2]
        p_dbs[a_] = dataclasses.replace(p_dbs[a_], adjacencies=[
            dataclasses.replace(x, is_overloaded=True)
            if x.other_node_name == b_ else x
            for x in p_dbs[a_].adjacencies])
        p_ls = LinkState("0")
        for db_ in p_dbs.values():
            p_ls.update_adjacency_database(db_)
        p_g = compile_graph(p_ls)
        p_src, p_dst, p_w, p_up = te_edge_arrays(p_g)
        p_w[np.flatnonzero(p_up)[:4]] = [31.0, 32.0, 33.5, 40.0]
        pn = p_g.n
        in_edge = int(np.flatnonzero(p_dst == p_g.node_index["pendant"])[0])
        rng = np.random.default_rng(5)
        p_dem = (rng.uniform(0, 2, (3, pn, pn)) * (1 - np.eye(pn))).astype(
            np.float32)
        p_caps = rng.uniform(0.5, 2.0, len(p_src)).astype(np.float32)
        runs, chains = {}, {}
        for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
            pin = te_inputs(p_src, p_dst, p_w, p_up, p_dem, p_caps, device)
            _, wh_, ls_ = teopt.adam_solve(
                pin["w"], pin["demands"],
                torch.tensor([1.0, 0.0, 1.0], device=device), pin["caps"],
                pin["graph"], pin["up"], teopt.TeOptConfig(), 16, 4)
            runs[side] = (wh_.cpu(), ls_.cpu())
            we_p = teo.edge_weights(pin["w"], pin["up"])
            for tau in (2.0, 0.5, 0.05):
                d_p = torch.full((pn, pn), tk.F_INF, device=device)
                d_p.fill_diagonal_(0.0)
                keeps, same_d = [], 0
                for _ in range(40):
                    new_p, keep_p = tk.softmin_round(d_p, we_p, pin["graph"],
                                                     tau)
                    if side == "card":
                        # the plain version on the same D, on the card
                        same_d += int((keep_p != tk._softmin_round_plain(
                            d_p, we_p, pin["graph"], tau)[1]).sum())
                    d_p = new_p
                    gap_p, _ = tk._gate_score(d_p, we_p, pin["up"],
                                              pin["graph"], tau)
                    keeps.append((keep_p.cpu(), (gap_p == 0).cpu(),
                                  d_p.cpu()))
                chains[side, tau] = (keeps, same_d)
        (wh_k, ls_k), (wh_c, ls_c) = runs["card"], runs["cpu"]
        gap_w = (wh_k - wh_c).abs().max(dim=0).values
        rest = torch.ones(len(gap_w), dtype=torch.bool)
        rest[in_edge] = False
        per_tau = {}
        for tau in (2.0, 0.5, 0.05):
            (kc, same_d), (kp, _) = chains["card", tau], chains["cpu", tau]
            per_tau[str(tau)] = {
                "keep_mismatch_card_vs_cpu_by_round": [
                    int((a[0] != b[0]).sum()) for a, b in zip(kc, kp)],
                "gap0_mismatch_card_vs_cpu_by_round": [
                    int((a[1] != b[1]).sum()) for a, b in zip(kc, kp)],
                "max_d_diff_last": float((kc[-1][2] - kp[-1][2]).abs().max()),
                "keep_k14_vs_plain_same_d": same_d,
            }
        pendant[pname] = {
            "n": pn, "edges": len(p_src), "pendant_in_edge": in_edge,
            "max_weight_gap": float(gap_w.max()),
            "max_weight_gap_edge": int(gap_w.argmax()),
            "max_weight_gap_other_edges": float(gap_w[rest].max()),
            "loss_rel_err": rel_err(ls_k, ls_c), "ties": per_tau,
        }
    emit({"phase": "te_pendant", "rounds": 16, "steps": 4,
          "seconds": time.perf_counter() - t0, "cases": pendant,
          "card": card})

    # -- 17. tile_wan: the destination-tiled layout on the north-star WAN --
    K19, K20, K21 = _cuda.TILE_ROUND, _cuda.TILE_FOLD, _cuda.TILE_MARK
    emit({"phase": "nccl", "not_measured": (
        "one card: the mesh's ranks share it, so a hop is a device copy; "
        "NCCL send/recv between cards cannot run here"),
        "device_count": torch.cuda.device_count(), "card": card})
    t0 = time.perf_counter()
    wkey = wan.sell.shape_key()
    st_w = to_device(wan, dev)
    d_ref, rounds_ref = spf._sell_solver_counted(
        wkey, src_t, st_w["nbrs"], st_w["wgs"], st_w["ov"])
    check(torch.equal(d_ref, d_k1), "K1 differs from its first run")
    wgs_new = tuple(torch.as_tensor(a, device=dev)
                    for a in wan.sell.patched_wg(wan_w_new[: wan.e]))
    d_new, rounds_new = spf._sell_solver_counted(
        wkey, src_t, st_w["nbrs"], wgs_new, st_w["ov"])
    tmesh = make_mesh([dev] * TILE_G, (1, TILE_G))
    tiling = tile_graph(wan, TILE_G)
    tkey = tiling.shape_key() + (wan.n_pad,)
    n_tile, h = tiling.n_tile, tiling.h
    tops = convert.tiling_ranks(tiling, tmesh)
    tsrc = convert.rank_sources(tmesh, wan_src)
    tov = convert.rank_replicas(tmesh, wan.overloaded, bool)
    targs = (tsrc, tops["src_l"], tops["hseg"], tops["hptr"], tops["w2"],
             tops["hcols"], tov)
    w2n = convert.rank_rows(tmesh, tiling.tile_weights(wan_w_new), np.int32)
    wargs = (tsrc, tops["src_l"], tops["hseg"], tops["hptr"], w2n,
             tops["w2"], tops["hcols"], tov, tov)
    tile_setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    paths.start()
    t0 = time.perf_counter()
    d_t, rounds_t, cold_copies = spf._tile_solver(tkey, tmesh, *targs)
    torch.cuda.synchronize()
    d_tw, rounds_tw, inv_tw, cc_tw, num_tw, warm_copies = (
        spf._tile_solver_warm(tkey, tmesh, *wargs, d_t))
    num_tw = int(num_tw)
    torch.cuda.synchronize()
    tile_s = time.perf_counter() - t0
    tile_launches = paths.read("tile_wan", (K19, K20, K21))
    check(torch.equal(d_t.gather(dev), d_k1) and rounds_t == rounds_ref,
          f"tiled cold D or rounds ({rounds_t}) differ from K1's "
          f"({rounds_ref})")
    check(torch.equal(d_tw.gather(dev), d_new),
          "tiled warm D differs from a cold K1 solve of the new weights")
    plain_w = spf._tile_solver_warm(tkey, tmesh, *wargs, d_t,
                                    ops=spf.TILE_PLAIN)
    check(torch.equal(plain_w[0].gather(dev), d_new)
          and (rounds_tw, inv_tw, num_tw) == (plain_w[1], plain_w[2],
                                              int(plain_w[4]))
          and all(torch.equal(a, b) for a, b in zip(cc_tw, plain_w[3])),
          f"tiled warm differs from its plain version: (rounds, inv, num) "
          f"{(rounds_tw, inv_tw, num_tw)} vs {plain_w[1:3]} "
          f"{int(plain_w[4])}")
    plain_c = spf._tile_solver(tkey, tmesh, *targs, ops=spf.TILE_PLAIN)
    check(torch.equal(plain_c[0].gather(dev), d_k1)
          and plain_c[1] == rounds_t, "tiled cold differs from plain")
    del plain_w, plain_c
    # the unsharded warm path on the same event, for its round counts
    wgs_u = tuple(a.clone() for a in st_w["wgs"])
    d_uw, _, r_uw, inv_uw, cc_uw, num_uw = spf._sell_solver_warm(
        wkey, src_t, st_w["nbrs"], wgs_u, st_w["ov"], idx_t, vals_t, inc_t,
        d_k1)
    check(torch.equal(d_uw, d_new) and torch.equal(torch.cat(cc_tw), cc_uw)
          and int(num_uw) == num_tw,
          "tiled warm columns differ from the sliced warm path's")

    # K19, K20 and K21 alone, on one round of the real state: rank j's
    # cold tile (the first round), its fixpoint with the event's seed mask
    # and with a mark mask
    j, s_l = 1, len(wan_src)
    off = j * n_tile
    rank = dict(sources=tsrc[0][j], overloaded=tov[0][j], offset=off,
                src_l=tops["src_l"][0][j], hseg=tops["hseg"][0][j],
                hptr=tops["hptr"][0][j], w2=tops["w2"][0][j], h=h)
    dpt = d_t.blocks[0][j]
    d0t = spf.tile_init(tsrc[0][j], off, n_tile)
    err21 = max_abs_err(d0t, spf._tile_init_plain(tsrc[0][j], off, n_tile))
    marks_t = (dpt % 3) == 0
    variants = (({}, d0t), ({"w_new": w2n[0][j],
                 "ov_new": tov[0][j]}, dpt),
                ({"marks": marks_t}, dpt))
    err19 = 0
    for kw, dd in variants:
        err19 = max(err19, max_abs_err(spf.tile_round(dd, **rank, **kw),
                                       spf._tile_round_plain(dd, **rank,
                                                             **kw)))
    ctr_j = spf.tile_round(d0t, **rank)
    rank0 = dict(rank, sources=tsrc[0][0], offset=0,
                 src_l=tops["src_l"][0][0], hseg=tops["hseg"][0][0],
                 hptr=tops["hptr"][0][0], w2=tops["w2"][0][0])
    ctr_0 = spf.tile_round(spf.tile_init(tsrc[0][0], 0, n_tile), **rank0)
    err20 = 0
    for ctr, cols in ((ctr_j, tops["hcols"][0][j]),
                      (ctr_0, tops["hcols"][0][0])):
        f_k, f_p = (torch.zeros(1, dtype=torch.int32, device=dev)
                    for _ in "kp")
        out_k = spf.tile_fold(dpt.clone(), ctr, cols, j, f_k)
        out_p = spf._tile_fold_plain(dpt.clone(), ctr, cols, j, f_p)
        err20 = max(err20, max_abs_err(out_k, out_p), max_abs_err(f_k, f_p))
    recv = spf.tile_fold(torch.full_like(dpt, INF), ctr_j,
                         tops["hcols"][0][j], j)
    for m in (None, marks_t):
        f_k, f_p = (torch.zeros(1, dtype=torch.int32, device=dev)
                    for _ in "kp")
        m_k = spf.tile_mark(m, recv.clone(), dpt, f_k)
        m_p = spf._tile_mark_plain(m, recv.clone(), dpt, f_p)
        err21 = max(err21, max_abs_err(m_k, m_p), max_abs_err(f_k, f_p))
    err21 = max(err21, max_abs_err(
        spf.tile_reset(marks_t, dpt, tsrc[0][j], off),
        spf._tile_reset_plain(marks_t, dpt, tsrc[0][j], off)))
    dwt = d_tw.blocks[0][j]
    outs = []
    for fn in (spf.tile_col_changed, spf._tile_col_changed_plain):
        cc = torch.zeros(n_tile, dtype=torch.bool, device=dev)
        cnt = torch.zeros(1, dtype=torch.int32, device=dev)
        fn(dwt, dpt, cc, cnt)
        outs.append((cc, cnt))
    err21 = max(err21, max_abs_err(outs[0][0], outs[1][0]),
                max_abs_err(outs[0][1], outs[1][1]))
    check(err19 == 0, f"K19 differs from its plain version: {err19}")
    check(err20 == 0, f"K20 differs from its plain version: {err20}")
    check(err21 == 0, f"K21 differs from its plain version: {err21}")

    # times, each the median of CUDA-event-timed calls
    ms_tc = time_ms(lambda: spf._tile_solver(tkey, tmesh, *targs), reps=5,
                    warmup=1)
    ms_tw = time_ms(lambda: spf._tile_solver_warm(tkey, tmesh, *wargs, d_t),
                    reps=5, warmup=1)
    ms_tcp = time_ms(lambda: spf._tile_solver(tkey, tmesh, *targs,
                                              ops=spf.TILE_PLAIN),
                     reps=3, warmup=1)
    ms_k1w = time_ms(lambda: spf._sell_solver_counted(
        wkey, src_t, st_w["nbrs"], st_w["wgs"], st_w["ov"]))
    buf = torch.empty((s_l, h), dtype=torch.int32, device=dev)
    per_call19 = launches_a_call(
        K19, lambda: spf.tile_round(d0t, **rank, out=buf))
    ms19 = time_ms(lambda: spf.tile_round(d0t, **rank, out=buf))
    dev19 = graph_ms(lambda: spf.tile_round(d0t, **rank, out=buf), 20)
    prof19 = profile_window(
        lambda: [spf.tile_round(d0t, **rank, out=buf) for _ in range(10)],
        split=("tile_round_nodes", "tile_round_slots"))
    plain_ms19 = time_ms(lambda: spf._tile_round_plain(d0t, **rank, out=buf))
    fold_t = dpt.clone()
    per_call20 = launches_a_call(
        K20, lambda: spf.tile_fold(fold_t, ctr_0, tops["hcols"][0][0], j))
    ms20 = time_ms(lambda: spf.tile_fold(fold_t, ctr_0, tops["hcols"][0][0],
                                         j))
    plain_ms20 = time_ms(lambda: spf._tile_fold_plain(
        fold_t, ctr_0, tops["hcols"][0][0], j))
    prof20 = profile_window(lambda: [spf.tile_fold(
        fold_t, ctr_0, tops["hcols"][0][0], j) for _ in range(10)])
    dev20 = graph_ms(lambda: spf.tile_fold(fold_t, ctr_0,
                                           tops["hcols"][0][0], j), 20)
    # the library's form of the fold: scatter_reduce_ (amin) of the owned
    # slots' frontier columns into their tile columns, its index built
    # outside the timing; it computes no flag
    k0_20, k1_20 = np.searchsorted(tiling.hcols[0], [off, off + n_tile])
    idx20 = torch.as_tensor(tiling.hcols[0][k0_20:k1_20] - off,
                            device=dev).long()
    idx20 = idx20[None, :].expand(s_l, -1).contiguous()
    ctr20 = ctr_0[:, k0_20:k1_20]
    check(torch.equal(
        dpt.clone().scatter_reduce_(1, idx20, ctr20, "amin"),
        spf._tile_fold_plain(dpt.clone(), ctr_0, tops["hcols"][0][0], j)),
        "scatter_reduce_ differs from K20's plain version")
    lib_ms20 = time_ms(lambda: fold_t.scatter_reduce_(1, idx20, ctr20,
                                                      "amin"))
    t21 = tile_mark_times(spf, K21, tsrc[0][j], off, marks_t, recv, dpt,
                          dwt)
    ms21_parts, plain21_parts = ({k: v[key] for k, v in t21.items()}
                                 for key in ("ms", "plain_ms"))
    per_call21 = sum(v["launches_per_call"] for v in t21.values())
    ms21, plain_ms21 = sum(ms21_parts.values()), sum(plain21_parts.values())
    for key, got, want in (("K19", per_call19, 2), ("K20", per_call20, 1),
                           ("K21", per_call21, 4)):
        check(got == want,
              f"{key} launched {got} times a timed call, not {want}")

    # bounds: each input read once, each output written once
    k_j = int(tiling.hptr[j][-1])
    hc = tiling.hcols[0]
    kept = int(np.count_nonzero((hc >= off) & (hc < off + n_tile)))
    tile_b = 4 * s_l * n_tile
    b19_ms, b19_by = bound(4 * s_l * h + tile_b + 8 * k_j + 4 * (h + 1)
                           + 4 * s_l + n_tile, 3 * s_l * k_j, rate)
    b20_ms, b20_by = bound(4 * h + 12 * s_l * kept, s_l * kept, rate)
    b21_parts = tile_mark_bytes(dwt, dpt)
    b21_ms = sum(b21_parts.values()) / rate * 1e3
    real_slots = (tiling.hcols != spf.TILE_PAD).sum(axis=1)
    payload = (s_l * h + h) * 4
    # the bytes the rings counted as they copied, against the halo count of
    # the reference's solver (`_account_halo`: g - 1 hops a round, the warm
    # solve's seed and mark exchanges besides, every rank's frontier a hop)
    halo_cold = (TILE_G - 1) * rounds_t * TILE_G * payload
    halo_warm = (TILE_G - 1) * (1 + inv_tw + rounds_tw) * TILE_G * payload
    check((cold_copies.bytes, warm_copies.bytes) == (halo_cold, halo_warm),
          f"the hops copied {cold_copies.bytes} and {warm_copies.bytes} "
          f"bytes, the halo counts are {halo_cold} and {halo_warm}")
    emit({
        "phase": "tile_wan", "graph": f"wan_edges({WAN_N}, 4, 3)",
        "mesh": [1, TILE_G], "sources": s_l, "n_pad": wan.n_pad,
        "g": TILE_G, "n_tile": n_tile, "e_tile": tiling.e_tile, "h": h,
        "real_edges": np.diff(tiling.hptr[:, [0, -1]], axis=1).ravel()
        .tolist(), "real_slots": real_slots.tolist(),
        "frontier_mib": s_l * h * 4 / 2**20, "tile_mib": tile_b / 2**20,
        "rounds": rounds_t, "rounds_k1": rounds_ref,
        "warm": {"rounds": rounds_tw, "inv_rounds": inv_tw,
                 "num_changed": num_tw, "sliced_rounds": r_uw,
                 "sliced_inv_rounds": inv_uw},
        "equal_k1": True, "equal_cold_new_weights": True,
        "equal_plain": True, "cold_ms": ms_tc, "warm_ms": ms_tw,
        "cold_plain_ms": ms_tcp, "k1_cold_ms": ms_k1w,
        "halo_bytes_cold": halo_cold, "halo_bytes_warm": halo_warm,
        "hop_copies_cold": cold_copies._asdict(),
        "hop_copies_warm": warm_copies._asdict(),
        "k19_ms": ms19, "k19_graph_ms": dev19,
        "k19_profile_10_calls": prof19, "k20_ms": ms20,
        "k20_stretch": [int(k0_20), int(k1_20)],
        "k20_profile_10_calls": prof20, "k20_graph_ms": dev20,
        "k20_scatter_reduce_ms": lib_ms20,
        "k21_ms": ms21_parts,
        "k21_graph_ms": {k: v["graph_ms"] for k, v in t21.items()},
        "k21_host_ms": {k: v["host_ms"] for k, v in t21.items()},
        "k21_restore_graph_ms": {k: t21[k]["restore_graph_ms"]
                                 for k in ("mark", "col_changed")},
        "k21_bound_ms": {k: v / rate * 1e3 for k, v in b21_parts.items()},
        "k21_plain_ms": plain21_parts, "setup_seconds": tile_setup_s,
        "seconds": tile_s, "launches": tile_launches, "card": card,
    })
    for k, src_name, e, m_, pm, bm, bb, lib, lpc in (
        (K19, "tile_round.cu", err19, ms19, plain_ms19, b19_ms, b19_by, None,
         per_call19),
        (K20, "tile_fold.cu", err20, ms20, plain_ms20, b20_ms, b20_by,
         lib_ms20, per_call20),
        (K21, "tile_mark.cu", err21, ms21, plain_ms21, b21_ms, "bytes", None,
         per_call21),
    ):
        results.append({
            "name": k.name, "route": "cuda",
            "source": f"openr_tpu_torch/ops/csrc/{src_name}",
            "replaces": k.replaces, "launches": None, "max_abs_err": e,
            "ms": m_, "plain_ms": pm, "bound_ms": bm, "bound_by": bb,
            "library_ms": lib, "launches_per_call": lpc,
        })
    results[-2]["library_call"] = ("scatter_reduce_ (amin) over the owned "
                                   "slots, its index built outside the "
                                   "timing; computes no flag")
    del (d_t, d_tw, d_uw, wgs_u, tops, w2n, targs, wargs, buf, recv, outs,
         d0t, ctr_j, ctr_0, fold_t, idx20, ctr20)

    # -- 18. tile_clos: CudaSpfSolver on a (1, 4) mesh, DeltaPath on tiles -
    me = "rsw0_0"
    t0 = time.perf_counter()
    tc_ls = [build_ls(clos_edges, LinkState, build_adj_dbs) for _ in "ab"]
    cmesh = make_mesh([dev] * TILE_G, (1, TILE_G))
    paths.start()
    tbuilder = DeltaRouteBuilder(CudaSpfSolver(me, device=dev, mesh=cmesh))
    tdb, _, used = tbuilder.build(me, {"0": tc_ls[1]}, clos_ps, None)
    paths.pause()
    check(not used, "tile_clos: the first build must be full")
    tsolver = tbuilder.solver
    tsolve = tsolver._solves[("0", me)][1]
    check(tsolve._dev["kind"] == "tile2d", "tile_clos: not tiled")
    flat = CudaSpfSolver(me, device=dev)
    flat_db = flat.build_route_db(me, {"0": tc_ls[1]}, clos_ps)
    want = SpfSolver(me).build_route_db(me, {"0": tc_ls[0]}, clos_ps)
    for got in (tdb, flat_db):
        check(got.unicast_entries == want.unicast_entries
              and got.mpls_entries == want.mpls_entries,
              "tile_clos: the first route db differs from the oracle")
    tc_events = []
    for name, edits, want_delta in clos_events():
        for a, b, changes in edits:
            edit_adjacency(tc_ls, a, b, **changes)
        paths.resume()
        t = time.perf_counter()
        tdb, _, used = tbuilder.build(me, {"0": tc_ls[1]}, clos_ps, tdb)
        delta_ms = (time.perf_counter() - t) * 1e3
        paths.pause()
        t = time.perf_counter()
        flat_db = flat.build_route_db(me, {"0": tc_ls[1]}, clos_ps)
        full_ms = (time.perf_counter() - t) * 1e3
        want = SpfSolver(me).build_route_db(me, {"0": tc_ls[0]}, clos_ps)
        for got in (tdb, flat_db):
            check(got.unicast_entries == want.unicast_entries
                  and got.mpls_entries == want.mpls_entries,
                  f"tile_clos {name}: route db differs from the oracle "
                  "or the mesh=None solver")
        check(used == want_delta,
              f"tile_clos {name}: used_delta {used}, want {want_delta}")
        tc_events.append({
            "event": name, "used_delta": used, "build_ms": delta_ms,
            "flat_full_build_ms": full_ms, "warm": tsolve.last_solve_warm,
            "rounds": tsolve.rounds_last,
            "inv_rounds": tsolve.invalidation_rounds_last,
            "halo_exchanges_last": tsolver.counters.get(
                "decision.spf.halo_exchanges_last"),
            "halo_bytes": tsolver.counters.get("decision.spf.halo_bytes"),
        })
    torch.cuda.synchronize()
    paths.resume()  # drops the last comparison builds' launches
    tc_launches = paths.read("tile_clos", (K3, K7, K19, K20, K21))
    check(tbuilder.delta_builds >= 6 and tsolver.host_spf_calls == 0,
          f"tile_clos: {tbuilder.delta_builds} delta builds, "
          f"{tsolver.host_spf_calls} host SPF answers")
    emit({
        "phase": "tile_clos", "me": me, "mesh": [1, TILE_G],
        "n_pad": tsolve.graph.n_pad, "h": tsolve._dev["tiling"].h,
        "events": tc_events, "delta_builds": tbuilder.delta_builds,
        "full_builds": tbuilder.full_builds,
        "halo_bytes": tsolver.counters.get("decision.spf.halo_bytes"),
        "halo_exchanges_last": tsolver.counters.get(
            "decision.spf.halo_exchanges_last"),
        "seconds": time.perf_counter() - t0, "launches": tc_launches,
        "card": card,
    })
    del tbuilder, tsolver, tsolve, flat, tc_ls

    # -- 19. mesh_rows: the batch-sharded row layout ---------------------
    t0 = time.perf_counter()
    rmesh = make_mesh([dev] * ROW_B, (ROW_B, 1))

    def row_layout():
        """The layout replicated over the mesh (one copy per device),
        with fresh weight buckets, which the warm solve patches."""
        return (replicate(rmesh, lambda d: st_w["nbrs"]),
                replicate(rmesh, lambda d: tuple(a.clone()
                                                 for a in st_w["wgs"])),
                replicate(rmesh, lambda d: st_w["ov"]))

    nb_r, wg_r, ov_r = row_layout()
    paths.start()
    d_r, rounds_r = spf._sell_solver_counted(wkey, src_t, nb_r, wg_r, ov_r,
                                             mesh=rmesh)
    d_rw, _, rounds_rw, inv_rw, cc_rw, num_rw = spf._sell_solver_warm(
        wkey, src_t, nb_r, wg_r, ov_r, idx_t, vals_t, inc_t, d_r, mesh=rmesh)
    torch.cuda.synchronize()
    paths.pause()  # the comparisons and timings below are not counted
    rows_s = time.perf_counter() - t0
    check(torch.equal(d_r.gather(dev), d_k1) and rounds_r == rounds_ref,
          "mesh_rows: the row-sharded cold solve differs from K1's")
    check(torch.equal(d_rw.gather(dev), d_new)
          and (rounds_rw, inv_rw) == (r_uw, inv_uw)
          and torch.equal(cc_rw, cc_uw) and int(num_rw) == int(num_uw),
          "mesh_rows: the row-sharded warm solve differs from the "
          "unsharded one")

    def rows_warm(nb, wg, ov):
        return spf._sell_solver_warm(wkey, src_t, nb, wg, ov, idx_t, vals_t,
                                     inc_t, d_r, mesh=rmesh)

    ms_rc = time_ms(lambda: spf._sell_solver_counted(
        wkey, src_t, nb_r, wg_r, ov_r, mesh=rmesh))
    ms_rw = time_ms(rows_warm, setup=row_layout)
    # KSP2 under a (2, 1) mesh: cold, row-sharded masked solves
    kr_ls = build_ls(ksp_edges, LinkState, build_adj_dbs)
    paths.resume()
    kr = CudaSpfSolver("w0", device=dev, mesh=make_mesh([dev] * 2, (2, 1)))
    t = time.perf_counter()
    db_kr = kr.build_route_db("w0", {"0": kr_ls}, ksp_ps)
    ms_kr = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    rows_launches = paths.read("mesh_rows", (K1, K4, K5, K7, K8, K9))
    ku = CudaSpfSolver("w0", device=dev)
    db_ku = ku.build_route_db("w0", {"0": kr_ls}, ksp_ps)
    check(db_kr.unicast_entries == db_ku.unicast_entries
          and db_kr.mpls_entries == db_ku.mpls_entries
          and len(db_kr.unicast_entries) == len(groups),
          "mesh_rows: the meshed KSP2 route db differs from the unsharded")
    krs = kr._solves[("0", "w0")][1]
    check(krs.ksp_device_batches > 0 and krs.ksp_warm_batches == 0
          and kr.host_spf_calls == 0, "mesh_rows: KSP did not run cold on "
          "the card")
    emit({
        "phase": "mesh_rows", "graph": f"wan_edges({WAN_N}, 4, 3)",
        "mesh": [ROW_B, 1], "rounds": rounds_r, "warm_rounds": rounds_rw,
        "inv_rounds": inv_rw, "num_changed": int(num_rw),
        "equal_k1": True, "equal_unsharded_warm": True,
        "cold_ms": ms_rc, "warm_ms": ms_rw, "k1_cold_ms": ms_k1w,
        "ksp": {"graph": f"wan_edges({KSP_WAN_N}, 4, 5)", "mesh": [2, 1],
                "prefixes": len(groups), "route_build_ms": ms_kr,
                "ksp_device_batches": krs.ksp_device_batches,
                "equal_unsharded": True},
        "seconds": rows_s, "launches": rows_launches, "card": card,
    })
    del d_r, d_rw, nb_r, wg_r, ov_r, kr, ku, krs, kr_ls, st_w, d_new

    # -- 20-22. Decision on the card -------------------------------------
    K14, K15, K16, K17, K18 = (
        _cuda.SOFTMIN_ROUND, _cuda.SOFTMIN_BWD, _cuda.SOFT_FLOW,
        _cuda.SOFT_FLOW_BWD, _cuda.TE_STEP,
    )
    paths.start()
    decision_phases(
        dev, card, paths,
        {"decision_clos": (K1, K3, K4, K5, K7),
         "decision_drill": (K1, K3, K14, K15, K16, K17, K18),
         "decision_mesh": (K3, K19, K20, K21)},
        clos_edges, lfa_edges, fabric_edges(pods=TE_CHAIN_PODS),
    )
    paths.start()
    decision_ledger(
        dev, card, paths,
        (K1, K3, K4, K5, K7, K11, K14, K15, K16, K17, K18, K19, K20, K21),
        clos_edges, lfa_edges, wan_edges(APSP_N, degree=4, seed=7),
    )

    # -- 23. kernels line, card, result ----------------------------------
    for row in results:
        row["launches"] = paths.total(row["name"])
        row["launches_by_path"] = {
            path: counts[row["name"]] for path, counts in paths.by_path.items()
        }
        row["timed_unit"] = TIMED_UNIT[row["name"]]
        check(row["launches_per_call"] > 0,
              f"{row['name']} launched no time in its timed call")
        check(row["launches"] > 0, f"{row['name']} never launched")
    check(len(results) == len(_cuda.KERNELS), "a kernel has no row")
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
