"""Gradient-descent TE loop: Adam over link weights, annealed.

The counterpart of the JAX package's te/optimizer.py. Per step: anneal the
softmin temperature toward hard SPF, differentiate the mean soft
max-link-utilization over the demand-scenario batch (`torch.autograd.grad`
of `_loss`, whose forward and backward run the kernels of te/kernels.py),
apply the Adam update (K18) and project back into the bounded weight box.
The weight trajectory [steps, E] and the losses [steps] stay on the card
and come back in one copy at the end, so the host can score every *rounded
integer* iterate under exact hard-SPF routing and keep the best one.

The scenario batch is a [B, N, N] demand tensor with a validity mask. The
softmin distances do not depend on the demands, so a step computes them
once for the whole batch (the reference's vmap leaves them unbatched too).
With a solver mesh the batch is sharded over its 'batch' axis, as SPF
source batches are (`parallel/mesh.py`): padded to the axis size with
masked zero-demand scenarios, batch rank r's [B / b, N, N] slice and mask
on its device, the topology replicated. One process drives every rank: a
step runs each rank's forward and backward in turn (so ranks sharing a
card peak near one rank's memory), sums their gradients onto batch rank
0's device, where the one Adam step runs, and copies the new weights to
the other ranks' devices. Given a ledger area (`mem_area`, TeService's
"{area}/te"), each rank's shard registers with the device-memory ledger
for the loop's duration, on its own card's tag: the memory it holds beyond
the batch the caller uploaded (its slice copied to another card, the
padded batch, the topology's replicas).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from openr_tpu_torch.convert import TeGraph, te_inputs
from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.ops.spf import batch_devices
from openr_tpu_torch.te import kernels as tk
from openr_tpu_torch.te.objective import (
    edge_weights,
    hard_max_util,
    utilization_core,
)


@dataclass(frozen=True)
class TeOptConfig:
    """Knobs of the gradient-descent TE loop (docs/TrafficEngineering.md)."""

    steps: int = 80  # Adam steps
    lr: float = 0.4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    # softmin/softmax temperature annealing: geometric tau0 -> tau_min
    # across the step budget; small tau -> the relaxation approaches the
    # hard SPF objective it is scored under
    tau0: float = 2.0
    tau_min: float = 0.05
    # smooth-max temperature of the max-link-utilization objective
    tau_obj: float = 0.25
    # bounded-weight projection box (integer metrics after rounding)
    w_min: float = 1.0
    w_max: float = 64.0
    # soft relaxation rounds; None -> n (graph node count)
    rounds: Optional[int] = None


@dataclass
class TeOptResult:
    """Outcome of one optimization run, hard-scored."""

    w0: np.ndarray  # initial float weights [E]
    w_best: np.ndarray  # best rounded integer weights [E]
    best_step: int  # scan step the winner came from (-1 = initial)
    initial_max_util: float  # worst-scenario hard MLU at w0
    best_max_util: float  # worst-scenario hard MLU at w_best
    losses: np.ndarray  # soft objective per step [steps]
    steps: int
    # device->host bytes of the trajectory copy-back (one per run); the
    # TE service folds this into decision.te.d2h_bytes so the TE share of
    # transfer traffic is observable next to decision.spf.*
    d2h_bytes: int = 0


def _loss(w, demands, scen_mask, caps, graph: TeGraph, up, tau: float,
          tau_obj: float, rounds: int) -> torch.Tensor:
    """Scenario-averaged soft max-link-utilization (the objective) as a
    one-element tensor, differentiable in w: the softmin distances once
    (K14), the flow of all B scenarios (K16) and the MLU (K18)."""
    we = edge_weights(w, up)
    util = utilization_core(we, up, demands, caps, graph, tau, rounds)
    return tk.SoftMlu.apply(util, scen_mask, tk.f32(tau_obj))


def _loss_plain(w, demands, scen_mask, caps, graph: TeGraph, up,
                tau: float, tau_obj: float, rounds: int) -> torch.Tensor:
    """`_loss` composed of the plain versions and differentiated by autograd
    on whatever device its tensors are (the kernels' reference)."""
    we = edge_weights(w, up)
    tau = tk.f32(tau)
    n = graph.n
    d = torch.full((n, n), tk.F_INF, dtype=torch.float32, device=w.device)
    d.fill_diagonal_(0.0)
    for _ in range(rounds):
        d = tk._softmin_round_plain(d, we, graph, tau)[0]
    util = tk._soft_flow_plain(d, we, up, demands, caps, graph, tau, rounds)
    return tk._te_mlu_plain(util, scen_mask, tk.f32(tau_obj))[0]


@dataclass
class ScenarioShard:
    """Batch rank r's share of the scenario batch, on its device: its
    demand slice [B / b, N, N] and mask [B / b], replicas of caps, up and
    the TeGraph, and `scale`, max(its mask's sum, 1) / max(the whole mask's
    sum, 1): K18's MLU averages over the rank's own scenarios, and the
    scale turns that into its share of the global mean."""

    demands: torch.Tensor
    mask: torch.Tensor
    caps: torch.Tensor
    graph: TeGraph
    up: torch.Tensor
    scale: float

    @property
    def device(self) -> torch.device:
        return self.demands.device


def _graph_on(graph: TeGraph, dev: torch.device) -> TeGraph:
    if graph.device == dev:
        return graph
    return dataclasses.replace(graph, **{
        f.name: getattr(graph, f.name).to(dev)
        for f in dataclasses.fields(graph)
        if isinstance(getattr(graph, f.name), torch.Tensor)})


def shard_scenarios(demands, scen_mask, caps, graph: TeGraph, up,
                    mesh) -> List[ScenarioShard]:
    """The scenario batch sharded over `mesh`'s 'batch' axis (the
    reference's `_shard_scenarios`): the scenario axis padded to the axis
    size with zero-demand scenarios whose mask is 0, and batch rank r's
    slice on `batch_devices(mesh)[r]` (graph rank 0: the batch replicates
    over 'graph'), with caps, up and the graph copied once to each device
    they are not on."""
    devs = batch_devices(mesh)
    b = len(devs)
    pad = (-demands.shape[0]) % b
    if pad:
        demands = torch.cat([demands, demands.new_zeros(
            (pad,) + tuple(demands.shape[1:]))])
        scen_mask = torch.cat([scen_mask, scen_mask.new_zeros(pad)])
    per = demands.shape[0] // b
    counts = scen_mask.reshape(b, per).sum(dim=1).tolist()
    total = max(sum(counts), 1.0)
    topo = {}
    out = []
    for r, dev in enumerate(devs):
        if dev not in topo:
            topo[dev] = (caps.to(dev), _graph_on(graph, dev), up.to(dev))
        rows = slice(r * per, (r + 1) * per)
        out.append(ScenarioShard(
            demands[rows].to(dev), scen_mask[rows].to(dev), *topo[dev],
            float(np.float32(max(counts[r], 1.0)) / np.float32(total))))
    return out


def _register_shards(shards, inputs, mem_area: str) -> List[int]:
    """Ledger handles of the shards' own memory: per rank, the storages
    that neither the inputs nor an earlier rank hold (a slice of the
    uploaded batch on its card is a view and counts nothing), under
    "{mem_area}/rank{r}@{device}"."""
    from openr_tpu_torch.monitor.memledger import get_ledger

    ledger = get_ledger()
    seen = {t.untyped_storage().data_ptr() for t in inputs}
    handles = []
    for r, sh in enumerate(shards):
        tensors = [sh.demands, sh.mask, sh.caps, sh.up] + [
            getattr(sh.graph, f.name) for f in dataclasses.fields(sh.graph)
            if isinstance(getattr(sh.graph, f.name), torch.Tensor)]
        own = 0
        for t in tensors:
            ptr = t.untyped_storage().data_ptr()
            if ptr not in seen:
                seen.add(ptr)
                own += t.untyped_storage().nbytes()
        if own:
            handles.append(ledger.register(
                f"{mem_area}/rank{r}@{sh.device}", "te.shard", layout="te",
                nbytes=own, dtype="float32",
                shape=tuple(sh.demands.shape)))
    return handles


def _sharded_grad(w, shards, replicas, loss_fn, tau: float, tau_obj: float,
                  rounds: int):
    """(loss [1], g [E]) on w's device: each rank's scaled loss and its
    gradient in turn, summed in rank order. `replicas` holds this step's
    copy of w on every other device."""
    loss_sum = g_sum = None
    for sh in shards:
        wr = w if sh.device == w.device else replicas[sh.device]
        wv = wr.detach().requires_grad_(True)
        loss = loss_fn(wv, sh.demands, sh.mask, sh.caps, sh.graph, sh.up,
                       tau, tau_obj, rounds)
        if sh.scale != 1.0:
            loss = loss * sh.scale
        (g,) = torch.autograd.grad(loss, wv)
        loss, g = loss.detach().to(w.device), g.to(w.device)
        loss_sum = loss if loss_sum is None else loss_sum + loss
        g_sum = g if g_sum is None else g_sum + g
    return loss_sum, g_sum


def anneal_tau(cfg: TeOptConfig, i: int, steps: int) -> float:
    """Step i's temperature tau0 * (tau_min / tau0) ** (i / (steps - 1)),
    in float32 as the reference's traced step computes it."""
    frac = np.float32(i) / np.float32(max(steps - 1, 1))
    tau0 = np.float32(cfg.tau0)
    return float(tau0 * (np.float32(cfg.tau_min) / tau0) ** frac)


def adam_solve(
    w0: torch.Tensor,
    demands: torch.Tensor,
    scen_mask: torch.Tensor,
    caps: torch.Tensor,
    graph: TeGraph,
    up: torch.Tensor,
    cfg: TeOptConfig,
    rounds: int,
    steps: int,
    plain: bool = False,
    mesh=None,
    mem_area: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(final w [E], weight trajectory [steps, E], losses [steps]) on w0's
    device, with nothing copied to the host. Each step takes the gradient
    of `_loss` at w, zeroes it on down links and applies Adam (K18). With
    `plain` every piece is its plain version differentiated by autograd,
    on any device: the reference the card's kernels are held against.

    With `mesh`, the batch is sharded over its 'batch' axis
    (`shard_scenarios`; w0 on batch rank 0's device): a step's loss and
    gradient are the ranks' sums (`_sharded_grad`), and the Adam step runs
    once, on w0's device. Without one the whole batch is one shard. With
    `mem_area` too, the shards' own memory is registered with the ledger
    while the loop runs (`_register_shards`)."""
    handles: List[int] = []
    if mesh is None:
        shards = [ScenarioShard(demands, scen_mask, caps, graph, up, 1.0)]
    else:
        if batch_devices(mesh)[0] != w0.device:
            raise ValueError(
                f"w0 on {w0.device}, batch rank 0 on {batch_devices(mesh)[0]}")
        shards = shard_scenarios(demands, scen_mask, caps, graph, up, mesh)
        if mem_area is not None:
            inputs = [demands, scen_mask, caps, up] + [
                getattr(graph, f.name) for f in dataclasses.fields(graph)
                if isinstance(getattr(graph, f.name), torch.Tensor)]
            handles = _register_shards(shards, inputs, mem_area)
    try:
        return _adam_loop(w0, shards, up, cfg, rounds, steps, plain)
    finally:
        if handles:
            from openr_tpu_torch.monitor.memledger import get_ledger

            for h in handles:
                get_ledger().release(h)


def _adam_loop(w0, shards, up, cfg: TeOptConfig, rounds: int, steps: int,
               plain: bool):
    """adam_solve's steps over its shards."""
    replicas = {sh.device: torch.empty_like(w0, device=sh.device)
                for sh in shards if sh.device != w0.device}
    w = w0.detach().clone()
    m = torch.zeros_like(w)
    v = torch.zeros_like(w)
    w_hist = torch.empty((steps, w.shape[0]), dtype=torch.float32,
                         device=w.device)
    losses = torch.empty(steps, dtype=torch.float32, device=w.device)
    loss_fn = _loss_plain if plain else _loss
    # each step's constants and trajectory row made once a solve
    rows = w_hist.unbind(0)
    sched = tk.adam_schedule(cfg, steps)
    for i in range(steps):
        tau = anneal_tau(cfg, i, steps)
        for rep in replicas.values():
            rep.copy_(w)
        loss, g = _sharded_grad(w, shards, replicas, loss_fn, tau,
                                cfg.tau_obj, rounds)
        losses[i : i + 1].copy_(loss.detach())
        if plain:
            tk._te_adam_plain(w, m, v, g, up, rows[i], sched[i])
        else:
            tk.te_adam(w, m, v, g.contiguous(), up, rows[i], sched[i])
        del loss, g
    return w, w_hist, losses


def optimize_weights(
    src_e: np.ndarray,
    dst_e: np.ndarray,
    up: np.ndarray,
    w0: np.ndarray,  # float initial weights [E]
    demands: np.ndarray,  # [B, N, N] candidate demand scenarios
    caps: np.ndarray,  # [E] per-directed-edge capacities
    n: int,
    config: Optional[TeOptConfig] = None,
    mesh=None,
    initial_d: Optional[np.ndarray] = None,
    device: DeviceLike = "cuda",
    mem_area: Optional[str] = None,
) -> TeOptResult:
    """Run the annealed GD loop on `device` and hard-score the rounded
    iterates on the host.

    The winner is the rounded integer weight vector minimizing the WORST
    scenario's hard max link utilization; the initial weights are scored
    too, so a run that finds nothing better reports itself unimproved
    instead of proposing noise. `initial_d`, when given, is an exact
    distance matrix for the INITIAL integer weights (the solver's resident
    APSP matrix, docs/Apsp.md): the w0 score reuses it instead of
    re-deriving [N, N] distances by Bellman-Ford. With `mesh` (a
    `parallel.Mesh`) the scenario batch is sharded over its 'batch' axis
    and the loop runs on its devices, batch rank 0's holding the weights:
    `device` is not read; `mem_area` registers each rank's shard with the
    memory ledger while the loop runs (`adam_solve`)."""
    cfg = config or TeOptConfig()
    rounds = cfg.rounds if cfg.rounds is not None else int(n)
    rounds = max(2, min(int(rounds), 128))

    b = demands.shape[0]
    dev = (batch_devices(mesh)[0] if mesh is not None
           else resolve_device(device))
    inp = te_inputs(src_e, dst_e, w0, up, demands, caps, dev)
    scen_mask = torch.ones(b, dtype=torch.float32, device=dev)
    _, w_hist, losses = adam_solve(
        inp["w"], inp["demands"], scen_mask, inp["caps"], inp["graph"],
        inp["up"], cfg, rounds, int(cfg.steps), mesh=mesh, mem_area=mem_area,
    )
    # the whole optimization stays on the device; this is its single
    # copy-back (trajectory + losses), accounted like every other d2h
    w_hist = w_hist.cpu().numpy()
    losses = losses.cpu().numpy()
    d2h_bytes = int(w_hist.nbytes + losses.nbytes)

    def worst_hard(w_int: np.ndarray, d=None) -> float:
        return max(
            hard_max_util(w_int, demands[k], caps, src_e, dst_e, up, n, d=d)
            for k in range(b)
        )

    w0_int = np.clip(np.rint(w0), cfg.w_min, cfg.w_max).astype(np.int64)
    best_w, best_step = w0_int, -1
    best_util = initial_util = worst_hard(w0_int, d=initial_d)
    seen = {w0_int.tobytes()}
    for i in range(w_hist.shape[0]):
        w_int = np.clip(np.rint(w_hist[i]), cfg.w_min, cfg.w_max).astype(
            np.int64
        )
        key = w_int.tobytes()
        if key in seen:
            continue  # rounded trajectory revisits few distinct vectors
        seen.add(key)
        util = worst_hard(w_int)
        if util < best_util:
            best_util, best_w, best_step = util, w_int, i

    if best_step >= 0:
        # minimal-change prune: GD wanders many weights on its way to the
        # optimum; revert every changed edge that does not pay for itself
        # so operators see the smallest equivalent proposal
        best_w = best_w.copy()
        for pos in np.flatnonzero(best_w != w0_int):
            trial = best_w.copy()
            trial[pos] = w0_int[pos]
            if worst_hard(trial) <= best_util:
                best_w = trial

    return TeOptResult(
        w0=np.asarray(w0),
        w_best=best_w,
        best_step=best_step,
        initial_max_util=initial_util,
        best_max_util=best_util,
        losses=losses,
        steps=int(cfg.steps),
        d2h_bytes=d2h_bytes,
    )
