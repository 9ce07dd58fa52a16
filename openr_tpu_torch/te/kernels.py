"""Differentiable TE on the card: the softmin relaxation, the soft ECMP flow
and the Adam step, forward and backward.

The objective (te/objective.py) is a chain of fixed-length round loops over
the TE edge list (`convert.TeGraph`): `rounds` softmin relaxation rounds
give the distance matrix D [N, N] (row = node, column = destination), a
softmax gate over the triangle gap gives the split p [E, N], `rounds` flow
rounds push the demands [B, N, N] along p, and the per-link utilization
[B, E] goes through a logsumexp into the scenario-averaged soft max link
utilization. Five hand-written CUDA kernels carry it (ops/csrc/):

  K14 softmin_round      one softmin round: D_prev -> D_new
  K15 softmin_round_bwd  its backward: g_new -> (g_prev, g_we)
  K16 soft_flow          the gate (p, once per step), a flow round for all
                         scenarios, and the utilization
  K17 soft_flow_bwd      the adjoint rounds' scale (once per backward),
                         the adjoint flow round, and the gate's backward
                         down to (g_D, g_we)
  K18 te_step            the logsumexp MLU with its masked mean, its
                         gradient seed, and the Adam update

`SoftminRound` (K14, K15), `SoftFlow` (K16, K17) and `SoftMlu` (K18) are
`torch.autograd.Function`s, so `torch.autograd.grad` of the loss runs the
backward kernels. The gradients follow the reference's reverse mode,
including its tie rules: an exact tie of `minimum`/`maximum` sends half the
gradient to each side (the fold of the incumbent, the two F_INF clamps of a
candidate, the clamp of the softmin output, max(gap, 0)). The fold's
outcome is recorded by the forward (`keep`, one byte an entry) rather than
recomputed by the backward: a converged entry ties with its softmin only
because the same arithmetic recomputes it. The gradient
through the softmin's stabiliser m cancels in exact arithmetic (it is
g_out * (1 - sum of the softmax weights)); the explicit backward versions
drop it, where autograd through the plain forward keeps its rounding.

The flow's [E, N] edge-flow tensor of the reference is never built: the
utilization needs only its row sums, and flow[e, t] summed over the rounds
is p[e, t] times the node's flow summed over the rounds, so the rounds keep
xsum [B, N, N] and one pass at the end reduces p * xsum[src] over t. The
backward needs every round's flow x_r [B, N, N]; `SoftFlow` keeps one in
`FLOW_CHECKPOINT` and recomputes the others a segment at a time.

Each wrapper checks device, dtype, shape and contiguity; on a CUDA tensor it
launches its kernel (and counts the launch), on a CPU tensor it runs the
plain PyTorch version beside it. The plain versions are the CPU tests' path
and the card's reference. `_softmin_round_plain`, `_soft_flow_plain` and
`_te_mlu_plain` are also differentiable by autograd, which the tests hold
the explicit backward versions against.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from openr_tpu_torch.convert import TeGraph
from openr_tpu_torch.ops._cuda import (
    SOFT_FLOW,
    SOFT_FLOW_BWD,
    SOFTMIN_BWD,
    SOFTMIN_DIV_CHECK,
    SOFTMIN_ROUND,
    TE_STEP,
)
from openr_tpu_torch.ops.spf import _check

# float-domain "unreachable" of the softmin arithmetic (te/objective.py)
F_INF = 1.0e9

# lanes of t per block: the kernels' block width, and the width of the
# chunks whose per-edge partial sums the backward kernels write
_THREADS = 256

# the largest node count: the row kernels put a node on gridDim.y
_MAX_N = 65535

# SoftFlow keeps the flow of one round in this many for its backward and
# recomputes the rest: at 3,956 nodes and 4 scenarios a round is 250 MB
FLOW_CHECKPOINT = 4


def _chunks(n: int) -> int:
    return (n + _THREADS - 1) // _THREADS


def f32(x: float) -> float:
    """x rounded to float32: the reference's scalars are float32 in its
    traced arithmetic, and a float32 value multiplies and divides the same
    in float32 or double."""
    return float(np.float32(x))


def _check_graph(graph: TeGraph, dev) -> None:
    if graph.device != dev:
        raise ValueError(f"graph on {graph.device}, expected {dev}")
    if graph.n > _MAX_N:
        raise ValueError(f"TE supports at most {_MAX_N} nodes, got {graph.n}")


def _check_square(name: str, t: torch.Tensor, n: int, dev) -> None:
    _check(name, t, torch.float32, 2, dev)
    if t.shape != (n, n):
        raise ValueError(f"{name} must be [{n}, {n}], got {tuple(t.shape)}")


def _check_edges(name: str, t: torch.Tensor, e: int, dtype, dev) -> None:
    _check(name, t, dtype, 1, dev)
    if t.shape[0] != e:
        raise ValueError(f"{name} must be [{e}], got {tuple(t.shape)}")


def _check_batch(name: str, t: torch.Tensor, n: int, dev) -> int:
    _check(name, t, torch.float32, 3, dev)
    if t.shape[1:] != (n, n):
        raise ValueError(f"{name} must be [B, {n}, {n}]")
    return t.shape[0]


def _f_inf(dev) -> torch.Tensor:
    return torch.tensor(F_INF, dtype=torch.float32, device=dev)


def _seg_sum(vals: torch.Tensor, idx: torch.Tensor, n: int, dim: int = 0):
    shape = list(vals.shape)
    shape[dim] = n
    return vals.new_zeros(shape).index_add(dim, idx, vals)


def _half_ties(a: torch.Tensor, b) -> torch.Tensor:
    """d min(a, b) / d a: 1 where a < b, 1/2 at a tie, 0 where a > b."""
    return (a < b).float() + 0.5 * (a == b).float()


# -- plain PyTorch versions: K14, K15 ----------------------------------------


def _softmin_cells(d, we, graph: TeGraph, tau: float):
    """One softmin round's per-(u, t) state, the reference's expressions:
    (total [E, N] = we + D[dst], m, s, out, relaxed [N, N]). Candidates are
    clamped at F_INF, the segment softmin over each source's out-edges is
    stabilised by the segment min; differentiable by autograd with the
    reference's tie rules (`torch.minimum` halves the gradient at a tie,
    where clamp would not)."""
    n = graph.n
    src, dst = graph.src.long(), graph.dst.long()
    f_inf = _f_inf(d.device)
    total = we[:, None] + d[dst]
    x = torch.minimum(torch.minimum(total, f_inf), f_inf)
    m = torch.full_like(d, float("inf")).scatter_reduce(
        0, src[:, None].expand_as(x), x, "amin", include_self=True
    )
    m = torch.minimum(m, f_inf)
    s = _seg_sum(torch.exp(-(x - m[src]) / tau), src, n)
    out = m - tau * torch.log(torch.clamp_min(s, 1e-30))
    relaxed = torch.where(s > 0, torch.minimum(out, f_inf), f_inf)
    return total, m, s, out, relaxed


def _fold(d, relaxed) -> torch.Tensor:
    """The incumbent folded in by a hard minimum, the diagonal pinned to
    0."""
    eye = torch.eye(d.shape[0], dtype=torch.bool, device=d.device)
    return torch.minimum(d, relaxed).masked_fill(eye, 0.0)


def _softmin_round_plain(d, we, graph: TeGraph, tau: float):
    """K14's plain version, the reference's scan body, as the wrapper
    returns it: (D_new, keep uint8 [N, N]), keep = 2 where D < relaxed, 1 at
    a tie, 0 where relaxed < D: the fold's outcome, which the backward reads
    instead of recomputing. D_new is differentiable by autograd (keep comes
    from comparisons)."""
    relaxed = _softmin_cells(d, we, graph, tau)[-1]
    keep = (d < relaxed).to(torch.uint8) * 2 + (d == relaxed).to(torch.uint8)
    return _fold(d, relaxed), keep


def _softmin_round_bwd_plain(
    g_new: torch.Tensor,
    d_prev: torch.Tensor,
    keep: torch.Tensor,
    we: torch.Tensor,
    graph: TeGraph,
    tau: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K15's plain version: (g_prev [N, N], g_we [E]) from g_new. The fold
    gives keep / 2 of g_new to the incumbent and the rest to the softmin;
    the softmin passes g_out * p_e to each candidate, p_e = exp(-(x_e - m)
    / tau) / s; a candidate's two F_INF clamps pass 1 below F_INF, 1/4 at
    it (a tie in each) and 0 above; the candidates' gradient gathers back
    to D's rows by destination and sums over t into g_we."""
    src, dst = graph.src.long(), graph.dst.long()
    total, m, s, out, _ = _softmin_cells(d_prev, we, graph, tau)
    gn = g_new.clone()
    gn.fill_diagonal_(0.0)
    k = 0.5 * keep.float()
    g_prev = gn * k
    g_out = torch.where(s > 0, gn * (1.0 - k) * _half_ties(out, F_INF), 0.0)
    coef = torch.where(s > 0, g_out / s.clamp_min(1.0), 0.0)
    x = total.clamp_max(F_INF)
    clamp = (total < F_INF).float() + 0.25 * (total == F_INF).float()
    g_x = coef[src] * torch.exp(-(x - m[src]) / tau) * clamp
    g_prev.index_add_(0, dst, g_x)
    return g_prev, g_x.sum(dim=1)


# -- plain PyTorch versions: K16, K17 ----------------------------------------


def _gate_score(d, we, up, graph: TeGraph, tau: float):
    """(gap [E, N], score [E, N]): the triangle gap (we + D[dst]) - D[src]
    and the gate's score exp(-max(gap, 0) / tau), 0 for a down edge, for t
    = src and where D[dst, t] >= F_INF / 2; differentiable by autograd with
    the reference's half gradient at gap = 0."""
    n = graph.n
    src, dst = graph.src.long(), graph.dst.long()
    gap = we[:, None] + d[dst] - d[src]
    node_t = torch.arange(n, device=d.device)
    live = up[:, None] & (src[:, None] != node_t[None, :]) & (
        d[dst] < F_INF / 2
    )
    zero = torch.zeros((), dtype=gap.dtype, device=gap.device)
    score = torch.where(live, torch.exp(-torch.maximum(gap, zero) / tau), 0.0)
    return gap, score


def _soft_gate_plain(d, we, up, graph: TeGraph, tau: float) -> torch.Tensor:
    """K16 gate's plain version: p [E, N] = score / denom by source where
    denom > 1e-20, else 0 (the reference's double where, NaN-free in the
    backward too); differentiable by autograd."""
    src = graph.src.long()
    _, score = _gate_score(d, we, up, graph, tau)
    denom = _seg_sum(score, src, graph.n)[src]
    ok = denom > 1e-20
    return torch.where(ok, score / torch.where(ok, denom, 1.0), 0.0)


def _soft_flow_round_plain(p, x, xsum, graph: TeGraph) -> torch.Tensor:
    """K16 round's plain version: x_next[b, v, t] = sum over v's in-edges of
    p[e, t] * x[b, src_e, t]; xsum += x in place when given."""
    ef = p[None] * x[:, graph.src.long()]
    x_next = _seg_sum(ef, graph.dst.long(), graph.n, dim=1)
    if xsum is not None:
        xsum += x
    return x_next


def _soft_flow_util_plain(p, xsum, caps, graph: TeGraph) -> torch.Tensor:
    """K16 utilization's plain version: util [B, E] = sum over t of p[e, t]
    * xsum[b, src_e, t], over max(caps, 1e-9)."""
    flow = (p[None] * xsum[:, graph.src.long()]).sum(dim=2)
    return flow / caps.clamp_min(1e-9)


def _soft_flow_plain(d, we, up, demands, caps, graph: TeGraph, tau: float,
                     rounds: int) -> torch.Tensor:
    """The gate, `rounds` flow rounds and the utilization [B, E] composed
    of the plain versions, differentiable by autograd in d and we."""
    p = _soft_gate_plain(d, we, up, graph, tau)
    eye = torch.eye(graph.n, dtype=torch.bool, device=d.device)
    x = demands.masked_fill(eye, 0.0)
    xsum = torch.zeros_like(x)
    for _ in range(rounds):
        xsum = xsum + x
        x = _soft_flow_round_plain(p, x, None, graph)
    return _soft_flow_util_plain(p, xsum, caps, graph)


def _soft_flow_bwd_round_plain(p, g_util, caps, lam_next, x_r, g_p,
                               graph: TeGraph, first: bool) -> torch.Tensor:
    """K17 round's plain version, one adjoint flow round: g_ef = g_util /
    max(caps, 1e-9) + lam_next[b, dst_e, t] (lam_next None: 0), lam[b, u, t]
    = sum over u's out-edges of p * g_ef, and g_p += sum over b of x_r[b,
    src_e, t] * g_ef (g_p is set, not added to, when `first`). Returns
    lam."""
    src, dst = graph.src.long(), graph.dst.long()
    g_ef = (g_util / caps.clamp_min(1e-9))[:, :, None]
    if lam_next is not None:
        g_ef = g_ef + lam_next[:, dst]
    else:
        g_ef = g_ef.expand(-1, -1, graph.n)
    part = (x_r[:, src] * g_ef).sum(dim=0)
    if first:
        g_p.copy_(part)
    else:
        g_p += part
    return _seg_sum(p[None] * g_ef, src, graph.n, dim=1)


def _soft_flow_bwd_scale_plain(g_util, caps) -> torch.Tensor:
    """K17 scale's plain version: c [B, E] = g_util / max(caps, 1e-9)."""
    return g_util / caps.clamp_min(1e-9)


def _soft_flow_adjoint_round_plain(p, c, lam_next, x_r, g_p,
                                   graph: TeGraph, first: bool):
    """K17 round's plain version with the scale c [B, E] given: the round
    of `_soft_flow_bwd_round_plain` with g_util = c over unit capacities (c
    / 1 is c exactly)."""
    return _soft_flow_bwd_round_plain(p, c, torch.ones_like(c[0]), lam_next,
                                      x_r, g_p, graph, first)


def _soft_gate_bwd_plain(g_p, d, we, up, graph: TeGraph, tau: float):
    """K17 gate's plain version: (g_d [N, N], g_we [E]) from g_p [E, N].
    The softmax-ratio rule g_score = (g_p - sum g_p p) / denom where denom >
    1e-20 (0 elsewhere, as the double-where gives), masked like the score,
    through exp, and through max(gap, 0) with half at gap = 0; the gap adds
    to D at the destination's row, subtracts at the source's, and sums
    over t into g_we."""
    n = graph.n
    src, dst = graph.src.long(), graph.dst.long()
    gap, score = _gate_score(d, we, up, graph, tau)
    denom = _seg_sum(score, src, n)
    s_gp = _seg_sum(g_p * score, src, n)
    ok = denom > 1e-20
    safe = torch.where(ok, denom, 1.0)
    g_score = torch.where(
        ok[src], (g_p - (s_gp / safe)[src]) / safe[src], 0.0
    )
    g_gap = -(g_score * score) / tau * _half_ties(-gap, 0.0)
    g_d = _seg_sum(g_gap, dst, n) - _seg_sum(g_gap, src, n)
    return g_d, g_gap.sum(dim=1)


# -- plain PyTorch versions: K18 ---------------------------------------------


def _te_mlu_plain(util, mask, tau_obj: float):
    """K18 MLU's plain version: (loss [1], lse [B]). loss is the mean over
    the unmasked scenarios of tau_obj * logsumexp(util[b] / tau_obj), the
    reference's logsumexp (shifted by the row max, which is not
    differentiated); differentiable by autograd in util."""
    a = util / tau_obj
    amax = a.amax(dim=1).detach()
    lse = torch.log(torch.exp(a - amax[:, None]).sum(dim=1)) + amax
    loss = (tau_obj * lse * mask).sum() / mask.sum().clamp_min(1.0)
    return loss.reshape(1), lse


def _te_mlu_bwd_plain(g_loss, util, lse, mask, tau_obj: float):
    """K18 seed's plain version: g_util [B, E] = g_loss * mask[b] /
    max(sum mask, 1) * softmax(util[b] / tau_obj)."""
    g_mlu = g_loss.reshape(()) * mask / mask.sum().clamp_min(1.0)
    soft = torch.exp(util / tau_obj - lse[:, None])
    return (g_mlu * tau_obj)[:, None] * soft / tau_obj


def _te_adam_plain(w, m, v, g, up, w_row, hp) -> None:
    """K18 Adam's plain version, in place: the reference's update with the
    down links' gradient zeroed, bias correction and the [w_min, w_max]
    projection; w_row gets the new w."""
    lr, b1, b2, eps, bc1, bc2, w_min, w_max = hp
    g = torch.where(up, g, 0.0)
    m.mul_(b1).add_(f32(1.0 - b1) * g)
    v.mul_(b2).add_(f32(1.0 - b2) * g * g)
    step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
    w.sub_(step).clamp_(w_min, w_max)
    w_row.copy_(w)


# -- wrappers: the kernel on the card, the plain version on the CPU ----------


def softmin_round(d: torch.Tensor, we: torch.Tensor, graph: TeGraph,
                  tau: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One softmin round (K14): D_prev [N, N] -> (D_new [N, N] float32,
    keep [N, N] uint8, the fold's outcome for the backward)."""
    dev = d.device
    _check_graph(graph, dev)
    _check_square("d", d, graph.n, dev)
    _check_edges("we", we, graph.e, torch.float32, dev)
    if dev.type != "cuda":
        return _softmin_round_plain(d, we, graph, tau)
    out = torch.empty_like(d)
    keep = torch.empty(d.shape, dtype=torch.uint8, device=dev)
    SOFTMIN_ROUND.launch(
        dev,
        d.data_ptr(), we.data_ptr(), graph.dst.data_ptr(),
        graph.out_ptr.data_ptr(), graph.out_perm.data_ptr(), out.data_ptr(),
        keep.data_ptr(), graph.n, f32(tau),
    )
    return out, keep


def softmin_round_bwd(g_new, d_prev, keep, we, graph: TeGraph, tau: float):
    """The backward of one softmin round (K15): (g_prev [N, N], g_we [E]),
    with keep from the forward. Deterministic: g_prev is a pull over
    in-edges, g_we a fixed-order sum of per-block partials."""
    dev = d_prev.device
    _check_graph(graph, dev)
    n = graph.n
    _check_square("g_new", g_new, n, dev)
    _check_square("d_prev", d_prev, n, dev)
    _check("keep", keep, torch.uint8, 2, dev)
    if keep.shape != (n, n):
        raise ValueError(f"keep must be [{n}, {n}]")
    _check_edges("we", we, graph.e, torch.float32, dev)
    if dev.type != "cuda":
        return _softmin_round_bwd_plain(g_new, d_prev, keep, we, graph, tau)
    nc = _chunks(n)
    g_prev = torch.empty_like(d_prev)
    # (coef, m) of every (u, t) side by side: the pull gathers 8 bytes an
    # in-edge
    cm = torch.empty((n, n, 2), dtype=torch.float32, device=dev)
    partial = torch.empty((graph.e, nc), dtype=torch.float32, device=dev)
    g_we = torch.empty_like(we)
    tau = f32(tau)
    SOFTMIN_BWD.launch(
        dev,
        g_new.data_ptr(), d_prev.data_ptr(), keep.data_ptr(), we.data_ptr(),
        graph.dst.data_ptr(), graph.out_ptr.data_ptr(),
        graph.out_perm.data_ptr(), g_prev.data_ptr(), cm.data_ptr(),
        partial.data_ptr(), n, nc, tau,
        entry="softmin_bwd_rows",
    )
    SOFTMIN_BWD.launch(
        dev,
        d_prev.data_ptr(), we.data_ptr(), graph.src.data_ptr(),
        graph.in_ptr.data_ptr(), graph.in_perm.data_ptr(), cm.data_ptr(),
        g_prev.data_ptr(), n, tau,
        entry="softmin_bwd_pull",
    )
    SOFTMIN_BWD.launch(dev, partial.data_ptr(), g_we.data_ptr(), graph.e, nc,
                       entry="softmin_bwd_edges")
    return g_prev, g_we


def softmin_div_check(tau: float, device="cuda") -> int:
    """On the card: the count of exponents a (every float a <= 0 with |a|
    <= 2^32, the domain of K14-K17's exponents -(x - m) and -max(gap, 0))
    at which exp(a / tau), the quotient taken from tau's reciprocal,
    differs in its bits from exp of the correctly rounded division. 0 means
    the kernels compute the bits of `__fdiv_rn` for this tau. There is no
    CPU version: it checks the card's arithmetic."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("softmin_div_check checks the card's arithmetic")
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    SOFTMIN_DIV_CHECK.launch(dev, f32(tau), count.data_ptr())
    return int(count.item())


def soft_gate(d, we, up, graph: TeGraph, tau: float) -> torch.Tensor:
    """The gate (K16): the split p [E, N] float32."""
    dev = d.device
    _check_graph(graph, dev)
    _check_square("d", d, graph.n, dev)
    _check_edges("we", we, graph.e, torch.float32, dev)
    _check_edges("up", up, graph.e, torch.bool, dev)
    if dev.type != "cuda":
        return _soft_gate_plain(d, we, up, graph, tau)
    p = torch.empty((graph.e, graph.n), dtype=torch.float32, device=dev)
    SOFT_FLOW.launch(
        dev,
        d.data_ptr(), we.data_ptr(), up.data_ptr(), graph.dst.data_ptr(),
        graph.out_ptr.data_ptr(), graph.out_perm.data_ptr(), p.data_ptr(),
        graph.n, f32(tau), entry="soft_gate",
    )
    return p


def soft_flow_round(p, x, xsum: Optional[torch.Tensor],
                    graph: TeGraph) -> torch.Tensor:
    """One flow round for all scenarios (K16): x [B, N, N] -> x_next; xsum
    += x in place when given."""
    dev = p.device
    _check_graph(graph, dev)
    _check("p", p, torch.float32, 2, dev)
    b = _check_batch("x", x, graph.n, dev)
    if xsum is not None and _check_batch("xsum", xsum, graph.n, dev) != b:
        raise ValueError("x and xsum differ in scenarios")
    if dev.type != "cuda":
        return _soft_flow_round_plain(p, x, xsum, graph)
    x_next = torch.empty_like(x)
    SOFT_FLOW.launch(
        dev,
        p.data_ptr(), x.data_ptr(),
        xsum.data_ptr() if xsum is not None else None, x_next.data_ptr(),
        graph.src.data_ptr(), graph.in_ptr.data_ptr(),
        graph.in_perm.data_ptr(), graph.n, b, entry="soft_flow_round",
    )
    return x_next


def soft_flow_util(p, xsum, caps, graph: TeGraph) -> torch.Tensor:
    """The utilization (K16): util [B, E] float32."""
    dev = p.device
    _check_graph(graph, dev)
    _check("p", p, torch.float32, 2, dev)
    b = _check_batch("xsum", xsum, graph.n, dev)
    _check_edges("caps", caps, graph.e, torch.float32, dev)
    if dev.type != "cuda":
        return _soft_flow_util_plain(p, xsum, caps, graph)
    util = torch.empty((b, graph.e), dtype=torch.float32, device=dev)
    SOFT_FLOW.launch(
        dev,
        p.data_ptr(), xsum.data_ptr(), caps.data_ptr(), graph.src.data_ptr(),
        util.data_ptr(), graph.n, graph.e, b, entry="soft_flow_util",
    )
    return util


def soft_flow_bwd_scale(g_util, caps) -> torch.Tensor:
    """The adjoint rounds' scale (K17), once per backward: c [B, E] =
    g_util / max(caps, 1e-9)."""
    dev = g_util.device
    _check("g_util", g_util, torch.float32, 2, dev)
    b, e = g_util.shape
    _check_edges("caps", caps, e, torch.float32, dev)
    if dev.type != "cuda":
        return _soft_flow_bwd_scale_plain(g_util, caps)
    c = torch.empty_like(g_util)
    SOFT_FLOW_BWD.launch(dev, g_util.data_ptr(), caps.data_ptr(),
                         c.data_ptr(), e, b, entry="soft_flow_bwd_scale")
    return c


def soft_flow_adjoint_round(p, c, lam_next, x_r, g_p, graph: TeGraph,
                            first: bool) -> torch.Tensor:
    """One adjoint flow round (K17) with the scale c [B, E] of
    `soft_flow_bwd_scale`: returns lam [B, N, N]; g_p [E, N] is set
    (`first`) or added to in place. lam_next None stands for 0."""
    dev = p.device
    _check_graph(graph, dev)
    _check("p", p, torch.float32, 2, dev)
    _check("g_p", g_p, torch.float32, 2, dev)
    if p.shape != (graph.e, graph.n) or g_p.shape != p.shape:
        raise ValueError(f"p and g_p must be [{graph.e}, {graph.n}]")
    b = _check_batch("x_r", x_r, graph.n, dev)
    if lam_next is not None and _check_batch(
            "lam_next", lam_next, graph.n, dev) != b:
        raise ValueError("lam_next and x_r differ in scenarios")
    _check("c", c, torch.float32, 2, dev)
    if c.shape != (b, graph.e):
        raise ValueError(f"c must be [{b}, {graph.e}]")
    if dev.type != "cuda":
        return _soft_flow_adjoint_round_plain(p, c, lam_next, x_r, g_p,
                                              graph, first)
    lam = torch.empty_like(x_r)
    SOFT_FLOW_BWD.launch(
        dev,
        p.data_ptr(), c.data_ptr(),
        lam_next.data_ptr() if lam_next is not None else None,
        x_r.data_ptr(), g_p.data_ptr(), lam.data_ptr(), graph.dst.data_ptr(),
        graph.out_ptr.data_ptr(), graph.out_perm.data_ptr(), graph.n,
        graph.e, b, int(first), entry="soft_flow_bwd_round",
    )
    return lam


def soft_flow_bwd_round(p, g_util, caps, lam_next, x_r, g_p,
                        graph: TeGraph, first: bool) -> torch.Tensor:
    """One adjoint flow round (K17) from g_util and caps: the scale, then
    the round (two launches on the card; `SoftFlow` takes the scale once per
    backward). Returns lam [B, N, N]; g_p [E, N] is set (`first`) or added
    to in place. lam_next None stands for 0."""
    return soft_flow_adjoint_round(p, soft_flow_bwd_scale(g_util, caps),
                                   lam_next, x_r, g_p, graph, first)


def soft_gate_bwd(g_p, d, we, up, graph: TeGraph, tau: float):
    """The gate's backward (K17): (g_d [N, N], g_we [E]) from g_p [E, N],
    which the kernel overwrites with the gap's gradient."""
    dev = d.device
    _check_graph(graph, dev)
    n = graph.n
    _check("g_p", g_p, torch.float32, 2, dev)
    if g_p.shape != (graph.e, n):
        raise ValueError(f"g_p must be [{graph.e}, {n}]")
    _check_square("d", d, n, dev)
    _check_edges("we", we, graph.e, torch.float32, dev)
    _check_edges("up", up, graph.e, torch.bool, dev)
    if dev.type != "cuda":
        return _soft_gate_bwd_plain(g_p, d, we, up, graph, tau)
    nc = _chunks(n)
    g_d = torch.empty_like(d)
    partial = torch.empty((graph.e, nc), dtype=torch.float32, device=dev)
    g_we = torch.empty_like(we)
    SOFT_FLOW_BWD.launch(
        dev,
        g_p.data_ptr(), d.data_ptr(), we.data_ptr(), up.data_ptr(),
        graph.dst.data_ptr(), graph.out_ptr.data_ptr(),
        graph.out_perm.data_ptr(), g_d.data_ptr(), partial.data_ptr(), n,
        nc, f32(tau), entry="soft_gate_bwd_rows",
    )
    SOFT_FLOW_BWD.launch(
        dev,
        g_p.data_ptr(), graph.in_ptr.data_ptr(), graph.in_perm.data_ptr(),
        g_d.data_ptr(), n, entry="soft_gate_bwd_pull",
    )
    SOFT_FLOW_BWD.launch(dev, partial.data_ptr(), g_we.data_ptr(), graph.e, nc,
                         entry="soft_gate_bwd_edges")
    return g_d, g_we


def _check_util(util, mask, dev) -> Tuple[int, int]:
    _check("util", util, torch.float32, 2, dev)
    b, e = util.shape
    _check_edges("mask", mask, b, torch.float32, dev)
    return b, e


def te_mlu(util, mask, tau_obj: float):
    """The scenario-averaged soft MLU (K18): (loss [1], lse [B]), lse[b] =
    logsumexp(util[b] / tau_obj)."""
    dev = util.device
    b, e = _check_util(util, mask, dev)
    if dev.type != "cuda":
        return _te_mlu_plain(util, mask, tau_obj)
    loss = torch.empty(1, dtype=torch.float32, device=dev)
    lse = torch.empty(b, dtype=torch.float32, device=dev)
    TE_STEP.launch(dev, util.data_ptr(), mask.data_ptr(), lse.data_ptr(),
                   loss.data_ptr(), b, e, f32(tau_obj), entry="te_mlu")
    return loss, lse


def te_mlu_bwd(g_loss, util, lse, mask, tau_obj: float) -> torch.Tensor:
    """The MLU's gradient seed (K18): g_util [B, E] from g_loss [1]."""
    dev = util.device
    b, e = _check_util(util, mask, dev)
    _check_edges("g_loss", g_loss, 1, torch.float32, dev)
    _check_edges("lse", lse, b, torch.float32, dev)
    if dev.type != "cuda":
        return _te_mlu_bwd_plain(g_loss, util, lse, mask, tau_obj)
    g_util = torch.empty_like(util)
    TE_STEP.launch(dev, g_loss.data_ptr(), util.data_ptr(), lse.data_ptr(),
                   mask.data_ptr(), g_util.data_ptr(), b, e, f32(tau_obj),
                   entry="te_mlu_bwd")
    return g_util


def adam_hparams(cfg, i: int) -> Tuple[float, ...]:
    """Step i's Adam constants in float32, as the reference's traced step
    computes them: (lr, beta1, beta2, eps, 1 - beta1 ** (i + 1), 1 - beta2
    ** (i + 1), w_min, w_max)."""
    one, k = np.float32(1.0), np.float32(i) + np.float32(1.0)
    b1, b2 = np.float32(cfg.beta1), np.float32(cfg.beta2)
    return (f32(cfg.lr), float(b1), float(b2), f32(cfg.eps),
            float(one - b1 ** k), float(one - b2 ** k), f32(cfg.w_min),
            f32(cfg.w_max))


def te_adam(w, m, v, g, up, w_row, hp: Tuple[float, ...]) -> None:
    """One Adam step (K18), in place on w, m, v [E]; w_row [E] (a row of
    the weight trajectory) receives the new w. hp from `adam_hparams`."""
    dev = w.device
    e = w.shape[0] if w.dim() == 1 else -1
    for name, t in (("w", w), ("m", m), ("v", v), ("g", g), ("w_row", w_row)):
        _check_edges(name, t, e, torch.float32, dev)
    _check_edges("up", up, e, torch.bool, dev)
    if dev.type != "cuda":
        _te_adam_plain(w, m, v, g, up, w_row, hp)
        return
    TE_STEP.launch(dev, w.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                   up.data_ptr(), w_row.data_ptr(), e, *hp, entry="te_adam")


# -- autograd ----------------------------------------------------------------


class SoftminRound(torch.autograd.Function):
    """One softmin round, differentiable in D_prev and we: K14 forward,
    K15 backward (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, d, we, graph: TeGraph, tau: float):
        new, keep = softmin_round(d, we, graph, tau)
        ctx.save_for_backward(d, keep, we)
        ctx.graph, ctx.tau = graph, tau
        return new

    @staticmethod
    def backward(ctx, g_new):
        d, keep, we = ctx.saved_tensors
        g_prev, g_we = softmin_round_bwd(g_new.contiguous(), d, keep, we,
                                         ctx.graph, ctx.tau)
        return (g_prev if ctx.needs_input_grad[0] else None), g_we, None, None


def _flow_rounds(p, x, xsum, graph: TeGraph, count: int) -> List[torch.Tensor]:
    """x and the next count - 1 rounds' flows (xsum accumulates all count
    rounds when given); returns the count flows x_r, r = 0 .. count - 1, and
    the one after as the last element."""
    xs = [x]
    for _ in range(count):
        xs.append(soft_flow_round(p, xs[-1], xsum, graph))
    return xs


class SoftFlow(torch.autograd.Function):
    """The gate, the flow rounds and the utilization [B, E], differentiable
    in D and we: K16 forward, K17 backward (the plain versions on the
    CPU). The backward walks the rounds in reverse a segment of
    FLOW_CHECKPOINT rounds at a time, recomputing each segment's flows from
    its first."""

    @staticmethod
    def forward(ctx, d, we, up, demands, caps, graph: TeGraph, tau: float,
                rounds: int):
        p = soft_gate(d, we, up, graph, tau)
        eye = torch.eye(graph.n, dtype=torch.bool, device=d.device)
        x = demands.masked_fill(eye, 0.0)
        xsum = torch.zeros_like(x)
        starts = list(range(0, rounds, FLOW_CHECKPOINT))
        kept = []
        for r0 in starts:
            kept.append(x)
            count = min(FLOW_CHECKPOINT, rounds - r0)
            x = _flow_rounds(p, x, xsum, graph, count)[-1]
        util = soft_flow_util(p, xsum, caps, graph)
        ctx.save_for_backward(d, we, up, caps, p, *kept)
        ctx.graph, ctx.tau, ctx.rounds = graph, tau, rounds
        return util

    @staticmethod
    def backward(ctx, g_util):
        d, we, up, caps, p, *kept = ctx.saved_tensors
        graph, rounds = ctx.graph, ctx.rounds
        c = soft_flow_bwd_scale(g_util.contiguous(), caps)
        g_p = torch.empty_like(p)
        lam = None
        for k in reversed(range(len(kept))):
            r0 = k * FLOW_CHECKPOINT
            count = min(FLOW_CHECKPOINT, rounds - r0)
            xs = _flow_rounds(p, kept[k], None, graph, count - 1)
            for j in reversed(range(count)):
                lam = soft_flow_adjoint_round(p, c, lam, xs[j], g_p, graph,
                                              first=r0 + j == rounds - 1)
            del xs
        g_d, g_we = soft_gate_bwd(g_p, d, we, up, graph, ctx.tau)
        return g_d, g_we, None, None, None, None, None, None


class SoftMlu(torch.autograd.Function):
    """The scenario-averaged soft MLU of util [B, E] as a one-element
    tensor, differentiable in util: K18's MLU forward and its gradient seed
    (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, util, mask, tau_obj: float):
        loss, lse = te_mlu(util, mask, tau_obj)
        ctx.save_for_backward(util, lse, mask)
        ctx.tau_obj = tau_obj
        return loss

    @staticmethod
    def backward(ctx, g_loss):
        util, lse, mask = ctx.saved_tensors
        g_util = te_mlu_bwd(g_loss.reshape(1).contiguous(), util, lse, mask,
                            ctx.tau_obj)
        return g_util, None, None
