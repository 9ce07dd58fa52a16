"""The port's differentiable TE (openr_tpu_torch/te/) against the JAX
package's (openr_tpu/te/), on the CPU.

The same numpy inputs go through both packages (the port's through
`convert.te_inputs` or its public functions with device="cpu"). Copies are
exact: `te_edge_arrays`, the hard scoring functions and
`build_demand_scenarios`. The relaxation is float32 arithmetic in another
order (segment sums, exp and log of another library), so:

  - distances: rtol 1e-5 (with an absolute floor of 1e-5 near 0), and the
    F_INF entries equal exactly; utilizations and the MLU: 1e-5 of the
    largest;
  - gradients in w: within 1e-4 of max |g|. The port's explicit backward
    drops the stabiliser's gradient, which the reference keeps at rounding
    level, and its sums run in another order;
  - the 8-step Adam trajectory: 2e-4 absolute on weights in [1, 64], the
    losses 1e-5 relative: Adam divides each step by the root of the
    gradient's second moment, so a relative gradient difference of 1e-7
    moves a weight by up to lr * 1e-7 per step, and later steps see the
    moved weights.

The graphs are the reference's TOPOLOGIES (tests/test_te_objective.py) plus
a pendant node (one out-edge: its triangle gap is exactly 0, the max(gap,
0) tie), a link down in one direction, and weights on both sides of 32 (the
float32 spacing at F_INF = 1e9 is 64, so we + F_INF == F_INF exactly for
we <= 32 and the candidate clamps tie), so the tie rules of the reference's
reverse mode are exercised, and checked to be. Each kernel's explicit
backward is also held against autograd through its plain forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.lsdb import LinkState as JLinkState
from openr_tpu.ops.graph import compile_graph as j_compile_graph
from openr_tpu.te import objective as jo
from openr_tpu.te import optimizer as jopt
from openr_tpu.te import scenarios as jsc
from openr_tpu.topology import build_adj_dbs as j_build_adj_dbs
from openr_tpu.topology import fabric_edges as j_fabric
from openr_tpu.topology import grid_edges as j_grid
from openr_tpu_torch.convert import te_graph, te_inputs
from openr_tpu_torch.lsdb import LinkState as TLinkState
from openr_tpu_torch.ops.graph import compile_graph as t_compile_graph
from openr_tpu_torch.te import kernels as tk
from openr_tpu_torch.te import objective as to
from openr_tpu_torch.te import optimizer as topt
from openr_tpu_torch.te import scenarios as tsc
from openr_tpu_torch.topology import build_adj_dbs as t_build_adj_dbs
from test_te_objective import TOPOLOGIES
from test_torch_cuda import (
    mlu_case,
    mlu_first_design,
    mlu_seed_first_design,
)
from test_torch_memory import release_memory_around_each_test  # noqa: F401

TAUS = (2.0, 0.5, 0.05)


def graphs(edges, ls_cls, build_adj_dbs, down=None):
    """The compiled graph of `edges` in one package, with `down` = (a, b)
    taken down in the a -> b direction only."""
    dbs = build_adj_dbs(edges)
    if down is not None:
        a, b = down
        dbs[a] = dataclasses.replace(dbs[a], adjacencies=[
            dataclasses.replace(adj, is_overloaded=True)
            if adj.other_node_name == b else adj
            for adj in dbs[a].adjacencies
        ])
    ls = ls_cls("0")
    for db in dbs.values():
        ls.update_adjacency_database(db)
    return ls


def te_case(topo, seed=3):
    """(n, src, dst, w, up) from the reference's compile of topo(seed) with
    a pendant node, one link down in one direction, and four weights at 31,
    32, 33.5 and 40."""
    edges = topo(seed)
    edges = edges + [("pendant", edges[0][0], 3)]
    graph = j_compile_graph(
        graphs(edges, JLinkState, j_build_adj_dbs, down=edges[1][:2]))
    src, dst, w, up = jo.te_edge_arrays(graph)
    w[np.flatnonzero(up)[:4]] = [31.0, 32.0, 33.5, 40.0]
    return graph.n, src, dst, w, up


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def assert_distances(got, want):
    fin = want < jo.F_INF / 2
    np.testing.assert_array_equal(got[~fin], want[~fin])
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


# -- copies: exact -----------------------------------------------------------


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_edge_arrays_and_hard_scoring_equal_the_reference(topo, seed):
    edges = topo(seed)
    jg = j_compile_graph(graphs(edges, JLinkState, j_build_adj_dbs,
                                down=edges[2][:2]))
    tg = t_compile_graph(graphs(edges, TLinkState, t_build_adj_dbs,
                                down=edges[2][:2]))
    ja, ta = jo.te_edge_arrays(jg), to.te_edge_arrays(tg)
    for x, y in zip(ja, ta):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    src, dst, w0, up = ta
    n = tg.n
    assert not up.all()
    rng = np.random.default_rng(seed)
    dem = (rng.uniform(0, 2, (n, n)) * (1 - np.eye(n))).astype(np.float32)
    caps = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    w_int = np.rint(w0).astype(np.int64)
    w_int[::3] += 2
    d = jo.hard_distances(w_int, src, dst, up, n)
    np.testing.assert_array_equal(to.hard_distances(w_int, src, dst, up, n), d)
    for dd in (None, d):
        np.testing.assert_array_equal(
            to.hard_utilization(w_int, dem, caps, src, dst, up, n, d=dd),
            jo.hard_utilization(w_int, dem, caps, src, dst, up, n, d=dd))
    assert to.hard_max_util(w_int, dem, caps, src, dst, up, n) == \
        jo.hard_max_util(w_int, dem, caps, src, dst, up, n)


@pytest.mark.parametrize("seed", [0, 5])
def test_demand_scenarios_equal_the_reference(seed):
    from openr_tpu.topology import grid_edges

    edges = grid_edges(3)
    jg = j_compile_graph(graphs(edges, JLinkState, j_build_adj_dbs))
    tg = t_compile_graph(graphs(edges, TLinkState, t_build_adj_dbs))
    specs = [
        None,
        {"demands": [["g0_0", "g2_2", 4.0], ["ghost", "g0_0", 9.0],
                     ["g1_1", "g0_2", 1.5]],
         "capacities": {"default": 2.0, "links": [["g0_0", "g0_1", 8.0]]},
         "scenarios": 3, "scenario_spread": 0.25},
        dict(jsc.uniform_demand_spec(list(jg.names)), scenarios=4),
    ]
    for spec in specs:
        want = jsc.build_demand_scenarios(jg, spec, seed=seed)
        got = tsc.build_demand_scenarios(tg, spec, seed=seed)
        for x, y in zip(want[:2], got[:2]):
            np.testing.assert_array_equal(x, y)
        assert want[2] == got[2]
    assert tsc.congested_clos_fixture() == jsc.congested_clos_fixture()
    assert tsc.uniform_demand_spec(["a", "b"]) == jsc.uniform_demand_spec(
        ["a", "b"])


# -- the objective: values and gradients against jax.grad --------------------


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("full", [False, True], ids=["rounds2", "roundsN"])
def test_softmin_distances_and_gradient_match_jax(topo, full):
    n, src, dst, w, up = te_case(topo)
    rounds = n if full else 2
    r = np.random.default_rng(1).standard_normal((n, n)).astype(np.float32)
    for tau in TAUS:
        want = np.asarray(jo.softmin_distances(w, src, dst, up, tau, n=n,
                                               rounds=rounds))
        wt = torch.tensor(w, requires_grad=True)
        got = to.softmin_distances(wt, src, dst, up, tau, n, rounds,
                                   device="cpu")
        assert_distances(got.detach().numpy(), want)
        g_want = np.asarray(jax.grad(lambda x: jnp.sum(jo.softmin_distances(
            x, src, dst, up, tau, n=n, rounds=rounds) * r))(jnp.asarray(w)))
        (got * torch.tensor(r)).sum().backward()
        assert rel_err(wt.grad.numpy(), g_want) <= 1e-4, tau
        assert not wt.grad.numpy()[~up].any()


def test_the_cases_hit_the_tie_rules():
    """The inputs above reach each tie: a candidate at F_INF exactly (a
    weight <= 32 onto an unreachable entry), one above it (a weight > 32),
    a triangle gap of exactly 0 and an incumbent equal to its softmin."""
    n, src, dst, w, up = te_case(TOPOLOGIES[1].values[0])
    graph = te_graph(src, dst, n, "cpu")
    we = to.edge_weights(torch.tensor(w), torch.tensor(up))
    d = to.softmin_core(we, graph, 0.5, 2)
    total, _, _, _, relaxed = tk._softmin_cells(d, we, graph, 0.5)
    assert bool((total == tk.F_INF).any()) and bool((total > tk.F_INF).any())
    assert bool((d == relaxed).any())
    d = to.softmin_core(we, graph, 0.5, n)
    gap, score = tk._gate_score(d, we, torch.tensor(up), graph, 0.5)
    assert bool(((gap == 0) & (score > 0)).any())


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("full", [False, True], ids=["rounds2", "roundsN"])
def test_soft_utilization_and_gradient_match_jax(topo, full):
    n, src, dst, w, up = te_case(topo)
    rounds = n if full else 2
    rng = np.random.default_rng(2)
    dem = (rng.uniform(0, 2, (n, n)) * (1 - np.eye(n))).astype(np.float32)
    caps = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    r = rng.standard_normal(len(src)).astype(np.float32)
    for tau in TAUS:
        want = np.asarray(jo.soft_utilization(w, dem, caps, src, dst, up,
                                              tau, n=n, rounds=rounds))
        wt = torch.tensor(w, requires_grad=True)
        got = to.soft_utilization(wt, dem, caps, src, dst, up, tau, n,
                                  rounds, device="cpu")
        assert rel_err(got.detach().numpy(), want) <= 1e-5, tau
        g_want = np.asarray(jax.grad(lambda x: jnp.sum(jo.soft_utilization(
            x, dem, caps, src, dst, up, tau, n=n, rounds=rounds) * r))(
            jnp.asarray(w)))
        (got * torch.tensor(r)).sum().backward()
        assert rel_err(wt.grad.numpy(), g_want) <= 1e-4, tau


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_soft_mlu_and_gradient_match_jax(topo):
    n, src, dst, w, up = te_case(topo)
    rng = np.random.default_rng(4)
    dem = (rng.uniform(0, 2, (n, n)) * (1 - np.eye(n))).astype(np.float32)
    caps = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    for tau in TAUS:
        args = (dem, caps, src, dst, up, tau, 0.25)
        want = float(jo.soft_mlu(w, *args, n=n, rounds=n))
        g_want = np.asarray(jax.grad(lambda x: jo.soft_mlu(
            x, *args, n=n, rounds=n))(jnp.asarray(w)))
        wt = torch.tensor(w, requires_grad=True)
        got = to.soft_mlu(wt, *args, n, n, device="cpu")
        assert got.dim() == 0
        assert float(got.detach()) == pytest.approx(want, rel=1e-5)
        got.backward()
        assert rel_err(wt.grad.numpy(), g_want) <= 1e-4, tau


def test_unsorted_edges_and_a_node_without_out_edges_match_jax():
    """Edges in no particular order (the edge ranges are permutations) and
    a sink node with no out-edge (an empty segment: F_INF, no gradient)."""
    src = np.array([2, 0, 1, 4, 0, 2, 1, 4], np.int32)
    dst = np.array([1, 1, 3, 2, 2, 4, 0, 3], np.int32)
    w = np.array([3.0, 1.0, 2.0, 40.0, 5.0, 1.5, 2.5, 31.0], np.float32)
    up = np.ones(8, bool)
    n = 5
    r = np.random.default_rng(3).standard_normal((n, n)).astype(np.float32)
    for tau in (2.0, 0.05):
        want = np.asarray(jo.softmin_distances(w, src, dst, up, tau, n=n,
                                               rounds=n))
        g_want = np.asarray(jax.grad(lambda x: jnp.sum(jo.softmin_distances(
            x, src, dst, up, tau, n=n, rounds=n) * r))(jnp.asarray(w)))
        wt = torch.tensor(w, requires_grad=True)
        got = to.softmin_distances(wt, src, dst, up, tau, n, n, device="cpu")
        assert_distances(got.detach().numpy(), want)
        assert (want[3, :3] == jo.F_INF).all()  # node 3 reaches nothing
        (got * torch.tensor(r)).sum().backward()
        assert rel_err(wt.grad.numpy(), g_want) <= 1e-4


def test_te_graph_orders_nodes_by_out_degree():
    """`out_order`, the gate's block order (the most work first), lists
    every node once, by out-degree from the largest, ties by node id."""
    src = np.array([2, 0, 1, 4, 0, 2, 1, 4, 2], np.int32)
    dst = np.array([1, 1, 3, 2, 2, 4, 0, 3, 0], np.int32)
    graph = te_graph(src, dst, 5, "cpu")
    assert graph.out_order.dtype == torch.int32
    assert graph.out_order.tolist() == [2, 0, 1, 4, 3]


# -- the explicit backward versions against autograd --------------------------


def mid_anneal(topo, tau, rounds=3):
    n, src, dst, w, up = te_case(topo)
    graph = te_graph(src, dst, n, "cpu")
    up_t = torch.tensor(up)
    we = to.edge_weights(torch.tensor(w), up_t)
    d = to.softmin_core(we, graph, tau, rounds)
    return n, graph, we, up_t, d


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("tau", TAUS)
def test_softmin_round_backward_matches_autograd(topo, tau):
    """K15's plain version against autograd through K14's plain version,
    one round from a D three rounds in (so F_INF entries remain)."""
    n, graph, we, _, d = mid_anneal(topo, tau)
    g_new = torch.tensor(np.random.default_rng(5).standard_normal((n, n)),
                         dtype=torch.float32)
    d_v = d.clone().requires_grad_(True)
    we_v = we.clone().requires_grad_(True)
    out = tk._softmin_round_plain(d_v, we_v, graph, tau)[0]
    new, keep = tk.softmin_round(d, we, graph, tau)
    assert torch.equal(out, new) and bool((keep == 1).any())
    g_d, g_we = torch.autograd.grad(out, (d_v, we_v), g_new)
    g_prev, g_we2 = tk.softmin_round_bwd(g_new, d, keep, we, graph, tau)
    assert rel_err(g_prev.numpy(), g_d.numpy()) <= 1e-5
    assert rel_err(g_we2.numpy(), g_we.numpy()) <= 1e-5


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("tau", TAUS)
def test_soft_flow_backward_matches_autograd(topo, tau):
    """K17's plain versions (adjoint rounds and gate backward, through
    SoftFlow) against autograd through K16's plain composition."""
    n, graph, we, up_t, d = mid_anneal(topo, tau, rounds=6)
    rng = np.random.default_rng(6)
    dem = torch.tensor(rng.uniform(0, 2, (3, n, n)), dtype=torch.float32)
    caps = torch.tensor(rng.uniform(0.5, 2, graph.e), dtype=torch.float32)
    g_util = torch.tensor(rng.standard_normal((3, graph.e)),
                          dtype=torch.float32)
    d_v = d.clone().requires_grad_(True)
    we_v = we.clone().requires_grad_(True)
    util = tk._soft_flow_plain(d_v, we_v, up_t, dem, caps, graph, tau, 7)
    g_d, g_we = torch.autograd.grad(util, (d_v, we_v), g_util)
    d_k = d.clone().requires_grad_(True)
    we_k = we.clone().requires_grad_(True)
    util_k = tk.SoftFlow.apply(d_k, we_k, up_t, dem, caps, graph, tau, 7)
    assert rel_err(util_k.detach().numpy(), util.detach().numpy()) <= 1e-6
    g_d2, g_we2 = torch.autograd.grad(util_k, (d_k, we_k), g_util)
    assert rel_err(g_d2.numpy(), g_d.numpy()) <= 1e-5
    assert rel_err(g_we2.numpy(), g_we.numpy()) <= 1e-5


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("lam_given", [False, True],
                         ids=["lam_none", "lam_next"])
def test_the_hoisted_scale_gives_the_adjoint_round_bit_for_bit(first,
                                                             lam_given):
    """K17's scale taken once (`soft_flow_bwd_scale`, then
    `soft_flow_adjoint_round`) against the round that divides g_util by
    the capacities itself (`_soft_flow_bwd_round_plain`): the same lam and
    g_p bit for bit, and so through the public round's CPU path."""
    n, graph, _, _, _ = mid_anneal(TOPOLOGIES[0].values[0], 0.5)
    rng = np.random.default_rng(9)
    b = 5

    def f32(*shape, lo=None):
        a = (rng.uniform(lo, 2, shape) if lo is not None
             else rng.standard_normal(shape))
        return torch.tensor(a, dtype=torch.float32)

    p, x_r = f32(graph.e, n, lo=0), f32(b, n, n, lo=0)
    g_util, caps = f32(b, graph.e), f32(graph.e, lo=0.5)
    caps[0] = 0.0  # the clamp to 1e-9
    lam_next = f32(b, n, n) if lam_given else None
    g_p0 = f32(graph.e, n)
    c = tk.soft_flow_bwd_scale(g_util, caps)
    assert torch.equal(c, g_util / caps.clamp_min(1e-9))
    runs = []
    for fn, args in (
            (tk._soft_flow_bwd_round_plain, (p, g_util, caps)),
            (tk.soft_flow_adjoint_round, (p, c)),
            (tk.soft_flow_bwd_round, (p, g_util, caps))):
        g_p = g_p0.clone()
        lam = fn(*args, lam_next, x_r, g_p, graph, first)
        runs.append((lam, g_p))
    for lam, g_p in runs[1:]:
        assert torch.equal(lam, runs[0][0]) and torch.equal(g_p, runs[0][1])


def test_soft_flow_backward_equals_the_per_round_division():
    """SoftFlow's backward (the scale once, then the adjoint rounds over
    recomputed flows) against the loop it replaced, every round dividing
    g_util by the capacities: the same g_D and g_we bit for bit."""
    n, graph, we, up_t, d = mid_anneal(TOPOLOGIES[0].values[0], 0.5, 6)
    rng = np.random.default_rng(10)
    dem = torch.tensor(rng.uniform(0, 2, (3, n, n)), dtype=torch.float32)
    caps = torch.tensor(rng.uniform(0.5, 2, graph.e), dtype=torch.float32)
    g_util = torch.tensor(rng.standard_normal((3, graph.e)),
                          dtype=torch.float32)
    rounds, tau = 7, 0.5
    d_k, we_k = d.clone().requires_grad_(True), we.clone().requires_grad_(True)
    util = tk.SoftFlow.apply(d_k, we_k, up_t, dem, caps, graph, tau, rounds)
    got = torch.autograd.grad(util, (d_k, we_k), g_util)
    p = tk._soft_gate_plain(d, we, up_t, graph, tau)
    xs = [dem.masked_fill(torch.eye(n, dtype=torch.bool), 0.0)]
    for _ in range(rounds - 1):
        xs.append(tk._soft_flow_round_plain(p, xs[-1], None, graph))
    g_p, lam = torch.empty_like(p), None
    for r in reversed(range(rounds)):
        lam = tk._soft_flow_bwd_round_plain(p, g_util, caps, lam, xs[r], g_p,
                                            graph, r == rounds - 1)
    want = tk._soft_gate_bwd_plain(g_p, d, we, up_t, graph, tau)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("checkpoint", [1, 3, 7, 9])
def test_flow_checkpoints_do_not_change_the_gradient(monkeypatch, checkpoint):
    """SoftFlow keeps one flow in FLOW_CHECKPOINT and recomputes the rest:
    any interval (one that divides the rounds or not, or exceeds them)
    gives the same values bit for bit."""
    n, graph, we, up_t, d = mid_anneal(TOPOLOGIES[0].values[0], 0.5, 6)
    rng = np.random.default_rng(7)
    dem = torch.tensor(rng.uniform(0, 2, (2, n, n)), dtype=torch.float32)
    caps = torch.ones(graph.e)
    g_util = torch.tensor(rng.standard_normal((2, graph.e)),
                          dtype=torch.float32)

    def run():
        d_k = d.clone().requires_grad_(True)
        util = tk.SoftFlow.apply(d_k, we, up_t, dem, caps, graph, 0.5, 8)
        (g,) = torch.autograd.grad(util, d_k, g_util)
        return util.detach(), g

    want = run()
    monkeypatch.setattr(tk, "FLOW_CHECKPOINT", checkpoint)
    got = run()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_mlu_seed_matches_autograd():
    rng = np.random.default_rng(8)
    util = torch.tensor(rng.uniform(0, 3, (4, 50)), dtype=torch.float32)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
    u_v = util.clone().requires_grad_(True)
    loss = tk._te_mlu_plain(u_v, mask, 0.25)[0]
    (g,) = torch.autograd.grad(loss, u_v)
    loss2, lse = tk.te_mlu(util, mask, 0.25)
    assert float(loss2) == pytest.approx(float(loss.detach()), rel=1e-6)
    g2 = tk.te_mlu_bwd(torch.ones(1), util, lse, mask, 0.25)
    assert rel_err(g2.numpy(), g.numpy()) <= 1e-5
    assert g2[1].abs().max() == 0  # the masked scenario has no gradient


@pytest.mark.parametrize("b, e, rows, mask_kind, tau_obj", [
    (1, 1, "random", "all", 0.25),
    (4, 1025, "mixed", "one_masked", 0.25),
    (7, 3000, "mixed", "one_masked", 0.05),
    (3, 2048, "random", "none", 0.1),
], ids=["e1_b1", "e1025_b4", "e3000_b7", "e2048_b3_den0"])
def test_mlu_first_design_matches_plain_and_jax(b, e, rows, mask_kind,
                                                tau_obj):
    """The card tests' yardstick for K18, the first design's order written
    out (`mlu_first_design`, `mlu_seed_first_design`), against the plain
    versions and the reference's expression (`_loss_core`'s logsumexp and
    masked mean, and its jax.grad in util) on the CPU: lse and the loss
    within 1e-6 of the largest magnitude (float32 sums in another order),
    the seed within 1e-6 of the plain version's (the same expression, the
    mask summed in another order) and 1e-5 of jax.grad's (exp and the
    division of another library)."""
    util_h, mask_h = mlu_case(b, e, rows, mask_kind)
    util, mask = torch.as_tensor(util_h), torch.as_tensor(mask_h)
    tau = np.float32(tau_obj)

    def loss_j(u):
        lse = jax.scipy.special.logsumexp(u / tau, axis=1)
        return (jnp.sum(tau * lse * mask_h)
                / jnp.maximum(jnp.sum(mask_h), 1.0), lse)

    (want, lse_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(util_h))
    loss_f, lse_f = mlu_first_design(util, mask, tau_obj)
    loss_p, lse_p = tk._te_mlu_plain(util, mask, tau_obj)
    assert rel_err(lse_f.numpy(), lse_p.numpy()) <= 1e-6
    assert rel_err(lse_f.numpy(), np.asarray(lse_j)) <= 1e-6
    assert float(loss_f) == pytest.approx(float(loss_p), rel=1e-6)
    assert float(loss_f) == pytest.approx(float(want), rel=1e-6)
    g_loss = torch.full((1,), 1.5)
    g_f = mlu_seed_first_design(g_loss, util, lse_f, mask, tau_obj)
    g_p = tk._te_mlu_bwd_plain(g_loss, util, lse_f, mask, tau_obj)
    g_want = 1.5 * np.asarray(g_j)
    assert g_f.shape == (b, e)
    if mask_kind == "none":
        assert not bool(g_f.any()) and not g_want.any()
    else:
        assert rel_err(g_f.numpy(), g_p.numpy()) <= 1e-6
        assert rel_err(g_f.numpy(), g_want) <= 1e-5


# -- the optimizer -------------------------------------------------------------


def clos_case(b=3):
    n, src, dst, w, up = te_case(TOPOLOGIES[1].values[0])
    w = np.where(up, np.rint(w / 8).clip(1, None), 1).astype(np.float32)
    rng = np.random.default_rng(9)
    dem = (rng.uniform(0, 2, (b, n, n)) * (1 - np.eye(n))).astype(np.float32)
    caps = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    return n, src, dst, w, up, dem, caps


@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
def test_loss_matches_jax_with_a_masked_scenario(plain):
    n, src, dst, w, up, dem, caps = clos_case()
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    loss_j = jax.jit(jax.value_and_grad(jopt._loss_core),
                     static_argnames=("n", "rounds"))
    inp = te_inputs(src, dst, w, up, dem, caps, "cpu")
    fn = topt._loss_plain if plain else topt._loss
    for tau in (2.0, 0.3):
        want, g_want = loss_j(jnp.asarray(w), dem, mask, caps, src, dst, up,
                              tau, 0.25, n=n, rounds=n)
        wt = inp["w"].clone().requires_grad_(True)
        got = fn(wt, inp["demands"], torch.tensor(mask), inp["caps"],
                 inp["graph"], inp["up"], tau, 0.25, n)
        (g,) = torch.autograd.grad(got, wt)
        assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
        assert rel_err(g.numpy(), np.asarray(g_want)) <= 1e-4, tau


@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
def test_adam_solve_matches_jax_for_8_steps(plain):
    n, src, dst, w, up, dem, caps = clos_case()
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    cfg = jopt.TeOptConfig()
    _, wh, ls = jopt._adam_solver(
        jnp.asarray(w), jnp.asarray(dem), jnp.asarray(mask),
        jnp.asarray(caps), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(up), cfg.lr, cfg.beta1, cfg.beta2, cfg.eps, cfg.tau0,
        cfg.tau_min, cfg.tau_obj, cfg.w_min, cfg.w_max, n=n, rounds=n,
        steps=8)
    inp = te_inputs(src, dst, w, up, dem, caps, "cpu")
    w_fin, w_hist, losses = topt.adam_solve(
        inp["w"], inp["demands"], torch.tensor(mask), inp["caps"],
        inp["graph"], inp["up"], topt.TeOptConfig(), n, 8, plain=plain)
    np.testing.assert_allclose(w_hist.numpy(), np.asarray(wh), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ls), rtol=1e-5)
    assert torch.equal(w_fin, w_hist[-1])
    assert torch.equal(w_hist[:, ~inp["up"]], inp["w"][~inp["up"]].expand(
        8, -1))  # down links never move
    assert bool((w_hist >= 1).all() and (w_hist <= 64).all())


def pendant_case(name, seed=3):
    """The card tests' `te_case` (tests/test_torch_cuda.py): a Clos or a
    6x6 grid with seeded metrics 1-8, a pendant node, one link down in one
    direction and four weights at 31, 32, 33.5 and 40, not divided by 8;
    with 3 scenarios (the middle one masked), 16 rounds. Returns the
    inputs and the one edge into the pendant node (weight 31 here)."""
    rng = np.random.default_rng(seed)
    base = j_fabric(pods=2) if name == "clos" else j_grid(6)
    edges = [(a, b, int(rng.integers(1, 9))) for a, b, _ in base]
    edges.append(("pendant", edges[0][0], 3))
    graph = j_compile_graph(
        graphs(edges, JLinkState, j_build_adj_dbs, down=edges[1][:2]))
    src, dst, w, up = jo.te_edge_arrays(graph)
    w[np.flatnonzero(up)[:4]] = [31.0, 32.0, 33.5, 40.0]
    n = graph.n
    rng = np.random.default_rng(5)
    dem = (rng.uniform(0, 2, (3, n, n)) * (1 - np.eye(n))).astype(np.float32)
    caps = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    (pendant_edge,) = np.flatnonzero(dst == graph.node_index["pendant"])
    return n, src, dst, w, up, dem, caps, int(pendant_edge)


def pendant_runs(name, plain=False, steps=4, rounds=16):
    n, src, dst, w, up, dem, caps, pe = pendant_case(name)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    cfg = jopt.TeOptConfig()
    _, wh, ls = jopt._adam_solver(
        jnp.asarray(w), jnp.asarray(dem), jnp.asarray(mask),
        jnp.asarray(caps), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(up), cfg.lr, cfg.beta1, cfg.beta2, cfg.eps, cfg.tau0,
        cfg.tau_min, cfg.tau_obj, cfg.w_min, cfg.w_max, n=n, rounds=rounds,
        steps=steps)
    inp = te_inputs(src, dst, w, up, dem, caps, "cpu")
    _, w_hist, losses = topt.adam_solve(
        inp["w"], inp["demands"], torch.tensor(mask), inp["caps"],
        inp["graph"], inp["up"], topt.TeOptConfig(), rounds, steps,
        plain=plain)
    return (np.asarray(wh), np.asarray(ls)), (w_hist.numpy(),
                                              losses.numpy()), pe


# measured on this input (CPU): the largest weight gap over the 4 steps,
# all of it on the edge into the pendant node (every other weight within
# 1e-5); see test_the_pendant_case_departs_on_the_pendant_edge_alone
_PENDANT_GAPS = {("clos", False): 0.78, ("clos", True): 1.29,
                 ("grid", False): 0.0205, ("grid", True): 2.06}


@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
@pytest.mark.parametrize("name", ["clos", "grid"])
def test_adam_solve_on_the_pendant_case_matches_jax(name, plain, request):
    """Four Adam steps of the port's CPU path against the reference's
    `_adam_solver` on the card tests' pendant-node input, at PERF.md's
    tolerances: 5e-3 on the weights, 1e-4 on the losses. It fails on the
    edge into the pendant node alone: its gradient is at float32 rounding
    level in both packages and of either sign, and Adam normalises it to a
    step of up to lr = 0.4 (ROADMAP queue 3, item 1)."""
    request.node.add_marker(pytest.mark.xfail(strict=True, reason=(
        f"the pendant's in-edge departs by {_PENDANT_GAPS[name, plain]} "
        "(rounding-level gradient, Adam-normalised); ROADMAP queue 3 "
        "item 1")))
    (wh, ls), (w_hist, losses), _ = pendant_runs(name, plain)
    np.testing.assert_allclose(w_hist, wh, rtol=0, atol=5e-3)
    np.testing.assert_allclose(losses, ls, rtol=1e-4)


@pytest.mark.parametrize("name", ["clos", "grid"])
def test_the_pendant_case_departs_on_the_pendant_edge_alone(name):
    """The finding behind the strict xfail above: on the pendant-node input
    every weight but the one edge into the pendant node stays within 5e-3
    of the reference's over 4 steps, and the losses within 1e-4; at the
    first step that edge's gradient is below 1e-7 of the largest in both
    packages (float32 rounding: every path to the pendant takes that edge,
    so its weight moves all their candidates alike, and only the softmin's
    loop terms through the pendant, about exp(-34 / tau), reach it), while
    the other edges' gradients agree within 1e-4 of the largest."""
    (wh, ls), (w_hist, losses), pe = pendant_runs(name)
    rest = np.ones(wh.shape[1], dtype=bool)
    rest[pe] = False
    np.testing.assert_allclose(w_hist[:, rest], wh[:, rest], rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(losses, ls, rtol=1e-4)
    n, src, dst, w, up, dem, caps, _ = pendant_case(name)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    cfg = topt.TeOptConfig()
    _, g_j = jax.jit(jax.value_and_grad(jopt._loss_core),
                     static_argnames=("n", "rounds"))(
        jnp.asarray(w), dem, mask, caps, src, dst, up, cfg.tau0,
        cfg.tau_obj, n=n, rounds=16)
    g_j = np.asarray(g_j)
    inp = te_inputs(src, dst, w, up, dem, caps, "cpu")
    wt = inp["w"].clone().requires_grad_(True)
    loss = topt._loss(wt, inp["demands"], torch.tensor(mask), inp["caps"],
                      inp["graph"], inp["up"], cfg.tau0, cfg.tau_obj, 16)
    (g_t,) = torch.autograd.grad(loss, wt)
    g_t = g_t.numpy()
    top = np.abs(g_j).max()
    assert abs(g_j[pe]) < 1e-7 * top and abs(g_t[pe]) < 1e-7 * top
    assert np.abs(g_t[rest] - g_j[rest]).max() <= 1e-4 * top


def reference_pendant_run(name, variant):
    """The reference's `_adam_solver` on `pendant_case` as `pendant_runs`
    calls it (variant "as_is"), or on the same input changed only at
    float32 rounding: "scenarios_reversed" (the three scenarios and the
    mask in reverse order), "edge_order" (the edge arrays in a seeded
    order, the trajectory put back in the original one: other segment-sum
    orders), "demands_ulp" (every demand times 1 + 2**-23). Returns the
    weight trajectory [4, E], the losses and the pendant's in-edge."""
    n, src, dst, w, up, dem, caps, pe = pendant_case(name)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    order = np.arange(len(src))
    if variant == "scenarios_reversed":
        dem, mask = dem[::-1].copy(), mask[::-1].copy()
    elif variant == "edge_order":
        order = np.random.default_rng(0).permutation(len(src))
    elif variant == "demands_ulp":
        dem = dem * np.float32(1 + 2 ** -23)
    cfg = jopt.TeOptConfig()
    _, wh, ls = jopt._adam_solver(
        jnp.asarray(w[order]), jnp.asarray(dem), jnp.asarray(mask),
        jnp.asarray(caps[order]), jnp.asarray(src[order]),
        jnp.asarray(dst[order]), jnp.asarray(up[order]), cfg.lr, cfg.beta1,
        cfg.beta2, cfg.eps, cfg.tau0, cfg.tau_min, cfg.tau_obj, cfg.w_min,
        cfg.w_max, n=n, rounds=16, steps=4)
    w_hist = np.empty_like(np.asarray(wh))
    w_hist[:, order] = np.asarray(wh)
    return w_hist, np.asarray(ls), pe


# measured on this input (CPU), the reference against itself, the largest
# gap on the pendant's in-edge over the 4 steps: Clos 0.0431 (scenarios
# reversed), 0.777 (edge order), 0.432 (demands one spacing up); grid
# 0.00215, 0.0125, 2.07. Every other weight within 1.3e-5, the losses
# within 2e-7 relative.
@pytest.mark.parametrize("name", ["clos", "grid"])
def test_the_reference_departs_from_itself_on_the_pendant_edge(name):
    """ROADMAP queue 3 item 1, settled: the reference's own `_adam_solver`,
    run on the pendant-node input and on the same input changed only at
    float32 rounding (another scenario order, another edge order, every
    demand one spacing up), departs from itself on the edge into the
    pendant node alone, beyond PERF.md's 5e-3 on the weights and by as
    much as the port departs from it (0.0205 to 2.06): the gradient of that
    edge is at rounding level and Adam turns its sign into a step of up to
    lr. Every other weight and the losses stay within PERF.md's tolerances
    (5e-3, 1e-4) in every variant. The port's strict xfails stand."""
    w0, ls0, pe = reference_pendant_run(name, "as_is")
    rest = np.ones(w0.shape[1], dtype=bool)
    rest[pe] = False
    gaps = {}
    for variant in ("scenarios_reversed", "edge_order", "demands_ulp"):
        wv, lv, _ = reference_pendant_run(name, variant)
        np.testing.assert_allclose(wv[:, rest], w0[:, rest], rtol=0,
                                   atol=5e-3)
        np.testing.assert_allclose(lv, ls0, rtol=1e-4)
        gaps[variant] = float(np.abs(wv[:, pe] - w0[:, pe]).max())
    assert all(g > 0 for g in gaps.values()), gaps
    assert max(gaps.values()) > 5e-3, gaps
    assert max(gaps.values()) >= _PENDANT_GAPS[name, False] / 2, gaps


def test_anneal_and_adam_constants_are_float32():
    cfg = topt.TeOptConfig(tau0=2.0, tau_min=0.05)
    taus = [topt.anneal_tau(cfg, i, 48) for i in range(48)]
    assert taus[0] == 2.0 and taus[-1] == float(np.float32(0.05))
    assert all(float(np.float32(t)) == t for t in taus)
    hp = tk.adam_hparams(cfg, 0)
    assert hp[4] == float(np.float32(1) - np.float32(0.9))
    assert all(float(np.float32(x)) == x for x in hp)


def bits32(x) -> int:
    return int(np.float32(x).view(np.uint32))


@pytest.mark.parametrize("cfg", [
    topt.TeOptConfig(),
    topt.TeOptConfig(lr=0.1, beta1=0.5, beta2=0.95, eps=1e-6, w_min=2.0,
                     w_max=30.0),
], ids=["default", "other"])
def test_adam_schedule_equals_adam_hparams_at_every_step(cfg):
    """The constants `adam_solve` makes once a solve (`adam_schedule`) are
    `adam_hparams(cfg, i)` bit for bit at every step, as a tuple and in the
    packed form the kernel takes."""
    steps = 300
    sched = tk.adam_schedule(cfg, steps)
    assert len(sched) == steps
    for i, step in enumerate(sched):
        want = [bits32(x) for x in tk.adam_hparams(cfg, i)]
        assert [bits32(x) for x in step] == want, i
        packed = [getattr(step.packed, name)
                  for name, _ in step.packed._fields_]
        assert [bits32(x) for x in packed] == want, i


def test_te_adam_raises_on_a_wrong_operand():
    """`te_adam` checks every operand on every call, whether its constants
    are an `adam_schedule` step or `adam_hparams`' tuple: a wrong device,
    dtype, shape or layout raises before anything runs; the schedule's
    step updates as the tuple does."""
    e, steps = 6, 3
    cfg = topt.TeOptConfig()
    rng = np.random.default_rng(2)
    w = torch.tensor(rng.uniform(1, 64, e), dtype=torch.float32)
    m, v = torch.zeros(e), torch.zeros(e)
    up = torch.tensor([True, True, False, True, True, True])
    rows = torch.empty(steps, e).unbind(0)
    sched = tk.adam_schedule(cfg, steps)
    g = torch.tensor(rng.standard_normal(e), dtype=torch.float32)
    w2, m2, v2, row2 = w.clone(), m.clone(), v.clone(), torch.empty(e)
    tk.te_adam(w, m, v, g, up, rows[0], sched[0])
    tk.te_adam(w2, m2, v2, g, up, row2, tk.adam_hparams(cfg, 0))
    for a, b in ((w, w2), (m, m2), (v, v2), (rows[0], row2)):
        assert torch.equal(a, b)
    for msg, args in {
        "g: expected 1-d torch.float32": (w, m, v, g.double(), up, rows[1]),
        r"g must be \[6\]": (w, m, v, g[:5], up, rows[1]),
        "g: on meta": (w, m, v, g.to("meta"), up, rows[1]),
        "g: must be contiguous": (w, m, v, torch.zeros(2 * e)[::2], up,
                                  rows[1]),
        "w: expected 1-d torch.float32": (w.double(), m, v, g, up, rows[1]),
        "m: on meta": (w, m.to("meta"), v, g, up, rows[1]),
        r"m must be \[6\]": (w, m[:4], v, g, up, rows[1]),
        r"w_row must be \[6\]": (w, m, v, g, up, torch.empty(e + 1)),
        "up: expected 1-d torch.bool": (w, m, v, g, up.float(), rows[1]),
        "up: on meta": (w, m, v, g, up.to("meta"), rows[1]),
    }.items():
        for hp in (sched[1], tk.adam_hparams(cfg, 1)):
            with pytest.raises(ValueError, match=msg):
                tk.te_adam(*args, hp)


def test_soft_flow_bwd_scale_raises_on_a_wrong_operand():
    """K17's scale checks g_util and caps: a wrong device, dtype, shape or
    layout raises before anything runs."""
    g_util, caps = torch.randn(3, 5), torch.rand(5)
    for msg, args in {
        r"caps must be \[5\]": (g_util, torch.rand(4)),
        "g_util: expected 2-d torch.float32": (g_util[0], caps),
        "caps: expected 1-d torch.float32": (g_util, caps.double()),
        "caps: on meta": (g_util, caps.to("meta")),
        "caps: on cpu, expected meta": (g_util.to("meta"), caps),
        "g_util: must be contiguous": (torch.randn(5, 3).t(), caps),
    }.items():
        with pytest.raises(ValueError, match=msg):
            tk.soft_flow_bwd_scale(*args)
