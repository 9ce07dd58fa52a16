"""TE's scenario batch sharded over a mesh's 'batch' axis: the port's
(openr_tpu_torch/te/optimizer.py, te/service.py) against the JAX
package's, on the CPU.

The reference shards the [B, N, N] demand tensor over its 'batch' axis
(`_shard_scenarios`: padded to the axis size with masked zero-demand
scenarios) on the 8-device virtual CPU mesh of tests/conftest.py; the
port's meshes are `make_mesh([cpu] * 8, (4, 2))` and the like, one process
driving every rank. Tolerances are PERF.md §2's for TE: the Adam
trajectory within 5e-3 on weights in [1, 64] and the losses within 1e-4
relative (float32 sums in another order: each rank sums its own
scenarios, and the ranks' gradients are summed after). A mesh of one rank
gives the unsharded run's bits.

The graph is tests/test_torch_te.py's 2-pod Clos case and the service's
congested 2-pod Clos fixture; 8 Adam steps, 40 in the service.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.parallel import resolve_mesh
from openr_tpu.te import TeService as JTeService
from openr_tpu.te import optimizer as jopt
from openr_tpu_torch.convert import te_inputs
from openr_tpu_torch.parallel import make_mesh
from openr_tpu_torch.solver import CudaSpfSolver
from openr_tpu_torch.te import TeService, congested_clos_fixture
from openr_tpu_torch.te import optimizer as topt
from test_torch_memory import release_memory_around_each_test  # noqa: F401
from test_torch_te import clos_case
from test_torch_te_service import assert_reports_equal, build_ls

CPU = torch.device("cpu")
STEPS = 8


def cpu_mesh(shape):
    return make_mesh([CPU] * (shape[0] * shape[1]), shape)


def mask_for(b):
    """All scenarios valid, but the second of three masked out."""
    return np.array([1.0, 0.0, 1.0] if b == 3 else [1.0] * b, np.float32)


def port_run(b, mesh, plain=False):
    n, src, dst, w, up, dem, caps = clos_case(b)
    inp = te_inputs(src, dst, w, up, dem, caps, "cpu")
    _, wh, ls = topt.adam_solve(
        inp["w"], inp["demands"], torch.tensor(mask_for(b)), inp["caps"],
        inp["graph"], inp["up"], topt.TeOptConfig(), n, STEPS, plain=plain,
        mesh=mesh)
    return wh.numpy(), ls.numpy()


def reference_run(b, shape):
    """The reference's `_adam_solver` on the same case, its demands and mask
    sharded by `_shard_scenarios` over resolve_mesh(shape)."""
    n, src, dst, w, up, dem, caps = clos_case(b)
    cfg = jopt.TeOptConfig()
    dem_s, mask_s = jopt._shard_scenarios(dem, mask_for(b),
                                          resolve_mesh(shape))
    _, wh, ls = jopt._adam_solver(
        jnp.asarray(w), dem_s, mask_s, jnp.asarray(caps), jnp.asarray(src),
        jnp.asarray(dst), jnp.asarray(up), cfg.lr, cfg.beta1, cfg.beta2,
        cfg.eps, cfg.tau0, cfg.tau_min, cfg.tau_obj, cfg.w_min, cfg.w_max,
        n=n, rounds=n, steps=STEPS)
    return np.asarray(wh), np.asarray(ls)


def assert_runs_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=5e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)


@pytest.mark.parametrize("plain", [False, True], ids=["kernels", "plain"])
@pytest.mark.parametrize("b", [3, 4, 1])
def test_sharded_adam_solve_matches_the_reference_sharded(b, plain):
    """8 Adam steps on a (4, 2) mesh against the reference's on its (4, 2)
    mesh: B = 3 pads to 4 (one scenario masked besides), B = 4 splits
    evenly, B = 1 leaves three ranks all padding."""
    got = port_run(b, cpu_mesh((4, 2)), plain)
    assert_runs_close(got, reference_run(b, (4, 2)))


@pytest.mark.parametrize("shape", [(4, 2), (2, 1), (4, 1)])
@pytest.mark.parametrize("b", [3, 4, 1])
def test_sharded_adam_solve_matches_the_unsharded(b, shape):
    assert_runs_close(port_run(b, cpu_mesh(shape)), port_run(b, None))


@pytest.mark.parametrize("b", [3, 1])
def test_a_mesh_of_one_rank_gives_the_unsharded_bits(b):
    got, want = port_run(b, cpu_mesh((1, 1))), port_run(b, None)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_shard_scenarios_pads_places_and_scales():
    n, src, dst, w, up, dem, caps = clos_case(3)
    inp = te_inputs(src, dst, w, up, dem, caps, "cpu")
    mask = torch.tensor([1.0, 0.0, 1.0])
    shards = topt.shard_scenarios(inp["demands"], mask, inp["caps"],
                                  inp["graph"], inp["up"], cpu_mesh((2, 3)))
    assert len(shards) == 2  # the batch axis; 'graph' replicates
    assert [tuple(sh.demands.shape) for sh in shards] == [(2, n, n)] * 2
    assert torch.equal(shards[0].demands, inp["demands"][:2])
    assert torch.equal(shards[1].demands[0], inp["demands"][2])
    assert not shards[1].demands[1].any()  # the padding scenario
    assert [sh.mask.tolist() for sh in shards] == [[1.0, 0.0], [1.0, 0.0]]
    assert [sh.scale for sh in shards] == [0.5, 0.5]
    for sh in shards:
        assert sh.graph is inp["graph"] and sh.caps is inp["caps"]
    one = topt.shard_scenarios(inp["demands"][:1], mask[:1], inp["caps"],
                               inp["graph"], inp["up"], cpu_mesh((4, 1)))
    assert [sh.mask.tolist() for sh in one] == [[1.0], [0.0], [0.0], [0.0]]
    assert [sh.scale for sh in one] == [1.0] * 4


def test_adam_solve_refuses_weights_off_batch_rank_0():
    n, src, dst, w, up, dem, caps = clos_case(2)
    inp = te_inputs(src, dst, w, up, dem, caps, "cpu")
    mesh = make_mesh([torch.device("meta"), CPU], (2, 1))
    with pytest.raises(ValueError, match="batch rank 0"):
        topt.adam_solve(inp["w"], inp["demands"], torch.ones(2),
                        inp["caps"], inp["graph"], inp["up"],
                        topt.TeOptConfig(), n, 1, mesh=mesh)


@pytest.mark.parametrize("b", [3, 1])
def test_optimize_weights_on_a_mesh_matches_the_reference(b):
    """`optimize_weights(mesh=)` against the reference's on its (4, 2)
    mesh: the losses within 1e-4, the hard scores, the winner and its
    step equal."""
    n, src, dst, w, up, dem, caps = clos_case(b)
    cfg = topt.TeOptConfig(steps=STEPS)
    got = topt.optimize_weights(src, dst, up, w, dem, caps, n, config=cfg,
                                mesh=cpu_mesh((4, 2)), device="cpu")
    want = jopt.optimize_weights(src, dst, up, w, dem, caps, n,
                                 config=jopt.TeOptConfig(steps=STEPS),
                                 mesh=resolve_mesh((4, 2)))
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert got.initial_max_util == want.initial_max_util
    assert got.best_max_util == want.best_max_util
    assert got.best_step == want.best_step
    np.testing.assert_array_equal(got.w_best, want.w_best)
    assert got.d2h_bytes == want.d2h_bytes


def test_scenario_batch_shards_over_mesh():
    """The counterpart of tests/test_te_service.py's TestMeshSharding: B =
    3 pads to the 4-way axis and the optimization still finds the
    fixture's improvement, with the reference's report on its mesh."""
    edges, spec = congested_clos_fixture()
    spec = dict(spec, scenarios=3, scenario_spread=0.2)
    params = {"demands": spec, "steps": 40, "seed": 0}
    svc = TeService("l0_0", {"0": build_ls("torch", edges)},
                    mesh=cpu_mesh((4, 2)), device="cpu")
    got = svc.optimize(dict(params))
    want = JTeService("l0_0", {"0": build_ls("jax", edges)},
                      mesh=resolve_mesh((4, 2))).optimize(dict(params))
    assert got["scenarios"] == 3
    assert got["improved"] is True
    assert got["optimized_max_util"] < got["initial_max_util"]
    assert_reports_equal(want, got)


def test_service_takes_the_solvers_mesh():
    """A TeService over CudaSpfSolver(mesh=) runs its batch on the
    solver's mesh, as the reference's does over its solver."""
    edges, spec = congested_clos_fixture()
    spec = dict(spec, scenarios=3, scenario_spread=0.2)
    params = {"demands": spec, "steps": 24, "seed": 0}
    solver = CudaSpfSolver("l0_0", mesh=cpu_mesh((4, 1)), device="cpu")
    svc = TeService("l0_0", {"0": build_ls("torch", edges)}, solver=solver,
                    device="cpu")
    assert svc.mesh is solver.mesh
    got = svc.optimize(dict(params))
    want = JTeService("l0_0", {"0": build_ls("jax", edges)},
                      mesh=resolve_mesh((4, 1))).optimize(dict(params))
    assert got["scenarios"] == 3
    assert_reports_equal(want, got)
    unsharded = TeService("l0_0", {"0": build_ls("torch", edges)},
                          device="cpu").optimize(dict(params))
    assert unsharded["scenarios"] == 3
    for key in ("initial_max_util", "optimized_max_util", "weight_changes"):
        assert got[key] == unsharded[key], key
