"""Differentiable traffic engineering over the live LSDB, on the card.

Softmin-relaxed shortest paths turn link weights into optimizable
parameters; an Adam loop with temperature annealing descends the
softmax-relaxed max-link-utilization over a batch of demand scenarios; the
TE service reports proposed integer weight changes scored under exact
hard-SPF ECMP routing. The forward and backward of every round run in
hand-written CUDA kernels (te/kernels.py).
"""

from openr_tpu_torch.te.objective import (
    hard_distances,
    hard_max_util,
    hard_utilization,
    soft_mlu,
    soft_utilization,
    softmin_distances,
    te_edge_arrays,
)
from openr_tpu_torch.te.optimizer import (
    TeOptConfig,
    TeOptResult,
    optimize_weights,
)
from openr_tpu_torch.te.scenarios import (
    build_demand_scenarios,
    congested_clos_fixture,
    uniform_demand_spec,
)
from openr_tpu_torch.te.service import TeService

__all__ = [
    "TeOptConfig",
    "TeOptResult",
    "TeService",
    "build_demand_scenarios",
    "congested_clos_fixture",
    "hard_distances",
    "hard_max_util",
    "hard_utilization",
    "optimize_weights",
    "soft_mlu",
    "soft_utilization",
    "softmin_distances",
    "te_edge_arrays",
    "uniform_demand_spec",
]
