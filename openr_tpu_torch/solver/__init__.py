"""Route computation: the CPU oracle and the device-backed solver."""

from openr_tpu_torch.solver.cpu import SpfSolver
from openr_tpu_torch.solver.cuda import CudaSpfSolver
from openr_tpu_torch.solver.delta import DeltaRouteBuilder
from openr_tpu_torch.solver.routes import (
    DecisionRouteDb,
    DecisionRouteUpdate,
    RibMplsEntry,
    RibUnicastEntry,
    apply_route_delta,
    get_route_delta,
)

__all__ = [
    "SpfSolver",
    "CudaSpfSolver",
    "DeltaRouteBuilder",
    "DecisionRouteDb",
    "DecisionRouteUpdate",
    "RibMplsEntry",
    "RibUnicastEntry",
    "apply_route_delta",
    "get_route_delta",
]
