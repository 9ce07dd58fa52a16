"""Route computation: the CPU oracle and the device-backed solver."""

from openr_tpu_torch.solver.cpu import SpfSolver
from openr_tpu_torch.solver.cuda import CudaSpfSolver
from openr_tpu_torch.solver.routes import (
    DecisionRouteDb,
    DecisionRouteUpdate,
    RibMplsEntry,
    RibUnicastEntry,
)

__all__ = [
    "SpfSolver",
    "CudaSpfSolver",
    "DecisionRouteDb",
    "DecisionRouteUpdate",
    "RibMplsEntry",
    "RibUnicastEntry",
]
