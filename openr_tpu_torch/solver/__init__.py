"""Route computation: the CPU oracle, the device-backed solver, and the
fault domain between them.

`SolverSupervisor` serves `CudaSpfSolver` under a circuit breaker with the
CPU oracle `SpfSolver` as the degraded path; `FlightRecorder` is the trace
ring and forensics layer it records into.
"""

from openr_tpu_torch.solver.cpu import SpfSolver
from openr_tpu_torch.solver.cuda import CudaSpfSolver
from openr_tpu_torch.solver.delta import DeltaRouteBuilder
from openr_tpu_torch.solver.flight_recorder import FlightRecorder, SolveTrace
from openr_tpu_torch.solver.routes import (
    DecisionRouteDb,
    DecisionRouteUpdate,
    RibMplsEntry,
    RibUnicastEntry,
    apply_route_delta,
    get_route_delta,
)
from openr_tpu_torch.solver.supervisor import (
    SolverSupervisor,
    SupervisorConfig,
)

__all__ = [
    "SpfSolver",
    "CudaSpfSolver",
    "DeltaRouteBuilder",
    "DecisionRouteDb",
    "DecisionRouteUpdate",
    "FlightRecorder",
    "RibMplsEntry",
    "RibUnicastEntry",
    "SolveTrace",
    "SolverSupervisor",
    "SupervisorConfig",
    "apply_route_delta",
    "get_route_delta",
]
