"""Test harness: the deterministic fault injector and the Decision parity
harness.

Port copies of the JAX package's testing/faults.py and the parts of
testing/decision_harness.py that drive one Decision from live
publications. Production modules (ops/spf, solver/cuda, apsp/state,
te/service, monitor/memledger) import `fault_point` from the faults
submodule directly, so the harness exports resolve lazily (PEP 562): the
fault seam must not drag Decision into a hot-path module's imports.
"""

_HARNESS_EXPORTS = {
    "assert_route_delta_equal",
    "decision_route_delta",
    "lsdb_publication",
    "run_decision_backend_parity",
}

__all__ = sorted(_HARNESS_EXPORTS)


def __getattr__(name: str):
    if name in _HARNESS_EXPORTS:
        from openr_tpu_torch.testing import decision_harness

        return getattr(decision_harness, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
