"""Decision module: LSDB subscription → debounced SPF → route deltas.

Equivalent of openr/decision/Decision.{h,cpp} module shell (the computation
itself lives in openr_tpu_torch.solver).
"""

from openr_tpu_torch.decision.decision import Decision, DecisionConfig

__all__ = ["Decision", "DecisionConfig"]
