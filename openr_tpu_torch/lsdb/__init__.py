"""LSDB graph model: LinkState (per-area topology) and PrefixState.

Equivalent of openr/decision/{LinkState,PrefixState}.{h,cpp} — the pure
compute-facing data model consumed by the SPF solvers.
"""

from openr_tpu_torch.lsdb.link_state import (
    HoldableValue,
    Link,
    LinkState,
    LinkStateChange,
    NodeSpfResult,
    SpfResult,
)
from openr_tpu_torch.lsdb.prefix_state import PrefixState

__all__ = [
    "HoldableValue",
    "Link",
    "LinkState",
    "LinkStateChange",
    "NodeSpfResult",
    "SpfResult",
    "PrefixState",
]
