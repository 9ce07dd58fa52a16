"""Blocked (min,+) Floyd–Warshall all-pairs shortest paths on the card.

Dense all-pairs distances for areas up to a node cap, closed cold by K11
and re-closed warm per weight event by K12 and K13 (apsp/kernels.py), kept
resident by `ApspState` (apsp/state.py), with the numpy Floyd–Warshall as
the shadow audit's oracle.
"""

from openr_tpu_torch.apsp.kernels import (
    build_allow_matrix,
    build_weight_matrix,
    fw_block_shape,
    np_floyd_warshall,
)
from openr_tpu_torch.apsp.state import ApspState

__all__ = [
    "ApspState",
    "build_allow_matrix",
    "build_weight_matrix",
    "fw_block_shape",
    "np_floyd_warshall",
]
