"""Batched min-plus SPF ops: graph compiler and the device solve."""

from openr_tpu_torch.ops.graph import INF, CompiledGraph, compile_graph
from openr_tpu_torch.ops.spf import (
    batched_spf,
    batched_spf_vw,
    ecmp_dag,
    sell_fixpoint,
)

__all__ = [
    "INF",
    "CompiledGraph",
    "compile_graph",
    "batched_spf",
    "batched_spf_vw",
    "ecmp_dag",
    "sell_fixpoint",
]
