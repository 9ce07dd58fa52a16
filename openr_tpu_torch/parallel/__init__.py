"""Solver meshes for the batched SPF solve.

Scaling axes, as in the JAX package:
  - 'batch': the source batch; each rank relaxes its slice of sources
    against a replica of the layout, with no traffic inside a round
  - 'graph': the destination axis; with a graph axis above one the distance
    matrix is tiled (batch, graph) and the rounds exchange only compact
    per-partition frontier minima around the graph ring (GraphTiling,
    tile_graph and the tiled solves of ops/spf.py); the same axis splits
    the ECMP DAG step's edges

One process drives every rank. plan_degraded_mesh walks the partial-mesh
degradation ladder: the largest strictly smaller (batch, graph) mesh over
the devices still answering a probe.
"""

from openr_tpu_torch.parallel.mesh import (
    GraphTiling,
    Mesh,
    make_mesh,
    plan_degraded_mesh,
    resolve_mesh,
    sharded_batched_spf,
    sharded_spf_step,
    shrink_candidates,
    surviving_devices,
    tile_graph,
)

__all__ = [
    "GraphTiling",
    "Mesh",
    "make_mesh",
    "plan_degraded_mesh",
    "resolve_mesh",
    "sharded_batched_spf",
    "sharded_spf_step",
    "shrink_candidates",
    "surviving_devices",
    "tile_graph",
]
