"""openr-tpu-torch: the PyTorch and CUDA port of openr_tpu.

The Decision module's batched shortest-path solve, on an NVIDIA Hopper card,
with the device work in hand-written CUDA kernels (ops/csrc/). Module names
follow the JAX package, so each counterpart is easy to find:

  types.py        wire types (copy)
  topology.py     topology generators (copy)
  lsdb/           LinkState graph + PrefixState, the Dijkstra oracle (copy)
  ops/graph.py    LSDB graph -> padded arrays, sliced-ELL layout (copy)
  ops/spf.py      batched min-plus SPF and the ECMP triangle, with kernels
  solver/cpu.py   the CPU route-computation oracle (copy)
  solver/cuda.py  CudaSpfSolver: the route pipeline over the device solve
  convert.py      carry a compiled graph across packages and onto the card

Nothing here imports jax or openr_tpu, and no CUDA code is built or loaded
at import time.
"""

__version__ = "0.1.0"
