"""Refused kernel launches on the card, for the fault domain's checks.

`refused_launches()` makes every launch of the given kernels (all of
`ops._cuda.KERNELS` by default) return a CUDA error code instead of
launching, so `Kernel.launch` raises `KernelLaunchError` as it does when
the runtime refuses a launch. Nothing runs on the card and its context
stays usable; leaving the block restores the kernels. Needs the kernels
built (`ops._cuda.build()`): it binds each library first.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence

from openr_tpu_torch.ops import _cuda

# cudaErrorInvalidConfiguration: what a launch with a bad grid returns
CUDA_ERROR_INVALID_CONFIGURATION = 9


@contextlib.contextmanager
def refused_launches(
    kernels: Optional[Sequence[_cuda.Kernel]] = None,
    rc: int = CUDA_ERROR_INVALID_CONFIGURATION,
) -> Iterator[None]:
    saved = []
    for kernel in kernels if kernels is not None else _cuda.KERNELS:
        fns = kernel._fns or kernel._bind()
        saved.append((fns, dict(fns)))
        for sym in fns:
            fns[sym] = lambda *args, _rc=rc: _rc
    try:
        yield
    finally:
        for fns, orig in saved:
            fns.update(orig)
