"""Build and bind the hand-written CUDA kernels of `ops/csrc/`.

Each `.cu` source has a plain C entry point and is compiled with `nvcc` for
`sm_90a` into its own shared library under `openr_tpu_torch/_build/`, named
by a hash of the source so an edited kernel is rebuilt. The library is
loaded with `ctypes`. The build runs at a kernel's first use, never at
import: hosts without `nvcc` or a card import this module freely.

Every pointer and the stream are passed as `ctypes.c_void_p` and every int as
`ctypes.c_int`; each entry point returns `cudaGetLastError()` and a non-zero
code raises. Launches go on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int


class Kernel:
    """One kernel of `csrc/`: its source, C entry point and argument types,
    the reference function it replaces, and the count of its launches."""

    def __init__(
        self, name: str, source: str, argtypes: Sequence, replaces: str
    ) -> None:
        self.name = name
        self.source = _CSRC / source
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes()).hexdigest()[:12]
        return _BUILD / f"{self.source.stem}.{digest}.so"

    def compile_command(self, out: Path) -> List[str]:
        return [
            _nvcc(), _ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", str(out), str(self.source),
        ]

    def _bind(self):
        with self._lock:
            if self._fn is None:
                path = self.library_path()
                if not path.exists():
                    build([self])
                fn = getattr(ctypes.CDLL(str(path)), self.name)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Launch on the current stream; raises on a refused launch."""
        fn = self._bind()
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: cudaError {rc}"
            )
        self.launches += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built"
    )


def build(kernels: Optional[Sequence[Kernel]] = None) -> Dict[str, Path]:
    """Compile the given kernels (all by default) that are not built yet,
    one `nvcc` per source, all started together. Returns name -> library."""
    kernels = list(KERNELS if kernels is None else kernels)
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for k in kernels:
        out = k.library_path()
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            k.compile_command(tmp),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        procs.append((k, proc, tmp, out))
    errors = []
    for k, proc, tmp, out in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{k.source.name}:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return {k.name: k.library_path() for k in kernels}


SELL_RELAX = Kernel(
    "sell_relax_round",
    "sell_relax.cu",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "openr_tpu/ops/spf.py:177 _sell_relax",
)
BF_RELAX = Kernel(
    "bf_relax_round",
    "bf_relax.cu",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "openr_tpu/ops/spf.py:55 _bf_relax",
)
ECMP_TRIANGLE = Kernel(
    "ecmp_triangle",
    "ecmp_triangle.cu",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "openr_tpu/ops/spf.py:1165 _ecmp_dag",
)
KERNELS = (SELL_RELAX, BF_RELAX, ECMP_TRIANGLE)
