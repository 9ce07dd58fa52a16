"""Build and bind the hand-written CUDA kernels of `ops/csrc/`.

Each `.cu` source has a plain C entry point and is compiled with `nvcc` for
`sm_90a` into its own shared library under `openr_tpu_torch/_build/`, named
by a hash of the source so an edited kernel is rebuilt. The library is
loaded with `ctypes`. The build runs at a kernel's first use, never at
import: hosts without `nvcc` or a card import this module freely.

A source may export several entry points (one `__global__` each); they
share one library and, within one `Kernel`, one launch count. Two `Kernel`s
may name the same source (K1 and K9 share `sell_relax.cu`): they share the
library, which is built once, and count their launches apart. A source may
include a local header (`#include "fw_minplus.cuh"`); the library's name
hashes the header too, so editing it rebuilds every source that uses it. Every
pointer and the stream are passed as `ctypes.c_void_p`, every int as
`ctypes.c_int` and every float as `ctypes.c_float`; each entry point
returns `cudaGetLastError()` and a non-zero code raises. A launch names
the card that holds its tensors and goes on that card's current stream,
with that card current: the ranks of a mesh may lie on several cards, and
PyTorch orders its own work on a card, the copies between cards among it,
on the same streams.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
_F = ctypes.c_float


class Kernel:
    """One kernel of `csrc/`: its source, its C entry points with their
    argument types, the reference function it replaces, and the count of
    its launches (all entry points together).

    `entries` maps each C function name to its argument types without the
    trailing stream; the first entry is the default of `launch`."""

    def __init__(
        self,
        name: str,
        source: str,
        entries: Dict[str, Sequence],
        replaces: str,
    ) -> None:
        self.name = name
        self.source = _CSRC / source
        self.entries = {sym: [*types, _P] for sym, types in entries.items()}
        self.replaces = replaces
        self.launches = 0
        self._fns: Optional[Dict[str, object]] = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        h = hashlib.sha1(self.source.read_bytes())
        for header in _local_headers(self.source):
            h.update(header.read_bytes())
        return _BUILD / f"{self.source.stem}.{h.hexdigest()[:12]}.so"

    def compile_command(self, out: Path) -> List[str]:
        return [
            _nvcc(), _ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", str(out), str(self.source),
        ]

    def _bind(self) -> Dict[str, object]:
        with self._lock:
            if self._fns is None:
                path = self.library_path()
                if not path.exists():
                    build([self])
                lib = ctypes.CDLL(str(path))
                fns = {}
                for sym, argtypes in self.entries.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[sym] = fn
                self._fns = fns
        return self._fns

    def launch(self, device: torch.device, *args,
               entry: Optional[str] = None) -> None:
        """Launch one entry point (the first by default) on `device`, the
        card that holds its tensors, on that card's current stream; raises
        on a refused launch."""
        fns = self._fns or self._bind()
        sym = entry or next(iter(self.entries))
        # the small kernels are host-bound, so the launch reads the raw
        # stream (torch.cuda.current_stream() and the device context cost
        # more host time than the kernels) and switches the card only when
        # another one is current
        prev = torch.cuda.current_device()
        idx = prev if device.index is None else device.index
        if prev != idx:
            torch.cuda.set_device(idx)
        try:
            rc = fns[sym](*args, torch._C._cuda_getCurrentRawStream(idx))
        finally:
            if prev != idx:
                torch.cuda.set_device(prev)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {sym} failed to launch: cudaError {rc}"
            )
        self.launches += 1


def _local_headers(source: Path) -> List[Path]:
    """The headers of csrc/ that `source` includes with quotes."""
    names = re.findall(r'^#include "([^"]+)"', source.read_text(), re.M)
    return [source.parent / name for name in names]


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
    started = set()
    for k in kernels:
        out = k.library_path()
        if out.exists() or out in started:
            continue
        started.add(out)
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
    {"sell_relax_round": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I]},
    "openr_tpu/ops/spf.py:177 _sell_relax",
)
BF_RELAX = Kernel(
    "bf_relax_round",
    "bf_relax.cu",
    {"bf_relax_round": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I]},
    "openr_tpu/ops/spf.py:55 _bf_relax",
)
ECMP_TRIANGLE = Kernel(
    "ecmp_triangle",
    "ecmp_triangle.cu",
    {"ecmp_triangle": [_P, _P, _P, _P, _P, _P, _P, _I, _I]},
    "openr_tpu/ops/spf.py:1165 _ecmp_dag",
)
SELL_PATCH = Kernel(
    "sell_apply_patches",
    "sell_patch.cu",
    {"sell_apply_patches": [_P, _P, _P, _I, _I]},
    "openr_tpu/ops/spf.py:303 _sell_apply_patches",
)
SELL_MARK = Kernel(
    "sell_mark",
    "sell_mark.cu",
    {
        "sell_mark_seed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I],
        "sell_mark_round": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I],
        "sell_mark_reset": [_P, _P, _P, _P, _I, _I],
    },
    "openr_tpu/ops/spf.py:348,387 _sell_invalidate, _sell_mark_fixpoint",
)
BF_MARK = Kernel(
    "bf_mark",
    "bf_mark.cu",
    {
        "bf_mark_seed": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I],
        "bf_mark_round": [_P, _P, _P, _P, _P, _P, _P, _I, _I],
        "bf_mark_reset": [_P, _P, _P, _P, _I, _I],
    },
    "openr_tpu/ops/spf.py:497,567 _bf_warm_core, _bf_warm_vw_core",
)
DELTA_EXTRACT = Kernel(
    "delta_extract",
    "delta_extract.cu",
    {
        "delta_columns": [_P, _P, _P, _P, _I, _I],
        "delta_compact": [_P, _P, _P, _I, _I, _I],
        "delta_gather": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I],
    },
    "openr_tpu/ops/spf.py:907 _delta_extract",
)
SELL_MASK = Kernel(
    "sell_mask",
    "sell_mask.cu",
    {
        "sell_mask_build": [_P, _P, _P, _I, _I, _I, _I],
        "sell_mask_seed": [_P, _P, _P, _P, _I, _I, _I, _I],
    },
    "openr_tpu/ops/spf.py:933,970 _sell_solver_vw, _sell_solver_vw_warm",
)
SELL_RELAX_MASKED = Kernel(
    "sell_relax_masked_round",
    "sell_relax.cu",
    {
        "sell_relax_masked_round": [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        ],
    },
    "openr_tpu/ops/spf.py:177 _sell_relax (per-row wg, from :933, :970)",
)
FW_CLOSE = Kernel(
    "fw_close",
    "fw_close.cu",
    {
        "fw_close_diag": [_P, _P, _I, _I, _I],
        "fw_close_panels": [_P, _P, _I, _I, _I],
        "fw_close_outer": [_P, _P, _I, _I, _I],
        "fw_close_probe": [_P, _P, _I],
    },
    "openr_tpu/apsp/kernels.py:112 _fw_solver",
)
FW_SEED = Kernel(
    "fw_seed",
    "fw_seed.cu",
    {
        "fw_seed_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _I],
        "fw_seed_blocks": [_P, _P, _P, _I, _I],
    },
    "openr_tpu/apsp/kernels.py:178 _fw_seed_solver",
)
FW_RECLOSE = Kernel(
    "fw_reclose",
    "fw_reclose.cu",
    {
        "fw_reclose_compact": [_P, _P, _P, _I, _I],
        "fw_reclose_rows": [_P, _P, _P, _P, _I, _I, _I],
        "fw_reclose_rows_apply": [_P, _P, _P, _P, _I, _I, _I],
        "fw_reclose_snapshot": [_P, _P, _P, _P, _P, _I, _I, _I],
        "fw_reclose_step": [_P, _P, _P, _P, _P, _I, _I, _I],
        "fw_reclose_finish": [_P, _P, _P, _P, _I],
    },
    "openr_tpu/apsp/kernels.py:231 _fw_reclose_solver",
)
SOFTMIN_ROUND = Kernel(
    "softmin_round",
    "te_softmin.cu",
    {"softmin_round": [_P, _P, _P, _P, _P, _P, _P, _I, _F]},
    "openr_tpu/te/objective.py:72,94 _segment_softmin, "
    "_softmin_fixpoint_core",
)
SOFTMIN_BWD = Kernel(
    "softmin_round_bwd",
    "te_softmin.cu",
    {
        "softmin_bwd_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _F],
        "softmin_bwd_pull": [_P, _P, _P, _P, _P, _P, _P, _I, _F],
        "softmin_bwd_edges": [_P, _P, _I, _I],
    },
    "openr_tpu/te/objective.py:72,94 _segment_softmin, "
    "_softmin_fixpoint_core (jax.grad)",
)
# not a kernel of the path: the check that the TE kernels' quotient by tau
# gives exp the bits of the correctly rounded division (every exponent
# K14-K17 can meet); shares K14's and K15's library and counts its own
# launches
SOFTMIN_DIV_CHECK = Kernel(
    "softmin_div_check",
    "te_softmin.cu",
    {"softmin_div_check": [_F, _P]},
    "none (a check of softmin_round_bwd's arithmetic)",
)
SOFT_FLOW = Kernel(
    "soft_flow",
    "te_flow.cu",
    {
        "soft_gate": [_P, _P, _P, _P, _P, _P, _P, _I, _F],
        "soft_flow_round": [_P, _P, _P, _P, _P, _P, _P, _I, _I],
        "soft_flow_util": [_P, _P, _P, _P, _P, _I, _I, _I],
    },
    "openr_tpu/te/objective.py:138 _soft_utilization_core",
)
SOFT_FLOW_BWD = Kernel(
    "soft_flow_bwd",
    "te_flow.cu",
    {
        "soft_flow_bwd_round": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I],
        "soft_flow_bwd_scale": [_P, _P, _P, _I, _I],
        "soft_gate_bwd_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _F],
        "soft_gate_bwd_pull": [_P, _P, _P, _P, _I],
        "soft_gate_bwd_edges": [_P, _P, _I, _I],
    },
    "openr_tpu/te/objective.py:138 _soft_utilization_core (jax.grad)",
)
TE_STEP = Kernel(
    "te_step",
    "te_step.cu",
    {
        "te_mlu": [_P, _P, _P, _P, _I, _I, _F],
        "te_mlu_bwd": [_P, _P, _P, _P, _P, _I, _I, _F],
        "te_adam": [_P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _F, _F, _F,
                    _F],
    },
    "openr_tpu/te/optimizer.py:87,103 _loss_core, _adam_scan_core",
)
TILE_ROUND = Kernel(
    "tile_round",
    "tile_round.cu",
    {"tile_round": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I]},
    "openr_tpu/ops/spf.py:676,712 _tile_seg_min, _tile_relax",
)
TILE_FOLD = Kernel(
    "tile_fold",
    "tile_fold.cu",
    {"tile_fold": [_P, _P, _P, _P, _I, _I, _I, _I]},
    "openr_tpu/ops/spf.py:648,657 _tile_fold_min, _tile_halo_min",
)
TILE_MARK = Kernel(
    "tile_mark",
    "tile_mark.cu",
    {
        "tile_init": [_P, _P, _I, _I, _I],
        "tile_mark": [_P, _P, _P, _P, _P, _I],
        "tile_reset": [_P, _P, _P, _P, _I, _I, _I],
        "tile_col_changed": [_P, _P, _P, _P, _I, _I],
    },
    "openr_tpu/ops/spf.py:688,784 _tile_d0_allow, _tile_solver_warm",
)
KERNELS = (
    SELL_RELAX, BF_RELAX, ECMP_TRIANGLE,
    SELL_PATCH, SELL_MARK, BF_MARK, DELTA_EXTRACT,
    SELL_MASK, SELL_RELAX_MASKED,
    FW_CLOSE, FW_SEED, FW_RECLOSE,
    SOFTMIN_ROUND, SOFTMIN_BWD, SOFT_FLOW, SOFT_FLOW_BWD, TE_STEP,
    TILE_ROUND, TILE_FOLD, TILE_MARK,
)
