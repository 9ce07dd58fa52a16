"""Device selection for the port's entry points.

Every entry point takes an explicit `device`, "cuda" by default. Asking for
the card where there is none raises; nothing falls back to the CPU quietly.
Tests pass device="cpu", which runs each kernel's plain PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA card is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {device!r}")
    return dev
