"""openr_tpu_torch stands alone: no jax, nothing of openr_tpu, and no
quiet fall back to the CPU when the card is asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "openr_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "openr_tpu")


def port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


_IMPORT_ALL = """
import importlib.abc, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "openr_tpu" or name.startswith("openr_tpu."):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
for mod in sys.argv[1:]:
    importlib.import_module(mod)
assert not any(
    m == "openr_tpu" or m.startswith("openr_tpu.") for m in sys.modules
)
print("imported", len(sys.argv) - 1)
"""


def test_every_module_imports_without_jax_or_openr_tpu():
    mods = port_modules()
    assert "openr_tpu_torch.solver.cuda" in mods
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, *mods],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(mods)}" in proc.stdout


def test_refusing_finder_refuses_openr_tpu():
    """The check above can fail: the same finder refuses the JAX package."""
    code = _IMPORT_ALL.replace(
        "for mod in sys.argv[1:]:", "for mod in ['openr_tpu.types']:"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "refused: openr_tpu" in proc.stderr


@pytest.mark.parametrize(
    "path",
    [*sorted(PKG.rglob("*.py")), ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_import_of_jax_or_openr_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path.name}:{node.lineno} {name}"


def test_default_device_raises_without_a_card(monkeypatch):
    from openr_tpu_torch.device import resolve_device
    from openr_tpu_torch.ops import batched_spf
    from openr_tpu_torch.ops.graph import compile_edges
    from openr_tpu_torch.solver import CudaSpfSolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph = compile_edges([("a", "b", 1)])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        batched_spf(graph, [0])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        CudaSpfSolver("a")
    assert resolve_device("cpu") == torch.device("cpu")
