"""openr_tpu_torch stands alone: no jax, nothing of openr_tpu, and no
quiet fall back to the CPU when the card is asked for."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from openr_tpu_torch.ops._cuda import (
    KERNELS,
    MLU_DIV_CHECK,
    SOFTMIN_DIV_CHECK,
)

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
    assert "openr_tpu_torch.solver.delta" in mods
    assert "openr_tpu_torch.apsp.kernels" in mods
    assert "openr_tpu_torch.apsp.state" in mods
    for mod in ("kernels", "objective", "optimizer", "scenarios", "service"):
        assert f"openr_tpu_torch.te.{mod}" in mods
    assert "openr_tpu_torch.parallel" in mods
    assert "openr_tpu_torch.parallel.mesh" in mods
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
    from openr_tpu_torch.apsp import ApspState

    with pytest.raises(RuntimeError, match="no CUDA card"):
        ApspState(4096)
    assert resolve_device("cpu") == torch.device("cpu")


def _c_params(source: str, symbol: str):
    """Parameter types of `extern "C" int symbol(...)` in a .cu source."""
    m = re.search(
        r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{", source, re.S
    )
    assert m, f"no extern C entry point {symbol}"
    return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]


@pytest.mark.parametrize("kernel",
                         [*KERNELS, SOFTMIN_DIV_CHECK, MLU_DIV_CHECK],
                         ids=lambda k: k.name)
def test_kernel_bindings_match_their_c_entry_points(kernel):
    """Each ctypes binding has one c_void_p per pointer parameter, one c_int
    per int and one c_float per float parameter of its C entry point, and
    te_adam's `AdamConsts` for the struct of that name passed by value,
    whose float fields it lists in the C struct's order; the stream last:
    nvcc is absent here, so this is the check that runs before the card
    does."""
    import ctypes

    from openr_tpu_torch.ops._cuda import AdamConsts

    scalar = {"int": ctypes.c_int, "float": ctypes.c_float,
              "AdamConsts": AdamConsts}
    source = kernel.source.read_text()
    struct = re.search(r"struct AdamConsts \{\s*float ([^;]*);\s*\};",
                       source)
    if struct:
        fields = [f.strip() for f in struct.group(1).split(",")]
        assert [(f, ctypes.c_float) for f in fields] == AdamConsts._fields_
    assert kernel.entries
    for symbol, argtypes in kernel.entries.items():
        params = _c_params(source, symbol)
        assert params[-1] == "void*", symbol  # the stream
        assert all(p.endswith("*") or p in scalar for p in params), params
        want = [
            ctypes.c_void_p if p.endswith("*") else scalar[p]
            for p in params
        ]
        assert argtypes == want, symbol


def test_event_wrappers_run_plain_versions_on_cpu_tensors():
    """K4-K7's wrappers on CPU tensors: plain versions, no launch."""
    from openr_tpu_torch.ops import _cuda, spf

    d = torch.tensor([[0, 1, 2], [1, 0, 1]], dtype=torch.int32)
    before = [k.launches for k in _cuda.KERNELS]
    col_changed, num = spf.delta_columns(d, d.clone())
    assert int(num) == 0 and not bool(col_changed.any())
    cols, _, _ = spf._delta_extract(
        col_changed, d, torch.zeros(1, dtype=torch.int32),
        torch.ones(1, dtype=torch.int32), cap=8,
    )
    assert cols.tolist() == [3] * 8
    wg = torch.zeros((2, 2), dtype=torch.int32)
    spf._sell_apply_patches(
        (wg,), torch.tensor([[[1, 0]]], dtype=torch.int32),
        torch.tensor([[5]], dtype=torch.int32),
    )
    assert wg.tolist() == [[0, 0], [5, 0]]
    assert [k.launches for k in _cuda.KERNELS] == before


def test_apsp_wrappers_run_plain_versions_on_cpu_tensors():
    """K11-K13's wrappers on CPU tensors: plain versions, no launch; and
    ApspState asks for the card by default."""
    from openr_tpu_torch.apsp import ApspState
    from openr_tpu_torch.apsp import kernels as fw
    from openr_tpu_torch.ops import _cuda
    from openr_tpu_torch.ops.graph import INF

    before = [k.launches for k in _cuda.KERNELS]
    w = torch.full((4, 4), INF, dtype=torch.int32)
    w.fill_diagonal_(0)
    w[0, 1] = w[1, 2] = 1
    allow = torch.ones((4, 4), dtype=torch.bool)
    d, probe = fw.fw_close(w, allow)
    assert int(d[0, 2]) == 2 and int(probe) == 0
    slots = [torch.tensor([fw.INCREASE_PAD], dtype=torch.int32)] * 3
    d0, dirty, num = fw.fw_seed(d, w, *slots, 1, 4)
    assert torch.equal(d0, d) and int(num) == 0
    d1, _, counts = fw.fw_reclose(d0, allow, dirty | True, 1, 4, 1)
    assert torch.equal(d1, d) and counts.tolist() == [1, 0]
    assert [k.launches for k in _cuda.KERNELS] == before
    assert ApspState(4, device="cpu").device == torch.device("cpu")


def test_te_wrappers_run_plain_versions_on_cpu_tensors(monkeypatch):
    """K14-K18's wrappers on CPU tensors: plain versions, no launch; and
    the TE entry points ask for the card by default."""
    import numpy as np

    from openr_tpu_torch.convert import te_graph
    from openr_tpu_torch.ops import _cuda
    from openr_tpu_torch.te import kernels as tk
    from openr_tpu_torch.te import objective, optimizer

    before = [k.launches for k in _cuda.KERNELS]
    src, dst = np.array([0, 1, 1, 2]), np.array([1, 0, 2, 1])
    graph = te_graph(src, dst, 3, "cpu")
    we = torch.tensor([1.0, 1.0, 2.0, 2.0])
    up = torch.ones(4, dtype=torch.bool)
    d = torch.full((3, 3), tk.F_INF)
    d.fill_diagonal_(0.0)
    for _ in range(3):
        d_prev = d
        d, keep = tk.softmin_round(d_prev, we, graph, 0.05)
    assert abs(float(d[0, 2]) - 3.0) < 1e-3 and keep.dtype == torch.uint8
    tk.softmin_round_bwd(torch.ones(3, 3), d_prev, keep, we, graph, 0.05)
    p = tk.soft_gate(d, we, up, graph, 0.05)
    x = torch.ones((1, 3, 3))
    xsum = torch.zeros_like(x)
    x1 = tk.soft_flow_round(p, x, xsum, graph)
    assert torch.equal(xsum, x) and x1.shape == x.shape
    util = tk.soft_flow_util(p, xsum, torch.ones(4), graph)
    g_p = torch.zeros_like(p)
    tk.soft_flow_bwd_round(p, torch.ones_like(util), torch.ones(4), None, x,
                           g_p, graph, first=True)
    tk.soft_gate_bwd(g_p, d, we, up, graph, 0.05)
    loss, lse = tk.te_mlu(util, torch.ones(1), 0.25)
    tk.te_mlu_bwd(torch.ones(1), util, lse, torch.ones(1), 0.25)
    w, row = we + 5.0, torch.empty(4)
    tk.te_adam(w, torch.zeros(4), torch.zeros(4), torch.ones(4), up, row,
               tk.adam_hparams(optimizer.TeOptConfig(), 0))
    assert torch.equal(w, row) and bool((w < we + 5.0).all())
    assert [k.launches for k in _cuda.KERNELS] == before

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        objective.softmin_distances(we.numpy(), src, dst, up.numpy(), 1.0,
                                    3, 2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        optimizer.optimize_weights(src, dst, up.numpy(), we.numpy(),
                                   np.ones((1, 3, 3), np.float32),
                                   np.ones(4, np.float32), 3)


def test_tile_wrappers_run_plain_versions_on_cpu_tensors(monkeypatch):
    """K19-K21's wrappers and the tiled solve on CPU tensors: plain
    versions, no launch; and a mesh shape asks for the card by default."""
    import numpy as np

    from openr_tpu_torch import convert, parallel
    from openr_tpu_torch.ops import _cuda, spf
    from openr_tpu_torch.ops.graph import INF, compile_edges

    before = [k.launches for k in _cuda.KERNELS]
    graph = compile_edges([("a", "b", 1), ("b", "c", 2), ("c", "d", 3)])
    mesh = parallel.make_mesh([torch.device("cpu")] * 2, (1, 2))
    tiling = parallel.tile_graph(graph, 2)
    ops = convert.tiling_ranks(tiling, mesh)
    src = convert.rank_sources(
        mesh, np.full(8, graph.node_index["a"], dtype=np.int32))
    ov = convert.rank_replicas(mesh, graph.overloaded, bool)
    d, rounds, _ = spf._tile_solver(
        tiling.shape_key() + (graph.n_pad,), mesh, src, ops["src_l"],
        ops["hseg"], ops["hptr"], ops["w2"], ops["hcols"], ov)
    src_row = d.numpy()[0]
    assert [int(src_row[graph.node_index[x]]) for x in "abcd"] == [0, 1, 3, 6]
    assert rounds == 4
    n_tile = tiling.n_tile
    dp = d.blocks[0][0]
    flag = torch.zeros(1, dtype=torch.int32)
    recv = dp.clone()
    marks = spf.tile_mark(None, recv, dp, flag)
    assert bool(flag.item()) and bool((recv == INF).all())
    d0 = spf.tile_reset(marks, dp, src[0][0], 0)
    assert bool((d0[dp > 0] == INF).all()) and bool((d0[dp == 0] == 0).all())
    cc = torch.zeros(n_tile, dtype=torch.bool)
    count = torch.zeros(1, dtype=torch.int32)
    spf.tile_col_changed(d0, dp, cc, count)
    assert int(count.item()) == int(cc.sum()) > 0
    assert [k.launches for k in _cuda.KERNELS] == before

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        parallel.resolve_mesh((1, 1))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        parallel.make_mesh()
