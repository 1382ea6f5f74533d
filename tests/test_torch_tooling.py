"""PyTorch port, on-card tooling (``chip_smoke.py``, ``utils/chip.py`` and the
development studies of ``utils/``): its shape, checked on the CPU. The
package never imports the script at the repo root; each shared helper is
defined once, in ``utils/chip.py``; the runtime loads none of the tooling;
every study refuses to run without a CUDA device."""

import ast
import functools
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "wgpu_n_body_tpu_torch"
CHIP = PKG / "utils" / "chip.py"
#: what the smoke and the studies share; each is defined in utils/chip.py only
SHARED = ("smi", "card", "max_sm_clock_mhz", "time_ms", "profiler_events", "launches_of",
          "launch_split", "device_ms", "bound", "sfu_bound_ms", "SFU_PER_SM_CLOCK",
          "FP32_PEAK", "HBM_PEAK", "print_ptxas", "ptxas_kernels", "sass_all_loops",
          "sass_loops", "print_sass", "variant_source", "sorted_scene", "octant_boxes",
          "octant_local", "visualize_pos", "flythrough_camera", "headless_after_one_step",
          "N_TREE", "N_LOCAL")
STUDIES = ("group_walk_study", "naive_study", "tree_walk_study", "chained_scan_study",
           "let_export_study", "tile_raster_study")


@functools.cache
def _sources():
    """(path, AST) of every Python file of the package and of chip_smoke.py."""
    paths = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    return [(p, ast.parse(p.read_text(), str(p))) for p in paths]


@functools.cache
def _definitions(tree):
    """Names a module defines: its functions and classes at any depth, and
    its module-level assignments."""
    names = {n.name for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}
    for node in tree.body:
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, ast.AnnAssign) else [])
        for t in targets:
            names |= {n.id for n in ast.walk(t) if isinstance(n, ast.Name)}
    return names


def test_no_package_module_imports_chip_smoke():
    found = []
    for path, tree in _sources()[:-1]:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            if any(m.split(".")[0] == "chip_smoke" for m in mods):
                found.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert not found, f"package modules import the script chip_smoke.py: {found}"


@pytest.mark.parametrize("name", SHARED)
def test_shared_helper_is_defined_once_in_chip(name):
    where = [str(p.relative_to(REPO)) for p, tree in _sources() if name in _definitions(tree)]
    assert where == [str(CHIP.relative_to(REPO))]


def test_no_tool_pins_a_kernel_source_by_its_hash():
    # a kernel is compared in turns against another checkout (--repo), not
    # against a copy of an old source checked by its SHA-256
    tools = [(p, t) for p, t in _sources()
             if p.parent.name == "utils" or p.name == "chip_smoke.py"]
    pinned = [str(p.relative_to(REPO)) for p, tree in tools
              if any(isinstance(n, (ast.Import, ast.ImportFrom))
                     and "hashlib" in [a.name for a in n.names] + [getattr(n, "module", None)]
                     for n in ast.walk(tree))]
    assert not pinned


def test_cli_loads_no_tooling(tmp_path):
    # from another directory, so that the repo root (and chip_smoke.py) is on
    # the path only through PYTHONPATH
    code = ("import sys\n"
            "import wgpu_n_body_tpu_torch.cli\n"
            "loaded = [m for m in sys.modules if m == 'wgpu_n_body_tpu_torch.utils.chip'\n"
            "          or m.endswith('_study') or m == 'chip_smoke']\n"
            "assert not loaded, loaded\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, check=True, timeout=120)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a CUDA device")
@pytest.mark.parametrize("study", STUDIES)
def test_study_refuses_without_a_cuda_device(study, capsys):
    module = importlib.import_module(f"wgpu_n_body_tpu_torch.utils.{study}")
    assert module.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
