"""No module the benchmark runs is JAX's or the JAX package's, and the
reference imports nothing of the program either. Top-level names are
compared whole: ``wgpu_n_body_tpu_torch`` is not ``wgpu_n_body_tpu``."""

import subprocess
import sys

import pytest

from nbody_bench.tests._run import ROOT

HARNESS = ["nbody_bench", "nbody_bench.spec", "nbody_bench.scenes", "nbody_bench.peaks",
           "nbody_bench.traces", "nbody_bench.check", "nbody_bench.drive", "nbody_bench.faults",
           "nbody_bench.run", "nbody_bench.metrics._stages"]
REFERENCE = ["nbody_bench.reference", "nbody_bench.reference.order", "nbody_bench.reference.step",
             "nbody_bench.reference.octree", "nbody_bench.reference.render"]
# what a run imports of the program, beyond the harness itself
PROGRAM = ["wgpu_n_body_tpu_torch.models", "wgpu_n_body_tpu_torch.parallel",
           "wgpu_n_body_tpu_torch.runners.headless", "wgpu_n_body_tpu_torch.runners.online"]
JAX = {"jax", "jaxlib", "flax", "wgpu_n_body_tpu"}


def _loaded(modules, metric_files=()):
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"for p in {list(map(str, metric_files))!r}:\n"
            "    s = importlib.util.spec_from_file_location('m', p); "
            "s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"}, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(p.stdout.split())


def test_harness_and_program_load_no_jax():
    metrics = sorted((ROOT / "nbody_bench" / "metrics").glob("*.py"))
    top = _loaded(HARNESS + PROGRAM, metrics)
    assert not top & JAX, top & JAX
    assert "wgpu_n_body_tpu_torch" in top  # compared whole, the port's name passes


def test_reference_loads_nothing_of_the_program():
    top = _loaded(REFERENCE)
    assert not top & (JAX | {"wgpu_n_body_tpu_torch"}), top


@pytest.mark.parametrize("names,bad", [
    (["wgpu_n_body_tpu_torch.ops"], []),
    (["wgpu_n_body_tpu.ops"], ["wgpu_n_body_tpu"]),
    (["jax.numpy", "jaxlib"], ["jax", "jaxlib"]),
])
def test_the_guard_compares_whole_top_level_names(monkeypatch, names, bad):
    from nbody_bench import run

    fake = {n: object() for n in names}
    monkeypatch.setattr(sys, "modules", {**{k: v for k, v in sys.modules.items()
                                            if k.split(".")[0] not in JAX}, **fake})
    assert run.forbidden_loaded() == bad
