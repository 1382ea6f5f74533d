"""Running the harness in a subprocess from the tests."""

import copy
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: The viewer cell's entries. Its files (``configs/tree-viewer-100k.json``,
#: ``traffic/flight-disc.json``, ``metrics/idle_pct.frame.py``,
#: ``metrics/render_device_ms.py``) stay in the folder, and the tests run
#: the viewer loop from a checkout whose BENCHMARK.json has these added; the
#: committed benchmark leaves the cell out (PERF.md, Open questions).
VIEWER = {
    "configs": [{"name": "tree-viewer-100k", "source": "test", "reduced": [],
                 "file": "nbody_bench/configs/tree-viewer-100k.json", "why": "test"}],
    "workloads": [{"name": "serve-100k-disc", "config": "tree-viewer-100k",
                   "traffic": "flight-disc", "chips": 1, "why": "test"}],
    "end_to_end": [{"name": "frame_ms_p95", "unit": "ms", "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": ["serve-100k-disc"]}],
    "per_layer": [
        {"name": "idle_pct.frame", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "frame_ms_p95", "workloads": ["serve-100k-disc"]},
        {"name": "render_device_ms", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "renderer", "moves": "frame_ms_p95", "workloads": ["serve-100k-disc"]},
    ],
}


def with_viewer(bench: dict) -> dict:
    """A copy of ``bench`` with the viewer cell's entries added."""
    bench = copy.deepcopy(bench)
    for key, entries in VIEWER.items():
        bench[key] += copy.deepcopy(entries)
    return bench


def checkout(dest: Path, bench: dict) -> Path:
    """``dest`` holding a copy of the benchmark's folder and ``bench`` as
    its BENCHMARK.json (the program is imported from this checkout)."""
    shutil.copytree(ROOT / "nbody_bench", dest / "nbody_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


def run_cell(workload, *extra, seed=7, seconds=0.2, trace=0, root=ROOT, timeout=600):
    """(return code, last stdout line as JSON or None, stderr) of one run
    on the CPU, from the checkout ``root`` (the program imported from this
    one)."""
    cmd = [sys.executable, str(root / "nbody_bench" / "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
           "--device", "cpu", *extra]
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=root, timeout=timeout,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    lines = p.stdout.strip().splitlines()
    try:
        res = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        res = None
    return p.returncode, res, p.stderr
