"""Whole runs of the harness on the CPU at a tiny size: the result line,
``correct`` for a sound run, and ``correct`` false for the control and for
each fault the cell can have, planted under the timed path."""

import pytest

from nbody_bench.spec import load_benchmark
from nbody_bench.tests._run import ROOT, checkout, run_cell, with_viewer

SMALL = ("--set", "particle_num=2048")
KEYS = {"correct", "attempted", "failed", "metrics", "device"}
VIEWER_CELL = "serve-100k-disc"


@pytest.fixture(scope="module")
def viewer_root(tmp_path_factory):
    """A checkout whose BENCHMARK.json adds the viewer cell (entries only;
    the cell is not in the committed benchmark)."""
    return checkout(tmp_path_factory.mktemp("viewer"), with_viewer(load_benchmark(ROOT)))


def _root(cell, request):
    return request.getfixturevalue("viewer_root") if cell == VIEWER_CELL else ROOT


def test_sound_run_prints_the_result_line_last():
    rc, res, err = run_cell("headless-4m-uniform", *SMALL)
    assert rc == 0, err
    assert set(res) == KEYS | {"checks"} and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"step_ms", "force_err", "peak_mem_gb", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    last = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and "limit" in line for line in last)


def test_viewer_run_checks_frames(viewer_root):
    rc, res, err = run_cell(VIEWER_CELL, *SMALL, root=viewer_root)
    assert rc == 0, err
    assert res["correct"] is True and set(res["metrics"]) == {"frame_ms_p95", "setup_s"}
    assert res["checks"]["frames.px_off"] == {"value": 0, "limit": 0}


def test_no_card_no_result():
    import subprocess
    import sys

    from nbody_bench.tests._run import ROOT

    p = subprocess.run([sys.executable, str(ROOT / "nbody_bench" / "run.py"), "--workload",
                        "headless-4m-uniform", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_traced_run_without_device_events_prints_no_result():
    rc, res, err = run_cell("headless-4m-uniform", *SMALL, trace=1)
    assert rc != 0 and res is None
    assert "taking it again" in err


@pytest.mark.parametrize("cell", ["headless-4m-uniform", VIEWER_CELL])
def test_control_is_not_correct(cell, request):
    rc, res, err = run_cell(cell, *SMALL, "--control", root=_root(cell, request))
    assert rc == 0, err
    assert res["correct"] is False
    assert res["checks"]["start.rows_off"]["value"] > 0


@pytest.mark.parametrize("cell,fault", [
    *[(c, f) for c in ("headless-4m-uniform", "headless-4m-disc")
      for f in ("frozen_step", "half_batch", "altered_row")],
    (VIEWER_CELL, "frozen_step"),
    (VIEWER_CELL, "half_batch"),
    (VIEWER_CELL, "altered_pixel"),
])
def test_planted_fault_is_not_correct(cell, fault, request):
    rc, res, err = run_cell(cell, *SMALL, "--plant", fault, root=_root(cell, request))
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


@pytest.fixture(scope="module")
def sharded_checkout(tmp_path_factory):
    """A checkout whose BENCHMARK.json adds a four-rank cell of the
    configuration and traffic files the benchmark keeps for one (entries
    only; the cell is not in the committed benchmark)."""
    bench = load_benchmark(ROOT)
    bench["configs"].append({"name": "tree-replicated-16m-4gpu", "source": "test", "reduced": [],
                             "file": "nbody_bench/configs/tree-replicated-16m-4gpu.json",
                             "why": "test"})
    bench["workloads"].append({"name": "replicated-16m-4gpu", "config": "tree-replicated-16m-4gpu",
                               "traffic": "steps-uniform-4096", "chips": 4, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("step_ms", "force_err", "peak_mem_gb"):
            m["workloads"].append("replicated-16m-4gpu")
    return checkout(tmp_path_factory.mktemp("sharded"), bench)


@pytest.mark.parametrize("fault", [None, "no_exchange", "half_batch", "frozen_step", "altered_row"])
def test_sharded_cell_on_four_gloo_ranks(sharded_checkout, fault):
    extra = ("--set", "particle_num=4096") + (("--plant", fault) if fault else ())
    rc, res, err = run_cell("replicated-16m-4gpu", *extra, root=sharded_checkout, timeout=900)
    assert rc == 0, err
    assert res["device"]["count"] == 4
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["headless-4m-uniform", "headless-4m-disc", VIEWER_CELL])
def test_control_is_not_correct_on_the_card(card, cell, request):
    import os
    import subprocess
    import sys

    root = _root(cell, request)
    p = subprocess.run([sys.executable, str(root / "nbody_bench" / "run.py"), "--workload", cell,
                        "--seed", "2147483999", "--seconds", "1", "--trace", "0",
                        "--set", "particle_num=262144", "--control"],
                       capture_output=True, text=True, cwd=root, timeout=900,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stderr
    import json

    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is False
