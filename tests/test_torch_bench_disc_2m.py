"""PyTorch port, BASELINE config 3 (the 2M-body galaxy disc at θ=0.5) as
the benchmark runs it: ``nbody_bench/run.py`` on the cell
``disc-2m-theta05`` at a small N on the CPU, through ``TreeSim`` and
``OfflineHeadless``, held to the plain reference by the configuration's own
limits; the bfloat16 control fails them."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CELL = "disc-2m-theta05"
CONFIG = ROOT / "nbody_bench" / "configs" / "tree-disc-2m-theta05.json"


def _run(*extra, seed=2147483901):
    cmd = [sys.executable, str(ROOT / "nbody_bench" / "run.py"), "--workload", CELL,
           "--seed", str(seed), "--seconds", "0.2", "--trace", "0", "--device", "cpu",
           "--set", "particle_num=2048", *extra]
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_the_configuration_is_baseline_config_3_uncut():
    cfg = json.loads(CONFIG.read_text())
    base = json.loads((ROOT / "nbody_bench" / "configs" / "tree-headless-4m.json").read_text())
    assert cfg["sim_params"] == dict(base["sim_params"], particle_num=2_000_000)
    assert cfg["tree_params"] == dict(base["tree_params"], theta=0.5)
    assert cfg["reduced"] == [] and cfg["tree_params"]["walk_tile"] is None
    assert cfg["guarantees"]["force_err_max"] < base["guarantees"]["force_err_max"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("tree-disc-2m-theta05",
                                                                "steps-disc", 1)


@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_the_cell_is_correct_and_its_control_is_not(control):
    res = _run(*(["--control"] if control else []))
    assert res["correct"] is (not control), res["checks"]
    if control:
        assert res["checks"]["start.rows_off"]["value"] > 0
    else:
        limit = json.loads(CONFIG.read_text())["guarantees"]["force_err_max"]
        assert res["checks"]["window.force_err"] == {"value": res["metrics"]["force_err"]["value"],
                                                     "limit": limit}
