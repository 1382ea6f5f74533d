"""Cells, configurations, traffic mixes and metrics are found by name, and
a new one is only new files and new entries."""

import hashlib
import json
import re
import shutil

import pytest

from nbody_bench import spec
from nbody_bench.tests._run import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = spec.find_cell(BENCH, cell)
    assert c.config["sim_params"]["particle_num"] > 0
    assert c.traffic["loop"] in ("steps", "viewer")
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    read = spec.metric_reader(metric)
    ctx = {"events": [], "steps": 0, "loop": "none", "world": 1, "window": (0.0, 0.0),
           "window_us": 0.0, "busy_us": 0.0}
    assert read(ctx) is None  # a reader that finds nothing returns nothing


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.find_cell(BENCH, "no-such-cell")


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_is_new_files_and_entries(tmp_path):
    base = tmp_path / "nbody_bench"
    shutil.copytree(ROOT / "nbody_bench", base, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(base)
    (base / "configs" / "tree-small.json").write_text(json.dumps(
        dict(json.loads((base / "configs" / "tree-headless-4m.json").read_text()),
             sim_params={"particle_num": 2048, "g": 1e-6, "e": 1e-4, "dt": 0.016})))
    (base / "traffic" / "steps-spherical.json").write_text(json.dumps(
        dict(json.loads((base / "traffic" / "steps-uniform.json").read_text()),
             scene="spherical")))
    (base / "metrics" / "steps_seen.py").write_text("def read(ctx):\n    return float(ctx['steps'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tree-small", "source": "test", "reduced": ["particle_num"],
                             "file": "nbody_bench/configs/tree-small.json", "why": "test"})
    bench["workloads"].append({"name": "small-spherical", "config": "tree-small",
                               "traffic": "steps-spherical", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "runners",
                               "moves": "step_ms", "workloads": ["small-spherical"]})
    bench["end_to_end"][0]["workloads"].append("small-spherical")
    cell = spec.find_cell(bench, "small-spherical", base)
    assert cell.traffic["scene"] == "spherical"
    assert cell.config["sim_params"]["particle_num"] == 2048
    assert [m["name"] for m in cell.per_layer] == ["steps_seen"]
    assert spec.metric_reader("steps_seen", base)({"steps": 3}) == 3.0
    after = _digest(base)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == [
        "configs/tree-small.json", "metrics/steps_seen.py", "traffic/steps-spherical.json"]


def test_a_naive_cell_added_as_data_runs(tmp_path):
    """A configuration of another simulator, with no Morton reorder, is
    only a new file: the harness runs it and the reference holds it."""
    import os
    import subprocess
    import sys

    shutil.copytree(ROOT / "nbody_bench", tmp_path / "nbody_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    guarantees = dict(json.loads((ROOT / "nbody_bench/configs/tree-headless-4m.json").read_text())
                      ["guarantees"], morton_reorder_every_step=False, force_err_max=1e-4)
    (tmp_path / "nbody_bench/configs/naive-small.json").write_text(json.dumps({
        "sim": "naive", "chips": 1, "reduced": [], "guarantees": guarantees,
        "sim_params": {"particle_num": 1024, "g": 1e-6, "e": 1e-4, "dt": 0.016}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "naive-small", "source": "test", "reduced": [],
                             "file": "nbody_bench/configs/naive-small.json", "why": "test"})
    bench["workloads"].append({"name": "naive-uniform", "config": "naive-small",
                               "traffic": "steps-uniform", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("naive-uniform")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    p = subprocess.run([sys.executable, "nbody_bench/run.py", "--workload", "naive-uniform",
                        "--seed", "3", "--seconds", "0.2", "--trace", "0", "--device", "cpu"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stderr
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["window.force_err"]["value"] < 1e-5


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nbody_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"]: w for w in BENCH["workloads"]}
    # a full check of 24 cells fits the 43200 s the check allows
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    pairs = {(w["config"], w["traffic"]) for w in cells.values()}
    assert len(pairs) == len(cells)
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert {w["config"] for w in cells.values()} == set(configs)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("nbody_bench/configs/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names + list(cells))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in cells:
        reported = [m for m in e2e.values() if cell in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
