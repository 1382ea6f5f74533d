"""What a run measures, found by name from ``BENCHMARK.json``.

A cell (``workloads``) names a configuration and a traffic mix; each lives
in a file of its own, ``configs/<config>.json`` and
``traffic/<traffic>.json`` beside this module, and each per-layer metric is
a reader in ``metrics/<name>.py``. Adding a cell, a configuration, a mix or
a metric is adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)  # the metric entries this cell reports
    per_layer: list = field(default_factory=list)


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, base: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration and traffic read from
    ``base``; KeyError for a name the benchmark does not have."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    with open(base.parent / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(base / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str, base: Path = HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"nbody_bench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
