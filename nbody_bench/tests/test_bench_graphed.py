"""The reader ``graphed_pct`` (counters ``step.replayed`` over
``step.steps``, stubbed): the share of a step window's steps replayed from
captured CUDA graphs, nothing where the program counts no step or the loop
is not a step loop, and its entry in ``BENCHMARK.json``."""

import json

import pytest

from nbody_bench import traces
from nbody_bench.tests._run import ROOT
from nbody_bench.tests.test_bench_metrics import _ctx, _host
from nbody_bench.tests.test_bench_tracing import _read, program_counters  # noqa: F401

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
STEP_CELLS = ["headless-4m-uniform", "headless-4m-disc", "disc-2m-theta05",
              "headless-4m-per-particle"]


def _steps_ctx():
    return _ctx([_host(traces.STEP_RANGE, 0, 100), _host(traces.STEP_RANGE, 100, 100)])


@pytest.mark.parametrize("replayed,want", [(20, 100.0), (15, 75.0), (0, 0.0)])
def test_graphed_pct_reads_the_replayed_steps_over_the_steps(program_counters, replayed, want):
    program_counters.update({"step.steps": 20, "step.replayed": replayed})
    assert _read("graphed_pct", _steps_ctx()) == pytest.approx(want)


def test_graphed_pct_of_steps_none_replayed_reads_zero(program_counters):
    program_counters["step.steps"] = 20  # a program that counted no replay
    assert _read("graphed_pct", _steps_ctx()) == 0.0


@pytest.mark.parametrize("totals", [{}, {"step.steps": 0, "step.replayed": 0},
                                    {"walk.receivers": 4000}],
                         ids=["none", "no-step", "walk-only"])
def test_graphed_pct_without_its_counters_returns_nothing(program_counters, totals):
    program_counters.update(totals)
    assert _read("graphed_pct", _steps_ctx()) is None


def test_graphed_pct_of_a_program_without_counters_returns_nothing(monkeypatch):
    from wgpu_n_body_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert _read("graphed_pct", _steps_ctx()) is None


def test_graphed_pct_reads_nothing_in_the_viewer_loop(program_counters):
    program_counters.update({"step.steps": 20, "step.replayed": 20})
    ctx = _steps_ctx()
    ctx["loop"] = "viewer"
    assert _read("graphed_pct", ctx) is None


def test_graphed_pct_entry_lists_the_step_cells():
    entry = {m["name"]: m for m in BENCH["per_layer"]}["graphed_pct"]
    assert entry == {"name": "graphed_pct", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "runners", "moves": "step_ms",
                     "workloads": STEP_CELLS}
    assert BENCH["per_layer"][-1] is entry or BENCH["per_layer"][-1] == entry
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(STEP_CELLS) <= cells
