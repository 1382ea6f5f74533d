"""The reader ``pool_fill_pct`` on stubbed counters (``walk.pool_chunks``
over ``walk.pool_cap``): nothing from a program that does not count its
pool or counts a pool of no chunks. And the cell ``disc-2m-theta05`` run
whole on the CPU at a tiny size, as the other step cells are: correct when
sound, not correct for the control or for each fault planted under the
timed path."""

import json
import os
import subprocess
import sys

import pytest

from nbody_bench.tests._run import ROOT, run_cell
from nbody_bench.tests.test_bench_tracing import _counted_ctx, _read, program_counters  # noqa: F401

CELL = "disc-2m-theta05"
SMALL = ("--set", "particle_num=2048")
FULL = {"walk.pairs": 7_000_000, "walk.receivers": 4000, "walk.deferred": 30,
        "walk.eval_pairs": 7_340_032, "walk.pool_chunks": 270, "walk.pool_cap": 500}


def test_pool_fill_pct_reads_the_chunks_taken_over_the_chunks_held(program_counters):
    program_counters.update(FULL)
    assert _read("pool_fill_pct", _counted_ctx()) == pytest.approx(54.0)
    program_counters["walk.pool_chunks"] = 0
    assert _read("pool_fill_pct", _counted_ctx()) == 0.0


def test_pool_fill_pct_reads_nothing_in_the_viewer_loop(program_counters):
    program_counters.update(FULL)
    ctx = _counted_ctx()
    ctx["loop"] = "viewer"
    assert _read("pool_fill_pct", ctx) is None


@pytest.mark.parametrize("drop,zero", [
    ("walk.pool_chunks", None),
    ("walk.pool_cap", None),
    (None, "walk.pool_cap"),
    (None, "walk.receivers"),
], ids=["without-pool-chunks", "without-pool-cap", "cap-zero", "no-receiver"])
def test_pool_fill_pct_without_its_counters_returns_nothing(program_counters, drop, zero):
    program_counters.update(FULL)
    if drop:
        del program_counters[drop]
    if zero:
        program_counters[zero] = 0
    assert _read("pool_fill_pct", _counted_ctx()) is None


def test_pool_fill_pct_of_a_program_without_counters_returns_nothing(monkeypatch):
    from wgpu_n_body_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert _read("pool_fill_pct", _counted_ctx()) is None


def test_disc_2m_theta05_sound_run_is_correct():
    rc, res, err = run_cell(CELL, *SMALL, seed=2147483647 + 99)
    assert rc == 0, err
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert set(res["metrics"]) == {"step_ms", "force_err", "peak_mem_gb", "setup_s"}


def test_disc_2m_theta05_control_is_not_correct():
    rc, res, err = run_cell(CELL, *SMALL, "--control")
    assert rc == 0, err
    assert res["correct"] is False
    assert res["checks"]["start.rows_off"]["value"] > 0


@pytest.mark.parametrize("fault", ["frozen_step", "half_batch", "altered_row"])
def test_disc_2m_theta05_planted_fault_is_not_correct(fault):
    rc, res, err = run_cell(CELL, *SMALL, "--plant", fault)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


@pytest.mark.card
def test_disc_2m_theta05_control_is_not_correct_on_the_card(card):
    p = subprocess.run([sys.executable, str(ROOT / "nbody_bench" / "run.py"), "--workload", CELL,
                        "--seed", "2147483999", "--seconds", "1", "--trace", "0",
                        "--set", "particle_num=262144", "--control"],
                       capture_output=True, text=True, cwd=ROOT, timeout=900,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is False
