"""The reader ``eval_fill_pct`` on a synthetic trace: the counters
``walk.pairs`` over ``walk.eval_pairs``, stubbed; nothing from a program
that does not count the evaluation's pairs."""

import pytest

from nbody_bench.tests.test_bench_tracing import _counted_ctx, _read, program_counters  # noqa: F401

FULL = {"walk.pairs": 7_000_000, "walk.receivers": 4000, "walk.deferred": 30,
        "walk.eval_pairs": 7_340_032}


def test_eval_fill_pct_reads_the_pairs_with_a_receiver_over_the_computed_ones(program_counters):
    program_counters.update(FULL)
    assert _read("eval_fill_pct", _counted_ctx()) == pytest.approx(100 * 7_000_000 / 7_340_032)
    program_counters["walk.eval_pairs"] = 7_000_000  # every computed pair has a receiver
    assert _read("eval_fill_pct", _counted_ctx()) == 100.0


def test_eval_fill_pct_reads_nothing_in_the_viewer_loop(program_counters):
    program_counters.update(FULL)
    ctx = _counted_ctx()
    ctx["loop"] = "viewer"
    assert _read("eval_fill_pct", ctx) is None


@pytest.mark.parametrize("totals", [
    {},
    {"walk.receivers": 0},
    {"walk.receivers": 10},
    {"walk.pairs": 10, "walk.receivers": 4, "walk.deferred": 0},
    {"walk.pairs": 10, "walk.receivers": 4, "walk.deferred": 0, "walk.eval_pairs": 0},
], ids=["none", "no-receiver", "receivers-only", "without-eval-pairs", "eval-pairs-zero"])
def test_eval_fill_pct_without_the_kernels_count_returns_nothing(program_counters, totals):
    """A program that counts ``walk.pairs`` but not ``walk.eval_pairs``
    gives nothing."""
    program_counters.update(totals)
    assert _read("eval_fill_pct", _counted_ctx()) is None


def test_eval_fill_pct_of_a_program_without_counters_returns_nothing(monkeypatch):
    from wgpu_n_body_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert _read("eval_fill_pct", _counted_ctx()) is None
