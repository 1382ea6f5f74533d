"""The readers of the program's own spans and counters on a synthetic
trace: ``enqueue_ms``, ``starve_ms``, ``turnaround_ms``, ``integrate_ms``
(the ranges ``runner.*`` and ``leapfrog.*``), ``walk_pairs_ratio`` and
``deferred_pct`` (the counters ``walk.*``, stubbed)."""

import pytest

from nbody_bench import spec, traces
from nbody_bench.tests.test_bench_metrics import _ctx, _host, _op

SPAN_READERS = ("enqueue_ms", "starve_ms", "turnaround_ms", "integrate_ms")
COUNTER_READERS = ("walk_pairs_ratio", "deferred_pct")


def _trace(enqueue=True, leapfrog=True):
    """Two steps of 100 µs on the host. In each: ``runner.enqueue`` over
    [2, 40) holds the step's ranges (the drift [4, 6), ``theta_walk``
    [10, 30), the kick [32, 34)), then ``runner.sync`` [40, 85) and
    ``runner.health`` [86, 95). On the device: a drift kernel [5, 8), a
    walk kernel [12, 72) and a kick kernel [75, 77). Idle: [0, 2) before
    the enqueue and [2, 5), [8, 12) inside it (7 µs starved), [72, 75) and
    [77, 100) after it (28 µs of turnaround in all)."""
    ev = []
    for s, t0 in enumerate((0.0, 100.0)):
        c = 10 * s
        ev += [_host(traces.STEP_RANGE, t0, 100), _host("tree_step", t0 + 3, 35),
               _host("theta_walk", t0 + 10, 20), _host("runner.sync", t0 + 40, 45),
               _host("runner.health", t0 + 86, 9)]
        if enqueue:
            ev.append(_host("runner.enqueue", t0 + 2, 38))
        if leapfrog:
            ev += [_host("leapfrog.drift", t0 + 4, 2), _host("leapfrog.kick", t0 + 32, 2)]
        ev += _op("drift_kernel", t0 + 5, 3, c + 1, t0 + 4.5)
        ev += _op("group_eval_kernel", t0 + 12, 60, c + 2, t0 + 15)
        ev += _op("kick_kernel", t0 + 75, 2, c + 3, t0 + 33)
    return ev


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_span_readers():
    ctx = _ctx(_trace())
    assert _read("enqueue_ms", ctx) == pytest.approx(38 / 1e3)
    assert _read("starve_ms", ctx) == pytest.approx(7 / 1e3)
    assert _read("turnaround_ms", ctx) == pytest.approx(28 / 1e3)
    assert _read("integrate_ms", ctx) == pytest.approx(5 / 1e3)


@pytest.mark.parametrize("enqueue_at", [2.0, 0.0, 12.0])
def test_starved_and_turnaround_make_up_the_idle_share(enqueue_at):
    """Wherever the enqueue lies, the two add up to the idle of
    ``idle_pct.step``."""
    ev = [e if e["name"] != "runner.enqueue" else dict(e, ts=e["ts"] - 2 + enqueue_at)
          for e in _trace()]
    ctx = _ctx(ev)
    idle_ms = _read("idle_pct.step", ctx) / 100 * ctx["window_us"] / ctx["steps"] / 1e3
    starved, turnaround = _read("starve_ms", ctx), _read("turnaround_ms", ctx)
    assert starved >= 0 and turnaround >= 0
    assert abs(starved + turnaround - idle_ms) < 1e-9


@pytest.mark.parametrize("name,absent", [
    ("enqueue_ms", "enqueue"), ("starve_ms", "enqueue"), ("turnaround_ms", "enqueue"),
    ("integrate_ms", "leapfrog"),
])
def test_span_reader_without_its_span_returns_nothing(name, absent):
    assert _read(name, _ctx(_trace(**{absent: False}))) is None


@pytest.fixture
def program_counters(monkeypatch):
    """Stub the program's counter totals with the dict the test sets."""
    from wgpu_n_body_tpu_torch.utils import profiling

    totals = {}
    monkeypatch.setattr(profiling, "counters", lambda: dict(totals))
    return totals


def _counted_ctx():
    ctx = _ctx(_trace())
    ctx["counts"] = {"nodes": 1000, "interactions_mean": 250.0}
    return ctx


def test_counter_readers(program_counters):
    program_counters.update({"walk.pairs": 7_000_000, "walk.receivers": 4000, "walk.deferred": 30})
    ctx = _counted_ctx()
    assert _read("walk_pairs_ratio", ctx) == pytest.approx(7_000_000 / 4000 / 250.0)
    assert _read("deferred_pct", ctx) == pytest.approx(100 * 30 / 4000)
    program_counters["walk.deferred"] = 0
    assert _read("deferred_pct", ctx) == 0.0
    ctx["loop"] = "viewer"
    assert all(_read(n, ctx) is None for n in COUNTER_READERS)


@pytest.mark.parametrize("name", COUNTER_READERS)
@pytest.mark.parametrize("totals", [{}, {"walk.receivers": 0}, {"walk.receivers": 10}],
                         ids=["none", "no-receiver", "receivers-only"])
def test_counter_reader_without_its_counter_returns_nothing(program_counters, name, totals):
    program_counters.update(totals)
    assert _read(name, _counted_ctx()) is None


@pytest.mark.parametrize("name", COUNTER_READERS)
def test_counter_reader_of_a_program_without_counters_returns_nothing(monkeypatch, name):
    from wgpu_n_body_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert _read(name, _counted_ctx()) is None
