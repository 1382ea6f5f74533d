"""Each per-layer metric's arithmetic on a synthetic trace, and the
traced window's retake."""

import pytest

from nbody_bench import peaks, spec, traces


def _host(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _op(name, ts, dur, corr, launch_ts, cat="kernel"):
    """A device op and the runtime call that launched it."""
    return [{"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch_ts, "dur": 1,
             "args": {"correlation": corr}}]


def _trace():
    """Two steps of 100 µs on the host. In each: a sort kernel (10 µs)
    launched in ``morton_sort``, a walk kernel (40 µs) launched in
    ``group_eval`` nested in ``theta_walk``, a leapfrog kernel (5 µs) in
    ``tree_step`` alone, an NCCL kernel (3 µs); a raster kernel (2 µs) and
    a copy (1 µs) outside ``tree_step``."""
    ev = []
    for s, t0 in enumerate((0.0, 100.0)):
        c = 10 * s
        ev += [_host(traces.STEP_RANGE, t0, 100), _host("tree_step", t0 + 5, 80),
               _host("morton_sort", t0 + 6, 4), _host("theta_walk", t0 + 12, 20),
               _host("group_eval", t0 + 14, 5)]
        ev += _op("raster_kernel", t0 + 2, 2, c + 1, t0 + 1)
        ev += _op("Memcpy DtoH", t0 + 4, 1, c + 2, t0 + 1.5, cat="gpu_memcpy")
        ev += _op("cub_sort", t0 + 10, 10, c + 3, t0 + 7)
        ev += _op("group_eval_kernel", t0 + 25, 40, c + 4, t0 + 15)
        ev += _op("ncclDevKernel_AllGather", t0 + 66, 3, c + 5, t0 + 33)
        ev += _op("leapfrog_kernel", t0 + 70, 5, c + 6, t0 + 40)
        # the device span of theta_walk covers only its own (no) kernels
        ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": "group_eval", "ts": t0 + 25,
                   "dur": 40})
    return ev


def _ctx(events, loop="steps", world=1, steps=2):
    lo, hi = traces.window_us(events)
    busy = traces.busy_us(events, lo, hi)
    return {"events": events, "steps": steps, "loop": loop, "world": world, "window": (lo, hi),
            "window_us": hi - lo, "busy_us": busy}


def test_busy_and_idle_share():
    ctx = _ctx(_trace())
    assert ctx["window_us"] == 200
    assert ctx["busy_us"] == pytest.approx(2 * (2 + 1 + 10 + 40 + 3 + 5))
    idle = spec.metric_reader("idle_pct.step")(ctx)
    assert idle == pytest.approx(100 * (1 - 122 / 200))
    assert spec.metric_reader("idle_pct.frame")(ctx) is None
    assert spec.metric_reader("idle_pct.frame")(_ctx(_trace(), loop="viewer")) == pytest.approx(idle)


def test_busy_counts_overlap_once_and_clips_to_the_window():
    ev = [_host(traces.STEP_RANGE, 0, 10)] + _op("a", -5, 10, 1, -6) + _op("b", 2, 4, 2, 1)
    assert traces.busy_us(ev, *traces.window_us(ev)) == 6


def test_attribution_by_launch_counts_nested_ranges():
    ctx = _ctx(_trace())
    assert spec.metric_reader("walk_ms")(ctx) == pytest.approx(40 / 1e3)
    assert spec.metric_reader("build_ms")(ctx) == pytest.approx(10 / 1e3)


def test_attribution_without_launch_records_uses_device_spans():
    ev = [e for e in _trace() if e.get("cat") != "cuda_runtime"]
    assert spec.metric_reader("walk_ms")(_ctx(ev)) == pytest.approx(40 / 1e3)


def test_nccl_and_render_device_ms():
    assert spec.metric_reader("nccl_ms")(_ctx(_trace())) is None  # one chip
    assert spec.metric_reader("nccl_ms")(_ctx(_trace(), world=4)) == pytest.approx(3 / 1e3)
    render = spec.metric_reader("render_device_ms")(_ctx(_trace(), loop="viewer"))
    assert render == pytest.approx((2 + 1) / 1e3)


def test_snapshot_copies_are_dropped():
    ev = _trace() + [_host(traces.SNAPSHOT_RANGE, 90, 5)] + _op("copy", 91, 4, 99, 91,
                                                                  cat="gpu_memcpy")
    assert traces.busy_us(traces.clean(ev)) == traces.busy_us(_trace())


def test_rooflines_base():
    ctx = _ctx(_trace())
    ctx.update(counts={"interactions_mean": 378.2, "nodes": 996_977}, receivers=4_000_000,
               n=4_000_000, sms=132, sm_mhz=1980.0)
    bound = 378.2 * 4e6 * 2 / (16 * 132 * 1980e6) * 1e3
    assert peaks.walk_bound_ms(378.2 * 4e6, 132, 1980.0) == pytest.approx(bound)
    assert spec.metric_reader("walk_roofline")(ctx) == pytest.approx(100 * bound / 0.040)
    n = 4_000_000
    nbytes = (n * 24 + 12) + n * 24 + n * 94 + (n * 24 + 4 + 72 * (n + 1) + 996_978 * 44 + 9) - 24 * n
    assert peaks.build_bytes(n, 996_977) == nbytes
    assert spec.metric_reader("build_roofline")(ctx) == pytest.approx(
        100 * nbytes / 3.35e12 * 1e3 / 0.010)
    ctx.pop("counts")
    assert spec.metric_reader("walk_roofline")(ctx) is None


def test_top_ops_and_idle_gaps():
    ev = _trace()
    top = traces.top_device_ops(ev)
    assert top[0] == ["group_eval_kernel", 80 / 1e6]
    gaps = dict(traces.idle_gaps(ev))
    assert sum(gaps.values()) == pytest.approx((200 - 122) / 1e6)
    assert gaps["tree_step"] > 0


class _Profiler:
    """A stand-in for ``torch.profiler.profile`` whose trace is ``events()``."""

    events = staticmethod(lambda: [])

    def __init__(self, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def export_chrome_trace(self, path):
        import json

        with open(path, "w") as f:
            json.dump({"traceEvents": self.events()}, f)


def test_an_empty_window_is_taken_again_then_fails(monkeypatch, capsys):
    import torch

    class Prof(_Profiler):
        events = staticmethod(lambda: [_host(traces.STEP_RANGE, 0, 10)])

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    calls = []
    with pytest.raises(RuntimeError, match="3 traced windows"):
        traces.capture(lambda: calls.append(1))
    assert len(calls) == traces.TRACE_ATTEMPTS
    assert capsys.readouterr().err.count("taking it again") == traces.TRACE_ATTEMPTS


@pytest.mark.parametrize("lost", [0, 1, 2])
def test_a_retaken_viewer_window_reads_the_same_per_tick(monkeypatch, lost):
    """The viewer's ticks go on through a retake; the per-tick numbers are
    read over the ticks of the window kept, not over every tick run."""
    import time

    import torch

    from nbody_bench import drive
    from nbody_bench.tests._run import ROOT, with_viewer

    cell = spec.find_cell(with_viewer(spec.load_benchmark(ROOT)), "serve-100k-disc")
    cell.config["sim_params"]["particle_num"] = 2048
    ticks = cell.traffic["trace_ticks"] = 4
    windows = []

    def events():  # one 100 µs tick each, a 2 µs raster launched in it once a window is kept
        windows.append(1)
        ev = [_host(traces.STEP_RANGE, 100.0 * i, 100) for i in range(ticks)]
        if len(windows) > lost:
            for i in range(ticks):
                ev += _op("raster_kernel", 100.0 * i + 10, 2, i, 100.0 * i + 1)
        return ev

    class Prof(_Profiler):
        pass

    Prof.events = staticmethod(events)
    monkeypatch.setattr(torch.profiler, "profile", Prof)
    out = drive.run_viewer(cell, 11, 0.0, True, drive.Rank(0, 1, torch.device("cpu")),
                           time.perf_counter(), False, None)
    assert len(windows) == lost + 1 and out.attempted == (lost + 1) * ticks
    assert out.ctx["steps"] == ticks
    assert spec.metric_reader("render_device_ms")(out.ctx) == pytest.approx(2 / 1e3)
    assert spec.metric_reader("idle_pct.frame")(out.ctx) == pytest.approx(98.0)
    assert out.checks.correct, out.checks.as_json()
