"""The cell ``headless-4m-per-particle`` and what it adds: the readers
``pp_lane_fill_pct`` (counters ``walk.pp_live_visits`` over
``walk.pp_warp_visits``, stubbed) and ``pp_pack_ms`` (the range
``pp_pack``, on a synthetic trace), each giving nothing where its counter
or span is absent, as on a program without them; the plain θ-walk reference
``reference/theta_walk.py`` against a brute-force numpy walk of a tree built
here body by body; and the cell's entries in ``BENCHMARK.json``."""

import json

import numpy as np
import pytest
import torch

from nbody_bench import spec, traces
from nbody_bench.reference import octree, order, theta_walk
from nbody_bench.tests._run import ROOT
from nbody_bench.tests.test_bench_metrics import _ctx, _host, _op
from nbody_bench.tests.test_bench_tracing import _read, program_counters  # noqa: F401

CELL = "headless-4m-per-particle"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
COUNTED = {"walk.pp_receivers": 62_500, "walk.pp_live_visits": 27_000_000,
           "walk.pp_warp_visits": 45_000_000, "walk.pp_interactions": 23_600_000}


def _steps_ctx():
    return _ctx([_host(traces.STEP_RANGE, 0, 100), _host(traces.STEP_RANGE, 100, 100)])


def test_pp_lane_fill_pct_reads_live_visits_over_warp_visits(program_counters):
    program_counters.update(COUNTED)
    assert _read("pp_lane_fill_pct", _steps_ctx()) == pytest.approx(60.0)
    program_counters["walk.pp_live_visits"] = 0
    assert _read("pp_lane_fill_pct", _steps_ctx()) == 0.0


@pytest.mark.parametrize("drop,zero,loop", [
    ("walk.pp_live_visits", None, "steps"),
    ("walk.pp_warp_visits", None, "steps"),
    (None, "walk.pp_warp_visits", "steps"),
    (None, None, "viewer"),
], ids=["without-live-visits", "without-warp-visits", "zero-visits", "viewer-loop"])
def test_pp_lane_fill_pct_without_its_counters_returns_nothing(program_counters, drop, zero,
                                                                loop):
    program_counters.update(COUNTED)
    if drop:
        del program_counters[drop]
    if zero:
        program_counters[zero] = 0
    ctx = _steps_ctx()
    ctx["loop"] = loop
    assert _read("pp_lane_fill_pct", ctx) is None


def test_pp_lane_fill_pct_of_a_program_without_counters_returns_nothing(monkeypatch):
    from wgpu_n_body_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert _read("pp_lane_fill_pct", _steps_ctx()) is None


def _pp_trace(pack=True):
    """Two steps of 100 µs: in each, ``theta_walk`` [10, 60) holds
    ``pp_pack`` [11, 13) (a pack kernel of 3 µs) and ``pp_walk`` [14, 16)
    (a walk kernel of 40 µs); a counting kernel of 5 µs launched in
    ``counters`` [61, 63)."""
    ev = []
    for s, t0 in enumerate((0.0, 100.0)):
        c = 10 * s
        ev += [_host(traces.STEP_RANGE, t0, 100), _host("theta_walk", t0 + 10, 50),
               _host("pp_walk", t0 + 14, 2), _host("counters", t0 + 61, 2)]
        if pack:
            ev.append(_host("pp_pack", t0 + 11, 2))
        ev += _op("tree_walk_pack_kernel", t0 + 12, 3, c + 1, t0 + 12)
        ev += _op("tree_walk_kernel<false>", t0 + 16, 40, c + 2, t0 + 15)
        ev += _op("tree_walk_kernel<true>", t0 + 64, 5, c + 3, t0 + 62)
    return ev


def test_pp_pack_ms_reads_the_kernels_launched_in_its_range():
    ctx = _ctx(_pp_trace())
    assert _read("pp_pack_ms", ctx) == pytest.approx(3 / 1e3)
    assert _read("walk_ms", ctx) == pytest.approx(43 / 1e3)  # pack and walk, not the count


def test_pp_pack_ms_without_its_range_returns_nothing():
    assert _read("pp_pack_ms", _ctx(_pp_trace(pack=False))) is None


def test_the_cell_lists_the_tree_step_metrics_and_not_the_group_walks():
    cell = spec.find_cell(BENCH, CELL)
    assert [m["name"] for m in cell.end_to_end] == ["step_ms", "force_err", "peak_mem_gb",
                                                     "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "idle_pct.step", "build_ms", "walk_ms", "walk_roofline", "build_roofline", "enqueue_ms",
        "starve_ms", "turnaround_ms", "integrate_ms", "pp_lane_fill_pct", "pp_pack_ms"]
    new = {m["name"]: m for m in BENCH["per_layer"][-2:]}
    assert set(new) == {"pp_lane_fill_pct", "pp_pack_ms"}
    assert all(m["workloads"] == [CELL] and m["moves"] == "step_ms" for m in new.values())
    assert (new["pp_lane_fill_pct"]["layer"], new["pp_pack_ms"]["layer"]) == (
        "kernels", "models: force walk")


# ------------------------------------------------ the θ-walk reference


def _numpy_tree(keys, pos, mass, bound, depth, bucket):
    """Nodes as dicts, built body range by body range from the sorted keys:
    a node holding more than ``bucket`` bodies above ``depth`` has a child
    per run of equal next-level key prefixes."""
    width0 = np.float32(2.0 * bound)

    def node(level, lo, hi):
        m = mass[lo:hi].astype(np.float64)
        cog = pos[lo] if hi - lo == 1 else (
            (pos[lo:hi].astype(np.float64) * m[:, None]).sum(0) / m.sum()).astype(np.float32)
        out = {"lo": lo, "hi": hi, "mass": m.sum(), "cog": cog,
               "width": np.float32(width0 * np.float32(2.0 ** -level)), "kids": []}
        if hi - lo > bucket and level < depth:
            prefix = keys[lo:hi] >> (3 * (depth - level - 1))
            starts = [0] + [i for i in range(1, hi - lo) if prefix[i] != prefix[i - 1]]
            for a, b in zip(starts, starts[1:] + [hi - lo]):
                out["kids"].append(node(level + 1, lo + a, lo + b))
        return out

    return node(0, 0, len(keys))


def _numpy_walk(root, pos, mass, p, me, theta, gdt, e):
    """(force, interactions) of one receiver, float64 sums, by recursion."""
    acc, inter, todo = np.zeros(3), 0, [root]

    def term(d, m):
        r2 = float(d @ d)
        r = np.sqrt(r2)
        return m * gdt / (r2 * r + e) / r * d

    while todo:
        nd = todo.pop()
        d32 = nd["cog"] - p
        dist = np.sqrt((d32[0] * d32[0] + d32[1] * d32[1]) + d32[2] * d32[2])
        if nd["width"] < np.float32(theta) * dist:
            acc += term(nd["cog"].astype(np.float64) - p.astype(np.float64), nd["mass"])
            inter += 1
        elif not nd["kids"]:
            for j in range(nd["lo"], nd["hi"]):
                if j != me:
                    acc += term(pos[j].astype(np.float64) - p.astype(np.float64),
                                float(mass[j]))
            inter += nd["hi"] - nd["lo"]
        else:
            todo.extend(nd["kids"])
    return acc, inter


@pytest.mark.parametrize("theta,bucket,depth", [(0.75, 4, 8), (0.5, 2, 6), (0.0, 3, 5),
                                                (1.1, 8, 3)])
def test_theta_walk_equals_a_brute_force_numpy_walk(theta, bucket, depth):
    n, g, e, dt = 300, 1e-3, 1e-4, 0.016
    rng = np.random.default_rng(5)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pos[:40] = (0.2 + 1e-3 * pos[:40]).astype(np.float32)  # a cluster down to max_depth
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    perm, bound, keys = order.morton_order(torch.from_numpy(pos), depth)
    sp, sm = torch.from_numpy(pos)[perm], torch.from_numpy(mass)[perm]
    levels = octree.build(keys, sp, sm, bound, depth, bucket)
    recv = (sp + 0.01 * torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)))
    idx = torch.arange(n)
    got, inter = theta_walk.forces(levels, sp, sm, recv, idx, theta, g, e, dt, block=64)
    root = _numpy_tree(keys.numpy(), sp.numpy(), sm.numpy(), float(bound), depth, bucket)
    for i in range(n):
        want, count = _numpy_walk(root, sp.numpy(), sm.numpy(), recv[i].numpy(), i, theta,
                                  g * dt, e)
        assert int(inter[i]) == count, i
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-12, atol=1e-18)
    if theta == 0.0:  # every pair but the receiver's own, once
        assert bool((inter == n).all())
