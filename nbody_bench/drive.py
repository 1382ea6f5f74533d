"""Drive one cell: build the system under test from its configuration, feed
it the seeded scene, warm it up, run the window (or the traced window), and
hand what it produced to the check.

The program is ``wgpu_n_body_tpu_torch``: its ``OfflineHeadless`` (one
synchronised ``step()`` per step, as ``cli headless --chunk 1``) or its
``OnlineViewer`` (``tick(keys)``, as the browser asks for frames). A
sharded configuration runs one rank per chip, rank r on ``cuda:r``; rank 0
is the process that prints the result.
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from nbody_bench import check, scenes, traces
from nbody_bench.spec import Cell

STATE = check.FIELDS


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_sim(config: dict, mesh):
    """The configuration's simulator (the program's own classes)."""
    from wgpu_n_body_tpu_torch.models import NaiveSim, TreeSim
    from wgpu_n_body_tpu_torch.params import NaiveParams, SimParams, TreeParams

    sp = SimParams(**config["sim_params"])
    kind = config["sim"]
    if kind == "tree":
        return TreeSim(sp, TreeParams(**config["tree_params"]))
    if kind == "naive":
        return NaiveSim(sp, NaiveParams(**config.get("naive_params", {})))
    from wgpu_n_body_tpu_torch.parallel import ShardedNaiveSim, ShardedTreeSim

    if kind == "sharded_tree":
        return ShardedTreeSim(sp, mesh, TreeParams(**config["tree_params"]),
                              schedule=config["schedule"], let_cap=config.get("let_cap"))
    if kind == "sharded_naive":
        return ShardedNaiveSim(sp, mesh, NaiveParams(**config.get("naive_params", {})),
                               schedule=config["schedule"])
    raise ValueError(f"unknown sim {kind!r}")


def _host(state) -> dict:
    return {k: t.detach().cpu() for k, t in zip(STATE, state)}


def _clone(state) -> dict:
    return {k: t.detach().clone() for k, t in zip(STATE, state)}


def flight_keys(seed: int, traffic: dict):
    """The viewer's keys, one string per tick, forever. A flight is a set
    of excursions drawn once from the traffic's ``base_seed``, the same for
    every run: a key held, a pause, the opposite key held as long, a
    pause, so that each returns the camera to where it began. The run's
    seed orders them, afresh for each pass through the set. Forward holds
    are capped so that the camera never reaches the target."""
    base = np.random.default_rng(traffic["base_seed"])
    keys = list(traffic["keys"])
    opposite = {"w": "s", "s": "w", "a": "d", "d": "a", "q": "e", "e": "q"}
    lo, hi = traffic["hold_ticks"]
    ilo, ihi = traffic["idle_ticks"]
    flights = []
    for _ in range(traffic["excursions"]):
        key = keys[int(base.integers(len(keys)))]
        hold = int(base.integers(lo, hi + 1))
        if key == "w":
            hold = min(hold, traffic["forward_hold_max"])
        pauses = [int(base.integers(ilo, ihi + 1)) for _ in range(2)]
        flights.append([key] * hold + [""] * pauses[0] + [opposite[key]] * hold + [""] * pauses[1])
    order = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 1])
    while True:
        for f in order.permutation(len(flights)):
            yield from flights[f]


class Rank:
    """This process's place in the run: rank, world and device."""

    def __init__(self, rank: int, world: int, device: torch.device):
        self.rank, self.world, self.device = rank, world, device

    @property
    def root(self) -> bool:
        return self.rank == 0

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` stacked along dim 0 (``t`` itself on one)."""
        t = t.to(self.device).contiguous()
        if self.world == 1:
            return t
        out = torch.empty((self.world * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=self.device)
        dist.all_gather_into_tensor(out, t)
        return out

    def broadcast_int(self, v: int) -> int:
        if self.world == 1:
            return v
        t = torch.tensor([v], dtype=torch.int64, device=self.device)
        dist.broadcast(t, 0)
        return int(t.item())


def card_state(rk: Rank, when: str) -> None:
    """Log the card's clocks, power and throttle reasons (nvidia-smi)."""
    if rk.device.type == "cuda" and rk.root:
        from nbody_bench.peaks import smi

        log(f"card {when}: " + smi("clocks.sm,clocks.max.sm,power.draw,power.limit,"
                                   "temperature.gpu,clocks_throttle_reasons.active"))


def _peak() -> int:
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0


def _allocated() -> int:
    return torch.cuda.memory_allocated() if torch.cuda.is_available() else 0


class Outcome:
    """What a run hands back to ``run.py``: the end-to-end numbers, the
    traced window's context, and the checks."""

    def __init__(self):
        self.metrics: dict[str, float] = {}
        self.ctx: dict | None = None
        self.checks = check.Checks()
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0


def run_steps(cell: Cell, seed: int, seconds: float, trace: bool, rk: Rank, t_start: float,
              control: bool, plant: str | None) -> Outcome:
    from wgpu_n_body_tpu_torch.params import ParticleState
    from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless

    cfg, tr = cell.config, cell.traffic
    sp = cfg["sim_params"]
    mesh = _mesh(rk)
    sim = build_sim(cfg, mesh)
    scene = scenes.draw(tr["scene"], seed, sp["particle_num"], sp["g"], rk.device,
                        tr.get("scene_seed"))
    runner = OfflineHeadless(sim, lambda *_: ParticleState(*scene), device=rk.device)
    del scene
    if plant:
        from nbody_bench import faults

        faults.plant(plant, runner)
    runner.step()  # the start: the first step, from the benchmark's scene
    first = _host(runner.state)
    for _ in range(tr["warmup_steps"] - 1):
        runner.step()
    pre = _host(runner.state)
    rk.sync()
    held = _allocated()
    opening = _clone(runner.state)  # every segment starts from it, on the device
    rk.sync()
    held = _allocated() - held  # the benchmark's own bytes, not the program's
    pin = rk.device.type == "cuda"
    pinned = {k: torch.empty_like(v, pin_memory=pin) for k, v in pre.items()}
    steps = rk.broadcast_int(max(1, math.ceil(seconds / runner.timer.times_s[-1])))
    segment = tr["segment_steps"]
    setup_s = time.perf_counter() - t_start
    setup_peak = _peak()
    out = Outcome()

    def rewind():  # back to the state that opened the window
        runner.state = ParticleState(*(opening[k].clone() for k in STATE))

    def checked_step():  # the step that opens the window; its output to the host
        runner.step()
        for k, t in zip(STATE, runner.state):
            pinned[k].copy_(t, non_blocking=True)

    card_state(rk, "before the window")
    if trace:
        checked_step()
        rk.sync()
        n_traced = tr["trace_segments"] * segment

        def window():  # whole segments, each with its rewind, as the timed loop runs them
            for i in range(n_traced):
                with torch.profiler.record_function(traces.STEP_RANGE):
                    if i % segment == 0:
                        rewind()
                    runner.step()

        events = traces.capture(window, log)
        out.attempted = n_traced + 1
        out.ctx = _trace_ctx(events, n_traced, "steps", rk)
    else:
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats(rk.device)
        t0 = time.perf_counter()
        checked_step()
        done = 1
        while (time.perf_counter() - t0 < seconds) if rk.world == 1 else done < steps:
            if done % segment == 0:
                rewind()
            runner.step()
            done += 1
        rk.sync()
        wall = time.perf_counter() - t0
        peak = torch.tensor([_peak() - held], dtype=torch.float64, device=rk.device)
        out.metrics = {"step_ms": wall / done * 1e3, "setup_s": setup_s,
                       "peak_mem_gb": float(rk.gather(peak).max()) / 1e9}
        out.attempted = done
        log(f"window: {done} steps in {wall:.4f} s")
        ts = runner.timer.times_s[-done:]
        log("mean ms per step at each place of the segment: "
            + " ".join(f"{statistics.fmean(ts[j::segment]) * 1e3:.3f}"
                       for j in range(min(segment, done))))
    card_state(rk, "after the window")
    rk.sync()
    out.memory_peak = int(rk.gather(torch.tensor([max(setup_peak, _peak())], dtype=torch.float64,
                                                 device=rk.device)).max())
    win_out = {k: v.clone() for k, v in pinned.items()}
    del runner, sim, pinned, opening
    _free()
    whole = {name: {k: rk.gather(v) for k, v in st.items()}
             for name, st in (("first", first), ("pre", pre), ("out", win_out))}
    if not rk.root:
        return out
    scene = dict(zip(STATE, scenes.draw(tr["scene"], seed, sp["particle_num"], sp["g"],
                                        rk.device, tr.get("scene_seed"))))
    n_recv = tr["check_receivers"]
    nums = check.check_step(scene, whole["first"], cfg, seed, n_recv, control)
    out.checks.add_step("start", nums, cfg)
    nums = check.check_step(whole["pre"], whole["out"], cfg, seed, n_recv, control, count=trace)
    out.checks.add_step("window", nums, cfg)
    out.failed = sum(1 for s in ("start", "window")
                     if any(k.startswith(s) for k in out.checks.failed()))
    if not trace:
        out.metrics["force_err"] = nums["force_err"]
    if trace and out.ctx is not None:
        out.ctx["counts"] = {k: nums[k] for k in ("nodes", "interactions_mean") if k in nums}
        out.ctx["n"] = sp["particle_num"]
        out.ctx["receivers"] = sp["particle_num"] // rk.world
    return out


def run_viewer(cell: Cell, seed: int, seconds: float, trace: bool, rk: Rank, t_start: float,
               control: bool, plant: str | None) -> Outcome:
    from wgpu_n_body_tpu_torch.params import ParticleState
    from wgpu_n_body_tpu_torch.runners.online import OnlineViewer

    cfg, tr = cell.config, cell.traffic
    sp, vw = cfg["sim_params"], cfg["viewer"]
    sim = build_sim(cfg, _mesh(rk))
    scene = scenes.draw(tr["scene"], seed, sp["particle_num"], sp["g"], rk.device,
                        tr.get("scene_seed"))
    viewer = OnlineViewer(
        sim, lambda *_: ParticleState(*scene), width=vw["width"], height=vw["height"],
        steps_per_frame=vw["steps_per_frame"], footprint=vw["footprint"], speed=vw["speed"],
        png_level=vw["png_level"], step_sync_every=vw["step_sync_every"], device=rk.device)
    del scene
    if plant:
        from nbody_bench import faults

        faults.plant(plant, viewer.runner)
    viewer.warmup()  # the start: a frame and the first step, from the benchmark's scene
    first = _host(viewer.runner.state)
    warm_keys = [""] * tr["warmup_ticks"]
    for k in warm_keys:
        viewer.tick(k, True)
    rk.sync()
    limit = min(tr["check_window"], tr["trace_ticks"]) if trace else tr["check_window"]
    sample = {0} | set(check.sample_rows(seed, limit, tr["check_ticks"], salt=2).tolist())
    keys = flight_keys(seed, tr)
    used: list[str] = []
    pngs: dict[int, bytes] = {}
    snaps: dict[int, dict] = {}
    times: list[float] = []
    setup_s = time.perf_counter() - t_start
    out = Outcome()

    def snap(i: int) -> None:
        with torch.profiler.record_function(traces.SNAPSHOT_RANGE):
            if i in sample:
                snaps[i] = {"pre": _clone(viewer.runner.state)}
            if i - 1 in snaps:
                snaps[i - 1]["out"] = _clone(viewer.runner.state)

    def tick(i: int) -> None:
        k = next(keys)
        used.append(k)
        snap(i)
        with torch.profiler.record_function(traces.STEP_RANGE):
            t0 = time.perf_counter()
            png = viewer.tick(k, True)
            times.append(time.perf_counter() - t0)
        if i in sample:
            pngs[i] = png

    card_state(rk, "before the window")
    if trace:
        def window():
            for i in range(tr["trace_ticks"]):
                tick(len(times))

        events = traces.capture(window, log)
        # the events are the last window's; a retaken one ticks on, and its
        # frames are checked like any other
        out.ctx = _trace_ctx(events, tr["trace_ticks"], "viewer", rk)
    else:
        t_end = time.perf_counter() + seconds
        i = 0
        while time.perf_counter() < t_end:
            tick(i)
            i += 1
        wall = sum(times)
        p95 = statistics.quantiles(times, n=20)[-1] if len(times) >= 2 else times[0]
        out.metrics = {"frame_ms_p95": p95 * 1e3, "setup_s": setup_s}
        log(f"window: {len(times)} frames, median {statistics.median(times) * 1e3:.4f} ms, "
            f"p95 {p95 * 1e3:.4f} ms, {wall:.4f} s of ticks")
    card_state(rk, "after the window")
    snap(len(times))
    rk.sync()
    out.attempted = len(times)
    out.memory_peak = _peak()
    del viewer, sim
    _free()
    scene = dict(zip(STATE, scenes.draw(tr["scene"], seed, sp["particle_num"], sp["g"],
                                        rk.device, tr.get("scene_seed"))))
    n_recv = tr["check_receivers"]
    out.checks.add_step("start", check.check_step(scene, first_dev(first, rk), cfg, seed, n_recv,
                                                  control), cfg)
    rows = kicks = px = 0
    err = 0.0
    bad = 0
    for i in sorted(snaps):
        nums = check.check_step(snaps[i]["pre"], snaps[i]["out"], cfg, seed + i, n_recv, control)
        frame = check.check_frame(snaps[i]["pre"]["pos"], pngs[i], warm_keys + used[:i + 1], vw,
                                  control)
        rows, kicks, px = rows + nums["rows_off"], kicks + nums["kick_off"], px + frame
        err = max(err, nums["force_err"])
        bad += bool(nums["rows_off"] or nums["kick_off"] or frame
                    or nums["force_err"] > cfg["guarantees"]["force_err_max"])
    log(f"checked ticks {sorted(snaps)}")
    out.checks.add("ticks.rows_off", rows, 0)
    out.checks.add("ticks.kick_off", kicks, 0)
    out.checks.add("ticks.force_err", err, cfg["guarantees"]["force_err_max"])
    out.checks.add("frames.px_off", px, 0)
    out.failed = bad
    return out


def first_dev(first: dict, rk: Rank) -> dict:
    return {k: v.to(rk.device) for k, v in first.items()}


def _mesh(rk: Rank):
    if rk.world == 1:
        return None
    from wgpu_n_body_tpu_torch.parallel.mesh import Mesh

    return Mesh(rank=rk.rank, size=rk.world, device=rk.device)


def _free() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _trace_ctx(events, steps: int, loop: str, rk: Rank) -> dict:
    lo, hi = traces.window_us(events)
    busy = traces.busy_us(events, lo, hi)
    both = rk.gather(torch.tensor([busy, hi - lo], dtype=torch.float64, device=rk.device))
    both = both.view(rk.world, 2).cpu()
    log(f"traced window: {steps} {loop}, {(hi - lo) / steps / 1e3:.4f} ms each, of which the "
        f"device was busy {busy / steps / 1e3:.4f} ms")
    return {"events": events, "steps": steps, "loop": loop, "world": rk.world,
            "window": (lo, hi), "window_us": hi - lo, "busy_us": busy,
            "busy_s_mean": float(both[:, 0].mean()) / 1e6, "window_s": (hi - lo) / 1e6}


LOOPS = {"steps": run_steps, "viewer": run_viewer}
