"""Where the time goes in one TreeSim per-particle step on a CUDA card.

    python -m wgpu_n_body_tpu_torch.utils.profile_step [N]   # default 4,000,000

Prints, for the uniform scene at θ=0.75 (the ``cli headless`` defaults
with ``walk="per_particle"``):
- stage times by CUDA events over 3 steps (sort, build, kick+drift, walk,
  kick) and the host wall of each step;
- the wall of 5 synchronised ``TreeSim`` steps, with the SM clock and power;
- a ``torch.profiler`` window of 2 steps: kernel events attributed to the
  ``record_function`` ranges on the GPU timeline (``morton_sort``,
  ``tree_build``, ``theta_walk``; the rest is the leapfrog), busy time as
  the union of kernel intervals, the idle share of the window, the top
  kernels, and the peak device memory.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from wgpu_n_body_tpu_torch.inits import uniform_init
from wgpu_n_body_tpu_torch.models import TreeSim
from wgpu_n_body_tpu_torch.ops.tree_build import build_tree, morton_sort
from wgpu_n_body_tpu_torch.ops.tree_walk_cuda import tree_forces_cuda
from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams

RANGES = ("morton_sort", "tree_build", "theta_walk")


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()


def stage_times(state, params, tp):
    """One step by hand with CUDA events between the stages; returns
    (next state, [sort, build, kick+drift, walk, kick] ms, host wall ms)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    t0 = time.perf_counter()
    ev[0].record()
    ss, bound, keys = morton_sort(state, tp.max_depth)
    ev[1].record()
    tree = build_tree(ss, keys, bound, tp)
    ev[2].record()
    half = params.dt / 2.0
    vel_h = ss.vel + ss.acc * half
    pos_new = ss.pos + vel_h * params.dt
    ev[3].record()
    acc = tree_forces_cuda(pos_new, ss.pos, ss.mass, tree, params, tp)
    ev[4].record()
    vel = vel_h + acc * half
    ev[5].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return (ParticleState(pos_new, vel, acc, ss.mass),
            [ev[i].elapsed_time(ev[i + 1]) for i in range(5)], wall)


def kernel_breakdown(trace_events):
    """(per-range kernel µs, per-(range, kernel) µs, busy µs, span µs)
    from a chrome trace's events."""
    kernels = [e for e in trace_events if e.get("cat") == "kernel"]
    ranges = [e for e in trace_events
              if e.get("cat") == "gpu_user_annotation" and e.get("name") in RANGES]
    by_range, by_kernel = {}, {}
    for k in kernels:
        where = next((r["name"] for r in ranges
                      if r["ts"] <= k["ts"] < r["ts"] + r["dur"]), "leapfrog")
        by_range[where] = by_range.get(where, 0.0) + k["dur"]
        key = (where, k["name"][:60])
        by_kernel[key] = by_kernel.get(key, 0.0) + k["dur"]
    busy, end = 0.0, float("-inf")
    intervals = sorted((k["ts"], k["ts"] + k["dur"]) for k in kernels)
    for a, b in intervals:
        if b > end:
            busy += b - max(a, end)
            end = b
    return by_range, by_kernel, busy, intervals[-1][1] - intervals[0][0]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("profile_step needs a CUDA device", file=sys.stderr)
        return 1
    n = int(argv[0]) if argv else 4_000_000
    dev = torch.device("cuda", 0)
    print(_smi("name,power.limit"))
    params = SimParams(particle_num=n)
    tp = TreeParams(walk="per_particle")
    sim = TreeSim(params, tp)
    step = sim.make_step()
    state = step(uniform_init(torch.Generator().manual_seed(0), params, dev))  # warm
    torch.cuda.synchronize()

    names = ("sort", "build", "kick+drift", "walk", "kick")
    for _ in range(3):
        state, ms, wall = stage_times(state, params, tp)
        print("stages ms", {k: round(v, 3) for k, v in zip(names, ms)},
              f"host wall {wall:.3f} ms")

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        walls.append(round((time.perf_counter() - t0) * 1e3, 3))
    print("TreeSim step wall ms", walls, _smi("clocks.sm,power.draw,power.limit"))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state = step(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            by_range, by_kernel, busy, span = kernel_breakdown(json.load(f)["traceEvents"])
    total = sum(by_range.values())
    print(f"profiler, 2 steps: kernel time {total / 2:.1f} us/step, busy {busy / 2:.1f} "
          f"us/step, wall {wall_us / 2:.1f} us/step, idle share of the window "
          f"{1 - busy / wall_us:.4f}, of the kernel span {1 - busy / span:.4f}")
    for where, us in sorted(by_range.items(), key=lambda x: -x[1]):
        print(f"  {where}: {us / 2:.1f} us/step ({us / total:.2%})")
    for (where, name), us in sorted(by_kernel.items(), key=lambda x: -x[1])[:15]:
        print(f"    {where:12s} {us / 2:10.1f} us/step  {name}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
