"""Where the time goes in one TreeSim (or TreeSimHost, or NaiveSim) step on a
CUDA card.

    python -m wgpu_n_body_tpu_torch.utils.profile_step [N] [--walk per_particle]
    python -m wgpu_n_body_tpu_torch.utils.profile_step [N] --sim tree-host
    python -m wgpu_n_body_tpu_torch.utils.profile_step [N] --sim naive
    python -m wgpu_n_body_tpu_torch.utils.profile_step [N] --schedule let
    python -m wgpu_n_body_tpu_torch.utils.profile_step [N] --schedule let --fused-let-walk

N defaults to 4,000,000 and the walk to ``group``: the ``cli headless``
defaults (uniform scene, θ=0.75); with ``--sim naive`` to 262144, the naive
headless size (the all-pairs kernel B1). Every number comes from the
simulator's own step. Prints:
- the wall of 5 synchronised steps (2 with ``--sim tree-host``), with the SM
  clock and power;
- a ``torch.profiler`` window of 3 steps: kernel time per profiler range on
  the GPU timeline, each kernel attributed to the innermost range that holds
  it (``morton_keys``, ``morton_sort``, ``tree_build``, ``theta_walk`` and
  ``counters`` from ``TreeSim``, ``leapfrog.drift`` and ``leapfrog.kick``
  from the leapfrog;
  inside the group walk ``group_tiles``, ``group_kernel`` (B4: the walk
  kernel in ``group_walk``, the source table and the evaluation kernel in
  ``group_eval``) and ``group_fallback`` (B3 over the deferred mask, and
  the merge) from ``group_tree_forces_cuda``; a kernel in none of them
  counts to ``(no range)``),
  busy time as the union of kernel intervals, the idle share of the
  window, the top kernels and every kernel of ``morton_keys``,
  ``morton_sort`` and ``tree_build`` (the key kernel, CUB's sort passes,
  the four kernels of ``csrc/tree_build.cu``), and the peak device memory;
- ``TreeSim.diagnose`` of the last state (the group walk's deferred count).
A naive step's kernels all count to its ``naive_step`` range. With ``--sim
tree-host`` (N defaults to 4,000,000, singleton leaves) the step's host side
is printed too: the host time of the ranges ``host_build`` and, inside it,
``host_copy_down`` (positions and masses to the host, which waits for the
device), ``host_octree`` (the C++ build) and ``host_copy_up`` (the arena and
the permutation to the device), and of ``theta_walk`` (the host's enqueue of
the table and B3), from the same trace; its kernels count to ``theta_walk``
or to the rest of ``tree_step`` (the gather into DFS order and the leapfrog).
With ``--schedule replicated|let`` the step is ``ShardedTreeSim``'s in a
one-rank NCCL group (the sharded machinery on one card), and its kernel and
host time are also printed per stage: the sort (``morton_keys``,
``morton_sort``), ``tree_build``, B7 (``let_export``), the exchange
(``let_exchange``), the tile set-up both walks share (``let_tiles``), the
walks (``let_local_walk``, ``let_import_walk``; ``theta_walk`` under
``replicated``); with ``--fused-let-walk`` B8 (``let_import_forest``) and the
one walk (``let_fused_walk``).
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist

from wgpu_n_body_tpu_torch.inits import uniform_init
from wgpu_n_body_tpu_torch.models import NaiveSim, TreeSim, TreeSimHost
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams
from wgpu_n_body_tpu_torch.parallel import ShardedTreeSim
from wgpu_n_body_tpu_torch.parallel.mesh import free_port, init_distributed, make_mesh
# launches_of reads a trace per launch, as kernel_breakdown reads it per range
from wgpu_n_body_tpu_torch.utils.chip import card, launches_of, profiler_events, smi

STEPS = 3  # in the profiler window
RANGES = ("naive_step", "morton_keys", "morton_sort", "tree_build", "leapfrog.drift",
          "theta_walk", "counters", "leapfrog.kick", "group_tiles", "group_kernel", "group_walk",
          "group_eval", "group_fallback")  # outer to inner
HOST_RANGES = ("tree_step", "host_build", "host_copy_down", "host_octree", "host_copy_up",
               "theta_walk")  # of a TreeSimHost step, on the host's timeline
#: the stages of a sharded tree step, which do not nest
STAGES = ("morton_keys", "morton_sort", "tree_build", "let_export", "let_exchange",
          "let_tiles", "let_local_walk", "let_import_walk", "let_import_forest",
          "let_fused_walk", "theta_walk")


def kernel_breakdown(trace_events, names=RANGES):
    """(per-range kernel µs, per-(range, kernel) µs, busy µs, span µs)
    from a chrome trace's events; a kernel counts to the innermost range of
    ``names`` that holds it."""
    kernels = [e for e in trace_events if e.get("cat") == "kernel"]
    ranges = [e for e in trace_events
              if e.get("cat") == "gpu_user_annotation" and e.get("name") in names]
    by_range, by_kernel = {}, {}
    for k in kernels:
        inside = [r for r in ranges if r["ts"] <= k["ts"] < r["ts"] + r["dur"]]
        where = (min(inside, key=lambda r: (r["dur"], -names.index(r["name"])))["name"]
                 if inside else "(no range)")
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


def host_ranges(trace_events, names=HOST_RANGES):
    """Host µs per range of ``names``, summed over the trace."""
    out = {}
    for e in trace_events:
        if e.get("cat") == "user_annotation" and e.get("name") in names:
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"]
    return out


def host_ops(trace_events, within: str):
    """[(op or range name, host µs)] of the host events that lie directly
    inside the ranges named ``within`` (the outermost level below them),
    summed by name over the trace, longest first."""
    host = [e for e in trace_events
            if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation")]
    outer = [e for e in host if e.get("name") == within]
    out = {}
    for r in outer:
        lo, hi = r["ts"], r["ts"] + r["dur"]
        inner = [e for e in host if e is not r and lo <= e["ts"] and e["ts"] + e["dur"] <= hi]
        for e in inner:  # keep only events no other inner event encloses
            if not any(o is not e and o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
                       and o["dur"] > e["dur"] for o in inner):
                out[e["name"]] = out.get(e["name"], 0.0) + e["dur"]
    return sorted(out.items(), key=lambda x: -x[1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="profile_step")
    parser.add_argument("n", type=int, nargs="?")
    parser.add_argument("--sim", choices=["tree", "tree-host", "naive"], default="tree")
    parser.add_argument("--walk", choices=["group", "per_particle"], default="group")
    parser.add_argument("--schedule", choices=["replicated", "let"], default=None,
                        help="ShardedTreeSim's step in a one-rank NCCL group")
    parser.add_argument("--fused-let-walk", action="store_true",
                        help="with --schedule let: the fused LET walk (let_fused=True)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("profile_step needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(card())
    n = args.n or (262144 if args.sim == "naive" else 4_000_000)
    params = SimParams(particle_num=n)
    if args.sim == "naive":
        print(f"NaiveSim N={n}")
        sim = NaiveSim(params)
    elif args.sim == "tree-host":
        tp = TreeParams(leaf_bucket=1)
        print(f"TreeSimHost N={n} theta={tp.theta} leaf_bucket=1")
        sim = TreeSimHost(params, tp)
    elif args.schedule:
        tp = TreeParams(walk=args.walk, let_fused=args.fused_let_walk)
        init_distributed("nccl", 0, 1, f"tcp://localhost:{free_port()}")
        print(f"ShardedTreeSim N={n} theta={tp.theta} walk={tp.walk} schedule={args.schedule}, "
              f"fused LET walk {tp.let_fused}, one NCCL rank")
        sim = ShardedTreeSim(params, make_mesh(), tp, args.schedule)
    else:
        tp = TreeParams(walk=args.walk)
        print(f"TreeSim N={n} theta={tp.theta} walk={tp.walk}")
        sim = TreeSim(params, tp)
    step = sim.make_step()
    state = step(uniform_init(torch.Generator().manual_seed(0), params, dev))  # warm
    torch.cuda.synchronize()

    walls = []
    for _ in range(2 if args.sim == "tree-host" else 5):  # a host build takes seconds
        t0 = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        walls.append(round((time.perf_counter() - t0) * 1e3, 3))
    print(f"{type(sim).__name__} step wall ms", walls, smi("clocks.sm,power.draw,power.limit")[0])

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state = step(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = profiler_events(prof)
    by_range, by_kernel, busy, span = kernel_breakdown(events)
    total = sum(by_range.values())
    print(f"profiler, {STEPS} steps: kernel time {total / STEPS:.1f} us/step, busy "
          f"{busy / STEPS:.1f} us/step, wall {wall_us / STEPS:.1f} us/step, idle share of the "
          f"window {1 - busy / wall_us:.4f}, of the kernel span {1 - busy / span:.4f}")
    for where, us in sorted(by_range.items(), key=lambda x: -x[1]):
        print(f"  {where}: {us / STEPS:.1f} us/step ({us / total:.2%})")
    ranked = sorted(by_kernel.items(), key=lambda x: -x[1])
    for (where, name), us in ranked[:15]:
        print(f"    {where:14s} {us / STEPS:10.1f} us/step  {name}")
    for (where, name), us in ranked[15:]:  # the build stage's kernels, whatever their rank
        if where in ("morton_keys", "morton_sort", "tree_build"):
            print(f"    {where:14s} {us / STEPS:10.1f} us/step  {name}")
    if args.sim == "tree-host":
        host = host_ranges(events)
        print("  host time per range, ms/step: "
              + ", ".join(f"{k} {host.get(k, 0.0) / STEPS / 1e3:.3f}" for k in HOST_RANGES))
    if isinstance(sim, ShardedTreeSim):
        stages = kernel_breakdown(events, STAGES)[0]
        host = host_ranges(events, STAGES + ("sharded_tree_step",))
        print("  per stage, kernel / host ms per step: " + ", ".join(
            f"{k} {stages.get(k, 0.0) / STEPS / 1e3:.3f} / {host.get(k, 0.0) / STEPS / 1e3:.3f}"
            for k in STAGES + ("(no range)",) if k in stages or k in host)
            + f"; the step's host time {host.get('sharded_tree_step', 0.0) / STEPS / 1e3:.3f}")
        for within in ("let_import_walk", "let_import_forest", "group_fallback", "let_tiles",
                       "sharded_tree_step"):
            ops = host_ops(events, within)
            print(f"  host ms per step directly inside {within}, the longest: " + ", ".join(
                f"{name} {us / STEPS / 1e3:.3f}" for name, us in ops[:10]))
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if args.sim == "tree":  # TreeSim or ShardedTreeSim
        print("diagnose", sim.diagnose(state))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
