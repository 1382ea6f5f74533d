"""Command-line entry points — counterpart of ``wgpu_n_body_tpu/cli.py``
(reference src/bin/ + benches/benchmark.rs).

    python -m wgpu_n_body_tpu_torch.cli headless --sim naive --n 262144
    python -m wgpu_n_body_tpu_torch.cli headless          # TreeSim, N=4M, group walk
    python -m wgpu_n_body_tpu_torch.cli bench             # naive, then tree, at each size
    python -m wgpu_n_body_tpu_torch.cli visualize --gif disc.gif   # TreeSim N=100k disc, 60 frames
    python -m wgpu_n_body_tpu_torch.cli serve             # browser viewer at 127.0.0.1:8000
    python -m wgpu_n_body_tpu_torch.cli render --trajectory DIR

    python -m wgpu_n_body_tpu_torch.cli headless --devices 4 --schedule let   # 4 GPUs, NCCL
    python -m wgpu_n_body_tpu_torch.cli headless --devices 4 --device cpu --n 4096   # 4 CPU ranks

Flags and defaults are the JAX package's, plus ``--device`` (default
``cuda``; there is no silent fallback to the CPU). Ported: ``--sim naive``,
``--sim tree`` (either walk) and ``--sim tree-host`` (host C++ build,
device walk; needs ``g++``). ``visualize``, ``serve`` and ``render``
rasterise on ``--device`` (on the card through the kernels of
``csrc/raster.cu``). ``headless --devices K`` with K > 1 spawns K ranks
itself (``torch.multiprocessing``), rank r on ``cuda:r`` under NCCL, or K
CPU processes under gloo with ``--device cpu``, and runs ``--sim naive``
(``--schedule allgather|ring``, default allgather) or ``--sim tree``
(``replicated|let``, default replicated) sharded over them; rank 0 prints.
Exit code 2 (naming the field): a bad ``--schedule``, ``--devices`` with
another ``--sim`` or another command, more ranks than visible GPUs, an N
the ranks do not divide, ``--fused-let-walk`` (not yet ported), a
malformed ``--tree-kw``, a ``TreeParams`` value the chosen device does not
take (``walk_tile`` above 512 on CUDA) or one the backend does not take
(``leaf_bucket`` other than 1 with ``--sim tree-host``).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from wgpu_n_body_tpu_torch.inits import INITS, uniform_init
from wgpu_n_body_tpu_torch.models import NaiveSim, TreeSim, TreeSimHost
from wgpu_n_body_tpu_torch.models.base import Simulator
from wgpu_n_body_tpu_torch.ops.let_export import check_let_cap
from wgpu_n_body_tpu_torch.params import NaiveParams, SimParams, TreeParams
from wgpu_n_body_tpu_torch.parallel import ShardedNaiveSim, ShardedTreeSim, sharded_naive, sharded_tree
from wgpu_n_body_tpu_torch.parallel.mesh import Mesh, free_port, init_distributed, make_mesh
from wgpu_n_body_tpu_torch.runners.gif import write_gif
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.runners.online import OnlineViewer, serve
from wgpu_n_body_tpu_torch.runners.renderer import Camera, render_frame_on_device, write_png
from wgpu_n_body_tpu_torch.runners.trajectory import TrajectoryReader, TrajectoryWriter
from wgpu_n_body_tpu_torch.utils.profiling import time_steps


SIMS = ("naive", "tree", "tree-host")
TREE_SIMS = ("tree", "tree-host")  # the backends --tree-kw applies to
#: valid --schedule values per sharded backend, the first the default
SCHEDULES = {"naive": sharded_naive.SCHEDULES, "tree": sharded_tree.SCHEDULES}


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available")
    return device


def _usage_error(msg: str):
    print(msg, file=sys.stderr)
    raise SystemExit(2)


def _tree_kw(specs: list[str]) -> dict:
    """--tree-kw NAME=VALUE overrides as TreeParams kwargs; values are
    Python literals, as in the JAX CLI. A malformed one exits 2 naming the
    field and the value."""
    fields = {f.name for f in dataclasses.fields(TreeParams)}
    out = {}
    for spec in specs:
        name, sep, val = spec.partition("=")
        if not sep or name not in fields:
            _usage_error(
                f"--tree-kw {spec!r}: expected NAME=VALUE with NAME one of {sorted(fields)}"
            )
        try:
            out[name] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            _usage_error(
                f"--tree-kw {name}: value {val!r} is not a Python literal "
                "(quote strings, e.g. walk='\"per_particle\"')"
            )
    return out


def _build_sim(args) -> Simulator:
    if args.devices > 1:
        _usage_error(f"--devices {args.devices}: sharded runs are `headless` only "
                     "(--sim naive|tree)")
    if args.sim not in SIMS:
        _usage_error(f"--sim {args.sim!r}: choose one of {', '.join(SIMS)}")
    params = SimParams(particle_num=args.n, g=args.g, e=args.e, dt=args.dt)
    if args.sim == "naive":
        return NaiveSim(params, NaiveParams(use_pallas=not args.no_pallas))
    tkw = _tree_kw(args.tree_kw)
    if args.sim == "tree-host":
        # reference-architecture hybrid: host C++ build + device walk
        tkw = {"leaf_bucket": 1, **tkw}
    try:
        tp = TreeParams(**{"theta": args.theta, **tkw})
    except TypeError as exc:
        _usage_error(f"--tree-kw: {exc}")
    if args.sim == "tree-host":
        try:
            return TreeSimHost(params, tp)
        except (ValueError, RuntimeError) as exc:
            _usage_error(f"--sim tree-host: {exc}")
    try:
        sim = TreeSim(params, tp)
        # torch.device parses the name without touching a GPU
        sim.check_device(torch.device(args.device))
    except ValueError as exc:
        _usage_error(f"--sim tree: {exc}")
    return sim


def _sharded_sim(args, mesh: Mesh) -> Simulator:
    """The sharded backend of ``--devices`` for this rank's ``mesh``; exits 2
    naming the field on a value it does not take (called once with a
    stand-in mesh before any rank starts)."""
    if args.sim not in SCHEDULES:
        _usage_error(f"--devices requires --sim naive|tree (got --sim {args.sim})")
    schedule = args.schedule or SCHEDULES[args.sim][0]
    if schedule not in SCHEDULES[args.sim]:
        _usage_error(f"--schedule {schedule!r} invalid for --sim {args.sim}: choose from "
                     f"{', '.join(SCHEDULES[args.sim])}")
    if args.fused_let_walk:
        _usage_error("--fused-let-walk: the fused LET walk is not yet ported (ROADMAP B8); "
                     "the default split walk runs without the flag")
    if args.let_cap is not None:
        try:
            check_let_cap(args.let_cap)
        except ValueError as exc:
            _usage_error(f"--let-cap: {exc}")
    params = SimParams(particle_num=args.n, g=args.g, e=args.e, dt=args.dt)
    try:
        if args.sim == "naive":
            return ShardedNaiveSim(params, mesh, NaiveParams(use_pallas=not args.no_pallas),
                                   schedule=schedule)
        tp = TreeParams(**{"theta": args.theta, **_tree_kw(args.tree_kw)})
        return ShardedTreeSim(params, mesh, tp, schedule=schedule, let_cap=args.let_cap)
    except (TypeError, ValueError, NotImplementedError) as exc:
        _usage_error(f"--sim {args.sim} --devices {args.devices}: {exc}")


def _rank_main(rank: int, args, port: int) -> None:
    """One rank of ``headless --devices K``: join the group, run, leave."""
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    else:  # K processes share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.devices))
    init_distributed("nccl" if cuda else "gloo", rank, args.devices, f"tcp://localhost:{port}")
    try:
        mesh = make_mesh(device=f"cuda:{rank}" if cuda else "cpu")
        _headless(args, _sharded_sim(args, mesh), mesh.device, root=rank == 0)
    finally:
        dist.destroy_process_group()


def _run_sharded(args) -> int:
    """``headless --devices K``: check the arguments, then spawn K ranks."""
    _check_tree_kw(args)
    device = torch.device(args.device)
    _sharded_sim(args, Mesh(rank=0, size=args.devices, device=device))
    if device.type == "cuda":
        visible = torch.cuda.device_count()
        if args.devices > visible:
            _usage_error(f"--devices {args.devices}: only {visible} CUDA devices are visible")
    elif device.type != "cpu":
        _usage_error(f"--devices {args.devices}: --device must be cuda or cpu, got {device}")
    try:
        mp.spawn(_rank_main, args=(args, free_port()), nprocs=args.devices, join=True)
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
        print(f"a rank failed: {exc}", file=sys.stderr)
        return 1
    return 0


def _add_sim_flags(p, n, g, e, dt, sim, sim_list=False):
    if sim_list:  # bench: comma-separated list of backends
        p.add_argument("--sim", default=sim)
    else:
        p.add_argument("--sim", choices=list(SIMS), default=sim)
    p.add_argument("--n", type=int, default=n)
    p.add_argument("--g", type=float, default=g)
    p.add_argument("--e", type=float, default=e)
    p.add_argument("--dt", type=float, default=dt)
    p.add_argument("--init", choices=["uniform", "disc", "spherical"])
    p.add_argument("--theta", type=float, default=0.75)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-pallas", action="store_true",
                   help="plain torch force instead of the hand-written kernel")
    p.add_argument(
        "--tree-kw", action="append", default=[], metavar="NAME=VALUE",
        help="override a TreeParams field (value = Python literal), e.g. "
        "--tree-kw walk='\"per_particle\"' --tree-kw leaf_bucket=32",
    )
    p.add_argument("--devices", type=int, default=0,
                   help="shard `headless` over K ranks: K GPUs (NCCL), or K CPU processes "
                   "(gloo) with --device cpu (0/1 = one device)")
    p.add_argument("--schedule", type=str, default=None,
                   help="sharded schedule: naive allgather|ring, tree replicated|let "
                   "(default: the first of each)")
    p.add_argument("--let-cap", type=int, default=None,
                   help="LET export rows per destination (default: sized from measured "
                   "need, parallel/let_tree.py::auto_let_cap)")
    p.add_argument("--fused-let-walk", action="store_true",
                   help="the JAX package's fused LET walk: not yet ported (exits 2)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the state (default cuda)")


def _check_tree_kw(args) -> None:
    if args.tree_kw and args.sim not in TREE_SIMS:
        _usage_error(f"--tree-kw applies to --sim tree|tree-host only (got --sim {args.sim})")


def _headless(args, sim: Simulator, device: torch.device, root: bool = True) -> None:
    """The headless run of ``sim``: one device, or one rank of a sharded
    run (every rank runs this; the ``root`` rank writes and prints)."""
    runner = OfflineHeadless(sim, INITS[args.init or "uniform"], seed=args.seed, device=device)
    traj = (
        TrajectoryWriter(args.trajectory, meta={"n": args.n, "dt": args.dt})
        if args.trajectory and root
        else None
    )
    runner.run(
        steps=args.steps,
        chunk=args.chunk,
        log_every=args.chunk if args.chunk > 1 else 1,
        trajectory=traj,
        trajectory_every=args.trajectory_every or (max(args.chunk, 1) if args.trajectory else 0),
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every or args.steps,
        energy_every=args.energy_every,
        overflow_check_every=args.overflow_check_every,
        reshard_every=args.reshard_every,
        diag_log_every=args.diag_every,
        log_fn=print if root else (lambda line: None),
    )
    if root:
        print(f"mean: {runner.timer.mean_s() * 1e6:.1f} us/step over {args.steps} steps",
              flush=True)


def cmd_headless(args) -> int:
    """bin/headless.rs analog: per-step microseconds printed
    (headless.rs:12-34); ``--devices K`` > 1 runs it sharded over K ranks."""
    if args.devices > 1:
        return _run_sharded(args)
    _check_tree_kw(args)
    _headless(args, _build_sim(args), _device(args.device))
    return 0


def _write_frames(out_dir: str, frames, gif: str | None, fps: float) -> None:
    """The PNG of each (name, float image) under ``out_dir`` and, if asked,
    the animation of them all at ``gif``."""
    images, written = [], 0
    for name, img in frames:
        write_png(os.path.join(out_dir, name), img)
        written += 1
        if gif:
            images.append(img)
    print(f"wrote {written} frames to {out_dir}")
    if gif:
        write_gif(gif, images, fps=fps)
        print(f"wrote animation to {gif}")


def cmd_visualize(args) -> int:
    """bin/visualize.rs analog, offline: run TreeSim N=100k disc
    (visualize.rs:26-37) and render a frame after each ``--steps-per-frame``
    steps with the reference camera, the raster on ``--device``."""
    _check_tree_kw(args)
    sim = _build_sim(args)
    runner = OfflineHeadless(
        sim, INITS[args.init or "disc"], seed=args.seed, device=_device(args.device)
    )
    camera = Camera(aspect=args.width / args.height)
    os.makedirs(args.out, exist_ok=True)

    def frames():
        for frame in range(args.frames):
            for _ in range(args.steps_per_frame):
                runner.step()
            img = render_frame_on_device(
                runner.state.pos, camera, args.width, args.height, footprint=args.footprint
            )
            yield f"frame_{frame:06d}.png", img

    _write_frames(args.out, frames(), args.gif, args.fps)
    steps = args.frames * args.steps_per_frame
    print(f"mean: {runner.timer.mean_s() * 1e6:.1f} us/step over {steps} steps")
    return 0


def cmd_serve(args) -> int:
    """Interactive viewer (bin/visualize.rs + online_renderer.rs analog):
    the browser is the window — live frames, WASD/QE camera, Esc quits,
    focus loss pauses. Same scene defaults as ``visualize``."""
    _check_tree_kw(args)
    viewer = OnlineViewer(
        _build_sim(args),
        INITS[args.init or "disc"],
        seed=args.seed,
        width=args.width,
        height=args.height,
        steps_per_frame=args.steps_per_frame,
        footprint=args.footprint,
        device=_device(args.device),
    )
    stats = serve(viewer, host=args.host, port=args.port)
    print(f"served {stats['frames']} frames, {stats['steps']} steps")
    return 0


def cmd_render(args) -> int:
    """Render the frames of a dumped trajectory directory (either
    package's), each uploaded to ``--device`` and rasterised there."""
    device = _device(args.device)
    camera = Camera(aspect=args.width / args.height)
    os.makedirs(args.out, exist_ok=True)
    frames = (
        (f"frame_{step:08d}.png",
         render_frame_on_device(torch.from_numpy(pos).to(device), camera, args.width,
                                args.height))
        for step, pos in TrajectoryReader(args.trajectory)
    )
    _write_frames(args.out, frames, args.gif, args.fps)
    return 0


def cmd_bench(args) -> int:
    """benches/benchmark.rs analog: sweep N in 8192*{1,2,4,8,16}, report
    bodies/sec and pairs/sec, one JSON line per point, for each backend
    of ``--sim`` (a comma-separated list; empty, the default, means naive
    then tree). Each point times ``reps`` steps queued back to back, closed
    by a device synchronise. Returns 1 when no record was made."""
    device = _device(args.device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    sizes = args.sizes or [8192 * k for k in (1, 2, 4, 8, 16)]
    sims = args.sim.split(",") if args.sim else ["naive", "tree"]
    if args.tree_kw and not set(sims) & set(TREE_SIMS):
        _usage_error(f"--tree-kw applies to --sim tree|tree-host only (got --sim {args.sim})")
    made = 0
    for sim_name in sims:
        for n in sizes:
            a = argparse.Namespace(**vars(args))
            a.sim, a.n = sim_name, n
            sim = _build_sim(a)
            state = sim.init_state(
                torch.Generator().manual_seed(args.seed), uniform_init, device
            )
            _, dt = time_steps(sim.make_step(), state, args.reps)
            print(json.dumps({
                "sim": sim_name,
                "n": n,
                "device": kind,
                "s_per_step": dt,
                "bodies_per_sec": n / dt,
                "pairs_per_sec": n * n / dt if sim_name == "naive" else None,
            }))
            made += 1
    return 0 if made else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="wgpu_n_body_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("headless", help="timed compute-only run")
    _add_sim_flags(p, n=4_000_000, g=1e-6, e=1e-4, dt=0.016, sim="tree")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--chunk", type=int, default=1)
    p.add_argument("--trajectory", type=str, default=None)
    p.add_argument("--trajectory-every", type=int, default=0)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--energy-every", type=int, default=0)
    p.add_argument(
        "--overflow-check-every", type=int, default=0,
        help="also re-build the tree from the current state at this step "
        "cadence and raise on arena overflow (every step's own build is "
        "checked at each chunk boundary regardless)",
    )
    p.add_argument(
        "--diag-every", type=int, default=0,
        help="log the backend health dict (node count, capacity, overflow, "
        "walk_deferred) at this cadence (one extra sort, build and group walk "
        "per log)",
    )
    p.add_argument(
        "--reshard-every", type=int, default=0,
        help="re-partition a sharded tree run into global Morton slices at this "
        "cadence (bounds LET export drift; a pure permutation)",
    )
    p.set_defaults(fn=cmd_headless)

    p = sub.add_parser("visualize", help="run + render frames (offline)")
    _add_sim_flags(p, n=100_000, g=1e-5, e=1e-4, dt=0.0016, sim="tree")
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--steps-per-frame", type=int, default=1)
    p.add_argument("--out", type=str, default="frames")
    p.add_argument("--footprint", choices=["triangle", "splat"], default="triangle")
    p.add_argument("--gif", type=str, default=None)
    p.add_argument("--fps", type=float, default=30.0)
    p.set_defaults(fn=cmd_visualize)

    p = sub.add_parser("serve", help="interactive browser viewer")
    _add_sim_flags(p, n=100_000, g=1e-5, e=1e-4, dt=0.0016, sim="tree")
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--steps-per-frame", type=int, default=1)
    p.add_argument("--footprint", choices=["triangle", "splat"], default="triangle")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("render", help="render a dumped trajectory")
    p.add_argument("--trajectory", type=str, required=True)
    p.add_argument("--out", type=str, default="frames")
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=400)
    p.add_argument("--gif", type=str, default=None)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the raster (default cuda)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench", help="criterion-style sweep")
    _add_sim_flags(p, n=8192, g=1e-6, e=1e-4, dt=0.016, sim="", sim_list=True)
    p.add_argument("--sizes", type=int, nargs="*", default=None)
    p.add_argument("--reps", type=int, default=10)
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
