"""The sharded schedules on K GPUs against one GPU: forces and step time.

    python -m wgpu_n_body_tpu_torch.utils.multi_gpu_check --devices 4
    python -m wgpu_n_body_tpu_torch.utils.multi_gpu_check --devices 4 --device cpu \\
        --n-naive 2048 --n-tree 8192 --steps 2 --chunk 1 --sample 256   # a gloo rehearsal
    python -m wgpu_n_body_tpu_torch.utils.multi_gpu_check --devices 4 --schedule let \\
        --fused-let-walk   # the fused LET walk alone

For each schedule, K ranks (spawned; NCCL on ``cuda:0..K-1``, or gloo with
``--device cpu``) run ``ShardedNaiveSim`` (allgather, ring; ``--n-naive``
bodies) or ``ShardedTreeSim`` (replicated, let; ``--n-tree`` bodies, 4M per
rank at the default, BASELINE config 4's per-rank size) through
``OfflineHeadless`` from a uniform scene at rest with N/K bodies in each
rank's top-level Morton cells (``domains``): one step, whose whole state
rank 0 gathers and writes, then ``--steps`` steps in chunks of
``--chunk``, timed (rank 0's wall per step; each chunk ends in a
synchronisation; the first chunk is a warm-up). One device then runs the
single-device sim the same way. The bodies start at rest, so a receiver
of the first step sits exactly on its own source: its row is found in
every order by the bits of its position. The naive schedules' forces are
held to one device's (``tests/test_parallel.py``: rtol 1e-4, atol 1e-8),
the tree schedules' to ``tests/test_let.py:68``'s criteria against float64
all-pairs on ``--sample`` receivers. ``--schedule`` keeps one schedule;
``--fused-let-walk`` runs ``let`` with the fused walk (``let_fused=True``).
Prints the card's name and power limit and one JSON line per schedule;
exits 1 when a check fails. Not run by ``chip_smoke.py``, which needs one
card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from wgpu_n_body_tpu_torch.models import NaiveSim, TreeSim
from wgpu_n_body_tpu_torch.ops import (
    import_forest_cuda,
    let_export_cuda,
    morton_cuda,
    naive_cuda,
    tree_build_cuda,
    tree_walk_cuda,
    tree_walk_group_cuda,
)
from wgpu_n_body_tpu_torch.ops.naive_ref import mean_rel_err, naive_forces_ref
from wgpu_n_body_tpu_torch.params import NaiveParams, ParticleState, SimParams, TreeParams
from wgpu_n_body_tpu_torch.parallel import ShardedNaiveSim, ShardedTreeSim
from wgpu_n_body_tpu_torch.parallel.mesh import free_port, init_distributed, make_mesh
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless

SCHEDULES = (("naive", "allgather"), ("naive", "ring"), ("tree", "replicated"), ("tree", "let"))


def domains(ranks: int):
    """The scene's init function for ``ranks`` ranks (2, 4 or 8): bodies at
    rest, uniform in [-1, 1]^3, N / ranks of them in each rank's top-level
    Morton cells (rank r's octants 8r/ranks .. 8(r+1)/ranks - 1, in rank
    order), so that the global Morton order's slices are those cells. A
    uniform draw leaves each cell's count to chance, and a slice's end then
    reaches into the next cell and stretches its box (PERF.md §7)."""
    if ranks not in (2, 4, 8):
        raise SystemExit(f"--devices {ranks}: the scene has domains for 2, 4 or 8 ranks")
    per = 8 // ranks  # octants per rank: their low bits vary

    def init(gen, params, device):
        n_l = params.particle_num // ranks
        axis = torch.arange(3)
        full = (1 << axis) < per  # the axes whose bit varies among a rank's octants
        parts = []
        for r in range(ranks):
            lo = torch.where(full, -1.0, ((r * per) >> axis & 1).float() - 1.0)
            span = torch.where(full, 2.0, 1.0)
            parts.append(lo + span * torch.rand((n_l, 3), generator=gen))
        pos = torch.cat(parts).to(device)
        zero = torch.zeros_like(pos)
        return ParticleState(pos, zero, zero.clone(), torch.ones(pos.shape[0], device=device))

    return init


def _quiet(line):
    pass


def _timed(runner, steps, chunk) -> float:
    """ms per step over ``steps`` steps in chunks of ``chunk``, the first
    chunk left out (a warm-up) when there are several."""
    runner.run(steps=steps, chunk=chunk, log_fn=_quiet)
    times = runner.timer.times_s[-(steps // chunk):]
    times = times[1:] or times
    return sum(times) / len(times) / chunk * 1e3


def _params(kind, args):
    return SimParams(particle_num=args.n_naive if kind == "naive" else args.n_tree)


def _schedules(args):
    return [(k, s) for k, s in SCHEDULES if args.schedule in (None, s)]


def _rank(rank, args, port, out):
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.devices))
    init_distributed("nccl" if cuda else "gloo", rank, args.devices, f"tcp://localhost:{port}",
                     timeout_s=args.timeout)
    try:
        mesh = make_mesh(device=f"cuda:{rank}" if cuda else "cpu")
        for kind, schedule in _schedules(args):
            params = _params(kind, args)
            if kind == "naive":
                sim = ShardedNaiveSim(params, mesh, NaiveParams(), schedule)
            else:
                sim = ShardedTreeSim(params, mesh, TreeParams(let_fused=args.fused_let_walk),
                                     schedule, let_cap=args.let_cap if schedule == "let" else None)
            runner = OfflineHeadless(sim, domains(args.devices), seed=args.seed,
                                     device=mesh.device)
            runner.run(steps=1, log_fn=_quiet)
            first = runner.whole_state()
            ms = _timed(runner, args.steps, args.chunk)
            if rank == 0:
                np.savez(os.path.join(out, f"{kind}_{schedule}.npz"),
                         pos=first.pos.cpu().numpy(), acc=first.acc.cpu().numpy())
                with open(os.path.join(out, f"{kind}_{schedule}.json"), "w") as f:
                    json.dump({"ms": ms, "health": runner.last_health,
                               "let_cap": getattr(sim, "let_cap", None)}, f)
            del runner, first, sim
            if cuda:
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def position_keys(pos):
    """(n,) int64 hash of the float32 bits of a body's three coordinates:
    its key for matching rows of two orders of the same drifted state."""
    bits = pos.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return ((bits[:, 0] << 32) | bits[:, 1]) ^ (bits[:, 2] * -7046029254386353131)


def rows_of(pos: torch.Tensor, where: torch.Tensor) -> torch.Tensor:
    """The row of ``where`` holding each position of ``pos`` (bit-equal);
    ValueError when one is missing."""
    keys = position_keys(where)
    order = torch.argsort(keys)
    at = order[torch.searchsorted(keys[order], position_keys(pos)).clamp(max=keys.numel() - 1)]
    if not torch.equal(where[at], pos):
        raise ValueError("a position of pos is not in where")
    return at


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--n-naive", type=int, default=262_144)
    ap.add_argument("--n-tree", type=int, default=16_000_000)
    ap.add_argument("--let-cap", type=int, default=None,
                    help="LET rows per destination (default: auto_let_cap)")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--chunk", type=int, default=3)
    ap.add_argument("--sample", type=int, default=4096)
    ap.add_argument("--schedule", choices=[s for _, s in SCHEDULES], default=None,
                    help="run this schedule alone (default: all four)")
    ap.add_argument("--fused-let-walk", action="store_true",
                    help="the let schedule's fused walk (let_fused=True)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait before the ranks fail")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    if args.device == "cuda":
        if torch.cuda.device_count() < args.devices:
            raise SystemExit(f"--devices {args.devices}: {torch.cuda.device_count()} GPUs visible")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
        print("\n".join(smi), flush=True)
        with concurrent.futures.ThreadPoolExecutor(8) as pool:  # once, before the ranks
            mods = (naive_cuda, tree_walk_cuda, morton_cuda, tree_walk_group_cuda,
                    tree_build_cuda, let_export_cuda, import_forest_cuda)
            builds = [pool.submit(m.build) for m in mods]
            builds.append(pool.submit(tree_walk_group_cuda.build_tiles))
            for f in builds:
                f.result()
    ok = True
    with tempfile.TemporaryDirectory() as out:
        mp.spawn(_rank, args=(args, free_port(), out), nprocs=args.devices, join=True)
        singles = {}
        for kind, schedule in _schedules(args):
            params = _params(kind, args)
            if kind not in singles:
                sim = NaiveSim(params) if kind == "naive" else TreeSim(params)
                runner = OfflineHeadless(sim, domains(args.devices), seed=args.seed, device=dev)
                runner.run(steps=1, log_fn=_quiet)
                first = runner.state
                singles[kind] = (first, _timed(runner, args.steps, args.chunk))
                del runner
            single, single_ms = singles[kind]
            with np.load(os.path.join(out, f"{kind}_{schedule}.npz")) as z:
                pos, acc = torch.from_numpy(z["pos"]).to(dev), torch.from_numpy(z["acc"]).to(dev)
            with open(os.path.join(out, f"{kind}_{schedule}.json")) as f:
                rec = json.load(f)
            at = rows_of(pos, single.pos)
            rec.update(schedule=schedule, sim=kind, n=params.particle_num, ranks=args.devices,
                       single_ms=single_ms, speedup=single_ms / rec["ms"],
                       fused_let_walk=args.fused_let_walk and schedule == "let")
            if kind == "naive":
                rel = ((acc - single.acc[at]).norm(dim=1) / single.acc[at].norm(dim=1))
                rec["max_rel_vs_single"] = float(rel.max())
                good = bool(torch.allclose(acc, single.acc[at], rtol=1e-4, atol=1e-8))
            else:
                init = domains(args.devices)(torch.Generator().manual_seed(args.seed), params, dev)
                pick = torch.randperm(pos.shape[0], generator=torch.Generator().manual_seed(1))
                pick = pick[: args.sample].to(dev)
                own = rows_of(pos[pick], init.pos)  # at rest: each receiver on its source
                truth = naive_forces_ref(pos[pick].double(), init.pos.double(),
                                         init.mass.double(), params, block=8, row_offset=own)
                rec["err_sharded"] = mean_rel_err(acc[pick], truth)
                rec["err_single"] = mean_rel_err(single.acc[at[pick]], truth)
                good = (rec["err_sharded"] < 0.03 and rec["err_single"] < 0.03
                        and rec["err_sharded"] < 3 * rec["err_single"] + 1e-4)
            rec["ok"] = good
            ok &= good
            print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
