"""The replicated sharded step's CUDA graphs on K GPUs: its replays against
the eager step, a planted overflow, the graphs' memory and each rank's step
times.

    python3 -m wgpu_n_body_tpu_torch.utils.sharded_graph_check --devices 4
    python -m wgpu_n_body_tpu_torch.utils.sharded_graph_check --devices 2 --device cpu \\
        --n 4096 --n-overflow 4096 --steps 4   # a gloo rehearsal

K ranks (spawned; NCCL on ``cuda:0..K-1``, or gloo with ``--device cpu``,
where ``GraphedStep(plain=True)`` stands in for the graphs) each run
``ShardedTreeSim``'s ``replicated`` schedule with the default tree
parameters (θ 0.75, the group walk) on the uniform scene:

a. ``replay``: 12 calls of ``make_step()`` (its first call, the capture,
   then 10 replays; a rewind before the 8th call to a copy of the 5th
   call's output) against 12 of the eager step, every field of every call
   bit-equal on every rank; the capture's cuts; ``memory_reserved()`` after
   ``empty_cache`` before and after the capture (the graphs' pool, which
   ``max_memory_allocated`` does not see); a traced replay's counters equal
   to a traced eager step's; both simulators' health, reduced over the
   ranks, equal;
b. ``overflow``: an arena between the ``--n-overflow`` uniform scene's
   nodes and those of the same scene with its bodies in clusters of 17
   within 1e-6; the clustered state handed in at the 8th call through
   ``OfflineHeadless.run``: it raises after step 8 with chunk 1 and after
   step 9 with chunk 3, on every rank;
c. ``times``: synchronised ``OfflineHeadless.step()`` calls, as the
   benchmark makes them (two warm-up steps, then blocks of ``--steps``
   steps with a rewind every 10), graphed and eager in turns (graphed,
   eager, eager, graphed): every rank's step times in ms.

Prints the card's name and power limit, a line per rank and one JSON line,
and writes every rank's record to ``--out``; exits 1 when a check fails. Not run by ``chip_smoke.py``, which needs one
card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from wgpu_n_body_tpu_torch.inits import uniform_init
from wgpu_n_body_tpu_torch.models import TreeSim
from wgpu_n_body_tpu_torch.models.step_graph import GraphedStep
from wgpu_n_body_tpu_torch.ops import (
    morton_cuda,
    tree_build_cuda,
    tree_walk_cuda,
    tree_walk_group_cuda,
)
from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams
from wgpu_n_body_tpu_torch.parallel import ShardedTreeSim
from wgpu_n_body_tpu_torch.parallel.mesh import free_port, init_distributed, make_mesh, shard_state
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.utils import profiling
from wgpu_n_body_tpu_torch.utils.chip import smi

#: the turns of the timed blocks
TURNS = ("graphed", "eager", "eager", "graphed")
#: the benchmark's segment: a rewind to the opening state every this many steps
SEGMENT = 10


def _sync(mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _clone(state):
    return ParticleState(*(t.clone() for t in state))


def _graphed(sim, mesh):
    return sim.make_step() if mesh.device.type == "cuda" else GraphedStep(sim, plain=True)


def _reserved(mesh) -> int:
    if mesh.device.type != "cuda":
        return 0
    torch.cuda.synchronize(mesh.device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(mesh.device)


def _traced(step, state, mesh):
    """(output, the counters) of one call of ``step`` under the profiler."""
    profiling.reset_counters()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if mesh.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        out = step(state)
        _sync(mesh)
    got = profiling.counters()
    profiling.reset_counters()
    return out, got


def _replay_case(mesh, args) -> dict:
    params = SimParams(particle_num=args.n)
    eager_sim, sim = ShardedTreeSim(params, mesh), ShardedTreeSim(params, mesh)
    state = eager_sim.init_state(torch.Generator().manual_seed(args.seed), uniform_init)
    eager, step = eager_sim.step_fn(), _graphed(sim, mesh)
    a, b = state, _clone(state)
    reserved, off = [], []
    for i in range(1, 13):
        if i == 8:
            a, b = _clone(kept), _clone(kept)
        if i == 2:
            reserved.append(_reserved(mesh))
        a, b = eager(a), step(b)
        _sync(mesh)
        if i == 2:
            reserved.append(_reserved(mesh))
        if i == 5:
            kept = _clone(b)
        fields = [f for f, x, y in zip(state._fields, a, b) if not torch.equal(x, y)]
        if fields:
            off.append([i, fields])
    calls = [step.calls, step.replays, step.captures]
    cuts = [[name for _, name in seg.path] for seg in step.plans[0]]
    graphs = sum(seg.graph is not None for seg in step.plans[0])
    a, want = _traced(eager, _clone(b), mesh)
    b, got = _traced(step, b, mesh)
    steps = {k: got.pop(k, None) for k in ("step.steps", "step.replayed")}
    health = [eager_sim.read_health(), sim.read_health()]
    rec = {"n": args.n, "off": off, "calls": calls,
           "cuts": cuts, "graphs": graphs, "reserved_before": reserved[0],
           "reserved_after": reserved[1], "pool_bytes": reserved[1] - reserved[0],
           "traced_equal": all(torch.equal(x, y) for x, y in zip(a, b)),
           "counters": got, "eager_counters": want, "step_counters": steps, "health": health}
    rec["ok"] = (not off and rec["calls"] == [12, 10, 2] and rec["traced_equal"]
                 and got == want and steps == {"step.steps": 1, "step.replayed": 1}
                 and health[0] == health[1] and got.get("walk.receivers") == args.n // mesh.size)
    return rec


def _overflow_case(mesh, args) -> dict:
    n = args.n_overflow
    params = SimParams(particle_num=n)
    whole = uniform_init(torch.Generator().manual_seed(args.seed), params, "cpu")
    c = n // 17
    jitter = 1e-6 * torch.randn((17 * c, 3), generator=torch.Generator().manual_seed(3))
    clustered = whole._replace(pos=torch.cat([whole.pos[:c].repeat_interleave(17, 0) + jitter,
                                              whole.pos[17 * c:]]))
    probe = TreeSim(params, TreeParams(node_capacity_factor=4.0))
    nodes = [probe.diagnose(ParticleState(*(t.to(mesh.device) for t in s)))["num_nodes"]
             for s in (whole, clustered)]
    tp = TreeParams(node_capacity_factor=(nodes[0] + nodes[1]) / 2 / n)
    planted = shard_state(clustered, mesh)
    raised = {}
    for chunk in (1, 3):
        sim = ShardedTreeSim(params, mesh, tp)
        runner = OfflineHeadless(sim, lambda *_: whole, device=mesh.device)
        step, calls = _graphed(sim, mesh), iter(range(1, 100))
        runner._step = lambda s: step(planted if next(calls) == 8 else s)
        try:
            runner.run(12, chunk=chunk, log_fn=lambda line: None)
            raised[chunk] = None
        except RuntimeError as e:
            if "arena overflow" not in str(e):
                raise
            raised[chunk] = [runner.step_num, step.replays]
        del runner, sim, step
    ok = (2 * nodes[0] < nodes[1] and raised[1] is not None and raised[3] is not None
          and raised[1][0] == 8 and raised[3][0] == 9 and min(raised[1][1], raised[3][1]) >= 5)
    return {"n": n, "nodes": nodes, "capacity": tp.capacity(n), "raised": raised, "ok": ok}


def _timed_case(mesh, args) -> dict:
    params = SimParams(particle_num=args.n)
    sim = ShardedTreeSim(params, mesh)
    runners = {}
    for kind in ("graphed", "eager"):
        runner = OfflineHeadless(sim, uniform_init, seed=args.seed, device=mesh.device)
        runner._step = _graphed(sim, mesh) if kind == "graphed" else sim.step_fn()
        for _ in range(2):
            runner.step()
        runners[kind] = (runner, _clone(runner.state))
    times = {kind: [] for kind in runners}
    for kind in TURNS:
        runner, opening = runners[kind]
        for i in range(args.steps):
            if i % SEGMENT == 0:
                runner.state = _clone(opening)
            runner.step()
        times[kind].append([t * 1e3 for t in runner.timer.times_s[-args.steps:]])
    return {"n": args.n, "steps": args.steps, "turns": list(TURNS), "ms": times, "ok": True}


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
        rec = {"rank": rank}
        for name, case in (("replay", _replay_case), ("overflow", _overflow_case),
                           ("times", _timed_case)):
            rec[name] = case(mesh, args)
            if cuda:
                torch.cuda.empty_cache()
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--n", type=int, default=16_000_000)
    ap.add_argument("--n-overflow", type=int, default=1_048_576)
    ap.add_argument("--steps", type=int, default=40, help="steps in each timed block")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="sharded_graph_check.json",
                    help="the JSON file every rank's record is written to")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait before the ranks fail")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if torch.cuda.device_count() < args.devices:
            raise SystemExit(f"--devices {args.devices}: {torch.cuda.device_count()} GPUs visible")
        print("\n".join(smi("name,power.limit")), flush=True)
        with concurrent.futures.ThreadPoolExecutor(8) as pool:  # once, before the ranks
            builds = [pool.submit(m.build) for m in (tree_walk_cuda, morton_cuda,
                                                     tree_walk_group_cuda, tree_build_cuda)]
            builds.append(pool.submit(tree_walk_group_cuda.build_tiles))
            for f in builds:
                f.result()
    with tempfile.TemporaryDirectory() as out:
        mp.spawn(_rank, args=(args, free_port(), out), nprocs=args.devices, join=True)
        recs = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(args.devices)]
    ok = all(r[case]["ok"] for r in recs for case in ("replay", "overflow", "times"))
    result = {"ok": ok, "devices": args.devices, "device": args.device, "ranks": recs}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    for r in recs:
        rep, ovf, tim = r["replay"], r["overflow"], r["times"]
        med = {k: sorted(x for block in v for x in block)[len(v) * len(v[0]) // 2]
               for k, v in tim["ms"].items()}
        print(f"rank {r['rank']}: replay ok {rep['ok']} (off {rep['off']}, calls "
              f"{rep['calls']}, {rep['graphs']} graphs, reserved {rep['reserved_before']} -> "
              f"{rep['reserved_after']}); overflow ok {ovf['ok']} (nodes {ovf['nodes']}, raised "
              f"{ovf['raised']}); median step ms {med}", flush=True)
    print(json.dumps({"ok": ok, "devices": args.devices}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
