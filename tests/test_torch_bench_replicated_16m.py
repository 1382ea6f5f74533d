"""PyTorch port, BASELINE config 4 as the benchmark runs it: the cell
``replicated-16m-4gpu`` (``ShardedTreeSim``'s replicated schedule, N=16M over
four ranks, 4M receivers a rank), whose configuration is config 4 cut as its
file states. ``nbody_bench/run.py`` runs the cell at a small N on four gloo
ranks of the CPU through ``ShardedTreeSim`` and ``OfflineHeadless`` and holds
the gathered rows to the plain reference by the configuration's limits; the
bfloat16 control fails them.

One spawn of two gloo ranks checks the replicated step itself:
``make_step()`` on a CPU state is the eager step; its bookkeeping with
``plain=True`` (the stand-in for the CUDA graphs) replays the eager step bit
for bit through a rewind; a traced step opens ``rep_gather``,
``leapfrog.drift`` and ``leapfrog.kick`` and counts ``walk.*`` over the
rank's own receivers, equal to a count made here from a plain walk of the
rank's slice; a traced replay counts as the eager step does; and an arena
overflow raises at the end of the batch it happened in."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from wgpu_n_body_tpu_torch.inits import uniform_init
from wgpu_n_body_tpu_torch.models.step_graph import GraphedStep
from wgpu_n_body_tpu_torch.ops.tree_build import build_tree, morton_order, reorder
from wgpu_n_body_tpu_torch.ops.tree_walk_group import (
    LIST_CHUNK,
    POOL_MIN_ROWS,
    POOL_ROWS_PER_RECEIVER,
    group_tree_forces,
)
from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams
from wgpu_n_body_tpu_torch.parallel import ShardedTreeSim, init_distributed, make_mesh
from wgpu_n_body_tpu_torch.parallel.mesh import all_gather, free_port, shard_state
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CELL = "replicated-16m-4gpu"
CONFIG = ROOT / "nbody_bench" / "configs" / "tree-replicated-16m-4gpu.json"

# ---------------------------------------------------------- the configuration


def test_the_configuration_is_baseline_config_4_cut_as_stated():
    cfg = json.loads(CONFIG.read_text())
    config_4 = json.loads((ROOT / "BASELINE.json").read_text())["configs"][3]
    assert "N=32M" in config_4 and "v5e-8" in config_4
    assert cfg["published"] == {"particle_num": 32_000_000, "chips": 8, "schedule": "let"}
    assert sorted(cfg["reduced"]) == sorted(cfg["published"])
    run = {"particle_num": cfg["sim_params"]["particle_num"], "chips": cfg["chips"],
           "schedule": cfg["schedule"]}
    assert run == {"particle_num": 16_000_000, "chips": 4, "schedule": "replicated"}
    # each rank keeps config 4's receivers: 32M over 8 is 16M over 4
    assert run["particle_num"] // run["chips"] == 32_000_000 // 8
    assert any("16M over 4" in a for a in cfg["assumed"])
    assert any("replicated" in a for a in cfg["assumed"])
    base = json.loads((ROOT / "nbody_bench" / "configs" / "tree-headless-4m.json").read_text())
    assert cfg["tree_params"] == base["tree_params"]
    assert cfg["guarantees"]["force_err_max"] == 0.03 and cfg["sim"] == "sharded_tree"

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "tree-replicated-16m-4gpu", "steps-uniform-4096", 4)
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    assert entry["file"] == "nbody_bench/configs/tree-replicated-16m-4gpu.json"
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    assert sum(w["chips"] == 4 for w in bench["workloads"]) == 1
    reported = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
                if CELL in m.get("workloads", [])}
    assert {"step_ms", "force_err", "peak_mem_gb", "gather_ms", "gather_roofline",
            "graphed_pct", "integrate_ms", "walk_ms"} <= reported
    for name in ("gather_ms", "gather_roofline"):
        metric = {m["name"]: m for m in bench["per_layer"]}[name]
        assert metric["workloads"] == [CELL] and metric["layer"] == "parallel"
        assert (ROOT / "nbody_bench" / "metrics" / f"{name}.py").exists()
    traffic = json.loads((ROOT / "nbody_bench" / "traffic" / "steps-uniform-4096.json")
                         .read_text())
    assert (traffic["scene"], traffic["warmup_steps"], traffic["segment_steps"],
            traffic["trace_segments"], traffic["check_receivers"]) == ("uniform", 2, 10, 2, 4096)


def test_gather_roofline_counts_what_the_schedule_must_receive():
    """The gathers' least time: each rank receives the remote (P-1)/P of
    every body's position and mass (16 bytes) and of its own slice's vel_h
    (12 bytes a receiver), at NVLink 4's rate per direction; a reading is
    that time over ``gather_ms``."""
    sys.path.insert(0, str(ROOT))
    from nbody_bench.metrics import gather_roofline

    n, p = 16_000_000, 4
    assert gather_roofline.least_bytes(n, p) == 228_000_000
    assert gather_roofline.least_bytes(n, p) == (p - 1) * (16 * n + 12 * n // p) // p
    assert gather_roofline.least_ms(n, p) == pytest.approx(0.50667, rel=1e-4)
    ctx = {"loop": "steps", "world": p, "n": n, "steps": 2, "events": [
        {"cat": "user_annotation", "name": "rep_gather", "ts": 0.0, "dur": 100.0},
        {"cat": "cuda_runtime", "name": "launch", "ts": 10.0, "dur": 1.0,
         "args": {"correlation": 7}},
        {"cat": "kernel", "name": "ncclDevKernel_AllGather", "ts": 20.0, "dur": 2000.0,
         "args": {"correlation": 7}}]}
    from nbody_bench.metrics import gather_ms

    assert gather_ms.read(ctx) == pytest.approx(1.0)
    assert gather_roofline.read(ctx) == pytest.approx(100 * 0.50667 / 1.0, rel=1e-4)
    assert gather_roofline.read(dict(ctx, world=1)) is None
    assert gather_ms.read(dict(ctx, events=ctx["events"][1:])) is None


def _run_cell(*extra, seed=2147483659):
    cmd = [sys.executable, str(ROOT / "nbody_bench" / "run.py"), "--workload", CELL,
           "--seed", str(seed), "--seconds", "0.2", "--trace", "0", "--device", "cpu",
           "--set", "particle_num=4096", *extra]
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_the_cell_on_four_gloo_ranks_is_correct_and_its_control_is_not(control):
    res = _run_cell(*(["--control"] if control else []))
    assert res["device"]["count"] == 4
    assert res["correct"] is (not control), res["checks"]
    if control:
        assert res["checks"]["start.rows_off"]["value"] > 0
    else:
        for k in ("start.rows_off", "start.kick_off", "window.rows_off", "window.kick_off"):
            assert res["checks"][k] == {"value": 0, "limit": 0}
        limit = json.loads(CONFIG.read_text())["guarantees"]["force_err_max"]
        assert res["checks"]["window.force_err"] == {"value": res["metrics"]["force_err"]["value"],
                                                     "limit": limit}


# ------------------------------------------------------------- the ranks

P = 2
N = 1024
SP = SimParams(particle_num=N, g=1e-4)
TP = TreeParams(max_depth=10, walk_tile=32, walk_list_cap=2048)
CPU = [torch.profiler.ProfilerActivity.CPU]
RANGES = ("sharded_tree_step", "leapfrog.drift", "rep_gather", "morton_keys", "morton_sort",
          "tree_build", "theta_walk", "counters", "leapfrog.kick")


def _scene(n=N, seed=11):
    st = uniform_init(torch.Generator().manual_seed(seed), SimParams(particle_num=n, g=1e-4),
                      "cpu")
    # a moving scene: the step's half-kick reads the previous acc
    gen = torch.Generator().manual_seed(seed + 1)
    return st._replace(vel=1e-3 * torch.randn(st.pos.shape, generator=gen),
                       acc=1e-4 * torch.randn(st.pos.shape, generator=gen))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _clone(state):
    return ParticleState(*(t.clone() for t in state))


def _own_count(state, mesh):
    """The walk.* counters of one replicated step of ``state`` on this
    rank, counted here: the plain sort, build and group walk of the
    gathered state, and the counts from its tiles and lists by hand."""
    half = SP.dt / 2.0
    vel_h = state.vel + state.acc * half
    whole = ParticleState(all_gather(state.pos, P), all_gather(vel_h, P), all_gather(vel_h, P),
                          all_gather(state.mass, P))
    perm, bound, keys = morton_order(whole.pos, TP.max_depth)
    ss = reorder(whole, perm.long())
    tree = build_tree(ss, keys, bound, TP)
    n_l = N // P
    rows = slice(mesh.rank * n_l, (mesh.rank + 1) * n_l)
    pos_new = ss.pos[rows] + ss.vel[rows] * SP.dt
    _, stats = group_tree_forces(pos_new, ss.pos, ss.mass, tree, keys[rows], SP, TP,
                                 gid_offset=rows.start)
    t, lists = stats.tiles, stats.lists
    done = ~(lists.bad.numpy() | lists.pool_full.numpy())
    length = t.piece_len.numpy().astype(np.int64)
    list_rows = lists.rows.numpy().astype(np.int64)
    tile_id = t.tile_id.numpy()
    deferred = t.deferred.numpy() | ~done[tile_id]
    return {
        "walk.receivers": n_l,
        "walk.pairs": int((list_rows * length * done).sum()),
        "walk.eval_pairs": int((list_rows * 32 * np.ceil(np.minimum(length, t.g) / 32)
                                * done).sum()),
        "walk.deferred": int(deferred.sum()),
        "walk.pool_chunks": int((lists.chunks.numpy() >= 0).sum()),
        "walk.pool_cap": math.ceil(max(POOL_ROWS_PER_RECEIVER * n_l, POOL_MIN_ROWS) / LIST_CHUNK),
    }


def _nodes(whole):
    """Real nodes of the plain build of a whole scene's positions."""
    perm, bound, keys = morton_order(whole.pos, TP.max_depth)
    ss = reorder(whole, perm.long())
    return int(build_tree(ss, keys, bound, TreeParams(max_depth=10, node_capacity_factor=8.0))
               .num_nodes)


def _traced(step, state):
    """(output, counters, the names of the ranges opened) of one call of
    ``step`` under the profiler."""
    profiling.reset_counters()
    with torch.profiler.profile(activities=CPU) as prof:
        out = step(state)
    got = profiling.counters()
    profiling.reset_counters()
    return out, got, {e.name for e in prof.events()}


def _rank(rank, port, out):
    torch.set_num_threads(1)
    init_distributed("gloo", rank, P, f"tcp://localhost:{port}", timeout_s=120)
    try:
        mesh = make_mesh(device="cpu")
        res = {}
        state = shard_state(_scene(), mesh)

        # make_step on a CPU state: the eager step, counting nothing
        step = ShardedTreeSim(SP, mesh, TP).make_step()
        res["cpu_graphed_step"] = isinstance(step, GraphedStep)
        res["cpu_equal"] = _equal(step(state), ShardedTreeSim(SP, mesh, TP).step_fn()(state))
        res["cpu_calls"] = step.calls
        res["let_eager"] = not isinstance(
            ShardedTreeSim(SP, mesh, TP, schedule="let", let_cap=N).make_step(), GraphedStep)

        # plain replays against the eager step, the state set back before call 8
        eager = ShardedTreeSim(SP, mesh, TP).step_fn()
        graphed = GraphedStep(ShardedTreeSim(SP, mesh, TP), plain=True)
        a, b, off = state, _clone(state), []
        for i in range(1, 13):
            if i == 8:
                a, b = _clone(kept), _clone(kept)
            a, b = eager(a), graphed(b)
            if not _equal(a, b):
                off.append(i)
            if i == 5:
                kept = _clone(b)
        res["replay_off"] = off
        res["replay_counts"] = [graphed.calls, graphed.replays, graphed.captures]
        res["plan"] = [[name for _, name in seg.path] for seg in graphed.plans[0]]

        # traced: the eager step and a replay from the same state
        want = _own_count(b, mesh)
        a, eager_counts, names = _traced(eager, _clone(b))
        b, replay_counts, _ = _traced(graphed, b)
        res["replay_traced_equal"] = _equal(a, b)
        res["own_count"] = want
        res["eager_counts"] = eager_counts
        res["replay_counts_traced"] = replay_counts
        res["ranges"] = sorted(n for n in names if n in RANGES)

        # an overflow at the 8th call raises when its batch ends: an arena
        # between the scene's nodes and those of the same scene with its
        # bodies gathered in clusters of 17 (each a chain of cells)
        whole = _scene()
        c = N // 17
        jitter = 1e-6 * torch.randn((17 * c, 3), generator=torch.Generator().manual_seed(3))
        clustered = whole._replace(pos=torch.cat([whole.pos[:c].repeat_interleave(17, 0) + jitter,
                                                  whole.pos[17 * c:]]))
        nodes = [_nodes(s) for s in (whole, clustered)]
        tp = TreeParams(max_depth=10, walk_tile=32, walk_list_cap=2048,
                        node_capacity_factor=(nodes[0] + nodes[1]) / 2 / N)
        planted = shard_state(clustered, mesh)
        res["nodes"], res["raised"] = nodes, {}
        for chunk in (1, 3):
            sim = ShardedTreeSim(SP, mesh, tp)
            runner = OfflineHeadless(sim, lambda *_: whole, device="cpu")
            step, calls = GraphedStep(sim, plain=True), iter(range(1, 100))
            runner._step = lambda s: step(planted if next(calls) == 8 else s)
            try:
                runner.run(12, chunk=chunk, log_fn=lambda line: None)
                res["raised"][chunk] = None
            except RuntimeError as e:
                assert "arena overflow" in str(e), e
                res["raised"][chunk] = [runner.step_num, step.replays]
        dist.barrier()
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("replicated"))
    mp.spawn(_rank, args=(free_port(), out), nprocs=P, join=True)
    return [json.loads(Path(out, f"rank{r}.json").read_text()) for r in range(P)]


def test_make_step_on_a_cpu_state_is_the_eager_step(ranks):
    for res in ranks:
        assert res["cpu_graphed_step"] and res["cpu_equal"] and res["cpu_calls"] == 0
        assert res["let_eager"]


def test_plain_replays_equal_the_eager_replicated_step(ranks):
    for res in ranks:
        assert res["replay_off"] == []
        assert res["replay_counts"] == [12, 10, 2]
        cuts = [path[1:] for path in res["plan"]]
        assert all(path[0] == "sharded_tree_step" for path in res["plan"])
        assert cuts == [["leapfrog.drift"], ["rep_gather"], ["morton_keys"], ["morton_sort"],
                        ["tree_build"], ["leapfrog.drift"], ["theta_walk"], ["counters"],
                        ["leapfrog.kick"]]


def test_a_traced_step_opens_its_ranges_and_counts_the_ranks_own_receivers(ranks):
    for res in ranks:
        assert res["ranges"] == sorted(RANGES)
        assert res["eager_counts"] == res["own_count"], res
        assert res["own_count"]["walk.receivers"] == N // P
        assert res["own_count"]["walk.pairs"] > 0
        assert res["replay_traced_equal"]
        steps = {k: res["replay_counts_traced"].pop(k) for k in ("step.steps", "step.replayed")}
        assert steps == {"step.steps": 1, "step.replayed": 1}
        assert res["replay_counts_traced"] == res["eager_counts"]
    # each rank counts its own slice: the two ranks' pairs differ
    assert ranks[0]["own_count"]["walk.pairs"] != ranks[1]["own_count"]["walk.pairs"]


@pytest.mark.parametrize("chunk", ["1", "3"])
def test_an_overflow_raises_at_the_end_of_its_batch(ranks, chunk):
    for res in ranks:
        assert 1.5 * res["nodes"][0] < res["nodes"][1]
        step_num, replays = res["raised"][chunk]
        assert step_num == (8 if chunk == "1" else 9) and replays > 0
