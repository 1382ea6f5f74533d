"""PyTorch port, tracing: ``trace_scope`` ranges and the counter registry
(``utils/profiling.py``) record only under ``torch.profiler``; the runner's
``runner.enqueue``, ``runner.sync`` and ``runner.health`` ranges, the
leapfrog's ``leapfrog.drift`` and ``leapfrog.kick``, and the group walk's
counters ``walk.pairs``, ``walk.eval_pairs``, ``walk.receivers``,
``walk.deferred``, ``walk.pool_chunks`` and ``walk.pool_cap``, on small CPU
TreeSim scenes."""

import contextlib
import json

import numpy as np
import pytest
import torch

from wgpu_n_body_tpu_torch.inits import disc_init, uniform_init
from wgpu_n_body_tpu_torch.models import TreeSim
from wgpu_n_body_tpu_torch.models import tree as tree_model
from wgpu_n_body_tpu_torch.ops.tree_build import build_tree, morton_sort
from wgpu_n_body_tpu_torch.ops.tree_walk_group import GroupWalkStats, group_walk_lists, tile_setup
from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams, state_from_numpy
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.utils import profiling

N = 300
TP = dict(max_depth=10, walk_tile=32, walk_list_cap=2048)
DEFER = dict(theta=0.5, walk_list_cap=128)  # some tiles of the clustered scene overflow


def _scene(kind="uniform", seed=6):
    """N bodies at rest in [-1, 1]^3 (``clustered``: half in a 1e-3 ball):
    with zero velocity and acc the drift leaves every position as it is,
    so the step walks the receivers ``diagnose`` walks."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (N, 3))
    if kind == "clustered":
        pos[: N // 2] = 0.3 + pos[: N // 2] * 1e-3
    z = np.zeros((N, 3), np.float32)
    return state_from_numpy(pos=pos.astype(np.float32), vel=z, acc=z,
                            mass=rng.uniform(0.5, 2.0, N).astype(np.float32), device="cpu")


def _sim(**kw):
    return TreeSim(SimParams(particle_num=N, g=1e-3), TreeParams(**{**TP, **kw}))


def _runner(sim, state):
    return OfflineHeadless(sim, lambda *_: ParticleState(*state), device="cpu")


def _traced(fn, tmp_path):
    """The host ranges (``user_annotation``) and ops of ``fn()`` under a
    CPU ``torch.profiler``, as chrome-trace events."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def _ranges(events, name):
    return sorted(((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] == name))


def _overlap(a, b):
    return a[0] < b[1] and b[0] < a[1]


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


# ------------------------------------------------------------ trace_scope


def test_trace_scope_is_one_shared_noop_without_a_profiler():
    assert not profiling.tracing()
    off = profiling.trace_scope("a")
    assert off is profiling.trace_scope("b") and isinstance(off, contextlib.nullcontext)
    with off, off:  # reentrant
        pass


def test_trace_scope_records_a_user_annotation_under_the_profiler(tmp_path):
    def fn():
        assert profiling.tracing()
        with profiling.trace_scope("tracing.test"):
            torch.ones(4).sum()

    events = _traced(fn, tmp_path)
    assert len(_ranges(events, "tracing.test")) == 1


def test_count_keeps_totals_only_under_the_profiler(tmp_path):
    profiling.count("x", 5)
    assert profiling.counters() == {}
    _traced(lambda: [profiling.count("x", 5), profiling.count("x", torch.tensor(7, dtype=torch.int32)),
                     profiling.count("y", torch.tensor(2))], tmp_path)
    got = profiling.counters()
    assert got == {"x": 12, "y": 2} and all(type(v) is int for v in got.values())
    profiling.reset_counters()
    assert profiling.counters() == {}


# --------------------------------------------------------- runner ranges


@pytest.mark.parametrize("steps,chunk", [(1, 0), (4, 2), (4, 3)])
def test_runner_ranges_once_per_batch_in_order(tmp_path, steps, chunk):
    """chunk 0: ``step()``; otherwise ``run(steps, chunk)``."""
    runner = _runner(_sim(), _scene())
    events = _traced(lambda: runner.step() if not chunk else runner.run(steps, chunk=chunk),
                     tmp_path)
    batches = 1 if not chunk else -(-steps // chunk)
    enqueue, sync, health = (_ranges(events, f"runner.{k}") for k in ("enqueue", "sync", "health"))
    assert len(enqueue) == len(sync) == len(health) == batches
    for e, s, h in zip(enqueue, sync, health):
        assert e[1] <= s[0] and s[1] <= h[0]
    # every launch of a batch is queued inside its runner.enqueue
    tree_steps = _ranges(events, "tree_step")
    assert len(tree_steps) == steps
    assert all(any(e[0] <= t[0] and t[1] <= e[1] for e in enqueue) for t in tree_steps)
    # the leapfrog's ranges, once per step, around the walk but not over it
    drift, kick = _ranges(events, "leapfrog.drift"), _ranges(events, "leapfrog.kick")
    walks = _ranges(events, "theta_walk")
    assert len(drift) == len(kick) == len(walks) == steps
    for d, w, k in zip(drift, walks, kick):
        assert d[1] <= w[0] and w[1] <= k[0]


def test_the_default_step_opens_no_range_and_reduces_nothing_without_a_profiler(monkeypatch):
    """No ``record_function``, no counter and no ``GroupWalkStats`` sum in
    a step with no profiler; the same probes fire under one."""
    calls = {"record_function": 0, "count": 0, "stats": 0}
    record = torch.profiler.record_function

    def probe(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f

    monkeypatch.setattr(torch.profiler, "record_function", probe("record_function", record))
    monkeypatch.setattr(tree_model, "count", probe("count", profiling.count))
    for field in ("deferred", "pool_deferred", "pairs", "pool_used"):
        prop = getattr(GroupWalkStats, field)
        monkeypatch.setattr(GroupWalkStats, field, property(probe("stats", prop.fget)))
    runner = _runner(_sim(**DEFER), _scene("clustered"))
    runner.step()
    runner.run(2, chunk=2)
    assert calls == {"record_function": 0, "count": 0, "stats": 0}
    assert profiling.counters() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        runner.step()
    assert calls["record_function"] > 0 and calls["count"] == 6 and calls["stats"] == 3


# ------------------------------------------------------- walk counters


def _plain_walk(state, tp):
    """(tiles, lists) of the group walk of ``state`` at rest, from the plain
    sort, build, ``tile_setup`` and ``group_walk_lists``."""
    ss, bound, keys = morton_sort(state, tp.max_depth)
    tree = build_tree(ss, keys, bound, tp)
    tiles = tile_setup(keys, ss.pos.shape[0], tp)
    return tiles, group_walk_lists(ss.pos, tree, tiles, tp)


def _independent_count(state, tp):
    """(pairs, eval_pairs, deferred, pool chunks) of the group walk of the
    sorted ``state`` at rest, from ``tile_setup`` and ``group_walk_lists``:
    pairs by the formula of ``chip_smoke.py`` (rows times receivers over the
    tiles neither bad nor pool_full), eval_pairs with the receivers rounded
    up to whole 32-receiver blocks; deferred receivers of those tiles and of
    the partition; the chunks of 256 rows each list fills, over the tiles
    the pool had room for."""
    tiles, lists = _plain_walk(state, tp)
    nt = int((tiles.piece_len > 0).sum())
    fin = ~(lists.bad | lists.pool_full)[:nt]
    pairs = int((lists.rows[:nt][fin].double() * tiles.piece_len[:nt][fin].double()).sum())
    blocks = [-(-min(int(x), tiles.g) // 32) for x in tiles.piece_len[:nt][fin]]
    eval_pairs = sum(int(r) * 32 * b for r, b in zip(lists.rows[:nt][fin], blocks))
    deferred = int((tiles.deferred | (lists.bad | lists.pool_full)[tiles.tile_id]).sum())
    room = ~lists.pool_full[:nt]
    chunks = sum(-(-int(r) // 256) for r in lists.rows[:nt][room])
    return pairs, eval_pairs, deferred, chunks


def _pool_cap(n):
    """Chunks of 256 ids in a pool of 32 ids a receiver, at least 2^24 ids."""
    return max(32 * n, 1 << 24) // 256


@pytest.mark.parametrize("kind,kw", [("uniform", {}), ("clustered", DEFER)],
                         ids=["no-deferral", "deferral"])
def test_walk_counters_equal_an_independent_count(tmp_path, kind, kw):
    sim, state = _sim(**kw), _scene(kind)
    pairs, eval_pairs, deferred, chunks = _independent_count(state, sim.add_params)
    diag = sim.diagnose(state)
    assert (deferred > 0) == bool(kw) and diag["walk_deferred"] == deferred
    runner = _runner(sim, state)
    _traced(runner.step, tmp_path)
    assert profiling.counters() == {"walk.pairs": pairs, "walk.eval_pairs": eval_pairs,
                                    "walk.receivers": N, "walk.deferred": deferred,
                                    "walk.pool_chunks": chunks, "walk.pool_cap": _pool_cap(N)}
    _traced(lambda: runner.run(2, chunk=2), tmp_path)  # totals add up across windows
    got = profiling.counters()
    assert got["walk.receivers"] == 3 * N and got["walk.pool_cap"] == 3 * _pool_cap(N)


POOL_N = 3000
INITS = {"uniform": uniform_init, "disc": disc_init}


@pytest.mark.parametrize("theta", [0.5, 0.75])
@pytest.mark.parametrize("scene", list(INITS))
def test_pool_counters_equal_an_independent_count(tmp_path, scene, theta):
    """``walk.pool_chunks`` and ``walk.pool_cap`` of a traced step, at the
    port's default tree settings, equal the entries of the plain walk's
    chunk table, the chunks its lists fill, and the pool's size by hand."""
    sp = SimParams(particle_num=POOL_N)
    sim = TreeSim(sp, TreeParams(theta=theta))
    drawn = INITS[scene](torch.Generator().manual_seed(11), sp, "cpu")
    state = drawn._replace(vel=torch.zeros_like(drawn.vel))  # at rest: the walk sees these
    tiles, lists = _plain_walk(state, sim.add_params)
    table = int((lists.chunks >= 0).sum())
    chunks = _independent_count(state, sim.add_params)[3]
    assert table == chunks > 0 and not bool(lists.pool_full.any())
    _traced(_runner(sim, state).step, tmp_path)
    got = profiling.counters()
    assert got["walk.pool_chunks"] == chunks and got["walk.pool_cap"] == _pool_cap(POOL_N)


def test_counters_stay_empty_after_steps_without_a_profiler():
    runner = _runner(_sim(**DEFER), _scene("clustered"))
    runner.step()
    runner.run(3, chunk=3)
    assert profiling.counters() == {}


def test_counter_launches_sit_outside_theta_walk(tmp_path):
    runner = _runner(_sim(**DEFER), _scene("clustered"))
    events = _traced(lambda: runner.run(2, chunk=1), tmp_path)
    counters, walks = _ranges(events, "counters"), _ranges(events, "theta_walk")
    outside = [r for k in ("morton_keys", "morton_sort", "tree_build") for r in _ranges(events, k)]
    assert len(counters) == 2
    assert not any(_overlap(c, w) for c in counters for w in walks + outside)
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and any(a <= e["ts"] < b for a, b in counters)]
    assert any(e["name"] == "aten::sum" for e in ops)
