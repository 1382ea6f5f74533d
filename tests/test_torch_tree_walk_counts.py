"""PyTorch port: ``ops/tree_walk.py::walk_counts``, the counting-only plain
walk that ``chip_smoke.py`` and ``utils/tree_walk_study.py`` hold the walk
kernel's per-receiver counts against, and the rule by which the kernel
(``csrc/tree_walk.cu``) shares one traversal among the 32 receivers of a warp.

The counts are held against an independent numpy walk, one receiver at a
time, and against the forces: at theta = 0 every receiver opens everything
and sums every source once. The warp rule (a lane is live at the warp's node
iff that node is not under one it has accepted; the warp descends if any live
lane opens, else skips) is emulated in numpy as the kernel's note states it:
every lane must accept and sum exactly what its own walk does, and the warp
must visit exactly the union of its lanes' walks. The kernel itself runs only
on the card.

The group walk's evaluation counts the receiver-row pairs it computes
(``walk.eval_pairs``): whole blocks of 32 receivers, so a tile's last,
partial block counts in full. The count is held, through a traced
``TreeSim`` step on the CPU (the plain version counts by the kernel's rule),
against the rule worked out here from the tiles and lists.
"""

import numpy as np
import pytest
import torch

from wgpu_n_body_tpu_torch.models import TreeSim
from wgpu_n_body_tpu_torch.ops.tree_build import NO_CHILD, WIDTH, build_tree, morton_sort
from wgpu_n_body_tpu_torch.ops.tree_walk import walk_counts
from wgpu_n_body_tpu_torch.ops.tree_walk_group import (
    group_tree_forces,
    group_walk_lists,
    tile_setup,
)
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams, state_from_numpy
from wgpu_n_body_tpu_torch.utils import profiling

CASES = {
    "theta 0.5, bucket 4": dict(theta=0.5, max_depth=10, leaf_bucket=4),
    "theta 0.75, overfull cells": dict(theta=0.75, max_depth=3, leaf_bucket=2),
    "theta 0, singleton leaves": dict(theta=0.0, max_depth=6, leaf_bucket=1),
    "theta 1.2, bucket 16": dict(theta=1.2, max_depth=12, leaf_bucket=16),
}


def _scene(kw, n=700, seed=1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    zeros = np.zeros((n, 3), np.float32)
    tp = TreeParams(walk="per_particle", **kw)
    ss, bound, keys = morton_sort(
        state_from_numpy(pos, zeros, zeros, np.ones(n, np.float32), "cpu"), tp.max_depth)
    return ss, build_tree(ss, keys, bound, tp), tp


def _arena(tree):
    return (tree.nodes_f32.numpy(), tree.skip.numpy(), tree.count.numpy(),
            int(tree.num_nodes))


def _accepts(nodes, k, p, theta):
    """The plain walk's theta test of node k for receivers p, float32."""
    d = nodes[k, :3] - p
    r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    return nodes[k, WIDTH] < np.float32(theta) * np.sqrt(r2)


def _own_walk(nodes, skip, count, m, p, theta):
    """(accepted, members, visited nodes as a set) of one receiver's walk."""
    cur, far, mem, seen = 0, 0, 0, set()
    while cur < m:
        seen.add(cur)
        if _accepts(nodes, cur, p, theta):
            far, cur = far + 1, skip[cur]
        elif nodes[cur, NO_CHILD] > 0:
            mem, cur = mem + count[cur], skip[cur]
        else:
            cur += 1
    return far, mem, seen


@pytest.mark.parametrize("name", list(CASES))
def test_walk_counts_match_an_independent_walk(name):
    ss, tree, tp = _scene(CASES[name], n=300)
    nodes, skip, count, m = _arena(tree)
    got = walk_counts(ss.pos, tree, tp)
    for i, p in enumerate(ss.pos.numpy()):
        far, mem, seen = _own_walk(nodes, skip, count, m, p, tp.theta)
        assert (int(got[i, 0]), int(got[i, 1]), int(got[i, 2])) == (far, mem, len(seen)), i
        if far:  # the narrowest node it accepted is one it visited and accepts
            k = int(got[i, 3])
            assert k in seen and _accepts(nodes, k, p, tp.theta)
        else:
            assert int(got[i, 3]) == -1


def test_walk_counts_at_theta_0_sum_every_source_once():
    ss, tree, tp = _scene(CASES["theta 0, singleton leaves"])
    got = walk_counts(ss.pos, tree, tp)
    n = ss.pos.shape[0]
    assert int(got[:, 0].max()) == 0 and bool((got[:, 1] == n).all())
    assert bool((got[:, 3] == -1).all())
    assert bool((got[:, 2] == int(tree.num_nodes)).all())  # every node visited


@pytest.mark.parametrize("name", list(CASES))
def test_warp_shared_traversal_gives_each_lane_its_own_walk(name):
    ss, tree, tp = _scene(CASES[name])
    nodes, skip, count, m = _arena(tree)
    cap = nodes.shape[0] - 1
    want = walk_counts(ss.pos, tree, tp)
    pos = ss.pos.numpy()
    n = pos.shape[0]
    union = []  # per run of 32 receivers, the nodes their own walks visit between them
    for w0 in range(0, n, 32):
        seen = [_own_walk(nodes, skip, count, m, p, tp.theta)[2] for p in pos[w0:w0 + 32]]
        union.append(len(set().union(*seen)))
    got = np.zeros((n, 3), np.int64)
    warp_visits = []
    for w0 in range(0, n, 32):
        idx = np.arange(w0, min(w0 + 32, n))
        p = pos[idx]
        resume = np.zeros(len(idx), np.int64)
        cur, visits = 0, 0
        while cur < m:
            live = cur >= resume
            assert live.any()  # the warp never visits a node no lane wants
            accept = _accepts(nodes, cur, p, tp.theta)
            terminal = nodes[cur, NO_CHILD] > 0
            far, near = live & accept, live & ~accept & terminal
            opens = live & ~accept & ~terminal
            got[idx, 0] += far
            got[idx, 1] += near * count[cur]
            got[idx, 2] += live
            nxt = max(min(skip[cur], cap), cur + 1)  # as the pack kernel clamps it
            resume = np.where(far | near, nxt, resume)
            visits += 1
            cur = cur + 1 if opens.any() else nxt
        warp_visits.append(visits)
    np.testing.assert_array_equal(got, want[:, :3].numpy())
    np.testing.assert_array_equal(warp_visits, union)


# ------------------------------------------------ the evaluation's pair count

EVAL_N = 500
EVAL_CASES = {  # walk_tile, other TreeParams; each state has partial tiles
    "walk_tile 64": (64, {}),
    "walk_tile 100, tiles over the step budget": (100, dict(theta=0.5, walk_list_cap=64)),
    "walk_tile 33": (33, {}),
    "walk_tile 16": (16, {}),
}


def _eval_scene(seed=3):
    """EVAL_N bodies at rest: a third in a 1e-3 ball, the rest in [-1, 1]^3,
    so the density-adaptive tiles come in many lengths."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (EVAL_N, 3))
    pos[: EVAL_N // 3] = -0.4 + pos[: EVAL_N // 3] * 1e-3
    z = np.zeros((EVAL_N, 3), np.float32)
    return state_from_numpy(pos.astype(np.float32), z, z,
                            rng.uniform(0.5, 2.0, EVAL_N).astype(np.float32), "cpu")


def _eval_rule(state, tp):
    """(receiver-row pairs, pairs the evaluation computes, tile lengths) of
    the group walk of ``state`` at rest, over the tiles neither bad nor
    pool_full: rows x len, and rows x 32 x ceil(len / 32)."""
    ss, bound, keys = morton_sort(state, tp.max_depth)
    tiles = tile_setup(keys, EVAL_N, tp)
    lists = group_walk_lists(ss.pos, build_tree(ss, keys, bound, tp), tiles, tp)
    done = ~(lists.bad | lists.pool_full).numpy()
    rows, length = lists.rows.numpy().astype(np.int64), tiles.piece_len.numpy().astype(np.int64)
    pairs = int((rows * length)[done].sum())
    computed = sum(int(r) * 32 * -(-int(n) // 32) for r, n, d in zip(rows, length, done) if d)
    return pairs, computed, length[length > 0], int((~done).sum())


def _traced_step(sim, state):
    step = sim.step_fn()
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state)
    got = profiling.counters()
    profiling.reset_counters()
    return got


@pytest.mark.parametrize("name", list(EVAL_CASES))
def test_eval_pairs_count_whole_32_receiver_blocks_of_finished_tiles(name):
    g, kw = EVAL_CASES[name]
    tp = TreeParams(max_depth=10, walk_tile=g, **kw)
    state = _eval_scene()
    pairs, computed, length, skipped = _eval_rule(state, tp)
    assert ((length < g) & (length % 32 != 0)).any()  # partial tiles with a partial block
    assert (skipped > 0) == ("budget" in name)
    got = _traced_step(TreeSim(SimParams(particle_num=EVAL_N, g=1e-3), tp), state)
    assert got["walk.pairs"] == pairs and got["walk.eval_pairs"] == computed
    assert got["walk.eval_pairs"] >= got["walk.pairs"]
    if g % 32 == 0 and (length % 32 == 0).all():
        assert computed == pairs


def test_eval_pairs_is_neither_counted_nor_made_without_a_profiler():
    tp = TreeParams(max_depth=10, walk_tile=64)
    state = _eval_scene()
    sim = TreeSim(SimParams(particle_num=EVAL_N, g=1e-3), tp)
    profiling.reset_counters()
    sim.step_fn()(state)
    assert profiling.counters() == {}
    ss, bound, keys = morton_sort(state, tp.max_depth)
    tree = build_tree(ss, keys, bound, tp)
    _, stats = group_tree_forces(ss.pos, ss.pos, ss.mass, tree, keys, sim.sim_params, tp)
    assert stats.eval_pairs is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _, stats = group_tree_forces(ss.pos, ss.pos, ss.mass, tree, keys, sim.sim_params, tp)
    assert stats.eval_pairs.dtype == torch.int64 and stats.eval_pairs.dim() == 0
    assert int(stats.eval_pairs) == _eval_rule(state, tp)[1]
