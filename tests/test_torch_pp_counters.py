"""PyTorch port, the per-particle walk's counters: a traced
``TreeSim(walk="per_particle")`` step walks every 64th warp of its receivers
again by the walk kernel's warp rule and adds the receivers sampled, their
live visits, their warps' visits and their interactions to
``walk.pp_receivers``, ``walk.pp_live_visits``, ``walk.pp_warp_visits`` and
``walk.pp_interactions`` (``models/tree.py``). On the CPU the plain
``ops/tree_walk.py::warp_walk_counts`` counts what the kernel's counting
instantiation writes on the card.

Both are held against an independent numpy emulation of the warp rule, as
``csrc/tree_walk.cu`` states it (a lane is live at the warp's node iff that
node lies past every node it accepted or summed; the warp descends if any
live lane opens, else skips), on uniform and disc scenes at rest, so the
step's receivers are the sorted bodies. Without a profiler a step makes no
counter and runs no count."""

import numpy as np
import pytest
import torch

from wgpu_n_body_tpu_torch.inits import disc_init, uniform_init
from wgpu_n_body_tpu_torch.models import TreeSim
from wgpu_n_body_tpu_torch.models import tree as tree_model
from wgpu_n_body_tpu_torch.ops.tree_build import NO_CHILD, WIDTH, build_tree, morton_sort
from wgpu_n_body_tpu_torch.ops.tree_walk import walk_counts, warp_walk_counts
from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams
from wgpu_n_body_tpu_torch.utils import profiling

INITS = {"uniform": uniform_init, "disc": disc_init}
#: (scene, N, theta): N = 4100 cuts the third sampled warp, [4096, 4128), at 4 lanes
SCENES = [("uniform", 4100, 0.75), ("uniform", 4100, 0.5), ("disc", 3000, 0.75),
          ("disc", 3000, 0.5)]


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _at_rest(kind, n, seed=11):
    """The scene with zero velocity and acc: the drift leaves every position
    as it is, so the step's receivers are the sorted bodies."""
    sp = SimParams(particle_num=n)
    st = INITS[kind](torch.Generator().manual_seed(seed), sp, "cpu")
    z = torch.zeros_like(st.pos)
    return ParticleState(st.pos, z, z.clone(), st.mass)


def _tp(theta):
    return TreeParams(theta=theta, walk="per_particle")


def _numpy_warp_counts(pos, tree, theta, first_rows):
    """(B, 4) int64 for the warps [w0, w0 + 32) of ``first_rows``: nodes
    accepted, members summed, live visits, the warp's visits; numpy,
    float32 theta test as the plain walk rounds it."""
    nodes, skip = tree.nodes_f32.numpy(), tree.skip.numpy().astype(np.int64)
    count = tree.count.numpy().astype(np.int64)
    rows = nodes.shape[0]
    m = min(int(tree.num_nodes), rows - 1)
    out = []
    for w0 in first_rows:
        p = pos[w0:w0 + 32]
        got = np.zeros((len(p), 4), np.int64)
        resume = np.zeros(len(p), np.int64)
        cur = 0
        while cur < m:
            d = nodes[cur, :3] - p
            r2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            accept = nodes[cur, WIDTH] < np.float32(theta) * np.sqrt(r2)
            terminal = nodes[cur, NO_CHILD] > 0
            live = cur >= resume
            far, near = live & accept, live & ~accept & terminal
            got[:, 0] += far
            got[:, 1] += near * count[cur]
            got[:, 2] += live
            got[:, 3] += 1
            nxt = max(min(skip[cur], rows - 1), cur + 1)
            resume = np.where(far | near, nxt, resume)
            cur = cur + 1 if (live & ~accept & ~terminal).any() else nxt
        out.append(got)
    return np.concatenate(out)


def _sorted_tree(state, tp):
    ss, bound, keys = morton_sort(state, tp.max_depth)
    return ss, build_tree(ss, keys, bound, tp)


@pytest.mark.parametrize("kind,n,theta", SCENES)
def test_warp_walk_counts_equal_the_warp_rule_and_the_own_walks(kind, n, theta):
    tp = _tp(theta)
    ss, tree = _sorted_tree(_at_rest(kind, n), tp)
    got = warp_walk_counts(ss.pos, tree, tp)
    want = _numpy_warp_counts(ss.pos.numpy(), tree, theta, range(0, n, 32))
    np.testing.assert_array_equal(got.numpy(), want)
    # each lane accepts and sums what its own walk does, live at each node it visits
    own = walk_counts(ss.pos, tree, tp)
    np.testing.assert_array_equal(got[:, :3].numpy(), own[:, :3].numpy())
    assert bool((got[:, 3] >= got[:, 2]).all())


@pytest.mark.parametrize("n,k", [(1, 1), (31, 31), (2048, 32), (2049, 33), (4100, 68),
                                 (6144, 96), (6150, 102), (6200, 128)])
def test_sampled_rows_are_every_64th_warp(n, k):
    rows = tree_model._sampled_rows(n, torch.device("cpu"))
    want = [r for w in range(0, -(-n // 32), tree_model.PP_SAMPLE)
            for r in range(32 * w, min(32 * w + 32, n))]
    assert rows.tolist() == want and len(want) == k


def _traced_step(sim, state):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        sim.step_fn()(state)
    return profiling.counters()


@pytest.mark.parametrize("kind,n,theta", SCENES)
def test_traced_step_counts_the_sampled_warps_by_the_warp_rule(kind, n, theta):
    tp = _tp(theta)
    state = _at_rest(kind, n)
    got = _traced_step(TreeSim(SimParams(particle_num=n), tp), state)
    ss, tree = _sorted_tree(state, tp)
    first = range(0, n, 32 * tree_model.PP_SAMPLE)
    want = _numpy_warp_counts(ss.pos.numpy(), tree, theta, first)
    assert got == {
        "walk.pp_receivers": want.shape[0],
        "walk.pp_live_visits": int(want[:, 2].sum()),
        "walk.pp_warp_visits": int(want[:, 3].sum()),
        "walk.pp_interactions": int(want[:, 0].sum() + want[:, 1].sum()),
    }
    assert 0 < got["walk.pp_live_visits"] < got["walk.pp_warp_visits"]


def test_a_step_without_a_profiler_counts_and_samples_nothing(monkeypatch):
    calls = []

    def refuse(*a, **k):
        calls.append(a)
        raise AssertionError("a count ran without a profiler")

    monkeypatch.setattr(tree_model, "warp_walk_counts", refuse)
    monkeypatch.setattr(tree_model, "tree_forces_counts_cuda", refuse)
    monkeypatch.setattr(tree_model, "_sampled_rows", refuse)
    sim = TreeSim(SimParams(particle_num=600), _tp(0.75))
    out = sim.step_fn()(_at_rest("uniform", 600))
    assert torch.isfinite(out.acc).all()
    assert profiling.counters() == {} and calls == []


def test_the_group_walk_counts_no_pp_counter():
    n = 600
    got = _traced_step(TreeSim(SimParams(particle_num=n), TreeParams(walk_tile=64)),
                       _at_rest("uniform", n))
    assert got["walk.receivers"] == n
    assert not any(k.startswith("walk.pp_") for k in got)
