"""PyTorch port, group walk in two phases: ``group_walk_lists`` (the
interaction lists, the plain version of the walk kernel) and
``group_eval_lists`` (their evaluation, the plain version of the
evaluation kernel), on the CPU.

The lists are held id for id against an independent walk written here per
tile in numpy float32 (the same rounding of the theta test), and the forces
against a float64 evaluation of those lists, the JAX skip engine and
``group_tree_forces``, whatever the order in which the walks took their
chunks of the pool. The kernels themselves are checked on the card by
``chip_smoke.py`` phase 12a.
"""

import numpy as np
import pytest
import torch

from wgpu_n_body_tpu_torch.ops import tree_walk_group as twg
from wgpu_n_body_tpu_torch.ops.tree_build import (
    COG_X,
    MASS,
    NO_CHILD,
    WIDTH,
    build_tree,
    morton_sort,
)
from wgpu_n_body_tpu_torch.ops.tree_walk import tree_forces
from wgpu_n_body_tpu_torch.ops.tree_walk_group import (
    LIST_CHUNK,
    group_eval_lists,
    group_tree_forces,
    group_walk_lists,
    group_walk_tiles,
    list_ids,
    tile_setup,
)
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams, state_from_numpy

from tests.test_torch_tree_group import JAX_TOL, SCENE, _port, _sim_params, jax_skip  # noqa: F401

N = 600


def _scene(kind, seed=11, n=N):
    """n bodies, masses U[0.5, 2]: ``uniform`` in [-1, 1]^3, or ``disc``,
    a thin rotating-disc-like slab (radius U[0, 1]^0.5, height 1e-2)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        pos = rng.uniform(-1, 1, (n, 3))
    else:
        r = np.sqrt(rng.uniform(0, 1, n))
        phi = rng.uniform(0, 2 * np.pi, n)
        pos = np.stack([r * np.cos(phi), r * np.sin(phi), 1e-2 * rng.normal(size=n)], 1)
    z = np.zeros((n, 3), np.float32)
    return {"pos": pos.astype(np.float32), "vel": z, "acc": z,
            "mass": rng.uniform(0.5, 2.0, n).astype(np.float32)}


def _setup(kind, g, theta, **kw):
    tp = TreeParams(max_depth=10, walk_tile=g, theta=theta, walk_engine="skip", **kw)
    ss, bound, keys = morton_sort(state_from_numpy(**_scene(kind), device="cpu"), tp.max_depth)
    tree = build_tree(ss, keys, bound, tp)
    return ss, tree, tile_setup(keys, ss.pos.shape[0], tp), tp


def _reference_walk(pos, tree, tiles, theta):
    """Per tile, a scalar skip walk: (ids, bad, steps) with ids in walk
    order (node k -> k, member j -> cap + 1 + j)."""
    nodes = tree.nodes_f32.numpy()
    skip, first, count = (a.numpy() for a in (tree.skip, tree.first, tree.count))
    num_nodes, cap = int(tree.num_nodes), nodes.shape[0] - 1
    th = np.float32(theta)
    out = []
    for t in range(int((tiles.piece_len > 0).sum())):
        a, ln = int(tiles.piece_start[t]), int(tiles.piece_len[t])
        p = pos[a : a + ln]
        lo, hi = p.min(0), p.max(0)
        cur, steps, ids = 0, 0, []
        while cur < num_nodes and steps <= tiles.r_cap:
            c = nodes[cur, COG_X : COG_X + 3]
            d = np.maximum(np.maximum(lo - c, c - hi), np.float32(0))
            d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            if nodes[cur, WIDTH] < th * np.sqrt(d2):
                ids.append(cur)
                steps += 1
                cur = skip[cur]
            elif nodes[cur, NO_CHILD] > 0:
                members = max(int(count[cur]), 1)
                ids.extend(cap + 1 + first[cur] + np.arange(members))
                steps += members
                cur = skip[cur]
            else:
                steps += 1
                cur += 1
        bad = steps > tiles.r_cap
        out.append((np.asarray(ids, np.int64), bad, tiles.r_cap if bad else steps))
    return out


@pytest.mark.parametrize("theta", [0.0, 0.5, 0.75])
@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("kind", ["uniform", "disc"])
def test_lists_equal_a_scalar_walk_and_forces_its_float64_sum(kind, g, theta):
    ss, tree, tiles, tp = _setup(kind, g, theta)
    lists = group_walk_lists(ss.pos, tree, tiles, tp)
    ref = _reference_walk(ss.pos.numpy(), tree, tiles, theta)
    nt = len(ref)
    assert not lists.pool_full.any() and not lists.bad[nt:].any()
    ids = list_ids(lists).numpy()
    for t, (want, bad, steps) in enumerate(ref):
        assert bool(lists.bad[t]) == bad and int(lists.steps[t]) == steps
        if not bad:
            assert int(lists.rows[t]) == want.size
            np.testing.assert_array_equal(ids[t, : want.size], want)
            assert (ids[t, want.size :] == -1).all()
    # the lists cover the tiles once, in chunks of the pool
    used = lists.chunks[lists.chunks >= 0]
    assert used.unique().numel() == used.numel()
    assert (lists.chunks >= 0).sum(1).tolist()[:nt] == [
        -(-int(r) // LIST_CHUNK) for r in lists.rows[:nt]]

    params = SimParams(particle_num=N, g=1e-3)
    got = group_eval_lists(ss.pos, ss.pos, ss.mass, tree, tiles, lists, params)
    comb = torch.cat([tree.nodes_f32[:, COG_X : MASS + 1],
                      torch.cat([ss.pos, ss.mass[:, None]], 1)]).double().numpy()
    cap = tree.nodes_f32.shape[0] - 1
    want = np.zeros((N, 3))
    for t, (tid, bad, _) in enumerate(ref):
        a, ln = int(tiles.piece_start[t]), int(tiles.piece_len[t])
        rows = comb[tid]
        for i in range(a, a + ln):
            d = rows[:, :3] - ss.pos[i].double().numpy()
            r2 = (d * d).sum(1)
            own = tid == cap + 1 + i
            r2 = np.where(own, 1.0, r2)
            w = rows[:, 3] * params.g * params.dt / np.sqrt(r2) / (r2 * np.sqrt(r2) + params.e)
            want[i] = (np.where(own, 0.0, w)[:, None] * d).sum(0)
    keep = ~(tiles.deferred | lists.bad[tiles.tile_id]).numpy()
    # float32 sums against float64: per-row relative error (components of a
    # thin disc's rows cancel, so they carry no relative bound of their own)
    err = np.linalg.norm(got.numpy() - want, axis=1) / np.linalg.norm(want, axis=1)
    assert err[keep].max() <= 1e-4
    # the composition is today's group_walk_tiles
    acc, bad, steps, rows = group_walk_tiles(ss.pos, ss.pos, ss.mass, tree, tiles, params, tp)
    assert torch.equal(bad, lists.bad) and torch.equal(steps, lists.steps)
    assert torch.equal(rows, lists.rows)
    torch.testing.assert_close(acc[keep], got[keep], rtol=0, atol=0)


@pytest.mark.parametrize("theta", [0.1, 0.75])
def test_two_phases_match_jax_skip_engine(theta, jax_skip):
    want, want_def = jax_skip[theta]
    ss, tree, keys, ttp = _port(SCENE, theta=theta)
    _, params = _sim_params(300)
    tiles = tile_setup(keys, 300, ttp)
    lists = group_walk_lists(ss.pos, tree, tiles, ttp)
    assert want_def == 0 and not (lists.bad | lists.pool_full).any()
    got = group_eval_lists(ss.pos, ss.pos, ss.mass, tree, tiles, lists, params)
    np.testing.assert_allclose(got.numpy(), want, **JAX_TOL)


def _relaid(lists, order):
    """``lists`` with the tiles' chunks laid into a fresh pool in the tile
    order ``order``, as the walk kernel's atomic counter may hand them out."""
    need = (lists.chunks >= 0).sum(1)
    at = torch.zeros(lists.chunks.shape[0], dtype=torch.int64)
    at[order] = torch.cumsum(need[order], 0) - need[order]  # first new chunk of each tile
    c = torch.arange(lists.chunks.shape[1])
    new = torch.where(lists.chunks >= 0, at[:, None] + c, -1).to(torch.int32)
    pool = torch.full_like(lists.ids, -7)
    for old_c, new_c in zip(lists.chunks[lists.chunks >= 0].tolist(), new[new >= 0].tolist()):
        pool[new_c * LIST_CHUNK : (new_c + 1) * LIST_CHUNK] = lists.ids[
            old_c * LIST_CHUNK : (old_c + 1) * LIST_CHUNK]
    return lists._replace(ids=pool, chunks=new)


def test_heaviest_first_order_gives_the_same_forces():
    """The pool's layout depends on the order in which the walks take
    chunks (heaviest list first, or any other): lists and forces do not."""
    ss, tree, tiles, tp = _setup("disc", 32, 0.5)
    params = SimParams(particle_num=N, g=1e-3)
    lists = group_walk_lists(ss.pos, tree, tiles, tp)
    base = group_eval_lists(ss.pos, ss.pos, ss.mass, tree, tiles, lists, params)
    heavy = torch.argsort(lists.rows, descending=True)
    assert lists.rows[heavy[0]] > lists.rows[0]  # the order does move tiles
    shuffled = torch.from_numpy(np.random.default_rng(3).permutation(tiles.t_cap))
    for order in (heavy, shuffled):
        moved = _relaid(lists, order)
        assert not torch.equal(moved.chunks, lists.chunks)
        assert torch.equal(list_ids(moved), list_ids(lists))
        got = group_eval_lists(ss.pos, ss.pos, ss.mass, tree, tiles, moved, params)
        torch.testing.assert_close(got, base, rtol=0, atol=0)


def test_small_pool_defers_exactly_the_tiles_it_cannot_hold(monkeypatch):
    ss, tree, tiles, tp = _setup("uniform", 32, 0.5)
    params = SimParams(particle_num=N, g=1e-3)
    roomy = group_walk_lists(ss.pos, tree, tiles, tp)
    need = -(-roomy.rows.long() // LIST_CHUNK)
    n_chunks = int(need.sum()) // 2
    monkeypatch.setattr(twg, "pool_chunks", lambda n: n_chunks)
    lists = group_walk_lists(ss.pos, tree, tiles, tp)
    # tiles take chunks in tile order: those past the pool's end are full
    full = (need > 0) & (torch.cumsum(need, 0) > n_chunks)
    assert torch.equal(lists.pool_full, full) and 0 < int(full.sum()) < int((need > 0).sum())
    assert torch.equal(lists.rows, roomy.rows) and torch.equal(lists.bad, roomy.bad)
    assert (lists.chunks[full] == -1).all()
    assert int((lists.chunks >= 0).sum()) == int(need[~full].sum()) <= n_chunks

    keys = morton_sort(state_from_numpy(**_scene("uniform"), device="cpu"), tp.max_depth)[2]
    got, stats = group_tree_forces(ss.pos, ss.pos, ss.mass, tree, keys, params, tp)
    monkeypatch.undo()
    want, want_stats = group_tree_forces(ss.pos, ss.pos, ss.mass, tree, keys, params, tp)
    moved = full[tiles.tile_id]
    assert int(stats.pool_deferred) == int(moved.sum()) and int(want_stats.pool_deferred) == 0
    assert int(stats.deferred) == int(want_stats.deferred) + int(moved.sum())
    idx = moved.nonzero().flatten()
    per = tree_forces(ss.pos[idx], ss.pos, ss.mass, tree, params, tp, self_idx=idx)
    torch.testing.assert_close(got[idx], per, rtol=0, atol=0)
    torch.testing.assert_close(got[~moved], want[~moved], rtol=0, atol=0)


def test_kernel_wrappers_take_cuda_tensors_and_report_the_pool_stat():
    from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda

    ss, tree, tiles, tp = _setup("uniform", 32, 0.5)
    params = SimParams(particle_num=N, g=1e-3)
    lists = group_walk_lists(ss.pos, tree, tiles, tp)
    before = (gcuda.LAUNCHES, gcuda.LAUNCHES_EVAL)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gcuda.group_walk_lists_cuda(ss.pos, tree, tiles, tp)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gcuda.group_eval_lists_cuda(ss.pos, ss.pos, ss.mass, tree, tiles, lists, params)
    assert (gcuda.LAUNCHES, gcuda.LAUNCHES_EVAL) == before
    keys = morton_sort(state_from_numpy(**_scene("uniform"), device="cpu"), tp.max_depth)[2]
    _, stats = gcuda.group_tree_forces_cuda(ss.pos, ss.pos, ss.mass, tree, keys, params, tp)
    assert stats.pool_deferred.dtype == torch.int32 and int(stats.pool_deferred) == 0


def test_study_sweep_rewrites_each_launch_constant_once(tmp_path, monkeypatch):
    from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda
    from wgpu_n_body_tpu_torch.utils import group_walk_study as study
    from wgpu_n_body_tpu_torch.utils.chip import variant_source

    monkeypatch.setattr(gcuda, "BUILD_DIR", tmp_path)
    assert variant_source({}) == gcuda.SOURCE
    for var in study.SWEEP[1:-1]:
        text = variant_source(var).read_text()
        for name, value in var.items():
            assert f"constexpr int {name} = {value};" in text
    assert "constexpr int kChunk = 256;" in gcuda.SOURCE.read_text()
    assert twg.LIST_CHUNK == 256  # the wrapper passes it; the launcher checks it
    with pytest.raises(SystemExit, match="kNoSuch"):
        variant_source({"kNoSuch": 1})
