"""PyTorch port, the group walk's glue on the CPU: the list of deferred
receivers that the per-particle walk runs over, and the deferred masks that
``GroupWalkStats`` derives from the tiles and the lists when a caller reads
them.

Held to the composition the walk used while it merged the per-particle
walk's rows by a mask (``tiles.deferred | bad[tile_id]``, then the pool's
tiles, gathered per receiver), on the same inputs: the plain
``deferred_warps`` names exactly those receivers, and a numpy model of the
list kernel (``csrc/tree_walk_group.cu``'s ``group_defer_kernel``, which
reads the receivers' own flags only in the last tile and in pieces longer
than walk_tile) writes the same entries. The kernels themselves are held
to that composition bit for bit on the card by ``chip_smoke.py`` phase 12i.
"""

import numpy as np
import pytest
import torch

from wgpu_n_body_tpu_torch.ops import tree_walk_group as twg
from wgpu_n_body_tpu_torch.ops.tree_build import build_tree, morton_sort
from wgpu_n_body_tpu_torch.ops.tree_walk_group import (
    LIST_CHUNK,
    GroupWalkStats,
    defer_capacity,
    deferred_warps,
    group_tree_forces,
    group_walk_lists,
    tile_setup,
)
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams, state_from_numpy

N = 700


def _scene(seed, n=N):
    """n bodies, masses U[0.5, 2]: half in a tight clump, half uniform in
    [-1, 1]^3, so tiles range from short lists to long ones."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3))
    pos[: n // 2] = 0.3 + 0.02 * rng.normal(size=(n // 2, 3))
    z = np.zeros((n, 3), np.float32)
    return {"pos": pos.astype(np.float32), "vel": z, "acc": z,
            "mass": rng.uniform(0.5, 2.0, n).astype(np.float32)}


def _walk(case, monkeypatch):
    """(tiles, lists, keys, tree, sorted state, params) of one walk named by
    ``case``."""
    kw = {"roomy": {}, "over budget": {"walk_list_cap": 64},
          "small pool": {}, "spills": {}, "walk_tile 1": {"walk_list_cap": 64}}[case]
    g = 1 if case == "walk_tile 1" else 32
    tp = TreeParams(max_depth=10, walk_tile=g, theta=0.5, walk_engine="skip", **kw)
    ss, bound, keys = morton_sort(state_from_numpy(**_scene(5), device="cpu"), tp.max_depth)
    tree = build_tree(ss, keys, bound, tp)
    split = None
    if case == "spills":  # every receiver a group start: more pieces than the budget
        split = torch.zeros(N, dtype=torch.uint8)
    tiles = tile_setup(keys, N, tp, split=split)
    if case == "small pool":
        need = -(-group_walk_lists(ss.pos, tree, tiles, tp).rows.long() // LIST_CHUNK)
        monkeypatch.setattr(twg, "pool_chunks", lambda n: int(need.sum()) // 2)
    lists = group_walk_lists(ss.pos, tree, tiles, tp)
    return tiles, lists, keys, tree, ss, tp


def _parent_masks(tiles, lists):
    """The deferred and pool masks as the walk gathered them per receiver."""
    bad = tiles.deferred | lists.bad[tiles.tile_id]
    full = lists.pool_full[tiles.tile_id] & ~bad
    return bad | full, full


def _expand(warps):
    """The receivers a list of (first receiver, lane mask) entries names."""
    out = []
    for first, mask in warps.tolist():
        out += [first + lane for lane in range(32) if (mask >> lane) & 1]
    return torch.tensor(sorted(out), dtype=torch.int64)


def _defer_model(tiles, lists):
    """A numpy model of ``group_defer_kernel``: tiles in order, each read
    only if it is dropped, longer than walk_tile or the last; its piece cut
    into runs of 32 from its start, a run's lanes those dropped or deferred
    by the tile set-up, empty runs left out."""
    dropped = (lists.bad | lists.pool_full).numpy()
    start, length = tiles.piece_start.numpy(), tiles.piece_len.numpy()
    deferred = tiles.deferred.numpy()
    out = []
    for t in range(tiles.t_cap):
        p0, plen = int(start[t]), int(length[t])
        if not (dropped[t] or plen > tiles.g or t == tiles.t_cap - 1):
            continue
        for s0 in range(0, plen, 32):
            s = np.arange(s0, min(s0 + 32, plen))
            lanes = s[dropped[t] | deferred[p0 + s]] - s0
            mask = int(np.bitwise_or.reduce(1 << lanes)) if lanes.size else 0
            if mask:
                out.append((p0 + s0, mask - (1 << 32) if mask >= 1 << 31 else mask))
    return torch.tensor(out, dtype=torch.int32).reshape(-1, 2)


CASES = ["roomy", "over budget", "small pool", "spills", "walk_tile 1"]


@pytest.mark.parametrize("case", CASES)
def test_deferred_list_names_exactly_the_deferred_receivers(case, monkeypatch):
    tiles, lists, *_ = _walk(case, monkeypatch)
    warps, count = deferred_warps(tiles, lists)
    want, _ = _parent_masks(tiles, lists)
    assert warps.dtype == count.dtype == torch.int32 and int(count) == warps.shape[0]
    assert torch.equal(_expand(warps), want.nonzero().flatten())
    assert int(count) <= defer_capacity(N, tiles.t_cap)
    # each entry is 32 receivers of one piece, from a multiple of 32 in it
    first = warps[:, 0].long()
    top = [(m & 0xFFFFFFFF).bit_length() - 1 for m in warps[:, 1].tolist()]  # highest lane
    last = first + torch.tensor(top, dtype=torch.int64)
    assert (tiles.slot[first] % 32 == 0).all()
    assert torch.equal(tiles.tile_id[first], tiles.tile_id[last])
    if case in ("over budget", "small pool", "spills", "walk_tile 1"):
        assert int(count) > 0


@pytest.mark.parametrize("case", CASES)
def test_the_kernel_model_lists_what_the_plain_version_lists(case, monkeypatch):
    tiles, lists, *_ = _walk(case, monkeypatch)
    warps, _ = deferred_warps(tiles, lists)
    model = _defer_model(tiles, lists)
    # the kernel's order is the order in which tiles take their places
    assert torch.equal(model[torch.argsort(model[:, 0])], warps)


@pytest.mark.parametrize("case", CASES)
def test_tile_setup_defers_only_in_the_last_tile_or_long_pieces(case, monkeypatch):
    """What lets the list kernel read receivers' flags in few tiles."""
    tiles, *_ = _walk(case, monkeypatch)
    at = tiles.tile_id[tiles.deferred]
    assert ((at == tiles.t_cap - 1) | (tiles.piece_len[at] > tiles.g)).all()
    if case == "spills":
        assert tiles.deferred.any()


@pytest.mark.parametrize("case", CASES)
def test_lazy_masks_equal_the_gathered_ones(case, monkeypatch):
    tiles, lists, keys, tree, ss, tp = _walk(case, monkeypatch)
    stats = GroupWalkStats(tiles, lists)
    deferred, pool = _parent_masks(tiles, lists)
    assert torch.equal(stats.deferred_mask, deferred) and torch.equal(stats.pool_mask, pool)
    assert int(stats.deferred) == int(deferred.sum())
    assert int(stats.pool_deferred) == int(pool.sum())
    assert (int(stats.pool_deferred) > 0) == (case == "small pool")
    if case == "spills":
        return  # group_tree_forces makes its own tiles from the keys
    params = SimParams(particle_num=N, g=1e-3)
    _, walked = group_tree_forces(ss.pos, ss.pos, ss.mass, tree, keys, params, tp)
    assert torch.equal(walked.deferred_mask, deferred)
    assert torch.equal(walked.pool_mask, pool)


def test_stats_hold_no_per_receiver_mask():
    """The masks are derived when read: a walk keeps only its tiles, its
    lists and the evaluation's pair counter."""
    assert GroupWalkStats._fields == ("tiles", "lists", "eval_pairs")
    for name in ("deferred_mask", "pool_mask", "deferred", "pool_deferred"):
        assert isinstance(getattr(GroupWalkStats, name), property)
