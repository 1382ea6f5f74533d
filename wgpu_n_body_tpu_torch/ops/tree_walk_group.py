"""Group (tile-shared) theta walk, plain torch — counterpart of
``wgpu_n_body_tpu/ops/tree_walk_group.py::group_tree_forces`` and the plain
version of the CUDA kernel ``csrc/tree_walk_group.cu``
(``ops/tree_walk_group_cuda.py``).

The walk amortises one traversal over a *tile* of Morton-adjacent
receivers:

  tiles    pieces of at most ``walk_tile`` consecutive sorted receivers
           that never leave their density-adaptive Morton cell
           (``_tile_assignment``), so each tile's bounding box stays tight;
  phase A  (``group_walk_lists``) each tile walks the arena once from the
           root, without a stack (the JAX skip engine): a node whose width
           is below theta * dmin(bbox, cog) enters the tile's list as one
           point-mass row and the walk jumps past its subtree; a terminal
           cell that fails the test enters it as one member row per
           particle, one step each (overfull max-depth cells included);
           an internal node that fails costs one step and is opened. The
           lists are ids into the table [node rows | source rows], kept in
           chunks of a pool sized from the receiver count;
  phase B  (``group_eval_lists``) every receiver of the tile sums its list
           with one point-mass formula, the self pair excluded by global
           sorted index;
  fallback a tile that needs more than ``r_cap = ceil(2*walk_list_cap/256)
           *256`` steps is *bad*, and one whose list finds no room in the
           pool is *pool_full*: their receivers (and any that spilled out
           of the static tile budget) are deferred to the per-particle walk.

This is the JAX skip engine as it runs in one pass (the JAX package's CPU
path). The JAX package's default octet engine opens the same nodes up to
its 9-bit quantized centre of gravity; the port runs the skip engine's
exact test for both values of ``walk_engine`` (ROADMAP C lists the
difference). The JAX density ordering of tiles, list compaction sort,
straggler pass and tiered fallback batches are TPU scheduling and static
shape machinery; none changes a result, and none is here.

Phase A runs all tiles in lockstep, one step per iteration, as the JAX
``lax.while_loop``; phase B evaluates the lists in chunks of rows so that
memory stays bounded. The CUDA kernels take the same two phases
(``csrc/tree_walk_group.cu``), so each is held against its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from wgpu_n_body_tpu_torch.ops import morton
from wgpu_n_body_tpu_torch.ops.tree_build import (
    COG_X,
    MASS,
    NO_CHILD,
    WIDTH,
    TreeArrays,
)
from wgpu_n_body_tpu_torch.ops.tree_walk import tree_forces
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams


class GroupWalkStats(NamedTuple):
    deferred: torch.Tensor  # () int32: receivers sent down the fallback walk
    pool_deferred: torch.Tensor  # () int32: of those, deferred for want of list pool room


class Tiles(NamedTuple):
    """The tile partition of the receivers (``tile_setup``).

    tile_id:     (n,) int64 tile of each receiver (spills merged into the
                 last tile).
    slot:        (n,) int64 position of each receiver in its tile.
    piece_start: (t_cap,) int32 first receiver of each tile.
    piece_len:   (t_cap,) int32 receivers of each tile (0: unused tile).
    deferred:    (n,) bool receivers deferred by the partition itself
                 (beyond the static tile budget, or beyond walk_tile slots).
    t_cap, g, r_cap: tile budget, walk_tile and the per-tile step budget.
    """

    tile_id: torch.Tensor
    slot: torch.Tensor
    piece_start: torch.Tensor
    piece_len: torch.Tensor
    deferred: torch.Tensor
    t_cap: int
    g: int
    r_cap: int


def _window(x: torch.Tensor, w: int, op) -> torch.Tensor:
    """y[a] = op(x[a : a + w]) for a in [0, len(x) - w], by doubling: about
    log2(w) elementwise passes (``op`` is torch.minimum or torch.maximum)."""
    m, span = x, 1
    while 2 * span <= w:
        m = op(m[:-span], m[span:])  # m[a] = op(x[a : a + 2*span])
        span *= 2
    k = x.shape[0] - w + 1
    return op(m[:k], m[w - span : w - span + k])


def _tile_assignment(s, n, depth, g_tile, ta_blk_max=2048):
    """Split the sorted receivers into density-adaptive pieces
    (``tree_walk_group.py:184-242``, integers equal) from their split
    levels ``s`` (``morton.split_levels`` of their sorted keys).

    Each receiver's tile cell is its deepest ancestor Morton cell still
    holding >= g_tile receivers; pieces break where that cell changes and
    every g_tile receivers within it. Returns (tile_id (n,) int64, lstar
    (n,) int64, t_cap, t_blk, ta_blk).

    The JAX package sizes every level's runs with cummax/cummin scans over
    (depth+1, n) arrays. Here lstar comes from the split levels s alone:
    g_tile consecutive receivers [a, a+g_tile) share their key prefix down
    to level min(s[a+1 : a+g_tile]) - 1, and a cell holds >= g_tile
    receivers iff such a window inside it covers the receiver, so lstar[i]
    is the max of that depth over the windows covering i — two sliding
    windows of ~log2(g_tile) passes each, the same integers.
    """
    dev = s.device
    i64 = torch.int64
    ii = torch.arange(n, dtype=i64, device=dev)
    if g_tile == 1:
        lstar = torch.full((n,), depth, dtype=i64, device=dev)
    elif n < g_tile:
        lstar = torch.zeros(n, dtype=i64, device=dev)
    else:
        shared = _window(s[1:].to(torch.int32), g_tile - 1, torch.minimum) - 1
        pad = torch.full((g_tile - 1,), -1, dtype=torch.int32, device=dev)
        lstar = _window(torch.cat([pad, shared, pad]), g_tile, torch.maximum)
        lstar = torch.clamp(lstar, 0, depth).to(i64)
    prev_lstar = torch.cat([torch.full((1,), -1, dtype=i64, device=dev), lstar[:-1]])
    grp_start = (ii == 0) | (lstar != prev_lstar) | (s <= lstar)
    grp_id = torch.cumsum(grp_start, 0) - 1
    grp_first = torch.zeros(n + 1, dtype=i64, device=dev)  # slot n: dropped
    grp_first.scatter_(0, torch.where(grp_start, grp_id, n), ii)
    rs_grp = grp_first[grp_id]
    brk = grp_start | ((ii - rs_grp) % g_tile == 0)
    tile_id = torch.cumsum(brk, 0) - 1
    # static budgets, as the JAX package sizes them
    t_cap = -(-n // g_tile) + max(8, 2 * -(-n // g_tile))
    t_blk = min(32, t_cap)
    t_cap = -(-t_cap // t_blk) * t_blk
    ta_blk = min(ta_blk_max, t_cap)
    t_cap = -(-t_cap // ta_blk) * ta_blk
    return tile_id, lstar, t_cap, t_blk, ta_blk


def tile_setup(keys, n: int, tree_params: TreeParams, split=None) -> Tiles:
    """The tiles of n sorted receivers with packed Morton ``keys``
    (``tree_walk_group.py:287-301``). No host read. ``split``: the
    receivers' split levels where a build already made them (the build
    kernels' ``TreeArrays.split``); by default ``morton.split_levels`` of
    the keys."""
    depth = tree_params.max_depth
    s = morton.split_levels(keys, depth) if split is None else split
    g = tree_params.effective_walk_tile(n)
    tile_id_raw, _, t_cap, _, _ = _tile_assignment(s, n, depth, g, tree_params.walk_block)
    spilled = tile_id_raw >= t_cap  # merged into the last tile; deferred
    tile_id = torch.clamp(tile_id_raw, max=t_cap - 1)
    dev = tile_id.device
    piece_start = torch.searchsorted(tile_id, torch.arange(t_cap, device=dev))
    piece_end = torch.cat([piece_start[1:], torch.full((1,), n, dtype=torch.int64, device=dev)])
    slot = torch.arange(n, device=dev) - piece_start[tile_id]
    r_cap = -(-(2 * tree_params.walk_list_cap) // 256) * 256
    return Tiles(
        tile_id=tile_id,
        slot=slot,
        piece_start=piece_start.to(torch.int32),
        piece_len=(piece_end - piece_start).to(torch.int32),
        deferred=spilled | (slot >= g),
        t_cap=t_cap,
        g=g,
        r_cap=r_cap,
    )


def _check_engine_args(imports) -> None:
    if imports is not None:
        raise NotImplementedError(
            "group_tree_forces(imports=...) is the fused LET walk of the sharded "
            "tree (let_fused=True), not ported yet (ROADMAP A13, B8)"
        )


class GroupLists(NamedTuple):
    """Phase A's output (``group_walk_lists``): each tile's interaction
    list as ids into the combined table ``[node rows | source rows]`` (node
    ``k`` -> ``k``, sorted source ``j`` -> ``cap + 1 + j``), in walk order.

    ids:       (pool,) int32 pool of ids, in chunks of ``LIST_CHUNK``.
    chunks:    (t_cap, max_chunks) int32: the pool chunk that holds rows
               [c * LIST_CHUNK, (c + 1) * LIST_CHUNK) of tile t's list
               (-1: none).
    bad:       (t_cap,) bool, over the step budget r_cap.
    steps:     (t_cap,) int32 phase-A steps (r_cap for a bad tile).
    rows:      (t_cap,) int32 list rows.
    pool_full: (t_cap,) bool, the pool had no room for the tile's list.
    A bad or pool_full tile's receivers are deferred; its list, steps and
    rows are not meaningful past the point where it stopped.
    """

    ids: torch.Tensor
    chunks: torch.Tensor
    bad: torch.Tensor
    steps: torch.Tensor
    rows: torch.Tensor
    pool_full: torch.Tensor


#: Rows of one pool chunk: the unit a walk takes from the pool, and one
#: stage of the evaluation kernel's shared-memory ring.
LIST_CHUNK = 256
#: Pool rows per receiver, and the least pool. The longest lists measured
#: are the N=2M disc scene's at theta=0.5 (walk_tile 256): the walk takes
#: 16.85 pool ids per receiver, chunk padding included; the N=4M uniform
#: scene at theta=0.75 takes 5.72 (chip_smoke.py 12f and 12e; PERF.md). 32
#: per receiver leaves a 1.9x margin over the larger, 128 bytes per body.
#: Which tiles a full pool defers depends on scheduling, so it is sized not
#: to fill. The floor keeps small scenes, whose lists hold much of the
#: tree, out of the fallback.
POOL_ROWS_PER_RECEIVER = 32
POOL_MIN_ROWS = 1 << 24


def pool_chunks(n: int) -> int:
    """Pool chunks for n receivers."""
    return -(-max(POOL_ROWS_PER_RECEIVER * n, POOL_MIN_ROWS) // LIST_CHUNK)


def max_chunks(tiles: Tiles) -> int:
    """Chunks per tile: a list of more than r_cap rows means more than
    r_cap steps, so a bad tile."""
    return -(-tiles.r_cap // LIST_CHUNK)


def group_walk_lists(
    pos_new: torch.Tensor,
    tree: TreeArrays,
    tiles: Tiles,
    tree_params: TreeParams,
) -> GroupLists:
    """Phase A for every tile: the interaction lists, in a pool of
    ``pool_chunks(n)`` chunks.

    Tiles take chunks in tile order here; a tile whose chunks do not all fit
    is ``pool_full``. The kernel hands chunks out in the order walks ask for
    them, so under a full pool which tiles it defers depends on scheduling
    (each deferred row is then B3's, whichever tile it is in).
    """
    dev = pos_new.device
    n = pos_new.shape[0]
    cap = tree.nodes_f32.shape[0] - 1
    g, t_cap, r_cap = tiles.g, tiles.t_cap, tiles.r_cap
    theta = tree_params.theta
    i64 = torch.int64
    n_chunks = pool_chunks(n)

    # Tiles 0..T-1 hold every receiver; the rest of the static budget is empty.
    nt = min(int(tiles.tile_id[-1]) + 1, t_cap) if n else 0
    tile_pos = _tile_positions(pos_new, tiles, nt)
    blo = tile_pos.amin(1)
    bhi = tile_pos.amax(1)

    # ---- all tiles in lockstep, one node or member row per step ----
    # id `cap` marks a step that emits no row (an opened internal node, or
    # a finished walk)
    num_nodes = tree.num_nodes.to(i64)
    skip = tree.skip.to(i64)
    first = tree.first.to(i64)
    count = tree.count.to(i64)
    member_base = cap + 1
    cur = torch.zeros(nt, dtype=i64, device=dev)
    koff = torch.zeros(nt, dtype=i64, device=dev)
    steps = torch.zeros(nt, dtype=i64, device=dev)
    ids = []
    for _ in range(r_cap):
        done = cur >= num_nodes
        if bool(done.all()):
            break
        at = torch.clamp(cur, max=cap)
        row = tree.nodes_f32[at]
        cx, cy, cz = row[:, COG_X], row[:, COG_X + 1], row[:, COG_X + 2]
        dx = torch.clamp(torch.maximum(blo[:, 0] - cx, cx - bhi[:, 0]), min=0.0)
        dy = torch.clamp(torch.maximum(blo[:, 1] - cy, cy - bhi[:, 1]), min=0.0)
        dz = torch.clamp(torch.maximum(blo[:, 2] - cz, cz - bhi[:, 2]), min=0.0)
        dmin = torch.sqrt(dx * dx + dy * dy + dz * dz)
        theta_ok = row[:, WIDTH] < theta * dmin
        near = ~theta_ok & (row[:, NO_CHILD] > 0.0)
        entry = torch.where(theta_ok, cur, torch.where(near, member_base + first[at] + koff, cap))
        ids.append(torch.where(done, cap, entry))
        steps += (~done).to(i64)
        exhausted = koff + 1 >= count[at]
        koff = torch.where(near & ~exhausted & ~done, koff + 1, 0)
        nxt = torch.where(theta_ok | (near & exhausted), skip[at], torch.where(near, cur, cur + 1))
        cur = torch.where(done, cur, nxt)
    bad = cur < num_nodes
    lists = torch.stack(ids) if ids else torch.zeros((0, nt), dtype=i64, device=dev)

    # ---- the rows of each tile, in chunks of the pool, in tile order ----
    emitted = lists != cap  # (steps, T)
    rows = emitted.sum(0)
    need = -(-rows // LIST_CHUNK)
    start = torch.cumsum(need, 0) - need
    full = (need > 0) & (start + need > n_chunks)
    mc = max_chunks(tiles)
    cidx = torch.arange(mc, dtype=i64, device=dev)
    chunks = torch.full((t_cap, mc), -1, dtype=torch.int32, device=dev)
    chunks[:nt] = torch.where((cidx < need[:, None]) & ~full[:, None], start[:, None] + cidx, -1).to(
        torch.int32
    )
    used = int(torch.where(full, 0, need).sum())
    pool = torch.zeros(used * LIST_CHUNK, dtype=torch.int32, device=dev)
    keep = emitted & ~full
    rank = torch.cumsum(keep, 0) - 1
    at = (start[None, :] * LIST_CHUNK + rank)[keep]
    pool[at] = lists[keep].to(torch.int32)

    def full_len(x, dtype):
        out = torch.zeros(t_cap, dtype=dtype, device=dev)
        out[:nt] = x.to(dtype)
        return out

    return GroupLists(
        ids=pool,
        chunks=chunks,
        bad=full_len(bad, torch.bool),
        steps=full_len(torch.where(bad, r_cap, steps), torch.int32),
        rows=full_len(rows, torch.int32),
        pool_full=full_len(full, torch.bool),
    )


def list_ids(lists: GroupLists, pad: int = -1) -> torch.Tensor:
    """(t_cap, max rows) int64: each tile's list ids in walk order, gathered
    from the pool through the chunk table, padded with ``pad``. One host
    read (the longest list)."""
    width = int(lists.rows.max()) if lists.rows.numel() else 0
    r = torch.arange(width, dtype=torch.int64, device=lists.rows.device)
    chunk = lists.chunks.to(torch.int64).gather(
        1, (r // LIST_CHUNK).clamp(max=lists.chunks.shape[1] - 1).expand(lists.chunks.shape[0], -1)
    )
    live = (r[None, :] < lists.rows[:, None]) & (chunk >= 0)
    where = torch.where(live, chunk * LIST_CHUNK + r % LIST_CHUNK, 0)
    if lists.ids.numel() == 0:
        return torch.full(where.shape, pad, dtype=torch.int64, device=where.device)
    return torch.where(live, lists.ids.to(torch.int64)[where], pad)


def source_table(tree: TreeArrays, src_pos, src_mass, gdt: float) -> torch.Tensor:
    """(cap + 1 + N, 4) float32 combined table of the list ids: node rows
    (cog, mass * g * dt), then sorted source rows (position, mass * g * dt)."""
    rows = tree.nodes_f32.shape[0]
    table = torch.empty((rows + src_pos.shape[0], 4), dtype=torch.float32, device=src_pos.device)
    table[:rows, :3] = tree.nodes_f32[:, COG_X : COG_X + 3]
    table[rows:, :3] = src_pos
    torch.mul(tree.nodes_f32[:, MASS], gdt, out=table[:rows, 3])
    torch.mul(src_mass, gdt, out=table[rows:, 3])
    return table


def _tile_positions(pos_new, tiles: Tiles, nt: int):
    """(nt, G, 3) receivers of tiles 0..nt-1; unused slots repeat the
    piece's first receiver (the bbox stays tight)."""
    sidx = torch.arange(tiles.g, dtype=torch.int64, device=pos_new.device)
    start = tiles.piece_start[:nt].to(torch.int64)
    length = tiles.piece_len[:nt].to(torch.int64)
    return pos_new[start[:, None] + torch.minimum(sidx[None, :], length[:, None] - 1)]


def group_eval_lists(
    pos_new: torch.Tensor,
    src_pos: torch.Tensor,
    src_mass: torch.Tensor,
    tree: TreeArrays,
    tiles: Tiles,
    lists: GroupLists,
    params: SimParams,
    gid_offset: int = 0,
) -> torch.Tensor:
    """Phase B: (n, 3) acc*dt, every receiver of a tile against its list
    with one point-mass formula, the self pair excluded by sorted index.
    Rows of receivers in bad or pool_full tiles are not meaningful."""
    dev = pos_new.device
    n, n_src = pos_new.shape[0], src_pos.shape[0]
    cap = tree.nodes_f32.shape[0] - 1
    g, t_cap = tiles.g, tiles.t_cap
    e = params.e
    i64 = torch.int64
    nt = min(int(tiles.tile_id[-1]) + 1, t_cap) if n else 0
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if not nt:
        return acc
    comb = source_table(tree, src_pos, src_mass, params.g * params.dt)
    comb_gid = torch.cat(
        [torch.full((cap + 1,), -1, dtype=i64, device=dev), torch.arange(n_src, device=dev)]
    )
    ids = list_ids(lists, pad=cap)[:nt]  # (T, L); the pad row `cap` adds exactly 0
    tile_pos = _tile_positions(pos_new, tiles, nt)  # (T, G, 3)
    sidx = torch.arange(g, dtype=i64, device=dev)
    start = tiles.piece_start[:nt].to(i64)
    length = tiles.piece_len[:nt].to(i64)
    tile_gid = torch.where(sidx[None, :] < length[:, None], start[:, None] + sidx + gid_offset, n_src)
    px, py, pz = (tile_pos[:, :, c : c + 1] for c in range(3))  # (T, G, 1)
    acc_tiles = torch.zeros((nt, g, 3), dtype=torch.float32, device=dev)
    chunk = max(1, (1 << 22) // (nt * g))
    for c0 in range(0, ids.shape[1], chunk):
        idc = ids[:, c0 : c0 + chunk]  # (T, C)
        rows = comb[idc]  # (T, C, 4)
        is_self = comb_gid[idc][:, None, :] == tile_gid[:, :, None]  # (T, G, C)
        dx = rows[:, None, :, 0] - px
        dy = rows[:, None, :, 1] - py
        dz = rows[:, None, :, 2] - pz
        r2 = dx * dx + dy * dy + dz * dz
        r2s = torch.where(is_self, 1.0, r2)
        inv_r = torch.rsqrt(r2s)
        r = r2s * inv_r
        w = rows[:, None, :, 3] * inv_r / (r2s * r + e)
        w = torch.where(is_self, 0.0, w)
        acc_tiles += torch.stack([(w * dx).sum(2), (w * dy).sum(2), (w * dz).sum(2)], 2)

    slot = torch.clamp(tiles.slot, max=g - 1)
    return acc_tiles[torch.clamp(tiles.tile_id, max=nt - 1), slot]


def group_walk_tiles(
    pos_new: torch.Tensor,
    src_pos: torch.Tensor,
    src_mass: torch.Tensor,
    tree: TreeArrays,
    tiles: Tiles,
    params: SimParams,
    tree_params: TreeParams,
    gid_offset: int = 0,
):
    """Phases A and B for every tile (``group_walk_lists``, then
    ``group_eval_lists``): ((n, 3) acc*dt of the group walk, tile_bad
    (t_cap,) bool, tile_steps (t_cap,) int32, tile_rows (t_cap,) int32).

    ``tile_bad`` marks the tiles whose receivers are deferred (over the step
    budget, or no room in the list pool), ``tile_steps`` counts phase-A
    steps (r_cap for a tile over the budget) and ``tile_rows`` the list
    rows emitted. Rows of receivers in deferred tiles, or deferred by
    ``tiles``, are not meaningful: the fallback replaces them.
    """
    lists = group_walk_lists(pos_new, tree, tiles, tree_params)
    acc = group_eval_lists(pos_new, src_pos, src_mass, tree, tiles, lists, params, gid_offset)
    return acc, lists.bad | lists.pool_full, lists.steps, lists.rows


def group_tree_forces(
    pos_new: torch.Tensor,
    src_pos: torch.Tensor,
    src_mass: torch.Tensor,
    tree: TreeArrays,
    keys: torch.Tensor,
    params: SimParams,
    tree_params: TreeParams,
    gid_offset: int = 0,
    imports=None,
) -> tuple[torch.Tensor, GroupWalkStats]:
    """((B, 3) acc*dt, stats) of the group walk, plain torch.

    pos_new:  (B, 3) post-drift receivers, a contiguous slice of the sorted
              order starting at sorted index ``gid_offset``.
    src_pos:  (N, 3) pre-step sources, the full sorted order.
    src_mass: (N,) sorted masses.
    keys:     packed Morton keys of the receivers (same slice).
    imports:  the JAX fused-LET import forest; not ported (B8), raises.
    """
    _check_engine_args(imports)
    n = pos_new.shape[0]
    tiles = tile_setup(keys, n, tree_params)
    lists = group_walk_lists(pos_new, tree, tiles, tree_params)
    acc = group_eval_lists(pos_new, src_pos, src_mass, tree, tiles, lists, params, gid_offset)
    bad = tiles.deferred | lists.bad[tiles.tile_id]
    full = lists.pool_full[tiles.tile_id] & ~bad
    deferred = bad | full
    idx = deferred.nonzero().flatten()
    if idx.numel():
        acc[idx] = tree_forces(
            pos_new[idx], src_pos, src_mass, tree, params, tree_params,
            self_idx=gid_offset + idx,
        )
    return acc, GroupWalkStats(
        deferred=deferred.sum().to(torch.int32), pool_deferred=full.sum().to(torch.int32)
    )
