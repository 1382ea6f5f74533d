"""Wrapper of the hand-written group walk kernels (``csrc/tree_walk_group.cu``).

``group_tree_forces_cuda`` has the signature of
``ops/tree_walk_group.py::group_tree_forces`` (the JAX package's
``group_tree_forces``). For CUDA tensors it builds the tiles with torch ops,
launches the walk kernel (one warp per tile: the interaction lists, as ids
in a pool), the evaluation kernel (one CTA per tile), and then the
per-particle walk kernel (``csrc/tree_walk.cu``) once over the deferred
receivers as a mask, so a step needs no host read. For CPU tensors it
returns the plain version; every other device raises. A CUDA tensor never
falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from wgpu_n_body_tpu_torch.ops import cuda_build
from wgpu_n_body_tpu_torch.ops.tree_build import NODE_F32_COLS, TreeArrays
from wgpu_n_body_tpu_torch.ops.tree_walk_cuda import _check, tree_forces_cuda
from wgpu_n_body_tpu_torch.ops.tree_walk_group import (
    LIST_CHUNK,
    GroupLists,
    GroupWalkStats,
    Tiles,
    _check_engine_args,
    group_tree_forces,
    max_chunks,
    pool_chunks,
    source_table,
    tile_setup,
)
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams
from wgpu_n_body_tpu_torch.utils.profiling import trace_scope

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tree_walk_group.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = list(cuda_build.BASE_FLAGS)  # the theta test rounds by intrinsics
MAX_TILE = 512  # 128 threads per evaluation CTA, at most four receivers each

#: Walk kernel launches since import (or since a caller set it to 0): one
#: per group walk.
LAUNCHES = 0
#: Evaluation kernel launches, likewise.
LAUNCHES_EVAL = 0
_lib: ctypes.CDLL | None = None


def build() -> tuple[Path, str]:
    """Compile the kernels unless a library of this exact source exists.
    Returns (library path, compiler output); raises RuntimeError with
    nvcc's output when the build fails."""
    return cuda_build.compile_cu(SOURCE, BUILD_DIR, NVCC_FLAGS)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.group_lists_launch.argtypes = [
            p, p, p, p, p, p,  # pos_new, nodes, skip, first, count, num_nodes
            p, p, p, p, i, i,  # piece_start, piece_len, ids, pool_next, n_chunks, chunk
            p, i, p, p, p, p,  # chunks, max_chunks, bad, steps, rows, full
            i, i, i, i, f, i, p,  # tiles, g, r_cap, cap, theta, device, stream
        ]
        lib.group_eval_launch.argtypes = [
            p, p, p, p, i, p, p,  # pos_new, table, ids, chunks, max_chunks, rows, skip
            p, p, p,  # piece_start, piece_len, out
            i, i, i, f, i, p,  # tiles, g, self_base, e, device, stream
        ]
        lib.group_lists_launch.restype = lib.group_eval_launch.restype = i
        _lib = lib
    return _lib


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def check_receivers(gid_offset: int, n: int, n_src: int) -> int:
    """``gid_offset`` as an int, if the n receivers' global indices [gid_offset,
    gid_offset + n) are sources of the walk (a slice of the sorted order) or
    lie wholly past the n_src sources (the LET import walk, whose receivers
    are no source, so the self-mask masks none); ValueError otherwise."""
    gid_offset = int(gid_offset)
    if gid_offset < 0 or gid_offset < n_src < gid_offset + n:
        raise ValueError(f"receivers [{gid_offset}, {gid_offset + n}) straddle the end of the "
                         f"{n_src} sources")
    return gid_offset


def group_walk_lists_cuda(
    pos_new: torch.Tensor,
    tree: TreeArrays,
    tiles: Tiles,
    tree_params: TreeParams,
) -> GroupLists:
    """The walk kernel's counterpart of ``tree_walk_group.group_walk_lists``,
    CUDA tensors only. The pool holds ``pool_chunks(n)`` chunks; tiles take
    them in the order their walks ask."""
    global LAUNCHES
    device = pos_new.device
    if device.type != "cuda":
        raise ValueError(f"group_walk_lists_cuda takes CUDA tensors, got {device}")
    n = pos_new.shape[0]
    rows = tree.nodes_f32.shape[0]
    _check("pos_new", pos_new, torch.float32, (n, 3))
    _check("nodes_f32", tree.nodes_f32, torch.float32, (rows, NODE_F32_COLS))
    for name in ("skip", "first", "count"):
        _check(name, getattr(tree, name), torch.int32, (rows,))
    _check("num_nodes", tree.num_nodes, torch.int32, ())
    _check("piece_start", tiles.piece_start, torch.int32, (tiles.t_cap,))
    _check("piece_len", tiles.piece_len, torch.int32, (tiles.t_cap,))
    if not 1 <= tiles.g <= MAX_TILE:
        raise ValueError(f"walk_tile must be in [1, {MAX_TILE}] on CUDA, got {tiles.g}")
    n_chunks = pool_chunks(n)
    mc = max_chunks(tiles)

    ids = torch.empty(n_chunks * LIST_CHUNK, dtype=torch.int32, device=device)
    pool_next = torch.zeros((), dtype=torch.int32, device=device)
    chunks = torch.full((tiles.t_cap, mc), -1, dtype=torch.int32, device=device)
    per_tile = torch.empty((4, tiles.t_cap), dtype=torch.int32, device=device)
    err = _library().group_lists_launch(
        pos_new.data_ptr(), tree.nodes_f32.data_ptr(), tree.skip.data_ptr(),
        tree.first.data_ptr(), tree.count.data_ptr(), tree.num_nodes.data_ptr(),
        tiles.piece_start.data_ptr(), tiles.piece_len.data_ptr(), ids.data_ptr(),
        pool_next.data_ptr(), n_chunks, LIST_CHUNK, chunks.data_ptr(), mc,
        per_tile[0].data_ptr(), per_tile[1].data_ptr(), per_tile[2].data_ptr(),
        per_tile[3].data_ptr(), tiles.t_cap, tiles.g, tiles.r_cap, rows - 1,
        float(tree_params.theta), _device_index(device),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"group_lists kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return GroupLists(ids=ids, chunks=chunks, bad=per_tile[0] != 0, steps=per_tile[1],
                      rows=per_tile[2], pool_full=per_tile[3] != 0)


def group_eval_lists_cuda(
    pos_new: torch.Tensor,
    src_pos: torch.Tensor,
    src_mass: torch.Tensor,
    tree: TreeArrays,
    tiles: Tiles,
    lists: GroupLists,
    params: SimParams,
    gid_offset: int = 0,
    table: torch.Tensor | None = None,
) -> torch.Tensor:
    """The evaluation kernel's counterpart of
    ``tree_walk_group.group_eval_lists``, CUDA tensors only: (n, 3) acc*dt;
    rows of receivers in deferred tiles are not written. ``table`` is
    ``source_table(tree, src_pos, src_mass, g * dt)`` where the caller has
    it already; otherwise it is built here."""
    global LAUNCHES_EVAL
    device = pos_new.device
    if device.type != "cuda":
        raise ValueError(f"group_eval_lists_cuda takes CUDA tensors, got {device}")
    n, n_src = pos_new.shape[0], src_pos.shape[0]
    cap = tree.nodes_f32.shape[0] - 1
    t_cap, mc = tiles.t_cap, max_chunks(tiles)
    _check("pos_new", pos_new, torch.float32, (n, 3))
    _check("src_pos", src_pos, torch.float32, (n_src, 3))
    _check("src_mass", src_mass, torch.float32, (n_src,))
    _check("chunks", lists.chunks, torch.int32, (t_cap, mc))
    _check("rows", lists.rows, torch.int32, (t_cap,))
    _check("piece_start", tiles.piece_start, torch.int32, (t_cap,))
    _check("piece_len", tiles.piece_len, torch.int32, (t_cap,))
    if lists.ids.dtype != torch.int32 or lists.ids.dim() != 1:
        raise TypeError("ids must be a 1-D int32 pool")
    if not 1 <= tiles.g <= MAX_TILE:
        raise ValueError(f"walk_tile must be in [1, {MAX_TILE}] on CUDA, got {tiles.g}")
    gid_offset = check_receivers(gid_offset, n, n_src)

    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    if table is None:  # one 16-byte row per id
        table = source_table(tree, src_pos, src_mass, params.g * params.dt)
    _check("table", table, torch.float32, (cap + 1 + n_src, 4))
    skip = (lists.bad | lists.pool_full).to(torch.int32)
    err = _library().group_eval_launch(
        pos_new.data_ptr(), table.data_ptr(), lists.ids.data_ptr(), lists.chunks.data_ptr(), mc,
        lists.rows.data_ptr(), skip.data_ptr(), tiles.piece_start.data_ptr(),
        tiles.piece_len.data_ptr(), out.data_ptr(), t_cap, tiles.g,
        cap + 1 + gid_offset, float(params.e), _device_index(device),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"group_eval kernel launch failed: cudaError_t {err}")
    LAUNCHES_EVAL += 1
    return out


def group_walk_tiles_cuda(
    pos_new: torch.Tensor,
    src_pos: torch.Tensor,
    src_mass: torch.Tensor,
    tree: TreeArrays,
    tiles: Tiles,
    params: SimParams,
    tree_params: TreeParams,
    gid_offset: int = 0,
):
    """The kernels' counterpart of ``tree_walk_group.group_walk_tiles``, CUDA
    tensors only: ((n, 3) acc*dt, tile_bad (t_cap,) bool (deferred: over
    the step budget or no room in the pool), tile_steps (t_cap,) int32,
    tile_rows (t_cap,) int32). Rows of deferred receivers are not written."""
    lists = group_walk_lists_cuda(pos_new, tree, tiles, tree_params)
    acc = group_eval_lists_cuda(pos_new, src_pos, src_mass, tree, tiles, lists, params, gid_offset)
    return acc, lists.bad | lists.pool_full, lists.steps, lists.rows


def group_tree_forces_cuda(
    pos_new: torch.Tensor,
    src_pos: torch.Tensor,
    src_mass: torch.Tensor,
    tree: TreeArrays,
    keys: torch.Tensor,
    params: SimParams,
    tree_params: TreeParams,
    gid_offset: int = 0,
    imports=None,
    recv_split: torch.Tensor | None = None,
) -> tuple[torch.Tensor, GroupWalkStats]:
    """((B, 3) acc*dt, stats) of the group walk (see
    ``tree_walk_group.group_tree_forces``).

    CUDA tensors go through the kernel, then the per-particle kernel over
    the deferred receivers; CPU tensors through the plain version; anything
    else raises. On the card the tiles come from the split levels the build
    kernels wrote: the tree's own (``tree.split``) at the receivers' sorted
    indices [gid_offset, gid_offset + B), or ``recv_split`` (B,) where the
    receivers are not the tree's bodies (the LET import walk: the receivers'
    own tree's levels). The plain version derives them from ``keys``. The
    stages carry profiler ranges (``group_tiles``; ``group_kernel`` around
    the walk kernel's ``group_walk`` and the evaluation's ``group_eval``;
    ``group_fallback``), which ``utils/profile_step.py`` reads.
    """
    _check_engine_args(imports)
    tensors = [pos_new, src_pos, src_mass, tree.nodes_f32, tree.skip, tree.first,
               tree.count, tree.num_nodes, keys]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    device = pos_new.device
    if device.type == "cpu":
        return group_tree_forces(
            pos_new, src_pos, src_mass, tree, keys, params, tree_params, gid_offset
        )
    if device.type != "cuda":
        raise ValueError(f"group_tree_forces_cuda takes CUDA or CPU tensors, got {device}")
    n = pos_new.shape[0]
    g0 = int(gid_offset)
    if recv_split is None:
        if tree.split is None:
            raise ValueError("group_tree_forces_cuda on CUDA takes the build's split levels "
                             "(tree.split or recv_split); this tree has none")
        # the receivers are sorted bodies [g0, g0 + n); a slice's first split
        # level is never read (its first receiver starts a piece anyway)
        recv_split = tree.split[g0 : g0 + n]
    with trace_scope("group_tiles"):
        tiles = tile_setup(keys, n, tree_params, split=recv_split)
    with trace_scope("group_kernel"):
        with trace_scope("group_walk"):
            lists = group_walk_lists_cuda(pos_new, tree, tiles, tree_params)
        with trace_scope("group_eval"):
            # the [node | source] table, shared with the fallback's walk
            table = source_table(tree, src_pos, src_mass, params.g * params.dt)
            acc = group_eval_lists_cuda(
                pos_new, src_pos, src_mass, tree, tiles, lists, params, gid_offset, table
            )
    with trace_scope("group_fallback"):
        bad = tiles.deferred | lists.bad[tiles.tile_id]
        full = lists.pool_full[tiles.tile_id] & ~bad
        deferred = bad | full
        self_idx = None  # receiver i is source i, unless the receivers are a later slice
        if g0:
            self_idx = torch.arange(g0, g0 + n, dtype=torch.int32, device=device)
        fallback = tree_forces_cuda(
            pos_new, src_pos, src_mass, tree, params, tree_params, active=deferred,
            self_idx=self_idx, table=table,
        )
        acc = torch.where(deferred[:, None], fallback, acc)
    return acc, GroupWalkStats(
        deferred=deferred.sum(dtype=torch.int32), pool_deferred=full.sum(dtype=torch.int32)
    )
