"""Wrappers of the hand-written group walk kernels (``csrc/tree_walk_group.cu``)
and of its tile set-up (``csrc/tile_setup.cu``).

``group_tree_forces_cuda`` has the signature of
``ops/tree_walk_group.py::group_tree_forces`` (the JAX package's
``group_tree_forces``). For CUDA tensors it launches only hand-written
kernels: the tile set-up kernels (``tile_setup_cuda``), one pack launch that
writes the walk's tables (``tree_walk_cuda.walk_tables_cuda``: the
``[node | source]`` table the evaluation reads and the per-particle walk's
records), the walk kernel (one warp per tile: the interaction lists, as ids
in a pool, and each tile's flags) with, in the same launcher call,
``group_defer_kernel`` (the list of deferred receivers, on the device), the
evaluation kernel (one CTA per tile), and the per-particle walk kernel
(``csrc/tree_walk.cu``) once over that device-side list, writing the
deferred receivers' rows into the evaluation's output in place. So a step
needs no host read, and no pass over every receiver or the whole arena
yields nothing when none is deferred. While a profiler records, the
evaluation kernel also counts the receiver-row pairs it computes
(``GroupWalkStats.eval_pairs``).
For CPU tensors it returns the plain version; every other device raises. A
CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from wgpu_n_body_tpu_torch.ops import cuda_build
from wgpu_n_body_tpu_torch.ops.tree_build import NODE_F32_COLS, TreeArrays
from wgpu_n_body_tpu_torch.ops.tree_walk_cuda import (
    _check,
    tree_forces_listed_cuda,
    walk_tables_cuda,
)
from wgpu_n_body_tpu_torch.ops.tree_walk_group import (
    LIST_CHUNK,
    GroupLists,
    GroupWalkStats,
    Tiles,
    defer_capacity,
    group_tree_forces,
    max_chunks,
    pool_chunks,
    source_table,
    step_budget,
    tile_budget,
    tile_setup,
)
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams
from wgpu_n_body_tpu_torch.utils.profiling import trace_scope, tracing

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tree_walk_group.cu"
TILE_SOURCE = _PKG / "csrc" / "tile_setup.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = list(cuda_build.BASE_FLAGS)  # the theta test rounds by intrinsics
MAX_TILE = 512  # 128 threads per evaluation CTA, at most four receivers each

#: Walk kernel launches since import (or since a caller set it to 0): one
#: per group walk.
LAUNCHES = 0
#: Evaluation kernel launches, likewise.
LAUNCHES_EVAL = 0
#: Tile set-up launches, likewise: one per ``tile_setup_cuda`` on the card,
#: whose launcher enqueues its two kernels.
LAUNCHES_TILES = 0
_lib: ctypes.CDLL | None = None
_tile_lib: ctypes.CDLL | None = None


def build() -> tuple[Path, str]:
    """Compile the kernels unless a library of this exact source exists.
    Returns (library path, compiler output); raises RuntimeError with
    nvcc's output when the build fails."""
    return cuda_build.compile_cu(SOURCE, BUILD_DIR, NVCC_FLAGS)


def build_tiles() -> tuple[Path, str]:
    """Compile the tile set-up kernels, as ``build`` does the walk's."""
    return cuda_build.compile_cu(TILE_SOURCE, BUILD_DIR, NVCC_FLAGS)


def _tile_library() -> ctypes.CDLL:
    global _tile_lib
    if _tile_lib is None:
        lib = ctypes.CDLL(str(build_tiles()[0]))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tile_setup_scratch_bytes.argtypes = [i]
        lib.tile_setup_scratch_bytes.restype = ctypes.c_longlong
        lib.tile_setup_block_items.restype = i
        lib.tile_setup_launch.argtypes = [
            p, i, i, i, i,  # split, n, depth, g, t_cap
            p, p, p, p, p, p,  # scratch, tile_id, slot, deferred, piece_start, piece_len
            i, p,  # device, stream
        ]
        lib.tile_setup_launch.restype = i
        _tile_lib = lib
    return _tile_lib


def tile_block_items() -> int:
    """Receivers per block of the tile set-up kernels (builds them first)."""
    return _tile_library().tile_setup_block_items()


#: (device index, stream handle) -> the tile kernels' scratch on that stream:
#: zero when made, each call leaves its counter at zero for the next.
_tile_scratch: dict[tuple[int, int], torch.Tensor] = {}


def tile_setup_cuda(split: torch.Tensor, n: int, tree_params: TreeParams) -> Tiles:
    """The tiles of n sorted receivers from their split levels ``split``
    (n,) uint8 (the build kernels' ``TreeArrays.split``, or a slice of it):
    ``tree_walk_group.tile_setup``'s ``Tiles``, every integer equal. CUDA
    tensors go through the kernels (two launches), CPU tensors through the
    plain version; anything else raises, as do inputs of another type, shape
    or layout."""
    global LAUNCHES_TILES
    _check("split", split, torch.uint8, (n,))
    device = split.device
    if device.type == "cpu":
        return tile_setup(None, n, tree_params, split=split)
    if device.type != "cuda":
        raise ValueError(f"tile_setup_cuda takes CUDA or CPU tensors, got {device}")
    g = tree_params.effective_walk_tile(n)
    if not 1 <= g <= MAX_TILE:
        raise ValueError(f"walk_tile must be in [1, {MAX_TILE}] on CUDA, got {g}")
    t_cap = tile_budget(n, g, tree_params.walk_block)[0]
    lib = _tile_library()
    index, stream = cuda_build.launch_target(device)
    key, size = (index, stream), lib.tile_setup_scratch_bytes(n)
    scratch = _tile_scratch.get(key)
    if scratch is None or scratch.numel() < size:
        scratch = _tile_scratch[key] = torch.zeros(size, dtype=torch.uint8, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    tiles = Tiles(
        tile_id=torch.empty(n, dtype=torch.int64, device=device), slot=torch.empty(n, **i32),
        piece_start=torch.empty(t_cap, **i32), piece_len=torch.empty(t_cap, **i32),
        deferred=torch.empty(n, dtype=torch.bool, device=device),
        t_cap=t_cap, g=g, r_cap=step_budget(tree_params.walk_list_cap),
    )
    err = lib.tile_setup_launch(
        split.data_ptr(), n, tree_params.max_depth, g, t_cap, scratch.data_ptr(),
        tiles.tile_id.data_ptr(), tiles.slot.data_ptr(), tiles.deferred.data_ptr(),
        tiles.piece_start.data_ptr(), tiles.piece_len.data_ptr(), index, stream,
    )
    if err != 0:
        del _tile_scratch[key]  # a launch that did not run leaves it unknown
        raise RuntimeError(f"tile set-up kernels' launch failed: cudaError_t {err}")
    LAUNCHES_TILES += 1
    return tiles


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.group_lists_launch.argtypes = [
            p, p, p, p, p, p,  # pos_new, nodes, skip, first, count, num_nodes
            p, p, p, p, i, i,  # piece_start, piece_len, ids, pool_next, n_chunks, chunk
            p, i, p, p, p, p,  # chunks, max_chunks, bad, steps, rows, full
            p, p, p,  # deferred, defer, defer_len
            i, i, i, i, f, i, p,  # tiles, g, r_cap, cap, theta, device, stream
        ]
        lib.group_eval_launch.argtypes = [
            p, p, p, p, i, p, p, p,  # pos_new, table, ids, chunks, max_chunks, rows, bad, full
            p, p, p,  # piece_start, piece_len, out
            i, i, i, f, p, i, p,  # tiles, g, self_base, e, pairs, device, stream
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
    them in the order their walks ask. The lists also carry the deferred
    list the kernels write besides (``GroupLists.defer``, ``defer_len``)."""
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
    _check("deferred", tiles.deferred, torch.bool, (n,))
    if not 1 <= tiles.g <= MAX_TILE:
        raise ValueError(f"walk_tile must be in [1, {MAX_TILE}] on CUDA, got {tiles.g}")
    n_chunks = pool_chunks(n)
    mc = max_chunks(tiles)

    ids = torch.empty(n_chunks * LIST_CHUNK, dtype=torch.int32, device=device)
    # the pool's next chunk, and the deferred list's length
    counters = torch.zeros(2, dtype=torch.int32, device=device)
    chunks = torch.full((tiles.t_cap, mc), -1, dtype=torch.int32, device=device)
    per_tile = torch.empty((2, tiles.t_cap), dtype=torch.int32, device=device)
    flags = torch.empty((2, tiles.t_cap), dtype=torch.bool, device=device)
    defer = torch.empty((defer_capacity(n, tiles.t_cap), 2), dtype=torch.int32, device=device)
    lists = GroupLists(ids=ids, chunks=chunks, bad=flags[0], steps=per_tile[0],
                       rows=per_tile[1], pool_full=flags[1], defer=defer,
                       defer_len=counters[1])
    err = _library().group_lists_launch(
        pos_new.data_ptr(), tree.nodes_f32.data_ptr(), tree.skip.data_ptr(),
        tree.first.data_ptr(), tree.count.data_ptr(), tree.num_nodes.data_ptr(),
        tiles.piece_start.data_ptr(), tiles.piece_len.data_ptr(), ids.data_ptr(),
        counters[0].data_ptr(), n_chunks, LIST_CHUNK, chunks.data_ptr(), mc,
        lists.bad.data_ptr(), lists.steps.data_ptr(), lists.rows.data_ptr(),
        lists.pool_full.data_ptr(), tiles.deferred.data_ptr(),
        defer.data_ptr(), lists.defer_len.data_ptr(), tiles.t_cap, tiles.g, tiles.r_cap,
        rows - 1, float(tree_params.theta), _device_index(device),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"group_lists kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return lists


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
    pairs: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """The evaluation kernel's counterpart of
    ``tree_walk_group.group_eval_lists``, CUDA tensors only: (n, 3) acc*dt;
    rows of receivers in deferred tiles are not written. ``table`` is
    ``source_table(tree, src_pos, src_mass, g * dt)`` where the caller has
    it already; otherwise it is built here. ``pairs``: a () int64 tensor on
    the device that the kernel adds the receiver-row pairs it computes to
    (``tree_walk_group.eval_pairs``' rule), or None to count nothing.
    ``out``: the (n, 3) float32 tensor to write into, or None for a new one."""
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
    _check("bad", lists.bad, torch.bool, (t_cap,))
    _check("pool_full", lists.pool_full, torch.bool, (t_cap,))
    _check("piece_start", tiles.piece_start, torch.int32, (t_cap,))
    _check("piece_len", tiles.piece_len, torch.int32, (t_cap,))
    if lists.ids.dtype != torch.int32 or lists.ids.dim() != 1:
        raise TypeError("ids must be a 1-D int32 pool")
    if not 1 <= tiles.g <= MAX_TILE:
        raise ValueError(f"walk_tile must be in [1, {MAX_TILE}] on CUDA, got {tiles.g}")
    gid_offset = check_receivers(gid_offset, n, n_src)
    if pairs is not None:
        _check("pairs", pairs, torch.int64, ())
        if pairs.device != device:
            raise ValueError(f"pairs on {pairs.device}, receivers on {device}")

    if out is None:
        out = torch.empty((n, 3), dtype=torch.float32, device=device)
    _check("out", out, torch.float32, (n, 3))
    if out.device != device:
        raise ValueError(f"out on {out.device}, receivers on {device}")
    if table is None:  # one 16-byte row per id
        table = source_table(tree, src_pos, src_mass, params.g * params.dt)
    _check("table", table, torch.float32, (cap + 1 + n_src, 4))
    err = _library().group_eval_launch(
        pos_new.data_ptr(), table.data_ptr(), lists.ids.data_ptr(), lists.chunks.data_ptr(), mc,
        lists.rows.data_ptr(), lists.bad.data_ptr(), lists.pool_full.data_ptr(),
        tiles.piece_start.data_ptr(), tiles.piece_len.data_ptr(), out.data_ptr(), t_cap, tiles.g,
        cap + 1 + gid_offset, float(params.e), None if pairs is None else pairs.data_ptr(),
        _device_index(device), torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"group_eval kernel launch failed: cudaError_t {err}")
    LAUNCHES_EVAL += 1
    return out


def group_tree_forces_cuda(
    pos_new: torch.Tensor,
    src_pos: torch.Tensor,
    src_mass: torch.Tensor,
    tree: TreeArrays,
    keys: torch.Tensor,
    params: SimParams,
    tree_params: TreeParams,
    gid_offset: int = 0,
    tiles: Tiles | None = None,
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, GroupWalkStats]:
    """((B, 3) acc*dt, stats) of the group walk (see
    ``tree_walk_group.group_tree_forces``).

    CUDA tensors go through the kernels, then the per-particle kernel over
    the list of deferred receivers the walk kernels wrote; CPU tensors
    through the plain version; anything else raises. ``tiles``: the
    receivers' tiles where the caller has made them (``tile_setup_cuda``,
    with r_cap from this walk's walk_list_cap): the LET step's two walks
    share one set, and the import walk, whose receivers are not the tree's
    bodies, needs them. Otherwise, on the card, the tile kernels make them
    from the split levels the build kernels wrote (``tree.split``) at the
    receivers' sorted indices [gid_offset, gid_offset + B); the plain
    version derives them from ``keys``. Under a profiler the stages show as
    ranges (``group_tiles``; ``group_tables``, the pack launch;
    ``group_kernel`` around the walk kernel's ``group_walk`` and the
    evaluation's ``group_eval``; ``group_fallback``, the per-particle
    kernel over the list), which ``utils/profile_step.py`` reads. ``stats``
    holds the tiles and the lists: its masks and counts are built only when
    a caller reads them. While a profiler records, ``stats.eval_pairs``
    holds the evaluation kernel's count of the pairs it computed; otherwise
    (a capture included) it is None and nothing is counted. ``out``: the
    (B, 3) float32 tensor the forces are written into, or None for a new
    one.
    """
    tensors = [pos_new, src_pos, src_mass, tree.nodes_f32, tree.skip, tree.first,
               tree.count, tree.num_nodes, keys]
    if tiles is not None:
        tensors += [tiles.tile_id, tiles.slot, tiles.piece_start, tiles.piece_len, tiles.deferred]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    device = pos_new.device
    n = pos_new.shape[0]
    if tiles is not None and tiles.tile_id.shape != (n,):
        raise ValueError(f"tiles of {tiles.tile_id.shape[0]} receivers for {n} receivers")
    if device.type == "cpu":
        acc, stats = group_tree_forces(
            pos_new, src_pos, src_mass, tree, keys, params, tree_params, gid_offset, tiles=tiles
        )
        return (acc, stats) if out is None else (out.copy_(acc), stats)
    if device.type != "cuda":
        raise ValueError(f"group_tree_forces_cuda takes CUDA or CPU tensors, got {device}")
    g0 = check_receivers(gid_offset, n, src_pos.shape[0])
    if tiles is None:
        if tree.split is None:
            raise ValueError("group_tree_forces_cuda on CUDA takes the build's split levels "
                             "(tree.split) or the receivers' tiles; this call has neither")
        with trace_scope("group_tiles"):
            # the receivers are sorted bodies [g0, g0 + n); a slice's first split
            # level is never read (its first receiver starts a piece anyway)
            tiles = tile_setup_cuda(tree.split[g0 : g0 + n], n, tree_params)
    with trace_scope("group_tables"):
        # the [node | source] table, and the fallback walk's records
        rec, table = walk_tables_cuda(tree, src_pos, src_mass, params)
    with trace_scope("group_kernel"):
        with trace_scope("group_walk"):
            lists = group_walk_lists_cuda(pos_new, tree, tiles, tree_params)
        with trace_scope("group_eval"):
            pairs = torch.zeros((), dtype=torch.int64, device=device) if tracing() else None
            acc = group_eval_lists_cuda(
                pos_new, src_pos, src_mass, tree, tiles, lists, params, g0, table, pairs, out
            )
    with trace_scope("group_fallback"):
        # receiver i is source g0 + i: a later slice of the sources, or none
        tree_forces_listed_cuda(pos_new, rec, table, tree, lists.defer, lists.defer_len, g0,
                                params, tree_params, out=acc)
    return acc, GroupWalkStats(tiles, lists, pairs)
