"""Wrapper of the hand-written group walk kernel (``csrc/tree_walk_group.cu``).

``group_tree_forces_cuda`` has the signature of
``ops/tree_walk_group.py::group_tree_forces`` (the JAX package's
``group_tree_forces``). For CUDA tensors it builds the tiles with torch ops,
launches the kernel once (one CTA per tile, phases A and B fused) and then
the per-particle walk kernel (``csrc/tree_walk.cu``) once over the deferred
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
    GroupWalkStats,
    Tiles,
    _check_engine_args,
    group_tree_forces,
    tile_setup,
)
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams
from wgpu_n_body_tpu_torch.utils.profiling import trace_scope

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tree_walk_group.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = list(cuda_build.BASE_FLAGS)  # the theta test rounds by intrinsics
MAX_TILE = 512  # 128 threads per CTA, at most four receivers each

#: Kernel launches since import (or since a caller set it to 0).
LAUNCHES = 0
_lib: ctypes.CDLL | None = None


def build() -> tuple[Path, str]:
    """Compile the kernel unless a library of this exact source exists.
    Returns (library path, compiler output); raises RuntimeError with
    nvcc's output when the build fails."""
    return cuda_build.compile_cu(SOURCE, BUILD_DIR, NVCC_FLAGS)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        fn = lib.tree_walk_group_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # pos_new, src
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # nodes, skip, first, count
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # num_nodes, piece_start, piece_len
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out, bad, steps, rows
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # tiles, g, r_cap, gid_offset
            ctypes.c_float, ctypes.c_float, ctypes.c_float,  # theta, gdt, e
            ctypes.c_int, ctypes.c_void_p,  # device, stream
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    """The kernel's counterpart of ``tree_walk_group.group_walk_tiles``, CUDA
    tensors only: ((n, 3) acc*dt, tile_bad (t_cap,) bool, tile_steps
    (t_cap,) int32, tile_rows (t_cap,) int32). Rows of deferred receivers
    are not written."""
    global LAUNCHES
    device = pos_new.device
    if device.type != "cuda":
        raise ValueError(f"group_walk_tiles_cuda takes CUDA tensors, got {device}")
    n, n_src = pos_new.shape[0], src_pos.shape[0]
    rows = tree.nodes_f32.shape[0]
    _check("pos_new", pos_new, torch.float32, (n, 3))
    _check("src_pos", src_pos, torch.float32, (n_src, 3))
    _check("src_mass", src_mass, torch.float32, (n_src,))
    _check("nodes_f32", tree.nodes_f32, torch.float32, (rows, NODE_F32_COLS))
    for name in ("skip", "first", "count"):
        _check(name, getattr(tree, name), torch.int32, (rows,))
    _check("num_nodes", tree.num_nodes, torch.int32, ())
    _check("piece_start", tiles.piece_start, torch.int32, (tiles.t_cap,))
    _check("piece_len", tiles.piece_len, torch.int32, (tiles.t_cap,))
    if not 1 <= tiles.g <= MAX_TILE:
        raise ValueError(f"walk_tile must be in [1, {MAX_TILE}] on CUDA, got {tiles.g}")
    gid_offset = int(gid_offset)
    if gid_offset < 0 or gid_offset + n > n_src:
        raise ValueError(f"receivers [{gid_offset}, {gid_offset + n}) are not in the {n_src} sources")

    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    per_tile = torch.empty((3, tiles.t_cap), dtype=torch.int32, device=device)
    src = torch.cat([src_pos, src_mass[:, None]], 1)  # (n, 4): one 16-byte load
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().tree_walk_group_launch(
        pos_new.data_ptr(), src.data_ptr(),
        tree.nodes_f32.data_ptr(), tree.skip.data_ptr(), tree.first.data_ptr(),
        tree.count.data_ptr(), tree.num_nodes.data_ptr(),
        tiles.piece_start.data_ptr(), tiles.piece_len.data_ptr(),
        out.data_ptr(), per_tile[0].data_ptr(), per_tile[1].data_ptr(), per_tile[2].data_ptr(),
        tiles.t_cap, tiles.g, tiles.r_cap, gid_offset,
        float(tree_params.theta), float(params.g * params.dt), float(params.e),
        device.index if device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"tree_walk_group kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out, per_tile[0] != 0, per_tile[1], per_tile[2]


def group_tree_forces_cuda(
    pos_new: torch.Tensor,
    src_pos: torch.Tensor,
    src_mass: torch.Tensor,
    tree: TreeArrays,
    keys: tuple[torch.Tensor, torch.Tensor],
    params: SimParams,
    tree_params: TreeParams,
    gid_offset: int = 0,
    imports=None,
) -> tuple[torch.Tensor, GroupWalkStats]:
    """((B, 3) acc*dt, stats) of the group walk (see
    ``tree_walk_group.group_tree_forces``).

    CUDA tensors go through the kernel, then the per-particle kernel over
    the deferred receivers; CPU tensors through the plain version; anything
    else raises. The three stages carry profiler ranges (``group_tiles``,
    ``group_kernel``, ``group_fallback``), which ``utils/profile_step.py``
    reads.
    """
    _check_engine_args(imports)
    tensors = [pos_new, src_pos, src_mass, tree.nodes_f32, tree.skip, tree.first,
               tree.count, tree.num_nodes, *keys]
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
    with trace_scope("group_tiles"):
        tiles = tile_setup(keys, n, tree_params)
    with trace_scope("group_kernel"):
        acc, tile_bad, _, _ = group_walk_tiles_cuda(
            pos_new, src_pos, src_mass, tree, tiles, params, tree_params, gid_offset
        )
    with trace_scope("group_fallback"):
        deferred = tiles.deferred | tile_bad[tiles.tile_id]
        self_idx = torch.arange(
            int(gid_offset), int(gid_offset) + n, dtype=torch.int32, device=device
        )
        fallback = tree_forces_cuda(
            pos_new, src_pos, src_mass, tree, params, tree_params, active=deferred,
            self_idx=self_idx,
        )
        acc = torch.where(deferred[:, None], fallback, acc)
    return acc, GroupWalkStats(deferred=deferred.sum(dtype=torch.int32))
