"""Wrapper of the hand-written per-particle walk kernel (``csrc/tree_walk.cu``).

``tree_forces_cuda`` has the signature of ``ops/tree_walk.py::tree_forces``
(the JAX package's ``tree_forces``), plus ``table``: a caller that already
holds the ``[node | source]`` table of this tree and these sources
(``ops/tree_walk_group.py::source_table``, as the group walk does) hands it
over and the walk reads its source rows; otherwise the pack kernel writes
them. For CUDA tensors it launches the pack kernel (the arena as one 32-byte
record per node) and then the walk, one warp per 32 consecutive receivers;
for CPU tensors it returns the plain version; every other device raises. A
CUDA tensor never falls back to the plain version.

The kernel is built like the other kernels (``ops/cuda_build.py``), with
their flags: its theta test rounds as the plain version by intrinsics that
nvcc never contracts, so the file needs no ``-fmad=false``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from wgpu_n_body_tpu_torch.ops import cuda_build
from wgpu_n_body_tpu_torch.ops.tree_build import NODE_F32_COLS, TreeArrays
from wgpu_n_body_tpu_torch.ops.tree_walk import tree_forces
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tree_walk.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = list(cuda_build.BASE_FLAGS)  # the theta test rounds by intrinsics

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
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tree_walk_pack_launch.argtypes = [
            p, p, p, p, p, i, f,  # nodes, skip, first, count, rec, rows, gdt
            p, p, p, i, i, p,  # src_pos, src_mass, src, n, device, stream
        ]
        lib.tree_walk_launch.argtypes = [
            p, p, p, p, p, p, p, p,  # pos_new, rec, src, num_nodes, self_idx, active, out, counts
            i, i, i, f, f, i, p,  # b, n, rows, theta, e, device, stream
        ]
        lib.tree_walk_pack_launch.restype = lib.tree_walk_launch.restype = i
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def tree_forces_cuda(
    pos_new: torch.Tensor,
    src_pos: torch.Tensor,
    src_mass: torch.Tensor,
    tree: TreeArrays,
    params: SimParams,
    tree_params: TreeParams,
    active: torch.Tensor | None = None,
    self_idx: torch.Tensor | None = None,
    table: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, 3) acc*dt of receivers ``pos_new`` from the tree over the
    sorted sources ``src_pos``/``src_mass`` (see ``tree_walk.tree_forces``).

    CUDA tensors go through the kernel; CPU tensors through the plain
    version; anything else raises. ``table`` (CUDA only) is
    ``tree_walk_group.source_table(tree, src_pos, src_mass, g * dt)`` where
    the caller has it already: its source rows are read in place.
    """
    if pos_new.device.type == "cpu":
        _one_device(pos_new, src_pos, src_mass, tree, active, self_idx)
        return tree_forces(
            pos_new, src_pos, src_mass, tree, params, tree_params, active, self_idx
        )
    return _launch(pos_new, src_pos, src_mass, tree, params, tree_params, active, self_idx,
                   table, None)


def tree_forces_counts_cuda(
    pos_new: torch.Tensor,
    src_pos: torch.Tensor,
    src_mass: torch.Tensor,
    tree: TreeArrays,
    params: SimParams,
    tree_params: TreeParams,
    active: torch.Tensor | None = None,
    self_idx: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's counting instantiation, CUDA tensors only: ((B, 3)
    acc*dt, (B, 4) int32 per receiver: nodes accepted, members summed,
    visits at which the receiver was live, visits of its warp). For
    ``chip_smoke.py`` and ``utils/tree_walk_study.py``; no step calls it."""
    b = pos_new.shape[0]
    counts = torch.zeros((b, 4), dtype=torch.int32, device=pos_new.device)
    out = _launch(pos_new, src_pos, src_mass, tree, params, tree_params, active, self_idx,
                  None, counts)
    return out, counts


def _one_device(pos_new, src_pos, src_mass, tree, *optional) -> None:
    tensors = [pos_new, src_pos, src_mass, tree.nodes_f32, tree.skip, tree.first,
               tree.count, tree.num_nodes]
    tensors += [t for t in optional if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")


def _launch(pos_new, src_pos, src_mass, tree, params, tree_params, active, self_idx, table,
            counts) -> torch.Tensor:
    global LAUNCHES
    _one_device(pos_new, src_pos, src_mass, tree, active, self_idx, table)
    device = pos_new.device
    if device.type != "cuda":
        raise ValueError(f"tree_forces_cuda takes CUDA or CPU tensors, got {device}")
    b, n = pos_new.shape[0], src_pos.shape[0]
    rows = tree.nodes_f32.shape[0]
    _check("pos_new", pos_new, torch.float32, (b, 3))
    _check("src_pos", src_pos, torch.float32, (n, 3))
    _check("src_mass", src_mass, torch.float32, (n,))
    _check("nodes_f32", tree.nodes_f32, torch.float32, (rows, NODE_F32_COLS))
    for name in ("skip", "first", "count"):
        _check(name, getattr(tree, name), torch.int32, (rows,))
    _check("num_nodes", tree.num_nodes, torch.int32, ())
    if self_idx is not None:  # None: receiver i is source i, the kernel's default
        _check("self_idx", self_idx, torch.int32, (b,))
    if active is not None:
        _check("active", active, torch.bool, (b,))
    if rows < 1 or rows + n >= 2**31 or n >= 2**29:
        raise ValueError(f"the arena's {rows} rows and the {n} sources do not fit the kernel")

    out = torch.empty((b, 3), dtype=torch.float32, device=device)
    if b == 0:
        return out
    # the arena as one 32-byte record per node; the sources as (position,
    # mass * g * dt) rows, the table's where the caller has them
    rec = torch.empty((rows, NODE_F32_COLS), dtype=torch.float32, device=device)
    if table is None:
        src = torch.empty((n, 4), dtype=torch.float32, device=device)
        src_ptr, packed_src = src.data_ptr(), src.data_ptr()
    else:
        _check("table", table, torch.float32, (rows + n, 4))
        src_ptr, packed_src = table.data_ptr() + rows * 16, None
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _library()
    err = lib.tree_walk_pack_launch(
        tree.nodes_f32.data_ptr(), tree.skip.data_ptr(), tree.first.data_ptr(),
        tree.count.data_ptr(), rec.data_ptr(), rows, float(params.g * params.dt),
        src_pos.data_ptr(), src_mass.data_ptr(), packed_src, n, index, stream,
    )
    if err != 0:
        raise RuntimeError(f"tree_walk pack kernel launch failed: cudaError_t {err}")
    err = lib.tree_walk_launch(
        pos_new.data_ptr(), rec.data_ptr(), src_ptr, tree.num_nodes.data_ptr(),
        self_idx.data_ptr() if self_idx is not None else None,
        active.data_ptr() if active is not None else None,
        out.data_ptr(), counts.data_ptr() if counts is not None else None,
        b, n, rows, float(tree_params.theta), float(params.e), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"tree_walk kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out
