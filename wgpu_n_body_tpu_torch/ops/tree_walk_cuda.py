"""Wrapper of the hand-written per-particle walk kernel (``csrc/tree_walk.cu``).

``tree_forces_cuda`` has the signature of ``ops/tree_walk.py::tree_forces``
(the JAX package's ``tree_forces``). For CUDA tensors it launches the pack
kernel (the arena as one 32-byte record per node, and the sources as rows of
position and mass * g * dt) and then the walk, one warp per 32 consecutive
receivers; for CPU tensors it returns the plain version; every other device
raises. A CUDA tensor never falls back to the plain version. Under a profiler
the two launches are in the ranges ``pp_pack`` and ``pp_walk``.

The group walk (``ops/tree_walk_group_cuda.py``) takes the two launches
apart: ``walk_tables_cuda`` is one pack launch that writes the records and
the whole ``[node | source]`` table (``ops/tree_walk_group.py::
source_table``), whose source rows the walk reads, and
``tree_forces_listed_cuda`` walks only the receivers of a device list of
warps, writing their rows into the caller's output in place. CUDA tensors
only.

The kernel is built like the other kernels (``ops/cuda_build.py``), with
their flags: its theta test rounds as the plain version by intrinsics that
nvcc never contracts, so the file needs no ``-fmad=false``.
"""

from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path

import torch

from wgpu_n_body_tpu_torch.ops import cuda_build
from wgpu_n_body_tpu_torch.ops.tree_build import NODE_F32_COLS, TreeArrays
from wgpu_n_body_tpu_torch.ops.tree_walk import tree_forces
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams
from wgpu_n_body_tpu_torch.utils.profiling import trace_scope

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tree_walk.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = list(cuda_build.BASE_FLAGS)  # the theta test rounds by intrinsics

#: Walk launches since import (or since a caller set it to 0): one per
#: ``tree_forces_cuda`` (whose pack launch goes with it) or
#: ``tree_forces_listed_cuda`` call on the card; the counting instantiation
#: (``tree_forces_counts_cuda``) is not counted.
LAUNCHES = 0
#: ``walk_tables_cuda`` launches (the pack kernel writing the group walk's
#: tables), likewise.
LAUNCHES_TABLES = 0
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
            p, p, p, p, p, p, i, f,  # nodes, skip, first, count, rec, tab, rows, gdt
            p, p, p, i, i, p,  # src_pos, src_mass, src, n, device, stream
        ]
        lib.tree_walk_launch.argtypes = [
            p, p, p, p, p, p, p, p,  # pos_new, rec, src, num_nodes, self_idx, active, out, counts
            i, i, i, f, f, i, p,  # b, n, rows, theta, e, device, stream
        ]
        lib.tree_walk_list_launch.argtypes = [
            p, p, p, p, p, p, i, i,  # pos_new, rec, src, num_nodes, warps, n_warps, capacity, self_base
            p, i, i, i, f, f, i, p,  # out, b, n, rows, theta, e, device, stream
        ]
        for fn in (lib.tree_walk_pack_launch, lib.tree_walk_launch, lib.tree_walk_list_launch):
            fn.restype = i
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
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, 3) acc*dt of receivers ``pos_new`` from the tree over the
    sorted sources ``src_pos``/``src_mass`` (see ``tree_walk.tree_forces``),
    written into ``out`` where it is given.

    CUDA tensors go through the kernel; CPU tensors through the plain
    version; anything else raises.
    """
    if pos_new.device.type == "cpu":
        _one_device(tree, pos_new, src_pos, src_mass, active, self_idx)
        acc = tree_forces(
            pos_new, src_pos, src_mass, tree, params, tree_params, active, self_idx
        )
        return acc if out is None else out.copy_(acc)
    return _launch(pos_new, src_pos, src_mass, tree, params, tree_params, active, self_idx,
                   None, out)


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
    visits at which the receiver was live, visits of its warp), by the rule
    of ``tree_walk.py::warp_walk_counts``. For ``chip_smoke.py``,
    ``utils/tree_walk_study.py`` and the counters of a traced per-particle
    step (``models/tree.py``); it counts in no ``LAUNCHES`` and opens no
    profiler range."""
    b = pos_new.shape[0]
    counts = torch.zeros((b, 4), dtype=torch.int32, device=pos_new.device)
    out = _launch(pos_new, src_pos, src_mass, tree, params, tree_params, active, self_idx,
                  counts)
    return out, counts


def _one_device(tree, *tensors) -> None:
    """Raise unless the tree's arrays and the given tensors (None skipped)
    lie on one device."""
    found = [tree.nodes_f32, tree.skip, tree.first, tree.count, tree.num_nodes]
    found += [t for t in tensors if t is not None]
    devices = {t.device for t in found}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")


def _check_arena(tree, src_pos, src_mass) -> tuple[int, int]:
    """(arena rows, sources) of a tree and its sorted sources, checked."""
    rows, n = tree.nodes_f32.shape[0], src_pos.shape[0]
    _check("src_pos", src_pos, torch.float32, (n, 3))
    _check("src_mass", src_mass, torch.float32, (n,))
    _check("nodes_f32", tree.nodes_f32, torch.float32, (rows, NODE_F32_COLS))
    for name in ("skip", "first", "count"):
        _check(name, getattr(tree, name), torch.int32, (rows,))
    _check("num_nodes", tree.num_nodes, torch.int32, ())
    if rows < 1 or rows + n >= 2**31 or n >= 2**29:
        raise ValueError(f"the arena's {rows} rows and the {n} sources do not fit the kernel")
    return rows, n


def _target(device: torch.device) -> tuple[int, int]:
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def _pack(tree, src_pos, src_mass, gdt: float, rec, tab, src) -> None:
    """One pack launch: the records into ``rec``, the table's node rows into
    ``tab`` and the source rows into ``src`` (either may be None)."""
    err = _library().tree_walk_pack_launch(
        tree.nodes_f32.data_ptr(), tree.skip.data_ptr(), tree.first.data_ptr(),
        tree.count.data_ptr(), rec.data_ptr(), None if tab is None else tab.data_ptr(),
        rec.shape[0], gdt, src_pos.data_ptr(), src_mass.data_ptr(),
        None if src is None else src.data_ptr(), src_pos.shape[0], *_target(rec.device),
    )
    if err != 0:
        raise RuntimeError(f"tree_walk pack kernel launch failed: cudaError_t {err}")


def walk_tables_cuda(
    tree: TreeArrays, src_pos: torch.Tensor, src_mass: torch.Tensor, params: SimParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """(records, table) of the group walk, in one pack launch over the arena
    and the sources: the walk's (rows, 8) float32 records and the (rows + N,
    4) float32 ``[node | source]`` table, ``torch.equal`` to
    ``tree_walk_group.source_table(tree, src_pos, src_mass, g * dt)``. CUDA
    tensors only."""
    global LAUNCHES_TABLES
    _one_device(tree, src_pos, src_mass)
    device = src_pos.device
    if device.type != "cuda":
        raise ValueError(f"walk_tables_cuda takes CUDA tensors, got {device}")
    rows, n = _check_arena(tree, src_pos, src_mass)
    rec = torch.empty((rows, NODE_F32_COLS), dtype=torch.float32, device=device)
    table = torch.empty((rows + n, 4), dtype=torch.float32, device=device)
    _pack(tree, src_pos, src_mass, float(params.g * params.dt), rec, table, table[rows:])
    LAUNCHES_TABLES += 1
    return rec, table


def tree_forces_listed_cuda(
    pos_new: torch.Tensor,
    rec: torch.Tensor,
    table: torch.Tensor,
    tree: TreeArrays,
    warps: torch.Tensor,
    n_warps: torch.Tensor,
    self_base: int,
    params: SimParams,
    tree_params: TreeParams,
    out: torch.Tensor,
) -> torch.Tensor:
    """The walk of the receivers a device list names, written into ``out``
    in place (the other rows are left as they are); returns ``out``. CUDA
    tensors only.

    ``warps`` is (capacity, 2) int32, entry w (first receiver, lane mask):
    lane l walks receiver first + l where bit l is set; the () int32
    ``n_warps`` on the device says how many are live (the group walk's lists
    kernel writes both). Receiver i is source ``self_base + i`` (past the
    sources: none). ``rec`` and ``table`` are ``walk_tables_cuda``'s of this
    tree and sources. One launch of the per-particle walk kernel, whatever
    the count: its grid covers the capacity, and warps past the count return
    at once; each row is computed as ``tree_forces_cuda`` computes it."""
    global LAUNCHES
    device = pos_new.device
    if device.type != "cuda":
        raise ValueError(f"tree_forces_listed_cuda takes CUDA tensors, got {device}")
    _one_device(tree, pos_new, rec, table, warps, n_warps, out)
    b, rows = pos_new.shape[0], tree.nodes_f32.shape[0]
    n = table.shape[0] - rows
    _check("pos_new", pos_new, torch.float32, (b, 3))
    _check("out", out, torch.float32, (b, 3))
    _check("rec", rec, torch.float32, (rows, NODE_F32_COLS))
    _check("table", table, torch.float32, (rows + n, 4))
    _check("warps", warps, torch.int32, (warps.shape[0], 2))
    _check("n_warps", n_warps, torch.int32, ())
    _check("num_nodes", tree.num_nodes, torch.int32, ())
    err = _library().tree_walk_list_launch(
        pos_new.data_ptr(), rec.data_ptr(), table.data_ptr() + rows * 16,
        tree.num_nodes.data_ptr(), warps.data_ptr(), n_warps.data_ptr(), warps.shape[0],
        int(self_base), out.data_ptr(), b, n, rows, float(tree_params.theta), float(params.e),
        *_target(device),
    )
    if err != 0:
        raise RuntimeError(f"tree_walk list kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def _launch(pos_new, src_pos, src_mass, tree, params, tree_params, active, self_idx,
            counts, out=None) -> torch.Tensor:
    """The pack launch, then the walk over receivers [0, b), into ``out``
    (a new tensor where it is None). Without ``counts`` (a step's walk) the
    two are in the profiler ranges ``pp_pack`` and ``pp_walk`` and count in
    ``LAUNCHES``; the counting instantiation is neither traced nor
    counted."""
    global LAUNCHES
    walk = counts is None
    _one_device(tree, pos_new, src_pos, src_mass, active, self_idx)
    device = pos_new.device
    if device.type != "cuda":
        raise ValueError(f"tree_forces_cuda takes CUDA or CPU tensors, got {device}")
    b = pos_new.shape[0]
    _check("pos_new", pos_new, torch.float32, (b, 3))
    rows, n = _check_arena(tree, src_pos, src_mass)
    if self_idx is not None:  # None: receiver i is source i, the kernel's default
        _check("self_idx", self_idx, torch.int32, (b,))
    if active is not None:
        _check("active", active, torch.bool, (b,))

    if out is None:
        out = torch.empty((b, 3), dtype=torch.float32, device=device)
    _check("out", out, torch.float32, (b, 3))
    _one_device(tree, out)
    if b == 0:
        return out
    # the arena as one 32-byte record per node; the sources as (position,
    # mass * g * dt) rows
    rec = torch.empty((rows, NODE_F32_COLS), dtype=torch.float32, device=device)
    src = torch.empty((n, 4), dtype=torch.float32, device=device)
    with trace_scope("pp_pack") if walk else contextlib.nullcontext():
        _pack(tree, src_pos, src_mass, float(params.g * params.dt), rec, None, src)
    with trace_scope("pp_walk") if walk else contextlib.nullcontext():
        err = _library().tree_walk_launch(
            pos_new.data_ptr(), rec.data_ptr(), src.data_ptr(), tree.num_nodes.data_ptr(),
            self_idx.data_ptr() if self_idx is not None else None,
            active.data_ptr() if active is not None else None,
            out.data_ptr(), counts.data_ptr() if counts is not None else None,
            b, n, rows, float(tree_params.theta), float(params.e), *_target(device),
        )
    if err != 0:
        raise RuntimeError(f"tree_walk kernel launch failed: cudaError_t {err}")
    if walk:
        LAUNCHES += 1
    return out
