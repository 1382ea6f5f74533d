"""Wrapper of the hand-written per-particle walk kernel (``csrc/tree_walk.cu``).

``tree_forces_cuda`` has the signature of ``ops/tree_walk.py::tree_forces``
(the JAX package's ``tree_forces``). For CUDA tensors it launches the
kernel, one thread per receiver; for CPU tensors it returns the plain
version; every other device raises. A CUDA tensor never falls back to the
plain version.

The kernel is built like the all-pairs kernels (``ops/cuda_build.py``),
plus ``-fmad=false``: the walk's theta test must see the plain version's
rounding, not a fused multiply-add's (see the source's note).
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
NVCC_FLAGS = [*cuda_build.BASE_FLAGS, "-fmad=false"]
BLOCK = 128  # threads per block: 4 warps, many blocks per SM

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
        fn = lib.tree_walk_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # pos_new, src
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # nodes, skip, first, count
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # num_nodes, self_idx, active
            ctypes.c_void_p, ctypes.c_int,  # out, b
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,  # theta, gdt, e, bucket
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # block, device, stream
        ]
        fn.restype = ctypes.c_int
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
) -> torch.Tensor:
    """(B, 3) acc*dt of receivers ``pos_new`` from the tree over the
    sorted sources ``src_pos``/``src_mass`` (see ``tree_walk.tree_forces``).

    CUDA tensors go through the kernel; CPU tensors through the plain
    version; anything else raises.
    """
    global LAUNCHES
    tensors = [pos_new, src_pos, src_mass, tree.nodes_f32, tree.skip, tree.first,
               tree.count, tree.num_nodes]
    tensors += [t for t in (active, self_idx) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    device = pos_new.device
    if device.type == "cpu":
        return tree_forces(
            pos_new, src_pos, src_mass, tree, params, tree_params, active, self_idx
        )
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
    if self_idx is None:
        self_idx = torch.arange(b, dtype=torch.int32, device=device)
    _check("self_idx", self_idx, torch.int32, (b,))
    if active is not None:
        _check("active", active, torch.bool, (b,))
    bucket = tree_params.leaf_bucket
    if not isinstance(bucket, int) or bucket < 1:
        raise ValueError(f"leaf_bucket must be an int >= 1, got {bucket!r}")

    out = torch.empty((b, 3), dtype=torch.float32, device=device)
    if b == 0:
        return out
    src = torch.cat([src_pos, src_mass[:, None]], 1)  # (n, 4): one 16-byte load
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _library().tree_walk_launch(
        pos_new.data_ptr(), src.data_ptr(),
        tree.nodes_f32.data_ptr(), tree.skip.data_ptr(), tree.first.data_ptr(),
        tree.count.data_ptr(), tree.num_nodes.data_ptr(), self_idx.data_ptr(),
        active.data_ptr() if active is not None else None,
        out.data_ptr(), b,
        float(tree_params.theta), float(params.g * params.dt), float(params.e), bucket,
        BLOCK,
        device.index if device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"tree_walk kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out
