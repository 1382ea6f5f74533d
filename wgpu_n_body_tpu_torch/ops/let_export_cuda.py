"""Wrapper of the hand-written LET export kernels (``csrc/let_export.cu``).

``export_walk_cuda`` has the signature of ``ops/let_export.py::export_walk``
(the JAX package's ``parallel/let_tree.py::export_walk``). For CUDA tensors
it launches the classify kernel, CUB's max scan, the size kernel, CUB's sum
scan, the emission and the tail kernel, all on the current stream with no
host read; for CPU tensors it returns the plain version; every other device
raises. A CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from wgpu_n_body_tpu_torch.ops import cuda_build
from wgpu_n_body_tpu_torch.ops.let_export import LetExport, check_let_cap, export_walk
from wgpu_n_body_tpu_torch.ops.tree_build import NODE_F32_COLS, TreeArrays
from wgpu_n_body_tpu_torch.ops.tree_walk_cuda import _check

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "let_export.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = list(cuda_build.BASE_FLAGS)  # the theta test rounds by intrinsics

#: Export launches since import (or since a caller set it to 0): one per
#: call, whose launcher enqueues four kernels and CUB's two scans.
LAUNCHES = 0
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
        lib.let_export_temp_bytes.argtypes = [i, i, ctypes.POINTER(ctypes.c_size_t)]
        lib.let_export_temp_bytes.restype = i
        lib.let_export_launch.argtypes = [
            p, p, p, p, p, i,  # nodes, skip, first, count, num_nodes, rows
            p, p, p, p, i, i, f, i,  # src_pos, src_mass, box_lo, box_hi, p, self, theta, r_cap
            p, p, p, p, ctypes.c_size_t,  # kind, scan_a, scan_b, temp, temp_bytes
            p, p, p, p, p, p, p,  # out nodes, skip, first, count, parts, n_rows, overflow
            i, p,  # device, stream
        ]
        lib.let_export_launch.restype = i
        _lib = lib
    return _lib


def export_walk_cuda(
    tree: TreeArrays,
    src_pos: torch.Tensor,
    src_mass: torch.Tensor,
    bbox_lo: torch.Tensor,
    bbox_hi: torch.Tensor,
    self_index: int,
    theta: float,
    r_cap: int,
) -> LetExport:
    """The LET export of ``tree`` to each of the P boxes ``bbox_lo/hi``
    (P, 3) (see ``let_export.export_walk``). CUDA tensors go through the
    kernels, CPU tensors through the plain version; anything else raises,
    as do inputs of another type, shape or layout than the kernels take."""
    global LAUNCHES
    check_let_cap(r_cap)
    tensors = [tree.nodes_f32, tree.skip, tree.first, tree.count, tree.num_nodes,
               src_pos, src_mass, bbox_lo, bbox_hi]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    device = src_pos.device
    p = bbox_lo.shape[0] if bbox_lo.dim() == 2 else -1
    n = src_pos.shape[0] if src_pos.dim() == 2 else -1
    rows = tree.nodes_f32.shape[0]
    _check("bbox_lo", bbox_lo, torch.float32, (p, 3))
    _check("bbox_hi", bbox_hi, torch.float32, (p, 3))
    _check("src_pos", src_pos, torch.float32, (n, 3))
    _check("src_mass", src_mass, torch.float32, (n,))
    _check("nodes_f32", tree.nodes_f32, torch.float32, (rows, NODE_F32_COLS))
    for name in ("skip", "first", "count"):
        _check(name, getattr(tree, name), torch.int32, (rows,))
    _check("num_nodes", tree.num_nodes, torch.int32, ())
    self_index = int(self_index)
    if not 0 <= self_index < p:
        raise ValueError(f"self_index must be in [0, {p}), got {self_index}")
    if device.type == "cpu":
        return export_walk(tree, src_pos, src_mass, bbox_lo, bbox_hi, self_index, theta, r_cap)
    if device.type != "cuda":
        raise ValueError(f"export_walk_cuda takes CUDA or CPU tensors, got {device}")
    stride = rows + 1
    if p * (stride + 1 + n) >= 2**31:  # the scans' int32 values
        raise ValueError(f"{p} destinations of {rows} arena rows and {n} sources do not fit "
                         "the kernels' int32 scans")

    lib = _library()
    index, stream = cuda_build.launch_target(device)
    temp_bytes = ctypes.c_size_t(0)
    err = lib.let_export_temp_bytes(p * stride, index, ctypes.byref(temp_bytes))
    if err != 0:
        raise RuntimeError(f"the export scans' scratch query failed: cudaError_t {err}")
    kind = torch.empty(p * stride, dtype=torch.uint8, device=device)
    scan_a = torch.empty(p * stride, dtype=torch.int32, device=device)
    scan_b = torch.empty(p * stride, dtype=torch.int32, device=device)
    temp = torch.empty(max(temp_bytes.value, 1), dtype=torch.uint8, device=device)
    out = LetExport(
        nodes=torch.empty((p, r_cap, NODE_F32_COLS), dtype=torch.float32, device=device),
        skip=torch.empty((p, r_cap), dtype=torch.int32, device=device),
        first=torch.empty((p, r_cap), dtype=torch.int32, device=device),
        count=torch.empty((p, r_cap), dtype=torch.int32, device=device),
        parts=torch.empty((p, r_cap, 4), dtype=torch.float32, device=device),
        n_rows=torch.empty(p, dtype=torch.int32, device=device),
        overflow=torch.empty(p, dtype=torch.bool, device=device),
    )
    err = lib.let_export_launch(
        tree.nodes_f32.data_ptr(), tree.skip.data_ptr(), tree.first.data_ptr(),
        tree.count.data_ptr(), tree.num_nodes.data_ptr(), rows,
        src_pos.data_ptr(), src_mass.data_ptr(), bbox_lo.data_ptr(), bbox_hi.data_ptr(),
        p, self_index, float(theta), r_cap,
        kind.data_ptr(), scan_a.data_ptr(), scan_b.data_ptr(), temp.data_ptr(), temp_bytes.value,
        *(t.data_ptr() for t in out), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"let_export kernels' launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out
