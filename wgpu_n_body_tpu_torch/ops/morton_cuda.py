"""Wrapper of the Morton key kernel and the key sort (``csrc/morton_keys.cu``).

``morton_order_cuda`` has the signature of ``ops/tree_build.py::morton_order``
(perm, bound, sorted packed keys). For CUDA tensors it runs, on the current
stream and with no host read:

    torch.aminmax        the one reduction the bound needs (no |pos| array)
    morton_keys_kernel   packed keys and the index 0..n-1, and the bound
                         (profiler range ``morton_keys``)
    CUB SortPairs        the stable sort of (key, index) on the key's
                         3*depth bits (profiler range ``morton_sort``)

For CPU tensors it returns the plain version (``morton.packed_keys`` and
``torch.sort(stable=True)``); every other device raises. A CUDA tensor never
falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from wgpu_n_body_tpu_torch.ops import cuda_build, morton
from wgpu_n_body_tpu_torch.ops.tree_walk_cuda import _check
from wgpu_n_body_tpu_torch.utils.profiling import trace_scope

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "morton_keys.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = list(cuda_build.BASE_FLAGS)  # no fast math: the scale is an IEEE divide
BLOCK = 256

#: Key kernel launches since import (or since a caller set it to 0). The
#: sort is CUB's and is not counted.
LAUNCHES = 0
_lib: ctypes.CDLL | None = None


def build() -> tuple[Path, str]:
    """Compile the kernel and the sort unless a library of this exact source
    exists. Returns (library path, compiler output); raises RuntimeError
    with nvcc's output when the build fails."""
    return cuda_build.compile_cu(SOURCE, BUILD_DIR, NVCC_FLAGS)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.morton_keys_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.morton_keys_launch.restype = i
        lib.morton_sort_temp_bytes.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_size_t)]
        lib.morton_sort_temp_bytes.restype = i
        lib.morton_sort_launch.argtypes = [p, ctypes.c_size_t, p, p, p, p, i, i, i, p]
        lib.morton_sort_launch.restype = i
        _lib = lib
    return _lib


def key_bytes(n: int) -> int:
    """Bytes the key kernel must move for ``n`` bodies: the positions and
    the min and max read once, the keys (int64), the index (int32) and the
    bound written once."""
    return n * (12 + 8 + 4) + 4 + 4 + 4


def _checked_depth(depth) -> None:
    if not isinstance(depth, int) or not 1 <= depth <= 20:
        raise ValueError(f"max_depth must be an int in [1, 20], got {depth!r}")


def morton_keys_cuda(pos: torch.Tensor, depth: int, bound: torch.Tensor | None = None):
    """(keys (n,) int64 unsorted packed keys, index (n,) int32 0..n-1,
    bound () float32) of (n, 3) float32 positions: the bound's reduction
    and the key kernel on a CUDA tensor, the plain version on a CPU one.
    ``bound``, when given, is a () float32 at least max(1, max |pos|) that
    the cells are cut from instead (the LET schedule's, reduced over the
    ranks so that every rank's cells align); the kernel takes it as its
    min and max."""
    n = pos.shape[0] if pos.dim() == 2 else -1
    _check("pos", pos, torch.float32, (n, 3))
    _checked_depth(depth)
    if bound is not None:
        _check("bound", bound, torch.float32, ())
    if pos.device.type == "cpu":
        bound = morton.bound_of(pos) if bound is None else bound
        index = torch.arange(n, dtype=torch.int32)
        return morton.packed_keys(pos, bound, depth), index, bound
    if pos.device.type != "cuda":
        raise ValueError(f"morton_keys_cuda takes CUDA or CPU tensors, got {pos.device}")
    return launch_keys(pos, *(torch.aminmax(pos) if bound is None else (-bound, bound)), depth)


def launch_keys(pos: torch.Tensor, pos_min: torch.Tensor, pos_max: torch.Tensor, depth: int):
    """The key kernel alone on checked CUDA positions, given their min and
    max (``morton_keys_cuda`` computes them first): (keys, index, bound)."""
    global LAUNCHES
    n = pos.shape[0]
    if not 1 <= n < 2**31:
        raise ValueError(f"the key kernel takes 1 <= n < 2^31 bodies, got {n}")
    keys = torch.empty(n, dtype=torch.int64, device=pos.device)
    index = torch.empty(n, dtype=torch.int32, device=pos.device)
    bound = torch.empty((), dtype=torch.float32, device=pos.device)
    err = _library().morton_keys_launch(
        pos.data_ptr(), pos_min.data_ptr(), pos_max.data_ptr(), keys.data_ptr(),
        index.data_ptr(), bound.data_ptr(), n, depth, BLOCK,
        *cuda_build.launch_target(pos.device),
    )
    if err != 0:
        raise RuntimeError(f"morton_keys_kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return keys, index, bound


def sort_keys_cuda(keys: torch.Tensor, index: torch.Tensor, depth: int):
    """(perm (n,) int32, sorted keys (n,) int64): ``index`` in the stable
    order of ``keys``' bits [0, 3*depth). CUB's radix sort on a CUDA tensor,
    ``torch.sort(stable=True)`` on a CPU one."""
    n = keys.shape[0] if keys.dim() == 1 else -1
    _check("keys", keys, torch.int64, (n,))
    _check("index", index, torch.int32, (n,))
    _checked_depth(depth)
    if keys.device != index.device:
        raise ValueError(f"inputs on several devices: {keys.device}, {index.device}")
    if keys.device.type == "cpu":
        keys_sorted, order = torch.sort(keys, stable=True)
        return index[order], keys_sorted
    if keys.device.type != "cuda":
        raise ValueError(f"sort_keys_cuda takes CUDA or CPU tensors, got {keys.device}")
    lib = _library()
    dev, stream = cuda_build.launch_target(keys.device)
    temp_bytes = ctypes.c_size_t(0)
    err = lib.morton_sort_temp_bytes(n, 3 * depth, dev, ctypes.byref(temp_bytes))
    if err != 0:
        raise RuntimeError(f"the key sort's scratch query failed: cudaError_t {err}")
    temp = torch.empty(max(temp_bytes.value, 1), dtype=torch.uint8, device=keys.device)
    keys_sorted, perm = torch.empty_like(keys), torch.empty_like(index)
    err = lib.morton_sort_launch(
        temp.data_ptr(), temp_bytes.value, keys.data_ptr(), keys_sorted.data_ptr(),
        index.data_ptr(), perm.data_ptr(), n, 3 * depth, dev, stream,
    )
    if err != 0:
        raise RuntimeError(f"the key sort failed: cudaError_t {err}")
    return perm, keys_sorted


def morton_order_cuda(pos: torch.Tensor, depth: int, bound: torch.Tensor | None = None):
    """Morton ordering of (n, 3) float32 positions: (perm (n,) int32, bound
    () float32, sorted packed keys (n,) int64), equal to
    ``tree_build.morton_order``'s (against ``bound`` where it is given, see
    ``morton_keys_cuda``). The key kernel runs in the profiler range
    ``morton_keys``, the sort in ``morton_sort``."""
    with trace_scope("morton_keys"):
        keys, index, bound = morton_keys_cuda(pos, depth, bound)
    with trace_scope("morton_sort"):
        perm, keys = sort_keys_cuda(keys, index, depth)
    return perm, bound, keys

