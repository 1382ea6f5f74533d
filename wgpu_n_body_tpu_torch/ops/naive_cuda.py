"""Wrappers of the hand-written all-pairs CUDA kernels.

Counterpart of ``wgpu_n_body_tpu/ops/naive_pallas.py::naive_forces_pallas``:
``mxu=False`` launches ``csrc/naive_forces.cu`` (the dx-form ``_kernel``),
``mxu=True`` launches ``csrc/naive_forces_mxu.cu`` (the factored
``_kernel_mxu``). Each kernel is compiled by ``nvcc`` for ``sm_90a`` into
``wgpu_n_body_tpu_torch/_build/`` on first use (``ops/cuda_build.py``) and
loaded with ``ctypes`` (a plain C launcher, no PyTorch headers, so the
build takes seconds).

``naive_forces_cuda`` launches the kernel for CUDA tensors. For tensors on
the CPU it returns the matching plain version (``naive_ref``); every other
device raises. A CUDA tensor never falls back to the plain version: the
build or the launch succeeds, or an exception says why.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from wgpu_n_body_tpu_torch.ops import cuda_build
from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_mxu_ref, naive_forces_ref
from wgpu_n_body_tpu_torch.params import SimParams

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "naive_forces.cu"
SOURCE_MXU = _PKG / "csrc" / "naive_forces_mxu.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = list(cuda_build.BASE_FLAGS)
_MAX_SMEM_TILE_J = 48 * 1024 // 16  # float4 sources in 48 KB of shared memory

#: Launches of the dx-form kernel (B1) since import, or since a caller set it to 0.
LAUNCHES = 0
#: Launches of the factored kernel (B2), likewise.
LAUNCHES_MXU = 0
_libs: dict[bool, ctypes.CDLL] = {}


def build(mxu: bool = False) -> tuple[Path, str]:
    """Compile the dx-form kernel (or, with ``mxu``, the factored one)
    unless a library of this exact source exists.

    Returns (library path, compiler output). Raises RuntimeError with
    nvcc's output when the build fails.
    """
    return cuda_build.compile_cu(SOURCE_MXU if mxu else SOURCE, BUILD_DIR, NVCC_FLAGS)


def _library(mxu: bool) -> ctypes.CDLL:
    if mxu not in _libs:
        lib = ctypes.CDLL(str(build(mxu)[0]))
        fn = lib.naive_forces_mxu_launch if mxu else lib.naive_forces_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pos_new, src, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n_recv, n_src, row_offset
            ctypes.c_float, ctypes.c_int, ctypes.c_int,  # e, tile_i, tile_j
            ctypes.c_int, ctypes.c_void_p,  # device, stream
        ]
        fn.restype = ctypes.c_int
        _libs[mxu] = lib
    return _libs[mxu]


def _check_tiles(tile_i: int, tile_j: int) -> None:
    if tile_i % 32 or not 32 <= tile_i <= 1024:
        raise ValueError(f"tile_i must be a multiple of 32 in [32, 1024], got {tile_i}")
    if not 1 <= tile_j <= _MAX_SMEM_TILE_J:
        raise ValueError(f"tile_j must be in [1, {_MAX_SMEM_TILE_J}], got {tile_j}")


def naive_forces_cuda(
    pos_new: torch.Tensor,
    pos_old: torch.Tensor,
    mass: torch.Tensor,
    params: SimParams,
    row_offset: int = 0,
    tile_i: int = 512,
    tile_j: int = 2048,
    mxu: bool = False,
) -> torch.Tensor:
    """(N_recv, 3) acc*dt of receivers ``pos_new`` against sources
    ``pos_old`` / ``mass``; ``row_offset`` is the global source index of
    receiver row 0 (for the self-mask of a receiver shard). ``mxu``
    selects the factored accumulation Σw·p_j − p_i·Σw (B2) over the
    dx-form Σw·(p_j − p_i) (B1).

    CUDA tensors go through the kernel; CPU tensors through the plain
    version of the same form; anything else raises.
    """
    global LAUNCHES, LAUNCHES_MXU
    _check_tiles(tile_i, tile_j)
    if not isinstance(row_offset, int) or row_offset < 0:
        raise ValueError(f"row_offset must be an int >= 0, got {row_offset!r}")
    devices = {pos_new.device, pos_old.device, mass.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    device = pos_new.device
    if device.type == "cpu":
        plain = naive_forces_mxu_ref if mxu else naive_forces_ref
        return plain(pos_new, pos_old, mass, params, row_offset=row_offset)
    if device.type != "cuda":
        raise ValueError(f"naive_forces_cuda takes CUDA or CPU tensors, got {device}")
    for name, t in (("pos_new", pos_new), ("pos_old", pos_old), ("mass", mass)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    n_recv, n_src = pos_new.shape[0], pos_old.shape[0]
    if pos_new.shape != (n_recv, 3) or pos_old.shape != (n_src, 3):
        raise ValueError(
            f"pos_new/pos_old must be (N, 3), got {tuple(pos_new.shape)} / "
            f"{tuple(pos_old.shape)}"
        )
    if mass.shape != (n_src,):
        raise ValueError(f"mass must be ({n_src},), got {tuple(mass.shape)}")
    if not pos_new.is_contiguous():
        raise ValueError("pos_new must be contiguous")

    out = torch.empty((n_recv, 3), dtype=torch.float32, device=device)
    if n_recv == 0:
        return out
    # Packed sources (x, y, z, m*g*dt): one 16-byte load per source.
    src = torch.cat([pos_old, (mass * (params.g * params.dt))[:, None]], dim=1)
    tile_i = min(tile_i, -(-n_recv // 32) * 32)  # no idle warps on tiny inputs
    tile_j = min(tile_j, max(n_src, 1))
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _library(mxu)
    launch = lib.naive_forces_mxu_launch if mxu else lib.naive_forces_launch
    err = launch(
        pos_new.data_ptr(), src.data_ptr(), out.data_ptr(),
        n_recv, n_src, row_offset, params.e, tile_i, tile_j,
        device.index if device.index is not None else torch.cuda.current_device(),
        stream,
    )
    name = "naive_forces_mxu" if mxu else "naive_forces"
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    if mxu:
        LAUNCHES_MXU += 1
    else:
        LAUNCHES += 1
    return out
