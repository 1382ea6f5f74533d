"""Wrapper of the renderer's raster kernels (``csrc/raster.cu``, B6).

``raster_counts_cuda`` has the signature of ``ops/raster.py::raster_counts``
and ``blend_u8_cuda`` that of ``raster.blend_u8``. For CUDA tensors they
launch the kernels on the current stream with no host read; for CPU tensors
they return the plain version; every other device raises. A CUDA tensor
never falls back to the plain version.

A frame's kernels share a workspace per device, stream and frame size
(``_Workspace``), which each frame leaves zero for the next: a frame is two
launches and no memset.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from wgpu_n_body_tpu_torch.ops import cuda_build, raster
from wgpu_n_body_tpu_torch.ops.tree_walk_cuda import _check

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "raster.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = list(cuda_build.BASE_FLAGS)  # no fast math: the counts are bit-exact

#: Raster launches since import (or since a caller set it to 0): one per
#: frame, whose launcher enqueues raster_kernel and raster_tile_kernel.
LAUNCHES = 0
#: blend_u8_kernel launches, counted the same way.
LAUNCHES_BLEND = 0
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
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.raster_launch.argtypes = [p, i, p, i, i, i, p, p, p, i, p, i, p]
        lib.raster_launch.restype = i
        lib.raster_blend_launch.argtypes = [p, p, i, p, i, p]
        lib.raster_blend_launch.restype = i
        _lib = lib
    return _lib


def _check_frame(width: int, height: int, footprint: str) -> None:
    if footprint not in raster.FOOTPRINTS:
        raise ValueError(f"unknown footprint {footprint!r}")
    if not (isinstance(width, int) and isinstance(height, int)
            and width >= 1 and height >= 1 and width * height < 2**31):
        raise ValueError(f"a frame of {width} x {height} pixels is not drawable")


def frame_bytes(n: int, width: int, height: int, listed: int = 0) -> int:
    """Bytes a frame and its blend must move: 12 per body read, per pixel
    the int32 counts written and read back and the u8 image written, 4 per
    listed body."""
    return 12 * n + 9 * width * height + 4 * listed


def raster_counts_cuda(pos: torch.Tensor, view_proj, width: int, height: int,
                       footprint: str = "triangle") -> torch.Tensor:
    """(height, width) int32 coverage counts of (N, 3) float32 positions:
    the raster kernels on a CUDA tensor, the plain version on a CPU one."""
    n = pos.shape[0] if pos.dim() == 2 else -1
    _check("pos", pos, torch.float32, (n, 3))
    _check_frame(width, height, footprint)
    if pos.device.type == "cpu":
        return raster.raster_counts(pos, view_proj, width, height, footprint)
    if pos.device.type != "cuda":
        raise ValueError(f"raster_counts_cuda takes CUDA or CPU tensors, got {pos.device}")
    return launch_raster(pos, view_proj, width, height, footprint)[0]


#: Listed triangles a workspace holds at most; a frame with more draws the
#: rest in raster_kernel, one thread per footprint.
LIST_CAP = 1 << 20


class _Workspace:
    """One device's, stream's and frame size's workspace: the counts of
    the small footprints (zero between frames), the list's length, CTA
    count and last frame's listed count (``meta``; the first two zero
    between frames) and the listed triangles."""

    def __init__(self, width: int, height: int, cap: int, device: torch.device):
        self.acc = torch.zeros((height, width), dtype=torch.int32, device=device)
        self.meta = torch.zeros(3, dtype=torch.int32, device=device)
        self.tris = torch.empty((cap, 4), dtype=torch.float32, device=device)


#: (device index, stream handle, width, height) -> _Workspace
_workspaces: dict[tuple[int, int, int, int], _Workspace] = {}


def launch_raster(pos: torch.Tensor, view_proj, width: int, height: int,
                  footprint: str = "triangle"):
    """The raster kernels alone on checked CUDA positions: (counts (H, W)
    int32, listed triangles (cap, 4) float32 (cx, cy, sx, sy) of which the
    first ``listed`` are this frame's, listed () int32). The last two are
    the workspace's: the next frame on this stream and size overwrites
    them."""
    global LAUNCHES
    n = pos.shape[0]
    if n >= 2**31:
        raise ValueError(f"the raster takes fewer than 2^31 bodies, got {n}")
    m = np.ascontiguousarray(raster.view_proj_array(view_proj))
    index, stream = cuda_build.launch_target(pos.device)
    key = (index, stream, width, height)
    cap = max(1, min(n, LIST_CAP))
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = _Workspace(width, height, cap, pos.device)
    elif ws.tris.shape[0] < cap:
        ws.tris = torch.empty((cap, 4), dtype=torch.float32, device=pos.device)
    counts = torch.empty((height, width), dtype=torch.int32, device=pos.device)
    err = _library().raster_launch(
        pos.data_ptr(), n, m.ctypes.data, width, height, int(footprint == "splat"),
        counts.data_ptr(), ws.acc.data_ptr(), ws.tris.data_ptr(), ws.tris.shape[0],
        ws.meta.data_ptr(), index, stream,
    )
    if err != 0:
        del _workspaces[key]  # a launch that did not run leaves it unknown
        raise RuntimeError(f"raster kernels' launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return counts, ws.tris, ws.meta[2]


def blend_u8_cuda(counts: torch.Tensor, alpha: float = 0.25) -> torch.Tensor:
    """uint8 image ``blend_lut_u8(alpha)[min(counts, 255)]`` of (H, W) int32
    counts: blend_u8_kernel on a CUDA tensor, the plain version on a CPU one."""
    global LAUNCHES_BLEND
    if counts.dim() != 2:
        raise ValueError(f"counts must be (H, W), got shape {tuple(counts.shape)}")
    _check("counts", counts, torch.int32, tuple(counts.shape))
    lut = raster.blend_lut_u8(alpha)
    if counts.device.type == "cpu":
        return raster.blend_u8(counts, alpha)
    if counts.device.type != "cuda":
        raise ValueError(f"blend_u8_cuda takes CUDA or CPU tensors, got {counts.device}")
    out = torch.empty(counts.shape, dtype=torch.uint8, device=counts.device)
    err = _library().raster_blend_launch(
        counts.data_ptr(), out.data_ptr(), counts.numel(), lut.ctypes.data,
        *cuda_build.launch_target(counts.device),
    )
    if err != 0:
        raise RuntimeError(f"blend_u8_kernel launch failed: cudaError_t {err}")
    LAUNCHES_BLEND += 1
    return out
