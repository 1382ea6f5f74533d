"""Wrapper of the hand-written potential-energy kernel E1 (``csrc/energy.cu``).

``potential_energy_cuda`` computes what ``ops/energy.py::potential_energy``
does (the JAX package's ``ops/energy.py:62``): for CUDA tensors it launches
the kernel and its fixed-order sum on the current stream, with no host read;
for CPU tensors it returns the plain version; every other device raises. A
CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from wgpu_n_body_tpu_torch.ops import cuda_build
from wgpu_n_body_tpu_torch.ops.energy import (
    pair_constants,
    potential_energy_plain,
    share_range,
)
from wgpu_n_body_tpu_torch.params import ParticleState, SimParams

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "energy.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = list(cuda_build.BASE_FLAGS)  # the near field's accurate sqrtf/logf/atanf

#: E1 launches since import (or since a caller set it to 0): one per call,
#: whose launcher enqueues the pair kernel and the blocks' sum.
LAUNCHES = 0
_lib: ctypes.CDLL | None = None
_blocks: dict[int, int] = {}  # resident blocks of a launch, by device index


def build() -> tuple[Path, str]:
    """Compile the kernels unless a library of this exact source exists.
    Returns (library path, compiler output); raises RuntimeError with
    nvcc's output when the build fails."""
    return cuda_build.compile_cu(SOURCE, BUILD_DIR, NVCC_FLAGS)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fp = ctypes.POINTER(ctypes.c_float)
        lib.energy_blocks.argtypes = [i, p]
        lib.energy_blocks.restype = i
        lib.energy_launch.argtypes = [
            p, p, ll, ll, ll,  # pos, mass, n, lo, hi
            fp, i, i,  # consts, their count, softened
            ctypes.c_double, i, p, p,  # scale, blocks, partial, out
            i, p,  # device, stream
        ]
        lib.energy_launch.restype = i
        lib.energy_probe.argtypes = [p, ll, fp, i, i, p, i, p]
        lib.energy_probe.restype = i
        _lib = lib
    return _lib


def _consts(e: float, constants=None):
    """(float array, count) of ``constants`` (default ``pair_constants(e)``)
    for the launchers, which round each double to float32."""
    flat = (constants or pair_constants(e)).flat()
    return (ctypes.c_float * len(flat))(*flat), len(flat)


def launch_blocks(device: torch.device) -> int:
    """Blocks of one launch on CUDA ``device``: SMs times the blocks one SM
    holds at once, as the library reports them."""
    index = cuda_build.launch_target(device)[0]
    if index not in _blocks:
        blocks = ctypes.c_int()
        err = _library().energy_blocks(index, ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"energy_blocks failed: cudaError_t {err}")
        _blocks[index] = blocks.value
    return _blocks[index]


def potential_energy_cuda(
    pos: torch.Tensor,
    mass: torch.Tensor,
    params: SimParams,
    softened: bool = True,
    share: tuple[int, int] = (0, 1),
    block: int = 1024,
) -> torch.Tensor:
    """sum_{i<j} -g m_i m_j I(r_ij) (or / r_ij unless ``softened``) over the
    tile pairs of ``share`` of bodies ``pos`` (N, 3) / ``mass`` (N,), a
    float64 scalar on their device. CUDA tensors go through E1, CPU tensors
    through the plain version (receiver rows in blocks of ``block``, which
    E1 does not use); anything else raises, as do CUDA inputs of another
    type, shape or layout than the kernel takes."""
    global LAUNCHES
    if pos.device != mass.device:
        raise ValueError(f"pos on {pos.device}, mass on {mass.device}")
    device = pos.device
    if device.type == "cpu":
        state = ParticleState(pos, torch.zeros_like(pos), torch.zeros_like(pos), mass)
        return potential_energy_plain(state, params, block, softened, share)
    if device.type != "cuda":
        raise ValueError(f"potential_energy_cuda takes CUDA or CPU tensors, got {device}")
    n = pos.shape[0]
    if pos.shape != (n, 3) or mass.shape != (n,):
        raise ValueError(f"pos must be (N, 3) and mass (N,), got {tuple(pos.shape)} / "
                         f"{tuple(mass.shape)}")
    for name, t in (("pos", pos), ("mass", mass)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lo, hi = share_range(n, share)
    blocks = max(1, min(launch_blocks(device), hi - lo))
    partial = torch.empty(blocks, dtype=torch.float64, device=device)
    out = torch.empty(1, dtype=torch.float64, device=device)
    index, stream = cuda_build.launch_target(device)
    err = _library().energy_launch(
        pos.data_ptr(), mass.data_ptr(), n, lo, hi, *_consts(params.e), int(softened),
        -params.g, blocks, partial.data_ptr(), out.data_ptr(), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"energy kernel launch failed: cudaError_t {err} (n={n}, "
                           f"tile pairs [{lo}, {hi}), {blocks} blocks)")
    LAUNCHES += 1
    return out[0]


def pair_probe(r: torch.Tensor, e: float, softened: bool = True, constants=None) -> torch.Tensor:
    """I(r), or 1/r unless ``softened``, at each of the float32 distances
    ``r`` (a CUDA tensor) as E1's tile pass evaluates a pair, with
    ``pair_constants(e)`` or the given ``constants`` (a ``PairConstants``).
    A check of the kernel's arithmetic; it does not count as an E1 launch."""
    if r.device.type != "cuda" or r.dtype != torch.float32 or not r.is_contiguous():
        raise ValueError(f"pair_probe takes a contiguous float32 CUDA tensor, got {r.dtype} "
                         f"on {r.device}")
    out = torch.empty_like(r)
    index, stream = cuda_build.launch_target(r.device)
    err = _library().energy_probe(r.data_ptr(), r.numel(), *_consts(e, constants), int(softened),
                                  out.data_ptr(), index, stream)
    if err != 0:
        raise RuntimeError(f"energy_probe failed: cudaError_t {err}")
    return out
