"""Wrapper of the hand-written all-pairs CUDA kernels.

Counterpart of ``wgpu_n_body_tpu/ops/naive_pallas.py::naive_forces_pallas``.
One source, ``csrc/naive_forces.cu``, holds both forms: ``mxu=False``
launches the dx-form (the TPU's ``_kernel``, B1), ``mxu=True`` the
factored form (``_kernel_mxu``, B2). It is compiled by ``nvcc`` for
``sm_90a`` into ``wgpu_n_body_tpu_torch/_build/`` on first use
(``ops/cuda_build.py``) and loaded with ``ctypes`` (a plain C launcher, no
PyTorch headers, so the build takes seconds).

``plan_launch`` shapes the launch: threads and receivers per thread from
``tile_i``, receiver CTAs, and a split of the source axis into slices when
the receiver CTAs alone would leave the card's resident CTA slots empty
(small N). It plans with the limits the library reports of itself
(``kernel_limits``). A split launch adds a second, tiny kernel that sums
the slices in order, so the result is the same bit for bit from launch to
launch.

``naive_forces_cuda`` launches the kernel for CUDA tensors. For tensors on
the CPU it returns the matching plain version (``naive_ref``); every other
device raises. A CUDA tensor never falls back to the plain version: the
build or the launch succeeds, or an exception says why.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from wgpu_n_body_tpu_torch.ops import cuda_build
from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_mxu_ref, naive_forces_ref
from wgpu_n_body_tpu_torch.params import SimParams

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "naive_forces.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = list(cuda_build.BASE_FLAGS)
#: The largest summation granule: the 48 KB of float4 sources the first
#: kernel staged per tile, kept as the bound of ``tile_j``.
MAX_TILE_J = 48 * 1024 // 16
#: A split launch takes the fewest slices whose estimated time is within
#: this factor of the best (more slices cost more per-CTA set-up).
SPLIT_SLACK = 1.05

#: Launches of the dx-form kernel (B1) since import, or since a caller set
#: it to 0: one per force call (``run_plan``).
LAUNCHES = 0
#: Launches of the factored kernel (B2), likewise.
LAUNCHES_MXU = 0
#: The plan of the last launch of each form: B1's, B2's (None before one).
LAST_PLAN: LaunchPlan | None = None
LAST_PLAN_MXU: LaunchPlan | None = None
_libs: dict[Path, ctypes.CDLL] = {}  # by source
_limits: dict[tuple[Path, int, bool], KernelLimits] = {}  # by source, device, form


class KernelLimits(NamedTuple):
    """A form's launch limits, as its library reports them
    (``naive_forces_limits``)."""

    max_threads: int  # most threads per CTA (the kernel's kBlock)
    min_slice: int  # sources of one ring stage (kStage): the fewest in a slice
    per_thread: tuple[int, ...]  # receivers per thread, one per instantiation
    resident: tuple[int, ...]  # CTAs of max_threads threads per SM, by instantiation


class LaunchPlan(NamedTuple):
    """How one force call is launched. CTA (x, y) takes receivers
    ``[x * tile, (x + 1) * tile)`` (``tile = threads * per_thread``; thread
    t holds ``x * tile + q * threads + t`` for ``q < per_thread``) against
    sources ``[y * slice_len, min((y + 1) * slice_len, n_src))``."""

    threads: int
    per_thread: int
    ctas: int  # receiver CTAs (grid x)
    splits: int  # source slices (grid y)
    slice_len: int
    slots: int  # resident CTA slots on the card: SMs x resident CTAs per SM

    @property
    def waves(self) -> float:
        """CTAs of all slices over the card's resident slots."""
        return self.ctas * self.splits / self.slots


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_launch(
    n_recv: int, n_src: int, tile_i: int, sms: int, limits: KernelLimits
) -> LaunchPlan:
    """The launch of ``n_recv`` receivers against ``n_src`` sources with
    ``tile_i`` receivers per CTA (fewer for an input smaller than a tile)
    on a card of ``sms`` SMs, within the kernel's ``limits``.

    Receivers per thread: the fewest of ``limits.per_thread`` that keep a
    CTA at ``limits.max_threads`` threads or fewer; each SM holds that
    instantiation's ``limits.resident`` CTAs at once (a CTA of fewer
    threads is planned as a full one). Sources are split only when the
    receiver CTAs leave at least one slot per SM empty on average; then
    into enough slices that every slot gets a CTA, and among those the
    fewest whose estimated time is within ``SPLIT_SLACK`` of the best.
    The estimate is the most CTAs any SM runs, over the slices: CTAs of
    equal work go to SMs as slots free up, so the SMs finish together
    when the CTAs divide evenly among them, and a last round that only
    some SMs get is the tail this avoids. Slices hold at least
    ``limits.min_slice`` sources.
    """
    _check_tiles(tile_i, 1)
    tile = min(tile_i, _cdiv(max(n_recv, 1), 32) * 32)
    k, per = next((k, p) for k, p in enumerate(limits.per_thread)
                  if tile % p == 0 and tile // p <= limits.max_threads)
    resident = limits.resident[k]
    ctas = _cdiv(n_recv, tile)
    slots = sms * resident
    splits = 1
    if ctas <= sms * (resident - 1):
        s_max = max(1, n_src // limits.min_slice)
        cands = range(min(_cdiv(slots, max(ctas, 1)), s_max), s_max + 1)
        cost = {s: _cdiv(ctas * s, sms) / s for s in cands}
        best = min(cost.values())
        splits = next(s for s in cands if cost[s] <= SPLIT_SLACK * best)
    slice_len = max(_cdiv(n_src, splits), 1)
    splits = max(_cdiv(n_src, slice_len), 1)  # no empty slice
    return LaunchPlan(tile // per, per, ctas, splits, slice_len, slots)


def build() -> tuple[Path, str]:
    """Compile both forms' kernels unless a library of this exact source
    exists. Returns (library path, compiler output). Raises RuntimeError
    with nvcc's output when the build fails."""
    return cuda_build.compile_cu(SOURCE, BUILD_DIR, NVCC_FLAGS)


def _library() -> ctypes.CDLL:
    """The library of ``SOURCE``, built and loaded once."""
    lib = _libs.get(SOURCE)
    if lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.naive_forces_launch, lib.naive_forces_mxu_launch):
            fn.argtypes = [
                p, p, p, p,  # pos_new, src, out, partial
                i, i, i, f, i,  # n_recv, n_src, row_offset, e, tile_j
                i, i, i, i, i,  # threads, per, ctas, splits, slice_len
                i, p,  # device, stream
            ]
            fn.restype = i
        lib.naive_forces_limits.argtypes = [i, i, p, p, p, p]
        lib.naive_forces_limits.restype = i
        _libs[SOURCE] = lib
    return lib


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def kernel_limits(device: torch.device, mxu: bool = False) -> KernelLimits:
    """The launch limits of one form's kernel on CUDA ``device``, from its
    library (the kernel's constants and the CUDA occupancy calculator)."""
    key = (SOURCE, _device_index(device), mxu)
    if key not in _limits:
        block, stage = ctypes.c_int(), ctypes.c_int()
        per, resident = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
        err = _library().naive_forces_limits(
            int(mxu), key[1], ctypes.byref(block), ctypes.byref(stage), per, resident)
        if err != 0:
            raise RuntimeError(f"naive_forces_limits failed: cudaError_t {err}")
        _limits[key] = KernelLimits(block.value, stage.value, tuple(per), tuple(resident))
    return _limits[key]


def _check_tiles(tile_i: int, tile_j: int) -> None:
    if tile_i % 32 or not 32 <= tile_i <= 1024:
        raise ValueError(f"tile_i must be a multiple of 32 in [32, 1024], got {tile_i}")
    if not 1 <= tile_j <= MAX_TILE_J:
        raise ValueError(f"tile_j must be in [1, {MAX_TILE_J}], got {tile_j}")


def run_plan(
    pos_new: torch.Tensor,
    src: torch.Tensor,
    plan: LaunchPlan,
    e: float,
    row_offset: int = 0,
    tile_j: int = 2048,
    mxu: bool = False,
) -> torch.Tensor:
    """Launch the kernel of one form with ``plan`` on CUDA receivers
    ``pos_new`` (n_recv, 3) and packed sources ``src`` (n_src, 4: x, y, z,
    m*g*dt); returns the (n_recv, 3) force. Counts the launch
    (``LAUNCHES`` or ``LAUNCHES_MXU``) and keeps its plan (``LAST_PLAN``
    or ``LAST_PLAN_MXU``)."""
    global LAUNCHES, LAUNCHES_MXU, LAST_PLAN, LAST_PLAN_MXU
    n_recv, n_src = pos_new.shape[0], src.shape[0]
    device = pos_new.device
    out = torch.empty((n_recv, 3), dtype=torch.float32, device=device)
    partial = (
        torch.empty((plan.splits, n_recv, 4), dtype=torch.float32, device=device)
        if plan.splits > 1 else None
    )
    lib = _library()
    launch = lib.naive_forces_mxu_launch if mxu else lib.naive_forces_launch
    err = launch(
        pos_new.data_ptr(), src.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        n_recv, n_src, row_offset, e, tile_j,
        plan.threads, plan.per_thread, plan.ctas, plan.splits, plan.slice_len,
        _device_index(device), torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        name = "naive_forces_mxu" if mxu else "naive_forces"
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err} ({plan})")
    if mxu:
        LAUNCHES_MXU += 1
        LAST_PLAN_MXU = plan
    else:
        LAUNCHES += 1
        LAST_PLAN = plan
    return out


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
    dx-form Σw·(p_j − p_i) (B1). ``tile_i`` is receivers per CTA, ``tile_j``
    the sources summed into one partial before it joins the total.

    CUDA tensors go through the kernel; CPU tensors through the plain
    version of the same form; anything else raises.
    """
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
    if n_recv == 0:
        return torch.empty((0, 3), dtype=torch.float32, device=device)

    # Packed sources (x, y, z, m*g*dt): one 16-byte row per source.
    src = torch.cat([pos_old, (mass * (params.g * params.dt))[:, None]], dim=1)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = plan_launch(n_recv, n_src, tile_i, sms, kernel_limits(device, mxu))
    return run_plan(pos_new, src, plan, params.e, row_offset, tile_j, mxu)
