"""Wrapper of the hand-written octree build kernels (``csrc/tree_build.cu``).

``build_tree_cuda(state, perm, keys, bound, params)`` takes the bodies in
their input order, the Morton sort's permutation and sorted packed keys
(``ops/morton_cuda.py::morton_order_cuda``) and returns (sorted state,
arena): the plain ``reorder`` and ``build_tree`` of ``ops/tree_build.py``
(the JAX package's ``morton_sort`` gathers and ``build_tree``). For CUDA
tensors it launches the kernels; for CPU tensors it returns the plain
version; every other device raises. A CUDA tensor never falls back to the
plain version.

One build is two calls of the library's launchers, which enqueue four
kernels on the current stream:

    tree_reorder_kernel  the sorted state (pos, vel, acc, mass gathered by
                         perm), split levels and bucket-window levels from
                         the keys (``reorder_cuda``)
    tree_count_kernel    nodes per particle and the float64 mass and m*pos
                         terms, scanned inside blocks of 1024 particles
    tree_blocks_kernel   the scan of the block totals (one block)
    tree_emit_kernel     one thread per arena row: owner, level, run end, the
                         row; num_nodes, overflowed, root_width

The prefix sums are the kernels' own, in a fixed order of additions, so two
builds of one input are equal bit for bit (``torch.cumsum`` on the card is
not: its float64 sums change in the last bits from call to call). Nothing is
read back to the host, and no (depth+1) x n array is made: the scratch is
one byte, one int32 and four float64 per particle; the split levels (one
byte) go out with the arena as ``TreeArrays.split``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from wgpu_n_body_tpu_torch.ops import cuda_build, morton
from wgpu_n_body_tpu_torch.ops.tree_build import (
    NODE_F32_COLS,
    TreeArrays,
    build_tree,
    prefix_sums,
    reorder,
)
from wgpu_n_body_tpu_torch.ops.tree_walk_cuda import _check
from wgpu_n_body_tpu_torch.params import ParticleState, TreeParams

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tree_build.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = list(cuda_build.BASE_FLAGS)  # no fast math: the cog is an IEEE divide
BLOCK = 256  # threads per block of every kernel

#: Builds launched since import (or since a caller set it to 0): one per
#: call of the build launcher, which enqueues the count, block and emission
#: kernels once each.
LAUNCHES = 0
#: Reorder kernel launches (``reorder_cuda``): one per build.
LAUNCHES_REORDER = 0
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
        lib.tree_reorder_launch.argtypes = [
            p, p, p, p, p, p,  # perm, keys, pos, vel, acc, mass
            p, p, p, p, p, p,  # pos_s, vel_s, acc_s, mass_s, split, window
            i, i, i, i, i, p,  # n, depth, bucket, block, device, stream
        ]
        lib.tree_reorder_launch.restype = i
        lib.tree_build_launch.argtypes = [
            p, p, p, p,  # keys, pos, mass, bound
            p, p, p, p,  # split, window, in_block_c, in_block_w
            p, p, p, p,  # block_c, block_w, prefix_c, prefix_w
            p, p, p, p,  # nodes, skip, first, count
            p, p, p,  # num_nodes, root_width, overflowed
            i, i, i, i, i, i, p,  # n, cap, depth, bucket, block, device, stream
        ]
        lib.tree_build_launch.restype = i
        lib.tree_build_scan_block.argtypes = []
        lib.tree_build_scan_block.restype = i
        _lib = lib
    return _lib


def build_bytes(n: int, cap: int) -> int:
    """Bytes a build of ``n`` sorted bodies into an arena of ``cap`` rows
    must move, whatever implements it: the packed keys (int64), positions
    and masses read once; the prefix sums the totals and offsets need (four
    float64 and one int32 of n+1 entries) written once and read back once;
    the arena's cap+1 rows (eight float32, three int32) and the three
    scalars written once; the bound read once."""
    inputs = n * (8 + 3 * 4 + 4) + 4
    prefix = 2 * (n + 1) * (4 * 8 + 4)
    outputs = (cap + 1) * (NODE_F32_COLS * 4 + 3 * 4) + (4 + 4 + 1)
    return inputs + prefix + outputs


def reorder_bytes(n: int) -> int:
    """Bytes the reorder of ``n`` bodies must move: the permutation (int32),
    the state (pos, vel, acc, mass: 40 bytes) and the packed key read once;
    the sorted state and the split and window levels (a byte each) written
    once."""
    return n * (4 + 40 + 8 + 40 + 2)


def _checked(state, perm, keys, params, bound=None) -> torch.device:
    """Raise on inputs the kernels do not take (``bound`` when given);
    returns the one device."""
    tensors = [*state, perm, keys]
    if bound is not None:
        if not isinstance(bound, torch.Tensor):
            raise TypeError(f"bound must be a tensor, got {type(bound).__name__}")
        _check("bound", bound, torch.float32, ())
        tensors.append(bound)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    n = state.pos.shape[0]
    depth, bucket = params.max_depth, params.leaf_bucket
    for name in ("pos", "vel", "acc"):
        _check(name, getattr(state, name), torch.float32, (n, 3))
    _check("mass", state.mass, torch.float32, (n,))
    _check("perm", perm, torch.int32, (n,))
    _check("keys", keys, torch.int64, (n,))
    if not isinstance(depth, int) or not 1 <= depth <= 20:
        raise ValueError(f"max_depth must be an int in [1, 20], got {depth!r}")
    if not isinstance(bucket, int) or bucket < 1:
        raise ValueError(f"leaf_bucket must be an int >= 1, got {bucket!r}")
    if state.pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"build_tree_cuda takes CUDA or CPU tensors, got {state.pos.device}")
    return state.pos.device


def _reorder(state, perm, keys, params):
    """The reorder kernel on checked CUDA tensors: (sorted state, split
    (n,) uint8, window (n,) uint8)."""
    global LAUNCHES_REORDER
    n = state.pos.shape[0]
    bucket = min(params.leaf_bucket, n)  # no window of more than n bodies exists
    ss = ParticleState(*(torch.empty_like(t) for t in state))
    split = torch.empty(n, dtype=torch.uint8, device=keys.device)
    window = torch.empty(n, dtype=torch.uint8, device=keys.device)
    err = _library().tree_reorder_launch(
        perm.data_ptr(), keys.data_ptr(), *(t.data_ptr() for t in state),
        *(t.data_ptr() for t in ss), split.data_ptr(), window.data_ptr(),
        n, params.max_depth, bucket, BLOCK, *cuda_build.launch_target(keys.device),
    )
    if err != 0:
        raise RuntimeError(f"tree_reorder_kernel launch failed: cudaError_t {err}")
    LAUNCHES_REORDER += 1
    return ss, split, window


def reorder_cuda(state: ParticleState, perm: torch.Tensor, keys: torch.Tensor,
                 params: TreeParams):
    """(sorted state, split levels (n,) uint8, window levels (n,) uint8): the
    first pass of a build alone, for measurements. The plain version is
    ``tree_build.reorder``, ``morton.split_levels`` and
    ``morton.window_levels`` (CPU tensors)."""
    if _checked(state, perm, keys, params).type == "cpu":
        bucket = min(params.leaf_bucket, keys.shape[0])
        return (reorder(state, perm), morton.split_levels(keys, params.max_depth).to(torch.uint8),
                morton.window_levels(keys, params.max_depth, bucket).to(torch.uint8))
    return _reorder(state, perm, keys, params)


def _launch(state, perm, keys, bound, params):
    """The kernels on checked CUDA tensors: (sorted state, TreeArrays, the
    in-block scans (n, 4) float64, the block prefixes (blocks + 1, 4)
    float64, the window levels (n,) uint8)."""
    global LAUNCHES
    device = keys.device
    n = keys.shape[0]
    depth, bucket = params.max_depth, params.leaf_bucket
    cap = params.capacity(n)
    # node offsets and arena indices are int32 on the card
    if n < 1 or (depth + 1) * n >= 2**31 or cap + BLOCK >= 2**31 - 1:
        raise ValueError(
            f"build_tree_cuda takes 1 <= n with (max_depth+1)*n and the capacity below 2^31, "
            f"got n={n}, capacity {cap}"
        )
    ss, split, window = _reorder(state, perm, keys, params)
    bucket = min(bucket, n)  # no window of more than n bodies exists: the same tree
    lib = _library()
    nb = -(-n // lib.tree_build_scan_block())

    i32, f32, f64 = torch.int32, torch.float32, torch.float64
    in_block_c = torch.empty(n, dtype=i32, device=device)
    in_block_w = torch.empty((n, 4), dtype=f64, device=device)  # mass, m*x, m*y, m*z
    block_c = torch.empty(nb, dtype=i32, device=device)
    block_w = torch.empty((nb, 4), dtype=f64, device=device)
    prefix_c = torch.empty(nb + 1, dtype=i32, device=device)
    prefix_w = torch.empty((nb + 1, 4), dtype=f64, device=device)
    nodes = torch.empty((cap + 1, NODE_F32_COLS), dtype=f32, device=device)
    skip = torch.empty(cap + 1, dtype=i32, device=device)
    first = torch.empty(cap + 1, dtype=i32, device=device)
    count = torch.empty(cap + 1, dtype=i32, device=device)
    num_nodes = torch.empty((), dtype=i32, device=device)
    root_width = torch.empty((), dtype=f32, device=device)
    overflowed = torch.empty((), dtype=torch.bool, device=device)

    err = lib.tree_build_launch(
        keys.data_ptr(), ss.pos.data_ptr(), ss.mass.data_ptr(), bound.data_ptr(),
        split.data_ptr(), window.data_ptr(), in_block_c.data_ptr(), in_block_w.data_ptr(),
        block_c.data_ptr(), block_w.data_ptr(), prefix_c.data_ptr(), prefix_w.data_ptr(),
        nodes.data_ptr(), skip.data_ptr(), first.data_ptr(), count.data_ptr(),
        num_nodes.data_ptr(), root_width.data_ptr(), overflowed.data_ptr(),
        n, cap, depth, bucket, BLOCK, *cuda_build.launch_target(device),
    )
    if err != 0:
        raise RuntimeError(f"tree_build kernels' launch failed: cudaError_t {err}")
    LAUNCHES += 1
    tree = TreeArrays(
        nodes_f32=nodes, skip=skip, first=first, count=count,
        num_nodes=num_nodes, root_width=root_width, overflowed=overflowed, split=split,
    )
    return ss, tree, in_block_w, prefix_w, window


def build_tree_cuda(
    state: ParticleState,
    perm: torch.Tensor,
    keys: torch.Tensor,
    bound: torch.Tensor,
    params: TreeParams,
) -> tuple[ParticleState, TreeArrays]:
    """(sorted state, DFS node arena) of bodies in their input order, the
    sort's permutation ``perm`` (n,) int32 and the sorted packed ``keys``
    (n,) int64 (see ``tree_build.reorder`` and ``tree_build.build_tree``).

    CUDA tensors go through the kernels; CPU tensors through the plain
    version; anything else raises, as do inputs of another type, shape or
    layout than the kernels take, on either device.
    """
    if _checked(state, perm, keys, params, bound).type == "cpu":
        ss = reorder(state, perm)
        return ss, build_tree(ss, keys, bound, params)
    return _launch(state, perm, keys, bound, params)[:2]


def build_tree_cuda_with_sums(
    state: ParticleState,
    perm: torch.Tensor,
    keys: torch.Tensor,
    bound: torch.Tensor,
    params: TreeParams,
) -> tuple[ParticleState, TreeArrays, torch.Tensor, torch.Tensor]:
    """``build_tree_cuda``, the float64 prefix sums its totals came from,
    (4, n+1): mass, m*x, m*y, m*z over particles [0, j) in column j, and
    the window levels (n,) uint8 of its first pass. Given as ``sums`` to
    the plain ``build_tree``, the sums make it repeat the kernels' arena
    from the same sums (for checks: the step does not call this).
    """
    if _checked(state, perm, keys, params, bound).type == "cpu":
        ss = reorder(state, perm)
        sums = prefix_sums(ss)
        bucket = min(params.leaf_bucket, keys.shape[0])
        window = morton.window_levels(keys, params.max_depth, bucket).to(torch.uint8)
        return ss, build_tree(ss, keys, bound, params, sums=sums), sums, window
    ss, tree, in_block_w, prefix_w, window = _launch(state, perm, keys, bound, params)
    n = in_block_w.shape[0]
    block = torch.arange(n, device=in_block_w.device) // _library().tree_build_scan_block()
    sums = torch.cat([prefix_w[block] + in_block_w, prefix_w[-1:]])  # as the emission adds them
    return ss, tree, sums.T.contiguous(), window
