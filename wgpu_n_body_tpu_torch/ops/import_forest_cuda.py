"""Wrapper of the fused LET walk's import forest kernel B8
(``csrc/import_forest.cu``).

``assemble_fused_forest_cuda`` has the signature of
``parallel/let_tree.py::assemble_fused_forest``, its plain version. For
CUDA tensors it launches one kernel on the current stream, with no host
read; for CPU tensors it returns the plain version; every other device
raises. A CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from wgpu_n_body_tpu_torch.ops import cuda_build
from wgpu_n_body_tpu_torch.ops.let_export import LetExport
from wgpu_n_body_tpu_torch.ops.tree_build import NODE_F32_COLS, TreeArrays
from wgpu_n_body_tpu_torch.ops.tree_walk_cuda import _check
from wgpu_n_body_tpu_torch.parallel.let_tree import FusedForest, assemble_fused_forest

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "import_forest.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = list(cuda_build.BASE_FLAGS)

#: Kernel launches since import (or since a caller set it to 0): one per
#: fused forest made on the card.
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
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.import_forest_max_ranks.restype = i
        lib.import_forest_launch.argtypes = [
            p, p, p, p, p, p, i, p, p, i,  # local nodes .. overflowed, base, pos, mass, n
            p, p, p, p, p, p, p, i, i, i,  # imports nodes .. overflow, p, r_cap, cap_forest
            p, p, p, p, p, p, p, p, p, p, p,  # out nodes .. overflow
            i, p,  # device, stream
        ]
        lib.import_forest_launch.restype = i
        _lib = lib
    return _lib


def assemble_fused_forest_cuda(tree: TreeArrays, pos_s: torch.Tensor, mass_s: torch.Tensor,
                               imp: LetExport, cap_forest: int) -> FusedForest:
    """The fused LET walk's forest and sources of one rank: its arena
    ``tree`` and sorted bodies (``pos_s``, ``mass_s``) with its imports
    packed into ``cap_forest`` rows (see ``let_tree.assemble_fused_forest``).
    CUDA tensors go through the kernel, CPU tensors through the plain
    version; anything else raises, as do inputs of another type, shape or
    layout than the kernel takes."""
    global LAUNCHES
    tensors = [tree.nodes_f32, tree.skip, tree.first, tree.count, tree.num_nodes,
               tree.overflowed, pos_s, mass_s, *imp]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    device = pos_s.device
    base = tree.nodes_f32.shape[0]
    n = pos_s.shape[0] if pos_s.dim() == 2 else -1
    p, r_cap = imp.skip.shape if imp.skip.dim() == 2 else (-1, -1)
    _check("nodes_f32", tree.nodes_f32, torch.float32, (base, NODE_F32_COLS))
    for name in ("skip", "first", "count"):
        _check(name, getattr(tree, name), torch.int32, (base,))
    _check("num_nodes", tree.num_nodes, torch.int32, ())
    _check("overflowed", tree.overflowed, torch.bool, ())
    _check("pos_s", pos_s, torch.float32, (n, 3))
    _check("mass_s", mass_s, torch.float32, (n,))
    _check("imports' nodes", imp.nodes, torch.float32, (p, r_cap, NODE_F32_COLS))
    for name in ("skip", "first", "count"):
        _check(f"imports' {name}", getattr(imp, name), torch.int32, (p, r_cap))
    _check("imports' parts", imp.parts, torch.float32, (p, r_cap, 4))
    _check("imports' n_rows", imp.n_rows, torch.int32, (p,))
    _check("imports' overflow", imp.overflow, torch.bool, (p,))
    cap_forest = int(cap_forest)
    if cap_forest < 1:
        raise ValueError(f"cap_forest must be >= 1, got {cap_forest}")
    if device.type == "cpu":
        return assemble_fused_forest(tree, pos_s, mass_s, imp, cap_forest)
    if device.type != "cuda":
        raise ValueError(f"assemble_fused_forest_cuda takes CUDA or CPU tensors, got {device}")
    rows = base + cap_forest + 1
    if max(rows, n + 1 + cap_forest, p * r_cap) >= 2**31:
        raise ValueError(f"{base} arena rows, {n} bodies and {p} x {r_cap} import rows do not "
                         "fit the kernel's int32 rows")
    lib = _library()
    if p > lib.import_forest_max_ranks():
        raise ValueError(f"at most {lib.import_forest_max_ranks()} import buffers, got {p}")
    index, stream = cuda_build.launch_target(device)
    i32 = dict(dtype=torch.int32, device=device)
    forest = TreeArrays(
        nodes_f32=torch.empty((rows, NODE_F32_COLS), dtype=torch.float32, device=device),
        skip=torch.empty(rows, **i32), first=torch.empty(rows, **i32),
        count=torch.empty(rows, **i32), num_nodes=torch.empty((), **i32),
        root_width=tree.root_width,
        overflowed=torch.empty((), dtype=torch.bool, device=device),
    )
    out = FusedForest(
        forest=forest,
        src_pos=torch.empty((n + 1 + cap_forest, 3), dtype=torch.float32, device=device),
        src_mass=torch.empty(n + 1 + cap_forest, dtype=torch.float32, device=device),
        roots=torch.empty(p, **i32), extents=torch.empty(p, **i32),
        overflow=torch.empty((), dtype=torch.bool, device=device),
    )
    err = lib.import_forest_launch(
        tree.nodes_f32.data_ptr(), tree.skip.data_ptr(), tree.first.data_ptr(),
        tree.count.data_ptr(), tree.num_nodes.data_ptr(), tree.overflowed.data_ptr(), base,
        pos_s.data_ptr(), mass_s.data_ptr(), n,
        imp.nodes.data_ptr(), imp.skip.data_ptr(), imp.first.data_ptr(), imp.count.data_ptr(),
        imp.parts.data_ptr(), imp.n_rows.data_ptr(), imp.overflow.data_ptr(), p, r_cap,
        cap_forest,
        forest.nodes_f32.data_ptr(), forest.skip.data_ptr(), forest.first.data_ptr(),
        forest.count.data_ptr(), forest.num_nodes.data_ptr(), forest.overflowed.data_ptr(),
        out.src_pos.data_ptr(), out.src_mass.data_ptr(), out.roots.data_ptr(),
        out.extents.data_ptr(), out.overflow.data_ptr(), index, stream,
    )
    if err != 0:
        raise RuntimeError(f"import_forest kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def fused_forest_bytes(n_local: int, num_nodes: int, kept_rows: int) -> int:
    """The bytes B8's function moves: each of the arena's ``num_nodes`` live
    rows and each kept import row read and written once (32 bytes of node,
    12 of skip, first and count), the row at ``num_nodes`` that jumps to the
    imports written, and each local body and kept part read and written once
    (16 bytes). The arena's other rows, which no walk reads, and the
    sentinel and unused rows are not counted."""
    return 2 * (num_nodes + kept_rows) * 44 + 44 + 2 * (n_local + kept_rows) * 16
