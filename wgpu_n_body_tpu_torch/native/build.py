"""ctypes loader for the C++ octree build (``native/octree.cpp``) —
counterpart of ``wgpu_n_body_tpu/native/build.py``.

The library is compiled on first use with ``g++ -O3 -std=c++17 -shared
-fPIC -fopenmp`` into the package's git-ignored ``_build/`` directory,
named by a hash of the source and the flags, written under a temporary
name and renamed (as ``ops/cuda_build.py`` does for nvcc), so an edited
source never loads a stale build. ``native_available()`` says only whether
a ``g++`` is on PATH; a compile that fails with a compiler present raises
``RuntimeError`` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "octree.cpp"
BUILD_DIR = _PKG / "_build"
#: Only the bound reduction of ``nbody_build_tree`` uses OpenMP; the BFS
#: build is one thread.
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp"]
_lib: ctypes.CDLL | None = None

# Octant struct: [cog3 f32, mass f32, bodies u32, children8 u32] = 13 words
OCTANT_WORDS = 13


def native_available() -> bool:
    """Whether a ``g++`` is on PATH (nothing is compiled to answer)."""
    return shutil.which("g++") is not None


def library_path() -> Path:
    """Where the library of this source and these flags is, or will be, built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"liboctree_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library unless one of this exact source and flags
    exists. Returns (library path, compiler output, or "cached"); raises
    RuntimeError when there is no g++ or with g++'s output when it fails."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path, "cached"
    exe = shutil.which("g++")
    if exe is None:
        raise RuntimeError("the native octree library needs g++ on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [exe, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, lib_path)
    return lib_path, log


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.nbody_build_tree.restype = i64
        lib.nbody_build_tree.argtypes = [p, p, i64, p, i64, p]
        lib.nbody_dfs_order.restype = i64
        lib.nbody_dfs_order.argtypes = [p, i64, i64, p]
        lib.nbody_to_dfs_arena.restype = i64
        lib.nbody_to_dfs_arena.argtypes = [p, i64, i64, p, ctypes.c_float, p, p, p, p]
        _lib = lib
    return _lib


class HostOctree(NamedTuple):
    """Host-built octree in both layouts.

    octants:    (m, 13) u32/f32 words — the reference Octant layout
                (cog f32x3, mass f32, bodies u32, children u32x8)
    order:      (n,) int64 — DFS particle permutation (sorted <- original)
    root_width: float
    nodes_f32:  (m+1, 8) f32 DFS arena (ops/tree_build.py layout)
    skip:       (m+1,) int32
    first:      (m+1,) int32 — SORTED index of each node's first particle
    count:      (m+1,) int32 — particles per subtree
    """

    octants: np.ndarray
    order: np.ndarray
    root_width: float
    nodes_f32: np.ndarray
    skip: np.ndarray
    first: np.ndarray
    count: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.octants.shape[0]

    def cog(self):
        return np.ascontiguousarray(self.octants[:, 0:3]).view(np.float32)

    def mass(self):
        return np.ascontiguousarray(self.octants[:, 3]).view(np.float32)

    def bodies(self):
        return self.octants[:, 4]

    def children(self):
        return self.octants[:, 5:13]


def build_host_tree(pos: np.ndarray, mass: np.ndarray, cap_factor: float = 4.0) -> HostOctree:
    """Build the octree on the host CPU (reference tree.rs semantics).

    The octant buffer is ``cap_factor * n`` octants of 52 bytes of host
    memory per call (832 MB at N=4M), trimmed to the ``m`` the build made.
    """
    lib = _library()
    pos = np.ascontiguousarray(pos, np.float32)
    mass = np.ascontiguousarray(mass, np.float32)
    n = pos.shape[0]
    cap = int(cap_factor * max(n, 2)) + 1
    octants = np.zeros((cap, OCTANT_WORDS), np.uint32)
    root_width = np.zeros((1,), np.float32)
    m = lib.nbody_build_tree(
        pos.ctypes.data, mass.ctypes.data, n, octants.ctypes.data, cap, root_width.ctypes.data
    )
    if m == -1:
        raise RuntimeError(f"octree arena overflow (cap {cap})")
    if m == -2:
        raise RuntimeError(
            "exactly-coincident particle cluster beyond depth 64 "
            "(the reference implementation would not terminate here)"
        )
    octants = octants[:m]
    order = np.zeros((n,), np.int64)
    cnt = lib.nbody_dfs_order(octants.ctypes.data, m, n, order.ctypes.data)
    if cnt != n:
        raise RuntimeError(f"DFS order emitted {cnt} of {n} particles")
    nodes_f32 = np.zeros((m + 1, 8), np.float32)
    skip = np.zeros((m + 1,), np.int32)
    first = np.zeros((m + 1,), np.int32)
    count = np.zeros((m + 1,), np.int32)
    dfs_n = lib.nbody_to_dfs_arena(
        octants.ctypes.data, m, n, order.ctypes.data, ctypes.c_float(float(root_width[0])),
        nodes_f32.ctypes.data, skip.ctypes.data, first.ctypes.data, count.ctypes.data,
    )
    if dfs_n < 0:
        raise RuntimeError("DFS arena overflow")
    return HostOctree(
        octants=octants,
        order=order,
        root_width=float(root_width[0]),
        nodes_f32=nodes_f32,
        skip=skip,
        first=first,
        count=count,
    )
