"""Build one hand-written CUDA source into a shared library for ``ctypes``.

Each ``.cu`` file under ``wgpu_n_body_tpu_torch/csrc`` has a plain C
launcher (no PyTorch headers), so ``nvcc`` compiles it in seconds. The
library is named by the source's stem and a hash of its source and flags,
so an edited kernel or a changed flag never loads a stale build, and two
sources never share a library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

#: Flags every kernel of the port is built with: Hopper (``sm_90a``), no
#: ``--use_fast_math`` (IEEE divide and sqrt, denormals kept), and
#: ``-Xptxas -v`` so registers, shared memory and spills reach the log.
BASE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def nvcc() -> str:
    """Path of ``nvcc`` (PATH, then ``$CUDA_HOME/bin``, then /usr/local/cuda)."""
    exe = shutil.which("nvcc")
    if exe is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        exe = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")
    return exe


def compile_cu(source: Path, build_dir: Path, flags: list[str]) -> tuple[Path, str]:
    """Compile ``source`` unless a library of this exact source and flags
    exists in ``build_dir``.

    Returns (library path, compiler output, or "cached"). Raises
    RuntimeError with nvcc's output when the build fails.
    """
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = build_dir / f"lib{source.stem}_{digest}.so"
    if lib_path.exists():
        return lib_path, "cached"
    exe = nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [exe, *flags, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, lib_path)
    return lib_path, log
