"""Build one hand-written CUDA source into a shared library for ``ctypes``.

Each ``.cu`` file under ``wgpu_n_body_tpu_torch/csrc`` has a plain C
launcher (no PyTorch headers), so ``nvcc`` compiles it in seconds. The
library is named by the source's stem and a hash of its source, the
headers it includes (``#include "..."``, followed recursively) and the
flags, so an edited kernel or header or a changed flag never loads a stale
build, and two sources never share a library.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

#: Flags every kernel of the port is built with: Hopper (``sm_90a``), no
#: ``--use_fast_math`` (IEEE divide and sqrt, denormals kept, unless a
#: kernel asks for an approximation in inline PTX), and ``-Xptxas -v`` so
#: registers, shared memory and spills reach the log.
BASE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
#: The port's kernel sources and their shared headers; always on the
#: include path, so a copy of a source elsewhere (a variant of its launch
#: constants) still finds them.
CSRC = Path(__file__).resolve().parent.parent / "csrc"
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def launch_target(device: torch.device) -> tuple[int, int]:
    """(device index, handle of its current stream) of a CUDA ``device``:
    the last two arguments of every launcher."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def nvcc() -> str:
    """Path of ``nvcc`` (PATH, then ``$CUDA_HOME/bin``, then /usr/local/cuda)."""
    exe = shutil.which("nvcc")
    if exe is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        exe = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")
    return exe


def included_headers(source: Path) -> list[Path]:
    """The headers ``source`` includes with quotes, and theirs, each once,
    looked up in the including file's directory and then in ``CSRC`` as
    nvcc does. A header found in neither is left to nvcc to report."""
    found: list[Path] = []
    todo = [source]
    while todo:
        path = todo.pop()
        for name in _INCLUDE.findall(path.read_text()):
            for base in (path.parent, CSRC):
                header = (base / name).resolve()
                if header.is_file():
                    if header not in found:
                        found.append(header)
                        todo.append(header)
                    break
    return found


def library_path(source: Path, build_dir: Path, flags: list[str]) -> Path:
    """Where the library of ``source`` with ``flags`` is, or will be, built."""
    h = hashlib.sha256(source.read_bytes())
    for header in included_headers(source):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return build_dir / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def compile_cu(source: Path, build_dir: Path, flags: list[str]) -> tuple[Path, str]:
    """Compile ``source`` unless a library of this exact source, headers
    and flags exists in ``build_dir``.

    Returns (library path, compiler output, or "cached"). Raises
    RuntimeError with nvcc's output when the build fails.
    """
    lib_path = library_path(source, build_dir, flags)
    if lib_path.exists():
        return lib_path, "cached"
    exe = nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [exe, *flags, f"-I{CSRC}", "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, lib_path)
    return lib_path, log
