"""Development measurements of the chained-scan kernel on a CUDA card: the
LET export walk (B7, ``csrc/let_export.cu``), built on
``csrc/chained_scan.cuh``. (The tile set-up, B4 · T, no longer scans across
blocks with a look-back; ``utils/tile_raster_study.py`` measures
it.)

    python -m wgpu_n_body_tpu_torch.utils.chained_scan_study [--reps R] [--probe]

The kernel is timed on the device (its launches summed over a
``torch.profiler`` window) as built and as copies of its source
and of ``chained_scan.cuh`` changed for the measurement only, whose results
are wrong by design (only their times count):
  nowait     no look-back: every block takes its carry as the identity, so
             no block waits on another;
  noemit     the scan kernel writes no output row;
and as copies with other block sizes, whose results are the built ones:
  rows1, rows4  one or four arena rows per thread (256 or 1024 per block,
             not 512);
  min8       launch bounds asking for 8 resident blocks per SM (at most 32
             registers a thread).
The copies and the source as built run in turns (built, copies..., built)
on ``chip_smoke.py`` phase 16's octant geometry at P=8 and P=4. Builds go to
the git-ignored ``_build/study/``. Prints one JSON line per shape with the
card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from wgpu_n_body_tpu_torch.ops import cuda_build, let_export_cuda
from wgpu_n_body_tpu_torch.params import TreeParams
from wgpu_n_body_tpu_torch.parallel.let_tree import auto_let_cap
from wgpu_n_body_tpu_torch.utils.profile_step import device_launches

HEADER = cuda_build.CSRC / "chained_scan.cuh"
#: (file, text, replacement) edits of each variant; each text occurs once
EDITS = {
    "nowait": [
        ("chained_scan.cuh", "    carry = look_back(status, block, stride, op, identity);\n", ""),
        ("chained_scan.cuh", "    for (int end = block - 1;; end -= kThreads) {",
         "    for (int end = block - 1; end < 0; end -= kThreads) {"),
    ],
    "noemit": [("let_export.cu", "      all += max(0, min(total_s[d], o.r_cap - carry_s[d]));",
                "")],
    # other block sizes (these copies give the built kernel's results)
    "rows1": [("let_export.cu", "constexpr int kRowsPer = 2;", "constexpr int kRowsPer = 1;")],
    "rows4": [("let_export.cu", "constexpr int kRowsPer = 2;", "constexpr int kRowsPer = 4;")],
    "min8": [("let_export.cu", "__global__ void __launch_bounds__(kThreads) let_export_kernel(",
              "__global__ void __launch_bounds__(kThreads, 8) let_export_kernel(")],
    # B7 with a timestamp (%globaltimer, ns) at each phase boundary of every block
    "probe": [
        ("let_export.cu", '#include "chained_scan.cuh"\n',
         '#include "chained_scan.cuh"\n__device__ unsigned long long g_probe[16384 * 8];\n'
         "#define PROBE(k) if (threadIdx.x == 0) { unsigned long long ns; asm volatile("
         '"mov.u64 %0, %%globaltimer;" : "=l"(ns)); g_probe[b * 8 + (k)] = ns; }\n'),
        ("let_export.cu", "  if (base >= m) return;  // past the arena: no later block reads this one\n",
         "  if (base >= m) return;  // past the arena: no later block reads this one\n  PROBE(0)\n"),
        ("let_export.cu", "  if (warp < pg) warp_chained_scan(reach_s[warp]",
         "  PROBE(1)\n  if (warp < pg) warp_chained_scan(reach_s[warp]"),
        ("let_export.cu", "  // a row is visited iff no stop row before it reaches past it\n",
         "  PROBE(2)\n"),
        ("let_export.cu", "  if (warp < pg) {\n    const int2 ca",
         "  PROBE(3)\n  if (warp < pg) {\n    const int2 ca"),
        ("let_export.cu", "  // the visited rows' slots\n", "  PROBE(4)\n"),
        ("let_export.cu", "  // emission: thread k writes the block's k-th slot of all destinations,\n",
         "  PROBE(5)\n"),
        ("let_export.cu", "  }\n}\n\n__global__ void let_tail_kernel",
         "  }\n  PROBE(6)\n}\n\n__global__ void let_tail_kernel"),
        ("let_export.cu", "}  // namespace\n",
         "}  // namespace\nextern \"C\" int study_probe(void* out) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe)));\n}\n"),
    ],
}
PHASES = ("classify", "reach scan", "sizes", "slot scan", "slots", "emission")
KERNELS = {"let": ("let_export.cu", ("nowait", "noemit", "rows1", "rows4", "min8"))}


def variant(source: str, name: str) -> Path:
    """The library of ``source`` (a file of csrc/) with variant ``name``'s
    edits, built in _build/study/<name>/ beside its own copy of the header."""
    out = let_export_cuda.BUILD_DIR / "study" / name
    out.mkdir(parents=True, exist_ok=True)
    texts = {f: (cuda_build.CSRC / f).read_text() for f in (source, HEADER.name)}
    for f, old, new in EDITS.get(name, []):
        if f not in texts:
            continue
        if texts[f].count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} does not occur once in {f}")
        texts[f] = texts[f].replace(old, new)
    for f, text in texts.items():
        (out / f).write_text(text)
    return cuda_build.compile_cu(out / source, out, let_export_cuda.NVCC_FLAGS)[0]


def use(module, build_fn: str, lib: Path) -> None:
    """Make ``module``'s wrapper load ``lib`` on its next call."""
    setattr(module, build_fn, lambda: (lib, "study"))
    for attr in ("_lib", "_tile_lib"):
        if hasattr(module, attr):
            setattr(module, attr, None)


def device_ms(fn, reps):
    """Device ms per call of ``fn``: its launches summed over a profiler
    window of ``reps`` calls after one warm call. (CUDA events around calls
    of these wrappers would time the host's enqueue, which is longer.)"""
    fn()
    torch.cuda.synchronize()
    ms = sum(ms for ms, _ in device_launches(fn, reps).values())
    return ms if ms > 0 else "not measured: the profiler saw no device activity"


def probe(fn) -> dict:
    """B7's phases from the ``probe`` copy: per phase the mean and the 90th
    percentile of the blocks' durations (µs), and when the blocks start and
    end after the first one starts."""
    use(let_export_cuda, "build", variant("let_export.cu", "probe"))
    fn()
    torch.cuda.synchronize()
    buf = np.zeros(16384 * 8, np.uint64)
    err = let_export_cuda._lib.study_probe(ctypes.c_void_p(buf.ctypes.data))
    if err != 0:
        raise RuntimeError(f"study_probe: cudaError_t {err}")
    t = buf.reshape(-1, 8)[:, :7].astype(np.float64)
    t = t[t[:, 0] > 0] / 1e3  # the blocks that ran, µs
    t0 = t[:, 0].min()
    out = {"blocks": int(t.shape[0])}
    for k, name in enumerate(PHASES):
        d = t[:, k + 1] - t[:, k]
        out[name] = [round(float(d.mean()), 3), round(float(np.percentile(d, 90)), 3)]
    out["start"] = [round(float(np.percentile(t[:, 0] - t0, q)), 3) for q in (50, 90, 100)]
    out["end"] = [round(float(np.percentile(t[:, 6] - t0, q)), 3) for q in (50, 90, 100)]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="chained_scan_study")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--kernels", default="let")
    parser.add_argument("--probe", action="store_true", help="B7's phases by timestamps")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chained_scan_study needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    shutil.rmtree(let_export_cuda.BUILD_DIR / "study", ignore_errors=True)
    tp = TreeParams()
    for kernel in args.kernels.split(","):
        source, names = KERNELS[kernel]
        libs = {name: variant(source, name) for name in ("built",) + names}
        order = ["built", *names, "built"]
        sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
        from chip_smoke import N_LOCAL, octant_boxes, octant_local  # phase 16's geometry

        local, cap = octant_local(N_LOCAL, dev, tp), auto_let_cap(N_LOCAL, tp.theta)
        shapes = {}
        for p in (8, 4):
            blo, bhi = octant_boxes(p, dev)
            shapes[f"octants P={p}"] = (
                lambda blo=blo, bhi=bhi: let_export_cuda.export_walk_cuda(
                    local.tree, local.pos_s, local.mass_s, blo, bhi, 0, tp.theta, cap))
        module, build_fn = let_export_cuda, "build"
        for shape, fn in shapes.items():
            times = []
            for name in order:
                use(module, build_fn, libs[name])
                times.append((name, device_ms(fn, args.reps)))
            print(json.dumps({"kernel": source, "shape": shape, "ms_in_turns": times,
                              "card": smi}))
            if args.probe:
                print(json.dumps({"kernel": source, "shape": shape, "probe": probe(fn),
                                  "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
