"""E1 (``csrc/energy.cu``) against an earlier E1, in turns on a CUDA card.

    git show 20b939c:wgpu_n_body_tpu_torch/csrc/energy.cu > _parent/energy.cu
    python3 -m wgpu_n_body_tpu_torch.utils.energy_study --parent _parent/energy.cu
        [--sizes 262144,4000000] [--reps R] [--sass-dir DIR]

The parent is PR 13's E1 (the closed form with IEEE divisions; its
launcher takes the five floats a, a sqrt3, a^2, 6 a^2, a^2 sqrt3), built
with the port's flags into the git-ignored ``_build/study/``; the source
is this checkout's, launched through ``potential_energy_cuda``. For each
build:
- its pair loop's SASS (``chip_smoke.far_pair_sass``: instructions and
  MUFU ops per pair of the innermost loop with the fewest instructions per
  MUFU.RSQ; for the parent, whose loop branches to the closed form's slow
  paths, that is every instruction of the loop) and its registers;
- for the source, its pair arithmetic (``energy_probe``) against float64
  I(r) over ``chip_smoke.probe_sweep`` for e = 1e-4, 1e-5, 1e-2: the
  largest relative error beyond and inside r_s;
- its time by CUDA events (one warm call, then R calls; one call at N=4M),
  with the median SM clock and power draw nvidia-smi read meanwhile, on
  the uniform scene (seed 0) at each of ``--sizes`` and the disc scene at
  N=262144, in turns (parent, source, source, parent), the parent's result
  held to the source's within 1e-5.
Prints one JSON line with the card's name and power limit. ``chip_smoke.py``
does not run it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch


def registers(log):
    """Registers of the softened energy kernel in nvcc's -Xptxas -v output,
    or None (a cached build has no output)."""
    found = re.findall(r"Compiling entry function '\S*energy_kernelILb1E\S*'.*?Used (\d+) "
                       r"registers", log, re.S)
    return int(found[0]) if found else None


def parent_launcher(path):
    """``fn(st, params)`` launching PR 13's E1 from the library at ``path``
    on a state: the float64 scalar on the device."""
    from wgpu_n_body_tpu_torch.ops import cuda_build
    from wgpu_n_body_tpu_torch.ops.energy import share_range

    lib = ctypes.CDLL(str(path))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.energy_blocks.argtypes = [i, p]
    lib.energy_launch.argtypes = [p, p, ll, ll, ll, f, f, f, f, f, i, ctypes.c_double, i, p, p,
                                  i, p]
    resident = ctypes.c_int()
    if lib.energy_blocks(0, ctypes.byref(resident)) != 0:
        raise RuntimeError("parent: energy_blocks failed")

    def launch(st, params):
        lo, hi = share_range(st.n, (0, 1))
        blocks = max(1, min(resident.value, hi - lo))
        partial = torch.empty(blocks, dtype=torch.float64, device=st.pos.device)
        out = torch.empty(1, dtype=torch.float64, device=st.pos.device)
        a = params.e ** (1.0 / 3.0)
        s3 = math.sqrt(3.0)
        index, stream = cuda_build.launch_target(st.pos.device)
        err = lib.energy_launch(st.pos.data_ptr(), st.mass.data_ptr(), st.n, lo, hi, a, a * s3,
                                a * a, 6.0 * a * a, a * a * s3, 1, -params.g, blocks,
                                partial.data_ptr(), out.data_ptr(), index, stream)
        if err != 0:
            raise RuntimeError(f"parent: launch failed, cudaError_t {err}")
        return out[0]

    return launch, resident.value


def time_ms(fn, reps):
    """(ms per call by CUDA events over ``reps`` calls after a warm one, the
    result, the median SM clock in MHz and power draw in W that nvidia-smi
    read every 100 ms over the timed calls, or None if it read none)."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        lines = smi.communicate()[0].splitlines()
    reads = sorted(tuple(map(float, line.split(","))) for line in lines
                   if re.fullmatch(r"\s*[\d.]+\s*,\s*[\d.]+\s*", line))
    mid = reads[len(reads) // 2] if reads else (None, None)
    return start.elapsed_time(end) / reps, float(out), *mid


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="energy_study")
    parser.add_argument("--parent", required=True, help="PR 13's csrc/energy.cu")
    parser.add_argument("--sizes", default="262144,4000000")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--sass-dir", default=None, help="write each build's SASS listing here")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("energy_study needs a CUDA device", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(repo))
    from chip_smoke import energy_bound, far_pair_sass, max_sm_clock_mhz, probe_sweep
    from wgpu_n_body_tpu_torch.inits import disc_init, uniform_init
    from wgpu_n_body_tpu_torch.ops import cuda_build, energy_cuda
    from wgpu_n_body_tpu_torch.params import SimParams

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    mhz = max_sm_clock_mhz()
    dev = torch.device("cuda", 0)
    parent_path, parent_log = cuda_build.compile_cu(
        Path(args.parent).resolve(), energy_cuda.BUILD_DIR / "study", energy_cuda.NVCC_FLAGS)
    source_path, source_log = energy_cuda.build()
    parent, parent_blocks = parent_launcher(parent_path)
    builds = {
        "parent": (parent, parent_path, parent_log, parent_blocks),
        "source": (lambda st, params: energy_cuda.potential_energy_cuda(st.pos, st.mass, params),
                   source_path, source_log, energy_cuda.launch_blocks(dev)),
    }
    record = {"device": smi, "sm_mhz": mhz, "builds": {}, "times": []}
    for name, (_, path, log, blocks) in builds.items():
        sass = far_pair_sass(path, args.sass_dir)
        rec = {"registers": registers(log), "blocks": blocks,
               "sass_per_far_pair": sass and sass[0], "mufu_per_far_pair": sass and sass[1],
               "pairs_per_trip": sass and sass[2]}
        if name == "source":
            for e in (1e-4, 1e-5, 1e-2):
                r, want, near = probe_sweep(e, dev)
                rel = ((energy_cuda.pair_probe(r, e).double() - want) / want).abs()
                rec[f"probe_{e:g}"] = {"far": rel[~near].max().item(),
                                       "near": rel[near].max().item(),
                                       "near_mean": rel[near].mean().item()}
        record["builds"][name] = rec
        print(f"{name}: {json.dumps(rec)}", flush=True)

    scenes = [("uniform", uniform_init, int(n)) for n in args.sizes.split(",")]
    scenes.insert(1, ("disc", disc_init, 262_144))
    for scene, init, n in scenes:
        params = SimParams(particle_num=n)
        st = init(torch.Generator().manual_seed(0), params, dev)
        reps = 1 if n > 1_000_000 else args.reps
        bound = energy_bound(n, mhz)["bound_ms"]
        values = {}
        for name in ("parent", "source", "source", "parent"):
            ms, value, mhz_run, watts = time_ms(lambda: builds[name][0](st, params), reps)
            values[name] = value
            row = {"scene": scene, "n": n, "build": name, "ms": ms, "value": value,
                   "share_of_bound": bound / ms, "sm_mhz": mhz_run, "power_w": watts}
            record["times"].append(row)
            print(json.dumps(row), flush=True)
        if abs(values["parent"] - values["source"]) > 1e-5 * abs(values["source"]):
            print(f"{scene} N={n}: the parent's {values['parent']!r} against the source's "
                  f"{values['source']!r}", file=sys.stderr)
            return 1
        del st
        torch.cuda.empty_cache()
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
