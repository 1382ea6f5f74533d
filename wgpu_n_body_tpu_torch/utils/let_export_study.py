"""Development measurements of the LET export walk (B7) on a CUDA card.

    python3 wgpu_n_body_tpu_torch/utils/let_export_study.py [--repo DIR] [--reps R]

Builds ``csrc/let_export.cu`` of the package found in ``--repo`` (default:
the checkout this file is in; another checkout, for example a ``git
archive`` of an earlier commit unpacked into the git-ignored ``_parent/``,
times that commit's kernels), then, on the geometry of that checkout's
``chip_smoke.py`` phase 16 (``octant_local``, ``octant_boxes``:
n_local=4,000,000 bodies uniform in octant 0 of [-1, 1]^3, theta=0.75,
let_cap 98,304, the other octants' boxes as destinations), at P=8 and P=4:
- the export's time by CUDA events over R calls;
- each of its launches (kernels, CUB's scans, memsets) by name, the
  device time per call from a ``torch.profiler`` window of R calls.
Prints one JSON line per P with the card's name and power limit. Run it
for two checkouts in turns (old, new, new, old) inside one chip call to
compare them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="let_export_study")
    parser.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("let_export_study needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    from wgpu_n_body_tpu_torch.ops import let_export_cuda
    from wgpu_n_body_tpu_torch.params import TreeParams
    from wgpu_n_body_tpu_torch.parallel.let_tree import auto_let_cap
    from chip_smoke import N_LOCAL, octant_boxes, octant_local  # the checkout's phase 16 geometry

    if not let_export_cuda.__file__.startswith(os.path.abspath(args.repo)):
        print(f"imported {let_export_cuda.__file__}, not from {args.repo}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    let_export_cuda.build()
    tp = TreeParams()
    local, cap = octant_local(N_LOCAL, dev, tp), auto_let_cap(N_LOCAL, tp.theta)
    rows = int(local.tree.num_nodes)
    for p in (8, 4):
        blo, bhi = octant_boxes(p, dev)

        def call():
            return let_export_cuda.export_walk_cuda(local.tree, local.pos_s, local.mass_s, blo,
                                                    bhi, 0, tp.theta, cap)

        exp = call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.reps
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.reps):
                call()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        launches = {}
        for e in events:
            if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"):
                name = e["name"][:200]  # the two CUB scans differ past ~120 characters
                launches[name] = launches.get(name, 0.0) + e["dur"] / 1e3 / args.reps
        print(json.dumps({
            "repo": args.repo, "source": str(let_export_cuda.SOURCE.relative_to(
                os.path.abspath(args.repo))), "P": p, "n_local": N_LOCAL, "arena_rows": rows,
            "let_cap": cap, "n_rows": exp.n_rows.tolist(), "events_ms": ms,
            "device_ms_by_launch": launches, "device_ms_sum": sum(launches.values()),
            "card": smi,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
