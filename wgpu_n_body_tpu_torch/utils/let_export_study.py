"""Development measurements of the LET export walk (B7) on a CUDA card.

    python3 wgpu_n_body_tpu_torch/utils/let_export_study.py [--repo DIR] [--reps R]

Builds ``csrc/let_export.cu`` of the package found in ``--repo`` (default:
the checkout this file is in; another checkout that has ``utils/chip.py``,
for example a ``git archive`` of an earlier commit unpacked into the
git-ignored ``_parent/``, times that commit's kernels),
then, on the geometry of that checkout's ``utils/chip.py`` (``octant_local``,
``octant_boxes``: n_local=4,000,000 bodies uniform in octant 0 of
[-1, 1]^3, theta=0.75, let_cap 98,304, the other octants' boxes as
destinations; ``chip_smoke.py`` phase 16's), at P=8 and P=4:
- the export's time by CUDA events over R calls;
- each of its launches (kernels, CUB's scans, memsets) by name, the
  device time per call from a ``torch.profiler`` window of R calls.
The timers are this file's checkout's, whichever checkout is measured.
Prints one JSON line per P with the card's name and power limit. Run it
for two checkouts in turns (old, new, new, old) inside one chip call to
compare them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser = argparse.ArgumentParser(prog="let_export_study")
    parser.add_argument("--repo", default=here)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("let_export_study needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    from wgpu_n_body_tpu_torch.utils.chip import card, device_ms, import_checkout, time_ms

    import_checkout(args.repo)  # the measured checkout's package from here on
    from wgpu_n_body_tpu_torch.ops import let_export_cuda
    from wgpu_n_body_tpu_torch.parallel.let_tree import auto_let_cap
    from wgpu_n_body_tpu_torch.params import TreeParams
    from wgpu_n_body_tpu_torch.utils.chip import N_LOCAL, octant_boxes, octant_local

    smi = card()
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

        ms, exp = time_ms(call, args.reps)
        device, launches, _ = device_ms(call, args.reps)
        print(json.dumps({
            "repo": args.repo, "source": str(let_export_cuda.SOURCE.relative_to(
                os.path.abspath(args.repo))), "P": p, "n_local": N_LOCAL, "arena_rows": rows,
            "let_cap": cap, "n_rows": exp.n_rows.tolist(), "events_ms": ms,
            "device_ms_by_launch": launches, "device_ms_sum": device, "card": smi,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
