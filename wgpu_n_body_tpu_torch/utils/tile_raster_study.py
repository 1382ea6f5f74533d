"""Development measurements of the tile set-up (B4 · T, ``csrc/tile_setup.cu``)
and the raster (B6, ``csrc/raster.cu``) on a CUDA card, for one checkout.

    python3 wgpu_n_body_tpu_torch/utils/tile_raster_study.py [--repo DIR]
        [--scenes FILE] [--reps R] [--check] [--variants A,B]

``--repo``: the checkout whose package is imported (default: the one this
file is in); a ``git archive`` of an earlier commit unpacked into the
git-ignored ``_parent/`` times that commit's kernels. ``--scenes``: the
inputs, made by this checkout's scene functions (``utils/chip.py``; so a first
run without ``--repo``), saved with ``torch.save`` and loaded after it, so that
two checkouts run in turns (old, new, new, old) inside one chip call time
the same inputs:
- tiles: the split levels of the N=4M uniform scene's build (the
  ``cli headless`` defaults, walk_tile 512), and of the N=16M one (the
  single-device step of ``utils/multi_gpu_check.py``);
- raster, 400 x 400 triangles: the visualize state (TreeSim N=100,000 disc,
  10 steps) at the default camera and flown in until at least 1,000
  footprints pass the kernel's 8 x 8 box (``flythrough_camera``), the
  N=4M uniform initial state (unsorted) and the N=4M state after one ``cli
  headless`` step (Morton-sorted).
For each kernel and scene it prints one JSON line with the card's name and
power limit: the device time per call (kernels and memsets over a
``torch.profiler`` window of R calls, ``chip.device_ms``), the device ops
per call by name, and the time by CUDA events over R calls queued back to
back (the host's enqueue included); both timers are this file's
checkout's, whichever checkout is measured. B6's frame is the raster and the u8 blend (its record's
yardstick since it was ported); the raster alone is beside it.
``--check`` first holds each kernel against its plain version on every
scene and on edge inputs (every field of the tiles; the counts), and exits
1 at the first difference. ``--variants``: this checkout's sources changed
for the measurement (``VARIANTS``), each built into ``_build/study/`` and
timed after the sources as built. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

#: name -> (source, [(text, replacement), ...]); each text occurs once in the
#: source. tile_nowin, tile_nostore and the scan-kernel probes break B4 · T's
#: results by design (only their times count); the others give the built
#: kernels' results. (B6's interim variants and the single-pass B4 · T
#: timestamp probe of PERF.md were run on sources this file no longer edits.)
VARIANTS = {
    "tile_nowin": ("tile_setup.cu", [("  if (g == 1 || n < g) {", "  if (true) {")]),
    "tile_nostore": ("tile_setup.cu", [("  for (int r = t; r < kItems; r += kThreads) {\n",
                                        "  if (n > 0) return;\n"
                                        "  for (int r = t; r < kItems; r += kThreads) {\n")]),
    # B4 · T with 8 receivers a thread (2048 a block)
    "tile_per8": ("tile_setup.cu", [("constexpr int kPer = 16;", "constexpr int kPer = 8;")]),
    # where the scan kernel's time goes (wrong results): no segmented scans, no
    # combines, stop after the windows; the byte min/max as one LOP3, or as
    # one 16-bit-lane op (VIMNMX.U16)
    "tile_noslide": ("tile_setup.cu", [("  if (w < 8) return;  // window_at reads src itself",
                                        "  if (w >= 0) return;")]),
    "tile_nocombine": ("tile_setup.cu", [("      if (i >= ny) break;", "      if (i >= 0) break;"),
                                         ("      if (i >= kWordsL) break;",
                                          "      if (i >= 0) break;")]),
    "tile_windows_only": ("tile_setup.cu", [
        ("  // this thread's receivers i0 .. i0 + kPer - 1: group starts (bit e)",
         "  if (n > 0) return;\n  // this thread's receivers i0")]),
    "tile_cheapop": ("tile_setup.cu", [("    return __vminu4(a, b);", "    return a & b;"),
                                       ("    return __vmaxu4(a, b);", "    return a | b;")]),
    "tile_u16op": ("tile_setup.cu", [("    return __vminu4(a, b);", "    return __vminu2(a, b);"),
                                     ("    return __vmaxu4(a, b);", "    return __vmaxu2(a, b);")]),
    # right results: the byte min/max as two 16-bit-lane ops on the even and
    # the odd bytes; the kernels at other resident block counts
    "tile_u16lanes": ("tile_setup.cu", [
        ("    return __vminu4(a, b);",
         "    return __vminu2(a & 0x00ff00ffu, b & 0x00ff00ffu) | "
         "__vminu2(a & 0xff00ff00u, b & 0xff00ff00u);"),
        ("    return __vmaxu4(a, b);",
         "    return __vmaxu2(a & 0x00ff00ffu, b & 0x00ff00ffu) | "
         "__vmaxu2(a & 0xff00ff00u, b & 0xff00ff00u);")]),
    "tile_scan_regs": ("tile_setup.cu", [("__launch_bounds__(kThreads, 6) tile_scan_kernel(",
                                          "__launch_bounds__(kThreads) tile_scan_kernel(")]),
    "tile_emit_min5": ("tile_setup.cu", [("__launch_bounds__(kThreads) tile_emit_kernel(",
                                          "__launch_bounds__(kThreads, 5) tile_emit_kernel(")]),
    "tile_emit_min6": ("tile_setup.cu", [("__launch_bounds__(kThreads) tile_emit_kernel(",
                                          "__launch_bounds__(kThreads, 6) tile_emit_kernel(")]),
}


def make_scenes(dev):
    """The inputs (see the module's docstring), from this checkout's scene
    functions."""
    from wgpu_n_body_tpu_torch.inits import uniform_init
    from wgpu_n_body_tpu_torch.params import SimParams, TreeParams
    from wgpu_n_body_tpu_torch.runners.renderer import Camera
    from wgpu_n_body_tpu_torch.utils.chip import (
        N_TREE,
        flythrough_camera,
        headless_after_one_step,
        sorted_scene,
        visualize_pos,
    )

    splits = {}
    for n in (4 * N_TREE, N_TREE):  # the N_TREE state last: a frame below draws it
        params = SimParams(particle_num=n)
        big = uniform_init(torch.Generator().manual_seed(0), params, dev)
        splits[f"N={n // 1_000_000}M"] = sorted_scene(big, params, TreeParams())[1].split.clone()
    vis = visualize_pos(dev).clone()
    cam = Camera(aspect=1.0)
    return {
        "splits": splits,
        "frames": {
            "visualize": (vis, cam.view_proj()),
            "flythrough": (vis, flythrough_camera(vis)[0].view_proj()),
            "N=4M unsorted": (big.pos.clone(), cam.view_proj()),
            "N=4M sorted, one step": (headless_after_one_step(dev).clone(), cam.view_proj()),
        },
    }


def check(scenes, dev) -> list[str]:
    """The kernels against their plain versions: the differences found."""
    from wgpu_n_body_tpu_torch.ops import raster, raster_cuda
    from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda
    from wgpu_n_body_tpu_torch.ops.tree_walk_group import tile_setup
    from wgpu_n_body_tpu_torch.params import TreeParams

    bad = []
    gen = torch.Generator(device=dev).manual_seed(3)
    split = scenes["splits"]["N=4M"]
    cases = [("N=4M", split, TreeParams()), ("N=16M", scenes["splits"]["N=16M"], TreeParams())]
    for g in (1, 2, 3, 7, 8, 64, 256, 512):
        cases.append((f"N=4M prefix 300001, walk_tile {g}", split[:300_001], TreeParams(walk_tile=g)))
    cases += [
        ("unaligned slice [1:200002], walk_tile 512", split[1:200_002], TreeParams(walk_tile=512)),
        ("random levels", torch.randint(0, 18, (100_003,), generator=gen, device=dev)
         .to(torch.uint8), TreeParams(walk_tile=256)),
        ("all levels 0", torch.zeros(50_000, dtype=torch.uint8, device=dev),
         TreeParams(walk_tile=256)),
        ("n=1", split[:1].clone(), TreeParams(walk_tile=512)),
        ("n=300", split[:300].clone(), TreeParams(walk_tile=512)),
    ]
    for name, s, tp in cases:
        n = s.shape[0]
        for rep in range(2):  # the second call on the same workspace
            got = gcuda.tile_setup_cuda(s, n, tp)
            torch.cuda.synchronize()
            want = tile_setup(None, n, tp, split=s)
            diff = [f for f, x, y in zip(got._fields, got, want)
                    if not (torch.equal(x, y) if torch.is_tensor(x) else x == y)]
            if diff:
                bad.append(f"tiles {name} (call {rep + 1}): {diff} differ")
    for name, (pos, m) in scenes["frames"].items():
        for fp in ("triangle", "splat"):
            got = raster_cuda.raster_counts_cuda(pos, m, 400, 400, fp)
            again = raster_cuda.raster_counts_cuda(pos, m, 400, 400, fp)
            torch.cuda.synchronize()
            want = raster.raster_counts(pos, m, 400, 400, fp)
            if not (torch.equal(got, want) and torch.equal(again, want)):
                bad.append(f"raster {name} {fp}: {int((got != want).sum())} pixels differ")
    return bad


def variant_lib(module, source: str, name: str):
    """Build ``source`` with variant ``name``'s edit into _build/study/<name>/
    and make ``module``'s wrapper load it."""
    from wgpu_n_body_tpu_torch.ops import cuda_build

    src, edits = VARIANTS[name]
    assert src == source
    text = (cuda_build.CSRC / source).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} does not occur once in {source}")
        text = text.replace(old, new)
    out = module.BUILD_DIR / "study" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / source).write_text(text)
    lib = cuda_build.compile_cu(out / source, out, module.NVCC_FLAGS)[0]
    build_fn, attr = ("build_tiles", "_tile_lib") if source == "tile_setup.cu" else ("build", "_lib")
    setattr(module, build_fn, lambda: (lib, "study"))
    setattr(module, attr, None)


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser = argparse.ArgumentParser(prog="tile_raster_study")
    parser.add_argument("--repo", default=here)
    parser.add_argument("--scenes", default=os.path.join(
        here, "wgpu_n_body_tpu_torch", "_build", "tile_raster_scenes.pt"))
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--variants", default="")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("tile_raster_study needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    from wgpu_n_body_tpu_torch.utils.chip import card, device_ms, import_checkout, time_ms

    import_checkout(args.repo)  # the measured checkout's package from here on
    from wgpu_n_body_tpu_torch.ops import raster_cuda
    from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda
    from wgpu_n_body_tpu_torch.params import TreeParams

    smi = card()
    dev = torch.device("cuda", 0)
    for build in (gcuda.build_tiles, raster_cuda.build):
        log = build()[1]
        print("\n".join(line for line in log.splitlines() if "ptxas" in line or "Used" in line))
    if os.path.exists(args.scenes):
        scenes = torch.load(args.scenes, map_location=dev, weights_only=False)
    elif os.path.abspath(args.repo) != here:
        print(f"no {args.scenes}: make the scenes with this checkout first (no --repo)",
              file=sys.stderr)
        return 1
    else:
        scenes = make_scenes(dev)
        os.makedirs(os.path.dirname(args.scenes), exist_ok=True)
        torch.save(scenes, args.scenes)
    if args.check:
        bad = check(scenes, dev)
        print(json.dumps({"repo": args.repo, "check": bad or "every output equal", "card": smi}))
        if bad:
            return 1
    runs = [("built", None)] + [(v, v) for v in args.variants.split(",") if v]
    tp = TreeParams()
    for label, name in runs:
        if name is None or VARIANTS[name][0] == "tile_setup.cu":
            if name:
                variant_lib(gcuda, "tile_setup.cu", name)
            for scene, split in scenes["splits"].items():
                def tiles(split=split):
                    return gcuda.tile_setup_cuda(split, split.shape[0], tp)

                ms, parts, ops = device_ms(tiles, args.reps)
                print(json.dumps({"repo": args.repo, "kernel": "tile_setup", "variant": label,
                                  "scene": f"{scene} walk_tile 512", "device_ms": ms,
                                  "ops_per_call": ops, "parts_ms": parts,
                                  "events_ms": time_ms(tiles, args.reps)[0], "card": smi}))
        if name is None or VARIANTS[name][0] == "raster.cu":
            if name:
                variant_lib(raster_cuda, "raster.cu", name)
            for scene, (pos, m) in scenes["frames"].items():
                def frame(pos=pos, m=m):
                    return raster_cuda.blend_u8_cuda(raster_cuda.raster_counts_cuda(pos, m, 400, 400))

                def counts(pos=pos, m=m):
                    return raster_cuda.raster_counts_cuda(pos, m, 400, 400)

                ms, parts, ops = device_ms(frame, args.reps)
                r_ms, r_parts, r_ops = device_ms(counts, args.reps)
                print(json.dumps({
                    "repo": args.repo, "kernel": "raster", "variant": label, "scene": scene,
                    "n": int(pos.shape[0]), "device_ms": ms, "ops_per_frame": ops,
                    "parts_ms": parts, "raster_device_ms": r_ms, "raster_ops": r_ops,
                    "events_ms": time_ms(frame, args.reps)[0],
                    "raster_events_ms": time_ms(counts, args.reps)[0], "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
