"""Development measurements of the all-pairs kernels (B1, B2) on a CUDA card.

    python -m wgpu_n_body_tpu_torch.utils.naive_study [--sweep] [--sass-dir DIR]

Prints, each timed line with the card's name and power limit:
- ptxas registers and spills of every instantiation, and the SASS loops of
  both forms that evaluate pairs: instructions and MUFU ops per pair, from
  ``cuobjdump -sass`` (listings to ``--sass-dir``); and how much of the
  kernel-vs-plain tolerance of the smoke's phases 3a/3b each form uses;
- with ``--sweep``: the kernels rebuilt from copies of their source with
  other launch constants (receivers per thread through ``kBlock``, resident
  CTAs, ring stages and stage size, unroll, the summation group), each with its tolerance use and timed in
  both forms at N=262144 and N=16384 with the source as built
  first and last; then the source split at N=100000 and N=16384, every
  slice count of ``SPLITS`` beside the one ``plan_launch`` chooses.
The SASS reader, the variant builder and the timer are ``utils/chip.py``'s.
Builds go to the git-ignored ``_build/``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import sys

import numpy as np
import torch

from wgpu_n_body_tpu_torch.ops import cuda_build, naive_cuda
from wgpu_n_body_tpu_torch.params import SimParams
from wgpu_n_body_tpu_torch.utils.chip import (
    card,
    max_sm_clock_mhz,
    print_ptxas,
    print_sass,
    ptxas_kernels,
    sfu_bound_ms,
    time_ms,
    variant_source,
)

N_MAIN = 262144
#: Launch-constant variants of the sweep; {} is the source as it stands.
#: kBlock 256 and 64 put 2 and 8 receivers on a thread at tile_i 512, with
#: kMinBlocks keeping the resident threads per SM.
SWEEP = ([{}] + [{"kBlock": 256, "kMinBlocks": 2}, {"kBlock": 64, "kMinBlocks": 8}]
         + [{"kMinBlocks": b} for b in (3, 5)] + [{"kStages": s} for s in (2, 3, 6)]
         + [{"kStage": c} for c in (128, 512)]
         + [{"kUnroll": u} for u in (4, 16)] + [{"kGroup": g} for g in (0, 4, 16)] + [{}])
#: Source slices timed at the smaller sizes.
SPLITS = (1, 2, 4, 5, 8, 12, 16, 17, 20, 24, 32, 33, 48, 66)


def scene(n, dev):
    """(pos_new, packed sources, params) of the uniform scene of the smoke's
    naive phases: n bodies, one drift, unit masses."""
    params = SimParams(particle_num=n)
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vel = (rng.uniform(-1, 1, (n, 3)) * 0.001).astype(np.float32)
    pos_new = torch.from_numpy((pos + vel * np.float32(params.dt)).astype(np.float32)).to(dev)
    src = torch.cat([torch.from_numpy(pos).to(dev),
                     torch.full((n, 1), params.g * params.dt, device=dev)], 1)
    return pos_new, src, params


def tolerance_use(dev, mxu=False, against="plain", plain_itself=False):
    """The largest |kernel - reference| / (atol + rtol |reference|) over
    the smoke's phase 3a/3b inputs (n=1000, both tilings, four receiver
    shards) at tests/test_naive.py's tolerances: at most 1 passes. The
    kernel is the port's of the form (with ``plain_itself``, the plain
    version); the reference is the plain version on the card, or with
    ``against="float64"`` the plain version in float64."""
    from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_mxu_ref, naive_forces_ref

    rng = np.random.default_rng(3)
    pos = rng.uniform(-1, 1, (1000, 3)).astype(np.float32)
    vel = rng.uniform(-0.1, 0.1, (1000, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, 1000).astype(np.float32)
    pn, po, m = (torch.from_numpy(a).to(dev) for a in (pos + np.float32(0.01) * vel, pos, mass))
    params = SimParams(particle_num=1000, g=1e-4, e=1e-4, dt=0.016)
    plain = naive_forces_mxu_ref if mxu else naive_forces_ref
    rtol, atol = (5e-2, 2e-8) if mxu else (3e-5, 1e-9)

    def kernel(pn_, po_, m_, params_, a, ti, tj):
        if plain_itself:
            return plain(pn_, po_, m_, params_, row_offset=a)
        return naive_cuda.naive_forces_cuda(pn_, po_, m_, params_, a, ti, tj, mxu=mxu)

    worst = 0.0
    for ti, tj in ((64, 128), (512, 2048)):
        for a, b in ((0, 1000), (0, 64), (64, 192), (100, 300), (936, 1000)):
            k = kernel(pn[a:b], po, m, params, a, ti, tj)
            if against == "float64":
                p = plain(pn[a:b].double(), po.double(), m.double(), params, row_offset=a)
            else:
                p = plain(pn[a:b], po, m, params, row_offset=a)
            worst = max(worst, float(((k - p).abs() / (atol + rtol * p.abs())).max()))
    return worst


def plan_of(n, dev, tile_i=512):
    """The wrapper's plan of n receivers against n sources (limits of B1's
    instantiation, which B2's equal)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return naive_cuda.plan_launch(n, n, tile_i, sms, naive_cuda.kernel_limits(dev))


def new_kernel(pos_new, src, params, mxu=False, plan=None):
    """The kernel as the wrapper launches it (its own plan unless given)."""
    plan = plan or plan_of(pos_new.shape[0], pos_new.device)
    return naive_cuda.run_plan(pos_new, src, plan, params.e, mxu=mxu)


def with_source(src_path, fn):
    """``fn()`` with the wrapper pointed at a variant's source (whose
    library reports the variant's launch limits)."""
    saved = naive_cuda.SOURCE
    naive_cuda.SOURCE = src_path
    try:
        return fn()
    finally:
        naive_cuda.SOURCE = saved


def sweep(dev, smi, mhz):
    """Launch constants at N=262144 and N=16384, both forms; then the
    source split at the smaller sizes."""
    sources = [variant_source(v, naive_cuda.SOURCE) for v in SWEEP]
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        built = list(pool.map(
            lambda s: cuda_build.compile_cu(s, naive_cuda.BUILD_DIR, naive_cuda.NVCC_FLAGS),
            sources))
    scenes = {n: scene(n, dev) for n in (N_MAIN, 16_384)}

    def times():
        out = [f"phase 3a/3b tolerance use B1 {tolerance_use(dev):.3f}, "
               f"B2 {tolerance_use(dev, True):.3f}"]
        for n, (pos_new, src, params) in scenes.items():
            reps = 3 if n == N_MAIN else 40
            for mxu in (False, True):
                ms, _ = time_ms(lambda: new_kernel(pos_new, src, params, mxu), reps)
                out.append(f"{'B2' if mxu else 'B1'} N={n} {ms:.4f} ms")
        return out

    for var, src_path, (_, log) in zip(SWEEP, sources, built):
        row = with_source(src_path, times)
        regs = [(r, st) for _, r, st, _ in ptxas_kernels(log)]
        print(f"sweep {var or 'as built'}: {'; '.join(row)}; registers and spill stores {regs}; "
              f"[{smi}]")

    for n in (100_000, 16_384):
        pos_new, src, params = scene(n, dev)
        chosen = plan_of(n, dev)
        for s in sorted(set(SPLITS) | {chosen.splits}):
            slice_len = -(-n // s)
            plan = chosen._replace(splits=-(-n // slice_len), slice_len=slice_len)
            row = []
            for mxu in (False, True):
                ms, _ = time_ms(lambda: new_kernel(pos_new, src, params, mxu, plan), 20)
                row.append(f"{'B2' if mxu else 'B1'} {ms:.4f} ms")
            mark = " (the plan's)" if plan.splits == chosen.splits else ""
            print(f"split N={n}: {plan.ctas} x {plan.splits} slices{mark} of {plan.slice_len}, "
                  f"{plan.waves:.3f} waves: {', '.join(row)}; "
                  f"SFU bound {sfu_bound_ms(float(n) * n, mhz):.4f} ms; "
                  f"[{smi}]")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="naive_study")
    parser.add_argument("--sweep", action="store_true", help="sweep launch constants and splits")
    parser.add_argument("--sass-dir", help="write the SASS listings here")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("naive_study needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi, mhz = card(), max_sm_clock_mhz()
    print(f"{smi}; maximum SM clock {mhz:.0f} MHz")
    lib, log = naive_cuda.build()
    print_ptxas(log)
    # per instantiation: four loops, unmasked and self-masked, each as the
    # kGroup loop (the main one) and the remainder loop (fewer instructions)
    for factored, label in ((0, "B1"), (1, "B2")):
        for per in naive_cuda.kernel_limits(dev).per_thread:
            print_sass(f"{label} {per}/thread", lib,
                       f"naive_forces_kernelILb{factored}ELi{per}E", args.sass_dir)
    print(f"phase 3a/3b tolerance use (at most 1 passes): B1 {tolerance_use(dev):.3f}, "
          f"B2 {tolerance_use(dev, True):.3f} against the plain version; against float64 B1 "
          f"{tolerance_use(dev, against='float64'):.3f}, the plain version itself "
          f"{tolerance_use(dev, against='float64', plain_itself=True):.3f}")
    if args.sweep:
        sweep(dev, smi, mhz)
    return 0


if __name__ == "__main__":
    sys.exit(main())
