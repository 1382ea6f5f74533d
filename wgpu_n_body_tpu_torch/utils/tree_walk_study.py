"""Development measurements of the per-particle walk kernel (B3) on a CUDA card.

    python -m wgpu_n_body_tpu_torch.utils.tree_walk_study [--sweep] [--host] [--sass-dir DIR]
        [--scene uniform|disc] [--n N] [--theta T]

On the N=4M uniform scene of ``chip_smoke.py`` phase 10 (θ=0.75, leaf_bucket
16, the arena of the build kernels) unless ``--scene``, ``--n`` or ``--theta``
say otherwise, each timed line with the card's name and power limit:
- what a receiver's walk visits, from the kernel's counting instantiation
  over all 4M receivers: nodes visited, nodes accepted and members summed per
  receiver (the bound counts the last two), and the visits of its warp of 32
  consecutive receivers, which is the union of the nodes they visit
  (``tests/test_torch_tree_walk_counts.py`` holds that rule); the first
  three by the plain rules (``ops/tree_walk.py::walk_counts``) on 4096
  receivers (128 runs of 32), which must be equal;
- registers and spills from ``ptxas -v``, and the kernel's SASS loops from
  ``cuobjdump``: instructions per visit (the walk's loop without the member
  loops inside it) and per member;
- the kernel's time over all receivers, over 4096 consecutive and over 4096
  sampled ones, beside its bound (interactions × 2 MUFU at 16 per SM per
  clock at the card's maximum SM clock), and the issue slots it takes per
  visit of a warp;
- with ``--host``: the same counts and times on the host-built arena
  (``native/octree.cpp``: singleton leaves, the tree of ``TreeSimHost``), with
  the seconds of the host build;
- with ``--sweep``: the kernel rebuilt from copies of its source with other
  launch constants (``kBlock``, ``kMinBlocks``, ``kUnroll``),
  each timed over all receivers with the source as built first and last (on
  the host arena too with ``--host``).
Builds go to the git-ignored ``_build/``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import sys
import time

import torch

from wgpu_n_body_tpu_torch.inits import INITS
from wgpu_n_body_tpu_torch.models.tree_host import host_tree_arrays
from wgpu_n_body_tpu_torch.native.build import build_host_tree
from wgpu_n_body_tpu_torch.ops import cuda_build
from wgpu_n_body_tpu_torch.ops import tree_walk_cuda as wcuda
from wgpu_n_body_tpu_torch.ops.tree_walk import walk_counts
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams
from wgpu_n_body_tpu_torch.utils.chip import (
    N_TREE,
    card,
    max_sm_clock_mhz,
    print_ptxas,
    ptxas_kernels,
    sass_all_loops,
    sfu_bound_ms,
    sorted_scene,
    time_ms,
    variant_source,
)

SAMPLE = 4096
SLOTS_PER_SM_CLOCK = 4  # warp instructions per SM per clock (four schedulers)

#: Launch-shape variants of the sweep; {} is the source as it stands.
SWEEP = ([{}] + [{"kMinBlocks": m} for m in (6, 8, 10, 14)]
         + [{"kBlock": 64, "kMinBlocks": 24}, {"kBlock": 256, "kMinBlocks": 6},
            {"kBlock": 512, "kMinBlocks": 3}, {"kBlock": 1024, "kMinBlocks": 1}]
         + [{"kUnroll": u} for u in (2, 8)] + [{}])


def receiver_sets(n, dev):
    """(label, indices or None for all) of the three sets timed: all
    receivers, 4096 consecutive ones, 4096 sampled ones (sorted)."""
    gen = torch.Generator().manual_seed(1)
    sampled = torch.randperm(n, generator=gen)[:SAMPLE].sort().values.to(dev)
    start = n // 2
    return (("all", None),
            (f"{SAMPLE} consecutive", torch.arange(start, start + SAMPLE, device=dev)),
            (f"{SAMPLE} sampled", sampled))


def print_walk_sass(lib_path, sass_dir):
    """The walk's loop and the member loops inside it, per instantiation."""
    for name, loops in sass_all_loops(lib_path, "tree_walk_kernel", sass_dir):
        with_rsq = sorted((x for x in loops if x[3]), key=lambda x: x[2])
        if not with_rsq:
            continue
        outer = with_rsq[-1]
        inner = [x for x in with_rsq[:-1] if outer[0] <= x[0] and x[1] <= outer[1]]
        inside = sum(x[2] for x in inner)
        members = ", ".join(f"{x[2]} instructions / {x[3]} MUFU.RSQ = {x[2] / x[3]:.2f} per member"
                            for x in inner)
        print(f"SASS {name[:48]}...: the walk's loop {outer[2]} instructions, {outer[4]} MUFU, of "
              f"which member loops {inside}: {outer[2] - inside} instructions per visit on the "
              f"longest path; member loops: {members}")


def study_arena(label, pos_new, ss, tree, params, tp, dev, smi, mhz):
    """Counts and times on one arena."""
    n = pos_new.shape[0]
    m = int(tree.num_nodes)
    _, counts = wcuda.tree_forces_counts_cuda(pos_new, ss.pos, ss.mass, tree, params, tp)
    torch.cuda.synchronize()
    c = counts.double()
    far, mem, live, warp = (float(c[:, k].mean()) for k in range(4))
    inter = float(c[:, 0].sum() + c[:, 1].sum())
    warp_visits = float(c[::32, 3].sum())
    print(f"{label} arena, N={n}, {m} nodes, theta={tp.theta}, leaf_bucket={tp.leaf_bucket}: per "
          f"receiver {live:.1f} nodes visited, {far:.1f} accepted, {mem:.1f} members summed "
          f"({far + mem:.1f} interactions, {inter:.4e} in all; max {int(c[:, :2].sum(1).max())}); "
          f"a warp of 32 consecutive receivers visits {warp:.1f} nodes between them: "
          f"{warp / live:.3f} x one receiver's own")
    # the plain rules on 128 runs of 32 receivers
    gen = torch.Generator().manual_seed(2)
    starts = torch.randperm(n // 32, generator=gen)[: SAMPLE // 32].sort().values.to(dev) * 32
    idx = (starts[:, None] + torch.arange(32, device=dev)[None, :]).reshape(-1)
    want = walk_counts(pos_new[idx], tree, tp)
    got = counts[idx].long()
    same = [torch.equal(got[:, k], want[:, k]) for k in range(3)]
    print(f"{label} arena: the kernel's counts on {idx.numel()} receivers against the plain "
          f"rules: accepted {same[0]}, members {same[1]}, visited {same[2]}; plain rules: "
          f"visited {float(want[:, 2].double().mean()):.1f}")
    if not all(same):
        raise SystemExit(f"{label}: the kernel's counts differ from the plain rules")

    # the wrapper's call is the pack kernel, then the walk: one warp's call
    # is the pack's time to within a walk of 32 receivers
    ms_pack, _ = time_ms(lambda: wcuda.tree_forces_cuda(
        pos_new[:32], ss.pos, ss.mass, tree, params, tp), 10)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for what, sel in receiver_sets(n, dev):
        recv = pos_new if sel is None else pos_new[sel]
        sidx = None if sel is None else sel.to(torch.int32)
        cs = counts if sel is None else counts[sel]
        bound = sfu_bound_ms(float(cs[:, :2].sum()), mhz)

        mn, _ = time_ms(lambda: wcuda.tree_forces_cuda(recv, ss.pos, ss.mass, tree, params, tp,
                                                       self_idx=sidx), 3 if sel is None else 10)
        slots = ""
        if sel is None:
            per_visit = ((mn - ms_pack) * 1e-3 * mhz * 1e6 * sms * SLOTS_PER_SM_CLOCK
                         / warp_visits)
            slots = (f", of which the pack kernel ~{ms_pack:.3f} ms (a call with 32 receivers); "
                     f"the walk takes {per_visit:.1f} issue slots per warp visit "
                     f"({warp_visits:.4e} warp visits)")
        print(f"{label} arena, {what} receivers: {mn:.3f} ms, bound {bound:.4f} ms at "
              f"{mhz:.0f} MHz: {bound / mn:.2%}{slots}; [{smi}]")


def sweep(label, pos_new, ss, tree, params, tp, smi):
    sources = [variant_source(v, wcuda.SOURCE) for v in SWEEP]
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        built = list(pool.map(
            lambda s: cuda_build.compile_cu(s, wcuda.BUILD_DIR, wcuda.NVCC_FLAGS), sources))
    base = wcuda.SOURCE
    try:
        for var, src, (_, log) in zip(SWEEP, sources, built):
            wcuda.SOURCE, wcuda._lib = src, None
            ms, _ = time_ms(lambda: wcuda.tree_forces_cuda(
                pos_new, ss.pos, ss.mass, tree, params, tp), 3)
            regs = [(r, st) for _, r, st, _ in ptxas_kernels(log)]
            print(f"sweep {label} arena {var or 'as built'}: {ms:.3f} ms over all receivers "
                  f"(pack and walk); registers and spill stores {regs}; [{smi}]")
    finally:
        wcuda.SOURCE, wcuda._lib = base, None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tree_walk_study")
    parser.add_argument("--sweep", action="store_true", help="sweep the launch constants")
    parser.add_argument("--host", action="store_true", help="also the host-built arena")
    parser.add_argument("--sass-dir", help="write the SASS listings here")
    parser.add_argument("--n", type=int, default=N_TREE)
    parser.add_argument("--scene", choices=["uniform", "disc"], default="uniform")
    parser.add_argument("--theta", type=float, default=0.75)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("tree_walk_study needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi, mhz = card(), max_sm_clock_mhz()
    print(f"{smi}; maximum SM clock {mhz:.0f} MHz")
    lib, log = wcuda.build()
    print_ptxas(log)
    print_walk_sass(lib, args.sass_dir)

    n = args.n
    params = SimParams(particle_num=n)
    tp = TreeParams(theta=args.theta, walk="per_particle")
    print(f"scene {args.scene}, N={n}, theta={tp.theta}")
    state = INITS[args.scene](torch.Generator().manual_seed(0), params, dev)
    ss, tree, _, pos_new = sorted_scene(state, params, tp)
    study_arena("device", pos_new, ss, tree, params, tp, dev, smi, mhz)
    if args.sweep:
        sweep("device", pos_new, ss, tree, params, tp, smi)
    del tree

    if args.host:
        tph = TreeParams(theta=args.theta, walk="per_particle", leaf_bucket=1)
        t0 = time.perf_counter()
        host = build_host_tree(ss.pos.cpu().numpy(), ss.mass.cpu().numpy(),
                               tph.effective_capacity_factor)
        print(f"host build of N={n}: {time.perf_counter() - t0:.3f} s, "
              f"{host.nodes_f32.shape[0] - 1} nodes")
        order = torch.from_numpy(host.order).to(dev)
        hs = type(ss)(*(t[order] for t in ss))
        htree = host_tree_arrays(host, dev)
        study_arena("host", pos_new[order], hs, htree, params, tph, dev, smi, mhz)
        if args.sweep:
            sweep("host", pos_new[order], hs, htree, params, tph, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
