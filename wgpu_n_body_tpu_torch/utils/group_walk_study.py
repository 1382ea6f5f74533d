"""Development measurements of the group walk kernels (B4) on a CUDA card.

    python -m wgpu_n_body_tpu_torch.utils.group_walk_study [--sweep] [--sass-dir DIR]

Prints, each timed line with the card's name and power limit:
- ptxas's registers and spills of the kernels, and the SASS loops of the
  evaluation kernel that evaluate pairs: instructions and MUFU ops per pair,
  from ``cuobjdump -sass`` (listings to ``--sass-dir``);
- with ``--sweep``: the kernels rebuilt from copies of their source with
  other values of the launch constants (``kMinBlocks``, ``kStages``,
  ``kChunk``, ``kUnroll``, ``kWalkWarps``), each timed at N=4M uniform
  theta=0.75 and N=2M disc theta=0.5 with the source as built first and
  last, and the walk kernel over all, half and a quarter of the N=4M tiles.
``list_counts`` counts the nodes and members of each tile's list. Builds go
to the git-ignored ``_build/``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import sys

import torch

from wgpu_n_body_tpu_torch.inits import disc_init, uniform_init
from wgpu_n_body_tpu_torch.ops import cuda_build
from wgpu_n_body_tpu_torch.ops import tree_walk_group as twg
from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams
from wgpu_n_body_tpu_torch.utils.chip import (
    N_TREE,
    card,
    max_sm_clock_mhz,
    print_ptxas,
    print_sass,
    ptxas_kernels,
    sorted_scene,
    time_ms,
    variant_source,
)

#: Launch-shape variants of the sweep; {} is the source as it stands.
SWEEP = ([{}] + [{"kStages": st, "kMinBlocks": mb} for st in (2, 3, 4) for mb in (4, 5, 6)]
         + [{"kChunk": c} for c in (128, 512)] + [{"kUnroll": u} for u in (2, 4, 32)]
         + [{"kWalkWarps": w} for w in (2, 8)] + [{}])


def scene(init, n, tp, dev):
    """(sorted state, tree, tiles, drifted positions, params) of one step."""
    params = SimParams(particle_num=n)
    ss, tree, keys, pos_new = sorted_scene(init(torch.Generator().manual_seed(0), params, dev),
                                           params, tp)
    return ss, tree, twg.tile_setup(keys, n, tp), pos_new, params


def list_counts(lists: twg.GroupLists, table: torch.Tensor,
                cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(nodes, members), (t_cap,) int64 each: the rows of each tile's list
    whose row of ``table`` (the walk's ``source_table``, whose node rows end
    at the massless row ``cap``) has mass, node ids (<= cap) and member ids
    apart. Massless rows (sentinels, unused arena rows, the hops between
    import buffers) are not counted, so walks of the same trees count alike
    however their forest is laid out (the fused LET walk against the split
    one in ``chip_smoke.py`` 17c and the tests). A bad or pool_full tile
    counts what its walk emitted before it stopped."""
    t_cap, mc = lists.chunks.shape
    dev = lists.chunks.device
    live = lists.chunks >= 0
    tile = torch.arange(t_cap, device=dev)[:, None].expand(t_cap, mc)[live]
    chunk = torch.arange(mc, device=dev)[None, :].expand(t_cap, mc)[live]
    row = chunk[:, None] * twg.LIST_CHUNK + torch.arange(twg.LIST_CHUNK, device=dev)
    ids = lists.ids.view(-1, twg.LIST_CHUNK)[lists.chunks[live].long()].long()
    ids = torch.where(row < lists.rows[tile][:, None], ids, cap)  # past the list: row cap
    heavy = table[ids, 3] != 0
    nodes = torch.zeros(t_cap, dtype=torch.int64, device=dev)
    members = torch.zeros(t_cap, dtype=torch.int64, device=dev)
    nodes.index_add_(0, tile, (heavy & (ids <= cap)).sum(1))
    members.index_add_(0, tile, (heavy & (ids > cap)).sum(1))
    return nodes, members


def sweep(dev, smi):
    """The kernels' launch constants on BASELINE's two tree configs:
    N=4M uniform theta=0.75 (walk_tile 512, four receivers per thread) and
    N=2M disc theta=0.5 (walk_tile 256, two per thread)."""
    sources = [variant_source(v) for v in SWEEP]
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        built = list(pool.map(
            lambda s: cuda_build.compile_cu(s, gcuda.BUILD_DIR, gcuda.NVCC_FLAGS), sources))
    scenes = {"uniform 4M": (uniform_init, N_TREE, TreeParams()),
              "disc 2M theta=0.5": (disc_init, 2_000_000, TreeParams(theta=0.5))}
    scenes = {k: (tp, *scene(init, n, tp, dev)) for k, (init, n, tp) in scenes.items()}
    base, chunk = gcuda.SOURCE, twg.LIST_CHUNK
    try:
        for var, src, (_, log) in zip(SWEEP, sources, built):
            gcuda.SOURCE, gcuda._lib = src, None
            twg.LIST_CHUNK = gcuda.LIST_CHUNK = var.get("kChunk", chunk)
            times = []
            for label, (tp, ss, tree, tiles, pos_new, params) in scenes.items():
                ms_walk, lists = time_ms(
                    lambda: gcuda.group_walk_lists_cuda(pos_new, tree, tiles, tp), 5)
                ms_eval, _ = time_ms(lambda: gcuda.group_eval_lists_cuda(
                    pos_new, ss.pos, ss.mass, tree, tiles, lists, params), 5)
                times.append(f"{label}: walk kernel {ms_walk:.3f} ms, evaluation kernel "
                             f"{ms_eval:.3f} ms")
            regs = [(r, st) for _, r, st, _ in ptxas_kernels(log)]
            print(f"sweep {var or 'as built'}: {'; '.join(times)}; registers and spill stores "
                  f"{regs}; [{smi}]")
    finally:
        gcuda.SOURCE, gcuda._lib = base, None
        twg.LIST_CHUNK = gcuda.LIST_CHUNK = chunk
    tp, ss, tree, tiles, pos_new, params = scenes["uniform 4M"]
    # latency or issue: the walk kernel over the first half and quarter of
    # the tiles (one wave either way)
    nt = int((tiles.piece_len > 0).sum())
    for part in (1, 2, 4):
        sub = tiles._replace(t_cap=nt // part, piece_start=tiles.piece_start[: nt // part],
                             piece_len=tiles.piece_len[: nt // part])
        ms_walk, _ = time_ms(lambda: gcuda.group_walk_lists_cuda(pos_new, tree, sub, tp), 5)
        print(f"sweep walk kernel over {nt // part} of {nt} tiles: {ms_walk:.3f} ms; [{smi}]")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="group_walk_study")
    parser.add_argument("--sweep", action="store_true", help="sweep the launch constants")
    parser.add_argument("--sass-dir", help="write the SASS listings here")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("group_walk_study needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card()
    print(f"{smi}; maximum SM clock {max_sm_clock_mhz():.0f} MHz")
    lib, log = gcuda.build()
    print_ptxas(log)
    print_sass("eval", lib, "group_eval_kernel", args.sass_dir)
    if args.sweep:
        sweep(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
