#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --only graph [--repo DIR]   # phases 1 and 21 alone

Phases (any failure exits non-zero):
 1. a CUDA device is present; print the card's name and power limit;
 2. build every kernel from ``wgpu_n_body_tpu_torch/csrc`` (one nvcc per
    source, all started together: B1 and B2 share ``naive_forces.cu``; the
    key kernel K1 shares ``morton_keys.cu`` with CUB's radix sort; the tile
    set-up B4 · T (``tile_setup.cu``) takes its wait limit from B7's chained
    scan, ``chained_scan.cuh``; B8 is ``import_forest.cu``; E1 is
    ``energy.cu``) and,
    beside them, the host octree library from ``native/octree.cpp`` with g++;
    print each all-pairs instantiation's registers and spills;
 3. hold B1 against its plain torch version on the card: small ragged
    inputs, receiver shards (``row_offset``), coincident-pair NaN, and at
    N=262144 both against a float64 evaluation (sampled rows of the main
    path's full launch, and 512-row shards launched with their
    ``row_offset``);
 4. time B1 and its plain version at N=262144 with CUDA events, and check
    that two launches give the same bits; 4b. time B1 and B2 at N=100000
    and N=16384 beside the plan each launch used (CTAs, waves, source
    splits): two launches bit-equal, the split launch against the plain
    version on sampled rows and against one unsplit launch, with a gate
    that a planted fault (one ring stage's or one slice's sources dropped)
    must exceed;
 5. run ``cli headless --sim naive --n 262144 --steps 10 --energy-every 5``
    in-process and check that each step launched B1 once, each of the two
    energy lines E1 once, and the state is sane;
 6. three NaiveSim steps at N=16384, kernel vs plain version;
 7. report the tree kernels' builds (B3, B4, B4 · T, B5 with K2, K1, B6,
    B7, B8, E1): registers and spills;
 8. B2 against its plain factored version: small ragged inputs and
    shards, N=262144 against float64 (as 3), timed beside the plain version, and
    ``NaiveSim(mxu=True)`` through ``OfflineHeadless`` at N=262144;
    two launches bit-equal;
 9. the plain Morton sort and octree build on the card against the same
    on the CPU at N=262144 (packed keys, permutation and arena integers
    equal), and the build kernels (K2, the reorder, then B5's three) against
    the plain reorder and build on the card (sorted state, split and window
    levels bit-equal, integers equal, ``nodes_f32`` within rtol 1e-6 on
    every row): that scene
    at buckets 1, 16, 32 and with an overflowing arena, the small and odd
    inputs of ``ops/tree_build_cases.py``, the main path's N=4,000,000
    uniform state (timed beside the plain version and the bytes bound, two
    builds bit-equal) and the N=2,000,000 disc scene. The plain version is
    held both on the kernels' float64 prefix sums and on its own; the
    kernels' sums against ``torch.cumsum``'s; 9f. the sort stage (K1, the
    key kernel with the bound's reduction; CUB's stable sort on 3*depth
    bits; K2) bit-equal to its plain version at N=262144 with ties, depths
    5 and 20, N=2M disc and the N=4M scene before and after one step, a
    planted fault (two tied bodies swapped, a key bit flipped) caught, and
    K1, both sorts (CUB's, ``torch.sort``'s), K2 and the build timed at N=4M;
10. B3 against the plain walk on 4096 sampled receivers of the N=4M tree
    (each receiver's counts of accepted nodes and of members equal to the
    plain rules', forces within a per-row p99 of 1e-5, which a planted fault
    (one accepted node per receiver made massless) must exceed; two launches
    bit-equal), both against float64 all-pairs, theta=0 against B1, the
    overfull-cell and overflow cases, and the full N=4M walk timed beside
    its bound, listed (the group walk's fallback mode) over every receiver
    bit-equal to it, and on 4096 consecutive receivers;
11. run ``cli headless --sim tree --tree-kw walk='"per_particle"' --steps
    10`` in-process at the default N=4,000,000 and check that each step
    launched K1, K2, the build (B5), B3 and one records-only pack once
    (and the diagnostics one sort and build more and its group walk, B4 · T,
    the table's pack, B4 and B3 once), the state is sane and the checkpoint
    reloads; 11b: one traced step of that state, whose counters
    ``walk.pp_*`` (every 64th warp walked again by B3's counting
    instantiation) equal one full counting launch's sums on the same warps,
    and whose state equals the untraced step's bit for bit;
12. the group walk kernels (B4: a walk kernel writing each tile's list of
    ids, an evaluation kernel summing them) against their plain versions on
    every tile at N=262144 (uniform and disc, walk_tile 128/256/512: list
    ids, deferred tiles, step and row counts equal; forces on the same
    lists within a per-row p99 of 1e-5), hand-made partial tiles of 1 to 511
    receivers on one full tile's list, each row bit-equal to the full
    tile's and the kernel's pair counter equal to rows x 32 x live blocks
    (12h, walk_tile 512/256/128), against float64 all-pairs and B3
    on 2048 receivers of the N=4M tree, at theta=0 against B1, with every
    tile deferred against B3, with a list pool too small (12d), the full
    N=4M walk timed stage by stage beside B3 and its SFU bound (12e), and
    the list pool's use at N=2,000,000 disc theta=0.5 (BASELINE's tree
    measurement config), where no tile may find the pool empty and a traced
    TreeSim step's ``walk.pool_chunks`` equals the walk's own count (12f); the
    walk's glue (12i: its tables in one pack launch, the list of deferred
    receivers from the walk kernels, B3 over that list into
    ``acc`` in place) held bit for bit to the composition it replaced (the
    eager table, the masks gathered per receiver, B3 over the mask, the
    merge) on the same lists: tables, ``acc``, the lazy masks and the list
    against its plain version, on the three cells' scenes (each
    composition's device time beside the tables' bytes bound), every tile
    over its step budget, a pool too small, spills past the tile budget, a
    slice of the receivers and a LET import walk. Every
    walk there takes its tiles from B4 · T (``tile_setup_cuda``), held equal
    field for field to the plain ``tile_setup`` on the same split levels and
    on the keys' (12a, 12d-12f); 12e also times B4 · T at N=4M beside its
    plain version and its bytes bound, launches it twice (bit-equal) and
    catches one planted split level; 12g holds it on its edges: 48 bodies
    of 5,000 at one point each (overfull max-depth cells, groups longer
    than a block), random and all-zero split levels that spill past the
    tile budget, N=1, 300 < walk_tile, walk_tile 1 and 2, N off and on the
    block size;
13. run ``cli headless --steps 10`` in-process with no ``--tree-kw`` (TreeSim,
    group walk, N=4,000,000) and check that each step launched K1, K2 and
    the build (B5: its other three kernels, one launcher call) once, B4 · T
    once, the walk's tables (one pack launch) once, both B4 kernels once and
    B3 once (its fallback over the walk kernel's list of deferred receivers),
    the diagnostics (nothing deferred, none for the pool), the
    checkpoint and the mass multiset; and that B4 · T's tiles from the
    build's split levels equal the plain tile_setup's on the last state;
14. the tree-host path, where B3 is the whole force: one host build of the
    N=4M uniform scene (``native/octree.cpp``), B3 on its arena for 4096
    consecutive and 4096 sampled receivers against the plain walk on the same
    arena (counts equal, p99 1e-5) and float64 all-pairs, and timed over all
    receivers beside its own bound (14a); host arena against device arena
    with singleton leaves at N=262144: rtol 5e-4, atol 1e-8 on every row
    whose two walks have the same counts and that lies away from every body
    the float32 Morton key puts in a neighbouring cell, the other rows
    counted and held to 0.03; the host's DFS order against ``morton_sort``
    (14b); ``cli headless --sim tree-host
    --steps 3`` in-process at the default N=4,000,000 (at N=1,000,000 if one
    host build takes more than 15 s): exactly 3 B3 launches and no other
    kernel, finite state, mass multiset, the checkpoint reloads as a
    ``TreeSim`` with ``leaf_bucket=1``, and one more step timed stage by
    stage (14c).
15. the rendering path (B6, ``csrc/raster.cu``): 15a the raster kernels'
    counts bit-equal to their plain version on the card and to the host
    render (``runners/renderer.py::render_counts``) on the CPU tests' scenes
    (uniform, splat, near-lens, shell, 296 near-lens bodies, NaN and
    behind-camera rows), on the visualize scene (TreeSim N=100,000 disc after
    10 steps) at the default camera and at a camera flown forward until at
    least 1,000 footprints leave the per-thread 8 x 8 box (also through a
    fresh workspace that lists only 64 triangles, whose other wide
    footprints raster_kernel draws itself), and on the N=4M uniform headless
    scene, unsorted and after one ``cli headless`` step (Morton-sorted, as
    TreeSim hands the renderer every later state); the triangles the tile
    kernel drew equal to the plain ones of the bodies whose box passes 8 x 8
    px; two launches bit-equal; the u8 blend equal to the plain LUT; 15b
    each scene's raster and blend timed beside the plain version, with the
    bytes bound, the hits of each kernel, the list's length and the device
    ops per frame; 15c ``cli visualize --gif`` at its defaults (60
    PNGs and a GIF, 60 raster launches and one tree step each, a frame held
    against the host render of the same positions, µs/step); 15d ``cli
    render`` of a trajectory ``cli headless --trajectory`` wrote; 15e
    ``serve`` through ``make_server(port=0)``: the page, 40 flythrough frames
    each equal to the host render of its pre-step state, ``focus=0`` not
    stepping, ``/quit``, frame-time p50 and fps, one raster and one blend
    launch per frame.
16. the LET export walk (B7, ``csrc/let_export.cu``) against its plain
    version on the card, every output bit for bit: n_local=4,000,000 bodies
    uniform in octant 0 of [-1, 1]^3, theta=0.75, let_cap = auto_let_cap
    (98,304), the other octants' boxes as destinations at P=8 and P=4 (the
    geometry of the JAX package's ``tools/measure_let.py --geometry
    octants``), both timed (by CUDA events with the enqueue, and the device
    time of each launch from the profiler) beside the plain version and the
    bytes bound; P=12 (octants 0-3 again as destinations 8-11, self 8: two
    launches of the scan-and-emit kernel, destinations 9-11 bit-equal to
    1-3, the own octant as a foreign box overflowing); theta=0 (every row to every other octant,
    N=262144) and a planted overflow (let_cap 4096: the DFS prefix kept, the
    flags set); 16c the fused LET walk's import forest (B8,
    ``csrc/import_forest.cu``) against its plain version, every output bit
    for bit: the P=8 exports as the imports of one rank whose local tree is
    the n_local=4M octant arena, at the fused walk's cap (2.5 let_caps) and
    at half the kept rows (a planted overflow), timed by CUDA events and by
    device time beside its bytes bound;
17. the LET step of P=4 ranks of 4,000,000 bodies (N=16M, the four top
    Morton quadrants' slabs of the uniform scene) emulated on one card: the
    port's per-rank stages (``parallel/sharded_tree.py``: sort and build,
    B7, the tiles both walks share, the local and the import walk) in turn,
    the boxes' gather and the all_to_all done by hand, each stage timed per
    rank beside the single-device default step at N=16M; ``let_forces``
    launching B4 · T once per rank and B4 twice; forces on 4,096 sampled
    receivers held to ``tests/test_let.py:68``'s criteria against float64
    all-pairs;
    B3 over an import forest with self_idx past every source against the
    plain walk, and as the group walk's fallback; 17c the fused walk
    (``let_fused=True``) on the same exports: ``let_forces`` launching
    B8, B4 · T, B4 and B3 once per rank, each tile's counts of accepted
    nodes and members equal to the split walk's two where no walk deferred
    it, forces within a per-row p99 of 1e-4 of the split walk's and
    within ``tests/test_let.py:68``'s criteria against float64, B8 and the
    fused walk timed per rank in turns with the split walk's two walks
    (split, fused, fused, split), and rank 0's local, import and fused walks
    by kernel (the profiler's device time); 17b the exports' rows of a
    uniform N=16M scene owned as four slices of the global Morton order (a
    reshard's ownership, with ragged ends);
18. this slice's main path: a one-rank NCCL process group running
    ``ShardedNaiveSim`` (allgather, ring; N=262144) and ``ShardedTreeSim``
    (replicated, let, and let with the fused walk; N=4,000,000) through
    ``OfflineHeadless`` for 6 steps in chunks of 3, each held to its
    single-device sim (pos rtol 1e-5, vel and acc rtol 1e-4) with its
    launches counted (B7 and B4 · T once per LET step, B4 twice; the fused
    walk B8 and B4 once) and its time per step beside the single-device one;
    the naive runs log the total energy at their last step (E1 over the
    rank's share, summed by ``all_reduce``), equal to the single device's at
    rtol 1e-6; 18b ``cli bench`` through the group (``cli.run_rank``: each
    point of the sweep 8192·{1,2,4,8,16} for naive and tree on the sharded
    sims, JAX's keys, 12 steps a point counted) beside one device's, ``cli visualize`` (60 frames, the
    last against the host render of the gathered positions) and a 40-frame
    ``serve`` flight (each frame against the host render of the gathered
    pre-step state) through the group, beside phase 15's;
19. the potential energy (E1, ``csrc/energy.cu``): 19a the whole state at N=16384 of the uniform, disc and
    spherical scenes against the plain version in float64 (relative error
    <= 1e-5, the plain float32 version's beside it), each with one body made
    massless, which must fail that gate; 19b N=262144 (the naive main
    path's energy) timed beside the plain float32 version, two launches
    bit-equal, five shares summing to the whole within 1e-12, share 7 of 32
    against float64, and the disc scene timed (the most near pairs); 19c
    the N=4,000,000 uniform scene of ``cli headless`` evaluated once, timed
    by CUDA events beside its bound, and share 1234 of 4096 against
    float64; 19d E1's pair arithmetic (``energy_probe``: the kernel's tile
    pass over one source at each r, so its clamp, near-pair bits and the
    closed form after the tile) at r = 0, both sides of r_s and
    geomspace(1e-3 a, 4) against float64 I(r) (relative <= 1e-5) for
    e = 1e-4, 1e-5, 1e-2, 1/r too, with the switch planted at 1.2a, which
    must fail; 19e SASS instructions and MUFU ops per far pair of its pair
    loop (``cuobjdump``, where the toolkit has it);
20. 20a ``cli headless --steps 10 --energy-every 10`` at the defaults
    (TreeSim N=4M): the step's launches and one E1, one finite energy; 20b
    ``python -m wgpu_n_body_tpu_torch.bench`` in a subprocess, its one JSON
    line parsed (``bench.py``'s keys); 20c the drift proxy of
    ``tests/test_runners.py:146-160`` (N=512 spherical, 10,000 steps in
    chunks of 1000, |dE/E| < 3e-2) and BASELINE config 5 (N=4096, 100,000
    steps, |dE/E| finite and < 0.1), both through ``OfflineHeadless`` with
    B1 and E1, the drift and the wall seconds printed;
21. the graphed TreeSim step (``models/step_graph.py``) on the four step
    cells' configurations (N=4M uniform and disc, group walk; N=2M disc at
    theta=0.5; N=4M uniform, per-particle walk): 21a twelve calls (the
    first, the capture, ten replays with a rewind before the eighth to a
    copy of the fifth's output) bit-equal on every field to the eager step,
    the capture cut into one graph per innermost range with the counters
    as eager work, the memory reserved before and after the capture, and a
    traced replay's counters equal to a traced eager step's; 21b a planted
    arena overflow (a clustered state handed in at the 8th call) raises at
    the end of its batch through ``OfflineHeadless`` at chunk 1 and 3; 21c
    no ``aten::_local_scalar_dense`` in three traced graphed runner steps;
    21d the N=2M disc step's split graphs against one whole-step graph, in
    turns; 21e with ``--repo DIR`` (another checkout), the cell
    ``disc-2m-theta05`` through each checkout's ``nbody_bench/run.py``,
    untraced and traced, in turns (parent, change, change, parent). Phases
    11 and 13 run ``cli headless`` on the graphed step: the launches their
    wrappers count are those of the two plain calls and the two captures,
    and each replay launches what one capture counted.
Every kernel's record has its bound: the larger of its special-function
ops at 16 per SM per clock (at the card's maximum SM clock, nvidia-smi's
``clocks.max.sm``), its float32 flops at 67 TFLOP/s and its bytes at
3.35 TB/s (the bytes bind B5 and K1, the special-function ops the others).
B6's bound is the larger of its bytes (12 per body, 9 per pixel, 4 per
listed body) at 3.35 TB/s and its float32 operations (20 per body, 6 per
candidate pixel) at 67 TFLOP/s; its record's times are the visualize
scene's (raster and blend), its launches those of ``cli visualize`` and,
as ``launches_blend``, those of the served frames.
B7's bound is its bytes (the arena rows some destination visits, the
member rows it copies and every output slot) at 3.35 TB/s; its record's
times are phase 16's at P=8, its launches phase 18's. B8's bound is its
bytes (each live local arena row, read back after the build, and each kept
import row read and written once, 44 bytes; the row that jumps to the
imports written; each local body and kept part, 16 bytes) at 3.35 TB/s; its times are
16c's (``ms`` by CUDA events, ``device_ms`` beside), its launches those of
phase 18's fused LET run. B4 · T's bound is its
bytes (the split levels read; tile_id (int64), slot (int32) and deferred per
receiver and two int32 per tile written) at 3.35 TB/s; its times are phase 12e's at
N=4M, its launches phase 13's. B7's ``ms`` is the CUDA-event time per call,
as in every earlier record of it, with ``device_ms`` (its launches' device
time from the profiler) and ``device_share`` beside it. B4 · T, whose
wrapper takes longer to enqueue than the card to run it, has the device
time as ``ms`` and the CUDA-event time as ``events_ms``. The records of
B4 · T and B6, redesigned after commit f59feb3, carry ``design`` and their
device ops per call or frame (the earlier design's times, measured in turns
by ``utils/tile_raster_study.py``, are in PERF.md, not in the records).
E1's bound is ``bound``'s, from the operations of a far-field pair of the
function (``ENERGY_MUFU_PER_PAIR``, ``ENERGY_FLOPS_PER_PAIR``: 1 MUFU and
21 float32 flops), and its bytes (16 per body). Its record's times are
phase 19b's at N=262144 (the N=4M evaluation as ``n4m``), its launches
those of 20a (``cli headless --energy-every`` at the defaults) and, as
``launches_naive_cli``, phase 5's.
K1's and B5's times are on the main path's input (the N=4M state one step
after the initial one); K1's record carries the sort's times. B3's
record carries the tree-host path's launches; its times, bound and error
are those of the build kernels' arena (``arena``), and its figures on the
host arena and on the per-particle path are extra keys.
The helpers it shares with the development studies (the card's label,
the timers, the bounds, the ptxas and SASS readers, the scenes) are
``wgpu_n_body_tpu_torch/utils/chip.py``'s; this script runs no study.
The last two lines are a JSON record of the kernels and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from collections import Counter

import numpy as np
import torch

from wgpu_n_body_tpu_torch.utils.chip import (
    FP32_PEAK,
    HBM_PEAK,
    N_LOCAL,
    N_TREE,
    N_VIS,
    RASTER_SMALL_BOX,
    VIS_DT,
    VIS_G,
    VIS_STEPS,
    bound,
    card,
    device_ms,
    flythrough_camera,
    headless_after_one_step,
    launch_split,
    max_sm_clock_mhz,
    octant_boxes,
    octant_local,
    print_ptxas,
    ptxas_kernels,
    sass_loops,
    sorted_scene,
    time_ms,
    visualize_pos,
)

N_MAIN = 262144
STEPS = 10
STEPS_MXU = 5


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def row_rel_err(got, want):
    """Per-row relative L2 error |got_i - want_i| / |want_i| (float64)."""
    got, want = got.double(), want.double()
    return ((got - want).norm(dim=1) / want.norm(dim=1)).cpu().numpy()


def run_cli(cli, argv):
    """cli.main(argv) in-process; echoes its output and returns it."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print("\n".join("  | " + line for line in out.splitlines()))
    if rc != 0:
        fail(f"cli {' '.join(argv)} returned {rc}")
    return out


def cuda_state(n, seed, dev):
    """(pos_new, pos_old, mass) of a ragged small scene (tests/test_naive.py)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vel = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    pos_new = (pos + np.float32(0.01) * vel).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (pos_new, pos, mass))


def main_state(params, dev, n=N_MAIN):
    """(pos_new, pos_old, mass) of the uniform scene of n bodies (the main
    path's N=262144 by default), one drift."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vel = (rng.uniform(-1, 1, (n, 3)) * 0.001).astype(np.float32)
    pos_new = (pos + vel * np.float32(params.dt)).astype(np.float32)
    return (torch.from_numpy(pos_new).to(dev), torch.from_numpy(pos).to(dev),
            torch.ones(n, device=dev))


NO_LIBRARY = ("none: no single PyTorch call computes softened gravity over pairs or a "
              "tree walk")


@contextlib.contextmanager
def pool_of(gcuda, n_chunks):
    """The group walk wrapper's list pool set to ``n_chunks`` chunks."""
    saved = gcuda.pool_chunks
    gcuda.pool_chunks = lambda n: n_chunks  # the wrapper sizes its pool by this
    try:
        yield
    finally:
        gcuda.pool_chunks = saved


def zero_launch_counts():
    from wgpu_n_body_tpu_torch.ops import (
        energy_cuda,
        import_forest_cuda,
        let_export_cuda,
        morton_cuda,
        naive_cuda,
        raster_cuda,
        tree_build_cuda,
        tree_walk_cuda,
        tree_walk_group_cuda,
    )

    naive_cuda.LAUNCHES = naive_cuda.LAUNCHES_MXU = tree_walk_cuda.LAUNCHES = 0
    tree_walk_cuda.LAUNCHES_TABLES = 0
    import_forest_cuda.LAUNCHES = 0
    tree_walk_group_cuda.LAUNCHES = tree_walk_group_cuda.LAUNCHES_EVAL = 0
    tree_walk_group_cuda.LAUNCHES_TILES = 0
    tree_build_cuda.LAUNCHES = tree_build_cuda.LAUNCHES_REORDER = morton_cuda.LAUNCHES = 0
    raster_cuda.LAUNCHES = raster_cuda.LAUNCHES_BLEND = let_export_cuda.LAUNCHES = 0
    energy_cuda.LAUNCHES = 0


def launch_counts():
    """Launches since ``zero_launch_counts``: K1 the key kernel, K2 the
    reorder (B5's first kernel), B5 the builds, each of which enqueues its
    other three kernels once; "B4 tiles" the group walk's tile set-ups
    (B4 · T: one kernel each); "B4 tables" its tables (one pack launch of
    B3's source each; B3 counts the walks over its deferred list); B6 the frames' rasters
    (raster_kernel, then raster_tile_kernel), "B6 blend" their
    u8 blends; B7 the LET exports (each a memset, the scan-and-emit kernel
    per 8 destinations and the tail kernel); B8 the fused LET walk's
    import forests (one kernel each); E1 the potential energies (the pair
    kernel, then the blocks' sum)."""
    from wgpu_n_body_tpu_torch.ops import (
        energy_cuda,
        import_forest_cuda,
        let_export_cuda,
        morton_cuda,
        naive_cuda,
        raster_cuda,
        tree_build_cuda,
        tree_walk_cuda,
        tree_walk_group_cuda,
    )

    return {"B1": naive_cuda.LAUNCHES, "B2": naive_cuda.LAUNCHES_MXU,
            "B3": tree_walk_cuda.LAUNCHES, "B4": tree_walk_group_cuda.LAUNCHES,
            "B4 eval": tree_walk_group_cuda.LAUNCHES_EVAL,
            "B4 tiles": tree_walk_group_cuda.LAUNCHES_TILES,
            "B4 tables": tree_walk_cuda.LAUNCHES_TABLES, "B5": tree_build_cuda.LAUNCHES,
            "K1": morton_cuda.LAUNCHES, "K2": tree_build_cuda.LAUNCHES_REORDER,
            "B6": raster_cuda.LAUNCHES, "B6 blend": raster_cuda.LAUNCHES_BLEND,
            "B7": let_export_cuda.LAUNCHES, "B8": import_forest_cuda.LAUNCHES,
            "E1": energy_cuda.LAUNCHES}


def expected_counts(**counts):
    """``launch_counts``' keys, 0 but where given (``B4_eval`` for "B4 eval",
    ``B4_tiles`` for "B4 tiles", ``B4_tables`` for "B4 tables", ``B6_blend`` for
    "B6 blend")."""
    keys = ("B1", "B2", "B3", "B4", "B4 eval", "B4 tiles", "B4 tables", "B5", "K1", "K2", "B6",
            "B6 blend", "B7", "B8", "E1")
    return {k: counts.get(k.replace(" ", "_"), 0) for k in keys}


#: The all-pairs kernels' smaller sizes: the visualize scene and the size
#: sweep's 2 x 8192 (ROADMAP A10), where receiver CTAs alone underfill the card.
SMALL_N = (100_000, 16_384)


def naive_bytes(n):
    """Bytes an all-pairs force call must move: receivers, source
    positions and masses in, the force out (float32)."""
    return n * (12 + 12 + 4 + 12)


def naive_registers(rows, factored):
    """(registers, spill store bytes) of the all-pairs kernel of one form
    at four receivers per thread (tile_i 512, the main path's); None, None
    when the library was already built (no compiler output)."""
    if not rows:
        return None, None
    for name, regs, stores, _ in rows:
        if "naive_forces_kernel" in name and f"Lb{int(factored)}ELi4E" in name:
            return regs, stores
    fail(f"ptxas reported no {'factored' if factored else 'dx-form'} kernel at 4 per thread")


def plan_record(plan):
    return {**plan._asdict(), "waves": plan.waves}


def float64_rows(kernel, plain, pn, po, m, params):
    """Per-row relative errors against the float64 dx-form on four 512-row
    samples of the N=262144 scene: (rows of one full launch of ``kernel``
    at tile_i 512 / tile_j 2048, as the main path launches it; each sample
    launched as a shard with its ``row_offset``; the float32 ``plain``
    version)."""
    from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_ref

    k_full = kernel(pn, po, m, params, 0, 512, 2048)
    po64, pn64, m64 = po.double(), pn.double(), m.double()
    errs = ([], [], [])
    for a in (0, 65536 + 100, 131072 + 1000, N_MAIN - 512):
        b = a + 512
        t = naive_forces_ref(pn64[a:b], po64, m64, params, row_offset=a)
        for out, got in zip(errs, (k_full[a:b], kernel(pn[a:b], po, m, params, a, 512, 2048),
                                   plain(pn[a:b], po, m, params, row_offset=a))):
            out.append(row_rel_err(got, t))
    return tuple(np.concatenate(e) for e in errs)


def phase_small_n(dev, smi, mhz):
    """4b. B1 and B2 at N=100000 and N=16384: the plan the wrapper
    launched, times beside the bound, two launches bit-equal, the split
    launch against the plain version on sampled rows and against one launch
    without a split. That last gate sits between the largest p99 of sound
    runs and that of a planted fault, which must exceed it: the same split
    launch with the sources of one ring stage, or of one whole slice,
    dropped (their masses zeroed)."""
    from wgpu_n_body_tpu_torch.ops import naive_cuda
    from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_mxu_ref, naive_forces_ref
    from wgpu_n_body_tpu_torch.params import SimParams

    rows = []
    for n in SMALL_N:
        params = SimParams(particle_num=n)
        pn, po, m = main_state(params, dev, n)
        src = torch.cat([po, (m * (params.g * params.dt))[:, None]], 1)
        b = bound(float(n) * n, 2, 20, naive_bytes(n), mhz)
        # gates: the plain version as phases 4 and 8c; the unsplit launch
        # differs in summation order only, which moves the dx-form's rows
        # far less than the factored form's (~2e-4 p99 from float64). Sound
        # runs read p99 up to 1.1e-6 (B1) and 5.8e-5 (B2), PERF.md.
        for mxu, label, plain, gate, gate_one in (
                (False, "B1", naive_forces_ref, 2e-4, 1e-5),
                (True, "B2", naive_forces_mxu_ref, 2e-3, 2e-4)):
            def call(mxu=mxu):
                return naive_cuda.naive_forces_cuda(pn, po, m, params, mxu=mxu)

            ms, k = time_ms(call, 20)
            plan = naive_cuda.LAST_PLAN_MXU if mxu else naive_cuda.LAST_PLAN
            one = plan._replace(splits=1, slice_len=n)

            def unsplit(mxu=mxu, one=one):
                return naive_cuda.run_plan(pn, src, one, params.e, mxu=mxu)

            ms_one, k_one = time_ms(unsplit, 20)
            again = call()
            torch.cuda.synchronize()
            if not torch.equal(k, again):
                fail(f"{label} N={n}: two launches of the same plan differ")
            errs = np.concatenate([
                row_rel_err(k[a:a + 512], plain(pn[a:a + 512], po, m, params, row_offset=a))
                for a in (0, n // 2 + 100, n - 512)])
            p99 = float(np.percentile(errs, 99))
            d_one = row_rel_err(k, k_one)
            p99_one = float(np.percentile(d_one, 99))
            y0 = plan.splits // 2 * plan.slice_len  # the middle slice
            stage = naive_cuda.kernel_limits(dev, mxu).min_slice
            planted = {}
            for what, hi in (("stage", y0 + stage), ("slice", min(y0 + plan.slice_len, n))):
                bad = src.clone()
                bad[y0:hi, 3] = 0.0
                k_bad = naive_cuda.run_plan(pn, bad, plan, params.e, mxu=mxu)
                planted[what] = float(np.percentile(row_rel_err(k_bad, k_one), 99))
            del bad, k_bad
            print(f"4b {label} N={n}: plan {plan.ctas} receiver CTAs x {plan.splits} source "
                  f"slices of {plan.slice_len} = {plan.ctas * plan.splits} CTAs of "
                  f"{plan.threads} threads x {plan.per_thread} receivers, {plan.waves:.3f} waves "
                  f"of {plan.slots} slots; kernel {ms:.4f} ms, without the split "
                  f"{ms_one:.4f} ms; bound {b['bound_ms']:.4f} ms: {b['bound_ms'] / ms:.2%} "
                  f"(without the split {b['bound_ms'] / ms_one:.2%}); two launches bit-equal; "
                  f"vs plain on {errs.size} rows p99 {p99:.3e} (gate {gate:.0e}); vs the "
                  f"unsplit launch p99 {p99_one:.3e} max {d_one.max():.3e} (gate p99 "
                  f"{gate_one:.0e}; planted faults p99: {stage} sources dropped "
                  f"{planted['stage']:.3e}, a slice of {plan.slice_len} dropped "
                  f"{planted['slice']:.3e}); [{smi}]")
            if not np.isfinite(errs).all() or p99 > gate:
                fail(f"{label} N={n}: the split launch disagrees with the plain version")
            if not np.isfinite(d_one).all() or p99_one > gate_one:
                fail(f"{label} N={n}: the split and the unsplit launch disagree")
            if not min(planted.values()) > gate_one:
                fail(f"{label} N={n}: the split-vs-unsplit gate misses a planted fault {planted}")
            rows.append({"kernel": label, "n": n, "ms": ms, "unsplit_ms": ms_one,
                         "bound_ms": b["bound_ms"], "ctas": plan.ctas, "splits": plan.splits,
                         "slice_len": plan.slice_len, "threads": plan.threads,
                         "per_thread": plan.per_thread, "slots": plan.slots,
                         "waves": plan.waves, "unsplit_p99": p99_one,
                         "planted_p99": planted})
        del pn, po, m, src
    return rows


def phase_b2(dev, smi, mhz):
    """8. The factored all-pairs kernel (B2) against its plain version."""
    from wgpu_n_body_tpu_torch.inits import uniform_init
    from wgpu_n_body_tpu_torch.models import NaiveSim
    from wgpu_n_body_tpu_torch.ops import naive_cuda
    from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_mxu_ref
    from wgpu_n_body_tpu_torch.params import NaiveParams, SimParams
    from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless

    tol = dict(rtol=5e-2, atol=2e-8)  # tests/test_naive.py:94-110

    def kernel(pn, po, m, params, row_offset, tile_i, tile_j):
        out = naive_cuda.naive_forces_cuda(
            pn, po, m, params, row_offset, tile_i, tile_j, mxu=True)
        torch.cuda.synchronize()
        return out

    # -- 8a. small ragged inputs, shards, coincident pair --------------------
    small = SimParams(particle_num=1000, g=1e-4, e=1e-4, dt=0.016)
    pn, po, m = cuda_state(1000, 3, dev)
    want = naive_forces_mxu_ref(pn, po, m, small)
    for ti, tj in ((64, 128), (512, 2048)):
        torch.testing.assert_close(kernel(pn, po, m, small, 0, ti, tj), want, **tol)
        for a, b in ((0, 64), (64, 192), (100, 300), (936, 1000)):
            got = kernel(pn[a:b], po, m, small, a, ti, tj)
            ref = naive_forces_mxu_ref(pn[a:b], po, m, small, row_offset=a)
            torch.testing.assert_close(got, ref, **tol)
            torch.testing.assert_close(got, want[a:b], **tol)
    pn_c, po_c, m_c = (t[:64].clone() for t in (pn, po, m))
    po_c[9] = pn_c[5]
    got = kernel(pn_c, po_c, m_c, small, 0, 64, 128)
    ref = naive_forces_mxu_ref(pn_c, po_c, m_c, small)
    if not torch.equal(torch.isnan(got), torch.isnan(ref)) or not torch.isnan(got[5]).all():
        fail("B2 coincident-pair NaN rows differ from the plain version")
    print("8a B2 n=1000, 2 tilings, shards (0,64) (64,192) (100,300) (936,1000), "
          "coincident NaN: ok (rtol 5e-2, atol 2e-8)")

    # -- 8b. N=262144 against float64: rows of the main path's launch -------
    params = SimParams(particle_num=N_MAIN)
    pn, po, m = main_state(params, dev)
    errs_k, errs_s, errs_p = float64_rows(kernel, naive_forces_mxu_ref, pn, po, m, params)
    p99_k, p99_s, p99_p = (float(np.percentile(e, 99)) for e in (errs_k, errs_s, errs_p))
    print(f"8b B2 N={N_MAIN} vs float64 over {errs_k.size} rows: kernel (full launch) p99 "
          f"{p99_k:.3e} max {errs_k.max():.3e}; 512-row shards p99 {p99_s:.3e} max "
          f"{errs_s.max():.3e}; plain factored p99 {p99_p:.3e} max {errs_p.max():.3e}")
    gate = max(1e-3, 2 * p99_p)
    for what, errs, p99 in (("kernel", errs_k, p99_k), ("shard", errs_s, p99_s)):
        if not np.isfinite(errs).all() or p99 > gate:
            fail(f"B2 {what} p99 {p99:.3e} above the gate {gate:.3e}")

    # -- 8c. time kernel and plain version at N=262144 -----------------------
    ms_k, k_full = time_ms(
        lambda: naive_cuda.naive_forces_cuda(pn, po, m, params, 0, 512, 2048, mxu=True), 5)
    ms_p, p_full = time_ms(lambda: naive_forces_mxu_ref(pn, po, m, params), 2)
    pairs = float(N_MAIN) * N_MAIN
    diff = row_rel_err(k_full, p_full)
    max_abs = (k_full - p_full).abs().max().item()
    again = naive_cuda.naive_forces_cuda(pn, po, m, params, 0, 512, 2048, mxu=True)
    torch.cuda.synchronize()
    b2_bound = bound(pairs, 2, 20, naive_bytes(N_MAIN), mhz)
    print(f"8c B2 N={N_MAIN}: kernel {ms_k:.3f} ms ({pairs / ms_k * 1e3:.4e} pairs/s, "
          f"{b2_bound['bound_ms'] / ms_k:.2%} of the {b2_bound['bound_ms']:.3f} ms bound); "
          f"plain {ms_p:.3f} ms ({pairs / ms_p * 1e3:.4e} pairs/s); kernel vs plain per-row "
          f"p99 {np.percentile(diff, 99):.3e} max {diff.max():.3e}, max|k-p| {max_abs:.3e}; "
          f"two launches bit-equal: {torch.equal(k_full, again)}; [{smi}]")
    if not np.isfinite(diff).all() or np.percentile(diff, 99) > 2 * gate:
        fail("B2 and its plain version disagree at the main path's shape")
    if not torch.equal(k_full, again):
        fail("two B2 launches at N=262144 differ")
    del pn, po, m, k_full, p_full, again
    torch.cuda.empty_cache()

    # -- 8d. NaiveSim(mxu=True) through the runner -----------------------------
    sim = NaiveSim(params, NaiveParams(mxu=True))
    runner = OfflineHeadless(sim, uniform_init, seed=0, device=dev)
    zero_launch_counts()
    runner.run(steps=STEPS_MXU, log_fn=lambda line: None)
    counts = launch_counts()
    if counts != expected_counts(B2=STEPS_MXU):
        fail(f"NaiveSim(mxu=True) {STEPS_MXU} steps launched {counts}")
    plan = naive_cuda.LAST_PLAN_MXU  # the plan of the run's last launch
    if not all(torch.isfinite(t).all() for t in runner.state[:3]):
        fail("non-finite state after the NaiveSim(mxu=True) run")
    us = runner.timer.mean_s() * 1e6
    print(f"8d NaiveSim(mxu=True) N={N_MAIN} via OfflineHeadless: {counts['B2']} launches in "
          f"{STEPS_MXU} steps, {us:.1f} us/step; [{smi}]")
    del sim, runner
    torch.cuda.empty_cache()
    return {
        "name": "naive_forces_mxu",
        "route": "cuda",
        "source": "wgpu_n_body_tpu_torch/csrc/naive_forces.cu",
        "replaces": "wgpu_n_body_tpu/ops/naive_pallas.py:130",
        "launches": counts["B2"],
        "max_abs_err": max_abs,
        "ms": ms_k,
        "plain_ms": ms_p,
        **b2_bound,
        "library_ms": None,
        "library": NO_LIBRARY,
        "plan": plan_record(plan),
    }


def compare_builds(what, k, p):
    """The kernels' arena ``k`` against the plain version's ``p`` of the same
    input on the card: integers and scalars equal, ``nodes_f32`` within rtol
    1e-6 on every row (the unused tail and the sentinel included). Returns
    (max |k - p| over nodes_f32, rows of nodes_f32 that are not bit-equal)."""
    for name in ("skip", "first", "count", "num_nodes", "overflowed", "root_width", "split"):
        a, b = getattr(k, name), getattr(p, name)
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            fail(f"9 {what}: the kernels' {name} differs from the plain version's "
                 f"({a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)})")
    if k.nodes_f32.shape != p.nodes_f32.shape or k.octets is not None:
        fail(f"9 {what}: the kernels' arena has another shape than the plain version's")
    torch.testing.assert_close(k.nodes_f32, p.nodes_f32, rtol=1e-6, atol=0,
                               msg=lambda m: f"9 {what}: nodes_f32 kernels vs plain\n{m}")
    differ = int((k.nodes_f32 != p.nodes_f32).any(1).sum())
    return float((k.nodes_f32 - p.nodes_f32).abs().max()), differ


def bits_equal(a, b):
    """Same dtype, shape and bits (a float compared as its int32 bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def held_build(what, state, perm, keys, bound_, tp, own_scan=True):
    """One input (bodies in input order, the sort's permutation and keys)
    through the kernels (the reorder K2, then B5) and the plain version
    (``reorder``, then ``build_tree``) on the card.

    The sorted state, split and window levels must be bit-equal. The plain
    build is held twice: given the kernels' float64 prefix sums
    (so only the scans' summation order is shared: every hand-written search,
    count and total is compared, and the arenas should come out bit-equal),
    and, with ``own_scan``, with its own ``torch.cumsum`` sums. Both at
    integers equal and nodes_f32 within rtol 1e-6. The kernels' sums are
    held against the library's within 1e-12 of each column's sum of
    magnitudes (float64 sums in another order). Returns (the kernels' arena,
    a line for the log, max |k - p| against the plain version's own scan,
    the largest difference of the two scans)."""
    from wgpu_n_body_tpu_torch.ops.morton import window_levels
    from wgpu_n_body_tpu_torch.ops.tree_build import build_tree, prefix_sums, reorder
    from wgpu_n_body_tpu_torch.ops.tree_build_cuda import build_tree_cuda_with_sums

    ss_k, k, sums, window = build_tree_cuda_with_sums(state, perm, keys, bound_, tp)
    ss = reorder(state, perm)
    torch.cuda.synchronize()
    plain_window = window_levels(keys, tp.max_depth, min(tp.leaf_bucket, state.n))
    if not (all(bits_equal(a, b) for a, b in zip(ss_k, ss))
            and bits_equal(window, plain_window.to(torch.uint8))):
        fail(f"9 {what}: the reorder's sorted state or window levels differ from the plain "
             f"version's")
    p_same = build_tree(ss, keys, bound_, tp, sums=sums)
    torch.cuda.synchronize()
    err_same, differ_same = compare_builds(f"{what}, the kernels' sums", k, p_same)
    lib = prefix_sums(ss)
    scan_err = (sums - lib).abs().amax(1)
    scan_gate = 1e-12 * lib.diff(dim=1).abs().sum(1)
    if not bool((scan_err <= scan_gate).all()):
        fail(f"9 {what}: the kernels' prefix sums are {scan_err.tolist()} from torch.cumsum's "
             f"(gates {scan_gate.tolist()})")
    line = (f"sorted state and window levels bit-equal; kernels == plain on the kernels' "
            f"sums for skip/first/count/num_nodes/split "
            f"{int(k.num_nodes)} of cap {k.skip.shape[0] - 1}, overflowed {bool(k.overflowed)}, "
            f"nodes_f32 within rtol 1e-6 (max|k-p| {err_same:.3e}, {differ_same} rows not "
            f"bit-equal); the kernels' float64 sums within {float(scan_err.max()):.3e} of "
            f"torch.cumsum's")
    err = None
    if own_scan:
        p = build_tree(ss, keys, bound_, tp)
        torch.cuda.synchronize()
        err, differ = compare_builds(f"{what}, the plain version's own sums", k, p)
        line += (f"; against the plain version on its own sums the same gates hold "
                 f"(max|k-p| {err:.3e}, {differ} rows not bit-equal)")
    return k, line, err, float(scan_err.max())


def phase_build(dev, smi, mhz):
    """9. The Morton sort and the plain build on the card against the CPU,
    and the build kernels (B5) against the plain build on the card."""
    from wgpu_n_body_tpu_torch.inits import disc_init, uniform_init
    from wgpu_n_body_tpu_torch.ops import tree_build_cuda
    from wgpu_n_body_tpu_torch.ops.tree_build import (
        NO_CHILD,
        build_tree,
        morton_order,
        morton_sort,
        reorder,
    )
    from wgpu_n_body_tpu_torch.ops.tree_build_cases import build_cases
    from wgpu_n_body_tpu_torch.params import SimParams, TreeParams, state_from_numpy

    build_k = tree_build_cuda.build_tree_cuda

    # -- 9a. the plain version: card against CPU at N=262144 -------------------
    rng = np.random.default_rng(21)
    n = N_MAIN
    pos = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    pos[n // 2 : n // 2 + n // 100] = pos[: n // 100]  # exact duplicates: sort ties
    zeros = np.zeros((n, 3), np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    tp = TreeParams(walk="per_particle")
    res = []
    for where in ("cpu", dev):
        st = state_from_numpy(pos, zeros, zeros, mass, where)
        perm, bound_, keys = morton_order(st.pos, tp.max_depth)
        ss, _, _ = morton_sort(st, tp.max_depth)
        res.append((perm, bound_, keys, build_tree(ss, keys, bound_, tp)))
    (c_perm, c_bound, c_keys, c_tree), (g_perm, g_bound, g_keys, g_tree) = res
    for name, a, b in (("bound", c_bound, g_bound), ("keys", c_keys, g_keys),
                       ("perm", c_perm, g_perm), ("split", c_tree.split, g_tree.split),
                       ("skip", c_tree.skip, g_tree.skip), ("first", c_tree.first, g_tree.first),
                       ("count", c_tree.count, g_tree.count),
                       ("num_nodes", c_tree.num_nodes, g_tree.num_nodes),
                       ("overflowed", c_tree.overflowed, g_tree.overflowed)):
        if not torch.equal(a, b.cpu()):
            fail(f"tree build on the card differs from the CPU in {name}")
    torch.testing.assert_close(g_tree.nodes_f32.cpu(), c_tree.nodes_f32, rtol=1e-6, atol=0)
    st = state_from_numpy(pos, zeros, zeros, mass, dev)
    ms_sort, (ss, bound_, keys) = time_ms(lambda: morton_sort(st, tp.max_depth), 3)
    ms_build, _ = time_ms(lambda: build_tree(ss, keys, bound_, tp), 3)
    perm = g_perm
    print(f"9a plain build N={n} (1% duplicate positions): card == CPU for keys, permutation, "
          f"skip/first/count, num_nodes {int(g_tree.num_nodes)} of cap "
          f"{g_tree.nodes_f32.shape[0] - 1}; nodes_f32 within rtol 1e-6; "
          f"card sort {ms_sort:.3f} ms, plain build {ms_build:.3f} ms")

    # -- 9b. the kernels against the plain version on that scene ---------------
    # buckets 1, 16, 32, and an arena a twentieth of N that overflows
    for kw in ({"leaf_bucket": 1}, {"leaf_bucket": 16}, {"leaf_bucket": 32},
               {"leaf_bucket": 16, "node_capacity_factor": 0.05}):
        tpb = TreeParams(walk="per_particle", **kw)
        k, line, _, _ = held_build(f"N={n} {kw}", st, perm, keys, bound_, tpb)
        if bool(k.overflowed) != ("node_capacity_factor" in kw):
            fail(f"9b {kw}: overflowed is {bool(k.overflowed)}")
        print(f"9b B5 N={n} {kw}: {line}")
    del st, ss, perm, keys, k, res, c_tree, g_tree

    # -- 9c. the small and odd inputs of the CPU tests --------------------------
    for case in build_cases():
        tpc = TreeParams(walk="per_particle", **case.tree_kw)
        stc = state_from_numpy(**case.state, device=dev)
        perm_c, bound_c, keys_c = morton_order(stc.pos, tpc.max_depth)
        k, line, _, _ = held_build(case.name, stc, perm_c, keys_c, bound_c, tpc)
        m = int(k.num_nodes)
        print(f"9c B5 {case.name} (n={stc.n}, {case.tree_kw}): "
              f"{int((k.nodes_f32[:m, NO_CHILD] == 2).sum())} overfull cells; {line}")

    def twice(what, state, perm, keys, bound_, tp, k):
        again = build_k(state, perm, keys, bound_, tp)[1]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(k[:7], again[:7]))
        same = same and torch.equal(k.split, again.split)
        if not same or not torch.equal(k.nodes_f32.view(torch.int32),
                                       again.nodes_f32.view(torch.int32)):
            fail(f"9 {what}: two builds of the same input differ")

    # -- 9d. the main path's N=4M uniform state, timed --------------------------
    params, tp4 = SimParams(particle_num=N_TREE), TreeParams()  # depth 16, bucket 16
    state = uniform_init(torch.Generator().manual_seed(0), params, dev)
    perm, bound_, keys = morton_order(state.pos, tp4.max_depth)
    k, line, max_abs, _ = held_build(f"N={N_TREE}", state, perm, keys, bound_, tp4)
    twice(f"N={N_TREE}", state, perm, keys, bound_, tp4, k)
    del k
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms_k, (_, k) = time_ms(lambda: build_k(state, perm, keys, bound_, tp4), 10)
    peak_k = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    for _ in range(10):
        build_k(state, perm, keys, bound_, tp4)
    host_ms = (time.perf_counter() - t0) * 100  # the wrapper's enqueue alone, per build
    torch.cuda.synchronize()
    m, cap = int(k.num_nodes), k.skip.shape[0] - 1
    del k
    torch.cuda.reset_peak_memory_stats()
    ms_p, p = time_ms(lambda: build_tree(reorder(state, perm), keys, bound_, tp4), 3)
    peak_p = torch.cuda.max_memory_allocated() - base
    del p
    nbytes = stage_build_bytes(N_TREE, cap)
    # the operations are a few dozen per live row (the totals' float64
    # differences, three divides): far below the bytes' time
    b5_bound = bound(float(m), 0, 40, nbytes, mhz)
    print(f"9d B5 N={N_TREE} uniform, depth {tp4.max_depth}, bucket {tp4.leaf_bucket}, the "
          f"unsorted initial state (the reorder's gathers are random): {line}; two builds "
          f"bit-equal; kernels (reorder and build) {ms_k:.3f} ms per build by CUDA events over "
          f"10 builds (the wrapper's host time to enqueue one: {host_ms:.3f} ms), plain (gathers "
          f"and build) {ms_p:.3f} ms; bound {b5_bound['bound_ms']:.4f} ms ({nbytes} bytes at "
          f"3.35 TB/s): kernels at {b5_bound['bound_ms'] / ms_k:.2%}, plain at "
          f"{b5_bound['bound_ms'] / ms_p:.2%}; peak device memory above the input "
          f"{peak_k / 1e9:.3f} GB (plain {peak_p / 1e9:.3f} GB); [{smi}]")
    del state, perm, keys
    torch.cuda.empty_cache()

    # -- 9e. the N=2M disc scene of phase 12f ------------------------------------
    # Half its bodies lie in the plane z = 0, so whole cells have a z total
    # of exactly 0 and every scan leaves its own rounding there: no relative
    # tolerance holds between two scans (torch.cumsum's own sums differ from
    # call to call here). The kernels are held to the plain version on the
    # kernels' sums, their sums to the library's, and the plain version on
    # its own sums to what the two scans' difference allows.
    n2 = 2_000_000
    tp5 = TreeParams(theta=0.5)
    state = disc_init(torch.Generator().manual_seed(0), SimParams(particle_num=n2), dev)
    perm, bound_, keys = morton_order(state.pos, tp5.max_depth)
    k, line, _, scan_err = held_build(f"N={n2} disc", state, perm, keys, bound_, tp5,
                                      own_scan=False)
    twice(f"N={n2} disc", state, perm, keys, bound_, tp5, k)
    ss = reorder(state, perm)
    p = build_tree(ss, keys, bound_, tp5)
    p2 = build_tree(ss, keys, bound_, tp5)
    torch.cuda.synchronize()
    for name in ("skip", "first", "count", "num_nodes", "overflowed"):
        if not torch.equal(getattr(k, name), getattr(p, name)):
            fail(f"9e the kernels' {name} differs from the plain version's")
    atol = 4.0 * scan_err / float(ss.mass.min())
    torch.testing.assert_close(k.nodes_f32, p.nodes_f32, rtol=1e-6, atol=atol)
    outside = int(((k.nodes_f32 - p.nodes_f32).abs() > 1e-6 * p.nodes_f32.abs()).sum())
    plain_rows = int((p.nodes_f32 != p2.nodes_f32).any(1).sum())
    ms_k2, _ = time_ms(lambda: build_k(state, perm, keys, bound_, tp5), 5)
    ms_p2, _ = time_ms(lambda: build_tree(reorder(state, perm), keys, bound_, tp5), 2)
    print(f"9e B5 N={n2} disc: {int((k.nodes_f32[:, NO_CHILD] == 2).sum())} overfull cells; "
          f"{line}; two builds bit-equal (two plain builds differ in {plain_rows} rows); "
          f"against the plain version on its own sums integers equal, nodes_f32 within rtol "
          f"1e-6 + atol {atol:.3e} (four times the scans' difference over the least mass; "
          f"{outside} elements outside rtol 1e-6 alone, max|k-p| "
          f"{float((k.nodes_f32 - p.nodes_f32).abs().max()):.3e}); kernels {ms_k2:.3f} ms, "
          f"plain {ms_p2:.3f} ms; [{smi}]")
    del state, ss, perm, keys, k, p, p2
    torch.cuda.empty_cache()
    return {
        "name": "tree_build",
        "route": "cuda",
        "source": "wgpu_n_body_tpu_torch/csrc/tree_build.cu",
        "replaces": "wgpu_n_body_tpu/ops/tree_build.py:175",
        "launches": 0,  # set from the main path's run (phase 13)
        "max_abs_err": max_abs,
        # ms, plain_ms, bound_ms: phase 9f's, on the main path's input; here
        # the unsorted initial state
        "ms_initial_state": ms_k,
        "plain_ms_initial_state": ms_p,
        **b5_bound,
        "bound_count": nbytes,
        "bound_count_unit": "bytes",
        "library_ms": None,
        "library": "none: no single PyTorch call builds an octree",
        "n": N_TREE,
        "nodes": m,
        "host_enqueue_ms": host_ms,
        "peak_bytes": peak_k,
        "plain_peak_bytes": peak_p,
        "disc_2m_ms": ms_k2,
        "disc_2m_plain_ms": ms_p2,
    }


def stage_build_bytes(n, cap):
    """Bytes one build (the reorder, then B5's other kernels) must move:
    the two passes' own, less what B5 reads back of the reorder's work (the
    sorted positions and masses, 16 bytes a body) and its second read of
    the keys (8)."""
    from wgpu_n_body_tpu_torch.ops import tree_build_cuda

    return tree_build_cuda.reorder_bytes(n) + tree_build_cuda.build_bytes(n, cap) - 24 * n


#: The sort stage's outputs, in the order they are made and compared.
STAGE_FIELDS = ("bound", "keys", "index", "perm", "sorted keys", "pos", "vel", "acc", "mass",
                "split", "window")


def stage_outputs(state, tp, plain, perm=None, keys_u=None):
    """The sort stage of one tree step on the card, by field name: K1 (bound,
    keys, index), CUB's sort (perm, sorted keys) and K2 (the sorted state,
    split and window levels), or with ``plain`` their plain versions. A
    given ``keys_u`` replaces K1's keys before the sort, a given ``perm``
    the sort's permutation before K2 (planted faults)."""
    from wgpu_n_body_tpu_torch.ops import morton, morton_cuda, tree_build_cuda
    from wgpu_n_body_tpu_torch.ops.tree_build import reorder

    depth, n = tp.max_depth, state.n
    out = {}
    if plain:
        out["bound"] = morton.bound_of(state.pos)
        out["keys"] = morton.packed_keys(state.pos, out["bound"], depth)
        out["index"] = torch.arange(n, dtype=torch.int32, device=state.pos.device)
    else:
        out["keys"], out["index"], out["bound"] = morton_cuda.morton_keys_cuda(state.pos, depth)
    if keys_u is not None:
        out["keys"] = keys_u
    if plain:
        out["sorted keys"], order = torch.sort(out["keys"], stable=True)
        out["perm"] = out["index"][order]
    else:
        out["perm"], out["sorted keys"] = morton_cuda.sort_keys_cuda(out["keys"], out["index"],
                                                                     depth)
    if perm is not None:
        out["perm"] = perm
    if plain:
        bucket = min(tp.leaf_bucket, n)
        ss = reorder(state, out["perm"])
        split = morton.split_levels(out["sorted keys"], depth).to(torch.uint8)
        window = morton.window_levels(out["sorted keys"], depth, bucket).to(torch.uint8)
    else:
        ss, split, window = tree_build_cuda.reorder_cuda(state, out["perm"], out["sorted keys"],
                                                         tp)
    out.update(ss._asdict(), split=split, window=window)
    return out


def stage_mismatches(got, want):
    """The fields of ``stage_outputs`` whose bits differ."""
    torch.cuda.synchronize()
    return [f for f in STAGE_FIELDS if not bits_equal(got[f], want[f])]


def phase_sort(dev, smi, mhz):
    """9f. The sort stage's kernels against their plain versions on the card,
    bit for bit: K1 (the key kernel, with the bound's reduction), CUB's sort
    and K2 (the reorder, B5's first kernel), on the main path's N=4M uniform
    scene (its initial state and the state one step later, the input of
    every later step), the N=2M disc scene, N=262144 with 1% duplicate
    positions (ties), and depths 5 and 20; a planted fault (two tied bodies
    swapped in the permutation, one key bit flipped) must be caught. K1,
    the sort (CUB's and ``torch.sort``'s of the same keys), K2 and the whole
    build timed at N=4M."""
    from wgpu_n_body_tpu_torch.inits import disc_init, uniform_init
    from wgpu_n_body_tpu_torch.models import TreeSim
    from wgpu_n_body_tpu_torch.ops import morton, morton_cuda, tree_build_cuda
    from wgpu_n_body_tpu_torch.ops.tree_build import build_tree, reorder
    from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams, state_from_numpy

    def held(what, state, tp):
        got, want = stage_outputs(state, tp, False), stage_outputs(state, tp, True)
        bad = stage_mismatches(got, want)
        if bad:
            fail(f"9f {what}: the sort stage's kernels differ from the plain versions in {bad}")
        ties = int((got["sorted keys"][1:] == got["sorted keys"][:-1]).sum())
        print(f"9f {what}, depth {tp.max_depth}: bound, keys, index, permutation, sorted keys, "
              f"sorted state, split and window levels bit-equal to the plain versions "
              f"({ties} tied keys)")
        return got

    # -- the N=262144 scene of 9a, with velocities and accelerations ----------
    rng = np.random.default_rng(21)
    n = N_MAIN
    pos = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    pos[n // 2 : n // 2 + n // 100] = pos[: n // 100]  # exact duplicates: sort ties
    vel, acc = (rng.uniform(-1, 1, (n, 3)).astype(np.float32) for _ in range(2))
    st = state_from_numpy(pos, vel, acc, rng.uniform(0.5, 2.0, n).astype(np.float32), dev)
    tp = TreeParams()
    got = held(f"N={n}, 1% duplicate positions", st, tp)
    for depth in (5, 20):
        small = ParticleState(*(t[:65536].contiguous() for t in st))
        held("N=65536 of that scene", small, TreeParams(max_depth=depth, leaf_bucket=4))
    # planted faults: the check must see each
    keys = got["sorted keys"]
    tie = int((keys[1:] == keys[:-1]).nonzero()[0, 0])
    swapped = got["perm"].clone()
    swapped[[tie, tie + 1]] = swapped[[tie + 1, tie]]
    flipped = got["keys"].clone()
    flipped[n // 3] ^= 1 << 20
    want = stage_outputs(st, tp, True)
    planted = {
        "two tied bodies swapped": stage_mismatches(stage_outputs(st, tp, False, perm=swapped),
                                                    want),
        "one key bit flipped": stage_mismatches(stage_outputs(st, tp, False, keys_u=flipped),
                                                want),
    }
    print(f"9f planted faults at N={n}: fields that differ {planted}")
    if not ({"perm", "mass"} <= set(planted["two tied bodies swapped"])
            and "keys" in planted["one key bit flipped"]):
        fail(f"9f: a planted fault passed the check: {planted}")
    del st, got, want, keys, swapped, flipped

    # -- N=2M disc --------------------------------------------------------------
    n2 = 2_000_000
    held(f"N={n2} disc", disc_init(torch.Generator().manual_seed(0), SimParams(particle_num=n2),
                                   dev), TreeParams(theta=0.5))
    torch.cuda.empty_cache()

    # -- N=4M uniform: the initial state and the state one step later -----------
    params, tp4 = SimParams(particle_num=N_TREE), TreeParams()
    initial = uniform_init(torch.Generator().manual_seed(0), params, dev)
    held(f"N={N_TREE} uniform, initial state", initial, tp4)
    later = TreeSim(params, tp4).make_step()(initial)  # sorted by the step before
    held(f"N={N_TREE} uniform, one step later", later, tp4)
    depth = tp4.max_depth

    def timed(state):
        """ms of each piece on ``state``, by CUDA events."""
        lo, hi = torch.aminmax(state.pos)
        keys_u, index, bound_ = morton_cuda.morton_keys_cuda(state.pos, depth)
        perm, keys = morton_cuda.sort_keys_cuda(keys_u, index, depth)

        def stage():  # what a step runs before its walk
            perm_, bound_s, keys_ = morton_cuda.morton_order_cuda(state.pos, depth)
            return tree_build_cuda.build_tree_cuda(state, perm_, keys_, bound_s, tp4)

        t = {
            "aminmax": time_ms(lambda: torch.aminmax(state.pos), 20)[0],
            "K1": time_ms(lambda: morton_cuda.launch_keys(state.pos, lo, hi, depth), 20)[0],
            "K1 plain": time_ms(lambda: morton.packed_keys(state.pos, morton.bound_of(state.pos),
                                                           depth), 3)[0],
            "sort CUB": time_ms(lambda: morton_cuda.sort_keys_cuda(keys_u, index, depth), 20)[0],
            "sort torch": time_ms(lambda: torch.sort(keys_u, stable=True), 20)[0],
            "K2": time_ms(lambda: tree_build_cuda.reorder_cuda(state, perm, keys, tp4), 20)[0],
            "K2 plain": time_ms(lambda: (reorder(state, perm), morton.split_levels(keys, depth),
                                         morton.window_levels(keys, depth, tp4.leaf_bucket)),
                                3)[0],
            "build": time_ms(lambda: tree_build_cuda.build_tree_cuda(state, perm, keys, bound_,
                                                                     tp4), 20)[0],
            "build plain": time_ms(lambda: build_tree(reorder(state, perm), keys, bound_, tp4),
                                   3)[0],
            "stage": time_ms(stage, 20)[0],
        }
        local = float((perm.long() - torch.arange(N_TREE, device=dev)).abs().double().mean())
        return t, local

    t_init, local_init = timed(initial)
    t_later, local_later = timed(later)
    cap = tp4.capacity(N_TREE)
    b_k1 = bound(float(N_TREE), 0, 9, morton_cuda.key_bytes(N_TREE), mhz)
    b_k2 = bound(float(N_TREE), 0, 0, tree_build_cuda.reorder_bytes(N_TREE), mhz)
    b_stage = bound(float(N_TREE), 0, 0, stage_build_bytes(N_TREE, cap), mhz)
    for what, t, local in (("initial state", t_init, local_init),
                           ("one step later", t_later, local_later)):
        print(f"9f N={N_TREE} uniform, {what} (mean |perm[i] - i| {local:.1f}), ms by CUDA events: "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
              + f"; bounds (bytes at 3.35 TB/s): K1 {b_k1['bound_ms']:.4f} ms (K1 at "
              f"{b_k1['bound_ms'] / t['K1']:.2%}), K2 {b_k2['bound_ms']:.4f} ms (K2 at "
              f"{b_k2['bound_ms'] / t['K2']:.2%}), the build {b_stage['bound_ms']:.4f} ms (at "
              f"{b_stage['bound_ms'] / t['build']:.2%}); [{smi}]")
    del initial, later
    torch.cuda.empty_cache()
    k1 = {
        "name": "morton_keys",
        "route": "cuda",
        "source": "wgpu_n_body_tpu_torch/csrc/morton_keys.cu",
        "replaces": "wgpu_n_body_tpu/ops/morton.py:42",
        "launches": 0,  # set from the main path's run (phase 13)
        "max_abs_err": 0.0,  # keys, index and bound bit-equal to the plain version's
        "ms": t_later["K1"],
        "plain_ms": t_later["K1 plain"],
        **b_k1,
        "bound_count": morton_cuda.key_bytes(N_TREE),
        "bound_count_unit": "bytes",
        "library_ms": None,
        "library": "none: no single PyTorch call computes Morton keys",
        "n": N_TREE,
        "input": "the N=4M uniform state one TreeSim step after the initial one",
        "bound_reduction_ms": t_later["aminmax"],
        # the stable sort of the packed key (48 bits, int32 index), a
        # library call of the port's (CUB), and torch.sort of the same keys
        "sort_ms": t_later["sort CUB"],
        "sort_torch_ms": t_later["sort torch"],
        "initial_state_ms": {k: t_init[k] for k in ("aminmax", "K1", "sort CUB", "sort torch")},
    }
    b5 = {
        "ms": t_later["build"],
        "plain_ms": t_later["build plain"],
        **b_stage,
        "bound_count": stage_build_bytes(N_TREE, cap),
        "input": "the N=4M uniform state one TreeSim step after the initial one",
        "reorder_ms": t_later["K2"],
        "reorder_plain_ms": t_later["K2 plain"],
        "reorder_bound_ms": b_k2["bound_ms"],
        "reorder_ms_initial_state": t_init["K2"],
        "stage_ms": t_later["stage"],
    }
    return k1, b5


#: Per-row p99 gate of B3 against the plain walk: the same nodes and members
#: per receiver, approximate rsqrt and divide and another order of float32
#: sums (B4's evaluation gate on equal lists).
B3_GATE = 1e-5


def held_walk(what, recv, idx32, ss, tree, params, tp):
    """B3 on receivers ``recv`` (sorted indices ``idx32``) against the plain
    walk on the same arena: the kernel's per-receiver counts of accepted
    nodes and of members equal to the plain rules' exactly, the counting and
    the plain instantiation and two launches bit-equal, forces within a
    per-row p99 of ``B3_GATE``. Returns (kernel forces, plain forces, counts
    (b, 4), plain walk ms, max |k - p|, p99, the plain rules' counts (b, 4))."""
    from wgpu_n_body_tpu_torch.ops import tree_walk_cuda
    from wgpu_n_body_tpu_torch.ops.tree_walk import tree_forces, walk_counts

    k, counts = tree_walk_cuda.tree_forces_counts_cuda(
        recv, ss.pos, ss.mass, tree, params, tp, self_idx=idx32)
    k2 = tree_walk_cuda.tree_forces_cuda(recv, ss.pos, ss.mass, tree, params, tp, self_idx=idx32)
    k3 = tree_walk_cuda.tree_forces_cuda(recv, ss.pos, ss.mass, tree, params, tp, self_idx=idx32)
    torch.cuda.synchronize()
    if not (torch.equal(k, k2) and torch.equal(k2, k3)):
        fail(f"{what}: two launches of B3 on the same input differ")
    want = walk_counts(recv, tree, tp)
    for col, name in ((0, "accepted nodes"), (1, "members")):
        if not torch.equal(counts[:, col].long(), want[:, col]):
            fail(f"{what}: B3's {name} differ from the plain rules' for "
                 f"{int((counts[:, col].long() != want[:, col]).sum())} receivers")
    t0 = time.perf_counter()
    p = tree_forces(recv, ss.pos, ss.mass, tree, params, tp, self_idx=idx32)
    torch.cuda.synchronize()
    ms_plain = (time.perf_counter() - t0) * 1e3
    rel = row_rel_err(k, p)
    p99 = float(np.percentile(rel, 99))
    if not np.isfinite(rel).all() or p99 > B3_GATE:
        fail(f"{what}: B3 and the plain walk disagree (p99 {p99:.3e}, gate {B3_GATE:.0e})")
    return k, p, counts, ms_plain, (k - p).abs().max().item(), p99, want


def phase_b3(dev, smi, mhz):
    """10. The tree walk kernel (B3) against the plain walk and float64."""
    from wgpu_n_body_tpu_torch.inits import uniform_init
    from wgpu_n_body_tpu_torch.ops import naive_cuda, tree_walk_cuda
    from wgpu_n_body_tpu_torch.ops.naive_ref import mean_rel_err, naive_forces_dense, naive_forces_ref
    from wgpu_n_body_tpu_torch.ops.tree_build import NO_CHILD
    from wgpu_n_body_tpu_torch.ops.tree_walk import tree_forces
    from wgpu_n_body_tpu_torch.params import SimParams, TreeParams, state_from_numpy

    walk = tree_walk_cuda.tree_forces_cuda

    # -- the N=4M headless scene, one sort and build ---------------------------
    params = SimParams(particle_num=N_TREE)  # cli headless defaults
    tp = TreeParams(walk="per_particle")  # theta 0.75, leaf_bucket 16, max_depth 16
    state = uniform_init(torch.Generator().manual_seed(0), params, dev)
    ss, tree, _, pos_new = sorted_scene(state, params, tp)
    if bool(tree.overflowed):
        fail("the N=4M uniform tree overflowed its arena")
    m_nodes = int(tree.num_nodes)
    print(f"10 N={N_TREE} tree: {m_nodes} nodes of cap {tree.nodes_f32.shape[0] - 1}")

    # -- 10a. 4096 sampled receivers, kernel vs plain walk ---------------------
    gen = torch.Generator().manual_seed(1)
    idx = torch.randperm(N_TREE, generator=gen)[:4096].sort().values.to(dev)
    idx32 = idx.to(torch.int32)
    recv = pos_new[idx]
    k_sub, p_sub, counts, ms_plain, max_abs, p99, rules = held_walk(
        "10a", recv, idx32, ss, tree, params, tp)
    ms_sub, _ = time_ms(lambda: walk(recv, ss.pos, ss.mass, tree, params, tp, self_idx=idx32), 5)
    rel = row_rel_err(k_sub, p_sub)
    inter = counts[:, :2].sum(1).double()
    b3_count = float(inter.mean()) * N_TREE  # scaled from the sample
    print(f"10a B3 vs plain walk on {idx.numel()} sampled receivers: accepted nodes (mean "
          f"{float(counts[:, 0].double().mean()):.1f}) and members (mean "
          f"{float(counts[:, 1].double().mean()):.1f}) per receiver equal to the plain rules'; "
          f"per-row p99 {p99:.3e} max {rel.max():.3e} (gate p99 {B3_GATE:.0e}), max|k-p| "
          f"{max_abs:.3e}; the counting instantiation and two launches bit-equal; kernel "
          f"{ms_sub:.3f} ms, plain {ms_plain:.3f} ms ({ms_plain / idx.numel() * 1e3:.3f} us per "
          f"receiver); [{smi}]")
    print(f"10a B3 interactions per receiver on the {idx.numel()} sampled receivers: mean "
          f"{float(inter.mean()):.1f}, max {int(inter.max())}; {b3_count:.4e} for N={N_TREE} "
          f"scaled from the sample; a warp of these visits {float(counts[::32, 3].double().mean()):.1f} "
          f"nodes, one receiver {float(counts[:, 2].double().mean()):.1f}")
    # a planted fault must exceed the gate: the narrowest node each receiver
    # accepts made massless in a copy of the arena
    last = rules[:, 3]
    if bool((last < 0).any()):
        fail("10a: a sampled receiver accepted no node")
    faulty = tree._replace(nodes_f32=tree.nodes_f32.clone())
    faulty.nodes_f32[last.unique(), 3] = 0.0  # the mass column
    k_bad = walk(recv, ss.pos, ss.mass, faulty, params, tp, self_idx=idx32)
    torch.cuda.synchronize()
    p99_bad = float(np.percentile(row_rel_err(k_bad, p_sub), 99))
    print(f"10a planted fault (the narrowest node each receiver accepts made massless, "
          f"{int(last.unique().numel())} nodes): per-row p99 {p99_bad:.3e}")
    if not p99_bad > B3_GATE:
        fail(f"10a: the gate {B3_GATE:.0e} misses a dropped node (p99 {p99_bad:.3e})")
    del faulty, k_bad

    # -- 10b. both against float64 all-pairs on 2048 of those receivers --------
    sel = slice(0, None, 2)
    truth = naive_forces_ref(recv[sel].double(), ss.pos.double(), ss.mass.double(), params,
                             block=16, row_offset=idx[sel])
    mre_k, mre_p = mean_rel_err(k_sub[sel], truth), mean_rel_err(p_sub[sel], truth)
    print(f"10b theta=0.75 vs float64 all-pairs on {truth.shape[0]} receivers: mean relative "
          f"error kernel {mre_k:.4e}, plain {mre_p:.4e} (gate 0.03)")
    if not (mre_k <= 0.03 and mre_p <= 0.03):
        fail("the tree force is further than 0.03 from the all-pairs sum")
    del truth

    # -- 10c. the full N=4M walk -------------------------------------------------
    ms_full, k_full = time_ms(lambda: walk(pos_new, ss.pos, ss.mass, tree, params, tp), 3)
    if not torch.isfinite(k_full).all():
        fail("non-finite force from the full walk")
    rel_full = row_rel_err(k_full[idx], k_sub)
    p99_full = float(np.percentile(rel_full, 99))
    if not np.isfinite(rel_full).all() or p99_full > B3_GATE:
        fail(f"the full walk and the subset walk disagree (p99 {p99_full:.3e})")
    # the listed mode (the group walk's fallback) over a list of every
    # receiver, on the tables of one pack launch: the full walk's bits
    rec, table = tree_walk_cuda.walk_tables_cuda(tree, ss.pos, ss.mass, params)
    every = torch.stack([torch.arange(0, N_TREE, 32, dtype=torch.int32, device=dev),
                         torch.full((N_TREE // 32,), -1, dtype=torch.int32, device=dev)], 1)
    n_every = torch.tensor(every.shape[0], dtype=torch.int32, device=dev)
    ms_listed, k_listed = time_ms(lambda: tree_walk_cuda.tree_forces_listed_cuda(
        pos_new, rec, table, tree, every, n_every, 0, params, tp, torch.empty_like(k_full)), 3)
    if not torch.equal(k_listed, k_full):
        fail("B3's listed mode over every receiver differs from the full walk")
    mid = N_TREE // 2
    cons = torch.arange(mid, mid + 4096, dtype=torch.int32, device=dev)
    ms_cons, k_cons = time_ms(lambda: walk(pos_new[mid:mid + 4096], ss.pos, ss.mass, tree, params,
                                           tp, self_idx=cons), 5)
    if not torch.equal(k_cons, k_full[mid:mid + 4096]):
        fail("B3 on 4096 consecutive receivers differs from the same rows of the full walk")
    bound3 = bound(b3_count, 2, 20, N_TREE * (12 + 16 + 12) + m_nodes * 44, mhz)
    print(f"10c B3 full walk N={N_TREE}: {ms_full:.3f} ms per call, the pack kernel included "
          f"({ms_full / N_TREE * 1e6:.3f} ns per receiver; listed, every receiver on one pack "
          f"launch's tables, bit-equal: {ms_listed:.3f} ms without its pack); bound "
          f"{bound3['bound_ms']:.4f} ms: {bound3['bound_ms'] / ms_full:.2%}; rows of the "
          f"{idx.numel()} sampled receivers against their own launch: p99 {p99_full:.3e}, "
          f"{int((k_full[idx] == k_sub).all(1).sum())} bit-equal; 4096 consecutive receivers "
          f"{ms_cons:.3f} ms, bit-equal to the full walk's rows (4096 sampled: {ms_sub:.3f} ms); "
          f"[{smi}]")
    del state, ss, tree, pos_new, k_full, k_listed, rec, table, every
    torch.cuda.empty_cache()

    # -- 10d. theta=0 against the all-pairs kernel B1 at N=16384 ---------------
    p16 = SimParams(particle_num=16384, g=1e-5)
    tp0 = TreeParams(theta=0.0, walk="per_particle")
    ss16, tree16, _, pn16 = sorted_scene(
        uniform_init(torch.Generator().manual_seed(5), p16, dev), p16, tp0)
    kt = walk(pn16, ss16.pos, ss16.mass, tree16, p16, tp0)
    kn = naive_cuda.naive_forces_cuda(pn16, ss16.pos, ss16.mass, p16)
    torch.cuda.synchronize()
    rel = row_rel_err(kt, kn)
    print(f"10d theta=0 walk vs B1 at N=16384: per-row p99 {np.percentile(rel, 99):.3e} "
          f"max {rel.max():.3e} (gate p99 2e-4)")
    if not np.isfinite(rel).all() or np.percentile(rel, 99) > 2e-4:
        fail("the theta=0 walk differs from the all-pairs kernel")

    # -- 10e. an overfull max-depth cell (tests/test_tree.py:276-299) ----------
    rng = np.random.default_rng(10)
    pos = np.concatenate([0.6 + rng.uniform(0, 1, (20, 3)) * 1e-4,
                          rng.uniform(-1.0, 0.4, (44, 3))]).astype(np.float32)
    zeros = np.zeros((64, 3), np.float32)
    p64 = SimParams(particle_num=64, g=1e-3)
    tpo = TreeParams(theta=0.0, max_depth=3, leaf_bucket=4, walk="per_particle")
    sso, treeo, _, _ = sorted_scene(
        state_from_numpy(pos, zeros, zeros, np.ones(64, np.float32), dev), p64, tpo)
    if not (treeo.nodes_f32[: int(treeo.num_nodes), NO_CHILD] == 2.0).any():
        fail("the cluster scene has no overfull cell")
    k = walk(sso.pos, sso.pos, sso.mass, treeo, p64, tpo)
    torch.cuda.synchronize()
    torch.testing.assert_close(k, naive_forces_dense(sso.pos, sso.pos, sso.mass, p64),
                               rtol=2e-3, atol=1e-8)
    torch.testing.assert_close(k, tree_forces(sso.pos, sso.pos, sso.mass, treeo, p64, tpo),
                               rtol=1e-4, atol=1e-9)

    # -- 10f. arena overflow: flagged, and the walk returns --------------------
    base = rng.uniform(-1.0, 1.0, (32, 3)).astype(np.float32)
    pos = np.concatenate([base, base + np.float32(1e-6)])
    tpf = TreeParams(theta=0.5, leaf_bucket=1, node_capacity_factor=1, walk="per_particle")
    ssf, treef, _, _ = sorted_scene(
        state_from_numpy(pos, zeros, zeros, np.ones(64, np.float32), dev), p64, tpf)
    kf = walk(ssf.pos, ssf.pos, ssf.mass, treef, p64, tpf)
    torch.cuda.synchronize()
    if not bool(treef.overflowed) or int(treef.num_nodes) != treef.nodes_f32.shape[0] - 1:
        fail("the tight-pair scene did not flag its arena overflow")
    if not torch.isfinite(kf).all():
        fail("the walk of the overflowed arena gave a non-finite force")
    print(f"10e overfull cell: kernel == all-pairs (rtol 2e-3) and == plain walk; "
          f"10f overflow flagged, walk returned {tuple(kf.shape)}, finite")
    return {
        "name": "tree_walk",
        "route": "cuda",
        "source": "wgpu_n_body_tpu_torch/csrc/tree_walk.cu",
        "replaces": "wgpu_n_body_tpu/ops/tree_walk.py:60",
        "launches": 0,  # set from the main path's run (phase 14)
        "max_abs_err": max_abs,
        "ms": ms_full,
        "plain_ms": ms_plain,
        # the point-mass term needs one rsqrt and one reciprocal
        **bound3,
        "bound_count_scaled_from": int(idx.numel()),
        "library_ms": None,
        "library": NO_LIBRARY,
        # ms, bound_ms, max_abs_err and plain_ms: the arena of the build kernels
        # (leaf_bucket 16), the walk of walk="per_particle"; the host_arena_*
        # keys of phase 14 are the same on the tree-host path's arena
        "arena": f"build kernels (B5), leaf_bucket {tp.leaf_bucket}, {m_nodes} nodes",
        "ms_receivers": N_TREE,
        "plain_ms_receivers": int(idx.numel()),
        "ms_same_receivers": ms_sub,
        "ms_consecutive_4096": ms_cons,
        "ms_listed_every_receiver": ms_listed,
        "planted_fault_p99": p99_bad,
    }


@contextlib.contextmanager
def kept_steps():
    """The list of the steps ``TreeSim.make_step()`` returns inside the
    block (the CLI's graphed steps)."""
    from wgpu_n_body_tpu_torch.models import TreeSim

    made, make = [], TreeSim.make_step

    def keep(self):
        made.append(make(self))
        return made[-1]

    TreeSim.make_step = keep
    try:
        yield made
    finally:
        TreeSim.make_step = make


def graphed_bodies(made, steps):
    """How many times the graphed step ran its body through the launchers
    (its plain calls and its captures; a replay launches what one capture
    counted, and counts nothing); fails unless one step made ``steps``
    calls, all but two replays."""
    if len(made) != 1 or (made[0].calls, made[0].replays) != (steps, steps - 2):
        fail(f"the CLI's graphed steps: {[(m.calls, m.replays) for m in made]}")
    return made[0].calls - made[0].replays + made[0].captures


def phase_tree_cli(dev, smi):
    """11. The tree headless path through the CLI at the default N."""
    from wgpu_n_body_tpu_torch import cli
    from wgpu_n_body_tpu_torch.inits import uniform_init
    from wgpu_n_body_tpu_torch.models import TreeSim
    from wgpu_n_body_tpu_torch.params import SimParams
    from wgpu_n_body_tpu_torch.utils.checkpoint import load_checkpoint

    from wgpu_n_body_tpu_torch.ops import tree_walk_cuda

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "tree.npz")
        argv = ["headless", "--sim", "tree", "--tree-kw", 'walk="per_particle"',
                "--steps", str(STEPS), "--diag-every", str(STEPS), "--checkpoint", ckpt]
        zero_launch_counts()
        # pack launches by what they write; "load": init_state's one run of the
        # counters' kernels, on an arena of no node (two rows)
        packs = {"records": 0, "tables": 0, "load": 0}
        pack = tree_walk_cuda._pack

        def counted_pack(tree, src_pos, src_mass, gdt, rec, tab, src):
            packs["load" if rec.shape[0] == 2 else "records" if tab is None else "tables"] += 1
            pack(tree, src_pos, src_mass, gdt, rec, tab, src)

        tree_walk_cuda._pack = counted_pack
        try:
            with kept_steps() as made:
                out = run_cli(cli, argv)
        finally:
            tree_walk_cuda._pack = pack
        counts = launch_counts()
        # one sort stage (K1, K2), one build (B5) and one B3 launch per body
        # the graphed step ran through the launchers (its replays launch the
        # same, uncounted); the diagnostics line at the last step sorts and
        # builds once more and runs one group walk (its tiles, its tables,
        # B4, then B3 over its deferred list), as in JAX
        bodies = graphed_bodies(made, STEPS)
        if counts != expected_counts(B3=bodies + 1, B4=1, B4_eval=1, B4_tables=1, B4_tiles=1,
                                     B5=bodies + 1, K1=bodies + 1, K2=bodies + 1):
            fail(f"cli headless --sim tree, {STEPS} steps ({bodies} bodies run), launched "
                 f"{counts}")
        # one records-only pack with each body's B3 launch (none with the
        # untraced step's counters), the table's pack with the diagnostics
        if packs != {"records": bodies, "tables": 1, "load": 1}:
            fail(f"cli headless --sim tree, {STEPS} per-particle steps, packed {packs}")
        if "'overflowed': False" not in out:
            fail("the tree diagnostics do not report a healthy arena")
        us = float(re.search(r"mean: (\S+) us/step", out).group(1))
        ck = load_checkpoint(ckpt, dev)
        if not isinstance(ck.make_sim(), TreeSim) or ck.step != STEPS:
            fail("the tree checkpoint does not reload as a TreeSim at the last step")
        st = ck.state
        if st.n != N_TREE or not all(torch.isfinite(t).all() for t in st[:3]):
            fail("non-finite or mis-sized state after the tree run")
        init = uniform_init(torch.Generator().manual_seed(0), SimParams(particle_num=N_TREE), dev)
        if not torch.equal(torch.sort(st.mass).values, torch.sort(init.mass).values):
            fail("the tree run changed the mass multiset")
    print(f"11 headless tree N={N_TREE} theta=0.75 per-particle walk: {counts['B3']} B3 launches, "
          f"{counts['K1']} key kernel (K1) launches, {counts['K2']} reorders (K2) and "
          f"{counts['B5']} builds (B5) counted in {STEPS} steps ({bodies} bodies through the "
          f"launchers: two plain calls and two captures, then {STEPS - 2} replays of one "
          f"capture's launches each) + 1 diagnostics, {packs['records']} records-only packs, "
          f"{us:.1f} us/step; [{smi}]")
    counts["counters"] = phase_pp_counters(dev, smi, st)
    return counts


def phase_pp_counters(dev, smi, state):
    """11b. A traced per-particle step's sampled counters (every 64th warp
    walked again by B3's counting instantiation) equal the sums of one full
    counting launch over the step's receivers on the same warps; the traced
    step's state equals the untraced step's bit for bit."""
    from wgpu_n_body_tpu_torch.models import TreeSim
    from wgpu_n_body_tpu_torch.models import tree as tree_model
    from wgpu_n_body_tpu_torch.ops import tree_walk_cuda
    from wgpu_n_body_tpu_torch.params import SimParams, TreeParams
    from wgpu_n_body_tpu_torch.utils import profiling

    sim = TreeSim(SimParams(particle_num=state.n), TreeParams(walk="per_particle"))
    sim.init_state(None, lambda *_: state, dev)  # loads the counters' kernels
    step = sim.step_fn()
    plain = step(state)
    seen = []
    sampled = tree_model._per_particle_counts

    def keep(*args):
        seen.append(args)
        return sampled(*args)

    tree_model._per_particle_counts = keep
    profiling.reset_counters()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            traced = step(state)
            torch.cuda.synchronize()
    finally:
        tree_model._per_particle_counts = sampled
    got = profiling.counters()
    profiling.reset_counters()
    if not all(torch.equal(a, b) for a, b in zip(plain, traced)):
        fail("11b: the traced per-particle step differs from the untraced one")
    if len(seen) != 1:
        fail(f"11b: a traced step sampled its warps {len(seen)} times")
    pos_new, src_pos, src_mass, tree, params, tp = seen[0]
    _, full = tree_walk_cuda.tree_forces_counts_cuda(pos_new, src_pos, src_mass, tree, params, tp)
    rows = tree_model._sampled_rows(pos_new.shape[0], dev)
    c = full[rows].long().sum(0)
    want = {"walk.pp_receivers": int(rows.numel()), "walk.pp_live_visits": int(c[2]),
            "walk.pp_warp_visits": int(c[3]), "walk.pp_interactions": int(c[0] + c[1])}
    if got != want:
        fail(f"11b: the sampled counters {got} differ from the full launch's {want}")
    fill = 100.0 * want["walk.pp_live_visits"] / want["walk.pp_warp_visits"]
    print(f"11b traced per-particle step N={state.n}: counters equal the full counting launch "
          f"on {want['walk.pp_receivers']} sampled receivers (lane fill {fill:.2f}%, "
          f"{want['walk.pp_interactions'] / want['walk.pp_receivers']:.1f} interactions each); "
          f"traced and untraced states bit-equal; [{smi}]")
    return dict(want, lane_fill_pct=fill)


def tiles_differ(a, b):
    """The fields of two ``Tiles`` that differ (a tensor in dtype, shape or
    any element)."""
    out = []
    for f, x, y in zip(a._fields, a, b):
        same = (x.dtype == y.dtype and torch.equal(x, y)) if torch.is_tensor(x) else x == y
        if not same:
            out.append(f)
    return out


def held_tiles(what, split, n, tp, keys=None):
    """B4 · T (``tile_setup_cuda``) on the card against the plain
    ``tile_setup`` on the same split levels and, given ``keys``, on
    ``morton.split_levels`` of the keys: every field of ``Tiles`` equal.
    Returns the kernel's tiles."""
    from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda
    from wgpu_n_body_tpu_torch.ops.tree_walk_group import tile_setup

    got = gcuda.tile_setup_cuda(split, n, tp)
    torch.cuda.synchronize()
    wants = [tile_setup(None, n, tp, split=split)]
    if keys is not None:
        wants.append(tile_setup(keys, n, tp))
    for want in wants:
        bad = tiles_differ(got, want)
        if bad:
            fail(f"{what}: B4 · T's {bad} differ from the plain tile_setup's")
    return got


def tile_bytes(tiles, n):
    """Bytes the tile set-up must move: n split levels read (1 byte each),
    tile_id (int64), slot (int32) and deferred (bool) written per receiver,
    piece_start and piece_len (int32) per tile."""
    return n + n * 13 + tiles.t_cap * 8


def phase_tiles(dev, smi):
    """12g. B4 · T on the inputs that reach its edges: overfull max-depth
    cells (groups longer than a block), split levels that spill past the
    tile budget, n < walk_tile, walk_tile 1, 2, 3 and 7 (windows below 8
    bytes, and widths not a power of 2), n off the block size, split
    levels at an address off 4 bytes (a slice)."""
    from wgpu_n_body_tpu_torch.ops import morton
    from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda
    from wgpu_n_body_tpu_torch.ops.tree_build import morton_order
    from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams

    block = gcuda.tile_block_items()  # receivers per block of csrc/tile_setup.cu
    gen = torch.Generator(device=dev).manual_seed(7)
    # 48 points each held by 5,000 bodies (overfull max-depth cells) among
    # uniform ones, through the build kernels
    n = 262144
    pos = torch.rand((n, 3), generator=gen, device=dev) * 2.0 - 1.0
    pos[: 48 * 5000] = pos[:48].repeat_interleave(5000, 0)
    params, tp = SimParams(particle_num=n), TreeParams()
    z = torch.zeros_like(pos)
    _, tree, keys, _ = sorted_scene(ParticleState(pos, z, z, torch.ones(n, device=dev)), params,
                                    tp)
    tiles = held_tiles("12g duplicates", tree.split, n, tp, keys)
    same = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), keys[1:] != keys[:-1]])
    run = int(torch.diff(torch.nonzero(torch.cat([same, same.new_ones(1)])).flatten()).max())
    if run <= block:
        fail(f"12g the duplicates scene's longest run of equal keys is {run}")
    lines = [f"duplicates N={n} (longest run of one key {run}, {int(tiles.deferred.sum())} "
             f"deferred)"]
    del pos, z, tree, keys, same
    # synthetic split levels: random, and every receiver a group start
    for name, n, s in (
        ("random split levels", 100_003,
         torch.randint(0, 18, (100_003,), generator=gen, device=dev).to(torch.uint8)),
        ("all split levels 0", 50_000, torch.zeros(50_000, dtype=torch.uint8, device=dev)),
    ):
        tp = TreeParams(walk_tile=256)
        tiles = held_tiles(f"12g {name}", s, n, tp)
        spilled = int(tiles.deferred.sum())
        if not spilled:
            fail(f"12g {name}: nothing spilled past the tile budget")
        lines.append(f"{name} N={n} walk_tile 256 ({spilled} spilled past t_cap {tiles.t_cap})")
    # small and ragged sizes, split levels of a uniform draw's sorted keys
    for n, walk_tile in ((1, 512), (300, 512), (5000, 1), (2047, 256), (3 * block + 17, 256),
                         (3 * block + 17, 2), (3 * block + 17, 3), (3 * block + 17, 7),
                         (block, 512)):
        tp = TreeParams(walk_tile=walk_tile)
        pos = torch.rand((n, 3), generator=gen, device=dev) * 2.0 - 1.0
        keys = morton_order(pos, tp.max_depth)[2]
        split = morton.split_levels(keys, tp.max_depth).to(torch.uint8)
        held_tiles(f"12g N={n} walk_tile {walk_tile}", split, n, tp, keys)
        lines.append(f"N={n} walk_tile {walk_tile}")
    held_tiles(f"12g a slice at byte 1, N={n - 1} walk_tile 512", split[1:], n - 1,
               TreeParams(walk_tile=512), keys[1:])
    lines.append(f"a slice at byte 1, N={n - 1}")
    print(f"12g B4 · T bit-equal to the plain tile_setup: " + "; ".join(lines))


def phase_b4(dev, smi, mhz):
    """12. The group walk kernels (B4: the walk kernel writing the lists, the
    evaluation kernel summing them) against their plain versions, float64,
    B1 and B3."""
    from wgpu_n_body_tpu_torch.inits import disc_init, uniform_init
    from wgpu_n_body_tpu_torch.ops import naive_cuda, tree_walk_cuda
    from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda
    from wgpu_n_body_tpu_torch.ops.naive_ref import mean_rel_err, naive_forces_ref
    from wgpu_n_body_tpu_torch.ops.tree_build import NO_CHILD
    from wgpu_n_body_tpu_torch.ops.tree_walk_group import (
        LIST_CHUNK,
        Tiles,
        group_eval_lists,
        group_walk_lists,
        list_ids,
        max_chunks,
        pool_chunks,
        tile_setup,
    )
    from wgpu_n_body_tpu_torch.params import SimParams, TreeParams

    group = gcuda.group_tree_forces_cuda

    # -- 12a. every tile at N=262144: each kernel vs its plain version --------
    # walk_tile 128, 256 and 512 launch the evaluation kernel's three
    # instantiations (one, two and four receivers per thread); 256 is the
    # default at this N and 512 the default of the N=4M main path
    params = SimParams(particle_num=N_MAIN)
    max_abs, ms_plain = 0.0, None
    for name, init in (("uniform", uniform_init), ("disc", disc_init)):
        ss, tree, keys, pos_new = sorted_scene(init(torch.Generator().manual_seed(0), params, dev),
                                               params, TreeParams())
        for g_tile in (128, 256, 512):
            tp = TreeParams(walk_tile=g_tile)  # otherwise the defaults: theta 0.75
            tiles = held_tiles(f"12a {name} walk_tile {g_tile}", tree.split, N_MAIN, tp, keys)

            def walk_and_eval():
                lists = gcuda.group_walk_lists_cuda(pos_new, tree, tiles, tp)
                return lists, gcuda.group_eval_lists_cuda(pos_new, ss.pos, ss.mass, tree, tiles,
                                                          lists, params)

            ms_k, (k_walk, k_acc) = time_ms(walk_and_eval, 3)
            k_lists = gcuda.group_walk_lists_cuda(pos_new, tree, tiles, tp)
            k_eval = gcuda.group_eval_lists_cuda(pos_new, ss.pos, ss.mass, tree, tiles, k_lists,
                                                 params)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p_lists = group_walk_lists(pos_new, tree, tiles, tp)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            p_acc = group_eval_lists(pos_new, ss.pos, ss.mass, tree, tiles, k_lists, params)
            torch.cuda.synchronize()
            ms_p, ms_pe = (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3
            what = f"B4 {name} walk_tile {g_tile}"
            if k_lists.pool_full.any() or p_lists.pool_full.any():
                fail(f"{what}: the list pool ran out at the default size")
            if not (torch.equal(k_lists.bad, p_lists.bad)
                    and torch.equal(k_lists.steps, p_lists.steps)):
                fail(f"{what}: deferred tiles or step counts differ from the plain version "
                     f"({int((k_lists.bad != p_lists.bad).sum())} flags, "
                     f"{int((k_lists.steps != p_lists.steps).sum())} counts)")
            fin = ~p_lists.bad
            if not torch.equal(k_lists.rows[fin], p_lists.rows[fin]):
                fail(f"{what}: list rows of the finished tiles differ from the plain version")
            k_ids, p_ids = list_ids(k_lists)[fin], list_ids(p_lists)[fin]
            if not torch.equal(k_ids, p_ids):
                fail(f"{what}: the walk kernel's list ids differ from the plain version's in "
                     f"{int((k_ids != p_ids).any(1).sum())} tiles")
            if not all(torch.equal(getattr(k_walk, f), getattr(k_lists, f))
                       for f in ("bad", "rows", "steps")):
                fail(f"{what}: two walks of the same tiles differ")
            good = ~(tiles.deferred | p_lists.bad[tiles.tile_id])
            if not torch.equal(k_acc[good], k_eval[good]):
                fail(f"{what}: two evaluations of the same tiles differ")
            rel = row_rel_err(k_eval[good], p_acc[good])
            abs_err = (k_eval[good] - p_acc[good]).abs().max().item()
            nt = int((tiles.piece_len > 0).sum())
            print(f"12a {what} N={N_MAIN} theta=0.75: {nt} tiles, {int(k_lists.bad.sum())} "
                  f"deferred, steps/tile max {int(k_lists.steps.max())} mean "
                  f"{float(k_lists.steps[:nt].float().mean()):.1f}, list rows "
                  f"{int(k_lists.rows[fin].sum())} — walk kernel: flags, steps, rows and "
                  f"{int(k_ids.ne(-1).sum())} list ids equal to the plain version's; "
                  f"evaluation kernel vs plain on those lists, {int(good.sum())} receivers: "
                  f"per-row p99 {np.percentile(rel, 99):.3e} max {rel.max():.3e}, max|k-p| "
                  f"{abs_err:.3e}; kernels {ms_k:.3f} ms, plain {ms_p:.3f} + {ms_pe:.3f} ms; "
                  f"[{smi}]")
            if not np.isfinite(rel).all() or np.percentile(rel, 99) > 1e-5:
                fail(f"{what}: forces differ from the plain version (gate p99 1e-5)")
            max_abs = max(max_abs, abs_err)
            if name == "uniform" and g_tile == 512:  # the main path's instantiation
                ms_plain = ms_p + ms_pe
            del tiles, k_walk, k_acc, k_eval, p_acc, k_lists, p_lists, k_ids, p_ids
        del ss, tree, keys, pos_new
    torch.cuda.empty_cache()

    # -- 12h. partial tiles: a receiver's sum does not depend on its tile ------
    # The evaluation kernel sums a list only for a tile's live 32-receiver
    # blocks, block k on warp k % 4. Hand-made tiles of many lengths, each
    # length at four tile indices and four offsets into the full tile, all
    # share one full tile's list; their receivers are slices of that tile's.
    # Every row must equal bit for bit the row the full tile gives the same
    # receiver (the parent's shape: every block summed), and the kernel's
    # counter rows x 32 x live blocks. The receivers lie past the sources
    # (gid_offset n), so no self pair is masked in either launch.
    ss, tree, keys, pos_new = sorted_scene(disc_init(torch.Generator().manual_seed(0), params, dev),
                                           params, TreeParams())
    tp = TreeParams(walk_tile=512)
    tiles = gcuda.tile_setup_cuda(tree.split, N_MAIN, tp)
    lists = gcuda.group_walk_lists_cuda(pos_new, tree, tiles, tp)
    fine = torch.nonzero((tiles.piece_len == 512) & ~lists.bad & ~lists.pool_full).flatten()
    t0 = int(fine[fine.numel() // 2])
    p0, rows0 = int(tiles.piece_start[t0]), int(lists.rows[t0])
    for g_tile, lens in ((512, (1, 31, 32, 33, 97, 200, 511, 512)), (256, (1, 31, 33, 129, 255, 256)),
                         (128, (1, 31, 33, 127, 128))):
        base = pos_new[p0:p0 + g_tile].contiguous()
        spec = [(ln, (g_tile - ln) * r // 3) for ln in lens for r in range(4)]  # (length, offset)
        recv = torch.cat([base[o:o + ln] for ln, o in spec])
        n_r, t_made = recv.shape[0], len(spec)

        def made(lengths):
            lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
            start = (torch.cumsum(lengths, 0) - lengths).to(torch.int32)
            tile_id = torch.repeat_interleave(torch.arange(len(lengths), device=dev),
                                              lengths.long())
            slot = torch.cat([torch.arange(int(x), dtype=torch.int32, device=dev)
                              for x in lengths])
            no = torch.zeros(len(lengths), dtype=torch.bool, device=dev)
            m = Tiles(tile_id, slot, start, lengths, torch.zeros(int(lengths.sum()),
                      dtype=torch.bool, device=dev), len(lengths), g_tile, tiles.r_cap)
            return m, lists._replace(chunks=lists.chunks[t0].repeat(len(lengths), 1),
                                     rows=lists.rows[t0].repeat(len(lengths)), bad=no,
                                     pool_full=no, defer=None, defer_len=None)

        m_tiles, m_lists = made([ln for ln, _ in spec])
        f_tiles, f_lists = made([g_tile])
        counted = torch.zeros((), dtype=torch.int64, device=dev)
        got = gcuda.group_eval_lists_cuda(recv, ss.pos, ss.mass, tree, m_tiles, m_lists, params,
                                          N_MAIN, pairs=counted)
        full = gcuda.group_eval_lists_cuda(base, ss.pos, ss.mass, tree, f_tiles, f_lists, params,
                                           N_MAIN)
        want = torch.cat([full[o:o + ln] for ln, o in spec])
        plain = group_eval_lists(recv, ss.pos, ss.mass, tree, m_tiles, m_lists, params, N_MAIN)
        rel = row_rel_err(got, plain)
        computed = rows0 * 32 * sum(-(-ln // 32) for ln, _ in spec)
        print(f"12h walk_tile {g_tile}: {t_made} hand-made tiles of {sorted(set(lens))} "
              f"receivers (each at 4 offsets) on one {rows0}-row list, {n_r} receivers: "
              f"bit-equal to the full tile's rows {torch.equal(got, want)}; counter "
              f"{int(counted)} (rule {computed}); vs plain per-row p99 "
              f"{np.percentile(rel, 99):.3e} max {rel.max():.3e}")
        if not (torch.equal(got, want) and torch.isfinite(got).all()):
            fail(f"12h walk_tile {g_tile}: a partial tile's rows differ from the full tile's "
                 f"({int((got != want).any(1).sum())} rows)")
        if int(counted) != computed:
            fail(f"12h walk_tile {g_tile}: the kernel counted {int(counted)} pairs, not {computed}")
        if np.percentile(rel, 99) > 1e-5:
            fail(f"12h walk_tile {g_tile}: forces differ from the plain version (gate p99 1e-5)")
    del ss, tree, keys, pos_new, tiles, lists, recv, got, full, want, plain
    torch.cuda.empty_cache()

    # -- 12b. the N=4M tree: 2048 receivers against float64 and B3 -------------
    params = SimParams(particle_num=N_TREE)  # cli headless defaults
    tp = TreeParams()  # walk_tile resolves to 512 at this N
    ss, tree, keys, pos_new = sorted_scene(
        uniform_init(torch.Generator().manual_seed(0), params, dev), params, tp)
    acc, stats = group(pos_new, ss.pos, ss.mass, tree, keys, params, tp)
    gen = torch.Generator().manual_seed(1)
    idx = torch.randperm(N_TREE, generator=gen)[:2048].sort().values.to(dev)
    b3_sub = tree_walk_cuda.tree_forces_cuda(pos_new[idx], ss.pos, ss.mass, tree, params, tp,
                                             self_idx=idx.to(torch.int32))
    truth = naive_forces_ref(pos_new[idx].double(), ss.pos.double(), ss.mass.double(), params,
                             block=16, row_offset=idx)
    mre_4, mre_3 = mean_rel_err(acc[idx], truth), mean_rel_err(b3_sub, truth)
    print(f"12b N={N_TREE} theta=0.75 vs float64 all-pairs on {idx.numel()} receivers: mean "
          f"relative error B4 {mre_4:.4e}, B3 {mre_3:.4e} (gates 0.03 and 1.01 x B3)")
    if not (mre_4 <= 0.03 and mre_4 <= 1.01 * mre_3):
        fail("the group walk is less accurate than the gates allow")
    del truth, b3_sub

    # -- 12e. the full N=4M walk, each stage timed, beside B3 ------------------
    ms_group, (acc2, stats2) = time_ms(
        lambda: group(pos_new, ss.pos, ss.mass, tree, keys, params, tp), 3)
    if not torch.equal(acc2, acc) or not torch.isfinite(acc).all():
        fail("the N=4M group walk is non-finite or differs between two runs")
    tiles = held_tiles("12e N=4M", tree.split, N_TREE, tp, keys)
    ms_walk, lists = time_ms(lambda: gcuda.group_walk_lists_cuda(pos_new, tree, tiles, tp), 3)
    ms_eval, _ = time_ms(lambda: gcuda.group_eval_lists_cuda(
        pos_new, ss.pos, ss.mass, tree, tiles, lists, params), 3)
    ms_kern = ms_walk + ms_eval
    # B4 · T: timed beside its plain version (on the build's split levels, as
    # the card's step ran it before the kernel) and its bytes bound; two
    # launches bit-equal; one split level changed must change the tiles
    # (its ms: the device time of its launches; CUDA events around a call
    # also time the wrapper's enqueue, which is longer)
    ms_events, again = time_ms(lambda: gcuda.tile_setup_cuda(tree.split, N_TREE, tp), 20)
    t_split = launch_split(lambda: gcuda.tile_setup_cuda(tree.split, N_TREE, tp), 20)
    t_ops = sum(c for _, c in t_split.values())
    t_split = {k: ms for k, (ms, _) in t_split.items()}
    ms_setup = sum(t_split.values())
    ms_setup_plain, _ = time_ms(lambda: tile_setup(keys, N_TREE, tp, split=tree.split), 3)
    if tiles_differ(again, tiles):
        fail(f"12e two B4 · T launches differ in {tiles_differ(again, tiles)}")
    k = N_TREE // 2 + int(torch.nonzero(tiles.slot[N_TREE // 2:] != 0)[0])  # not a break
    planted = tree.split.clone()
    planted[k] = 0  # a group start there
    if not tiles_differ(gcuda.tile_setup_cuda(planted, N_TREE, tp), tiles):
        fail("12e a changed split level left B4 · T's tiles as they were")
    del again, planted
    t_bytes = tile_bytes(tiles, N_TREE)
    t_bound = t_bytes / HBM_PEAK * 1e3
    print(f"12e B4 · T at N={N_TREE} (walk_tile {tiles.g}, t_cap {tiles.t_cap}): bit-equal to "
          f"the plain tile_setup on the build's split levels and on the keys', two launches "
          f"bit-equal, a planted split level (receiver {k}) caught; kernel {ms_setup:.4f} ms of "
          f"device time (" + ", ".join(f"{k} {v:.4f}" for k, v in t_split.items())
          + f"; {ms_events:.4f} ms by events with the enqueue), plain {ms_setup_plain:.3f} ms, "
          f"bound {t_bound:.4f} ms ({t_bytes} bytes at 3.35 TB/s): {t_bound / ms_setup:.2%}; "
          f"{t_ops} device op(s) per call; [{smi}]")
    tile_rec = {
        "name": "tile_setup",
        "route": "cuda",
        "source": "wgpu_n_body_tpu_torch/csrc/tile_setup.cu",
        "replaces": "wgpu_n_body_tpu/ops/tree_walk_group.py:184",
        "launches": 0,  # set from the main path's run (phase 13)
        "max_abs_err": 0.0,  # integers, compared for equality
        "ms": ms_setup,
        "events_ms": ms_events,
        "device_ms_by_launch": t_split,
        "plain_ms": ms_setup_plain,
        "bound_ms": t_bound,
        "bound_by": "bytes",
        "bound_unit": "HBM",
        "bound_bytes": t_bytes,
        "library_ms": None,
        "library": ("none: no single PyTorch call computes the density-adaptive tiles (sliding "
                    "windows of split levels and two dependent scans)"),
        "ms_receivers": N_TREE,
        "design": "redesign of the kernels of commit f59feb3",
        "device_ops_per_call": t_ops,
    }
    ms_b3, _ = time_ms(
        lambda: tree_walk_cuda.tree_forces_cuda(pos_new, ss.pos, ss.mass, tree, params, tp), 2)
    nt = int((tiles.piece_len > 0).sum())
    deferred, pool_deferred = int(stats.deferred), int(stats.pool_deferred)
    m = int(tree.num_nodes)
    internal = int((tree.nodes_f32[:m, NO_CHILD] == 0).sum())
    tp2 = TreeParams(walk_list_cap=2 * tp.walk_list_cap)
    deferred2 = int(group(pos_new, ss.pos, ss.mass, tree, keys, params, tp2)[1].deferred)
    fin = ~(lists.bad | lists.pool_full)[:nt]
    rows_fin = lists.rows[:nt][fin].double()
    pairs = float((rows_fin * tiles.piece_len[:nt][fin].double()).sum())  # receiver-row pairs
    used = int((lists.chunks >= 0).sum())
    # receiver-row pairs in the 32-row groups that hold one of the tile's own
    # receivers: the evaluation kernel runs its self-masked loop on those
    ids = list_ids(lists)[:nt]
    ids = torch.nn.functional.pad(ids, (0, -ids.shape[1] % 32), value=-1)
    rel_id = ids - (tree.nodes_f32.shape[0] + tiles.piece_start[:nt].long())[:, None]
    own = (rel_id >= 0) & (rel_id < tiles.piece_len[:nt].long()[:, None])
    masked = own.view(nt, -1, 32).any(2).sum(1).double() * 32
    masked_share = float((masked * tiles.piece_len[:nt]).sum()) / pairs
    del ids, rel_id, own
    b4_bound = bound(pairs, 2, 20, N_TREE * (12 + 16 + 12) + tree.nodes_f32.numel() * 4 + 3 * m * 4,
                     mhz)
    print(f"12e N={N_TREE} group walk (tiles of {tiles.g}, r_cap {tiles.r_cap}): {ms_group:.3f} ms "
          f"per call (tile set-up {ms_setup:.4f} ms; B4 {ms_kern:.3f} ms = walk kernel "
          f"{ms_walk:.3f} + evaluation kernel with its table {ms_eval:.3f}; the rest the "
          f"tables' pack launch and B3 over the deferred list); B3 full per-particle walk "
          f"{ms_b3:.3f} ms; "
          f"{nt} tiles, {int(lists.bad.sum())} bad, {int(lists.pool_full.sum())} without pool "
          f"room, {deferred} receivers deferred ({pool_deferred} for the pool; {deferred2} with "
          f"twice the step budget); steps/tile max {int(lists.steps.max())} mean "
          f"{float(lists.steps[:nt].float().mean()):.1f}; list rows {int(rows_fin.sum())} "
          f"({float(rows_fin.mean()):.1f} per finished tile) in {used} of "
          f"{pool_chunks(N_TREE)} pool chunks; {pairs:.4e} receiver-row pairs "
          f"({pairs / (ms_eval * 1e-3):.4e} per s in the evaluation kernel; {masked_share:.2%} "
          f"of them in self-masked 32-row groups, padding included); SFU bound "
          f"{b4_bound['bound_ms']:.3f} ms at {mhz:.0f} MHz: B4 at "
          f"{b4_bound['bound_ms'] / ms_kern:.2%} of it, the evaluation kernel alone "
          f"{b4_bound['bound_ms'] / ms_eval:.2%}; internal nodes {internal} "
          f"({internal / N_TREE:.4f} N; the JAX octet table holds {tp.octet_capacity(N_TREE)} "
          f"rows); [{smi}]")
    if deferred or pool_deferred:
        fail("the N=4M uniform group walk deferred receivers")
    del ss, tree, keys, pos_new, acc, acc2, tiles, lists
    torch.cuda.empty_cache()

    # -- 12c. theta=0 against the all-pairs kernel B1 at N=16384 ---------------
    p16 = SimParams(particle_num=16384, g=1e-5)
    tp0 = TreeParams(theta=0.0, walk_list_cap=16384)  # every tile finishes: B4 alone
    ss16, tree16, keys16, pn16 = sorted_scene(
        uniform_init(torch.Generator().manual_seed(5), p16, dev), p16, tp0)
    kt, st0 = group(pn16, ss16.pos, ss16.mass, tree16, keys16, p16, tp0)
    kn = naive_cuda.naive_forces_cuda(pn16, ss16.pos, ss16.mass, p16)
    torch.cuda.synchronize()
    rel = row_rel_err(kt, kn)
    print(f"12c theta=0 group walk vs B1 at N=16384: {int(st0.deferred)} deferred, per-row p99 "
          f"{np.percentile(rel, 99):.3e} max {rel.max():.3e} (gate p99 2e-4)")
    if int(st0.deferred) != 0 or not np.isfinite(rel).all() or np.percentile(rel, 99) > 2e-4:
        fail("the theta=0 group walk differs from the all-pairs kernel")

    # -- 12d. every tile over its budget, or no pool room: the rows are B3's ---
    tpd = TreeParams(theta=0.0, walk_list_cap=128)
    kd, std = group(pn16, ss16.pos, ss16.mass, tree16, keys16, p16, tpd)
    want = tree_walk_cuda.tree_forces_cuda(pn16, ss16.pos, ss16.mass, tree16, p16, tpd)
    torch.cuda.synchronize()
    if int(std.deferred) != 16384 or not torch.equal(kd, want):
        fail(f"forced deferral: {int(std.deferred)} deferred, rows equal to B3: "
             f"{torch.equal(kd, want)}")
    # a pool one chunk short of the lists: some tiles find no room. At
    # theta=0.3, not 0: at theta=0 B3 and B4's evaluation sum the same sources
    # in the same order through the same pair term and give the same bits, so
    # a row that moved to B3 could not be told from one that stayed
    tpp = TreeParams(theta=0.3, walk_list_cap=16384)
    ktp, st3 = group(pn16, ss16.pos, ss16.mass, tree16, keys16, p16, tpp)
    if int(st3.deferred) != 0:
        fail(f"theta=0.3 with a roomy pool deferred {int(st3.deferred)} receivers")
    tiles16 = held_tiles("12d", tree16.split, 16384, tpp, keys16)
    roomy = gcuda.group_walk_lists_cuda(pn16, tree16, tiles16, tpp)
    n_small = int((roomy.chunks >= 0).sum()) - 1
    with pool_of(gcuda, n_small):
        small = gcuda.group_walk_lists_cuda(pn16, tree16, tiles16, tpp)
        kp, stp = group(pn16, ss16.pos, ss16.mass, tree16, keys16, p16, tpp)
    full = small.pool_full
    if not full.any() or full.all() or int((small.chunks >= 0).sum()) > n_small:
        fail(f"a pool of {n_small} chunks: {int(full.sum())} tiles without room")
    acc_s = gcuda.group_eval_lists_cuda(pn16, ss16.pos, ss16.mass, tree16, tiles16, small, p16)
    rest = ~full[tiles16.tile_id]
    if not torch.equal(acc_s[rest], ktp[rest]):
        fail("tiles that found pool room differ from the run with a roomy pool")
    b3_0 = tree_walk_cuda.tree_forces_cuda(pn16, ss16.pos, ss16.mass, tree16, p16, tpp)
    same, as_b3 = (kp == ktp).all(1), (kp == b3_0).all(1)
    moved = int((~same).sum())
    if not (same | as_b3).all() or not 0 < moved <= int(stp.pool_deferred) == int(stp.deferred):
        fail(f"pool deferral: {int(stp.pool_deferred)} receivers reported, {moved} rows moved, "
             f"rows other than the roomy run's or B3's: {int((~(same | as_b3)).sum())}")
    print(f"12d theta=0, walk_list_cap=128: {int(std.deferred)} of 16384 deferred, rows equal "
          f"to B3's; theta=0.3 with a pool of {n_small} chunks (one short): {int(full.sum())} "
          f"tiles without room, the others equal to the roomy run; through the wrapper {int(stp.pool_deferred)} "
          f"receivers deferred for the pool, each row the roomy run's or B3's")
    del ss16, tree16, keys16, pn16, roomy, small
    torch.cuda.empty_cache()

    # -- 12f. the list pool at N=2M disc theta=0.5 (BASELINE's tree config) --
    n2 = 2_000_000
    p2, tp5 = SimParams(particle_num=n2), TreeParams(theta=0.5)  # walk_tile resolves to 256
    disc2 = disc_init(torch.Generator().manual_seed(0), p2, dev)
    ss, tree, keys, pos_new = sorted_scene(disc2, p2, tp5)
    tiles = held_tiles("12f N=2M disc theta=0.5", tree.split, n2, tp5, keys)
    worst = tiles.t_cap * max_chunks(tiles)  # every tile's list at its step budget
    with pool_of(gcuda, worst):
        need = gcuda.group_walk_lists_cuda(pos_new, tree, tiles, tp5)
    used = int((need.chunks >= 0).sum())
    ms_disc, (_, st5) = time_ms(lambda: group(pos_new, ss.pos, ss.mass, tree, keys, p2, tp5), 2)
    nt = int((tiles.piece_len > 0).sum())
    fin = ~need.bad[:nt]
    print(f"12f N={n2} disc theta=0.5 (tiles of {tiles.g}): {nt} tiles, {int(need.bad.sum())} "
          f"over the step budget; with a pool of every tile's budget ({worst} chunks) the walk "
          f"takes {used} chunks, {used * LIST_CHUNK / n2:.3f} ids per receiver (finished tiles' "
          f"rows {float(need.rows[:nt][fin].double().sum()) / n2:.3f} per receiver); the default "
          f"pool holds {pool_chunks(n2)} chunks ({pool_chunks(n2) * LIST_CHUNK / n2:.3f} per "
          f"receiver, {pool_chunks(n2) / max(used, 1):.2f}x that need): {int(st5.deferred)} "
          f"receivers deferred, {int(st5.pool_deferred)} for the pool; group walk "
          f"{ms_disc:.3f} ms; [{smi}]")
    if int(st5.pool_deferred) or used > pool_chunks(n2):
        fail("the default list pool is too small for the N=2M disc theta=0.5 scene")
    # the step's own pool counters, under a profiler: the same lists, so
    # the same chunks as the walk above with a pool of every budget
    from wgpu_n_body_tpu_torch.models import TreeSim
    from wgpu_n_body_tpu_torch.utils import profiling

    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        TreeSim(p2, tp5).step_fn()(disc2)
        torch.cuda.synchronize()
    counted = profiling.counters()
    profiling.reset_counters()
    print(f"12f the step's counters under a profiler: walk.pool_chunks "
          f"{counted.get('walk.pool_chunks')} (the walk above took {used}), walk.pool_cap "
          f"{counted.get('walk.pool_cap')} (pool_chunks {pool_chunks(n2)}): the pool "
          f"{100.0 * used / pool_chunks(n2):.2f}% full")
    if counted.get("walk.pool_chunks") != used or counted.get("walk.pool_cap") != pool_chunks(n2):
        fail("12f the step's walk.pool_chunks or walk.pool_cap differs from the walk's own count")
    del ss, tree, keys, pos_new, tiles, need, disc2
    torch.cuda.empty_cache()
    phase_tiles(dev, smi)
    return tile_rec, {
        "name": "tree_walk_group",
        "route": "cuda",
        "source": "wgpu_n_body_tpu_torch/csrc/tree_walk_group.cu",
        "replaces": "wgpu_n_body_tpu/ops/tree_walk_group.py:245",
        "launches": 0,  # set from the main path's run (phase 13)
        "max_abs_err": max_abs,
        "ms": ms_kern,
        "plain_ms": ms_plain,
        **b4_bound,
        "library_ms": None,
        "library": NO_LIBRARY,
        "ms_receivers": N_TREE,
        "plain_ms_receivers": N_MAIN,
        "plain_ms_walk_tile": 512,
        "walk_kernel_ms": ms_walk,
        "eval_kernel_ms": ms_eval,
        "whole_walk_ms": ms_group,
        "b3_ms_same_run": ms_b3,
    }


def glue_bytes(rows, n):
    """Bytes the group walk's tables must move: per arena row the node (32
    bytes) and its skip, first and count (12) read, its record (32) and its
    table row (16) written; per source its position and mass (16) read and
    its table row (16) written."""
    return rows * (32 + 12 + 32 + 16) + n * (16 + 16)


def parent_glue(pos_new, src_pos, src_mass, tree, tiles, lists, params, tp, g0):
    """What the group walk ran after its walk kernel while it merged B3's
    rows by a mask: the eager [node | source] table (four strided ops), the
    evaluation on it, the deferred masks gathered per receiver, B3's pack
    (the records alone) and its walk over all receivers behind the mask,
    reading the table's source rows, and ``torch.where``.
    Returns (acc, table, deferred mask, pool mask)."""
    from wgpu_n_body_tpu_torch.ops import tree_walk_cuda
    from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda
    from wgpu_n_body_tpu_torch.ops.tree_build import NODE_F32_COLS
    from wgpu_n_body_tpu_torch.ops.tree_walk_group import source_table

    table = source_table(tree, src_pos, src_mass, params.g * params.dt)
    acc = gcuda.group_eval_lists_cuda(pos_new, src_pos, src_mass, tree, tiles, lists, params, g0,
                                      table)
    bad = tiles.deferred | lists.bad[tiles.tile_id]
    full = lists.pool_full[tiles.tile_id] & ~bad
    deferred = bad | full
    self_idx = None
    if g0:
        self_idx = torch.arange(g0, g0 + pos_new.shape[0], dtype=torch.int32,
                                device=pos_new.device)
    # B3 as the parent launched it with the table in hand: its pack writes
    # the records alone, and its walk reads the table's source rows in place
    rows, n = tree.nodes_f32.shape[0], src_pos.shape[0]
    rec = torch.empty((rows, NODE_F32_COLS), dtype=torch.float32, device=pos_new.device)
    tree_walk_cuda._pack(tree, src_pos, src_mass, float(params.g * params.dt), rec, None, None)
    fallback = torch.empty_like(acc)
    err = tree_walk_cuda._library().tree_walk_launch(
        pos_new.data_ptr(), rec.data_ptr(), table.data_ptr() + rows * 16,
        tree.num_nodes.data_ptr(), None if self_idx is None else self_idx.data_ptr(),
        deferred.data_ptr(), fallback.data_ptr(), None, pos_new.shape[0], n, rows,
        float(tp.theta), float(params.e), *tree_walk_cuda._target(pos_new.device))
    if err != 0:
        fail(f"12i: the parent composition's B3 launch failed: cudaError_t {err}")
    return torch.where(deferred[:, None], fallback, acc), table, deferred, full


def new_glue(pos_new, src_pos, src_mass, tree, tiles, lists, params, tp, g0):
    """The group walk's launches besides its walk kernel, as
    ``group_tree_forces_cuda`` makes them: the tables in one pack launch,
    the evaluation, B3 over the walk kernel's deferred list into the
    evaluation's rows. Returns (acc, table)."""
    from wgpu_n_body_tpu_torch.ops import tree_walk_cuda
    from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda

    rec, table = tree_walk_cuda.walk_tables_cuda(tree, src_pos, src_mass, params)
    acc = gcuda.group_eval_lists_cuda(pos_new, src_pos, src_mass, tree, tiles, lists, params, g0,
                                      table)
    tree_walk_cuda.tree_forces_listed_cuda(pos_new, rec, table, tree, lists.defer,
                                           lists.defer_len, g0, params, tp, out=acc)
    return acc, table


def held_glue(what, pos_new, src_pos, src_mass, tree, keys, tiles, params, tp, g0=0,
              timed=False):
    """12i on one walk: the walk kernel once, then the parent's composition
    and the new one on the same lists (which tiles a full pool defers
    depends on scheduling). The table and ``acc`` ``torch.equal``; the lazy
    ``deferred_mask`` and ``pool_mask`` and their counts equal the parent's
    masks'; the kernel's deferred list, sorted, equal to the plain
    ``deferred_warps``. ``timed``: each composition's device ms besides the
    evaluation kernel's, beside the tables' bytes bound. Returns a record."""
    from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda
    from wgpu_n_body_tpu_torch.ops.tree_walk_group import GroupWalkStats, deferred_warps

    lists = gcuda.group_walk_lists_cuda(pos_new, tree, tiles, tp)
    acc_p, table_p, deferred, pool = parent_glue(pos_new, src_pos, src_mass, tree, tiles, lists,
                                                 params, tp, g0)
    acc_n, table_n = new_glue(pos_new, src_pos, src_mass, tree, tiles, lists, params, tp, g0)
    torch.cuda.synchronize()
    stats = GroupWalkStats(tiles, lists)
    want, want_len = deferred_warps(tiles, lists)
    k = int(lists.defer_len)
    got = lists.defer[:k]
    got = got[torch.argsort(got[:, 0])]
    counts = (int(stats.deferred), int(stats.pool_deferred))
    errors = [name for name, ok in (
        ("table", torch.equal(table_n, table_p)),
        ("acc", torch.equal(acc_n, acc_p)),
        ("deferred_mask", torch.equal(stats.deferred_mask, deferred)),
        ("pool_mask", torch.equal(stats.pool_mask, pool)),
        ("deferred", counts == (int(deferred.sum()), int(pool.sum()))),
        ("deferred list", k == int(want_len) and torch.equal(got, want)),
        ("finite", bool(torch.isfinite(acc_n).all())),
    ) if not ok]
    if errors:
        fail(f"12i {what}: the new walk's {errors} differ from the parent composition's")
    rec = {"what": what, "n": pos_new.shape[0], "deferred": counts[0], "pool_deferred": counts[1],
           "deferred_warps": k}
    line = (f"12i {what}: table and acc torch.equal to the parent composition's, {counts[0]} "
            f"deferred ({counts[1]} for the pool) in {k} listed warps, equal to deferred_warps")
    if not lists.pool_full.any():  # the wrapper's own lists are the same
        acc_w, _ = gcuda.group_tree_forces_cuda(pos_new, src_pos, src_mass, tree, keys, params,
                                                tp, gid_offset=g0, tiles=tiles)
        if not torch.equal(acc_w, acc_n):
            fail(f"12i {what}: group_tree_forces_cuda differs from the composition on its lists")
        line += "; group_tree_forces_cuda the same"
    if timed:
        rows, n = tree.nodes_f32.shape[0], src_pos.shape[0]
        nbytes = glue_bytes(rows, n)
        bound_ms = nbytes / HBM_PEAK * 1e3
        for name, fn in (("parent", parent_glue), ("new", new_glue)):
            _, parts, ops = device_ms(lambda: fn(pos_new, src_pos, src_mass, tree, tiles, lists,
                                                 params, tp, g0), 10)
            glue = {k_: v for k_, v in parts.items() if k_ != "group_eval_kernel"}
            rec[f"{name}_glue_ms"] = sum(glue.values())
            rec[f"{name}_glue_ms_by_launch"] = glue
            rec[f"{name}_device_ops"] = ops
            line += (f"; {name} glue {sum(glue.values()):.4f} ms of device time in {ops - 1} ops ("
                     + ", ".join(f"{k_} {v:.4f}" for k_, v in glue.items()) + ")")
        rec.update(bound_ms=bound_ms, bound_bytes=nbytes)
        line += (f"; the tables' bytes bound {bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s): "
                 f"new glue at {bound_ms / rec['new_glue_ms']:.2%}")
    print(line)
    return rec


def phase_glue(dev, smi):
    """12i. The group walk's glue (B4 · G): the tables in one pack launch,
    the deferred list from the walk kernels, B3 over that
    list writing ``acc`` in place, held bit for bit to the composition it
    replaced (the eager table, the mask gathers, B3's pack and masked walk,
    ``torch.where``) on the same lists: the three cells' scenes (timed),
    every tile over its step budget, a pool too small, split levels that
    spill past the tile budget, a slice of receivers (gid_offset inside the
    sources) and a LET import walk (gid_offset past them)."""
    import dataclasses

    from wgpu_n_body_tpu_torch.inits import disc_init, uniform_init
    from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda
    from wgpu_n_body_tpu_torch.ops.tree_walk_group import step_budget
    from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams
    from wgpu_n_body_tpu_torch.parallel import sharded_tree as st
    from wgpu_n_body_tpu_torch.parallel.let_tree import assemble_import_forest, auto_let_cap

    records = []

    def scene(init, n, tp, seed=0):
        params = SimParams(particle_num=n)
        ss, tree, keys, pos_new = sorted_scene(init(torch.Generator().manual_seed(seed), params,
                                                    dev), params, tp)
        return params, ss, tree, keys, pos_new

    # the cells' scenes: the uniform one defers nothing, the discs some
    for what, init, n, tp in (("N=4M uniform theta=0.75", uniform_init, N_TREE, TreeParams()),
                              ("N=4M disc theta=0.75", disc_init, N_TREE, TreeParams()),
                              ("N=2M disc theta=0.5", disc_init, 2_000_000,
                               TreeParams(theta=0.5))):
        params, ss, tree, keys, pos_new = scene(init, n, tp)
        tiles = gcuda.tile_setup_cuda(tree.split, n, tp)
        records.append(held_glue(what, pos_new, ss.pos, ss.mass, tree, keys, tiles, params, tp,
                                 timed=True))
        del ss, tree, keys, pos_new, tiles
        torch.cuda.empty_cache()
    if records[0]["deferred"] or not records[1]["deferred"]:
        fail("12i the uniform scene deferred receivers, or the N=4M disc none")

    params, ss, tree, keys, pos_new = scene(disc_init, N_MAIN, TreeParams())
    # a step budget of 256: most tiles over it
    tp = TreeParams(walk_list_cap=128)
    tiles = gcuda.tile_setup_cuda(tree.split, N_MAIN, tp)
    r = held_glue("N=262144 disc walk_list_cap=128", pos_new, ss.pos, ss.mass, tree, keys, tiles,
                  params, tp)
    if not r["deferred"]:
        fail("12i walk_list_cap=128 deferred nothing")
    records.append(r)
    # a pool of half the chunks the lists take
    tp = TreeParams(theta=0.5)
    tiles = gcuda.tile_setup_cuda(tree.split, N_MAIN, tp)
    used = int((gcuda.group_walk_lists_cuda(pos_new, tree, tiles, tp).chunks >= 0).sum())
    with pool_of(gcuda, used // 2):
        r = held_glue(f"N=262144 disc theta=0.5, a pool of {used // 2} chunks", pos_new, ss.pos,
                      ss.mass, tree, keys, tiles, params, tp)
    if not r["pool_deferred"]:
        fail("12i a pool of half the chunks deferred nothing for the pool")
    records.append(r)
    # a slice of the sorted receivers: receiver i is source g0 + i
    g0, b = N_MAIN // 4, N_MAIN // 2
    tp = TreeParams(walk_list_cap=256)
    tiles = gcuda.tile_setup_cuda(tree.split[g0 : g0 + b], b, tp)
    r = held_glue(f"receivers [{g0}, {g0 + b}) of N=262144, walk_list_cap=256",
                  pos_new[g0 : g0 + b].contiguous(), ss.pos, ss.mass, tree, keys[g0 : g0 + b],
                  tiles, params, tp, g0=g0)
    if not r["deferred"]:
        fail("12i the slice's walk deferred nothing")
    records.append(r)
    del ss, tree, keys, pos_new, tiles
    # split levels that spill past the tile budget (every receiver a group
    # start), on a real tree: B4 · T defers the spills in the last tile
    n = 50_000
    tp = TreeParams(walk_tile=256)
    params, ss, tree, keys, pos_new = scene(uniform_init, n, tp)
    tiles = gcuda.tile_setup_cuda(torch.zeros(n, dtype=torch.uint8, device=dev), n, tp)
    r = held_glue(f"N={n} all split levels 0, walk_tile 256", pos_new, ss.pos, ss.mass, tree,
                  keys, tiles, params, tp)
    if r["deferred"] < int(tiles.deferred.sum()) or not tiles.deferred.any():
        fail("12i the spilled receivers were not all deferred")
    records.append(r)
    # a LET import walk of two ranks (each N=262144, rank r in [-1, 1] x
    # [r - 1, r] x [-1, 1]): rank 0's receivers against rank 1's export,
    # numbered past every source; a pool of half the chunks defers tiles
    p, n_l = 2, N_MAIN
    tp = TreeParams()
    tp_imp = dataclasses.replace(tp, walk_list_cap=tp.effective_import_list_cap())
    cap = 2 * auto_let_cap(n_l, tp.theta)
    gen = torch.Generator(device=dev).manual_seed(3)
    ranks = []
    for rank in range(p):
        pos = torch.rand((n_l, 3), generator=gen, device=dev) * 2.0 - 1.0
        pos[:, 1] = pos[:, 1] * 0.5 - 0.5 + rank
        z = torch.zeros_like(pos)
        ranks.append(ParticleState(pos, z, z, torch.ones(n_l, device=dev)))
    params = SimParams(particle_num=p * n_l)
    bound_ = torch.stack([st.let_bound(s.pos) for s in ranks]).amax(0)
    locs = [st.let_sort_build(s, bound_, params, tp) for s in ranks]
    boxes = [st.receiver_box(loc.pos_new) for loc in locs]
    blo, bhi = torch.cat([x[0] for x in boxes]), torch.cat([x[1] for x in boxes])
    imps = st.exchange_by_hand([st.let_export(loc, blo, bhi, rank, tp, cap)
                                for rank, loc in enumerate(locs)])
    loc, imp = locs[0], imps[0]
    forest = assemble_import_forest(imp)
    parts_pos = imp.parts[:, :, :3].reshape(-1, 3).contiguous()
    parts_mass = imp.parts[:, :, 3].reshape(-1).contiguous()
    tiles = gcuda.tile_setup_cuda(loc.tree.split, n_l, tp)._replace(
        r_cap=step_budget(tp_imp.walk_list_cap))
    used = int((gcuda.group_walk_lists_cuda(loc.pos_new, forest, tiles, tp_imp).chunks
                >= 0).sum())
    with pool_of(gcuda, used // 2):
        r = held_glue(f"LET import walk, gid_offset {p * cap}, a pool of {used // 2} chunks",
                      loc.pos_new, parts_pos, parts_mass, forest, loc.keys, tiles, params,
                      tp_imp, g0=p * cap)
    if not r["deferred"]:
        fail("12i the import walk deferred nothing")
    records.append(r)
    print(f"12i the group walk's glue held to the parent composition in {len(records)} walks; "
          f"[{smi}]")
    return records


def phase_host(dev, smi, mhz):
    """14. The tree-host path: the native host build, B3 on its arena, and
    ``cli headless --sim tree-host``."""
    from wgpu_n_body_tpu_torch import cli
    from wgpu_n_body_tpu_torch.inits import uniform_init
    from wgpu_n_body_tpu_torch.models import TreeSim
    from wgpu_n_body_tpu_torch.models.tree_host import host_tree_arrays
    from wgpu_n_body_tpu_torch.native.build import build_host_tree
    from wgpu_n_body_tpu_torch.ops import tree_walk_cuda
    from wgpu_n_body_tpu_torch.ops.naive_ref import mean_rel_err, naive_forces_ref
    from wgpu_n_body_tpu_torch.ops.morton_cuda import morton_order_cuda
    from wgpu_n_body_tpu_torch.ops.tree_build import morton_sort
    from wgpu_n_body_tpu_torch.ops.tree_build_cuda import build_tree_cuda
    from wgpu_n_body_tpu_torch.ops.tree_walk import walk_counts
    from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams, state_from_numpy
    from wgpu_n_body_tpu_torch.utils.checkpoint import load_checkpoint

    walk = tree_walk_cuda.tree_forces_cuda
    tp = TreeParams(leaf_bucket=1)  # what cli --sim tree-host builds: theta 0.75

    # -- 14a. the N=4M uniform scene on the host arena ---------------------------
    params = SimParams(particle_num=N_TREE)
    state = uniform_init(torch.Generator().manual_seed(0), params, dev)
    pos_h, mass_h = state.pos.cpu().numpy(), state.mass.cpu().numpy()
    t0 = time.perf_counter()
    host = build_host_tree(pos_h, mass_h, tp.effective_capacity_factor)
    s_build = time.perf_counter() - t0
    m_nodes = host.nodes_f32.shape[0] - 1
    if m_nodes > tp.capacity(N_TREE):
        fail(f"the host tree's {m_nodes} nodes exceed the cap {tp.capacity(N_TREE)}")
    tree = host_tree_arrays(host, dev)
    if tree.nodes_f32.shape[0] != m_nodes + 1 or int(tree.num_nodes) != m_nodes:
        fail("the host arena on the card is not the m + 1 rows the host made")
    order = torch.from_numpy(host.order).to(dev)
    ss = ParticleState(*(t[order] for t in state))
    pos_new = ss.pos + (ss.vel + ss.acc * (params.dt / 2.0)) * params.dt  # the drift
    del state, pos_h, mass_h
    print(f"14a host build N={N_TREE}: {s_build:.3f} s, {m_nodes} nodes ({m_nodes / N_TREE:.3f} "
          f"per body) of cap {tp.capacity(N_TREE)}; {m_nodes + 1} rows uploaded "
          f"({(m_nodes + 1) * 44 / 1e6:.1f} MB; padded to the cap it would be "
          f"{(tp.capacity(N_TREE) + 1) * 44 / 1e6:.1f} MB)")
    mid = N_TREE // 2
    gen = torch.Generator().manual_seed(1)
    sets = {"consecutive": torch.arange(mid, mid + 4096, device=dev),
            "sampled": torch.randperm(N_TREE, generator=gen)[:4096].sort().values.to(dev)}
    inter_mean, max_abs, ms_sets, ms_plain = {}, 0.0, {}, None
    for name, idx in sets.items():
        idx32 = idx.to(torch.int32)
        recv = pos_new[idx]
        k, p, counts, ms_p, abs_err, p99, _ = held_walk(
            f"14a {name}", recv, idx32, ss, tree, params, tp)
        ms_sets[name], _ = time_ms(
            lambda: walk(recv, ss.pos, ss.mass, tree, params, tp, self_idx=idx32), 5)
        sel = slice(0, None, 4)
        truth = naive_forces_ref(recv[sel].double(), ss.pos.double(), ss.mass.double(), params,
                                 block=16, row_offset=idx[sel])
        mre_k, mre_p = mean_rel_err(k[sel], truth), mean_rel_err(p[sel], truth)
        inter_mean[name] = float(counts[:, :2].sum(1).double().mean())
        print(f"14a B3 on the host arena, 4096 {name} receivers: accepted nodes (mean "
              f"{float(counts[:, 0].double().mean()):.1f}) and members (mean "
              f"{float(counts[:, 1].double().mean()):.1f}) equal to the plain rules'; vs the plain "
              f"walk per-row p99 {p99:.3e} (gate {B3_GATE:.0e}), max|k-p| {abs_err:.3e}; vs "
              f"float64 all-pairs on {truth.shape[0]} of them: mean relative error kernel "
              f"{mre_k:.4e}, plain {mre_p:.4e} (gate 0.03); kernel {ms_sets[name]:.3f} ms, plain "
              f"{ms_p:.3f} ms; a warp visits {float(counts[::32, 3].double().mean()):.1f} nodes, "
              f"one receiver {float(counts[:, 2].double().mean()):.1f}; [{smi}]")
        if not (mre_k <= 0.03 and mre_p <= 0.03):
            fail(f"14a {name}: the host-arena force is further than 0.03 from the all-pairs sum")
        max_abs, ms_plain = max(max_abs, abs_err), ms_p
        del truth
    ms_full, k_full = time_ms(lambda: walk(pos_new, ss.pos, ss.mass, tree, params, tp), 3)
    if not torch.isfinite(k_full).all():
        fail("14a: non-finite force from the full walk of the host arena")
    count = inter_mean["sampled"] * N_TREE  # scaled from the sample
    hb = bound(count, 2, 20, N_TREE * (12 + 16 + 12) + m_nodes * 44, mhz)
    print(f"14a B3 full walk of the host arena N={N_TREE}: {ms_full:.3f} ms per call, the pack "
          f"kernel included; {count:.4e} interactions scaled from the sampled receivers (mean "
          f"{inter_mean['sampled']:.1f}); bound {hb['bound_ms']:.4f} ms: "
          f"{hb['bound_ms'] / ms_full:.2%}; [{smi}]")
    del ss, tree, pos_new, k_full, order, host
    torch.cuda.empty_cache()

    # -- 14b. host arena against device arena, singleton leaves, N=262144 --------
    rng = np.random.default_rng(22)
    n = N_MAIN
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    zeros = np.zeros((n, 3), np.float32)
    pb = SimParams(particle_num=n)
    tpb = TreeParams(theta=0.5, leaf_bucket=1, walk="per_particle")
    st = state_from_numpy(pos, zeros, zeros, mass, dev)
    perm, bound_d, keys_d = morton_order_cuda(st.pos, tpb.max_depth)
    ssd, dtree = build_tree_cuda(st, perm, keys_d, bound_d, tpb)
    if bool(dtree.overflowed):
        fail("14b: the device arena with singleton leaves overflowed")
    counted = tree_walk_cuda.tree_forces_counts_cuda

    def unsorted(x, by):  # rows back to the input order
        out = torch.empty_like(x)
        out[by] = x
        return out

    k_dev, c_dev = counted(ssd.pos, ssd.pos, ssd.mass, dtree, pb, tpb)
    hostb = build_host_tree(pos, mass, tpb.effective_capacity_factor)
    order = torch.from_numpy(hostb.order).to(dev)
    ssh = ParticleState(*(t[order] for t in st))
    htree = host_tree_arrays(hostb, dev)
    k_host, c_host = counted(ssh.pos, ssh.pos, ssh.mass, htree, pb, tpb)
    torch.cuda.synchronize()
    f_dev, f_host = unsorted(k_dev, perm), unsorted(k_host, order)
    # The tolerance of tests/test_native.py:106 (rtol 5e-4, atol 1e-8 on
    # every component, which holds at its n = 400) is asked of every row
    # whose two walks could be the same walk. Two things make them differ,
    # and both are read off here rather than assumed:
    # - the two builds sum a cell's centre in another order (float32 on the
    #   host, float64 prefix sums on the card), and among the ~1e8 theta tests
    #   of this scene a few fall the other way: the receiver opens a cell the
    #   other tree accepts. Such a row's counts of accepted nodes, members
    #   and visited nodes differ between the arenas.
    # - the Morton key's cell is floor((p + bound) * scale) in float32, and
    #   that sum rounds a body just under a cell's face onto it: the device
    #   tree holds it in the neighbouring cell, the host tree (p > centre,
    #   exact) does not. Receivers around such a stray body see two cells with
    #   other contents.
    # Rows of neither kind meet the tolerance; the others are counted, held to
    # the tree's accuracy bound, and their counts checked by the plain rules.
    stray = stray_bodies(st.pos, bound_d, tpb.max_depth, htree, order)
    radius = 0.2
    near = torch.zeros(n, dtype=torch.bool, device=dev)
    if stray.numel():
        near = torch.cdist(st.pos, st.pos[stray]).amin(1) <= radius
    cnt_dev, cnt_host = unsorted(c_dev[:, :3], perm), unsorted(c_host[:, :3], order)
    flipped = (cnt_dev != cnt_host).any(1)
    outside = ~torch.isclose(f_host, f_dev, rtol=5e-4, atol=1e-8).all(1)
    relb = row_rel_err(f_host, f_dev)
    unexplained = outside & ~flipped & ~near
    rel_same = relb[(~flipped & ~near).cpu().numpy()]
    reach = float(torch.cdist(st.pos[outside & ~flipped], st.pos[stray]).amin(1).max()) \
        if stray.numel() and bool((outside & ~flipped).any()) else 0.0
    # the kernel's counts of the rows outside the tolerance, by the plain rules
    rows = outside.nonzero().flatten()
    for what, srt, by, tree_ in (("device", ssd, perm, dtree), ("host", ssh, order, htree)):
        inv = torch.empty_like(by)
        inv[by] = torch.arange(n, dtype=by.dtype, device=dev)
        want = walk_counts(srt.pos[inv[rows]], tree_, tpb)[:, :3]
        got = (cnt_dev if what == "device" else cnt_host)[rows].long()
        if not torch.equal(got, want):
            fail(f"14b: B3's counts on the {what} arena differ from the plain rules'")
    print(f"14b N={n} theta=0.5 leaf_bucket=1: B3 on the host arena ({hostb.num_nodes} nodes) vs "
          f"B3 on the device arena ({int(dtree.num_nodes)} nodes), rtol 5e-4, atol 1e-8 on every "
          f"component: {int(outside.sum())} rows outside. {int(flipped.sum())} rows' walks differ "
          f"in their counts of accepted nodes, members or visits (a theta test falls the other "
          f"way), {int((outside & flipped).sum())} of them outside, {int((flipped & ~near).sum())} "
          f"of them away from every stray body; {stray.numel()} stray bodies "
          f"(the float32 key puts them in the neighbouring cell: "
          f"{st.pos[stray].cpu().numpy().tolist()}), {int(near.sum())} rows within {radius} of "
          f"one, {int((outside & near & ~flipped).sum())} of them outside with equal counts, the "
          f"furthest {reach:.4f} away; every other row ({rel_same.size}) inside, per-row max "
          f"{rel_same.max():.3e}; the counts of the rows outside equal to the plain rules' on "
          f"both arenas; all rows per-row p99 {np.percentile(relb, 99):.3e} max {relb.max():.3e} "
          f"(gate 0.03)")
    if bool(unexplained.any()):
        fail(f"14b: {int(unexplained.sum())} rows whose walks agree, away from every stray body, "
             f"are outside rtol 5e-4, atol 1e-8")
    # measured on this scene: 1 stray body, 71 rows with other counts, 246 outside
    if (stray.numel() > 3 or int(flipped.sum()) > 150 or int(outside.sum()) > 500
            or not np.isfinite(relb).all() or relb.max() > 0.03):
        fail("14b: more stray bodies (3), rows with other counts (150) or rows outside the "
             "tolerance (500) than this scene has, or a row beyond 0.03")
    # DFS order == Morton order (tests/test_native.py:50-66): 300 bodies, depth 20
    p300, m300 = pos[:300], mass[:300]
    h300 = build_host_tree(p300, m300)
    s300, _, _ = morton_sort(state_from_numpy(p300, zeros[:300], zeros[:300], m300, dev), 20)
    if not torch.equal(s300.pos.cpu(), torch.from_numpy(p300[h300.order])):
        fail("14b: the host tree's DFS order is not the port's Morton order")
    print("14b host DFS order == morton_sort at depth 20 on 300 bodies")
    vs_device = {"rows": n, "outside_rtol_5e-4": int(outside.sum()),
                 "other_counts": int(flipped.sum()), "stray_bodies": stray.numel(),
                 "max_row_rel": float(relb.max())}
    del st, ssd, ssh, dtree, htree, f_dev, f_host, k_dev, k_host
    torch.cuda.empty_cache()

    # -- 14c. cli headless --sim tree-host at the CLI's default N -----------------
    n_cli = N_TREE if s_build <= 15.0 else 1_000_000
    if n_cli != N_TREE:
        print(f"14c one host build at N={N_TREE} took {s_build:.3f} s (> 15 s): the CLI run is at "
              f"N={n_cli}")
    steps = 3
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "host.npz")
        argv = ["headless", "--sim", "tree-host", "--steps", str(steps), "--checkpoint", ckpt]
        if n_cli != N_TREE:
            argv += ["--n", str(n_cli)]
        zero_launch_counts()
        out = run_cli(cli, argv)
        counts = launch_counts()
        if counts != expected_counts(B3=steps):
            fail(f"cli headless --sim tree-host, {steps} steps, launched {counts}")
        us = float(re.search(r"mean: (\S+) us/step", out).group(1))
        ck = load_checkpoint(ckpt, dev)
        sim = ck.make_sim()
        if not isinstance(sim, TreeSim) or sim.add_params.leaf_bucket != 1 or ck.step != steps:
            fail("the tree-host checkpoint does not reload as a TreeSim with leaf_bucket=1")
        stc = ck.state
        if stc.n != n_cli or not all(torch.isfinite(t).all() for t in stc[:3]):
            fail("non-finite or mis-sized state after the tree-host run")
        init = uniform_init(torch.Generator().manual_seed(0), SimParams(particle_num=n_cli), dev)
        if not torch.equal(torch.sort(stc.mass).values, torch.sort(init.mass).values):
            fail("the tree-host run changed the mass multiset")
        # where one step's time goes, by the host's clock around each stage
        split = host_step_split(stc, SimParams(particle_num=n_cli), tp, dev)
    print(f"14 headless tree-host N={n_cli} theta=0.75 leaf_bucket=1: {counts['B3']} B3 launches "
          f"and no other kernel in {steps} steps, {us:.1f} us/step; one more step by stage, ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f"; [{smi}]")
    return counts["B3"], {
        # `launches` is this path's: every launch walks the host arena
        "launches_arena": f"native/octree.cpp, leaf_bucket 1, {m_nodes} nodes at N={N_TREE}",
        "host_vs_device_arena": vs_device,
        "host_arena_ms": ms_full, "host_arena_bound_ms": hb["bound_ms"],
        "host_arena_bound_count": count, "host_arena_nodes": m_nodes,
        "host_arena_max_abs_err": max_abs, "host_arena_plain_ms": ms_plain,
        "host_arena_ms_consecutive_4096": ms_sets["consecutive"],
        "host_arena_ms_sampled_4096": ms_sets["sampled"],
        "host_build_s": s_build, "tree_host_n": n_cli, "tree_host_us_per_step": us,
        "tree_host_step_ms": split,
    }


def stray_bodies(pos, bound_, depth, htree, order):
    """Indices of the bodies that the Morton key (float32: ``(p + bound) *
    scale`` truncated) puts in another cell than the host build's exact
    comparisons (``p > centre``; a body on a face belongs to the lower cell),
    at a level above the body's own leaf in the host tree ``htree``, whose
    DFS order is ``order``. Positions inside the root cube; the exact cell
    is computed in float64."""
    from wgpu_n_body_tpu_torch.ops.morton import quantize
    from wgpu_n_body_tpu_torch.ops.tree_build import WIDTH

    m = int(htree.num_nodes)
    leaf = (htree.count[:m] == 1).nonzero().flatten()
    level = torch.zeros(pos.shape[0], dtype=torch.int64, device=pos.device)
    level[order[htree.first[leaf].long()]] = torch.log2(
        htree.root_width / htree.nodes_f32[leaf, WIDTH]).round().long()
    shift = torch.clamp(depth - level + 1, min=0)[:, None]  # the leaf's parent cell
    b = float(bound_)
    exact = torch.clamp(torch.ceil((pos.double() + b) * (2.0 ** depth / (2.0 * b))) - 1, min=0)
    differs = (quantize(pos, bound_, depth) >> shift) != (exact.long() >> shift)
    return differs.any(1).nonzero().flatten()


def host_step_split(state, params, tp, dev):
    """One TreeSimHost step taken apart, each stage closed by a device
    synchronise and timed on the host's clock (ms): the copy down, the C++
    build, the copy up, the gather into DFS order, B3 (pack and walk) over
    all receivers, and the rest of the leapfrog."""
    from wgpu_n_body_tpu_torch.models.tree_host import host_tree_arrays
    from wgpu_n_body_tpu_torch.native.build import build_host_tree
    from wgpu_n_body_tpu_torch.ops.integrate import leapfrog_step
    from wgpu_n_body_tpu_torch.ops.tree_walk_cuda import tree_forces_cuda
    from wgpu_n_body_tpu_torch.params import ParticleState

    out, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name], t = (now - t) * 1e3, now

    torch.cuda.synchronize()
    t = time.perf_counter()
    pos, mass = state.pos.cpu().numpy(), state.mass.cpu().numpy()
    lap("copy down")
    host = build_host_tree(pos, mass, tp.effective_capacity_factor)
    lap("host build")
    tree = host_tree_arrays(host, dev)
    order = torch.from_numpy(host.order).to(dev)
    lap("copy up")
    ss = ParticleState(*(x[order] for x in state))
    lap("gather")

    def force(pos_new, pos_old, m):
        lap("drift")
        acc = tree_forces_cuda(pos_new, pos_old, m, tree, params, tp)
        lap("B3")
        return acc

    leapfrog_step(ss, params, force)
    lap("kick")
    return out


def phase_group_cli(dev, smi):
    """13. The main path: ``cli headless`` with its defaults (group walk)."""
    from wgpu_n_body_tpu_torch import cli
    from wgpu_n_body_tpu_torch.inits import uniform_init
    from wgpu_n_body_tpu_torch.models import TreeSim
    from wgpu_n_body_tpu_torch.ops.morton import split_levels
    from wgpu_n_body_tpu_torch.ops.morton_cuda import morton_order_cuda
    from wgpu_n_body_tpu_torch.ops.tree_build_cuda import build_tree_cuda
    from wgpu_n_body_tpu_torch.params import SimParams
    from wgpu_n_body_tpu_torch.utils.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "group.npz")
        argv = ["headless", "--steps", str(STEPS), "--diag-every", str(STEPS),
                "--checkpoint", ckpt]
        zero_launch_counts()
        with kept_steps() as made:
            out = run_cli(cli, argv)
        counts = launch_counts()
        diags = re.findall(r"'walk_deferred': (\d+)", out)
        # each body the graphed step runs through the launchers (two plain
        # calls, two captures; a replay launches one capture's, uncounted)
        # sorts once (K1, K2), builds once (B5) and walks once (its tables,
        # B4, then B3 over its deferred list), and so does each diagnostics
        # line
        walks = graphed_bodies(made, STEPS) + len(diags)
        if len(diags) != 1 or counts != expected_counts(B3=walks, B4=walks, B4_eval=walks,
                                                        B4_tables=walks, B4_tiles=walks, B5=walks,
                                                        K1=walks, K2=walks):
            fail(f"cli headless, {STEPS} steps and {len(diags)} diagnostics, launched {counts}")
        if "'overflowed': False" not in out:
            fail("the tree diagnostics do not report a healthy arena")
        us = float(re.search(r"mean: (\S+) us/step", out).group(1))
        ck = load_checkpoint(ckpt, dev)
        sim = ck.make_sim()
        if not isinstance(sim, TreeSim) or sim.add_params.walk != "group" or ck.step != STEPS:
            fail("the checkpoint does not reload as a group-walk TreeSim at the last step")
        st = ck.state
        if st.n != N_TREE or not all(torch.isfinite(t).all() for t in st[:3]):
            fail("non-finite or mis-sized state after the group-walk run")
        init = uniform_init(torch.Generator().manual_seed(0), SimParams(particle_num=N_TREE), dev)
        if not torch.equal(torch.sort(st.mass).values, torch.sort(init.mass).values):
            fail("the group-walk run changed the mass multiset")
    # the step's tiles come from the build's split levels through B4 · T: on
    # the last state, equal to the plain tile_setup's on those levels and on
    # the plain split levels of the keys
    tp = sim.add_params
    perm, bound_, keys = morton_order_cuda(st.pos, tp.max_depth)
    _, tree = build_tree_cuda(st, perm, keys, bound_, tp)
    if not torch.equal(tree.split.long(), split_levels(keys, tp.max_depth)):
        fail("the build's split levels differ from the plain split levels of the keys")
    held_tiles("13 the last state", tree.split, N_TREE, tp, keys)
    del perm, keys, tree
    pool = re.findall(r"'walk_pool_deferred': (\d+)", out)
    if pool != ["0"]:
        fail(f"the N=4M diagnostics report pool deferrals {pool}")
    print(f"13 headless defaults (TreeSim N={N_TREE}, theta=0.75, group walk): K1 "
          f"{counts['K1']}, K2 {counts['K2']}, B5 builds {counts['B5']}, B4 · T "
          f"{counts['B4 tiles']}, B4 walk {counts['B4']} and evaluation {counts['B4 eval']}, B3 "
          f"{counts['B3']} launches counted in {STEPS} steps (two plain calls and two "
          f"captures, then {STEPS - 2} replays) + {len(diags)} diagnostics (walk_deferred "
          f"{diags[0]}, walk_pool_deferred {pool[0]}), {us:.1f} us/step; B4 · T's tiles from the "
          f"build's split levels equal the plain ones; [{smi}]")
    return counts


NO_RASTER_LIBRARY = ("none: no single PyTorch call rasterises triangles by the pixel-centre "
                     "rule (index_add_ or bincount only scatters the hits)")


def render_scenes():
    """(name, positions, camera, width, height, footprint) of the CPU tests'
    scenes (tests/test_torch_renderer.py, made from the same seeds)."""
    from wgpu_n_body_tpu_torch.runners.renderer import Camera

    def uniform(seed, n):
        return np.random.RandomState(seed).uniform(-0.8, 0.8, (n, 3)).astype(np.float32)

    def behind_lens(rng, n):
        return rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32) - np.float32([0, 0, 1])

    lens = Camera(eye=(0.0, 0.0, 2.0), aspect=1.0)
    rng = np.random.RandomState(7)
    near = np.concatenate([np.array([[0.0, 0.0, 1.999]], np.float32), behind_lens(rng, 3000)])
    rng = np.random.RandomState(11)
    shell = rng.uniform(-0.05, 0.05, (500, 3)).astype(np.float32) + np.float32([0, 0, 1.85])
    shell = np.concatenate([shell, behind_lens(rng, 2000)])
    rng = np.random.RandomState(3)
    n296 = rng.uniform(-0.001, 0.001, (296, 3)).astype(np.float32)
    n296[:, 2] = 1.999 + n296[:, 2] * 0.1
    n296 = np.concatenate([n296, behind_lens(rng, 500)])
    odd = uniform(5, 400)
    odd[:8] = [[np.nan, 0, 0], [0, np.nan, 0], [0, 0, np.nan], [np.inf, 0, 0],
               [0, 1, 3.0], [50, 0, 0], [0, 0, 2.0], [0, 1, 2.0]]
    return [("uniform 20000", uniform(3, 20000), Camera(aspect=1.0), 400, 400, "triangle"),
            ("splat 5000", uniform(4, 5000), Camera(aspect=1.0), 256, 256, "splat"),
            ("near lens", near, lens, 400, 400, "triangle"),
            ("shell", shell, lens, 400, 400, "triangle"),
            ("near lens 296", n296, lens, 128, 128, "triangle"),
            ("odd rows", odd, Camera(aspect=1.0), 96, 64, "triangle"),
            ("odd rows splat", odd, Camera(aspect=1.0), 96, 64, "splat")]


def held_frame(name, pos, cam, width, height, footprint, host=True, cap=None):
    """15a: B6's counts against its plain version on the card, a second
    launch and (``host``) the host render; its list against the plain
    triangles of the wide boxes (``cap``: a workspace that lists at most
    this many, which must then be full with some of them); the u8 blend
    against the plain LUT.
    Returns the frame's figures: kept bodies, candidate pixels, listed
    bodies, hits by kernel."""
    from wgpu_n_body_tpu_torch.ops import raster, raster_cuda
    from wgpu_n_body_tpu_torch.runners.renderer import render_counts

    m = cam.view_proj()
    k, listed, length = raster_cuda.launch_raster(pos, m, width, height, footprint)
    n_listed = int(length)
    listed = listed[:n_listed].clone()  # the workspace's: the next frame overwrites it
    again = raster_cuda.raster_counts_cuda(pos, m, width, height, footprint)
    torch.cuda.synchronize()
    plain = raster.raster_counts(pos, m, width, height, footprint)
    if not torch.equal(k, plain):
        fail(f"15a {name}: B6's counts differ from the plain version's on "
             f"{int((k != plain).sum())} pixels")
    if not torch.equal(k, again):
        fail(f"15a {name}: two B6 launches differ")
    if host and not np.array_equal(k.cpu().numpy(), render_counts(
            pos.cpu().numpy(), cam, width, height, footprint)):
        fail(f"15a {name}: B6's counts differ from the host render's")
    u8 = raster_cuda.blend_u8_cuda(k)
    if not torch.equal(u8, raster.blend_u8(k)):
        fail(f"15a {name}: blend_u8_kernel differs from the plain LUT")
    clip, w = raster.project(pos, m)
    keep, cx, cy, sx, sy = raster.triangles(clip, w, width, height, footprint)
    idx = keep.nonzero().flatten()
    if footprint == "splat":
        tested, big = int(k.sum()), torch.zeros_like(k)
    else:
        x0, x1, y0, y1 = raster.boxes(cx[idx], cy[idx], sx[idx], sy[idx], width, height)
        wide = (x1 >= x0) & (y1 >= y0) & (
            (x1 - x0 >= RASTER_SMALL_BOX) | (y1 - y0 >= RASTER_SMALL_BOX))
        want = torch.stack([cx[idx], cy[idx], sx[idx], sy[idx]], 1)[wide]
        if cap is None:
            held = n_listed == int(wide.sum()) and np.array_equal(sorted_rows(listed),
                                                                  sorted_rows(want))
        else:
            left = Counter(map(tuple, sorted_rows(want).tolist()))
            left.subtract(map(tuple, sorted_rows(listed).tolist()))
            held = n_listed == min(cap, int(wide.sum())) and min(left.values()) >= 0
        if not held:
            fail(f"15a {name}: the tile kernel's list ({n_listed} triangles) is not the "
                 f"triangles of the bodies whose box exceeds {RASTER_SMALL_BOX} px "
                 f"({int(wide.sum())}{'' if cap is None else f', at most {cap} of them'})")
        tested = int(((x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0)).sum())
        big = raster.raster_counts(pos[idx[wide]], m, width, height)
    return {"scene": name, "n": int(pos.shape[0]), "width": width, "height": height,
            "footprint": footprint, "kept": int(keep.sum()), "candidate_pixels": tested,
            "listed": n_listed, "hits": int(k.sum()),
            "raster_kernel_hits": int(k.sum()) - int(big.sum()),
            "tile_kernel_hits": int(big.sum())}


def sorted_rows(t):
    """The rows of a float32 (m, 4) tensor as their bits, in lexicographic
    order: equal multisets of rows give equal arrays."""
    a = t.cpu().numpy().view(np.uint32)
    return a[np.lexsort(a.T[::-1])]


def raster_bound(rec):
    """The least time for a frame and its blend: the bytes (12 per body, 9
    per pixel, 4 per listed body) at the HBM rate, or the float32 operations
    (20 per body, 6 per candidate pixel; the float64 projection counted at
    the float32 rate) at the float32 peak, whichever is larger."""
    from wgpu_n_body_tpu_torch.ops.raster_cuda import frame_bytes

    nbytes = frame_bytes(rec["n"], rec["width"], rec["height"], rec["listed"])
    ops = 20 * rec["n"] + 6 * rec["candidate_pixels"]
    t_bytes, t_ops = nbytes / HBM_PEAK * 1e3, ops / FP32_PEAK * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations", "bound_bytes": nbytes, "bound_ops": ops, "bound_ops_ms": t_ops}


def timed_frame(rec, pos, cam, reps=20):
    """15b: raster, blend and both by device time (profiler) and by CUDA
    events over calls queued back to back (which the host's enqueue bounds
    when a frame is short), the plain version beside them, and the bound."""
    from wgpu_n_body_tpu_torch.ops import raster, raster_cuda

    m, w, h, fp = cam.view_proj(), rec["width"], rec["height"], rec["footprint"]
    ms_r, k = time_ms(lambda: raster_cuda.raster_counts_cuda(pos, m, w, h, fp), reps)
    ms_b, _ = time_ms(lambda: raster_cuda.blend_u8_cuda(k), reps)
    ev_ms, _ = time_ms(lambda: raster_cuda.blend_u8_cuda(raster_cuda.raster_counts_cuda(
        pos, m, w, h, fp)), reps)
    dev_r, parts, ops = device_ms(lambda: raster_cuda.raster_counts_cuda(pos, m, w, h, fp), reps)
    dev_b, _, ops_b = device_ms(lambda: raster_cuda.blend_u8_cuda(k), reps)
    ms_p, _ = time_ms(lambda: raster.blend_u8(raster.raster_counts(pos, m, w, h, fp)), 3)
    rec.update(ms=dev_r + dev_b, raster_ms=dev_r, blend_ms=dev_b, raster_parts_ms=parts,
               device_ops_per_frame=ops + ops_b, event_ms=ev_ms, event_raster_ms=ms_r,
               event_blend_ms=ms_b, plain_ms=ms_p, **raster_bound(rec))
    ms = rec["ms"]
    rec["share_of_bound"] = rec["bound_ms"] / ms
    print(f"15b {rec['scene']}: N={rec['n']} {w}x{h} {fp}: device time raster {dev_r:.4f} ms "
          f"({', '.join(f'{n} {t:.4f}' for n, t in parts.items())}) + blend {dev_b:.4f} ms = "
          f"{ms:.4f} ms; CUDA events back to back: raster {ms_r:.4f} + blend {ms_b:.4f}, "
          f"together {ev_ms:.4f} ms; plain {ms_p:.3f} ms; bound {rec['bound_ms']:.4f} "
          f"ms ({rec['bound_by']}: {rec['bound_bytes']} bytes, {rec['bound_ops']} ops) -> "
          f"{rec['share_of_bound']:.2%} of the device time; kept {rec['kept']}, candidate pixels "
          f"{rec['candidate_pixels']}, listed {rec['listed']}, hits {rec['hits']} "
          f"({rec['raster_kernel_hits']} by raster_kernel, {rec['tile_kernel_hits']} by the "
          f"tile kernel); device ops per frame: {ops} for the raster call + {ops_b} blend")
    return rec


def phase_render_kernels(dev, smi):
    """15a-b: B6 held and timed on every scene."""
    from wgpu_n_body_tpu_torch.inits import uniform_init
    from wgpu_n_body_tpu_torch.ops import raster_cuda
    from wgpu_n_body_tpu_torch.params import SimParams
    from wgpu_n_body_tpu_torch.runners.renderer import Camera

    records = []
    for name, pos_np, cam, w, h, fp in render_scenes():
        pos = torch.from_numpy(pos_np).to(dev)
        rec = held_frame(name, pos, cam, w, h, fp)
        records.append(timed_frame(rec, pos, cam))
    # the visualize scene after 10 steps, at the default camera and flown in
    pos = visualize_pos(dev)
    cam = Camera(aspect=1.0)
    vis = timed_frame(held_frame(f"visualize N={N_VIS} disc, {VIS_STEPS} steps", pos, cam, 400,
                                 400, "triangle"), pos, cam)
    cam, moves = flythrough_camera(pos)
    fly = timed_frame(held_frame(f"visualize flythrough ({moves} moves forward, eye "
                                 f"{[round(float(v), 3) for v in cam.eye]})", pos, cam, 400,
                                 400, "triangle"), pos, cam)
    # a full list: the flythrough through a fresh workspace that lists 64
    # triangles, so that raster_kernel draws the other wide footprints itself
    list_cap, raster_cuda.LIST_CAP = raster_cuda.LIST_CAP, 64
    raster_cuda._workspaces.clear()
    try:
        full = held_frame("visualize flythrough, list full at 64", pos, cam, 400, 400,
                          "triangle", cap=64)
    finally:
        raster_cuda.LIST_CAP = list_cap
        raster_cuda._workspaces.clear()
    print(f"15a a full list ({full['listed']} of {fly['listed']} wide footprints listed, the "
          f"rest drawn per thread): the flythrough bit-equal to the plain version, a second "
          f"launch and the host render")
    # the N=4M uniform headless scene: the initial draw (unsorted), and the
    # state after one cli headless step (Morton-sorted, as TreeSim hands the
    # renderer every state after the first)
    big = uniform_init(torch.Generator().manual_seed(0), SimParams(particle_num=N_TREE), dev).pos
    heads = []
    for label in ("uniform", "uniform after one step (Morton-sorted)"):
        if heads:
            del big
            big = headless_after_one_step(dev)
        t0 = time.perf_counter()
        head = held_frame(f"headless N={N_TREE} {label}", big, Camera(aspect=1.0), 400,
                          400, "triangle")
        print(f"15a the N={N_TREE} {label} frame held against the host render in "
              f"{time.perf_counter() - t0:.1f} s")
        heads.append(timed_frame(head, big, Camera(aspect=1.0)))
    del big
    torch.cuda.empty_cache()
    print(f"15a B6 bit-equal to its plain version, to a second launch and to the host render "
          f"on {len(records) + 4} scenes; lists equal the plain triangles of the wide "
          f"footprints; blend equal to the LUT; [{smi}]")
    return vis, [*records, fly, *heads]


def phase_visualize_cli(dev, smi, mesh=None, label="15c"):
    """15c: ``cli visualize --gif`` at its defaults, in-process; with
    ``mesh``, the body of ``cli visualize --devices K`` on this rank of it
    (``cli.run_rank``: the sharded TreeSim, each frame the gathered
    positions)."""
    from wgpu_n_body_tpu_torch import cli
    from wgpu_n_body_tpu_torch.runners import renderer

    seen = []
    render = cli.render_frame_on_device

    def recorded(pos, *args, **kw):  # keeps the last frame's positions
        seen[:] = [pos.clone()]
        return render(pos, *args, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        out, gif = os.path.join(tmp, "frames"), os.path.join(tmp, "disc.gif")
        cli.render_frame_on_device = recorded
        try:
            zero_launch_counts()
            t0 = time.perf_counter()
            argv = ["visualize", "--out", out, "--gif", gif]
            if mesh is None:
                with kept_steps() as made:
                    text = run_cli(cli, argv)
            else:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    cli.run_rank(cli.parse_args(argv), mesh)
                text = buf.getvalue()
                print("\n".join("  | " + line for line in text.splitlines()))
            wall = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            cli.render_frame_on_device = render
        frames = sorted(os.listdir(out))
        if len(frames) != 60 or not os.path.getsize(gif):
            fail(f"{label} cli visualize wrote {len(frames)} frames and a GIF of "
                 f"{os.path.getsize(gif) if os.path.exists(gif) else 0} bytes")
        # --frames 60 x --steps-per-frame 1, the group walk's step: its bodies
        # through the launchers (one device: the graphed step's two plain calls
        # and two captures)
        steps = 60 if mesh is not None else graphed_bodies(made, 60)
        if counts != expected_counts(B3=steps, B4=steps, B4_eval=steps, B4_tables=steps,
                                     B4_tiles=steps, B5=steps, K1=steps, K2=steps, B6=60):
            fail(f"{label} cli visualize launched {counts}")
        last = os.path.join(tmp, "host.png")
        renderer.write_png(last, renderer.render_frame(seen[0].cpu().numpy()))
        with open(last, "rb") as a, open(os.path.join(out, frames[-1]), "rb") as b:
            if a.read() != b.read():
                fail(f"{label} the last frame differs from the host render of the same positions")
        gif_bytes = os.path.getsize(gif)
    us = float(re.search(r"mean: (\S+) us/step", text).group(1))
    where = "" if mesh is None else f" through a {mesh.size}-rank group (ShardedTreeSim)"
    print(f"{label} cli visualize{where} (TreeSim N={N_VIS} disc, 60 frames, --gif): "
          f"{counts['B6']} raster "
          f"launches, {counts['B4']} steps; the last frame equals the host render of its "
          f"positions; GIF {gif_bytes} bytes; {us:.1f} us/step (TreeSim N={N_VIS} disc, mean of "
          f"steps 2-60), whole command {wall:.1f} s; [{smi}]")
    return counts["B6"], us, wall


def phase_render_cli(dev, smi):
    """15d: ``cli render`` of a trajectory that ``cli headless`` wrote."""
    from wgpu_n_body_tpu_torch import cli
    from wgpu_n_body_tpu_torch.runners import renderer
    from wgpu_n_body_tpu_torch.runners.trajectory import TrajectoryReader

    with tempfile.TemporaryDirectory() as tmp:
        traj, out = os.path.join(tmp, "traj"), os.path.join(tmp, "frames")
        run_cli(cli, ["headless", "--n", str(N_VIS), "--init", "disc", "--g", str(VIS_G),
                      "--dt", str(VIS_DT), "--steps", "4", "--trajectory", traj])
        zero_launch_counts()
        run_cli(cli, ["render", "--trajectory", traj, "--out", out, "--gif",
                      os.path.join(tmp, "t.gif")])
        counts = launch_counts()
        reader = TrajectoryReader(traj)
        if counts != expected_counts(B6=len(reader)) or len(reader) != 5:
            fail(f"15d cli render of {len(reader)} frames launched {counts}")
        for step, pos in reader:
            want = os.path.join(tmp, "host.png")
            renderer.write_png(want, renderer.render_frame(pos))
            with open(want, "rb") as a, open(os.path.join(out, f"frame_{step:08d}.png"), "rb") as b:
                if a.read() != b.read():
                    fail(f"15d cli render's frame {step} differs from the host render")
    print(f"15d cli render of the 5 frames cli headless --trajectory wrote (TreeSim N={N_VIS} "
          f"disc): {counts['B6']} raster launches, every PNG equal to the host render's; [{smi}]")


def phase_serve(dev, smi, mesh=None, label="15e"):
    """15e: serve, through make_server(port=0) and http.client; with
    ``mesh``, the viewer of the sharded TreeSim on this rank of it (the
    ticks' commands broadcast, each frame the gathered positions)."""
    import http.client
    import threading

    from wgpu_n_body_tpu_torch.inits import disc_init
    from wgpu_n_body_tpu_torch.models import TreeSim
    from wgpu_n_body_tpu_torch.params import SimParams, TreeParams
    from wgpu_n_body_tpu_torch.parallel import ShardedTreeSim
    from wgpu_n_body_tpu_torch.runners.online import KEYMAP, OnlineViewer, make_server
    from wgpu_n_body_tpu_torch.runners.renderer import png_bytes, render_frame

    params = SimParams(particle_num=N_VIS, g=VIS_G, dt=VIS_DT)
    sim = (TreeSim(params, TreeParams(theta=0.75)) if mesh is None
           else ShardedTreeSim(params, mesh, TreeParams(theta=0.75)))
    viewer = OnlineViewer(sim, disc_init, device=dev)
    viewer.warmup()
    server, done = make_server(viewer, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)

        def get(path):
            conn.request("GET", path)
            return conn.getresponse().read()

        page = get("/")
        if b"frame.png" not in page:
            fail(f"{label} the page does not load frames")
        # into the disc (1,551 then 6,067 footprints past the 8 x 8 box at
        # the initial state), back out, orbit, up and down
        script = ["w"] * 10 + ["s"] * 10 + ["a"] * 5 + ["d"] * 5 + ["q"] * 3 + ["e"] * 3 + [""] * 4
        zero_launch_counts()
        steps0 = viewer.runner.step_num
        frame_ms = []
        for i, keys in enumerate(script):
            pos = viewer.runner.whole_state().pos.cpu().numpy()
            cam = viewer.camera
            for k in keys.split(",") if keys else []:
                cam = cam.moved(KEYMAP[k], viewer.speed)
            png = get(f"/frame.png?keys={keys}&focus=1")
            img = render_frame(pos, cam, viewer.width, viewer.height)
            want = png_bytes((np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8), level=1)
            if png != want:
                fail(f"{label} frame {i} (keys {keys!r}) differs from the host render of its "
                     "pre-step state")
            frame_ms.append(json.loads(get("/stats"))["last_frame_ms"])
        checked = len(script)
        # the same flight again, timed: nothing but the requests
        t0 = time.perf_counter()
        for keys in script:
            get(f"/frame.png?keys={keys}&focus=1")
            frame_ms.append(json.loads(get("/stats"))["last_frame_ms"])
        fps_client = len(script) / (time.perf_counter() - t0)
        stats = json.loads(get("/stats"))
        steps = viewer.runner.step_num
        get("/frame.png?focus=0")
        if json.loads(get("/stats"))["steps"] != steps:
            fail(f"{label} focus=0 stepped")
        frames = 2 * len(script) + 1
        counts = launch_counts()
        walked = steps - steps0
        if mesh is None:  # the graphed step's bodies through the launchers since the warm-up's
            step = viewer.runner._step
            walked = step.calls - step.replays + step.captures - steps0
        if counts != expected_counts(B3=walked, B4=walked, B4_eval=walked, B4_tables=walked,
                                     B4_tiles=walked, B5=walked, K1=walked, K2=walked, B6=frames,
                                     B6_blend=frames):
            fail(f"{label} {frames} frames and {steps - steps0} steps ({walked} bodies through "
                 f"the launchers) launched {counts}")
        if get("/quit") != b"bye" or not done.wait(timeout=10):
            fail(f"{label} /quit did not set the done event")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        viewer.close()
    p50 = float(np.percentile(frame_ms[checked:], 50))
    where = "" if mesh is None else f" through a {mesh.size}-rank group (ShardedTreeSim)"
    print(f"{label} serve{where} (TreeSim N={N_VIS} disc, 400x400): {checked} flythrough "
          f"frames equal to "
          f"the host render of their pre-step state; focus=0 did not step; /quit set done; "
          f"timed flight of {len(script)} frames: frame time p50 {p50:.3f} ms (tick), fps "
          f"{stats['fps']} (server's window), {fps_client:.2f} (client, with /stats); raster "
          f"{counts['B6']} and blend {counts['B6 blend']} launches in {frames} frames; "
          f"[{smi}]")
    return counts["B6 blend"], {"frame_ms_p50": p50, "fps": stats["fps"],
                                "fps_client": fps_client, "frames": frames}


def phase_render(dev, smi, mhz):
    """15. The rendering path: B6 held and timed (15a-b), then driven by
    ``cli visualize`` (15c, its main path), ``cli render`` (15d) and
    ``serve`` (15e)."""
    vis, scenes = phase_render_kernels(dev, smi)
    launches, us, wall = phase_visualize_cli(dev, smi)
    phase_render_cli(dev, smi)
    launches_blend, serve = phase_serve(dev, smi)
    return {
        "name": "raster",
        "route": "cuda",
        "source": "wgpu_n_body_tpu_torch/csrc/raster.cu",
        "replaces": "wgpu_n_body_tpu/runners/renderer.py:435",
        "launches": launches,
        "launches_blend": launches_blend,
        "max_abs_err": 0,  # integer counts, held equal on every scene
        "ms": vis["ms"],
        "plain_ms": vis["plain_ms"],
        "bound_ms": vis["bound_ms"],
        "bound_by": vis["bound_by"],
        "library_ms": None,
        "library": NO_RASTER_LIBRARY,
        "raster_ms": vis["raster_ms"],
        "blend_ms": vis["blend_ms"],
        "design": "redesign of the kernels of commit f59feb3",
        "device_ops_per_frame": vis["device_ops_per_frame"],
        "scene": vis["scene"],
        "scenes": scenes,
        "visualize_us_per_step": us,
        "visualize_wall_s": wall,
        "serve": serve,
        "sm_mhz": mhz,
    }


# ------------------------------------------------------------ multi-GPU (A13)

#: the ranks of the emulated LET step (N = 4 x N_LOCAL)
P_EMULATED = 4
#: receivers held against float64 in the emulated LET step
LET_SAMPLE = 4096
NO_EXPORT_LIBRARY = "none: no single PyTorch call prunes a tree against boxes"


def held_export(what, local, blo, bhi, me, theta, cap):
    """B7 on the card against its plain version on the same inputs, every
    output bit for bit (floats too: both copy the same rows). Returns (the
    kernel's export, the plain rows' visited mask, max |kernel - plain|)."""
    from wgpu_n_body_tpu_torch.ops import let_export, let_export_cuda

    k = let_export_cuda.export_walk_cuda(local.tree, local.pos_s, local.mass_s, blo, bhi, me,
                                         theta, cap)
    torch.cuda.synchronize()
    p = let_export.export_walk(local.tree, local.pos_s, local.mass_s, blo, bhi, me, theta, cap)
    _, visited, _ = let_export.export_rows(local.tree, blo, bhi, me, theta)
    bad = [f for f in k._fields
           if getattr(k, f).dtype != getattr(p, f).dtype or not bits_equal(getattr(k, f),
                                                                          getattr(p, f))]
    if bad:
        for f in bad:
            a, b = getattr(k, f), getattr(p, f)
            where = (a != b).nonzero()[:5].tolist() if a.shape == b.shape else (a.shape, b.shape)
            print(f"  {what}: {f} differs at {where}")
        fail(f"16 B7 {what}: the kernel's {bad} differ from the plain version's")
    err = max(float((getattr(k, f) - getattr(p, f)).abs().max()) for f in ("nodes", "parts"))
    return k, visited, err


def phase_let_kernel(dev, smi):
    """16. B7 (``csrc/let_export.cu``) against its plain version, timed, on
    the octant geometry."""
    from wgpu_n_body_tpu_torch.ops import let_export, let_export_cuda
    from wgpu_n_body_tpu_torch.params import TreeParams
    from wgpu_n_body_tpu_torch.parallel.let_tree import auto_let_cap

    tp = TreeParams()
    cap = auto_let_cap(N_LOCAL, tp.theta)
    local = octant_local(N_LOCAL, dev, tp)
    m = int(local.tree.num_nodes)
    rec = {}
    exp8 = None
    for p in (8, 4):
        blo, bhi = octant_boxes(p, dev)
        exp, visited, err = held_export(f"octants P={p}", local, blo, bhi, 0, tp.theta, cap)
        if bool(exp.overflow.any()) or int(exp.n_rows[0]) != 0:
            fail(f"16 P={p}: n_rows {exp.n_rows.tolist()} overflow {exp.overflow.tolist()}")
        ms, _ = time_ms(lambda: let_export_cuda.export_walk_cuda(
            local.tree, local.pos_s, local.mass_s, blo, bhi, 0, tp.theta, cap), 10)
        plain_ms, _ = time_ms(lambda: let_export.export_walk(
            local.tree, local.pos_s, local.mass_s, blo, bhi, 0, tp.theta, cap), 2)
        nbytes = let_export.export_bytes(exp, visited)
        bound_ms = nbytes / HBM_PEAK * 1e3
        # ms by CUDA events, as every earlier record of B7; beside it the
        # device time of its launches (events also time the enqueue)
        split = launch_split(lambda: let_export_cuda.export_walk_cuda(
            local.tree, local.pos_s, local.mass_s, blo, bhi, 0, tp.theta, cap), 10)
        split = {k: ms for k, (ms, _) in split.items()}
        dev_ms = sum(split.values())
        rec[p] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_bytes": nbytes, "share_of_bound": bound_ms / ms,
                  "device_share": bound_ms / dev_ms, "max_abs_err": err,
                  "n_rows": exp.n_rows.tolist(), "visited_rows": int(visited.any(0).sum()),
                  "device_ms_by_launch": split}
        print(f"16a B7 octants n_local={N_LOCAL} ({m} arena rows) theta={tp.theta} P={p} "
              f"let_cap={cap}: bit-equal to the plain version; rows per destination "
              f"{exp.n_rows.tolist()}; kernel {ms:.4f} ms by CUDA events "
              f"({dev_ms:.4f} ms of device time), plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s): {bound_ms / ms:.2%} by events, "
              f"{bound_ms / dev_ms:.2%} of the device time; device ms per launch "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + f"; [{smi}]")
        if p == 8:
            exp8 = exp
        del exp, visited
    # P > 8 takes one scan-and-emit launch per 8 destinations: P=12 repeats
    # octants 0-3 as destinations 8-11, self at 8 (the second launch), so
    # destination 0 (the own octant as a foreign box) takes the whole tree
    # and overflows, and destinations 9-11 must carry 1-3's bits
    blo, bhi = octant_boxes(12, dev)
    exp12, _, _ = held_export("octants P=12, self 8", local, blo, bhi, 8, tp.theta, cap)
    same = all(bits_equal(getattr(exp12, f)[1:4], getattr(exp12, f)[9:12])
               for f in exp12._fields)
    rows12 = exp12.n_rows.tolist()
    if not same or int(exp12.n_rows[8]) != 0 or not bool(exp12.overflow[0]):
        fail(f"16 P=12: destinations 9-11 equal 1-3 {same}, n_rows {rows12}, overflow "
             f"{exp12.overflow.tolist()}")
    print(f"16a B7 octants P=12 (two launches of 8 and 4 destinations), self 8: bit-equal to "
          f"the plain version; rows per destination {rows12}; destinations 9-11 bit-equal to "
          f"1-3; overflow {exp12.overflow.tolist()}")
    del exp12
    # theta = 0 opens every row (each destination takes the whole tree), and
    # a let_cap below the face neighbours' rows must overflow, keeping the
    # DFS prefix
    small = octant_local(262144, dev, tp, seed=1)
    blo, bhi = octant_boxes(8, dev)
    exp0, _, _ = held_export("theta=0", small, blo, bhi, 0, 0.0, 327680)
    m0 = int(small.tree.num_nodes)
    singles = int(((small.tree.nodes_f32[:m0, 6] > 0) & (small.tree.count[:m0] == 1)).sum())
    want0 = m0 + small.pos_s.shape[0] - singles  # every row, and each header's members
    exp_o, _, _ = held_export("overflow", local, blo, bhi, 0, tp.theta, 4096)
    if exp0.overflow.any() or exp0.n_rows[1:].ne(exp0.n_rows[1]).any():
        fail(f"16 theta=0: n_rows {exp0.n_rows.tolist()}")
    if not bool(exp_o.overflow[1]) or int(exp_o.n_rows[1]) != 4096:
        fail(f"16 planted overflow not flagged: {exp_o.n_rows.tolist()}")
    print(f"16b theta=0 (N=262144, let_cap 327680): bit-equal, {int(exp0.n_rows[1])} rows to "
          f"each other octant (arena rows + bodies - one-body cells = {want0}); let_cap 4096 at "
          f"n_local={N_LOCAL}: bit-equal, overflow {exp_o.overflow.tolist()}")
    if int(exp0.n_rows[1]) != want0:
        fail(f"16 theta=0 exports {int(exp0.n_rows[1])} rows, not {want0}")
    del small, exp0, exp_o
    b8 = phase_import_forest(dev, smi, local, exp8, cap)
    del local, exp8
    torch.cuda.empty_cache()
    return b8, {
        "name": "let_export",
        "route": "cuda",
        "source": "wgpu_n_body_tpu_torch/csrc/let_export.cu",
        "replaces": "wgpu_n_body_tpu/parallel/let_tree.py:148",
        "launches": 0,  # set from the main path's run (phase 18)
        "max_abs_err": max(r["max_abs_err"] for r in rec.values()),
        "ms": rec[8]["ms"],
        "device_ms": rec[8]["device_ms"],
        "device_share": rec[8]["device_share"],
        "plain_ms": rec[8]["plain_ms"],
        "bound_ms": rec[8]["bound_ms"],
        "bound_by": "bytes",
        "bound_unit": "HBM",
        "library_ms": None,
        "library": NO_EXPORT_LIBRARY,
        "geometry": f"octants, n_local={N_LOCAL}, theta={tp.theta}, let_cap={cap}, P=8",
        "p8": rec[8],
        "p4": rec[4],
    }


def held_forest(what, tree, pos_s, mass_s, imp, cap_forest):
    """B8 on the card against its plain version on the same inputs, every
    output bit for bit (both copy the same rows and rewrite the same
    integers). Returns the kernel's ``FusedForest``."""
    from wgpu_n_body_tpu_torch.ops import import_forest_cuda
    from wgpu_n_body_tpu_torch.parallel import let_tree

    k = import_forest_cuda.assemble_fused_forest_cuda(tree, pos_s, mass_s, imp, cap_forest)
    torch.cuda.synchronize()
    p = let_tree.assemble_fused_forest(tree, pos_s, mass_s, imp, cap_forest)
    pairs = [(f"forest.{f}", getattr(k.forest, f), getattr(p.forest, f))
             for f in k.forest._fields[:7]]
    pairs += [(f, getattr(k, f), getattr(p, f)) for f in k._fields[1:]]
    bad = [name for name, a, b in pairs if not bits_equal(a, b)]
    for name, a, b in pairs:
        if name in bad:
            where = (a != b).nonzero()[:5].tolist() if a.shape == b.shape else (a.shape, b.shape)
            print(f"  16c {what}: {name} differs at {where}")
    if bad:
        fail(f"16c B8 {what}: the kernel's {bad} differ from the plain version's")
    return k


def phase_import_forest(dev, smi, local, imp, let_cap):
    """16c. B8 (``csrc/import_forest.cu``) against its plain version: phase
    16's P=8 exports taken as the imports of one rank whose local tree is the
    n_local=4M octant arena, every output bit for bit, at the fused walk's
    cap and at half the kept rows (a planted overflow); timed by CUDA events
    and by device time beside its bytes bound."""
    from wgpu_n_body_tpu_torch.ops import import_forest_cuda
    from wgpu_n_body_tpu_torch.params import TreeParams
    from wgpu_n_body_tpu_torch.parallel import let_tree

    tp = TreeParams()
    p = imp.skip.shape[0]
    cap_forest = tp.let_forest_cap(p, let_cap)
    args = (local.tree, local.pos_s, local.mass_s, imp)
    k = held_forest("fits", *args, cap_forest)
    total = int(torch.clamp(imp.n_rows, max=let_cap).sum())
    kept = int(k.extents.sum())
    if bool(k.overflow) or kept != total:
        fail(f"16c B8 kept {kept} of {total} import rows (overflow {bool(k.overflow)})")
    over = held_forest("planted overflow", *args, total // 2)
    if not bool(over.overflow) or int(over.extents.sum()) != total // 2:
        fail(f"16c B8 at cap {total // 2}: overflow {bool(over.overflow)}, kept "
             f"{int(over.extents.sum())}")
    del over

    def call():
        return import_forest_cuda.assemble_fused_forest_cuda(*args, cap_forest)

    # the earlier phases' cached blocks fragment the allocator: outputs of
    # ~0.2 GB then cost a cudaMalloc (and its synchronisation) per call
    torch.cuda.empty_cache()
    ms, _ = time_ms(call, 20)
    dev_ms, parts, ops = device_ms(call, 20)
    plain_ms, _ = time_ms(lambda: let_tree.assemble_fused_forest(*args, cap_forest), 3)
    base, n = local.tree.nodes_f32.shape[0], local.pos_s.shape[0]
    live = int(local.tree.num_nodes)
    nbytes = import_forest_cuda.fused_forest_bytes(n, live, kept)
    bound_ms = nbytes / HBM_PEAK * 1e3
    print(f"16c B8 n_local={n} ({base} arena rows, {live} live) with the P={p} exports as imports "
          f"({kept} kept rows, cap_forest {cap_forest}): bit-equal to the plain version, and at "
          f"cap {total // 2} (overflow flagged, {total // 2} rows kept); kernel {ms:.4f} ms by CUDA "
          f"events, {dev_ms:.4f} ms of device time in {ops} ops ({parts}); plain {plain_ms:.3f} "
          f"ms; bound {bound_ms:.4f} ms ({nbytes} bytes at 3.35 TB/s): {bound_ms / ms:.2%} by "
          f"events, {bound_ms / dev_ms:.2%} of the device time; [{smi}]")
    return {
        "name": "import_forest",
        "route": "cuda",
        "source": "wgpu_n_body_tpu_torch/csrc/import_forest.cu",
        "replaces": "wgpu_n_body_tpu/ops/import_octets.py:86",
        "launches": 0,  # set from the main path's run (phase 18, the fused let run)
        "max_abs_err": 0.0,  # every output bit-equal (held_forest)
        "ms": ms,
        "device_ms": dev_ms,
        "device_share": bound_ms / dev_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "bound_unit": "HBM",
        "bound_bytes": nbytes,
        "library_ms": None,
        "library": "none: no single PyTorch call packs import buffers behind an arena",
        "geometry": f"octant arena n_local={n} ({base} rows, {live} live), P={p} imports of let_cap "
                    f"{let_cap}, {kept} kept rows, cap_forest {cap_forest}",
    }


def stage_ms(fn):
    """(fn's result, its ms by CUDA events, one call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_let_emulated(dev, smi):
    """17. The LET step of P=4 ranks of N_LOCAL bodies each, emulated on one
    card: the port's per-rank stages in turn, the boxes' gather and the
    exchange by hand; forces against float64 beside the single-device step."""
    import dataclasses

    from wgpu_n_body_tpu_torch.models import TreeSim
    from wgpu_n_body_tpu_torch.ops import import_forest_cuda, let_export_cuda, tree_walk_group_cuda
    from wgpu_n_body_tpu_torch.ops.morton_cuda import morton_order_cuda
    from wgpu_n_body_tpu_torch.ops.naive_ref import mean_rel_err, naive_forces_ref
    from wgpu_n_body_tpu_torch.ops.tree_walk_group import source_table, step_budget
    from wgpu_n_body_tpu_torch.utils.group_walk_study import list_counts
    from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams
    from wgpu_n_body_tpu_torch.parallel import sharded_tree as st
    from wgpu_n_body_tpu_torch.parallel.let_tree import assemble_import_forest, auto_let_cap
    from wgpu_n_body_tpu_torch.utils.multi_gpu_check import rows_of

    p, n_l = P_EMULATED, N_LOCAL
    n = p * n_l
    params, tp = SimParams(particle_num=n), TreeParams()
    # auto_let_cap sizes the face of a cube-shaped domain (98,304 rows at 4M);
    # these domains are 2:1:1 slabs, so the step takes twice it and reports
    # whether the auto size would have held every export
    auto = auto_let_cap(n_l, tp.theta)
    cap = 2 * auto
    # the uniform scene of N bodies in [-1, 1]^3, rank r owning the slab of
    # the top Morton quadrant r (y half r & 1, z half r >> 1), n_l bodies
    # each: the domains of the global Morton order's four slices, cut clean
    gen = torch.Generator(device=dev).manual_seed(0)
    ranks = []
    for r in range(p):
        pos = torch.rand((n_l, 3), generator=gen, device=dev)
        pos = pos - torch.tensor([0.5, 1.0 - (r & 1), 1.0 - (r >> 1)], device=dev)
        pos[:, 0] *= 2.0
        vel = (torch.rand((n_l, 3), generator=gen, device=dev) * 2.0 - 1.0) * 0.001
        ranks.append(ParticleState(pos, vel, torch.zeros_like(pos), torch.ones(n_l, device=dev)))
    state = ranks[0]  # for its field names
    bound = torch.stack([st.let_bound(s.pos) for s in ranks]).amax(0)  # the all_reduce
    tp_imp = dataclasses.replace(tp, walk_list_cap=tp.effective_import_list_cap())
    fused_tp = dataclasses.replace(tp, let_fused=True)
    cap_forest = tp.let_forest_cap(p, cap)

    def import_walk(loc, imp, tiles):
        return tree_walk_group_cuda.group_tree_forces_cuda(
            loc.pos_new, imp.parts[:, :, :3].reshape(-1, 3).contiguous(),
            imp.parts[:, :, 3].reshape(-1).contiguous(), assemble_import_forest(imp),
            loc.keys, params, tp_imp, gid_offset=p * cap,
            tiles=tiles._replace(r_cap=step_budget(tp_imp.walk_list_cap)))

    for _ in range(2):  # the ranks' stages twice: the second pass is timed
        t = {k: [] for k in ("build", "export", "tiles", "local_walk", "import_walk")}
        locals_ = []
        for s in ranks:
            loc, ms = stage_ms(lambda: st.let_sort_build(s, bound, params, tp))
            locals_.append(loc)
            t["build"].append(ms)
        boxes = [st.receiver_box(loc.pos_new) for loc in locals_]
        blo, bhi = torch.cat([b[0] for b in boxes]), torch.cat([b[1] for b in boxes])
        zero_launch_counts()
        exps = []
        for r, loc in enumerate(locals_):
            exp, ms = stage_ms(lambda: st.let_export(loc, blo, bhi, r, tp, cap))
            exps.append(exp)
            t["export"].append(ms)
        counts = launch_counts()
        imps = st.exchange_by_hand(exps)
        for r, loc in enumerate(locals_):
            # each stage of let_forces alone, timed: the tiles both walks share,
            # the local walk, the import walk
            tiles, ms = stage_ms(lambda: tree_walk_group_cuda.tile_setup_cuda(
                loc.tree.split, n_l, tp))
            t["tiles"].append(ms)
            _, ms = stage_ms(lambda: tree_walk_group_cuda.group_tree_forces_cuda(
                loc.pos_new, loc.pos_s, loc.mass_s, loc.tree, loc.keys, params, tp, tiles=tiles))
            t["local_walk"].append(ms)
            imp = imps[r]
            _, ms = stage_ms(lambda: import_walk(loc, imp, tiles))
            t["import_walk"].append(ms)
        # the product's let_forces for the forces: one tile set-up per rank,
        # two group walks
        zero_launch_counts()
        accs, deferred = [], 0
        for r, loc in enumerate(locals_):
            acc, d = st.let_forces(loc, imps[r], params, tp, p, cap)
            accs.append(acc)
            deferred += int(d)
        forces_counts = launch_counts()
        # 17c. the fused walk on the same exports: one B8, one tile set-up,
        # one group walk and B3 once per rank; then its stages timed in turns
        # with the split walk's (split, fused, fused, split) on each rank
        zero_launch_counts()
        accs_f, deferred_f = [], 0
        for r, loc in enumerate(locals_):
            acc, d = st.let_forces(loc, imps[r], params, fused_tp, p, cap)
            accs_f.append(acc)
            deferred_f += int(d)
        fused_counts = launch_counts()
        turns = {k: [] for k in ("split_local", "split_import", "b8", "fused_walk")}
        for r, loc in enumerate(locals_):
            imp = imps[r]
            tiles = tree_walk_group_cuda.tile_setup_cuda(loc.tree.split, n_l, tp)
            for turn in ("split", "fused", "fused", "split"):
                if turn == "split":
                    _, ms = stage_ms(lambda: tree_walk_group_cuda.group_tree_forces_cuda(
                        loc.pos_new, loc.pos_s, loc.mass_s, loc.tree, loc.keys, params, tp,
                        tiles=tiles))
                    turns["split_local"].append(ms)
                    _, ms = stage_ms(lambda: import_walk(loc, imp, tiles))
                    turns["split_import"].append(ms)
                else:
                    f, ms = stage_ms(lambda: import_forest_cuda.assemble_fused_forest_cuda(
                        loc.tree, loc.pos_s, loc.mass_s, imp, cap_forest))
                    turns["b8"].append(ms)
                    _, ms = stage_ms(lambda: tree_walk_group_cuda.group_tree_forces_cuda(
                        loc.pos_new, f.src_pos, f.src_mass, f.forest, loc.keys, params, tp,
                        tiles=tiles))
                    turns["fused_walk"].append(ms)
                    del f
    # B3 over an import forest, its receivers numbered past every source
    # (self_idx = P * let_cap + i): against the plain walk, and as the group
    # walk's fallback when every tile is deferred (no room in the list pool)
    loc, imp = locals_[1], imps[1]
    forest = assemble_import_forest(imp)
    src = types.SimpleNamespace(pos=imp.parts[:, :, :3].reshape(-1, 3).contiguous(),
                                mass=imp.parts[:, :, 3].reshape(-1).contiguous())
    b = LET_SAMPLE
    past = torch.arange(p * cap, p * cap + b, dtype=torch.int32, device=dev)
    k_b3, _, _, _, _, p99_b3, _ = held_walk("17 B3 past the sources", loc.pos_new[:b], past,
                                            src, forest, params, tp_imp)
    with pool_of(tree_walk_group_cuda, 0):
        k_def, stats = tree_walk_group_cuda.group_tree_forces_cuda(
            loc.pos_new[:b], src.pos, src.mass, forest, loc.keys[:b], params, tp_imp,
            gid_offset=p * cap,
            tiles=tree_walk_group_cuda.tile_setup_cuda(loc.tree.split[:b], b, tp_imp))
    if int(stats.deferred) != b or not torch.equal(k_def, k_b3):
        fail(f"17 the import walk's fallback ({int(stats.deferred)} of {b} deferred) differs "
             "from B3 with self_idx past the sources")
    print(f"17 B3 over rank 1's import forest, {b} receivers with self_idx past all "
          f"{p * cap} sources: counts equal the plain rules', per-row p99 {p99_b3:.3e} against "
          f"the plain walk; the group walk with every tile deferred gives B3's bits")
    rows = [e.n_rows.tolist() for e in exps]
    if any(bool(e.overflow.any()) for e in exps) or any(bool(l.tree.overflowed) for l in locals_):
        fail(f"17 emulated LET step overflowed: rows {rows}")
    if counts != expected_counts(B7=p):
        fail(f"17 {p} exports launched {counts}")
    if forces_counts != expected_counts(B4_tiles=p, B4=2 * p, B4_eval=2 * p, B4_tables=2 * p,
                                        B3=2 * p):
        fail(f"17 let_forces of {p} ranks launched {forces_counts}")
    if fused_counts != expected_counts(B4_tiles=p, B8=p, B4=p, B4_eval=p, B4_tables=p, B3=p):
        fail(f"17c the fused let_forces of {p} ranks launched {fused_counts}")
    # 17c. each receiver's accepted nodes and members: the fused walk's lists
    # against the split walk's two (massless rows aside), where no walk
    # deferred its tile
    gdt = params.g * params.dt
    compared = deferred_tiles = 0
    for r, loc in enumerate(locals_):
        imp = imps[r]
        tiles = tree_walk_group_cuda.tile_setup_cuda(loc.tree.split, n_l, tp)
        f = import_forest_cuda.assemble_fused_forest_cuda(loc.tree, loc.pos_s, loc.mass_s, imp,
                                                         cap_forest)
        if bool(f.overflow):
            fail(f"17c rank {r}'s imports overflow the fused forest's {cap_forest} rows")
        walks = [(f.forest, f.src_pos, f.src_mass, tiles, tp),
                 (loc.tree, loc.pos_s, loc.mass_s, tiles, tp),
                 (assemble_import_forest(imp), imp.parts[:, :, :3].reshape(-1, 3).contiguous(),
                  imp.parts[:, :, 3].reshape(-1).contiguous(),
                  tiles._replace(r_cap=step_budget(tp_imp.walk_list_cap)), tp_imp)]
        per_walk = []
        for forest, sp, sm, tl, tpx in walks:
            lists = tree_walk_group_cuda.group_walk_lists_cuda(loc.pos_new, forest, tl, tpx)
            nodes, members = list_counts(lists, source_table(forest, sp, sm, gdt),
                                         forest.nodes_f32.shape[0] - 1)
            per_walk.append((nodes, members, lists.bad | lists.pool_full))
            del lists
        (nf, mf, bf), (nl, ml, bl), (ni, mi, bi) = per_walk
        live = tiles.piece_len > 0
        ok = live & ~(bf | bl | bi)
        deferred_tiles += int((live & ~ok).sum())
        compared += int(ok.sum())
        if not (torch.equal(nf[ok], (nl + ni)[ok]) and torch.equal(mf[ok], (ml + mi)[ok])):
            bad = int((ok & ((nf != nl + ni) | (mf != ml + mi))).sum())
            fail(f"17c rank {r}: {bad} tiles' counts of accepted nodes or members differ between "
                 "the fused walk and the split walk")
        del f, walks, per_walk
    rel_fs = row_rel_err(torch.cat(accs_f), torch.cat(accs))
    p99_fs = float(np.percentile(rel_fs, 99))
    print(f"17c fused walk, P={p}: let_forces launched "
          f"{({k: v for k, v in fused_counts.items() if v})}; deferred {deferred_f}; counts of "
          f"accepted nodes and members equal to the split walk's on {compared} tiles "
          f"({deferred_tiles} deferred by a walk); forces against the split walk's per-row p99 "
          f"{p99_fs:.3e}, max {rel_fs.max():.3e} (gate p99 1e-4)")
    if deferred_f or deferred_tiles or not np.isfinite(rel_fs).all() or p99_fs > 1e-4:
        fail("17c the fused walk deferred receivers or disagrees with the split walk")
    # 17c. rank 0's split walks and fused walk (B8 with it) by kernel, device
    # time from the profiler: where the split walk's second walk spends
    loc, imp = locals_[0], imps[0]
    tiles = tree_walk_group_cuda.tile_setup_cuda(loc.tree.split, n_l, tp)

    def local_walk():
        tree_walk_group_cuda.group_tree_forces_cuda(loc.pos_new, loc.pos_s, loc.mass_s, loc.tree,
                                                    loc.keys, params, tp, tiles=tiles)

    def fused_walk():
        f = import_forest_cuda.assemble_fused_forest_cuda(loc.tree, loc.pos_s, loc.mass_s, imp,
                                                         cap_forest)
        tree_walk_group_cuda.group_tree_forces_cuda(loc.pos_new, f.src_pos, f.src_mass, f.forest,
                                                    loc.keys, params, tp, tiles=tiles)

    by_kernel = {}
    for name, fn in (("split local", local_walk), ("split import", lambda: import_walk(
            loc, imp, tiles)), ("fused (B8 and the walk)", fused_walk)):
        _, parts, _ = device_ms(fn, 3)
        by_kernel[name] = parts
        print(f"17c rank 0's {name}: {sum(parts.values()):.3f} ms of device time per call; "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(parts.items(),
                                                           key=lambda kv: -kv[1])))
    del tiles
    # the single-device default step on the same bodies, eager as the stages are
    sim = TreeSim(params, tp)
    step = sim.step_fn()
    whole = ParticleState(*(torch.cat([getattr(s, f) for s in ranks]) for f in state._fields))
    del state, ranks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = step(whole)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    _, single_ev = stage_ms(lambda: step(whole))
    # 4096 sampled receivers, 1024 of each rank, against float64 all-pairs
    gen_s = torch.Generator(device=dev).manual_seed(1)
    per = LET_SAMPLE // p
    picks = [torch.randint(0, n_l, (per,), generator=gen_s, device=dev) for _ in range(p)]
    recv = torch.cat([loc.pos_new[i] for loc, i in zip(locals_, picks)])
    got_let = torch.cat([a[i] for a, i in zip(accs, picks)])
    src = torch.cat([loc.pos_s for loc in locals_])
    mass = torch.cat([loc.mass_s for loc in locals_])
    own = torch.cat([r * n_l + i for r, i in enumerate(picks)])
    truth = naive_forces_ref(recv.double(), src.double(), mass.double(), params, block=8,
                             row_offset=own)
    try:
        at = rows_of(recv, single.pos)
    except ValueError:
        fail("17 the sampled receivers are not in the single-device step's drifted state")
    err_let = mean_rel_err(got_let, truth)
    err_fused = mean_rel_err(torch.cat([a[i] for a, i in zip(accs_f, picks)]), truth)
    err_rep = mean_rel_err(single.acc[at], truth)
    mean = {k: sum(v) / p for k, v in t.items()}
    need = max(max(r) for r in rows)
    print(f"17 emulated LET step, P={p} x n_local={n_l} (N={n}, uniform, the four top Morton "
          f"quadrants' slabs), theta={tp.theta}, let_cap={cap}: rows per export {rows} (the "
          f"largest {need}: auto_let_cap {auto} {'holds' if need <= auto else 'overflows'}); "
          f"deferred {deferred}; launches: exports {counts['B7']} B7, let_forces "
          f"{({k: v for k, v in forces_counts.items() if v})}")
    for k, v in t.items():
        print(f"17 {k}: " + ", ".join(f"{x:.3f}" for x in v) + f" ms per rank (mean {mean[k]:.3f})")
    print(f"17 single-device default step at N={n}: {single_ms:.3f} ms synchronised, "
          f"{single_ev:.3f} ms by events; per-rank LET stages sum {sum(mean.values()):.3f} ms")
    print(f"17 vs float64 on {LET_SAMPLE} receivers: mean relative error LET {err_let:.4e}, "
          f"single-device group walk {err_rep:.4e} (gates < 0.03 and LET < 3 x single + 1e-4); "
          f"[{smi}]")
    if not (err_let < 0.03 and err_rep < 0.03 and err_let < 3 * err_rep + 1e-4):
        fail("17 the emulated LET step's forces miss tests/test_let.py:68's criteria")
    mean_f = {k: sum(v) / len(v) for k, v in turns.items()}
    for k, v in turns.items():
        print(f"17c {k} (ranks 0-{p - 1}, two turns each): " + ", ".join(f"{x:.3f}" for x in v)
              + f" ms (mean {mean_f[k]:.3f})")
    print(f"17c per rank: split {mean_f['split_local'] + mean_f['split_import']:.3f} ms (local "
          f"{mean_f['split_local']:.3f} + import {mean_f['split_import']:.3f}), fused "
          f"{mean_f['b8'] + mean_f['fused_walk']:.3f} ms (B8 {mean_f['b8']:.3f} + walk "
          f"{mean_f['fused_walk']:.3f}), the tile set-up shared; vs float64 on {LET_SAMPLE} "
          f"receivers: fused {err_fused:.4e} (gates < 0.03 and < 3 x single + 1e-4); [{smi}]")
    if not (err_fused < 0.03 and err_fused < 3 * err_rep + 1e-4):
        fail("17c the fused LET step's forces miss tests/test_let.py:68's criteria")
    del locals_, exps, imps, accs, accs_f, single, truth
    # 17b. the uniform scene (each quadrant's count as it falls) owned as a
    # reshard leaves it: slices of the global Morton order, whose ragged ends
    # poke into the neighbours' slabs; the exports' rows at four times the
    # auto size (a measurement)
    del whole
    pos = torch.rand((n, 3), generator=gen, device=dev) * 2.0 - 1.0
    zero3 = torch.zeros_like(pos)
    perm = morton_order_cuda(pos, tp.max_depth)[0].long()
    slices = [st.let_sort_build(ParticleState(pos[perm[r * n_l:(r + 1) * n_l]], zero3[:n_l],
                                              zero3[:n_l], torch.ones(n_l, device=dev)),
                                bound, params, tp) for r in range(p)]
    del perm, pos, zero3
    boxes = [st.receiver_box(loc.pos_new) for loc in slices]
    blo, bhi = torch.cat([b[0] for b in boxes]), torch.cat([b[1] for b in boxes])
    wide = 4 * auto
    morton_rows = [st.let_export(loc, blo, bhi, r, tp, wide).n_rows.tolist()
                   for r, loc in enumerate(slices)]
    print(f"17b N={n} uniform in [-1, 1]^3 as four slices of the global Morton order: rows per "
          f"export at let_cap {wide}: {morton_rows} (auto_let_cap {auto}); [{smi}]")
    del slices
    torch.cuda.empty_cache()
    return {"stages_ms": t, "single_ms": single_ms, "single_events_ms": single_ev,
            "err_let": err_let, "err_single": err_rep, "rows": rows, "deferred": deferred,
            "let_cap": cap, "auto_let_cap": auto, "morton_slice_rows": morton_rows,
            "launches": counts["B7"],
            "fused": {"turns_ms": turns, "err": err_fused, "cap_forest": cap_forest,
                      "vs_split_p99": p99_fs, "tiles_compared": compared,
                      "launches": fused_counts["B8"], "device_ms_by_kernel": by_kernel}}


def sharded_run(make, steps, chunk, dev, energy_every=0):
    """(runner, launches, ms per step of the last chunk, the logged total
    energies) of a headless run on ``dev`` of ``steps`` steps in chunks of
    ``chunk`` (each chunk ends in a synchronisation; the energy, if any, is
    evaluated after it, outside the timed chunk)."""
    from wgpu_n_body_tpu_torch.inits import uniform_init
    from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless

    runner = OfflineHeadless(make(), uniform_init, seed=0, device=dev)
    lines = []
    zero_launch_counts()
    runner.run(steps=steps, chunk=chunk, energy_every=energy_every, log_fn=lines.append)
    energies = [float(x) for line in lines for x in re.findall(r"total energy (\S+)", line)]
    return runner, launch_counts(), runner.timer.times_s[-1] / chunk * 1e3, energies


def phase_sharded(dev, smi, render):
    """18. This slice's main path: a one-rank NCCL group running the sharded
    sims through the runner, each held to its single-device sim (the LET
    schedule with the split and with the fused walk); then ``bench``,
    ``visualize`` and ``serve`` through the group (18b), beside the
    single-device runs (``render``: phase 15's record)."""
    import torch.distributed as dist

    from wgpu_n_body_tpu_torch import cli
    from wgpu_n_body_tpu_torch.models import NaiveSim, TreeSim
    from wgpu_n_body_tpu_torch.params import NaiveParams, SimParams, TreeParams
    from wgpu_n_body_tpu_torch.parallel import ShardedNaiveSim, ShardedTreeSim
    from wgpu_n_body_tpu_torch.parallel.mesh import free_port, init_distributed, make_mesh

    backend = "nccl" if dev.type == "cuda" else "gloo"
    init_distributed(backend, 0, 1, f"tcp://localhost:{free_port()}")
    out = {}
    try:
        mesh = make_mesh()
        if mesh.device != dev or dist.get_backend() != backend:
            fail(f"18 the one-rank group runs on {mesh.device} under {dist.get_backend()}")
        steps, chunk = 6, 3
        # the naive runs log the total energy at their last step: one E1
        # launch over the one rank's share (0, 1), the single device's sum
        runs = [("naive", s, N_MAIN, expected_counts(B1=steps, E1=1))
                for s in ("allgather", "ring")]
        tree_counts = {
            "replicated": expected_counts(K1=steps, K2=steps, B5=steps, B4=steps,
                                          B4_eval=steps, B4_tables=steps, B4_tiles=steps, B3=steps),
            # the LET step's two walks share one tile set-up
            "let": expected_counts(K1=steps, K2=steps, B5=steps, B4=2 * steps,
                                   B4_eval=2 * steps, B4_tables=2 * steps, B4_tiles=steps,
                                   B3=2 * steps, B7=steps),
            # the fused walk: one B8 and one group walk per step
            "let fused": expected_counts(K1=steps, K2=steps, B5=steps, B4=steps,
                                         B4_eval=steps, B4_tables=steps, B4_tiles=steps,
                                         B3=steps, B7=steps, B8=steps),
        }
        runs += [("tree", s, N_TREE, c) for s, c in tree_counts.items()]
        singles = {}
        for kind, schedule, n, want in runs:
            params = SimParams(particle_num=n)
            if kind == "naive":
                make = lambda: ShardedNaiveSim(params, mesh, NaiveParams(), schedule)
                make_single = lambda: NaiveSim(params, NaiveParams())
            else:
                tp = TreeParams(let_fused=schedule == "let fused")
                make = lambda: ShardedTreeSim(params, mesh, tp, schedule.split()[0])
                make_single = lambda: TreeSim(params, TreeParams())
            every = steps if kind == "naive" else 0
            runner, counts, ms, energies = sharded_run(make, steps, chunk, dev, every)
            if counts != want:
                fail(f"18 {kind} {schedule}: {steps} steps launched {counts}, not {want}")
            if kind not in singles:
                singles[kind] = sharded_run(make_single, steps, chunk, dev, every)
            single, _, single_ms, single_energies = singles[kind]
            if len(energies) != (1 if every else 0) or not np.allclose(
                    energies, single_energies, rtol=1e-6, atol=0):
                fail(f"18 {kind} {schedule}: energies {energies} against the single device's "
                     f"{single_energies}")
            a, b = runner.state, single.state
            torch.testing.assert_close(a.pos, b.pos, rtol=1e-5, atol=1e-7)
            torch.testing.assert_close(a.vel, b.vel, rtol=1e-4, atol=1e-7)
            torch.testing.assert_close(a.acc, b.acc, rtol=1e-4, atol=1e-8)
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            health = runner.last_health
            print(f"18 one-rank NCCL {kind} {schedule} N={n}: {steps} steps in chunks of {chunk}, "
                  f"launches {({k: v for k, v in counts.items() if v})}; held to the "
                  f"single-device sim (bit-equal: {same}); {ms:.3f} ms/step against "
                  f"{single_ms:.3f} ({ms / single_ms - 1:+.2%}); health {health}; total "
                  f"energy {energies} against the single device's {single_energies}; [{smi}]")
            out[f"{kind} {schedule}"] = {"ms": ms, "single_ms": single_ms, "counts": counts,
                                         "bit_equal": same, "energies": energies}
            del runner
        del singles
        torch.cuda.empty_cache()
        # 18b. the other commands of --devices through the group: bench's
        # sweep (each point on the sharded sims) beside one device's,
        # visualize at its defaults, a serve flight
        lines = {}
        for what, argv in (("one device", ["bench"]), ("group", ["bench"])):
            buf = io.StringIO()
            zero_launch_counts()
            with contextlib.redirect_stdout(buf):
                if what == "group":
                    cli.run_rank(cli.parse_args(argv), mesh)
                elif cli.main(argv) != 0:
                    fail("18b cli bench returned non-zero")
            lines[what] = [json.loads(x) for x in buf.getvalue().splitlines()
                           if x.startswith("{")]
        # five points a backend, each two warm-up steps (``time_steps``: the second
        # captures a one-card TreeSim's graphed step) and 10 timed ones
        k = 5 * 12
        bench_counts = launch_counts()
        if bench_counts != expected_counts(B1=k, K1=k, K2=k, B5=k, B4=k, B4_eval=k, B4_tables=k,
                                           B4_tiles=k, B3=k):
            fail(f"18b bench through the group launched {bench_counts}")
        keys = {"sim", "n", "s_per_step", "bodies_per_sec", "pairs_per_sec"}
        group, single = lines["group"], lines["one device"]
        if (len(group) != 10 or [(r["sim"], r["n"]) for r in group]
                != [(r["sim"], r["n"]) for r in single]
                or not all(keys <= set(r) and r["s_per_step"] > 0 for r in group)):
            fail(f"18b bench through the group printed {group}")
        for a, b in zip(group, single):
            print(f"18b bench {a['sim']} ({a['schedule']}) N={a['n']}: "
                  f"{a['s_per_step'] * 1e6:.1f} us/step through the group, "
                  f"{b['s_per_step'] * 1e6:.1f} on one device")
        out["bench"] = {"group": group, "single": single, "counts": bench_counts}
        launches, us, wall = phase_visualize_cli(dev, smi, mesh, label="18b")
        print(f"18b visualize through the group: {us:.1f} us/step against "
              f"{render['visualize_us_per_step']:.1f} on one device (15c)")
        _, served = phase_serve(dev, smi, mesh, label="18b")
        print(f"18b serve through the group: frame p50 {served['frame_ms_p50']:.3f} ms, fps "
              f"{served['fps']} against {render['serve']['frame_ms_p50']:.3f} ms, "
              f"{render['serve']['fps']} on one device (15e)")
        out["visualize"] = {"us_per_step": us, "wall_s": wall, "launches": launches}
        out["serve"] = served
    finally:
        dist.destroy_process_group()
    return out


# ---------------------------------------------------------- the energy (E1)

#: E1 against the plain version in float64: the gate of 19a-19d, relative.
ENERGY_RTOL = 1e-5
N_ENERGY = 16_384
#: E1's operations per pair, counted from the function: a pair beyond
#: r_s = 3a by the series I = r^-2 sum_{k<5} c_k r^-3k, c_k = (-e)^k / (3k + 2)
#: (u = e r^-3 <= 1/27 there, so five terms are the fewest whose truncation
#: stays under 1e-8 of I over the whole far field; a pair far beyond r_s
#: would need fewer, which this count does not credit), e folded into the
#: coefficients on the host. MUFU: rsqrt(r^2). Float32 flops: d (3), r^2 (a
#: product and two FMAs, 5), ri^2 (1), t = ri^2 ri (1), Horner over five
#: coefficients (4 FMAs, 8), I = ri^2 P (1), m_j I accumulated (2): 21.
ENERGY_MUFU_PER_PAIR = 1
ENERGY_FLOPS_PER_PAIR = 21
NO_ENERGY_LIBRARY = "none: no single PyTorch call sums a pair potential over the pairs i < j"


def energy_bound(n, mhz):
    """E1's ``bound`` over the n (n - 1) / 2 pairs of n bodies: the
    function's operations per pair, the bodies' 16 bytes each and the
    float64 out."""
    return bound(n * (n - 1) / 2, ENERGY_MUFU_PER_PAIR, ENERGY_FLOPS_PER_PAIR, n * 16 + 8, mhz)


def far_pair_sass(lib_path, sass_dir=None):
    """(SASS instructions per pair, MUFU ops per pair, pairs per trip) of
    E1's far loop: the innermost loop of the softened kernel with the fewest
    instructions per MUFU.RSQ (``utils/chip.py::sass_loops``; the far loop
    has no branch and one RSQ a pair). None without ``cuobjdump``."""
    loops = sass_loops(lib_path, "energy_kernelILb1E", sass_dir)
    if not loops:
        return None
    _, n_ins, rsq, mufu = min(loops, key=lambda loop: loop[1] / loop[2])
    return n_ins / rsq, mufu / rsq, rsq


def probe_sweep(e, dev):
    """float32 r on the card for E1's pair probe: 0, geomspace(1e-3 a, 4)
    and r_s (1 -+ 1e-6), a = e^(1/3); beside it I(r) in float64 at the r the
    float32 r^2 stands for, and the near field's mask."""
    from wgpu_n_body_tpu_torch.ops.energy import RS_OVER_A, pair_constants, softened_pair_integral

    a = e ** (1.0 / 3.0)
    rs = RS_OVER_A * a
    r = np.concatenate([[0.0, rs * (1 - 1e-6), rs * (1 + 1e-6)],
                        np.geomspace(1e-3 * a, 4.0, 200_001)])
    r = torch.from_numpy(r).float().to(dev)
    r2 = (r * r).double()
    return r, softened_pair_integral(torch.sqrt(r2), e), r2 < pair_constants(e).rs2


def phase_energy_probe(dev, smi):
    """19d. E1's pair arithmetic on the card (``energy_probe``: the kernel's
    tile pass, one source at each r) against float64 I(r) over the sweep,
    for three softening values, with the switch planted at 1.2a, which must
    fail."""
    from wgpu_n_body_tpu_torch.ops import energy_cuda
    from wgpu_n_body_tpu_torch.ops.energy import pair_constants

    out = {}
    for e in (1e-4, 1e-5, 1e-2):
        r, want, near = probe_sweep(e, dev)
        rel = ((energy_cuda.pair_probe(r, e).double() - want) / want).abs()
        newton = ((energy_cuda.pair_probe(r[1:], e, softened=False).double()
                   - torch.rsqrt((r[1:] * r[1:]).double())) * torch.sqrt((r[1:] * r[1:]).double())
                  ).abs().max().item()
        bad = pair_constants(e)._replace(rs2=(1.2 * e ** (1.0 / 3.0)) ** 2)
        planted = ((energy_cuda.pair_probe(r, e, constants=bad).double() - want) / want
                   ).abs().max().item()
        far, near_err, worst = rel[~near].max().item(), rel[near].max().item(), rel.max().item()
        print(f"19d pair probe e={e:g} ({r.numel()} r, {int(near.sum())} near): max rel err far "
              f"{far:.3e}, near {near_err:.3e} (gate {ENERGY_RTOL:.0e}); 1/r {newton:.3e}; the "
              f"switch at 1.2a {planted:.3e}; [{smi}]")
        if not (worst <= ENERGY_RTOL and newton <= ENERGY_RTOL):
            fail(f"19d E1's pair function at e={e:g}: {worst:.3e} (1/r {newton:.3e}) from float64")
        if planted <= ENERGY_RTOL:
            fail(f"19d the switch planted at 1.2a ({planted:.3e}) passes the gate at e={e:g}")
        out[f"{e:g}"] = {"far": far, "near": near_err, "newton": newton, "planted": planted}
    return out


def phase_energy(dev, smi, mhz, lib_path):
    """19. E1 against the plain version in float64 on three scenes, a planted
    fault, N=262144 timed beside the plain version (uniform, and disc), launches and shares,
    N=4M timed, its pair function probed, its far pair's SASS."""
    from wgpu_n_body_tpu_torch.inits import disc_init, spherical_init, uniform_init
    from wgpu_n_body_tpu_torch.ops import energy_cuda
    from wgpu_n_body_tpu_torch.ops.energy import potential_energy_plain
    from wgpu_n_body_tpu_torch.params import ParticleState, SimParams

    def e1(state, params, share=(0, 1)):
        out = energy_cuda.potential_energy_cuda(state.pos, state.mass, params, True, share)
        torch.cuda.synchronize()
        return out

    def plain(state, params, share=(0, 1), block=1024, double=False):
        if double:
            state = ParticleState(*(t.double() for t in state))
        return potential_energy_plain(state, params, block, True, share)

    def rel(got, want):
        return abs(float(got) - float(want)) / abs(float(want))

    # -- 19a. three scenes, whole, against float64; one body made massless --
    scenes = {}
    for name, init in (("uniform", uniform_init), ("disc", disc_init),
                       ("spherical", spherical_init)):
        params = SimParams(particle_num=N_ENERGY)
        st = init(torch.Generator().manual_seed(1), params, dev)
        want = plain(st, params, double=True)
        got, plain32 = e1(st, params), plain(st, params)
        err, err_plain = rel(got, want), rel(plain32, want)
        mass = st.mass.clone()
        mass[N_ENERGY // 3] = 0
        planted = rel(e1(st._replace(mass=mass), params), want)
        print(f"19a {name} N={N_ENERGY}: E1 {float(got):.12e}, float64 {float(want):.12e}: "
              f"rel err {err:.3e} (plain float32 {err_plain:.3e}); one body massless moves it "
              f"{planted:.3e}; gate {ENERGY_RTOL:.0e}")
        if not np.isfinite(float(got)) or err > ENERGY_RTOL:
            fail(f"19a E1 on the {name} scene is {err:.3e} from float64")
        if planted <= ENERGY_RTOL:
            fail(f"19a the planted fault on the {name} scene ({planted:.3e}) passes the gate")
        scenes[name] = {"rel_err": err, "plain_rel_err": err_plain, "planted": planted}
        del st, mass

    # -- 19b. N=262144 (the naive main path's energy): timed, launches, shares --
    params = SimParams(particle_num=N_MAIN)
    st = uniform_init(torch.Generator().manual_seed(0), params, dev)  # cli headless --sim naive
    ms, whole = time_ms(lambda: energy_cuda.potential_energy_cuda(st.pos, st.mass, params), 3)
    plain_ms, whole32 = time_ms(lambda: plain(st, params), 1)
    again = e1(st, params)
    max_abs = abs(float(whole) - float(whole32))
    if not torch.equal(whole, again):
        fail(f"19b two E1 launches differ: {float(whole)!r} {float(again)!r}")
    parts = [float(e1(st, params, (k, 5))) for k in range(5)]
    share_err = rel(sum(parts), whole)
    if share_err > 1e-12:
        fail(f"19b five shares sum to {sum(parts)!r}, the whole is {float(whole)!r}")
    share = (7, 32)
    got = e1(st, params, share)
    want = plain(st, params, share, block=64, double=True)
    err = rel(got, want)
    if err > ENERGY_RTOL:
        fail(f"19b E1 on share {share} at N={N_MAIN} is {err:.3e} from float64")
    b = energy_bound(N_MAIN, mhz)
    print(f"19b N={N_MAIN} uniform: E1 {ms:.3f} ms, plain float32 {plain_ms:.3f} ms, |E1 - "
          f"plain| {max_abs:.3e} (rel {rel(whole, whole32):.3e}); bound {b['bound_ms']:.3f} ms "
          f"({b['bound_unit']}; float32 {b['bound_fp32_ms']:.3f} ms), E1 at "
          f"{b['bound_ms'] / ms:.2%}; two launches bit-equal; 5 shares sum to the whole within "
          f"{share_err:.3e}; share {share} against float64 {err:.3e}; [{smi}]")
    rec = {"name": "potential_energy", "route": "cuda",
           "source": "wgpu_n_body_tpu_torch/csrc/energy.cu",
           "replaces": "wgpu_n_body_tpu/ops/energy.py:62", "max_abs_err": max_abs, "ms": ms,
           "plain_ms": plain_ms, **b, "library_ms": None, "library": NO_ENERGY_LIBRARY,
           "n": N_MAIN, "scenes": scenes,
           "shares_rel_err": share_err, "share_rel_err_f64": err}
    del st, whole32

    # -- 19b'. N=262144 disc: the most near pairs, so the most divergence --
    st = disc_init(torch.Generator().manual_seed(0), params, dev)
    disc_ms, _ = time_ms(lambda: energy_cuda.potential_energy_cuda(st.pos, st.mass, params), 3)
    print(f"19b N={N_MAIN} disc: E1 {disc_ms:.3f} ms, at {b['bound_ms'] / disc_ms:.2%} of the "
          f"bound; [{smi}]")
    rec["disc_ms"] = disc_ms
    del st

    # -- 19c. N=4M, the headless default's scene: one evaluation, timed --
    params = SimParams(particle_num=N_TREE)
    st = uniform_init(torch.Generator().manual_seed(0), params, dev)
    out, ms_4m = stage_ms(lambda: energy_cuda.potential_energy_cuda(st.pos, st.mass, params))
    s_4m = ms_4m / 1e3
    share = (1234, 4096)
    err = rel(e1(st, params, share), plain(st, params, share, block=16, double=True))
    b4m = energy_bound(N_TREE, mhz)
    print(f"19c N={N_TREE} uniform: E1 {float(out):.9e} in {s_4m:.3f} s; bound "
          f"{b4m['bound_ms'] / 1e3:.3f} s ({b4m['bound_unit']}; float32 "
          f"{b4m['bound_fp32_ms'] / 1e3:.3f} s), E1 at {b4m['bound_ms'] / 1e3 / s_4m:.2%}; "
          f"share {share} against float64 {err:.3e}; [{smi}]")
    if not np.isfinite(float(out)) or err > ENERGY_RTOL:
        fail(f"19c E1 at N={N_TREE}: {float(out)!r}, share against float64 {err:.3e}")
    rec["n4m"] = {"s": s_4m, "bound_s": b4m["bound_ms"] / 1e3, "bound_unit": b4m["bound_unit"],
                  "share_of_bound": b4m["bound_ms"] / 1e3 / s_4m, "share_rel_err_f64": err}
    del st
    torch.cuda.empty_cache()

    # -- 19d. the pair function alone; 19e. the far pair's SASS --
    rec["probe"] = phase_energy_probe(dev, smi)
    sass = far_pair_sass(lib_path)
    if sass:
        print(f"19e SASS of E1's pair loop, every pair far: {sass[0]:.2f} instructions and "
              f"{sass[1]:.2f} MUFU per pair ({sass[2]} pairs per trip); [{smi}]")
        rec["sass_per_far_pair"], rec["mufu_per_far_pair"] = sass[0], sass[1]
    else:
        print("19e SASS of E1's pair loop: not measured (no cuobjdump, or no loop found)")
    return rec


def drift_run(n, steps, chunk, dev):
    """(|dE/E|, wall s, launches) of ``steps`` naive steps of the spherical
    scene (tests/test_runners.py:146-160's parameters) through the runner,
    in chunks of ``chunk``; the energies by E1."""
    from wgpu_n_body_tpu_torch.inits import spherical_init
    from wgpu_n_body_tpu_torch.models import NaiveSim
    from wgpu_n_body_tpu_torch.params import NaiveParams, SimParams
    from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless

    params = SimParams(particle_num=n, g=1e-6, e=1e-4, dt=0.016)
    runner = OfflineHeadless(NaiveSim(params, NaiveParams()), spherical_init, seed=2, device=dev)
    zero_launch_counts()
    e0 = runner.total_energy()
    t0 = time.perf_counter()
    runner.run(steps=steps, chunk=chunk, log_fn=lambda line: None)
    wall = time.perf_counter() - t0
    e1 = runner.total_energy()
    return abs(e1 - e0) / abs(e0), wall, launch_counts()


def phase_energy_runs(dev, smi):
    """20. ``cli headless --energy-every`` at the defaults (N=4M), the bench
    module, the drift proxy and BASELINE config 5."""
    from wgpu_n_body_tpu_torch import cli

    # -- 20a. the headless default with an energy line ----------------------
    argv = ["headless", "--steps", str(STEPS), "--energy-every", str(STEPS)]
    zero_launch_counts()
    t0 = time.perf_counter()
    with kept_steps() as made:
        out = run_cli(cli, argv)
    cli_s = time.perf_counter() - t0
    cli_counts = launch_counts()
    k = graphed_bodies(made, STEPS)  # the graphed step's bodies through the launchers
    want = expected_counts(K1=k, K2=k, B5=k, B4=k, B4_eval=k, B4_tables=k, B4_tiles=k, B3=k, E1=1)
    if cli_counts != want:
        fail(f"20a cli headless --energy-every {STEPS} launched {cli_counts}, not {want}")
    energies = [float(x) for x in re.findall(r"total energy (\S+)", out)]
    if len(energies) != 1 or not np.isfinite(energies).all():
        fail(f"20a energies {energies}")
    print(f"20a cli headless --steps {STEPS} --energy-every {STEPS} (N={N_TREE}): total energy "
          f"{energies[0]!r}, E1 {cli_counts['E1']} launch, {cli_s:.3f} s for the run; [{smi}]")

    # -- 20b. the bench module, as a user runs it -----------------------------
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, "-m", "wgpu_n_body_tpu_torch.bench"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"20b python -m wgpu_n_body_tpu_torch.bench exited {proc.returncode}:\n"
             f"{proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    bench = json.loads(lines[-1]) if len(lines) == 1 else {}
    if set(bench) != {"metric", "value", "unit", "vs_baseline", "device"} or not (
            bench["metric"] == f"naive_pairwise_interactions_per_sec_n{N_MAIN}"
            and np.isfinite(bench["value"]) and bench["value"] > 0):
        fail(f"20b the bench module printed {proc.stdout!r}")
    print(f"20b python -m wgpu_n_body_tpu_torch.bench: {lines[0]}; [{smi}]")

    # -- 20c. the drift proxy and BASELINE config 5 ---------------------------
    drift = {}
    for name, n, steps, gate in (("proxy", 512, 10_000, 3e-2), ("config5", 4096, 100_000, 0.1)):
        d, wall, counts = drift_run(n, steps, 1000, dev)
        if counts != expected_counts(B1=steps, E1=2):
            fail(f"20c {name}: {counts}")
        print(f"20c drift {name}: N={n} spherical, {steps} steps in chunks of 1000: |dE/E| "
              f"{d:.6e} (gate {gate:.0e}), {wall:.3f} s ({wall / steps * 1e6:.1f} us/step); "
              f"launches B1 {counts['B1']}, E1 {counts['E1']}; [{smi}]")
        if not np.isfinite(d) or d >= gate:
            fail(f"20c drift {name} {d!r} not below {gate}")
        drift[name] = {"n": n, "steps": steps, "drift": d, "s": wall}
    return {"launches": cli_counts["E1"], "cli_s": cli_s, "energy": energies[0], "bench": bench,
            "drift": drift}


#: The graphed step's cases (phase 21): the benchmark's four step cells'
#: configurations and scenes, (label, N, scene, TreeParams keywords).
GRAPH_CASES = (
    ("headless-4m-uniform", N_TREE, "uniform", {}),
    ("headless-4m-disc", N_TREE, "disc", {}),
    ("disc-2m-theta05", 2_000_000, "disc", {"theta": 0.5}),
    ("headless-4m-per-particle", N_TREE, "uniform", {"walk": "per_particle"}),
)
#: the cuts a captured step keeps, after ``tree_step``: one per innermost
#: range, the counters as eager work
GRAPH_CUTS = {
    "group": [("morton_keys",), ("morton_sort",), ("tree_build",), ("leapfrog.drift",),
              ("theta_walk", "group_tiles"), ("theta_walk", "group_tables"),
              ("theta_walk", "group_kernel", "group_walk"),
              ("theta_walk", "group_kernel", "group_eval"), ("theta_walk", "group_fallback"),
              ("counters",), ("leapfrog.kick",), ("overflow_flag",)],
    "per_particle": [("morton_keys",), ("morton_sort",), ("tree_build",), ("leapfrog.drift",),
                     ("theta_walk", "pp_pack"), ("theta_walk", "pp_walk"), ("counters",),
                     ("leapfrog.kick",), ("overflow_flag",)],
}
#: parent, change, change, parent: the turns of phase 21e
TURNS = ("parent", "change", "change", "parent")


def graph_scene(scene, n, dev, seed=0):
    from wgpu_n_body_tpu_torch.inits import disc_init, uniform_init
    from wgpu_n_body_tpu_torch.params import SimParams

    init = disc_init if scene == "disc" else uniform_init
    return init(torch.Generator().manual_seed(seed), SimParams(particle_num=n), dev)


def clone_state(state):
    return type(state)(*(t.clone() for t in state))


def traced_counters(step, state):
    """(output, the counters) of one call of ``step`` under the profiler."""
    from wgpu_n_body_tpu_torch.utils import profiling

    profiling.reset_counters()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        out = step(state)
        torch.cuda.synchronize()
    got = profiling.counters()
    profiling.reset_counters()
    return out, got


def phase_graph_case(dev, smi, label, n, scene, kw):
    """21a. One configuration: 12 calls of the graphed step (its first
    call, the capture, then 10 replays, a rewind before the 8th call to a
    copy of the 5th call's output) each bit-equal on every field to the
    eager step's; the cuts of the capture; the graph pool's bytes; a traced
    replay's counters equal to a traced eager step's."""
    from wgpu_n_body_tpu_torch.models import TreeSim
    from wgpu_n_body_tpu_torch.params import SimParams, TreeParams

    params, tp = SimParams(particle_num=n), TreeParams(**kw)
    state = graph_scene(scene, n, dev)
    eager_sim, sim = TreeSim(params, tp), TreeSim(params, tp)
    for s in (eager_sim, sim):
        s.init_state(None, lambda *_: state, dev)  # loads the counters' kernels
    eager, step = eager_sim.step_fn(), sim.make_step()
    a, b = state, clone_state(state)
    reserved = []
    for i in range(1, 13):
        if i == 8:
            a, b = clone_state(kept), clone_state(kept)
        if i == 2:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved.append(torch.cuda.memory_reserved(dev))
        a, b = eager(a), step(b)
        torch.cuda.synchronize()
        if i == 2:
            torch.cuda.empty_cache()
            reserved.append(torch.cuda.memory_reserved(dev))
        if i == 5:
            kept = clone_state(b)
        off = [f for f, x, y in zip(state._fields, a, b) if not torch.equal(x, y)]
        if off:
            fail(f"21a {label}: call {i} of the graphed step differs from the eager step in {off}")
    if (step.calls, step.replays, step.captures) != (12, 10, 2):
        fail(f"21a {label}: calls, replays, captures {step.calls, step.replays, step.captures}")
    cuts = [tuple(name for _, name in seg.path[1:]) for seg in step.plans[0]]
    if cuts != GRAPH_CUTS[tp.walk] or [s.path[0][1] for s in step.plans[0]] != ["tree_step"] * len(cuts):
        fail(f"21a {label}: the capture's cuts {cuts}")
    graphs = sum(seg.graph is not None for seg in step.plans[0])
    a, want = traced_counters(eager, clone_state(b))
    b, got = traced_counters(step, b)
    steps = {k: got.pop(k, None) for k in ("step.steps", "step.replayed")}
    if not all(torch.equal(x, y) for x, y in zip(a, b)) or got != want or steps != {
            "step.steps": 1, "step.replayed": 1}:
        fail(f"21a {label}: a traced replay's counters {got} {steps} (outputs equal "
             f"{all(torch.equal(x, y) for x, y in zip(a, b))}), the eager step's {want}")
    pool = reserved[1] - reserved[0]
    print(f"21a {label} (N={n}, {scene}, {kw or 'defaults'}): 12 calls (first, capture, 10 "
          f"replays, a rewind before the 8th) bit-equal to the eager step on every field; "
          f"{graphs} graphs a direction, cuts {[c[-1] for c in cuts]}; reserved bytes before and "
          f"after the capture {reserved[0]} -> {reserved[1]} (the pool and the side stream's "
          f"scratch: {pool}); a traced replay's counters equal the eager step's; [{smi}]")
    del a, b, kept, eager, step, eager_sim, sim, state
    torch.cuda.empty_cache()
    return {"graphs": graphs, "reserved_before": reserved[0], "reserved_after": reserved[1],
            "pool_bytes": pool}


def phase_graph_overflow(dev, smi):
    """21b. A planted overflow raises at the end of its batch: an arena
    between the N=262144 uniform scene's nodes and those of the same scene
    with its bodies gathered in clusters of 17 within 1e-6 (each a chain of
    cells down to the last level), the clustered state handed in at the 8th
    call (the second of the third batch of 3), through ``OfflineHeadless``;
    21c no device read in a graphed runner step: no
    ``aten::_local_scalar_dense`` or ``aten::item`` in its trace."""
    from wgpu_n_body_tpu_torch.models import TreeSim
    from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams
    from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless

    n = N_MAIN
    params = SimParams(particle_num=n)
    fits = graph_scene("uniform", n, dev)
    c = n // 17
    gen = torch.Generator(device=dev).manual_seed(3)
    pos = fits.pos.clone()
    pos[:17 * c] = (fits.pos[:c].repeat_interleave(17, 0)
                    + 1e-6 * torch.randn((17 * c, 3), generator=gen, device=dev))
    clustered = fits._replace(pos=pos)
    probe = TreeSim(params, TreeParams(node_capacity_factor=4.0))
    nodes = [probe.diagnose(s)["num_nodes"] for s in (fits, clustered)]
    if not 2 * nodes[0] < nodes[1]:
        fail(f"21b the clustered scene has not twice the uniform one's nodes: {nodes}")
    tp = TreeParams(node_capacity_factor=(nodes[0] + nodes[1]) / 2 / n)
    raised = {}
    for chunk in (1, 3):
        sim = TreeSim(params, tp)
        runner = OfflineHeadless(sim, lambda *_: ParticleState(*fits), device=dev)
        step, calls = runner._step, iter(range(1, 100))
        runner._step = lambda state: step(clustered if next(calls) == 8 else state)
        try:
            runner.run(12, chunk=chunk)
            raised[chunk] = None
        except RuntimeError as e:
            if "arena overflow" not in str(e):
                raise
            raised[chunk] = runner.step_num
        if raised[chunk] != (8 if chunk == 1 else 9) or step.replays < 5:
            fail(f"21b chunk {chunk}: the planted overflow raised at step {raised[chunk]} "
                 f"({step.replays} replays)")
    sim = TreeSim(params, TreeParams())
    runner = OfflineHeadless(sim, lambda *_: ParticleState(*fits), device=dev)
    for _ in range(2):
        runner.step()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            runner.step()
    reads = [e.key for e in prof.key_averages() if e.key in ("aten::_local_scalar_dense",
                                                             "aten::item")]
    if reads:
        fail(f"21c graphed runner steps read the device: {reads}")
    print(f"21b planted overflow (arena of {tp.capacity(n)} nodes: the uniform scene "
          f"{nodes[0]}, clustered {nodes[1]}) at the 8th call raised after step {raised[1]} "
          f"(chunk 1) and {raised[3]} (chunk 3); 21c three traced graphed runner steps: no "
          f"aten::_local_scalar_dense or aten::item; [{smi}]")
    return {"nodes": nodes, "raised_at": raised}


def phase_graph_whole(dev, smi):
    """21d. The 2M disc θ=0.5 step untraced, synchronised after each step as
    the runner does: the split graphs' replay against one whole-step graph
    of the same body (captured here for the comparison only), in turns."""
    from wgpu_n_body_tpu_torch.models import TreeSim
    from wgpu_n_body_tpu_torch.models.step_graph import replay
    from wgpu_n_body_tpu_torch.params import SimParams, TreeParams

    n = 2_000_000
    sim = TreeSim(SimParams(particle_num=n), TreeParams(theta=0.5))
    state = graph_scene("disc", n, dev)
    sim.init_state(None, lambda *_: state, dev)
    step = sim.make_step()
    step(step(state))
    whole = torch.cuda.CUDAGraph()
    with torch.cuda.stream(step._stream):
        torch.cuda.synchronize()
        whole.capture_begin()
        step._body(0)
        whole.capture_end()
    torch.cuda.synchronize()
    plan = step.plans[0]

    def timed(fn, reps=40):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    turns = {"split": [], "whole": []}
    for kind in ("split", "whole", "whole", "split", "split", "whole"):
        turns[kind].append(timed((lambda: replay(plan)) if kind == "split" else whole.replay))
    split, one = (float(np.mean(turns[k])) for k in ("split", "whole"))
    print(f"21d N={n} disc theta=0.5, synchronised steps, median ms per turn: split "
          f"{turns['split']}, whole-step graph {turns['whole']}: the whole-step graph saves "
          f"{split - one:.4f} ms a step; [{smi}]")
    del whole, step, sim, state
    torch.cuda.empty_cache()
    return {"split_ms": turns["split"], "whole_ms": turns["whole"], "saves_ms": split - one}


def phase_graph_turns(smi, repo, seconds=10):
    """21e. The cell ``disc-2m-theta05`` through the benchmark (``nbody_bench/run.py``
    of each checkout, ``--seconds`` 10), untraced and traced, in turns with
    the checkout at ``repo`` (parent, change, change, parent): step_ms,
    force_err, enqueue_ms, starve_ms, idle_pct.step, the kernels' ranges and
    the traced window's idle gaps by what the host was doing."""
    here = os.path.dirname(os.path.abspath(__file__))
    rows = []
    for trace in (0, 1):
        for i, who in enumerate(TURNS):
            root = repo if who == "parent" else here
            seed = 3_000_000_011 + 7 * i
            cmd = [sys.executable, "nbody_bench/run.py", "--workload", "disc-2m-theta05",
                   "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
            p = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=900)
            if p.returncode != 0:
                fail(f"21e {who} run failed: {p.stderr[-3000:]}")
            res = json.loads(p.stdout.strip().splitlines()[-1])
            nums = {k: v["value"] for k, v in res["metrics"].items()}
            rows.append({"who": who, "trace": trace, "seed": seed, "correct": res["correct"],
                         "metrics": nums, "idle_gaps": res.get("breakdown", {}).get("idle_gaps")})
            print(f"21e {who} trace {trace} seed {seed}: correct {res['correct']} "
                  + ", ".join(f"{k} {v:.6g}" for k, v in sorted(nums.items()))
                  + (f"; idle gaps (s over the window) {rows[-1]['idle_gaps']}" if trace else ""))
            if not res["correct"]:
                fail(f"21e {who} trace {trace}: not correct: {res['checks']}")
    print(f"21e done; [{smi}]")
    return rows


def phase_graph(dev, smi, repo=None):
    """21. The graphed TreeSim step."""
    cases = {label: phase_graph_case(dev, smi, label, n, scene, kw)
             for label, n, scene, kw in GRAPH_CASES}
    rec = {"cases": cases, "overflow": phase_graph_overflow(dev, smi),
           "whole_step": phase_graph_whole(dev, smi)}
    if repo:
        rec["turns"] = phase_graph_turns(smi, repo)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "graph_phase.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="the port's main path on one NVIDIA GPU")
    ap.add_argument("--only", choices=["graph"], default=None,
                    help="run phase 1 and this phase alone")
    ap.add_argument("--repo", default=None,
                    help="another checkout (with this benchmark laid over it) for phase 21e")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    from wgpu_n_body_tpu_torch import cli
    from wgpu_n_body_tpu_torch.inits import uniform_init
    from wgpu_n_body_tpu_torch.models import NaiveSim
    from wgpu_n_body_tpu_torch.native import build as native_build
    from wgpu_n_body_tpu_torch.ops import (
        energy_cuda,
        import_forest_cuda,
        let_export_cuda,
        morton_cuda,
        naive_cuda,
        raster_cuda,
        tree_build_cuda,
        tree_walk_cuda,
        tree_walk_group_cuda,
    )
    from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_ref
    from wgpu_n_body_tpu_torch.params import NaiveParams, SimParams
    from wgpu_n_body_tpu_torch.utils.checkpoint import load_checkpoint

    if "jax" in sys.modules or "wgpu_n_body_tpu" in sys.modules:
        fail("the port imported jax or the JAX package")

    # -- 1. the card -------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    smi = card()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    if args.only == "graph":
        phase_graph(dev, smi, args.repo)
        print(f"chip_smoke --only graph elapsed {time.perf_counter() - t_start:.1f} s; [{smi}]")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return

    # -- 2. build every kernel, one nvcc per source, all at once ------------
    t0 = time.perf_counter()
    def timed_host_build():
        t = time.perf_counter()
        return (*native_build.build(), time.perf_counter() - t)

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=11)
    host_lib = pool.submit(timed_host_build)  # native/octree.cpp, by g++
    builds = {
        "B1/B2": pool.submit(naive_cuda.build),
        "B3": pool.submit(tree_walk_cuda.build),
        "B4": pool.submit(tree_walk_group_cuda.build),
        "B4 T": pool.submit(tree_walk_group_cuda.build_tiles),
        "B5": pool.submit(tree_build_cuda.build),
        "K1": pool.submit(morton_cuda.build),  # with CUB's radix sort
        "B6": pool.submit(raster_cuda.build),
        "B7": pool.submit(let_export_cuda.build),
        "B8": pool.submit(import_forest_cuda.build),
        "E1": pool.submit(energy_cuda.build),
    }
    pool.shutdown(wait=True)
    t_build = time.perf_counter() - t0
    built = {k: f.result() for k, f in builds.items()}  # raises a build's error
    lib_path, log = built["B1/B2"]
    octree_lib, _, s_octree = host_lib.result()
    print(f"build ({len(built)} kernel sources and native/octree.cpp in parallel): {t_build:.3f} s "
          f"-> {lib_path.name}; g++ on native/octree.cpp {s_octree:.3f} s -> {octree_lib.name}")
    if log == "cached":
        print_ptxas(log)
    naive_ptxas = ptxas_kernels(log)
    for name, regs, stores, loads in naive_ptxas:
        print(f"2 ptxas {name}: {regs} registers, {stores} bytes spill stores, {loads} bytes "
              f"spill loads")
    regs_b1, regs_b2 = naive_registers(naive_ptxas, False), naive_registers(naive_ptxas, True)
    for mxu, label in ((False, "B1"), (True, "B2")):
        print(f"2 {label} launch limits from its library: {naive_cuda.kernel_limits(dev, mxu)}")
    mhz = max_sm_clock_mhz()

    def kernel(pn, po, m, params, row_offset, tile_i, tile_j):
        """Launch the kernel and surface any fault of its run here."""
        out = naive_cuda.naive_forces_cuda(pn, po, m, params, row_offset, tile_i, tile_j)
        torch.cuda.synchronize()
        return out

    # -- 3a. small ragged inputs: rtol 3e-5, atol 1e-9 (tests/test_naive.py) --
    small = SimParams(particle_num=1000, g=1e-4, e=1e-4, dt=0.016)
    pn, po, m = cuda_state(1000, 3, dev)
    want = naive_forces_ref(pn, po, m, small)
    for ti, tj in ((64, 128), (512, 2048)):
        got = kernel(pn, po, m, small, 0, ti, tj)
        torch.testing.assert_close(got, want, rtol=3e-5, atol=1e-9)
        print(f"3a n=1000 tiles {ti}/{tj}: max|k-p| {(got - want).abs().max().item():.3e} ok")

    # -- 3b. receiver shards; (100, 300) straddles source tiles 128 and 256 --
    for a, b in ((0, 64), (64, 192), (100, 300), (936, 1000)):
        for ti, tj in ((64, 128), (512, 2048)):
            got = kernel(pn[a:b], po, m, small, a, ti, tj)
            ref = naive_forces_ref(pn[a:b], po, m, small, row_offset=a)
            torch.testing.assert_close(got, ref, rtol=3e-5, atol=1e-9)
            torch.testing.assert_close(got, want[a:b], rtol=3e-5, atol=1e-9)
    print("3b row_offset shards (0,64) (64,192) (100,300) (936,1000) x 2 tilings: ok")

    # -- 3c. distinct coincident particles give NaN in both ----------------
    pn_c, po_c, m_c = (t[:64].clone() for t in (pn, po, m))
    po_c[9] = pn_c[5]
    got = kernel(pn_c, po_c, m_c, small, 0, 64, 128)
    ref = naive_forces_ref(pn_c, po_c, m_c, small)
    nan_k, nan_p = torch.isnan(got).any(dim=1), torch.isnan(ref).any(dim=1)
    if not nan_k[5] or not torch.equal(nan_k, nan_p):
        fail(f"NaN rows differ: kernel {nan_k.nonzero().flatten().tolist()} "
             f"plain {nan_p.nonzero().flatten().tolist()}")
    torch.testing.assert_close(got[~nan_k], ref[~nan_k], rtol=3e-5, atol=1e-9)
    print(f"3c coincident pair: NaN rows {nan_k.nonzero().flatten().tolist()} in both, ok")

    # -- 3d. N=262144 uniform scene against float64: the main path's launch --
    params = SimParams(particle_num=N_MAIN)  # g 1e-6, e 1e-4, dt 0.016
    pn, po, m = main_state(params, dev)
    errs_k, errs_s, errs_p = float64_rows(kernel, naive_forces_ref, pn, po, m, params)
    p99_k, p99_s, p99_p = (float(np.percentile(e, 99)) for e in (errs_k, errs_s, errs_p))
    print(f"3d N={N_MAIN} vs float64 over {errs_k.size} rows: kernel (full launch) p99 "
          f"{p99_k:.3e} max {errs_k.max():.3e}; 512-row shards p99 {p99_s:.3e} max "
          f"{errs_s.max():.3e}; plain f32 p99 {p99_p:.3e} max {errs_p.max():.3e}")
    gate = 1e-4 if p99_p <= 1e-4 else 2 * p99_p
    for what, errs, p99 in (("kernel", errs_k, p99_k), ("shard", errs_s, p99_s)):
        if not np.isfinite(errs).all() or p99 > gate:
            fail(f"{what} p99 {p99:.3e} above the gate {gate:.3e}")

    # -- 4. time kernel and plain version at the main path's shape ---------
    ms_k, k_full = time_ms(
        lambda: naive_cuda.naive_forces_cuda(pn, po, m, params, 0, 512, 2048), 5
    )
    ms_p, p_full = time_ms(lambda: naive_forces_ref(pn, po, m, params), 3)
    pairs = float(N_MAIN) * N_MAIN
    b1_bound = bound(pairs, 2, 20, naive_bytes(N_MAIN), mhz)
    print(f"4 N={N_MAIN}: kernel {ms_k:.3f} ms ({pairs / ms_k * 1e3:.4e} pairs/s); "
          f"plain {ms_p:.3f} ms ({pairs / ms_p * 1e3:.4e} pairs/s); max SM clock {mhz:.0f} MHz, "
          f"bound {b1_bound['bound_ms']:.3f} ms ({b1_bound['bound_unit']}; float32 "
          f"{b1_bound['bound_fp32_ms']:.3f} ms): kernel at {b1_bound['bound_ms'] / ms_k:.2%}; "
          f"[{smi}]")
    plan = naive_cuda.LAST_PLAN
    print(f"4 N={N_MAIN} plan: {plan.ctas} receiver CTAs x {plan.splits} source slices of "
          f"{plan.threads} threads x {plan.per_thread} receivers, {plan.waves:.3f} waves of "
          f"{plan.slots} slots")
    # full-shape agreement: both are f32 sums in different orders, each held
    # to 1e-4 p99 against float64 above, so their difference to 2e-4
    diff = row_rel_err(k_full, p_full)
    max_abs = (k_full - p_full).abs().max().item()
    again = naive_cuda.naive_forces_cuda(pn, po, m, params, 0, 512, 2048)
    torch.cuda.synchronize()
    print(f"4 full shape kernel vs plain: per-row rel p99 {np.percentile(diff, 99):.3e} "
          f"max {diff.max():.3e}; max|k-p| {max_abs:.3e}; two launches bit-equal: "
          f"{torch.equal(k_full, again)}")
    if not np.isfinite(diff).all() or np.percentile(diff, 99) > 2e-4:
        fail("kernel and plain version disagree at the main path's shape")
    if not torch.equal(k_full, again):
        fail("two B1 launches at N=262144 differ")
    del k_full, p_full, again

    # -- 4b. B1 and B2 at the smaller sizes, split over the source axis -----
    small_n = phase_small_n(dev, smi, mhz)

    # -- 5. the main path through the CLI -----------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "state.npz")
        argv = ["headless", "--sim", "naive", "--n", str(N_MAIN), "--steps", str(STEPS),
                "--energy-every", "5", "--checkpoint", ckpt]
        zero_launch_counts()
        out = run_cli(cli, argv)
        counts = launch_counts()
        launches, e1_naive_launches = counts["B1"], counts["E1"]
        plan = naive_cuda.LAST_PLAN  # the plan of the run's last launch
        # two energy lines (steps 5 and 10), each one E1 launch
        if counts != expected_counts(B1=STEPS, E1=2):
            fail(f"{STEPS} headless naive steps launched {counts}")
        energies = [float(x) for x in re.findall(r"total energy (\S+)", out)]
        if len(energies) != 2 or not np.isfinite(energies).all():
            fail(f"energies {energies}")
        us = float(re.search(r"mean: (\S+) us/step", out).group(1))
        ck = load_checkpoint(ckpt, dev)
        st = ck.state
        if ck.step != STEPS or not all(torch.isfinite(t).all() for t in st[:3]):
            fail("non-finite state or wrong step after the headless run")
        if not torch.equal(st.mass, torch.ones_like(st.mass)):
            fail("mass changed")
    print(f"5 headless naive N={N_MAIN}: {launches} launches in {STEPS} steps, "
          f"{us:.1f} us/step ({pairs / (us * 1e-6):.4e} pairs/s), energies {energies}; [{smi}]")

    # -- 6. NaiveSim steps, kernel vs plain (tests/test_naive.py tolerances) --
    p16 = SimParams(particle_num=16384, g=1e-5)
    gen = torch.Generator().manual_seed(4)
    s_k = s_p = NaiveSim(p16).init_state(gen, uniform_init, dev)
    step_k = NaiveSim(p16, NaiveParams(use_pallas=True)).make_step()
    step_p = NaiveSim(p16, NaiveParams(use_pallas=False)).make_step()
    for _ in range(3):
        s_k, s_p = step_k(s_k), step_p(s_p)
    torch.cuda.synchronize()
    torch.testing.assert_close(s_k.pos, s_p.pos, rtol=1e-5, atol=1e-8)
    torch.testing.assert_close(s_k.vel, s_p.vel, rtol=1e-4, atol=1e-8)
    print("6 NaiveSim N=16384 3 steps kernel vs plain: ok")
    b1 = {
        "name": "naive_forces",
        "route": "cuda",
        "source": "wgpu_n_body_tpu_torch/csrc/naive_forces.cu",
        "replaces": "wgpu_n_body_tpu/ops/naive_pallas.py:58",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms_k,
        "plain_ms": ms_p,
        **b1_bound,
        "library_ms": None,
        "library": NO_LIBRARY,
        "plan": plan_record(plan),
        "registers": regs_b1[0],
        "spill_store_bytes": regs_b1[1],
        "small_n": [r for r in small_n if r["kernel"] == "B1"],
    }
    del pn, po, m
    torch.cuda.empty_cache()

    # -- 7. the other kernels' builds (made in phase 2) ---------------------
    tree_ptxas = {}
    for key in ("B3", "B4", "B4 T", "B5", "K1", "B6", "B7", "B8", "E1"):
        lib, blog = built[key]
        print(f"7 {key} built -> {lib.name}")
        print_ptxas(blog)
        tree_ptxas[key] = ptxas_kernels(blog)
    for name, regs, stores, loads in tree_ptxas["B5"] + tree_ptxas["K1"]:
        short = re.search(r"(tree|morton)_[a-z]+_kernel|cub\w*?(Onesweep|Histogram)\w*?Kernel", name)
        print(f"7 ptxas {short.group(0) if short else name}: {regs} registers, "
              f"{stores} bytes spill stores, {loads} bytes spill loads")

    b2 = phase_b2(dev, smi, mhz)
    b2["registers"], b2["spill_store_bytes"] = regs_b2
    b2["small_n"] = [r for r in small_n if r["kernel"] == "B2"]
    b5 = phase_build(dev, smi, mhz)
    # registers and spills of each of B5's kernels, by entry function (empty
    # when the library was already built: no compiler output)
    short = [(re.search(r"tree_[a-z]+_kernel", name).group(0), regs, stores)
             for name, regs, stores, _ in tree_ptxas["B5"]]
    b5["registers"] = {name: regs for name, regs, _ in short}
    b5["spill_store_bytes"] = {name: stores for name, _, stores in short}
    k1, b5_main_input = phase_sort(dev, smi, mhz)
    b5.update(b5_main_input)
    for name, regs, stores, _ in tree_ptxas["K1"]:
        if "morton_keys_kernel" in name:
            k1["registers"], k1["spill_store_bytes"] = regs, stores
    b3 = phase_b3(dev, smi, mhz)
    per_particle = phase_tree_cli(dev, smi)
    b3["launches_per_particle_path"] = per_particle["B3"]
    b5["launches_per_particle_path"] = per_particle["B5"]
    k1["launches_per_particle_path"] = per_particle["K1"]
    b4t, b4 = phase_b4(dev, smi, mhz)
    b4["glue"] = phase_glue(dev, smi)
    main_path = phase_group_cli(dev, smi)
    b4["launches"], b4["launches_eval"] = main_path["B4"], main_path["B4 eval"]
    b4t["launches"] = main_path["B4 tiles"]
    for name, regs, stores, _ in tree_ptxas["B4 T"]:
        short = re.search(r"tile_[a-z]+_kernel", name)
        if short:
            b4t.setdefault("registers", {})[short.group(0)] = regs
            b4t.setdefault("spill_store_bytes", {})[short.group(0)] = stores
    b5["launches"], b5["reorder_launches"] = main_path["B5"], main_path["K2"]
    k1["launches"] = main_path["K1"]
    # this slice's main path: B3 is the whole force of the tree-host backend
    b3["launches"], host_record = phase_host(dev, smi, mhz)
    b3.update(host_record)

    b6 = phase_render(dev, smi, mhz)
    # registers and spills of each of B6's kernels (empty when already built)
    for key, col in (("registers", 1), ("spill_store_bytes", 2)):
        for row in tree_ptxas["B6"]:
            m = re.search(r"raster_tile_kernel|raster_kernelILb[01]E|blend_u8_kernel", row[0])
            if m:
                b6.setdefault(key, {})[m.group(0)] = row[col]

    b8, b7 = phase_let_kernel(dev, smi)
    for name, regs, stores, _ in tree_ptxas["B7"]:
        short = re.search(r"let_[a-z]+_kernel", name)
        if short:
            b7.setdefault("registers", {})[short.group(0)] = regs
            b7.setdefault("spill_store_bytes", {})[short.group(0)] = stores
    for name, regs, stores, _ in tree_ptxas["B8"]:
        if "import_forest_kernel" in name:
            b8["registers"], b8["spill_store_bytes"] = regs, stores
    b7["emulated_p4"] = phase_let_emulated(dev, smi)
    sharded = phase_sharded(dev, smi, b6)
    # the fused LET run of the one-rank group: one B8 per step
    b8["launches"] = sharded["tree let fused"]["counts"]["B8"]
    b8["emulated_p4"] = b7["emulated_p4"].pop("fused")
    # this slice's main path: one export per LET step of the one-rank group
    b7["launches"] = sharded["tree let"]["counts"]["B7"]
    b7["launches_emulated_p4"] = b7["emulated_p4"].pop("launches")
    b7["sharded_p1"] = sharded

    e1 = phase_energy(dev, smi, mhz, built["E1"][0])
    for name, regs, stores, _ in tree_ptxas["E1"]:
        short = re.search(r"energy_[a-z]*_?kernel(ILb[01]E)?", name)
        if short:
            e1.setdefault("registers", {})[short.group(0)] = regs
            e1.setdefault("spill_store_bytes", {})[short.group(0)] = stores
    runs = phase_energy_runs(dev, smi)
    # the main path: `cli headless --energy-every` at the defaults (20a)
    e1["launches"], e1["launches_naive_cli"] = runs.pop("launches"), e1_naive_launches
    e1.update(runs)
    phase_graph(dev, smi, args.repo)

    kernels = [b1, b2, b3, b4, b4t, b5, k1, b6, b7, b8, e1]
    for k in kernels:
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    print(f"chip_smoke elapsed {time.perf_counter() - t_start:.1f} s; [{smi}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
