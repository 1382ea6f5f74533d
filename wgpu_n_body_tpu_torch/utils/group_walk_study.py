"""Development measurements of the group walk kernels (B4) on a CUDA card.

    python -m wgpu_n_body_tpu_torch.utils.group_walk_study [--fused PATH] [--parent PATH]
        [--sweep] [--sass-dir DIR]

Prints, each timed line with the card's name and power limit:
- the SASS loops of the evaluation kernel that evaluate pairs: instructions
  and MUFU ops per pair, from ``cuobjdump -sass`` (listings to ``--sass-dir``);
- with ``--fused PATH``: the fused kernel the two kernels replaced (one CTA
  per tile, phase A walking while the CTA waits, then phase B), built from
  PATH, which must be the ``csrc/tree_walk_group.cu`` of commit e0dd89f
  (checked by its SHA-256; for example ``git show
  e0dd89f:wgpu_n_body_tpu_torch/csrc/tree_walk_group.cu > _parent/tree_walk_group.cu``,
  a git-ignored directory). It is timed in turns with the new kernels
  (fused, new, new, fused) at N=4M uniform and N=262144 disc walk_tile 256,
  each beside the SFU bound of its pairs at the card's maximum SM clock;
  then a copy with clock probes at its phase boundaries gives each phase's
  share of the tiles' cycles, the per-tile spread and when the last tile
  ends, and its pair loop's SASS;
- with ``--parent PATH``: the evaluation kernel that ran every 32-receiver
  block of a tile whether it held a receiver or not, built from PATH, which
  must be the ``csrc/tree_walk_group.cu`` of commit f773a9b (checked by its
  SHA-256; ``git show f773a9b:wgpu_n_body_tpu_torch/csrc/tree_walk_group.cu
  > _parent/tree_walk_group.cu``). On the same lists and table it is timed
  in turns with this evaluation kernel (parent, new, new, parent, twice) at
  N=4M uniform and disc as the benchmark draws them, N=2M disc theta=0.5
  walk_tile 256, N=100k disc (the viewer's), a slice of sorted receivers
  (gid_offset > 0) and an import walk (receivers past the sources); each
  output is held bit for bit (``torch.equal``) to the parent's, the
  kernel's pair counter to ``tree_walk_group.eval_pairs``, and each time
  printed beside the SFU bound of the pairs with a receiver and of the
  pairs each kernel computes;
- with ``--sweep``: the new kernels rebuilt from copies of their source with
  other values of the launch constants (``kMinBlocks``, ``kStages``,
  ``kChunk``, ``kUnroll``, ``kWalkWarps``), each timed at N=4M uniform
  theta=0.75 and N=2M disc theta=0.5 with the source as built first and
  last, and the walk kernel over all, half and a quarter of the N=4M tiles.
Builds go to the git-ignored ``_build/``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from wgpu_n_body_tpu_torch.inits import disc_init, uniform_init
from wgpu_n_body_tpu_torch.ops import cuda_build
from wgpu_n_body_tpu_torch.ops import tree_walk_group as twg
from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda
from wgpu_n_body_tpu_torch.ops.tree_build import build_tree, morton_sort
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams

N_TREE = 4_000_000
N_DISC = 262144
SFU_PER_SM_CLOCK = 16
#: SHA-256 of the fused kernel's source (csrc/tree_walk_group.cu at e0dd89f),
#: which the probe edits below are written against.
FUSED_SHA256 = "c242dc5c1127c1314247459ee1d056c3e853ee4d28deacbd86aef8e099f32ab2"
#: SHA-256 of csrc/tree_walk_group.cu at f773a9b, whose evaluation kernel
#: sums the list for every register slot of a tile, live or not.
PARENT_SHA256 = "be9706f9e0123226e2e996bfce7519b63888128df42b7f9b90b47ec313949b73"
#: the benchmark's step cells (nbody_bench/configs/tree-headless-4m.json,
#: nbody_bench/traffic/steps-*.json): g, e, dt and the disc's scene_seed
BENCH_PARAMS = dict(g=1e-6, e=1e-4, dt=0.016)
BENCH_DISC_SEED = 20261018

# Clock probes spliced into the fused kernel at its phase boundaries: per
# tile, warp 0's phase-A cycles, warp 1's cycles from the loop's top to the
# end of the barrier behind phase A, thread 0's phase-B cycles, the tile's
# total cycles, its start and end on the global timer, its SM, and warp 1's
# cycles outside its own phase B.
PROBE_ROWS = 65536
PROBE_EDITS = (
    ("constexpr unsigned kFull = 0xffffffffu;\n",
     "constexpr unsigned kFull = 0xffffffffu;\n"
     f"__device__ long long g_probe[{PROBE_ROWS}][8];\n"
     "__device__ __forceinline__ long long pr_clock() {\n"
     "  long long c;\n"
     "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(c) :: \"memory\");\n"
     "  return c;\n"
     "}\n"),
    ("  const int p0 = piece_start[t];\n",
     "  const int p0 = piece_start[t];\n"
     "  const long long pr_t0 = pr_clock();\n"
     "  long long pr_g0, pr_a = 0, pr_w = 0, pr_b = 0;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pr_g0));\n"),
    ("  while (true) {\n    if (warp == 0) {\n",
     "  while (true) {\n    const long long pr_a0 = pr_clock();\n    if (warp == 0) {\n"),
    ("    __syncthreads();\n    const int nr = s_nrows;\n",
     "    const long long pr_w0 = pr_clock();\n"
     "    __syncthreads();\n"
     "    const long long pr_w1 = pr_clock();\n"
     "    if (warp == 0) pr_a += pr_w0 - pr_a0; else pr_w += pr_w1 - pr_a0;\n"
     "    const int nr = s_nrows;\n"),
    ("    __syncthreads();  // the list is refilled next\n",
     "    pr_b += pr_clock() - pr_w1;\n    __syncthreads();  // the list is refilled next\n"),
    ("  if (tid == 0) {\n    tile_bad[t] = bad ? 1 : 0;\n",
     "  if (t < " + str(PROBE_ROWS) + " && (tid == 0 || tid == 32)) {\n"
     "    long long g1;\n"
     "    unsigned sm;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
     "    asm(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "    if (tid == 32) {\n"
     "      g_probe[t][1] = pr_w; g_probe[t][7] = pr_clock() - pr_t0 - pr_b;\n"
     "    } else {\n"
     "      g_probe[t][0] = pr_a; g_probe[t][2] = pr_b; g_probe[t][3] = pr_clock() - pr_t0;\n"
     "      g_probe[t][4] = pr_g0; g_probe[t][5] = g1; g_probe[t][6] = sm;\n"
     "    }\n"
     "  }\n"
     "  if (tid == 0) {\n    tile_bad[t] = bad ? 1 : 0;\n"),
)
PROBE_READ = """
extern "C" int group_walk_probe_read(void* dst, int bytes) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_probe, bytes, 0, cudaMemcpyDeviceToDevice));
}
"""

#: Launch-shape variants of the sweep; {} is the source as it stands.
SWEEP = ([{}] + [{"kStages": st, "kMinBlocks": mb} for st in (2, 3, 4) for mb in (4, 5, 6)]
         + [{"kChunk": c} for c in (128, 512)] + [{"kUnroll": u} for u in (2, 4, 32)]
         + [{"kWalkWarps": w} for w in (2, 8)] + [{}])


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps):
    """Mean ms of ``fn`` over ``reps`` calls after one warm call (CUDA
    events); returns (ms, the warm call's result)."""
    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def scene(init, n, tp, dev):
    """(sorted state, tree, tiles, drifted positions, params) of one step."""
    params = SimParams(particle_num=n)
    ss, bound, keys = morton_sort(init(torch.Generator().manual_seed(0), params, dev),
                                  tp.max_depth)
    tree = build_tree(ss, keys, bound, tp)
    pos_new = ss.pos + (ss.vel + ss.acc * (params.dt / 2.0)) * params.dt
    return ss, tree, twg.tile_setup(keys, n, tp), pos_new, params


def sfu_bound_ms(pairs, mhz):
    """Two MUFU ops per receiver-row pair at 16 per SM per clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 2 * pairs / (SFU_PER_SM_CLOCK * sms * mhz * 1e6) * 1e3


def pairs_of(tiles, bad, rows):
    nt = int((tiles.piece_len > 0).sum())
    fin = ~bad[:nt]
    return float((rows[:nt][fin].double() * tiles.piece_len[:nt][fin].double()).sum())


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


def sass_all_loops(lib_path, name_part, sass_dir):
    """Every SASS loop (a backward branch and its target) of the kernels
    whose mangled name holds ``name_part``: (kernel, [(first address, last
    address, instructions, MUFU.RSQ, all MUFU), ...]) each, from
    ``cuobjdump -sass`` (the listing also goes to ``sass_dir``)."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
        Path(sass_dir, Path(lib_path).name + ".sass").write_text(text)
    found = []
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        if name_part not in name:
            continue
        labels, ins, branches, pending = {}, [], [], []
        for line in part.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if not m:
                continue
            addr, op = int(m.group(1), 16), m.group(2)
            labels.update((lab_name, addr) for lab_name in pending)
            pending = []
            ins.append((addr, op))
            b = re.search(r"\bBRA\s+(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))", op)
            if b:
                branches.append((addr, b.group(1) or int(b.group(2), 16)))
        loops = []
        for addr, target in branches:
            target = labels.get(target) if isinstance(target, str) else target
            if target is not None and target <= addr:
                body = [op for a, op in ins if target <= a <= addr]
                loops.append((target, addr, len(body), sum("MUFU.RSQ" in op for op in body),
                              sum("MUFU" in op for op in body)))
        found.append((name, loops))
    return found


def sass_loops(lib_path, name_part, sass_dir):
    """Innermost SASS loops that evaluate pairs (hold MUFU.RSQ) in the
    kernels whose mangled name holds ``name_part``: (kernel, instructions,
    MUFU.RSQ, all MUFU) each. One MUFU.RSQ per pair, so instructions per
    pair is the ratio."""
    found = []
    for name, loops in sass_all_loops(lib_path, name_part, sass_dir):
        for lo, hi, n_ins, rsq, mufu in loops:
            inner = [x for x in loops if x[4] and lo <= x[0] and x[1] <= hi and x[:2] != (lo, hi)]
            if rsq and not inner:
                found.append((name, n_ins, rsq, mufu))
    return sorted(found, key=lambda x: -x[2])


def print_sass(label, lib_path, name_part, sass_dir):
    for name, n_ins, rsq, mufu in sass_loops(lib_path, name_part, sass_dir):
        print(f"{label} SASS {name[:60]}...: pair loop {n_ins} instructions, {rsq} MUFU.RSQ, "
              f"{mufu} MUFU: {n_ins / rsq:.2f} instructions and {mufu / rsq:.2f} MUFU per pair")


class FusedKernel:
    """The fused group-walk kernel the two kernels replaced, built from its
    source with the port's flags; ``probed`` splices in the clock probes."""

    def __init__(self, source: Path, probed: bool):
        if hashlib.sha256(source.read_bytes()).hexdigest() != FUSED_SHA256:
            raise SystemExit(f"{source} is not csrc/tree_walk_group.cu of commit e0dd89f")
        if probed:
            text = source.read_text()
            for old, new in PROBE_EDITS:
                text = text.replace(old, new)
            source = gcuda.BUILD_DIR / "tree_walk_group_fused_probed.cu"
            source.parent.mkdir(parents=True, exist_ok=True)
            source.write_text(text + PROBE_READ)
        self.lib_path, self.log = cuda_build.compile_cu(
            source, gcuda.BUILD_DIR / "fused", list(cuda_build.BASE_FLAGS))
        self.lib = ctypes.CDLL(str(self.lib_path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.lib.tree_walk_group_launch.argtypes = [p] * 13 + [i] * 4 + [f] * 3 + [i, p]
        self.lib.tree_walk_group_launch.restype = i
        if probed:
            self.lib.group_walk_probe_read.argtypes = [p, i]
            self.lib.group_walk_probe_read.restype = i

    def __call__(self, pos_new, src_pos, src_mass, tree, tiles, params, tp):
        dev = pos_new.device
        out = torch.empty((pos_new.shape[0], 3), dtype=torch.float32, device=dev)
        per_tile = torch.empty((3, tiles.t_cap), dtype=torch.int32, device=dev)
        src = torch.cat([src_pos, src_mass[:, None]], 1)
        err = self.lib.tree_walk_group_launch(
            pos_new.data_ptr(), src.data_ptr(), tree.nodes_f32.data_ptr(), tree.skip.data_ptr(),
            tree.first.data_ptr(), tree.count.data_ptr(), tree.num_nodes.data_ptr(),
            tiles.piece_start.data_ptr(), tiles.piece_len.data_ptr(), out.data_ptr(),
            per_tile[0].data_ptr(), per_tile[1].data_ptr(), per_tile[2].data_ptr(),
            tiles.t_cap, tiles.g, tiles.r_cap, 0, float(tp.theta), float(params.g * params.dt),
            float(params.e), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"the fused kernel did not launch: cudaError_t {err}")
        return out, per_tile[0] != 0, per_tile[1], per_tile[2]

    def probes(self, rows, dev):
        buf = torch.empty((PROBE_ROWS, 8), dtype=torch.int64, device=dev)
        err = self.lib.group_walk_probe_read(buf.data_ptr(), buf.numel() * 8)
        if err != 0:
            raise RuntimeError(f"reading the probes failed: cudaError_t {err}")
        return buf[:rows].cpu().numpy()


def study_fused(path, dev, smi, mhz, sass_dir):
    """The fused kernel beside the new ones, and its probed phase split."""
    old, probed = FusedKernel(path, False), FusedKernel(path, True)
    print_sass("fused", old.lib_path, "group_walk_kernel", sass_dir)
    for label, n, init, g_tile in (("uniform", N_TREE, uniform_init, None),
                                   ("disc", N_DISC, disc_init, 256)):
        tp = TreeParams(walk_tile=g_tile)
        ss, tree, tiles, pos_new, params = scene(init, n, tp, dev)
        args = (pos_new, ss.pos, ss.mass, tree, tiles, params, tp)
        ms = {"fused": [], "new": []}
        for who in ("fused", "new", "new", "fused"):
            fn = old if who == "fused" else gcuda.group_walk_tiles_cuda
            ms[who].append(time_ms(lambda: fn(*args), 5)[0])
        o_acc, o_bad, o_steps, _ = old(*args)
        n_acc, n_bad, n_steps, n_rows = gcuda.group_walk_tiles_cuda(*args)
        if not (torch.equal(o_bad, n_bad) and torch.equal(o_steps, n_steps)):
            raise SystemExit(f"{label}: the fused and the new kernels defer or step differently")
        good = ~(tiles.deferred | n_bad[tiles.tile_id])
        d = (n_acc[good] - o_acc[good]).double().norm(dim=1) / o_acc[good].double().norm(dim=1)
        b = sfu_bound_ms(pairs_of(tiles, n_bad, n_rows), mhz)
        mo, mn = float(np.mean(ms["fused"])), float(np.mean(ms["new"]))
        print(f"{label} N={n} walk_tile {tiles.g}, in turns fused/new/new/fused: fused "
              f"{ms['fused'][0]:.3f} / {ms['fused'][1]:.3f} ms, new {ms['new'][0]:.3f} / "
              f"{ms['new'][1]:.3f} ms; SFU bound {b:.3f} ms at {mhz:.0f} MHz: fused at "
              f"{b / mo:.2%}, new at {b / mn:.2%}; forces new vs fused per-row p99 "
              f"{float(torch.quantile(d, 0.99)):.3e}; [{smi}]")

        nt = int((tiles.piece_len > 0).sum())
        ms_probed, (_, _, _, rows) = time_ms(lambda: probed(*args), 3)
        pr = probed.probes(nt, dev).astype(np.float64)
        a, w, b_, tot = pr[:, 0].sum(), pr[:, 1].sum(), pr[:, 2].sum(), pr[:, 3].sum()
        ends, cyc = pr[:, 5] - pr[:, 4].min(), pr[:, 3]
        print(f"fused probed {label} N={n} walk_tile {tiles.g}: {nt} tiles, {ms_probed:.3f} ms; "
              f"warp 0 in phase A {a / tot:.2%} of the tiles' cycles, phase B {b_ / tot:.2%}; "
              f"warp 1 at the barrier behind phase A {w / tot:.2%}, outside its phase B "
              f"{pr[:, 7].sum() / tot:.2%}; per-tile cycles mean {cyc.mean():.0f} p50 "
              f"{np.percentile(cyc, 50):.0f} p99 {np.percentile(cyc, 99):.0f} max "
              f"{cyc.max():.0f}; list rows per tile mean {float(rows[:nt].float().mean()):.1f}; "
              f"tile ends: mean {ends.mean() / 1e6:.3f} ms, last {ends.max() / 1e6:.3f} ms after "
              f"the first start; [{smi}]")
        del ss, tree, tiles, pos_new, args, o_acc, n_acc
        torch.cuda.empty_cache()


class ParentEval:
    """The evaluation kernel of f773a9b (every slot of a tile summed, block k
    on warp k % 4), built from its source with the port's flags."""

    def __init__(self, source: Path):
        if hashlib.sha256(source.read_bytes()).hexdigest() != PARENT_SHA256:
            raise SystemExit(f"{source} is not csrc/tree_walk_group.cu of commit f773a9b")
        self.lib_path, self.log = cuda_build.compile_cu(
            source, gcuda.BUILD_DIR / "parent", gcuda.NVCC_FLAGS)
        self.lib = ctypes.CDLL(str(self.lib_path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.lib.group_eval_launch.argtypes = [p, p, p, p, i, p, p, p, p, p, i, i, i, f, i, p]
        self.lib.group_eval_launch.restype = i

    def __call__(self, pos_new, tree, tiles, lists, table, e, gid_offset):
        dev = pos_new.device
        out = torch.empty((pos_new.shape[0], 3), dtype=torch.float32, device=dev)
        skip = (lists.bad | lists.pool_full).to(torch.int32)
        cap = tree.nodes_f32.shape[0] - 1
        err = self.lib.group_eval_launch(
            pos_new.data_ptr(), table.data_ptr(), lists.ids.data_ptr(), lists.chunks.data_ptr(),
            lists.chunks.shape[1], lists.rows.data_ptr(), skip.data_ptr(),
            tiles.piece_start.data_ptr(), tiles.piece_len.data_ptr(), out.data_ptr(), tiles.t_cap,
            tiles.g, cap + 1 + gid_offset, float(e), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent evaluation kernel did not launch: cudaError_t {err}")
        return out


def bench_scene(kind, n, tp, dev):
    """scene() of the benchmark's draw of ``kind`` (``nbody_bench/scenes.py``;
    the disc from its scene_seed, in the order seed 1 gives)."""
    from nbody_bench import scenes
    from wgpu_n_body_tpu_torch.params import ParticleState

    params = SimParams(particle_num=n, **BENCH_PARAMS)
    state = ParticleState(*scenes.draw(kind, 1, n, params.g, dev,
                                       scene_seed=BENCH_DISC_SEED if kind == "disc" else None))
    ss, bound, keys = morton_sort(state, tp.max_depth)
    tree = build_tree(ss, keys, bound, tp)
    pos_new = ss.pos + (ss.vel + ss.acc * (params.dt / 2.0)) * params.dt
    return ss, tree, twg.tile_setup(keys, n, tp), pos_new, params


def held_eval(label, parent, mhz, smi, pos_new, src_pos, src_mass, tree, tiles, params, tp,
              gid_offset=0):
    """Time the parent's evaluation kernel and this one in turns on one set
    of lists; their outputs must be equal bit for bit on every receiver the
    evaluation writes, and the counter must equal ``eval_pairs``."""
    lists = gcuda.group_walk_lists_cuda(pos_new, tree, tiles, tp)
    table = twg.source_table(tree, src_pos, src_mass, params.g * params.dt)
    skip = lists.bad | lists.pool_full
    written = ~(tiles.deferred | skip[tiles.tile_id])

    def new(pairs=None):
        return gcuda.group_eval_lists_cuda(pos_new, src_pos, src_mass, tree, tiles, lists, params,
                                           gid_offset, table, pairs)

    def old():
        return parent(pos_new, tree, tiles, lists, table, params.e, gid_offset)

    ms = {"parent": [], "new": []}
    for who in ("parent", "new", "new", "parent") * 2:
        ms[who].append(time_ms(old if who == "parent" else new, 10)[0])
    counted = torch.zeros((), dtype=torch.int64, device=pos_new.device)
    a_new, a_old = new(counted), old()
    equal = torch.equal(a_new[written], a_old[written])
    want = int(twg.eval_pairs(tiles, lists))
    nt = int((tiles.piece_len > 0).sum())
    fin = ~skip[:nt]
    rows = lists.rows[:nt][fin].double()
    length = torch.clamp(tiles.piece_len[:nt][fin], max=tiles.g).double()
    real = float((rows * length).sum())
    per = 1 << max(0, (tiles.g - 1).bit_length() - 7)  # slots a thread: 128 PER >= g
    parent_pairs = float(rows.sum()) * 128 * per
    partial = int((length < tiles.g).sum())
    mo, mn = float(np.median(ms["parent"])), float(np.median(ms["new"]))
    b_real, b_old, b_new = (sfu_bound_ms(x, mhz) for x in (real, parent_pairs, want))
    print(f"eval {label}: walk_tile {tiles.g} (PER {per}), {nt} tiles ({partial} partial), "
          f"gid_offset {gid_offset}; in turns parent/new/new/parent x2: parent "
          + " ".join(f"{x:.4f}" for x in ms["parent"]) + " ms, new "
          + " ".join(f"{x:.4f}" for x in ms["new"]) + f" ms (medians {mo:.4f} -> {mn:.4f}, "
          f"{mn / mo - 1:+.2%}); pairs with a receiver {real:.4e}, computed parent "
          f"{parent_pairs:.4e} ({real / parent_pairs:.2%} filled), new {want:.4e} "
          f"({real / max(want, 1):.2%}); SFU bound of the real pairs {b_real:.4f} ms: parent "
          f"{b_real / mo:.2%}, new {b_real / mn:.2%}; of the computed pairs: parent "
          f"{b_old / mo:.2%}, new {b_new / mn:.2%}; outputs bit-equal on "
          f"{int(written.sum())} receivers: {equal}; counter {int(counted)} == {want}: "
          f"{int(counted) == want}; [{smi}]", flush=True)
    if not equal or int(counted) != want or not torch.isfinite(a_new[written]).all():
        raise SystemExit(f"eval {label}: the evaluation differs from the parent's or miscounts")
    return mo, mn


def study_parent(path, dev, smi, mhz):
    """The parent's evaluation kernel against this one, in turns, at the
    shapes its change touches."""
    parent = ParentEval(path)
    print("\n".join(f"parent ptxas: {x.strip()}" for x in parent.log.splitlines()
                    if re.search(r"registers|spill", x)))
    from wgpu_n_body_tpu_torch.inits import disc_init

    shapes = (("uniform 4M (bench)", lambda tp: bench_scene("uniform", N_TREE, tp, dev),
               TreeParams()),
              ("disc 4M (bench)", lambda tp: bench_scene("disc", N_TREE, tp, dev), TreeParams()),
              ("disc 2M theta=0.5", lambda tp: scene(disc_init, 2_000_000, tp, dev),
               TreeParams(theta=0.5, walk_tile=256)),
              ("disc 100k (viewer)", lambda tp: scene(disc_init, 100_000, tp, dev),
               TreeParams()))
    for label, make, tp in shapes:
        ss, tree, tiles, pos_new, params = make(tp)
        held_eval(label, parent, mhz, smi, pos_new, ss.pos, ss.mass, tree, tiles, params, tp)
        del ss, tree, tiles, pos_new
        torch.cuda.empty_cache()
    # receivers that are a later slice of the sources (the replicated
    # schedule's), and receivers past the sources (the LET import walk's)
    tp = TreeParams()
    ss, tree, tiles, pos_new, params = scene(disc_init, N_DISC, tp, dev)
    g0, n1 = N_DISC // 4, N_DISC // 2
    keys = morton_sort(ss, tp.max_depth)[2]
    sub = twg.tile_setup(keys[g0:g0 + n1], n1, tp)
    held_eval("disc 262144, receivers [65536, 196608)", parent, mhz, smi, pos_new[g0:g0 + n1],
              ss.pos, ss.mass, tree, sub, params, tp, gid_offset=g0)
    other, _, o_tiles, o_new, _ = scene(uniform_init, n1, tp, dev)  # no body is a source
    held_eval(f"import walk: {n1} receivers over a {N_DISC}-body tree", parent, mhz, smi,
              o_new, ss.pos, ss.mass, tree, o_tiles, params, tp, gid_offset=N_DISC)
    del ss, tree, tiles, pos_new, other, o_tiles, o_new
    torch.cuda.empty_cache()


def variant_source(overrides: dict, source: Path | None = None) -> Path:
    """A copy of a kernel source (the group walk's by default) with other
    values of its launch constants (each ``constexpr int kName = value;``
    found exactly once), in the build directory; the headers it includes
    stay on nvcc's include path (``cuda_build.CSRC``)."""
    source = gcuda.SOURCE if source is None else source
    if not overrides:
        return source
    text = source.read_text()
    for name, value in overrides.items():
        text, k = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
        if k != 1:
            raise SystemExit(f"{source.name} defines {name} {k} times, not once")
    tag = "_".join(f"{k}{v}" for k, v in overrides.items())
    path = gcuda.BUILD_DIR / f"{source.stem}_{tag}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def sweep(dev, smi):
    """The new kernels' launch constants on BASELINE's two tree configs:
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
            regs = re.findall(r"Used (\d+) registers", log)
            spills = re.findall(r"(\d+) bytes spill stores", log)
            print(f"sweep {var or 'as built'}: {'; '.join(times)}; registers {regs}, spill "
                  f"stores {spills}; [{smi}]")
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
    parser.add_argument("--fused", type=Path, help="source of the fused kernel (e0dd89f)")
    parser.add_argument("--parent", type=Path, help="tree_walk_group.cu of f773a9b")
    parser.add_argument("--sweep", action="store_true", help="sweep the launch constants")
    parser.add_argument("--sass-dir", help="write the SASS listings here")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("group_walk_study needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = _smi("name,power.limit")
    mhz = float(_smi("clocks.max.sm"))
    print(f"{smi}; maximum SM clock {mhz:.0f} MHz")
    lib, log = gcuda.build()
    print("\n".join(f"ptxas: {x.strip()}" for x in log.splitlines()
                    if re.search(r"registers|spill", x)))
    print_sass("new", lib, "group_eval_kernel", args.sass_dir)
    if args.parent:
        study_parent(args.parent, dev, smi, mhz)
    if args.fused:
        study_fused(args.fused, dev, smi, mhz, args.sass_dir)
    if args.sweep:
        sweep(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
