"""Shared helpers of the port's on-card tooling: ``chip_smoke.py``, the
development studies (``utils/*_study.py``), ``utils/profile_step.py`` and
``utils/multi_gpu_check.py``. Each measurement convention is written once:

- the card: its name and power limit (``card``), written beside every timed
  line, and its maximum SM clock (``max_sm_clock_mhz``), which a bound
  assumes;
- time: CUDA events around calls queued back to back (``time_ms``: the
  host's enqueue shows when it is the longer), and each launch's device time
  from a ``torch.profiler`` window (``launch_split``, ``device_ms``);
- bounds: Hopper's special-function rate and the published float32 and HBM
  peaks (``bound``, ``sfu_bound_ms``);
- the compiler's reports: ptxas's registers and spills, SASS loops from
  ``cuobjdump``, and copies of a kernel source with other launch constants
  (``variant_source``);
- the scenes that the smoke and the studies share.

Nothing that a step, the CLI or the benchmark runs imports this module
(``nbody_bench/peaks.py`` keeps a frozen copy of the peaks, because the
benchmark imports nothing of the program). Most helpers need a CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from wgpu_n_body_tpu_torch.inits import disc_init, uniform_init
from wgpu_n_body_tpu_torch.models import TreeSim
from wgpu_n_body_tpu_torch.ops import raster
from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda
from wgpu_n_body_tpu_torch.ops.morton_cuda import morton_order_cuda
from wgpu_n_body_tpu_torch.ops.tree_build_cuda import build_tree_cuda
from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams
from wgpu_n_body_tpu_torch.parallel.sharded_tree import let_sort_build
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.runners.renderer import Camera

N_TREE = 4_000_000  # cli headless default (reference bin/headless.rs)
#: BASELINE config 4's per-rank size (N=32,000,000 over 8 ranks): the bodies
#: of one rank in the octant scenes
N_LOCAL = 4_000_000
#: cli visualize / serve defaults (reference bin/visualize.rs: TreeSim, disc)
#: and the steps the visualize scene takes
N_VIS, VIS_G, VIS_DT, VIS_STEPS = 100_000, 1e-5, 0.0016, 10
#: B6's per-thread box (``csrc/raster.cu`` kSmallBox): a footprint whose
#: clipped box is wider or higher goes to the tile kernel's list
RASTER_SMALL_BOX = 8
#: the flythrough camera moves forward until this many footprints leave the
#: per-thread box
FLY_LISTED = 1000
#: Hopper's special-function units: 16 results per SM per clock (rsqrt,
#: reciprocal); the published float32 rate outside the tensor cores and the
#: HBM rate of an H100 SXM (NVIDIA's H100 datasheet), at 700 W.
SFU_PER_SM_CLOCK = 16
FP32_PEAK = 67e12
HBM_PEAK = 3.35e12
PROFILER_TRIES = 5  # windows before an empty trace fails the run


# ------------------------------------------------------------------ the card

def smi(query: str) -> list[str]:
    """nvidia-smi's reading of ``query`` (``--query-gpu``), one line per card."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()


def card() -> str:
    """The first card's name and power limit, written beside every number."""
    return smi("name,power.limit")[0]


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock (``clocks.max.sm``): the clock a bound
    assumes."""
    out = smi("clocks.max.sm")
    try:
        return float(out[0].split()[0])
    except (IndexError, ValueError):
        raise SystemExit(f"nvidia-smi gave no maximum SM clock: {out}") from None


# ---------------------------------------------------------------------- time

def time_ms(fn, reps):
    """Mean ms of ``fn`` over ``reps`` calls after one warm call, by CUDA
    events; returns (ms, the warm call's result)."""
    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def profiler_events(prof) -> list:
    """The chrome trace events of a finished ``torch.profiler`` window."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def launches_of(trace_events, reps) -> dict:
    """{launch: (device ms per call, launches per call)} of a trace of
    ``reps`` calls, each launch named by its kernel (``..._kernel``) or
    "Memset". A launch's ms is the mean of its events times its launches per
    call (its events over ``reps``, to the nearest whole number, at least
    1): CUPTI drops an event now and then, often at a window's edge, which a
    sum over the window would read as a shorter call."""
    durs = {}
    for e in trace_events:
        if e.get("cat") in ("kernel", "gpu_memset"):
            m = re.search(r"\w+_kernel|Memset", e["name"])
            durs.setdefault(m.group(0) if m else e["name"][:60], []).append(e["dur"] / 1e3)
    out = {}
    for name, d in durs.items():
        per_call = max(1, round(len(d) / reps))
        out[name] = (sum(d) / len(d) * per_call, per_call)
    return out


def launch_split(fn, reps) -> dict:
    """``launches_of`` the kernels and memsets ``fn`` enqueues, from a
    ``torch.profiler`` window of ``reps`` calls. A window in which the
    profiler saw no device activity is taken again, up to ``PROFILER_TRIES``
    windows, each of twice the calls and after a pause (CUPTI loses a whole
    short window now and then: a window of 20 frames at N=4M is ~1.4 ms of
    device time)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(PROFILER_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps << attempt):
                fn()
            torch.cuda.synchronize()
        out = launches_of(profiler_events(prof), reps << attempt)
        if out:
            return out
        print(f"profiler window {attempt + 1} of {PROFILER_TRIES} saw no device activity; "
              "taking it again", file=sys.stderr, flush=True)
        time.sleep(1.0)
    raise SystemExit(f"the profiler saw no device activity in {PROFILER_TRIES} windows")


def device_ms(fn, reps):
    """(device ms per call of ``fn``, {kernel or memset: ms per call}, device
    ops per call) from a profiler window of ``reps`` calls after one warm
    call (``launch_split``), without the host's enqueue time between them."""
    fn()
    torch.cuda.synchronize()
    split = launch_split(fn, reps)
    parts = {k: ms for k, (ms, _) in split.items()}
    return sum(parts.values()), parts, sum(c for _, c in split.values())


def import_checkout(repo: str) -> None:
    """Make later imports of the package come from the checkout at ``repo``,
    for a study that times two checkouts in turns: the package's modules
    imported so far are dropped (what was taken from them stays this
    checkout's yardstick)."""
    repo = os.path.abspath(repo)
    if repo != str(Path(__file__).resolve().parents[2]):
        for name in [m for m in sys.modules if m.split(".")[0] == "wgpu_n_body_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, repo)
    import wgpu_n_body_tpu_torch

    if not wgpu_n_body_tpu_torch.__file__.startswith(os.path.join(repo, "")):
        raise SystemExit(f"imported {wgpu_n_body_tpu_torch.__file__}, not from {repo}")


# -------------------------------------------------------------------- bounds

def bound(count, mufu_each, flops_each, nbytes, mhz):
    """The least time the card could take: the larger of the special-function
    ops at 16 per SM per clock at ``mhz``, the float32 flops at the published
    peak and the bytes at the HBM rate, for ``count`` pairs (or
    interactions)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    times = {
        "SFU": count * mufu_each / (SFU_PER_SM_CLOCK * sms * mhz * 1e6) * 1e3,
        "FP32": count * flops_each / FP32_PEAK * 1e3,
        "HBM": nbytes / HBM_PEAK * 1e3,
    }
    unit = max(times, key=times.get)
    return {"bound_ms": times[unit], "bound_by": "bytes" if unit == "HBM" else "operations",
            "bound_unit": unit, "bound_count": count, "bound_fp32_ms": times["FP32"],
            "sm_mhz": mhz}


def sfu_bound_ms(pairs, mhz):
    """The special-function ops' time alone: two MUFU ops a pair."""
    return bound(pairs, 2, 0, 0, mhz)["bound_ms"]


# ------------------------------------------------------ the compiler's output

def print_ptxas(log: str) -> None:
    """Each kernel's registers, spills and memory from ``nvcc -Xptxas -v``."""
    if log == "cached":
        print("  ptxas: (library already built in this checkout: no compiler output)")
    for line in log.splitlines():
        if re.search(r"Compiling entry|registers|spill|smem|bytes stack", line):
            print(f"  ptxas: {line.strip()}")


def ptxas_kernels(log: str):
    """(entry function, registers, spill store bytes, spill load bytes) of
    each kernel in ``nvcc -Xptxas -v`` output."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return rows


def sass_all_loops(lib_path, name_part, sass_dir=None):
    """Every SASS loop (a backward branch and its target) of the kernels
    whose mangled name holds ``name_part``: (kernel, [(first address, last
    address, instructions, MUFU.RSQ, all MUFU), ...]) each, from
    ``cuobjdump -sass`` (the listing also goes to ``sass_dir``); none where
    the toolkit has no ``cuobjdump``."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return []
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


def sass_loops(lib_path, name_part, sass_dir=None):
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


def print_sass(label, lib_path, name_part, sass_dir=None):
    for name, n_ins, rsq, mufu in sass_loops(lib_path, name_part, sass_dir):
        print(f"{label} SASS {name[:60]}...: pair loop {n_ins} instructions, {rsq} MUFU.RSQ, "
              f"{mufu} MUFU: {n_ins / rsq:.2f} instructions and {mufu / rsq:.2f} MUFU per pair")


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


# -------------------------------------------------------------------- scenes

def sorted_scene(state, params, tp):
    """(sorted state, tree, keys, drifted positions) of one tree step, built
    as TreeSim builds it on the card (K1, CUB's sort, the kernels of B5)."""
    perm, bound_, keys = morton_order_cuda(state.pos, tp.max_depth)
    ss, tree = build_tree_cuda(state, perm, keys, bound_, tp)
    pos_new = ss.pos + (ss.vel + ss.acc * (params.dt / 2.0)) * params.dt  # the drift
    return ss, tree, keys, pos_new


def octant_boxes(p, dev):
    """(lo, hi) (p, 3): destination d is octant d % 8 of the global [-1, 1]^3
    cube, x lowest (octant 0, this rank's own, is [-1, 0]^3): the geometry
    of the JAX package's ``tools/measure_let.py --geometry octants``."""
    lo = torch.tensor([[-1.0 + (d & 1), -1.0 + ((d >> 1) & 1), -1.0 + ((d >> 2) & 1)]
                       for d in range(p)], dtype=torch.float32, device=dev)
    return lo, lo + 1.0


def octant_local(n, dev, tp, seed=0):
    """One rank's LET sort and build (``sharded_tree.let_sort_build``) of n
    bodies uniform in octant 0 of [-1, 1]^3 (mass 1, at rest), against the
    whole cube's bound 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.rand((n, 3), generator=gen, device=dev) - 1.0
    z = torch.zeros_like(pos)
    state = ParticleState(pos, z, z, torch.ones(n, device=dev))
    return let_sort_build(state, torch.ones(1, device=dev), SimParams(particle_num=n), tp)


def visualize_pos(dev):
    """The visualize scene: ``cli visualize``'s TreeSim N_VIS disc after
    VIS_STEPS steps."""
    params = SimParams(particle_num=N_VIS, g=VIS_G, dt=VIS_DT)
    runner = OfflineHeadless(TreeSim(params, TreeParams(theta=0.75)), disc_init, seed=0,
                             device=dev)
    for _ in range(VIS_STEPS):
        runner.step()
    return runner.state.pos


def flythrough_camera(pos):
    """(camera, moves): the default camera moved forward 0.2 at a time until
    at least FLY_LISTED footprints of ``pos`` pass the per-thread box (the
    plain boxes), after at most 12 moves."""
    cam = Camera(aspect=1.0)
    for moves in range(13):
        keep, cx, cy, sx, sy = raster.triangles(*raster.project(pos, cam.view_proj()), 400, 400)
        x0, x1, y0, y1 = raster.boxes(cx[keep], cy[keep], sx[keep], sy[keep], 400, 400)
        wide = (x1 >= x0) & (y1 >= y0) & (
            (x1 - x0 >= RASTER_SMALL_BOX) | (y1 - y0 >= RASTER_SMALL_BOX))
        if int(wide.sum()) >= FLY_LISTED:
            return cam, moves
        cam = cam.moved("forward", 0.2)
    raise SystemExit(f"12 moves forward leave fewer than {FLY_LISTED} footprints past the "
                     f"{RASTER_SMALL_BOX} x {RASTER_SMALL_BOX} box")


def headless_after_one_step(dev):
    """The N_TREE uniform ``cli headless`` state after one step: sorted in
    Morton order, as TreeSim hands the renderer every state after the
    first."""
    sim = OfflineHeadless(TreeSim(SimParams(particle_num=N_TREE), TreeParams()), uniform_init,
                          seed=0, device=dev)
    sim.step()
    return sim.state.pos
