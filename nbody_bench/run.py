"""Run one cell of the benchmark and print its result as the last line.

    python3 nbody_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics
(``BENCHMARK.json`` ``end_to_end``), with ``--trace 1`` its per-layer ones,
each read by ``metrics/<name>.py`` from a profiler trace of a few whole
steps or ticks. Either way the run checks what the program produced
against the plain reference and prints each number compared beside its
limit, as the last lines of standard error and under ``checks``, the last
key of the result.

The run exits non-zero and prints no result without enough CUDA devices,
when a module of JAX or of the JAX package is loaded once the window has
closed, or on any error. A cell on several chips spawns one process per
further rank (``--rank``), which meet rank 0 through a file in a directory
of the temporary directory; rank 0 prints the result.

Options for the tests only: ``--device cpu`` skips the look for a card;
``--set key=value`` overrides a ``sim_params`` value (a smaller N);
``--control`` puts the reference in bfloat16 in the program's place;
``--plant <fault>`` breaks the timed path (``faults.py``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import datetime  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "nbody_bench":
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names that may not be loaded in the process that
#: prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "wgpu_n_body_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(prog="nbody_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--set", action="append", default=[], help=argparse.SUPPRESS)
    p.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--plant", default=None, help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--rendezvous", default="", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _spawn(args, world: int, rendezvous: str) -> list[subprocess.Popen]:
    """Ranks 1..world-1 as processes of this script; their standard output
    goes to this process's standard error."""
    argv = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
            "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace", str(args.trace),
            "--device", args.device, "--rendezvous", rendezvous]
    for s in args.set:
        argv += ["--set", s]
    if args.control:
        argv.append("--control")
    if args.plant:
        argv += ["--plant", args.plant]
    return [subprocess.Popen(argv + ["--rank", str(r)], stdout=sys.stderr, stdin=subprocess.DEVNULL)
            for r in range(1, world)]


def _result(cell, out, trace: bool, device_info: dict) -> dict:
    from nbody_bench.spec import metric_reader

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"])(out.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = dict(device_info, busy_s=out.ctx["busy_s_mean"], window_s=out.ctx["window_s"])
    else:
        for m in cell.end_to_end:
            if m["name"] in out.metrics:
                metrics[m["name"]] = {"value": out.metrics[m["name"]], "unit": m["unit"]}
    res = {"correct": out.checks.correct, "attempted": out.attempted, "failed": out.failed,
           "metrics": metrics, "device": device_info}
    if trace:
        from nbody_bench import traces

        res["breakdown"] = {"device_ops": traces.top_device_ops(out.ctx["events"]),
                            "idle_gaps": traces.idle_gaps(out.ctx["events"])}
    res["checks"] = out.checks.as_json()
    return res


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from nbody_bench import drive, spec

    cell = spec.find_cell(spec.load_benchmark(ROOT), args.workload)
    for s in args.set:
        key, value = s.split("=", 1)
        cell.config["sim_params"][key] = json.loads(value)
    world = cell.chips
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < world:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {world} CUDA devices; {n} visible", file=sys.stderr)
            return 2
        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    children, rdv_dir = [], None
    try:
        if world > 1:
            rendezvous = args.rendezvous
            if args.rank == 0:
                rdv_dir = tempfile.mkdtemp(prefix="nbody_bench_")
                rendezvous = os.path.join(rdv_dir, "rendezvous")
                children = _spawn(args, world, rendezvous)
            torch.distributed.init_process_group(
                "nccl" if device.type == "cuda" else "gloo",
                init_method=f"file://{rendezvous}", rank=args.rank, world_size=world,
                timeout=datetime.timedelta(seconds=300))
        rk = drive.Rank(args.rank, world, device)
        out = drive.LOOPS[cell.traffic["loop"]](cell, args.seed, args.seconds, bool(args.trace),
                                                rk, T_START, args.control, args.plant)
        if world > 1:
            torch.distributed.barrier()
            torch.distributed.destroy_process_group()
        if args.rank != 0:
            return 0
        from nbody_bench import peaks

        if out.ctx is not None:
            out.ctx.update(
                sms=torch.cuda.get_device_properties(device).multi_processor_count
                if device.type == "cuda" else 0,
                sm_mhz=float(peaks.smi("clocks.max.sm") or 0) if device.type == "cuda" else 0.0)
            print(f"card {peaks.smi('name')}, power limit {peaks.smi('power.limit')} W, max SM clock "
                  f"{out.ctx['sm_mhz']} MHz, {out.ctx['sms']} SMs", file=sys.stderr)
        device_info = {
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": world, "memory_peak_bytes": out.memory_peak}
        res = _result(cell, out, bool(args.trace), device_info)
        for child in children:
            if child.wait(timeout=300) != 0:
                print(f"rank process {child.args[-1]} exited {child.returncode}", file=sys.stderr)
                return 1
        children = []
        bad = forbidden_loaded()
        if bad:
            print(f"modules of {bad} are loaded in the process that prints the result",
                  file=sys.stderr)
            return 3
        for line in out.checks.lines():
            print(line, file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(res), flush=True)
        return 0
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
            child.wait()
        if rdv_dir:
            shutil.rmtree(rdv_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
