"""Host spans and program counters, shared by the readers of this folder.

The spans are the runner's profiler ranges (``runner.enqueue``: the host
queueing a step's launches), on the trace's one clock with the device
operations. The counters are the program's own
(``wgpu_n_body_tpu_torch.utils.profiling.counters``): they add up only
while a profiler records, so in this process only over the traced windows,
retakes included; a reader of them returns a ratio of two.
"""

from __future__ import annotations

from nbody_bench.traces import device_ops

ENQUEUE = "runner.enqueue"


def _merge(intervals) -> list[tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _clipped(events, lo: float, hi: float) -> list[tuple[float, float]]:
    spans = ((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events)
    return _merge((a, b) for a, b in spans if b > a)


def host_intervals(ctx, name: str) -> list[tuple[float, float]]:
    """The union of the host range ``name``'s intervals inside the window,
    as (start, end) µs."""
    return _clipped([e for e in ctx["events"]
                     if e.get("cat") == "user_annotation" and e.get("name") == name],
                    *ctx["window"])


def idle_intervals(ctx) -> list[tuple[float, float]]:
    """The window's (start, end) µs in which no device operation ran: the
    gaps whose sum ``idle_pct.step`` reads (``traces.busy_us``)."""
    lo, hi = ctx["window"]
    gaps, at = [], lo
    for a, b in _clipped(device_ops(ctx["events"]), lo, hi):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < hi:
        gaps.append((at, hi))
    return gaps


def overlap_us(xs, ys) -> float:
    """µs that two sorted lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_split_ms(ctx) -> tuple[float, float] | None:
    """(starved, turnaround) device-idle ms per step of a step window: the
    idle µs inside ``runner.enqueue`` (the device waiting for the host to
    queue the step) and the rest (the sync's tail, the health read, the
    loop); None without that range."""
    if ctx["loop"] != "steps" or not ctx["steps"] or not ctx["window_us"]:
        return None
    enqueue = host_intervals(ctx, ENQUEUE)
    if not enqueue:
        return None
    starved = overlap_us(idle_intervals(ctx), enqueue)
    idle = ctx["window_us"] - ctx["busy_us"]
    return starved / ctx["steps"] / 1e3, (idle - starved) / ctx["steps"] / 1e3


def program_counters() -> dict[str, int]:
    """The program's counter totals, or {} for a program without them."""
    try:
        from wgpu_n_body_tpu_torch.utils import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "counters", None)
    return read() if read is not None else {}


def walk_counters(ctx) -> dict[str, int] | None:
    """The group walk's counters of a step window, or None where the
    program counted no receiver."""
    if ctx["loop"] != "steps":
        return None
    c = program_counters()
    if not c.get("walk.receivers"):
        return None
    return c
