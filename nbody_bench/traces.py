"""The traced window: a ``torch.profiler`` trace of whole steps or ticks,
and the arithmetic the per-layer readers take from it.

Busy time is the union of device intervals, as in
``wgpu_n_body_tpu_torch/utils/profile_step.py::kernel_breakdown`` at commit
d60e59f. Device time is attributed to a profiler range by where its
operation was launched (``launched_in``), not by the device spans that
function reads: a device span covers only the kernels its range launched
itself, so a range's nested ranges would have to be listed by name. The
window is the span of the benchmark's ``bench.step`` ranges (one per step
or tick); device operations are kernels, copies and memsets; the ones
launched inside a ``bench.snapshot`` range (copies the benchmark makes for
its check) are dropped before anything is read.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

STEP_RANGE = "bench.step"
SNAPSHOT_RANGE = "bench.snapshot"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: a traced window that shows no device operation is taken again, this
#: many times in all, before the run fails
TRACE_ATTEMPTS = 3


def launched_in(trace_events, name: str) -> list[dict]:
    """The device operations launched while a host range ``name`` was
    open: by the launch's correlation id and its host time. An operation
    whose launch the trace lacks counts where it ran: inside the device
    span of ``name`` or of a range the host opened inside ``name``."""
    host = [(e["ts"], e["ts"] + e["dur"]) for e in trace_events
            if e.get("cat") == "user_annotation" and e.get("name") == name]
    if not host:
        return []
    launch = {e["args"]["correlation"]: e["ts"] for e in trace_events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    nested = {e["name"] for e in trace_events if e.get("cat") == "user_annotation"
              and any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in host)}
    spans = [e for e in trace_events
             if e.get("cat") == "gpu_user_annotation" and e.get("name") in nested]
    out = []
    for e in device_ops(trace_events):
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is not None:
            if any(a <= t < b for a, b in host):
                out.append(e)
        elif _inside(e, spans):
            out.append(e)
    return out


def _inside(e, spans) -> bool:
    return any(s["ts"] <= e["ts"] < s["ts"] + s["dur"] for s in spans)


def clean(trace_events):
    """The events without the device operations of the benchmark's own
    snapshots."""
    snaps = {id(e) for e in launched_in(trace_events, SNAPSHOT_RANGE)}
    return [e for e in trace_events if id(e) not in snaps]


def device_ops(trace_events):
    return [e for e in trace_events if e.get("cat") in DEVICE_CATS and e.get("dur", 0) > 0]


def window_us(trace_events) -> tuple[float, float]:
    """(start, end) µs of the benchmark's step or tick ranges on the host."""
    steps = [e for e in trace_events
             if e.get("cat") == "user_annotation" and e.get("name") == STEP_RANGE]
    if not steps:
        return 0.0, 0.0
    return min(e["ts"] for e in steps), max(e["ts"] + e["dur"] for e in steps)


def busy_us(trace_events, lo: float = float("-inf"), hi: float = float("inf")) -> float:
    """µs in which a device operation ran, inside [lo, hi]."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in device_ops(trace_events)):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def top_device_ops(trace_events, k: int = 10):
    """[[name, seconds]] of the device operations that took most time."""
    by = {}
    for e in device_ops(trace_events):
        by[e["name"]] = by.get(e["name"], 0.0) + e["dur"]
    return [[name, us / 1e6] for name, us in sorted(by.items(), key=lambda x: -x[1])[:k]]


def idle_gaps(trace_events, k: int = 10):
    """[[what the host was doing, seconds]]: the device's idle gaps inside
    the window, each labelled with the innermost host range or op open at
    its start, summed by label, the longest first."""
    lo, hi = window_us(trace_events)
    ops = sorted((e["ts"], e["ts"] + e["dur"]) for e in device_ops(trace_events))
    host = [e for e in trace_events
            if e.get("ph") == "X" and e.get("cat") in ("user_annotation", "cpu_op")]
    gaps, end = [], lo
    for a, b in ops:
        if a > end and a > lo:
            gaps.append((max(end, lo), min(a, hi)))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    by = {}
    for a, b in gaps:
        if b <= a:
            continue
        open_ = [e for e in host if e["ts"] <= a < e["ts"] + e["dur"]]
        label = min(open_, key=lambda e: e["dur"])["name"] if open_ else "(no host range)"
        by[label] = by.get(label, 0.0) + (b - a)
    return [[name, us / 1e6] for name, us in sorted(by.items(), key=lambda x: -x[1])[:k]]


def capture(window, log=print):
    """Run ``window()`` under ``torch.profiler`` and return its cleaned
    chrome-trace events; a window that shows no device operation inside
    its steps is taken again, up to ``TRACE_ATTEMPTS`` windows in all, each
    retry noted on standard error. RuntimeError after that many empty
    windows. The trace file is written under the temporary directory and
    removed."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with torch.profiler.profile(activities=acts) as prof:
            window()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = clean(json.load(f)["traceEvents"])
        finally:
            os.remove(path)
        lo, hi = window_us(events)
        if busy_us(events, lo, hi) > 0:
            return events
        print(f"traced window {attempt} of {TRACE_ATTEMPTS} shows no device operation; "
              "taking it again", file=sys.stderr)
    raise RuntimeError(f"{TRACE_ATTEMPTS} traced windows showed no device operation")
