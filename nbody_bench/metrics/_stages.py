"""Device ms per step of the program's profiler ranges, shared by the
readers of this folder: a device operation counts to a range when it was
launched while the range was open on the host (``traces.launched_in``), so
everything a range's nested ranges launch counts to it too."""

from nbody_bench.traces import launched_in

BUILD = ("morton_keys", "morton_sort", "tree_build")


def stage_ms(ctx, names) -> float | None:
    """Device ms per step of the kernels launched inside the ranges
    ``names``, or None when the trace holds none of them."""
    kernels = [e for n in names for e in launched_in(ctx["events"], n) if e.get("cat") == "kernel"]
    if not kernels or not ctx["steps"]:
        return None
    return sum(e["dur"] for e in kernels) / ctx["steps"] / 1e3
