"""render_device_ms: device ms per viewer tick of what the tick launched
outside the step (the host range ``tree_step``): the raster, the blend and
the copy of the frame to the host."""

from nbody_bench.traces import device_ops, launched_in


def read(ctx):
    if ctx["loop"] != "viewer" or not ctx["steps"]:
        return None
    step = {id(e) for e in launched_in(ctx["events"], "tree_step")}
    lo, hi = ctx["window"]
    us = sum(e["dur"] for e in device_ops(ctx["events"]) if lo <= e["ts"] < hi and id(e) not in step)
    return us / ctx["steps"] / 1e3 if us else None
