"""enqueue_ms: host ms per step inside the runner's ``runner.enqueue``
range: the host's cost to queue one step's launches."""

from nbody_bench.metrics._host import ENQUEUE, host_intervals


def read(ctx):
    if ctx["loop"] != "steps" or not ctx["steps"]:
        return None
    spans = host_intervals(ctx, ENQUEUE)
    if not spans:
        return None
    return sum(b - a for a, b in spans) / ctx["steps"] / 1e3
