"""idle_pct.step: the share of the traced window of whole steps in which no
device operation ran (rank 0's window in a sharded cell), in %."""


def read(ctx):
    if ctx["loop"] != "steps" or not ctx["window_us"]:
        return None
    return 100.0 * (1.0 - ctx["busy_us"] / ctx["window_us"])
