"""idle_pct.frame: the share of the traced window of whole viewer ticks in
which no device operation ran, in %."""


def read(ctx):
    if ctx["loop"] != "viewer" or not ctx["window_us"]:
        return None
    return 100.0 * (1.0 - ctx["busy_us"] / ctx["window_us"])
