"""pp_lane_fill_pct: the share of the per-particle walk's warp visits at
which a lane does its own work (counters ``walk.pp_live_visits`` over
``walk.pp_warp_visits``: per sampled receiver, the visits of its warp at
which it was live, over all the visits of its warp), in %. A warp walks the
union of its 32 receivers' walks, so the rest is the traversal a lane rides
along. A program that does not count its warps gives nothing."""

from nbody_bench.metrics._host import program_counters


def read(ctx):
    if ctx["loop"] != "steps":
        return None
    c = program_counters()
    if "walk.pp_live_visits" not in c or not c.get("walk.pp_warp_visits"):
        return None
    return 100.0 * c["walk.pp_live_visits"] / c["walk.pp_warp_visits"]
