"""walk_roofline: the tree force's least time over ``walk_ms``, in %.

The least time is the interactions the per-receiver θ-walk rule needs on
the opening state (the reference's octree, 4,096 sampled receivers, scaled
to this chip's receivers) at 2 MUFU results each, 16 per SM per clock at
the card's maximum SM clock. The count is the same whatever walk the
program runs."""

from nbody_bench.metrics._stages import stage_ms
from nbody_bench.peaks import walk_bound_ms


def read(ctx):
    walk = stage_ms(ctx, ("theta_walk",))
    counts = ctx.get("counts")
    if not walk or not counts or not ctx.get("sm_mhz"):
        return None
    interactions = counts["interactions_mean"] * ctx["receivers"]
    return 100.0 * walk_bound_ms(interactions, ctx["sms"], ctx["sm_mhz"]) / walk
