"""walk_pairs_ratio: receiver-row pairs the group walk evaluated per
receiver (counters ``walk.pairs`` over ``walk.receivers``), over the
interactions the per-receiver θ-walk rule needs on the opening state
(``walk_roofline``'s count): the pairs evaluated per interaction the rule
asks for."""

from nbody_bench.metrics._host import walk_counters


def read(ctx):
    c = walk_counters(ctx)
    counts = ctx.get("counts")
    if c is None or "walk.pairs" not in c or not counts or not counts.get("interactions_mean"):
        return None
    return c["walk.pairs"] / c["walk.receivers"] / counts["interactions_mean"]
