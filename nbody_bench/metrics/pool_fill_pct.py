"""pool_fill_pct: the share of the group walk's list pool its lists took
(counters ``walk.pool_chunks`` over ``walk.pool_cap``, the chunks taken
over the chunks the pool holds, summed over the traced steps), in %. A
full pool defers whole tiles to the per-particle walk, so this is the
room left before ``deferred_pct`` rises. A program that does not count
its pool gives nothing."""

from nbody_bench.metrics._host import walk_counters


def read(ctx):
    c = walk_counters(ctx)
    if c is None or "walk.pool_chunks" not in c or not c.get("walk.pool_cap"):
        return None
    return 100.0 * c["walk.pool_chunks"] / c["walk.pool_cap"]
