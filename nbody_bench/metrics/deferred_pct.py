"""deferred_pct: the share of the group walk's receivers sent down the
per-particle fallback walk (counters ``walk.deferred`` over
``walk.receivers``), in %."""

from nbody_bench.metrics._host import walk_counters


def read(ctx):
    c = walk_counters(ctx)
    if c is None or "walk.deferred" not in c:
        return None
    return 100.0 * c["walk.deferred"] / c["walk.receivers"]
