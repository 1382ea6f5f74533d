"""eval_fill_pct: the share of the receiver-row pairs the group walk's
evaluation kernel computed that have a receiver (counters ``walk.pairs``
over ``walk.eval_pairs``), in %. The kernel computes whole blocks of 32
receivers, so a tile's last, partial block is the rest. A program whose
kernel does not count its pairs gives nothing."""

from nbody_bench.metrics._host import walk_counters


def read(ctx):
    c = walk_counters(ctx)
    if c is None or "walk.pairs" not in c or not c.get("walk.eval_pairs"):
        return None
    return 100.0 * c["walk.pairs"] / c["walk.eval_pairs"]
