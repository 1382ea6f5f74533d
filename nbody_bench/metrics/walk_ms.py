"""walk_ms: device ms per step of the force walk (the range ``theta_walk``
with the group walk's tiles, lists, evaluation and fallback inside it)."""

from nbody_bench.metrics._stages import stage_ms


def read(ctx):
    return stage_ms(ctx, ("theta_walk",))
