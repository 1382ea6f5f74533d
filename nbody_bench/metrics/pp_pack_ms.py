"""pp_pack_ms: device ms per step of the per-particle walk's pack (the range
``pp_pack``: the arena as B3's 32-byte records and the sources as rows of
position and mass * g * dt, before B3 walks every receiver)."""

from nbody_bench.metrics._stages import stage_ms


def read(ctx):
    return stage_ms(ctx, ("pp_pack",))
