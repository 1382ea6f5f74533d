"""integrate_ms: device ms per step of the leapfrog's eager operations (the
ranges ``leapfrog.drift`` and ``leapfrog.kick``)."""

from nbody_bench.metrics._stages import stage_ms


def read(ctx):
    return stage_ms(ctx, ("leapfrog.drift", "leapfrog.kick"))
