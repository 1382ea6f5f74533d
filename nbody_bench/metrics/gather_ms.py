"""gather_ms: rank 0's device ms per step of the kernels launched in the
range ``rep_gather`` (the replicated step's three all_gathers of position,
half-kicked velocity and mass), by ``_stages.stage_ms``. A program without
the range gives nothing."""

from nbody_bench.metrics._stages import stage_ms


def read(ctx):
    return stage_ms(ctx, ("rep_gather",))
