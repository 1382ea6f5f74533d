"""build_ms: device ms per step of the sort and build (the ranges
``morton_keys``, ``morton_sort`` and ``tree_build``)."""

from nbody_bench.metrics._stages import BUILD, stage_ms


def read(ctx):
    return stage_ms(ctx, BUILD)
