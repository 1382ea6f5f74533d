"""build_roofline: the sort and build's least time over ``build_ms``, in %.

The least time is the bytes K1, the sort, the reorder and the build must
move for the step's bodies and the reference octree's real nodes
(``peaks.build_bytes``) at the HBM rate."""

from nbody_bench.metrics._stages import BUILD, stage_ms
from nbody_bench.peaks import build_bound_ms


def read(ctx):
    build = stage_ms(ctx, BUILD)
    counts = ctx.get("counts")
    if not build or not counts:
        return None
    return 100.0 * build_bound_ms(ctx["n"], counts["nodes"]) / build
