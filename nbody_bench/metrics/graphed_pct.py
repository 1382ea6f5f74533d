"""graphed_pct: the share of a step window's steps that replayed captured
CUDA graphs (counters ``step.replayed`` over ``step.steps``, which the
program's graphed step counts per call), in %. A program that does not
count its steps gives nothing."""

from nbody_bench.metrics._host import program_counters


def read(ctx):
    if ctx["loop"] != "steps":
        return None
    c = program_counters()
    if not c.get("step.steps"):
        return None
    return 100.0 * c.get("step.replayed", 0) / c["step.steps"]
