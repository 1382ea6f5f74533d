"""turnaround_ms: device-idle ms per step outside ``runner.enqueue``: the
tail of the synchronise, the health read, the loop and the benchmark's
rewind, after the device finished the step's work."""

from nbody_bench.metrics._host import idle_split_ms


def read(ctx):
    split = idle_split_ms(ctx)
    return None if split is None else split[1]
