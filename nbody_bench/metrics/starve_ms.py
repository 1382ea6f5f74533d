"""starve_ms: device-idle ms per step while the host was inside
``runner.enqueue``: the device ran dry because the next launch was not
queued yet. With ``turnaround_ms`` it makes up the idle of ``idle_pct.step``."""

from nbody_bench.metrics._host import idle_split_ms


def read(ctx):
    split = idle_split_ms(ctx)
    return None if split is None else split[0]
