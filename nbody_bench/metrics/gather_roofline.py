"""gather_roofline: the replicated step's gathers' least time over
``gather_ms``, in %.

The least time counts what the schedule needs, not what a gather moves:
each of P ranks must receive the remote (P - 1) / P of every body's
position and mass (16 bytes) and of its own sorted slice's half-kicked
velocity (12 bytes for each of its N / P receivers), at NVLink 4's rate per
direction on an H100 SXM5 (450 GB/s, half the 900 GB/s NVIDIA's data sheet
gives for both directions). At N=16M over four ranks: 228,000,000 bytes,
0.507 ms. Gathering whole velocities (every body's, 12 bytes) moves more,
so such a step reads at most 228 / 336 of it. Frozen here: the program
cannot move the yardstick."""

from nbody_bench.metrics._stages import stage_ms

#: NVLink 4 on an H100 SXM5, one direction: 18 links at 25 GB/s
NVLINK_BYTES_PER_S = 450e9
#: bytes a body's position and mass take, and a receiver's velocity
POS_MASS_BYTES, VEL_BYTES = 16, 12


def least_bytes(n: int, p: int) -> int:
    """Bytes each of ``p`` ranks must receive in one step of ``n`` bodies."""
    return (p - 1) * (POS_MASS_BYTES * n + VEL_BYTES * n // p) // p


def least_ms(n: int, p: int) -> float:
    return least_bytes(n, p) / NVLINK_BYTES_PER_S * 1e3


def read(ctx):
    if ctx.get("world", 1) < 2 or not ctx.get("n"):
        return None
    gather = stage_ms(ctx, ("rep_gather",))
    if not gather:
        return None
    return 100.0 * least_ms(ctx["n"], ctx["world"]) / gather
