"""The chip's peaks and the work a step must do, for the roofline shares.

Frozen from ``chip_smoke.py`` (``SFU_PER_SM_CLOCK``, ``HBM_PEAK``, ``bound``,
``stage_build_bytes``), ``ops/morton_cuda.py::key_bytes`` and
``ops/tree_build_cuda.py::{build_bytes, reorder_bytes}`` at commit d60e59f,
so that a change to the program cannot move the yardstick. Two changes from
those counts, both to count what the function needs and not what one
implementation chooses: the build writes the arena rows of the real nodes
(the reference's octree counts them) and not the whole capacity, and the
sort's least traffic (keys and index read once, sorted keys and
permutation written once) is added between K1 and the reorder.
"""

from __future__ import annotations

import subprocess

#: Hopper's special-function units: 16 results per SM per clock (rsqrt,
#: reciprocal). NVIDIA's H100 SXM data sheet, at 700 W.
SFU_PER_SM_CLOCK = 16
HBM_PEAK = 3.35e12
#: A softened pair term needs one rsqrt and one reciprocal (the divide by
#: r^3 + e): two special-function results per interaction.
MUFU_PER_INTERACTION = 2
#: One arena row: eight float32 and three int32.
ARENA_ROW_BYTES = 8 * 4 + 3 * 4


def smi(query: str) -> str:
    """One ``nvidia-smi --query-gpu`` reading of the first card, or ""."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def walk_bound_ms(interactions: float, sms: int, sm_mhz: float) -> float:
    """Least time for ``interactions`` pair terms at the MUFU rate."""
    return interactions * MUFU_PER_INTERACTION / (SFU_PER_SM_CLOCK * sms * sm_mhz * 1e6) * 1e3


def build_bytes(n: int, nodes: int) -> int:
    """Bytes one sort and build of ``n`` bodies into ``nodes`` real nodes
    must move: K1 (positions read; keys, index written), the sort (keys
    and index read, sorted keys and permutation written), the reorder
    (permutation, state and key read; sorted state and split and window
    levels written) and the build (keys, positions, masses read; the
    prefix sums written and read back; the real nodes' rows and the
    sentinel written), less what the build reads back of the reorder's
    work (24 bytes a body)."""
    keys = n * (12 + 8 + 4) + 12
    sort = n * (8 + 4) * 2
    reorder = n * (4 + 40 + 8 + 40 + 2)
    build = n * (8 + 3 * 4 + 4) + 4 + 2 * (n + 1) * (4 * 8 + 4) + (nodes + 1) * ARENA_ROW_BYTES + 9
    return keys + sort + reorder + build - 24 * n


def build_bound_ms(n: int, nodes: int) -> float:
    return build_bytes(n, nodes) / HBM_PEAK * 1e3
