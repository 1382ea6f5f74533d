"""Prefix scans of the octree build — counterpart of
``wgpu_n_body_tpu/ops/scan.py``.

The JAX package blocks its scans by hand because XLA's associative scan
was slow on the TPU; torch's ``cummax``/``cummin``/``cumsum`` are native
scans, so the port calls them directly. Only a 1-D ``cumsum`` is a
device-wide scan on the GPU: a scan along one axis of a 2-D tensor, and
every ``cummax``/``cummin``, runs as one thread block per row (or one
thread per column), which measured 1.02 s for a float64 (4M, 4) cumsum
along axis 0 on an H100. So ``ff_cumsum_ext`` scans column by column,
and the octree build uses cumsums instead of ``cummax_last`` and
``cummin_last`` (kept for the JAX package's API).

``ff_cumsum_ext`` keeps the JAX contract — (hi, lo) float32 prefix sums
whose boundary differences ``(hi[b] - hi[a]) + (lo[b] - lo[a])`` give a
range's sum far below float32 ulp — but computes it as a float64 cumsum
split into its float32 rounding (hi) and the float32 rounding of the
remainder (lo), instead of the JAX package's compensated float-float
scan. A range sum of a plain float32 cumsum would carry eps*total into
every small node (the build derives node mass and centre of gravity from
these differences).
"""

from __future__ import annotations

import torch


def cummax_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative max along the last axis."""
    return torch.cummax(x, dim=-1).values


def cummin_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative min along the last axis."""
    return torch.cummin(x, dim=-1).values


def cumsum_ext(x: torch.Tensor) -> torch.Tensor:
    """(n+1, c) float64 prefix sums of ``x`` (n, c) float32 along axis 0:
    row j holds sum(x[:j]), row 0 is zero. Column by column, each a 1-D
    device-wide scan."""
    x64 = x.to(torch.float64).T.contiguous()  # one contiguous row per column
    cs = torch.stack([torch.cumsum(col, 0) for col in x64], 1)
    zero = torch.zeros((1, x.shape[1]), dtype=torch.float64, device=x.device)
    return torch.cat([zero, cs])


def ff_split(cs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float64 ``cs`` as (hi, lo) float32 with hi + lo = cs to about 2^-48:
    the float32 rounding and the float32 rounding of the remainder."""
    hi = cs.to(torch.float32)
    lo = (cs - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def ff_cumsum_ext(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefix sums of ``x`` (n, c) float32 along axis 0 as (hi, lo).

    Each is (n+1, c) float32: row j holds sum(x[:j]) = hi[j] + lo[j] —
    row 0 is zero, row n the grand total — so a contiguous range [a, b)
    sums to ``(hi[b] - hi[a]) + (lo[b] - lo[a])``. Computed in float64
    (about 2^-53 relative to the running total per step, against the JAX
    float-float scan's ~2^-48).
    """
    return ff_split(cumsum_ext(x))
