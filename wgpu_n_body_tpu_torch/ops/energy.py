"""Energy diagnostics — counterpart of ``wgpu_n_body_tpu/ops/energy.py``.

Kinetic energy is exact: KE = 1/2 sum m |v|^2.

Potential energy — two variants:

- ``softened=True`` (default): the potential matched to the reference
  force law g*m/(r^3 + e) (naive.wgsl:38-39). Its radial antiderivative
  has a closed form via partial fractions of 1/(s^3 + a^3), a = e^(1/3):

      I(r) = INT_r^inf ds/(s^3+e)
           = ln((r^2 - a r + a^2) / (r + a)^2) / (6 a^2)
             + (pi/2 - arctan((2r - a)/(a sqrt(3)))) / (a^2 sqrt(3))

  and U_ij = -g m_i m_j I(r_ij), so -dU/dr equals the pair force.
- ``softened=False``: the Newtonian pair proxy -g m_i m_j / r.

``potential_energy`` hands the state to E1's wrapper (``ops/energy_cuda.py``),
which sends a CUDA state to the hand-written kernel (``csrc/energy.cu``) and a
CPU state to the plain version here; every other device raises. Both sum
the same pairs:
the upper triangle of (receiver tile, source tile) pairs of ``TILE``
bodies, numbered row by row, of which ``share=(k, P)`` takes the k-th of P
equal runs (a sharded runner gives each rank its own share and sums the
results). Partial sums are in the state's float type (E1: a receiver over
one source tile; the plain version: a block of rows over a run of source
tiles), their total in float64; the result is a float64 scalar.
"""

from __future__ import annotations

import math

import torch

from wgpu_n_body_tpu_torch.params import ParticleState, SimParams

#: Bodies per tile of the pair triangle: E1's receivers per block and
#: sources per shared-memory stage (``csrc/energy.cu`` kTile).
TILE = 256


def kinetic_energy(state: ParticleState) -> torch.Tensor:
    return 0.5 * torch.sum(state.mass * torch.sum(state.vel**2, dim=1))


def softened_pair_integral(r: torch.Tensor, e: float) -> torch.Tensor:
    """I(r) = INT_r^inf ds/(s^3 + e), elementwise.

    pi/2 - arctan(x) is computed as arctan(1/x) for x > 0 (exact identity;
    the direct difference loses ~3 significant digits in f32 once r >> a).
    I(0) = 2 pi / (3 sqrt(3) a^2) is finite.
    """
    a = e ** (1.0 / 3.0)
    s3 = math.sqrt(3.0)
    x = (2.0 * r - a) / (a * s3)
    cot = torch.atan(1.0 / torch.where(x > 0, x, 1.0))
    at = torch.where(x > 0, cot, math.pi / 2 - torch.atan(x))
    log_term = torch.log((r * r - a * r + a * a) / ((r + a) * (r + a)))
    return log_term / (6.0 * a * a) + at / (a * a * s3)


def check_share(share: tuple[int, int]) -> tuple[int, int]:
    """``share`` as (k, P) ints with 0 <= k < P; raises ValueError otherwise."""
    k, p = share
    if not (isinstance(k, int) and isinstance(p, int) and 0 <= k < p):
        raise ValueError(f"share must be (k, P) with 0 <= k < P, got {share!r}")
    return k, p


def share_range(n: int, share: tuple[int, int], tile: int = TILE) -> tuple[int, int]:
    """[lo, hi): the tile pairs of ``share`` (k, P) among the
    nt (nt + 1) / 2 of the upper triangle, nt = ceil(n / tile)."""
    k, p = check_share(share)
    nt = -(-n // tile)
    count = nt * (nt + 1) // 2
    return count * k // p, count * (k + 1) // p


def row_start(a: int, nt: int) -> int:
    """Index of tile pair (a, a): row a of the triangle holds (a, a..nt-1)."""
    return a * nt - a * (a - 1) // 2


def tile_pair(t: int, nt: int) -> tuple[int, int]:
    """(receiver tile a, source tile b >= a) of tile pair ``t`` of the
    triangle: E1's mapping (``csrc/energy.cu`` tile_pair), a float64 root
    corrected by whole rows."""
    w = 2.0 * nt + 1.0
    a = int((w - math.sqrt(max(w * w - 8.0 * t, 0.0))) * 0.5)
    a = min(max(a, 0), nt - 1)
    while a + 1 < nt and row_start(a + 1, nt) <= t:
        a += 1
    while row_start(a, nt) > t:
        a -= 1
    return a, a + t - row_start(a, nt)


def share_rects(n: int, share: tuple[int, int], tile: int = TILE) -> list[tuple[int, int, int]]:
    """The tile pairs of ``share`` as (a, b0, b1) runs: receiver tile a
    against source tiles [b0, b1), in the kernel's order."""
    nt = -(-n // tile)
    lo, hi = share_range(n, share, tile)
    out = []
    t = lo
    while t < hi:
        a, b0 = tile_pair(t, nt)
        b1 = min(nt, b0 + hi - t)
        out.append((a, b0, b1))
        t += b1 - b0
    return out


def potential_energy_plain(
    state: ParticleState,
    params: SimParams,
    block: int = 1024,
    softened: bool = True,
    share: tuple[int, int] = (0, 1),
) -> torch.Tensor:
    """sum_{i<j} U_ij over the tile pairs of ``share``, in plain torch on
    the state's device and float type: receiver rows in blocks of at most
    ``block`` (and ``TILE``) against each run of source tiles; each block's
    sum in the state's type, their total in float64."""
    n = state.n
    pos, mass = state.pos, state.mass
    idx = torch.arange(n, device=pos.device)
    total = torch.zeros((), dtype=torch.float64, device=pos.device)
    for a, b0, b1 in share_rects(n, share):
        c0, c1 = b0 * TILE, min(b1 * TILE, n)
        for s in range(a * TILE, min((a + 1) * TILE, n), block):
            e = min(s + block, (a + 1) * TILE, n)
            pb, ib, mb = pos[s:e], idx[s:e], mass[s:e]
            d = pos[None, c0:c1, :] - pb[:, None, :]
            r2 = torch.sum(d * d, dim=-1)
            valid = ib[:, None] < idx[None, c0:c1]
            r = torch.sqrt(torch.where(valid, r2, 1.0))
            pair = softened_pair_integral(r, params.e) if softened else 1.0 / r
            total += torch.sum(torch.where(valid, mb[:, None] * mass[None, c0:c1] * pair, 0.0))
    return -params.g * total


def potential_energy(
    state: ParticleState,
    params: SimParams,
    block: int = 1024,
    softened: bool = True,
    share: tuple[int, int] = (0, 1),
) -> torch.Tensor:
    """sum_{i<j} U_ij over the tile pairs of ``share`` (all of them by
    default), a float64 scalar on the state's device, from E1's wrapper:
    the kernel for a CUDA state, the plain version (receiver rows in blocks
    of ``block``) for a CPU state."""
    from wgpu_n_body_tpu_torch.ops.energy_cuda import potential_energy_cuda  # imports this module

    return potential_energy_cuda(state.pos, state.mass, params, softened, share, block)


def total_energy(
    state: ParticleState, params: SimParams, block: int = 1024, softened: bool = True
) -> torch.Tensor:
    return kinetic_energy(state) + potential_energy(state, params, block, softened)
