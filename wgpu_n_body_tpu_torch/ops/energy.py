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

Plain torch, evaluated in receiver row blocks (O(block*N) memory).
"""

from __future__ import annotations

import math

import torch

from wgpu_n_body_tpu_torch.params import ParticleState, SimParams


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


def potential_energy(
    state: ParticleState, params: SimParams, block: int = 1024, softened: bool = True
) -> torch.Tensor:
    """sum_{i<j} U_ij over receiver row blocks; a block of rows [s, s+b)
    pairs only with sources j >= s, the rest of its row being j <= i."""
    n = state.n
    pos, mass = state.pos, state.mass
    idx = torch.arange(n, device=pos.device)
    parts = []
    for s in range(0, n, block):
        pb, ib, mb = pos[s : s + block], idx[s : s + block], mass[s : s + block]
        d = pos[None, s:, :] - pb[:, None, :]
        r2 = torch.sum(d * d, dim=-1)
        valid = ib[:, None] < idx[None, s:]
        r = torch.sqrt(torch.where(valid, r2, 1.0))
        pair = softened_pair_integral(r, params.e) if softened else 1.0 / r
        parts.append(
            -params.g
            * torch.sum(torch.where(valid, mb[:, None] * mass[None, s:] * pair, 0.0))
        )
    return torch.sum(torch.stack(parts))


def total_energy(
    state: ParticleState, params: SimParams, block: int = 1024, softened: bool = True
) -> torch.Tensor:
    return kinetic_energy(state) + potential_energy(state, params, block, softened)
