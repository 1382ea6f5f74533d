"""Initial-condition generators — counterpart of ``wgpu_n_body_tpu/inits.py``
(reference src/inits.rs).

Each generator has signature ``(generator, SimParams, device) ->
ParticleState``. Random numbers are drawn on the generator's device and the
state is then moved to ``device``, so one CPU generator and seed give the
same scene on every device. The streams differ from ``jax.random``'s:
scenes match the JAX package in distribution, not bit for bit.

Distributions match the reference exactly:
- uniform_init   src/inits.rs:6-27   pos U[-1,1]^3, vel U[-1,1]*0.001, mass 1
- disc_init      src/inits.rs:29-54  central body mass 150000 at rest;
                 N-1 bodies rejection-sampled into the annulus
                 0.25 < |p| < 1 (first draw in the z=0 plane, redraws use
                 z*0.1), then pos *= |pos| and circular velocity
                 sqrt(g*1000/|pos'|) * normalize(p x z-hat)
- spherical_init src/inits.rs:56-83  rejection-sampled unit ball, outward
                 radial velocity 0.4, mass U[1,3]

Rejection sampling is vectorised: all pending particles redraw together
until every one is accepted.
"""

from __future__ import annotations

import torch

from wgpu_n_body_tpu_torch.params import ParticleState, SimParams


def _u(gen: torch.Generator, shape) -> torch.Tensor:
    """U[-1, 1) float32 on the generator's device."""
    return torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32) * 2.0 - 1.0


def _state(pos, vel, mass, device) -> ParticleState:
    pos = pos.to(device)
    return ParticleState(
        pos=pos, vel=vel.to(device), acc=torch.zeros_like(pos), mass=mass.to(device)
    )


def uniform_init(
    gen: torch.Generator, sim_params: SimParams, device: torch.device
) -> ParticleState:
    """Uniform cube scene (reference src/inits.rs:6-27)."""
    n = sim_params.particle_num
    pos = _u(gen, (n, 3))
    vel = _u(gen, (n, 3)) * 0.001
    return _state(pos, vel, torch.ones(n, dtype=torch.float32), device)


def disc_init(
    gen: torch.Generator, sim_params: SimParams, device: torch.device
) -> ParticleState:
    """Galaxy-disc scene (reference src/inits.rs:29-54).

    Body 0 is the central mass (150000, at rest). The rest are
    rejection-sampled into the annulus 0.25 < |p| < 1: the first draw is in
    the z=0 plane and every redraw uses z = U[-1,1]*0.1. Accepted positions
    are scaled by their own length and get circular-orbit velocity
    sqrt(g*1000/|p'|) * normalize(p' x z-hat).
    """
    n = sim_params.particle_num
    g = sim_params.g

    def ok(p):
        r = torch.linalg.norm(p, dim=1)
        return (r <= 1.0) & (r >= 0.25)

    xy = _u(gen, (n, 2))  # first draw: z exactly zero (inits.rs:40)
    pos = torch.cat([xy, torch.zeros_like(xy[:, :1])], dim=1)
    accepted = ok(pos)
    while not bool(accepted.all()):
        cand = _u(gen, (n, 3))
        cand[:, 2] *= 0.1  # redraws use z*0.1 (inits.rs:42)
        pos = torch.where(accepted[:, None], pos, cand)
        accepted = accepted | ok(pos)

    # pos *= |pos| (inits.rs:44), then vel from the *scaled* length (:45)
    pos = pos * torch.linalg.norm(pos, dim=1, keepdim=True)
    r1 = torch.linalg.norm(pos, dim=1)
    tangent = torch.stack([pos[:, 1], -pos[:, 0], torch.zeros_like(r1)], dim=1)
    tangent = tangent / torch.linalg.norm(tangent, dim=1, keepdim=True)
    vel = torch.sqrt(g * 1000.0 / r1)[:, None] * tangent

    # Body 0: central mass, at rest at the origin (inits.rs:33-38).
    pos[0] = 0.0
    vel[0] = 0.0
    mass = torch.ones(n, dtype=torch.float32)
    mass[0] = 150000.0
    return _state(pos, vel, mass, device)


def spherical_init(
    gen: torch.Generator, sim_params: SimParams, device: torch.device
) -> ParticleState:
    """Exploding-sphere scene (reference src/inits.rs:56-83)."""
    n = sim_params.particle_num
    outward_vel = 0.4  # inits.rs:57
    pos = _u(gen, (n, 3))
    accepted = torch.linalg.norm(pos, dim=1) <= 1.0
    while not bool(accepted.all()):
        pos = torch.where(accepted[:, None], pos, _u(gen, (n, 3)))
        accepted = accepted | (torch.linalg.norm(pos, dim=1) <= 1.0)
    r = torch.linalg.norm(pos, dim=1, keepdim=True)
    vel = pos / r * outward_vel
    mass = _u(gen, (n,)) + 2.0  # U[1,3] (inits.rs:79)
    return _state(pos, vel, mass, device)


INITS = {
    "uniform": uniform_init,
    "disc": disc_init,
    "spherical": spherical_init,
}
