"""The initial scenes, drawn from the seed on the run's device.

A frozen copy of ``wgpu_n_body_tpu_torch/inits.py`` at commit d60e59f (the
upstream generators, src/inits.rs:6-83), so that a later change to the
program cannot move the benchmark's inputs. Each generator takes a
``torch.Generator`` and draws on its device; the benchmark hands the same
tensors to the program and to the reference.

- uniform: pos U[-1,1]^3, vel U[-1,1]*0.001, mass 1
- disc: central body of mass 150000 at rest; the rest rejection-sampled
  into the annulus 0.25 < |p| < 1 (first draw in the z=0 plane, redraws
  with z*0.1), then pos *= |pos| and circular velocity
  sqrt(g*1000/|pos'|) * normalize(p x z-hat)
- spherical: rejection-sampled unit ball, outward radial velocity 0.4,
  mass U[1,3]

Each returns (pos, vel, acc, mass) float32 tensors, acc zero.
"""

from __future__ import annotations

import torch


def _u(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32) * 2.0 - 1.0


def uniform(gen: torch.Generator, n: int, g: float):
    pos = _u(gen, (n, 3))
    vel = _u(gen, (n, 3)) * 0.001
    return pos, vel, torch.zeros_like(pos), torch.ones(n, dtype=torch.float32, device=gen.device)


def disc(gen: torch.Generator, n: int, g: float):
    def ok(p):
        r = torch.linalg.norm(p, dim=1)
        return (r <= 1.0) & (r >= 0.25)

    xy = _u(gen, (n, 2))
    pos = torch.cat([xy, torch.zeros_like(xy[:, :1])], dim=1)
    accepted = ok(pos)
    while not bool(accepted.all()):
        cand = _u(gen, (n, 3))
        cand[:, 2] *= 0.1
        pos = torch.where(accepted[:, None], pos, cand)
        accepted = accepted | ok(pos)
    pos = pos * torch.linalg.norm(pos, dim=1, keepdim=True)
    r1 = torch.linalg.norm(pos, dim=1)
    tangent = torch.stack([pos[:, 1], -pos[:, 0], torch.zeros_like(r1)], dim=1)
    tangent = tangent / torch.linalg.norm(tangent, dim=1, keepdim=True)
    vel = torch.sqrt(g * 1000.0 / r1)[:, None] * tangent
    pos[0] = 0.0
    vel[0] = 0.0
    mass = torch.ones(n, dtype=torch.float32, device=gen.device)
    mass[0] = 150000.0
    return pos, vel, torch.zeros_like(pos), mass


def spherical(gen: torch.Generator, n: int, g: float):
    pos = _u(gen, (n, 3))
    accepted = torch.linalg.norm(pos, dim=1) <= 1.0
    while not bool(accepted.all()):
        pos = torch.where(accepted[:, None], pos, _u(gen, (n, 3)))
        accepted = accepted | (torch.linalg.norm(pos, dim=1) <= 1.0)
    r = torch.linalg.norm(pos, dim=1, keepdim=True)
    vel = pos / r * 0.4
    mass = _u(gen, (n,)) + 2.0
    return pos, vel, torch.zeros_like(pos), mass


SCENES = {"uniform": uniform, "disc": disc, "spherical": spherical}


def draw(scene: str, seed: int, n: int, g: float, device: torch.device,
         scene_seed: int | None = None):
    """(pos, vel, acc, mass) of ``scene`` with ``n`` bodies, drawn on
    ``device`` by a generator seeded with ``seed``. With ``scene_seed`` the
    bodies are those of the draw from ``scene_seed``, in an order drawn from
    ``seed``: every run then steps the same bodies, and the seed changes
    only the order the program receives them in."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed if scene_seed is None else scene_seed))
    state = SCENES[scene](gen, n, g)
    if scene_seed is None:
        return state
    gen.manual_seed(int(seed))
    perm = torch.randperm(n, generator=gen, device=device)
    return tuple(t[perm] for t in state)
