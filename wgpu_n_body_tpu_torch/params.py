"""Core value types: simulation parameters and the particle state.

Counterpart of ``wgpu_n_body_tpu/params.py``. The parameter dataclasses
carry the same fields and defaults, so ``dataclasses.asdict`` of them is
the same record in both packages and each reads the other's checkpoints.
``ParticleState`` holds the same SoA fields as torch tensors.

The state bridge (``state_from_numpy`` / ``state_to_numpy`` /
``params_from_dict``) is how one numpy state is fed to both packages.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Global simulation parameters (reference src/sims/mod.rs:53-58).

    Attributes:
      particle_num: N, number of bodies.
      g: gravitational constant.
      e: softening term added to r^3 in the force denominator
         (naive.wgsl:39 — it softens r^3, not r^2).
      dt: timestep. The reference multiplies dt *inside* force
         accumulation (naive.wgsl:41), so the stored "acceleration" field
         is really sum(a)*dt. Replicated exactly.
    """

    particle_num: int = 10000
    g: float = 1e-6
    e: float = 1e-4
    dt: float = 0.016


@dataclasses.dataclass(frozen=True)
class NaiveParams:
    """Extra params for the naive O(N^2) backend.

    Attributes:
      tile_i: receivers per thread block of the all-pairs kernel (one
        thread each; a multiple of 32, at most 1024).
      tile_j: sources per shared-memory tile of the kernel (16 bytes each;
        at most 3072, the 48 KB a block gets without opting in).
      use_pallas: True selects the hand-written kernel for CUDA tensors
        (the name is kept so checkpoints of both packages agree); False
        uses the plain torch force on every device.
      mxu: the factored-accumulation kernel variant of the JAX package.
        Not ported yet; ``NaiveSim`` raises if it is set.
    """

    tile_i: int = 512
    tile_j: int = 2048
    use_pallas: bool = True
    mxu: bool = False


class ParticleState(NamedTuple):
    """SoA particle state (reference Particle, src/sims/mod.rs:11-16).

    pos:  (N, 3) float32 positions
    vel:  (N, 3) float32 velocities
    acc:  (N, 3) float32 — sum(a)*dt of the last step, like the
          reference's acceleration field (naive.wgsl:41,68)
    mass: (N,)   float32 masses
    """

    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    mass: torch.Tensor

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @staticmethod
    def zeros(
        n: int, *, device: str | torch.device, dtype: torch.dtype = torch.float32
    ) -> "ParticleState":
        return ParticleState(
            pos=torch.zeros((n, 3), dtype=dtype, device=device),
            vel=torch.zeros((n, 3), dtype=dtype, device=device),
            acc=torch.zeros((n, 3), dtype=dtype, device=device),
            mass=torch.ones((n,), dtype=dtype, device=device),
        )


def validate_state(state: ParticleState) -> None:
    """Shape invariants; raises ValueError on violation."""
    n = state.pos.shape[0]
    if tuple(state.pos.shape) != (n, 3):
        raise ValueError(f"pos must be (N,3), got {tuple(state.pos.shape)}")
    if tuple(state.vel.shape) != (n, 3):
        raise ValueError(f"vel must be (N,3), got {tuple(state.vel.shape)}")
    if tuple(state.acc.shape) != (n, 3):
        raise ValueError(f"acc must be (N,3), got {tuple(state.acc.shape)}")
    if tuple(state.mass.shape) != (n,):
        raise ValueError(f"mass must be (N,), got {tuple(state.mass.shape)}")


def state_from_numpy(pos, vel, acc, mass, device: str | torch.device) -> ParticleState:
    """ParticleState of contiguous float32 tensors on ``device``."""

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    state = ParticleState(pos=t(pos), vel=t(vel), acc=t(acc), mass=t(mass))
    validate_state(state)
    return state


def state_to_numpy(state: ParticleState) -> dict[str, np.ndarray]:
    """{"pos", "vel", "acc", "mass"} as host numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def params_from_dict(d: dict) -> SimParams:
    """SimParams from ``dataclasses.asdict`` of either package's SimParams."""
    return SimParams(**d)
