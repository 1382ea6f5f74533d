"""Backend protocol — counterpart of ``wgpu_n_body_tpu/models/base.py``.

Reference (src/sims/mod.rs:73-90): a backend is built from parameter
values, makes its initial state, and exposes a step ``state -> state``.
PyTorch runs eagerly, so ``make_step`` compiles nothing and returns the
step itself.
"""

from __future__ import annotations

import abc
from typing import Callable

import torch

from wgpu_n_body_tpu_torch.params import ParticleState, SimParams

StepFn = Callable[[ParticleState], ParticleState]
InitFn = Callable[[torch.Generator, SimParams, torch.device], ParticleState]


class Simulator(abc.ABC):
    """Abstract simulation backend."""

    def __init__(self, sim_params: SimParams):
        self.sim_params = sim_params

    @abc.abstractmethod
    def step_fn(self) -> StepFn:
        """Return the single-step function."""

    def make_step(self) -> StepFn:
        """The step to call in a loop (eager: the step function itself)."""
        return self.step_fn()

    def init_state(
        self, generator: torch.Generator, init_fn: InitFn, device: str | torch.device
    ) -> ParticleState:
        """Generate the initial state on ``device`` from ``generator``."""
        return init_fn(generator, self.sim_params, torch.device(device))
