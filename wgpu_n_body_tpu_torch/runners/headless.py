"""Compute-only runner — counterpart of ``wgpu_n_body_tpu/runners/headless.py``
(reference src/runners/offline_headless.rs).

State stays on its device; the host waits for the device only when it
wants numbers (timing, diagnostics, dumps). Two stepping modes:
- ``step()``: one step, synchronised — per-step wall time recorded, the
  analog of the reference's timed loop (src/bin/headless.rs:29-33).
- ``run(..., chunk=k)``: k steps queued back to back with one
  synchronisation at the end; the host touches state only at chunk
  boundaries, so dump/checkpoint/energy cadences must divide k.

Backends with an arena that can overflow (TreeSim) are checked at every
chunk boundary through ``raise_on_overflow``: the flag of every build in
the chunk is read once, after the synchronisation the chunk ends with
anyway. (The JAX package checks only the first batch unless
``overflow_check_every`` is set.)
"""

from __future__ import annotations

from typing import Callable

import torch

from wgpu_n_body_tpu_torch.models.base import InitFn, Simulator
from wgpu_n_body_tpu_torch.ops.energy import total_energy
from wgpu_n_body_tpu_torch.params import ParticleState
from wgpu_n_body_tpu_torch.runners.trajectory import TrajectoryWriter
from wgpu_n_body_tpu_torch.utils.checkpoint import save_checkpoint
from wgpu_n_body_tpu_torch.utils.profiling import StepTimer


class OfflineHeadless:
    """Owns a backend + state and drives the step loop."""

    def __init__(
        self,
        sim: Simulator,
        init_fn: InitFn,
        seed: int = 0,
        *,
        device: str | torch.device,
    ):
        self.sim = sim
        gen = torch.Generator().manual_seed(seed)
        self.state: ParticleState = sim.init_state(gen, init_fn, device)
        self.step_num = 0
        self.timer = StepTimer()
        self._step = sim.make_step()

    def step(self) -> float:
        """One synchronised step; returns wall seconds (incl. launch)."""
        with self.timer.step() as box:
            self.state = self._step(self.state)
            box["sync"] = self.state.pos
        self.step_num += 1
        if hasattr(self.sim, "raise_on_overflow"):
            self.sim.raise_on_overflow()
        return self.timer.times_s[-1]

    def run(
        self,
        steps: int,
        chunk: int = 1,
        log_every: int = 0,
        trajectory: TrajectoryWriter | None = None,
        trajectory_every: int = 0,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 0,
        energy_every: int = 0,
        overflow_check_every: int = 0,
        diag_log_every: int = 0,
        log_fn: Callable[[str], None] = print,
    ) -> ParticleState:
        """Drive ``steps`` steps with optional periodic side channels.

        Overflow of a backend's arena raises RuntimeError at the end of the
        chunk it happened in. ``overflow_check_every``: backends exposing
        ``check_overflow`` also re-build from the current state at this
        cadence and raise if that tree overflows (the state the next step
        builds from). ``diag_log_every``: backends exposing ``diagnose``
        log their health dict at this cadence (one sort and build each).
        """
        if trajectory is not None and trajectory_every <= 0:
            trajectory_every = max(chunk, 1)
        if chunk > 1:
            for every, what in (
                (trajectory_every, "trajectory_every"),
                (checkpoint_every, "checkpoint_every"),
                (energy_every, "energy_every"),
            ):
                if every and every % chunk != 0:
                    raise ValueError(f"{what}={every} must be a multiple of chunk={chunk}")
        done = 0
        if trajectory is not None:
            trajectory.append(self.state, self.step_num)
        while done < steps:
            k = min(chunk, steps - done)
            with self.timer.step() as box:
                for _ in range(k):
                    self.state = self._step(self.state)
                box["sync"] = self.state.pos
            self.step_num += k
            done += k
            if hasattr(self.sim, "raise_on_overflow"):
                self.sim.raise_on_overflow()
            if (
                overflow_check_every
                and hasattr(self.sim, "check_overflow")
                and self.step_num % overflow_check_every < k
            ):
                self.sim.check_overflow(self.state)
            if (
                diag_log_every
                and hasattr(self.sim, "diagnose")
                and self.step_num % diag_log_every < k
            ):
                log_fn(f"step {self.step_num}: {self.sim.diagnose(self.state)}")
            if log_every and (done % log_every < k):
                us = self.timer.times_s[-1] / k * 1e6
                log_fn(f"step {self.step_num}: {us:.1f} us/step")
            if trajectory is not None and self.step_num % trajectory_every == 0:
                trajectory.append(self.state, self.step_num)
            if checkpoint_path and checkpoint_every and self.step_num % checkpoint_every == 0:
                save_checkpoint(
                    checkpoint_path, self.state, self.sim.sim_params, self.step_num,
                    sim=self.sim,
                )
            if energy_every and self.step_num % energy_every == 0:
                e = float(total_energy(self.state, self.sim.sim_params))
                log_fn(f"step {self.step_num}: total energy {e:.9e}")
        return self.state
