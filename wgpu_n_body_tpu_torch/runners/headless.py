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

Sharded backends (``parallel/``) run one runner per rank, each stepping its
own slice; every rank makes the same calls, so the collectives line up.
Chunks step them like any other backend (the JAX runner compiles a chunk
from ``step_fn``, which its sharded sims refuse). ``ShardedTreeSim``'s
health (overflow flags, deferred receivers) is reduced over the ranks once
per chunk (``read_health``), after the reshard due at that boundary, if
any; an overflow in the batch a reshard just ended is logged and not
raised (the JAX rule: the reshard exists to bound it, and the next batch
confirms). Trajectory, checkpoint and energy read the whole state gathered
from every rank, and rank 0 alone writes and logs them. The potential
energy's O(N^2) pairs are split: every rank evaluates its share of them on
the gathered state and one ``all_reduce`` sums the float64 parts (the JAX
runner evaluates ``total_energy`` on the global sharded array).

Under ``torch.profiler`` each batch shows three host ranges, in order:
``runner.enqueue`` (the calls of the step function: every launch of the
batch queued), ``runner.sync`` (``StepTimer``: the host waiting for the
device) and ``runner.health`` (``_check_batch``: the reshard due, the health
read and its one flag read).
"""

from __future__ import annotations

from typing import Callable

import torch

from wgpu_n_body_tpu_torch.models.base import InitFn, Simulator
from wgpu_n_body_tpu_torch.ops.energy import kinetic_energy, potential_energy
from wgpu_n_body_tpu_torch.params import ParticleState
from wgpu_n_body_tpu_torch.parallel.mesh import all_reduce, gather_state
from wgpu_n_body_tpu_torch.runners.trajectory import TrajectoryWriter
from wgpu_n_body_tpu_torch.utils.checkpoint import save_checkpoint
from wgpu_n_body_tpu_torch.utils.profiling import StepTimer, trace_scope


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
        self.last_health: dict | None = None
        self._step = sim.make_step()

    @property
    def is_root(self) -> bool:
        """Whether this runner writes and logs: rank 0 of a sharded run, or
        the only runner."""
        mesh = getattr(self.sim, "mesh", None)
        return mesh is None or mesh.rank == 0

    def whole_state(self) -> ParticleState:
        """The whole state: gathered from every rank for a sharded backend (a
        collective), the state itself otherwise."""
        mesh = getattr(self.sim, "mesh", None)
        return self.state if mesh is None else gather_state(self.state, mesh)

    def total_energy(self) -> float:
        """Kinetic plus potential energy of the whole state. A sharded
        backend's ranks each evaluate their share of the pairs and sum the
        parts (a collective: every rank calls it)."""
        whole = self.whole_state()
        mesh = getattr(self.sim, "mesh", None)
        share = (0, 1) if mesh is None else (mesh.rank, mesh.size)
        pe = potential_energy(whole, self.sim.sim_params, share=share)
        if mesh is not None:
            pe = all_reduce(pe.reshape(1), "sum")[0]
        return float(kinetic_energy(whole) + pe)

    def _check_batch(self, k: int, reshard_every: int, log_fn) -> None:
        """The end of a batch of ``k`` steps: the reshard due now, then the
        overflow flags of every step of the batch (and, for the LET
        schedule, the import budget's escalation), in the profiler range
        ``runner.health``."""
        with trace_scope("runner.health"):
            resharded = bool(reshard_every and hasattr(self.sim, "reshard")
                             and self.step_num % reshard_every < k)
            if resharded:
                self.state = self.sim.reshard(self.state)
            if hasattr(self.sim, "read_health"):
                diag = self.last_health = self.sim.read_health()
                if resharded and (diag["overflowed"] or diag["let_overflowed"]):
                    log_fn(f"step {self.step_num}: overflow flagged in the batch before the "
                           f"reshard ({diag}); continuing, a recurrence after it raises")
                else:
                    self.sim.raise_on_health(diag)
                if self.sim.maybe_escalate_import_budget(diag):
                    log_fn(f"step {self.step_num}: walk deferral detected; escalating LET "
                           "import list budget to "
                           f"{self.sim.add_params.effective_import_list_cap()}")
            elif hasattr(self.sim, "raise_on_overflow"):
                self.sim.raise_on_overflow()

    def step(self) -> float:
        """One synchronised step; returns wall seconds (incl. launch)."""
        with self.timer.step() as box:
            with trace_scope("runner.enqueue"):
                self.state = self._step(self.state)
            box["sync"] = self.state.pos
        self.step_num += 1
        self._check_batch(1, 0, print)
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
        reshard_every: int = 0,
        diag_log_every: int = 0,
        log_fn: Callable[[str], None] = print,
    ) -> ParticleState:
        """Drive ``steps`` steps with optional periodic side channels.

        Overflow of a backend's arena (or a LET export) raises RuntimeError
        at the end of the chunk it happened in. ``overflow_check_every``:
        backends exposing ``check_overflow`` also re-build from the current
        state at this cadence and raise if that tree overflows (the state
        the next step builds from). ``reshard_every``: backends exposing
        ``reshard`` (ShardedTreeSim) re-partition their particles at this
        cadence. ``diag_log_every``: backends exposing ``diagnose`` log
        their health dict at this cadence (one sort and build each).

        In a sharded run every rank calls ``run`` with the same arguments,
        except that ``trajectory`` may be None on all ranks but 0: the state
        is gathered every ``trajectory_every`` steps whatever it is.
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
        if trajectory_every:
            whole = self.whole_state()
            if trajectory is not None:
                trajectory.append(whole, self.step_num)
        while done < steps:
            k = min(chunk, steps - done)
            with self.timer.step() as box:
                with trace_scope("runner.enqueue"):
                    for _ in range(k):
                        self.state = self._step(self.state)
                box["sync"] = self.state.pos
            self.step_num += k
            done += k
            self._check_batch(k, reshard_every, log_fn)
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
            if trajectory_every and self.step_num % trajectory_every == 0:
                whole = self.whole_state()
                if trajectory is not None:
                    trajectory.append(whole, self.step_num)
            if checkpoint_path and checkpoint_every and self.step_num % checkpoint_every == 0:
                whole = self.whole_state()
                if self.is_root:
                    save_checkpoint(
                        checkpoint_path, whole, self.sim.sim_params, self.step_num,
                        sim=self.sim,
                    )
            if energy_every and self.step_num % energy_every == 0:
                e = self.total_energy()
                if self.is_root:
                    log_fn(f"step {self.step_num}: total energy {e:.9e}")
        return self.state
