"""Leapfrog (KDK) integration with the reference's exact semantics.

Counterpart of ``wgpu_n_body_tpu/ops/integrate.py``. The reference kernel
(naive.wgsl:63-68, tree.wgsl:105-110) is

    vel += acc_prev * dt / 2      # acc_prev already carries a factor dt
    pos += vel * dt               # drift
    acc  = getAcc(pos_new)        # force, *dt applied inside accumulation
    vel += acc * dt / 2

and two of its quirks are kept: the stored ``acc`` is sum(a)*dt, and the
force pairs each particle's *post-drift* position (receiver) with every
other particle's *pre-step* position (source). So ``state.pos`` must not
be updated in place before the force call: it is the source array.

Under ``torch.profiler`` the half-kick and the drift show as the range
``leapfrog.drift`` and the closing half-kick as ``leapfrog.kick``; the force
call lies outside both.
"""

from __future__ import annotations

from typing import Callable

import torch

from wgpu_n_body_tpu_torch.params import ParticleState, SimParams
from wgpu_n_body_tpu_torch.utils.profiling import trace_scope

ForceFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def leapfrog_step(
    state: ParticleState, params: SimParams, force_fn: ForceFn,
    out: ParticleState | None = None,
) -> ParticleState:
    """One reference-exact KDK step; returns new tensors, reads ``state``.
    ``out``: a state whose ``pos`` and ``vel`` the drift and the closing
    half-kick write instead, bit for bit the same (its ``acc`` and ``mass``
    are the caller's to fill: the new state takes the force's output and
    ``state.mass``)."""
    half = params.dt / 2.0
    with trace_scope("leapfrog.drift"):
        vel_h = state.vel + state.acc * half
        pos_new = torch.add(state.pos, vel_h * params.dt, out=None if out is None else out.pos)
    acc_new = force_fn(pos_new, state.pos, state.mass)
    with trace_scope("leapfrog.kick"):
        vel_new = torch.add(vel_h, acc_new * half, out=None if out is None else out.vel)
    return ParticleState(pos=pos_new, vel=vel_new, acc=acc_new, mass=state.mass)
