"""Naive O(N^2) backend — counterpart of ``wgpu_n_body_tpu/models/naive.py``
(reference src/sims/naive.rs + naive.wgsl).

State stays on its device; particle order is preserved across steps. The
force is picked by the tensors' device: with ``use_pallas=True`` a CUDA
state goes through the hand-written kernel (``ops/naive_cuda.py``; the
factored one when ``mxu=True``) and a CPU state through the plain torch
version of the same form; ``use_pallas=False`` takes the plain dx-form on
every device, as the JAX package does.
"""

from __future__ import annotations

from wgpu_n_body_tpu_torch.models.base import Simulator, StepFn
from wgpu_n_body_tpu_torch.ops.integrate import leapfrog_step
from wgpu_n_body_tpu_torch.ops.naive_cuda import naive_forces_cuda
from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_ref
from wgpu_n_body_tpu_torch.params import NaiveParams, ParticleState, SimParams
from wgpu_n_body_tpu_torch.utils.profiling import trace_scope


class NaiveSim(Simulator):
    """All-pairs softened gravity, one step per call."""

    def __init__(self, sim_params: SimParams, add_params: NaiveParams | None = None):
        super().__init__(sim_params)
        self.add_params = add_params or NaiveParams()

    def step_fn(self) -> StepFn:
        params, ap = self.sim_params, self.add_params

        if ap.use_pallas:

            def force(pos_new, pos_old, mass):
                return naive_forces_cuda(
                    pos_new, pos_old, mass, params,
                    tile_i=ap.tile_i, tile_j=ap.tile_j, mxu=ap.mxu,
                )

        else:

            def force(pos_new, pos_old, mass):
                return naive_forces_ref(pos_new, pos_old, mass, params)

        def step(state: ParticleState) -> ParticleState:
            with trace_scope("naive_step"):
                return leapfrog_step(state, params, force)

        return step
