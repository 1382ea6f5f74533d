"""Multi-GPU naive O(N^2) backend — counterpart of
``wgpu_n_body_tpu/parallel/sharded_naive.py``.

Receivers are sharded over the ranks; every rank needs every source. Two
schedules:

- ``allgather``: one gather of the old positions and masses per step,
  then the all-pairs force (B1, or B2 with ``mxu=True``) over this rank's
  receivers with the shard's global row offset for the self-mask. O(N)
  memory per rank for the gathered sources.
- ``ring``: P - 1 rotations of the source shard around the ranks (send to
  rank + 1, receive from rank - 1); each rank adds its receivers' force
  from the shard it holds, in the JAX order (its own shard first, then
  rank - 1's, ...). O(N / P) memory per rank.

Both give the single-device physics up to the float32 order of the sums
(the ring sums shard by shard). Particle order is preserved.
"""

from __future__ import annotations

from wgpu_n_body_tpu_torch.models.base import Simulator, StepFn
from wgpu_n_body_tpu_torch.ops.naive_cuda import naive_forces_cuda
from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_ref
from wgpu_n_body_tpu_torch.params import NaiveParams, ParticleState, SimParams
from wgpu_n_body_tpu_torch.parallel.mesh import Mesh, all_gather, ring_shift, shard_state
from wgpu_n_body_tpu_torch.utils.profiling import trace_scope

SCHEDULES = ("allgather", "ring")


def local_forces(pos_new_l, pos_old, mass, row_offset: int, params: SimParams,
                 ap: NaiveParams):
    """This rank's receivers against the given sources, the self-mask at
    global row ``row_offset`` (``sharded_naive.py:38``): B1 (B2 with
    ``mxu``) for CUDA tensors, its plain version for CPU ones; the plain
    dx-form everywhere with ``use_pallas=False``."""
    if ap.use_pallas:
        return naive_forces_cuda(pos_new_l, pos_old, mass, params, row_offset,
                                 tile_i=ap.tile_i, tile_j=ap.tile_j, mxu=ap.mxu)
    return naive_forces_ref(pos_new_l, pos_old, mass, params, row_offset=row_offset)


class ShardedNaiveSim(Simulator):
    """Multi-GPU NaiveSim: one instance per rank, stepping that rank's slice."""

    def __init__(self, sim_params: SimParams, mesh: Mesh,
                 add_params: NaiveParams | None = None, schedule: str = "allgather"):
        super().__init__(sim_params)
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}")
        if sim_params.particle_num % mesh.size:
            raise ValueError(f"N={sim_params.particle_num} not divisible by mesh size {mesh.size}")
        self.mesh = mesh
        self.add_params = add_params or NaiveParams()
        self.schedule = schedule

    def step_fn(self) -> StepFn:
        params, ap, mesh, schedule = self.sim_params, self.add_params, self.mesh, self.schedule
        half = params.dt / 2.0

        def step(state: ParticleState) -> ParticleState:
            with trace_scope("sharded_naive_step"):
                n_local = state.n
                vel_h = state.vel + state.acc * half
                pos_new = state.pos + vel_h * params.dt
                row_off = mesh.rank * n_local
                if schedule == "allgather":
                    pos_all = all_gather(state.pos, mesh.size)
                    mass_all = all_gather(state.mass, mesh.size)
                    acc_new = local_forces(pos_new, pos_all, mass_all, row_off, params, ap)
                else:
                    src_pos, src_mass = state.pos, state.mass
                    acc_new = None
                    for k in range(mesh.size):
                        # the shard held now is rank - k's: its own bodies
                        # only at k = 0 (a row offset past the shard masks none)
                        part = local_forces(pos_new, src_pos, src_mass, 0 if k == 0 else n_local,
                                            params, ap)
                        acc_new = part if acc_new is None else acc_new + part
                        if k + 1 < mesh.size:
                            src_pos, src_mass = ring_shift([src_pos, src_mass], mesh)
                vel_new = vel_h + acc_new * half
                return ParticleState(pos=pos_new, vel=vel_new, acc=acc_new, mass=state.mass)

        return step

    def init_state(self, generator, init_fn, device=None) -> ParticleState:
        """This rank's slice of the scene ``init_fn`` draws on the CPU from
        ``generator`` (the same scene on every rank), on the mesh's device."""
        return shard_state(init_fn(generator, self.sim_params, "cpu"), self.mesh)
