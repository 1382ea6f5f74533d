"""Hybrid Barnes-Hut backend: host (C++) tree build + device theta walk —
counterpart of ``wgpu_n_body_tpu/models/tree_host.py``.

This mirrors the reference's actual architecture — its TreeSim builds the
octree on the CPU and dispatches the walk to the accelerator every step
(src/sims/tree.rs:262-353) — as a secondary backend. The device-resident
``TreeSim`` is the production path (no host round trip); ``TreeSimHost``
exists for architectural parity, as an independent cross-check of the
device tree build, and for hosts with strong CPUs attached to small
accelerators.

Per step: positions and masses device -> host (this waits for the device:
a host build needs the numbers, it is this backend's nature), the native
BFS build + DFS sort (``native/octree.cpp``), the DFS arena host -> device,
the state gathered into DFS order, then the leapfrog with the per-particle
walk as the force (``ops/tree_walk_cuda.py``: the kernel ``csrc/tree_walk.cu``
for a CUDA state, the plain walk for a CPU state).

The arena goes up with the ``m + 1`` rows the host made (row ``m`` is the
sentinel, a finished walk's ``skip`` is ``m``, ``num_nodes = m``). The JAX
package pads it to the static ``capacity(n) + 1`` rows so that XLA
compiles the step once; PyTorch runs eagerly and needs no fixed shape, so
the padding (704 MB per step at N=4M) is not uploaded.
"""

from __future__ import annotations

import dataclasses

import torch

from wgpu_n_body_tpu_torch.models.base import Simulator, StepFn
from wgpu_n_body_tpu_torch.native.build import HostOctree, build_host_tree, native_available
from wgpu_n_body_tpu_torch.ops.integrate import leapfrog_step
from wgpu_n_body_tpu_torch.ops.tree_build import TreeArrays
from wgpu_n_body_tpu_torch.ops.tree_walk_cuda import tree_forces_cuda
from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams
from wgpu_n_body_tpu_torch.utils.profiling import trace_scope


def host_tree_arrays(host: HostOctree, device: torch.device) -> TreeArrays:
    """The host tree's DFS arena on ``device``: its ``m + 1`` rows as they
    are, ``num_nodes = m``, never overflowed."""
    m = host.nodes_f32.shape[0] - 1
    return TreeArrays(
        nodes_f32=torch.from_numpy(host.nodes_f32).to(device),
        skip=torch.from_numpy(host.skip).to(device),
        first=torch.from_numpy(host.first).to(device),
        count=torch.from_numpy(host.count).to(device),
        num_nodes=torch.tensor(m, dtype=torch.int32, device=device),
        root_width=torch.tensor(host.root_width, dtype=torch.float32, device=device),
        overflowed=torch.tensor(False, device=device),
    )


class TreeSimHost(Simulator):
    """CPU-build / device-walk Barnes-Hut (reference-architecture parity).

    The native build subdivides to singleton leaves (exactly
    tree.rs:506-540), so this backend requires ``leaf_bucket=1`` and
    rejects anything else rather than silently overriding the caller.
    """

    def __init__(self, sim_params: SimParams, add_params: TreeParams | None = None):
        super().__init__(sim_params)
        self.add_params = add_params or dataclasses.replace(TreeParams(), leaf_bucket=1)
        if self.add_params.leaf_bucket != 1:
            raise ValueError(
                "TreeSimHost builds singleton leaves (reference parity); "
                f"pass leaf_bucket=1, got {self.add_params.leaf_bucket}"
            )
        if not native_available():
            raise RuntimeError("TreeSimHost requires the native octree library (g++)")

    def step_fn(self) -> StepFn:
        """The step. PyTorch runs eagerly, so nothing is traced and a step
        that crosses the host boundary is a step like any other:
        ``step_fn()`` and ``make_step()`` return the same function (the JAX
        package's ``step_fn`` raises, because its steps are jitted)."""
        params, tp = self.sim_params, self.add_params
        cap = tp.capacity(params.particle_num)

        def step(state: ParticleState) -> ParticleState:
            with trace_scope("tree_step"):
                device = state.pos.device
                with trace_scope("host_build"):
                    with trace_scope("host_copy_down"):
                        pos, mass = state.pos.cpu().numpy(), state.mass.cpu().numpy()
                    with trace_scope("host_octree"):
                        host = build_host_tree(pos, mass, tp.effective_capacity_factor)
                    m = host.nodes_f32.shape[0] - 1
                    if m > cap:
                        raise RuntimeError(f"host tree {m} nodes exceeds cap {cap}")
                    with trace_scope("host_copy_up"):
                        tree = host_tree_arrays(host, device)
                        order = torch.from_numpy(host.order).to(device)
                # first/count index the DFS order, so the state is gathered
                # before the walk (its default self_idx is arange)
                sorted_state = ParticleState(
                    pos=state.pos[order],
                    vel=state.vel[order],
                    acc=state.acc[order],
                    mass=state.mass[order],
                )

                def force(pos_new, pos_old, mass_):
                    with trace_scope("theta_walk"):
                        return tree_forces_cuda(pos_new, pos_old, mass_, tree, params, tp)

                return leapfrog_step(sorted_state, params, force)

        return step
