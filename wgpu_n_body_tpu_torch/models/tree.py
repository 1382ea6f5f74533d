"""Barnes-Hut octree backend — counterpart of ``wgpu_n_body_tpu/models/tree.py``
(reference src/sims/tree.rs + tree.wgsl).

One step, all on the state's device:

    Morton keys and their stable sort (ops/morton_cuda.py: the key kernel
       of csrc/morton_keys.cu and CUB's radix sort)
    -> the reorder (== the reference's DFS particle reorder) and the arena
       build (ops/tree_build_cuda.py: the kernels of csrc/tree_build.cu)
    -> leapfrog with the theta walk as the force

each with its plain version (ops/tree_build.py) for a CPU state.

Like the reference, TreeSim reorders particles every step and returns the
sorted state. The force is the default group walk (``walk="group"``: the
CUDA kernel ``csrc/tree_walk_group.cu`` plus the per-particle kernel over
the receivers it defers) or the stackless per-particle walk
(``walk="per_particle"``: ``csrc/tree_walk.cu``), each with its plain torch
version for a CPU state. Both values of ``walk_engine`` run the group
walk's skip-engine semantics (ROADMAP C).

Every build's overflow flag is kept on the device, OR-ed over the steps
since the last check, so the runner can raise on an overflow in any batch
with one host read where it already synchronises (``raise_on_overflow``).
"""

from __future__ import annotations

import torch

from wgpu_n_body_tpu_torch.models.base import Simulator, StepFn
from wgpu_n_body_tpu_torch.ops.integrate import leapfrog_step
from wgpu_n_body_tpu_torch.ops.morton_cuda import morton_order_cuda
from wgpu_n_body_tpu_torch.ops.tree_build_cuda import build_tree_cuda
from wgpu_n_body_tpu_torch.ops.tree_walk_cuda import tree_forces_cuda
from wgpu_n_body_tpu_torch.ops.tree_walk_group_cuda import MAX_TILE, group_tree_forces_cuda
from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams
from wgpu_n_body_tpu_torch.utils.profiling import trace_scope


def validate_tree_params(tp: TreeParams) -> None:
    """Raise ValueError for TreeParams values no tree backend takes."""
    if tp.walk not in ("group", "per_particle"):
        raise ValueError(f"unknown walk {tp.walk!r}")
    if not isinstance(tp.max_depth, int) or not 1 <= tp.max_depth <= 20:
        raise ValueError(f"max_depth must be an int in [1, 20], got {tp.max_depth!r}")
    if not isinstance(tp.leaf_bucket, int) or tp.leaf_bucket < 1:
        raise ValueError(f"leaf_bucket must be an int >= 1, got {tp.leaf_bucket!r}")
    if not isinstance(tp.theta, (int, float)) or not tp.theta >= 0:
        raise ValueError(f"theta must be a number >= 0, got {tp.theta!r}")


def check_walk_tile(tp: TreeParams, n_receivers: int, device: torch.device) -> None:
    """Raise ValueError for a walk tile ``device`` does not take.

    The group walk's evaluation kernel holds a tile in one CTA, at most
    ``MAX_TILE`` receivers, so a larger ``walk_tile`` is rejected for a CUDA
    device, before any state is made or stepped (``diagnose`` runs the
    group walk whatever ``walk`` is). The CPU path takes any tile."""
    tile = tp.effective_walk_tile(n_receivers)
    if device.type == "cuda" and tile > MAX_TILE:
        raise ValueError(
            f"walk_tile must be at most {MAX_TILE} on a CUDA device, got {tile} "
            "(larger tiles run with --device cpu only)"
        )


class TreeSim(Simulator):
    """Barnes-Hut O(N log N) backend, device-resident."""

    def __init__(self, sim_params: SimParams, add_params: TreeParams | None = None):
        super().__init__(sim_params)
        # The reference defaults theta=0.75 when params are missing
        # (tree.rs:42-51); here the default lives in TreeParams itself.
        self.add_params = add_params or TreeParams()
        validate_tree_params(self.add_params)
        self._overflowed: torch.Tensor | None = None

    def check_device(self, device: torch.device) -> None:
        """Raise ValueError for parameters that ``device`` does not take
        (``check_walk_tile``)."""
        check_walk_tile(self.add_params, self.sim_params.particle_num, device)

    def init_state(self, generator, init_fn, device) -> ParticleState:
        self.check_device(torch.device(device))
        return super().init_state(generator, init_fn, device)

    def _sort_build(self, state: ParticleState):
        """(sorted state, arena, sorted packed keys): the key kernel in the
        profiler range ``morton_keys``, the sort in ``morton_sort``, the
        reorder and the build in ``tree_build``."""
        tp = self.add_params
        perm, bound, keys = morton_order_cuda(state.pos, tp.max_depth)
        with trace_scope("tree_build"):
            state_sorted, tree = build_tree_cuda(state, perm, keys, bound, tp)
        return state_sorted, tree, keys

    def step_fn(self) -> StepFn:
        params, tp = self.sim_params, self.add_params

        def force_of(tree, keys):
            def force(pos_new, pos_old, mass):
                with trace_scope("theta_walk"):
                    if tp.walk == "group":
                        return group_tree_forces_cuda(
                            pos_new, pos_old, mass, tree, keys, params, tp
                        )[0]
                    return tree_forces_cuda(pos_new, pos_old, mass, tree, params, tp)

            return force

        def step(state: ParticleState) -> ParticleState:
            with trace_scope("tree_step"):
                # Sort and build from the pre-step positions, as the
                # reference does before its compute dispatch (tree.rs:271-297).
                state_sorted, tree, keys = self._sort_build(state)
                flag = tree.overflowed
                self._overflowed = flag if self._overflowed is None else self._overflowed | flag
                return leapfrog_step(state_sorted, params, force_of(tree, keys))

        return step

    def _overflow_error(self) -> RuntimeError:
        cap = self.add_params.capacity(self.sim_params.particle_num)
        return RuntimeError(
            f"octree arena overflow (cap {cap} nodes): forces are truncated; "
            "raise node_capacity_factor or leaf_bucket"
        )

    def raise_on_overflow(self) -> None:
        """Raise if any build since the last call overflowed its arena.
        One host read of a device flag: call it where the host waits for
        the device anyway."""
        flag, self._overflowed = self._overflowed, None
        if flag is not None and bool(flag):
            raise self._overflow_error()

    def check_overflow(self, state: ParticleState) -> None:
        """Raise if the arena overflows for this state (one sort + build,
        no walk)."""
        _, tree, _ = self._sort_build(state)
        if bool(tree.overflowed):
            raise self._overflow_error()

    def diagnose(self, state: ParticleState) -> dict:
        """Tree health for this state: node count against the arena, and
        how many receivers one group walk of the sorted state defers to the
        per-particle walk (computed whatever ``walk`` is, as in JAX), and how
        many of those for want of room in the walk's list pool."""
        ss, tree, keys = self._sort_build(state)
        _, stats = group_tree_forces_cuda(
            ss.pos, ss.pos, ss.mass, tree, keys, self.sim_params, self.add_params
        )
        return {
            "num_nodes": int(tree.num_nodes),
            "node_capacity": self.add_params.capacity(self.sim_params.particle_num),
            "overflowed": bool(tree.overflowed),
            "walk_deferred": int(stats.deferred),
            "walk_pool_deferred": int(stats.pool_deferred),
        }
