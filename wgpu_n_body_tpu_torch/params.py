"""Core value types: simulation parameters and the particle state.

Counterpart of ``wgpu_n_body_tpu/params.py``. The parameter dataclasses
carry the same fields and defaults, so ``dataclasses.asdict`` of them is
the same record in both packages and each reads the other's checkpoints.
``ParticleState`` holds the same SoA fields as torch tensors.

The state bridge (``state_from_numpy`` / ``state_to_numpy`` /
``params_from_dict``) is how one numpy state and one parameter record are
fed to both packages.
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
      tile_i: receivers per thread block of the all-pairs kernel (a
        multiple of 32, at most 1024; up to 128 threads hold one, two,
        four or eight receivers each).
      tile_j: sources summed into one partial before it joins a
        receiver's total (the two-level summation that keeps the f32
        error near the TPU kernel's; at most 3072).
      use_pallas: True selects the hand-written kernel for CUDA tensors
        (the name is kept so checkpoints of both packages agree); False
        uses the plain torch force on every device.
      mxu: opt-in factored accumulation (``csrc/naive_forces.cu``'s
        factored form, port of ``naive_pallas._kernel_mxu``): the same per-pair weights,
        summed as Σw·p_j − p_i·Σw. Less accurate than the dx-form default
        (the JAX package documents ~2e-4 vs ~2e-5 p99 relative error in
        f32). Only read when ``use_pallas`` is True.
    """

    tile_i: int = 512
    tile_j: int = 2048
    use_pallas: bool = True
    mxu: bool = False


@dataclasses.dataclass(frozen=True)
class TreeParams:
    """Extra params for the Barnes-Hut backend: the JAX package's
    ``TreeParams`` field for field, default for default, so checkpoints
    and ``dataclasses.asdict`` records are shared.

    Reference: ``AddParams::TreeSimParams { theta }`` (src/sims/mod.rs:18-23)
    with default theta 0.75 (src/sims/tree.rs:42-51).

    Read by the port:
      theta: opening angle; a cell is accepted when width < theta * dist.
      max_depth: octree depth D; Morton keys have 3*D bits (D <= 20).
        Cells still holding more than ``leaf_bucket`` particles at depth D
        are terminal and direct-summed in bucket-sized chunks.
      node_capacity_factor: arena size = factor * N nodes (see
        ``capacity``); None resolves by bucket (4.0 for singleton leaves,
        1.0 below 8, 0.5 from 8 up). Overflow is flagged, never hangs.
      leaf_bucket: cells of at most this many particles are leaves; a leaf
        that fails the theta test is summed exactly over its particles.
      walk: "group" (the default: the tile walk of
        ``ops/tree_walk_group.py``, CUDA kernel ``csrc/tree_walk_group.cu``,
        at least as accurate as the per-particle walk for every receiver)
        or "per_particle" (the stackless walk of ``ops/tree_walk.py``, CUDA
        kernel ``csrc/tree_walk.cu``; also the group walk's fallback).
      walk_tile: receivers per group-walk tile (Morton-adjacent, inside
        one density-adaptive cell); None resolves by receiver count, 512
        at n >= 2**21, 256 below (``effective_walk_tile``). At most 512
        on CUDA tensors (the kernel holds four receivers per thread).
      walk_list_cap: a tile whose walk takes more than
        ``ceil(2*walk_list_cap/256)*256`` steps (one per visited node or
        emitted member row) defers its receivers to the per-particle walk.
      walk_block: read only where the JAX package reads it, in the static
        tile budget (``tree_walk_group._tile_assignment``), so the tiles
        are the JAX package's.
      walk_engine: "octet" (the JAX default) and "skip" both run the skip
        engine's walk here. The JAX octet engine tests theta against a
        9-bit quantized centre of gravity and so opens slightly more
        nodes; its tables are TPU gather-latency machinery (ROADMAP C).

    Carried with the JAX defaults and meanings (see
    ``wgpu_n_body_tpu/params.py``) so that records round-trip, and not
    read: ``walk_straggler_budget`` and ``walk_straggler_slots`` (the JAX
    second pass that restarts straggler tiles runs on the TPU only; its CPU
    path, which the port follows, is one pass, and a CUDA block finishes
    its own tile with no lockstep) and ``octet_capacity_factor`` (no octet
    tables are built).

    Read by the sharded tree (``parallel/sharded_tree.py``):
      let_import_list_cap: walk_list_cap of the split LET walk's import
        forest walk (``effective_import_list_cap``).
      let_fused: with ``walk="group"``, the fused LET walk: the imports
        packed slack-free behind the local arena (B8), one group walk at the
        full ``walk_list_cap`` over both. The JAX package fuses only under
        its octet engine; the port's walk is the skip engine for both
        values of ``walk_engine``, so it fuses under either. Default False
        (the split walk), as in the JAX package.
      let_forest_factor: the packed forest's rows, in let_caps
        (``let_forest_cap``); more kept import rows flag a LET overflow.
    """

    theta: float = 0.75
    max_depth: int = 16
    node_capacity_factor: float | None = None
    leaf_bucket: int = 16
    walk: str = "group"
    walk_tile: int | None = None
    walk_list_cap: int = 8192
    walk_block: int = 2048
    walk_straggler_budget: int = 2
    walk_straggler_slots: int = 8
    walk_engine: str = "octet"
    octet_capacity_factor: float | None = None
    let_import_list_cap: int | None = None
    let_fused: bool = False
    let_forest_factor: float = 2.5

    def let_forest_cap(self, p: int, let_cap: int) -> int:
        """Row capacity of the fused LET walk's compacted import forest:
        ``let_forest_factor`` let_caps, at least one, at most P * let_cap."""
        return min(p * let_cap, max(let_cap, int(self.let_forest_factor * let_cap)))

    def effective_import_list_cap(self) -> int:
        """walk_list_cap of the split LET schedule's import-forest walk:
        ``let_import_list_cap``, or 2048 capped by walk_list_cap."""
        if self.let_import_list_cap is not None:
            return self.let_import_list_cap
        return min(self.walk_list_cap, 2048)

    def effective_walk_tile(self, n: int) -> int:
        """walk_tile with the default resolved by receiver count n:
        512 at n >= 2**21, 256 below."""
        if self.walk_tile is not None:
            return self.walk_tile
        return 512 if n >= (1 << 21) else 256

    @property
    def effective_capacity_factor(self) -> float:
        """node_capacity_factor with the bucket-aware default resolved."""
        if self.node_capacity_factor is not None:
            return self.node_capacity_factor
        if self.leaf_bucket == 1:
            return 4.0
        return 0.5 if self.leaf_bucket >= 8 else 1.0

    def capacity(self, n: int) -> int:
        """Node-arena size for N particles (reference: 4N octants,
        src/sims/tree.rs:188-199). The auto default is floored at 4096
        for tiny N; an explicit node_capacity_factor is exact."""
        cap = int(self.effective_capacity_factor * n)
        if self.node_capacity_factor is None:
            cap = max(4096, cap)
        return cap + 1

    def octet_capacity(self, n: int) -> int:
        """Octet-table rows (internal nodes only) for N particles; the
        auto factor is 4.0 for singleton leaves, 0.5 below bucket 8 and
        0.06 from 8 up, floored at 16384 rows (4096 when explicit) and
        capped by the node capacity."""
        f = self.octet_capacity_factor
        if f is None:
            f = 4.0 if self.leaf_bucket == 1 else (
                0.5 if self.leaf_bucket < 8 else 0.06
            )
            return min(self.capacity(n), max(16384, int(n * f)))
        return min(self.capacity(n), max(4096, int(n * f)))


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


_ADD_PARAM_KINDS = {"naive": NaiveParams, "tree": TreeParams}


def params_from_dict(d: dict) -> SimParams | NaiveParams | TreeParams:
    """Parameters from ``dataclasses.asdict`` of either package's records.

    A dict with a ``"kind"`` key (``"naive"`` or ``"tree"``, the
    checkpoint's add-params record) gives that backend's params; one
    without gives SimParams.
    """
    d = dict(d)
    kind = d.pop("kind", None)
    if kind is None:
        return SimParams(**d)
    if kind not in _ADD_PARAM_KINDS:
        raise ValueError(f"unknown add-params kind {kind!r}")
    return _ADD_PARAM_KINDS[kind](**d)
