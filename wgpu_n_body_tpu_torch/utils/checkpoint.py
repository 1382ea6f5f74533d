"""Checkpoint / resume — counterpart of ``wgpu_n_body_tpu/utils/checkpoint.py``.

The same format: one atomic .npz holding the SoA state arrays and a
format-versioned JSON meta record (step, SimParams, the backend's
add-params, the multi-chip schedule). A checkpoint written by the JAX
package loads here, and one written here loads in the JAX package.
A ``TreeSimHost`` run records ``kind: "tree"`` with its ``TreeParams``
(``leaf_bucket=1``), as the JAX package does, and so reloads as a
``TreeSim`` with singleton leaves. A sharded run records its schedule as
the JAX package does, ``{"name", "let_cap", "mesh_axes": {"particles":
P}}``, and resumes onto any number of ranks: ``load_checkpoint(...,
mesh=)`` gives each rank its slice and ``make_sim(mesh=)`` the sharded
backend (a LET run's ownership is a contiguous re-slice, which a reshard
compacts).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from wgpu_n_body_tpu_torch.params import (
    NaiveParams,
    ParticleState,
    SimParams,
    TreeParams,
    params_from_dict,
    state_from_numpy,
    state_to_numpy,
)

_FORMAT_VERSION = 2


class Checkpoint(NamedTuple):
    """A loaded checkpoint. ``make_sim()`` reconstructs the backend."""

    state: ParticleState
    params: SimParams
    step: int
    add_params: NaiveParams | TreeParams | None
    schedule: dict | None  # {"name", "let_cap", "mesh_axes"} for sharded runs

    def make_sim(self, mesh=None):
        """Rebuild the Simulator this checkpoint was written by (no
        add-params means a TreeSim with default TreeParams, as in JAX). A
        sharded run's needs ``mesh`` (``parallel.make_mesh``), of any size
        that divides N."""
        from wgpu_n_body_tpu_torch.models.naive import NaiveSim
        from wgpu_n_body_tpu_torch.models.tree import TreeSim

        ap = self.add_params
        if self.schedule is not None:
            if mesh is None:
                raise ValueError(
                    f"checkpoint holds a sharded {self.schedule['name']!r} run over mesh axes "
                    f"{self.schedule['mesh_axes']}; pass mesh= to resume"
                )
            from wgpu_n_body_tpu_torch.parallel import ShardedNaiveSim, ShardedTreeSim

            if isinstance(ap, NaiveParams):
                return ShardedNaiveSim(self.params, mesh, ap, schedule=self.schedule["name"])
            return ShardedTreeSim(self.params, mesh, ap, schedule=self.schedule["name"],
                                  let_cap=self.schedule.get("let_cap"))
        if isinstance(ap, NaiveParams):
            return NaiveSim(self.params, ap)
        return TreeSim(self.params, ap)


def save_checkpoint(
    path: str, state: ParticleState, params: SimParams, step: int, sim=None
) -> None:
    """Atomically write state+params+step (and, when ``sim`` is given, its
    add-params and, for a sharded backend, its schedule) to ``path``
    (.npz). ``state`` is the whole state (``OfflineHeadless.whole_state``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ap = getattr(sim, "add_params", None)
    kind = {NaiveParams: "naive", TreeParams: "tree"}.get(type(ap))
    mesh = getattr(sim, "mesh", None)
    meta = {
        "version": _FORMAT_VERSION,
        "step": int(step),
        "params": dataclasses.asdict(params),
        "add_params": None if kind is None else {"kind": kind, **dataclasses.asdict(ap)},
        "schedule": None if mesh is None else {
            "name": sim.schedule,
            "let_cap": getattr(sim, "let_cap", None),
            "mesh_axes": dict(mesh.shape),
        },
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            **state_to_numpy(state),
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        )
    os.replace(tmp, path)


def load_checkpoint(path: str, device: str | torch.device | None = None, mesh=None) -> Checkpoint:
    """Load a checkpoint of either package onto ``device``, or, given a
    ``mesh``, this rank's slice of it onto the mesh's device."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["version"] not in (1, _FORMAT_VERSION):
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        state = state_from_numpy(z["pos"], z["vel"], z["acc"], z["mass"], device or "cpu")
    if mesh is not None:
        from wgpu_n_body_tpu_torch.parallel.mesh import shard_state

        state = shard_state(state, mesh)
    add_params = meta.get("add_params")
    if add_params is not None:
        add_params = params_from_dict(add_params)
    return Checkpoint(
        state=state,
        params=params_from_dict(meta["params"]),
        step=meta["step"],
        add_params=add_params,
        schedule=meta.get("schedule"),
    )
