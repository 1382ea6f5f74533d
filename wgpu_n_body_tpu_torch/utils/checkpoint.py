"""Checkpoint / resume — counterpart of ``wgpu_n_body_tpu/utils/checkpoint.py``.

The same format: one atomic .npz holding the SoA state arrays and a
format-versioned JSON meta record (step, SimParams, the backend's
add-params, the multi-chip schedule). A checkpoint written by the JAX
package loads here, and one written here loads in the JAX package.
A ``TreeSimHost`` run records ``kind: "tree"`` with its ``TreeParams``
(``leaf_bucket=1``), as the JAX package does, and so reloads as a
``TreeSim`` with singleton leaves. Sharded schedules load as their recorded
dicts; ``make_sim`` raises for them until those backends are ported.
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

    def make_sim(self):
        """Rebuild the Simulator this checkpoint was written by (no
        add-params means a TreeSim with default TreeParams, as in JAX)."""
        from wgpu_n_body_tpu_torch.models.naive import NaiveSim
        from wgpu_n_body_tpu_torch.models.tree import TreeSim

        if self.schedule is not None:
            raise NotImplementedError(
                f"checkpoint holds a sharded {self.schedule['name']!r} run; "
                "multi-GPU backends are not ported yet (ROADMAP A13)"
            )
        if isinstance(self.add_params, NaiveParams):
            return NaiveSim(self.params, self.add_params)
        return TreeSim(self.params, self.add_params)


def save_checkpoint(
    path: str, state: ParticleState, params: SimParams, step: int, sim=None
) -> None:
    """Atomically write state+params+step (and, when ``sim`` is given, its
    add-params) to ``path`` (.npz)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ap = getattr(sim, "add_params", None)
    kind = {NaiveParams: "naive", TreeParams: "tree"}.get(type(ap))
    meta = {
        "version": _FORMAT_VERSION,
        "step": int(step),
        "params": dataclasses.asdict(params),
        "add_params": None if kind is None else {"kind": kind, **dataclasses.asdict(ap)},
        "schedule": None,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            **state_to_numpy(state),
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        )
    os.replace(tmp, path)


def load_checkpoint(path: str, device: str | torch.device) -> Checkpoint:
    """Load a checkpoint of either package onto ``device``."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["version"] not in (1, _FORMAT_VERSION):
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        state = state_from_numpy(z["pos"], z["vel"], z["acc"], z["mass"], device)
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
