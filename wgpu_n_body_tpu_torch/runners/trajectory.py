"""Trajectory dump / replay — counterpart of
``wgpu_n_body_tpu/runners/trajectory.py``, with the same on-disk format:
one ``pos_%08d.npy`` (and optionally ``vel_%08d.npy``) per dumped step
plus a ``meta.json`` manifest, so either package reads the other's dumps.
"""

from __future__ import annotations

import json
import os

import numpy as np

from wgpu_n_body_tpu_torch.params import ParticleState


class TrajectoryWriter:
    """Writes position (and optionally velocity) frames under ``root``."""

    def __init__(self, root: str, save_velocity: bool = False, meta: dict | None = None):
        self.root = root
        self.save_velocity = save_velocity
        self.steps: list[int] = []
        self._meta = dict(meta or {})
        os.makedirs(root, exist_ok=True)

    def append(self, state: ParticleState, step: int) -> None:
        np.save(
            os.path.join(self.root, f"pos_{step:08d}.npy"), state.pos.detach().cpu().numpy()
        )
        if self.save_velocity:
            np.save(
                os.path.join(self.root, f"vel_{step:08d}.npy"),
                state.vel.detach().cpu().numpy(),
            )
        self.steps.append(int(step))
        self._flush_meta()

    def _flush_meta(self) -> None:
        manifest = {"steps": self.steps, "save_velocity": self.save_velocity, **self._meta}
        tmp = os.path.join(self.root, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(self.root, "meta.json"))


class TrajectoryReader:
    """Iterates frames written by TrajectoryWriter (of either package)."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "meta.json")) as f:
            self.meta = json.load(f)
        self.steps: list[int] = self.meta["steps"]

    def __len__(self) -> int:
        return len(self.steps)

    def positions(self, i: int) -> np.ndarray:
        return np.load(os.path.join(self.root, f"pos_{self.steps[i]:08d}.npy"))

    def __iter__(self):
        for i in range(len(self)):
            yield self.steps[i], self.positions(i)
