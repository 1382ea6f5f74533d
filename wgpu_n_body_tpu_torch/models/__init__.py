"""Simulation backends (the reference's `sims` module)."""

from wgpu_n_body_tpu_torch.models.base import Simulator
from wgpu_n_body_tpu_torch.models.naive import NaiveSim
from wgpu_n_body_tpu_torch.models.tree import TreeSim
from wgpu_n_body_tpu_torch.models.tree_host import TreeSimHost

__all__ = ["Simulator", "NaiveSim", "TreeSim", "TreeSimHost"]
