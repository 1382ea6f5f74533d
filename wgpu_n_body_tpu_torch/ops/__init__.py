"""Compute ops: forces, integration, energy, the octree and its walk."""

from wgpu_n_body_tpu_torch.ops.integrate import leapfrog_step
from wgpu_n_body_tpu_torch.ops.naive_cuda import naive_forces_cuda
from wgpu_n_body_tpu_torch.ops.naive_ref import (
    naive_forces_dense,
    naive_forces_mxu_ref,
    naive_forces_ref,
)
from wgpu_n_body_tpu_torch.ops.tree_build import build_tree, morton_sort
from wgpu_n_body_tpu_torch.ops.tree_walk import tree_forces
from wgpu_n_body_tpu_torch.ops.tree_walk_cuda import tree_forces_cuda
from wgpu_n_body_tpu_torch.ops.tree_walk_group import GroupWalkStats, group_tree_forces
from wgpu_n_body_tpu_torch.ops.tree_walk_group_cuda import group_tree_forces_cuda

__all__ = [
    "GroupWalkStats",
    "build_tree",
    "group_tree_forces",
    "group_tree_forces_cuda",
    "leapfrog_step",
    "morton_sort",
    "naive_forces_cuda",
    "naive_forces_dense",
    "naive_forces_mxu_ref",
    "naive_forces_ref",
    "tree_forces",
    "tree_forces_cuda",
]
