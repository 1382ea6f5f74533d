"""Compute ops: forces, integration, energy."""

from wgpu_n_body_tpu_torch.ops.integrate import leapfrog_step
from wgpu_n_body_tpu_torch.ops.naive_cuda import naive_forces_cuda
from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_dense, naive_forces_ref

__all__ = [
    "leapfrog_step",
    "naive_forces_cuda",
    "naive_forces_dense",
    "naive_forces_ref",
]
