"""Plain torch O(N^2) softened-gravity force — the kernel's plain version.

Counterpart of ``wgpu_n_body_tpu/ops/naive_ref.py`` (naive.wgsl:23-48):

    for each pair (i, j), j != i:
        acc_i += m_j*g*dt * rsqrt(r^2) / (r^3 + e) * (p_old_j - p_new_i)

written in the order of operations of the all-pairs kernel
(``wgpu_n_body_tpu/ops/naive_pallas.py::_kernel`` and its CUDA port
``csrc/naive_forces.cu``), so that the kernel and this function differ
only in summation order. Only the self pair (global i == j) is skipped;
two *distinct* coincident particles give NaN, as WGSL's normalize(0).

``row_offset`` is the global index of receiver row 0, for receivers that
are a slice of the sources (the kernel's shard case).
"""

from __future__ import annotations

import torch

from wgpu_n_body_tpu_torch.params import SimParams


def _pair_acc(pos_i_new, idx_i, pos_old, mass, params: SimParams):
    """(B, 3) acc*dt of receivers ``pos_i_new`` with global indices
    ``idx_i`` against all sources."""
    d = pos_old[None, :, :] - pos_i_new[:, None, :]  # (B, N, 3) = b - a
    r2 = torch.sum(d * d, dim=-1)  # (B, N)
    idx_j = torch.arange(pos_old.shape[0], device=pos_old.device)
    self_mask = idx_i[:, None] == idx_j[None, :]
    inv_r = torch.rsqrt(torch.where(self_mask, 1.0, r2))
    r = r2 * inv_r  # = sqrt(r2)
    mgdt = mass * (params.g * params.dt)
    w = mgdt[None, :] * inv_r / (r2 * r + params.e)
    w = torch.where(self_mask, 0.0, w)
    return torch.sum(w[:, :, None] * d, dim=1)


def naive_forces_dense(pos_new, pos_old, mass, params: SimParams, row_offset: int = 0):
    """(N_recv, 3) acc*dt via one dense (N_recv, N_src) evaluation."""
    idx = row_offset + torch.arange(pos_new.shape[0], device=pos_new.device)
    return _pair_acc(pos_new, idx, pos_old, mass, params)


def naive_forces_ref(
    pos_new, pos_old, mass, params: SimParams, block: int = 2048, row_offset: int = 0
):
    """(N_recv, 3) acc*dt evaluated in receiver row blocks of ``block``,
    so memory stays O(block * N_src)."""
    n = pos_new.shape[0]
    if n <= block:
        return naive_forces_dense(pos_new, pos_old, mass, params, row_offset)
    return torch.cat(
        [
            naive_forces_dense(
                pos_new[s : s + block], pos_old, mass, params, row_offset + s
            )
            for s in range(0, n, block)
        ]
    )
