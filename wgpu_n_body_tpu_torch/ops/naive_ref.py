"""Plain torch O(N^2) softened-gravity force — the kernel's plain version.

Counterpart of ``wgpu_n_body_tpu/ops/naive_ref.py`` (naive.wgsl:23-48):

    for each pair (i, j), j != i:
        acc_i += m_j*g*dt * rsqrt(r^2) / (r^3 + e) * (p_old_j - p_new_i)

written in the order of operations of the all-pairs kernel
(``wgpu_n_body_tpu/ops/naive_pallas.py::_kernel`` and its CUDA port
``csrc/naive_forces.cu``), so that the kernel and this function differ
only in summation order, FMA contraction and the kernel's approximate
(flush-to-zero) rsqrt and divide. Only the self pair (global i == j) is
skipped; two *distinct* coincident particles give NaN, as WGSL's
normalize(0).

``row_offset`` is the global index of receiver row 0, for receivers that
are a slice of the sources (the kernel's shard case), or a (N_recv,)
tensor of each receiver's global index (a sample of the sources).

``naive_forces_mxu_ref`` is the plain version of the factored kernel
(``naive_pallas.py::_kernel_mxu``; the factored form of
``csrc/naive_forces.cu``): the same weights, accumulated as
Σw·p_old_j − p_new_i·Σw. The sums are
elementwise products reduced by ``torch.sum``, not a matrix product, so no
TF32 setting can touch them (the TPU kernel's dot runs at
``Precision.HIGHEST``).
"""

from __future__ import annotations

import torch

from wgpu_n_body_tpu_torch.params import SimParams


def _pair_weights(pos_i_new, idx_i, pos_old, mass, params: SimParams):
    """(B, N) weights w = m_j*g*dt * rsqrt(r^2) / (r^3 + e) of receivers
    ``pos_i_new`` with global indices ``idx_i`` against all sources (0 on
    the self pair), and the (B, N, 3) offsets d = p_old_j - p_new_i."""
    d = pos_old[None, :, :] - pos_i_new[:, None, :]  # (B, N, 3) = b - a
    r2 = torch.sum(d * d, dim=-1)  # (B, N)
    idx_j = torch.arange(pos_old.shape[0], device=pos_old.device)
    self_mask = idx_i[:, None] == idx_j[None, :]
    inv_r = torch.rsqrt(torch.where(self_mask, 1.0, r2))
    r = r2 * inv_r  # = sqrt(r2)
    mgdt = mass * (params.g * params.dt)
    w = mgdt[None, :] * inv_r / (r2 * r + params.e)
    return torch.where(self_mask, 0.0, w), d


def _recv_idx(pos_new, row_offset):
    if isinstance(row_offset, torch.Tensor):
        return row_offset.to(device=pos_new.device, dtype=torch.int64)
    return row_offset + torch.arange(pos_new.shape[0], device=pos_new.device)


def naive_forces_dense(pos_new, pos_old, mass, params: SimParams, row_offset=0):
    """(N_recv, 3) acc*dt via one dense (N_recv, N_src) evaluation."""
    w, d = _pair_weights(pos_new, _recv_idx(pos_new, row_offset), pos_old, mass, params)
    return torch.sum(w[:, :, None] * d, dim=1)


def naive_forces_mxu_dense(pos_new, pos_old, mass, params: SimParams, row_offset=0):
    """(N_recv, 3) acc*dt, factored: Σ_j w·p_old_j − p_new_i·Σ_j w."""
    w, _ = _pair_weights(pos_new, _recv_idx(pos_new, row_offset), pos_old, mass, params)
    s_p = torch.sum(w[:, :, None] * pos_old[None, :, :], dim=1)
    return s_p - pos_new * torch.sum(w, dim=1, keepdim=True)


def _blocked(dense, pos_new, pos_old, mass, params, block, row_offset):
    n = pos_new.shape[0]
    if n <= block:
        return dense(pos_new, pos_old, mass, params, row_offset)
    idx = _recv_idx(pos_new, row_offset)
    return torch.cat(
        [
            dense(pos_new[s : s + block], pos_old, mass, params, idx[s : s + block])
            for s in range(0, n, block)
        ]
    )


def naive_forces_ref(
    pos_new, pos_old, mass, params: SimParams, block: int = 2048, row_offset=0
):
    """(N_recv, 3) acc*dt evaluated in receiver row blocks of ``block``,
    so memory stays O(block * N_src)."""
    return _blocked(naive_forces_dense, pos_new, pos_old, mass, params, block, row_offset)


def naive_forces_mxu_ref(
    pos_new, pos_old, mass, params: SimParams, block: int = 2048, row_offset=0
):
    """The factored force of ``naive_forces_mxu_dense`` in receiver row
    blocks of ``block``."""
    return _blocked(
        naive_forces_mxu_dense, pos_new, pos_old, mass, params, block, row_offset
    )
