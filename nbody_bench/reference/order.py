"""The Morton order of a step: which body each output row holds.

A frozen copy of ``wgpu_n_body_tpu_torch/ops/morton.py`` (``bound_of``,
``quantize``, ``morton_keys``, ``pack_keys``) and
``ops/tree_build.py::morton_order`` at commit d60e59f: float32 cells of
``(pos + bound) * (2^D / (2 bound))``, clipped and truncated, interleaved
z y x per level (upstream tree.rs:549-553), packed into one int64 key, and
a stable sort, so that ties keep index order.
"""

from __future__ import annotations

import torch


def _spread_bits_10(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def bound_of(pos: torch.Tensor) -> torch.Tensor:
    """The root's half width max(|coord|, 1) (upstream tree.rs:424-446)."""
    one = torch.ones((), dtype=pos.dtype, device=pos.device)
    return torch.maximum(one, pos.abs().amax())


def packed_keys(pos: torch.Tensor, bound: torch.Tensor, depth: int) -> torch.Tensor:
    """(N,) int64 packed Morton keys of 3*depth bits, level L at bits
    [3(depth-L), 3(depth-L)+2]."""
    bound = torch.as_tensor(bound, dtype=pos.dtype, device=pos.device)
    cells_per_side = torch.tensor(2.0**depth, dtype=pos.dtype, device=pos.device)
    scale = cells_per_side / (2.0 * bound)
    cell = torch.clamp((pos + bound) * scale, 0.0, 2.0**depth - 1.0).to(torch.int64)
    d_hi = min(depth, 10)
    d_lo = depth - d_hi
    x, y, z = cell[:, 0], cell[:, 1], cell[:, 2]
    xh, yh, zh = (v >> d_lo for v in (x, y, z))
    hi = _spread_bits_10(xh) | (_spread_bits_10(yh) << 1) | (_spread_bits_10(zh) << 2)
    if d_lo == 0:
        return hi
    mask = (1 << d_lo) - 1
    xl, yl, zl = (v & mask for v in (x, y, z))
    lo = _spread_bits_10(xl) | (_spread_bits_10(yl) << 1) | (_spread_bits_10(zl) << 2)
    return (hi << (3 * d_lo)) | lo


def morton_order(pos: torch.Tensor, depth: int):
    """(perm (N,) int64, bound, sorted keys (N,) int64): the stable sort of
    the packed keys."""
    bound = bound_of(pos)
    keys, perm = torch.sort(packed_keys(pos, bound, depth), stable=True)
    return perm, bound, keys
