"""Morton (Z-order) keys — counterpart of ``wgpu_n_body_tpu/ops/morton.py``.

The reference's child index ``(x>cx) | (y>cy)<<1 | (z>cz)<<2``
(tree.rs:549-553) makes its tree-DFS particle order exactly Morton order
with x as the lowest interleaved bit, so sorting by Morton key is the
reference's per-step reorder, and the octree cells at depth L are runs of
equal 3L-bit key prefixes.

Keys are 3*D bits (D = max depth <= 20), split as in the JAX package into
(hi, lo): hi holds levels 1..min(D, 10) in its low 3*min(D, 10) bits, lo
the levels below. Both halves are at most 30 bits, so they are computed
and returned as int64 tensors holding the JAX package's uint32 values
bit for bit (torch has no usable uint32 arithmetic on CUDA).
"""

from __future__ import annotations

import torch


def _spread_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Insert two zero bits between each of the low 10 bits (int64)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def quantize(pos: torch.Tensor, bound: torch.Tensor, depth: int) -> torch.Tensor:
    """(N, 3) int64 cells in [0, 2^depth) of float32 positions in
    [-bound, bound]^3 (reference tree.rs:457-471: root centred at the
    origin, width 2*bound).

    Float32 end to end, in the JAX package's order of operations:
    ``(pos + bound) * (2^depth / (2*bound))``, clipped, truncated. ``bound``
    is made a float32 tensor first, so a Python float cannot promote the
    arithmetic to float64.
    """
    bound = torch.as_tensor(bound, dtype=torch.float32, device=pos.device)
    # tensor / tensor: a Python number on the left would make torch take
    # reciprocal-then-multiply, two roundings instead of one divide
    cells_per_side = torch.tensor(2.0**depth, dtype=torch.float32, device=pos.device)
    scale = cells_per_side / (2.0 * bound)
    cells = (pos + bound) * scale
    cells = torch.clamp(cells, 0.0, 2.0**depth - 1.0)
    return cells.to(torch.int64)


def morton_keys(cell: torch.Tensor, depth: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) Morton keys of (N, 3) integer cells at ``depth``.

    Bit layout per level (most significant first): z y x — matching
    decide_octant's ``x | y<<1 | z<<2`` (tree.rs:549-553).
    """
    if depth > 20:
        raise ValueError("max supported depth is 20 (60-bit keys)")
    d_hi = min(depth, 10)
    d_lo = depth - d_hi
    cell = cell.to(torch.int64)
    x, y, z = cell[:, 0], cell[:, 1], cell[:, 2]
    xh, yh, zh = (v >> d_lo for v in (x, y, z))
    hi = _spread_bits_10(xh) | (_spread_bits_10(yh) << 1) | (_spread_bits_10(zh) << 2)
    if d_lo == 0:
        return hi, torch.zeros_like(hi)
    mask = (1 << d_lo) - 1
    xl, yl, zl = (v & mask for v in (x, y, z))
    lo = _spread_bits_10(xl) | (_spread_bits_10(yl) << 1) | (_spread_bits_10(zl) << 2)
    return hi, lo


def highest_bit(v: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each non-negative int64 below 2^53
    (0 for 0): the exact integer ``31 - clz`` of 32-bit values.

    The binary exponent of the value as a float64, which holds every such
    integer exactly (unlike a float ``log2``, which can round up at powers
    of two); three kernels instead of a 36-kernel binary search.
    """
    return torch.clamp(torch.frexp(v.to(torch.float64)).exponent.to(v.dtype) - 1, min=0)


def split_levels(hi: torch.Tensor, lo: torch.Tensor, depth: int) -> torch.Tensor:
    """(n,) int64: the shallowest level at which key[i] differs from
    key[i-1] — particle i starts a new cell run at exactly the levels
    >= split_levels[i]. Element 0 is 0 (a run start everywhere); identical
    adjacent keys give depth+1 (never a start)."""
    d_hi = min(depth, 10)
    xh = hi[1:] ^ hi[:-1]
    xl = lo[1:] ^ lo[:-1]
    # hi holds levels 1..d_hi, level L at bits [3*(d_hi-L)+2 : 3*(d_hi-L)];
    # lo holds levels d_hi+1..depth likewise.
    lvl = torch.where(
        xh != 0,
        d_hi - highest_bit(xh) // 3,
        torch.where(xl != 0, depth - highest_bit(xl) // 3, depth + 1),
    )
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=hi.device), lvl])


def prefix_at_level(
    hi: torch.Tensor, lo: torch.Tensor, level: int, depth: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Truncate 3*depth-bit keys to their first 3*level bits (node id at level)."""
    d_hi = min(depth, 10)
    d_lo = depth - d_hi
    if level <= d_hi:
        return hi >> (3 * (d_hi - level)), torch.zeros_like(lo)
    return hi, lo >> (3 * (d_lo - (level - d_hi)))
