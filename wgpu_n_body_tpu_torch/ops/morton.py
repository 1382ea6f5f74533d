"""Morton (Z-order) keys — counterpart of ``wgpu_n_body_tpu/ops/morton.py``.

The reference's child index ``(x>cx) | (y>cy)<<1 | (z>cz)<<2``
(tree.rs:549-553) makes its tree-DFS particle order exactly Morton order
with x as the lowest interleaved bit, so sorting by Morton key is the
reference's per-step reorder, and the octree cells at depth L are runs of
equal 3L-bit key prefixes.

Keys are 3*D bits (D = max depth <= 20). The JAX package splits them into
(hi, lo): hi holds levels 1..min(D, 10) in its low 3*min(D, 10) bits, lo
the levels below; ``morton_keys`` returns that pair as int64 tensors
holding the JAX package's uint32 values bit for bit (torch has no usable
uint32 arithmetic on CUDA). The port sorts and builds from one packed
int64 key, ``hi << 3*d_lo | lo`` (d_lo = D - min(D, 10)): 48 bits at the
default depth 16, 60 at depth 20, level L at bits [3(D-L), 3(D-L)+2].
``packed_keys`` is the plain version of the key kernel
(``csrc/morton_keys.cu``); ``unpack_keys`` gives back (hi, lo).
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


def pack_keys(hi: torch.Tensor, lo: torch.Tensor, depth: int) -> torch.Tensor:
    """The packed key ``hi << 3*d_lo | lo`` of (hi, lo) keys at ``depth``."""
    return (hi << (3 * (depth - min(depth, 10)))) | lo


def unpack_keys(key: torch.Tensor, depth: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of packed keys at ``depth``: the JAX package's two halves."""
    lo_bits = 3 * (depth - min(depth, 10))
    return key >> lo_bits, key & ((1 << lo_bits) - 1)


def bound_of(pos: torch.Tensor) -> torch.Tensor:
    """The root's half width max(|coord|, 1) (tree.rs:424-446), float32."""
    one = torch.ones((), dtype=pos.dtype, device=pos.device)
    return torch.maximum(one, pos.abs().amax())


def packed_keys(pos: torch.Tensor, bound: torch.Tensor, depth: int) -> torch.Tensor:
    """(N,) int64 packed Morton keys of float32 positions: the plain version
    of ``morton_keys_kernel`` (``quantize``, ``morton_keys``, packed)."""
    return pack_keys(*morton_keys(quantize(pos, bound, depth), depth), depth)


def highest_bit(v: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each non-negative int64 (0 for 0):
    the exact integer ``63 - clzll``.

    The binary exponent of the value's high or low 32 bits as a float64,
    which holds every such integer exactly (unlike a float ``log2``, which
    can round up at powers of two, or the float64 of a 60-bit value)."""
    high = v >> 32
    part = torch.where(high != 0, high, v)
    exp = torch.clamp(torch.frexp(part.to(torch.float64)).exponent.to(v.dtype) - 1, min=0)
    return exp + torch.where(high != 0, 32, 0)


def diff_levels(a: torch.Tensor, b: torch.Tensor, depth: int) -> torch.Tensor:
    """int64: the shallowest level at which packed keys ``a`` and ``b``
    differ, ``depth + 1`` where they are equal. Level L sits at bits
    [3(depth-L), 3(depth-L)+2], so it is ``depth - highest_bit(a ^ b) // 3``."""
    x = a ^ b
    return torch.where(x != 0, depth - highest_bit(x) // 3, depth + 1)


def split_levels(keys: torch.Tensor, depth: int) -> torch.Tensor:
    """(n,) int64 of sorted packed keys: the shallowest level at which
    key[i] differs from key[i-1] — particle i starts a new cell run at
    exactly the levels >= split_levels[i]. Element 0 is 0 (a run start
    everywhere); identical adjacent keys give depth+1 (never a start)."""
    zero = torch.zeros(min(1, keys.shape[0]), dtype=torch.int64, device=keys.device)
    return torch.cat([zero, diff_levels(keys[:-1], keys[1:], depth)])


def window_levels(keys: torch.Tensor, depth: int, bucket: int) -> torch.Tensor:
    """(n,) int64 of sorted packed keys: the shallowest level at which
    key[i] differs from key[i+bucket], 0 where i + bucket >= n (the build
    kernels' ``window``, ``csrc/tree_build.cu``)."""
    n = keys.shape[0]
    tail = torch.zeros(min(bucket, n), dtype=torch.int64, device=keys.device)
    return torch.cat([diff_levels(keys[: max(n - bucket, 0)], keys[bucket:], depth), tail])


def prefix_at_level(
    hi: torch.Tensor, lo: torch.Tensor, level: int, depth: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Truncate 3*depth-bit keys to their first 3*level bits (node id at level)."""
    d_hi = min(depth, 10)
    d_lo = depth - d_hi
    if level <= d_hi:
        return hi >> (3 * (d_hi - level)), torch.zeros_like(lo)
    return hi, lo >> (3 * (d_lo - (level - d_hi)))
