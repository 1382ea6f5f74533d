"""Octree construction on the tensors' device — counterpart of
``wgpu_n_body_tpu/ops/tree_build.py`` (reference src/sims/tree.rs:417-602).

The same construction as the JAX package, in torch ops (sort, scans,
gathers), with results equal to it. ``morton_order`` is the plain version
of the key kernel and sort (``ops/morton_cuda.py``), ``build_tree`` of the
build kernels (``ops/tree_build_cuda.py``, ``csrc/tree_build.cu``), which
sort and build a CUDA state's arena. Keys are the packed int64 Morton keys
of ``ops/morton.py``:

- After the Morton sort, the cell of a node at level L is a run of equal
  3L-bit key prefixes. A node is real iff it is the root or its parent run
  holds more than ``leaf_bucket`` particles (the reference subdivides
  while >= 2, tree.rs:506-540, generalised to buckets).
- DFS node order equals lexicographic (first particle, level), so node
  indices are cumsums: ``offset[i]`` = real nodes starting at particles
  < i, a node's first child is the next index, and ``skip`` = ``offset``
  at the first particle past its run.
- Node payloads (cog = sum(m*p)/sum(m), mass, count) match tree.rs:484-505;
  a singleton leaf stores its particle's position exactly. Bound =
  max(|coord|, 1), root width = 2*bound (tree.rs:424-451).

The arena has ``cap = TreeParams.capacity(N)`` rows plus an inert sentinel
row ``cap``. More real nodes than ``cap`` clamp ``num_nodes`` to ``cap`` —
walks stay bounded and terminate, forces lose the truncated tail — and
set ``overflowed``. The JAX package emits nodes in 65536-row chunks up to
the last live one to save TPU work; here one vectorised pass over the
arena writes the same rows. The JAX octet tables (``octets``/
``octet_pts``) are not built: the port's group walk
(``ops/tree_walk_group.py``) walks this arena directly for both values of
``walk_engine``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from wgpu_n_body_tpu_torch.ops import morton, scan
from wgpu_n_body_tpu_torch.params import ParticleState, TreeParams

# nodes_f32 column layout
COG_X, COG_Y, COG_Z, MASS, WIDTH, IS_SINGLE, NO_CHILD = range(7)
NODE_F32_COLS = 8  # padded to 8: one row is two 16-byte loads

#: Far position of the sentinel row and of unused arena rows: far away yet
#: finite when squared in float32.
FAR = 1e15


class TreeArrays(NamedTuple):
    """Fixed-size octree in DFS order (the JAX package's layout).

    nodes_f32:  (cap+1, 8) float32 [cog xyz, mass, width, is_single,
                no_child, unused]; row ``cap`` is the inert sentinel.
    skip:       (cap+1,) int32 — next DFS node outside this subtree.
    first:      (cap+1,) int32 — the node's first particle in the sorted
                order; with ``count`` its contiguous particle range.
    count:      (cap+1,) int32 — particles in the node's subtree.
    num_nodes:  () int32 — real node count clamped to cap.
    root_width: () float32 — 2 * bound (tree.rs:450).
    overflowed: () bool — the unclamped node count exceeded cap.
    octets, octet_pts: the JAX octet engine's tables; always None here.
    split:      (n,) uint8 — per sorted particle, the shallowest level at
                which its key differs from its predecessor's
                (``morton.split_levels``); the group walk's tile set-up
                reads it on the card. None for an arena made elsewhere
                (the host build).

    ``NO_CHILD`` is 3-state: 0 = internal, 1 = terminal cell of at most
    leaf_bucket particles, 2 = terminal cell at max_depth holding more
    (the walk direct-sums it in bucket-sized chunks).
    """

    nodes_f32: torch.Tensor
    skip: torch.Tensor
    first: torch.Tensor
    count: torch.Tensor
    num_nodes: torch.Tensor
    root_width: torch.Tensor
    overflowed: torch.Tensor
    octets: torch.Tensor | None = None
    octet_pts: torch.Tensor | None = None
    split: torch.Tensor | None = None


def morton_order(pos: torch.Tensor, depth: int):
    """Morton ordering of positions: (perm (n,) int32, bound, sorted packed
    keys (n,) int64).

    bound = max(|coord|, 1.0) (tree.rs:424-446). The sort is stable on the
    packed key, so ties keep index order and ``perm`` equals the JAX
    package's ``(hi, lo, idx)`` lexsort.
    """
    bound = morton.bound_of(pos)
    keys, perm = torch.sort(morton.packed_keys(pos, bound, depth), stable=True)
    return perm.to(torch.int32), bound, keys


def reorder(state: ParticleState, perm: torch.Tensor) -> ParticleState:
    """The state in the order ``perm``: ``x[perm]`` for each field."""
    return ParticleState(*(t[perm] for t in state))


def morton_sort(state: ParticleState, depth: int):
    """Sort particles by Morton key (the reference's per-step reorder):
    (sorted state, bound, sorted packed keys)."""
    perm, bound, keys = morton_order(state.pos, depth)
    return reorder(state, perm), bound, keys


def prefix_sums(state_sorted: ParticleState) -> torch.Tensor:
    """(4, n+1) float64 prefix sums of mass, m*x, m*y, m*z (products in
    float32): column j holds the sum over particles [0, j). Four 1-D
    cumsums; on the card ``torch.cumsum`` does not return the same last
    bits from call to call."""
    pos, mass = state_sorted.pos, state_sorted.mass
    return scan.cumsum_ext(torch.cat([mass[:, None], mass[:, None] * pos], 1)).T.contiguous()


def build_tree(
    state_sorted: ParticleState,
    keys: torch.Tensor,
    bound: torch.Tensor,
    params: TreeParams,
    sums: torch.Tensor | None = None,
) -> TreeArrays:
    """Build the DFS node arena from Morton-sorted particles.

    ``sums``: the float64 prefix sums the node totals are differenced from,
    as ``prefix_sums`` returns them (the default computes them so). A caller
    that holds another build against this one passes that build's sums, so
    the two do not differ by the scans' summation order.

    Run structure at all levels comes from one split-level pass (run
    starts nest across levels) and one flat scan of the (depth+1, n) run
    starts; mass and cog totals from differencing the float64 prefix sum
    at run boundaries. Every scan is a 1-D one (on the GPU a device-wide
    scan; a scan along one axis of a 2-D tensor runs there as one thread
    block per row, or per column). Nothing is read back to the host.
    """
    depth = params.max_depth
    bucket = params.leaf_bucket
    pos, mass = state_sorted.pos, state_sorted.mass
    n = pos.shape[0]
    dev = pos.device
    cap = params.capacity(n)
    root_width = (2.0 * bound).to(torch.float32)
    i64 = torch.int64

    # Per-level runs: particle i starts a run at exactly the levels >= s[i].
    # The (depth+1, n) start flags are scanned as ONE flat 1-D cumsum (run
    # ids), and each run's first flat index is scattered once: a run's
    # start is that of its id, its end the start of the next id. Particle
    # 0 starts a run at every level, so the run after a level's last run
    # begins exactly one row of n later, which reads back as end n. (The
    # JAX package's cummax/cummin over the level rows would run on the GPU
    # as one thread block per row.)
    s = morton.split_levels(keys, depth)
    rows = (depth + 1) * n
    lv = torch.arange(depth + 1, dtype=i64, device=dev)[:, None]
    start = (s[None, :] <= lv).reshape(-1)
    run_id = torch.cumsum(start, 0) - 1
    run_first = torch.full((rows + 2,), rows, dtype=i64, device=dev)  # slot rows+1: dropped
    run_first.scatter_(
        0,
        torch.where(start, run_id, rows + 1),
        torch.arange(rows, dtype=i64, device=dev),
    )
    del start
    run_end = run_first[run_id + 1]  # flat index of the next run's first particle
    counts = run_end - run_first[run_id]  # run size containing i, per level
    del run_id, run_first
    re_all = (run_end.view(depth + 1, n) - lv * n).reshape(-1)  # run end per level, as i
    del run_end

    # Run sizes shrink with level, so particle i's real levels are the
    # contiguous range [s[i], min(t[i], depth)], t[i] = number of levels
    # whose containing run still exceeds the bucket.
    t = (counts > bucket).reshape(depth + 1, n).sum(0)
    del counts
    c_per_particle = torch.clamp(torch.clamp(t, max=depth) - s + 1, min=0)
    csum = torch.cumsum(c_per_particle, 0)
    offset = csum - c_per_particle  # exclusive scan
    num_nodes_raw = csum[-1]
    num_nodes = torch.clamp(num_nodes_raw, max=cap)
    offset_ext = torch.cat([offset, num_nodes_raw[None]])

    # Inverse mapping node -> (first particle, level): node k belongs to
    # the particle whose node range [offset, csum) holds k (a binary
    # search over csum), at the level given by k's rank in that range.
    kk = torch.arange(cap, dtype=i64, device=dev)
    pon = torch.clamp(torch.searchsorted(csum, kk, right=True), max=max(n - 1, 0))
    lvl = torch.clamp(s[pon] + (kk - offset[pon]), 0, depth)
    valid = kk < num_nodes
    re_k = re_all[lvl * n + pon]
    del re_all
    count_k = re_k - pon

    if sums is None:
        sums = prefix_sums(state_sorted)
    cs_hi, cs_lo = scan.ff_split(sums.T)
    tot = (cs_hi[re_k] - cs_hi[pon]) + (cs_lo[re_k] - cs_lo[pon])  # (cap, 4)
    del cs_hi, cs_lo
    is_single = count_k == 1
    # cog: the particle's exact position for singletons (tree.rs:525-529)
    cog = torch.where(is_single[:, None], pos[pon], tot[:, 1:4] / tot[:, 0:1])
    # width = root_width * 2^-level, by a table of exact powers of two
    pow2 = torch.tensor([2.0**-k for k in range(depth + 1)], dtype=torch.float32, device=dev)
    width = root_width * pow2[lvl]
    terminal = (count_k <= bucket) | (lvl == depth)
    no_child = torch.where(
        terminal,
        torch.where(count_k > bucket, 2.0, 1.0),
        0.0,
    ).to(torch.float32)
    rows = torch.cat(
        [
            cog,
            tot[:, 0:1],
            width[:, None],
            is_single.to(torch.float32)[:, None],
            no_child[:, None],
            torch.zeros((cap, 1), dtype=torch.float32, device=dev),
        ],
        1,
    )
    sentinel = torch.zeros((1, NODE_F32_COLS), dtype=torch.float32, device=dev)
    sentinel[0, COG_X] = FAR
    sentinel[0, NO_CHILD] = 1.0
    nodes = torch.cat([torch.where(valid[:, None], rows, sentinel), sentinel])

    def with_tail(x, tail):
        return torch.cat([x, torch.full((1,), tail, dtype=i64, device=dev)]).to(torch.int32)

    return TreeArrays(
        nodes_f32=nodes,
        skip=with_tail(torch.where(valid, offset_ext[re_k], cap), cap),
        first=with_tail(torch.where(valid, pon, n), n),
        count=with_tail(torch.where(valid, count_k, 0), 0),
        num_nodes=num_nodes.to(torch.int32),
        root_width=root_width,
        overflowed=num_nodes_raw > cap,
        split=s.to(torch.uint8),
    )
