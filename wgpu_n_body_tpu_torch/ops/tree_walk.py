"""Per-particle theta walk, plain torch — counterpart of
``wgpu_n_body_tpu/ops/tree_walk.py`` (reference tree.wgsl:41-90), and the
plain version of the CUDA kernel ``csrc/tree_walk.cu``
(``ops/tree_walk_cuda.py``).

The DFS arena of ``ops/tree_build.py`` makes the walk stackless:

    cur = 0
    while cur < num_nodes:
        accepted or leaf  -> cur = skip[cur]   (jump over the subtree)
        opened            -> cur = cur + 1     (first child is adjacent)

All receivers advance in lockstep, one gathered node row per iteration,
exactly as the JAX package's ``lax.while_loop``. Per node:

- accept when width < theta * dist; the contribution is
  ``mass*g*dt / (r2*dist + e) / dist * d`` (tree.wgsl:63-69);
- a terminal cell that fails the test is summed directly over its
  particle range, the self pair excluded by index (``self_idx``); a
  max-depth cell holding more than ``leaf_bucket`` particles is consumed
  in bucket-sized chunks, the receiver staying on the node until done;
- each iteration's contribution (node term, then members in order) is
  summed before it joins the running total, as JAX's ``acc + stack(...)``.

theta = 0 therefore opens everything and gives the exact all-pairs sum.
Distinct coincident particles give NaN, as in the naive force.
"""

from __future__ import annotations

import torch

from wgpu_n_body_tpu_torch.ops.tree_build import FAR, MASS, NO_CHILD, WIDTH, TreeArrays
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams


def tree_forces(
    pos_new: torch.Tensor,
    src_pos: torch.Tensor,
    src_mass: torch.Tensor,
    tree: TreeArrays,
    params: SimParams,
    tree_params: TreeParams,
    active: torch.Tensor | None = None,
    self_idx: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, 3) acc*dt via per-particle stackless DFS walks, in lockstep.

    pos_new:  (B, 3) post-drift receiver positions (any subset of lanes).
    src_pos:  (N, 3) pre-step source positions in SORTED order (the order
              the tree indexes; read for direct bucket sums).
    src_mass: (N,) sorted source masses.
    active:   optional (B,) bool — lanes with False skip their walk.
    self_idx: optional (B,) int — each receiver's index in the sorted
              order, for exact self-exclusion; default arange(B).
    """
    dev = pos_new.device
    b = pos_new.shape[0]
    n = src_pos.shape[0]
    cap = tree.nodes_f32.shape[0] - 1
    theta = tree_params.theta
    bucket = tree_params.leaf_bucket
    gdt = params.g * params.dt
    e = params.e
    i64 = torch.int64
    if self_idx is None:
        self_idx = torch.arange(b, device=dev)
    self_idx = self_idx.to(i64)[:, None]

    px, py, pz = pos_new[:, 0], pos_new[:, 1], pos_new[:, 2]
    # (n+1, 4) sources; row n is a massless far sentinel for idle slots
    src = torch.cat(
        [
            torch.cat([src_pos, torch.full((1, 3), FAR, dtype=torch.float32, device=dev)]),
            torch.cat([src_mass, torch.zeros(1, dtype=torch.float32, device=dev)])[:, None],
        ],
        1,
    )
    skip = tree.skip.to(i64)
    first_all = tree.first.to(i64)
    count_all = tree.count.to(i64)
    num_nodes = tree.num_nodes.to(i64)
    lanes = torch.arange(bucket, dtype=i64, device=dev)

    if active is None:
        cur = torch.zeros(b, dtype=i64, device=dev)
    else:
        cur = torch.where(active, 0, num_nodes)
    koff = torch.zeros(b, dtype=i64, device=dev)
    acc = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    while bool((cur < num_nodes).any()):
        done = cur >= num_nodes
        at = torch.clamp(cur, max=cap)  # an overflowed skip may point past the arena
        row = tree.nodes_f32[at]
        nskip = skip[at]
        dx = row[:, 0] - px
        dy = row[:, 1] - py
        dz = row[:, 2] - pz
        r2 = dx * dx + dy * dy + dz * dz
        dist = torch.sqrt(r2)
        theta_ok = row[:, WIDTH] < theta * dist
        no_child = row[:, NO_CHILD] > 0.0
        far = theta_ok & ~done
        near = ~theta_ok & no_child & ~done
        w = torch.where(far, row[:, MASS] * gdt / (r2 * dist + e) / dist, 0.0)
        ax, ay, az = w * dx, w * dy, w * dz

        cnt = count_all[at]
        k = koff[:, None] + lanes  # (B, bucket) member offsets in the cell
        j = torch.where(near[:, None] & (k < cnt[:, None]), first_all[at][:, None] + k, n)
        srow = src[j]  # (B, bucket, 4)
        sdx = srow[..., 0] - px[:, None]
        sdy = srow[..., 1] - py[:, None]
        sdz = srow[..., 2] - pz[:, None]
        sr2 = sdx * sdx + sdy * sdy + sdz * sdz
        is_self = j == self_idx
        sr2s = torch.where(is_self, 1.0, sr2)
        sd = torch.sqrt(sr2s)
        sw = srow[..., 3] * gdt / (sr2s * sd + e) / sd
        sw = torch.where(is_self, 0.0, sw)
        tx, ty, tz = sw * sdx, sw * sdy, sw * sdz
        for m in range(bucket):  # member order, as the JAX loop adds them
            ax = ax + tx[:, m]
            ay = ay + ty[:, m]
            az = az + tz[:, m]
        acc = acc + torch.stack([ax, ay, az], 1)

        more = near & (koff + bucket < cnt)  # overfull cell not exhausted
        koff = torch.where(more, koff + bucket, 0)
        nxt = torch.where(more, cur, torch.where(far | near, nskip, cur + 1))
        cur = torch.where(done, cur, nxt)
    return acc


def walk_counts(
    pos_new: torch.Tensor,
    tree: TreeArrays,
    tree_params: TreeParams,
) -> torch.Tensor:
    """What the walk of ``tree_forces`` visits, counting only: (B, 4) int64
    per receiver [nodes accepted, members of the terminal cells it opened
    (the receiver itself included where the cell is its own), nodes
    visited, the narrowest node it accepted (the first of them) or -1], by
    the same rules and the same rounding of the theta test.
    """
    dev = pos_new.device
    b = pos_new.shape[0]
    cap = tree.nodes_f32.shape[0] - 1
    i64 = torch.int64
    px, py, pz = pos_new[:, 0], pos_new[:, 1], pos_new[:, 2]
    skip, count = tree.skip.to(i64), tree.count.to(i64)
    num_nodes = tree.num_nodes.to(i64)
    cur = torch.zeros(b, dtype=i64, device=dev)
    out = torch.zeros((b, 4), dtype=i64, device=dev)
    out[:, 3] = -1
    narrowest = torch.full((b,), float("inf"), dtype=torch.float32, device=dev)
    while bool((cur < num_nodes).any()):
        done = cur >= num_nodes
        at = torch.clamp(cur, max=cap)
        row = tree.nodes_f32[at]
        dx = row[:, 0] - px
        dy = row[:, 1] - py
        dz = row[:, 2] - pz
        r2 = dx * dx + dy * dy + dz * dz
        theta_ok = row[:, WIDTH] < tree_params.theta * torch.sqrt(r2)
        far = theta_ok & ~done
        near = ~theta_ok & (row[:, NO_CHILD] > 0.0) & ~done
        out[:, 0] += far
        out[:, 1] += near * count[at]
        out[:, 2] += ~done
        better = far & (row[:, WIDTH] < narrowest)
        out[:, 3] = torch.where(better, at, out[:, 3])
        narrowest = torch.where(better, row[:, WIDTH], narrowest)
        cur = torch.where(done, cur, torch.where(far | near, skip[at], cur + 1))
    return out


def warp_walk_counts(
    pos_new: torch.Tensor,
    tree: TreeArrays,
    tree_params: TreeParams,
) -> torch.Tensor:
    """What the walk kernel's counting instantiation (``csrc/tree_walk.cu``,
    ``tree_walk_cuda.tree_forces_counts_cuda``) writes, by its warp rule:
    (B, 4) int64 per receiver [nodes accepted, members of the terminal cells
    it opened, visits of its warp at which it was live, visits of its warp].

    Receivers [32w, 32w + 32) of ``pos_new`` share warp w's traversal. A
    lane is live at the warp's node iff that node is not under one it has
    accepted or summed (``resume``); a live lane takes its own theta test
    (the plain rounding, as ``walk_counts``); the warp goes to the next row
    if any live lane opens the node, else to its skip, clamped as the pack
    kernel clamps it. The first two columns equal ``walk_counts``'.
    """
    dev = pos_new.device
    b = pos_new.shape[0]
    i64 = torch.int64
    rows = tree.nodes_f32.shape[0]
    num_nodes = min(int(tree.num_nodes), rows - 1)
    n_warps = -(-b // 32)
    pad = n_warps * 32 - b
    p = torch.cat([pos_new, pos_new.new_zeros((pad, 3))]).view(n_warps, 32, 3)
    real = (torch.arange(n_warps * 32, device=dev) < b).view(n_warps, 32)
    nxt_all = torch.maximum(torch.clamp(tree.skip.to(i64), max=rows - 1),
                            torch.arange(1, rows + 1, dtype=i64, device=dev))
    count = tree.count.to(i64)
    cur = torch.zeros(n_warps, dtype=i64, device=dev)
    resume = torch.where(real, 0, num_nodes).to(i64)
    out = torch.zeros((n_warps, 32, 4), dtype=i64, device=dev)
    while True:
        going = cur < num_nodes
        if not bool(going.any()):
            break
        at = torch.clamp(cur, max=rows - 1)
        row = tree.nodes_f32[at]  # (W, 8)
        d = row[:, None, :3] - p
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        accept = row[:, None, WIDTH] < tree_params.theta * torch.sqrt(r2)
        terminal = (row[:, NO_CHILD] > 0.0)[:, None]
        live = going[:, None] & (cur[:, None] >= resume)
        far = live & accept
        near = live & ~accept & terminal
        opens = (live & ~accept & ~terminal).any(1)
        out[..., 0] += far
        out[..., 1] += near * count[at][:, None]
        out[..., 2] += live
        out[..., 3] += going[:, None]
        nxt = nxt_all[at]
        resume = torch.where(far | near, nxt[:, None], resume)
        cur = torch.where(going, torch.where(opens, cur + 1, nxt), cur)
    return out.view(n_warps * 32, 4)[:b]
