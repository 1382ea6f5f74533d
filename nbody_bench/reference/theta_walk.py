"""The forces of the per-receiver θ-walk rule, worked out again on
``octree.py``'s levels: what a sound per-particle walk computes, up to the
rounding of its sums.

Each receiver walks the tree from the root by the rule of upstream
tree.wgsl:41-111 (the program's ``ops/tree_walk.py::tree_forces`` at commit
a8fff5b), level by level instead of down a DFS arena:

- a node whose width < θ * |cog - receiver| (the test in float32, as
  ``octree.interactions`` makes it) is accepted: one point mass, the node's
  mass summed in float64, at its float32 centre of gravity;
- an opened terminal node is summed over its bodies, skipping only the
  receiver's own row (i == j);
- an opened internal node hands the receiver to its children.

A term is m g dt / (r^3 + e) / r along the offset d = source - receiver,
r = |d|, the softening and dt folded in as the configurations state, every
term and sum in float64. Receivers go in blocks, so that 16,384 of them at
N=4M fit beside the state. The interactions it counts per receiver are
``octree.interactions``'.
"""

from __future__ import annotations

import torch

from nbody_bench.reference.octree import Level


def _add_terms(acc, who, d, m, gdt: float, e: float) -> None:
    """acc[who] += m g dt / (r^3 + e) / r * d, float64, where m is 0 for a
    skipped pair (its r set to 1)."""
    r2 = (d * d).sum(1)
    skip = m == 0
    r2 = torch.where(skip, 1.0, r2)
    r = torch.sqrt(r2)
    w = torch.where(skip, 0.0, m * gdt / (r2 * r + e) / r)
    acc.index_add_(0, who, w[:, None] * d)


def _walk(levels, mass_of, src, src_mass, recv, recv_idx, theta, gdt, e):
    dev = recv.device
    b = recv.shape[0]
    acc = torch.zeros((b, 3), dtype=torch.float64, device=dev)
    inter = torch.zeros(b, dtype=torch.int64, device=dev)
    recv64 = recv.double()
    who = torch.arange(b, device=dev)
    node = torch.zeros(b, dtype=torch.int64, device=dev)
    for lv, cur in enumerate(levels):
        cog = cur.cog[node]
        d = cog - recv[who]
        dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
        ok = cur.width < theta * dist
        term = cur.terminal[node]
        first, end = cur.first[node], cur.end[node]
        inter.index_add_(0, who, torch.where(ok, 1, torch.where(term, end - first, 0)))
        # accepted nodes: point masses at their centres of gravity
        a = who[ok]
        _add_terms(acc, a, cog[ok].double() - recv64[a], mass_of[lv][node[ok]], gdt, e)
        # opened terminal nodes: their bodies, the receiver's own row skipped
        near = ~ok & term
        cnt = (end - first)[near]
        rw = torch.repeat_interleave(who[near], cnt)
        j = torch.repeat_interleave(first[near] - torch.cumsum(cnt, 0) + cnt, cnt)
        j = j + torch.arange(j.shape[0], device=dev)
        m = torch.where(j == recv_idx[rw], 0.0, src_mass[j])
        _add_terms(acc, rw, src[j] - recv64[rw], m, gdt, e)
        opened = ~ok & ~term
        if lv + 1 == len(levels) or not bool(opened.any()):
            break
        nxt = levels[lv + 1]
        who, node = who[opened], node[opened]
        c0 = torch.searchsorted(nxt.first, cur.first[node])
        c1 = torch.searchsorted(nxt.first, cur.end[node])
        k = c1 - c0
        who = torch.repeat_interleave(who, k)
        base = torch.repeat_interleave(c0 - torch.cumsum(k, 0) + k, k)
        node = base + torch.arange(who.shape[0], device=dev)
    return acc, inter


def forces(levels: list[Level], src_pos: torch.Tensor, src_mass: torch.Tensor,
           recv: torch.Tensor, recv_idx: torch.Tensor, theta: float, g: float, e: float,
           dt: float, block: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """((B, 3) float64 sum(a)*dt, (B,) int64 interactions) of receivers
    ``recv`` (B, 3) float32, whose own rows in the sorted sources are
    ``recv_idx``, by the θ-walk rule on ``levels`` (``octree.build`` of the
    sorted ``src_pos``, ``src_mass``)."""
    src = src_pos.double()
    m64 = src_mass.double()
    sums = torch.cat([torch.zeros(1, dtype=torch.float64, device=src.device),
                      torch.cumsum(m64, 0)])
    mass_of = [sums[lv.end] - sums[lv.first] for lv in levels]
    recv_idx = recv_idx.to(device=src.device, dtype=torch.int64)
    parts = [_walk(levels, mass_of, src, m64, recv[b0:b0 + block], recv_idx[b0:b0 + block],
                   theta, g * dt, e) for b0 in range(0, recv.shape[0], block)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
