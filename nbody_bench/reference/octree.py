"""The octree of a Morton-sorted state and what the per-receiver θ-walk
needs on it: the count that ``walk_roofline`` divides by the rate.

The rules are those of ``wgpu_n_body_tpu_torch/ops/tree_build.py`` and
``ops/tree_walk.py::walk_counts`` at commit d60e59f (the JAX
``ops/tree_walk.py::tree_forces`` rule, upstream tree.rs:417-602 and
tree.wgsl:41-90), built here level by level and not as the program's DFS
arena:

- the cell of a node at level L is a run of equal 3L-bit key prefixes; a
  node is real iff it is the root or its parent holds more than
  ``leaf_bucket`` bodies; it is terminal when it holds at most
  ``leaf_bucket`` or sits at ``max_depth``;
- its centre of gravity is sum(m p) / sum(m) (a single body's own
  position), its width ``2 bound 2^-L``;
- a receiver accepts a node when width < θ * |cog - receiver| (float32),
  sums an opened terminal node over its bodies, and opens the children of
  an internal one.

So each receiver needs (nodes accepted) + (bodies of the opened terminal
nodes) interactions, whatever walk the program runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Level(NamedTuple):
    """The real nodes of one level, in Morton order."""

    first: torch.Tensor  # (k,) int64 first body
    end: torch.Tensor  # (k,) int64 one past the last body
    cog: torch.Tensor  # (k, 3) float32
    width: torch.Tensor  # () float32
    terminal: torch.Tensor  # (k,) bool


def build(keys: torch.Tensor, pos: torch.Tensor, mass: torch.Tensor, bound: torch.Tensor,
          depth: int, bucket: int) -> list[Level]:
    """The real nodes of every level of the sorted bodies (``keys`` sorted,
    ``pos`` and ``mass`` in that order)."""
    n = keys.shape[0]
    dev = keys.device
    w = pos.double() * mass.double()[:, None]
    zero = torch.zeros((1, 4), dtype=torch.float64, device=dev)
    sums = torch.cat([zero, torch.cumsum(torch.cat([mass.double()[:, None], w], 1), 0)])
    root_width = (2.0 * bound).to(torch.float32)

    def level(first, end, lv):
        tot = sums[end] - sums[first]
        single = (end - first) == 1
        cog = torch.where(single[:, None], pos[first.clamp(max=n - 1)].double(),
                          tot[:, 1:] / tot[:, :1]).to(torch.float32)
        cnt = end - first
        return Level(first, end, cog, root_width * (2.0 ** -lv),
                     (cnt <= bucket) | (lv == depth))

    levels = [level(torch.zeros(1, dtype=torch.int64, device=dev),
                    torch.full((1,), n, dtype=torch.int64, device=dev), 0)]
    for lv in range(1, depth + 1):
        parent = levels[-1]
        inner = ~parent.terminal
        if not bool(inner.any()):
            break
        prefix = keys >> (3 * (depth - lv))
        starts = torch.nonzero(torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                          prefix[1:] != prefix[:-1]])).flatten()
        ends = torch.cat([starts[1:], torch.full((1,), n, dtype=torch.int64, device=dev)])
        owner = torch.searchsorted(parent.first, starts, right=True) - 1
        keep = inner[owner] & (starts < parent.end[owner])
        levels.append(level(starts[keep], ends[keep], lv))
    return levels


def node_count(levels: list[Level]) -> int:
    """Real nodes of the tree."""
    return sum(int(lv.first.shape[0]) for lv in levels)


def interactions(levels: list[Level], recv: torch.Tensor, theta: float) -> torch.Tensor:
    """(B,) int64: nodes accepted plus bodies of opened terminal nodes, per
    receiver of ``recv`` (B, 3) float32."""
    dev = recv.device
    b = recv.shape[0]
    out = torch.zeros(b, dtype=torch.int64, device=dev)
    who = torch.arange(b, device=dev)
    node = torch.zeros(b, dtype=torch.int64, device=dev)
    for lv, cur in enumerate(levels):
        d = cur.cog[node] - recv[who]
        dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
        ok = cur.width < theta * dist
        term = cur.terminal[node]
        cnt = cur.end[node] - cur.first[node]
        gain = torch.where(ok, 1, torch.where(term, cnt, 0))
        out.index_add_(0, who, gain)
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
    return out
