"""One step of the reference's semantics, worked out again from its input.

The parity rules the configurations state (upstream naive.wgsl:23-68,
tree.wgsl:105-110): a kick-drift-kick leapfrog whose stored ``acc`` is
sum(a)*dt; the force pairs each body's post-drift position (receiver) with
every other body's pre-step position (source); a pair's weight is
m_j g dt / (r^3 + e) along the unit offset; only i == j is skipped; the
tree step reorders the bodies into Morton order first.

``drift`` and ``kick`` are the program's float32 expressions in its order
of operations, so a sound program equals them bit for bit; ``allpairs``
is the exact force in float64; ``force_err`` is the accuracy statistic of
``tests/test_tree.py`` (mean |got - want| over the mean row norm of want).
"""

from __future__ import annotations

import torch


def drift(pos, vel, acc, dt: float, dtype=torch.float32):
    """(vel_h, pos_new) = (vel + acc dt/2, pos + vel_h dt) in ``dtype``."""
    pos, vel, acc = (t.to(dtype) for t in (pos, vel, acc))
    vel_h = vel + acc * (dt / 2.0)
    return vel_h, pos + vel_h * dt


def kick(vel_h, acc_new, dt: float):
    """The closing half-kick vel_h + acc_new dt/2, in vel_h's dtype."""
    return vel_h + acc_new.to(vel_h.dtype) * (dt / 2.0)


def allpairs(recv, recv_idx, src, mass, g: float, e: float, dt: float, dtype=torch.float64,
             recv_block: int = 256, src_block: int = 1 << 21):
    """(B, 3) sum(a)*dt on receivers ``recv`` (their rows ``recv_idx`` in
    the source order, whose own pair is skipped) from every source, in
    ``dtype``, blocked so that a block's temporaries stay near 4 GB.

    In float64 a block is three matrix products: r^2 = |p|^2 + |s|^2 -
    2 p.s, and the force sum(w s) - p sum(w) (the rounding of r^2 is
    ~1e-16 absolute, 1e-8 of the nearest pairs' r^2). Another dtype sums the
    offsets elementwise, as the program does."""
    dev = src.device
    src = src.to(dtype)
    mgdt = mass.to(dtype) * (g * dt)
    recv = recv.to(device=dev, dtype=dtype)
    recv_idx = recv_idx.to(device=dev, dtype=torch.int64)
    out = torch.zeros((recv.shape[0], 3), dtype=dtype, device=dev)
    n = src.shape[0]
    exact = dtype == torch.float64
    if not exact:
        recv_block, src_block = 64, 1 << 20
    src2 = (src * src).sum(1)
    for r0 in range(0, recv.shape[0], recv_block):
        p = recv[r0:r0 + recv_block]
        ri = recv_idx[r0:r0 + recv_block]
        for s0 in range(0, n, src_block):
            s = src[s0:s0 + src_block]
            own = ri[:, None] == torch.arange(s0, s0 + s.shape[0], device=dev)[None, :]
            if exact:
                r2 = ((p * p).sum(1)[:, None] + src2[None, s0:s0 + src_block]
                      - 2.0 * (p @ s.T)).clamp_(min=0.0)
                r2 = torch.where(own, 1.0, r2)
                r = torch.sqrt(r2)
                w = torch.where(own, 0.0, mgdt[None, s0:s0 + src_block] / (r2 * r + e) / r)
                out[r0:r0 + recv_block] += w @ s - p * w.sum(1, keepdim=True)
            else:
                d = s[None, :, :] - p[:, None, :]
                r2 = torch.where(own, 1.0, (d * d).sum(-1))
                r = torch.sqrt(r2)
                w = torch.where(own, 0.0, mgdt[None, s0:s0 + src_block] / (r2 * r + e) / r)
                out[r0:r0 + recv_block] += (w[:, :, None] * d).sum(1)
    return out


def force_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """mean |got - want| over the mean row norm of ``want``, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().mean() / want.norm(dim=1).mean())
