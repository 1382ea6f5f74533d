"""The renderer's raster (B6), plain PyTorch version — counterpart of the
raster tiers of ``wgpu_n_body_tpu/runners/renderer.py`` (``render_frame``
:213, ``_triangle_coverage`` :162, ``_device_raster_fn`` :435,
``blend_lut_u8`` :640).

Each body is the reference's instanced triangle of clip-space half-extent
``POINT_EXTENT`` (online_renderer.rs:224-229), rasterised by the pixel-centre
rule into per-pixel coverage counts; a pixel covered k times blends to
``1 - (1 - alpha)^k``. ``csrc/raster.cu`` is the kernel of the same function
(``ops/raster_cuda.py``); this module is what the CPU takes and what the
kernel is held against.

The projection is defined once, in a fixed order:
``((x*m[r,0] + y*m[r,1]) + z*m[r,2]) + m[r,3]`` in float64 from the float32
inputs, rounded once to float32 (``project``). The JAX package leaves it to
numpy's matrix product, whose last bit depends on the BLAS kernel, so the
two differ on some rows by at most a few float32 ulps of the terms' sum
(ROADMAP C). Everything after the projection is float32 in the JAX op
order, so from the same clip coordinates the counts are bit-equal to JAX
``_triangle_coverage``.

Which pixels a triangle may light (``boxes``) follows the JAX host exactly:
a footprint at most 31 px wide and high is tested over the window that
starts at ``floor(c - s + 0.5)``; a wider one over the box
``floor(c -+ s + 0.5) -+ 1`` (``_scanline_counts``' 1-px slack). Both are
clipped to the frame.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: clip-space half-extent of the instanced point triangle
#: (online_renderer.rs:224: [-0.006,-0.006, 0.006,-0.006, 0.0,0.006])
POINT_EXTENT = 0.006
#: the JAX host's vectorised window (``_MEDIUM_WINDOW``): a footprint with
#: 2*s > WINDOW - 1 px on either axis takes the slack box instead
WINDOW = 32
FOOTPRINTS = ("triangle", "splat")
#: pairs of (body, candidate pixel) evaluated at once by ``raster_counts``
_CHUNK = 1 << 22
#: float bounds are clamped to +-2^24 before they become integers (a
#: footprint near znear reaches ~1e5 px, one at a denormal w is infinite)
_CLAMP = float(1 << 24)


def view_proj_array(view_proj) -> np.ndarray:
    """A (4, 4) float32 numpy copy of ``view_proj`` (numpy or a tensor)."""
    if torch.is_tensor(view_proj):
        view_proj = view_proj.detach().cpu().numpy()
    m = np.asarray(view_proj, np.float32)
    if m.shape != (4, 4):
        raise ValueError(f"view_proj must have shape (4, 4), got {m.shape}")
    return m


def project(pos: torch.Tensor, view_proj) -> tuple[torch.Tensor, torch.Tensor]:
    """(clip (N, 3) float32, w (N,) float32) of (N, 3) float32 positions:
    each row ``((x*m[r,0] + y*m[r,1]) + z*m[r,2]) + m[r,3]`` in float64,
    rounded once to float32."""
    m = view_proj_array(view_proj).astype(np.float64)
    x, y, z = (pos[:, k].double() for k in range(3))
    rows = [(((x * m[r, 0]) + (y * m[r, 1])) + (z * m[r, 2])) + m[r, 3] for r in range(4)]
    return torch.stack(rows[:3], dim=1).float(), rows[3].float()


def triangles(clip: torch.Tensor, w: torch.Tensor, width: int, height: int,
              footprint: str = "triangle"):
    """(keep, cx, cy, sx, sy), each (N,): the cull and the pixel-space
    centre and half-extents, float32 in the JAX op order (``render_frame``
    :249-264, ``_device_raster_fn`` :493-506). Culled rows hold
    meaningless values; a splat has sx = sy = 0."""
    if footprint not in FOOTPRINTS:
        raise ValueError(f"unknown footprint {footprint!r}")
    x, y, z = clip[:, 0], clip[:, 1], clip[:, 2]
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=w.device)
    lim = w if footprint == "splat" else w * f32(1 + POINT_EXTENT)
    keep = (w > 0) & (x.abs() <= lim) & (y.abs() <= lim) & (z >= 0) & (z <= w)
    ws = torch.where(keep, w, f32(1.0))
    half, wid, hei = f32(0.5), f32(width), f32(height)
    cx = ((x / ws) + f32(1.0)) * half * wid
    cy = (f32(1.0) - (y / ws)) * half * hei
    if footprint == "splat":
        zero = torch.zeros_like(cx)
        return keep, cx, cy, zero, zero
    sn = torch.div(f32(POINT_EXTENT), ws)  # not ``0.006 / ws``: torch takes a reciprocal
    return keep, cx, cy, sn * half * wid, sn * half * hei


def _floor_int(v: torch.Tensor) -> torch.Tensor:
    return torch.floor(v).clamp(-_CLAMP, _CLAMP).long()


def boxes(cx, cy, sx, sy, width: int, height: int):
    """(x0, x1, y0, y1) int64 per triangle: the pixels it may light, as the
    JAX host tests them, clipped to the frame (empty where x1 < x0 or
    y1 < y0)."""
    two, half, edge = (torch.tensor(v, dtype=torch.float32, device=cx.device)
                       for v in (2.0, 0.5, WINDOW - 1.0))
    small = ~((two * sx > edge) | (two * sy > edge))
    out = []
    for c, s, size in ((cx, sx, width), (cy, sy, height)):
        lo = _floor_int((c - s) + half)
        hi = _floor_int((c + s) + half) + 1
        hi = torch.where(small, torch.minimum(hi, lo + (WINDOW - 1)), hi)
        lo = torch.where(small, lo, lo - 1)
        out += [lo.clamp(min=0), hi.clamp(max=size - 1)]
    return out[0], out[1], out[2], out[3]


def covers(gx, gy, cx, cy, sx, sy) -> torch.Tensor:
    """The pixel-centre rule of ``_triangle_coverage``: an isoceles triangle,
    apex up in pixel space, centred at (cx, cy) with half-extents (sx, sy),
    covers pixel (gx, gy) (integers), float32 in the JAX op order."""
    half, two = (torch.tensor(v, dtype=torch.float32, device=cx.device) for v in (0.5, 2.0))
    vy = (gy.float() + half) - cy
    hw = (sx * (vy + sy)) / (two * sy)
    vx = (gx.float() + half) - cx
    return (vy.abs() <= sy) & (vx.abs() <= hw)


def raster_counts(pos: torch.Tensor, view_proj, width: int, height: int,
                  footprint: str = "triangle") -> torch.Tensor:
    """(height, width) int32 coverage counts of (N, 3) float32 positions, on
    their device. A splat lights the truncated, clamped pixel of its centre
    (``render_frame``'s ``footprint="splat"``)."""
    clip, w = project(pos, view_proj)
    keep, cx, cy, sx, sy = triangles(clip, w, width, height, footprint)
    if footprint == "splat":
        return splat_counts(cx[keep], cy[keep], width, height)
    return triangle_counts(cx[keep], cy[keep], sx[keep], sy[keep], width, height)


def splat_counts(cx, cy, width: int, height: int) -> torch.Tensor:
    """(height, width) int32 counts of splats at pixel-space centres (the
    kept rows of ``triangles``): one at the truncated, clamped pixel."""
    px = cx.long().clamp(0, width - 1)
    py = cy.long().clamp(0, height - 1)
    flat = py * width + px
    return torch.bincount(flat, minlength=width * height).int().reshape(height, width)


def triangle_counts(cx, cy, sx, sy, width: int, height: int) -> torch.Tensor:
    """(height, width) int32 coverage counts of pixel-space triangles (the
    kept rows of ``triangles``): every candidate pixel of ``boxes`` held to
    ``covers``."""
    npix = width * height
    dev = cx.device
    counts = torch.zeros(npix, dtype=torch.int64, device=dev)
    x0, x1, y0, y1 = boxes(cx, cy, sx, sy, width, height)
    bw = (x1 - x0 + 1).clamp(min=0)
    area = bw * (y1 - y0 + 1).clamp(min=0)
    end = area.cumsum(0)
    start = end - area
    total = int(end[-1]) if len(end) else 0
    # (body, candidate pixel) pairs, in chunks of about _CHUNK pairs
    cuts = torch.searchsorted(end, torch.arange(_CHUNK, max(total, _CHUNK), _CHUNK, device=dev), right=True)
    bounds = [0, *cuts.tolist(), len(area)]
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        if b1 <= b0:
            continue
        body = torch.repeat_interleave(torch.arange(b0, b1, device=dev), area[b0:b1])
        k = torch.arange(len(body), device=dev) + start[b0] - start[body]  # pixel in its box
        gx = x0[body] + k % bw[body]
        gy = y0[body] + k // bw[body]
        hit = covers(gx, gy, cx[body], cy[body], sx[body], sy[body])
        counts += torch.bincount((gy * width + gx)[hit], minlength=npix)
    return counts.int().reshape(height, width)


@functools.lru_cache(maxsize=None)
def blend_lut_u8(alpha: float = 0.25) -> np.ndarray:
    """256-entry uint8 LUT of the blend-then-quantize pipeline: entry k is
    what ``png_bytes`` emits for a pixel with k coverage hits — f64
    ``1-(1-alpha)^k``, cast to f32, clipped, ``*255.0``, truncated to uint8.
    For alpha=0.25 the f32 cast saturates at k=61, so every k >= 255 maps to
    lut[255] and ``min(counts, 255)`` indexing is exact. Read-only."""
    k = np.arange(256, dtype=np.float64)
    img = (1.0 - (1.0 - float(alpha)) ** k).astype(np.float32)
    lut = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    if lut[-1] != lut[-2]:  # non-saturating alpha: clamp would be wrong
        raise ValueError(f"blend LUT does not saturate for alpha={alpha}")
    lut.flags.writeable = False
    return lut


def blend_u8(counts: torch.Tensor, alpha: float = 0.25) -> torch.Tensor:
    """uint8 image ``lut[min(counts, 255)]`` of int32 coverage counts, on
    their device."""
    lut = torch.from_numpy(blend_lut_u8(alpha).copy()).to(counts.device)
    return lut[counts.clamp(max=255).long()]
