"""The frame of a viewer tick, worked out again from the state it draws.

A frozen copy of the host half of ``wgpu_n_body_tpu_torch/runners/renderer.py``
(``Camera``, ``project_host``, ``_scanline_counts``, ``_triangle_coverage``,
``render_counts``) and of ``ops/raster.py::blend_lut_u8`` at commit d60e59f:
the reference camera (upstream online_renderer.rs:12-20,125-165,231-239),
the fixed-order float64 projection, pixel-centre coverage of the instanced
triangle of clip half-extent 0.006 (draw.wgsl), and the blend
1-(1-alpha)^k quantised to u8 as the viewer's PNG holds it. ``decode_png``
reads the program's PNG bytes back into pixels (8-bit greyscale, any
filter), so that the frame is judged by what it says.

``dtype`` lowers the projection's precision for the control.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

POINT_EXTENT = 0.006
WINDOW = 32


@dataclasses.dataclass
class Camera:
    """Perspective camera (reference online_renderer.rs:12-20,231-239)."""

    eye: tuple = (0.0, 1.0, 2.0)
    target: tuple = (0.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    aspect: float = 1.0
    fovy_deg: float = 45.0
    znear: float = 1e-5
    zfar: float = 100.0

    def view_proj(self) -> np.ndarray:
        """4x4 row-vector-on-the-right matrix: clip = M @ [x,y,z,1]."""
        eye = np.asarray(self.eye, np.float32)
        target = np.asarray(self.target, np.float32)
        up = np.asarray(self.up, np.float32)
        f = target - eye
        f = f / np.linalg.norm(f)
        s = np.cross(f, up)
        s = s / np.linalg.norm(s)
        u = np.cross(s, f)
        view = np.eye(4, dtype=np.float32)
        view[0, :3], view[1, :3], view[2, :3] = s, u, -f
        view[0, 3] = -s @ eye
        view[1, 3] = -u @ eye
        view[2, 3] = f @ eye
        t = 1.0 / np.tan(np.radians(self.fovy_deg) / 2.0)
        n, fr = self.znear, self.zfar
        proj = np.zeros((4, 4), np.float32)
        proj[0, 0] = t / self.aspect
        proj[1, 1] = t
        proj[2, 2] = (fr + n) / (n - fr)
        proj[2, 3] = 2 * fr * n / (n - fr)
        proj[3, 2] = -1.0
        # OpenGL [-1,1] z -> wgpu [0,1] z (online_renderer.rs:42-47)
        gl2wgpu = np.eye(4, dtype=np.float32)
        gl2wgpu[2, 2], gl2wgpu[2, 3] = 0.5, 0.5
        return gl2wgpu @ proj @ view

    # -- CameraController moves (online_renderer.rs:125-164) --------------
    def moved(self, direction: str, speed: float = 0.05) -> "Camera":
        """Return a camera after one controller tick of `direction` in
        {forward, backward, up, down, left, right} (reference key moves)."""
        eye = np.asarray(self.eye, np.float64)
        target = np.asarray(self.target, np.float64)
        up = np.asarray(self.up, np.float64)
        fwd = target - eye
        fwd_n = fwd / np.linalg.norm(fwd)
        up_n = up / np.linalg.norm(up)
        if direction == "forward" and np.linalg.norm(fwd) > speed:
            eye = eye + fwd_n * speed
        elif direction == "backward":
            eye = eye - fwd_n * speed
        elif direction == "up" and np.linalg.norm(up) > speed:
            eye = eye + up_n * speed
        elif direction == "down":
            eye = eye - up_n * speed
        elif direction in ("left", "right"):
            right = np.cross(fwd_n, up)
            fwd = target - eye
            mag = np.linalg.norm(fwd)
            delta = right * speed if direction == "right" else -right * speed
            eye = target - (fwd + delta) / np.linalg.norm(fwd + delta) * mag
        return dataclasses.replace(self, eye=tuple(eye))


def project_host(pos: np.ndarray, m: np.ndarray, dtype=np.float64) -> tuple[np.ndarray, np.ndarray]:
    """(clip (N, 3), w (N,)) float32: ``ops/raster.py::project`` in numpy,
    each row ``((x*m[r,0] + y*m[r,1]) + z*m[r,2]) + m[r,3]`` in float64,
    rounded once."""
    p = np.asarray(pos, np.float32).astype(dtype)
    m = np.asarray(m, np.float32).astype(dtype)
    with np.errstate(invalid="ignore"):  # inf * 0 is NaN, culled as in numpy's product
        rows = [
            ((p[:, 0] * m[r, 0] + p[:, 1] * m[r, 1]) + p[:, 2] * m[r, 2]) + m[r, 3]
            for r in range(4)
        ]
    return np.stack(rows[:3], axis=1).astype(np.float32), rows[3].astype(np.float32)


def _scanline_counts(
    counts: np.ndarray, bx, by, bsx, bsy, width: int, height: int
) -> None:
    """Exact per-triangle rasterization (pixel-center rule) of arbitrarily
    large triangles, accumulated into flat ``counts`` in place, f32
    predicates in the op order of ``ops/raster.py::covers``; the bbox clip
    gets 1 px of slack so f32 rounding of hw can never exclude a pixel the
    predicates admit."""
    f32 = np.float32
    bx32 = np.asarray(bx, f32)
    by32 = np.asarray(by, f32)
    bsx32 = np.asarray(bsx, f32)
    bsy32 = np.asarray(bsy, f32)
    for j in range(len(bx32)):
        x0 = max(0, int(np.floor(float(bx32[j] - bsx32[j] + f32(0.5)))) - 1)
        x1 = min(
            width - 1, int(np.floor(float(bx32[j] + bsx32[j] + f32(0.5)))) + 1
        )
        y0 = max(0, int(np.floor(float(by32[j] - bsy32[j] + f32(0.5)))) - 1)
        y1 = min(
            height - 1,
            int(np.floor(float(by32[j] + bsy32[j] + f32(0.5)))) + 1,
        )
        if x1 < x0 or y1 < y0:
            continue
        ys = (np.arange(y0, y1 + 1, dtype=f32)[:, None] + f32(0.5)) - by32[j]
        xs = (np.arange(x0, x1 + 1, dtype=f32)[None, :] + f32(0.5)) - bx32[j]
        hw = bsx32[j] * (ys + bsy32[j]) / (f32(2.0) * bsy32[j])
        hit = (np.abs(ys) <= bsy32[j]) & (np.abs(xs) <= hw)
        iy, ix = np.nonzero(hit)
        np.add.at(counts, (iy + y0) * width + (ix + x0), 1)


def _triangle_coverage(
    cx, cy, sx, sy, width: int, height: int
) -> np.ndarray:
    """Per-pixel coverage counts of isoceles triangles (apex up in pixel
    space) centered at (cx, cy) with half-extents (sx, sy), rasterized by
    the pixel-center rule. Vectorized over a fixed ``WINDOW`` offset window
    with f32 predicates; the rare oversized triangles (particles almost
    touching znear) take the per-triangle f32 scanline loop."""
    counts = np.zeros(width * height, np.int64)
    if len(cx) == 0:
        return counts
    f32 = np.float32
    cx32, cy32 = cx.astype(f32), cy.astype(f32)
    sx32, sy32 = sx.astype(f32), sy.astype(f32)
    cap = WINDOW
    big = (f32(2.0) * sx32 > f32(cap - 1.0)) | (
        f32(2.0) * sy32 > f32(cap - 1.0)
    )
    if big.any():
        _scanline_counts(
            counts, cx[big], cy[big], sx[big], sy[big], width, height
        )
    sel = ~big
    bx, by, bsx, bsy = cx32[sel], cy32[sel], sx32[sel], sy32[sel]
    if len(bx) == 0:
        return counts
    # f32 window origin and predicates: floor(c - s + 0.5), vy = f32(iy0) + (ky+0.5) - c
    ix0 = np.floor(bx - bsx + f32(0.5)).astype(np.int64)
    iy0 = np.floor(by - bsy + f32(0.5)).astype(np.int64)
    for ky in range(cap):
        vy = iy0.astype(f32) + f32(ky + 0.5) - by
        row_ok = np.abs(vy) <= bsy
        if not row_ok.any():
            continue
        # apex up after the y flip: halfwidth sx at vy=+sy, 0 at -sy
        hw = bsx * (vy + bsy) / (f32(2.0) * bsy)
        for kx in range(cap):
            vx = ix0.astype(f32) + f32(kx + 0.5) - bx
            hit = row_ok & (np.abs(vx) <= hw)
            gx = ix0 + kx
            gy = iy0 + ky
            hit &= (gx >= 0) & (gx < width) & (gy >= 0) & (gy < height)
            if hit.any():
                np.add.at(counts, gy[hit] * width + gx[hit], 1)
    return counts


def render_counts(
    pos: np.ndarray,
    camera: Camera | None = None,
    width: int = 400,
    height: int = 400,
    footprint: str = "triangle",
    dtype=np.float64,
) -> np.ndarray:
    """(H, W) int64 coverage counts of particle positions on the host: the
    raster of ``render_frame`` before its blend."""
    if camera is None:
        camera = Camera(aspect=width / height)
    clip, w = project_host(pos, camera.view_proj(), dtype)
    if footprint == "splat":
        keep = (
            (w > 0)
            & (np.abs(clip[:, 0]) <= w)
            & (np.abs(clip[:, 1]) <= w)
            & (clip[:, 2] >= 0)
            & (clip[:, 2] <= w)
        )
        ndc = clip[keep] / w[keep, None]
        px = ((ndc[:, 0] + 1) * 0.5 * width).astype(np.int64)
        py = ((1 - ndc[:, 1]) * 0.5 * height).astype(np.int64)
        px = np.clip(px, 0, width - 1)
        py = np.clip(py, 0, height - 1)
        counts = np.bincount(py * width + px, minlength=width * height)
    elif footprint == "triangle":
        s = POINT_EXTENT
        # keep anything whose triangle can reach the viewport; z-clip on
        # the particle center (the triangle offset has z == 0, draw.wgsl:13)
        keep = (
            (w > 0)
            & (np.abs(clip[:, 0]) <= w * (1 + s))
            & (np.abs(clip[:, 1]) <= w * (1 + s))
            & (clip[:, 2] >= 0)
            & (clip[:, 2] <= w)
        )
        ndc = clip[keep] / w[keep, None]
        s_ndc = s / w[keep]  # clip offset / w = NDC extent
        cx = (ndc[:, 0] + 1) * 0.5 * width
        cy = (1 - ndc[:, 1]) * 0.5 * height
        sx = s_ndc * 0.5 * width
        sy = s_ndc * 0.5 * height
        counts = _triangle_coverage(
            cx.astype(np.float64),
            cy.astype(np.float64),
            sx.astype(np.float64),
            sy.astype(np.float64),
            width,
            height,
        )
    else:
        raise ValueError(f"unknown footprint {footprint!r}")
    return counts.reshape(height, width)


def blend_lut_u8(alpha: float = 0.25) -> np.ndarray:
    """256-entry u8 LUT: entry k is f64 1-(1-alpha)^k, cast to f32, clipped,
    times 255, truncated. Saturates by k=255 for the viewer's alpha."""
    k = np.arange(256, dtype=np.float64)
    img = (1.0 - (1.0 - float(alpha)) ** k).astype(np.float32)
    lut = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    if lut[-1] != lut[-2]:
        raise ValueError(f"blend LUT does not saturate for alpha={alpha}")
    return lut


def frame_u8(pos: np.ndarray, camera: Camera, width: int, height: int, alpha: float,
             footprint: str = "triangle", dtype=np.float64) -> np.ndarray:
    """(H, W) u8 pixels of a frame of ``pos`` seen by ``camera``."""
    counts = render_counts(pos, camera, width, height, footprint, dtype)
    return blend_lut_u8(alpha)[np.minimum(counts, 255)]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode_png(data: bytes) -> np.ndarray:
    """(H, W) u8 pixels of an 8-bit greyscale, non-interlaced PNG."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    at, idat = 8, b""
    w = h = None
    while at < len(data):
        (length,) = struct.unpack(">I", data[at:at + 4])
        tag, body = data[at + 4:at + 8], data[at + 8:at + 8 + length]
        at += 12 + length
        if tag == b"IHDR":
            w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, colour, interlace) != (8, 0, 0):
                raise ValueError(f"PNG depth {depth}, colour {colour}, interlace {interlace}")
        elif tag == b"IDAT":
            idat += body
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    out = np.zeros((h, w), np.int64)
    prev = np.zeros(w, np.int64)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int64)
        if f == 0:
            row = line
        elif f == 2:
            row = (line + prev) & 255
        else:
            row = np.zeros(w, np.int64)
            for x in range(w):
                a = row[x - 1] if x else 0
                c = prev[x - 1] if x else 0
                pred = {1: a, 3: (a + prev[x]) // 2, 4: _paeth(a, prev[x], c)}[int(f)]
                row[x] = (line[x] + pred) & 255
        out[y] = row
        prev = row
    return out.astype(np.uint8)
