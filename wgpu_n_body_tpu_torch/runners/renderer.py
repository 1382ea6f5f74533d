"""Offline renderer — counterpart of ``wgpu_n_body_tpu/runners/renderer.py``
(reference src/runners/online_renderer.rs, draw.wgsl), with the same camera
geometry, footprint and blending:

- Camera: eye (0,1,2), target origin, up +y, fovy 45 deg, znear 1e-5,
  zfar 100 (online_renderer.rs:231-239), view = look_at_rh, proj = OpenGL
  perspective, then the OpenGL->wgpu clip matrix (z' = 0.5 z + 0.5 w).
- Blending: white at alpha 0.25 over black is order-independent, so a
  pixel covered by k particles ends at 1 - 0.75^k: coverage is counted per
  pixel and the closed form applied in float64.
- Footprint: the reference's instanced triangle of clip-space half-extent
  0.006 (``footprint="triangle"``, pixel-centre coverage without MSAA), or
  the nearest pixel (``"splat"``).

Host half (numpy only): ``Camera``, ``render_counts`` and ``render_frame``,
``raster_blend``,
``png_bytes``, ``write_png`` / ``write_ppm``, ``render_trajectory``. Its one
change from the JAX package is the projection, which is
``ops/raster.py::project``'s fixed-order float64 expression instead of
numpy's matrix product (ROADMAP C).

Device half: ``raster_dispatch`` enqueues the raster of a tensor on its
device (a CUDA tensor through the kernels of ``csrc/raster.cu``, B6; a CPU
tensor through the plain version) and ``raster_finish`` fetches and blends
it. Not ported, being TPU tier machinery that changes no image:
``raster_resolve``, ``_medium_raster_fn``, ``_big_raster_fn``,
``_combine_blend_u8_fn``, the ``_MEDIUM_*`` / ``_BIG_CAP`` constants and the
``window`` argument.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from wgpu_n_body_tpu_torch.ops import raster_cuda
from wgpu_n_body_tpu_torch.ops.raster import POINT_EXTENT, WINDOW, blend_lut_u8

__all__ = [
    "POINT_EXTENT", "Camera", "blend_lut_u8", "png_bytes", "raster_blend",
    "raster_blend_u8", "raster_dispatch", "raster_finish", "render_counts", "render_frame",
    "render_frame_on_device", "render_trajectory", "write_png", "write_ppm",
]


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


def project_host(pos: np.ndarray, m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(clip (N, 3), w (N,)) float32: ``ops/raster.py::project`` in numpy,
    each row ``((x*m[r,0] + y*m[r,1]) + z*m[r,2]) + m[r,3]`` in float64,
    rounded once."""
    p = np.asarray(pos, np.float32).astype(np.float64)
    m = np.asarray(m, np.float32).astype(np.float64)
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
) -> np.ndarray:
    """(H, W) int64 coverage counts of particle positions on the host: the
    raster of ``render_frame`` before its blend."""
    if camera is None:
        camera = Camera(aspect=width / height)
    clip, w = project_host(pos, camera.view_proj())
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


def render_frame(
    pos: np.ndarray,
    camera: Camera | None = None,
    width: int = 400,
    height: int = 400,
    alpha: float = 0.25,
    footprint: str = "triangle",
) -> np.ndarray:
    """Rasterize particle positions to a (H, W) float image in [0, 1] on the
    host.

    Defaults mirror the reference visualizer: 400x400 window
    (src/bin/visualize.rs:21-24), white alpha-0.25 triangles of clip-space
    half-extent 0.006 on black (draw.wgsl, online_renderer.rs:224-229).
    ``footprint="splat"`` lights the nearest pixel per particle instead.
    """
    return raster_blend(render_counts(pos, camera, width, height, footprint), alpha)


def raster_blend(counts, alpha: float = 0.25) -> np.ndarray:
    """The closed-form ``1-(1-alpha)^k`` blend of integer coverage counts,
    in float64, as a float32 image."""
    k = np.asarray(counts, np.int64)
    return (1.0 - (1.0 - alpha) ** k).astype(np.float32)


def raster_dispatch(
    pos: torch.Tensor,
    camera: Camera | None = None,
    width: int = 400,
    height: int = 400,
    footprint: str = "triangle",
) -> torch.Tensor:
    """Enqueue the raster of (N, 3) float32 positions on their device
    WITHOUT waiting: (H, W) int32 coverage counts, there. A CUDA tensor goes
    through the kernels of ``csrc/raster.cu``, a CPU tensor through the
    plain version (``ops/raster.py``)."""
    if camera is None:
        camera = Camera(aspect=width / height)
    return raster_cuda.raster_counts_cuda(
        pos, camera.view_proj(), width, height, footprint
    )


def raster_finish(counts: torch.Tensor, alpha: float = 0.25) -> np.ndarray:
    """Fetch dispatched counts and blend them on the host in float64, as
    ``render_frame`` does: a (H, W) float32 image in [0, 1]."""
    return raster_blend(counts.cpu().numpy(), alpha)


def raster_blend_u8(counts: torch.Tensor, alpha: float = 0.25) -> np.ndarray:
    """The blend on the counts' device through ``blend_lut_u8`` (a CUDA
    tensor through blend_u8_kernel), fetched as a (H, W) uint8 image:
    bit-equal to ``png_bytes``' quantisation of ``raster_blend``."""
    return raster_cuda.blend_u8_cuda(counts, alpha).cpu().numpy()


def render_frame_on_device(
    pos: torch.Tensor,
    camera: Camera | None = None,
    width: int = 400,
    height: int = 400,
    alpha: float = 0.25,
    footprint: str = "triangle",
) -> np.ndarray:
    """``render_frame`` with the raster on the positions' device: only the
    (H, W) int32 counts cross to the host, where the blend is applied in
    float64. Equal to ``render_frame`` of the same positions, bit for bit."""
    counts = raster_dispatch(pos, camera, width, height, footprint)
    return raster_finish(counts, alpha)


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write a grayscale [0,1] image as a binary P6 PPM (zero-dependency)."""
    g = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    rgb = np.repeat(g[:, :, None], 3, axis=2)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(rgb.tobytes())


def png_bytes(img: np.ndarray, level: int = 6) -> bytes:
    """Encode a [0,1] grayscale image as an 8-bit PNG (stdlib zlib only).

    ``level``: zlib compression level (the serve loop uses 1). A uint8
    ``img`` is taken as already-quantized grayscale (``raster_blend_u8``);
    a float one is clipped, scaled by 255 and truncated."""
    import struct
    import zlib

    if img.dtype == np.uint8:
        g = img
    else:
        g = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    h, w = g.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit grayscale
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), g], axis=1
    ).tobytes()  # filter byte 0 per scanline
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, level))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write PNG — via PIL when present, else the stdlib encoder above."""
    try:
        from PIL import Image
    except ImportError:
        with open(path, "wb") as f:
            f.write(png_bytes(img))
        return
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


def render_trajectory(
    reader,
    out_dir: str,
    camera: Camera | None = None,
    width: int = 400,
    height: int = 400,
    fmt: str = "auto",
) -> list[str]:
    """Render every frame of a TrajectoryReader on the host (``fmt``
    "auto"/"png" or "ppm"); returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for step, pos in reader:
        img = render_frame(pos, camera, width, height)
        if fmt == "ppm":
            path = os.path.join(out_dir, f"frame_{step:08d}.ppm")
            write_ppm(path, img)
        else:
            path = os.path.join(out_dir, f"frame_{step:08d}.png")
            write_png(path, img)
        paths.append(path)
    return paths
