"""PyTorch port, renderer (B6's plain version and the host half) against the
JAX package's host renderer, on the CPU.

The raster stage is held bit for bit: from the same clip coordinates the
port's triangles equal JAX ``render_frame``'s float32 expressions and its
counts equal JAX ``_triangle_coverage``. Images from positions may differ
only where the port's fixed-order float64 projection differs from numpy's
matrix product: inside the footprints of those rows, each held to
2 x eps32 x the sum of its terms' magnitudes (ROADMAP C).
"""

import numpy as np
import pytest
import torch

from wgpu_n_body_tpu.runners import renderer as jr
from wgpu_n_body_tpu_torch.ops import raster, raster_cuda
from wgpu_n_body_tpu_torch.runners import renderer as tr

EPS32 = float(np.finfo(np.float32).eps)
LENS = jr.Camera(eye=(0.0, 0.0, 2.0), aspect=1.0)


def _uniform(seed, n, lo=-0.8, hi=0.8, shift=(0.0, 0.0, 0.0)):
    rng = np.random.RandomState(seed)
    return (rng.uniform(lo, hi, (n, 3)).astype(np.float32) + np.float32(shift)).astype(np.float32)


def _near_lens():  # tests/test_renderer.py: one body at w ~ 1e-3
    rng = np.random.RandomState(7)
    return np.concatenate([
        np.array([[0.0, 0.0, 1.999]], np.float32),
        rng.uniform(-0.4, 0.4, (3000, 3)).astype(np.float32) - np.float32([0, 0, 1]),
    ])


def _shell():  # tests/test_renderer.py: footprints of ~12-24 px
    rng = np.random.RandomState(11)
    shell = rng.uniform(-0.05, 0.05, (500, 3)).astype(np.float32)
    return np.concatenate([
        shell + np.float32([0.0, 0.0, 1.85]),
        rng.uniform(-0.4, 0.4, (2000, 3)).astype(np.float32) - np.float32([0, 0, 1]),
    ])


def _near_lens_296():  # tests/test_renderer.py: 296 footprints past the frame
    rng = np.random.RandomState(3)
    near = rng.uniform(-0.001, 0.001, (296, 3)).astype(np.float32)
    near[:, 2] = 1.999 + near[:, 2] * 0.1
    return np.concatenate(
        [near, rng.uniform(-0.4, 0.4, (500, 3)).astype(np.float32) - np.float32([0, 0, 1])]
    )


def _odd_rows():
    """NaN, infinite, behind-camera, far off-axis and on-frustum-edge rows
    among ordinary ones."""
    pos = _uniform(5, 400)
    pos[:8] = [[np.nan, 0, 0], [0, np.nan, 0], [0, 0, np.nan], [np.inf, 0, 0],
               [0, 1, 3.0], [50, 0, 0], [0, 0, 2.0], [0, 1, 2.0]]
    return pos


#: (name, positions, camera, width, height, footprint)
SCENES = {
    "uniform": (lambda: _uniform(3, 20000), jr.Camera(aspect=1.0), 400, 400, "triangle"),
    "splat": (lambda: _uniform(4, 5000), jr.Camera(aspect=1.0), 256, 256, "splat"),
    "near_lens": (_near_lens, LENS, 400, 400, "triangle"),
    "shell": (_shell, LENS, 400, 400, "triangle"),
    "near_lens_296": (_near_lens_296, LENS, 128, 128, "triangle"),
    "odd_rows": (_odd_rows, jr.Camera(aspect=1.0), 96, 64, "triangle"),
    "odd_rows_splat": (_odd_rows, jr.Camera(aspect=1.0), 96, 64, "splat"),
}


def _jax_clip(pos, camera):
    """JAX ``render_frame``'s projection (renderer.py:230-233)."""
    m = camera.view_proj()
    p = np.asarray(pos, np.float32)
    with np.errstate(invalid="ignore"):  # the scene's infinite row
        return p @ m[:3, :3].T + m[:3, 3], p @ m[3, :3] + m[3, 3]


def _jax_triangles(clip, w, width, height, footprint):
    """JAX ``render_frame``'s cull and pixel-space triangles from clip
    coordinates (renderer.py:234-264): (keep, cx, cy, sx, sy)."""
    s = jr.POINT_EXTENT
    grow = 1 if footprint == "splat" else 1 + s
    with np.errstate(invalid="ignore"):
        keep = ((w > 0) & (np.abs(clip[:, 0]) <= w * grow) & (np.abs(clip[:, 1]) <= w * grow)
                & (clip[:, 2] >= 0) & (clip[:, 2] <= w))
    ndc = clip[keep] / w[keep, None]
    s_ndc = s / w[keep]
    return (keep, (ndc[:, 0] + 1) * 0.5 * width, (1 - ndc[:, 1]) * 0.5 * height,
            s_ndc * 0.5 * width, s_ndc * 0.5 * height)


def _jax_counts(keep_cx_cy_sx_sy, width, height, footprint):
    _, cx, cy, sx, sy = keep_cx_cy_sx_sy
    if footprint == "splat":
        px = np.clip(cx.astype(np.int64), 0, width - 1)
        py = np.clip(cy.astype(np.int64), 0, height - 1)
        return np.bincount(py * width + px, minlength=width * height).reshape(height, width)
    f64 = [a.astype(np.float64) for a in (cx, cy, sx, sy)]
    return jr._triangle_coverage(*f64, width, height).reshape(height, width)


def _port_counts(keep, cx, cy, sx, sy, width, height, footprint):
    if footprint == "splat":
        return raster.splat_counts(cx[keep], cy[keep], width, height)
    return raster.triangle_counts(cx[keep], cy[keep], sx[keep], sy[keep], width, height)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_raster_stage_equals_jax_triangle_coverage(name):
    make, cam, width, height, footprint = SCENES[name]
    clip, w = _jax_clip(make(), cam)
    want = _jax_triangles(clip, w, width, height, footprint)
    got = raster.triangles(torch.from_numpy(clip), torch.from_numpy(w), width, height, footprint)
    keep = got[0].numpy()
    np.testing.assert_array_equal(keep, want[0])
    for g, wnt in zip(got[1:3 if footprint == "splat" else 5], want[1:]):
        np.testing.assert_array_equal(g.numpy()[keep], wnt)  # bit for bit
    counts = _port_counts(*got, width, height, footprint)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), _jax_counts(want, width, height, footprint))
    # the port's host copy of _triangle_coverage agrees too
    if footprint == "triangle":
        host = tr._triangle_coverage(*(a.astype(np.float64) for a in want[1:]), width, height)
        np.testing.assert_array_equal(counts.numpy().ravel(), host)


def test_raster_stage_covers_every_class():
    """The scenes reach both JAX classes (window and slack box) and boxes
    wider than the kernel's per-thread 8 x 8 square."""
    widest = {}
    for name in ("uniform", "near_lens", "shell", "near_lens_296"):
        make, cam, width, height, _ = SCENES[name]
        clip, w = raster.project(torch.from_numpy(make()), cam.view_proj())
        keep, cx, cy, sx, sy = raster.triangles(clip, w, width, height)
        x0, x1, y0, y1 = raster.boxes(cx[keep], cy[keep], sx[keep], sy[keep], width, height)
        widest[name] = int(torch.maximum(x1 - x0, y1 - y0).max())
    assert widest["uniform"] < 8 <= widest["shell"] < 31 < widest["near_lens"]
    assert widest["near_lens_296"] == 127  # the whole frame


def _term_bound(pos, m):
    """2 x eps32 x (|x m0| + |y m1| + |z m2| + |m3|) per row and output."""
    p = np.abs(np.asarray(pos, np.float64))
    a = np.abs(m.astype(np.float64))
    with np.errstate(invalid="ignore"):
        return 2 * EPS32 * (p @ a[:, :3].T + a[:, 3])


def _projection_rows(pos, camera):
    """Rows whose port projection differs from numpy's; each held to its
    bound here."""
    clip_j, w_j = _jax_clip(pos, camera)
    clip_p, w_p = tr.project_host(pos, camera.view_proj())
    got = np.concatenate([clip_p, w_p[:, None]], axis=1).astype(np.float64)
    want = np.concatenate([clip_j, w_j[:, None]], axis=1).astype(np.float64)
    finite = np.isfinite(want).all(axis=1)
    diff = ~((got == want) | (np.isnan(got) & np.isnan(want))).all(axis=1)
    bound = _term_bound(pos, camera.view_proj())
    held = finite & diff
    over = np.abs(got[held] - want[held]) > bound[held]
    assert not over.any(), f"{over.sum()} projected values beyond 2 eps32 x the terms"
    # the port's torch projection is the host one, bit for bit
    clip_t, w_t = raster.project(torch.from_numpy(pos), camera.view_proj())
    np.testing.assert_array_equal(clip_t.numpy(), clip_p)
    np.testing.assert_array_equal(w_t.numpy(), w_p)
    return diff, (clip_j, w_j), (clip_p, w_p)


def _explained(pos, camera, width, height, footprint):
    """Pixels that the rows of ``_projection_rows`` light under either
    projection: the only pixels where the port's image may differ."""
    rows, jax_clip, port_clip = _projection_rows(pos, camera)
    mask = np.zeros((height, width), bool)
    for clip, w in (jax_clip, port_clip):
        tris = _jax_triangles(clip[rows], w[rows], width, height, footprint)
        mask |= _jax_counts(tris, width, height, footprint) > 0
    return rows, mask


@pytest.mark.parametrize("name", sorted(SCENES))
def test_images_from_positions_equal_jax_but_for_projection_rows(name):
    make, cam, width, height, footprint = SCENES[name]
    pos = make()
    cam_p = tr.Camera(**vars(cam))
    want = jr.render_frame(pos, cam, width, height, footprint=footprint)
    host = tr.render_frame(pos, cam_p, width, height, footprint=footprint)
    dev = tr.render_frame_on_device(torch.from_numpy(pos), cam_p, width, height,
                                    footprint=footprint)
    np.testing.assert_array_equal(dev, host)  # plain version == host half
    assert dev.dtype == np.float32
    rows, mask = _explained(pos, cam, width, height, footprint)
    differ = dev != want
    assert not (differ & ~mask).any(), (
        f"{(differ & ~mask).sum()} pixels differ outside the footprints of the "
        f"{rows.sum()} rows whose projection differs"
    )


def test_camera_and_moves_equal_jax():
    cam_j, cam_p = jr.Camera(aspect=1.5), tr.Camera(aspect=1.5)
    np.testing.assert_array_equal(cam_p.view_proj(), cam_j.view_proj())
    for d in ("forward", "backward", "up", "down", "left", "right"):
        cam_j, cam_p = cam_j.moved(d, 0.2), cam_p.moved(d, 0.2)
        assert cam_p.eye == cam_j.eye
    np.testing.assert_array_equal(cam_p.view_proj(), cam_j.view_proj())
    assert tr.POINT_EXTENT == jr.POINT_EXTENT


def test_png_and_blend_equal_jax():
    img = np.linspace(-0.1, 1.1, 32 * 16, dtype=np.float32).reshape(16, 32)
    for level in (1, 6):
        assert tr.png_bytes(img, level) == jr.png_bytes(img, level)
    u8 = (np.arange(256, dtype=np.uint8)).reshape(16, 16)
    assert tr.png_bytes(u8) == jr.png_bytes(u8)
    np.testing.assert_array_equal(tr.blend_lut_u8(0.25), jr.blend_lut_u8(0.25))
    ks = np.arange(400, dtype=np.int64).reshape(20, 20)
    np.testing.assert_array_equal(tr.raster_blend(ks), jr.raster_blend([ks]))


def test_blend_u8_equals_host_quantisation():
    """counts 0-400 through the LUT == png_bytes' quantisation of the host
    float64 blend (tests/test_online.py's check), on both the plain version
    and the wrapper's CPU route."""
    ks = torch.arange(400, dtype=torch.int32).reshape(20, 20)
    expect = (np.clip(jr.raster_blend([ks.numpy()]), 0.0, 1.0) * 255.0).astype(np.uint8)
    for got in (raster.blend_u8(ks), raster_cuda.blend_u8_cuda(ks)):
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), expect)
    np.testing.assert_array_equal(tr.raster_blend_u8(ks), expect)


def test_write_png_and_ppm_bytes_equal_jax(tmp_path):
    img = jr.render_frame(_uniform(0, 300), None, 48, 40)
    for mod in (jr, tr):
        mod.write_png(str(tmp_path / f"{mod.__name__}.png"), img)
        mod.write_ppm(str(tmp_path / f"{mod.__name__}.ppm"), img)
    for ext in ("png", "ppm"):
        a = (tmp_path / f"{jr.__name__}.{ext}").read_bytes()
        assert (tmp_path / f"{tr.__name__}.{ext}").read_bytes() == a


def test_wrapper_routes_and_rejects():
    pos = torch.from_numpy(_uniform(1, 500))
    m = tr.Camera().view_proj()
    np.testing.assert_array_equal(
        raster_cuda.raster_counts_cuda(pos, m, 64, 48).numpy(),
        raster.raster_counts(pos, torch.from_numpy(m), 64, 48).numpy(),
    )
    with pytest.raises(TypeError):
        raster_cuda.raster_counts_cuda(pos.double(), m, 64, 48)
    with pytest.raises(ValueError):
        raster_cuda.raster_counts_cuda(pos[:, :2].contiguous(), m, 64, 48)
    with pytest.raises(ValueError):
        raster_cuda.raster_counts_cuda(pos, m, 64, 48, footprint="disc")
    with pytest.raises(ValueError):
        raster_cuda.raster_counts_cuda(pos, m, 0, 48)
    with pytest.raises(ValueError):
        raster_cuda.raster_counts_cuda(pos, m[:3], 64, 48)
    with pytest.raises(ValueError):
        raster_cuda.raster_counts_cuda(pos.to("meta"), m, 64, 48)
    with pytest.raises(TypeError):
        raster_cuda.blend_u8_cuda(torch.zeros((4, 4), dtype=torch.int64))
    before = (raster_cuda.LAUNCHES, raster_cuda.LAUNCHES_BLEND)
    raster_cuda.blend_u8_cuda(raster_cuda.raster_counts_cuda(pos, m, 8, 8))
    assert (raster_cuda.LAUNCHES, raster_cuda.LAUNCHES_BLEND) == before  # CPU never counts


def test_empty_and_all_culled_frames():
    m = tr.Camera().view_proj()
    assert int(raster.raster_counts(torch.zeros((0, 3)), m, 16, 16).sum()) == 0
    behind = torch.tensor([[0.0, 1.0, 3.0]] * 5)
    assert int(raster.raster_counts(behind, m, 16, 16).sum()) == 0


def test_frame_bytes():
    assert raster_cuda.frame_bytes(100_000, 400, 400) == 12 * 100_000 + 9 * 160_000
    assert raster_cuda.frame_bytes(10, 2, 2, listed=3) == 120 + 36 + 12



def _tile_pass(cx, cy, sx, sy, width, height, tile=16, chunk=256):
    """csrc/raster.cu's tile pass on listed triangles, in torch: each tile
    reads the list ``chunk`` entries at a time, keeps (in order) those whose
    ``raster.boxes`` box meets it, and each of its pixels tests only those.
    Returns (hits (H, W) int64, the tiles (tx, ty) that kept each entry)."""
    x0, x1, y0, y1 = raster.boxes(cx, cy, sx, sy, width, height)
    hits = torch.zeros((height, width), dtype=torch.int64)
    landed = [set() for _ in range(len(cx))]
    for ty in range(0, height, tile):
        for tx in range(0, width, tile):
            gy, gx = (a.reshape(-1, 1) for a in torch.meshgrid(
                torch.arange(ty, ty + tile), torch.arange(tx, tx + tile), indexing="ij"))
            h = torch.zeros(tile * tile, dtype=torch.int64)
            for base in range(0, len(cx), chunk):
                j = torch.arange(base, min(base + chunk, len(cx)))
                kept = j[(x0[j] <= tx + tile - 1) & (x1[j] >= tx) & (y0[j] <= ty + tile - 1)
                         & (y1[j] >= ty)]
                for k in kept.tolist():
                    landed[k].add((tx // tile, ty // tile))
                k = kept
                inbox = (gx >= x0[k]) & (gx <= x1[k]) & (gy >= y0[k]) & (gy <= y1[k])
                h += (inbox & raster.covers(gx, gy, cx[k], cy[k], sx[k], sy[k])).sum(1)
            inside = ((gx < width) & (gy < height)).flatten()
            hits[gy.flatten()[inside], gx.flatten()[inside]] += h[inside]
    return hits, landed


@pytest.mark.parametrize("name, cap", [("shell", 1 << 20), ("shell", 100),
                                       ("near_lens_296", 1 << 20), ("near_lens", 1 << 20)])
def test_tile_pass_model_lands_each_footprint_in_its_tiles(name, cap):
    # the kernel's split: boxes past 8 x 8 px are listed (in the order the
    # atomics give, here a shuffle) up to the list's capacity and drawn by
    # the tile pass; the rest, and a full list's overflow, per thread
    make, cam, width, height, footprint = SCENES[name]
    pos = torch.from_numpy(make())
    m = cam.view_proj()
    keep, cx, cy, sx, sy = raster.triangles(*raster.project(pos, m), width, height, footprint)
    cx, cy, sx, sy = (a[keep] for a in (cx, cy, sx, sy))
    x0, x1, y0, y1 = raster.boxes(cx, cy, sx, sy, width, height)
    wide = ((x1 >= x0) & (y1 >= y0) & ((x1 - x0 >= 8) | (y1 - y0 >= 8))).nonzero().flatten()
    order = wide[torch.randperm(len(wide), generator=torch.Generator().manual_seed(0))]
    listed, over = order[:cap], order[cap:]
    own = torch.ones(len(cx), dtype=torch.bool)
    own[listed] = False  # drawn per thread: small boxes and the list's overflow
    hits, landed = _tile_pass(cx[listed], cy[listed], sx[listed], sy[listed], width, height)
    for k, got in zip(listed.tolist(), landed):
        want = {(tx, ty) for tx in range(int(x0[k]) // 16, int(x1[k]) // 16 + 1)
                for ty in range(int(y0[k]) // 16, int(y1[k]) // 16 + 1)}
        assert got == want
    counts = raster.triangle_counts(cx[own], cy[own], sx[own], sy[own], width, height) + hits
    np.testing.assert_array_equal(counts.numpy(),
                                  raster.raster_counts(pos, m, width, height).numpy())
    assert len(listed) > 0 and (len(over) > 0) == (cap == 100)
    if name == "shell":  # many wide footprints, each over several tiles
        assert len(wide) > 400 and sum(len(t) for t in landed) > 2 * len(listed)

def test_kernel_source_mirrors_the_plain_constants():
    """csrc/raster.cu spells the plain version's constants: the extent, the
    cull's 1 + extent, the JAX window, and no fast math in the build."""
    src = raster_cuda.SOURCE.read_text()
    assert "static_cast<float>(0.006)" in src and "static_cast<float>(1.0 + 0.006)" in src
    assert raster.POINT_EXTENT == 0.006 and raster.WINDOW == 32
    assert "kWindowEdge = 31.0f" in src and "kWindow = 32" in src
    assert "--use_fast_math" not in raster_cuda.NVCC_FLAGS
    assert "__fdiv_rn" in src and "__dadd_rn" in src


def test_render_trajectory_bytes_equal_jax(tmp_path):
    """The host half's trajectory renderer writes JAX's files (PNG and PPM)
    for the same dump when the two images are equal."""
    from wgpu_n_body_tpu.runners.trajectory import TrajectoryReader as JaxReader
    from wgpu_n_body_tpu_torch.runners.trajectory import TrajectoryReader, TrajectoryWriter

    root = str(tmp_path / "traj")
    w = TrajectoryWriter(root)

    class State:
        pos = torch.from_numpy(_uniform(0, 100, -1, 1))

    w.append(State, 0)
    w.append(State, 1)
    same = (tr.render_frame(State.pos.numpy(), None, 64, 64)
            == jr.render_frame(State.pos.numpy(), None, 64, 64)).all()
    for fmt in ("png", "ppm"):
        ours = tr.render_trajectory(TrajectoryReader(root), str(tmp_path / f"p{fmt}"), None,
                                    64, 64, fmt)
        theirs = jr.render_trajectory(JaxReader(root), str(tmp_path / f"j{fmt}"), None,
                                      64, 64, fmt)
        assert [p.rsplit("/", 1)[1] for p in ours] == [p.rsplit("/", 1)[1] for p in theirs]
        assert len(ours) == 2
        if same:  # else the images test holds the difference to the projection rows
            for a, b in zip(ours, theirs):
                with open(a, "rb") as f, open(b, "rb") as g:
                    assert f.read() == g.read()
