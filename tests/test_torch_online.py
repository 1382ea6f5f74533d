"""PyTorch port, interactive viewer (runners/online.py) and the CLI's
``visualize``, ``serve`` and ``render``, on the CPU.

The viewer is driven as the JAX package's tests/test_online.py drives it:
one redraw per tick drawing the PRE-step state, held keys moving the camera
at speed 0.2, no step while unfocused, Esc quitting, through ``tick`` and
through a real HTTP round trip. The CLI's frames are held against the JAX
CLI's on the same trajectory, up to the projection's rows
(tests/test_torch_renderer.py).
"""

import http.client
import io
import json
import os
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_renderer import _explained
from wgpu_n_body_tpu import cli as jax_cli
from wgpu_n_body_tpu.runners import online as jax_online
from wgpu_n_body_tpu.runners.renderer import Camera as JaxCamera
from wgpu_n_body_tpu_torch import cli
from wgpu_n_body_tpu_torch.inits import disc_init
from wgpu_n_body_tpu_torch.models import NaiveSim
from wgpu_n_body_tpu_torch.ops import raster
from wgpu_n_body_tpu_torch.params import NaiveParams, SimParams
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.runners.online import CONTROLLER_SPEED, KEYMAP, OnlineViewer, make_server
from wgpu_n_body_tpu_torch.runners.renderer import (
    Camera,
    png_bytes,
    render_frame,
    render_frame_on_device,
    write_png,
)
from wgpu_n_body_tpu_torch.runners.trajectory import TrajectoryWriter

PIL = pytest.importorskip("PIL.Image")
PNG = b"\x89PNG\r\n\x1a\n"
PARAMS = SimParams(particle_num=64, g=1e-5, dt=0.0016)


def _viewer(**kw):
    kw.setdefault("width", 64)
    kw.setdefault("height", 64)
    return OnlineViewer(NaiveSim(PARAMS, NaiveParams(use_pallas=False)), disc_init,
                        device="cpu", **kw)


def _u8(img):
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def test_keymap_and_speed_equal_jax():
    assert KEYMAP == jax_online.KEYMAP and CONTROLLER_SPEED == jax_online.CONTROLLER_SPEED


def test_tick_steps_and_renders_and_focus_loss_pauses():
    v = _viewer()
    assert v.tick()[:8] == PNG
    assert v.runner.step_num == 1 and v.frames == 1
    assert v.tick(focused=False)[:8] == PNG  # bin/visualize.rs:65-71
    assert v.runner.step_num == 1 and v.frames == 2
    v.tick()
    assert v.runner.step_num == 2
    stats = v.stats()
    assert stats["frames"] == 3 and stats["steps"] == 2 and stats["n"] == 64
    assert stats["last_step_ms"] is not None and stats["fps"] is not None


def test_key_moves_match_camera_controller():
    v = _viewer()
    v.tick(keys="w")
    expect = Camera(aspect=1.0).moved("forward", CONTROLLER_SPEED)
    np.testing.assert_allclose(v.camera.eye, expect.eye, rtol=1e-6)
    v2 = _viewer()
    v2.tick(keys="ArrowUp")  # arrows alias WASD (online_renderer.rs:92-118)
    np.testing.assert_allclose(v2.camera.eye, v.camera.eye, rtol=1e-6)
    v3 = _viewer()
    v3.tick(keys="w,q,x")  # every held key, unknown ones ignored
    expect = expect.moved("up", CONTROLLER_SPEED)
    np.testing.assert_allclose(v3.camera.eye, expect.eye, rtol=1e-6)


def test_orbit_keeps_radius():
    v = _viewer()
    r0 = np.linalg.norm(np.asarray(v.camera.eye))
    for _ in range(5):
        v.tick(keys="d", focused=False)
    assert abs(np.linalg.norm(np.asarray(v.camera.eye)) - r0) < 1e-6
    assert v.runner.step_num == 0


def test_warmup_runs_one_frame_and_one_step():
    v = _viewer(steps_per_frame=2)
    v.warmup()
    assert v.runner.step_num == 1 and v.frames == 0
    assert v.tick(keys="w")[:8] == PNG
    assert v.runner.step_num == 3


def test_flythrough_frames_are_the_pre_step_state():
    """Every served PNG equals png_bytes(u8(render_frame_on_device(pre-step
    positions))) at that tick's camera, on a path that flies through the
    disc (footprints past the 8 x 8 and 31-px boxes) and back out."""
    v = _viewer(step_sync_every=3)
    # bodies on the flight path, just ahead of where the eye will be
    # (radii 2.04, 1.84, ..., 0.64 along the line to the origin)
    axis = np.asarray(Camera().eye) / np.linalg.norm(Camera().eye)
    pos = v.runner.state.pos.clone()
    for row, r in enumerate((1.21, 1.03, 0.62)):
        pos[row] = torch.from_numpy((axis * r + [0.004, 0.0, 0.0]).astype(np.float32))
    v.runner.state = v.runner.state._replace(pos=pos)
    script = [""] * 2 + ["w"] * 8 + ["s"] * 6 + ["", "a,e"]
    widest = 0
    for i, keys in enumerate(script):
        pos = v.runner.state.pos.clone()
        cam = v.camera
        for k in keys.split(",") if keys else []:
            cam = cam.moved(KEYMAP[k], CONTROLLER_SPEED)
        expect = png_bytes(_u8(render_frame_on_device(pos, cam, 64, 64)), level=v.png_level)
        assert v.tick(keys=keys) == expect, f"frame {i} (keys={keys!r})"
        assert not torch.equal(v.runner.state.pos, pos)  # it stepped after drawing
        clip, w = raster.project(pos, cam.view_proj())
        keep, cx, cy, sx, sy = raster.triangles(clip, w, 64, 64)
        x0, x1, y0, y1 = raster.boxes(cx[keep], cy[keep], sx[keep], sy[keep], 64, 64)
        widest = max(widest, int(torch.maximum(x1 - x0, y1 - y0).max()))
    # footprints past the kernel's 8 x 8 square and JAX's 31-px window
    assert widest > 31 and v.runner.step_num == len(script)


def test_http_round_trip():
    v = _viewer()
    server, done = make_server(v, host="127.0.0.1", port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/")
        page = conn.getresponse().read()
        assert b"wgpu-n-body" in page and b"frame.png" in page
        conn.request("GET", "/frame.png?keys=w,q&focus=1")
        assert conn.getresponse().read()[:8] == PNG
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["steps"] == 1 and stats["frames"] == 1
        assert stats["eye"] != [0.0, 1.0, 2.0]
        conn.request("GET", "/frame.png?focus=0")
        assert conn.getresponse().read()[:8] == PNG
        conn.request("GET", "/stats")
        assert json.loads(conn.getresponse().read())["steps"] == 1
        conn.request("GET", "/nothing")
        assert conn.getresponse().status == 404
        conn.request("GET", "/quit")
        assert conn.getresponse().read() == b"bye"
        assert done.wait(timeout=10)
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_cli_visualize_writes_the_host_render_of_each_state(tmp_path, capsys):
    out, gif = str(tmp_path / "frames"), str(tmp_path / "a.gif")
    argv = ["visualize", "--device", "cpu", "--sim", "naive", "--no-pallas", "--n", "256",
            "--frames", "2", "--width", "48", "--height", "32", "--out", out, "--gif", gif]
    assert cli.main(argv) == 0
    assert sorted(os.listdir(out)) == ["frame_000000.png", "frame_000001.png"]
    assert "wrote 2 frames" in capsys.readouterr().out and os.path.getsize(gif) > 0
    # the same run by hand: the frame after two steps, rendered on the host
    params = SimParams(particle_num=256, g=1e-5, dt=0.0016)
    r = OfflineHeadless(NaiveSim(params, NaiveParams(use_pallas=False)), disc_init, seed=0,
                        device="cpu")
    r.step()
    r.step()
    write_png(str(tmp_path / "host.png"), render_frame(r.state.pos.numpy(), None, 48, 32))
    with open(os.path.join(out, "frame_000001.png"), "rb") as f:
        assert f.read() == (tmp_path / "host.png").read_bytes()


def _decoded(path):
    img = PIL.open(path)
    frames = []
    for i in range(getattr(img, "n_frames", 1)):
        img.seek(i)
        frames.append(np.asarray(img.convert("L")))
    return frames


def test_cli_render_equals_jax_cli_render(tmp_path):
    """Both CLIs on one trajectory: PNG and GIF bytes equal, unless a pixel
    differs inside the footprint of a row whose projection differs (then
    only there)."""
    traj = str(tmp_path / "traj")
    w = TrajectoryWriter(traj)
    frames = [np.random.RandomState(s).uniform(-1, 1, (300, 3)).astype(np.float32)
              for s in range(3)]

    class State:
        pass

    for step, pos in enumerate(frames):
        State.pos = torch.from_numpy(pos)
        w.append(State, step)
    size = ["--width", "64", "--height", "48"]
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cli.main(["render", "--device", "cpu", "--trajectory", traj, "--out", ours,
                     "--gif", ours + ".gif", *size]) == 0
    assert jax_cli.main(["render", "--trajectory", traj, "--out", theirs,
                         "--gif", theirs + ".gif", *size]) == 0
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == names and len(names) == 3
    masks = [_explained(pos, JaxCamera(aspect=64 / 48), 64, 48, "triangle")[1] for pos in frames]
    pairs = [(_decoded(os.path.join(ours, n))[0], _decoded(os.path.join(theirs, n))[0])
             for n in names]
    pairs += list(zip(_decoded(ours + ".gif"), _decoded(theirs + ".gif")))
    for (a, b), mask in zip(pairs, masks + masks):
        assert not ((a != b) & ~mask).any()
    if all((a == b).all() for a, b in pairs):
        for n in names:
            with open(os.path.join(ours, n), "rb") as f, open(os.path.join(theirs, n), "rb") as g:
                assert f.read() == g.read()
        with open(ours + ".gif", "rb") as f, open(theirs + ".gif", "rb") as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("argv", [
    ["visualize", "--devices", "2", "--sim", "tree-host"],
    ["serve", "--devices", "2", "--n", "99"],
    ["visualize", "--sim", "naive", "--tree-kw", "theta=0.5"],
])
def test_cli_render_commands_usage_errors_exit_2(argv):
    with pytest.raises(SystemExit) as exc:
        cli.main([*argv, "--device", "cpu"])
    assert exc.value.code == 2


def test_cli_render_without_a_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        cli.main(["render", "--trajectory", str(tmp_path), "--device", "cuda"])
    assert "no CUDA device" in str(exc.value.code)


def test_png_level_one_is_what_serve_sends():
    img = np.random.RandomState(2).uniform(0, 1, (16, 24)).astype(np.float32)
    data = png_bytes(_u8(img), level=1)
    np.testing.assert_array_equal(np.asarray(PIL.open(io.BytesIO(data))), _u8(img))
