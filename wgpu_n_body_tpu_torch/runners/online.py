"""Interactive online viewer — counterpart of
``wgpu_n_body_tpu/runners/online.py``: the reference's windowed visualizer
(src/bin/visualize.rs, src/runners/online_renderer.rs) as a local web app.

- GET /frame.png is the redraw request: it applies the held keys reported
  by the page (CameraController::update_camera at speed 0.2,
  online_renderer.rs:125-165,316), steps the sim, and returns the frame.
  Like the reference, the frame drawn is the state *before* the step
  encoded on the same tick (naive.rs:164-166, tree.rs:355-357).
- Key mapping as online_renderer.rs:92-118: W/Up forward, S/Down backward,
  A/Left orbit left, D/Right orbit right, Q up, E down.
- Focus loss pauses stepping (bin/visualize.rs:65-71); Escape (or closing
  the tab) ends the run through /quit (bin/visualize.rs:78-87).

Everything but torch is stdlib: http.server and a zlib PNG encoder. Run it
with ``python -m wgpu_n_body_tpu_torch.cli serve`` and open
http://127.0.0.1:8000/.

A sharded sim (``cli serve --devices K``) steps on every rank: rank 0 runs
the server, and each of its ticks first broadcasts one small int tensor
(steps to take, what to do) to the other ranks, which ``follow`` it: every
rank takes its part in the gather of the positions rank 0 draws, then in
the steps. While no frame is asked for, ``serve`` broadcasts an idle
command every ``IDLE_EVERY_S`` seconds, so that the other ranks' wait never
reaches the process group's timeout; on every way out of ``serve``
(/quit, Ctrl-C, an error) ``close`` sends the quit.
"""

from __future__ import annotations

import collections
import json
import threading
import time

import torch

from wgpu_n_body_tpu_torch.models.base import InitFn, Simulator
from wgpu_n_body_tpu_torch.ops import raster_cuda
from wgpu_n_body_tpu_torch.parallel.mesh import broadcast
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.runners.renderer import Camera, png_bytes, raster_dispatch
from wgpu_n_body_tpu_torch.utils.profiling import sync

#: browser key -> CameraController direction (online_renderer.rs:92-118)
KEYMAP = {
    "w": "forward", "arrowup": "forward",
    "s": "backward", "arrowdown": "backward",
    "a": "left", "arrowleft": "left",
    "d": "right", "arrowright": "right",
    "q": "up",
    "e": "down",
}

#: reference controller speed (online_renderer.rs:316)
CONTROLLER_SPEED = 0.2

#: What rank 0 tells the other ranks of a sharded sim: draw a frame and take
#: the steps, end, or nothing (keeps the group alive while no frame is asked)
FRAME, QUIT, IDLE = 0, 1, 2
#: Seconds between idle commands while ``serve`` waits (the process group's
#: timeout is minutes: ``parallel/mesh.py::init_distributed``)
IDLE_EVERY_S = 10.0


class OnlineViewer:
    """Window-loop state: sim driver + camera + controller, HTTP-agnostic.

    ``tick(keys, focused)`` is one winit redraw: input -> update -> render
    -> (maybe) step. Thread-safe: the HTTP server is threaded, and the lock
    covers every use of the state and of the device's stream, so all of a
    viewer's kernels run in the order ``tick`` enqueues them.

    The frame is pipelined: the raster and the u8 blend of the pre-step
    state, and the copy of the image into a pinned host buffer, are
    enqueued first and marked by a CUDA event; then the step is enqueued;
    then the host waits on the event (the frame, not the step) and encodes
    the PNG while the step runs. A plain ``.cpu()`` would wait for the step.

    ``step_sync_every``: every k-th focused frame also waits for the step,
    to measure true ms/step for the HUD; that frame loses the overlap.
    """

    def __init__(
        self,
        sim: Simulator,
        init_fn: InitFn,
        seed: int = 0,
        width: int = 400,
        height: int = 400,
        steps_per_frame: int = 1,
        footprint: str = "triangle",
        speed: float = CONTROLLER_SPEED,
        png_level: int = 1,
        step_sync_every: int = 32,
        fps_window: int = 40,
        *,
        device: str | torch.device,
    ):
        self.runner = OfflineHeadless(sim, init_fn, seed=seed, device=device)
        self.mesh = getattr(sim, "mesh", None)
        self.device = self.runner.state.pos.device
        self.camera = Camera(aspect=width / height)
        self.width, self.height = width, height
        self.steps_per_frame = steps_per_frame
        self.footprint = footprint
        self.speed = speed
        self.png_level = png_level
        self.step_sync_every = max(1, step_sync_every)
        self.alpha = 0.25
        self.frames = 0
        self.last_step_ms = float("nan")
        self.last_frame_ms = float("nan")
        self._frame_clock = collections.deque(maxlen=max(2, fps_window))
        self._lock = threading.Lock()
        self._host = torch.empty(
            (height, width), dtype=torch.uint8, pin_memory=self.device.type == "cuda"
        )

    def _command(self, steps: int = 0, op: int = FRAME) -> tuple[int, int]:
        """(steps, op) of this tick: rank 0's, broadcast to every rank of a
        sharded sim (the other ranks' arguments are not read)."""
        if self.mesh is None:
            return steps, op
        msg = torch.tensor([steps, op], dtype=torch.int32, device=self.device)
        steps, op = broadcast(msg).tolist()
        return steps, op

    def _advance(self, steps: int) -> None:
        for _ in range(steps):
            self.runner.state = self.runner._step(self.runner.state)
        self.runner.step_num += steps

    def follow(self) -> None:
        """A sharded sim's rank other than 0: take rank 0's commands, each
        the gather of a frame and its steps or nothing, until it sends
        quit."""
        while True:
            steps, op = self._command()
            if op == QUIT:
                return
            if op == FRAME:
                self.runner.whole_state()
                self._advance(steps)

    def idle(self) -> None:
        """Tell the other ranks of a sharded sim that rank 0 is still there
        (rank 0, while no frame is asked for); nothing for one device."""
        with self._lock:
            self._command(op=IDLE)

    def close(self) -> None:
        """Send the other ranks of a sharded sim the quit (rank 0, on its
        way out of ``serve``); nothing for one device."""
        with self._lock:
            self._command(op=QUIT)

    def warmup(self) -> None:
        """Build the raster kernels and run one frame and one step, so the
        first served frame pays for no build."""
        with self._lock:
            if self.device.type == "cuda":
                raster_cuda.build()
            self._command(1)
            self._enqueue_frame()
            self._advance(1)
            sync(self.runner.state.pos)

    def apply_input(self, keys: str) -> None:
        """One controller tick for each held key (update_camera applies
        every pressed direction each frame, online_renderer.rs:125-165)."""
        for k in keys.split(",") if keys else []:
            d = KEYMAP.get(k.strip().lower())
            if d:
                self.camera = self.camera.moved(d, self.speed)

    def _enqueue_frame(self):
        """Enqueue raster, blend and the copy to the host buffer of the
        current state; returns the event that marks their end (None on the
        CPU, where they have ended already)."""
        counts = raster_dispatch(
            self.runner.whole_state().pos, self.camera, self.width, self.height,
            footprint=self.footprint,
        )
        img = raster_cuda.blend_u8_cuda(counts, self.alpha)
        self._host.copy_(img, non_blocking=True)
        if self.device.type != "cuda":
            return None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return done

    def tick(self, keys: str = "", focused: bool = True) -> bytes:
        """One redraw: returns the PNG frame. Steps only when focused
        (bin/visualize.rs:65-71); the drawn state is pre-step, like the
        reference's trailing dest_particle_slice."""
        with self._lock:
            tf = time.perf_counter()
            self.apply_input(keys)
            self._command(self.steps_per_frame if focused else 0)
            frame_done = self._enqueue_frame()
            if focused:
                sync_step = self.frames % self.step_sync_every == 0
                t0 = time.perf_counter()
                self._advance(self.steps_per_frame)
                if sync_step:  # sparse true-step-time probe for the HUD
                    sync(self.runner.state.pos)
                    self.last_step_ms = (
                        (time.perf_counter() - t0) * 1e3 / self.steps_per_frame
                    )
            if frame_done is not None:
                frame_done.synchronize()  # the frame, not the step behind it
            png = png_bytes(self._host.numpy(), level=self.png_level)
            self.frames += 1
            now = time.perf_counter()
            self.last_frame_ms = (now - tf) * 1e3
            self._frame_clock.append(now)
            return png

    def stats(self) -> dict:
        with self._lock:
            clock = list(self._frame_clock)
            # windowed steady-state fps: a lifetime average includes the
            # kernel build and understates for minutes
            fps = (
                round((len(clock) - 1) / (clock[-1] - clock[0]), 2)
                if len(clock) >= 2 and clock[-1] > clock[0]
                else None
            )
            return {
                "frames": self.frames,
                "steps": self.runner.step_num,
                "last_step_ms": None
                if self.last_step_ms != self.last_step_ms
                else round(self.last_step_ms, 3),
                "last_frame_ms": None
                if self.last_frame_ms != self.last_frame_ms
                else round(self.last_frame_ms, 3),
                "fps": fps,
                "n": self.runner.sim.sim_params.particle_num,
                "eye": [round(float(v), 4) for v in self.camera.eye],
            }


_PAGE = """<!doctype html>
<title>wgpu-n-body torch</title>
<style>
 body { background:#000; color:#9a9a9a; font:12px monospace; margin:0 }
 #hud { position:fixed; top:8px; left:8px; white-space:pre }
 img { display:block; margin:auto; image-rendering:pixelated }
</style>
<div id="hud"></div><img id="v" width="%W%" height="%H%">
<script>
 const held = new Set();
 let focused = true, closing = false;
 addEventListener('keydown', e => {
   if (e.key === 'Escape') { closing = true; fetch('/quit'); return; }
   held.add(e.key.toLowerCase());
 });
 addEventListener('keyup', e => held.delete(e.key.toLowerCase()));
 addEventListener('blur', () => focused = false);   // visualize.rs:65-71
 addEventListener('focus', () => focused = true);
 async function loop() {
   while (!closing) {
     const q = '/frame.png?keys=' + Array.from(held).join(',') +
               '&focus=' + (focused ? 1 : 0) + '&t=' + Date.now();
     const r = await fetch(q);
     if (!r.ok) break;
     const blob = await r.blob();
     const url = URL.createObjectURL(blob);
     const img = document.getElementById('v');
     const old = img.src; img.src = url;
     if (old) URL.revokeObjectURL(old);
     const s = await (await fetch('/stats')).json();
     document.getElementById('hud').textContent =
       `step ${s.steps}  ${s.last_step_ms ?? '-'} ms/step  ` +
       `${s.fps ?? '-'} fps  N=${s.n}` +
       `\\nWASD/arrows move - QE up/down - Esc quits - blur pauses`;
   }
 }
 loop();
</script>"""


def make_server(viewer: OnlineViewer, host: str = "127.0.0.1", port: int = 8000):
    """Bind the viewer's HTTP server; returns (server, done_event).

    ``server.server_address[1]`` is the bound port (pass port=0 for an
    ephemeral one); ``done_event`` is set by GET /quit (the Esc key)."""
    import http.server
    import urllib.parse

    page = (
        _PAGE.replace("%W%", str(viewer.width))
        .replace("%H%", str(viewer.height))
        .encode()
    )
    done = threading.Event()

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(u.query)
            if u.path == "/":
                self._send(200, "text/html", page)
            elif u.path == "/frame.png":
                png = viewer.tick(
                    keys=q.get("keys", [""])[0],
                    focused=q.get("focus", ["1"])[0] == "1",
                )
                self._send(200, "image/png", png)
            elif u.path == "/stats":
                self._send(
                    200, "application/json",
                    json.dumps(viewer.stats()).encode(),
                )
            elif u.path == "/quit":
                self._send(200, "text/plain", b"bye")
                done.set()
            else:
                self._send(404, "text/plain", b"not found")

    server = http.server.ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    return server, done


def serve(viewer: OnlineViewer, host: str = "127.0.0.1", port: int = 8000):
    """Blocking event loop: serve the viewer until Escape/close (/quit).
    Every ``IDLE_EVERY_S`` seconds of the wait it sends the other ranks of a
    sharded sim the idle command, and whatever ends the loop, the quit."""
    try:
        print("building the raster kernels and the first step ...")
        viewer.warmup()
        server, done = make_server(viewer, host, port)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        print(f"viewing at http://{host}:{server.server_address[1]}/  (Esc quits)")
        try:
            while not done.wait(IDLE_EVERY_S):
                viewer.idle()
        except KeyboardInterrupt:
            pass
        server.shutdown()
        server.server_close()
    finally:
        viewer.close()
    return viewer.stats()
