"""PyTorch port, ``--devices K`` for ``bench``, ``visualize`` and ``serve``
on K gloo CPU ranks (the JAX ``_build_sim`` shards every command that builds
a sim, ``wgpu_n_body_tpu/cli.py:47-94``).

Every rank steps its slice; rank 0 prints, and draws the positions gathered
from every rank. The frames are held against the host render of the
gathered state: ``visualize``'s against ``render`` of a sharded
``headless --trajectory`` of the same scene, the served ones against a
sharded run of as many steps. The usage errors of ``headless --devices``
are those of every command.
"""

import datetime
import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from wgpu_n_body_tpu_torch import cli
from wgpu_n_body_tpu_torch.inits import disc_init
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams
from wgpu_n_body_tpu_torch.parallel import ShardedTreeSim, init_distributed, make_mesh
from wgpu_n_body_tpu_torch.parallel.mesh import free_port
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.runners import online
from wgpu_n_body_tpu_torch.runners.online import OnlineViewer, serve
from wgpu_n_body_tpu_torch.runners.renderer import png_bytes, render_frame_on_device

K = 2
#: the JAX ``cli bench`` line's keys (wgpu_n_body_tpu/cli.py:318-324)
JAX_BENCH_KEYS = {"sim", "n", "s_per_step", "bodies_per_sec", "pairs_per_sec"}


def test_cli_bench_devices_2_prints_jax_keys(capfd):
    assert cli.main(["bench", "--devices", str(K), "--device", "cpu", "--sizes", "4096",
                     "--reps", "2"]) == 0
    recs = [json.loads(line) for line in capfd.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [(r["sim"], r["n"]) for r in recs] == [("naive", 4096), ("tree", 4096)]
    for r in recs:  # rank 0 alone prints
        assert JAX_BENCH_KEYS <= set(r) and r["s_per_step"] > 0 and r["devices"] == K
        assert r["bodies_per_sec"] == pytest.approx(4096 / r["s_per_step"])
    assert [r["schedule"] for r in recs] == ["allgather", "replicated"]
    assert recs[0]["pairs_per_sec"] == pytest.approx(4096 * 4096 / recs[0]["s_per_step"])
    assert recs[1]["pairs_per_sec"] is None


def test_cli_visualize_devices_2_draws_the_gathered_state(tmp_path, capfd):
    """Frame k of a sharded ``visualize`` is bit-equal to ``render`` of step
    k + 1 of a sharded ``headless`` of the same scene (visualize's defaults:
    TreeSim, disc, g 1e-5, dt 0.0016) dumped every step."""
    out, traj, ref = (str(tmp_path / d) for d in ("frames", "traj", "ref"))
    scene = ["--devices", str(K), "--device", "cpu", "--n", "4096", "--seed", "3"]
    assert cli.main(["visualize", *scene, "--frames", "3", "--out", out]) == 0
    assert cli.main(["headless", *scene, "--init", "disc", "--g", "1e-5", "--dt", "0.0016",
                     "--steps", "3", "--trajectory", traj, "--trajectory-every", "1"]) == 0
    assert cli.main(["render", "--device", "cpu", "--trajectory", traj, "--out", ref]) == 0
    printed = capfd.readouterr().out
    assert printed.count("wrote 3 frames") == 1 and printed.count("wrote 4 frames") == 1
    frames = sorted(os.listdir(out))
    assert frames == [f"frame_{k:06d}.png" for k in range(3)]
    for k, name in enumerate(frames):
        with open(os.path.join(out, name), "rb") as f, \
                open(os.path.join(ref, f"frame_{k + 1:08d}.png"), "rb") as g:
            assert f.read() == g.read(), name


SERVE_PARAMS = SimParams(particle_num=1024, g=1e-5, dt=0.0016)
SERVE_TP = TreeParams(max_depth=10, walk_tile=64)


def _serve_rank(rank, out, port):
    """The serve protocol on one of K ranks: rank 0 ticks (focused, then
    unfocused, then focused) and quits; the others follow. Then both run
    the same steps through the runner, and rank 0 renders the gathered
    states the frames should show."""
    torch.set_num_threads(1)
    init_distributed("gloo", rank, K, f"tcp://localhost:{port}")
    try:
        mesh = make_mesh()

        def sim():
            return ShardedTreeSim(SERVE_PARAMS, mesh, SERVE_TP)

        viewer = OnlineViewer(sim(), disc_init, seed=0, width=64, height=48, device="cpu")
        if rank:
            viewer.follow()
            frames = []
        else:
            viewer.warmup()
            frames = [viewer.tick(focused=f) for f in (True, False, True)]
            viewer.close()
        steps = viewer.runner.step_num
        # what each frame drew: the gathered state after 1, 2 and 2 steps
        runner = OfflineHeadless(sim(), disc_init, seed=0, device="cpu")
        want = []
        for k in (1, 1, 0):
            runner.run(steps=k, log_fn=lambda line: None)
            want.append(runner.whole_state().pos)
        if rank == 0:
            cam = viewer.camera
            expect = [png_bytes((np.clip(render_frame_on_device(p, cam, 64, 48), 0.0, 1.0)
                                 * 255.0).astype(np.uint8), level=viewer.png_level)
                      for p in want]
            np.savez(os.path.join(out, "serve.npz"), steps=steps,
                     equal=[a == b for a, b in zip(frames, expect)],
                     same=frames[1] == frames[2])
        else:
            np.savez(os.path.join(out, f"follower{rank}.npz"), steps=steps)
    finally:
        dist.destroy_process_group()


def test_serve_protocol_over_two_gloo_ranks(tmp_path):
    """Each served frame is the host render of the state gathered from both
    ranks before the tick's step; focus 0 steps no rank; the quit ends the
    follower's loop and both ranks exit 0 (``mp.spawn`` raises otherwise)."""
    mp.spawn(_serve_rank, args=(str(tmp_path), free_port()), nprocs=K, join=True)
    with np.load(tmp_path / "serve.npz") as z:
        assert int(z["steps"]) == 3 and z["equal"].all() and bool(z["same"])
    with np.load(tmp_path / "follower1.npz") as z:
        assert int(z["steps"]) == 3


#: the process group's timeout in the idle test, and how long its page asks
#: for no frame: well past that timeout
IDLE_TIMEOUT_S = 2.0
IDLE_GAP_S = 5.0


def _get(url, wait_s=60.0):
    """The body of GET ``url``, retried until the server listens."""
    t_end = time.monotonic() + wait_s
    while True:
        try:
            with urllib.request.urlopen(url, timeout=wait_s) as r:
                return r.read()
        except OSError:
            if time.monotonic() > t_end:
                raise
            time.sleep(0.1)


def _serve_idle_rank(rank, out, port, http_port, mode):
    """``serve`` on rank 0 of a group whose timeout is IDLE_TIMEOUT_S, the
    other rank following. mode "idle": no frame for IDLE_GAP_S, then one
    frame and /quit. mode "error": rank 0's port is taken, so ``serve``
    raises after the warm-up."""
    torch.set_num_threads(1)
    online.IDLE_EVERY_S = 0.2
    # the store waits for both ranks as long as it takes; the short timeout
    # is the group's, which every collective's wait is held to
    store = dist.TCPStore("localhost", port, K, rank == 0,
                          timeout=datetime.timedelta(seconds=120))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=K,
                            timeout=datetime.timedelta(seconds=IDLE_TIMEOUT_S))
    try:
        viewer = OnlineViewer(ShardedTreeSim(SERVE_PARAMS, make_mesh(), SERVE_TP), disc_init,
                              seed=0, width=64, height=48, device="cpu")
        if rank:
            viewer.follow()
        elif mode == "idle":
            th = threading.Thread(target=serve, args=(viewer, "127.0.0.1", http_port))
            th.start()
            _get(f"http://127.0.0.1:{http_port}/stats")
            time.sleep(IDLE_GAP_S)
            png = _get(f"http://127.0.0.1:{http_port}/frame.png?focus=1")
            _get(f"http://127.0.0.1:{http_port}/quit")
            th.join(timeout=60)
            assert png.startswith(b"\x89PNG") and not th.is_alive()
        else:
            with socket.socket() as taken:
                taken.bind(("127.0.0.1", http_port))
                taken.listen()
                with pytest.raises(OSError):
                    serve(viewer, "127.0.0.1", http_port)
        np.savez(os.path.join(out, f"{mode}{rank}.npz"), steps=viewer.runner.step_num)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode, steps", [("idle", 2), ("error", 1)])
def test_serve_ends_every_rank_cleanly(tmp_path, mode, steps):
    """``serve --devices K``: an idle page longer than the process group's
    timeout does not end the other ranks (rank 0 sends them the idle command
    while it waits), and when rank 0's ``serve`` fails (its port taken) the
    others still get the quit and exit 0 (``mp.spawn`` raises otherwise).
    Both ranks took the warm-up's step and, when idle, the one frame's."""
    mp.spawn(_serve_idle_rank, args=(str(tmp_path), free_port(), free_port(), mode),
             nprocs=K, join=True)
    for rank in range(K):
        with np.load(tmp_path / f"{mode}{rank}.npz") as z:
            assert int(z["steps"]) == steps


@pytest.mark.parametrize("command", ["headless", "visualize", "serve", "bench"])
@pytest.mark.parametrize("extra, says", [
    (["--sim", "naive", "--schedule", "let"], "--schedule 'let' invalid for --sim naive"),
    (["--sim", "tree-host"], "--devices requires --sim naive|tree"),
    (["--sim", "naive", "--n", "66"], "not divisible"),
    (["--sim", "naive", "--device", "cuda"], "CUDA devices are visible"),
    (["--sim", "naive", "--fused-let-walk"], "--fused-let-walk applies to --sim tree"),
])
def test_cli_devices_usage_errors_exit_2(command, extra, says, capsys):
    """The usage errors of ``headless --devices`` are every command's: a bad
    ``--schedule``, another ``--sim``, too few GPUs, an indivisible N, the
    fused walk off the LET schedule. None says sharded runs are `headless`
    only any more."""
    if "--device" not in extra:
        extra = [*extra, "--device", "cpu"]
    if command == "bench":
        extra = [*extra, "--sizes", extra[extra.index("--n") + 1] if "--n" in extra else "64"]
    with pytest.raises(SystemExit) as exc:
        cli.main([command, "--devices", "4", "--n", "64", *extra])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert says in err and "Traceback" not in err and "headless` only" not in err
