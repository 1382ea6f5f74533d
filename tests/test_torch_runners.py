"""PyTorch port, runner layer: energy, step loop, trajectory, checkpoints
(within the port and across packages) and the CLI, on the CPU."""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_n_body_tpu import params as jp
from wgpu_n_body_tpu.inits import uniform_init as jax_uniform_init
from wgpu_n_body_tpu.models.naive import NaiveSim as JaxNaiveSim
from wgpu_n_body_tpu.ops import energy as jax_energy
from wgpu_n_body_tpu.runners.headless import OfflineHeadless as JaxOfflineHeadless
from wgpu_n_body_tpu.runners.trajectory import TrajectoryReader as JaxTrajectoryReader
from wgpu_n_body_tpu.utils import checkpoint as jax_checkpoint
from wgpu_n_body_tpu_torch import cli
from wgpu_n_body_tpu_torch.inits import spherical_init, uniform_init
from wgpu_n_body_tpu_torch.models import NaiveSim, TreeSim
from wgpu_n_body_tpu_torch.ops import energy
from wgpu_n_body_tpu_torch.params import (
    NaiveParams,
    SimParams,
    TreeParams,
    state_from_numpy,
    state_to_numpy,
)
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.runners.trajectory import TrajectoryReader, TrajectoryWriter
from wgpu_n_body_tpu_torch.utils.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = SimParams(particle_num=96, g=1e-4)
NP_ = NaiveParams(use_pallas=False)
PALLAS_64 = dict(use_pallas=True, tile_i=64, tile_j=128)


def _runner():
    return OfflineHeadless(NaiveSim(PARAMS, NP_), uniform_init, seed=0, device="cpu")


def _np_state(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "pos": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "vel": rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32),
        "acc": np.zeros((n, 3), np.float32),
        "mass": rng.uniform(0.5, 2.0, n).astype(np.float32),
    }


@pytest.mark.parametrize("softened", [True, False])
def test_energy_matches_jax(softened):
    s = _np_state(3, PARAMS.particle_num)
    st = state_from_numpy(**s, device="cpu")
    jst = jp.ParticleState(**{k: jnp.asarray(v) for k, v in s.items()})
    jparams = jp.SimParams(**dataclasses.asdict(PARAMS))
    np.testing.assert_allclose(
        float(energy.kinetic_energy(st)), float(jax_energy.kinetic_energy(jst)), rtol=1e-6
    )
    np.testing.assert_allclose(
        float(energy.potential_energy(st, PARAMS, block=32, softened=softened)),
        float(jax_energy.potential_energy(jst, jparams, block=32, softened=softened)),
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        float(energy.total_energy(st, PARAMS, block=32, softened=softened)),
        float(jax_energy.total_energy(jst, jparams, block=32, softened=softened)),
        rtol=1e-5,
    )


def test_softened_pair_integral_matches_jax():
    rs = np.array([0.0, 0.01, 0.0464, 0.1, 0.3, 1.0, 2.5], np.float32)
    got = energy.softened_pair_integral(torch.from_numpy(rs), 1e-4).numpy()
    want = np.asarray(jax_energy.softened_pair_integral(jnp.asarray(rs), 1e-4))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_stepwise_and_chunked_agree():
    r1, r2 = _runner(), _runner()
    for _ in range(6):
        r1.step()
    r2.run(steps=6, chunk=3)
    torch.testing.assert_close(r1.state.pos, r2.state.pos, rtol=1e-6, atol=1e-7)
    assert r1.step_num == r2.step_num == 6
    assert len(r1.timer.times_s) == 6 and len(r2.timer.times_s) == 2


def test_energy_drift_small_over_short_run():
    params = SimParams(particle_num=128, g=1e-6, dt=0.004)
    r = OfflineHeadless(NaiveSim(params, NP_), uniform_init, seed=1, device="cpu")
    e0 = float(energy.total_energy(r.state, params))
    r.run(steps=50, chunk=10)
    e1 = float(energy.total_energy(r.state, params))
    assert abs(e1 - e0) / abs(e0) < 1e-3


@pytest.mark.slow
def test_energy_drift_long_horizon_proxy():
    # tests/test_runners.py:146-160 for the port: the CI-scale proxy of
    # BASELINE config 5 (100k-step drift run), N=512 spherical, 10k leapfrog
    # steps in chunks of 1000, and that test's bound (about 4x the 6.7e-3 it
    # records for the JAX package). chip_smoke.py runs it, and config 5
    # itself, on the card.
    params = SimParams(particle_num=512, g=1e-6, e=1e-4, dt=0.016)
    r = OfflineHeadless(NaiveSim(params, NP_), spherical_init, seed=2, device="cpu")
    e0 = float(energy.total_energy(r.state, params))
    r.run(steps=10_000, chunk=1000)
    e1 = float(energy.total_energy(r.state, params))
    assert abs(e1 - e0) / abs(e0) < 0.03


def test_trajectory_roundtrip_readable_by_both_packages(tmp_path):
    root = str(tmp_path / "traj")
    r = _runner()
    w = TrajectoryWriter(root, meta={"n": PARAMS.particle_num})
    r.run(steps=4, chunk=2, trajectory=w, trajectory_every=2)
    for reader in (TrajectoryReader(root), JaxTrajectoryReader(root)):
        assert reader.steps == [0, 2, 4]
        np.testing.assert_array_equal(reader.positions(2), r.state.pos.numpy())
        assert reader.meta["n"] == PARAMS.particle_num


def test_checkpoint_resume_is_bit_identical(tmp_path):
    ck = str(tmp_path / "state.npz")
    r1 = _runner()
    r1.run(steps=3, checkpoint_path=ck, checkpoint_every=3)
    r1.run(steps=3)
    ckpt = load_checkpoint(ck, device="cpu")
    assert ckpt.step == 3 and ckpt.params == PARAMS and ckpt.add_params == NP_
    r2 = OfflineHeadless(ckpt.make_sim(), uniform_init, seed=0, device="cpu")
    r2.state, r2.step_num = ckpt.state, ckpt.step
    r2.run(steps=3)
    for a, b in zip(r1.state, r2.state):
        assert torch.equal(a, b)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    ck = str(tmp_path / "jax.npz")
    jparams = jp.SimParams(particle_num=128, g=1e-5)
    jr = JaxOfflineHeadless(JaxNaiveSim(jparams, jp.NaiveParams(**PALLAS_64)), jax_uniform_init, key=0)
    jr.run(steps=2, checkpoint_path=ck, checkpoint_every=2)
    # JAX's own resume
    jck = jax_checkpoint.load_checkpoint(ck)
    jstate = jck.state
    jstep = jck.make_sim().make_step(donate=False)
    # the port's resume
    ckpt = load_checkpoint(ck, device="cpu")
    assert ckpt.step == 2 and dataclasses.asdict(ckpt.params) == dataclasses.asdict(jparams)
    assert ckpt.add_params == NaiveParams(**PALLAS_64)
    state = ckpt.state
    step = ckpt.make_sim().make_step()
    for _ in range(2):
        jstate, state = jstep(jstate), step(state)
    got = state_to_numpy(state)
    np.testing.assert_allclose(got["pos"], np.asarray(jstate.pos), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got["vel"], np.asarray(jstate.vel), rtol=1e-4, atol=1e-8)


def test_port_checkpoint_loads_in_jax(tmp_path):
    ck = str(tmp_path / "port.npz")
    sim = NaiveSim(SimParams(particle_num=128, g=1e-5), NaiveParams(**PALLAS_64))
    r = OfflineHeadless(sim, uniform_init, seed=2, device="cpu")
    r.run(steps=2, checkpoint_path=ck, checkpoint_every=2)
    jck = jax_checkpoint.load_checkpoint(ck)
    assert jck.step == 2 and jck.schedule is None
    assert jck.add_params == jp.NaiveParams(**PALLAS_64)
    for k, v in state_to_numpy(r.state).items():
        np.testing.assert_array_equal(np.asarray(getattr(jck.state, k)), v)
    jstate = jck.make_sim().make_step(donate=False)(jck.state)
    r.step()
    np.testing.assert_allclose(r.state.pos.numpy(), np.asarray(jstate.pos), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(r.state.vel.numpy(), np.asarray(jstate.vel), rtol=1e-4, atol=1e-8)


def test_make_sim_of_tree_checkpoint_raises(tmp_path):
    ck = str(tmp_path / "tree.npz")
    jparams = jp.SimParams(particle_num=16)
    jax_checkpoint.save_checkpoint(ck, jax_uniform_init(jax.random.key(0), jparams), jparams, 5)
    ckpt = load_checkpoint(ck, device="cpu")
    assert ckpt.step == 5 and ckpt.add_params is None
    # no add-params means TreeSim with the default (group) walk, as in JAX;
    # a sharded run's checkpoint needs the ranks' mesh, as in JAX
    sim = ckpt.make_sim()
    assert isinstance(sim, TreeSim) and sim.add_params == TreeParams()
    with pytest.raises(ValueError, match="pass mesh="):
        ckpt._replace(schedule={"name": "let", "let_cap": 64, "mesh_axes": ["x"]}).make_sim()


def test_chunk_cadence_validation():
    with pytest.raises(ValueError):
        _runner().run(steps=4, chunk=4, energy_every=3)


def test_cli_headless_on_cpu(tmp_path, capsys):
    ck, traj = str(tmp_path / "ck.npz"), str(tmp_path / "traj")
    argv = ["headless", "--sim", "naive", "--n", "256", "--steps", "3", "--device", "cpu",
            "--energy-every", "3", "--checkpoint", ck, "--trajectory", traj]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "step 3: total energy" in out and "us/step over 3 steps" in out
    ckpt = load_checkpoint(ck, device="cpu")
    assert ckpt.step == 3 and torch.isfinite(ckpt.state.pos).all()
    assert TrajectoryReader(traj).steps == [0, 1, 2, 3]


@pytest.mark.parametrize("extra", [["--sim", "tree", "--devices", "2", "--schedule", "let",
                                    "--fused-let-walk"]])
def test_cli_not_ported_exits_2(extra, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["headless", "--n", "64", "--device", "cpu", *extra])
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


def test_cli_headless_tree_defaults_on_cpu(tmp_path, capsys):
    # no --tree-kw: TreeSim with the default group walk
    ck = str(tmp_path / "tree.npz")
    argv = ["headless", "--sim", "tree", "--n", "256", "--steps", "2", "--device", "cpu",
            "--diag-every", "2", "--checkpoint", ck]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "us/step over 2 steps" in out and "'walk_deferred': 0" in out
    ckpt = load_checkpoint(ck, device="cpu")
    assert ckpt.step == 2 and torch.isfinite(ckpt.state.pos).all()
    assert ckpt.add_params == TreeParams() and ckpt.make_sim().add_params.walk == "group"
    assert cli.main(["bench", "--sim", "tree", "--sizes", "128", "--reps", "1",
                     "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["sim"] == "tree" and rec["n"] == 128 and rec["s_per_step"] > 0


def test_cli_bench_on_cpu(capsys):
    # no --sim: naive, then tree, at each size (the JAX CLI's default)
    assert cli.main(["bench", "--sizes", "64", "128", "--reps", "2", "--device", "cpu"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["sim"], r["n"]) for r in recs] == [
        ("naive", 64), ("naive", 128), ("tree", 64), ("tree", 128)]
    assert all(r["device"] == "cpu" and r["s_per_step"] > 0 for r in recs)
    assert all((r["pairs_per_sec"] is None) == (r["sim"] == "tree") for r in recs)


def test_cli_bench_returns_1_without_a_record(capsys):
    parser_defaults = dict(sim="", n=8192, g=1e-6, e=1e-4, dt=0.016, init=None, theta=0.75,
                           seed=0, no_pallas=False, tree_kw=[], devices=0, device="cpu", reps=1)
    # an empty sweep (truthy, so the default sizes do not replace it)
    args = argparse.Namespace(**parser_defaults, sizes=iter(()))
    assert cli.cmd_bench(args) == 1
    assert capsys.readouterr().out == ""
    args = argparse.Namespace(**parser_defaults, sizes=[64])
    assert cli.cmd_bench(args) == 0
    assert len(capsys.readouterr().out.splitlines()) == 2


@pytest.mark.parametrize("walk", ["group", "per_particle"])
def test_cli_walk_tile_above_512_on_cuda_exits_2(walk, capsys):
    # rejected from the device's name alone, before any state is made or
    # stepped: no GPU is needed to see it. Either walk: the diagnostics run
    # the group walk whatever ``walk`` is.
    with pytest.raises(SystemExit) as exc:
        cli.main(["headless", "--sim", "tree", "--n", "64", "--tree-kw", "walk_tile=1024",
                  "--tree-kw", f"walk={walk!r}", "--device", "cuda"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "walk_tile must be at most 512 on a CUDA device, got 1024" in err


def test_walk_tile_above_512_runs_on_cpu(capsys):
    sim = TreeSim(SimParams(particle_num=64), TreeParams(walk_tile=1024))
    with pytest.raises(ValueError, match="walk_tile must be at most 512"):
        sim.init_state(torch.Generator().manual_seed(0), uniform_init, "cuda")
    sim.check_device(torch.device("cpu"))
    TreeSim(SimParams(particle_num=64), TreeParams(walk_tile=512)).check_device(
        torch.device("cuda"))
    argv = ["headless", "--sim", "tree", "--n", "600", "--steps", "1", "--device", "cpu",
            "--tree-kw", "walk_tile=1024"]
    assert cli.main(argv) == 0
    assert "us/step over 1 steps" in capsys.readouterr().out


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import wgpu_n_body_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "assert 'wgpu_n_body_tpu_torch.cli' in names, names\n"
        "assert 'jax' not in sys.modules and 'wgpu_n_body_tpu' not in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
