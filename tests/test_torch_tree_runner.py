"""PyTorch port, tree slice above the ops: the runner's overflow and
diagnostics side channels, ``cli headless|bench --sim tree`` and tree
checkpoints across the two packages, on the CPU."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_n_body_tpu import params as jp
from wgpu_n_body_tpu.inits import uniform_init as jax_uniform_init
from wgpu_n_body_tpu.models.tree import TreeSim as JaxTreeSim
from wgpu_n_body_tpu.runners.headless import OfflineHeadless as JaxOfflineHeadless
from wgpu_n_body_tpu.utils import checkpoint as jax_checkpoint
from wgpu_n_body_tpu_torch import cli
from wgpu_n_body_tpu_torch.inits import uniform_init
from wgpu_n_body_tpu_torch.models import TreeSim
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams, state_from_numpy, state_to_numpy
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

TREE_KW = dict(theta=0.5, max_depth=10, walk="per_particle", walk_engine="skip")
POS_TOL = dict(rtol=1e-5, atol=1e-8)
VEL_TOL = dict(rtol=1e-4, atol=1e-8)
# argv of the shell words --tree-kw walk='"per_particle"'
PER_PARTICLE = ["--tree-kw", 'walk="per_particle"']


def _closing_pairs_state():
    """32 pairs, each closing its gap within two steps: the arena of a
    4N-capacity singleton-leaf tree holds the first two builds and
    overflows on the third (the pairs then drag chains to max depth)."""
    rng = np.random.default_rng(11)
    base = rng.uniform(-0.9, 0.9, (32, 3)).astype(np.float32)
    off = rng.uniform(-0.05, 0.05, (32, 3)).astype(np.float32)
    return {
        "pos": np.concatenate([base, base + off]),
        "vel": np.concatenate([np.zeros_like(off), -off / np.float32(2 * 0.016)]),
        "acc": np.zeros((64, 3), np.float32),
        "mass": np.ones(64, np.float32),
    }


def _closing_pairs_runner():
    tp = TreeParams(theta=0.5, max_depth=16, leaf_bucket=1, node_capacity_factor=4,
                    walk="per_particle")
    sim = TreeSim(SimParams(particle_num=64, g=1e-9, dt=0.016), tp)
    s = _closing_pairs_state()
    return OfflineHeadless(sim, lambda gen, p, dev: state_from_numpy(**s, device=dev),
                           device="cpu")


@pytest.mark.parametrize("chunk, raised_at", [(1, 3), (2, 4)])
def test_overflow_raises_on_a_later_batch(chunk, raised_at):
    r = _closing_pairs_runner()
    assert not r.sim.diagnose(r.state)["overflowed"]  # the first build is healthy
    with pytest.raises(RuntimeError, match="overflow"):
        r.run(steps=6, chunk=chunk)
    # the third step's build overflowed: raised at the end of its batch
    assert r.step_num == raised_at


def test_overflow_check_and_diag_cadences():
    r = _closing_pairs_runner()
    logs = []
    with pytest.raises(RuntimeError, match="overflow"):
        r.run(steps=6, overflow_check_every=1, diag_log_every=1, log_fn=logs.append)
    # the cadence check re-builds from the state after step 2 and raises
    # before the overflowed third step runs
    assert r.step_num == 2
    diags = [line for line in logs if "num_nodes" in line]
    assert diags[0].startswith("step 1: {'num_nodes': ") and "'overflowed': False" in diags[0]


def test_single_step_raises_on_overflow():
    r = _closing_pairs_runner()
    r.step()
    r.step()
    with pytest.raises(RuntimeError, match="overflow"):
        r.step()


def test_cli_headless_tree_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    argv = ["headless", "--sim", "tree", "--n", "256", "--steps", "2", "--device", "cpu",
            "--theta", "0.6", *PER_PARTICLE, "--tree-kw", "max_depth=10",
            "--diag-every", "2", "--overflow-check-every", "1", "--checkpoint", ck]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "us/step over 2 steps" in out and "'overflowed': False" in out
    ckpt = load_checkpoint(ck, device="cpu")
    assert ckpt.step == 2 and torch.isfinite(ckpt.state.pos).all()
    assert ckpt.add_params == TreeParams(theta=0.6, max_depth=10, walk="per_particle")
    assert isinstance(ckpt.make_sim(), TreeSim)


@pytest.mark.parametrize(
    "extra, says",
    [
        (["--tree-kw", "walk=per_particle"], "walk"),  # not a Python literal
        (["--tree-kw", "leaf_bucket=[1"], "leaf_bucket"),
        (["--tree-kw", "bucket=4"], "NAME one of"),
        (["--tree-kw", 'leaf_bucket="x"', *PER_PARTICLE], "leaf_bucket"),
        (["--tree-kw", 'walk="stack"'], "unknown walk"),
        (["--sim", "naive", *PER_PARTICLE], "--sim tree|tree-host only"),
    ],
)
def test_cli_tree_usage_errors_exit_2(extra, says, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["headless", "--n", "64", "--device", "cpu", *extra])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert says in err and "Traceback" not in err


def test_cli_bench_naive_and_tree_on_cpu(capsys):
    argv = ["bench", "--sim", "naive,tree", "--sizes", "128", "--reps", "1", "--device", "cpu",
            *PER_PARTICLE]
    assert cli.main(argv) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["sim"], r["n"]) for r in recs] == [("naive", 128), ("tree", 128)]
    assert recs[0]["pairs_per_sec"] > 0 and recs[1]["pairs_per_sec"] is None
    assert all(r["s_per_step"] > 0 for r in recs)


def test_jax_tree_checkpoint_resumes_in_port(tmp_path):
    ck = str(tmp_path / "jax.npz")
    jparams = jp.SimParams(particle_num=128, g=1e-5)
    jsim = JaxTreeSim(jparams, jp.TreeParams(**TREE_KW))
    jr = JaxOfflineHeadless(jsim, jax_uniform_init, key=0)
    jr.run(steps=1, checkpoint_path=ck, checkpoint_every=1)
    jck = jax_checkpoint.load_checkpoint(ck)
    ckpt = load_checkpoint(ck, device="cpu")
    assert ckpt.step == 1 and ckpt.add_params == TreeParams(**TREE_KW)
    assert dataclasses.asdict(ckpt.params) == dataclasses.asdict(jparams)
    sim = ckpt.make_sim()
    assert isinstance(sim, TreeSim)
    jstate = jck.make_sim().make_step(donate=False)(jck.state)
    state = sim.make_step()(ckpt.state)
    got = state_to_numpy(state)
    np.testing.assert_allclose(got["pos"], np.asarray(jstate.pos), **POS_TOL)
    np.testing.assert_allclose(got["vel"], np.asarray(jstate.vel), **VEL_TOL)
    np.testing.assert_array_equal(got["mass"], np.asarray(jstate.mass))


def test_port_tree_checkpoint_loads_in_jax(tmp_path):
    ck = str(tmp_path / "port.npz")
    params = SimParams(particle_num=128, g=1e-5)
    r = OfflineHeadless(TreeSim(params, TreeParams(**TREE_KW)), uniform_init, seed=3, device="cpu")
    r.run(steps=1, checkpoint_path=ck, checkpoint_every=1)
    jck = jax_checkpoint.load_checkpoint(ck)
    assert jck.step == 1 and jck.schedule is None
    assert jck.add_params == jp.TreeParams(**TREE_KW)
    jsim = jck.make_sim()
    assert isinstance(jsim, JaxTreeSim)
    for k, v in state_to_numpy(r.state).items():
        np.testing.assert_array_equal(np.asarray(getattr(jck.state, k)), v)
    jstate = jsim.make_step(donate=False)(jck.state)
    r.step()
    np.testing.assert_allclose(r.state.pos.numpy(), np.asarray(jstate.pos), **POS_TOL)
    np.testing.assert_allclose(r.state.vel.numpy(), np.asarray(jstate.vel), **VEL_TOL)


def test_jax_default_tree_checkpoint_resumes_in_port(tmp_path):
    # a checkpoint of the JAX default TreeSim (group walk, octet engine)
    # steps in the port with the group walk's skip-engine semantics, as the
    # JAX skip engine steps it
    ck = str(tmp_path / "group.npz")
    jparams = jp.SimParams(particle_num=128, g=1e-5)
    state = jp.ParticleState(**{k: jnp.asarray(v) for k, v in state_to_numpy(
        uniform_init(torch.Generator().manual_seed(0), SimParams(particle_num=128),
                     torch.device("cpu"))).items()})
    jax_checkpoint.save_checkpoint(ck, state, jparams, 4, sim=JaxTreeSim(jparams))
    ckpt = load_checkpoint(ck, device="cpu")
    assert ckpt.step == 4 and ckpt.add_params == TreeParams() and ckpt.add_params.walk == "group"
    sim = ckpt.make_sim()
    assert isinstance(sim, TreeSim) and sim.add_params.walk_engine == "octet"
    got = state_to_numpy(sim.make_step()(ckpt.state))
    jtp = dataclasses.replace(jax_checkpoint.load_checkpoint(ck).add_params, walk_engine="skip")
    jstate = JaxTreeSim(jparams, jtp).make_step(donate=False)(state)
    np.testing.assert_allclose(got["pos"], np.asarray(jstate.pos), **POS_TOL)
    np.testing.assert_allclose(got["vel"], np.asarray(jstate.vel), **VEL_TOL)
    np.testing.assert_array_equal(got["mass"], np.asarray(jstate.mass))
    # and a port save of the same params round-trips through both loaders
    save_checkpoint(ck, ckpt.state, ckpt.params, 4, sim=sim)
    assert jax_checkpoint.load_checkpoint(ck).add_params == jp.TreeParams()


def test_profile_step_attributes_kernels_to_ranges():
    from wgpu_n_body_tpu_torch.utils.profile_step import kernel_breakdown, main

    trace = [
        {"cat": "gpu_user_annotation", "name": "tree_build", "ts": 0, "dur": 100},
        {"cat": "gpu_user_annotation", "name": "theta_walk", "ts": 100, "dur": 50},
        {"cat": "kernel", "name": "scan", "ts": 10, "dur": 30},
        {"cat": "kernel", "name": "gather", "ts": 30, "dur": 20},  # overlaps scan
        {"cat": "kernel", "name": "tree_walk_kernel", "ts": 110, "dur": 40},
        {"cat": "kernel", "name": "kick", "ts": 200, "dur": 5},
        {"cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 500},
    ]
    by_range, by_kernel, busy, span = kernel_breakdown(trace)
    assert by_range == {"tree_build": 50, "theta_walk": 40, "(no range)": 5}
    assert by_kernel[("theta_walk", "tree_walk_kernel")] == 40
    assert busy == 40 + 40 + 5 and span == 195
    assert main([]) == 1  # no CUDA device here: refuses instead of timing the CPU


def test_profile_step_counts_a_kernel_to_its_innermost_range():
    # the group walk's own ranges nest inside TreeSim's theta_walk
    from wgpu_n_body_tpu_torch.utils.profile_step import kernel_breakdown

    trace = [
        {"cat": "gpu_user_annotation", "name": "theta_walk", "ts": 0, "dur": 100},
        {"cat": "gpu_user_annotation", "name": "group_tiles", "ts": 0, "dur": 10},
        {"cat": "gpu_user_annotation", "name": "group_kernel", "ts": 10, "dur": 60},
        {"cat": "gpu_user_annotation", "name": "group_walk", "ts": 10, "dur": 12},
        {"cat": "gpu_user_annotation", "name": "group_eval", "ts": 22, "dur": 48},
        {"cat": "gpu_user_annotation", "name": "group_fallback", "ts": 70, "dur": 30},
        {"cat": "kernel", "name": "searchsorted", "ts": 2, "dur": 5},
        {"cat": "kernel", "name": "group_lists_kernel", "ts": 12, "dur": 9},
        {"cat": "kernel", "name": "mul", "ts": 22, "dur": 1},
        {"cat": "kernel", "name": "group_eval_kernel", "ts": 24, "dur": 45},
        {"cat": "kernel", "name": "tree_walk_kernel", "ts": 72, "dur": 20},
        {"cat": "kernel", "name": "where", "ts": 95, "dur": 3},
        {"cat": "gpu_user_annotation", "name": "leapfrog.kick", "ts": 118, "dur": 8},
        {"cat": "kernel", "name": "kick", "ts": 120, "dur": 4},
    ]
    by_range, by_kernel, busy, span = kernel_breakdown(trace)
    assert by_range == {"group_tiles": 5, "group_walk": 9, "group_eval": 46,
                        "group_fallback": 23, "leapfrog.kick": 4}
    assert by_kernel[("group_walk", "group_lists_kernel")] == 9
    assert by_kernel[("group_eval", "group_eval_kernel")] == 45
    assert busy == 87 and span == 122


@pytest.mark.parametrize("dropped", [0, 1, 3])
def test_launches_of_averages_each_launch_over_the_events_it_kept(dropped):
    from wgpu_n_body_tpu_torch.utils.profile_step import launches_of

    # 10 calls, each a memset (1 us), one scan kernel (30 us) and two launches
    # of an emit kernel (20 us each); the profiler lost `dropped` emit events
    reps, ev = 10, []
    for _ in range(reps):
        ev.append({"cat": "gpu_memset", "name": "Memset (Device)", "dur": 1.0})
        ev.append({"cat": "kernel", "name": "void (anonymous namespace)::scan_kernel(int*)",
                   "dur": 30.0})
        ev += [{"cat": "kernel", "name": "emit_kernel<4>(float const*)", "dur": 20.0}] * 2
        ev.append({"cat": "cpu_op", "name": "aten::empty", "dur": 5.0})
    emits = [k for k, e in enumerate(ev) if "emit" in e["name"]]
    lost = set(emits[:dropped])  # the window's first emit events
    got = launches_of([e for k, e in enumerate(ev) if k not in lost], reps)
    want = {"Memset": (0.001, 1), "scan_kernel": (0.030, 1), "emit_kernel": (0.040, 2)}
    assert got.keys() == want.keys()
    for name, (ms, per_call) in want.items():
        assert got[name][1] == per_call
        assert got[name][0] == pytest.approx(ms, rel=1e-12)

