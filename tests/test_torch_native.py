"""PyTorch port, host-tree slice: the native C++ octree build, the plain
walk on its arena and ``TreeSimHost``, each fed the same numpy inputs as the
JAX package and held against it, on the CPU.

The two packages compile the same ``octree.cpp`` with the same flags, so
the host trees must be equal bit for bit. Forces and states carry the
tolerances of ``tests/test_native.py`` and ``tests/test_torch_tree.py``,
each named below. On the CPU the walk's wrapper takes its plain torch
version; the kernel is held on the card by ``chip_smoke.py`` (phases 10
and 14).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_n_body_tpu import params as jp
from wgpu_n_body_tpu.models.tree_host import TreeSimHost as JaxTreeSimHost
from wgpu_n_body_tpu.native import build as jax_native
from wgpu_n_body_tpu.ops import tree_build as jax_build
from wgpu_n_body_tpu.ops.tree_walk import tree_forces as jax_tree_forces
from wgpu_n_body_tpu_torch import cli
from wgpu_n_body_tpu_torch.models import TreeSim, TreeSimHost
from wgpu_n_body_tpu_torch.models.tree_host import host_tree_arrays
from wgpu_n_body_tpu_torch.native import build as native
from wgpu_n_body_tpu_torch.ops import tree_walk_cuda
from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_dense
from wgpu_n_body_tpu_torch.ops.tree_build import NO_CHILD, build_tree, morton_sort
from wgpu_n_body_tpu_torch.ops.tree_walk import tree_forces
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams, state_from_numpy
from wgpu_n_body_tpu_torch.utils.checkpoint import load_checkpoint

if not native.native_available():
    pytest.skip("no g++ for the native octree", allow_module_level=True)

# tests/test_native.py:106: the host tree halves 2*max(|coord|, 1) down to
# singletons at any depth, the device tree stops at max_depth: other cells,
# the same force to this tolerance
ARENA_TOL = dict(rtol=5e-4, atol=1e-8)
# the tree tests' force tolerance (plain walk vs JAX tree_forces on one
# arena: the same terms, float32 sums XLA may associate differently)
WALK_TOL = dict(rtol=2e-5, atol=1e-9)
# tests/test_native.py:128-130, three steps
POS_TOL = dict(rtol=1e-4, atol=1e-6)

HOST_FIELDS = ("octants", "order", "nodes_f32", "skip", "first", "count")


def _pos_mass(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.uniform(0.5, 2.0, n).astype(np.float32))


def _np_state(n, seed):
    pos, mass = _pos_mass(n, seed)
    rng = np.random.default_rng(seed + 100)
    return {"pos": pos, "vel": rng.uniform(-0.01, 0.01, (n, 3)).astype(np.float32),
            "acc": np.zeros((n, 3), np.float32), "mass": mass}


def _jax_arena(h, rows=None):
    """The host arena as JAX TreeArrays: its m + 1 rows, or padded to
    ``rows`` as ``wgpu_n_body_tpu/models/tree_host.py`` pads it."""
    m = h.nodes_f32.shape[0] - 1
    nodes, skip, first, count = h.nodes_f32, h.skip, h.first, h.count
    if rows is not None:
        cap, n = rows - 1, h.order.shape[0]
        nodes = np.zeros((cap + 1, 8), np.float32)
        nodes[:m], nodes[cap] = h.nodes_f32[:m], h.nodes_f32[m]
        skip = np.full((cap + 1,), cap, np.int32)
        first = np.full((cap + 1,), n, np.int32)
        count = np.zeros((cap + 1,), np.int32)
        skip[:m], first[:m], count[:m] = h.skip[:m], h.first[:m], h.count[:m]
    return jax_build.TreeArrays(
        nodes_f32=jnp.asarray(nodes), skip=jnp.asarray(skip), first=jnp.asarray(first),
        count=jnp.asarray(count), num_nodes=jnp.asarray(m, jnp.int32),
        root_width=jnp.asarray(h.root_width, jnp.float32), overflowed=jnp.asarray(False))


@pytest.mark.parametrize("n", [500, 37])
def test_host_tree_equals_jax_package(n):
    pos, mass = _pos_mass(n, seed=n)
    ours, theirs = native.build_host_tree(pos, mass), jax_native.build_host_tree(pos, mass)
    for name in HOST_FIELDS:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32) if a.dtype == np.float32 else a,
                                      b.view(np.uint32) if b.dtype == np.float32 else b,
                                      err_msg=name)
    assert ours.root_width == theirs.root_width and ours.num_nodes == theirs.num_nodes


def test_host_tree_invariants():
    n = 500
    pos, mass = _pos_mass(n)
    t = native.build_host_tree(pos, mass)
    bodies = t.bodies()
    assert bodies[0] == n
    np.testing.assert_allclose(t.mass()[0], mass.sum(), rtol=1e-5)
    assert t.root_width == 2.0  # all |coord| <= 1 -> bound identity 1.0
    leaves = bodies == 1  # singleton leaves hold exact particle positions
    assert leaves.sum() == n
    np.testing.assert_array_equal(t.cog()[leaves], pos[t.children()[leaves][:, 0]])
    assert sorted(t.order.tolist()) == list(range(n))
    m = t.nodes_f32.shape[0] - 1  # DFS arena: skips advance, the root covers everything
    assert t.num_nodes == m and t.skip[0] == m
    assert (t.skip[:m] > np.arange(m)).all() and (t.skip[:m] <= m).all()
    np.testing.assert_allclose(t.nodes_f32[0, 3], mass.sum(), rtol=1e-5)
    assert t.first[0] == 0 and t.count[0] == n
    arena_leaves = t.nodes_f32[:m, NO_CHILD] > 0
    assert sorted(t.first[:m][arena_leaves].tolist()) == list(range(n))


def test_host_dfs_order_matches_port_morton_sort():
    # the reference's DFS sort order == Morton order (same child bit layout)
    n = 300
    pos, mass = _pos_mass(n, seed=1)
    zeros = np.zeros((n, 3), np.float32)
    t = native.build_host_tree(pos, mass)
    ss, _, _ = morton_sort(state_from_numpy(pos, zeros, zeros, mass, "cpu"), 20)
    np.testing.assert_array_equal(ss.pos.numpy(), pos[t.order])
    np.testing.assert_array_equal(ss.mass.numpy(), mass[t.order])


def test_coincident_cluster_rejected():
    with pytest.raises(RuntimeError, match="coincident|overflow"):
        native.build_host_tree(np.zeros((3, 3), np.float32), np.ones((3,), np.float32))


def test_library_is_built_into_the_package_build_dir():
    lib, _ = native.build()
    assert lib == native.library_path() and lib.exists()
    assert lib.parent == native.BUILD_DIR and lib.parent.name == "_build"
    assert lib.parent.parent.name == "wgpu_n_body_tpu_torch"
    assert native.build() == (lib, "cached")
    assert "-fopenmp" in native.CXX_FLAGS and "-O3" in native.CXX_FLAGS


def test_failed_compile_raises_with_the_compilers_output(monkeypatch, tmp_path):
    bad = tmp_path / "octree.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_lib", None)
    assert native.native_available()  # a compiler is present: an error, not a skip
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        native.build_host_tree(*_pos_mass(8))
    assert not list((tmp_path / "out").iterdir())  # nothing half-built is left behind


def test_no_compiler_is_reported_and_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    assert not native.native_available()
    with pytest.raises(RuntimeError, match=r"g\+\+"):
        native.build_host_tree(*_pos_mass(8))
    with pytest.raises(RuntimeError, match="requires the native octree library"):
        TreeSimHost(SimParams(particle_num=8))


def test_device_build_bucket_1_matches_host_arena():
    # the port's plain build with singleton leaves against the host tree,
    # through the plain walk's forces on the same sorted input
    n = 400
    params = SimParams(particle_num=n, g=1e-3)
    tp = TreeParams(theta=0.5, max_depth=16, leaf_bucket=1, walk="per_particle")
    pos, mass = _pos_mass(n, seed=2)
    zeros = np.zeros((n, 3), np.float32)
    ss, bound, keys = morton_sort(state_from_numpy(pos, zeros, zeros, mass, "cpu"), tp.max_depth)
    dev = tree_forces(ss.pos, ss.pos, ss.mass, build_tree(ss, keys, bound, tp), params, tp)
    h = native.build_host_tree(pos, mass)
    np.testing.assert_array_equal(ss.pos.numpy(), pos[h.order])
    host = tree_forces(ss.pos, ss.pos, ss.mass, host_tree_arrays(h, torch.device("cpu")),
                       params, tp)
    torch.testing.assert_close(host, dev, **ARENA_TOL)
    exact = naive_forces_dense(ss.pos, ss.pos, ss.mass, params)
    assert float((dev - exact).abs().mean() / exact.norm(dim=1).mean()) < 0.01


@pytest.mark.parametrize("padded", [False, True])
def test_plain_walk_on_host_arena_matches_jax(padded):
    # an arena of exactly m + 1 rows (what the port uploads) and JAX's padded
    # one give the JAX walk, and the port's plain walk, the same forces
    n = 400
    jparams, params = jp.SimParams(particle_num=n, g=1e-3), SimParams(particle_num=n, g=1e-3)
    kw = dict(theta=0.5, max_depth=16, leaf_bucket=1, walk="per_particle")
    jtp, tp = jp.TreeParams(**kw), TreeParams(**kw)
    pos, mass = _pos_mass(n, seed=4)
    h = native.build_host_tree(pos, mass)
    m = h.nodes_f32.shape[0] - 1
    spos, smass = pos[h.order], mass[h.order]
    tree = host_tree_arrays(h, torch.device("cpu"))
    assert tree.nodes_f32.shape == (m + 1, 8) and tree.skip.shape == (m + 1,)
    assert int(tree.num_nodes) == m and not bool(tree.overflowed)
    assert int(tree.skip[:m].max()) == m
    ours = tree_forces(torch.from_numpy(spos), torch.from_numpy(spos), torch.from_numpy(smass),
                       tree, params, tp)
    jtree = _jax_arena(h, rows=jtp.capacity(n) + 1 if padded else None)
    theirs = np.asarray(jax_tree_forces(jnp.asarray(spos), jnp.asarray(spos), jnp.asarray(smass),
                                        jtree, jparams, jtp))
    torch.testing.assert_close(ours, torch.from_numpy(theirs.copy()), **WALK_TOL)


def _run(step, state, steps=3):
    for _ in range(steps):
        state = step(state)
    return state


def test_tree_sim_host_matches_jax_tree_sim_host():
    n = 256
    kw = dict(theta=0.5, max_depth=16, walk="per_particle", leaf_bucket=1)
    s = _np_state(n, seed=3)
    jstate = jp.ParticleState(**{k: jnp.asarray(v) for k, v in s.items()})
    theirs = _run(JaxTreeSimHost(jp.SimParams(particle_num=n, g=1e-4), jp.TreeParams(**kw))
                  .make_step(donate=False), jstate)
    before = tree_walk_cuda.LAUNCHES
    ours = _run(TreeSimHost(SimParams(particle_num=n, g=1e-4), TreeParams(**kw)).make_step(),
                state_from_numpy(**s, device="cpu"))
    assert tree_walk_cuda.LAUNCHES == before  # CPU tensors never count
    np.testing.assert_allclose(ours.pos.numpy(), np.asarray(theirs.pos), **POS_TOL)
    np.testing.assert_array_equal(ours.mass.numpy(), np.asarray(theirs.mass))  # the same order


def test_tree_sim_host_matches_port_tree_sim():
    n = 256
    params = SimParams(particle_num=n, g=1e-4)
    tp = TreeParams(theta=0.5, max_depth=16, walk="per_particle", leaf_bucket=1)
    s = _np_state(n, seed=5)
    a = _run(TreeSim(params, tp).make_step(), state_from_numpy(**s, device="cpu"))
    b = _run(TreeSimHost(params, tp).make_step(), state_from_numpy(**s, device="cpu"))
    torch.testing.assert_close(a.pos, b.pos, **POS_TOL)
    assert torch.isfinite(b.vel).all() and torch.isfinite(b.acc).all()


def test_tree_sim_host_constructor_and_step():
    params = SimParams(particle_num=64)
    sim = TreeSimHost(params)
    assert sim.add_params == dataclasses.replace(TreeParams(), leaf_bucket=1)
    with pytest.raises(ValueError, match="leaf_bucket=1, got 16"):
        TreeSimHost(params, TreeParams(leaf_bucket=16))
    # eager: step_fn and make_step both return the step
    state = state_from_numpy(**_np_state(64, seed=6), device="cpu")
    a, b = sim.step_fn()(state), sim.make_step()(state)
    assert torch.equal(a.pos, b.pos) and torch.equal(a.acc, b.acc)


def test_tree_sim_host_rejects_a_tree_above_its_capacity():
    n = 64
    sim = TreeSimHost(SimParams(particle_num=n),
                      TreeParams(leaf_bucket=1, node_capacity_factor=1.0))
    with pytest.raises(RuntimeError, match="overflow|exceeds cap"):
        sim.make_step()(state_from_numpy(**_np_state(n, seed=7), device="cpu"))


def test_cli_headless_tree_host_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "host.npz")
    argv = ["headless", "--sim", "tree-host", "--n", "256", "--steps", "2", "--device", "cpu",
            "--theta", "0.6", "--tree-kw", "max_depth=12", "--checkpoint", ck]
    assert cli.main(argv) == 0
    assert "us/step over 2 steps" in capsys.readouterr().out
    # saved as kind "tree" with its TreeParams, as the JAX package does: it
    # reloads as a TreeSim with singleton leaves
    ckpt = load_checkpoint(ck, device="cpu")
    assert ckpt.step == 2 and torch.isfinite(ckpt.state.pos).all()
    assert ckpt.add_params == TreeParams(theta=0.6, max_depth=12, leaf_bucket=1)
    sim = ckpt.make_sim()
    assert isinstance(sim, TreeSim) and sim.add_params.leaf_bucket == 1


@pytest.mark.parametrize(
    "extra, says",
    [
        (["--tree-kw", "leaf_bucket=4"], "leaf_bucket=1, got 4"),
        (["--tree-kw", "bucket=4"], "NAME one of"),
        (["--devices", "2"], "not yet ported"),
    ],
)
def test_cli_tree_host_usage_errors_exit_2(extra, says, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["headless", "--sim", "tree-host", "--n", "64", "--device", "cpu", *extra])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert says in err and "Traceback" not in err


def test_cli_bench_tree_host_on_cpu(capsys):
    assert cli.main(["bench", "--sim", "tree-host", "--sizes", "128", "--reps", "1",
                     "--device", "cpu", "--tree-kw", "max_depth=12"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(recs) == 1
    assert recs[0]["sim"] == "tree-host" and recs[0]["n"] == 128
    assert recs[0]["s_per_step"] > 0 and recs[0]["pairs_per_sec"] is None
