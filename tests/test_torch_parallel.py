"""PyTorch port, multi-GPU schedules (``parallel/``) on four gloo CPU
processes, held against the JAX package's sharded sims on the conftest's
virtual CPU mesh, its single-device sims and float64 all-pairs.

One spawn of four ranks runs every scenario (a spawn costs seconds); rank
0 writes each scenario's whole state to a file, and the tests read them.
The CLI tests spawn their own ranks through ``--devices 4 --device cpu``.
The NCCL path with more than one rank needs several GPUs and is not run
here; ``chip_smoke.py`` runs the one-rank NCCL group on the card.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from wgpu_n_body_tpu import params as jp
from wgpu_n_body_tpu.models.tree import TreeSim as JaxTreeSim
from wgpu_n_body_tpu.parallel import ShardedNaiveSim as JaxShardedNaiveSim
from wgpu_n_body_tpu.parallel import ShardedTreeSim as JaxShardedTreeSim
from wgpu_n_body_tpu.parallel import make_mesh as jax_make_mesh
from wgpu_n_body_tpu.parallel import shard_state as jax_shard_state
from wgpu_n_body_tpu_torch import cli
from wgpu_n_body_tpu_torch.inits import disc_init
from wgpu_n_body_tpu_torch.models import NaiveSim
from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_ref
from wgpu_n_body_tpu_torch.ops.tree_build import morton_order
from wgpu_n_body_tpu_torch.params import (
    NaiveParams,
    SimParams,
    TreeParams,
    state_from_numpy,
    state_to_numpy,
)
from wgpu_n_body_tpu_torch.parallel import (
    ShardedNaiveSim,
    ShardedTreeSim,
    gather_state,
    init_distributed,
    make_mesh,
    shard_state,
)
from wgpu_n_body_tpu_torch.parallel.mesh import Mesh, free_port
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

P = 4
# tests/test_parallel.py:23-34 (sharded naive against one device, 3 steps)
POS_TOL = dict(rtol=1e-5, atol=1e-7)
VEL_TOL = dict(rtol=1e-4, atol=1e-7)
ACC_TOL = dict(rtol=1e-4, atol=1e-8)
# tests/test_let.py:63: theta = 0 against the all-pairs sum
THETA0_TOL = dict(rtol=2e-4, atol=1e-8)
# the per-particle walk of one forest in both packages (tests/test_torch_tree.py)
WALK_TOL = dict(rtol=1e-4, atol=1e-9)


def _uniform(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "pos": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "vel": (rng.uniform(-1, 1, (n, 3)) * 0.001).astype(np.float32),
        "acc": np.zeros((n, 3), np.float32),
        "mass": np.ones(n, np.float32),
    }


def _disc(n):
    st = disc_init(torch.Generator().manual_seed(1), SimParams(particle_num=n, g=1e-4), "cpu")
    return state_to_numpy(st)


def _elongated(n, seed=3):
    """tests/test_let.py:283's quasi-1-D scene (x in [-8, 8], thin yz, ballistic
    x velocities) in Morton order: far ranks start apart, drift mixes them."""
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(-1, 1, (n, 3)) * np.array([8.0, 0.05, 0.05])).astype(np.float32)
    vel = np.zeros((n, 3), np.float32)
    vel[:, 0] = rng.uniform(-1, 1, n)
    perm = morton_order(torch.from_numpy(pos), 8)[0].numpy()
    return {"pos": pos[perm], "vel": vel[perm], "acc": np.zeros((n, 3), np.float32),
            "mass": np.ones(n, np.float32)}


def _fixed(s):
    """An init_fn handing every rank the numpy state ``s``."""
    return lambda gen, params, device: state_from_numpy(**s, device=device)


# ------------------------------------------------------------- the ranks

NAIVE_PARAMS = SimParams(particle_num=256, g=1e-4)
TP_PP = TreeParams(theta=0.5, max_depth=10, walk="per_particle", walk_engine="skip")
TP_GROUP = TreeParams(theta=0.4, max_depth=10, walk_tile=32, walk_list_cap=2048,
                      walk_engine="skip")
TP_THETA0 = TreeParams(theta=0.0, max_depth=8, leaf_bucket=4, walk_tile=16, walk_list_cap=2048)
TP_DISC = TreeParams(theta=0.75, max_depth=10, walk_tile=64, walk_list_cap=4096)
TP_LET_PP = TreeParams(theta=0.6, max_depth=8, walk="per_particle", walk_engine="skip")


def _save(out, name, runner_or_state, mesh):
    state = runner_or_state
    if isinstance(state, OfflineHeadless):
        state = state.whole_state()
    else:
        state = gather_state(state, mesh)
    if mesh.rank == 0:
        np.savez(os.path.join(out, f"{name}.npz"), **state_to_numpy(state))


def _note(out, mesh, name, value):
    if mesh.rank == 0:
        with open(os.path.join(out, f"{name}.json"), "w") as f:
            json.dump(value, f)


def _run(sim, s, steps, **kw):
    runner = OfflineHeadless(sim, _fixed(s), device="cpu")
    runner.run(steps=steps, log_fn=kw.pop("log_fn", lambda line: None), **kw)
    return runner


def _scenarios(mesh, out):
    # sharded naive, both schedules (tests/test_parallel.py:23)
    s = _uniform(0, 256)
    for schedule in ("allgather", "ring"):
        sim = ShardedNaiveSim(NAIVE_PARAMS, mesh, NaiveParams(), schedule=schedule)
        _save(out, f"naive_{schedule}", _run(sim, s, 3), mesh)
    # replicated: the per-particle walk and the group walk, 3 steps each
    s = _uniform(5, 256)
    _save(out, "rep_pp", _run(ShardedTreeSim(NAIVE_PARAMS, mesh, TP_PP), s, 3), mesh)
    s = _uniform(6, 256)
    _save(out, "rep_group", _run(ShardedTreeSim(NAIVE_PARAMS, mesh, TP_GROUP), s, 3), mesh)
    # LET at theta = 0 (tests/test_let.py:48)
    s = _uniform(0, 256)
    sim = ShardedTreeSim(NAIVE_PARAMS, mesh, TP_THETA0, schedule="let", let_cap=1024)
    _save(out, "let_theta0", _run(sim, s, 1), mesh)
    # replicated and LET on a disc at theta = 0.75 (tests/test_let.py:68)
    s = _disc(4096)
    params = SimParams(particle_num=4096, g=1e-4)
    _save(out, "disc_rep", _run(ShardedTreeSim(params, mesh, TP_DISC), s, 1), mesh)
    runner = _run(ShardedTreeSim(params, mesh, TP_DISC, schedule="let", let_cap=4096), s, 1)
    _save(out, "disc_let", runner, mesh)
    _note(out, mesh, "disc_let_health", runner.last_health)
    # LET with the per-particle walk, one step (both packages walk one forest)
    s = _uniform(9, 1024)
    params = SimParams(particle_num=1024, g=1e-4, dt=0.01)
    sim = ShardedTreeSim(params, mesh, TP_LET_PP, schedule="let", let_cap=2048)
    _save(out, "let_pp", _run(sim, s, 1), mesh)

    # reshard: an exact permutation; the runner's cadence drives it
    # (tests/test_let.py:345)
    s = _elongated(2048)
    params = SimParams(particle_num=2048, g=1e-5, dt=0.02)
    tp = TreeParams(theta=0.75, max_depth=8, walk="per_particle")
    sim = ShardedTreeSim(params, mesh, tp, schedule="let", let_cap=4096)
    st = shard_state(state_from_numpy(**s, device="cpu"), mesh)
    _save(out, "reshard_before", st, mesh)
    _save(out, "reshard_after", sim.reshard(st), mesh)
    runner = _run(sim, s, 6, reshard_every=2)
    _save(out, "reshard_run", runner, mesh)
    _note(out, mesh, "reshard_diag", sim.diagnose(runner.state))

    # a checkpoint resumed onto the four ranks equals an unbroken run
    # (tests/test_let.py:391)
    s = _uniform(9, 1024)
    params = SimParams(particle_num=1024, g=1e-4, dt=0.01)
    sim = ShardedTreeSim(params, mesh, TP_LET_PP, schedule="let", let_cap=2048)
    r1 = _run(sim, s, 2)
    ck = os.path.join(out, "let.npz")
    whole = r1.whole_state()
    if mesh.rank == 0:
        save_checkpoint(ck, whole, params, r1.step_num, sim=sim)
    dist.barrier()
    r1.run(steps=2, log_fn=lambda line: None)
    ckpt = load_checkpoint(ck, mesh=mesh)
    r2 = OfflineHeadless(ckpt.make_sim(mesh=mesh), _fixed(s), device="cpu")
    r2.state, r2.step_num = ckpt.state, ckpt.step
    r2.run(steps=2, log_fn=lambda line: None)
    _save(out, "resume_unbroken", r1, mesh)
    _save(out, "resume_resumed", r2, mesh)
    _note(out, mesh, "resume_meta", {"step": ckpt.step, "schedule": ckpt.schedule,
                                     "sim": type(ckpt.make_sim(mesh=mesh)).__name__})

    # an undersized let_cap raises, in check_overflow and in the runner
    # (tests/test_let.py:216); a healthy one diagnoses clean
    s = _uniform(6, 2048)
    params = SimParams(particle_num=2048, g=1e-4)
    tp = TreeParams(theta=0.75, max_depth=8, walk_tile=64, walk_list_cap=2048)
    errors = []
    bad = ShardedTreeSim(params, mesh, tp, schedule="let", let_cap=8)
    for call in (lambda: bad.check_overflow(shard_state(state_from_numpy(**s, device="cpu"),
                                                        mesh)),
                 lambda: _run(bad, s, 2)):
        try:
            call()
            errors.append(None)
        except RuntimeError as exc:
            errors.append(str(exc))
    ok = ShardedTreeSim(params, mesh, tp, schedule="let", let_cap=4096)
    runner = _run(ok, s, 2)
    _note(out, mesh, "overflow", {"errors": errors, "diag": ok.diagnose(runner.state)})

    # the reduced import budget escalates on deferral (tests/test_let.py:455),
    # and a reshard returns it to the configured one
    s = _uniform(3, 1024)
    params = SimParams(particle_num=1024, g=1e-4)
    tp = TreeParams(theta=0.2, max_depth=8, walk_tile=64, walk_list_cap=4096,
                    let_import_list_cap=256)
    sim = ShardedTreeSim(params, mesh, tp, schedule="let", let_cap=8192)
    logs = []
    runner = _run(sim, s, 2, log_fn=logs.append)
    escalated = sim.add_params.effective_import_list_cap()
    after = sim.diagnose(runner.state)["walk_deferred"]
    runner.state = sim.reshard(runner.state)
    _note(out, mesh, "escalation", {
        "logs": logs, "escalated": escalated, "deferred_after": after,
        "after_reshard": sim.add_params.effective_import_list_cap(),
        "health": runner.last_health})


def _rank(rank, out, port):
    torch.set_num_threads(1)
    init_distributed("gloo", rank, P, f"tcp://localhost:{port}")
    try:
        _scenarios(make_mesh(), out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The directory the four ranks wrote their scenarios to."""
    out = str(tmp_path_factory.mktemp("ranks"))
    mp.spawn(_rank, args=(out, free_port()), nprocs=P, join=True)

    def load(name):
        path = os.path.join(out, name)
        if name.endswith(".json"):
            with open(path) as f:
                return json.load(f)
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    return load


# -------------------------------------------------------------- the tests


def _match(a_pos, a_val, b_pos, b_val, **pos_tol):
    """tests/test_let.py:31: rows of two orders of the same bodies matched by
    position. Within one package the drift is the same arithmetic, so the
    positions are bit-equal; across packages XLA may contract the drift
    into fused multiply-adds, so ``pos_tol`` lets them differ by rounding."""
    ka = np.lexsort((a_pos[:, 2], a_pos[:, 1], a_pos[:, 0]))
    kb = np.lexsort((b_pos[:, 2], b_pos[:, 1], b_pos[:, 0]))
    if pos_tol:
        np.testing.assert_allclose(a_pos[ka], b_pos[kb], **pos_tol)
    else:
        np.testing.assert_array_equal(a_pos[ka], b_pos[kb])
    return a_val[ka], b_val[kb]


def _jax(s):
    return jp.ParticleState(**{k: jnp.asarray(v) for k, v in s.items()})


@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_sharded_naive_matches_jax_sharded(ranks, schedule):
    mesh = jax_make_mesh(P)
    jparams = jp.SimParams(particle_num=256, g=1e-4)
    step = JaxShardedNaiveSim(jparams, mesh, jp.NaiveParams(use_pallas=False),
                              schedule=schedule).make_step(donate=False)
    st = jax_shard_state(_jax(_uniform(0, 256)), mesh)
    for _ in range(3):
        st = step(st)
    got = ranks(f"naive_{schedule}.npz")
    np.testing.assert_allclose(got["pos"], np.asarray(st.pos), **POS_TOL)
    np.testing.assert_allclose(got["vel"], np.asarray(st.vel), **VEL_TOL)
    np.testing.assert_allclose(got["acc"], np.asarray(st.acc), **ACC_TOL)


def test_replicated_per_particle_matches_jax_single_device(ranks):
    """tests/test_parallel.py:54: the per-particle walk under the replicated
    schedule is the single-device walk, row for row."""
    jtp = jp.TreeParams(theta=0.5, max_depth=10, walk="per_particle", walk_engine="skip")
    step = JaxTreeSim(jp.SimParams(particle_num=256, g=1e-4), jtp).make_step(donate=False)
    st = _jax(_uniform(5, 256))
    for _ in range(3):
        st = step(st)
    got = ranks("rep_pp.npz")
    np.testing.assert_allclose(got["pos"], np.asarray(st.pos), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["acc"], np.asarray(st.acc), rtol=1e-5, atol=1e-8)


def _jax_rep_group(sharded):
    """Three steps of the JAX group walk (skip engine, TP_GROUP) from
    ``_uniform(6, 256)``: its single-device TreeSim, or ShardedTreeSim's
    replicated schedule on the four-device mesh."""
    jparams = jp.SimParams(particle_num=256, g=1e-4)
    jtp = jp.TreeParams(theta=0.4, max_depth=10, walk_tile=32, walk_list_cap=2048,
                        walk_engine="skip")
    st = _jax(_uniform(6, 256))
    if sharded:
        mesh = jax_make_mesh(P)
        sim = JaxShardedTreeSim(jparams, mesh, jtp, schedule="replicated")
        st = jax_shard_state(st, mesh)
    else:
        sim = JaxTreeSim(jparams, jtp)
    step = sim.make_step(donate=False)
    for _ in range(3):
        st = step(st)
    return {k: np.asarray(getattr(st, k)) for k in ("pos", "vel", "acc")}


def _assert_state_close(got, want):
    np.testing.assert_allclose(got["pos"], want["pos"], **POS_TOL)
    np.testing.assert_allclose(got["vel"], want["vel"], **VEL_TOL)
    np.testing.assert_allclose(got["acc"], want["acc"], **ACC_TOL)


def test_replicated_group_walk_close_to_jax_single_device(ranks):
    """tests/test_parallel.py:97: each rank tiles its own slice, so the
    forces are close to the single-device walk's, not equal (the JAX
    package's own sharded walk differs from its single-device one alike;
    the next test holds the forces against it)."""
    got, want = ranks("rep_group.npz"), _jax_rep_group(sharded=False)
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=1e-4, atol=1e-6)


def test_replicated_group_walk_matches_jax_sharded(ranks):
    """The same three steps against the JAX ShardedTreeSim's replicated
    schedule on its four-device mesh (``gid_offset`` = the slice start)."""
    _assert_state_close(ranks("rep_group.npz"), _jax_rep_group(sharded=True))


def test_let_theta_zero_is_exact(ranks):
    st = NaiveSim(NAIVE_PARAMS, NaiveParams(use_pallas=False)).make_step()(
        state_from_numpy(**_uniform(0, 256), device="cpu"))
    got = ranks("let_theta0.npz")
    want, have = _match(st.pos.numpy(), st.acc.numpy(), got["pos"], got["acc"])
    np.testing.assert_allclose(have, want, **THETA0_TOL)


def _disc_exact():
    """The drifted positions of ``_disc(4096)``'s first step and their
    float64 all-pairs forces."""
    s = _disc(4096)
    params = SimParams(particle_num=4096, g=1e-4)
    half = params.dt / 2.0
    pos_new = s["pos"] + (s["vel"] + s["acc"] * half) * params.dt
    exact = naive_forces_ref(torch.from_numpy(pos_new).double(),
                             torch.from_numpy(s["pos"]).double(),
                             torch.from_numpy(s["mass"]).double(), params).numpy()
    return pos_new, exact


def test_let_matches_replicated_within_theta_error(ranks):
    pos_new, exact = _disc_exact()
    rep, let = ranks("disc_rep.npz"), ranks("disc_let.npz")
    x1, acc_r = _match(pos_new, exact, rep["pos"], rep["acc"])
    x2, acc_l = _match(pos_new, exact, let["pos"], let["acc"])
    scale = np.linalg.norm(x1, axis=1).mean()
    err_rep = np.abs(acc_r - x1).mean() / scale
    err_let = np.abs(acc_l - x2).mean() / scale
    assert err_rep < 0.03 and err_let < 0.03
    assert err_let < 3 * err_rep + 1e-4
    health = ranks("disc_let_health.json")
    assert health["let_overflowed"] is False and 0 < health["let_export_rows_max"] <= 4096


def _jax_let_disc(walk_engine):
    """One step of the JAX ShardedTreeSim's LET schedule from ``_disc(4096)``
    on its four-device mesh, handed the state in the global Morton order
    the port's LET ranks start from: (pos, acc)."""
    mesh = jax_make_mesh(P)
    jtp = jp.TreeParams(theta=0.75, max_depth=10, walk_tile=64, walk_list_cap=4096,
                        walk_engine=walk_engine)
    s = _disc(4096)
    perm = morton_order(torch.from_numpy(s["pos"]), 10)[0].numpy()
    sim = JaxShardedTreeSim(jp.SimParams(particle_num=4096, g=1e-4), mesh, jtp,
                            schedule="let", let_cap=4096)
    st = sim.make_step(donate=False)(jax_shard_state(_jax({k: v[perm] for k, v in s.items()}),
                                                     mesh))
    return np.asarray(st.pos), np.asarray(st.acc)


@pytest.mark.parametrize("walk_engine", ["octet", "skip"])
def test_let_group_walk_matches_jax_sharded(ranks, walk_engine):
    """The port's LET step (the split walk: B4 over the local tree and over
    the import forest) against the JAX ShardedTreeSim's on its four-device
    mesh, rows matched by position. With ``walk_engine="skip"`` JAX walks
    the concatenated forest with the port's acceptance rule: the same
    interactions, so the forces agree to rounding (ACC_TOL). Its default,
    ``"octet"`` with the split walk, tests theta against a quantized centre
    of gravity and opens a few more nodes: rows agree within the 1e-2 that
    tests/test_torch_tree_group_sim.py holds the single-device octet walk
    to, and the port's error against float64 is no larger than JAX's at
    the theta level (tests/test_let.py:68)."""
    got = ranks("disc_let.npz")
    jpos, jacc = _jax_let_disc(walk_engine)
    want, have = _match(jpos, jacc, got["pos"], got["acc"], rtol=1e-6, atol=1e-7)
    if walk_engine == "skip":
        np.testing.assert_allclose(have, want, **ACC_TOL)
        return
    rel = np.linalg.norm(have - want, axis=1) / np.linalg.norm(want, axis=1)
    assert rel.max() < 1e-2
    pos_new, exact = _disc_exact()
    x, acc_l = _match(pos_new, exact, got["pos"], got["acc"])
    scale = np.linalg.norm(x, axis=1).mean()
    err_port = np.abs(acc_l - x).mean() / scale
    err_jax = np.abs(want - x).mean() / scale
    print(f"LET vs JAX octet: {(rel > 1e-4).sum()} rows beyond 1e-4, max {rel.max():.3e}; "
          f"error vs float64: port {err_port:.4e}, JAX {err_jax:.4e}")
    assert err_port < 0.03 and err_port < 3 * err_jax + 1e-4


@pytest.mark.slow
def test_let_per_particle_matches_jax_sharded(ranks):
    """One step of the per-particle LET walk against the JAX package's on its
    four-device mesh: the same exports, the same forest, one walk. The port's
    LET ranks start from slices of the global Morton order, so JAX is handed
    the state in that order."""
    mesh = jax_make_mesh(P)
    jparams = jp.SimParams(particle_num=1024, g=1e-4, dt=0.01)
    jtp = jp.TreeParams(theta=0.6, max_depth=8, walk="per_particle", walk_engine="skip")
    s = _uniform(9, 1024)
    perm = morton_order(torch.from_numpy(s["pos"]), 8)[0].numpy()
    st = JaxShardedTreeSim(jparams, mesh, jtp, schedule="let", let_cap=2048).make_step(
        donate=False)(jax_shard_state(_jax({k: v[perm] for k, v in s.items()}), mesh))
    got = ranks("let_pp.npz")
    want, have = _match(np.asarray(st.pos), np.asarray(st.acc), got["pos"], got["acc"])
    np.testing.assert_allclose(have, want, **WALK_TOL)


def test_reshard_is_exact_permutation_and_runner_cadence(ranks):
    a, b = ranks("reshard_before.npz"), ranks("reshard_after.npz")
    rows = [np.concatenate([s["pos"], s["vel"], s["mass"][:, None]], 1) for s in (a, b)]
    np.testing.assert_array_equal(*(r[np.lexsort(r.T)] for r in rows))
    # the slices are contiguous runs of the global Morton order
    perm = morton_order(torch.from_numpy(a["pos"]), 8)[0].numpy()
    np.testing.assert_array_equal(b["pos"], a["pos"][perm])
    assert np.isfinite(ranks("reshard_run.npz")["pos"]).all()
    diag = ranks("reshard_diag.json")
    assert not diag["let_overflowed"] and not diag["overflowed"]


def test_let_checkpoint_resume_bit_equivalence(ranks):
    meta = ranks("resume_meta.json")
    assert meta == {"step": 2, "schedule": {"name": "let", "let_cap": 2048,
                                            "mesh_axes": {"particles": P}},
                    "sim": "ShardedTreeSim"}
    a, b = ranks("resume_unbroken.npz"), ranks("resume_resumed.npz")
    for k in ("pos", "vel", "acc", "mass"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sharded_overflow_surfaces(ranks):
    got = ranks("overflow.json")
    assert all(e is not None and "LET export overflow" in e for e in got["errors"])
    diag = got["diag"]
    assert diag["overflowed"] is False and diag["let_overflowed"] is False
    assert diag["walk_deferred"] == 0 and 0 < diag["let_export_rows_max"] <= 4096


def test_import_budget_escalates_and_reshard_restores_it(ranks):
    got = ranks("escalation.json")
    assert any("escalating LET import list budget" in line for line in got["logs"])
    assert got["escalated"] == 4096 and got["deferred_after"] == 0
    # unlike the JAX package (ROADMAP C), a reshard returns to the configured budget
    assert got["after_reshard"] == 256


def test_jax_let_checkpoint_resumes_on_port_ranks(ranks, tmp_path):
    """A sharded checkpoint of either package names its schedule alike; the
    port's loads its slice per rank (make_sim needs the mesh)."""
    from wgpu_n_body_tpu.utils import checkpoint as jax_checkpoint

    mesh = jax_make_mesh(P)
    jparams = jp.SimParams(particle_num=64, g=1e-4)
    sim = JaxShardedTreeSim(jparams, mesh, jp.TreeParams(), schedule="let", let_cap=1024)
    ck = str(tmp_path / "jax_let.npz")
    jax_checkpoint.save_checkpoint(ck, _jax(_uniform(1, 64)), jparams, 3, sim=sim)
    ckpt = load_checkpoint(ck, device="cpu")
    assert ckpt.schedule == {"name": "let", "let_cap": 1024, "mesh_axes": {"particles": P}}
    with pytest.raises(ValueError, match="pass mesh="):
        ckpt.make_sim()


def test_shard_state_rejects_indivisible_n():
    st = state_from_numpy(**_uniform(2, 250), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        shard_state(st, Mesh(rank=0, size=P, device=torch.device("cpu")))
    part = shard_state(state_from_numpy(**_uniform(2, 256), device="cpu"),
                       Mesh(rank=2, size=P, device=torch.device("cpu")))
    np.testing.assert_array_equal(part.pos.numpy(), _uniform(2, 256)["pos"][128:192])


# ---------------------------------------------------------------------- CLI


@pytest.mark.parametrize("argv", [
    ["--sim", "naive", "--n", "512", "--schedule", "ring", "--steps", "2"],
    ["--sim", "tree", "--n", "1024", "--schedule", "let", "--steps", "4", "--reshard-every", "2",
     "--diag-every", "4", "--overflow-check-every", "2", "--chunk", "2", "--energy-every", "2"],
])
def test_cli_headless_devices_4_on_cpu(argv, capfd, tmp_path):
    ck = str(tmp_path / "ck.npz")
    assert cli.main(["headless", "--devices", str(P), "--device", "cpu", "--checkpoint", ck,
                     *argv]) == 0
    out = capfd.readouterr().out
    assert out.count("mean: ") == 1 and "us/step over" in out  # rank 0 alone prints
    if "tree" in argv:
        assert "'walk_deferred': 0" in out and out.count("total energy") == 2
    ckpt = load_checkpoint(ck, device="cpu")
    assert ckpt.schedule["mesh_axes"] == {"particles": P}
    assert ckpt.schedule["name"] == argv[argv.index("--schedule") + 1]
    assert torch.isfinite(ckpt.state.pos).all() and ckpt.state.n == int(argv[3])


def test_cli_rank_failure_exits_1(capfd):
    """A rank that raises (here the LET export overflow of a let_cap far too
    small) ends the run with exit code 1 and the rank's error on stderr."""
    assert cli.main(["headless", "--devices", str(P), "--device", "cpu", "--sim", "tree",
                     "--n", "1024", "--schedule", "let", "--let-cap", "8", "--steps", "1"]) == 1
    err = capfd.readouterr().err
    assert "a rank failed" in err and "LET export overflow" in err


@pytest.mark.parametrize("extra, says", [
    (["--sim", "naive", "--schedule", "let"], "--schedule 'let' invalid for --sim naive"),
    (["--sim", "tree", "--schedule", "let", "--fused-let-walk"], "--fused-let-walk"),
    (["--sim", "tree-host"], "--devices requires --sim naive|tree"),
    (["--sim", "naive", "--n", "66"], "not divisible"),
    (["--sim", "tree", "--let-cap", "100"], "--let-cap"),
    (["--sim", "naive", "--device", "cuda"], "CUDA devices are visible"),
])
def test_cli_sharded_usage_errors_exit_2(extra, says, capsys):
    if "--device" not in extra:
        extra = [*extra, "--device", "cpu"]
    with pytest.raises(SystemExit) as exc:
        cli.main(["headless", "--devices", str(P), "--n", "64", *extra])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert says in err and "Traceback" not in err


def test_let_ranks_start_from_morton_slices():
    """Under ``let`` rank r starts with slice r of the global Morton order (a
    reshard's ownership), under ``replicated`` with slice r of the draw."""
    s = _uniform(4, 256)
    perm = morton_order(torch.from_numpy(s["pos"]), 10)[0].numpy()
    for schedule, order in (("let", perm), ("replicated", np.arange(256))):
        for r in range(P):
            mesh = Mesh(rank=r, size=P, device=torch.device("cpu"))
            sim = ShardedTreeSim(NAIVE_PARAMS, mesh, TreeParams(max_depth=10), schedule=schedule)
            st = sim.init_state(torch.Generator(), _fixed(s))
            np.testing.assert_array_equal(st.pos.numpy(), s["pos"][order][r * 64:(r + 1) * 64])
