"""PyTorch port, the fused LET walk (``let_fused=True``, ``cli ...
--schedule let --fused-let-walk``) on the CPU.

The import buffers are packed slack-free (``compact_import_forest``, equal
to the JAX package's on every field) behind the local arena
(``assemble_fused_forest``, the plain version of the kernel B8), and one
group walk covers both. It is held against the port's split walk on the
same exports (the same interactions per receiver, forces to rounding),
against the JAX package's skip-engine LET step (the same one-walk shape
over a padded forest), against JAX's fused octet walk at the theta level,
and against the all-pairs sum at theta = 0. Four gloo ranks run the
overflow probe and the runner; the CLI spawns its own. B8's kernel is held
against the plain version on the card by ``chip_smoke.py`` (16b, 17c).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tests.test_torch_parallel import ACC_TOL, THETA0_TOL, _disc, _fixed, _jax, _match, _uniform
from wgpu_n_body_tpu import params as jp
from wgpu_n_body_tpu.parallel import ShardedTreeSim as JaxShardedTreeSim
from wgpu_n_body_tpu.parallel import let_tree as jax_let
from wgpu_n_body_tpu.parallel import make_mesh as jax_make_mesh
from wgpu_n_body_tpu.parallel import shard_state as jax_shard_state
from wgpu_n_body_tpu_torch import cli
from wgpu_n_body_tpu_torch.models import NaiveSim
from wgpu_n_body_tpu_torch.ops import import_forest_cuda, let_export
from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_ref
from wgpu_n_body_tpu_torch.ops.tree_build import build_tree, morton_order, morton_sort, reorder
from wgpu_n_body_tpu_torch.ops.tree_walk import tree_forces
from wgpu_n_body_tpu_torch.ops.tree_walk_group import (
    group_walk_lists,
    source_table,
    step_budget,
    tile_setup,
)
from wgpu_n_body_tpu_torch.params import (
    NaiveParams,
    ParticleState,
    SimParams,
    TreeParams,
    state_from_numpy,
)
from wgpu_n_body_tpu_torch.parallel import ShardedTreeSim, init_distributed, make_mesh
from wgpu_n_body_tpu_torch.parallel import let_tree
from wgpu_n_body_tpu_torch.parallel import sharded_tree as st
from wgpu_n_body_tpu_torch.parallel.mesh import Mesh, free_port
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.utils.group_walk_study import list_counts

P = 4
DISC_PARAMS = SimParams(particle_num=4096, g=1e-4)
TP_DISC = TreeParams(theta=0.75, max_depth=10, walk_tile=64, walk_list_cap=4096)
DISC_CAP = 4096


def _small_exports():
    """tests/test_let.py:646's export set: one rank's 1,024 uniform bodies
    and the boxes of four Morton slices of them (every row kind), rank 3 the
    exporter; the port's plain build and export (equal to the JAX package's,
    tests/test_torch_let.py)."""
    rng = np.random.default_rng(7)
    pos = rng.uniform(-1, 1, (1024, 3)).astype(np.float32)
    z = np.zeros((1024, 3), np.float32)
    tp = TreeParams(theta=0.5, max_depth=8, leaf_bucket=4)
    ss, bound, keys = morton_sort(state_from_numpy(pos, z, z, np.ones(1024, np.float32), "cpu"),
                                  tp.max_depth)
    tree = build_tree(ss, keys, bound, tp)
    qs = np.array_split(ss.pos.numpy(), P)
    blo = torch.from_numpy(np.stack([q.min(0) for q in qs]))
    bhi = torch.from_numpy(np.stack([q.max(0) for q in qs]))
    exp = let_export.export_walk(tree, ss.pos, ss.mass, blo, bhi, P - 1, tp.theta, 4096)
    return ss, tree, tp, exp


@pytest.mark.parametrize("part_base", [0, 17])
@pytest.mark.parametrize("fits", [True, False])
def test_compact_import_forest_equals_jax(part_base, fits):
    """Every field bit for bit (dtypes too), at a cap that holds every row
    and at half the rows, where trailing buffers are cut and flagged and
    every skip stays within the cap (tests/test_let.py:740)."""
    _, _, _, exp = _small_exports()
    total = int(torch.clamp(exp.n_rows, max=exp.skip.shape[1]).sum())
    cap = total + 64 if fits else total // 2
    want = jax_let.compact_import_forest(jax_let.LetExport(*(jnp.asarray(x.numpy()) for x in exp)),
                                         cap, part_base)
    got = let_tree.compact_import_forest(exp, cap, part_base)
    pairs = [(f, getattr(want, f), getattr(got, f)) for f in ("roots", "extents", "parts",
                                                            "overflow")]
    pairs += [(f, getattr(want.forest, f), getattr(got.forest, f))
              for f in got.forest._fields[:7]]
    for field, w, g in pairs:
        w, g = np.asarray(w), g.numpy()
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert bool(got.overflow) is not fits
    if not fits:
        skip = got.forest.skip.numpy()
        assert (skip >= 0).all() and (skip <= cap).all() and int(got.extents.sum()) <= cap


def test_compact_forest_walk_equals_padded_forest_walk():
    """A pure re-layout (tests/test_let.py:701): the per-particle walk over
    the packed forest gives the padded ``assemble_import_forest`` walk's
    bits."""
    ss, _, tp, exp = _small_exports()
    p, r_cap = exp.skip.shape
    params = SimParams(particle_num=1024, g=1e-4)
    recv = ss.pos[:64] + 0.003  # off the exported bodies: no coincident pair
    self_idx = torch.full((64,), p * r_cap + 7, dtype=torch.int32)  # no self here
    want = tree_forces(recv, exp.parts[:, :, :3].reshape(-1, 3), exp.parts[:, :, 3].reshape(-1),
                       let_tree.assemble_import_forest(exp), params, tp, self_idx=self_idx)
    total = int(torch.clamp(exp.n_rows, max=r_cap).sum())
    cf = let_tree.compact_import_forest(exp, total + 64)
    assert not bool(cf.overflow)
    got = tree_forces(recv, cf.parts[:, :3].contiguous(), cf.parts[:, 3].contiguous(), cf.forest,
                      params, tp, self_idx=self_idx)
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(cf.extents.numpy(), np.minimum(exp.n_rows.numpy(), r_cap))


def test_fused_forest_wrapper_takes_plain_version_on_cpu():
    """The wrapper's CPU route is the plain version (no launch counted); the
    layout: local rows past num_nodes jump to the first import row, the
    import part is the compaction shifted by the arena's rows, the sources
    are [local | far row | packed parts]."""
    ss, tree, _, exp = _small_exports()
    before = import_forest_cuda.LAUNCHES
    f = import_forest_cuda.assemble_fused_forest_cuda(tree, ss.pos, ss.mass, exp, 4000)
    assert import_forest_cuda.LAUNCHES == before
    base, n = tree.nodes_f32.shape[0], ss.n
    cf = let_tree.compact_import_forest(exp, 4000, part_base=n + 1)
    m = int(tree.num_nodes)
    assert (f.forest.skip[m:base] == base).all()
    assert torch.equal(f.forest.skip[:m], tree.skip[:m])
    assert torch.equal(f.forest.skip[base:], cf.forest.skip + base)
    assert torch.equal(f.forest.nodes_f32[base:], cf.forest.nodes_f32)
    assert int(f.forest.num_nodes) == base + int(cf.forest.num_nodes)
    assert torch.equal(f.src_pos[:n], ss.pos) and torch.equal(f.src_pos[n + 1:], cf.parts[:, :3])
    assert float(f.src_mass[n]) == 0.0 and torch.equal(f.src_mass[n + 1:], cf.parts[:, 3])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        meta = type(tree)(*(t.to("meta") if torch.is_tensor(t) else t for t in tree))
        import_forest_cuda.assemble_fused_forest_cuda(
            meta, ss.pos.to("meta"), ss.mass.to("meta"), type(exp)(*(t.to("meta") for t in exp)),
            4000)
    with pytest.raises(TypeError, match="float32"):
        import_forest_cuda.assemble_fused_forest_cuda(tree, ss.pos.double(), ss.mass, exp, 4000)


def test_fused_forest_reads_no_arena_row_past_num_nodes():
    """The arena's rows past num_nodes, which no walk reads, are not copied:
    the forest is the same bit for bit whatever they hold, and they are the
    build's own inert rows, each jumping to the first import row."""
    ss, tree, _, exp = _small_exports()
    want = let_tree.assemble_fused_forest(tree, ss.pos, ss.mass, exp, 4000)
    m, base = int(tree.num_nodes), tree.nodes_f32.shape[0]
    assert m < base - 1
    junk = tree._replace(**{f: getattr(tree, f).clone() for f in ("nodes_f32", "skip", "first",
                                                                  "count")})
    junk.nodes_f32[m:] = -7.0
    junk.skip[m:], junk.first[m:], junk.count[m:] = 3, 5, 9
    got = let_tree.assemble_fused_forest(junk, ss.pos, ss.mass, exp, 4000)
    for f in ("nodes_f32", "skip", "first", "count", "num_nodes", "overflowed"):
        assert torch.equal(getattr(got.forest, f), getattr(want.forest, f)), f
    for f in ("src_pos", "src_mass", "roots", "extents", "overflow"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(want.forest.nodes_f32[m:base], tree.nodes_f32[m:base])
    assert torch.equal(want.forest.first[m:base], tree.first[m:base])
    assert not want.forest.count[m:base].any() and (want.forest.skip[m:base] == base).all()


# ------------------------------------------------- the LET step, emulated


def _let_ranks(s, params, tp, let_cap):
    """P emulated ranks of a LET step from the numpy state ``s``, handed out
    as ``ShardedTreeSim.init_state`` does (slices of the global Morton
    order): (each rank's sort and build, each rank's imports)."""
    whole = state_from_numpy(**s, device="cpu")
    whole = reorder(whole, morton_order(whole.pos, tp.max_depth)[0].long())
    n_l = whole.n // P
    ranks = [ParticleState(*(t[r * n_l:(r + 1) * n_l] for t in whole)) for r in range(P)]
    bound = torch.stack([st.let_bound(x.pos) for x in ranks]).amax(0)
    locs = [st.let_sort_build(x, bound, params, tp) for x in ranks]
    boxes = [st.receiver_box(loc.pos_new) for loc in locs]
    blo, bhi = torch.cat([b[0] for b in boxes]), torch.cat([b[1] for b in boxes])
    exps = [st.let_export(loc, blo, bhi, r, tp, let_cap) for r, loc in enumerate(locs)]
    return locs, st.exchange_by_hand(exps)


def _counts(loc, forest, src_pos, src_mass, tiles, tp, params):
    """(nodes, members) per receiver of one group walk's lists, and whether
    any receiver was deferred."""
    lists = group_walk_lists(loc.pos_new, forest, tiles, tp)
    table = source_table(forest, src_pos, src_mass, params.g * params.dt)
    nodes, members = list_counts(lists, table, forest.nodes_f32.shape[0] - 1)
    deferred = bool((lists.bad | lists.pool_full).any() or tiles.deferred.any())
    return nodes[tiles.tile_id], members[tiles.tile_id], deferred


@pytest.fixture(scope="module")
def disc_step():
    """One emulated LET step of ``_disc(4096)`` (TP_DISC, let_cap 4096), the
    fused and the split walk on the same exports: (locals, imports, fused
    (acc, deferred) per rank, split likewise)."""
    fused_tp = dataclasses.replace(TP_DISC, let_fused=True)
    locs, imps = _let_ranks(_disc(4096), DISC_PARAMS, TP_DISC, DISC_CAP)
    fused = [st.let_forces(loc, imp, DISC_PARAMS, fused_tp, P, DISC_CAP)
             for loc, imp in zip(locs, imps)]
    split = [st.let_forces(loc, imp, DISC_PARAMS, TP_DISC, P, DISC_CAP)
             for loc, imp in zip(locs, imps)]
    return locs, imps, fused, split


def test_fused_walk_equals_split_walk(disc_step):
    """The same exports through both walks: no receiver deferred, each
    receiver's accepted nodes and members equal (massless rows aside: the
    padded forest's hops between buffers and the arena's unused rows), and
    forces equal up to the float32 summation order (ACC_TOL)."""
    locs, imps, fused, split = disc_step
    cap_forest = TP_DISC.let_forest_cap(P, DISC_CAP)
    tp_imp = dataclasses.replace(TP_DISC, walk_list_cap=TP_DISC.effective_import_list_cap())
    for loc, imp, (acc_f, def_f), (acc_s, def_s) in zip(locs, imps, fused, split):
        assert int(def_f) == 0 and int(def_s) == 0
        torch.testing.assert_close(acc_f, acc_s, **ACC_TOL)
        n_l = loc.pos_s.shape[0]
        tiles = tile_setup(loc.keys, n_l, TP_DISC)
        f = let_tree.assemble_fused_forest(loc.tree, loc.pos_s, loc.mass_s, imp, cap_forest)
        assert not bool(f.overflow)
        nf, mf, d1 = _counts(loc, f.forest, f.src_pos, f.src_mass, tiles, TP_DISC, DISC_PARAMS)
        nl, ml, d2 = _counts(loc, loc.tree, loc.pos_s, loc.mass_s, tiles, TP_DISC, DISC_PARAMS)
        ni, mi, d3 = _counts(loc, let_tree.assemble_import_forest(imp),
                             imp.parts[:, :, :3].reshape(-1, 3), imp.parts[:, :, 3].reshape(-1),
                             tiles._replace(r_cap=step_budget(tp_imp.walk_list_cap)), tp_imp,
                             DISC_PARAMS)
        assert not (d1 or d2 or d3)
        assert int(mi.sum()) > 0  # the imports take part
        torch.testing.assert_close(nf, nl + ni, rtol=0, atol=0)
        torch.testing.assert_close(mf, ml + mi, rtol=0, atol=0)


def _jax_let(**kw):
    """One step of the JAX ShardedTreeSim's LET schedule (TP_DISC, let_cap
    4096, ``kw`` on top) from ``_disc(4096)`` on its four-device mesh, handed
    the state in the global Morton order the port's ranks start from:
    (pos, acc)."""
    mesh = jax_make_mesh(P)
    jtp = jp.TreeParams(theta=0.75, max_depth=10, walk_tile=64, walk_list_cap=4096, **kw)
    s = _disc(4096)
    perm = morton_order(torch.from_numpy(s["pos"]), 10)[0].numpy()
    sim = JaxShardedTreeSim(jp.SimParams(particle_num=4096, g=1e-4), mesh, jtp, schedule="let",
                            let_cap=DISC_CAP)
    out = sim.make_step(donate=False)(jax_shard_state(_jax({k: v[perm] for k, v in s.items()}),
                                                      mesh))
    return np.asarray(out.pos), np.asarray(out.acc)


def _fused_rows(disc_step):
    locs, _, fused, _ = disc_step
    return (torch.cat([loc.pos_new for loc in locs]).numpy(),
            torch.cat([a for a, _ in fused]).numpy())


def test_fused_walk_matches_jax_skip_engine(disc_step):
    """JAX's ``walk_engine="skip"`` LET step walks one forest, [local arena
    | the padded import buffers], with the port's acceptance rule: the same
    interactions as the fused walk, so the forces agree to rounding."""
    pos, acc = _fused_rows(disc_step)
    jpos, jacc = _jax_let(walk_engine="skip")
    want, have = _match(jpos, jacc, pos, acc, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(have, want, **ACC_TOL)


def test_fused_walk_matches_jax_fused_octet_walk(disc_step):
    """JAX's own fused walk (``let_fused=True``, the octet engine with its
    import octet tables) tests theta against a quantized centre of gravity:
    rows agree within 1e-2, and both sit at the theta level against float64
    (max |error| < 0.02 of the largest force, tests/test_let.py:663)."""
    pos, acc = _fused_rows(disc_step)
    jpos, jacc = _jax_let(let_fused=True)
    want, have = _match(jpos, jacc, pos, acc, rtol=1e-6, atol=1e-7)
    rel = np.linalg.norm(have - want, axis=1) / np.linalg.norm(want, axis=1)
    assert rel.max() < 1e-2
    s = _disc(4096)
    half = DISC_PARAMS.dt / 2.0
    pos_new = s["pos"] + (s["vel"] + s["acc"] * half) * DISC_PARAMS.dt
    exact = naive_forces_ref(torch.from_numpy(pos_new).double(),
                             torch.from_numpy(s["pos"]).double(),
                             torch.from_numpy(s["mass"]).double(), DISC_PARAMS).numpy()
    x, ours = _match(pos_new, exact, pos, acc)
    _, theirs = _match(pos_new, exact, jpos, jacc, rtol=1e-6, atol=1e-7)
    scale = np.abs(x).max()
    assert np.abs(ours - x).max() / scale < 0.02
    assert np.abs(theirs - x).max() / scale < 0.02


def test_fused_walk_at_theta0_is_exact():
    """theta = 0 opens every row: the fused step is the all-pairs sum
    (tests/test_let.py:48)."""
    params = SimParams(particle_num=256, g=1e-4)
    tp = TreeParams(theta=0.0, max_depth=8, leaf_bucket=4, walk_tile=16, walk_list_cap=2048,
                    let_fused=True)
    s = _uniform(0, 256)
    locs, imps = _let_ranks(s, params, tp, 1024)
    out = [st.let_forces(loc, imp, params, tp, P, 1024) for loc, imp in zip(locs, imps)]
    assert all(int(d) == 0 for _, d in out)
    want = NaiveSim(params, NaiveParams(use_pallas=False)).make_step()(
        state_from_numpy(**s, device="cpu"))
    have_pos = torch.cat([loc.pos_new for loc in locs]).numpy()
    a, b = _match(want.pos.numpy(), want.acc.numpy(), have_pos,
                  torch.cat([a for a, _ in out]).numpy())
    np.testing.assert_allclose(b, a, **THETA0_TOL)


def test_fused_walk_has_no_import_budget_to_escalate():
    """``maybe_escalate_import_budget`` is False on the fused walk whatever
    it deferred (``sharded_tree.py:664-670``); the split walk escalates."""
    mesh = Mesh(rank=0, size=P, device=torch.device("cpu"))
    tp = TreeParams(walk_list_cap=4096, let_import_list_cap=256)
    fused = ShardedTreeSim(DISC_PARAMS, mesh, dataclasses.replace(tp, let_fused=True),
                           schedule="let")
    split = ShardedTreeSim(DISC_PARAMS, mesh, tp, schedule="let")
    assert not fused.maybe_escalate_import_budget({"walk_deferred": 5})
    assert fused.add_params.effective_import_list_cap() == 256
    assert split.maybe_escalate_import_budget({"walk_deferred": 5})


# ------------------------------------------------------------ four ranks


def _rank(rank, out, port):
    torch.set_num_threads(1)
    init_distributed("gloo", rank, P, f"tcp://localhost:{port}")
    try:
        mesh = make_mesh()
        # tests/test_let.py:829: theta = 0 fills every buffer, so a forest of
        # one let_cap overflows, and check_overflow raises
        params = SimParams(particle_num=512, g=1e-4)
        tp = TreeParams(theta=0.0, max_depth=8, leaf_bucket=4, walk_tile=16, walk_list_cap=2048,
                        let_forest_factor=1.0, let_fused=True)
        sim = ShardedTreeSim(params, mesh, tp, schedule="let", let_cap=256)
        try:
            sim.check_overflow(sim.init_state(torch.Generator().manual_seed(11), _fixed(
                _uniform(11, 512))))
            error = None
        except RuntimeError as exc:
            error = str(exc)
        # the fused step through the runner: one step of _disc(4096)
        sim = ShardedTreeSim(DISC_PARAMS, mesh, dataclasses.replace(TP_DISC, let_fused=True),
                             schedule="let", let_cap=DISC_CAP)
        runner = OfflineHeadless(sim, _fixed(_disc(4096)), device="cpu")
        runner.run(steps=1, log_fn=lambda line: None)
        whole = runner.whole_state()
        if mesh.rank == 0:
            np.savez(os.path.join(out, "runner.npz"), pos=whole.pos.numpy(),
                     acc=whole.acc.numpy(), error=np.array(error or ""),
                     deferred=np.array(runner.last_health["walk_deferred"]))
    finally:
        dist.destroy_process_group()


def test_fused_walk_on_four_gloo_ranks(tmp_path, disc_step):
    """On four gloo ranks: an undersized packed forest raises through
    ``check_overflow`` naming its cap; the runner's fused step, collectives
    and all, gives the emulated ranks' bits."""
    mp.spawn(_rank, args=(str(tmp_path), free_port()), nprocs=P, join=True)
    with np.load(tmp_path / "runner.npz") as z:
        got = {k: z[k] for k in z.files}
    assert "LET export overflow" in str(got["error"]) and "fused forest cap 256" in str(
        got["error"])
    assert int(got["deferred"]) == 0
    pos, acc = _fused_rows(disc_step)
    np.testing.assert_array_equal(got["pos"], pos)
    np.testing.assert_array_equal(got["acc"], acc)


def test_cli_headless_fused_let_walk_on_four_cpu_ranks(capfd):
    assert cli.main(["headless", "--devices", str(P), "--device", "cpu", "--sim", "tree",
                     "--schedule", "let", "--fused-let-walk", "--n", "4096", "--steps", "2",
                     "--diag-every", "2"]) == 0
    out = capfd.readouterr().out
    assert out.count("mean: ") == 1 and "'walk_deferred': 0" in out
