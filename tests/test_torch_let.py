"""PyTorch port, LET building blocks (``parallel/let_tree.py``, B7's plain
version ``ops/let_export.py``) on the CPU, held against the JAX package's
``parallel/let_tree.py`` on the same arena and boxes.

The plain export walk must equal JAX ``export_walk`` bit for bit on every
output (integers and floats: the floats are copies). Both packages get the
JAX build's arena, so the comparison is of the walks alone. The import
walk's receivers lie past every import source; the group walk there is
held against JAX's on the same import forest and against the exact sum.
B7's kernel is held against this plain version on the card by
``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_n_body_tpu import params as jp
from wgpu_n_body_tpu.ops import tree_build as jax_build
from wgpu_n_body_tpu.ops.tree_walk_group import group_tree_forces as jax_group_tree_forces
from wgpu_n_body_tpu.parallel import let_tree as jax_let
from wgpu_n_body_tpu_torch.ops import let_export, let_export_cuda, tree_walk_group, tree_walk_group_cuda
from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_dense
from wgpu_n_body_tpu_torch.ops.tree_build import TreeArrays, build_tree, morton_sort
from wgpu_n_body_tpu_torch.ops.tree_walk_group import group_tree_forces
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams, state_from_numpy
from wgpu_n_body_tpu_torch.parallel import let_tree
from wgpu_n_body_tpu_torch.parallel.sharded_tree import exchange_by_hand

# the import walk against JAX's on the same forest (tests/test_torch_tree_group.py)
JAX_TOL = dict(rtol=1e-4, atol=1e-8)
# tests/test_let.py:63: theta = 0 against the all-pairs sum
THETA0_TOL = dict(rtol=2e-4, atol=1e-8)


def _scene(seed, n, bucket, theta, depth=10):
    """(port sorted state, the port's plain arena as the JAX package's, the
    arena, JAX and port TreeParams): both packages walk the same arena."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    z = np.zeros((n, 3), np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    kw = dict(theta=theta, max_depth=depth, leaf_bucket=bucket, walk_engine="skip")
    jtp, ttp = jp.TreeParams(**kw), TreeParams(**kw)
    ss, bound, keys = morton_sort(state_from_numpy(pos, z, z, mass, "cpu"), depth)
    ttree = build_tree(ss, keys, bound, ttp)
    jtree = jax_build.TreeArrays(*(jnp.asarray(t.numpy()) for t in ttree[:7]))
    return ss, jtree, ttree, jtp, ttp


def _boxes(pos, geometry):
    """(P, 3) lo and hi destination boxes and this rank's index."""
    lo, hi = pos.min(0), pos.max(0)
    if geometry == "octants":  # this rank's box and its seven neighbours
        shifts = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
        blo = np.stack([lo + np.array(s) * (hi - lo) for s in shifts])
        bhi = np.stack([hi + np.array(s) * (hi - lo) for s in shifts])
        me = 0
    elif geometry == "overlap":  # Morton quarters of the rank's own bodies
        qs = np.array_split(pos, 4)
        blo, bhi, me = np.stack([q.min(0) for q in qs]), np.stack([q.max(0) for q in qs]), 3
    else:  # one box over the whole set (and this rank's own)
        blo, bhi, me = np.stack([lo, lo]), np.stack([hi, hi]), 1
    return blo.astype(np.float32), bhi.astype(np.float32), me


CASES = {
    # (seed, n, bucket, theta, geometry, let_cap)
    "octants": (0, 4096, 16, 0.75, "octants", 8192),
    "overlap": (1, 1024, 4, 0.4, "overlap", 2048),
    "theta0": (2, 512, 4, 0.0, "overlap", 1024),
    # tests/test_let.py:170: theta = 0 against an overlapping box needs ~n
    # plus the internal rows; 64 rows must overflow (and keep the DFS prefix)
    "overflow": (4, 512, 1, 0.0, "whole", 64),
}


def _exports(case):
    seed, n, bucket, theta, geometry, cap = CASES[case]
    ss, jtree, ttree, _, _ = _scene(seed, n, bucket, theta)
    blo, bhi, me = _boxes(ss.pos.numpy(), geometry)
    jexp = jax_let.export_walk(jtree, jnp.asarray(ss.pos.numpy()), jnp.asarray(ss.mass.numpy()),
                               jnp.asarray(blo), jnp.asarray(bhi), jnp.int32(me), theta, cap)
    texp = let_export_cuda.export_walk_cuda(ttree, ss.pos, ss.mass, torch.from_numpy(blo),
                                            torch.from_numpy(bhi), me, theta, cap)
    return jexp, texp, me


@pytest.mark.parametrize("case", list(CASES))
def test_plain_export_walk_equals_jax_bit_for_bit(case):
    before = let_export_cuda.LAUNCHES
    jexp, texp, me = _exports(case)
    assert let_export_cuda.LAUNCHES == before  # CPU tensors: the plain version
    for field in jexp._fields:
        want, got = np.asarray(getattr(jexp, field)), getattr(texp, field).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert int(texp.n_rows[me]) == 0 and not bool(texp.overflow[me])
    if case == "overflow":
        assert bool(texp.overflow[0]) and int(texp.n_rows[0]) == 64
    else:
        assert not bool(texp.overflow.any()) and int(texp.n_rows.max()) > 0


def test_export_rows_parallel_form():
    """The parallel form's pieces: a visited row is covered by no earlier
    stop row, the slots sum to n_rows, and only the self destination is
    empty."""
    ss, _, ttree, _, _ = _scene(5, 1024, 8, 0.5)
    blo, bhi, me = _boxes(ss.pos.numpy(), "overlap")
    kinds, visited, sizes = let_export.export_rows(ttree, torch.from_numpy(blo),
                                                   torch.from_numpy(bhi), me, 0.5)
    exp = let_export.export_walk(ttree, ss.pos, ss.mass, torch.from_numpy(blo),
                                 torch.from_numpy(bhi), me, 0.5, 4096)
    np.testing.assert_array_equal(sizes.sum(1).numpy(), exp.n_rows.numpy())
    assert not visited[me].any() and visited[:me].any(1).all()
    skip = ttree.skip.numpy()
    for d in range(4):
        stop = np.isin(kinds[d].numpy(), [let_export.TERMINAL, let_export.POINT,
                                         let_export.HEADER])
        vis = visited[d].numpy()
        for i in np.flatnonzero(vis & stop)[:50]:  # nothing inside a stop row's subtree
            assert not vis[i + 1 : skip[i]].any()


def test_export_walk_wrapper_rejects():
    ss, _, ttree, _, _ = _scene(6, 256, 4, 0.5)
    pos, mass = ss.pos, ss.mass
    box = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="multiple of 8"):
        let_export_cuda.export_walk_cuda(ttree, pos, mass, box, box, 0, 0.5, 100)
    with pytest.raises(ValueError, match="self_index"):
        let_export_cuda.export_walk_cuda(ttree, pos, mass, box, box, 2, 0.5, 64)
    with pytest.raises(TypeError, match="float32"):
        let_export_cuda.export_walk_cuda(ttree, pos.double(), mass, box, box, 0, 0.5, 64)
    meta = TreeArrays(*(t.to("meta") if isinstance(t, torch.Tensor) else t for t in ttree))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        let_export_cuda.export_walk_cuda(meta, pos.to("meta"), mass.to("meta"), box.to("meta"),
                                         box.to("meta"), 0, 0.5, 64)


@pytest.mark.parametrize("n_local, theta", [(4096, 0.75), (4_000_000, 0.75),
                                            (4_000_000, 0.5), (1 << 20, 0.6)])
def test_auto_let_cap_equals_jax(n_local, theta):
    assert let_tree.auto_let_cap(n_local, theta) == jax_let.auto_let_cap(n_local, theta)


@pytest.mark.parametrize("kw", [{}, {"walk_engine": "skip"}, {"let_fused": True},
                                {"leaf_bucket": 1, "walk_list_cap": 4096}])
def test_let_memory_bytes_equals_jax(kw):
    for n, p, cap in ((32_000_000, 8, 16384), (16_000_000, 4, 102400), (4096, 4, 8192)):
        want = jax_let.let_memory_bytes(n, p, jp.TreeParams(**kw), let_cap=cap)
        assert let_tree.let_memory_bytes(n, p, TreeParams(**kw), let_cap=cap) == want
    # tests/test_let.py:186: BASELINE config 4 fits 16 GB per chip
    assert let_tree.let_memory_bytes(32_000_000, 8, TreeParams(), let_cap=16384)["total"] < 6e9


@pytest.mark.parametrize("cap", [256, 8192])
def test_wire_round_trip_and_exchange(cap):
    """The wire arrays rebuild every field bit for bit (tests/test_let.py:547),
    including a truncated buffer; the hand exchange hands rank r buffer r of
    every export."""
    ss, _, ttree, _, _ = _scene(5, 4096, 8, 0.5)
    lo, hi = ss.pos.numpy().min(0), ss.pos.numpy().max(0)
    shifts = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 1), (3, 0, 0)]
    blo = np.stack([lo + np.array(s) * (hi - lo) for s in shifts]).astype(np.float32)
    bhi = np.stack([hi + np.array(s) * (hi - lo) for s in shifts]).astype(np.float32)
    exps = [let_export.export_walk(ttree, ss.pos, ss.mass, torch.from_numpy(blo),
                                   torch.from_numpy(bhi), me, 0.5, cap) for me in range(5)]
    rt = let_tree.import_from_wire(*let_tree.wire_arrays(exps[0]))
    for field in exps[0]._fields:
        assert torch.equal(getattr(rt, field), getattr(exps[0], field)), field
    assert bool(exps[0].overflow.any()) is (cap == 256)
    imps = exchange_by_hand(exps)
    for r in range(5):
        for s in range(5):
            for field in imps[r]._fields:
                assert torch.equal(getattr(imps[r], field)[s], getattr(exps[s], field)[r]), field


@pytest.fixture(scope="module")
def import_side():
    """A JAX export to four Morton-quarter boxes of a second body set,
    imported by the port (``let_export_from_numpy``) and by JAX."""
    ss, jtree, _, jtp, ttp = _scene(7, 1024, 4, 0.5, depth=8)
    rng = np.random.default_rng(8)
    recv = np.sort(rng.uniform(-1, 1, (512, 3)).astype(np.float32) * 0.5 + 1.2, axis=0)
    qs = np.array_split(recv, 4)
    blo = np.stack([q.min(0) for q in qs]).astype(np.float32)
    bhi = np.stack([q.max(0) for q in qs]).astype(np.float32)
    jexp = jax_let.export_walk(jtree, jnp.asarray(ss.pos.numpy()), jnp.asarray(ss.mass.numpy()),
                               jnp.asarray(blo), jnp.asarray(bhi), jnp.int32(3), 0.5, 2048)
    return ss, jexp, recv, jtp, ttp


def _port_import_walk(jexp, recv, ttp, **kw):
    imp = let_tree.let_export_from_numpy(jexp)
    p, cap = imp.skip.shape
    forest = let_tree.assemble_import_forest(imp)
    keys = torch.zeros(recv.shape[0], dtype=torch.int64)  # one tile cell: tiles by index
    params = SimParams(particle_num=recv.shape[0], g=1e-3)
    return tree_walk_group_cuda.group_tree_forces_cuda(
        torch.from_numpy(recv), imp.parts[:, :, :3].reshape(-1, 3).contiguous(),
        imp.parts[:, :, 3].reshape(-1).contiguous(), forest, keys, params,
        dataclasses.replace(ttp, walk_tile=32, **kw), gid_offset=p * cap,
    ), imp


def test_import_walk_past_the_sources_matches_jax(import_side):
    ss, jexp, recv, jtp, ttp = import_side
    (acc, stats), imp = _port_import_walk(jexp, recv, ttp, walk_list_cap=2048)
    p, cap = imp.skip.shape
    forest = jax_let.assemble_import_forest(jexp)
    want, jstats = jax_group_tree_forces(
        jnp.asarray(recv), jexp.parts[:, :, :3].reshape(-1, 3), jexp.parts[:, :, 3].reshape(-1),
        forest, (jnp.zeros(512, jnp.uint32), jnp.zeros(512, jnp.uint32)),
        jp.SimParams(particle_num=512, g=1e-3),
        dataclasses.replace(jtp, walk_tile=32, walk_list_cap=2048), gid_offset=p * cap,
    )
    np.testing.assert_allclose(acc.numpy(), np.asarray(want), **JAX_TOL)
    assert int(stats.deferred) == int(jstats.deferred) == 0


@pytest.mark.parametrize("defer", [False, True])
def test_import_walk_at_theta0_is_the_exact_remote_sum(defer, monkeypatch):
    """theta = 0 exports every remote body as a member row: the import walk,
    receivers past all sources (nothing masked), is the all-pairs sum. With
    no room in the list pool every tile is deferred, and the per-particle
    walk takes all receivers with self_idx = gid_offset + i, beyond every
    source: the same sum."""
    ss, jtree, ttree, _, ttp = _scene(9, 256, 4, 0.0, depth=8)
    pos, mass = ss.pos, ss.mass
    recv = pos[:64] * 0.5 + 1.5  # another rank's receivers, off the sources
    box = torch.stack([recv.amin(0), pos.amin(0)]), torch.stack([recv.amax(0), pos.amax(0)])
    exp = let_export.export_walk(ttree, pos, mass, *box, 1, 0.0, 1024)
    forest = let_tree.assemble_import_forest(exp)
    params = SimParams(particle_num=64, g=1e-3)
    if defer:
        monkeypatch.setattr(tree_walk_group, "pool_chunks", lambda n: 0)
    got, stats = group_tree_forces(recv, exp.parts[:, :, :3].reshape(-1, 3),
                                   exp.parts[:, :, 3].reshape(-1), forest,
                                   torch.zeros(64, dtype=torch.int64), params,
                                   dataclasses.replace(ttp, walk_tile=16), gid_offset=2 * 1024)
    assert int(stats.deferred) == (64 if defer else 0)
    want = naive_forces_dense(recv, pos, mass, params, row_offset=256)
    torch.testing.assert_close(got, want, **THETA0_TOL)


@pytest.mark.parametrize("g0, n, n_src, ok", [
    (0, 10, 10, True), (5, 5, 10, True), (10, 4, 10, True), (40, 4, 10, True),
    (8, 4, 10, False), (-1, 4, 10, False),
])
def test_group_walk_receiver_guard(g0, n, n_src, ok):
    """The evaluation kernel's wrapper takes receivers inside the sources or
    wholly past them (the LET import walk), never straddling their end."""
    if ok:
        assert tree_walk_group_cuda.check_receivers(g0, n, n_src) == g0
    else:
        with pytest.raises(ValueError, match="straddle"):
            tree_walk_group_cuda.check_receivers(g0, n, n_src)


def test_morton_order_against_a_given_bound():
    """The LET schedule's local sort cuts its cells from the bound reduced over
    the ranks: the positions' own bound gives the default order, a wider one
    the plain keys of that bound."""
    from wgpu_n_body_tpu_torch.ops import morton
    from wgpu_n_body_tpu_torch.ops.morton_cuda import morton_order_cuda

    pos = torch.from_numpy(np.random.default_rng(3).uniform(-0.5, 0.5, (300, 3)).astype(np.float32))
    own = morton.bound_of(pos)
    for got, want in zip(morton_order_cuda(pos, 10, own), morton_order_cuda(pos, 10)):
        assert torch.equal(got, want)
    wide = torch.tensor(2.5)
    perm, bound, keys = morton_order_cuda(pos, 10, wide)
    assert bound is wide
    want_keys, want_perm = torch.sort(morton.packed_keys(pos, wide, 10), stable=True)
    assert torch.equal(keys, want_keys) and torch.equal(perm, want_perm.to(torch.int32))
