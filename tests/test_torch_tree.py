"""PyTorch port, tree slice: Morton keys, scans, the octree arena, the
per-particle walk and TreeSim, each fed the same numpy state as the JAX
package and held against it.

Integers (keys, permutation, split levels, arena skip/first/count,
num_nodes, overflowed) must be exactly equal. Floats carry the
tolerances below, each with its reason. The JAX side runs the
per-particle walk with ``walk_engine="skip"`` (no octet tables to build).
On the CPU the port's kernel wrapper takes its plain torch version; the
kernel itself is checked on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_n_body_tpu import params as jp
from wgpu_n_body_tpu.models.tree import TreeSim as JaxTreeSim
from wgpu_n_body_tpu.ops import morton as jax_morton
from wgpu_n_body_tpu.ops import scan as jax_scan
from wgpu_n_body_tpu.ops import tree_build as jax_build
from wgpu_n_body_tpu.ops.tree_walk import tree_forces as jax_tree_forces
from wgpu_n_body_tpu_torch.models import TreeSim
from wgpu_n_body_tpu_torch.ops import morton, scan, tree_walk_cuda
from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_dense
from wgpu_n_body_tpu_torch.ops.tree_build import (
    IS_SINGLE,
    NO_CHILD,
    build_tree,
    morton_order,
    morton_sort,
)
from wgpu_n_body_tpu_torch.ops.tree_walk import tree_forces
from wgpu_n_body_tpu_torch.params import (
    SimParams,
    TreeParams,
    params_from_dict,
    state_from_numpy,
    state_to_numpy,
)

# node payloads come from prefix-sum differences (float64 here, float-float
# in JAX): a few float32 ulp apart at most
NODE_TOL = dict(rtol=1e-6, atol=0)
# plain walk vs JAX tree_forces: the same node and member terms, float32
# sums that XLA may associate differently
WALK_TOL = dict(rtol=1e-4, atol=1e-9)
# tests/test_tree.py:144 (theta=0 against the all-pairs sum)
THETA0_TOL = dict(rtol=2e-4, atol=1e-8)
# tests/test_naive.py state tolerances, two steps
POS_TOL = dict(rtol=1e-5, atol=1e-8)
VEL_TOL = dict(rtol=1e-4, atol=1e-8)

DEPTH = 10
SCENES = ["uniform", "span3", "duplicates"]


def _np_state(seed, n, span=1.0, duplicates=False):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    if duplicates:  # exact copies: equal keys, ties the sort must keep in order
        pos[n // 2 : n // 2 + n // 8] = pos[: n // 8]
    return {
        "pos": pos,
        "vel": rng.uniform(-0.01, 0.01, (n, 3)).astype(np.float32),
        "acc": np.zeros((n, 3), np.float32),
        "mass": rng.uniform(0.5, 2.0, n).astype(np.float32),
    }


def _scene(name, n=384):
    return {
        "uniform": lambda: _np_state(1, n),
        "span3": lambda: _np_state(2, n, span=3.0),
        "duplicates": lambda: _np_state(3, n, duplicates=True),
    }[name]()


def _jax_state(s):
    return jp.ParticleState(**{k: jnp.asarray(v) for k, v in s.items()})


def _port_state(s):
    return state_from_numpy(**s, device="cpu")


def _tp(**kw):
    """The same TreeParams in both packages (JAX: skip engine, no octets)."""
    kw = {"max_depth": DEPTH, "walk": "per_particle", "walk_engine": "skip", **kw}
    return jp.TreeParams(**kw), TreeParams(**kw)


def _sim_params(n, g=1e-3):
    return jp.SimParams(particle_num=n, g=g), SimParams(particle_num=n, g=g)


def _i64(a):
    return np.asarray(a).astype(np.int64)


def _sort_build_both(s, **tp_kw):
    jtp, ttp = _tp(**tp_kw)
    jss, jbound, jkeys = jax_build.morton_sort(_jax_state(s), jtp.max_depth)
    jtree = jax_build.build_tree(jss, jkeys, jbound, jtp)
    tss, tbound, tkeys = morton_sort(_port_state(s), ttp.max_depth)
    ttree = build_tree(tss, tkeys, tbound, ttp)
    return (jss, jbound, jkeys, jtree), (tss, tbound, tkeys, ttree)


@pytest.fixture(scope="module")
def jax_orders():
    """JAX Morton order of each scene: (perm, bound, hi, lo) as numpy."""
    out = {}
    for name in SCENES:
        perm, bound, (hi, lo) = jax_build.morton_order(jnp.asarray(_scene(name)["pos"]), DEPTH)
        out[name] = (_i64(perm), float(bound), _i64(hi), _i64(lo))
    return out


# ---------------------------------------------------------------- morton


def test_morton_keys_match_manual_interleave():
    depth = 4
    cell = torch.tensor([[0b1010, 0b0110, 0b0011]])
    hi, lo = morton.morton_keys(cell, depth)
    want = 0
    for lvl in range(depth):
        b = depth - 1 - lvl
        x, y, z = (0b1010 >> b) & 1, (0b0110 >> b) & 1, (0b0011 >> b) & 1
        want = (want << 3) | (x | (y << 1) | (z << 2))
    assert int(hi[0]) == want and int(lo[0]) == 0


@pytest.mark.parametrize("scene", SCENES)
def test_morton_keys_and_permutation_equal_jax(scene, jax_orders):
    pos = _scene(scene)["pos"]
    perm, bound, keys = morton_order(torch.from_numpy(pos), DEPTH)
    hi, lo = morton.unpack_keys(keys, DEPTH)
    jperm, jbound, jhi, jlo = jax_orders[scene]
    assert bound.dtype == torch.float32 and float(bound) == jbound
    np.testing.assert_array_equal(hi.numpy(), jhi)
    np.testing.assert_array_equal(lo.numpy(), jlo)
    np.testing.assert_array_equal(perm.numpy(), jperm)
    if scene == "span3":
        assert jbound > 1.0  # the bound really left the unit cube
    if scene == "duplicates":
        assert (np.diff(jhi) == 0).any()  # ties exist and kept index order


@pytest.mark.parametrize("depth", [4, 10, 16, 20])
def test_quantize_and_keys_equal_jax_at_each_depth(depth):
    pos = _np_state(4, 500, span=2.5)["pos"]
    bound = np.float32(np.abs(pos).max())
    cells = morton.quantize(torch.from_numpy(pos), torch.tensor(bound), depth)
    jcells = jax_morton.quantize(jnp.asarray(pos), jnp.float32(bound), depth)
    np.testing.assert_array_equal(cells.numpy(), _i64(jcells))
    hi, lo = morton.morton_keys(cells, depth)
    jhi, jlo = jax_morton.morton_keys(jcells, depth)
    np.testing.assert_array_equal(hi.numpy(), _i64(jhi))
    np.testing.assert_array_equal(lo.numpy(), _i64(jlo))
    order = np.lexsort((_i64(jlo), _i64(jhi)))
    hi_s, lo_s = hi[order], lo[order]
    got = morton.split_levels(morton.pack_keys(hi_s, lo_s, depth), depth).numpy()
    want = _i64(jax_morton.split_levels(jhi[order], jlo[order], depth))
    np.testing.assert_array_equal(got, want)
    for level in (0, 1, min(depth, 10), depth):
        p_hi, p_lo = morton.prefix_at_level(hi_s, lo_s, level, depth)
        j_hi, j_lo = jax_morton.prefix_at_level(jhi[order], jlo[order], level, depth)
        np.testing.assert_array_equal(p_hi.numpy(), _i64(j_hi))
        np.testing.assert_array_equal(p_lo.numpy(), _i64(j_lo))


@pytest.mark.parametrize("scene", SCENES)
def test_split_levels_equal_jax(scene, jax_orders):
    _, _, jhi, jlo = jax_orders[scene]
    got = morton.split_levels(
        morton.pack_keys(torch.from_numpy(jhi), torch.from_numpy(jlo), DEPTH), DEPTH
    )
    want = jax_morton.split_levels(
        jnp.asarray(jhi, jnp.uint32), jnp.asarray(jlo, jnp.uint32), DEPTH
    )
    np.testing.assert_array_equal(got.numpy(), _i64(want))


def test_highest_bit_is_exact():
    v = torch.tensor([1, 2, 3, 7, 8, (1 << 30) - 1, 1 << 30, (1 << 31) - 1, (1 << 40) + 5])
    want = [int(x).bit_length() - 1 for x in v]
    assert morton.highest_bit(v).tolist() == want


# ------------------------------------------------------------------ scans


def test_scans_match_jax():
    rng = np.random.default_rng(5)
    x = rng.integers(-1000, 1000, (3, 700)).astype(np.int32)
    np.testing.assert_array_equal(
        scan.cummax_last(torch.from_numpy(x)).numpy(), np.asarray(jax_scan.cummax_last(jnp.asarray(x)))
    )
    np.testing.assert_array_equal(
        scan.cummin_last(torch.from_numpy(x)).numpy(), np.asarray(jax_scan.cummin_last(jnp.asarray(x)))
    )
    # range sums of a big-offset series: a plain float32 cumsum loses them
    v = np.concatenate([[150000.0], rng.uniform(0.5, 2.0, 999)]).astype(np.float32)[:, None]
    hi, lo = scan.ff_cumsum_ext(torch.from_numpy(v))
    jhi, jlo = jax_scan.ff_cumsum_ext(jnp.asarray(v))
    exact = np.concatenate([[0.0], np.cumsum(v[:, 0].astype(np.float64))])
    for a, b in ((1, 17), (500, 516), (0, 1000), (999, 1000)):
        got = float((hi[b, 0] - hi[a, 0]) + (lo[b, 0] - lo[a, 0]))
        want = float((jhi[b, 0] - jhi[a, 0]) + (jlo[b, 0] - jlo[a, 0]))
        assert got == pytest.approx(exact[b] - exact[a], rel=1e-7)
        assert got == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------------ build


@pytest.mark.parametrize("bucket", [1, 4, 16])
def test_build_arena_equal_jax(bucket):
    s = _np_state(6, 400)
    (jss, _, _, jt), (tss, _, _, tt) = _sort_build_both(s, leaf_bucket=bucket)
    np.testing.assert_array_equal(tss.pos.numpy(), np.asarray(jss.pos))
    for field in ("skip", "first", "count"):
        got = getattr(tt, field)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jt, field)), err_msg=field)
    assert int(tt.num_nodes) == int(jt.num_nodes) > 0
    assert bool(tt.overflowed) is bool(jt.overflowed) is False
    assert float(tt.root_width) == float(jt.root_width)
    np.testing.assert_allclose(tt.nodes_f32.numpy(), np.asarray(jt.nodes_f32), **NODE_TOL)
    m = int(tt.num_nodes)
    nodes = tt.nodes_f32.numpy()
    singles = nodes[:m, IS_SINGLE] > 0
    # singleton cog is the particle's position, bit for bit
    np.testing.assert_array_equal(nodes[:m][singles][:, :3], tss.pos.numpy()[tt.first.numpy()[:m][singles]])
    assert tt.octets is None and tt.octet_pts is None


def test_build_clustered_and_duplicate_scenes_equal_jax():
    for s in (_scene("duplicates"), _cluster_state(20, 44)):
        (_, _, _, jt), (_, _, _, tt) = _sort_build_both(s, max_depth=3, leaf_bucket=4)
        for field in ("skip", "first", "count", "num_nodes"):
            np.testing.assert_array_equal(
                getattr(tt, field).numpy(), np.asarray(getattr(jt, field)), err_msg=field
            )
        np.testing.assert_allclose(tt.nodes_f32.numpy(), np.asarray(jt.nodes_f32), **NODE_TOL)


# ------------------------------------------------------------------- walk


@pytest.mark.parametrize("scene", SCENES)
def test_walk_matches_jax_tree_forces(scene):
    s = _scene(scene)
    n = s["pos"].shape[0]
    (jss, _, _, jt), (tss, _, _, tt) = _sort_build_both(s)
    jparams, tparams = _sim_params(n)
    jtp, ttp = _tp()
    rng = np.random.default_rng(7)
    pos_new = (tss.pos.numpy() + rng.uniform(-1e-3, 1e-3, (n, 3))).astype(np.float32)
    want = np.asarray(jax_tree_forces(jnp.asarray(pos_new), jss.pos, jss.mass, jt, jparams, jtp))
    got = tree_forces(torch.from_numpy(pos_new), tss.pos, tss.mass, tt, tparams, ttp).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], **WALK_TOL)
    # a sampled subset of receivers, with their sorted indices and a mask
    idx = np.sort(rng.choice(n, 40, replace=False)).astype(np.int32)
    active = rng.uniform(size=40) < 0.8
    jsub = np.asarray(jax_tree_forces(
        jnp.asarray(pos_new[idx]), jss.pos, jss.mass, jt, jparams, jtp,
        active=jnp.asarray(active), self_idx=jnp.asarray(idx),
    ))
    sub = tree_forces(
        torch.from_numpy(pos_new[idx]), tss.pos, tss.mass, tt, tparams, ttp,
        active=torch.from_numpy(active), self_idx=torch.from_numpy(idx),
    ).numpy()
    assert (sub[~active] == 0).all()
    ok = ~np.isnan(jsub)
    np.testing.assert_allclose(sub[ok], jsub[ok], **WALK_TOL)
    np.testing.assert_array_equal(sub[active], got[idx][active])


def test_theta_zero_equals_naive():
    s = _np_state(8, 256)
    _, ttp = _tp(theta=0.0)
    _, params = _sim_params(256)
    tss, bound, keys = morton_sort(_port_state(s), DEPTH)
    tree = build_tree(tss, keys, bound, ttp)
    got = tree_forces(tss.pos, tss.pos, tss.mass, tree, params, ttp)
    want = naive_forces_dense(tss.pos, tss.pos, tss.mass, params)
    torch.testing.assert_close(got, want, **THETA0_TOL)


def test_theta_accuracy_improves_as_theta_shrinks():
    s = _np_state(9, 256)
    _, params = _sim_params(256)
    tss, bound, keys = morton_sort(_port_state(s), DEPTH)
    want = naive_forces_dense(tss.pos, tss.pos, tss.mass, params).numpy()
    scale = np.linalg.norm(want, axis=1).mean()

    def err(theta):
        _, ttp = _tp(theta=theta)
        tree = build_tree(tss, keys, bound, ttp)
        got = tree_forces(tss.pos, tss.pos, tss.mass, tree, params, ttp).numpy()
        return np.abs(got - want).mean() / scale

    e75, e30 = err(0.75), err(0.3)
    # tests/test_tree.py:149-171: ~1% at theta=0.75, ~0.05% at theta=0.3
    assert e30 < e75 < 0.03
    assert e30 < 0.003


def _cluster_state(n_cluster, n_far, seed=10):
    """n_cluster particles inside one tiny cell + n_far spread out."""
    rng = np.random.default_rng(seed)
    cluster = 0.6 + rng.uniform(0, 1, (n_cluster, 3)) * 1e-4
    far = rng.uniform(-1.0, 0.4, (n_far, 3))
    n = n_cluster + n_far
    return {
        "pos": np.concatenate([cluster, far]).astype(np.float32),
        "vel": np.zeros((n, 3), np.float32),
        "acc": np.zeros((n, 3), np.float32),
        "mass": np.ones(n, np.float32),
    }


def test_overfull_terminal_cell_exact():
    # a max-depth cell holding more than leaf_bucket particles is summed in
    # bucket-sized chunks, not truncated (tests/test_tree.py:276-299)
    s = _cluster_state(20, 44)
    (jss, _, _, jt), (tss, _, _, tt) = _sort_build_both(s, theta=0.0, max_depth=3, leaf_bucket=4)
    m = int(tt.num_nodes)
    assert (tt.nodes_f32[:m, NO_CHILD] == 2.0).any()
    jparams, params = _sim_params(64)
    jtp, ttp = _tp(theta=0.0, max_depth=3, leaf_bucket=4)
    got = tree_forces(tss.pos, tss.pos, tss.mass, tt, params, ttp)
    want = naive_forces_dense(tss.pos, tss.pos, tss.mass, params)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=1e-8)
    jgot = np.asarray(jax_tree_forces(jss.pos, jss.pos, jss.mass, jt, jparams, jtp))
    np.testing.assert_allclose(got.numpy(), jgot, **WALK_TOL)


def _tight_pairs_state(n_pairs, seed=11):
    """Nearly coincident pairs: each drags a chain of nodes to max depth."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.0, 1.0, (n_pairs, 3)).astype(np.float32)
    n = 2 * n_pairs
    return {
        "pos": np.concatenate([base, base + np.float32(1e-6)]),
        "vel": np.zeros((n, 3), np.float32),
        "acc": np.zeros((n, 3), np.float32),
        "mass": np.ones(n, np.float32),
    }


def test_arena_overflow_flags_and_walk_terminates():
    kw = dict(theta=0.5, max_depth=16, leaf_bucket=1, node_capacity_factor=1)
    s = _tight_pairs_state(32)
    (_, _, _, jt), (tss, _, _, tt) = _sort_build_both(s, **kw)
    cap = tt.nodes_f32.shape[0] - 1
    assert bool(tt.overflowed) and bool(jt.overflowed)
    assert int(tt.num_nodes) == int(jt.num_nodes) == cap
    np.testing.assert_array_equal(tt.skip.numpy(), np.asarray(jt.skip))
    _, params = _sim_params(64)
    acc = tree_forces(tss.pos, tss.pos, tss.mass, tt, params, _tp(**kw)[1])
    assert acc.shape == (64, 3)
    # finished lanes never read past the arena (JAX's fill-mode gather
    # turns most rows NaN here; ROADMAP C)
    assert torch.isfinite(acc).all()


def test_coincident_pair_matches_naive_semantics():
    # two exactly coincident particles share a bucket: both NaN, as the
    # all-pairs force gives; a far third particle stays finite
    s = {
        "pos": np.array([[0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [-0.5, -0.5, -0.5]], np.float32),
        "vel": np.zeros((3, 3), np.float32),
        "acc": np.zeros((3, 3), np.float32),
        "mass": np.ones(3, np.float32),
    }
    (jss, _, _, jt), (tss, _, _, tt) = _sort_build_both(s, theta=0.5, max_depth=4)
    params = SimParams(particle_num=3, g=1e-2)
    ttp = _tp(theta=0.5, max_depth=4)[1]
    acc = tree_forces(tss.pos, tss.pos, tss.mass, tt, params, ttp).numpy()
    want = naive_forces_dense(tss.pos, tss.pos, tss.mass, params).numpy()
    jacc = np.asarray(jax_tree_forces(
        jss.pos, jss.pos, jss.mass, jt, jp.SimParams(particle_num=3, g=1e-2),
        _tp(theta=0.5, max_depth=4)[0],
    ))
    lone = tss.pos.numpy()[:, 0] < 0
    assert np.isnan(want[~lone]).any()
    np.testing.assert_array_equal(np.isnan(acc), np.isnan(want))
    np.testing.assert_array_equal(np.isnan(acc), np.isnan(jacc))
    np.testing.assert_allclose(acc[lone], want[lone], rtol=1e-5)
    assert acc[lone][0] @ np.ones(3) > 0


def test_walk_wrapper_on_cpu_takes_plain_version_without_launching():
    s = _np_state(12, 128)
    _, ttp = _tp()
    _, params = _sim_params(128)
    tss, bound, keys = morton_sort(_port_state(s), DEPTH)
    tree = build_tree(tss, keys, bound, ttp)
    before = tree_walk_cuda.LAUNCHES
    got = tree_walk_cuda.tree_forces_cuda(tss.pos, tss.pos, tss.mass, tree, params, ttp)
    assert tree_walk_cuda.LAUNCHES == before
    want = tree_forces(tss.pos, tss.pos, tss.mass, tree, params, ttp)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="several devices"):
        tree_walk_cuda.tree_forces_cuda(
            tss.pos.to("meta"), tss.pos, tss.mass, tree, params, ttp
        )


# ---------------------------------------------------------------- TreeSim


def test_tree_sim_matches_jax_tree_sim():
    n = 256
    s = _np_state(13, n)
    jparams, params = _sim_params(n, g=1e-5)
    jtp, ttp = _tp(theta=0.5)
    jstep = JaxTreeSim(jparams, jtp).make_step(donate=False)
    step = TreeSim(params, ttp).make_step()
    a, b = _jax_state(s), _port_state(s)
    for _ in range(2):
        a, b = jstep(a), step(b)
    got = state_to_numpy(b)
    # both return the Morton-sorted state, so rows correspond
    np.testing.assert_allclose(got["pos"], np.asarray(a.pos), **POS_TOL)
    np.testing.assert_allclose(got["vel"], np.asarray(a.vel), **VEL_TOL)
    np.testing.assert_array_equal(got["mass"], np.asarray(a.mass))
    np.testing.assert_array_equal(np.sort(got["mass"]), np.sort(s["mass"]))


def test_tree_sim_default_is_the_group_walk_and_steps():
    sim = TreeSim(SimParams(particle_num=64, g=1e-5))
    assert sim.add_params == TreeParams() and sim.add_params.walk == "group"
    out = sim.make_step()(_port_state(_np_state(15, 64)))
    assert torch.isfinite(out.pos).all() and torch.isfinite(out.acc).all()
    assert (out.acc != 0).any(dim=1).all()
    with pytest.raises(ValueError, match="walk"):
        TreeSim(SimParams(particle_num=8), TreeParams(walk="stack"))


def test_tree_sim_diagnose_and_check_overflow():
    _, ttp = _tp(theta=0.5)
    ok = TreeSim(SimParams(particle_num=256), ttp)
    d = ok.diagnose(_port_state(_np_state(14, 256)))
    assert 0 < d["num_nodes"] <= d["node_capacity"] == ttp.capacity(256)
    assert d["overflowed"] is False
    ok.check_overflow(_port_state(_np_state(14, 256)))
    _, bad_tp = _tp(theta=0.5, max_depth=16, leaf_bucket=1, node_capacity_factor=1)
    bad = TreeSim(SimParams(particle_num=64), bad_tp)
    with pytest.raises(RuntimeError, match="overflow"):
        bad.check_overflow(_port_state(_tight_pairs_state(32)))
    assert bad.diagnose(_port_state(_tight_pairs_state(32)))["overflowed"] is True


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"leaf_bucket": 1},
        {"leaf_bucket": 4, "node_capacity_factor": 2.0},
        {"octet_capacity_factor": 0.3, "walk_tile": 64, "let_import_list_cap": 512},
    ],
)
def test_tree_params_match_jax(kw):
    tp, jtp = TreeParams(**kw), jp.TreeParams(**kw)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jtp)
    assert tp.effective_capacity_factor == jtp.effective_capacity_factor
    assert tp.effective_import_list_cap() == jtp.effective_import_list_cap()
    for n in (100, 5000, 1 << 21, 4_000_000):
        assert tp.capacity(n) == jtp.capacity(n)
        assert tp.octet_capacity(n) == jtp.octet_capacity(n)
        assert tp.effective_walk_tile(n) == jtp.effective_walk_tile(n)
    assert tp.let_forest_cap(8, 1000) == jtp.let_forest_cap(8, 1000)
    record = {"kind": "tree", **dataclasses.asdict(jtp)}
    assert params_from_dict(record) == tp
    assert params_from_dict(dataclasses.asdict(jp.SimParams(particle_num=7))) == SimParams(
        particle_num=7
    )
    with pytest.raises(ValueError, match="kind"):
        params_from_dict({"kind": "octree"})
