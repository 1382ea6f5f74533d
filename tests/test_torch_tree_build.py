"""PyTorch port, octree build: the plain version against the JAX package on
the small and odd inputs the CUDA kernels must also get right, and the
kernel wrapper's CPU route, input checks and bytes bound.

The cases come from ``wgpu_n_body_tpu_torch/ops/tree_build_cases.py``;
``chip_smoke.py`` runs the kernels against the plain version on the same
ones on the card. Integers (skip, first, count, num_nodes, overflowed)
must be exactly equal; node payloads carry ``NODE_TOL``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_n_body_tpu import params as jp
from wgpu_n_body_tpu.ops import tree_build as jax_build
from wgpu_n_body_tpu_torch.ops import tree_build_cuda
from wgpu_n_body_tpu_torch.ops.tree_build import (
    NO_CHILD,
    build_tree,
    morton_order,
    morton_sort,
    prefix_sums,
    reorder,
)
from wgpu_n_body_tpu_torch.ops.tree_build_cases import build_cases
from wgpu_n_body_tpu_torch.params import ParticleState, TreeParams, state_from_numpy

# node payloads come from prefix-sum differences (float64 here, float-float
# in JAX): a few float32 ulp apart at most (tests/test_torch_tree.py)
NODE_TOL = dict(rtol=1e-6, atol=0)

CASES = {c.name: c for c in build_cases()}
ENGINE = {"walk": "per_particle", "walk_engine": "skip"}  # JAX: no octet tables


def _sorted(case):
    tp = TreeParams(**ENGINE, **case.tree_kw)
    ss, bound, keys = morton_sort(state_from_numpy(**case.state, device="cpu"), tp.max_depth)
    return ss, keys, bound, tp


def _unsorted(case):
    """(state in input order, perm, sorted keys, bound, params): what the
    build wrapper takes."""
    tp = TreeParams(**ENGINE, **case.tree_kw)
    state = state_from_numpy(**case.state, device="cpu")
    perm, bound, keys = morton_order(state.pos, tp.max_depth)
    return state, perm, keys, bound, tp


@pytest.mark.parametrize("name", list(CASES))
def test_plain_build_equals_jax(name):
    case = CASES[name]
    jtp = jp.TreeParams(**ENGINE, **case.tree_kw)
    jstate = jp.ParticleState(**{k: jnp.asarray(v) for k, v in case.state.items()})
    jss, jbound, jkeys = jax_build.morton_sort(jstate, jtp.max_depth)
    jt = jax_build.build_tree(jss, jkeys, jbound, jtp)
    ss, keys, bound, tp = _sorted(case)
    tt = build_tree(ss, keys, bound, tp)
    np.testing.assert_array_equal(ss.pos.numpy(), np.asarray(jss.pos))
    for field in ("skip", "first", "count", "num_nodes"):
        got = getattr(tt, field)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jt, field)), err_msg=field)
    assert bool(tt.overflowed) is bool(jt.overflowed) is (name == "overflow")
    assert float(tt.root_width) == float(jt.root_width)
    np.testing.assert_allclose(tt.nodes_f32.numpy(), np.asarray(jt.nodes_f32), **NODE_TOL)
    m, n = int(tt.num_nodes), ss.pos.shape[0]
    assert int(tt.count[0]) == n and int(tt.first[0]) == 0
    overfull = int((tt.nodes_f32[:m, NO_CHILD] == 2.0).sum())
    if name in ("n1", "below_bucket"):
        assert m == 1  # the root alone, a leaf
    if name == "one_point":
        # one chain of cells down to max_depth, the last one overfull
        assert m == tp.max_depth + 1 and overfull == 1
        assert tt.count[:m].tolist() == [n] * m
    if name in ("depth10", "depth20"):
        assert overfull > 0  # tight pairs share a max-depth cell
    if name == "overflow":
        assert m == tp.capacity(n) and int(tt.skip[:m].max()) > m  # skips stay unclamped


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    tree_build_cuda.LAUNCHES = 0
    for name in ("bucket32", "overflow", "n1"):
        state, perm, keys, bound, tp = _unsorted(CASES[name])
        got_ss, got = tree_build_cuda.build_tree_cuda(state, perm, keys, bound, tp)
        ss = reorder(state, perm)
        want = build_tree(ss, keys, bound, tp)
        assert all(torch.equal(a, b) for a, b in zip(got_ss, ss))
        for a, b in zip(got[:7], want[:7]):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b) or (torch.isnan(a) == torch.isnan(b)).all()
        assert got.octets is None and got.octet_pts is None
    assert tree_build_cuda.LAUNCHES == 0


def test_plain_build_takes_another_builds_sums():
    # what the card's check relies on: the plain version differenced from given sums
    state, perm, keys, bound, tp = _unsorted(CASES["bucket32"])
    ss = reorder(state, perm)
    want = build_tree(ss, keys, bound, tp)
    sums = prefix_sums(ss)
    assert sums.shape == (4, ss.pos.shape[0] + 1) and sums.dtype == torch.float64
    assert float(sums[0, -1]) == pytest.approx(float(ss.mass.double().sum()), rel=1e-14)
    got_ss, got, got_sums, _ = tree_build_cuda.build_tree_cuda_with_sums(
        state, perm, keys, bound, tp)
    assert torch.equal(got_sums, sums) and torch.equal(got_ss.mass, ss.mass)
    for tree in (got, build_tree(ss, keys, bound, tp, sums=sums)):
        for a, b in zip(tree[:7], want[:7]):
            assert torch.equal(a, b)
    # other sums give other totals: a tenth more mass everywhere
    heavier = build_tree(ss, keys, bound, tp, sums=sums * torch.tensor([[1.1], [1], [1], [1]]))
    m = int(want.num_nodes)
    torch.testing.assert_close(heavier.nodes_f32[:m, 3], 1.1 * want.nodes_f32[:m, 3],
                               rtol=1e-6, atol=0)
    assert torch.equal(heavier.skip, want.skip)


def _replaced(ss, **kw):
    return ParticleState(**{**ss._asdict(), **kw})


@pytest.mark.parametrize("what", ["keys_int32", "pos_float64", "mass_shape", "bound_python",
                                  "bound_shape", "pos_strided", "mixed_devices",
                                  "other_device", "depth", "bucket"])
def test_wrapper_rejects(what):
    ss, perm, keys, bound, tp = _unsorted(CASES["depth4"])
    n = ss.pos.shape[0]

    def call(ss, keys, bound, tp):
        return tree_build_cuda.build_tree_cuda(ss, perm, keys, bound, tp)

    if what == "keys_int32":
        with pytest.raises(TypeError, match=r"keys must be torch.int64"):
            call(ss, keys.to(torch.int32), bound, tp)
    elif what == "pos_float64":
        with pytest.raises(TypeError, match="pos must be torch.float32"):
            call(_replaced(ss, pos=ss.pos.double()), keys, bound, tp)
    elif what == "mass_shape":
        with pytest.raises(ValueError, match="mass must have shape"):
            call(_replaced(ss, mass=ss.mass[: n - 1]), keys, bound, tp)
    elif what == "bound_python":
        with pytest.raises(TypeError, match="bound must be a tensor"):
            call(ss, keys, float(bound), tp)
    elif what == "bound_shape":
        with pytest.raises(ValueError, match="bound must have shape"):
            call(ss, keys, bound[None], tp)
    elif what == "pos_strided":
        wide = torch.zeros((n, 4))
        wide[:, :3] = ss.pos
        with pytest.raises(ValueError, match="pos must be contiguous"):
            call(_replaced(ss, pos=wide[:, :3]), keys, bound, tp)
    elif what == "mixed_devices":
        with pytest.raises(ValueError, match="several devices"):
            call(ss, keys, bound.to("meta"), tp)
    elif what == "other_device":
        meta = ParticleState(*(t.to("meta") for t in ss))
        with pytest.raises(ValueError, match="takes CUDA or CPU tensors"):
            tree_build_cuda.build_tree_cuda(meta, perm.to("meta"), keys.to("meta"),
                                            bound.to("meta"), tp)
    elif what == "depth":
        with pytest.raises(ValueError, match="max_depth"):
            call(ss, keys, bound, TreeParams(max_depth=21))
    else:
        with pytest.raises(ValueError, match="leaf_bucket"):
            call(ss, keys, bound, TreeParams(leaf_bucket=0))


def test_build_bytes_is_the_hand_count():
    # n = 10 bodies, an arena of cap = 20 rows (+ the sentinel):
    #   read   10 * (8 packed key, 12 pos, 4 mass) + 4 (bound)        =  244
    #   prefix 11 entries * (4 float64 + 1 int32), written and read   =  792
    #   write  21 rows * (32 nodes_f32 + 3 * 4 ints) + 4 + 4 + 1      =  933
    assert tree_build_cuda.build_bytes(10, 20) == 244 + 792 + 933 == 1969
    n, cap = 4_000_000, TreeParams().capacity(4_000_000)
    assert cap == 2_000_001
    assert tree_build_cuda.build_bytes(n, cap) == 24 * n + 4 + 72 * (n + 1) + 44 * (cap + 1) + 9


def test_treesim_builds_through_the_wrapper(monkeypatch):
    from wgpu_n_body_tpu_torch.models import TreeSim, tree
    from wgpu_n_body_tpu_torch.params import SimParams

    calls = []

    def spy(*args):
        calls.append(args[0].pos.device.type)
        return tree_build_cuda.build_tree_cuda(*args)

    monkeypatch.setattr(tree, "build_tree_cuda", spy)
    sim = TreeSim(SimParams(particle_num=300), TreeParams(**CASES["depth4"].tree_kw))
    state = state_from_numpy(**CASES["depth4"].state, device="cpu")
    sim.make_step()(state)
    sim.check_overflow(state)
    assert sim.diagnose(state)["overflowed"] is False
    assert calls == ["cpu"] * 3  # the step, check_overflow and diagnose
