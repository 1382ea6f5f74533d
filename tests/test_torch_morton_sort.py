"""PyTorch port, the sort stage of a tree step: packed Morton keys, their
stable sort, the reorder and the split levels, held against the JAX package.

On the card the stage runs the key kernel (``csrc/morton_keys.cu``), CUB's
radix sort and the reorder kernel of ``csrc/tree_build.cu``; here the
wrappers take their plain versions, which must give the JAX package's
integers: its (hi, lo) keys out of the packed key, its permutation (ties in
index order), its split levels, its sorted state and, from the packed key,
its arena. Every check but the arena's float payloads is exact.
``chip_smoke.py`` (phase 9f) holds the kernels against these plain versions
on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_n_body_tpu import params as jp
from wgpu_n_body_tpu.ops import morton as jax_morton
from wgpu_n_body_tpu.ops import tree_build as jax_build
from wgpu_n_body_tpu_torch.ops import morton, morton_cuda, tree_build_cuda
from wgpu_n_body_tpu_torch.ops.tree_build import build_tree, morton_order, morton_sort, reorder
from wgpu_n_body_tpu_torch.ops.tree_walk_group import tile_setup
from wgpu_n_body_tpu_torch.params import ParticleState, TreeParams, state_from_numpy

DEPTHS = [1, 5, 10, 11, 16, 20]  # 10: d_lo = 0; 11: the first lo level; 20: 60-bit keys
SCENES = ["duplicates", "faces", "span3"]
# node payloads: float64 prefix sums here, float-float in JAX (tests/test_torch_tree_build.py)
NODE_TOL = dict(rtol=1e-6, atol=0)


def _np_state(scene, depth, n=400, seed=7):
    """A numpy state of n bodies:
    duplicates: uniform, an eighth of them exact copies of others (ties);
    faces:      every coordinate on a cell face of level ``depth`` of the
                unit root, a quarter of them one float32 step below one,
                and the root's own faces -1 and 1 (the clamped top cell);
    span3:      uniform in [-3, 3]^3 (bound above 1)."""
    rng = np.random.default_rng(seed + depth)
    if scene == "faces":
        cells = rng.integers(0, 2**depth + 1, (n, 3))
        pos = (cells * (2.0 / 2**depth) - 1.0).astype(np.float32)
        below = rng.random((n, 3)) < 0.25
        pos[below] = np.nextafter(pos[below], np.float32(-np.inf))
        pos = np.clip(pos, np.float32(-1), np.float32(1))
        pos[:2] = [[-1, -1, -1], [1, 1, 1]]
    else:
        pos = rng.uniform(-3 if scene == "span3" else -1, 3 if scene == "span3" else 1,
                          (n, 3)).astype(np.float32)
        if scene == "duplicates":
            pos[n // 2 : n // 2 + n // 8] = pos[: n // 8]
    return {
        "pos": pos,
        "vel": rng.uniform(-0.01, 0.01, (n, 3)).astype(np.float32),
        "acc": rng.uniform(-0.01, 0.01, (n, 3)).astype(np.float32),
        "mass": rng.uniform(0.5, 2.0, n).astype(np.float32),
    }


def _i64(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("depth", DEPTHS)
def test_packed_order_equals_jax(scene, depth):
    s = _np_state(scene, depth)
    perm, bound, keys = morton_order(torch.from_numpy(s["pos"]), depth)
    jperm, jbound, (jhi, jlo) = jax_build.morton_order(jnp.asarray(s["pos"]), depth)
    assert perm.dtype == torch.int32 and keys.dtype == torch.int64
    assert float(bound) == float(jbound)
    np.testing.assert_array_equal(perm.numpy(), _i64(jperm))
    hi, lo = morton.unpack_keys(keys, depth)
    np.testing.assert_array_equal(hi.numpy(), _i64(jhi))
    np.testing.assert_array_equal(lo.numpy(), _i64(jlo))
    assert int(keys.max()) < 2 ** (3 * depth) and bool((keys[1:] >= keys[:-1]).all())
    # the packed key is the JAX pair's concatenation, and packs back
    assert torch.equal(morton.pack_keys(hi, lo, depth), keys)
    if scene == "duplicates":
        assert bool((keys[1:] == keys[:-1]).any())  # ties exist and kept index order


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("depth", DEPTHS)
def test_split_levels_of_the_packed_key_equal_jax(scene, depth):
    s = _np_state(scene, depth)
    _, _, (jhi, jlo) = jax_build.morton_order(jnp.asarray(s["pos"]), depth)
    want = _i64(jax_morton.split_levels(jhi, jlo, depth))
    keys = morton.pack_keys(torch.from_numpy(_i64(jhi)), torch.from_numpy(_i64(jlo)), depth)
    np.testing.assert_array_equal(morton.split_levels(keys, depth).numpy(), want)
    # window[i]: first level where key[i] and key[i+b] differ = min(split[i+1 .. i+b])
    for b in (1, 4, 16):
        win = morton.window_levels(keys, depth, b).numpy()
        n = keys.shape[0]
        ref = [want[i + 1 : i + b + 1].min() for i in range(n - b)] + [0] * b
        np.testing.assert_array_equal(win, ref)


@pytest.mark.parametrize("depth", [5, 16, 20])
def test_sorted_state_equals_jax(depth):
    s = _np_state("duplicates", depth)
    jss, jbound, jkeys = jax_build.morton_sort(
        jp.ParticleState(**{k: jnp.asarray(v) for k, v in s.items()}), depth)
    ss, bound, keys = morton_sort(state_from_numpy(**s, device="cpu"), depth)
    for name in ("pos", "vel", "acc", "mass"):
        np.testing.assert_array_equal(getattr(ss, name).numpy(), np.asarray(getattr(jss, name)))
    hi, lo = morton.unpack_keys(keys, depth)
    np.testing.assert_array_equal(hi.numpy(), _i64(jkeys[0]))
    np.testing.assert_array_equal(lo.numpy(), _i64(jkeys[1]))


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("depth", [5, 11, 16, 20])
def test_arena_from_the_packed_key_equals_jax(scene, depth):
    kw = {"max_depth": depth, "leaf_bucket": 2, "walk": "per_particle", "walk_engine": "skip"}
    s = _np_state(scene, depth)
    jss, jbound, jkeys = jax_build.morton_sort(
        jp.ParticleState(**{k: jnp.asarray(v) for k, v in s.items()}), depth)
    jt = jax_build.build_tree(jss, jkeys, jbound, jp.TreeParams(**kw))
    tp = TreeParams(**kw)
    ss, tt = tree_build_cuda.build_tree_cuda(
        state_from_numpy(**s, device="cpu"), *_order(s["pos"], depth), tp)
    for field in ("skip", "first", "count", "num_nodes", "overflowed"):
        np.testing.assert_array_equal(getattr(tt, field).numpy(), np.asarray(getattr(jt, field)),
                                      err_msg=field)
    assert float(tt.root_width) == float(jt.root_width)
    np.testing.assert_allclose(tt.nodes_f32.numpy(), np.asarray(jt.nodes_f32), **NODE_TOL)
    np.testing.assert_array_equal(tt.split.numpy(), _i64(jax_morton.split_levels(*jkeys, depth)))


def _order(pos, depth):
    """(perm, keys, bound) of numpy positions, in the build wrapper's order."""
    perm, bound, keys = morton_order(torch.from_numpy(pos), depth)
    return perm, keys, bound


def test_wrappers_on_cpu_are_the_plain_versions_and_launch_nothing():
    s = _np_state("duplicates", 16)
    state = state_from_numpy(**s, device="cpu")
    tp = TreeParams(walk="per_particle")
    before = (morton_cuda.LAUNCHES, tree_build_cuda.LAUNCHES, tree_build_cuda.LAUNCHES_REORDER)
    perm, bound, keys = morton_cuda.morton_order_cuda(state.pos, 16)
    want = morton_order(state.pos, 16)
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip((perm, bound, keys), want))
    ss, split, window = tree_build_cuda.reorder_cuda(state, perm, keys, tp)
    assert all(torch.equal(a, b) for a, b in zip(ss, reorder(state, perm)))
    assert split.dtype == window.dtype == torch.uint8
    assert torch.equal(split.long(), morton.split_levels(keys, 16))
    assert torch.equal(window.long(), morton.window_levels(keys, 16, tp.leaf_bucket))
    ss2, tree = tree_build_cuda.build_tree_cuda(state, perm, keys, bound, tp)
    assert all(torch.equal(a, b) for a, b in zip(ss2, ss)) and torch.equal(tree.split, split)
    assert (morton_cuda.LAUNCHES, tree_build_cuda.LAUNCHES,
            tree_build_cuda.LAUNCHES_REORDER) == before


def test_other_devices_and_inputs_raise():
    s = _np_state("span3", 16, n=50)
    pos = torch.from_numpy(s["pos"])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        morton_cuda.morton_keys_cuda(pos.to("meta"), 16)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        morton_cuda.sort_keys_cuda(torch.zeros(50, dtype=torch.int64, device="meta"),
                                   torch.zeros(50, dtype=torch.int32, device="meta"), 16)
    with pytest.raises(TypeError, match="pos must be torch.float32"):
        morton_cuda.morton_order_cuda(pos.double(), 16)
    with pytest.raises(ValueError, match="max_depth"):
        morton_cuda.morton_order_cuda(pos, 21)
    with pytest.raises(TypeError, match="index must be torch.int32"):
        morton_cuda.sort_keys_cuda(torch.zeros(50, dtype=torch.int64),
                                   torch.zeros(50, dtype=torch.int64), 16)
    state = state_from_numpy(**s, device="cpu")
    perm, bound, keys = morton_order(pos, 16)
    meta = ParticleState(*(t.to("meta") for t in state))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tree_build_cuda.reorder_cuda(meta, perm.to("meta"), keys.to("meta"), TreeParams())
    with pytest.raises(TypeError, match="perm must be torch.int32"):
        tree_build_cuda.build_tree_cuda(state, perm.long(), keys, bound, TreeParams())


def test_tiles_from_the_builds_split_levels_equal_the_recomputed_ones():
    s = _np_state("duplicates", 10, n=700)
    tp = TreeParams(max_depth=10, walk_tile=32)
    ss, bound, keys = morton_sort(state_from_numpy(**s, device="cpu"), 10)
    tree = build_tree(ss, keys, bound, tp)
    for a, b in ((0, 700), (100, 428)):
        want = tile_setup(keys[a:b], b - a, tp)
        got = tile_setup(keys[a:b], b - a, tp, split=tree.split[a:b])
        for x, y in zip(got, want):
            assert torch.equal(x, y) if torch.is_tensor(x) else x == y


def test_highest_bit_is_exact_to_60_bits():
    v = torch.tensor([0, 1, 7, 8, (1 << 32) - 1, 1 << 32, (1 << 53) + 1, (1 << 54) - 1,
                      (1 << 60) - 1, (1 << 60) | 5, (1 << 62) + (1 << 40)])
    want = [max(int(x).bit_length() - 1, 0) for x in v]
    assert morton.highest_bit(v).tolist() == want


def test_stage_bytes_are_the_hand_count():
    # key kernel, n = 10: 10 * (12 pos + 8 key + 4 index) + 4 + 4 (min, max) + 4 (bound)
    assert morton_cuda.key_bytes(10) == 240 + 12 == 252
    # reorder, n = 10: 10 * (4 perm + 40 state + 8 key read, 40 state + 2 levels written)
    assert tree_build_cuda.reorder_bytes(10) == 940
    assert tree_build_cuda.reorder_bytes(4_000_000) == 376_000_000
