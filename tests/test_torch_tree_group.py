"""PyTorch port, group walk: the tile partition, the plain group walk and
its kernel wrapper on the CPU, fed the same numpy state as the JAX
package's ``group_tree_forces`` (skip engine, one pass: what the JAX
package runs on the CPU) and held against it.

Integers (tile ids, adaptive-cell depths, static budgets, deferral
counts) must be equal. Forces carry ``tests/test_tree_group.py``'s
tolerances. The kernel itself is checked on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_n_body_tpu import params as jp
from wgpu_n_body_tpu.ops import tree_build as jax_build
from wgpu_n_body_tpu.ops.tree_walk_group import _tile_assignment as jax_tile_assignment
from wgpu_n_body_tpu.ops.tree_walk_group import group_tree_forces as jax_group_tree_forces
from wgpu_n_body_tpu_torch.ops import morton, tree_walk_cuda, tree_walk_group_cuda
from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_dense
from wgpu_n_body_tpu_torch.ops.tree_build import build_tree, morton_order, morton_sort
from wgpu_n_body_tpu_torch.ops.tree_walk import tree_forces
from wgpu_n_body_tpu_torch.ops.tree_walk_group import (
    _tile_assignment,
    _window,
    group_tree_forces,
    group_walk_tiles,
    step_budget,
    tile_setup,
)
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams, state_from_numpy

# tests/test_tree_group.py:52 (theta=0 against the all-pairs sum) and the
# plain walk against JAX: the same rows, float32 sums in another order
THETA0_TOL = dict(rtol=2e-4, atol=1e-8)
JAX_TOL = dict(rtol=1e-4, atol=1e-8)

DEPTH = 10


def _np_state(seed, n, kind="uniform"):
    """n bodies in [-1, 1]^3 (``clustered``: half of them in a 1e-3 ball,
    ``duplicates``: a quarter exact copies), masses U[0.5, 2]."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3))
    if kind == "clustered":
        pos[: n // 2] = 0.3 + pos[: n // 2] * 1e-3
    if kind == "duplicates":
        pos[n // 2 : n // 2 + n // 4] = pos[: n // 4]
    z = np.zeros((n, 3), np.float32)
    return {"pos": pos.astype(np.float32), "vel": z, "acc": z,
            "mass": rng.uniform(0.5, 2.0, n).astype(np.float32)}


def _tp(**kw):
    """The same TreeParams in both packages: the small walk of
    tests/test_tree_group.py, skip engine."""
    kw = {"max_depth": DEPTH, "walk_tile": 32, "walk_list_cap": 2048,
          "walk_engine": "skip", **kw}
    return jp.TreeParams(**kw), TreeParams(**kw)


def _sim_params(n, g=1e-3):
    return jp.SimParams(particle_num=n, g=g), SimParams(particle_num=n, g=g)


def _jax_walk(s, gid=None, **tp_kw):
    """JAX group walk of the sorted state: (acc of receivers ``gid`` (a
    slice of the sorted order, default all), deferred)."""
    jtp, _ = _tp(**tp_kw)
    n = s["pos"].shape[0]
    st = jp.ParticleState(**{k: jnp.asarray(v) for k, v in s.items()})
    ss, bound, keys = jax_build.morton_sort(st, jtp.max_depth)
    tree = jax_build.build_tree(ss, keys, bound, jtp)
    gid = gid or slice(0, n)
    acc, stats = jax_group_tree_forces(
        ss.pos[gid], ss.pos, ss.mass, tree, (keys[0][gid], keys[1][gid]),
        _sim_params(n)[0], jtp, gid_offset=gid.start,
    )
    return np.asarray(acc), int(stats.deferred)


def _port(s, **tp_kw):
    """The port's sorted state, tree and keys."""
    _, ttp = _tp(**tp_kw)
    ss, bound, keys = morton_sort(state_from_numpy(**s, device="cpu"), ttp.max_depth)
    return ss, build_tree(ss, keys, bound, ttp), keys, ttp


SCENE = _np_state(0, 300)  # the scene of the JAX engine comparison (ROADMAP C)


@pytest.fixture(scope="module")
def jax_skip():
    """JAX skip-engine forces and deferral counts of SCENE at two thetas."""
    return {theta: _jax_walk(SCENE, theta=theta) for theta in (0.1, 0.75)}


# ---------------------------------------------------------------- tiles


@pytest.mark.parametrize("kind", ["uniform", "clustered", "duplicates"])
@pytest.mark.parametrize("g", [1, 16, 32, 100, 256, 512])  # 256, 512: the defaults
def test_tile_assignment_equals_jax(kind, g):
    n = 700 if g <= 100 else 2048
    s = _np_state(1, n, kind)
    _, _, keys = morton_order(torch.from_numpy(s["pos"]), DEPTH)
    hi, lo = morton.unpack_keys(keys, DEPTH)
    want = jax_tile_assignment(
        (jnp.asarray(hi.numpy(), jnp.uint32), jnp.asarray(lo.numpy(), jnp.uint32)),
        n, DEPTH, g, 64,
    )
    got = _tile_assignment(morton.split_levels(keys, DEPTH), n, DEPTH, g, 64)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # tile_id
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))  # lstar
    assert got[2:] == tuple(want[2:])  # t_cap, t_blk, ta_blk
    if kind == "clustered" and g in (32, 512):
        assert got[1].max() > got[1].min() + 3  # the cluster's cells are deeper


def _pileup_state(seed, n):
    """n bodies, 3000 of them exact copies of one point: one overfull cell at
    max_depth, whose receivers make one tile group longer than a block of
    2048 receivers."""
    s = _np_state(seed, n)
    s["pos"][n - 3000 :] = s["pos"][0]
    return s


# block edges (2048 receivers, and csrc/tile_setup.cu's 4096):
# n at and past a multiple of the block, a group longer than a block, n < g,
# walk_tile 1
@pytest.mark.parametrize("n, g, kind", [
    (2048, 256, "uniform"), (2049, 256, "uniform"), (4097, 512, "clustered"),
    (5000, 32, "pileup"), (5000, 512, "pileup"), (5000, 1, "pileup"),
    (300, 512, "uniform"), (17, 32, "duplicates"),
])
def test_tile_assignment_edges_equal_jax(n, g, kind):
    s = _pileup_state(8, n) if kind == "pileup" else _np_state(8, n, kind)
    _, _, keys = morton_order(torch.from_numpy(s["pos"]), DEPTH)
    hi, lo = morton.unpack_keys(keys, DEPTH)
    want = jax_tile_assignment(
        (jnp.asarray(hi.numpy(), jnp.uint32), jnp.asarray(lo.numpy(), jnp.uint32)),
        n, DEPTH, g, 64,
    )
    split = morton.split_levels(keys, DEPTH)
    got = _tile_assignment(split, n, DEPTH, g, 64)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # tile_id
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))  # lstar
    assert got[2:] == tuple(want[2:])  # t_cap, t_blk, ta_blk
    # the same tiles from the build's one-byte split levels
    t8 = tile_setup(None, n, TreeParams(max_depth=DEPTH, walk_tile=g), split=split.to(torch.uint8))
    assert (t8.tile_id.dtype, t8.slot.dtype) == (torch.int64, torch.int32)
    np.testing.assert_array_equal(t8.tile_id.numpy(), np.minimum(np.asarray(want[0]), t8.t_cap - 1))
    if kind == "pileup":  # the pile-up's max-depth cell: one group longer than a block
        assert (np.asarray(want[1]) == DEPTH).sum() > 2048


def _np_tiles(s, n, depth, g, t_cap):
    """The tile rules in numpy, one receiver at a time: (tile_id, slot,
    piece_start, piece_len, deferred)."""
    s = s.astype(np.int64)
    if g == 1:
        lstar = np.full(n, depth)
    elif n < g:
        lstar = np.zeros(n, np.int64)
    else:
        shared = np.lib.stride_tricks.sliding_window_view(s[1:], g - 1).min(1) - 1  # a in [0, n-g]
        lstar = np.array([shared[max(0, i - g + 1) : min(i, n - g) + 1].max(initial=-1)
                          for i in range(n)])
        lstar = np.clip(lstar, 0, depth)
    tile_raw, rs, t = np.zeros(n, np.int64), -1, -1
    for i in range(n):
        start = i == 0 or lstar[i] != lstar[i - 1] or s[i] <= lstar[i]
        rs = i if start else rs
        t += start or (i - rs) % g == 0
        tile_raw[i] = t
    tile_id = np.minimum(tile_raw, t_cap - 1)
    piece_start = np.array([np.searchsorted(tile_id, k) for k in range(t_cap)])
    piece_len = np.diff(np.append(piece_start, n))
    slot = np.arange(n) - piece_start[tile_id]
    return tile_id, slot, piece_start, piece_len, (tile_raw >= t_cap) | (slot >= g)


@pytest.mark.parametrize("levels", ["random", "zero"])
def test_tiles_spilling_past_the_budget_follow_the_rules(levels):
    # split levels that start a group at most receivers: far more tiles than
    # t_cap, merged into the last tile and deferred. JAX needs keys, so a
    # numpy loop of the same rules is the reference.
    n, g = 3000, 32
    rng = np.random.default_rng(9)
    s = rng.integers(0, 4, n) if levels == "random" else np.zeros(n, np.int64)
    s[0] = 0
    tp = TreeParams(max_depth=DEPTH, walk_tile=g)
    got = tile_setup(None, n, tp, split=torch.from_numpy(s.astype(np.uint8)))
    want = _np_tiles(s, n, DEPTH, g, got.t_cap)
    for field, w in zip(("tile_id", "slot", "piece_start", "piece_len", "deferred"), want):
        np.testing.assert_array_equal(getattr(got, field).numpy(), w, err_msg=field)
    assert want[4].sum() > n // 4  # many receivers spilled


def test_window_is_a_sliding_min_and_max():
    x = torch.from_numpy(np.random.default_rng(2).integers(-50, 50, 300))
    for w in (1, 2, 5, 64, 255, 300):
        for op, red in ((torch.minimum, np.min), (torch.maximum, np.max)):
            want = [red(x.numpy()[a : a + w]) for a in range(300 - w + 1)]
            assert _window(x, w, op).tolist() == want


def test_tile_setup_covers_every_receiver_once():
    ss, _, keys, ttp = _port(_np_state(3, 500, "clustered"))
    t = tile_setup(keys, 500, ttp)
    start, length = t.piece_start.long(), t.piece_len.long()
    assert int(length.sum()) == 500 and (length <= t.g).all() and not t.deferred.any()
    np.testing.assert_array_equal((start[t.tile_id] + t.slot).numpy(), np.arange(500))
    assert t.r_cap == 4096 and t.t_cap % 32 == 0



# ------------------------------------------- the tile kernel's decomposition
# A model of csrc/tile_setup.cu's design, in numpy at blocks of K receivers
# (the kernel's are thousands; K this small cuts groups and spreads a
# max-depth pile-up over many blocks): the van Herk / Gil-Werman windows of
# each block over its split levels with a halo, the block summaries
# (first group start, last group start, breaks from the first start on, the
# span) scanned as the last scan block scans them (a contiguous run per
# thread, the runs composed in order, each run absorbed from the state
# before it) into the state before each block, then each receiver's tile,
# slot and the pieces from that state alone.

_MIN, _MAX = (np.minimum, 0xFF), (np.maximum, 0)


def _vh_window(x, w, op):
    """y[k] = op(x[k : k + w]) for k in [0, len(x) - w], as the kernel takes
    it: directly below 8 bytes, else from prefix and suffix ops over
    segments of w & ~3 bytes (whole words) from byte 0, with one more
    combine where w is not a multiple of 4."""
    fn, _ = op
    n_out = len(x) - w + 1
    if w < 8:
        return fn.reduce(np.stack([x[c : c + n_out] for c in range(w)]), axis=0)
    wp, e = w & ~3, w - (w & ~3)
    seg = np.arange(len(x)) // wp
    pre, suf = x.copy(), x.copy()
    for k in range(1, len(x)):
        if seg[k] == seg[k - 1]:
            pre[k] = fn(pre[k - 1], x[k])
    for k in range(len(x) - 2, -1, -1):
        if seg[k] == seg[k + 1]:
            suf[k] = fn(suf[k + 1], x[k])
    k = np.arange(n_out)
    y = fn(suf[k], pre[k + wp - 1])
    return fn(y, fn(suf[k + e], pre[k + e + wp - 1])) if e else y


def _block_lstar(s, n, depth, g, base, k_items):
    """lstar of receivers base - 1 .. base + k_items - 1 (entry v is
    receiver base - 1 + v), from the block's split levels and halos alone."""
    if g == 1 or n < g:
        return np.full(k_items + 1, depth if g == 1 else 0)
    h = (g + 3) & ~3
    x = np.zeros(k_items + 2 * h, np.int64)
    j = np.arange(base - h, base + k_items + h)
    inside = (j >= 0) & (j < n)
    x[inside] = s[j[inside]]
    vh = _vh_window(x, g - 1, _MIN)  # vh[p] = min(x[p : p + g - 1])
    u = np.arange(k_items + g)
    y = np.where((u >= g - base) & (u <= n - base), vh[u + 1 + h - g], 0)
    return np.clip(_vh_window(y, g, _MAX)[: k_items + 1] - 1, 0, depth)


def _count_breaks(a, b, rs, g):
    """The i in [a, b) with (i - rs) % g == 0."""
    if b <= a:
        return 0
    first = a + (-(a - rs)) % g
    return (b - 1 - first) // g + 1 if first < b else 0


_NONE = None  # the empty span's summary


def _compose(a, b, g):
    """The summary (first start or -1, last start, breaks in [first, hi),
    lo, hi) of span a followed by span b."""
    if a is _NONE or b is _NONE:
        return b if a is _NONE else a
    if a[0] < 0:
        return (b[0], b[1], b[2], a[3], b[4])
    k = a[2] + _count_breaks(b[3], b[0] if b[0] >= 0 else b[4], a[1], g)
    return (a[0], b[1] if b[0] >= 0 else a[1], k + (b[2] if b[0] >= 0 else 0), a[3], b[4])


def _absorb(state, a, g):
    """The state (last group start mod g, breaks so far) after span a."""
    if a is _NONE:
        return state
    rs, t = state
    t += _count_breaks(a[3], a[0] if a[0] >= 0 else a[4], rs, g)
    return ((a[1] % g, t + a[2]) if a[0] >= 0 else (rs, t))


def _block_summary(starts, lo, hi, g):
    """A span's summary from its group starts (a bool per receiver)."""
    idx = np.flatnonzero(starts) + lo
    if not len(idx):
        return (-1, -1, 0, lo, hi)
    k, rs = 0, idx[0]
    for i in range(idx[0], hi):
        rs = i if starts[i - lo] else rs
        k += starts[i - lo] or (i - rs) % g == 0
    return (int(idx[0]), int(idx[-1]), k, lo, hi)


def _model_tiles(s, n, depth, g, t_cap, k_items, threads=4):
    """(tile_id, slot, piece_start, piece_len, deferred) by the kernel's
    decomposition into blocks of k_items receivers, whose summaries
    ``threads`` lanes scan."""
    s = np.asarray(s, np.int64)
    blocks = max(1, -(-n // k_items))
    starts, sums = [], []
    for b in range(blocks):
        lo, hi = b * k_items, min(n, (b + 1) * k_items)
        ls = _block_lstar(s, n, depth, g, lo, k_items)
        i = np.arange(lo, hi)
        st = (i == 0) | (ls[1 : hi - lo + 1] != ls[: hi - lo]) | (s[lo:hi] <= ls[1 : hi - lo + 1])
        starts.append(st)
        sums.append(_block_summary(st, lo, hi, g))
    # each block's state: a run of summaries per lane; a lane's run starts
    # from the composed runs before it, absorbed into the initial state
    per = -(-blocks // threads)
    ins, before = [], _NONE
    for k0 in range(0, blocks, per):
        state = _absorb((0, 0), before, g)
        for summ in sums[k0 : k0 + per]:
            ins.append(state)
            state = _absorb(state, summ, g)
            before = _compose(before, summ, g)
    tile = np.zeros(n, np.int64)
    slot = np.zeros(n, np.int64)
    piece_start, piece_len = np.full(t_cap, -1), np.full(t_cap, -1)
    p0 = None
    for b, (st, (rs, t)) in enumerate(zip(starts, ins)):
        for e, i in enumerate(range(b * k_items, min(n, (b + 1) * k_items))):
            prev_rs = rs
            rs = i if st[e] else rs
            brk = st[e] or (i - rs) % g == 0
            t += brk
            tile[i], slot[i] = t - 1, (i - rs) % g
            prev = i - 1 - (i - 1 - prev_rs) % g if st[e] else i - g  # the previous break
            if brk and t - 1 < t_cap:
                piece_start[t - 1] = i
                if t - 1 > 0:
                    piece_len[t - 2] = i - prev
            elif brk and t - 1 == t_cap:  # the first spill
                piece_len[t_cap - 1], p0 = n - prev, prev
            if i == n - 1 and t - 1 < t_cap:
                piece_len[t - 1] = n - (i - slot[i])
    used = min(state[1], t_cap)
    piece_start[used:], piece_len[used:] = n, 0
    spilled = tile >= t_cap
    if spilled.any():
        slot[spilled] = np.flatnonzero(spilled) - p0
    return np.minimum(tile, t_cap - 1), slot, piece_start, piece_len, spilled


@pytest.mark.parametrize("g", [1, 2, 3, 7, 64, 512])
@pytest.mark.parametrize("k_items", [12, 64])
def test_tile_kernel_model_equals_plain_and_jax(g, k_items):
    # a pile-up of 500 copies (one max-depth cell over many blocks) among
    # uniform bodies; n not a multiple of the block
    n = 1100
    s_np = _np_state(12, n)
    s_np["pos"][n - 500 :] = s_np["pos"][3]
    _, _, keys = morton_order(torch.from_numpy(s_np["pos"]), DEPTH)
    split = morton.split_levels(keys, DEPTH)
    tp = TreeParams(max_depth=DEPTH, walk_tile=g)
    want = tile_setup(None, n, tp, split=split.to(torch.uint8))
    got = _model_tiles(split.numpy(), n, DEPTH, g, want.t_cap, k_items)
    for field, x in zip(("tile_id", "slot", "piece_start", "piece_len", "deferred"), got):
        np.testing.assert_array_equal(x, getattr(want, field).numpy(), err_msg=field)
    hi, lo = morton.unpack_keys(keys, DEPTH)
    jax_tile = jax_tile_assignment(
        (jnp.asarray(hi.numpy(), jnp.uint32), jnp.asarray(lo.numpy(), jnp.uint32)),
        n, DEPTH, g, 64)[0]
    np.testing.assert_array_equal(got[0], np.minimum(np.asarray(jax_tile), want.t_cap - 1))
    # 501 equal keys: 500 receivers whose key equals the one before, one group
    assert (split.numpy() > DEPTH).sum() == 500 and not want.deferred.any()


@pytest.mark.parametrize("levels, g", [("random", 32), ("zero", 8), ("zero", 32)])
def test_tile_kernel_model_spills_like_the_plain_version(levels, g):
    n = 700
    rng = np.random.default_rng(13)
    s = rng.integers(0, 4, n) if levels == "random" else np.zeros(n, np.int64)
    tp = TreeParams(max_depth=DEPTH, walk_tile=g)
    want = tile_setup(None, n, tp, split=torch.from_numpy(s.astype(np.uint8)))
    got = _model_tiles(s, n, DEPTH, g, want.t_cap, 16)
    for field, x in zip(("tile_id", "slot", "piece_start", "piece_len", "deferred"), got):
        np.testing.assert_array_equal(x, getattr(want, field).numpy(), err_msg=field)
    assert got[4].sum() > n // 8


@pytest.mark.parametrize("g", [2, 7, 64])
def test_tile_kernel_summaries_compose_associatively(g):
    # summaries of adjacent spans of one sequence of group starts: composing
    # them in any grouping, or absorbing them one by one into a state, gives
    # what the whole span gives
    rng = np.random.default_rng(g)
    starts = rng.random(400) < 0.03
    starts[[0, 150, 151]] = True
    starts[200:330] = False  # a span with no start at all
    cuts = [0, 37, 150, 200, 260, 330, 400]
    spans = [_block_summary(starts[a:b], a, b, g) for a, b in zip(cuts, cuts[1:])]
    whole = _block_summary(starts, 0, 400, g)
    for a, b, c in zip(spans, spans[1:], spans[2:]):
        assert _compose(_compose(a, b, g), c, g) == _compose(a, _compose(b, c, g), g)
    folded = _NONE
    for x in spans:
        folded = _compose(folded, x, g)
    assert folded == whole
    for state in ((0, 0), (g - 1, 5)):
        one_by_one = state
        for x in spans:
            one_by_one = _absorb(one_by_one, x, g)
        assert one_by_one == _absorb(state, whole, g)


# ---------------------------------------------------------------- forces


@pytest.mark.parametrize("theta", [0.1, 0.75])
def test_forces_match_jax_skip_engine(theta, jax_skip):
    want, want_def = jax_skip[theta]
    ss, tree, keys, ttp = _port(SCENE, theta=theta)
    _, params = _sim_params(300)
    got, stats = group_tree_forces(ss.pos, ss.pos, ss.mass, tree, keys, params, ttp)
    assert stats.deferred.dtype == torch.int32 and stats.deferred.shape == ()
    assert int(stats.deferred) == want_def == 0
    np.testing.assert_allclose(got.numpy(), want, **JAX_TOL)


@pytest.mark.parametrize("bucket", [1, 16])
def test_theta_zero_equals_naive(bucket):
    n = 200  # not a multiple of the tile: ragged last tiles
    ss, tree, keys, ttp = _port(_np_state(4, n), theta=0.0, leaf_bucket=bucket)
    _, params = _sim_params(n)
    got, stats = group_tree_forces(ss.pos, ss.pos, ss.mass, tree, keys, params, ttp)
    assert int(stats.deferred) == 0
    torch.testing.assert_close(got, naive_forces_dense(ss.pos, ss.pos, ss.mass, params),
                               **THETA0_TOL)


def test_full_deferral_is_exact_and_equals_per_particle_walk():
    # every tile overflows its step budget: all receivers take the
    # per-particle walk, and the answer stays the exact all-pairs sum
    n = 256
    ss, tree, keys, ttp = _port(_np_state(5, n), theta=0.0, walk_list_cap=128, leaf_bucket=1)
    _, params = _sim_params(n)
    tiles = tile_setup(keys, n, ttp)
    _, bad, steps, _ = group_walk_tiles(ss.pos, ss.pos, ss.mass, tree, tiles, params, ttp)
    nt = int((tiles.piece_len > 0).sum())
    assert bad[:nt].all() and (steps[:nt] == tiles.r_cap).all() and not bad[nt:].any()
    got, stats = group_tree_forces(ss.pos, ss.pos, ss.mass, tree, keys, params, ttp)
    assert int(stats.deferred) == n
    torch.testing.assert_close(got, naive_forces_dense(ss.pos, ss.pos, ss.mass, params),
                               **THETA0_TOL)
    torch.testing.assert_close(
        got, tree_forces(ss.pos, ss.pos, ss.mass, tree, params, ttp), rtol=0, atol=0
    )


def test_partial_deferral_matches_jax():
    # a budget some tiles of the clustered scene overflow and others keep
    s = _np_state(6, 300, "clustered")
    want, want_def = _jax_walk(s, theta=0.5, walk_list_cap=128)
    ss, tree, keys, ttp = _port(s, theta=0.5, walk_list_cap=128)
    _, params = _sim_params(300)
    got, stats = group_tree_forces(ss.pos, ss.pos, ss.mass, tree, keys, params, ttp)
    assert 0 < int(stats.deferred) == want_def < 300
    np.testing.assert_allclose(got.numpy(), want, **JAX_TOL)


def test_group_walk_is_at_least_as_accurate_as_per_particle():
    ss, tree, keys, ttp = _port(SCENE, theta=0.75)
    _, params = _sim_params(300)
    exact = naive_forces_dense(ss.pos.double(), ss.pos.double(), ss.mass.double(), params)
    scale = exact.norm(dim=1).mean()
    grp = group_tree_forces(ss.pos, ss.pos, ss.mass, tree, keys, params, ttp)[0]
    per = tree_forces(ss.pos, ss.pos, ss.mass, tree, params, ttp)
    err_grp = float((grp.double() - exact).abs().mean() / scale)
    err_per = float((per.double() - exact).abs().mean() / scale)
    assert err_grp <= 1.01 * err_per and err_grp < 0.03


# ---------------------------------------------------------------- wrapper


def test_tile_setup_cuda_on_cpu_is_the_plain_version_and_checks_its_input():
    ss, tree, keys, ttp = _port(_np_state(3, 500, "clustered"))
    before = tree_walk_group_cuda.LAUNCHES_TILES
    got = tree_walk_group_cuda.tile_setup_cuda(tree.split, 500, ttp)
    assert tree_walk_group_cuda.LAUNCHES_TILES == before
    for x, y in zip(got, tile_setup(keys, 500, ttp)):
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y
    with pytest.raises(TypeError, match="uint8"):
        tree_walk_group_cuda.tile_setup_cuda(tree.split.long(), 500, ttp)
    with pytest.raises(ValueError, match="shape"):
        tree_walk_group_cuda.tile_setup_cuda(tree.split, 499, ttp)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tree_walk_group_cuda.tile_setup_cuda(tree.split.to("meta"), 500, ttp)


@pytest.mark.parametrize("list_cap", [2048, 128])
def test_wrapper_with_given_tiles_equals_its_own(list_cap):
    # the LET step makes the tiles once and hands them to both walks, each
    # with its own step budget
    ss, tree, keys, ttp = _port(_np_state(6, 300, "clustered"), theta=0.5,
                                walk_list_cap=list_cap)
    _, params = _sim_params(300)
    want, want_stats = tree_walk_group_cuda.group_tree_forces_cuda(
        ss.pos, ss.pos, ss.mass, tree, keys, params, ttp)
    other = TreeParams(**{**ttp.__dict__, "walk_list_cap": 4096})
    tiles = tree_walk_group_cuda.tile_setup_cuda(tree.split, 300, other)
    got, stats = tree_walk_group_cuda.group_tree_forces_cuda(
        ss.pos, ss.pos, ss.mass, tree, keys, params, ttp,
        tiles=tiles._replace(r_cap=step_budget(list_cap)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(stats.deferred) == int(want_stats.deferred)
    assert (int(stats.deferred) > 0) == (list_cap == 128)
    with pytest.raises(ValueError, match="tiles of 300 receivers for 299"):
        tree_walk_group_cuda.group_tree_forces_cuda(
            ss.pos[:299], ss.pos, ss.mass, tree, keys[:299], params, ttp, tiles=tiles)


def test_wrapper_on_cpu_takes_plain_version_and_other_devices_raise():
    ss, tree, keys, ttp = _port(_np_state(7, 200), theta=0.6)
    _, params = _sim_params(200)
    before = (tree_walk_group_cuda.LAUNCHES, tree_walk_cuda.LAUNCHES)
    got, stats = tree_walk_group_cuda.group_tree_forces_cuda(
        ss.pos, ss.pos, ss.mass, tree, keys, params, ttp
    )
    assert (tree_walk_group_cuda.LAUNCHES, tree_walk_cuda.LAUNCHES) == before
    want, want_stats = group_tree_forces(ss.pos, ss.pos, ss.mass, tree, keys, params, ttp)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(stats.deferred) == int(want_stats.deferred)
    with pytest.raises(ValueError, match="several devices"):
        tree_walk_group_cuda.group_tree_forces_cuda(
            ss.pos.to("meta"), ss.pos, ss.mass, tree, keys, params, ttp
        )
    meta = [t.to("meta") for t in (ss.pos, ss.mass)]
    meta_tree = type(tree)(*(t.to("meta") if torch.is_tensor(t) else t for t in tree))
    meta_keys = keys.to("meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tree_walk_group_cuda.group_tree_forces_cuda(
            meta[0], meta[0], meta[1], meta_tree, meta_keys, params, ttp
        )
