"""The plain reference against float64 all-pairs and plain rules on tiny
scenes. (The tests may import the program to compare with; the reference
itself does not.)"""

import numpy as np
import pytest
import torch

from nbody_bench import scenes
from nbody_bench.reference import octree, order, render, step

G, E, DT = 1e-3, 1e-4, 0.016


def _scene(name="uniform", n=300, seed=3):
    return scenes.draw(name, seed, n, G, torch.device("cpu"))


def test_allpairs_equals_a_float64_double_loop():
    pos, vel, acc, mass = _scene(n=64)
    recv = pos + 0.01
    idx = torch.tensor([0, 5, 63])
    got = step.allpairs(recv[idx], idx, pos, mass, G, E, DT, recv_block=2, src_block=16)
    p, m = pos.double().numpy(), mass.double().numpy()
    for row, i in enumerate(idx.tolist()):
        want = np.zeros(3)
        for j in range(64):
            if j == i:
                continue
            d = p[j] - recv[i].double().numpy()
            r = np.sqrt(d @ d)
            want += m[j] * G * DT / (r ** 3 + E) / r * d
        np.testing.assert_allclose(got[row].numpy(), want, rtol=1e-12)


def test_drift_and_kick_equal_the_programs_leapfrog_bit_for_bit():
    from wgpu_n_body_tpu_torch.ops.integrate import leapfrog_step
    from wgpu_n_body_tpu_torch.params import ParticleState, SimParams

    pos, vel, _, mass = _scene(n=500)
    acc = torch.randn(500, 3) * 1e-3
    force = torch.randn(500, 3) * 1e-3
    out = leapfrog_step(ParticleState(pos, vel, acc, mass), SimParams(500, G, E, DT),
                        lambda *a: force)
    vel_h, pos_new = step.drift(pos, vel, acc, DT)
    assert torch.equal(out.pos, pos_new)
    assert torch.equal(out.vel, step.kick(vel_h, force, DT))


@pytest.mark.parametrize("scene", ["uniform", "disc", "spherical"])
def test_morton_order_equals_the_programs_plain_order(scene):
    from wgpu_n_body_tpu_torch.ops.tree_build import morton_order

    pos = _scene(scene, n=2000)[0]
    perm, bound, keys = order.morton_order(pos, 16)
    p_perm, p_bound, p_keys = morton_order(pos, 16)
    assert torch.equal(perm, p_perm.long()) and torch.equal(keys, p_keys)
    assert torch.equal(bound, p_bound)


def _tree(scene="uniform", n=3000, bucket=4, depth=8):
    pos, _, _, mass = _scene(scene, n=n, seed=11)
    perm, bound, keys = order.morton_order(pos, depth)
    return octree.build(keys, pos[perm], mass[perm], bound, depth, bucket), pos[perm], mass[perm]


def test_theta_zero_walk_sums_every_body():
    levels, pos, _ = _tree()
    counts = octree.interactions(levels, pos[:50] + 1e-4, 0.0)
    assert torch.all(counts == pos.shape[0])


@pytest.mark.parametrize("scene", ["uniform", "disc"])
def test_counts_equal_the_programs_plain_walk(scene):
    from wgpu_n_body_tpu_torch.ops.tree_build import build_tree, morton_order, reorder
    from wgpu_n_body_tpu_torch.ops.tree_walk import walk_counts
    from wgpu_n_body_tpu_torch.params import ParticleState, TreeParams

    n, bucket, depth = 3000, 4, 8
    pos, vel, acc, mass = _scene(scene, n=n, seed=11)
    levels, spos, smass = _tree(scene, n=n, bucket=bucket, depth=depth)
    tp = TreeParams(theta=0.75, max_depth=depth, leaf_bucket=bucket, node_capacity_factor=4.0)
    perm, bound, keys = morton_order(pos, depth)
    st = reorder(ParticleState(pos, vel, acc, mass), perm.long())
    tree = build_tree(st, keys, bound, tp)
    recv = st.pos[::7] + 1e-3
    want = walk_counts(recv, tree, tp)
    got = octree.interactions(levels, recv, 0.75)
    assert octree.node_count(levels) == int(tree.num_nodes)
    # the sums of the centres of gravity differ in order: a rare theta test may flip
    assert (got != want[:, 0] + want[:, 1]).float().mean() < 0.01
    assert abs(float(got.double().mean()) / float((want[:, 0] + want[:, 1]).double().mean()) - 1) < 1e-3


def test_frame_equals_the_programs_and_the_png_decodes():
    from wgpu_n_body_tpu_torch.ops.raster import blend_u8
    from wgpu_n_body_tpu_torch.runners import renderer

    pos = _scene("disc", n=5000)[0].numpy()
    cam = render.Camera(aspect=1.0).moved("forward", 0.2).moved("left", 0.2)
    pcam = renderer.Camera(aspect=1.0).moved("forward", 0.2).moved("left", 0.2)
    want = render.frame_u8(pos, cam, 200, 150, 0.25)
    counts = torch.from_numpy(renderer.render_counts(pos, pcam, 200, 150)).to(torch.int32)
    img = blend_u8(counts, 0.25).numpy()
    assert np.array_equal(want, img)
    assert np.array_equal(render.decode_png(renderer.png_bytes(img, level=1)), img)


@pytest.mark.parametrize("filt", [1, 2, 3, 4])
def test_png_filters_decode(filt):
    import struct
    import zlib

    rng = np.random.default_rng(filt)
    img = rng.integers(0, 256, (6, 5)).astype(np.int64)
    raw = b""
    prev = np.zeros(5, np.int64)
    for y in range(6):
        row, enc = img[y], []
        for x in range(5):
            a = row[x - 1] if x else 0
            c = prev[x - 1] if x else 0
            b = prev[x]
            pred = {1: a, 2: b, 3: (a + b) // 2, 4: render._paeth(a, b, c)}[filt]
            enc.append((row[x] - pred) & 255)
        raw += bytes([filt] + enc)
        prev = row

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 6, 8, 0, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    assert np.array_equal(render.decode_png(png), img.astype(np.uint8))


def test_scenes_repeat_by_seed_and_differ_across_seeds():
    a = scenes.draw("disc", 2**31 + 5, 1000, G, torch.device("cpu"))
    b = scenes.draw("disc", 2**31 + 5, 1000, G, torch.device("cpu"))
    c = scenes.draw("disc", 2**31 + 6, 1000, G, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert float(a[3][0]) == 150000.0 and torch.all(a[0][0] == 0)


def test_a_scene_seed_fixes_the_bodies_and_the_seed_orders_them():
    cpu = torch.device("cpu")
    a = scenes.draw("disc", 2**31 + 5, 1000, G, cpu, scene_seed=9)
    b = scenes.draw("disc", 2**31 + 6, 1000, G, cpu, scene_seed=9)
    c = scenes.draw("disc", 2**31 + 5, 1000, G, cpu, scene_seed=9)
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    assert not torch.equal(a[0], b[0])
    rows = [torch.cat([t.reshape(1000, -1) for t in s], dim=1) for s in (a, b)]
    assert torch.equal(*(r[torch.argsort(r[:, 0], stable=True)] for r in rows))
    assert float(a[3].max()) == 150000.0
