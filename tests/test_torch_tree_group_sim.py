"""PyTorch port, group walk above the plain function: a receiver shard
(``gid_offset``), the JAX default octet engine's accuracy, ``TreeSim()``
with its default group walk and ``diagnose()``, each against the JAX
package on the same numpy state, on the CPU.

The JAX group walk compiles for several seconds per configuration on the
CPU, so this file keeps to four of them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from tests.test_torch_tree_group import JAX_TOL, SCENE, _jax_walk, _np_state, _port, _sim_params, _tp
from wgpu_n_body_tpu import params as jp
from wgpu_n_body_tpu.models.tree import TreeSim as JaxTreeSim
from wgpu_n_body_tpu.ops import tree_build as jax_build
from wgpu_n_body_tpu.ops.tree_walk_group import group_tree_forces as jax_group_tree_forces
from wgpu_n_body_tpu_torch.models import TreeSim
from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_dense
from wgpu_n_body_tpu_torch.ops.tree_walk import tree_forces
from wgpu_n_body_tpu_torch.ops.tree_walk_group import group_tree_forces
from wgpu_n_body_tpu_torch.params import SimParams, TreeParams, state_from_numpy, state_to_numpy

# tests/test_naive.py state tolerances, two steps
POS_TOL = dict(rtol=1e-5, atol=1e-8)
VEL_TOL = dict(rtol=1e-4, atol=1e-8)

# a clustered scene and a step budget that some of its tiles overflow
DEFER_KW = dict(theta=0.5, walk_list_cap=128)


def _jax_state(s):
    return jp.ParticleState(**{k: jnp.asarray(v) for k, v in s.items()})


def test_receiver_shard_matches_jax_with_deferral():
    # receivers are the sorted rows [100, 228) against all 300 sources; some
    # of the shard's tiles defer, so the fallback's self index is offset too
    s = _np_state(6, 300, "clustered")
    want, want_def = _jax_walk(s, gid=slice(100, 228), **DEFER_KW)
    ss, tree, keys, ttp = _port(s, **DEFER_KW)
    _, params = _sim_params(300)
    got, stats = group_tree_forces(
        ss.pos[100:228], ss.pos, ss.mass, tree, keys[100:228], params, ttp, gid_offset=100,
    )
    assert 0 < int(stats.deferred) == want_def < 128
    np.testing.assert_allclose(got.numpy(), want, **JAX_TOL)


def test_octet_engine_difference_is_conservative():
    # The JAX default (walk_engine="octet") tests theta against a quantized
    # centre of gravity and so opens a few more nodes than the skip
    # semantics the port runs for both engines: rows differ slightly, and
    # both stay at least as accurate as the per-particle walk.
    jtp = jp.TreeParams(theta=0.75, max_depth=10, walk_tile=32, walk_list_cap=2048)
    assert jtp.walk_engine == "octet"
    st = _jax_state(SCENE)
    jss, jbound, jkeys = jax_build.morton_sort(st, jtp.max_depth)
    jtree = jax_build.build_tree(jss, jkeys, jbound, jtp)
    assert jtree.octets is not None
    jparams, params = _sim_params(300)
    octet, ostats = jax_group_tree_forces(jss.pos, jss.pos, jss.mass, jtree, jkeys, jparams, jtp)
    octet = np.asarray(octet)
    ttp = TreeParams(**dataclasses.asdict(jtp))
    ss, tree, keys, _ = _port(SCENE, theta=0.75)
    got, stats = group_tree_forces(ss.pos, ss.pos, ss.mass, tree, keys, params, ttp)
    assert int(stats.deferred) == int(ostats.deferred) == 0
    exact = naive_forces_dense(ss.pos.double(), ss.pos.double(), ss.mass.double(), params).numpy()
    per = tree_forces(ss.pos, ss.pos, ss.mass, tree, params, ttp).numpy()
    scale = np.linalg.norm(exact, axis=1).mean()

    def err(a):
        return np.abs(a - exact).mean() / scale

    e_port, e_octet, e_per = err(got.numpy()), err(octet), err(per)
    rel = np.linalg.norm(got.numpy() - octet, axis=1) / np.linalg.norm(octet, axis=1)
    print(f"octet vs port: {(rel > 1e-4).sum()} of 300 rows beyond 1e-4, max {rel.max():.3e}; "
          f"error vs float64: port {e_port:.4e}, JAX octet {e_octet:.4e}, per-particle {e_per:.4e}")
    assert e_port < 0.03 and e_port <= 1.01 * e_per
    assert e_octet < 0.03 and e_octet <= 1.01 * e_per
    assert rel.max() < 1e-2


def test_tree_sim_default_group_walk_matches_jax_skip_engine():
    n = 300
    s = _np_state(8, n)
    jparams, params = _sim_params(n, g=1e-5)
    assert TreeParams().walk == "group"
    jstep = JaxTreeSim(jparams, jp.TreeParams(walk_engine="skip")).make_step(donate=False)
    step = TreeSim(params).make_step()
    a, b = _jax_state(s), state_from_numpy(**s, device="cpu")
    for _ in range(2):
        a, b = jstep(a), step(b)
    got = state_to_numpy(b)
    # both return the Morton-sorted state, so rows correspond
    np.testing.assert_allclose(got["pos"], np.asarray(a.pos), **POS_TOL)
    np.testing.assert_allclose(got["vel"], np.asarray(a.vel), **VEL_TOL)
    np.testing.assert_array_equal(got["mass"], np.asarray(a.mass))


def test_diagnose_matches_jax():
    s = _np_state(6, 300, "clustered")
    jtp, ttp = _tp(**DEFER_KW)
    jparams, params = _sim_params(300)
    want = JaxTreeSim(jparams, jtp).diagnose(_jax_state(s))
    got = TreeSim(params, ttp).diagnose(state_from_numpy(**s, device="cpu"))
    # the port adds the list pool's share of the deferrals, which JAX lacks
    assert {k: got[k] for k in want} == want and got["walk_pool_deferred"] == 0
    assert got["walk_deferred"] > 0 and got["overflowed"] is False


def test_diagnose_reports_the_group_walk_for_either_walk():
    s = _np_state(6, 300, "clustered")
    _, ttp = _tp(**DEFER_KW)
    state = state_from_numpy(**s, device="cpu")
    group = TreeSim(SimParams(particle_num=300), ttp).diagnose(state)
    per = TreeSim(SimParams(particle_num=300), dataclasses.replace(ttp, walk="per_particle"))
    assert per.diagnose(state) == group
