"""PyTorch port, naive slice: the same numpy inputs through the JAX package
(dense oracle and interpret-mode Pallas kernel) and through the port.

On the CPU the port's kernel wrapper takes its plain torch version; the
kernel itself is checked on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracle import step_numpy
from wgpu_n_body_tpu import params as jp
from wgpu_n_body_tpu.models.naive import NaiveSim as JaxNaiveSim
from wgpu_n_body_tpu.ops.integrate import leapfrog_step as jax_leapfrog_step
from wgpu_n_body_tpu.ops.naive_pallas import naive_forces_pallas
from wgpu_n_body_tpu.ops.naive_ref import naive_forces_dense as jax_forces_dense
from wgpu_n_body_tpu_torch.models import NaiveSim
from wgpu_n_body_tpu_torch.ops import cuda_build, naive_cuda, tree_walk_cuda
from wgpu_n_body_tpu_torch.ops.integrate import leapfrog_step
from wgpu_n_body_tpu_torch.ops.naive_ref import (
    naive_forces_dense,
    naive_forces_mxu_ref,
    naive_forces_ref,
)
from wgpu_n_body_tpu_torch.params import (
    NaiveParams,
    SimParams,
    state_from_numpy,
    state_to_numpy,
)

# tests/test_naive.py tolerances
FORCE_TOL = dict(rtol=3e-5, atol=1e-9)
POS_TOL = dict(rtol=1e-5, atol=1e-8)
VEL_TOL = dict(rtol=1e-4, atol=1e-8)
# tests/test_naive.py:94-110: the factored (mxu) accumulation is less exact
MXU_TOL = dict(rtol=5e-2, atol=2e-8)


def _np_state(seed, n, with_acc=True):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "pos": rng.uniform(-1, 1, (n, 3)).astype(f32),
        "vel": rng.uniform(-0.1, 0.1, (n, 3)).astype(f32),
        "acc": (
            rng.uniform(-0.01, 0.01, (n, 3)) if with_acc else np.zeros((n, 3))
        ).astype(f32),
        "mass": rng.uniform(0.5, 2.0, n).astype(f32),
    }


def _jax_params(params: SimParams) -> jp.SimParams:
    return jp.SimParams(**dataclasses.asdict(params))


def _jax_state(s) -> jp.ParticleState:
    return jp.ParticleState(**{k: jnp.asarray(v) for k, v in s.items()})


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _force_inputs(n, seed=3):
    s = _np_state(seed, n)
    pos_new = (s["pos"] + np.float32(0.01) * s["vel"]).astype(np.float32)
    return pos_new, s["pos"], s["mass"]


@pytest.mark.parametrize("n", [64, 200, 1000])
def test_forces_match_jax_dense_and_pallas(n):
    params = SimParams(particle_num=n, g=1e-4, e=1e-4, dt=0.016)
    pos_new, pos_old, mass = _force_inputs(n)
    got = naive_forces_ref(*_torch(pos_new, pos_old, mass), params).numpy()
    jargs = (jnp.asarray(pos_new), jnp.asarray(pos_old), jnp.asarray(mass), _jax_params(params))
    dense = np.asarray(jax_forces_dense(*jargs))
    pallas = np.asarray(naive_forces_pallas(*jargs, tile_i=64, tile_j=128))
    np.testing.assert_allclose(got, dense, **FORCE_TOL)
    np.testing.assert_allclose(got, pallas, **FORCE_TOL)


def test_row_offset_shard_matches_jax_pallas():
    n = 256
    params = SimParams(particle_num=n, g=1e-4)
    pos_new, pos_old, mass = _force_inputs(n, seed=4)
    t_new, t_old, t_mass = _torch(pos_new, pos_old, mass)
    got = naive_forces_ref(t_new[64:192], t_old, t_mass, params, row_offset=64).numpy()
    shard = naive_forces_pallas(
        jnp.asarray(pos_new[64:192]), jnp.asarray(pos_old), jnp.asarray(mass),
        _jax_params(params), tile_i=64, tile_j=128, row_offset=64,
    )
    np.testing.assert_allclose(got, np.asarray(shard), **FORCE_TOL)
    full = naive_forces_dense(t_new, t_old, t_mass, params).numpy()
    np.testing.assert_allclose(got, full[64:192], **FORCE_TOL)


def test_blockwise_matches_dense():
    params = SimParams(particle_num=300, g=1e-4)
    pos_new, pos_old, mass = _torch(*_force_inputs(300, seed=2))
    dense = naive_forces_dense(pos_new, pos_old, mass, params)
    blocked = naive_forces_ref(pos_new, pos_old, mass, params, block=128)
    torch.testing.assert_close(blocked, dense, rtol=1e-5, atol=1e-9)
    shard = naive_forces_ref(pos_new[100:300], pos_old, mass, params, block=64, row_offset=100)
    torch.testing.assert_close(shard, dense[100:300], rtol=1e-5, atol=1e-9)


def test_coincident_pair_nan_parity():
    params = SimParams(particle_num=32, g=1e-4)
    pos_new, pos_old, mass = _force_inputs(32, seed=5)
    pos_old[9] = pos_new[5]  # receiver 5 sits exactly on source 9
    got = naive_forces_ref(*_torch(pos_new, pos_old, mass), params).numpy()
    jargs = (jnp.asarray(pos_new), jnp.asarray(pos_old), jnp.asarray(mass), _jax_params(params))
    for want in (
        np.asarray(jax_forces_dense(*jargs)),
        np.asarray(naive_forces_pallas(*jargs, tile_i=64, tile_j=128)),
    ):
        nan_rows = np.isnan(want).any(axis=1)
        assert nan_rows[5] and nan_rows.sum() == 1
        np.testing.assert_array_equal(np.isnan(got).any(axis=1), nan_rows)
        np.testing.assert_allclose(got[~nan_rows], want[~nan_rows], **FORCE_TOL)


def test_leapfrog_matches_jax_and_oracle():
    params = SimParams(particle_num=13, g=1e-3, e=1e-4, dt=0.016)
    s = _np_state(1, 13)
    st = state_from_numpy(**s, device="cpu")
    out = leapfrog_step(st, params, lambda pn, po, m: naive_forces_dense(pn, po, m, params))
    # the step reads the pre-step positions as sources and leaves them be
    np.testing.assert_array_equal(st.pos.numpy(), s["pos"])
    got = state_to_numpy(out)
    jparams = _jax_params(params)
    jout = jax_leapfrog_step(
        _jax_state(s), jparams, lambda pn, po, m: jax_forces_dense(pn, po, m, jparams)
    )
    np.testing.assert_allclose(got["pos"], np.asarray(jout.pos), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(got["vel"], np.asarray(jout.vel), rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(got["acc"], np.asarray(jout.acc), rtol=2e-4, atol=1e-9)
    wp, wv, wa = step_numpy(s["pos"], s["vel"], s["acc"], s["mass"], params.g, params.e, params.dt)
    np.testing.assert_allclose(got["pos"], wp, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(got["vel"], wv, rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(got["acc"], wa, rtol=2e-4, atol=1e-9)
    np.testing.assert_array_equal(got["mass"], s["mass"])


@pytest.mark.parametrize("use_pallas", [True, False])
def test_naive_sim_matches_jax_pallas_sim(use_pallas):
    params = SimParams(particle_num=256, g=1e-5)
    s = _np_state(6, 256, with_acc=False)
    jstep = JaxNaiveSim(
        _jax_params(params), jp.NaiveParams(use_pallas=True, tile_i=64, tile_j=128)
    ).make_step(donate=False)
    step = NaiveSim(params, NaiveParams(use_pallas=use_pallas, tile_i=64, tile_j=128)).make_step()
    a, b = _jax_state(s), state_from_numpy(**s, device="cpu")
    for _ in range(3):
        a, b = jstep(a), step(b)
    got = state_to_numpy(b)
    np.testing.assert_allclose(got["pos"], np.asarray(a.pos), **POS_TOL)
    np.testing.assert_allclose(got["vel"], np.asarray(a.vel), **VEL_TOL)
    np.testing.assert_array_equal(got["mass"], s["mass"])


@pytest.mark.parametrize("n", [200, 1000])
def test_mxu_forces_match_jax_mxu_kernel_and_dense(n):
    params = SimParams(particle_num=n, g=1e-4, e=1e-4, dt=0.016)
    pos_new, pos_old, mass = _force_inputs(n, seed=7)
    t_new, t_old, t_mass = _torch(pos_new, pos_old, mass)
    got = naive_forces_mxu_ref(t_new, t_old, t_mass, params).numpy()
    jargs = (jnp.asarray(pos_new), jnp.asarray(pos_old), jnp.asarray(mass), _jax_params(params))
    dense = np.asarray(jax_forces_dense(*jargs))
    mxu = np.asarray(naive_forces_pallas(*jargs, tile_i=128, tile_j=128, mxu=True))
    np.testing.assert_allclose(got, mxu, **MXU_TOL)
    np.testing.assert_allclose(got, dense, **MXU_TOL)
    # the receiver shard keeps the self-mask on the global diagonal
    shard = naive_forces_mxu_ref(t_new[64:192], t_old, t_mass, params, row_offset=64).numpy()
    jshard = naive_forces_pallas(
        jnp.asarray(pos_new[64:192]), *jargs[1:], tile_i=128, tile_j=128, mxu=True,
        row_offset=64,
    )
    np.testing.assert_allclose(shard, np.asarray(jshard), **MXU_TOL)
    np.testing.assert_allclose(shard, dense[64:192], **MXU_TOL)
    # receiver blocks of the plain version give the one dense evaluation
    blocked = naive_forces_mxu_ref(t_new, t_old, t_mass, params, block=96)
    torch.testing.assert_close(blocked, torch.from_numpy(got), rtol=0, atol=0)


def test_mxu_coincident_pair_nan_parity():
    params = SimParams(particle_num=32, g=1e-4)
    pos_new, pos_old, mass = _force_inputs(32, seed=5)
    pos_old[9] = pos_new[5]
    got = naive_forces_mxu_ref(*_torch(pos_new, pos_old, mass), params).numpy()
    jargs = (jnp.asarray(pos_new), jnp.asarray(pos_old), jnp.asarray(mass), _jax_params(params))
    want = np.asarray(naive_forces_pallas(*jargs, tile_i=128, tile_j=128, mxu=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[5]).all()
    ok = ~np.isnan(want).any(axis=1)
    np.testing.assert_allclose(got[ok], want[ok], **MXU_TOL)


def test_naive_sim_mxu_matches_jax_mxu_sim():
    params = SimParams(particle_num=256, g=1e-5)
    s = _np_state(8, 256, with_acc=False)
    ap = dict(use_pallas=True, tile_i=128, tile_j=128, mxu=True)
    jstep = JaxNaiveSim(_jax_params(params), jp.NaiveParams(**ap)).make_step(donate=False)
    step = NaiveSim(params, NaiveParams(**ap)).make_step()
    a, b = _jax_state(s), state_from_numpy(**s, device="cpu")
    before = naive_cuda.LAUNCHES_MXU
    for _ in range(3):
        a, b = jstep(a), step(b)
    assert naive_cuda.LAUNCHES_MXU == before  # the CPU takes the plain version
    got = state_to_numpy(b)
    np.testing.assert_allclose(got["pos"], np.asarray(a.pos), **POS_TOL)
    np.testing.assert_allclose(got["vel"], np.asarray(a.vel), **VEL_TOL)
    np.testing.assert_array_equal(got["mass"], s["mass"])


def test_mxu_wrapper_on_cpu_takes_factored_plain_version():
    params = SimParams(particle_num=100, g=1e-4)
    args = _torch(*_force_inputs(100))
    got = naive_cuda.naive_forces_cuda(*args, params, tile_i=64, tile_j=128, mxu=True)
    torch.testing.assert_close(got, naive_forces_mxu_ref(*args, params), rtol=0, atol=0)
    # use_pallas=False keeps the plain dx-form whatever mxu says, as in JAX
    s = _np_state(9, 64, with_acc=False)
    st = state_from_numpy(**s, device="cpu")
    p64 = SimParams(particle_num=64, g=1e-4)
    out = NaiveSim(p64, NaiveParams(use_pallas=False, mxu=True)).make_step()(st)
    ref = leapfrog_step(st, p64, lambda pn, po, m: naive_forces_ref(pn, po, m, p64))
    torch.testing.assert_close(out.acc, ref.acc, rtol=0, atol=0)


def test_wrapper_on_cpu_takes_plain_version_without_launching():
    params = SimParams(particle_num=100, g=1e-4)
    args = _torch(*_force_inputs(100))
    before = naive_cuda.LAUNCHES
    got = naive_cuda.naive_forces_cuda(*args, params, tile_i=64, tile_j=128)
    assert naive_cuda.LAUNCHES == before
    torch.testing.assert_close(got, naive_forces_ref(*args, params), rtol=0, atol=0)


@pytest.mark.parametrize(
    "kwargs", [{"tile_i": 48}, {"tile_i": 2048}, {"tile_j": 4096}, {"row_offset": -1}]
)
def test_wrapper_rejects_bad_arguments(kwargs):
    args = _torch(*_force_inputs(16))
    with pytest.raises(ValueError):
        naive_cuda.naive_forces_cuda(*args, SimParams(particle_num=16), **kwargs)


def test_kernel_build_flags_and_missing_nvcc(monkeypatch, tmp_path):
    for module in (naive_cuda, tree_walk_cuda):
        flags = " ".join(module.NVCC_FLAGS)
        assert "arch=compute_90a,code=sm_90a" in flags
        assert "fast_math" not in flags and "fast-math" not in flags
    # no kernel turns contraction off for its whole file: the walks' theta
    # tests round as the plain versions by intrinsics nvcc never contracts
    assert "-fmad=false" not in tree_walk_cuda.NVCC_FLAGS
    assert "-fmad=false" not in naive_cuda.NVCC_FLAGS
    assert "__fsqrt_rn" in tree_walk_cuda.SOURCE.read_text()
    monkeypatch.setattr(naive_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tree_walk_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    for build in (naive_cuda.build, tree_walk_cuda.build):  # B1 and B2 share one source
        with pytest.raises(RuntimeError, match="nvcc"):
            build()
    assert not any(tmp_path.iterdir())  # nothing half-built is left behind
