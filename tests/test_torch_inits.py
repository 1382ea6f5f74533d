"""PyTorch port, scene generators: the distribution checks of
tests/test_inits.py, and agreement in distribution with the JAX package
(the random streams differ, so no bitwise comparison)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from wgpu_n_body_tpu import inits as jax_inits
from wgpu_n_body_tpu import params as jp
from wgpu_n_body_tpu_torch.inits import INITS, disc_init, spherical_init, uniform_init
from wgpu_n_body_tpu_torch.params import (
    ParticleState,
    SimParams,
    state_to_numpy,
    validate_state,
)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_uniform_shapes_and_ranges():
    st = uniform_init(_gen(0), SimParams(particle_num=5000), torch.device("cpu"))
    validate_state(st)
    s = state_to_numpy(st)
    pos, vel = s["pos"], s["vel"]
    assert pos.shape == (5000, 3) and pos.dtype == np.float32
    assert pos.min() >= -1.0 and pos.max() <= 1.0
    assert np.abs(vel).max() <= 0.001
    assert np.abs(vel).max() > 0.0005
    np.testing.assert_array_equal(s["mass"], 1.0)
    np.testing.assert_array_equal(s["acc"], 0.0)
    assert abs(pos.mean()) < 0.02
    assert abs(pos.std() - (2 / np.sqrt(12))) < 0.02
    z = ParticleState.zeros(7, device="cpu")
    validate_state(z)
    assert z.n == 7 and float(z.pos.abs().sum()) == 0.0 and bool((z.mass == 1).all())


def test_disc_central_body_and_annulus():
    s = state_to_numpy(disc_init(_gen(1), SimParams(particle_num=4096, g=1e-5), torch.device("cpu")))
    pos, vel, mass = s["pos"], s["vel"], s["mass"]
    np.testing.assert_array_equal(pos[0], 0.0)
    np.testing.assert_array_equal(vel[0], 0.0)
    assert mass[0] == 150000.0
    np.testing.assert_array_equal(mass[1:], 1.0)
    r = np.linalg.norm(pos[1:], axis=1)
    assert r.min() >= 0.25**2 - 1e-6
    assert r.max() <= 1.0 + 1e-6
    speed = np.linalg.norm(vel[1:], axis=1)
    np.testing.assert_allclose(speed, np.sqrt(1e-5 * 1000.0 / r), rtol=1e-4)
    assert np.abs(np.sum(vel[1:] * pos[1:], axis=1)).max() < 1e-5
    assert np.abs(pos[1:, 2]).max() <= 0.1 + 1e-6
    # the first draw keeps z exactly 0 for the bodies it accepted
    assert (pos[1:, 2] == 0.0).mean() > 0.5


def test_spherical_ball_and_masses():
    s = state_to_numpy(spherical_init(_gen(2), SimParams(particle_num=4096), torch.device("cpu")))
    pos, vel, mass = s["pos"], s["vel"], s["mass"]
    r = np.linalg.norm(pos, axis=1)
    assert r.max() <= 1.0 + 1e-6
    np.testing.assert_allclose(np.linalg.norm(vel, axis=1), 0.4, rtol=1e-5)
    np.testing.assert_allclose(np.sum(vel * pos, axis=1) / (r * 0.4), 1.0, rtol=1e-4)
    assert mass.min() >= 1.0 and mass.max() <= 3.0
    assert abs(mass.mean() - 2.0) < 0.05


@pytest.mark.parametrize("name", sorted(INITS))
def test_seeded_and_reproducible(name):
    params = SimParams(particle_num=512)
    a = INITS[name](_gen(7), params, torch.device("cpu"))
    b = INITS[name](_gen(7), params, torch.device("cpu"))
    c = INITS[name](_gen(8), params, torch.device("cpu"))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.pos, c.pos)


@pytest.mark.parametrize("name", sorted(INITS))
def test_distribution_matches_jax(name):
    """Summary statistics of both packages' scenes agree at N=8192 (each a
    mean over thousands of bodies, so 3% covers sampling noise)."""
    params = SimParams(particle_num=8192, g=1e-5)
    s = state_to_numpy(INITS[name](_gen(0), params, torch.device("cpu")))
    j = jax_inits.INITS[name](jax.random.key(0), jp.SimParams(**dataclasses.asdict(params)))
    js = {k: np.asarray(v) for k, v in j._asdict().items()}
    for t in (s, js):
        t["r"] = np.linalg.norm(t["pos"], axis=1)
        t["speed"] = np.linalg.norm(t["vel"], axis=1)
    for key in ("r", "speed", "mass"):
        np.testing.assert_allclose(s[key].mean(), js[key].mean(), rtol=0.03, err_msg=key)
        np.testing.assert_allclose(s[key].std(), js[key].std(), rtol=0.03, atol=1e-6, err_msg=key)
