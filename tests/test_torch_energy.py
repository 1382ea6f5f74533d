"""PyTorch port, the potential energy (E1, ``csrc/energy.cu``) on the CPU:
the plain version's shares against the JAX package's ``potential_energy``,
a model of the kernel's enumeration of tile pairs, the CPU path's routing,
the sharded runner's energy over two gloo ranks, and the bench module.

The kernel itself runs on the card only (``chip_smoke.py`` holds it against
the plain version in float64 there)."""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_n_body_tpu import params as jp
from wgpu_n_body_tpu.ops import energy as jax_energy
from wgpu_n_body_tpu_torch import bench, cli
from wgpu_n_body_tpu_torch.inits import uniform_init
from wgpu_n_body_tpu_torch.models import NaiveSim
from wgpu_n_body_tpu_torch.ops import energy, energy_cuda
from wgpu_n_body_tpu_torch.params import NaiveParams, ParticleState, SimParams, state_from_numpy
from wgpu_n_body_tpu_torch.parallel.mesh import Mesh
from wgpu_n_body_tpu_torch.runners import headless
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless

PARAMS = SimParams(particle_num=1000, g=1e-4, e=1e-4)


def _np_state(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "pos": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        "vel": rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32),
        "acc": np.zeros((n, 3), np.float32),
        "mass": rng.uniform(0.5, 2.0, n).astype(np.float32),
    }


@functools.lru_cache(maxsize=None)
def _jax_potential(n, softened):
    s = _np_state(n, n)
    jst = jp.ParticleState(**{k: jnp.asarray(v) for k, v in s.items()})
    jparams = jp.SimParams(particle_num=n, g=PARAMS.g, e=PARAMS.e)
    return float(jax_energy.potential_energy(jst, jparams, block=32, softened=softened))


@pytest.mark.parametrize("p", [1, 2, 3, 5])
@pytest.mark.parametrize("n", [1, 2, 1000])
@pytest.mark.parametrize("softened", [True, False])
def test_plain_shares_sum_to_jax(softened, n, p):
    st = state_from_numpy(**_np_state(n, n), device="cpu")
    parts = [energy.potential_energy(st, PARAMS, softened=softened, share=(k, p))
             for k in range(p)]
    assert all(t.dtype == torch.float64 and t.shape == () for t in parts)
    np.testing.assert_allclose(float(sum(parts)), _jax_potential(n, softened), rtol=1e-5)


@pytest.mark.parametrize("block", [1, 32, 100])
def test_plain_row_block_does_not_change_the_sum(block):
    st = state_from_numpy(**_np_state(7, 600), device="cpu")
    whole = float(energy.potential_energy(st, PARAMS))
    got = float(energy.potential_energy(st, PARAMS, block=block, share=(1, 3)))
    got += sum(float(energy.potential_energy(st, PARAMS, share=(k, 3))) for k in (0, 2))
    np.testing.assert_allclose(got, whole, rtol=1e-6)


def _kernel_model(n, tile, p, blocks):
    """How many times E1's launches over the P shares, each of ``blocks``
    blocks, count each pair (i, j): each block walks its run of tile pairs
    as ``csrc/energy.cu`` does (one ``tile_pair`` root, then b + 1, and the
    next row's diagonal at the row's end); on the diagonal tile receiver k
    of the tile starts past itself."""
    nt = -(-n // tile)
    seen = np.zeros((n, n), np.int64)
    for k in range(p):
        lo, hi = energy.share_range(n, (k, p), tile)
        for g in range(blocks):
            t0, t1 = lo + (hi - lo) * g // blocks, lo + (hi - lo) * (g + 1) // blocks
            if t0 >= t1:
                continue
            a, b = energy.tile_pair(t0, nt)
            for _ in range(t0, t1):
                for q in range(min(tile, n - a * tile)):
                    i = a * tile + q
                    j0 = b * tile + (q + 1 if a == b else 0)
                    seen[i, j0:min((b + 1) * tile, n)] += 1
                b += 1
                if b == nt:
                    a += 1
                    b = a
    return seen


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n,tile", [(1, 4), (2, 4), (37, 4), (64, 8), (301, 16), (1000, 256)])
def test_kernel_enumeration_covers_each_pair_once(n, tile, p):
    seen = _kernel_model(n, tile, p, blocks=5)
    want = np.triu(np.ones((n, n), np.int64), k=1)
    np.testing.assert_array_equal(seen, want)


@pytest.mark.parametrize("nt", [1, 2, 3, 17, 128, 15625])
def test_tile_pair_inverts_the_row_numbering(nt):
    count = nt * (nt + 1) // 2
    ts = [t for t in {0, 1, count // 3, count // 2, count - 2, count - 1} if 0 <= t < count]
    for a in sorted({0, nt // 2, nt - 1}):
        ts += [energy.row_start(a, nt), energy.row_start(a, nt) + nt - a - 1]
    for t in ts:
        a, b = energy.tile_pair(t, nt)
        assert 0 <= a <= b < nt and energy.row_start(a, nt) + b - a == t


def test_share_range_splits_the_triangle_evenly():
    n = 4_000_000
    nt = -(-n // energy.TILE)
    runs = [energy.share_range(n, (k, 8)) for k in range(8)]
    assert runs[0][0] == 0 and runs[-1][1] == nt * (nt + 1) // 2
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert max(hi - lo for lo, hi in runs) - min(hi - lo for lo, hi in runs) <= 1
    for bad in [(1, 1), (-1, 2), (0, 0), (0.0, 1)]:
        with pytest.raises(ValueError, match="share"):
            energy.share_range(n, bad)


def test_cpu_state_never_loads_the_cuda_library(monkeypatch):
    def refuse():
        raise AssertionError("a CPU state loaded the CUDA library")

    monkeypatch.setattr(energy_cuda, "_library", refuse)
    st = state_from_numpy(**_np_state(5, 300), device="cpu")
    want = float(energy.potential_energy_plain(st, PARAMS, share=(1, 2)))
    assert float(energy.potential_energy(st, PARAMS, share=(1, 2))) == want
    assert float(energy_cuda.potential_energy_cuda(st.pos, st.mass, PARAMS, share=(1, 2))) == want
    r = OfflineHeadless(NaiveSim(PARAMS, NaiveParams(use_pallas=False)), uniform_init,
                        device="cpu")
    np.testing.assert_allclose(r.total_energy(), float(energy.total_energy(r.state, PARAMS)),
                               rtol=1e-12)
    assert energy_cuda.LAUNCHES == 0


def test_other_devices_raise():
    st = ParticleState(*(torch.empty(s, device="meta") for s in ((4, 3), (4, 3), (4, 3), (4,))))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        energy.potential_energy(st, PARAMS)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        energy_cuda.potential_energy_cuda(st.pos, st.mass, PARAMS)


def test_runner_evaluates_its_rank_share(monkeypatch):
    """A sharded runner's rank evaluates share (rank, P) of the pairs on the
    gathered state and sums the parts over the ranks."""
    calls = []

    def fake_potential(state, params, share):
        calls.append(share)
        return torch.tensor(2.0, dtype=torch.float64)

    def fake_all_reduce(x, op):
        calls.append(op)
        return x * 3  # three ranks of 2.0 each

    monkeypatch.setattr(headless, "potential_energy", fake_potential)
    monkeypatch.setattr(headless, "all_reduce", fake_all_reduce)
    monkeypatch.setattr(headless, "gather_state", lambda state, mesh: state)
    r = OfflineHeadless(NaiveSim(PARAMS, NaiveParams(use_pallas=False)), uniform_init,
                        device="cpu")
    r.sim.mesh = Mesh(rank=1, size=3, device=torch.device("cpu"))
    ke = float(energy.kinetic_energy(r.state))
    assert r.total_energy() == pytest.approx(ke + 6.0, rel=1e-12)
    assert calls == [(1, 3), "sum"]


def _energies(out):
    return [float(line.rsplit(" ", 1)[1]) for line in out.splitlines()
            if "total energy" in line]


@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_two_gloo_ranks_log_the_single_device_energy(schedule, capfd):
    argv = ["headless", "--device", "cpu", "--sim", "naive", "--n", "512", "--steps", "4",
            "--energy-every", "2", "--init", "spherical"]
    assert cli.main(argv) == 0
    single = _energies(capfd.readouterr().out)
    assert cli.main([*argv, "--devices", "2", "--schedule", schedule]) == 0
    sharded = _energies(capfd.readouterr().out)
    assert len(single) == len(sharded) == 2 and np.isfinite(single).all()
    np.testing.assert_allclose(sharded, single, rtol=1e-6)


def test_bench_module_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "N", 1024)
    monkeypatch.setattr(bench, "REPS", 1)
    monkeypatch.setattr(bench, "DEVICE", "cpu")
    assert bench.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    # bench.py's keys (bench.py:51-60), and the device's name
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert rec["metric"] == "naive_pairwise_interactions_per_sec_n1024"
    assert rec["unit"] == "pairs/s" and rec["device"] == "cpu"
    assert rec["value"] > 0 and rec["vs_baseline"] == pytest.approx(rec["value"] / 1e11)
