#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero):
 1. a CUDA device is present; print the card's name and power limit;
 2. build the all-pairs kernel from ``wgpu_n_body_tpu_torch/csrc``;
 3. hold the kernel against its plain torch version on the card: small
    ragged inputs, receiver shards (``row_offset``), coincident-pair NaN,
    and at N=262144 both against a float64 evaluation;
 4. time kernel and plain version at N=262144 with CUDA events;
 5. run ``cli headless --sim naive --n 262144 --steps 10`` in-process and
    check that each step launched the kernel once and the state is sane;
 6. three NaiveSim steps at N=16384, kernel vs plain version.
The last two lines are a JSON record of the kernel and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_MAIN = 262144
STEPS = 10


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def row_rel_err(got, want):
    """Per-row relative L2 error |got_i - want_i| / |want_i| (float64)."""
    got, want = got.double(), want.double()
    return ((got - want).norm(dim=1) / want.norm(dim=1)).cpu().numpy()


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from wgpu_n_body_tpu_torch import cli
        from wgpu_n_body_tpu_torch.inits import uniform_init
        from wgpu_n_body_tpu_torch.models import NaiveSim
        from wgpu_n_body_tpu_torch.ops import naive_cuda
        from wgpu_n_body_tpu_torch.ops.naive_ref import naive_forces_ref
        from wgpu_n_body_tpu_torch.params import NaiveParams, SimParams
        from wgpu_n_body_tpu_torch.utils.checkpoint import load_checkpoint
    except ImportError as exc:
        fail(f"run from a checkout of the repo ({exc})")
    if "jax" in sys.modules:
        fail("the port imported jax")

    # -- 1. the card -------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = naive_cuda.build()
    print(f"build: {time.perf_counter() - t0:.3f} s -> {lib_path.name}")
    for line in log.splitlines():
        if re.search(r"registers|spill|smem|bytes stack", line):
            print(f"  ptxas: {line.strip()}")

    def kernel(pn, po, m, params, row_offset, tile_i, tile_j):
        """Launch the kernel and surface any fault of its run here."""
        out = naive_cuda.naive_forces_cuda(pn, po, m, params, row_offset, tile_i, tile_j)
        torch.cuda.synchronize()
        return out

    def cuda_state(n, seed):
        rng = np.random.default_rng(seed)
        pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        vel = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
        mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
        pos_new = (pos + np.float32(0.01) * vel).astype(np.float32)
        return tuple(torch.from_numpy(a).to(dev) for a in (pos_new, pos, mass))

    # -- 3a. small ragged inputs: rtol 3e-5, atol 1e-9 (tests/test_naive.py) --
    small = SimParams(particle_num=1000, g=1e-4, e=1e-4, dt=0.016)
    pn, po, m = cuda_state(1000, 3)
    want = naive_forces_ref(pn, po, m, small)
    for ti, tj in ((64, 128), (512, 2048)):
        got = kernel(pn, po, m, small, 0, ti, tj)
        torch.testing.assert_close(got, want, rtol=3e-5, atol=1e-9)
        print(f"3a n=1000 tiles {ti}/{tj}: max|k-p| {(got - want).abs().max().item():.3e} ok")

    # -- 3b. receiver shards; (100, 300) straddles source tiles 128 and 256 --
    for a, b in ((0, 64), (64, 192), (100, 300), (936, 1000)):
        for ti, tj in ((64, 128), (512, 2048)):
            got = kernel(pn[a:b], po, m, small, a, ti, tj)
            ref = naive_forces_ref(pn[a:b], po, m, small, row_offset=a)
            torch.testing.assert_close(got, ref, rtol=3e-5, atol=1e-9)
            torch.testing.assert_close(got, want[a:b], rtol=3e-5, atol=1e-9)
    print("3b row_offset shards (0,64) (64,192) (100,300) (936,1000) x 2 tilings: ok")

    # -- 3c. distinct coincident particles give NaN in both ----------------
    pn_c, po_c, m_c = (t[:64].clone() for t in (pn, po, m))
    po_c[9] = pn_c[5]
    got = kernel(pn_c, po_c, m_c, small, 0, 64, 128)
    ref = naive_forces_ref(pn_c, po_c, m_c, small)
    nan_k, nan_p = torch.isnan(got).any(dim=1), torch.isnan(ref).any(dim=1)
    if not nan_k[5] or not torch.equal(nan_k, nan_p):
        fail(f"NaN rows differ: kernel {nan_k.nonzero().flatten().tolist()} "
             f"plain {nan_p.nonzero().flatten().tolist()}")
    torch.testing.assert_close(got[~nan_k], ref[~nan_k], rtol=3e-5, atol=1e-9)
    print(f"3c coincident pair: NaN rows {nan_k.nonzero().flatten().tolist()} in both, ok")

    # -- 3d. N=262144 uniform scene against float64 --------------------------
    params = SimParams(particle_num=N_MAIN)  # g 1e-6, e 1e-4, dt 0.016
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, (N_MAIN, 3)).astype(np.float32)
    vel = (rng.uniform(-1, 1, (N_MAIN, 3)) * 0.001).astype(np.float32)
    pos_new = (pos + vel * np.float32(params.dt)).astype(np.float32)
    po = torch.from_numpy(pos).to(dev)
    pn = torch.from_numpy(pos_new).to(dev)
    m = torch.ones(N_MAIN, device=dev)
    po64, pn64, m64 = po.double(), pn.double(), m.double()
    errs_k, errs_p = [], []
    for a in (0, 65536 + 100, 131072 + 1000, N_MAIN - 512):
        b = a + 512
        k = kernel(pn[a:b], po, m, params, a, 512, 2048)
        p = naive_forces_ref(pn[a:b], po, m, params, row_offset=a)
        t = naive_forces_ref(pn64[a:b], po64, m64, params, row_offset=a)
        errs_k.append(row_rel_err(k, t))
        errs_p.append(row_rel_err(p, t))
    errs_k, errs_p = np.concatenate(errs_k), np.concatenate(errs_p)
    p99_k, p99_p = float(np.percentile(errs_k, 99)), float(np.percentile(errs_p, 99))
    print(f"3d N={N_MAIN} vs float64 over {errs_k.size} rows: kernel p99 {p99_k:.3e} "
          f"max {errs_k.max():.3e}; plain f32 p99 {p99_p:.3e} max {errs_p.max():.3e}")
    gate = 1e-4 if p99_p <= 1e-4 else 2 * p99_p
    if not np.isfinite(errs_k).all() or p99_k > gate:
        fail(f"kernel p99 {p99_k:.3e} above the gate {gate:.3e}")

    # -- 4. time kernel and plain version at the main path's shape ---------
    def time_ms(fn, reps):
        out = fn()  # warm
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, out

    ms_k, k_full = time_ms(
        lambda: naive_cuda.naive_forces_cuda(pn, po, m, params, 0, 512, 2048), 5
    )
    ms_p, p_full = time_ms(lambda: naive_forces_ref(pn, po, m, params), 3)
    pairs = float(N_MAIN) * N_MAIN
    print(f"4 N={N_MAIN}: kernel {ms_k:.3f} ms ({pairs / ms_k * 1e3:.4e} pairs/s); "
          f"plain {ms_p:.3f} ms ({pairs / ms_p * 1e3:.4e} pairs/s); [{smi}]")
    # full-shape agreement: both are f32 sums in different orders, each held
    # to 1e-4 p99 against float64 above, so their difference to 2e-4
    diff = row_rel_err(k_full, p_full)
    max_abs = (k_full - p_full).abs().max().item()
    print(f"4 full shape kernel vs plain: per-row rel p99 {np.percentile(diff, 99):.3e} "
          f"max {diff.max():.3e}; max|k-p| {max_abs:.3e}")
    if not np.isfinite(diff).all() or np.percentile(diff, 99) > 2e-4:
        fail("kernel and plain version disagree at the main path's shape")
    del k_full, p_full

    # -- 5. the main path through the CLI -----------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "state.npz")
        argv = ["headless", "--sim", "naive", "--n", str(N_MAIN), "--steps", str(STEPS),
                "--energy-every", "5", "--checkpoint", ckpt]
        buf = io.StringIO()
        naive_cuda.LAUNCHES = 0
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        launches = naive_cuda.LAUNCHES
        out = buf.getvalue()
        print("\n".join("  | " + line for line in out.splitlines()))
        if rc != 0:
            fail(f"cli headless returned {rc}")
        if launches != STEPS:
            fail(f"kernel launched {launches} times in {STEPS} headless steps")
        energies = [float(x) for x in re.findall(r"total energy (\S+)", out)]
        if len(energies) != 2 or not np.isfinite(energies).all():
            fail(f"energies {energies}")
        us = float(re.search(r"mean: (\S+) us/step", out).group(1))
        ck = load_checkpoint(ckpt, dev)
        st = ck.state
        if ck.step != STEPS or not all(torch.isfinite(t).all() for t in st[:3]):
            fail("non-finite state or wrong step after the headless run")
        if not torch.equal(st.mass, torch.ones_like(st.mass)):
            fail("mass changed")
    print(f"5 headless naive N={N_MAIN}: {launches} launches in {STEPS} steps, "
          f"{us:.1f} us/step ({pairs / (us * 1e-6):.4e} pairs/s), energies {energies}; [{smi}]")

    # -- 6. NaiveSim steps, kernel vs plain (tests/test_naive.py tolerances) --
    p16 = SimParams(particle_num=16384, g=1e-5)
    gen = torch.Generator().manual_seed(4)
    s_k = s_p = NaiveSim(p16).init_state(gen, uniform_init, dev)
    step_k = NaiveSim(p16, NaiveParams(use_pallas=True)).make_step()
    step_p = NaiveSim(p16, NaiveParams(use_pallas=False)).make_step()
    for _ in range(3):
        s_k, s_p = step_k(s_k), step_p(s_p)
    torch.cuda.synchronize()
    torch.testing.assert_close(s_k.pos, s_p.pos, rtol=1e-5, atol=1e-8)
    torch.testing.assert_close(s_k.vel, s_p.vel, rtol=1e-4, atol=1e-8)
    print("6 NaiveSim N=16384 3 steps kernel vs plain: ok")

    print(json.dumps({"kernels": [{
        "name": "naive_forces",
        "route": "cuda",
        "source": "wgpu_n_body_tpu_torch/csrc/naive_forces.cu",
        "replaces": "wgpu_n_body_tpu/ops/naive_pallas.py:58",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms_k,
        "plain_ms": ms_p,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
