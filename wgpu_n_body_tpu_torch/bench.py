"""Headline benchmark: naive all-pairs pairwise interactions/sec, one GPU —
counterpart of the repo root's ``bench.py``.

    python -m wgpu_n_body_tpu_torch.bench

Prints ONE JSON line with ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline`` against 1e11 pairs/s, BASELINE.json) and the
device's name. Set-up as ``bench.py``: N=262144 uniform bodies, g=1e-6, the
hand-written all-pairs kernel (B1), one warm-up step (which builds the
kernel on first use), then REPS steps queued back to back and closed by one
device synchronise (``utils/profiling.py::time_steps``, as ``cli bench``).
"""

from __future__ import annotations

import json

import torch

from wgpu_n_body_tpu_torch.inits import uniform_init
from wgpu_n_body_tpu_torch.models import NaiveSim
from wgpu_n_body_tpu_torch.params import NaiveParams, SimParams
from wgpu_n_body_tpu_torch.utils.profiling import time_steps

N = 262_144  # BASELINE.json config 2
REPS = 5
DEVICE = "cuda"
BASELINE_PAIRS_PER_SEC = 1e11


def main() -> int:
    device = torch.device(DEVICE)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    sim = NaiveSim(SimParams(particle_num=N, g=1e-6), NaiveParams())
    state = sim.init_state(torch.Generator().manual_seed(0), uniform_init, device)
    _, dt = time_steps(sim.make_step(), state, REPS)

    pairs_per_sec = N * N / dt
    print(json.dumps({
        "metric": f"naive_pairwise_interactions_per_sec_n{N}",
        "value": pairs_per_sec,
        "unit": "pairs/s",
        "vs_baseline": pairs_per_sec / BASELINE_PAIRS_PER_SEC,
        "device": kind,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
