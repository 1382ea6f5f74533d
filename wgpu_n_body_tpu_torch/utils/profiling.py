"""Step timing + profiler scopes — counterpart of
``wgpu_n_body_tpu/utils/profiling.py``.

The reference prints per-step wall-clock from the headless binary
(src/bin/headless.rs:30-32) and labels GPU command regions with debug
groups (naive.rs:151). Here: a host ``StepTimer`` that waits for the
device before reading the clock, and ``torch.profiler`` scopes.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


def sync(t: torch.Tensor) -> None:
    """Wait until the device of ``t`` has finished all queued work
    (CUDA kernels return before they run); a no-op for CPU tensors."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclass
class StepTimer:
    """Accumulates per-step wall times, each closed by ``sync``."""

    times_s: list = field(default_factory=list)

    @contextlib.contextmanager
    def step(self, result_to_sync: torch.Tensor | None = None):
        t0 = time.perf_counter()
        box = {}
        yield box
        t = box.get("sync", result_to_sync)
        if t is not None:
            sync(t)
        self.times_s.append(time.perf_counter() - t0)

    @property
    def last_us(self) -> float:
        return self.times_s[-1] * 1e6

    def mean_s(self, skip_first: int = 1) -> float:
        ts = self.times_s[skip_first:] or self.times_s
        return sum(ts) / len(ts)


def trace_scope(name: str):
    """Named profiler region (analog of wgpu push_debug_group)."""
    return torch.profiler.record_function(name)
