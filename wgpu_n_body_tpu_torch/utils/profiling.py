"""Step timing + profiler scopes — counterpart of
``wgpu_n_body_tpu/utils/profiling.py``.

The reference prints per-step wall-clock from the headless binary
(src/bin/headless.rs:30-32) and labels GPU command regions with debug
groups (naive.rs:151). Here: a host ``StepTimer`` that waits for the
device before reading the clock, ``torch.profiler`` scopes, and counters
of the work a step did beside them.

Scopes and counters record only while a ``torch.profiler`` is active (the
one switch; ``tracing()``): with none, ``trace_scope`` hands back one shared
no-op context and ``count`` does nothing, so a step pays neither a
``record_function`` nor a launch for them.

While a step is captured into CUDA graphs (``models/step_graph.py``), its
``trace_scope``s cut it into one graph per range (``set_recorder``), nothing
is traced or counted, and the work ``traced`` hands over runs eagerly at the
graphs' traced replays instead.
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


def time_steps(step, state, reps: int):
    """(last state, mean wall s per step) of ``reps`` calls of ``step``
    queued back to back after two warm-up calls (the first builds the
    kernels on first use, the second captures a graphed step), closed by one
    ``sync``."""
    for _ in range(2):
        state = step(state)
    sync(state.pos)
    t0 = time.perf_counter()
    for _ in range(reps):
        state = step(state)
    sync(state.pos)
    return state, (time.perf_counter() - t0) / reps


@dataclass
class StepTimer:
    """Accumulates per-step wall times, each closed by ``sync`` (in the
    profiler range ``runner.sync``: the host waiting for the device)."""

    times_s: list = field(default_factory=list)
    #: the indices of the times a caller marked warm-up (``box["warmup"]``)
    warmup: set = field(default_factory=set)

    @contextlib.contextmanager
    def step(self, result_to_sync: torch.Tensor | None = None):
        t0 = time.perf_counter()
        box = {}
        yield box
        t = box.get("sync", result_to_sync)
        if t is not None:
            with trace_scope("runner.sync"):
                sync(t)
        if box.get("warmup"):
            self.warmup.add(len(self.times_s))
        self.times_s.append(time.perf_counter() - t0)

    def mean_s(self, skip_first: int = 1) -> float:
        """Mean of the times after the first ``skip_first`` (the kernels'
        builds), less those marked warm-up; of all of them if none is
        left."""
        ts = [t for i, t in enumerate(self.times_s)
              if i >= skip_first and i not in self.warmup] or self.times_s
        return sum(ts) / len(ts)


_OFF = contextlib.nullcontext()
#: running totals of ``count``: host ints, or int64 tensors on the device
_totals: dict[str, int | torch.Tensor] = {}
#: the recorder of the step being captured, or None
_recorder = None


def set_recorder(recorder) -> None:
    """Hand every ``trace_scope`` and ``traced`` to ``recorder`` (its
    ``scope(name)`` and ``eager(name, fn)``) until it is set back to None."""
    global _recorder
    _recorder = recorder


def tracing() -> bool:
    """Whether a profiler is recording, outside a capture: the switch of
    ``trace_scope`` and ``count``."""
    return _recorder is None and torch._C._autograd._profiler_enabled()


def trace_scope(name: str):
    """Named profiler region (analog of wgpu push_debug_group): a
    ``record_function`` while a profiler records, else a shared no-op; in
    a capture, the recorder's cut."""
    if _recorder is not None:
        return _recorder.scope(name)
    return torch.profiler.record_function(name) if tracing() else _OFF


def traced(name: str, fn, *args) -> None:
    """Call ``fn(*args)`` in the range ``name`` while a profiler records; in
    a capture, hand both to the recorder, which calls it so at each traced
    replay."""
    if _recorder is not None:
        _recorder.eager(name, fn, args)
    elif tracing():
        with trace_scope(name):
            fn(*args)


def count(name: str, value: int | torch.Tensor) -> None:
    """Add ``value`` (an int, or a 0-d integer tensor) to the total
    ``name`` while a profiler records; nothing otherwise. A tensor's total
    stays on its device as int64, with no host read."""
    if not tracing():
        return
    if isinstance(value, torch.Tensor):
        value = value.to(torch.int64)
    total = _totals.get(name)
    _totals[name] = value if total is None else total + value


def counters() -> dict[str, int]:
    """{name: total} of every counter: one host read per device total, so
    call it after the traced window."""
    return {name: int(total) for name, total in _totals.items()}


def reset_counters() -> None:
    _totals.clear()
