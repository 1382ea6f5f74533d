"""A tree step on one CUDA device, replayed from captured CUDA graphs: the
port's counterpart of the JAX runner's compiled chunk
(``wgpu_n_body_tpu/runners/headless.py::_compile_chunk``).

``TreeSim.make_step()`` returns a ``GraphedStep``, and so does
``ShardedTreeSim.make_step()`` under the ``replicated`` schedule, one per
rank: its captures hold the step's ``all_gather``s (NCCL captures
collectives; the first call, eager, makes the communicator), and every
rank replays in the same order. A CPU state goes to the eager step (the
simulator's ``step_fn()``). A CUDA state goes through the same step as a
body that writes the new state into a buffer it is given:

- the first call of a key (each field's shape, dtype and device, the
  ``SimParams`` and the ``TreeParams``) makes two state buffers, copies the
  state into one and runs the body from it into the other: every kernel is
  built and loaded;
- the second call runs the body once more on a side stream of the step's
  own (the tile set-up keeps a scratch per stream: it is made there, outside
  any graph), then captures the body twice, from each buffer into the other
  (``record``). A capture cuts the body at every profiler range it opens or
  closes (``utils/profiling.py::trace_scope``): one CUDA graph per innermost
  range (TreeSim's ``morton_keys``, ``morton_sort``, ``tree_build``,
  ``leapfrog.drift``, the walk's ranges, ``leapfrog.kick`` and
  ``overflow_flag``; the replicated step's ``rep_gather`` besides), and one
  for the work between ranges, all in one memory pool; a cut that captured
  nothing is dropped;
- every later call replays the graphs of the buffer the state is in, in
  order, each inside the ranges that were open around it, so a traced step's
  device work counts to the ranges an eager step's does. The walk's
  ``counters`` (``utils/profiling.py::traced``) stay outside every graph: a
  traced replay runs them eagerly between the walk's graphs and the kick's,
  on the walk's outputs of the capture, which each replay rewrites. They
  hold those outputs as views the caching allocator does not count
  (``unowned``): the second capture reuses the first's blocks, and the pool
  holds one step's work, not two.

A state in neither buffer (a rewind, a checkpoint, a caller's own tensors)
is first copied into the buffer the last step read, one ``copy_`` per
field. A state of another key starts over at the first call: it is never
replayed on graphs of another shape or other parameters.

Lifetime: a returned state lives in one of the two buffers. The next step,
handed it, reads it and writes the other buffer, so it stays valid until the
step after next overwrites its buffer; a step handed any other state writes
the buffer of the last state returned. A caller that keeps a state longer
copies it (to the host, or with ``clone``); work it enqueues on the state
before the next step is ordered on the stream and needs no copy.

Overflow: TreeSim's last graph (``overflow_flag``) ORs its build's overflow
flag into one device byte (``OverflowFlag``, the eager step's too) and
copies that byte into pinned host memory. ``TreeSim.raise_on_overflow``
reads the host byte after the synchronisation the runner makes anyway: no
read of a device tensor. ``ShardedTreeSim`` folds its health into one
device vector in place, which ``read_health`` reduces over the ranks.

Under ``torch.profiler`` each call counts ``step.steps`` and each replay
``step.replayed`` (``utils/profiling.py::count``); a CPU state's call counts
neither. ``plain=True`` runs the same bookkeeping on any device with no
graph: the capture records the cuts while it runs the body, and a replay
calls the body (the CPU tests' stand-in for the graphs).
"""

from __future__ import annotations

import contextlib
import itertools
import warnings
from typing import Callable, NamedTuple

import torch

from wgpu_n_body_tpu_torch.params import ParticleState
from wgpu_n_body_tpu_torch.utils import profiling
from wgpu_n_body_tpu_torch.utils.profiling import count, tracing

#: a profiler range as a cut knows it: (its opening's number, its name)
Range = tuple[int, str]


class Segment(NamedTuple):
    """One cut of a captured step: its CUDA graph (None where ``plain``, or
    for eager work), or the eager work ``eager(*args)`` that runs only at
    traced replays, and the ranges open around it, outermost first."""

    path: tuple[Range, ...]
    graph: object | None = None
    eager: Callable[..., None] | None = None
    args: tuple = ()


class Recorder:
    """Cuts the work of a body into ``Segment``s at every range it opens or
    closes, while ``utils/profiling.py`` hands it the body's
    ``trace_scope``s and ``traced`` work (``record``). With a graph pool it
    captures each cut into a CUDA graph of that pool, on the current stream,
    and keeps the cuts that captured something; without one (``plain``) it
    keeps the innermost ranges' cuts, the work running as it is cut. Every
    graph it made stays in ``held``: the pool lives as long as a graph of it
    does, so an empty one dropped would end the pool under the next capture."""

    def __init__(self, pool=None):
        self.pool = pool
        self.plan: list[Segment] = []
        self.held: list = []
        self._path: list[Range] = []
        self._numbers = itertools.count()
        self._graph = None
        self._innermost = False  # the open cut began at a range's opening

    def _begin(self, innermost: bool) -> None:
        self._innermost = innermost
        if self.pool is not None:
            self._graph = torch.cuda.CUDAGraph()
            self._graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def _end(self, closing: bool) -> None:
        if self.pool is None:
            if closing and self._innermost:
                self.plan.append(Segment(tuple(self._path)))
            return
        graph, self._graph = self._graph, None
        self.held.append(graph)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            graph.capture_end()
        if not any("empty" in str(w.message) for w in caught):
            self.plan.append(Segment(tuple(self._path), graph))

    @contextlib.contextmanager
    def scope(self, name: str):
        self._end(False)
        self._path.append((next(self._numbers), name))
        self._begin(True)
        try:
            yield
        finally:
            self._end(True)
            self._path.pop()
            self._begin(False)

    def eager(self, name: str, fn: Callable[..., None], args: tuple) -> None:
        self._end(False)
        self.plan.append(Segment((*self._path, (next(self._numbers), name)), None, fn, args))
        self._begin(False)


def record(body: Callable[[], object], pool=None) -> Recorder:
    """The ``Recorder`` of one call of ``body``: its ``plan``, the
    ``Segment``s, and the graphs it ``held``."""
    rec = Recorder(pool)
    rec._begin(False)
    profiling.set_recorder(rec)
    try:
        body()
    except BaseException:
        if rec._graph is not None:
            with contextlib.suppress(Exception):
                rec._graph.capture_end()
        raise
    finally:
        profiling.set_recorder(None)
    rec._end(False)
    return rec


def replay(plan: list[Segment]) -> None:
    """Replay a captured plan on the current stream: its graphs in order,
    each inside its ranges, and its eager work, while a profiler records."""
    if not tracing():
        for seg in plan:
            if seg.graph is not None:
                seg.graph.replay()
        return
    opened: list[tuple[Range, object]] = []
    try:
        for seg in plan:
            k = 0
            while k < min(len(opened), len(seg.path)) and opened[k][0] == seg.path[k]:
                k += 1
            while len(opened) > k:
                opened.pop()[1].__exit__(None, None, None)
            for rng in seg.path[k:]:
                ctx = torch.profiler.record_function(rng[1])
                ctx.__enter__()
                opened.append((rng, ctx))
            if seg.graph is not None:
                seg.graph.replay()
            else:
                seg.eager(*seg.args)
    finally:
        while opened:
            opened.pop()[1].__exit__(None, None, None)


class _Memory:
    """The memory of a CUDA tensor, offered through the CUDA array interface
    with no claim on it."""

    def __init__(self, t: torch.Tensor):
        self.__cuda_array_interface__ = {
            "shape": tuple(t.shape),
            "strides": tuple(s * t.element_size() for s in t.stride()),
            "typestr": torch.empty(0, dtype=t.dtype).numpy().dtype.str,
            "data": (t.data_ptr(), False),
            "version": 2,
        }


def unowned(x):
    """``x`` (a tensor, or tuples of them, named or not) with each CUDA
    tensor replaced by a view of its memory that the caching allocator does
    not count and that keeps no block alive: for a captured graph's outputs,
    whose memory its pool keeps and its replays rewrite."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(_Memory(x), device=x.device) if x.is_cuda else x
    if isinstance(x, tuple):
        parts = [unowned(v) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x


class OverflowFlag:
    """The arena overflow of every build on one device since the last
    ``take``: a device byte each step ORs its build's flag into, and its
    host copy, in pinned memory on a CUDA device, that the step's last
    operation refreshes (``publish``)."""

    def __init__(self, device: torch.device):
        self.acc = torch.zeros((), dtype=torch.bool, device=device)
        self.host = torch.zeros((), dtype=torch.bool, pin_memory=device.type == "cuda")
        self._view = self.host.numpy()  # read and reset with no torch op

    def publish(self, overflowed: torch.Tensor) -> None:
        """OR a build's () bool flag in and copy the byte to the host."""
        self.acc.logical_or_(overflowed)
        self.host.copy_(self.acc, non_blocking=True)

    def take(self) -> bool:
        """Whether a build overflowed since the last ``take``, as of the
        last step the host has waited for; resets both bytes when one did."""
        if not self._view:
            return False
        self._view[()] = False
        self.acc.zero_()
        return True


def step_key(sim, state: ParticleState) -> tuple:
    """What a capture holds fixed: each field's shape, dtype and device,
    and the simulator's parameters."""
    return (tuple((tuple(t.shape), t.dtype, t.device) for t in state), sim.sim_params,
            sim.add_params)


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


class GraphedStep:
    """A tree simulator's step to call in a loop (see the module's
    docstring): ``sim.step_fn()`` is a step ``(state, out)`` that writes the
    new state into the buffers ``out`` where it can."""

    def __init__(self, sim, plain: bool = False):
        self.sim = sim
        self.plain = plain
        self.eager = sim.step_fn()
        #: calls on the graphed path, replays among them, and bodies captured
        self.calls = self.replays = self.captures = 0
        self.key = None
        self.plans: dict[int, list[Segment]] | None = None
        self._last: int | None = None  # the buffer of the last state returned
        self._stream = None
        self._held: list = []  # every graph of the captures, the empty ones too

    def __call__(self, state: ParticleState) -> ParticleState:
        if not (self.plain or state.pos.is_cuda):
            return self.eager(state)
        self.calls += 1
        count("step.steps", 1)
        key = step_key(self.sim, state)
        if key != self.key:
            self._start(key, state)
            return self._run(self._copy_in(state))
        src = self._source(state)
        if self.plans is None:
            return self._capture(src)
        self.replays += 1
        count("step.replayed", 1)
        if self.plain:
            return self._run(src)
        replay(self.plans[src])
        return self._done(src)

    def _start(self, key, state: ParticleState) -> None:
        self.key, self.plans, self._last, self._held = key, None, None, []
        self.body = self.sim.step_fn()
        self.bufs = [ParticleState(*(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                                     for t in state)) for _ in range(2)]

    def _source(self, state: ParticleState) -> int:
        """The buffer ``state`` is in, else the one it is copied into."""
        for i, buf in enumerate(self.bufs):
            if all(a is b for a, b in zip(state, buf)):
                return i
        return self._copy_in(state)

    def _copy_in(self, state: ParticleState) -> int:
        """Copy ``state`` into the buffer the last step read (the other one
        if ``state`` lies in it); returns that buffer's index."""
        i = 0 if self._last is None else 1 - self._last
        if any(_shares(t, d) for t in state for d in self.bufs[i]):
            i = 1 - i
        dst = self.bufs[i]
        fields = [t.clone() if any(_shares(t, d) for d in self.bufs[i]) else t for t in state]
        for t, d in zip(fields, dst):
            d.copy_(t)
        return i

    def _body(self, src: int) -> None:
        """The step from buffer ``src`` into the other one; a field the body
        returns elsewhere is copied there."""
        out = self.bufs[1 - src]
        got = self.body(self.bufs[src], out)
        for t, d in zip(got, out):
            if t is not d:
                d.copy_(t)

    def _done(self, src: int) -> ParticleState:
        self._last = 1 - src
        return self.bufs[1 - src]

    def _run(self, src: int) -> ParticleState:
        self._body(src)
        return self._done(src)

    def _capture(self, src: int) -> ParticleState:
        """The second call: the body once more, then both captures."""
        if self.plain:
            plan = record(lambda: self._body(src)).plan
            self.plans, self.captures = {0: plan, 1: plan}, self.captures + 2
            return self._done(src)
        device = self.bufs[src].pos.device
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
        here = torch.cuda.current_stream(device)
        self._stream.wait_stream(here)
        with torch.cuda.stream(self._stream):
            self._body(src)
            torch.cuda.synchronize(device)
            pool = torch.cuda.graph_pool_handle()
            recs = {}
            for i in (src, 1 - src):
                rec = recs[i] = record(lambda i=i: self._body(i), pool)
                # before the next capture, which may then reuse their blocks
                rec.plan = [s._replace(args=unowned(s.args)) for s in rec.plan]
                self.captures += 1
        here.wait_stream(self._stream)
        self.plans = {i: rec.plan for i, rec in recs.items()}
        self._held = [g for rec in recs.values() for g in rec.held]
        return self._done(src)
