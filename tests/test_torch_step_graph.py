"""PyTorch port, the graphed TreeSim step (``models/step_graph.py``): its
bookkeeping on the CPU, with ``plain=True`` standing in for the CUDA graphs
(the capture records the cuts while it runs the body, a replay calls the
body). Replayed steps equal the eager step bit for bit through a rewind;
states ping-pong between two buffers and a state from elsewhere is copied
in; another shape or other parameters are captured again; the CPU path and
the other simulators keep their eager steps; an arena overflow raises at
the end of its batch, from the graphed or the eager step; ``step.steps``
and ``step.replayed`` count only under a profiler; a replay's counters
count the evaluated pairs by the rule; the runner's mean leaves out the
build and the capture."""

import dataclasses
import itertools

import pytest
import torch

from wgpu_n_body_tpu_torch.inits import disc_init, uniform_init
from wgpu_n_body_tpu_torch.models import NaiveSim, TreeSim, TreeSimHost
from wgpu_n_body_tpu_torch.models.base import Simulator
from wgpu_n_body_tpu_torch.models.step_graph import GraphedStep
from wgpu_n_body_tpu_torch.models.tree import _count_group
from wgpu_n_body_tpu_torch.ops.tree_walk_group import group_tree_forces
from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams
from wgpu_n_body_tpu_torch.parallel import ShardedTreeSim
from wgpu_n_body_tpu_torch.runners.headless import OfflineHeadless
from wgpu_n_body_tpu_torch.utils import profiling

N = 256
SP = SimParams(particle_num=N, g=1e-4)
TP = dict(max_depth=10, walk_tile=32)
CPU = [torch.profiler.ProfilerActivity.CPU]


def _scene(init=disc_init, n=N, seed=1):
    return init(torch.Generator().manual_seed(seed), dataclasses.replace(SP, particle_num=n),
                "cpu")


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _clone(state):
    return ParticleState(*(t.clone() for t in state))


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.mark.parametrize("walk", ["group", "per_particle"])
def test_replayed_steps_equal_the_eager_steps_through_a_rewind(walk):
    """12 steps, the state set back to the one after step 5 before step 10
    (the benchmark's rewind): every output bit-equal to the eager step's;
    outputs alternate between the two buffers, but for the rewind's, which
    goes to the buffer of the last output; a copy-in at the first step and
    at the rewind only; from the third step on every step a replay."""
    sim = TreeSim(SP, TreeParams(walk=walk, **TP))
    eager, graphed = TreeSim(SP, sim.add_params).step_fn(), GraphedStep(sim, plain=True)
    copied = []
    copy_in = graphed._copy_in
    graphed._copy_in = lambda state: copied.append(graphed.calls) or copy_in(state)
    a = b = _scene()
    last = None
    for i in range(1, 13):
        if i == 10:
            a, b = _clone(kept), _clone(kept)
        a, b = eager(a), graphed(b)
        assert _equal(a, b), f"step {i}"
        assert any(b is buf for buf in graphed.bufs) and (b is last) == (i == 10)
        last = b
        if i == 5:
            kept = _clone(b)
    assert copied == [1, 10]
    assert (graphed.calls, graphed.replays, graphed.captures) == (12, 10, 2)


def test_the_plan_cuts_the_step_at_its_ranges():
    """One cut per innermost range the CPU step opens, the counters as
    eager work between the walk and the kick."""
    sim = TreeSim(SP, TreeParams(**TP))
    step = GraphedStep(sim, plain=True)
    step(step(_scene()))
    plan = step.plans[0]
    assert [tuple(name for _, name in seg.path) for seg in plan] == [
        ("tree_step", r) for r in ("morton_keys", "morton_sort", "tree_build", "leapfrog.drift",
                                   "theta_walk", "counters", "leapfrog.kick", "overflow_flag")]
    assert [seg.eager is not None for seg in plan] == [False] * 5 + [True] + [False] * 2


def test_a_returned_state_lives_until_the_step_after_next():
    sim = TreeSim(SP, TreeParams(**TP))
    step = GraphedStep(sim, plain=True)
    s1 = step(_scene())
    kept = _clone(s1)
    s2 = step(s1)
    assert _equal(s1, kept) and s2 is not s1
    s3 = step(s2)
    assert s3 is s1  # the step after next writes its buffer
    other = _clone(s3)
    s4 = step(_scene(seed=2))  # another state: the buffer of the last state returned
    assert s4 is s3 and not _equal(s4, other)


@pytest.mark.parametrize("change", ["shape", "params"])
def test_another_shape_or_other_parameters_are_captured_again(change):
    sim = TreeSim(SP, TreeParams(**TP))
    step = GraphedStep(sim, plain=True)
    s = step(step(step(_scene())))
    assert (step.replays, step.captures) == (1, 2)
    if change == "shape":
        s, want_sim = _scene(n=N // 2), TreeSim(dataclasses.replace(SP, particle_num=N // 2),
                                              TreeParams(**TP))
    else:
        sim.add_params = TreeParams(theta=0.5, **TP)
        want_sim = TreeSim(SP, sim.add_params)
    eager = want_sim.step_fn()
    a = b = _clone(s)
    for _ in range(3):
        a, b = eager(a), step(b)
        assert _equal(a, b)
    assert (step.replays, step.captures) == (2, 4)  # a first call, a capture, a replay


def test_only_one_card_treesim_takes_the_graphed_step():
    """A CPU state goes to TreeSim's eager step, counting nothing; NaiveSim,
    TreeSimHost and ShardedTreeSim keep the base class's eager step."""
    sim = TreeSim(SP, TreeParams(**TP))
    step = sim.make_step()
    assert isinstance(step, GraphedStep)
    state = _scene()
    with torch.profiler.profile(activities=CPU):
        out = step(state)
    assert _equal(out, sim.step_fn()(state)) and step.calls == 0 and step.key is None
    assert "step.steps" not in profiling.counters()
    for cls in (NaiveSim, TreeSimHost, ShardedTreeSim):
        assert cls.make_step is Simulator.make_step
    assert not isinstance(NaiveSim(SP).make_step(), GraphedStep)


@pytest.mark.parametrize("chunk", [1, 3])
def test_an_overflow_raises_at_the_end_of_its_batch(chunk):
    """An arena of 0.4 N = 102 nodes holds the uniform scene (72 nodes) but
    not the same bodies shrunk 100-fold (123 nodes): handed in at the eighth
    step, the second of the third batch of 3, it raises when that batch
    ends, not before."""
    sim = TreeSim(SP, TreeParams(node_capacity_factor=0.4, **TP))
    fits = _scene(uniform_init)
    shrunk = fits._replace(pos=fits.pos * 1e-2)
    assert not sim.diagnose(fits)["overflowed"] and sim.diagnose(shrunk)["overflowed"]
    runner = OfflineHeadless(sim, lambda *_: ParticleState(*fits), device="cpu")
    step, calls = GraphedStep(sim, plain=True), itertools.count(1)
    runner._step = lambda state: step(shrunk if next(calls) == 8 else state)
    with pytest.raises(RuntimeError, match="arena overflow"):
        runner.run(12, chunk=chunk)
    assert runner.step_num == (8 if chunk == 1 else 9)
    flag = sim.overflow_flag(torch.device("cpu"))
    assert step.replays > 0 and not flag._view and not flag.acc  # read and reset


def test_the_eager_step_raises_an_overflow_through_the_same_flag():
    """``step_fn()`` ORs its build's overflow into the flag the graphed step
    uses: the runner raises at the end of the batch, and the flag is read
    and reset."""
    sim = TreeSim(SP, TreeParams(node_capacity_factor=0.4, **TP))
    fits = _scene(uniform_init)
    shrunk = fits._replace(pos=fits.pos * 1e-2)
    runner = OfflineHeadless(sim, lambda *_: ParticleState(*fits), device="cpu")
    step, calls = sim.step_fn(), itertools.count(1)
    runner._step = lambda state: step(shrunk if next(calls) == 5 else state)
    with pytest.raises(RuntimeError, match="arena overflow"):
        runner.run(9, chunk=3)
    assert runner.step_num == 6
    flag = sim.overflow_flag(torch.device("cpu"))
    assert not flag._view and not flag.acc
    sim.raise_on_overflow()  # nothing since the last read


def test_step_counters_count_only_under_a_profiler():
    sim = TreeSim(SP, TreeParams(**TP))
    step = GraphedStep(sim, plain=True)
    s = step(step(_scene()))  # the first call and the capture
    assert profiling.counters() == {}
    with torch.profiler.profile(activities=CPU):
        s = step(step(s))
    got = profiling.counters()
    assert (got["step.steps"], got["step.replayed"]) == (2, 2)
    assert got["walk.receivers"] == 2 * N


def test_a_walk_that_counted_nothing_counts_its_evaluated_pairs_by_the_rule():
    """A captured walk's evaluation counts nothing (``eval_pairs`` None):
    its ``counters`` at a traced replay count ``walk.eval_pairs`` by the
    rule from its lists, equal to the count of the walk that counted."""
    tp = TreeParams(**TP)
    sim = TreeSim(SP, tp)
    ss, tree, keys = sim._sort_build(_scene())
    with torch.profiler.profile(activities=CPU):
        _, stats = group_tree_forces(ss.pos, ss.pos, ss.mass, tree, keys, SP, tp)
        _count_group(stats, N)
        counted = profiling.counters()
        profiling.reset_counters()
        _count_group(stats._replace(eval_pairs=None), N)
    assert stats.eval_pairs is not None and profiling.counters() == counted
    assert counted["walk.eval_pairs"] >= counted["walk.pairs"] > 0


@pytest.mark.parametrize("chunk", [1, 2])
def test_the_runner_leaves_a_graphed_step_s_build_and_capture_out_of_its_mean(chunk):
    """The batches that built or captured the graphed step are marked
    warm-up and left out of ``StepTimer.mean_s``; another step's first
    batch alone is left out."""
    sim = TreeSim(SP, TreeParams(**TP))
    runner = OfflineHeadless(sim, lambda *_: _scene(), device="cpu")
    runner._step = GraphedStep(sim, plain=True)
    runner.run(6, chunk=chunk)
    assert runner.timer.warmup == ({0, 1} if chunk == 1 else {0})
    runner.timer.times_s = [10.0, 10.0] + [1.0] * (len(runner.timer.times_s) - 2)
    assert runner.timer.mean_s() == (1.0 if chunk == 1 else 5.5)  # chunk 2: (10 + 1) / 2
    eager = OfflineHeadless(NaiveSim(SP), lambda *_: _scene(), device="cpu")
    eager.run(3)
    assert eager.timer.warmup == set()
    eager.timer.times_s = [10.0, 1.0, 1.0]
    assert eager.timer.mean_s() == 1.0
