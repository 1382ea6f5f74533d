"""Faults planted under the timed path, for the tests that see ``correct``
come out false (``run.py --plant <fault>``). Each patches the program in
this process, after the system under test is built and before its first
step; none is used by a measured run."""

from __future__ import annotations

import torch


def _frozen_step(runner):
    """A step that returns its state unchanged."""
    runner._step = lambda state: state


def _half_batch(runner):
    """The force of half of the receivers left out (zero), as if the step
    had computed only the other half."""
    from wgpu_n_body_tpu_torch.models import tree
    from wgpu_n_body_tpu_torch.parallel import sharded_tree

    leapfrog = tree.leapfrog_step

    def halved(force):
        def f(*args):
            acc = force(*args)
            acc = acc.clone()
            acc[acc.shape[0] // 2:] = 0.0
            return acc
        return f

    tree.leapfrog_step = lambda state, params, force: leapfrog(state, params, halved(force))
    rep_forces = sharded_tree.rep_forces

    def rep_halved(g, params, tp):
        acc, deferred = rep_forces(g, params, tp)
        acc = acc.clone()
        acc[acc.shape[0] // 2:] = 0.0
        return acc, deferred

    sharded_tree.rep_forces = rep_halved


def _no_exchange(runner):
    """The gathers between chips left out: each rank builds from its own
    slice, repeated."""
    from wgpu_n_body_tpu_torch.parallel import sharded_tree

    sharded_tree.all_gather = lambda x, size: torch.cat([x] * size)


def _altered_row(runner):
    """One output row's position altered where the step produces it."""
    step = runner._step

    def altered(state):
        out = step(state)
        pos = out.pos.clone()
        pos[min(7, pos.shape[0] - 1), 0] += 1e-3
        return out._replace(pos=pos)

    runner._step = altered


def _altered_pixel(runner):
    """One pixel of every frame altered where the viewer encodes it."""
    from wgpu_n_body_tpu_torch.runners import online

    encode = online.png_bytes

    def altered(img, level=6):
        img = img.copy()
        img[0, 0] ^= 1
        return encode(img, level=level)

    online.png_bytes = altered


FAULTS = {
    "frozen_step": _frozen_step,
    "half_batch": _half_batch,
    "no_exchange": _no_exchange,
    "altered_row": _altered_row,
    "altered_pixel": _altered_pixel,
}


def plant(name: str, runner) -> None:
    FAULTS[name](runner)
