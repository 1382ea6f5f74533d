"""Small and odd inputs of the octree build, as numpy states from a seed.

The CPU tests hold the plain version against the JAX package on them, and
``chip_smoke.py`` holds the kernels against the plain version on the card
on the same ones: sizes below the bucket, the depths either side of the
(hi, lo) key split, all bodies in one overfull max-depth cell, an arena
that overflows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BuildCase(NamedTuple):
    """One input of the build: ``state`` holds ``pos``/``vel``/``acc``/
    ``mass`` float32 arrays, ``tree_kw`` the TreeParams fields that differ
    from the defaults."""

    name: str
    state: dict
    tree_kw: dict


def _state(pos: np.ndarray, rng: np.random.Generator) -> dict:
    n = pos.shape[0]
    zeros = np.zeros((n, 3), np.float32)
    return {"pos": pos.astype(np.float32), "vel": zeros, "acc": zeros.copy(),
            "mass": rng.uniform(0.5, 2.0, n).astype(np.float32)}


def _uniform(seed: int, n: int, span: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return _state(rng.uniform(-span, span, (n, 3)), rng)


def _clustered(seed: int, n: int) -> dict:
    """Half the bodies uniform, half in tight pairs 1e-6 apart: deep cells."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.0, 1.0, (n // 2, 3)).astype(np.float32)
    return _state(np.concatenate([base, base + np.float32(1e-6)]), rng)


def _one_point(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    return _state(np.full((n, 3), 0.25, np.float32), rng)


def build_cases() -> list[BuildCase]:
    """The cases, each made anew from its seed."""
    return [
        BuildCase("n1", _uniform(31, 1), {}),
        BuildCase("n2", _uniform(32, 2), {"leaf_bucket": 1}),
        BuildCase("below_bucket", _uniform(33, 10), {}),
        BuildCase("depth4", _uniform(34, 300), {"max_depth": 4, "leaf_bucket": 4}),
        BuildCase("depth10", _clustered(35, 300), {"max_depth": 10, "leaf_bucket": 1}),
        BuildCase("depth20", _clustered(36, 300), {"max_depth": 20, "leaf_bucket": 1}),
        BuildCase("bucket32", _uniform(37, 700, span=2.5), {"leaf_bucket": 32}),
        BuildCase("one_point", _one_point(38, 40), {"max_depth": 6}),
        BuildCase("overflow", _clustered(39, 64),
                  {"leaf_bucket": 1, "node_capacity_factor": 1}),
    ]
