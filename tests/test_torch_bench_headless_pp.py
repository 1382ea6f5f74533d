"""PyTorch port, upstream's own TreeSim walk (one walk per body,
tree.wgsl:41-111) at its headless demo's N=4M and θ=0.75 as the benchmark
runs it: the cell ``headless-4m-per-particle``, whose configuration is
``tree-headless-4m``'s with ``walk="per_particle"``. ``nbody_bench/run.py``
runs it at a small N on the CPU through ``TreeSim`` and ``OfflineHeadless``
and holds it to the plain reference by the configuration's limits; the
bfloat16 control fails them. The port's per-particle forces are held to the
benchmark's plain θ-walk reference (``nbody_bench/reference/theta_walk.py``)
on a step of a moving scene."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nbody_bench import check, scenes
from nbody_bench.reference import octree, step, theta_walk
from wgpu_n_body_tpu_torch.models import TreeSim
from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams

ROOT = Path(__file__).resolve().parents[1]
CELL = "headless-4m-per-particle"
CONFIG = ROOT / "nbody_bench" / "configs" / "tree-headless-4m-per-particle.json"
#: per-row |a - a_ref| / |a_ref| of the plain walk (float32 terms and sums,
#: IEEE sqrt and divides) against the reference's float64 sums of the same
#: interactions: a row sums a few hundred terms, each rounded to ~6e-8, which
#: read at most 4.3e-6 (p99 1.1e-6) on these scenes; a walk in bfloat16 or one
#: that drops or adds a node per receiver is off by 1e-3 or more
ROW_P99, ROW_MAX = 1e-5, 1e-4


def _run(*extra, seed=3000000019):
    cmd = [sys.executable, str(ROOT / "nbody_bench" / "run.py"), "--workload", CELL,
           "--seed", str(seed), "--seconds", "0.2", "--trace", "0", "--device", "cpu",
           "--set", "particle_num=2048", *extra]
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_the_configuration_is_tree_headless_4m_with_the_per_particle_walk():
    cfg = json.loads(CONFIG.read_text())
    base = json.loads((ROOT / "nbody_bench" / "configs" / "tree-headless-4m.json").read_text())
    assert cfg["tree_params"] == dict(base["tree_params"], walk="per_particle")
    assert {k: v for k, v in cfg.items() if k not in ("tree_params", "source", "assumed")} == {
        k: v for k, v in base.items() if k not in ("tree_params", "source", "assumed")}
    assert cfg["sim_params"]["particle_num"] == 4_000_000 and cfg["reduced"] == []
    assert cfg["tree_params"]["theta"] == 0.75
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "tree-headless-4m-per-particle", "steps-uniform", 1)
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    assert entry["file"] == "nbody_bench/configs/tree-headless-4m-per-particle.json"
    assert entry["source"] == cfg["source"] and entry["reduced"] == []


@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_the_cell_is_correct_and_its_control_is_not(control):
    res = _run(*(["--control"] if control else []))
    assert res["correct"] is (not control), res["checks"]
    if control:
        assert res["checks"]["start.rows_off"]["value"] > 0
    else:
        limit = json.loads(CONFIG.read_text())["guarantees"]["force_err_max"]
        assert res["checks"]["window.force_err"] == {"value": res["metrics"]["force_err"]["value"],
                                                     "limit": limit}


@pytest.mark.parametrize("kind,theta", [("uniform", 0.75), ("disc", 0.75), ("uniform", 0.5),
                                        ("disc", 0.5)])
def test_per_particle_forces_agree_with_the_theta_walk_reference(kind, theta):
    """One ``TreeSim`` step of a moving scene; the reference sorts, drifts
    and walks the step's input on its own (``octree.build``), so both walk
    the same nodes: every checked receiver's interactions equal, its force
    within the float32 rounding of its sums."""
    n, g, e, dt = 3000, 1e-3, 1e-4, 0.016
    sp = SimParams(particle_num=n, g=g, e=e, dt=dt)
    tp = TreeParams(theta=theta, walk="per_particle")
    pre = scenes.draw(kind, 4000000007, n, g, torch.device("cpu"))
    out = TreeSim(sp, tp).step_fn()(ParticleState(*pre))
    (keys, bound), s = check._sorted_input(dict(zip(check.FIELDS, pre)),
                                           {"tree_params": {"max_depth": tp.max_depth},
                                            "guarantees": {"morton_reorder_every_step": True}},
                                           torch.float32)
    _, pos_new = step.drift(s["pos"], s["vel"], s["acc"], dt)
    assert torch.equal(out.pos, pos_new)
    idx = check.sample_rows(5, n, 1024)
    levels = octree.build(keys, s["pos"], s["mass"], bound, tp.max_depth, tp.leaf_bucket)
    want, inter = theta_walk.forces(levels, s["pos"], s["mass"], pos_new[idx], idx, theta,
                                    g, e, dt, block=300)
    assert torch.equal(inter, octree.interactions(levels, pos_new[idx], theta))
    rel = ((out.acc[idx].double() - want).norm(dim=1) / want.norm(dim=1)).numpy()
    assert np.percentile(rel, 99) <= ROW_P99 and rel.max() <= ROW_MAX, (
        np.percentile(rel, 99), rel.max())
    # a bfloat16 receiver misses by far more than the tolerance
    coarse, _ = theta_walk.forces(levels, s["pos"], s["mass"],
                                  pos_new[idx].bfloat16().float(), idx, theta, g, e, dt)
    rel_c = ((coarse - want).norm(dim=1) / want.norm(dim=1)).numpy()
    assert np.percentile(rel_c, 99) > 100 * ROW_P99
