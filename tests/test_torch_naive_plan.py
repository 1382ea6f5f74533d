"""PyTorch port, all-pairs kernels (B1, B2): the launch plan, the build
cache's hash of included headers, and the development study's source
variants. The kernels themselves run only on the card (``chip_smoke.py``);
these are the parts of their launch that a CPU can check."""

import ctypes
import re
import stat
import types

import numpy as np
import pytest
import torch

from wgpu_n_body_tpu_torch.ops import cuda_build, naive_cuda
from wgpu_n_body_tpu_torch.utils import naive_study

H100_SMS = 132
#: The limits both forms' library reported on an NVIDIA H100 80GB HBM3
#: (chip_smoke.py phase 2): 128 threads a CTA, 256-source stages, and
#: resident CTAs of 128 threads per SM for 1, 2, 4 and 8 receivers per
#: thread (80 registers at 1; the 128-register cap at 2, 4 and 8).
H100 = naive_cuda.KernelLimits(128, 256, (1, 2, 4, 8), (6, 4, 4, 4))
CU_TEXT = naive_cuda.SOURCE.read_text()

# (receivers, sources, tile_i): the main path, the visualize scene, the
# size sweep's 2 x 8192, a small input, and receiver shards (a shard's
# receivers are rows [row_offset, row_offset + n_recv) of the sources)
CASES = [
    (262144, 262144, 512),
    (100000, 100000, 512),
    (16384, 16384, 512),
    (1000, 1000, 512),
    (1000, 1000, 64),
    (128, 256, 64),  # row_offset 64
    (65536, 262144, 512),  # a quarter shard, row_offset 65536
    (50000, 100000, 128),  # row_offset 25000
    (16384, 16384, 1024),
    (4097, 4097, 256),
]


def _cover(plan, n_recv, n_src):
    """How often each receiver and each source is taken by the plan's CTAs
    (CTA x, thread t, slot q: receiver x*tile + q*threads + t; slice y:
    sources [y*slice_len, (y+1)*slice_len))."""
    tile = plan.threads * plan.per_thread
    x = np.arange(plan.ctas)[:, None, None]
    q = np.arange(plan.per_thread)[None, :, None]
    t = np.arange(plan.threads)[None, None, :]
    rows = (x * tile + q * plan.threads + t).ravel()
    recv = np.bincount(rows[rows < n_recv], minlength=n_recv)
    src = np.zeros(n_src, np.int64)
    for y in range(plan.splits):
        lo, hi = y * plan.slice_len, min((y + 1) * plan.slice_len, n_src)
        assert lo < hi or n_src == 0, f"slice {y} is empty"
        src[lo:hi] += 1
    return recv, src


@pytest.mark.parametrize("n_recv,n_src,tile_i", CASES)
def test_plan_covers_every_receiver_and_source_once(n_recv, n_src, tile_i):
    plan = naive_cuda.plan_launch(n_recv, n_src, tile_i, H100_SMS, H100)
    recv, src = _cover(plan, n_recv, n_src)
    assert (recv == 1).all() and (src == 1).all()
    # no CTA without a receiver
    assert (plan.ctas - 1) * plan.threads * plan.per_thread < n_recv
    assert plan.slots == H100_SMS * H100.resident[H100.per_thread.index(plan.per_thread)]


@pytest.mark.parametrize("n_recv,n_src,tile_i", CASES)
def test_plan_splits_only_when_receiver_ctas_leave_slots_empty(n_recv, n_src, tile_i):
    plan = naive_cuda.plan_launch(n_recv, n_src, tile_i, H100_SMS, H100)
    empty = plan.ctas <= plan.slots - H100_SMS  # at least one slot per SM left empty
    if not empty:
        assert plan.splits == 1
    elif n_src >= 2 * H100.min_slice:
        assert plan.splits > 1
        assert plan.slice_len >= H100.min_slice
        # where the sources allow it, every slot gets a CTA
        if n_src // H100.min_slice * plan.ctas >= plan.slots:
            assert plan.ctas * plan.splits >= plan.slots


def test_plan_at_the_measured_sizes():
    """N=262144 needs no split (512 CTAs for 528 slots); the smaller sizes
    split so that every slot gets a CTA and the SMs get nearly equal
    shares: no SM runs a CTA more than the mean rounded up."""
    main = naive_cuda.plan_launch(262144, 262144, 512, H100_SMS, H100)
    assert (main.threads, main.per_thread, main.ctas, main.splits) == (128, 4, 512, 1)
    vis = naive_cuda.plan_launch(100000, 100000, 512, H100_SMS, H100)
    assert (vis.ctas, vis.splits, vis.slice_len) == (196, 4, 25000)
    sweep = naive_cuda.plan_launch(16384, 16384, 512, H100_SMS, H100)
    assert (sweep.ctas, sweep.splits, sweep.slice_len) == (32, 20, 820)
    for plan in (vis, sweep):
        per_sm = plan.ctas * plan.splits / H100_SMS
        assert plan.ctas * plan.splits >= plan.slots and per_sm > 0.95 * -(-per_sm // 1)
    # one more slice than the slots need leaves a tail: 17 x 32 CTAs put a
    # fifth CTA on 16 SMs (measured 15% slower than 16 or 20 slices, PERF.md)
    cost = lambda s: -(-32 * s // H100_SMS) / s  # noqa: E731
    assert cost(17) > naive_cuda.SPLIT_SLACK * cost(20)


@pytest.mark.parametrize("n_recv", [1, 31, 33, 100, 1000, 16384, 262144])
def test_plan_thread_counts_and_receivers_per_thread(n_recv):
    for tile_i in range(32, 1025, 32):
        plan = naive_cuda.plan_launch(n_recv, 4096, tile_i, H100_SMS, H100)
        assert 32 <= plan.threads <= 1024
        assert plan.threads <= H100.max_threads
        assert plan.per_thread in H100.per_thread
        assert tile_i % plan.per_thread == 0
        # tile_i keeps its meaning, receivers per CTA, unless the input is smaller
        assert plan.threads * plan.per_thread == min(tile_i, -(-n_recv // 32) * 32)


@pytest.mark.parametrize("kwargs", [{"tile_i": 48}, {"tile_i": 1056}])
def test_plan_rejects_bad_tiles(kwargs):
    with pytest.raises(ValueError):
        naive_cuda.plan_launch(1000, 1000, kwargs["tile_i"], H100_SMS, H100)


def test_wrapper_mirrors_the_kernel_constants():
    """The wrapper copies none of the kernel's constants: it plans with
    the limits its library reports, and the query names the instantiations
    that the launcher's switch launches."""
    for name in ("MAX_THREADS", "RESIDENT", "MIN_SLICE", "PER_THREAD"):
        assert not hasattr(naive_cuda, name)
    cases = [int(c) for c in re.findall(r"case (\d+): NAIVE_LAUNCH\(\1\);", CU_TEXT)]
    assert cases == [1 << k for k in range(4)]
    assert "per[k] = 1 << k;" in CU_TEXT
    assert 'extern "C" int naive_forces_limits' in CU_TEXT
    # one source, two forms, one shared pair term
    assert "extern \"C\" int naive_forces_launch" in CU_TEXT
    assert "extern \"C\" int naive_forces_mxu_launch" in CU_TEXT
    assert not (naive_cuda.SOURCE.parent / "naive_forces_mxu.cu").exists()
    header = cuda_build.CSRC / "pair_term.cuh"
    for src in (naive_cuda.SOURCE, cuda_build.CSRC / "tree_walk_group.cu"):
        assert cuda_build.included_headers(src) == [header.resolve()]
        assert "rsqrt.approx" not in src.read_text()  # written once, in the header


def test_profile_step_takes_the_naive_step():
    from wgpu_n_body_tpu_torch.utils.profile_step import RANGES, kernel_breakdown, main

    trace = [
        {"cat": "gpu_user_annotation", "name": "naive_step", "ts": 0, "dur": 100},
        {"cat": "kernel", "name": "naive_forces_kernel", "ts": 5, "dur": 80},
        {"cat": "kernel", "name": "cat", "ts": 1, "dur": 2},
    ]
    by_range, by_kernel, busy, span = kernel_breakdown(trace)
    assert by_range == {"naive_step": 82} and RANGES[0] == "naive_step"
    assert by_kernel[("naive_step", "naive_forces_kernel")] == 80
    assert main(["--sim", "naive"]) == 1  # no CUDA device here: refuses


def _fake_nvcc(tmp_path):
    """An executable that writes an empty file where ``-o`` points."""
    exe = tmp_path / "nvcc"
    exe.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                   '  if [ "$1" = "-o" ]; then shift; : > "$1"; fi\n  shift\ndone\n')
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return str(exe)


def test_build_cache_hashes_included_headers(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "inner.cuh").write_text("#define INNER 1\n")
    (csrc / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    source = csrc / "k.cu"
    source.write_text('#include <cuda_runtime.h>\n#include "outer.cuh"\n')
    monkeypatch.setattr(cuda_build, "nvcc", lambda: _fake_nvcc(tmp_path))
    assert cuda_build.included_headers(source) == [
        (csrc / "outer.cuh").resolve(), (csrc / "inner.cuh").resolve()]
    first, log = cuda_build.compile_cu(source, build, ["-O3"])
    assert first.exists() and log != "cached"
    assert cuda_build.compile_cu(source, build, ["-O3"]) == (first, "cached")
    # an edit to a header two includes deep names a new library: no stale load
    (csrc / "inner.cuh").write_text("#define INNER 2\n")
    second, log = cuda_build.compile_cu(source, build, ["-O3"])
    assert second != first and log != "cached"
    assert second.name.startswith("libk_") and first.exists()
    # and so do the flags
    assert cuda_build.library_path(source, build, ["-O2"]) != second


def test_naive_study_rewrites_each_launch_constant_once(tmp_path, monkeypatch):
    from wgpu_n_body_tpu_torch.ops import tree_walk_group_cuda as gcuda
    from wgpu_n_body_tpu_torch.utils.chip import variant_source

    monkeypatch.setattr(gcuda, "BUILD_DIR", tmp_path)
    assert variant_source({}, naive_cuda.SOURCE) == naive_cuda.SOURCE
    for var in naive_study.SWEEP[1:-1]:
        path = variant_source(var, naive_cuda.SOURCE)
        assert path.parent == tmp_path and path.name.startswith("naive_forces_")
        text = path.read_text()
        for name, value in var.items():
            assert f"constexpr int {name} = {value};" in text
        # the copy finds the shared header through the include path
        assert cuda_build.included_headers(path) == [
            (cuda_build.CSRC / "pair_term.cuh").resolve()]


def _fake_limits(calls, err=0):
    """A C function with the signature of naive_forces_limits that reports
    an H100-like card, counting its calls."""
    proto = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             *[ctypes.POINTER(ctypes.c_int)] * 4)

    def limits(factored, device, block, stage, per, resident):
        calls.append((factored, device))
        block[0], stage[0] = 128, 256
        for k in range(4):
            per[k], resident[k] = 1 << k, 16 >> k
        return err

    return proto(limits)


def test_kernel_limits_come_from_the_library_once_per_form(monkeypatch):
    calls = []
    lib = types.SimpleNamespace(naive_forces_limits=_fake_limits(calls))
    monkeypatch.setattr(naive_cuda, "_library", lambda: lib)
    monkeypatch.setattr(naive_cuda, "_limits", {})
    dev = torch.device("cuda", 0)  # named only: the fake library touches no card
    want = naive_cuda.KernelLimits(128, 256, (1, 2, 4, 8), (16, 8, 4, 2))
    assert naive_cuda.kernel_limits(dev) == want
    assert naive_cuda.kernel_limits(dev, mxu=True) == want
    assert naive_cuda.kernel_limits(dev) == want
    assert calls == [(0, 0), (1, 0)]  # one query per form
    # the plan takes the resident CTAs of the instantiation it launches
    plan = naive_cuda.plan_launch(262144, 262144, 512, H100_SMS, want)
    assert (plan.per_thread, plan.slots, plan.splits) == (4, 4 * H100_SMS, 1)
    plan = naive_cuda.plan_launch(1000, 1000, 64, H100_SMS, want)
    assert (plan.per_thread, plan.slots) == (1, 16 * H100_SMS)
    # a failed query raises, naming the CUDA error
    monkeypatch.setattr(naive_cuda, "_limits", {})
    lib.naive_forces_limits = _fake_limits([], err=98)
    with pytest.raises(RuntimeError, match="cudaError_t 98"):
        naive_cuda.kernel_limits(dev)
