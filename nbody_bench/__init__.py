"""The benchmark of the PyTorch and CUDA port ``wgpu_n_body_tpu_torch``.

    python3 nbody_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root of the repository names the cells; each
cell's configuration, traffic mix and per-layer metrics are files of their
own here (``configs/``, ``traffic/``, ``metrics/``), found by name
(``spec.py``). The scenes are drawn from the seed (``scenes.py``), the step
loop and the viewer loop are driven and traced by ``drive.py`` and
``traces.py``, and ``check.py`` holds what the program produced against the
plain reference (``reference/``), which imports nothing of the program.
"""
