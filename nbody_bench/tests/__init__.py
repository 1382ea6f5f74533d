"""CPU tests of the benchmark harness (``pytest nbody_bench/tests``)."""
