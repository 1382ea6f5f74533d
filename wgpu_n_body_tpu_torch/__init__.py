"""wgpu_n_body_tpu_torch — the PyTorch/CUDA port of ``wgpu_n_body_tpu``.

The same layout and public names as the JAX package, which stays the
reference the port is held against:

- ``params``      value types and the numpy state bridge
- ``inits``       initial-condition generators (torch.Generator)
- ``models``      simulation backends: naive O(N^2), Barnes-Hut TreeSim
                  (group and per-particle walks), TreeSimHost
- ``ops``         forces (plain torch + the hand-written CUDA kernels in
                  ``csrc/``: all-pairs dx-form and factored, tree walks),
                  Morton keys, octree build, leapfrog, energy, the
                  renderer's raster, the LET export
- ``parallel``    multi-GPU schedules on ``torch.distributed`` (sharded
                  naive and tree, the LET export kernel's wrappers)
- ``runners``     headless step loop, trajectory IO, offline renderer,
                  online viewer, GIF writer
- ``utils``       profiling, checkpointing (format shared with JAX)
"""

from wgpu_n_body_tpu_torch.params import NaiveParams, ParticleState, SimParams, TreeParams

__all__ = ["SimParams", "NaiveParams", "TreeParams", "ParticleState"]

__version__ = "0.1.0"
