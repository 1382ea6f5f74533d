"""Multi-GPU schedules on ``torch.distributed`` — counterpart of
``wgpu_n_body_tpu/parallel``.

One process per rank (rank r on ``cuda:r`` under NCCL, or on the CPU under
gloo), each holding its contiguous particle slice; forces need every
source, so the schedules exchange them with collectives:

- naive: gather the old positions and masses (``allgather``), or rotate
  the source shards around the ranks (``ring``);
- tree: ``replicated`` (the whole system built on every rank, the walk
  sharded, O(N) per rank) or ``let`` (local builds and one exchange of
  locally-essential pruned subtrees, O(N/P) per rank: the scalable one).
"""

from wgpu_n_body_tpu_torch.parallel.let_tree import let_memory_bytes
from wgpu_n_body_tpu_torch.parallel.mesh import (
    PARTICLE_AXIS,
    gather_state,
    init_distributed,
    make_mesh,
    shard_state,
)
from wgpu_n_body_tpu_torch.parallel.sharded_naive import ShardedNaiveSim
from wgpu_n_body_tpu_torch.parallel.sharded_tree import ShardedTreeSim

__all__ = [
    "make_mesh",
    "shard_state",
    "ShardedNaiveSim",
    "ShardedTreeSim",
    "PARTICLE_AXIS",
    "let_memory_bytes",
    "init_distributed",
    "gather_state",
]
