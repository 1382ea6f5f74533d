"""Morton re-sharding for the LET schedule — counterpart of
``wgpu_n_body_tpu/parallel/resharding.py``.

Under ``schedule="let"`` each rank keeps the particles it was given while
they move. The physics stays theta-correct under any drift (exports are
probed against the destinations' boxes of this step), but once ownership
regions inter-penetrate, exports grow toward whole remote trees and an
undersized ``let_cap`` overflows (loudly). Re-sharding restores compact
ownership: gather the state, sort it by the global Morton order (every
rank computes the same stable order) and keep this rank's 1/P slice. An
exact permutation of the system; O(N) transient bytes per rank, at the
cadence it runs (``reshard_every``).
"""

from __future__ import annotations

from wgpu_n_body_tpu_torch.ops.morton_cuda import morton_order_cuda
from wgpu_n_body_tpu_torch.params import ParticleState, TreeParams
from wgpu_n_body_tpu_torch.parallel.mesh import Mesh, gather_state, local_slice


def reshard(state: ParticleState, mesh: Mesh, tp: TreeParams | None = None) -> ParticleState:
    """This rank's slice of the whole state in the global Morton order
    (``resharding.py:42``; the key kernel and CUB's sort on the card)."""
    tp = tp or TreeParams()
    whole = gather_state(state, mesh)
    perm, _, _ = morton_order_cuda(whole.pos, tp.max_depth)
    mine = perm[local_slice(whole.n, mesh)].long()
    return ParticleState(*(t[mine] for t in whole))
