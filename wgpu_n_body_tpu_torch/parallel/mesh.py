"""Process group and state sharding — counterpart of
``wgpu_n_body_tpu/parallel/mesh.py``.

The JAX package runs one controller over a device mesh (``shard_map``).
The port is SPMD: one process per rank, rank r on ``cuda:r`` (NCCL) or on
the CPU (gloo), each holding only its contiguous particle slice. A
``Mesh`` here is this process's view of the group: its rank, the world
size and its device. The collectives the schedules need are
``torch.distributed`` calls, wrapped below:

    lax.all_gather(..., tiled=True)   all_gather       (all_gather_into_tensor)
    lax.all_to_all                    all_to_all       (all_to_all_single)
    lax.ppermute                      ring_shift       (batch_isend_irecv)
    lax.pmax, lax.psum                all_reduce
    (the viewer's command to the ranks) broadcast
"""

from __future__ import annotations

import datetime
import socket
from typing import NamedTuple

import torch
import torch.distributed as dist

from wgpu_n_body_tpu_torch.params import ParticleState

PARTICLE_AXIS = "particles"


class Mesh(NamedTuple):
    """One rank's view of the 1-D particle mesh: its rank, the world size
    and the device its particles live on."""

    rank: int
    size: int
    device: torch.device

    @property
    def shape(self) -> dict:
        """{PARTICLE_AXIS: size}, the JAX ``Mesh.shape`` of this mesh."""
        return {PARTICLE_AXIS: self.size}


def free_port() -> int:
    """A TCP port free on this host, for the ranks' rendezvous
    (``tcp://localhost:<port>``)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def init_distributed(
    backend: str | None,
    rank: int,
    world_size: int,
    init_method: str,
    timeout_s: float = 600.0,
) -> None:
    """Join the process group (``torch.distributed.init_process_group``):
    NCCL when CUDA is available and ``backend`` is None, else gloo. Nothing
    on the machine tells a process of its cluster, so the address, the
    rank and the world size are the caller's. Idempotent: a process that is
    already in a group of the same size stays in it."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"already in a process group of {dist.get_world_size()} "
                               f"ranks, not {world_size}")
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(n_devices: int | None = None, device: str | torch.device | None = None) -> Mesh:
    """This rank's Mesh over the whole process group (``init_distributed``
    first). ``device`` defaults to ``cuda:<rank>`` under NCCL and the CPU
    under gloo. ``n_devices``, when given, must be the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    rank, size = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices asked in a group of {size} ranks")
    if device is None:
        device = f"cuda:{rank}" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(rank=rank, size=size, device=torch.device(device))


def local_slice(n: int, mesh: Mesh) -> slice:
    """Rank ``mesh.rank``'s rows of an N-row state. N must be divisible by
    the mesh size (pad upstream with zero-mass particles)."""
    if n % mesh.size != 0:
        raise ValueError(f"N={n} not divisible by mesh size {mesh.size}")
    n_local = n // mesh.size
    return slice(mesh.rank * n_local, (mesh.rank + 1) * n_local)


def shard_state(state: ParticleState, mesh: Mesh) -> ParticleState:
    """This rank's contiguous slice of a whole state, on ``mesh.device``."""
    rows = local_slice(state.n, mesh)
    return ParticleState(*(t[rows].contiguous().to(mesh.device) for t in state))


# ---------------------------------------------------------------- collectives


def all_gather(x: torch.Tensor, size: int) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in rank order (the tiled
    ``lax.all_gather``)."""
    out = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x.contiguous())
    return out


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Block j of ``x`` (its dim 0 split into world-size blocks) to rank j;
    the blocks received, in rank order (``lax.all_to_all(x, axis, 0, 0)``)."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous())
    return out


def ring_shift(tensors: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Send each tensor to rank + 1 and receive rank - 1's (``lax.ppermute``
    with the permutation s -> s + 1 mod P)."""
    nxt, prv = (mesh.rank + 1) % mesh.size, (mesh.rank - 1) % mesh.size
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, prv) for r in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def all_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` reduced over the ranks, ``op`` "max" or "sum" (``lax.pmax``,
    ``lax.psum``); returns the reduced tensor (x itself, in place)."""
    dist.all_reduce(x, op={"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[op])
    return x


def broadcast(x: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``x`` on every rank (in place; returns it)."""
    dist.broadcast(x, src=0)
    return x


def gather_state(state: ParticleState, mesh: Mesh) -> ParticleState:
    """The whole state from every rank's slice, in rank order, on every rank
    (rank 0 writes it: dumps, checkpoints, energy). A collective: every
    rank calls it."""
    return ParticleState(*(all_gather(t, mesh.size) for t in state))
