"""Multi-GPU Barnes-Hut — counterpart of ``wgpu_n_body_tpu/parallel/sharded_tree.py``.

Two schedules, each split as the JAX package splits it (``_schedule_fns``)
into per-rank stages with the collectives between them. The stages are
plain functions on tensors: ``ShardedTreeSim`` calls them with
``torch.distributed`` collectives in between, and a single process can
call them for P emulated ranks in turn, doing the exchange by hand.

``replicated`` (``rep_prologue``/``rep_forces``): one gather of (pos, vel_h,
mass) per step; every rank sorts and builds the whole system the same way
(the key kernel, CUB's sort, the kernels of B5), then walks only its 1/P
slice of the sorted receivers: the group walk B4 with ``gid_offset`` =
the slice's start (B3 with ``self_idx`` for ``walk="per_particle"``).
O(N) memory per rank.

``let`` (the scalable one): each rank keeps its own slice.
  1. ``let_sort_build``: a local sort and build against the bound reduced
     over the ranks (``all_reduce`` MAX), so that cells align;
  2. ``receiver_box``, gathered from every rank (``all_gather``);
  3. ``let_export``: the export walk B7 to each rank's box;
  4. one ``all_to_all`` of the wire arrays (``exchange``);
  5. ``let_forces``: the split walk of the JAX default (``walk_engine=
     "octet"``, ``let_fused=False``): B4 over the local tree, and B4 over the
     import forest with the reduced list budget
     (``effective_import_list_cap``) and receivers numbered past every
     import source (``gid_offset = P * let_cap``); the two forces added.
     ``walk="per_particle"`` walks one concatenated forest with B3.
O(N / P + P * let_cap) memory per rank.

Every step's health (``[build_overflow, let_overflow, walk_deferred,
let_rows_max]``, ``sharded_tree.py:332-340``) stays on the device, folded
over the steps since it was last read; ``read_health`` reduces it over the
ranks with ``all_reduce`` once per chunk, after the synchronisation the
chunk ends with anyway. ``let_fused=True`` (the fused walk with import
octet tables) is not ported (ROADMAP B8) and raises.

Like TreeSim, every step reorders particles: globally (replicated) or
within each rank's slice (let).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from wgpu_n_body_tpu_torch.models.base import Simulator, StepFn
from wgpu_n_body_tpu_torch.models.tree import check_walk_tile, validate_tree_params
from wgpu_n_body_tpu_torch.ops import morton
from wgpu_n_body_tpu_torch.ops.morton_cuda import morton_order_cuda
from wgpu_n_body_tpu_torch.ops.tree_build import FAR, TreeArrays, morton_order, reorder
from wgpu_n_body_tpu_torch.ops.tree_build_cuda import build_tree_cuda
from wgpu_n_body_tpu_torch.ops.tree_walk_cuda import tree_forces_cuda
from wgpu_n_body_tpu_torch.ops.tree_walk_group_cuda import group_tree_forces_cuda
from wgpu_n_body_tpu_torch.params import ParticleState, SimParams, TreeParams
from wgpu_n_body_tpu_torch.parallel import resharding
from wgpu_n_body_tpu_torch.parallel.let_tree import (
    LetExport,
    assemble_forest,
    assemble_import_forest,
    auto_let_cap,
    export_walk,
    import_from_wire,
    wire_arrays,
)
from wgpu_n_body_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_reduce,
    all_to_all,
    shard_state,
)
from wgpu_n_body_tpu_torch.utils.profiling import trace_scope

SCHEDULES = ("replicated", "let")


# ------------------------------------------------------------ LET stages


class LetLocal(NamedTuple):
    """One rank's local sort and build (``let_prologue`` before the
    exchange): the sorted slice, its packed keys, its arena and the
    drifted receivers."""

    pos_s: torch.Tensor
    velh_s: torch.Tensor
    mass_s: torch.Tensor
    keys: torch.Tensor
    tree: TreeArrays
    pos_new: torch.Tensor


def let_bound(pos: torch.Tensor) -> torch.Tensor:
    """This rank's max(1, max |pos|), (1,) float32: reduced with MAX over the
    ranks it is the bound every rank's cells are cut from."""
    return morton.bound_of(pos).reshape(1)


def let_sort_build(state: ParticleState, bound: torch.Tensor, params: SimParams,
                   tp: TreeParams) -> LetLocal:
    """Half-kick, the local Morton sort against the global ``bound``, the
    build over the slice and the drift (``sharded_tree.py:81-111``)."""
    vel_h = state.vel + state.acc * (params.dt / 2.0)
    bound = bound.reshape(())
    perm, bound, keys = morton_order_cuda(state.pos, tp.max_depth, bound)
    with trace_scope("tree_build"):
        # the reorder gathers vel_h in the vel and acc slots (acc is unread)
        ss, tree = build_tree_cuda(ParticleState(state.pos, vel_h, vel_h, state.mass), perm,
                                   keys, bound, tp)
    pos_new = ss.pos + ss.vel * params.dt
    return LetLocal(ss.pos, ss.vel, ss.mass, keys, tree, pos_new)


def receiver_box(pos_new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo (1, 3), hi (1, 3)): the bounds of this rank's drifted receivers."""
    return pos_new.amin(0, keepdim=True), pos_new.amax(0, keepdim=True)


def let_export(local: LetLocal, box_lo: torch.Tensor, box_hi: torch.Tensor, rank: int,
               tp: TreeParams, let_cap: int) -> LetExport:
    """B7: the pruned subtree of this rank's tree for every rank's box."""
    with trace_scope("let_export"):
        return export_walk(local.tree, local.pos_s, local.mass_s, box_lo, box_hi, rank,
                           tp.theta, let_cap)


def _wire(exp: LetExport):
    """The wire arrays, n_rows and overflow as one (P, 2) int32."""
    nodes, skip, n_rows, overflow = wire_arrays(exp)
    return nodes, skip, torch.stack([n_rows, overflow.to(torch.int32)], 1)


def _unwire(nodes, skip, meta) -> LetExport:
    return import_from_wire(nodes, skip, meta[:, 0].contiguous(), meta[:, 1] != 0)


def exchange(exp: LetExport) -> LetExport:
    """The imports of this rank: buffer s holds rank s's export to it. One
    ``all_to_all`` per wire array (``sharded_tree.py:113-122``)."""
    with trace_scope("let_exchange"):
        return _unwire(*(all_to_all(x) for x in _wire(exp)))


def exchange_by_hand(exports: list[LetExport]) -> list[LetExport]:
    """What ``exchange`` gives each of P emulated ranks, from their exports
    in rank order: rank r's import buffer s is rank s's buffer r."""
    wires = [_wire(e) for e in exports]
    return [
        _unwire(*(torch.stack([w[k][r] for w in wires]) for k in range(3)))
        for r in range(len(exports))
    ]


def let_forces(local: LetLocal, imp: LetExport, params: SimParams, tp: TreeParams,
               p: int, let_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(acc, deferred receivers) of the local receivers from the local tree
    and the imports (``sharded_tree.py:126-236``): the split walk for
    ``walk="group"``, one per-particle walk of the concatenated forest
    otherwise (deferred 0)."""
    n_local = local.pos_s.shape[0]
    parts_pos = imp.parts[:, :, :3].reshape(-1, 3).contiguous()
    parts_mass = imp.parts[:, :, 3].reshape(-1).contiguous()
    if tp.walk == "group":
        with trace_scope("let_local_walk"):
            acc_loc, s1 = group_tree_forces_cuda(local.pos_new, local.pos_s, local.mass_s,
                                                 local.tree, local.keys, params, tp)
        with trace_scope("let_import_walk"):
            tp_imp = dataclasses.replace(tp, walk_list_cap=tp.effective_import_list_cap())
            acc_imp, s2 = group_tree_forces_cuda(
                local.pos_new, parts_pos, parts_mass, assemble_import_forest(imp), local.keys,
                params, tp_imp, gid_offset=p * let_cap, recv_split=local.tree.split,
            )
        return acc_loc + acc_imp, s1.deferred + s2.deferred
    dev = local.pos_s.device
    forest, _ = assemble_forest(local.tree, imp, n_local)
    src_pos = torch.cat([local.pos_s, torch.full((1, 3), FAR, device=dev), parts_pos])
    src_mass = torch.cat([local.mass_s, torch.zeros(1, device=dev), parts_mass])
    idx = torch.arange(n_local, dtype=torch.int32, device=dev)
    with trace_scope("let_forest_walk"):
        acc = tree_forces_cuda(local.pos_new, src_pos, src_mass, forest, params, tp,
                               self_idx=idx)
    return acc, torch.zeros((), dtype=torch.int32, device=dev)


# ------------------------------------------------------ replicated stages


class RepGlobal(NamedTuple):
    """The whole sorted system and its arena, as every rank builds it, with
    this rank's slice of receivers."""

    pos_s: torch.Tensor
    mass_s: torch.Tensor
    tree: TreeArrays
    keys_l: torch.Tensor
    velh_l: torch.Tensor
    pos_new: torch.Tensor
    start: int


def rep_prologue(pos_all: torch.Tensor, velh_all: torch.Tensor, mass_all: torch.Tensor,
                 rank: int, size: int, params: SimParams, tp: TreeParams) -> RepGlobal:
    """The deterministic global sort and build of the gathered (pos, vel_h,
    mass), and this rank's slice of the sorted receivers, drifted
    (``sharded_tree.py:238-274``)."""
    perm, bound, keys = morton_order_cuda(pos_all, tp.max_depth)
    with trace_scope("tree_build"):
        # the reorder gathers vel_h in the vel and acc slots (acc is unread)
        ss, tree = build_tree_cuda(ParticleState(pos_all, velh_all, velh_all, mass_all), perm,
                                   keys, bound, tp)
    n_local = ss.n // size
    rows = slice(rank * n_local, (rank + 1) * n_local)
    velh_l = ss.vel[rows]
    return RepGlobal(ss.pos, ss.mass, tree, keys[rows], velh_l,
                     ss.pos[rows] + velh_l * params.dt, rows.start)


def rep_forces(g: RepGlobal, params: SimParams, tp: TreeParams):
    """(acc, deferred receivers) of this rank's slice from the global tree
    (``sharded_tree.py:276``): receivers local, sources and self indices
    global."""
    with trace_scope("theta_walk"):
        if tp.walk == "group":
            acc, stats = group_tree_forces_cuda(g.pos_new, g.pos_s, g.mass_s, g.tree, g.keys_l,
                                                params, tp, gid_offset=g.start)
            return acc, stats.deferred
        n_local = g.pos_new.shape[0]
        idx = torch.arange(g.start, g.start + n_local, dtype=torch.int32,
                           device=g.pos_new.device)
        acc = tree_forces_cuda(g.pos_new, g.pos_s, g.mass_s, g.tree, params, tp, self_idx=idx)
        return acc, torch.zeros((), dtype=torch.int32, device=acc.device)


# ------------------------------------------------------------------- sim


def _health_vec(build_ov, let_ov, deferred, rows_max) -> torch.Tensor:
    """[build_overflow, let_overflow, walk_deferred, let_rows_max], (4,) int64.
    A plain number is filled in on the device: copying it from the host
    would wait for the device's queued work."""
    dev = deferred.device
    return torch.stack([
        (x if isinstance(x, torch.Tensor) else torch.full((), x, device=dev)).to(torch.int64)
        for x in (build_ov, let_ov, deferred, rows_max)
    ])


def _fold(a: torch.Tensor | None, b: torch.Tensor) -> torch.Tensor:
    """Two health vectors as one: flags and rows by max, deferrals summed."""
    if a is None:
        return b
    return torch.stack([torch.maximum(a[0], b[0]), torch.maximum(a[1], b[1]), a[2] + b[2],
                        torch.maximum(a[3], b[3])])


def _reduce(h: torch.Tensor) -> dict:
    """A health vector reduced over the ranks (max, max, sum, max) and read
    on the host: ``diagnose``'s dict."""
    mx = all_reduce(h[[0, 1, 3]].clone(), "max")
    sm = all_reduce(h[2:3].clone(), "sum")
    return {
        "overflowed": bool(mx[0]),
        "let_overflowed": bool(mx[1]),
        "walk_deferred": int(sm[0]),
        "let_export_rows_max": int(mx[2]),
    }


def _resolve_let_cap(let_cap: int | None, params: SimParams, mesh: Mesh, tp: TreeParams) -> int:
    if let_cap is not None:
        return let_cap
    return auto_let_cap(params.particle_num // mesh.size, tp.theta)


class ShardedTreeSim(Simulator):
    """Multi-GPU TreeSim: one instance per rank, stepping that rank's slice.

    schedule="replicated": the whole system built on every rank, the walk
    sharded, O(N) per rank. schedule="let": local builds and the
    locally-essential-subtree exchange, O(N/P) per rank.
    """

    def __init__(self, sim_params: SimParams, mesh: Mesh, add_params: TreeParams | None = None,
                 schedule: str = "replicated", let_cap: int | None = None):
        super().__init__(sim_params)
        tp = add_params or TreeParams()
        validate_tree_params(tp)
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}")
        if tp.let_fused:
            raise NotImplementedError("let_fused=True (--fused-let-walk, the fused LET walk with "
                                      "import octet tables) is not yet ported (ROADMAP B8)")
        if sim_params.particle_num % mesh.size:
            raise ValueError(f"N={sim_params.particle_num} not divisible by mesh size {mesh.size}")
        check_walk_tile(tp, sim_params.particle_num // mesh.size, mesh.device)
        self.mesh = mesh
        self.add_params = tp
        self.schedule = schedule
        # resolved now, so that checkpoints record the int
        self.let_cap = _resolve_let_cap(let_cap, sim_params, mesh, tp)
        self._import_list_cap = tp.let_import_list_cap  # what a reshard returns to
        self._health: torch.Tensor | None = None

    def _run(self, state: ParticleState, walk: bool):
        """One step's stages on this rank: (new state, or None without the
        walk; health vector of this rank)."""
        params, tp, mesh = self.sim_params, self.add_params, self.mesh
        half = params.dt / 2.0
        if self.schedule == "let":
            bound = all_reduce(let_bound(state.pos), "max")
            local = let_sort_build(state, bound, params, tp)
            lo, hi = receiver_box(local.pos_new)
            exp = let_export(local, all_gather(lo, mesh.size), all_gather(hi, mesh.size),
                             mesh.rank, tp, self.let_cap)
            imp = exchange(exp)
            rows_max, let_ov = exp.n_rows.max(), exp.overflow.any()
            if not walk:
                return None, _health_vec(local.tree.overflowed, let_ov, torch.zeros(
                    (), dtype=torch.int32, device=rows_max.device), rows_max)
            acc, deferred = let_forces(local, imp, params, tp, mesh.size, self.let_cap)
            health = _health_vec(local.tree.overflowed, let_ov, deferred, rows_max)
            return ParticleState(local.pos_new, local.velh_s + acc * half, acc,
                                 local.mass_s), health
        vel_h = state.vel + state.acc * half
        g = rep_prologue(all_gather(state.pos, mesh.size), all_gather(vel_h, mesh.size),
                         all_gather(state.mass, mesh.size), mesh.rank, mesh.size, params, tp)
        zero = torch.zeros((), dtype=torch.int32, device=g.pos_s.device)
        if not walk:
            return None, _health_vec(g.tree.overflowed, False, zero, 0)
        acc, deferred = rep_forces(g, params, tp)
        mass_l = g.mass_s[g.start : g.start + acc.shape[0]]
        return (ParticleState(g.pos_new, g.velh_l + acc * half, acc, mass_l),
                _health_vec(g.tree.overflowed, False, deferred, 0))

    def step_fn(self) -> StepFn:
        """The step (it reads ``add_params`` at every call, so an escalated
        import budget takes effect at the next step). Its health is folded
        into this rank's record until ``read_health``."""

        def step(state: ParticleState) -> ParticleState:
            with trace_scope("sharded_tree_step"):
                new, health = self._run(state, walk=True)
            self._health = _fold(self._health, health)
            return new

        return step

    def init_state(self, generator, init_fn, device=None) -> ParticleState:
        """This rank's slice of the scene ``init_fn`` draws on the CPU from
        ``generator`` (the same scene on every rank), on the mesh's device.
        Under ``let`` the slices are those of the global Morton order, as a
        reshard leaves them: in the draw's order every rank's box would be
        the whole scene and its first exports the whole tree (the JAX
        package starts so, and overflows at scale)."""
        whole = init_fn(generator, self.sim_params, "cpu")
        if self.schedule == "let":
            whole = reorder(whole, morton_order(whole.pos, self.add_params.max_depth)[0].long())
        return shard_state(whole, self.mesh)

    def read_health(self) -> dict:
        """The health of the steps since the last read, reduced over the
        ranks (a collective: every rank calls it): ``diagnose``'s keys, with
        ``walk_deferred`` summed over those steps."""
        h = self._health
        self._health = None
        if h is None:
            h = torch.zeros(4, dtype=torch.int64, device=self.mesh.device)
        return _reduce(h)

    def raise_on_health(self, diag: dict) -> None:
        """Raise the overflow errors a health dict reports."""
        self._raise_on_flags(diag.get("overflowed", False), diag.get("let_overflowed", False))

    def _raise_on_flags(self, build_ov: bool, let_ov: bool) -> None:
        if build_ov:
            n = self.sim_params.particle_num
            cap = self.add_params.capacity(n if self.schedule == "replicated" else n // self.mesh.size)
            raise RuntimeError(
                f"octree arena overflow on >=1 rank (cap {cap} nodes/rank): forces are "
                "truncated; raise node_capacity_factor or leaf_bucket"
            )
        if let_ov:
            raise RuntimeError(
                f"LET export overflow (let_cap {self.let_cap} rows): remote forces are "
                "truncated; raise let_cap or re-shard (ownership drift grows exports; see "
                "parallel/resharding.py)"
            )

    def check_overflow(self, state: ParticleState) -> None:
        """Raise if any rank's arena or LET export overflows for this state:
        the step's sort, build and export, no walk (a collective)."""
        _, health = self._run(state, walk=False)
        self.raise_on_health(_reduce(health))

    def diagnose(self, state: ParticleState) -> dict:
        """The health of one step from this state, walk included, over all
        ranks (a collective; the state is not advanced)."""
        _, health = self._run(state, walk=True)
        return _reduce(health)

    def reshard(self, state: ParticleState) -> ParticleState:
        """Re-partition the particles into contiguous global-Morton slices
        (``parallel/resharding.py``), a pure permutation; the LET import
        budget returns to the configured one (the JAX package keeps an
        escalated budget for good)."""
        self.add_params = dataclasses.replace(self.add_params,
                                              let_import_list_cap=self._import_list_cap)
        return resharding.reshard(state, self.mesh, self.add_params)

    def maybe_escalate_import_budget(self, diag: dict) -> bool:
        """Raise the LET import walk's list budget to the full
        ``walk_list_cap`` when the walks deferred receivers (the reduced
        budget's deferral cliff, ``sharded_tree.py:646``); True when it
        changed. The next step runs at the new budget; a reshard returns to
        the configured one."""
        if self.schedule != "let" or diag.get("walk_deferred", 0) <= 0:
            return False
        full = self.add_params.walk_list_cap
        if self.add_params.effective_import_list_cap() >= full:
            return False
        self.add_params = dataclasses.replace(self.add_params, let_import_list_cap=full)
        return True
