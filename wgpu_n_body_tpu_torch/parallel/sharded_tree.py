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
     ``let_fused=True``: the fused walk, one B4 walk with the full budget
     over [local arena | the imports packed slack-free into
     ``let_forest_cap`` rows] (B8, ``ops/import_forest_cuda.py``), whose
     fixed costs (list pool, evaluation launch, B3's pass) are paid once.
     ``walk="per_particle"`` walks one concatenated forest with B3.
O(N / P + P * let_cap) memory per rank.

Every step's health (``[build_overflow, let_overflow, walk_deferred,
let_rows_max]``, ``sharded_tree.py:332-340``) stays on the device, folded
in place into one vector over the steps since it was last read;
``read_health`` reduces it over the ranks with ``all_reduce`` once per
chunk, after the synchronisation the chunk ends with anyway. Under the
fused walk the overflow flag also covers the packed forest: more kept
import rows than ``let_forest_cap`` (``sharded_tree.py:354-358``).

Like TreeSim, every step reorders particles: globally (replicated) or
within each rank's slice (let).

``make_step()`` under ``replicated`` is ``models/step_graph.py::GraphedStep``,
as TreeSim's: on a CUDA device the step, the three ``all_gather``s
included, is captured into CUDA graphs at its second call and replayed
(NCCL captures collectives; the first, eager call has made the
communicator). ``let`` and a CPU state keep the eager step.

Under ``torch.profiler`` the replicated step shows, inside
``sharded_tree_step``: the half-kick in ``leapfrog.drift``, the gathers in
``rep_gather``, ``morton_keys``, ``morton_sort``, ``tree_build``, the drift
of the slice in ``leapfrog.drift``, ``theta_walk``, the group walk's
counters of this rank's receivers in ``counters`` (``models/tree.py``'s
``walk.*``), and the closing half-kick in ``leapfrog.kick``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from wgpu_n_body_tpu_torch.models.base import Simulator, StepFn
from wgpu_n_body_tpu_torch.models.step_graph import GraphedStep
from wgpu_n_body_tpu_torch.models.tree import (
    _count_group,
    _load_counter_kernels,
    check_walk_tile,
    validate_tree_params,
)
from wgpu_n_body_tpu_torch.ops import import_forest_cuda, morton
from wgpu_n_body_tpu_torch.ops.morton_cuda import morton_order_cuda
from wgpu_n_body_tpu_torch.ops.tree_build import FAR, TreeArrays, morton_order, reorder
from wgpu_n_body_tpu_torch.ops.tree_build_cuda import build_tree_cuda
from wgpu_n_body_tpu_torch.ops.tree_walk_cuda import tree_forces_cuda
from wgpu_n_body_tpu_torch.ops.tree_walk_group import step_budget
from wgpu_n_body_tpu_torch.ops.tree_walk_group_cuda import group_tree_forces_cuda, tile_setup_cuda
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
from wgpu_n_body_tpu_torch.utils.profiling import trace_scope, traced

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
    and the imports (``sharded_tree.py:126-236``): for ``walk="group"`` the
    fused walk if ``let_fused``, else the split walk; one per-particle walk
    of the concatenated forest otherwise (deferred 0). Both walks of the
    split walk have the same receivers, so they share one tile set-up: only
    their step budgets differ."""
    n_local = local.pos_s.shape[0]
    if fused_walk(tp):
        with trace_scope("let_tiles"):
            tiles = tile_setup_cuda(local.tree.split, n_local, tp)
        with trace_scope("let_import_forest"):
            fused = import_forest_cuda.assemble_fused_forest_cuda(
                local.tree, local.pos_s, local.mass_s, imp, tp.let_forest_cap(p, let_cap))
        with trace_scope("let_fused_walk"):
            # receiver i is source i; every import source lies past them
            acc, stats = group_tree_forces_cuda(local.pos_new, fused.src_pos, fused.src_mass,
                                                fused.forest, local.keys, params, tp,
                                                tiles=tiles)
        return acc, stats.deferred
    parts_pos = imp.parts[:, :, :3].reshape(-1, 3).contiguous()
    parts_mass = imp.parts[:, :, 3].reshape(-1).contiguous()
    if tp.walk == "group":
        with trace_scope("let_tiles"):
            tiles = tile_setup_cuda(local.tree.split, n_local, tp)
        with trace_scope("let_local_walk"):
            acc_loc, s1 = group_tree_forces_cuda(local.pos_new, local.pos_s, local.mass_s,
                                                 local.tree, local.keys, params, tp, tiles=tiles)
        with trace_scope("let_import_walk"):
            tp_imp = dataclasses.replace(tp, walk_list_cap=tp.effective_import_list_cap())
            acc_imp, s2 = group_tree_forces_cuda(
                local.pos_new, parts_pos, parts_mass, assemble_import_forest(imp), local.keys,
                params, tp_imp, gid_offset=p * let_cap,
                tiles=tiles._replace(r_cap=step_budget(tp_imp.walk_list_cap)),
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
    this rank's slice of receivers, and where the slice's forces go
    (``acc_out``; None for a new tensor)."""

    pos_s: torch.Tensor
    mass_s: torch.Tensor
    tree: TreeArrays
    keys_l: torch.Tensor
    velh_l: torch.Tensor
    pos_new: torch.Tensor
    start: int
    acc_out: torch.Tensor | None = None


def rep_prologue(pos_all: torch.Tensor, velh_all: torch.Tensor, mass_all: torch.Tensor,
                 rank: int, size: int, params: SimParams, tp: TreeParams,
                 out: ParticleState | None = None) -> RepGlobal:
    """The deterministic global sort and build of the gathered (pos, vel_h,
    mass), and this rank's slice of the sorted receivers, drifted
    (``sharded_tree.py:238-274``) in the range ``leapfrog.drift``. ``out``:
    buffers of the slice's new state; the drift writes its ``pos``, the
    walk its ``acc``."""
    perm, bound, keys = morton_order_cuda(pos_all, tp.max_depth)
    with trace_scope("tree_build"):
        # the reorder gathers vel_h in the vel and acc slots (acc is unread)
        ss, tree = build_tree_cuda(ParticleState(pos_all, velh_all, velh_all, mass_all), perm,
                                   keys, bound, tp)
    n_local = ss.n // size
    rows = slice(rank * n_local, (rank + 1) * n_local)
    velh_l = ss.vel[rows]
    with trace_scope("leapfrog.drift"):
        pos_new = torch.add(ss.pos[rows], velh_l * params.dt,
                            out=None if out is None else out.pos)
    return RepGlobal(ss.pos, ss.mass, tree, keys[rows], velh_l, pos_new, rows.start,
                     None if out is None else out.acc)


def rep_forces(g: RepGlobal, params: SimParams, tp: TreeParams):
    """(acc, deferred receivers) of this rank's slice from the global tree
    (``sharded_tree.py:276``): receivers local, sources and self indices
    global. The group walk's counters (``models/tree.py::_count_group``)
    count this rank's receivers while a profiler records."""
    with trace_scope("theta_walk"):
        if tp.walk == "group":
            acc, stats = group_tree_forces_cuda(g.pos_new, g.pos_s, g.mass_s, g.tree, g.keys_l,
                                                params, tp, gid_offset=g.start, out=g.acc_out)
        else:
            n_local = g.pos_new.shape[0]
            idx = torch.arange(g.start, g.start + n_local, dtype=torch.int32,
                               device=g.pos_new.device)
            acc = tree_forces_cuda(g.pos_new, g.pos_s, g.mass_s, g.tree, params, tp,
                                   self_idx=idx, out=g.acc_out)
            return acc, torch.zeros((), dtype=torch.int32, device=acc.device)
    traced("counters", _count_group, stats, g.pos_new.shape[0])
    return acc, stats.deferred


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


def _fold(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two health vectors as one: flags and rows by max, deferrals summed."""
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


def fused_walk(tp: TreeParams) -> bool:
    """Whether the LET step runs the fused walk (``let_fused`` with the
    group walk)."""
    return tp.walk == "group" and tp.let_fused


def forest_overflow(imp: LetExport, tp: TreeParams, p: int, let_cap: int) -> torch.Tensor:
    """() bool: the fused walk's imports keep more rows than its packed
    forest holds (``sharded_tree.py:354-358``)."""
    return torch.clamp(imp.n_rows, max=let_cap).sum() > tp.let_forest_cap(p, let_cap)


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
        if sim_params.particle_num % mesh.size:
            raise ValueError(f"N={sim_params.particle_num} not divisible by mesh size {mesh.size}")
        check_walk_tile(tp, sim_params.particle_num // mesh.size, mesh.device)
        self.mesh = mesh
        self.add_params = tp
        self.schedule = schedule
        # resolved now, so that checkpoints record the int
        self.let_cap = _resolve_let_cap(let_cap, sim_params, mesh, tp)
        self._import_list_cap = tp.let_import_list_cap  # what a reshard returns to
        #: this rank's health since the last ``read_health``, folded in place
        self._health = torch.zeros(4, dtype=torch.int64, device=mesh.device)

    def _run(self, state: ParticleState, walk: bool, out: ParticleState | None = None):
        """One step's stages on this rank: (new state, or None without the
        walk; health vector of this rank). ``out``: buffers the replicated
        step writes the slice's new state into (``GraphedStep``'s body)."""
        params, tp, mesh = self.sim_params, self.add_params, self.mesh
        half = params.dt / 2.0
        if self.schedule == "let":
            bound = all_reduce(let_bound(state.pos), "max")
            local = let_sort_build(state, bound, params, tp)
            lo, hi = receiver_box(local.pos_new)
            exp = let_export(local, all_gather(lo, mesh.size), all_gather(hi, mesh.size),
                             mesh.rank, tp, self.let_cap)
            imp = exchange(exp)
            rows_max = exp.n_rows.max()
            let_ov = exp.overflow.any()
            if fused_walk(tp):
                let_ov = let_ov | forest_overflow(imp, tp, mesh.size, self.let_cap)
            if not walk:
                return None, _health_vec(local.tree.overflowed, let_ov, torch.zeros(
                    (), dtype=torch.int32, device=rows_max.device), rows_max)
            acc, deferred = let_forces(local, imp, params, tp, mesh.size, self.let_cap)
            health = _health_vec(local.tree.overflowed, let_ov, deferred, rows_max)
            return ParticleState(local.pos_new, local.velh_s + acc * half, acc,
                                 local.mass_s), health
        with trace_scope("leapfrog.drift"):
            vel_h = state.vel + state.acc * half
        with trace_scope("rep_gather"):
            gathered = (all_gather(state.pos, mesh.size), all_gather(vel_h, mesh.size),
                        all_gather(state.mass, mesh.size))
        g = rep_prologue(*gathered, mesh.rank, mesh.size, params, tp, out)
        del gathered  # free for the walk: the sorted copies are what the step reads on
        if not walk:
            zero = torch.zeros((), dtype=torch.int32, device=g.pos_s.device)
            return None, _health_vec(g.tree.overflowed, False, zero, 0)
        acc, deferred = rep_forces(g, params, tp)
        mass_l = g.mass_s[g.start : g.start + acc.shape[0]]
        with trace_scope("leapfrog.kick"):
            vel_new = torch.add(g.velh_l, acc * half, out=None if out is None else out.vel)
        return (ParticleState(g.pos_new, vel_new, acc, mass_l),
                _health_vec(g.tree.overflowed, False, deferred, 0))

    def step_fn(self) -> StepFn:
        """The eager step, ``step(state, out=None)`` (it reads ``add_params``
        at every call, so an escalated import budget takes effect at the
        next step). Its health is folded into this rank's record, in place,
        until ``read_health``. With ``out`` (buffers of the state's shape)
        the replicated step writes the new state's fields there: the body
        ``GraphedStep`` captures."""

        def step(state: ParticleState, out: ParticleState | None = None) -> ParticleState:
            with trace_scope("sharded_tree_step"):
                new, health = self._run(state, walk=True, out=out)
                self._record(health)
            return new

        return step

    def make_step(self) -> StepFn:
        """The step to call in a loop: under ``replicated`` a
        ``GraphedStep`` (replayed from CUDA graphs on a CUDA device, the
        eager step on a CPU state; see ``models/step_graph.py`` for how long
        a returned state stays valid); under ``let`` the eager step."""
        return GraphedStep(self) if self.schedule == "replicated" else self.step_fn()

    def _record(self, health: torch.Tensor) -> None:
        """Fold a step's health into this rank's record, in place, so that a
        replayed step folds into the vector its capture saw."""
        self._health.copy_(_fold(self._health, health))

    def init_state(self, generator, init_fn, device=None) -> ParticleState:
        """This rank's slice of the scene ``init_fn`` draws on the CPU from
        ``generator`` (the same scene on every rank), on the mesh's device.
        Under ``let`` the slices are those of the global Morton order, as a
        reshard leaves them: in the draw's order every rank's box would be
        the whole scene and its first exports the whole tree (the JAX
        package starts so, and overflows at scale). On a CUDA device the
        group walk's counter kernels are loaded first, as TreeSim loads them
        (``models/tree.py::_load_counter_kernels``)."""
        if self.mesh.device.type == "cuda" and self.add_params.walk == "group":
            _load_counter_kernels(self.mesh.device)
        whole = init_fn(generator, self.sim_params, "cpu")
        if self.schedule == "let":
            whole = reorder(whole, morton_order(whole.pos, self.add_params.max_depth)[0].long())
        return shard_state(whole, self.mesh)

    def read_health(self) -> dict:
        """The health of the steps since the last read, reduced over the
        ranks (a collective: every rank calls it): ``diagnose``'s keys, with
        ``walk_deferred`` summed over those steps."""
        h = self._health.clone()
        self._health.zero_()
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
            forest_cap = self.add_params.let_forest_cap(self.mesh.size, self.let_cap)
            raise RuntimeError(
                f"LET export overflow (let_cap {self.let_cap} rows, fused forest cap "
                f"{forest_cap} rows): remote forces are truncated; raise let_cap / "
                "let_forest_factor or re-shard (ownership drift grows exports; see "
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
        the configured one. The fused walk has no import budget of its own
        (``sharded_tree.py:664-670``): always False there."""
        if self.schedule != "let" or diag.get("walk_deferred", 0) <= 0:
            return False
        if fused_walk(self.add_params):
            return False
        full = self.add_params.walk_list_cap
        if self.add_params.effective_import_list_cap() >= full:
            return False
        self.add_params = dataclasses.replace(self.add_params, let_import_list_cap=full)
        return True
