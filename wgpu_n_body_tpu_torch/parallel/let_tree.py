"""Locally-essential-tree (LET) building blocks of the multi-GPU Barnes-Hut
schedule — counterpart of ``wgpu_n_body_tpu/parallel/let_tree.py``.

Each rank owns a contiguous slice of particles, sorts and builds an octree
over its slice alone, then exports to every other rank the pruned subtree
that rank's receivers need (``export_walk``, kernel B7):

    width < theta * dmin(remote box, cog)   -> a TERMINAL point row
    terminal cell failing the test          -> its member particles
    internal node failing the test          -> an INTERNAL row, and descend

Every receiver on the destination lies inside the box, so its own distance
is at least the probe's and each exported terminal row passes its theta
test: the export is theta-valid for the whole destination. Exports are
(P, let_cap) buffers exchanged with one ``all_to_all``; only the wire
arrays cross (``wire_arrays``), the receiver derives the rest
(``import_from_wire``). The receiver walks its own tree and the import
forest (``assemble_import_forest``) separately and adds the two forces,
or, for the per-particle walk, one concatenated forest
(``assemble_forest``).

Not ported: the JAX ``_rank_join`` (a TPU workaround for slow gathers; B7
takes its pruned skips from its own prefix sums) and ``CompactForest`` /
``compact_import_forest``, which serve only the fused LET walk (ROADMAP).
"""

from __future__ import annotations

import numpy as np
import torch

from wgpu_n_body_tpu_torch.ops.let_export import LetExport, derive_first_count_parts
from wgpu_n_body_tpu_torch.ops.let_export_cuda import export_walk_cuda
from wgpu_n_body_tpu_torch.ops.tree_build import FAR, NODE_F32_COLS, NO_CHILD, TreeArrays

__all__ = [
    "LetExport",
    "assemble_forest",
    "assemble_import_forest",
    "auto_let_cap",
    "derive_first_count_parts",
    "export_walk",
    "import_from_wire",
    "let_export_from_numpy",
    "let_memory_bytes",
    "wire_arrays",
]

#: The export walk: B7's kernels for CUDA tensors, the plain version for CPU ones.
export_walk = export_walk_cuda


def auto_let_cap(n_local: int, theta: float) -> int:
    """Export rows per destination sized from measured need, the JAX
    package's rule (``let_tree.py:109``): 1.5 x 2.53 x (0.75 / theta)^2 x
    n_local^(2/3) rows for a face-adjacent neighbour, at least 8192, rounded
    up to a multiple of 4096. Overflow beyond it is flagged and raised."""
    rows = 1.5 * 2.53 * (0.75 / theta) ** 2 * float(n_local) ** (2.0 / 3.0)
    return max(8192, -(-int(rows) // 4096) * 4096)


def wire_arrays(exp: LetExport) -> tuple:
    """What crosses between ranks: (nodes, skip, n_rows, overflow), 36 bytes
    a row; first/count/parts are derived again on the receiving side."""
    return exp.nodes, exp.skip, exp.n_rows, exp.overflow


def import_from_wire(nodes, skip, n_rows, overflow) -> LetExport:
    """The full LetExport from the wire arrays, equal bit for bit to sending
    every field (``derive_first_count_parts`` is shared with the export)."""
    first, count, parts = derive_first_count_parts(nodes)
    return LetExport(nodes=nodes, skip=skip, first=first, count=count, parts=parts,
                     n_rows=n_rows, overflow=overflow)


def let_export_from_numpy(exp, device: str | torch.device = "cpu") -> LetExport:
    """A LetExport of numpy arrays (or of anything ``np.asarray`` takes, such
    as the JAX package's export) as the port's, on ``device``: so one
    package's export can feed the other's import side."""
    return LetExport(*(torch.from_numpy(np.array(x)).to(device) for x in exp))


def _sentinel_row(device) -> torch.Tensor:
    """The inert row (1, 8): far, massless, a terminal single. Made by device
    ops: a number written into a CUDA tensor is copied from the host, and
    that copy waits for all the work queued on the device."""
    col = torch.arange(NODE_F32_COLS, device=device)
    return torch.where(col == 0, FAR, ((col == 5) | (col == NO_CHILD)).float())[None, :]


def _in_buffer(imp: LetExport) -> torch.Tensor:
    """The rows' member counts, cut to their own buffer. Only a header whose
    member rows a truncated (overflowed) export dropped is cut: the JAX
    package keeps its whole count, so its member range runs into the next
    buffer or past the table, which XLA's gathers clamp and a kernel would
    read out of bounds. Its forces are flagged as truncated either way."""
    r_cap = imp.skip.shape[1]
    return torch.minimum(imp.count, r_cap - imp.first)


def assemble_import_forest(imp: LetExport, part_base: int = 0) -> TreeArrays:
    """The P import buffers as one walkable DFS forest (``let_tree.py:645``)
    for the split LET walk: a walk from row 0 visits buffer after buffer
    (each buffer's sentinel rows jump to the next one), and row ``first[k]``
    of buffer b is source ``part_base + b * let_cap + k`` of the flattened
    ``imp.parts``. Receivers walk it with ``gid_offset >= part_base + P *
    let_cap``, wholly past its sources, so no self pair can alias."""
    p, r_cap = imp.skip.shape
    total = p * r_cap
    dev = imp.nodes.device
    offs = torch.arange(p, dtype=torch.int32, device=dev)[:, None] * r_cap
    return TreeArrays(
        nodes_f32=torch.cat([imp.nodes.reshape(total, NODE_F32_COLS), _sentinel_row(dev)]),
        skip=torch.cat([(imp.skip + offs).reshape(-1),
                        torch.full((1,), total, dtype=torch.int32, device=dev)]),
        first=torch.cat([(imp.first + offs + part_base).reshape(-1),
                         torch.full((1,), part_base + total, dtype=torch.int32, device=dev)]),
        count=torch.cat([_in_buffer(imp).reshape(-1),
                         torch.zeros(1, dtype=torch.int32, device=dev)]),
        num_nodes=torch.full((), total, dtype=torch.int32, device=dev),
        root_width=torch.zeros((), dtype=torch.float32, device=dev),
        overflowed=imp.overflow.any(),
    )


def assemble_forest(tree_l: TreeArrays, imp: LetExport, n_local: int) -> tuple[TreeArrays, int]:
    """[local arena | P import buffers | sentinel] as one DFS forest
    (``let_tree.py:579``), for the per-particle LET walk; returns (forest,
    rows). Its sources are [local sorted particles (n_local) | one far
    massless row | the flattened import parts (P * let_cap)]: the arena's
    rows past num_nodes jump to the first import and point at that one row,
    import rows at their own buffer slot."""
    p, r_cap = imp.skip.shape
    dev = imp.nodes.device
    cap_l = tree_l.nodes_f32.shape[0] - 1
    base = cap_l + 1
    total = base + p * r_cap
    kk = torch.arange(cap_l + 1, dtype=torch.int32, device=dev)
    skip_local = torch.where(kk >= tree_l.num_nodes, base, tree_l.skip)
    offs = base + torch.arange(p, dtype=torch.int32, device=dev)[:, None] * r_cap
    part_offs = n_local + 1 + torch.arange(p, dtype=torch.int32, device=dev)[:, None] * r_cap
    forest = TreeArrays(
        nodes_f32=torch.cat([tree_l.nodes_f32, imp.nodes.reshape(p * r_cap, NODE_F32_COLS),
                             tree_l.nodes_f32[cap_l:]]),
        skip=torch.cat([skip_local, (imp.skip + offs).reshape(-1),
                        torch.full((1,), total, dtype=torch.int32, device=dev)]),
        first=torch.cat([tree_l.first, (imp.first + part_offs).reshape(-1),
                         torch.full((1,), n_local, dtype=torch.int32, device=dev)]),
        count=torch.cat([tree_l.count, _in_buffer(imp).reshape(-1),
                         torch.zeros(1, dtype=torch.int32, device=dev)]),
        num_nodes=torch.full((), total, dtype=torch.int32, device=dev),
        root_width=tree_l.root_width,
        overflowed=tree_l.overflowed | imp.overflow.any(),
    )
    return forest, total


def let_memory_bytes(n: int, p: int, tp, let_cap: int = 8192,
                     walk_list_rows: int | None = None) -> dict:
    """Per-rank live bytes of the LET schedule's dominant arrays at N
    particles over P ranks: the JAX package's budget (``let_tree.py:827``),
    term for term, so both packages size a deployment alike. Its
    ``local_octets`` and fused-walk terms count the JAX octet tables, which
    the port does not build (its group walk walks the arena itself)."""
    n_l = n // p
    cap_l = tp.capacity(n_l)
    r = let_cap
    g = tp.effective_walk_tile(n_l)
    t_cap = -(-n_l // g) + max(8, 2 * -(-n_l // g))
    rows = walk_list_rows or (-(-(2 * tp.walk_list_cap) // 256) * 256)
    ta_blk = min(2048, t_cap)
    fused = tp.walk_engine == "octet" and tp.let_fused
    cf = tp.let_forest_cap(p, r) if fused else p * r
    sizes = {
        "state": 2 * n_l * 40,
        "local_arena": (cap_l + 1) * (32 + 12),
        "import_forest": (cf + 1) * (32 + 12) + (cf * 16 if fused else 0),
        "export_import": 2 * p * r * (32 + 12 + 16),
        "eval_tables": (3 * ((n_l + 1 + cf + 1) // 2)) * 32
        + (0 if fused else (p * r + 1 + p * r) * 32),
        "tiles": t_cap * g * 3 * 4 + t_cap * g * 4,
        "phase_a_lists": rows * ta_blk * 4,
        "acc_tiles": t_cap * g * 3 * 4,
    }
    if tp.walk_engine == "octet":
        cap_oct = tp.octet_capacity(n_l)
        sizes["local_octets"] = cap_oct * 17 * 4 + (cap_oct * 12 + 2) * 32
        if fused:
            sizes["import_octets"] = cf * 17 * 4 + cf * 12 * 32
    sizes["total"] = sum(sizes.values())
    return sizes
