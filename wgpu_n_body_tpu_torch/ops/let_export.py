"""LET export walk (B7), plain torch — counterpart of
``wgpu_n_body_tpu/parallel/let_tree.py::export_walk`` and the plain version
of the CUDA kernels ``csrc/let_export.cu`` (``ops/let_export_cuda.py``).

A rank exports to each destination d the pruned DFS subtree of its local
arena that destination d's receivers need: the rows the JAX walk emits
when it walks the arena with d's receiver box as the acceptance probe.
The JAX walk is one lane per destination, one dependent row gather per
emitted row, up to ``r_cap`` rows. Here the same rows come in parallel:

kind     each arena row's kind for d depends on that row alone:
         ``TERMINAL`` (width < theta * dmin(box_d, cog)), ``POINT`` (a
         terminal cell of one particle that fails the test), ``HEADER`` (a
         terminal cell of more), ``INTERNAL`` (an internal node that fails);
visited  row i is visited iff no earlier *stop* row a (``TERMINAL``,
         ``POINT`` or ``HEADER``: the walk jumps to ``skip[a]``) covers it,
         a < i < skip[a]: one exclusive prefix max of ``stop(a) * skip[a]``
         over the DFS rows per destination, compared with i;
offset   a visited row takes one slot, a header one plus its members (the
         ``PAYLOAD`` rows that follow it): an exclusive prefix sum gives each
         row's slot;
emit     rows at slot >= r_cap are dropped, which keeps the DFS prefix as the
         JAX walk does when its loop runs out: ``overflow`` is total >
         r_cap and ``n_rows`` min(total, r_cap). The destination equal to
         ``self_index`` emits only sentinel rows.

The emitted rows' payloads (``let_tree.py:409-505``) follow the JAX code
column for column: an internal row's pruned skip is the number of emitted
slots whose original row precedes its original skip (``torch.searchsorted``,
the JAX package's vmapped searchsorted, which its rank join replaced), and
``first``/``count``/``parts`` come from the node rows alone
(``derive_first_count_parts``), the same function the receiver applies to
the wire arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from wgpu_n_body_tpu_torch.ops.tree_build import FAR, NO_CHILD, WIDTH, TreeArrays

# Row kinds, the JAX package's numbering (let_tree.py:59).
SENTINEL, INTERNAL, TERMINAL, POINT, HEADER, PAYLOAD = range(6)
#: The JAX walk unrolls eight steps per loop trip and takes only a
#: ``let_cap`` that is a multiple of eight; so does the port.
LET_CAP_MULTIPLE = 8


class LetExport(NamedTuple):
    """Per-destination pruned-subtree buffers (leading axis: the P ranks).

    nodes: (P, R, 8) float32 node-schema rows; skip/first/count: (P, R)
    int32 (skip local to the buffer; first into the buffer's own rows);
    parts: (P, R, 4) float32 member payloads [x y z mass] (a far massless
    row on non-member rows); n_rows: (P,) int32 emitted rows; overflow:
    (P,) bool, the destination's forces from this rank are truncated.
    """

    nodes: torch.Tensor
    skip: torch.Tensor
    first: torch.Tensor
    count: torch.Tensor
    parts: torch.Tensor
    n_rows: torch.Tensor
    overflow: torch.Tensor


def check_let_cap(r_cap: int) -> None:
    if not isinstance(r_cap, int) or r_cap < LET_CAP_MULTIPLE or r_cap % LET_CAP_MULTIPLE:
        raise ValueError(f"let_cap must be a positive multiple of {LET_CAP_MULTIPLE}, got {r_cap!r}")


def row_kinds(tree: TreeArrays, bbox_lo, bbox_hi, theta: float) -> torch.Tensor:
    """(P, M) int64 kind of each of the M = num_nodes arena rows for each
    destination box: ``TERMINAL``, ``POINT``, ``HEADER`` or ``INTERNAL``
    (``let_tree.py:279-321``, the same float32 roundings)."""
    m = int(tree.num_nodes)
    rows = tree.nodes_f32[:m]

    def gap(c):
        v = rows[None, :, c]
        return torch.clamp(torch.maximum(bbox_lo[:, c : c + 1] - v, v - bbox_hi[:, c : c + 1]),
                           min=0.0)

    dx, dy, dz = gap(0), gap(1), gap(2)
    dmin = torch.sqrt(dx * dx + dy * dy + dz * dz)
    theta_ok = rows[None, :, WIDTH] < theta * dmin
    near = ~theta_ok & (rows[None, :, NO_CHILD] > 0.0)
    cnt = tree.count[None, :m]
    return torch.where(
        theta_ok, TERMINAL,
        torch.where(near & (cnt == 1), POINT, torch.where(near & (cnt > 1), HEADER, INTERNAL)),
    )


def export_rows(tree: TreeArrays, bbox_lo, bbox_hi, self_index: int, theta: float):
    """(kinds (P, M), visited (P, M) bool, sizes (P, M) int64): each arena
    row's kind per destination, whether the destination's walk visits it,
    and the slots it takes there (one, a header one plus its members, an
    unvisited row none)."""
    kinds = row_kinds(tree, bbox_lo, bbox_hi, theta)
    p, m = kinds.shape
    stop = (kinds == TERMINAL) | (kinds == POINT) | (kinds == HEADER)
    covers = torch.where(stop, tree.skip[:m].to(torch.int64), 0)
    before = torch.cat([torch.zeros((p, 1), dtype=torch.int64, device=covers.device),
                        covers[:, :-1]], 1)
    reach = torch.cummax(before, dim=1).values  # furthest skip of an earlier stop row
    visited = reach <= torch.arange(m, device=covers.device)
    visited[int(self_index)] = False
    sizes = torch.where(
        visited, 1 + torch.where(kinds == HEADER, tree.count[None, :m].to(torch.int64), 0), 0
    )
    return kinds, visited, sizes


def derive_first_count_parts(nodes: torch.Tensor):
    """Receiver-side (first, count, parts) from the (P, R, 8) node rows
    alone (``let_tree.py:507``): a header (no_child > 0, col 7 = k > 0)
    points at its k payload rows; a "pointish" row (mass > 0 and width 0,
    or a terminal cell with col 7 = 0) is a one-member point at its own
    row; internal and sentinel rows count 0 and carry a far massless part."""
    p, r_cap, _ = nodes.shape
    qq = torch.arange(r_cap, dtype=torch.int32, device=nodes.device).expand(p, r_cap)
    k7 = nodes[:, :, 7]
    nc = nodes[:, :, NO_CHILD]
    header = (nc > 0.0) & (k7 > 0.0)
    pointish = (nodes[:, :, 3] > 0.0) & ((nodes[:, :, WIDTH] == 0.0) | ((nc > 0.0) & (k7 == 0.0)))
    first = torch.where(header, qq + 1, qq).to(torch.int32)
    count = torch.where(header, k7.to(torch.int32), pointish.to(torch.int32)).to(torch.int32)
    # [FAR, FAR, FAR, 0] by a device op: a number written into a CUDA tensor is
    # copied from the host, and that copy waits for the device's queued work
    sent4 = torch.where(torch.arange(4, device=nodes.device) < 3, FAR, 0.0)
    parts = torch.where(pointish[:, :, None], nodes[:, :, :4], sent4)
    return first, count, parts


def export_walk(
    tree: TreeArrays,
    src_pos: torch.Tensor,
    src_mass: torch.Tensor,
    bbox_lo: torch.Tensor,
    bbox_hi: torch.Tensor,
    self_index: int,
    theta: float,
    r_cap: int,
) -> LetExport:
    """One pruned subtree per destination box, plain torch (see the module
    docstring): the JAX ``export_walk``'s outputs, equal to them bit for
    bit.

    tree: the local arena over the sorted sources ``src_pos`` (n, 3) /
    ``src_mass`` (n,); bbox_lo/hi: (P, 3) post-drift receiver bounds per
    rank; self_index: this rank, whose buffer holds only sentinel rows;
    r_cap: rows per destination buffer (``let_cap``)."""
    check_let_cap(r_cap)
    dev = src_pos.device
    p = bbox_lo.shape[0]
    n_src = src_pos.shape[0]
    m = int(tree.num_nodes)
    i64 = torch.int64
    kinds_rows, visited, sizes = export_rows(tree, bbox_lo, bbox_hi, self_index, theta)
    total = sizes.sum(1)
    off = torch.cumsum(sizes, 1) - sizes

    # every emitted row: the visited row it comes from and its rank in that
    # row's run (0 the row itself, j >= 1 a header's member j - 1)
    d_of, i_of = visited.nonzero(as_tuple=True)
    run = sizes[d_of, i_of]
    grp = torch.repeat_interleave(torch.arange(run.numel(), device=dev), run)
    within = torch.arange(grp.numel(), device=dev) - (torch.cumsum(run, 0) - run)[grp]
    slot = off[d_of, i_of][grp] + within
    keep = slot < r_cap
    d_e, i_e, w_e, q_e = d_of[grp][keep], i_of[grp][keep], within[keep], slot[keep]
    kind_e = torch.where(w_e == 0, kinds_rows[d_e, i_e], PAYLOAD)
    first_e = tree.first[i_e].to(i64)
    memb_e = torch.where(
        kind_e == POINT, first_e,
        torch.where(kind_e == PAYLOAD, first_e + w_e - 1,
                    torch.where(kind_e == HEADER, first_e - 1, n_src)),
    )
    keys = torch.full((p, r_cap), m, dtype=i64, device=dev)
    kinds = torch.full((p, r_cap), SENTINEL, dtype=i64, device=dev)
    membs = torch.full((p, r_cap), n_src, dtype=i64, device=dev)
    keys[d_e, q_e] = i_e
    kinds[d_e, q_e] = kind_e
    membs[d_e, q_e] = memb_e

    # ---- payloads: let_tree.py:409-505, column by column ----
    qq = torch.arange(r_cap, dtype=i64, device=dev)[None, :]
    sentinel = kinds == SENTINEL
    is_pt = (kinds == POINT) | (kinds == PAYLOAD)
    is_internal = kinds == INTERNAL
    is_header = kinds == HEADER
    is_node = (kinds == TERMINAL) | is_internal | is_header
    src4 = torch.cat([
        torch.cat([src_pos, torch.full((1, 3), FAR, dtype=torch.float32, device=dev)]),
        torch.cat([src_mass, torch.zeros(1, dtype=torch.float32, device=dev)])[:, None],
    ], 1)
    ppart = src4[torch.where(is_pt, membs, n_src)]
    nrow = tree.nodes_f32[keys]
    hdr_cnt = torch.where(is_header, tree.count[keys].to(i64), 0)
    cogm = torch.where(is_pt[:, :, None], ppart,
                       torch.where(is_node[:, :, None], nrow[:, :, :4], 0.0))
    far_row = torch.where(torch.arange(4, device=dev) == 0, FAR, 0.0)
    cogm = torch.where(sentinel[:, :, None], far_row, cogm)
    width = torch.where(is_node, nrow[:, :, WIDTH], 0.0)
    single = torch.where(is_pt, 1.0, torch.where(is_node, nrow[:, :, 5], 0.0))
    no_child = torch.where(is_internal, 0.0, 1.0)
    nodes_out = torch.cat(
        [cogm, width[:, :, None], single[:, :, None], no_child[:, :, None],
         hdr_cnt.to(torch.float32)[:, :, None]],
        2,
    )
    # internal rows jump past their pruned subtree: the emitted slots whose
    # original row precedes the original skip (sentinel slots carry row m)
    pruned = torch.searchsorted(keys, tree.skip[keys].to(i64).contiguous(), side="left")
    skip_out = torch.where(
        is_internal, pruned,
        torch.where(sentinel, r_cap, torch.where(is_header, qq + 1 + hdr_cnt, qq + 1)),
    ).to(torch.int32)
    first_out, count_out, parts_out = derive_first_count_parts(nodes_out)
    return LetExport(
        nodes=nodes_out,
        skip=skip_out,
        first=first_out,
        count=count_out,
        parts=parts_out,
        n_rows=torch.clamp(total, max=r_cap).to(torch.int32),
        overflow=total > r_cap,
    )


def export_bytes(exp: LetExport, visited: torch.Tensor) -> int:
    """Bytes the export ``exp`` must move: each arena row that some
    destination visits (``export_rows``) read once (its node row, skip,
    first and count: 44 bytes), each member row emitted (width 0, one
    particle) read once from the sources (16 bytes), the boxes, and every
    output written once (60 bytes a slot, 5 a destination)."""
    p, r_cap, _ = exp.nodes.shape
    rows = int(visited.any(0).sum())
    members = int(((exp.nodes[:, :, WIDTH] == 0.0) & (exp.nodes[:, :, 5] == 1.0)).sum())
    return rows * 44 + members * 16 + p * 24 + p * r_cap * 60 + p * 5
