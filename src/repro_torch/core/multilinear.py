"""The paper's multilinear kernel (§III-A, §IV-A), MSF half.

``w_i ← ⊕_j f(x_i, a_ij, y_j)`` computed all-at-once over the edge list,
with the MSF instantiation ``f(p_i, a_ij, p_j) = (a_ij, p_j) if p_i ≠ p_j
else identity`` over the MINWEIGHT monoid, and the generic form
``multilinear_coo`` with ⊕ in {sum, min, max}.

The paper's distributed schedule (Fig 2) runs on a 2-D grid of
``torch.distributed`` ranks (:class:`~repro_torch.launch.mesh.Mesh`):
edges in (row, col) blocks, vertex vectors 1-D sharded; all-gather x
along rows and y along columns, compute all-at-once over the local block,
⊕-reduce across the grid with masked all-reduce(min) passes. Each rank
calls these functions with its own block, as the reference calls its
functions inside ``shard_map``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.semiring import (
    IMAX,
    INF,
    PACK_IDENTITY,
    EdgeMin,
    allreduce_argmin,
    axis_argmin,
    pack32,
    segment_argmin,
    segment_min,
    unpack32,
)
from repro_torch.kernels import ops
from repro_torch.obs.trace import host_sync


def min_outgoing_coo(
    p: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    eid: torch.Tensor,
    valid: torch.Tensor,
    n: int,
    *,
    segment: str = "root",
    star: torch.Tensor | None = None,
    return_outgoing: bool = False,
):
    """All-at-once kernel for Algorithm 1 line 9(+10), reduced by ``segment``:
    "root" (segment ids = p[src], fuses the line-10 projection; valid when
    every tree is a star) or "vertex" (segment ids = src, the literal line 9).

    Returns EdgeMin over [n] with payload (p_dst,); with ``return_outgoing``
    also the edges that took part: their bool [E] mask, or, on the route
    of the hand-written kernel, their 0-d int64 count.

    The "root" form without ``star`` is that route on every device
    (``kernels.ops.min_outgoing_flat64``): on the card one pass that sends
    only the outgoing edges' 64-bit keys, builds no [E] tensor and waits on
    nothing; on the CPU its plain twin. Its zero weights come out as +0.0.
    Every other form, such as the paper variant's vertex form with
    ``star``, runs ``segment_argmin``'s masked scatters.
    """
    if segment == "root" and star is None:
        r, count = ops.min_outgoing_flat64(p, src, dst, w, eid, valid, n, count=return_outgoing)
        return (r, count) if return_outgoing else r
    ps = p[src]
    pd = p[dst]
    outgoing = (ps != pd) & valid
    if star is not None:
        outgoing = outgoing & star[src]
    seg = ps if segment == "root" else src
    r = segment_argmin(w, eid, (pd,), seg, n, valid=outgoing)
    return (r, outgoing) if return_outgoing else r


def project_to_roots(q: EdgeMin, p: torch.Tensor, n: int) -> EdgeMin:
    """Line 10: r_{p_i} ← MINWEIGHT_j { q_j : p_j = i } (vertex-indexed q)."""
    return segment_argmin(q.w, q.eid, q.payload, p, n, valid=q.w < INF)


def min_outgoing_coo_packed(
    p: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    eid: torch.Tensor,
    valid: torch.Tensor,
    n: int,
    *,
    segmin=None,
    return_outgoing: bool = False,
):
    """pack32 fast path of :func:`min_outgoing_coo` (root-segment form).

    Valid for ``w`` integral in [0, 255] and ``eid < 2^24 - 1``. The
    per-round reduction is ONE segment-min on the packed key plus one
    payload pass over the winners; ``segmin(keys, segs, n)`` swaps in the CUDA
    kernel (``kernels.ops.packed_segmin``) for the packed one.
    ``return_outgoing`` as in :func:`min_outgoing_coo`.
    """
    ps = p[src]
    pd = p[dst]
    outgoing = (ps != pd) & valid
    # Mask weights BEFORE the integer cast: padding carries +inf, which
    # casts to INT64_MIN.
    w_int = torch.where(outgoing, w, 0.0).to(torch.int64)
    key = torch.where(outgoing, pack32(w_int, eid), PACK_IDENTITY)
    if segmin is None:
        minkey = segment_min(key, ps, n, PACK_IDENTITY)
    else:
        minkey = segmin(key, ps, n)
    w_out, eid_out = unpack32(minkey)
    # Scatter only the winners (at most one per root). Masking the rest to
    # IMAX, as the reference does, sends every edge of a large component
    # to one root's slot, and on the card those atomics serialise.
    host_sync("min_outgoing.winners")
    win = (outgoing & (key == minkey[ps])).nonzero().squeeze(1)
    pay = segment_min(pd[win], ps[win], n, IMAX)
    empty = minkey == PACK_IDENTITY
    r = EdgeMin(
        w=torch.where(empty, INF, w_out.to(torch.float32)),
        eid=torch.where(empty, IMAX, eid_out),
        payload=(pay,),
    )
    return (r, outgoing) if return_outgoing else r


def min_outgoing_dense(
    p: torch.Tensor, a: torch.Tensor, star: torch.Tensor | None = None
) -> EdgeMin:
    """Dense-adjacency version (a[i, j] = w or +inf), for small-graph
    validation."""
    n = a.shape[0]
    neq = p[:, None] != p[None, :]
    if star is not None:
        neq = neq & star[:, None]
    w = torch.where(neq, a, INF)
    col = torch.arange(n, dtype=torch.int32, device=a.device)
    eid = torch.where(w < INF, col[None, :], IMAX)
    pd = torch.where(w < INF, p[None, :].to(torch.int32), IMAX)
    return axis_argmin(w, eid, (pd,), axis=1)


# ---------------------------------------------------------------------------
# Generic multilinear (GNN substrate reuse)
# ---------------------------------------------------------------------------


def _reduce_identity(dtype: torch.dtype, reduce: str):
    if dtype.is_floating_point:
        return float("inf") if reduce == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if reduce == "min" else info.min


def multilinear_coo(
    x: torch.Tensor,
    y: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    a: torch.Tensor | None,
    f: Callable,
    *,
    num_segments: int,
    reduce: str = "sum",
) -> torch.Tensor:
    """w_i = ⊕_{(i,j) ∈ E} f(x_i, a_ij, y_j) with ⊕ in {sum, min, max}.

    ``x``/``y`` may be [n] or [n, d]; ``f`` is applied vectorized over the
    edge dimension. Empty segments hold the monoid identity: 0 for sum,
    the dtype's largest value (+inf for floats) for min, its smallest for
    max. Sum is ``index_add_``, whose float order differs from the
    reference's; min and max are ``scatter_reduce_`` onto the identity.
    """
    if reduce not in ("sum", "min", "max"):
        raise ValueError(f"reduce must be one of sum, min, max; got {reduce!r}")
    vals = f(x[src], a, y[dst])
    seg = src.long()
    shape = (num_segments, *vals.shape[1:])
    if reduce == "sum":
        out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, seg, vals)
    out = torch.full(shape, _reduce_identity(vals.dtype, reduce), dtype=vals.dtype,
                     device=vals.device)
    idx = seg.view(-1, *([1] * (vals.dim() - 1))).expand_as(vals)
    return out.scatter_reduce_(0, idx, vals, "amin" if reduce == "min" else "amax",
                               include_self=True)


def spmm_sum_2d(
    x_local: torch.Tensor,  # [n/P, h] — 1-D-sharded node features
    src_row: torch.Tensor,  # [E_loc] local src offsets into the row block
    dst_col: torch.Tensor,  # [E_loc] local dst offsets into the column block
    valid: torch.Tensor,
    *,
    mesh,
    row_axis,
    col_axis,
    shard_size: int,
    col_block_size: int,
) -> torch.Tensor:
    """GNN aggregation (⊕ = sum) on the paper's Fig-2 schedule.

    Gather the row block of x (all-gather over cols, n/R rows), aggregate
    the local edge block by destination, ⊕-reduce the partials over rows
    (all-reduce sum, n/C rows), then slice this rank's own 1-D shard out
    of its column block. Float sums run in another order than the
    reference's.
    """
    x_row = mesh.all_gather(x_local, col_axis)  # [n/R, h]
    msgs = torch.where(valid[:, None], x_row[src_row.long()], 0.0)
    y_partial = torch.zeros((col_block_size, x_local.shape[1]), dtype=msgs.dtype,
                            device=msgs.device).index_add_(0, dst_col.long(), msgs)
    y_col = mesh.all_reduce(y_partial, "sum", row_axis)  # [n/C, h]
    r = mesh.axis_index(row_axis)
    return y_col[r * shard_size:(r + 1) * shard_size]


# ---------------------------------------------------------------------------
# Distributed schedule (paper Fig 2): one rank's block
# ---------------------------------------------------------------------------

def gather_row_col_vectors(p_local: torch.Tensor, mesh, row_axis, col_axis):
    """Redistribute + broadcast step of the paper's kernel.

    The global parent vector is 1-D-sharded over the grid in row-major
    order: rank (r, s) owns shard r*C + s. Gathering over ``col_axis``
    therefore concatenates the shards of row block r → x^(r); gathering
    over ``row_axis`` yields the *strided* column block y^(s).

    Returns (x_row_block [n/R], y_col_block [n/C]).
    """
    return mesh.all_gather(p_local, col_axis), mesh.all_gather(p_local, row_axis)


def min_outgoing_2d_packed(
    p_local: torch.Tensor,
    src_row: torch.Tensor,
    dst_col: torch.Tensor,
    w: torch.Tensor,
    eid: torch.Tensor,
    valid: torch.Tensor,
    n: int,
    *,
    mesh,
    row_axis,
    col_axis,
    segmin=None,
) -> EdgeMin:
    """pack32 fast path of the distributed kernel: weights integral in
    [0, 255], eids < 2^24 - 1. The (w, eid) key packs into one value, so
    the cross-rank ⊕-combine is two all-reduce(min) passes (packed key,
    then the winners' payload) instead of three. The local reduction is
    ``segmin(keys, segs, n)`` (the flat CUDA kernel on the card) or, with
    ``None``, the plain scatter-min. Keys stay int64 holding the uint32
    value: NCCL and gloo reduce int64 with MIN, and have no uint32.
    """
    x_row, y_col = gather_row_col_vectors(p_local, mesh, row_axis, col_axis)
    ps = x_row[src_row]
    pd = y_col[dst_col]
    outgoing = (ps != pd) & valid
    # Mask weights BEFORE the integer cast: padding carries +inf.
    w_int = torch.where(outgoing, w, 0.0).to(torch.int64)
    key = torch.where(outgoing, pack32(w_int, eid), PACK_IDENTITY)
    if segmin is None:
        minkey = segment_min(key, ps, n, PACK_IDENTITY)
    else:
        minkey = segmin(key, ps, n)
    minkey = mesh.all_reduce(mesh.all_reduce(minkey, "min", col_axis), "min", row_axis)
    w_out, eid_out = unpack32(minkey)
    # Only the ranks holding a winning edge contribute its p_dst, and each
    # scatters only its winners (see min_outgoing_coo_packed).
    host_sync("min_outgoing.winners")
    win = (outgoing & (key == minkey[ps])).nonzero().squeeze(1)
    pay = segment_min(pd[win], ps[win], n, IMAX)
    pay = mesh.all_reduce(mesh.all_reduce(pay, "min", col_axis), "min", row_axis)
    empty = minkey == PACK_IDENTITY
    return EdgeMin(
        w=torch.where(empty, INF, w_out.to(torch.float32)),
        eid=torch.where(empty, IMAX, eid_out),
        payload=(pay,),
    )


def min_outgoing_2d(
    p_local: torch.Tensor,
    src_row: torch.Tensor,  # local edge src, as offset into the row block
    dst_col: torch.Tensor,  # local edge dst, as offset into the column block
    w: torch.Tensor,
    eid: torch.Tensor,
    valid: torch.Tensor,
    n: int,
    *,
    mesh,
    row_axis,
    col_axis,
) -> EdgeMin:
    """The paper's distributed multilinear kernel, fused with the root
    projection: after the row/col vector gathers each rank computes local
    per-root minima into a dense [n] accumulator, then ⊕-combines over the
    column axis *and* the row axis, so every rank holds r replicated."""
    x_row, y_col = gather_row_col_vectors(p_local, mesh, row_axis, col_axis)
    ps = x_row[src_row]
    pd = y_col[dst_col]
    outgoing = (ps != pd) & valid
    local = segment_argmin(w, eid, (pd,), ps, n, valid=outgoing)
    combined = allreduce_argmin(local, mesh, col_axis)
    return allreduce_argmin(combined, mesh, row_axis)
