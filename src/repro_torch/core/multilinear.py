"""The paper's multilinear kernel (§III-A, §IV-A), MSF half.

``w_i ← ⊕_j f(x_i, a_ij, y_j)`` computed all-at-once over the edge list,
with the MSF instantiation ``f(p_i, a_ij, p_j) = (a_ij, p_j) if p_i ≠ p_j
else identity`` over the MINWEIGHT monoid. The 2-D distributed schedule
and the generic GNN entry points are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import (
    IMAX,
    INF,
    PACK_IDENTITY,
    EdgeMin,
    axis_argmin,
    pack32,
    segment_argmin,
    segment_min,
    unpack32,
)


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
) -> EdgeMin:
    """All-at-once kernel for Algorithm 1 line 9(+10), reduced by ``segment``:
    "root" (segment ids = p[src], fuses the line-10 projection; valid when
    every tree is a star) or "vertex" (segment ids = src, the literal line 9).

    Returns EdgeMin over [n] with payload (p_dst,).
    """
    ps = p[src]
    pd = p[dst]
    outgoing = (ps != pd) & valid
    if star is not None:
        outgoing = outgoing & star[src]
    seg = ps if segment == "root" else src
    return segment_argmin(w, eid, (pd,), seg, n, valid=outgoing)


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
) -> EdgeMin:
    """pack32 fast path of :func:`min_outgoing_coo` (root-segment form).

    Valid for ``w`` integral in [0, 255] and ``eid < 2^24 - 1``. The
    per-round reduction is ONE segment-min on the packed key plus one
    payload pass over the winners; ``segmin(keys, segs, n)`` swaps in the CUDA
    kernel (``kernels.ops.make_packed_segmin``) for the packed one.
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
    win = (outgoing & (key == minkey[ps])).nonzero().squeeze(1)
    pay = segment_min(pd[win], ps[win], n, IMAX)
    empty = minkey == PACK_IDENTITY
    return EdgeMin(
        w=torch.where(empty, INF, w_out.to(torch.float32)),
        eid=torch.where(empty, IMAX, eid_out),
        payload=(pay,),
    )


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
