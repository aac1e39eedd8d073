"""The paper's multilinear kernel (§III-A, §IV-A), MSF half.

``w_i ← ⊕_j f(x_i, a_ij, y_j)`` computed all-at-once over the edge list,
with the MSF instantiation ``f(p_i, a_ij, p_j) = (a_ij, p_j) if p_i ≠ p_j
else identity`` over the MINWEIGHT monoid, and the generic form
``multilinear_coo`` with ⊕ in {sum, min, max}. The 2-D distributed
schedule is not ported yet.
"""
from __future__ import annotations

from typing import Callable

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
