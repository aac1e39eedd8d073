"""MINWEIGHT monoid of the MSF formulation (paper §II-A, §III).

Elements are ``(weight, eid, payload...)``; combine keeps the least
``(w, eid)`` pair. Deterministic argmin-with-payload is a small fixed
number of masked min-reductions, because effective weights ``(w, eid)``
are lexicographically distinct:

  pass 1:  minw   = min_seg w
  pass 2:  mineid = min_seg (eid     | masked to w == minw)
  pass 3+: payload = min_seg (payload | masked to eid == mineid)

Each segment pass is one ``scatter_reduce_(..., "amin", include_self=True)``
into an output filled with the identity (+inf / IMAX), which is what
``jax.ops.segment_min`` gives at empty segments.

pack32 fast path (integer weights 0..255, idx < 2^24): key =
``w << 24 | idx``, one reduction. torch has no ``>>``, ``minimum`` or
``scatter_reduce`` amin for uint32 on the CPU, so keys travel as int64
tensors holding the uint32 value, with identity ``0xFFFFFFFF``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

INF = float("inf")
IMAX = int(torch.iinfo(torch.int32).max)


class EdgeMin(NamedTuple):
    """Per-segment result of a MINWEIGHT reduction."""

    w: torch.Tensor  # float32 [n]; +inf where the segment is empty
    eid: torch.Tensor  # int32 [n]; IMAX where empty
    payload: Tuple[torch.Tensor, ...]  # int32 [n] each; IMAX where empty


def segment_min(vals: torch.Tensor, segs: torch.Tensor, num_segments: int,
                identity) -> torch.Tensor:
    """``out[s] = min(identity, min{vals[e] : segs[e] == s})``; ids in range."""
    out = torch.full((num_segments,), identity, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, segs.long(), vals, "amin", include_self=True)


def segment_argmin(
    w: torch.Tensor,
    eid: torch.Tensor,
    payloads: Sequence[torch.Tensor],
    segment_ids: torch.Tensor,
    num_segments: int,
    valid: torch.Tensor | None = None,
) -> EdgeMin:
    """MINWEIGHT reduction by segment, with deterministic (w, eid) tie-break.

    All inputs are edge-indexed [E]. Invalid entries contribute the monoid
    identity (inf, IMAX, ...).
    """
    seg = segment_ids.long()
    if valid is not None:
        w = torch.where(valid, w, INF)
    minw = segment_min(w, seg, num_segments, INF)
    on_min = w == minw[seg]  # inf==inf at empty segments is harmless
    if valid is not None:
        on_min = on_min & valid
    mineid = segment_min(torch.where(on_min, eid, IMAX), seg, num_segments, IMAX)
    winner = on_min & (eid == mineid[seg])
    outs = tuple(
        segment_min(torch.where(winner, p, IMAX), seg, num_segments, IMAX)
        for p in payloads
    )
    return EdgeMin(w=minw, eid=mineid, payload=outs)


def axis_argmin(
    w: torch.Tensor,
    eid: torch.Tensor,
    payloads: Sequence[torch.Tensor],
    axis: int,
) -> EdgeMin:
    """MINWEIGHT reduction along a dense array axis."""
    minw = torch.amin(w, dim=axis)
    on_min = w == minw.unsqueeze(axis)
    mineid = torch.amin(torch.where(on_min, eid, IMAX), dim=axis)
    winner = on_min & (eid == mineid.unsqueeze(axis))
    outs = tuple(
        torch.amin(torch.where(winner, p, IMAX), dim=axis) for p in payloads
    )
    return EdgeMin(w=minw, eid=mineid, payload=outs)


def combine_edgemin(a: EdgeMin, b: EdgeMin) -> EdgeMin:
    """Binary MINWEIGHT combine of two EdgeMin fields (elementwise)."""
    w = torch.minimum(a.w, b.w)
    a_on = a.w == w
    b_on = b.w == w
    eid = torch.minimum(torch.where(a_on, a.eid, IMAX), torch.where(b_on, b.eid, IMAX))
    a_win = a_on & (a.eid == eid)
    b_win = b_on & (b.eid == eid)
    payload = tuple(
        torch.minimum(torch.where(a_win, pa, IMAX), torch.where(b_win, pb, IMAX))
        for pa, pb in zip(a.payload, b.payload)
    )
    return EdgeMin(w=w, eid=eid, payload=payload)


def allreduce_argmin(em: EdgeMin, mesh, axis) -> EdgeMin:
    """Cross-rank MINWEIGHT combine over ``axis`` of a
    :class:`~repro_torch.launch.mesh.Mesh`: the paper's ⊕-reduction over
    processor-grid columns (§IV-A), as 2 + len(payload) masked
    all-reduce(min) passes. Every rank along ``axis`` gets the result."""
    minw = mesh.all_reduce(em.w, "min", axis)
    on_min = em.w == minw
    mineid = mesh.all_reduce(torch.where(on_min, em.eid, IMAX), "min", axis)
    winner = on_min & (em.eid == mineid)
    payload = tuple(
        mesh.all_reduce(torch.where(winner, p, IMAX), "min", axis) for p in em.payload
    )
    return EdgeMin(w=minw, eid=mineid, payload=payload)


# ---------------------------------------------------------------------------
# pack32 fast path (paper's integer-weight regime: w in [0, 255], idx < 2^24)
# ---------------------------------------------------------------------------

PACK_IDX_BITS = 24
PACK_IDX_MASK = (1 << PACK_IDX_BITS) - 1
PACK_MAX_W = (1 << (32 - PACK_IDX_BITS)) - 1  # 255 weight levels
PACK_IDENTITY = 0xFFFFFFFF  # held in int64 keys


def pack32(w_int: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Pack (small int weight, index) into one min-reducible key: an int64
    tensor holding the uint32 value ``w << 24 | (idx & 0xFFFFFF)``."""
    w = w_int.to(torch.int64) & 0xFFFFFFFF
    return ((w << PACK_IDX_BITS) & 0xFFFFFFFF) | (idx.to(torch.int64) & PACK_IDX_MASK)


def unpack32(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (key >> PACK_IDX_BITS).to(torch.int32), (key & PACK_IDX_MASK).to(torch.int32)


def packable(n: int, max_w: int) -> bool:
    return n <= PACK_IDX_MASK + 1 and max_w <= PACK_MAX_W


# Tropical semiring helper (used by the Bellman-Ford showcase, paper §II-B).
def tropical_spmv(d: torch.Tensor, src, dst, w, num_segments: int) -> torch.Tensor:
    """One Bellman-Ford relaxation: d'_j = min(d_j, min_i d_i + w_ij)."""
    return torch.minimum(d, segment_min(d[src] + w, dst, num_segments, INF))
