"""Plain PyTorch versions of the port's kernels: the CPU path and the
oracle each CUDA kernel is held against on the card."""
from __future__ import annotations

import torch

from repro_torch.core.semiring import IMAX, INF, PACK_IDENTITY, EdgeMin

#: The 64-bit identity of the min-outgoing twin's keys: all ones as an
#: unsigned value, held with its top bit flipped (int64 max).
KEY64_IDENTITY = int(torch.iinfo(torch.int64).max)


def segment_min_flat_ref(keys: torch.Tensor, segs: torch.Tensor, num_segments: int):
    """``out[s] = min{keys[e] : segs[e] == s}`` over unsorted segment ids.

    keys: int64 [E] holding uint32 pack32 values (``0xFFFFFFFF`` =
    identity); segs: int32 [E]. Returns int64 [num_segments], the identity
    at empty segments. Ids outside ``[0, num_segments)`` are dropped, as
    ``jax.ops.segment_min`` drops them: they are routed to a spare slot
    past the end instead of being scattered out of bounds.
    """
    segs = segs.long()
    in_range = (segs >= 0) & (segs < num_segments)
    idx = torch.where(in_range, segs, num_segments)
    out = torch.full((num_segments + 1,), PACK_IDENTITY, dtype=torch.int64, device=keys.device)
    out.scatter_reduce_(0, idx, keys, "amin", include_self=True)
    return out[:num_segments]


def segment_min_sorted_ref(keys: torch.Tensor, segs: torch.Tensor, num_segments: int):
    """Plain version of the sorted-segment kernel: the same reduction as
    :func:`segment_min_flat_ref`. Sortedness of ``segs`` only restricts how
    the ids may be laid out, not what the result is."""
    return segment_min_flat_ref(keys, segs, num_segments)


def segment_min_bucketed_ref(keys: torch.Tensor, rows: torch.Tensor, block_rows: int):
    """``out[b * block_rows + r] = min{keys[b, e] : rows[b, e] == r}``.

    keys: int64 [NB, BE] holding uint32 pack32 values (``0xFFFFFFFF`` =
    identity and padding); rows: int32 [NB, BE], the local row within the
    bucket's block. Returns int64 [NB * block_rows]. Rows outside
    ``[0, block_rows)`` are dropped, as the reference's compare-broadcast
    drops them: the bucketed layout becomes one flat segment-min over the
    ids ``b * block_rows + rows``, with the dropped entries routed out of
    range.
    """
    nb = keys.shape[0]
    rows = rows.long()
    base = torch.arange(nb, dtype=torch.int64, device=keys.device)[:, None] * block_rows
    in_range = (rows >= 0) & (rows < block_rows)
    segs = torch.where(in_range, base + rows, -1)
    return segment_min_flat_ref(keys.reshape(-1), segs.reshape(-1), nb * block_rows)


def multilinear_dense_ref(p: torch.Tensor, a: torch.Tensor):
    """Per row i, the lexicographic argmin over j of ``(a_ij, j)`` subject to
    ``p_i != p_j`` and ``a_ij < inf``, with payload ``p_j`` of the winner.

    p: int32 [n]; a: float32 [n, n] (+inf = no edge; NaN is never valid,
    -inf is). Returns (minw float32 [n], mincol int32 [n], minpay int32
    [n]); the identity ``(inf, IMAX, IMAX)`` at rows with no valid entry.
    """
    n = a.shape[0]
    if n == 0:
        return (a.new_empty(0), p.new_empty(0, dtype=torch.int32),
                p.new_empty(0, dtype=torch.int32))
    col = torch.arange(n, dtype=torch.int32, device=a.device)
    valid = (p[:, None] != p[None, :]) & (a < INF)
    w = torch.where(valid, a, INF)
    minw = torch.amin(w, dim=1)
    on = (w == minw[:, None]) & (minw[:, None] < INF)
    mincol = torch.amin(torch.where(on, col[None, :], IMAX), dim=1)
    winner = on & (col[None, :] == mincol[:, None])
    minpay = torch.amin(torch.where(winner, p[None, :].to(torch.int32), IMAX), dim=1)
    return minw, mincol, minpay


def key64(w: torch.Tensor, eid: torch.Tensor) -> torch.Tensor:
    """The min-outgoing kernel's 64-bit keys ``ord(w) << 32 | (eid ^ 2^31)``
    (``csrc/min_outgoing_flat64.cu``), as int64 with the top bit flipped:
    torch on the CPU has no uint64 min, and the flip orders the same way.
    ``-0.0`` is keyed as ``+0.0``."""
    bits = torch.where(w == 0, 0.0, w).view(torch.int32).long()
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # floats in signed order
    return (ordered << 32) | (eid.long() + (1 << 31))


def unkey64(keys: torch.Tensor):
    """(w float32, eid int32) of :func:`key64` keys."""
    hi = keys >> 32
    bits = hi ^ ((hi >> 31) & 0x7FFFFFFF)
    w = bits.to(torch.int32).view(torch.float32)
    return w, ((keys & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _least_keys(seg, key, payload, n: int, device) -> EdgeMin:
    """Per segment of ``[0, n)`` the least 64-bit key (:func:`key64`) and
    the least ``payload`` among the pieces that hold it; ``(inf, IMAX,
    IMAX)`` at a segment with no piece. ``seg`` int64 lies in ``[0, n)``."""
    out = torch.full((n,), KEY64_IDENTITY, dtype=torch.int64, device=device)
    out.scatter_reduce_(0, seg, key, "amin", include_self=True)
    win = key == out[seg]
    pay = torch.full((n,), IMAX, dtype=torch.int32, device=device)
    pay.scatter_reduce_(0, seg[win], payload[win], "amin", include_self=True)
    empty = out == KEY64_IDENTITY
    minw, mineid = unkey64(out)
    return EdgeMin(w=torch.where(empty, INF, minw), eid=torch.where(empty, IMAX, mineid),
                   payload=(pay,))


def min_outgoing_flat64_ref(p, src, dst, w, eid, valid, n: int):
    """Plain version of ``csrc/min_outgoing_flat64.cu``: per root
    ``s = p[src]``, the least ``(w, eid)`` over the outgoing edges
    (``valid`` and ``p[src] != p[dst]``) with the ``p[dst]`` of its edge
    (the least one where a multigraph repeats the pair).

    p int32 [n]; src, dst, eid int32 [E]; w float32 [E] (not NaN); valid
    bool [E]. Returns (EdgeMin over [n], int64 0-d count of the outgoing
    edges); ``(inf, IMAX, IMAX)`` at roots with no outgoing edge, and a
    zero weight as ``+0.0``. Roots outside ``[0, n)`` are dropped.
    """
    ps = p[src].long()
    pd = p[dst]
    outgoing = valid & (ps != pd)
    count = outgoing.sum()
    take = (outgoing & (ps >= 0) & (ps < n)).nonzero().squeeze(1)
    return _least_keys(ps[take], key64(w[take], eid[take]), pd[take], n, p.device), count


def min_outgoing_und64_ref(p, lo, hi, w, eid, valid, n: int):
    """Plain version of ``csrc/min_outgoing_flat64.cu``'s undirected mode:
    each undirected edge ``(lo, hi)`` is outgoing when ``valid`` and
    ``p[lo] != p[hi]``, and offers its ``(w, eid)`` to both of its roots,
    to ``p[lo]`` with the payload ``p[hi]`` and to ``p[hi]`` with
    ``p[lo]``: :func:`min_outgoing_flat64_ref` over the two directions of
    every edge.

    Same arguments, dtypes and result as :func:`min_outgoing_flat64_ref`
    with ``lo``/``hi`` in place of ``src``/``dst``; the count is of the
    outgoing undirected edges. A root outside ``[0, n)`` drops that side.
    """
    plo = p[lo].long()
    phi = p[hi].long()
    outgoing = valid & (plo != phi)
    count = outgoing.sum()
    take = outgoing.nonzero().squeeze(1)
    plo, phi = plo[take], phi[take]
    key = key64(w[take], eid[take])
    seg = torch.cat([plo, phi])
    other = torch.cat([phi, plo]).to(torch.int32)
    key = torch.cat([key, key])
    keep = (seg >= 0) & (seg < n)
    return _least_keys(seg[keep], key[keep], other[keep], n, p.device), count
