"""Plain PyTorch versions of the port's kernels: the CPU path and the
oracle each CUDA kernel is held against on the card."""
from __future__ import annotations

import torch

from repro_torch.core.semiring import IMAX, INF, PACK_IDENTITY


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
