"""Edge filtering between contraction levels (counterpart of
``repro.coarsen.filter``).

Relabels the edge list into supervertex space, drops self-loops (edges
internal to a contracted component) and deduplicates parallel edges,
keeping the minimum-(w, eid)-lex representative. Dropping the heavier
parallels is exact under the distinct (w, eid) total order: parallel
supervertex edges close a cycle through the two contracted components,
and the cycle property excludes every non-minimal one from the MSF.

The device pipeline, all on the graph's device with fixed shapes:

1. canonical pair keys (``lo << 16 | hi`` when n ≤ 2^16, ``lo << 32 |
   hi`` beyond), stable-sorted so that duplicate pairs become adjacent;
   invalid entries sort last into one dead segment;
2. segment ids by a prefix sum over boundary flags (ranks in [0, E),
   non-decreasing);
3. the per-segment MINWEIGHT: in the pack32 regime one packed
   segment-min over the *sorted* ids (``segmin``, the hand-written
   sorted-segment kernel on the card), the 3-pass masked float reduction
   (``semiring.segment_argmin``) otherwise;
4. the winners' (lo, hi, w, global eid), front-packed.

The sorts are library sorts (``torch.sort(stable=True)``), as the
reference leaves them to ``jax.lax.sort``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.coarsen.relabel import relabel_edges
from repro_torch.core.semiring import (
    IMAX,
    INF,
    PACK_IDENTITY,
    pack32,
    segment_argmin,
    segment_min,
    unpack32,
)
from repro_torch.graphs.structures import canonical_edges, edge_keys, host_array
from repro_torch.obs.trace import host_sync

#: largest vertex count for the 32-bit pair-key sort path
PAIR_PACK_LIMIT = 1 << 16


class FilterResult(NamedTuple):
    """Deduped canonical edges, indexed by segment (front-packed: entries
    [0, m_new) are the live unique pairs, the rest carry valid=False)."""

    lo: torch.Tensor  # int32 [E]
    hi: torch.Tensor  # int32 [E]
    w: torch.Tensor  # float32 [E]
    eid: torch.Tensor  # int32 [E] — original global eids
    valid: torch.Tensor  # bool [E]
    m_new: torch.Tensor  # int32 scalar: number of unique live pairs


def _empty_result(w: torch.Tensor) -> FilterResult:
    dev = w.device
    z_i = torch.zeros((0,), dtype=torch.int32, device=dev)
    return FilterResult(
        lo=z_i, hi=z_i.clone(), w=torch.zeros((0,), dtype=w.dtype, device=dev),
        eid=z_i.clone(), valid=torch.zeros((0,), dtype=torch.bool, device=dev),
        m_new=torch.zeros((), dtype=torch.int32, device=dev),
    )


def front_packed(a, size: int, fill, device) -> torch.Tensor:
    """``a`` (array or tensor) in the front of a [size] tensor on
    ``device``, the rest ``fill``."""
    t = torch.as_tensor(a, device=device)
    if t is not a:  # a copy from the host
        host_sync("filter_host.to_device")
    out = torch.full((size,), fill, dtype=t.dtype, device=device)
    out[: t.shape[0]] = t
    return out


def _segments(sorted_key: torch.Tensor):
    """(boundary flags, segment ranks int32) of a sorted key array."""
    boundary = torch.ones_like(sorted_key, dtype=torch.bool)
    boundary[1:] = sorted_key[1:] != sorted_key[:-1]
    return boundary, torch.cumsum(boundary, 0, dtype=torch.int32) - 1


def filter_level(und_lo, und_hi, w, eid, valid, new_ids, *, n: int,
                 pack: bool = False, segmin=None) -> FilterResult:
    """Relabel into supervertex space, drop self-loops, dedupe parallels.

    Takes the *undirected* canonical arrays (one entry per edge). ``n`` is
    the previous level's vertex count, the bound on relabeled ids used for
    the sort sentinels. ``pack`` requires integral weights in [0, 255] and
    global eids < 2^24 − 1: (w, eid) is packed jointly, so the sort only
    orders the pair key and the segment-min settles the winner.
    ``segmin(keys, segs, num_segments)`` is that segment-min (``None``: the
    plain scatter-min).

    Output entries beyond ``m_new`` are the identity (lo = hi = 0,
    w = +inf, eid = IMAX, valid = False), so the arrays can feed the next
    level directly.
    """
    e = und_lo.shape[0]
    if e == 0:
        return _empty_result(w)
    ns, nd = relabel_edges(new_ids, und_lo, und_hi)
    lo = torch.minimum(ns, nd)
    hi = torch.maximum(ns, nd)
    real = valid & (lo != hi)

    if pack:
        # (w, eid) packed into one min-reducible value: the sort only makes
        # duplicate pairs adjacent, the segment-min picks the winner.
        w_int = torch.where(real, w, 0.0).to(torch.int64)
        wkey = torch.where(real, pack32(w_int, eid), PACK_IDENTITY)
        if n <= PAIR_PACK_LIMIT:
            key = torch.where(real, (lo.long() << 16) | hi.long(), PACK_IDENTITY)
        else:
            # One int64 key orders the (lo, hi) pairs as the reference's
            # two-key sort does; the segment ranks come out identical.
            key = (torch.where(real, lo, n).long() << 32) | torch.where(real, hi, n).long()
        key_s, order = torch.sort(key, stable=True)
        wkey_s = wkey[order]
        boundary, seg = _segments(key_s)
        if segmin is None:
            minkey = segment_min(wkey_s, seg, e, PACK_IDENTITY)
        else:
            minkey = segmin(wkey_s, seg, e)
        seg_live = minkey != PACK_IDENTITY
        w_min, eid_min = unpack32(minkey)
        # Every member of a segment carries the same pair key: its first
        # member writes it, the others write a spare slot past the end.
        keyseg = torch.zeros(e + 1, dtype=torch.int64, device=key.device)
        keyseg[torch.where(boundary, seg, e).long()] = key_s
        keyseg = keyseg[:e]
        shift, mask = (16, 0xFFFF) if n <= PAIR_PACK_LIMIT else (32, 0xFFFFFFFF)
        lo_out = (keyseg >> shift).to(torch.int32)
        hi_out = (keyseg & mask).to(torch.int32)
        return FilterResult(
            lo=torch.where(seg_live, lo_out, 0),
            hi=torch.where(seg_live, hi_out, 0),
            w=torch.where(seg_live, w_min.to(w.dtype), INF),
            eid=torch.where(seg_live, eid_min, IMAX),
            valid=seg_live,
            m_new=seg_live.sum(dtype=torch.int32),
        )

    # Float path: order by (pair key, w, eid) so that within each pair run
    # the (w, eid)-lex minimum comes first and the min-*position* winner IS
    # the representative. The reference's lexsort becomes successive stable
    # sorts, least significant key first.
    if n <= PAIR_PACK_LIMIT:
        key = torch.where(real, (lo.long() << 16) | hi.long(), PACK_IDENTITY)
    else:
        key = (torch.where(real, lo, n).long() << 32) | torch.where(real, hi, n).long()
    order = torch.sort(eid, stable=True).indices
    order = order[torch.sort(w[order], stable=True).indices]
    order = order[torch.sort(key[order], stable=True).indices]
    boundary, seg = _segments(key[order])
    lo_s, hi_s = lo[order], hi[order]
    w_s, eid_s = w[order], eid[order]
    real_s = real[order]
    pos = torch.arange(e, dtype=torch.int32, device=lo.device)

    em = segment_argmin(w_s, pos, (), seg, e, valid=real_s)
    seg_live = em.w < INF
    sel = em.eid.clamp(0, e - 1).long()
    return FilterResult(
        lo=torch.where(seg_live, lo_s[sel], 0),
        hi=torch.where(seg_live, hi_s[sel], 0),
        w=torch.where(seg_live, w_s[sel], INF),
        eid=torch.where(seg_live, eid_s[sel], IMAX),
        valid=seg_live,
        m_new=seg_live.sum(dtype=torch.int32),
    )


def filter_level_callback(und_lo, und_hi, w, eid, valid, new_ids, *, n: int) -> FilterResult:
    """:func:`filter_level` twin that runs the dedupe on the host
    (:func:`filter_level_host`) and pads its output back to the input
    capacity on the input's device: the reference's ``pure_callback``,
    as a direct call."""
    e = und_lo.shape[0]
    if e == 0:
        return _empty_result(w)
    l2, h2, w2, e2 = filter_level_host(und_lo, und_hi, w, eid, valid, new_ids, n)
    m = len(l2)
    dev = und_lo.device
    host_sync("filter_host.to_device")  # m_new's copy; front_packed counts its own
    return FilterResult(
        lo=front_packed(l2, e, 0, dev), hi=front_packed(h2, e, 0, dev),
        w=front_packed(w2, e, INF, dev).to(w.dtype), eid=front_packed(e2, e, IMAX, dev),
        valid=torch.arange(e, device=dev) < m,
        m_new=torch.tensor(m, dtype=torch.int32, device=dev),
    )


def filter_level_host(lo, hi, w, eid, valid, new_ids, n: int):
    """Host (numpy) twin of :func:`filter_level`: the same policy, returns
    compact unpadded numpy arrays (lo, hi, w, eid). Takes numpy arrays or
    tensors on any device."""
    host_sync("filter_host.to_host", 6)
    new_ids = host_array(new_ids)
    ns, nd = new_ids[host_array(lo)], new_ids[host_array(hi)]
    l, h, keep = canonical_edges(ns, nd)
    real = host_array(valid) & keep
    l, h = l[real], h[real]
    w, eid = host_array(w)[real], host_array(eid)[real]
    key = edge_keys(l, h, n)  # collision-free pair key
    order = np.lexsort((eid, w, key))  # per pair: min (w, eid) first
    key_s = key[order]
    first = np.ones(len(key_s), bool)
    first[1:] = key_s[1:] != key_s[:-1]
    idx = order[first]
    return l[idx], h[idx], w[idx], eid[idx]
