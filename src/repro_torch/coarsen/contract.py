"""Borůvka-style contraction rounds via the AS multilinear kernel
(counterpart of ``repro.coarsen.contract``).

One *level* = K hook+shortcut rounds of the flat MSF machinery
(``min_outgoing_coo`` → ``hook_and_tiebreak`` → ``complete_shortcut``)
from singleton stars, followed by the rank/relabel pass. Each round
merges every component with its minimum outgoing (w, eid)-lex edge, so
K rounds shrink the vertex count by ≥ 2^K wherever edges remain, and
every hooked edge is an MSF edge (cut property under the distinct
(w, eid) total order).

The recorded eids are the graph's *global* edge ids, threaded unchanged
through relabeling and filtering by the engine. The JAX package's
``jit``-unrolled round loop is a host loop here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.coarsen.relabel import rank_relabel
from repro_torch.core import shortcut as sc
from repro_torch.core.msf import hook_and_tiebreak, record_edges
from repro_torch.core.multilinear import min_outgoing_coo, min_outgoing_coo_packed
from repro_torch.core.semiring import (
    IMAX,
    INF,
    PACK_IDENTITY,
    EdgeMin,
    pack32,
    segment_min,
    unpack32,
)
from repro_torch.kernels import ops


class ContractResult(NamedTuple):
    parent: torch.Tensor  # int32 [n]: star-canonical labels after K rounds
    new_ids: torch.Tensor  # int32 [n]: vertex → supervertex rank in [0, n_next)
    n_next: torch.Tensor  # int32 scalar: supervertex count
    weight: torch.Tensor  # float32 scalar: weight hooked this level
    msf_eids: torch.Tensor  # int32 [n]: global eids chosen this level (front-packed)
    n_msf_edges: torch.Tensor  # int32 scalar


def hook_rounds(reduce_fn, n: int, rounds: int, device):
    """K hook+shortcut rounds from singleton stars, *without* the
    rank/relabel tail: ``(parent, weight, msf_eids, n_msf_edges)``."""
    p = torch.arange(n, dtype=torch.int32, device=device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    msf_eids = torch.full((n,), IMAX, dtype=torch.int32, device=device)
    n_f = torch.zeros((), dtype=torch.int32, device=device)
    for _ in range(rounds):
        r = reduce_fn(p)
        p_h, keep, _ = hook_and_tiebreak(p, r.w, r.eid, r.payload[0])
        total = total + torch.where(keep, r.w, 0.0).sum()
        msf_eids, n_f = record_edges(msf_eids, n_f, keep, r.eid)
        p = sc.complete_shortcut(p_h)
    return p, total, msf_eids, n_f


def contract_rounds(reduce_fn, n: int, rounds: int, device) -> ContractResult:
    """Shared K-round hook+shortcut driver; ``reduce_fn(p)`` yields the
    per-root MINWEIGHT EdgeMin for the current parent vector."""
    p, total, msf_eids, n_f = hook_rounds(reduce_fn, n, rounds, device)
    new_ids, n_next = rank_relabel(p)
    return ContractResult(
        parent=p, new_ids=new_ids, n_next=n_next, weight=total,
        msf_eids=msf_eids, n_msf_edges=n_f,
    )


def contract_level(src, dst, w, eid, valid, *, n: int, rounds: int = 2,
                   pack: bool = False, segmin=None) -> ContractResult:
    """Run K hook+shortcut rounds over the symmetric (directed) edge
    arrays and rank-relabel the surviving roots. Each round is exactly the
    complete-variant MSF body."""
    if pack:
        def reduce_fn(p):
            return min_outgoing_coo_packed(p, src, dst, w, eid, valid, n, segmin=segmin)
    else:
        def reduce_fn(p):
            return min_outgoing_coo(p, src, dst, w, eid, valid, n, segment="root")
    return contract_rounds(reduce_fn, n, rounds, src.device)


def contract_level_und(lo, hi, w, eid, valid, *, n: int, eid_capacity: int,
                       rounds: int = 2, pack: bool = False, segmin=None) -> ContractResult:
    """:func:`contract_level` over the *undirected* canonical arrays
    (each round's reduction: :func:`make_und_reduce`). Identical results
    to :func:`contract_level` on the concatenated form. ``eid_capacity``
    is a bound with eid < eid_capacity for every valid edge.
    """
    reduce_fn = make_und_reduce(
        lo, hi, w, eid, valid, n=n, eid_capacity=eid_capacity, pack=pack, segmin=segmin,
    )
    return contract_rounds(reduce_fn, n, rounds, lo.device)


def _identity(x):
    return x


def make_und_reduce(lo, hi, w, eid, valid, *, n: int, eid_capacity: int,
                    pack: bool = False, segmin=None, combine=None):
    """Build ``reduce_fn(p) → EdgeMin`` over the undirected canonical arrays.

    The ``outgoing`` mask is symmetric (p[lo] ≠ p[hi]), so each outgoing
    edge offers one key to both of its roots. Without pack32 on one device
    (``combine`` None) a round is one call of
    :func:`~repro_torch.kernels.ops.min_outgoing_und64`, which picks the
    winner and its payload (the other endpoint's root) itself. Otherwise
    the per-root partials are two segment-mins (segments p[lo], then
    p[hi]) combined elementwise, and the payload is gathered back through
    an eid → position table. ``combine`` is applied to every dense [n]
    partial *before* winner selection: the identity (``None``) on one
    device; a cross-device min all-reduce where the arrays are one shard of
    the edge set. The payload lookup is masked by locality (the eid →
    position table marks absent eids with −1), so a shard without the
    winning edge contributes the identity. ``segmin(keys, segs, n)`` is the
    packed segment-min of the pack32 path (``None``: the plain
    scatter-min).
    """
    if not pack and combine is None:
        def reduce_fn(p):
            return ops.min_outgoing_und64(p, lo, hi, w, eid, valid, n)[0]
        return reduce_fn
    if combine is None:
        combine = _identity
    dev = lo.device
    e = lo.shape[0]
    lo_l, hi_l = lo.long(), hi.long()
    # The reference scatters with mode="drop": here the edges that must not
    # write (invalid, or an eid out of range) go to a spare slot past the end.
    keep = valid & (eid >= 0) & (eid < eid_capacity)
    pos_of_eid = torch.full((eid_capacity + 1,), -1, dtype=torch.int32, device=dev)
    pos_of_eid[torch.where(keep, eid, eid_capacity).long()] = torch.arange(
        e, dtype=torch.int32, device=dev)
    pos_of_eid = pos_of_eid[:eid_capacity]
    i_n = torch.arange(n, dtype=torch.int32, device=dev)

    def payload_from_eid(p, mineid, empty):
        if e == 0:
            return combine(torch.full((n,), IMAX, dtype=torch.int32, device=dev))
        pos = pos_of_eid[mineid.clamp(0, eid_capacity - 1).long()]
        local = (pos >= 0) & ~empty  # this shard holds the winning edge
        safe = pos.clamp(0, e - 1).long()
        plo, phi = p[lo_l[safe]], p[hi_l[safe]]
        pd = torch.where(plo == i_n, phi, plo)
        return combine(torch.where(local, pd, IMAX))

    if pack:
        def reduce_fn(p):
            plo, phi = p[lo_l], p[hi_l]
            out = (plo != phi) & valid
            # Mask weights BEFORE the integer cast (padding carries +inf).
            w_int = torch.where(out, w, 0.0).to(torch.int64)
            key = torch.where(out, pack32(w_int, eid), PACK_IDENTITY)
            if segmin is None:
                m1 = segment_min(key, plo, n, PACK_IDENTITY)
                m2 = segment_min(key, phi, n, PACK_IDENTITY)
            else:
                m1 = segmin(key, plo, n)
                m2 = segmin(key, phi, n)
            minkey = combine(torch.minimum(m1, m2))
            w_out, eid_out = unpack32(minkey)
            empty = minkey == PACK_IDENTITY
            return EdgeMin(
                w=torch.where(empty, INF, w_out.to(torch.float32)),
                eid=torch.where(empty, IMAX, eid_out),
                payload=(payload_from_eid(p, eid_out, empty),),
            )
    else:
        def reduce_fn(p):
            plo, phi = p[lo_l], p[hi_l]
            out = (plo != phi) & valid
            wm = torch.where(out, w, INF)
            minw = combine(torch.minimum(
                segment_min(wm, plo, n, INF), segment_min(wm, phi, n, INF),
            ))
            on1 = out & (wm == minw[plo.long()])
            on2 = out & (wm == minw[phi.long()])
            mineid = combine(torch.minimum(
                segment_min(torch.where(on1, eid, IMAX), plo, n, IMAX),
                segment_min(torch.where(on2, eid, IMAX), phi, n, IMAX),
            ))
            empty = minw == INF
            return EdgeMin(w=minw, eid=mineid, payload=(payload_from_eid(p, mineid, empty),))
    return reduce_fn
