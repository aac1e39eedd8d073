"""Algebraic Awerbuch-Shiloach minimum spanning forest (paper Algorithm 1).

Variants, as in ``repro.core.msf``:

- ``variant="complete"`` (default, paper §IV-B): complete shortcutting
  keeps every tree a star at the top of each round, so the starcheck
  disappears and hooking fuses the line-10 projection into the
  multilinear kernel (segment ids = p[src] are root ids).
- ``variant="paper"`` (faithful Algorithm 1): starcheck, per-vertex
  multilinear kernel, separate projection to roots, one shortcut round.
- ``variant="pairwise"`` (paper §IV-A baseline): materialize
  m_ij = (a_ij, p_j) first, then reduce.

The JAX driver's ``lax.while_loop`` is a host loop here: one round per
step, stopping when a round changes no parent (FastSV's convergence
test, paper §V) or at the unroll guard; the stop test is one ``.item()``.
In obs trace mode the same loop runs under an ``msf.flat`` span with one
device-synced ``msf.round`` span per round (as the reference's traced
loop records), and inside each round the port's own device-synced phase spans
``msf.min_outgoing``, ``msf.hook`` and ``msf.shortcut``, with the
trace-only count of the round's outgoing edges under an ``msf.counts``
span of its own between the first two, so that no phase span times it;
otherwise it adds no span and no sync. Each host wait counts in
``obs.host_sync``'s tally.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.obs.trace import host_sync, trace_active, trace_span
from repro_torch.core import shortcut as sc
from repro_torch.core.multilinear import (
    min_outgoing_coo,
    min_outgoing_coo_packed,
    project_to_roots,
)
from repro_torch.core.semiring import IMAX, INF, segment_argmin
from repro_torch.graphs.structures import Graph
from repro_torch.kernels import ops


class MSFResult(NamedTuple):
    weight: torch.Tensor  # float32 scalar: total MSF weight
    parent: torch.Tensor  # int32 [n]: component representative per vertex
    msf_eids: torch.Tensor  # int32 [n]: global eids of MSF edges, IMAX padded
    n_msf_edges: torch.Tensor  # int32 scalar
    iterations: torch.Tensor  # int32 scalar


def starcheck(p: torch.Tensor) -> torch.Tensor:
    """AS starcheck (paper §II-C): s_i = does vertex i belong to a star."""
    gp = p[p]
    s = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
    nonstar = gp != p
    # Vertex i informs its grandparent the tree is not a star. Only the
    # non-star vertices write (the reference drops the rest out of bounds).
    host_sync("starcheck.mask")
    s[gp[nonstar].long()] = False
    s = s & ~nonstar
    # Remaining vertices query their parent.
    return s & s[p]


def hook_and_tiebreak(p, r_w, r_eid, r_parent):
    """Lines 11-13: hook star roots with their min outgoing edge, then break
    the 2-cycles hooking introduces (larger root keeps the hook)."""
    i = torch.arange(p.shape[0], dtype=p.dtype, device=p.device)
    hooked = r_w < INF  # only roots receive a valid r entry
    p_h = torch.where(hooked, r_parent, p)
    # Tie break: i was a (hooked) root, i < p_i, and p_{p_i} == i.
    t = hooked & (i < p_h) & (p_h[p_h] == i)
    p_new = torch.where(t, i, p_h)
    keep = hooked & ~t  # roots whose hook survives contribute their edge
    return p_new, keep, t


def record_edges(msf_eids, n_f, keep, r_eid):
    """Append the surviving hook edges' eids to the MSF buffer (in place:
    the driver owns the buffer, so no [n] copy per round)."""
    pos = n_f + torch.cumsum(keep, 0, dtype=torch.int32) - 1
    # Only the winners write (the reference drops the rest out of bounds).
    host_sync("record_edges.nonzero")
    win = keep.nonzero().squeeze(1)  # one host sync for the winners' count
    msf_eids[pos[win].long()] = r_eid[win]
    return msf_eids, n_f + keep.sum(dtype=torch.int32)


def count_true(mask: torch.Tensor) -> torch.Tensor:
    """0-d int64 count of a contiguous bool tensor's True entries. Eight
    bytes (each 0 or 1) are summed per int64 word by one multiply, whose top
    byte holds their sum. ``mask.sum()`` first casts the whole mask to an
    int64 copy, eight bytes an entry; ``view`` raises for a mask it cannot
    reinterpret as words."""
    k = mask.numel() // 8 * 8
    words = mask[:k].view(torch.int64)
    return ((words * 0x0101010101010101) >> 56).sum() + mask[k:].sum()


def _make_msf_body(graph: Graph, variant, shortcut_fn, pack, segmin):
    """One hook+shortcut round as ``body(state) -> state`` over the
    6-tuple ``(p, total, msf_eids, n_f, it, done)``. In trace mode its
    phases are the spans ``msf.min_outgoing``, ``msf.hook`` and
    ``msf.shortcut`` (no-ops otherwise), and ``msf.counts`` carries the
    round's ``edges`` (scanned) and ``outgoing`` (joining two components)."""
    n = graph.n
    src, dst, w, eid, valid = graph.src, graph.dst, graph.w, graph.eid, graph.valid
    n_edges = int(src.shape[0])

    def min_outgoing(p):
        """(per-root minimum outgoing edge, the edges that took part, or
        None outside trace mode): their bool [E] mask, or the kernel
        route's 0-d count (``min_outgoing_coo``), which only trace mode
        asks the kernel for."""
        tracing = trace_active()
        if variant == "paper":
            s = starcheck(p)
            q, outgoing = min_outgoing_coo(p, src, dst, w, eid, valid, n, segment="vertex",
                                           star=s, return_outgoing=True)
            r = project_to_roots(q, p, n)
        elif variant == "pairwise":
            # Paper §IV-A pairwise baseline: materialize m = (a_ij, p_j)
            # into nnz-sized buffers (the extra writes), then reduce with
            # f(p_i, m_ij). Algebraically identical to the fused kernel.
            m_w = torch.where(valid, w, INF)
            m_pd = torch.where(valid, p[dst], IMAX)
            m_eid = torch.where(valid, eid, IMAX)
            ps = p[src]
            outgoing = (ps != m_pd) & valid
            r = segment_argmin(m_w, m_eid, (m_pd,), ps, n, valid=outgoing)
        elif pack:
            r, outgoing = min_outgoing_coo_packed(p, src, dst, w, eid, valid, n,
                                                  segmin=segmin, return_outgoing=True)
        else:
            got = min_outgoing_coo(p, src, dst, w, eid, valid, n, segment="root",
                                   return_outgoing=tracing)
            r, outgoing = got if tracing else (got, None)
        return r, (outgoing if tracing else None)

    def body(state):
        p, total, msf_eids, n_f, it, _ = state
        p_prev = p
        with trace_span("msf.min_outgoing") as sp:
            r, outgoing = min_outgoing(p)
            sp.attach(r)
        if outgoing is not None:
            with trace_span("msf.counts", edges=n_edges) as sp:
                sp.set(outgoing=int(outgoing if outgoing.dim() == 0 else count_true(outgoing)))
            del outgoing
        with trace_span("msf.hook") as sp:
            p_h, keep, _ = hook_and_tiebreak(p, r.w, r.eid, r.payload[0])
            total = total + torch.where(keep, r.w, 0.0).sum()
            msf_eids, n_f = sp.attach(record_edges(msf_eids, n_f, keep, r.eid))
        with trace_span("msf.shortcut") as sp:
            if variant == "paper":
                p_next = sp.attach(sc.shortcut_once(p_h, starcheck(p_h)))
            else:
                p_next = sp.attach(shortcut_fn(p_h, p_prev))
        host_sync("msf.done")
        done = torch.equal(p_next, p_prev)
        return p_next, total, msf_eids, n_f, it + 1, done

    return body


def _msf_init(graph: Graph, parent0):
    dev = graph.device
    if parent0 is None:
        p0 = torch.arange(graph.n, dtype=torch.int32, device=dev)
    else:
        # Canonicalize: the hooking kernels rely on the every-tree-a-star
        # invariant at the top of each round.
        p0 = sc.complete_shortcut(torch.as_tensor(parent0).to(device=dev, dtype=torch.int32))
    return (
        p0,
        torch.zeros((), dtype=torch.float32, device=dev),
        torch.full((graph.n,), IMAX, dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        0,
        False,
    )


def _msf_limit(n: int, max_iters) -> int:
    return int(max_iters if max_iters is not None else 2 * int(n).bit_length() + 8)


def run_flat(
    graph: Graph,
    *,
    parent0=None,
    variant: str = "complete",
    shortcut: str = "complete",
    capacity: int = 1 << 16,
    max_iters: int | None = None,
    unroll_guard: bool = True,
    pack: bool = False,
    segmin=None,
) -> MSFResult:
    """Flat AS driver for callers holding a *resolved* segmin callable
    (the solve package's flat engine, :func:`flat_msf`)."""
    limit = _msf_limit(graph.n, max_iters)
    shortcut_fn = sc.make_shortcut_fn(shortcut, capacity) if variant != "paper" else None
    body = _make_msf_body(graph, variant, shortcut_fn, pack, segmin)
    state = _msf_init(graph, parent0)
    # msf.flat / msf.round open only in trace mode (the reference's
    # _msf_traced): off and metrics run the same loop with no span and no
    # sync. The round attr is the host loop's own int.
    with trace_span("msf.flat", n=graph.n, variant=variant) as sp:
        while not state[5] and (not unroll_guard or state[4] < limit):
            with trace_span("msf.round", round=state[4]) as rsp:
                state = rsp.attach(body(state))
        p, total, msf_eids, n_f, it, _ = state
        # canonical labels (complete variant: no-op)
        p = sp.attach(sc.complete_shortcut(p))
        sp.set(iterations=it)
    host_sync("msf.iterations")  # a synchronous copy to the device
    return MSFResult(
        weight=total, parent=p, msf_eids=msf_eids, n_msf_edges=n_f,
        iterations=torch.tensor(it, dtype=torch.int32, device=graph.device),
    )


def flat_msf(graph: Graph, *, pack: bool = False, segmin: str | None = None,
             **kw) -> MSFResult:
    """Internal flat AS solve with a *string* segmin request, selected by
    :func:`~repro_torch.kernels.ops.packed_segmin` at the flat site."""
    return run_flat(
        graph, pack=pack, segmin=ops.packed_segmin(segmin, "flat") if pack else None, **kw,
    )
