"""Algebraic Awerbuch-Shiloach / Shiloach-Vishkin connectivity (paper §II-D).

The LACC/FastSV variant: hooking uses any outgoing edge (the smallest
neighbouring parent id), split into conditional hooking (only onto
smaller parent ids, acyclic by construction) and unconditional hooking
(for stagnant stars), with the same shortcutting as the MSF solver. It
cross-checks the MSF component labels.

The reference's ``lax.while_loop`` is a host loop here, stopping when a
round changes no parent or at ``2 * bit_length(n) + 8`` rounds.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import shortcut as sc
from repro_torch.core.msf import starcheck
from repro_torch.core.semiring import IMAX, segment_min
from repro_torch.graphs.structures import Graph


class CCResult(NamedTuple):
    parent: torch.Tensor  # int32 [n]: component root per vertex
    n_components: torch.Tensor  # int32 scalar
    iterations: torch.Tensor  # int32 scalar


def _min_neighbour_parent(p, src, dst, edges, n):
    """Per root r, the least ``p[dst]`` over the ``edges`` (bool [E]) whose
    ``p[src] == r`` and ``p[src] != p[dst]``; IMAX where there is none.

    Only those edges are scattered. The reference also scatters an IMAX or
    the root's own id for every other edge; neither can change what the
    callers do with the result (a hook needs a value below the root's id,
    or below IMAX), and on the card they pile a component's edges onto its
    root's slot, where the atomics serialise.
    """
    ps, pd = p[src], p[dst]
    e = (edges & (ps != pd)).nonzero().squeeze(1)
    return segment_min(pd[e], ps[e], n, IMAX)


def connected_components(graph: Graph, *, max_iters: int | None = None) -> CCResult:
    """Component root per vertex, the component count and the rounds run."""
    n = graph.n
    src, dst, valid = graph.src, graph.dst, graph.valid
    i = torch.arange(n, dtype=torch.int32, device=graph.device)
    p = i
    limit = int(max_iters if max_iters is not None else 2 * int(n).bit_length() + 8)
    it, done = 0, False
    while not done and it < limit:
        p_prev = p
        s = starcheck(p)
        # Conditional hooking: each star root takes the smallest parent id
        # its star's edges reach, and hooks only onto a smaller id.
        ph = _min_neighbour_parent(p, src, dst, valid & s[src], n)
        p = torch.where((ph < i) & (p == i), ph, p)
        # Unconditional hooking: stars that stayed stagnant hook anywhere.
        stagnant = starcheck(p) & (p == p_prev)
        ph2 = _min_neighbour_parent(p, src, dst, valid & stagnant[src], n)
        hooked2 = (ph2 < IMAX) & (p == i)
        p = torch.where(hooked2, ph2, p)
        # Mutual unconditional hooks form 2-cycles (the hook target is a
        # min over ids, so no longer cycles); the smaller root keeps itself.
        p = torch.where(hooked2 & (i < p) & (p[p] == i), i, p)
        p = sc.complete_shortcut(p)
        done = torch.equal(p, p_prev)
        it += 1
    return CCResult(
        parent=p,
        n_components=(p == i).sum(dtype=torch.int32),
        iterations=torch.tensor(it, dtype=torch.int32, device=graph.device),
    )
