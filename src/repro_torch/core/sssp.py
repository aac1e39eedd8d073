"""Algebraic Bellman-Ford SSSP (paper §II-B, the motivating example for
algebraic graph algorithms): up to n−1 tropical-semiring SpMVs with early
exit on convergence, over the same COO substrate as the MSF engine.

The reference's ``lax.while_loop`` is a host loop here, with one host
sync per round for its stop test (no distance changed).
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import INF, segment_min, tropical_spmv
from repro_torch.graphs.structures import Graph

# Above this largest in-degree a round scatters only the improving
# candidates. Scattering every candidate piles a hub's in-edges onto its
# one slot, where the card's atomics serialise: on R-MAT scale 20 (largest
# in-degree 39,579) that costs ~0.57 ms a round, ~14 ns per edge of the
# hub, against the ~0.07 ms of launches a round the masked form adds on
# the 1024 x 1024 grid (PERF.md, measured with chip_smoke.py on one H100).
# The limit is an estimate: a linear cost fitted to those two graphs puts
# break-even near 5,000, and no graph with a largest in-degree near it has
# been measured.
HUB_IN_DEGREE = 4096


def _relax_improving(d, src, dst, w, n):
    """One relaxation scattering only the edges whose candidate beats
    ``d[dst]`` (the rest cannot change d'); the ``nonzero`` that finds them
    is the round's sync, and none found means d' == d."""
    cand = d[src] + w
    better = (cand < d[dst]).nonzero().squeeze(1)
    return torch.minimum(d, segment_min(cand[better], dst[better], n, INF)), better.numel() > 0


def _relax_all(d, src, dst, w, n):
    """One relaxation scattering every candidate, as the reference does;
    the stop test d' == d is the round's sync."""
    d_new = tropical_spmv(d, src, dst, w, n)
    return d_new, not torch.equal(d_new, d)


def sssp(graph: Graph, source: int, *, max_iters: int | None = None):
    """Single-source shortest path distances from ``source``.

    Returns ``(d, iterations)``: d float32 [n] (+inf = unreachable) on the
    graph's device, and the number of relaxations run (the last one
    changes nothing unless the limit, by default n − 1, stopped the loop).
    """
    n = graph.n
    w = torch.where(graph.valid, graph.w, INF)
    in_degree = torch.bincount(graph.dst[graph.valid].long(), minlength=n)
    hub = n > 0 and int(in_degree.max()) > HUB_IN_DEGREE
    relax = _relax_improving if hub else _relax_all
    d = torch.full((n,), INF, dtype=torch.float32, device=graph.device)
    d[source] = 0.0
    limit = int(max_iters if max_iters is not None else n - 1)
    it, changed = 0, True
    while changed and it < limit:
        d, changed = relax(d, graph.src, graph.dst, w, n)
        it += 1
    return d, it
