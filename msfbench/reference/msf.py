"""Plain reference of the minimum spanning forest, in plain PyTorch.

Borůvka's algorithm over undirected edges ``(lo, hi, w)``: every round,
each component takes its cheapest outgoing edge under the strict order
``(w, position)``, the chosen edges join the forest, and the components
they join merge. With that order the forest is unique: it is the exact
MSF under (weight, edge id) when edge ``i`` has id ``i``. Imports torch
only; works on any device and takes nothing the program made.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_NONE = torch.iinfo(torch.int64).max
_POS_BITS = 36  # positions below 2**36; weights below 2**27


class Forest(NamedTuple):
    in_forest: torch.Tensor  # bool [m]: edge i is in the MSF
    labels: torch.Tensor  # int64 [n]: smallest vertex of each vertex's component
    weight: float  # exact total weight (float64 of integer weights)
    n_components: int


def _jump(parent: torch.Tensor) -> torch.Tensor:
    """Pointer jumping to the roots (``parent`` is a forest of pointers)."""
    while True:
        nxt = parent[parent]
        if torch.equal(nxt, parent):
            return parent
        parent = nxt


def canonical_labels(labels: torch.Tensor) -> torch.Tensor:
    """Relabel a partition by the smallest vertex of each class, so two
    labellings of one partition become equal element by element."""
    n = labels.shape[0]
    labels = labels.long()
    first = torch.full((n,), n, dtype=torch.int64, device=labels.device)
    first.scatter_reduce_(0, labels, torch.arange(n, device=labels.device), "amin")
    return first[labels]


def msf(lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor, n: int) -> Forest:
    """The MSF of the undirected multigraph ``(lo[i], hi[i], w[i])`` on
    ``n`` vertices, ties broken by the edge's position ``i``. Self-loops
    never enter it. ``w`` holds integers (any integer or float dtype)."""
    dev = lo.device
    m = int(lo.shape[0])
    if m >= 1 << _POS_BITS:
        raise ValueError(f"{m} edges exceed the reference's 2**{_POS_BITS} positions")
    lo = lo.long()
    hi = hi.long()
    key = (w.long() << _POS_BITS) | torch.arange(m, device=dev)
    comp = torch.arange(n, device=dev)
    ar = torch.arange(n, device=dev)
    in_forest = torch.zeros(m, dtype=torch.bool, device=dev)
    active = torch.nonzero(lo != hi).squeeze(1)
    while True:
        cu, cv = comp[lo[active]], comp[hi[active]]
        cross = cu != cv
        active, cu, cv = active[cross], cu[cross], cv[cross]
        if active.numel() == 0:
            break
        k = key[active]
        best = torch.full((n,), _NONE, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, cu, k, "amin")
        best.scatter_reduce_(0, cv, k, "amin")
        roots = torch.nonzero(best != _NONE).squeeze(1)
        e = best[roots] & ((1 << _POS_BITS) - 1)
        in_forest[e] = True
        a, b = comp[lo[e]], comp[hi[e]]
        parent = ar.clone()
        parent[roots] = torch.where(a == roots, b, a)
        # two components that chose the same edge point at each other:
        # the smaller one stays the root
        mutual = (parent[parent] == ar) & (ar < parent)
        parent = _jump(torch.where(mutual, ar, parent))
        comp = parent[comp]
    labels = canonical_labels(comp)
    weight = float(w[in_forest].to(torch.float64).sum())
    ncc = int((labels == ar).sum())
    return Forest(in_forest, labels, weight, ncc)


def components(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """Canonical component labels (smallest vertex) of the graph's edges."""
    return msf(lo, hi, torch.zeros_like(lo, dtype=torch.int64), n).labels


def root_labels(parent, n: int, max_jumps: int = 64):
    """Canonical labels of a parent vector judged as the program's output:
    pointer-jumped to its roots, or ``None`` when it does not settle into
    a forest of pointers within ``max_jumps`` jumps (every vertex reaching
    a vertex that points at itself) or points outside ``[0, n)``."""
    p0 = torch.as_tensor(parent).long()
    if p0.shape != (n,) or (n and (int(p0.min()) < 0 or int(p0.max()) >= n)):
        return None
    p = p0
    for _ in range(max_jumps):
        nxt = p[p]
        if torch.equal(nxt, p):
            # a cycle of pointers also settles, on vertices that are no roots
            return canonical_labels(p) if bool((p0[p] == p).all()) else None
        p = nxt
    return None
