"""Supervertex rank/relabel pass (counterpart of ``repro.coarsen.relabel``).

After K hook+shortcut rounds every tree is a star, so the parent vector
``p`` is a component labeling by *root vertex id*. Contraction renames
each root to its **rank**, a prefix sum over root indicators, giving
contiguous supervertex ids in [0, n′): one cumsum and two gathers on the
graph's device.

``new_ids[v]`` is defined for every vertex (its root's rank), so edge
relabeling and the original-vertex → supervertex ``label_map``
composition are plain gathers.
"""
from __future__ import annotations

import torch

from repro_torch.obs.trace import host_sync


def rank_relabel(p: torch.Tensor):
    """Star-canonical parent vector → (new_ids, n_next).

    new_ids: int32 [n], the supervertex id (root rank) of every vertex;
    n_next: int32 scalar tensor, the number of supervertices (= roots,
    including isolated vertices, which stay their own supervertex).
    """
    i = torch.arange(p.shape[0], dtype=p.dtype, device=p.device)
    is_root = (p == i).to(torch.int32)
    rank = torch.cumsum(is_root, 0, dtype=torch.int32) - 1  # root v ↦ #roots ≤ v − 1
    new_ids = rank[p.long()]  # every vertex inherits its root's rank
    return new_ids, is_root.sum(dtype=torch.int32)


def relabel_edges(new_ids: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """Edge endpoints in the previous level's vertex space → supervertex ids."""
    return new_ids[src.long()], new_ids[dst.long()]


def compose_labels(label_map: torch.Tensor, new_ids: torch.Tensor) -> torch.Tensor:
    """original vertex → current-level id, composed with one more level
    (``new_ids`` already routes through the level's parent vector)."""
    return new_ids[label_map.long()]


def canonical_minvertex_labels(comp, comp_space: int) -> torch.Tensor:
    """Canonical component labels: each original vertex gets the *minimum
    original vertex* of its component.

    ``comp`` is an int [n0] tensor (or array) of component ids in an id
    space of size ``comp_space`` (e.g. residual-solve root ids gathered
    through the level ``label_map``). Returns int32 [n0] on ``comp``'s
    device (the CPU for an array). A stable sort makes each component's
    first member its minimum vertex, where a scatter-min would send every
    vertex of a large component to one slot.
    """
    comp = torch.as_tensor(comp).long()
    n0 = comp.numel()
    comp_s, order = torch.sort(comp, stable=True)
    first = torch.ones_like(comp_s, dtype=torch.bool)
    first[1:] = comp_s[1:] != comp_s[:-1]
    reps = torch.full((comp_space,), n0, dtype=torch.int64, device=comp.device)
    host_sync("labels.mask", 2)
    reps[comp_s[first]] = order[first]
    return reps[comp].to(torch.int32)
