"""Shortcutting strategies (paper §IV-B, Algorithm 2).

- ``shortcut_once``      — the original AS step: p_i ← p_{p_i} for non-star i.
- ``complete_shortcut``  — iterate p ← p[p] until every tree is a star.
- ``csp_shortcut``       — Complete Shortcutting with Prefetching: gather the
                           ``changed = {(i, p_i) : p_i ≠ p_i^prev}`` pairs
                           once, compress that map to its fixpoint by pointer
                           doubling within the map, then apply it in one pass.
- ``optimized_shortcut`` — the paper's OS policy: CSP when |changed| fits the
                           prefetch budget, plain complete shortcut otherwise.

The JAX package's ``lax.while_loop``/``lax.cond`` become host loops and
branches here; each step's condition is one ``.item()`` (a device sync
on the card).
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.obs.trace import host_sync

IMAX = int(torch.iinfo(torch.int32).max)


def shortcut_once(p: torch.Tensor, star: torch.Tensor) -> torch.Tensor:
    """AS step (iii): p_i ← p_{p_i} for each vertex not in a star."""
    return torch.where(star, p, p[p])


def count_shortcut_subiters(p: torch.Tensor):
    """Pointer-jump until p == p[p]; returns (p, number of jumps)."""
    k = 0
    while True:
        pp = p[p]
        host_sync("shortcut.any")
        if not bool((pp != p).any()):
            return p, k
        p, k = pp, k + 1


def complete_shortcut(p: torch.Tensor) -> torch.Tensor:
    """Pointer-jump until p == p[p] (every tree a star)."""
    return count_shortcut_subiters(p)[0]


def _compress_changed_map(ids: torch.Tensor, vals: torch.Tensor):
    """Pointer-double the changed map to its fixpoint using only local reads.

    ids: sorted changed vertex ids (padded with IMAX), vals: their new
    parents. After compression, vals[k] is outside the map (or a fixpoint),
    so one application resolves any chain.
    """
    last = ids.shape[0] - 1
    real = ids != IMAX

    def lookup(x):
        j = torch.searchsorted(ids, x).clamp_(0, last)
        # x == IMAX are padding entries — never a hit.
        hit = (ids[j] == x) & (x != IMAX)
        return torch.where(hit, vals[j], x), hit

    while True:
        nxt, hit = lookup(vals)
        host_sync("shortcut.compress_any")
        if not bool((hit & real).any()):
            return ids, vals
        vals = nxt


def build_changed(p: torch.Tensor, p_prev: torch.Tensor, capacity: int):
    """Fixed-capacity (ids, vals) buffer of vertices whose parent changed.

    Returns (ids sorted asc padded IMAX, vals, count, overflowed).
    """
    n = p.shape[0]
    capacity = min(capacity, n)
    changed = p != p_prev
    count = changed.sum(dtype=torch.int32)
    key = torch.where(
        changed, torch.arange(n, dtype=torch.int32, device=p.device), IMAX
    )
    ids = -torch.topk(-key, capacity, sorted=True).values  # smallest ids
    safe = ids.clamp(0, n - 1)
    vals = torch.where(ids == IMAX, IMAX, p[safe])
    return ids, vals, count, count > capacity


def csp_shortcut(p: torch.Tensor, p_prev: torch.Tensor, capacity: int) -> torch.Tensor:
    """Algorithm 2, single-shard semantics. On overflow the buffer dropped
    entries, so fall back to the complete shortcut."""
    ids, vals, _, overflow = build_changed(p, p_prev, capacity)
    host_sync("shortcut.overflow")
    if bool(overflow.item()):
        return complete_shortcut(p)
    ids, vals = _compress_changed_map(ids, vals)
    j = torch.searchsorted(ids, p).clamp_(0, ids.shape[0] - 1)
    return torch.where(ids[j] == p, vals[j], p)


def optimized_shortcut(p: torch.Tensor, p_prev: torch.Tensor, capacity: int) -> torch.Tensor:
    """Paper's OS: CSP when |changed| ≤ capacity, complete shortcut
    otherwise — on one device exactly :func:`csp_shortcut`'s branches."""
    return csp_shortcut(p, p_prev, capacity)


def make_shortcut_fn(strategy: str, capacity: int = 1 << 16):
    """strategy ∈ {complete, csp, os} → ``fn(p, p_prev)``."""
    if strategy == "complete":
        return lambda p, p_prev: complete_shortcut(p)
    if strategy == "csp":
        return partial(csp_shortcut, capacity=capacity)
    if strategy == "os":
        return partial(optimized_shortcut, capacity=capacity)
    raise ValueError(f"unknown shortcut strategy {strategy!r}")
