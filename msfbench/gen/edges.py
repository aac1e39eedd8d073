"""Canonical undirected edge lists, made on the device.

The layout is the one ``repro_torch.graphs.from_edges`` gives a user's
edges: self-loops dropped, parallel edges collapsed to the cheapest (the
earliest draw among equals), edges sorted by ``(lo, hi)`` with ``lo < hi``,
and edge ids numbering them in that order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Edges(NamedTuple):
    """Undirected edges on one device: ``lo < hi`` (int32), integer weights
    (uint8, 1..255); edge ``i`` has id ``i``."""

    lo: torch.Tensor
    hi: torch.Tensor
    w: torch.Tensor
    n: int

    @property
    def m(self) -> int:
        return int(self.lo.shape[0])


def canonical(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, n: int) -> Edges:
    """``Edges`` of the draws ``(u[i], v[i], w[i])`` (int64 endpoints in
    ``[0, n)``, integer weights below 256): one stable sort of
    ``key << 8 | w`` puts every pair's cheapest, earliest draw first."""
    lo = torch.minimum(u, v)
    hi = torch.maximum(u, v)
    keep = lo != hi
    lo, hi, w = lo[keep], hi[keep], w[keep].to(torch.int64)
    comp = ((lo * n + hi) << 8) | w
    comp, _ = torch.sort(comp, stable=True)
    key = comp >> 8
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    key, w = key[first], (comp[first] & 0xFF)
    return Edges(
        lo=(key // n).to(torch.int32),
        hi=(key % n).to(torch.int32),
        w=w.to(torch.uint8),
        n=int(n),
    )


def weights(gen: torch.Generator, m: int, device, lo: int = 1, hi: int = 255) -> torch.Tensor:
    """``m`` integer weights uniform in ``[lo, hi]`` (paper §VII: 1..255)."""
    return torch.randint(lo, hi + 1, (m,), generator=gen, device=device, dtype=torch.int64)
