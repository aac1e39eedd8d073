"""Graph500 Kronecker (R-MAT) generator, on the device.

The Graph500 specification's generator: ``edgefactor * 2**scale`` edges,
each endpoint pair chosen bit by bit with the initiator probabilities
A, B, C (D = 1 - A - B - C), then every vertex label sent through one
random permutation. Weights are integers 1..255 (paper §VII). The same
seed gives the same edges on the same device.
"""
from __future__ import annotations

import torch

from msfbench import rng
from msfbench.gen import edges as E


def _permutation(n: int, seed: int, index: int, device) -> torch.Tensor:
    return torch.randperm(n, generator=rng.generator(device, seed, "kronecker.perm", index),
                          device=device)


def draws(cfg: dict, gen: torch.Generator, m: int, perm: torch.Tensor, device):
    """``m`` Kronecker draws ``(u, v, w)``: int64 endpoints after the
    vertex permutation, int64 weights."""
    scale = int(cfg["scale"])
    a, b, c = float(cfg["A"]), float(cfg["B"]), float(cfg["C"])
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    u = torch.zeros(m, dtype=torch.int64, device=device)
    v = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand((2, m), generator=gen, device=device)
        ii = r[0] > ab
        jj = r[1] > torch.where(ii, c_norm, a_norm)
        u |= ii.to(torch.int64) << bit
        v |= jj.to(torch.int64) << bit
    w = E.weights(gen, m, device, *cfg["weights"])
    return perm[u], perm[v], w


def base_edges(cfg: dict, seed: int, index: int, device) -> E.Edges:
    """Graph ``index`` of the configuration for ``seed``: its own draws
    and its own vertex permutation."""
    n = 1 << int(cfg["scale"])
    m = int(cfg["edgefactor"]) * n
    perm = _permutation(n, seed, index, device)
    gen = rng.generator(device, seed, "kronecker.base", index)
    u, v, w = draws(cfg, gen, m, perm, device)
    return E.canonical(u, v, w, n)
