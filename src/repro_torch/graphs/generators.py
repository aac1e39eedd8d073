"""Synthetic graph generators (counterpart of ``repro.graphs.generators``).

The same seed gives the same numpy draws, and so edge arrays identical
to the JAX package's: uniform random graphs (paper §VII-C), R-MAT with
Graph500 parameters (§VII-B), 2-D grid road proxies, and disjoint unions
of random components. Integer weights are uniform in [1, 255] (§VII).
Generation runs on the host; ``device`` places the result (``None`` =
``"cuda"``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.structures import Graph, from_edges

WEIGHT_LO, WEIGHT_HI = 1, 255


def assign_distinct_weights(rng: np.random.Generator, m: int) -> np.ndarray:
    """Integer weights 1..255; distinctness comes from (w, eid) lex order."""
    return rng.integers(WEIGHT_LO, WEIGHT_HI + 1, size=m).astype(np.float64)


def random_graph(n: int, m: int, seed: int = 0, *, device=None) -> Graph:
    """Uniform random graph with ~m undirected edges."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, size=m)
    v = rng.integers(0, n, size=m)
    w = assign_distinct_weights(rng, m)
    return from_edges(u, v, w, n, device=device)


def rmat_graph(
    scale: int,
    edge_factor: int,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    *,
    device=None,
) -> Graph:
    """R-MAT generator (Graph500 parameters by default). n = 2**scale."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    u = np.zeros(m, np.int64)
    v = np.zeros(m, np.int64)
    ab = a + b
    abc = a + b + c
    for bit in range(scale):
        r = rng.random(m)
        right = r >= ab  # bottom half for the row bit
        r2 = rng.random(m)
        # Conditional column split given the row choice.
        col_p = np.where(right, (abc - ab) / (1.0 - ab), a / ab)
        down = r2 >= col_p
        u |= right.astype(np.int64) << bit
        v |= down.astype(np.int64) << bit
    w = assign_distinct_weights(rng, m)
    return from_edges(u, v, w, n, device=device)


def grid_road_graph(rows: int, cols: int, seed: int = 0, *, device=None) -> Graph:
    """2D grid graph: high diameter, degree ≤ 4 — a road-network proxy."""
    n = rows * cols
    idx = np.arange(n).reshape(rows, cols)
    u = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    v = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    rng = np.random.default_rng(seed)
    w = assign_distinct_weights(rng, len(u))
    return from_edges(u, v, w, n, device=device)


def components_graph(n_components: int, comp_size: int, seed: int = 0, *,
                     device=None) -> Graph:
    """Disjoint union of random connected components (the *forest* case)."""
    rng = np.random.default_rng(seed)
    us, vs = [], []
    for k in range(n_components):
        base = k * comp_size
        # random spanning tree + extra edges
        perm = rng.permutation(comp_size)
        for i in range(1, comp_size):
            us.append(base + perm[i])
            vs.append(base + perm[rng.integers(0, i)])
        extra = comp_size // 2
        us.extend(base + rng.integers(0, comp_size, extra))
        vs.extend(base + rng.integers(0, comp_size, extra))
    u = np.array(us, np.int64)
    v = np.array(vs, np.int64)
    w = assign_distinct_weights(rng, len(u))
    return from_edges(u, v, w, n_components * comp_size, device=device)
