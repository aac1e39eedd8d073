"""The input generators: deterministic from the seed, canonical, and laid
out as the port's own ``from_edges`` lays out the same draws."""
import numpy as np
import torch

import _small  # noqa: F401  (puts the checkout on sys.path)
from msfbench import rng
from msfbench.gen import edges as E
from msfbench.gen import kronecker

KCFG = dict(_small.small_config(_small.CELLS[0]))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[:3], b[:3])) and a.n == b.n


def test_same_seed_same_graph():
    a = kronecker.base_edges(KCFG, _small.SEED, 0, "cpu")
    b = kronecker.base_edges(KCFG, _small.SEED, 0, "cpu")
    c = kronecker.base_edges(KCFG, _small.SEED, 1, "cpu")
    d = kronecker.base_edges(KCFG, _small.SEED + 1, 0, "cpu")
    assert _same(a, b)
    assert not torch.equal(a.w, c.w) or not torch.equal(a.lo, c.lo)
    assert not torch.equal(a.w, d.w) or not torch.equal(a.lo, d.lo)


def test_canonical():
    e = kronecker.base_edges(KCFG, 5, 0, "cpu")
    assert e.lo.dtype == torch.int32 and e.w.dtype == torch.uint8
    assert bool((e.lo < e.hi).all()) and int(e.hi.max()) < e.n
    key = e.lo.long() * e.n + e.hi.long()
    assert bool((key[1:] > key[:-1]).all())  # sorted, no pair twice
    assert int(e.w.min()) >= 1 and int(e.w.max()) <= 255


def test_kronecker_skew():
    """R-MAT draws put most edges on few vertices: the top 1% of vertices
    by degree hold far more than 1% of the endpoints."""
    e = kronecker.base_edges(dict(KCFG, scale=12), 1, 0, "cpu")
    deg = torch.bincount(torch.cat([e.lo, e.hi]).long(), minlength=e.n).sort(descending=True)[0]
    assert int(deg[: e.n // 100].sum()) > 0.1 * int(deg.sum())


def test_layout_matches_the_ports_from_edges():
    from repro_torch.graphs.structures import from_edges

    gen = rng.generator("cpu", 11, "t")
    n = 300
    u = torch.randint(0, n, (2000,), generator=gen)
    v = torch.randint(0, n, (2000,), generator=gen)
    w = E.weights(gen, 2000, "cpu")
    e = E.canonical(u, v, w, n)
    g = from_edges(u.numpy(), v.numpy(), w.numpy(), n, device="cpu")
    m = g.num_directed_edges // 2
    assert e.m == m
    assert np.array_equal(g.src[:m].numpy(), e.lo.numpy())
    assert np.array_equal(g.dst[:m].numpy(), e.hi.numpy())
    assert np.array_equal(g.w[:m].numpy(), e.w.float().numpy())


def test_seed_streams_are_distinct():
    assert rng.stream_seed(1, "a") != rng.stream_seed(1, "b")
    assert rng.stream_seed(2**40, "a") == rng.stream_seed(2**40, "a")
    assert 0 <= rng.stream_seed(-5, "a") < 2**63
