"""The plain reference against a brute-force Kruskal at tiny sizes,
forests, ties, self-loops and parallel edges included."""
import numpy as np
import pytest
import torch

import _small  # noqa: F401
from msfbench.reference import msf as R


def kruskal(lo, hi, w, n):
    """Brute force: edges in (w, position) order, one union-find."""
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    chosen = np.zeros(len(lo), bool)
    for i in sorted(range(len(lo)), key=lambda i: (w[i], i)):
        a, b = find(lo[i]), find(hi[i])
        if a != b:
            parent[max(a, b)] = min(a, b)
            chosen[i] = True
    labels = np.array([min(v for v in range(n) if find(v) == find(u)) for u in range(n)])
    return chosen, labels


@pytest.mark.parametrize("seed", range(12))
def test_matches_kruskal(seed):
    g = np.random.default_rng(seed)
    n = int(g.integers(2, 40))
    m = int(g.integers(0, 90))
    lo = g.integers(0, n, m)
    hi = g.integers(0, n, m)  # self-loops and parallel edges included
    w = g.integers(1, 4, m)  # few weights: many ties
    chosen, labels = kruskal(lo, hi, w, n)
    f = R.msf(torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(w), n)
    assert np.array_equal(f.in_forest.numpy(), chosen)
    assert np.array_equal(f.labels.numpy(), labels)
    assert f.weight == float(w[chosen].sum())
    assert f.n_components == len(set(labels.tolist()))


def test_forest_of_components():
    # three components and an isolated vertex
    lo = torch.tensor([0, 1, 3, 4, 6, 0])
    hi = torch.tensor([1, 2, 4, 5, 7, 2])
    w = torch.tensor([5, 5, 1, 1, 9, 5])
    f = R.msf(lo, hi, w, 9)
    assert f.in_forest.tolist() == [True, True, True, True, True, False]
    assert f.labels.tolist() == [0, 0, 0, 3, 3, 3, 6, 6, 8]
    assert f.n_components == 4 and f.weight == 21.0


def test_root_labels_judges_a_parent_vector():
    assert R.root_labels(torch.tensor([1, 1, 1, 4, 4]), 5).tolist() == [0, 0, 0, 3, 3]
    assert R.root_labels(torch.tensor([1, 0, 2]), 3) is None  # a cycle never settles
    assert R.root_labels(torch.tensor([0, 5]), 2) is None  # outside [0, n)
