"""The port's graph layer against ``repro.graphs``: the same seed gives
identical edge arrays, and conversions keep every array."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_util import cpu_graph, to_np  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.graphs import structures as jst  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402
from repro_torch.graphs import structures as tst  # noqa: E402
from test_msf_properties import _FIXED_CASES, _fixed_graph  # noqa: E402

FIELDS = ("src", "dst", "w", "eid", "valid")
DTYPES = dict(src=torch.int32, dst=torch.int32, w=torch.float32, eid=torch.int32,
              valid=torch.bool)


def _assert_same_graph(tg, jg):
    assert tg.n == jg.n
    for f in FIELDS:
        t = getattr(tg, f)
        assert t.dtype == DTYPES[f], f
        np.testing.assert_array_equal(to_np(t), np.asarray(getattr(jg, f)), err_msg=f)


@pytest.mark.parametrize("name,args", [
    ("random_graph", (50, 200, 3)),
    ("rmat_graph", (8, 4, 1)),
    ("grid_road_graph", (7, 9, 2)),
    ("components_graph", (4, 12, 5)),
])
def test_generators_match_reference(name, args):
    tg = getattr(tgen, name)(*args, device="cpu")
    _assert_same_graph(tg, getattr(jgen, name)(*args))


@pytest.mark.parametrize("case", _FIXED_CASES, ids=[c[0] for c in _FIXED_CASES])
def test_property_classes_rebuild_identically(case):
    """Each property-suite class through the port's own constructors:
    ``from_edges``, and ``graph_from_canonical`` for the multigraphs."""
    name, n, m, wlevels, multi, seed = case
    jg = _fixed_graph(*case)
    rng = np.random.default_rng(seed)
    if name == "two_cliques":
        half = n // 2
        u, v = rng.integers(0, half, m), rng.integers(0, half, m)
        flip = rng.random(m) < 0.5
        u, v = np.where(flip, u + half, u), np.where(flip, v + half, v)
    elif name == "sparse_isolated":
        u, v = rng.integers(0, n // 4, m), rng.integers(0, n // 4, m)
    else:
        u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    w = rng.integers(1, wlevels + 1, m).astype(np.float64)
    if multi:
        keep = u != v
        lo, hi = np.minimum(u, v)[keep], np.maximum(u, v)[keep]
        tg = tst.graph_from_canonical(lo, hi, w[keep], np.arange(len(lo)),
                                      np.ones(len(lo), bool), n, device="cpu")
    else:
        tg = tst.from_edges(u, v, w, n, device="cpu")
    _assert_same_graph(tg, jg)


def test_conversions_and_host_helpers_match():
    jg = jgen.random_graph(30, 80, seed=7)
    tg = cpu_graph(jg)
    _assert_same_graph(tg, jg)
    _assert_same_graph(tg.pad_to(200), jg.pad_to(200))
    with pytest.raises(ValueError):
        tg.pad_to(10)
    for a, b in zip(tst.to_csr(tg), jst.to_csr(jg)):
        np.testing.assert_array_equal(a, b)
    assert tst.nx_free_msf_weight(tg) == jst.nx_free_msf_weight(jg)
    assert tst.nx_free_n_components(tg) == jst.nx_free_n_components(jg)
    lo, hi, keep = tst.canonical_edges(tg.src, tg.dst)
    jlo, jhi, jkeep = jst.canonical_edges(np.asarray(jg.src), np.asarray(jg.dst))
    for a, b in zip((lo, hi, keep), (jlo, jhi, jkeep)):
        np.testing.assert_array_equal(to_np(a), b)
    u, v = np.array([3, 1, 3, 2]), np.array([1, 3, 1, 0])
    w = np.array([5.0, 4.0, 4.0, 1.0])
    for a, b in zip(tst.dedupe_canonical(np.minimum(u, v), np.maximum(u, v), w, 4),
                    jst.dedupe_canonical(np.minimum(u, v), np.maximum(u, v), w, 4)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tst.edge_keys(u, v, 4), jst.edge_keys(u, v, 4))
    # from_arrays takes tensors as well as numpy arrays
    _assert_same_graph(tst.from_arrays(tg.src, tg.dst, tg.w, tg.eid, tg.valid, tg.n,
                                       device="cpu"), jg)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.random_graph(10, 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.from_reference(jgen.random_graph(10, 20))
    assert tst.resolve_device("cpu") == torch.device("cpu")
