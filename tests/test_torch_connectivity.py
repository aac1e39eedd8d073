"""The port's connectivity, SSSP, tropical SpMV and generic multilinear
against ``repro.core``: the same numpy inputs, exact equality (the float
sum of ``multilinear_coo`` to rtol 1e-6: its summation order differs).

Connectivity, and SSSP on graphs with a hub, scatter only the edges that
can change the result, where the reference scatters every edge; these
tests hold both forms to the reference's results.
"""
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_util import cpu_graph, to_np  # noqa: E402
from repro.core import connected_components as jax_cc  # noqa: E402
from repro.core import multilinear_coo as jax_multilinear_coo  # noqa: E402
from repro.core.semiring import tropical_spmv as jax_tropical_spmv  # noqa: E402
from repro.core.sssp import sssp as jax_sssp  # noqa: E402
from repro.graphs import grid_road_graph, random_graph, rmat_graph  # noqa: E402
from repro.graphs.generators import components_graph  # noqa: E402
from repro.graphs.structures import from_edges  # noqa: E402
from repro_torch.core import CCResult, connected_components, multilinear_coo  # noqa: E402
from repro_torch.core import sssp as sssp_mod  # noqa: E402
from repro_torch.core.semiring import tropical_spmv  # noqa: E402
from repro_torch.core.sssp import sssp  # noqa: E402
from repro_torch.graphs.structures import nx_free_n_components  # noqa: E402
from repro_torch.solve import SolveSpec, plan  # noqa: E402

jax_connectivity = importlib.import_module("repro.core.connectivity")


def _random_small(n, m, seed):
    """The draw of tests/test_connectivity.py::test_cc_property."""
    rng = np.random.default_rng(seed)
    return from_edges(rng.integers(0, n, m), rng.integers(0, n, m),
                      rng.integers(1, 256, m).astype(np.float64), n)


# The graph classes of tests/test_connectivity.py, plus fixed draws of its
# property test (isolated vertices, no edges, a single vertex).
GRAPHS = {
    "random": lambda: random_graph(200, 600, seed=1),
    "grid": lambda: grid_road_graph(12, 17, seed=2),
    "rmat": lambda: rmat_graph(8, 4, seed=3),
    "sparse": lambda: random_graph(300, 150, seed=4),
    "components": lambda: components_graph(5, 40, seed=5),
    "long_grid": lambda: grid_road_graph(2, 150, seed=6),
    "small_isolated": lambda: _random_small(50, 20, 7),
    "no_edges": lambda: _random_small(9, 0, 8),
    "one_vertex": lambda: _random_small(1, 3, 9),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_connected_components_matches_reference(name):
    g = GRAPHS[name]()
    want = jax_cc(g)
    got = connected_components(cpu_graph(g))
    assert isinstance(got, CCResult)
    assert got.parent.dtype == torch.int32
    np.testing.assert_array_equal(to_np(got.parent), np.asarray(want.parent))
    assert int(got.n_components) == int(want.n_components) == nx_free_n_components(cpu_graph(g))
    assert int(got.iterations) == int(want.iterations)


@pytest.mark.parametrize("max_iters", [1, 2])
def test_connected_components_round_limit_matches(max_iters):
    g = grid_road_graph(6, 40, seed=3)
    want = jax_connectivity.connected_components(g, max_iters=max_iters)
    got = connected_components(cpu_graph(g), max_iters=max_iters)
    np.testing.assert_array_equal(to_np(got.parent), np.asarray(want.parent))
    assert int(got.iterations) == int(want.iterations) == max_iters


def test_connected_components_partition_matches_msf():
    g = rmat_graph(8, 4, seed=11)
    cc = to_np(connected_components(cpu_graph(g)).parent)
    r = plan(cpu_graph(g), SolveSpec()).solve().parent
    fwd, bwd = {}, {}
    for x, y in zip(cc, r):
        assert fwd.setdefault(x, y) == y
        assert bwd.setdefault(y, x) == x


def _dijkstra(g, source):
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    src, dst, w, v = (np.asarray(x) for x in (g.src, g.dst, g.w, g.valid))
    a = sp.coo_matrix((w[v], (src[v], dst[v])), shape=(g.n, g.n)).tocsr()
    return csg.dijkstra(a, directed=True, indices=source)


SSSP_GRAPHS = {
    "random": (lambda: random_graph(150, 500, seed=1), 0),
    "grid": (lambda: grid_road_graph(10, 12, seed=2), 0),
    "grid_far_source": (lambda: grid_road_graph(10, 12, seed=2), 119),
    "components_unreachable": (lambda: components_graph(4, 30, seed=5), 31),
    "rmat": (lambda: rmat_graph(9, 4, seed=3), 1),
    "small_isolated": (lambda: _random_small(40, 30, 12), 0),
}


@pytest.fixture(params=["default", "improving", "all"])
def relax_form(request, monkeypatch):
    """sssp's relaxation: chosen by the largest in-degree, or forced to
    scatter only the improving candidates, or every candidate."""
    limit = {"default": sssp_mod.HUB_IN_DEGREE, "improving": -1, "all": 1 << 40}
    monkeypatch.setattr(sssp_mod, "HUB_IN_DEGREE", limit[request.param])
    return request.param


@pytest.mark.parametrize("name", list(SSSP_GRAPHS))
def test_sssp_matches_reference_and_scipy(name, relax_form):
    make, source = SSSP_GRAPHS[name]
    g = make()
    want_d, want_it = jax_sssp(g, source)
    d, it = sssp(cpu_graph(g), source)
    assert d.dtype == torch.float32
    np.testing.assert_array_equal(to_np(d), np.asarray(want_d))
    assert it == int(want_it)
    # integer weights: float32 distances are exact, and so is Dijkstra's
    np.testing.assert_array_equal(to_np(d).astype(np.float64), _dijkstra(g, source))


def test_sssp_round_limit_matches(relax_form):
    g = grid_road_graph(10, 12, seed=2)
    want_d, want_it = jax_sssp(g, 0, max_iters=3)
    d, it = sssp(cpu_graph(g), 0, max_iters=3)
    np.testing.assert_array_equal(to_np(d), np.asarray(want_d))
    assert it == int(want_it) == 3


def test_sssp_scatters_only_improving_edges_past_a_hub(monkeypatch):
    calls = []
    for name in ("_relax_improving", "_relax_all"):
        fn = getattr(sssp_mod, name)
        monkeypatch.setattr(sssp_mod, name,
                            lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    leaves = sssp_mod.HUB_IN_DEGREE + 1  # a star: the centre's in-degree passes the limit
    star = from_edges(np.zeros(leaves), np.arange(1, leaves + 1), np.ones(leaves), leaves + 1)
    d, it = sssp(cpu_graph(star), 3)
    want_d, want_it = jax_sssp(star, 3)
    np.testing.assert_array_equal(to_np(d), np.asarray(want_d))
    assert it == int(want_it) and set(calls) == {"_relax_improving"}
    calls.clear()
    sssp(cpu_graph(grid_road_graph(10, 12, seed=2)), 0)
    assert set(calls) == {"_relax_all"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tropical_spmv_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n, e = 60, 400
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = rng.integers(1, 50, e).astype(np.float32)
    w[rng.random(e) < 0.1] = np.inf  # invalid edges
    d = rng.integers(0, 200, n).astype(np.float32)
    d[rng.random(n) < 0.3] = np.inf  # unreached vertices
    want = np.array(jax_tropical_spmv(jnp.array(d), jnp.array(src), jnp.array(dst),
                                      jnp.array(w), n))
    args = [torch.from_numpy(x) for x in (d, src, dst, w)]
    np.testing.assert_array_equal(to_np(tropical_spmv(*args, n)), want)
    for relax in (sssp_mod._relax_improving, sssp_mod._relax_all):
        got, changed = relax(*args, n)
        np.testing.assert_array_equal(to_np(got), want)
        assert changed == (not np.array_equal(want, d))
        _, changed = relax(torch.from_numpy(want), *args[1:], n)
        assert changed == (not np.array_equal(
            np.asarray(jax_tropical_spmv(jnp.array(want), *(jnp.array(x) for x in (src, dst, w)),
                                         n)), want))


def _edge_fns():
    return {
        "scaled": lambda xi, a, yj: xi * a + yj,
        "gated": lambda xi, a, yj: (xi - yj) * a[:, None],
        "no_weights": lambda xi, a, yj: xi + 2 * yj,
    }


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("form", ["scaled", "gated", "no_weights", "int"])
def test_multilinear_coo_matches_reference(reduce, form):
    rng = np.random.default_rng(len(form) + len(reduce))
    n, e, d = 40, 300, 5
    src = rng.integers(0, n - 3, e).astype(np.int32)  # the last vertices stay empty
    dst = rng.integers(0, n, e).astype(np.int32)
    a = rng.standard_normal(e).astype(np.float32)
    if form == "int":
        x = rng.integers(-50, 50, n).astype(np.int32)
        y = rng.integers(-50, 50, n).astype(np.int32)
        a = None
        f = _edge_fns()["no_weights"]
    elif form == "gated":
        x = rng.standard_normal((n, d)).astype(np.float32)
        y = rng.standard_normal((n, d)).astype(np.float32)
        f = _edge_fns()[form]
    else:
        x = rng.standard_normal(n).astype(np.float32)
        y = rng.standard_normal(n).astype(np.float32)
        a = None if form == "no_weights" else a
        f = _edge_fns()[form]
    jx = lambda v: None if v is None else jnp.array(v)  # noqa: E731
    tx = lambda v: None if v is None else torch.from_numpy(v)  # noqa: E731
    want = np.asarray(jax_multilinear_coo(jx(x), jx(y), jx(src), jx(dst), jx(a), f,
                                          num_segments=n, reduce=reduce))
    got = to_np(multilinear_coo(tx(x), tx(y), tx(src), tx(dst), tx(a), f,
                                num_segments=n, reduce=reduce))
    assert got.dtype == want.dtype and got.shape == want.shape
    if reduce == "sum" and form != "int":
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_multilinear_coo_rejects_unknown_reduce():
    x = torch.zeros(3)
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="reduce"):
        multilinear_coo(x, x, idx, idx, None, lambda xi, a, yj: xi, num_segments=3,
                        reduce="prod")
