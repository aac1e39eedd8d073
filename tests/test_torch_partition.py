"""The port's ``graphs.partition`` against ``repro.graphs.partition`` on
the same graphs: ``Partition2D`` array for array, ``block_global_ids``
on numpy arrays and on tensors, ``partition_edges_1d`` and ``pad_n``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_util import cpu_graph  # noqa: E402
from repro.graphs import grid_road_graph, random_graph  # noqa: E402
from repro.graphs import partition as jpart  # noqa: E402
from repro.graphs.generators import components_graph  # noqa: E402
from repro_torch.graphs import partition as tpart  # noqa: E402

GRIDS = [(1, 1), (1, 2), (2, 2), (2, 4), (3, 2)]
GRAPHS = {
    "random_150_500_s3": lambda: random_graph(150, 500, seed=3),
    "grid_14x15_s4": lambda: grid_road_graph(14, 15, seed=4),
    "components_5x14_s2": lambda: components_graph(5, 14, seed=2),
}


def _assert_same_partition(want, got):
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray) and b.dtype == a.dtype, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert b == a and type(b) is type(a), f.name
    assert got.e_max == want.e_max


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{r}x{c}" for r, c in GRIDS])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_partition_2d_matches_reference(graph, grid):
    g = GRAPHS[graph]()
    want = jpart.partition_edges_2d(g, *grid)
    got = tpart.partition_edges_2d(cpu_graph(g), *grid)
    _assert_same_partition(want, got)
    src_w, dst_w = jpart.block_global_ids(want.src_row, want.dst_col, want.shard_size)
    src_g, dst_g = tpart.block_global_ids(got.src_row, got.dst_col, got.shard_size)
    np.testing.assert_array_equal(src_g, src_w)
    np.testing.assert_array_equal(dst_g, dst_w)
    assert src_g.dtype == dst_g.dtype == np.int32
    # tensors in, tensors out: the same ids
    src_t, dst_t = tpart.block_global_ids(torch.from_numpy(got.src_row),
                                          torch.from_numpy(got.dst_col), got.shard_size)
    assert src_t.dtype == dst_t.dtype == torch.int32
    np.testing.assert_array_equal(src_t.numpy(), src_w)
    np.testing.assert_array_equal(dst_t.numpy(), dst_w)
    # the global ids give back the graph's valid edge multiset
    valid = np.asarray(g.valid)
    edges = sorted(zip(src_g[got.valid].tolist(), dst_g[got.valid].tolist()))
    assert edges == sorted(zip(np.asarray(g.src)[valid].tolist(),
                               np.asarray(g.dst)[valid].tolist()))


@pytest.mark.parametrize("parts", [1, 3, 8])
def test_partition_1d_matches_reference(parts):
    g = random_graph(60, 200, seed=5).pad_to(450)
    want = jpart.partition_edges_1d(g, parts)
    got = tpart.partition_edges_1d(cpu_graph(g), parts)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n,rows,cols", [(1, 1, 1), (10, 2, 2), (1000, 2, 4), (7, 3, 2)])
def test_pad_n_matches_reference(n, rows, cols):
    assert tpart.pad_n(n, rows, cols) == jpart.pad_n(n, rows, cols)
