"""``solve.cost.dist_round_terms``: one Fig-2 round of the dist driver on
one rank, counted from shapes, against the collective bytes that
``Mesh.count_collectives`` records over one real round of the port's
driver on four gloo ranks (2×2) on the CPU; and ``plan_cost("dist")``
stays ``None``, as the reference's does.

One round is isolated as the difference between a driver capped at two
rounds and one capped at one: both end with the same all-gather of the
parent vector, so the difference is the second round alone."""
import numpy as np
import pytest

from _torch_util import join_ranks, start_ranks
from repro_torch.graphs import partition_edges_2d, random_graph
from repro_torch.solve import cost

_RANKS = r"""
from collections import Counter
from repro_torch import solve
from repro_torch.core.msf_dist import build_dist_driver
from repro_torch.launch.mesh import make_mesh

mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
part = INPUTS["part"]
arrays = (part.src_row, part.dst_col, part.w, part.eid, part.valid)
for pack in (True, False):
    runs = []
    for rounds in (1, 2):
        driver = build_dist_driver(part, mesh, pack=pack, max_iters=rounds, capacity=1 << 16)
        with mesh.count_collectives() as counted:
            res = driver(*arrays)
        runs.append((Counter(counted), int(res.iterations)))
    OUT[pack] = (dict(runs[1][0] - runs[0][0]), runs[0][1], runs[1][1])
OUT["cost"] = solve.plan(part, solve.SolveSpec(mode="dist"), mesh=mesh).cost
"""


@pytest.fixture(scope="module")
def part():
    return partition_edges_2d(random_graph(500, 1500, seed=1, device="cpu"), 2, 2)


@pytest.fixture(scope="module")
def ranks(part, tmp_path_factory):
    handle = start_ranks(_RANKS, 4, {"part": part}, tmp_path_factory.mktemp("cost_dist"))
    return join_ranks(handle, timeout=180)


@pytest.mark.parametrize("pack", [True, False])
def test_round_collective_bytes_equal_a_gloo_round(ranks, part, pack):
    want = cost.dist_round_terms(rows=2, cols=2, e_max=int(part.src_row.shape[2]),
                                 shard_size=part.shard_size, pack=pack).collective
    for r in ranks:
        got, one, two = r[pack]
        assert (one, two) == (1, 2), "the graph must take a second round"
        assert got == want


def test_plan_cost_dist_is_none(ranks):
    assert all(r["cost"] is None for r in ranks)


def test_round_terms_by_hand():
    """A 2×4 grid, shard 100, 1,000 edge slots, pack32: the gathers are
    the row block (4 shards) over model and the column block (2 shards)
    over data; the packed key (int64) and the payload (int32) are
    all-reduced over each axis."""
    n = 2 * 4 * 100
    rnd = cost.dist_round_terms(rows=2, cols=4, e_max=1000, shard_size=100, pack=True)
    assert rnd.collective == {("model",): 4 * 100 * 4 + n * 8 + n * 4,
                              ("data",): 2 * 100 * 4 + n * 8 + n * 4}
    assert set(rnd.terms) >= {"gathers", "key_build", "segment_min", "combine", "payload",
                              "hook", "record", "shortcut"}
    assert all(b > 0 for b, _ in rnd.terms.values()) and rnd.temp_bytes > 0
    base = cost.dist_round_terms(rows=2, cols=4, e_max=1000, shard_size=100, pack=False,
                                 shortcut="baseline", row_axes=("pod", "data"))
    # three masked all-reduce passes (w, eid, payload) per axis, and per
    # charged pointer-jump step a grid all-gather and a one-int flag
    assert base.collective[("model",)] == 4 * 100 * 4 + 3 * n * 4
    assert base.collective[("pod", "data", "model")] == cost.SHORTCUT_STEPS * (n * 4 + 4)


def test_one_rank_grid_moves_nothing():
    rnd = cost.dist_round_terms(rows=1, cols=1, e_max=64, shard_size=32, pack=True)
    assert rnd.collective == {}
    with pytest.raises(ValueError):
        cost.dist_round_terms(rows=1, cols=1, e_max=1, shard_size=1, pack=True, shortcut="x")


def test_dist_round_grows_with_the_edge_block():
    small, big = (sum(b for b, _ in cost.dist_round_terms(
        rows=2, cols=2, e_max=e, shard_size=64, pack=True).terms.values()) for e in (100, 200))
    assert big > small
    assert np.isfinite(big)
