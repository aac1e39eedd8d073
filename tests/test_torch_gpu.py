"""Tests of the port that need the card (marker ``gpu``): the CUDA kernels
against their plain versions, and the flat and coarsen paths on the card
against the CPU. Elsewhere they skip. Run them on an H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,e,lo,hi", [(1, 1000, 0, 1), (1000, 0, 0, 1000),
                                       (4097, 100_000, 0, 4097), (300, 50_000, -3, 310)])
def test_segment_min_flat_kernel_matches_plain(card, n, e, lo, hi):
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=card).manual_seed(n + e)
    keys = torch.randint(0, ref.PACK_IDENTITY + 1, (e,), generator=gen, device=card,
                         dtype=torch.int64)
    segs = torch.randint(lo, hi, (e,), generator=gen, device=card, dtype=torch.int32)
    before = ops.segment_min_flat.launches
    got = ops.segment_min_flat(keys, segs, n)
    torch.cuda.synchronize()
    assert ops.segment_min_flat.launches == before + 1
    assert torch.equal(got, ref.segment_min_flat_ref(keys, segs, n))


def test_main_path_on_card_matches_cpu(card):
    from repro_torch.graphs import rmat_graph
    from repro_torch.kernels import ops
    from repro_torch.solve import SolveSpec, plan

    g_card = rmat_graph(12, 8, seed=3, device=card)
    g_cpu = rmat_graph(12, 8, seed=3, device="cpu")
    p = plan(g_card, SolveSpec())
    assert p.resolved.segmin_flat is ops.segment_min_flat
    ops.segment_min_flat.launches = 0
    a = p.solve()
    assert ops.segment_min_flat.launches == a.iterations > 0
    b = plan(g_cpu, SolveSpec()).solve()
    np.testing.assert_array_equal(a.msf_eids, b.msf_eids)
    np.testing.assert_array_equal(a.parent, b.parent)
    assert (a.weight, a.iterations) == (b.weight, b.iterations)


@pytest.mark.parametrize("n,e,run", [(1, 5000, 5000), (4097, 0, 1), (1 << 16, 1 << 16, 1),
                                     (300_000, 1_000_000, 7), (1000, 100_000, 90_000)])
def test_segment_min_sorted_kernel_matches_plain(card, n, e, run):
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=card).manual_seed(n + e)
    keys = torch.randint(0, ref.PACK_IDENTITY + 1, (e,), generator=gen, device=card,
                         dtype=torch.int64)
    # sorted ids in runs of about `run` edges, with gaps (empty segments)
    steps = (torch.rand(e, generator=gen, device=card) < 1.0 / run).to(torch.int32)
    segs = (torch.cumsum(steps * 3, 0, dtype=torch.int32) % max(n, 1)).sort().values
    before = ops.segment_min_sorted.launches
    got = ops.segment_min_sorted(keys, segs.contiguous(), n)
    torch.cuda.synchronize()
    assert ops.segment_min_sorted.launches == before + 1
    assert torch.equal(got, ref.segment_min_sorted_ref(keys, segs, n))
    # unsorted ids: still the exact minimum
    perm = torch.randperm(e, generator=gen, device=card)
    assert torch.equal(ops.segment_min_sorted(keys[perm], segs[perm].contiguous(), n),
                       ref.segment_min_sorted_ref(keys, segs, n))


def test_coarsen_path_on_card_matches_cpu(card):
    from repro_torch.coarsen import CoarsenConfig
    from repro_torch.graphs import grid_road_graph
    from repro_torch.kernels import ops
    from repro_torch.solve import SolveSpec, plan

    spec = SolveSpec(mode="coarsen", coarsen=CoarsenConfig(cutoff=64))
    p = plan(grid_road_graph(64, 64, seed=3, device=card), spec)
    ops.segment_min_flat.launches = ops.segment_min_sorted.launches = 0
    a = p.solve()
    be = p.engine.last_backends
    assert (be.hook, be.dedupe_segmin, be.dedupe) == (
        ops.segment_min_flat, ops.segment_min_sorted, "device")
    assert ops.segment_min_sorted.launches == len(a.levels) >= 1
    assert ops.segment_min_flat.launches > 0
    b = plan(grid_road_graph(64, 64, seed=3, device="cpu"), spec).solve()
    np.testing.assert_array_equal(a.msf_eids, b.msf_eids)
    np.testing.assert_array_equal(a.parent, b.parent)
    assert (a.weight, a.iterations, a.levels) == (b.weight, b.iterations, b.levels)
