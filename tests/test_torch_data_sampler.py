"""Parity of the port's numpy data pipelines and neighbor sampler
(``repro_torch.data.pipeline``, ``repro_torch.graphs.sampler``) with the
reference's. Tolerance: none, every array must be bit-identical."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as ref_pipe  # noqa: E402
from repro.graphs import random_graph, to_csr  # noqa: E402
from repro.graphs import sampler as ref_sampler  # noqa: E402
from repro_torch.data import pipeline as pipe  # noqa: E402
from repro_torch.graphs import sampler  # noqa: E402

SEEDS = [0, 3, 11]


def _same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _sources(mod, seed):
    offs, sizes = np.array([0, 10, 30, 80]), np.array([10, 20, 50, 7])
    return {
        "lm": mod.LMBatchSource(vocab=100, seq_len=16, batch=4, seed=seed),
        "recsys": mod.RecsysBatchSource(offs, sizes, batch=32, seed=seed),
        "molecule": mod.MoleculeBatchSource(n_atoms=12, n_edges=40, batch=6, seed=seed),
    }


@pytest.mark.parametrize("kind", ["lm", "recsys", "molecule"])
@pytest.mark.parametrize("seed", SEEDS)
def test_batch_at_is_bit_identical(kind, seed):
    got, want = _sources(pipe, seed)[kind], _sources(ref_pipe, seed)[kind]
    for step in (0, 1, 17, 10_000):
        _same(got.batch_at(step), want.batch_at(step))


@pytest.mark.parametrize("seed", SEEDS)
def test_planted_graph_task_is_bit_identical(seed):
    _same(pipe.make_planted_graph_task(200, 800, 16, 3, seed),
          ref_pipe.make_planted_graph_task(200, 800, 16, 3, seed))


@pytest.mark.parametrize("batch,fanouts", [(1024, (15, 10)), (32, (5, 3)), (7, ()), (3, (4, 2, 2))])
def test_max_sample_sizes(batch, fanouts):
    assert sampler.max_sample_sizes(batch, fanouts) == ref_sampler.max_sample_sizes(batch, fanouts)


@pytest.mark.parametrize("seed", SEEDS)
def test_neighbor_sampler_draws_the_same_subgraph(seed):
    g = random_graph(500, 3000, seed=seed)
    indptr, indices, _, _ = to_csr(g)
    indptr, indices = np.asarray(indptr), np.asarray(indices)
    got_s = sampler.NeighborSampler(indptr, indices, seed=seed)
    want_s = ref_sampler.NeighborSampler(indptr, indices, seed=seed)
    for draw in range(2):  # the sampler's rng advances between draws
        seeds = np.arange(32) * 7 % 500 + draw
        got = got_s.sample(seeds, fanouts=(5, 3))
        want = want_s.sample(seeds, fanouts=(5, 3))
        assert type(got).__module__ == "repro_torch.graphs.sampler"
        gd, wd = dataclasses.asdict(got), dataclasses.asdict(want)
        assert gd.pop("n_seeds") == wd.pop("n_seeds")
        _same(gd, wd)
