"""How ``solve.report.report_from_msf_result`` brings a result to the host.

On the CPU, for the flat and the coarsen engine on small graphs: the
arrays are C-contiguous int32 numpy arrays, ``msf_eids`` is the result's
``msf_eids[:n_msf_edges]``, the scalars are the result's, every field is
what a field-by-field read of the result gives (``.cpu().numpy()`` of
each array: ``chip_smoke.pageable_report``), and in trace mode the
tally's report sites count the card route's two waits while the
``solve.report`` span says the page-locked route did not run. On a card
(marker ``gpu``; skipped without one): the page-locked report equals
that pageable read, a report kept across later solves of other graphs
keeps its values in buffers of its own, the span carries ``pinned`` 1
and the bytes copied, and the report waits twice.
"""
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from chip_smoke import pageable_report, report_bytes, same_report  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import solve  # noqa: E402
from repro_torch.coarsen import CoarsenConfig  # noqa: E402
from repro_torch.graphs import grid_road_graph, random_graph, rmat_graph  # noqa: E402
from repro_torch.solve.report import SolveReport, report_from_msf_result  # noqa: E402

ENGINES = {
    "flat": dict(),
    "flat-unpacked": dict(pack=False),
    "coarsen": dict(mode="coarsen", coarsen=CoarsenConfig(cutoff=32)),
}
GRAPHS = {
    "random": lambda dev: random_graph(300, 1200, seed=5, device=dev),
    "rmat": lambda dev: rmat_graph(9, 4, seed=3, device=dev),
    "grid": lambda dev: grid_road_graph(24, 20, seed=1, device=dev),
}


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.disable()
    obs.reset()
    solve.clear_plan_cache()
    yield
    obs.disable()
    obs.reset()
    obs.metrics_reset()
    solve.clear_plan_cache()


def _solve(g, engine, **kw):
    return solve.plan(g, solve.SolveSpec(**ENGINES[engine], **kw)).solve()


def _assert_same(got: SolveReport, want: SolveReport) -> None:
    for field in SolveReport._fields:
        x, y = getattr(got, field), getattr(want, field)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), field
        else:
            assert type(x) is type(y) and x == y or field == "raw", field


def _report_span(events) -> dict:
    (ev,) = [e for e in events if e[0] == "solve.report"]
    return ev[4]


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_report_arrays_are_contiguous_int32(engine, graph):
    rep = _solve(GRAPHS[graph]("cpu"), engine)
    for a in (rep.msf_eids, rep.parent):
        assert isinstance(a, np.ndarray) and a.dtype == np.int32
        assert a.flags["C_CONTIGUOUS"] and a.ndim == 1
    assert rep.parent.shape == (rep.raw.parent.numel(),)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_report_eids_are_the_results_prefix(engine, graph):
    rep = _solve(GRAPHS[graph]("cpu"), engine)
    n_f = int(rep.raw.n_msf_edges)
    assert rep.n_msf_edges == n_f == rep.msf_eids.shape[0] > 0
    assert np.array_equal(rep.msf_eids, rep.raw.msf_eids[:n_f].numpy())
    assert np.array_equal(rep.parent, rep.raw.parent.numpy())


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_report_equals_a_read_of_each_field(engine, graph):
    """Weight, rounds, eids and parent: what reading each field of the
    result gives, in type, dtype and value."""
    rep = _solve(GRAPHS[graph]("cpu"), engine)
    _assert_same(rep, pageable_report(rep))
    assert isinstance(rep.weight, float) and isinstance(rep.iterations, int)
    assert rep.weight == float(rep.raw.weight) and rep.iterations == int(rep.raw.iterations)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_report_tally_and_span_of_a_cpu_result(engine):
    """Trace mode: the report's sites count the card route's waits (the
    scalars, then both arrays), and a CPU result takes the route that
    reads in place: ``pinned`` 0, no bytes copied."""
    rep = _solve(GRAPHS["rmat"]("cpu"), engine, obs="trace")
    events = obs.trace_events()
    (solve_attrs,) = [e[4] for e in events if e[0] == f"solve.{rep.mode}"]
    by_site = solve_attrs["host_syncs_by_site"]
    assert by_site["report.scalars"] == by_site["report.arrays"] == 1
    assert _report_span(events) == {"pinned": 0, "d2h_bytes": 0}


def test_report_of_a_result_built_by_hand():
    """A dist-shaped record (the engines' common input) on the CPU: the
    eids trimmed to ``n_msf_edges``, the padding never reported."""
    from repro_torch.core.msf import MSFResult
    from repro_torch.core.semiring import IMAX

    eids = torch.full((8,), IMAX, dtype=torch.int32)
    eids[:3] = torch.tensor([5, 1, 7], dtype=torch.int32)
    r = MSFResult(weight=torch.tensor(2.5), parent=torch.arange(8, dtype=torch.int32),
                  msf_eids=eids, n_msf_edges=torch.tensor(3, dtype=torch.int32),
                  iterations=torch.tensor(2, dtype=torch.int32))
    rep = report_from_msf_result("dist", r)
    assert rep.msf_eids.tolist() == [5, 1, 7] and rep.msf_eids.dtype == np.int32
    assert rep.n_msf_edges == 3 and rep.iterations == 2 and rep.weight == 2.5
    empty = report_from_msf_result("dist", r._replace(n_msf_edges=torch.tensor(0)))
    assert empty.msf_eids.shape == (0,) and empty.msf_eids.dtype == np.int32


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (page-locked host memory needs CUDA)")
    return torch.device("cuda")


def _syncs(fn) -> int:
    """The host waits torch's sync debug mode reports during ``fn()``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.gpu
@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_pinned_report_equals_the_pageable_read(card, engine, graph):
    rep = _solve(GRAPHS[graph](card), engine)
    assert rep.raw.parent.is_cuda
    assert same_report(rep, pageable_report(rep))
    _assert_same(rep, pageable_report(rep))
    for a in (rep.msf_eids, rep.parent):
        assert a.flags["C_CONTIGUOUS"] and torch.from_numpy(a).is_pinned()


@pytest.mark.gpu
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_kept_report_holds_its_values_across_later_solves(card, engine):
    """Three graphs of one size: the first report is kept while the second
    is solved and dropped (its blocks go back to the cache) and the third
    is solved; the first still holds its own values, in memory of its own."""
    graphs = [rmat_graph(10, 8, seed=s, device=card) for s in (1, 2, 3)]
    kept = _solve(graphs[0], engine)
    want = pageable_report(kept)
    second = _solve(graphs[1], engine)
    assert not np.array_equal(second.parent, kept.parent)
    del second
    third = _solve(graphs[2], engine)
    _assert_same(kept, want)
    for a in (kept.msf_eids, kept.parent):
        for b in (third.msf_eids, third.parent):
            assert not np.shares_memory(a, b)
    _assert_same(third, pageable_report(third))


@pytest.mark.gpu
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_report_span_of_a_card_result(card, engine):
    g = GRAPHS["rmat"](card)
    rep = _solve(g, engine, obs="trace")
    attrs = _report_span(obs.trace_events())
    assert attrs == {"pinned": 1, "d2h_bytes": report_bytes(g.n, rep.n_msf_edges)}


@pytest.mark.gpu
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_card_report_waits_twice(card, engine):
    rep = _solve(GRAPHS["grid"](card), engine)
    assert _syncs(lambda: report_from_msf_result(rep.mode, rep.raw, levels=rep.levels)) == 2
    edgeless = rep.raw._replace(n_msf_edges=torch.zeros((), dtype=torch.int32, device=card))
    empty = report_from_msf_result(rep.mode, edgeless)
    assert empty.msf_eids.shape == (0,) and empty.msf_eids.dtype == np.int32
