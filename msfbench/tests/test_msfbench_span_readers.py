"""The readers of the AS round's phase spans, the host-wait tally and the
report span, on hand-made readings; each reads ``None`` where the program
records none of its spans (a program without them)."""
import pytest

import _small  # noqa: F401
from msfbench import harness, peaks
from msfbench.harness import Reading

MS = 1_000_000  # ns


def _read(metric, spans):
    return harness.metric_reader(metric)(Reading([], spans, None, peaks.H100_SXM))


def _flat_solves():
    """Two flat solves: rounds with their phases, the report, the solve span."""
    spans = []
    for s, (syncs, report_ms) in enumerate(((50, 100), (54, 140))):
        t = 10_000 * MS * s
        for k, (mo, hk, sc, out) in enumerate(((300, 20, 10, 900), (700, 30, 20, 100))):
            spans += [("msf.min_outgoing", t + 100 * MS * k, mo * MS, 1, None),
                      ("msf.counts", t, 2 * MS, 1, {"edges": 1000, "outgoing": out}),
                      ("msf.hook", t, hk * MS, 1, None),
                      ("msf.shortcut", t, sc * MS, 1, None),
                      ("msf.round", t, (mo + hk + sc + 1) * MS, 1, {"round": k})]
        spans += [("solve.report", t, report_ms * MS, 1, None),
                  ("solve.flat", t, 2000 * MS, 1,
                   {"host_syncs": syncs, "host_syncs_by_site": {"msf.done": syncs}})]
    return spans


def test_phase_readers_sum_per_solve():
    spans = _flat_solves()
    assert _read("min_outgoing_ms.solve", spans) == pytest.approx((300 + 700) * 2 / 2)
    assert _read("hook_ms.solve", spans) == pytest.approx(50.0)
    assert _read("shortcut_ms.solve", spans) == pytest.approx(30.0)


def test_outgoing_share_pools_the_rounds():
    assert _read("outgoing_share.solve", _flat_solves()) == pytest.approx(
        100.0 * (900 + 100) * 2 / (1000 * 4))


def test_host_syncs_and_report_means():
    spans = _flat_solves()
    assert _read("host_syncs.solve", spans) == pytest.approx(52.0)
    assert _read("report_ms.solve", spans) == pytest.approx(120.0)
    coarsen = [("solve.report", 0, 60 * MS, 1, None),
               ("solve.coarsen", 0, 600 * MS, 1, {"host_syncs": 40}),
               ("solve.report", 0, 70 * MS, 1, None),
               ("solve.coarsen", 0, 600 * MS, 1, {"host_syncs": 44})]
    assert _read("host_syncs.coarsen", coarsen) == pytest.approx(42.0)
    assert _read("report_ms.coarsen", coarsen) == pytest.approx(65.0)


NEW = ["min_outgoing_ms.solve", "hook_ms.solve", "shortcut_ms.solve", "outgoing_share.solve",
       "host_syncs.solve", "report_ms.solve", "host_syncs.coarsen", "report_ms.coarsen"]


@pytest.mark.parametrize("metric", NEW)
def test_nothing_to_read_without_the_spans(metric):
    """No spans at all, and the spans a program without these instruments
    records (rounds and solves, no phases, no attributes): ``None``."""
    assert _read(metric, []) is None
    older = [("msf.round", 0, 5 * MS, 1, {"round": 0}), ("msf.flat", 0, 6 * MS, 1, None),
             ("solve.flat", 0, 7 * MS, 1, None), ("coarsen.levels", 0, 3 * MS, 1, None),
             ("solve.coarsen", 0, 9 * MS, 1, None)]
    assert _read(metric, older) is None
