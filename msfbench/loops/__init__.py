"""Traffic loops, found by the ``loop`` key of a traffic file.

Each module ``loops/<name>.py`` has ``run(ctx, system=None) -> Outcome``:
it builds the cell's inputs and the system under test, warms up, calls
``ctx.setup_done()``, drives the timed window, calls
``ctx.window_closed()``, frees the program's state and compares what the
window produced with the plain reference. ``system`` is the class of the
system under test; the port's by default (the control and the tests'
planted faults give their own).
"""
from __future__ import annotations

from typing import NamedTuple


class Outcome(NamedTuple):
    attempted: int
    failed: int
    end_to_end: dict  # metric name -> value, for every metric the loop can report
    requests: list  # one dict per request of the window (the per-layer readers' input)
    profile: object  # devtrace.Profile of the traced sub-window, or None
    spans: list  # the program's span events inside the window
    checks: dict  # name -> (value, limit), in print order
    correct: bool


def judge(readings: dict, limits: dict) -> tuple[dict, bool]:
    """Pair every reading with its limit; correct when none is over."""
    checks = {k: (v, limits[k]) for k, v in readings.items()}
    ok = all(v <= lim for v, lim in checks.values())
    return checks, ok
