"""Arithmetic of the readers that take the program's spans per solve: the
AS round's phase spans, and the attributes the trace-mode spans carry."""
from __future__ import annotations

from msfbench.readers import span_durations_ms


def per_solve_ms(spans, name: str, solve: str):
    """Total length (ms) of the spans called ``name`` over the count of
    ``solve`` spans (``solve.flat``, ``solve.coarsen``); ``None`` when
    either is absent."""
    durations = span_durations_ms(spans, name)
    solves = sum(ev[0] == solve for ev in spans)
    return sum(durations) / solves if durations and solves else None


def attr_values(spans, name: str, key: str) -> list:
    """The values of attribute ``key`` of the spans called ``name`` that
    carry it."""
    return [ev[4][key] for ev in spans if ev[0] == name and ev[4] and key in ev[4]]
