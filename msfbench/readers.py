"""Arithmetic the per-layer metrics' readers share."""
from __future__ import annotations


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def span_durations_ms(spans, name: str) -> list:
    """Durations (ms) of the program's spans called ``name``."""
    return [ev[2] * 1e-6 for ev in spans if ev[0] == name]


def idle_share(profile):
    """Percent of the traced sub-window in which nothing ran on the device."""
    if profile is None or profile.window_s <= 0 or profile.n_device_events == 0:
        return None
    return 100.0 * (1.0 - profile.busy_s / profile.window_s)
