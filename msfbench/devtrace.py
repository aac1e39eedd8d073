"""torch.profiler over a steady sub-window of a traced run, reduced to
what the per-layer metrics and the ``breakdown`` read.

The loop names each request with a ``record_function`` range while the
profiler is on (the first requests of the window, right after the
warm-up). From the device's timeline (every kernel, copy and set
on the card) the reduction keeps: the busy time (the union of the
device intervals) inside the sub-window and inside each request's
range, the device operations that took most time, and the idle gaps
labelled by what the host was doing (the innermost host operation of
the calling thread that spans the middle of the gap).
"""
from __future__ import annotations

import bisect
import contextlib
from typing import NamedTuple

import torch

TOP = 10


class Profile(NamedTuple):
    window_s: float  # from the first profiled request's start to the last one's end
    busy_s: float  # device busy inside the window
    request_busy_s: list  # device busy inside each profiled request, in order
    device_ops: list  # [[name, seconds]] of the device operations, most time first
    idle_gaps: list  # [[host operation, seconds]] of the idle time, most first
    n_device_events: int


class SubWindow:
    """Profiles the first ``count`` requests of a window. The loop calls
    :meth:`begin` at the end of its set-up (the profiler's own start-up
    lands there), :meth:`step` with each request's index before it, and
    wraps each request in :meth:`range`. The events are read only by
    :meth:`summary`, once the window has closed."""

    def __init__(self, enabled: bool, count: int, label: str):
        self.enabled = enabled
        self.count = int(count)
        self.label = label
        self._prof = None
        self._done = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def begin(self) -> None:
        if not self.enabled or self.count <= 0:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def step(self, k: int) -> None:
        if self._prof is not None and k >= self.count:
            self.close()

    def range(self):
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(self.label)

    def close(self) -> None:
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            self._done, self._prof = self._prof, None

    def summary(self) -> Profile | None:
        """The reduction, or ``None`` when nothing was profiled."""
        self.close()
        if self._done is None:
            return None
        events = list(self._done.events())
        self._done = None
        return reduce_events(events, self.label) if events else None


def _is_device(ev) -> bool:
    return ev.device_type != torch.autograd.DeviceType.CPU


#: host events of the profiler's own bookkeeping, never what the program did
PROFILER_HOST_EVENTS = ("Activity Buffer Request",)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _overlap(merged, starts, s, e) -> float:
    """Length of ``[s, e]`` covered by the merged, sorted intervals."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    tot = 0.0
    while i < len(merged) and merged[i][0] < e:
        a, b = max(merged[i][0], s), min(merged[i][1], e)
        if b > a:
            tot += b - a
        i += 1
    return tot


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def reduce_events(events, label: str) -> Profile | None:
    """:class:`Profile` of a profiler's ``events()`` (times in microseconds)."""
    reqs = sorted((ev.time_range.start, ev.time_range.end, ev.thread)
                  for ev in events if ev.name == label and not _is_device(ev))
    if not reqs:
        return None
    w0, w1 = reqs[0][0], max(r[1] for r in reqs)
    thread = reqs[0][2]
    # the device side of a record_function range is an annotation, not work
    dev = [ev for ev in events if _is_device(ev) and ev.name != label
           and not getattr(ev, "is_user_annotation", False)
           and ev.time_range.end > w0 and ev.time_range.start < w1]
    merged = _merge((max(ev.time_range.start, w0), min(ev.time_range.end, w1)) for ev in dev)
    starts = [m[0] for m in merged]
    busy = sum(b - a for a, b in merged)
    ops: dict = {}
    for ev in dev:
        name = ev.name[:120]
        ops[name] = ops.get(name, 0.0) + (ev.time_range.end - ev.time_range.start) * 1e-6
    # idle gaps, each labelled by the innermost host op spanning its middle
    gaps, t = [], w0
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host = sorted(((ev.time_range.start, -ev.time_range.end, ev.name) for ev in events
                   if not _is_device(ev) and ev.thread == thread
                   and ev.name not in PROFILER_HOST_EVENTS), key=lambda x: x[:2])
    idle: dict = {}
    stack, i = [], 0
    for a, b in sorted(gaps):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            stack.append(host[i])
            i += 1
        while stack and -stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2][:120] if stack else "host (outside any operation)"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return Profile(
        window_s=(w1 - w0) * 1e-6,
        busy_s=busy * 1e-6,
        request_busy_s=[_overlap(merged, starts, s, e) * 1e-6 for s, e, _ in reqs],
        device_ops=_top(ops),
        idle_gaps=_top(idle),
        n_device_events=len(dev),
    )
