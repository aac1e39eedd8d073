"""Lightweight span tracer with Chrome-trace/Perfetto export (counterpart
of ``repro.obs.trace``, DESIGN.md §10.1).

Usage::

    from repro_torch import obs

    obs.enable("trace")                 # or "metrics"; process-global
    with obs.span("hook_rounds", level=0) as sp:
        out = run(...)
        sp.attach(out)                  # CUDA sync on exit (sync mode)
    obs.export_trace("trace.json")      # open in ui.perfetto.dev

Three modes, escalating cost:

- ``"off"`` (default): :func:`span` returns a shared no-op context
  manager — the disabled path is **one branch and zero allocation**, so
  instrumentation can stay unconditionally in hot loops;
- ``"metrics"``: span durations feed ``span.<name>`` fixed-bucket
  histograms in the default :mod:`repro_torch.obs.metrics` registry
  (p50/p95/p99 summaries); no event buffer;
- ``"trace"``: additionally every span is recorded as a Chrome-trace
  complete event (``ph: "X"`` with microsecond ``ts``/``dur``) in a
  bounded in-process buffer, exported by :func:`export_trace`. Nesting
  falls out of timestamps: Perfetto stacks same-thread spans whose
  intervals contain each other. While torch's profiler is collecting,
  each span also opens a ``record_function`` range of its name, closed
  after its sync, so the spans nest in the profiler's own timeline and
  its idle time can be laid at a span's door.

Device-sync timing: CUDA launches are asynchronous, so a span around
them measures the enqueue, not the execution. ``sp.attach(value)`` marks
a value (a tensor, or tuples, named tuples, lists and dicts holding
tensors) whose CUDA devices are synchronised *before* the span closes
(enabled by default, ``enable(..., sync=False)`` opts out) — the
exported duration then covers the device work, at the cost of the sync
point the profiler itself introduces. CPU tensors and numpy values need
no sync. Spans are thread-safe (per-thread ids in the export; the
buffer appends under a lock).

Host waits: :func:`host_sync` counts, by site, each point at which the
host blocks on the device (a read of a device value, a shape that depends
on device data, a synchronous copy), inside :func:`collect_syncs`, in
trace mode only. The spans' own syncs are not among them, so the tally
is what an untraced solve waits.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager

import torch

from repro_torch.obs import metrics as _metrics

MODES = ("off", "metrics", "trace")
_MODE_RANK = {m: i for i, m in enumerate(MODES)}

#: Bounded event buffer — a runaway traced loop degrades to dropped-event
#: accounting (surfaced in the export metadata), never unbounded memory.
MAX_EVENTS = 1_000_000

_lock = threading.Lock()
_mode: str = "off"
_enabled: bool = False  # _mode != "off" — the single hot-path branch
_sync: bool = True
_events: list = []  # (name, t0_ns, dur_ns, tid, attrs | None)
_dropped: int = 0
_tls = threading.local()  # .collectors / .syncs: list[dict] of active aggregators

#: Spans the port records in trace mode and the reference does not: the
#: phases of an AS round and its outgoing-edge count (``core/msf.py``), and
#: the report's host copies (``solve/engines.py``).
PORT_ONLY_SPANS = ("msf.min_outgoing", "msf.counts", "msf.hook", "msf.shortcut",
                   "solve.report")


def _check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown obs mode {mode!r} (expected one of {MODES})")
    return mode


def mode() -> str:
    """Current process-global observability mode."""
    return _mode


def trace_active() -> bool:
    return _mode == "trace"


def metrics_active() -> bool:
    """True in both "metrics" and "trace" modes."""
    return _enabled


def sync_active() -> bool:
    return _enabled and _sync


def enable(mode: str = "trace", *, sync: bool = True) -> None:
    """Set the process-global mode (until :func:`disable`)."""
    global _mode, _enabled, _sync
    _check_mode(mode)
    with _lock:
        _mode = mode
        _enabled = mode != "off"
        _sync = bool(sync)


def disable() -> None:
    enable("off")


@contextmanager
def enabled(mode: str = "trace", *, sync: bool | None = None):
    """Scoped enable: raise the mode for the duration, restore after.

    Upgrade-only — ``enabled("metrics")`` inside a process already in
    "trace" mode keeps tracing (a spec-level knob never silences a
    global ``obs.enable``); ``enabled("off")`` is a no-op context.
    """
    global _mode, _enabled, _sync
    _check_mode(mode)
    if _MODE_RANK[mode] <= _MODE_RANK[_mode]:
        yield
        return
    with _lock:
        prev = (_mode, _enabled, _sync)
        _mode = mode
        _enabled = True
        if sync is not None:
            _sync = bool(sync)
    try:
        yield
    finally:
        with _lock:
            _mode, _enabled, _sync = prev


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _NoopSpan:
    """Shared disabled-mode span: every call is a no-op, ``span()``
    returns this one instance — zero allocation on the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def attach(self, value):
        return value

    def set(self, **attrs):
        return None


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "_t0", "_pending", "_range")

    def __init__(self, name: str, attrs: dict | None):
        self.name = name
        self.attrs = attrs
        self._pending = None
        self._range = None

    def __enter__(self):
        if _mode == "trace" and torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def attach(self, value):
        """Mark a value whose CUDA tensors are waited for before the span
        closes (sync mode) so the duration covers the device work, not
        the enqueue."""
        self._pending = value
        return value

    def set(self, **attrs):
        """Add attributes after entry (e.g. results only known inside)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __exit__(self, *exc):
        if self._pending is not None and _sync:
            for dev in _cuda_devices(self._pending, set()):
                torch.cuda.synchronize(dev)
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _record(self.name, self._t0, t1 - self._t0, self.attrs)
        return False


def _cuda_devices(value, found: set) -> set:
    """The CUDA devices of the tensors in ``value`` (tensors, tuples,
    named tuples, lists and dict values, nested)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, found)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    return found


def span(name: str, **attrs) -> _Span | _NoopSpan:
    """Context manager timing one region. Disabled mode: one branch,
    returns the shared no-op instance."""
    if not _enabled:
        return NOOP_SPAN
    return _Span(name, attrs or None)


def trace_span(name: str, **attrs) -> _Span | _NoopSpan:
    """A span that opens only in trace mode: the sub-spans the reference
    records only in its trace-mode twins (``msf.round``, the coarsen
    level phases). Otherwise the shared no-op, so metrics mode records the
    reference's names and no extra sync."""
    if _mode != "trace":
        return NOOP_SPAN
    return _Span(name, attrs or None)


def _record(name: str, t0_ns: int, dur_ns: int, attrs) -> None:
    global _dropped
    dur_s = dur_ns * 1e-9
    collectors = getattr(_tls, "collectors", None)
    if collectors:
        for d in collectors:
            d[name] = d.get(name, 0.0) + dur_s
    _metrics.DEFAULT_REGISTRY.histogram(f"span.{name}").observe(dur_s)
    if _mode == "trace":
        with _lock:
            if len(_events) < MAX_EVENTS:
                _events.append(
                    (name, t0_ns, dur_ns, threading.get_ident(), attrs)
                )
            else:
                _dropped += 1


def host_sync(site: str, n: int = 1) -> None:
    """Count ``n`` host waits at ``site`` in every active
    :func:`collect_syncs` tally. Trace mode only: otherwise one branch."""
    if _mode != "trace":
        return
    for d in getattr(_tls, "syncs", ()):
        d[site] = d.get(site, 0) + n


@contextmanager
def collect_syncs():
    """Tally same-thread :func:`host_sync` calls by site for the duration.

    Yields a dict that fills with ``{site: count}`` in trace mode (empty
    otherwise), the planner's ``host_syncs`` attributes of a solve span.
    """
    d: dict = {}
    stack = getattr(_tls, "syncs", None)
    if stack is None:
        stack = _tls.syncs = []
    stack.append(d)
    try:
        yield d
    finally:
        stack.remove(d)


@contextmanager
def collect_timings():
    """Aggregate same-thread span durations by name for the duration.

    Yields a dict that fills with ``{span name: total seconds}`` —
    nested spans each contribute their own name (a parent's time
    includes its children's, as in any trace viewer). Empty when
    observability is off. This is what populates
    ``SolveReport.timings``.
    """
    d: dict = {}
    if not _enabled:
        yield d
        return
    stack = getattr(_tls, "collectors", None)
    if stack is None:
        stack = _tls.collectors = []
    stack.append(d)
    try:
        yield d
    finally:
        stack.remove(d)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def trace_events() -> list:
    """Copy of the recorded raw events (name, t0_ns, dur_ns, tid, attrs)."""
    with _lock:
        return list(_events)


def reset() -> None:
    """Drop every recorded event (mode is unchanged)."""
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0


def export_trace(path: str) -> dict:
    """Write the buffer as Chrome-trace JSON (Perfetto / chrome://tracing).

    Complete events (``ph: "X"``) with microsecond ``ts`` (relative to
    the first recorded span) and ``dur``, one ``tid`` per recording
    thread, span attributes under ``args``. Returns the document (also
    handy for tests). The buffer is kept — call :func:`reset` to start a
    fresh window.
    """
    with _lock:
        events = list(_events)
        dropped = _dropped
    t_base = min((e[1] for e in events), default=0)
    tids = {}
    trace_events_out = []
    for name, t0_ns, dur_ns, tid_raw, attrs in events:
        tid = tids.setdefault(tid_raw, len(tids))
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t0_ns - t_base) / 1e3,
            "dur": dur_ns / 1e3,
            "pid": 0,
            "tid": tid,
        }
        if attrs:
            ev["args"] = {k: _json_safe(v) for k, v in attrs.items()}
        trace_events_out.append(ev)
    meta = [
        {"name": "process_name", "ph": "M", "pid": 0,
         "args": {"name": "repro_torch"}},
    ] + [
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
         "args": {"name": f"thread-{tid}"}}
        for tid in sorted(tids.values())
    ]
    doc = {
        "traceEvents": meta + trace_events_out,
        "displayTimeUnit": "ms",
        "otherData": {"dropped_events": dropped, "source": "repro_torch.obs"},
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def _json_safe(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, torch.Tensor) and v.dim() != 0:
        return str(v)
    try:
        return int(v)  # numpy scalars, 0-d tensors
    except (TypeError, ValueError):
        return str(v)
