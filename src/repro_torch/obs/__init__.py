# Observability substrate of the port (counterpart of repro.obs, DESIGN.md
# §10): span tracing with Chrome-trace/Perfetto export (repro_torch.obs.trace)
# + a process-global metrics registry of counters / gauges / fixed-bucket
# latency histograms (repro_torch.obs.metrics). Leaf package — imported by
# every layer (core, coarsen, stream, solve, serve, launch), so it imports
# none of them; a span that holds CUDA tensors synchronises their devices
# at exit (sync mode).
#
#     from repro_torch import obs
#     obs.enable("trace")
#     with obs.span("solve", n=graph.n) as sp:
#         sp.attach(run(graph))
#     obs.export_trace("trace.json")
#
# The declarative route is `SolveSpec(obs="trace")` — the plan layer
# scopes the mode around each solve and fills `SolveReport.timings`.
from repro_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS,
    DEFAULT_REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from repro_torch.obs.trace import (
    MODES,
    NOOP_SPAN,
    PORT_ONLY_SPANS,
    collect_syncs,
    collect_timings,
    disable,
    enable,
    enabled,
    export_trace,
    host_sync,
    metrics_active,
    mode,
    reset,
    span,
    sync_active,
    trace_active,
    trace_events,
)

# The port's own surface (PORT_ONLY_SPANS, host_sync, collect_syncs) stays
# out of __all__, which lists what the reference's obs exports.

__all__ = [
    # tracing
    "MODES",
    "NOOP_SPAN",
    "collect_timings",
    "disable",
    "enable",
    "enabled",
    "export_trace",
    "metrics_active",
    "mode",
    "reset",
    "span",
    "sync_active",
    "trace_active",
    "trace_events",
    # metrics
    "DEFAULT_LATENCY_BUCKETS",
    "DEFAULT_REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "counter",
    "gauge",
    "histogram",
    "metrics_snapshot",
    "metrics_reset",
]


def counter(name: str) -> Counter:
    """Named counter in the process-global registry."""
    return DEFAULT_REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return DEFAULT_REGISTRY.gauge(name)


def histogram(name: str, bounds=DEFAULT_LATENCY_BUCKETS) -> Histogram:
    return DEFAULT_REGISTRY.histogram(name, bounds)


def metrics_snapshot() -> dict:
    """JSON-safe snapshot of the process-global registry."""
    return DEFAULT_REGISTRY.snapshot()


def metrics_reset() -> None:
    DEFAULT_REGISTRY.reset()
