"""``repro_torch.obs`` against ``repro.obs`` on the CPU: the tracer and the
metrics registry (mirroring ``tests/test_obs.py``), the export schema
through ``tools/check_trace.py``, and the instrumented solve stack — the
same inputs through both packages with obs off, "metrics" and "trace"
give identical reports, the same span names and counts, the same
counters."""
import collections
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_util import StreamTrace, apply_op, assert_same_msf, cpu_graph  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import solve as jsolve  # noqa: E402
from repro.coarsen import CoarsenConfig as JCoarsenConfig  # noqa: E402
from repro.graphs.generators import random_graph  # noqa: E402
from repro.stream.engine import StreamEngine as JStreamEngine  # noqa: E402
from repro.stream.service import MicroBatcher as JMicroBatcher  # noqa: E402
from repro.stream.service import QueryService as JQueryService  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import solve as tsolve  # noqa: E402
from repro_torch.coarsen import CoarsenConfig as TCoarsenConfig  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.stream.engine import StreamEngine as TStreamEngine  # noqa: E402
from repro_torch.stream.service import MicroBatcher as TMicroBatcher  # noqa: E402
from repro_torch.stream.service import QueryService as TQueryService  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"reference": jobs, "port": tobs}
MODES = ("off", "metrics", "trace")


def _clean():
    for o in (jobs, tobs):
        o.disable()
        o.reset()
        o.metrics_reset()


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts and ends with obs off and empty buffers, in both
    packages (each has its own process-global mode and registry)."""
    _clean()
    yield
    _clean()


# ---------------------------------------------------------------------------
# tracer and registry (the port's copy, beside the reference's)
# ---------------------------------------------------------------------------


def test_all_matches_the_reference():
    assert tobs.__all__ == jobs.__all__
    assert tobs.MODES == jobs.MODES
    assert tobs.DEFAULT_LATENCY_BUCKETS == jobs.DEFAULT_LATENCY_BUCKETS


def test_disabled_span_is_shared_noop_singleton():
    s1 = tobs.span("a")
    s2 = tobs.span("b", level=3)
    assert s1 is s2 is tobs.NOOP_SPAN
    with s1 as sp:
        assert sp.attach("payload") == "payload"
        sp.set(anything="goes")
    assert tobs.trace_events() == []
    assert tobs.metrics_snapshot()["histograms"] == {}


def test_span_nesting_records_all_levels():
    tobs.enable("trace")
    with tobs.span("outer", level=0):
        with tobs.span("inner", level=1):
            pass
        with tobs.span("inner", level=2):
            pass
    events = tobs.trace_events()
    assert [e[0] for e in events] == ["inner", "inner", "outer"]
    outer = events[-1]
    for _, t0, dur, tid, _ in events[:2]:
        assert tid == outer[3]
        assert outer[1] <= t0 and t0 + dur <= outer[1] + outer[2]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_enabled_is_upgrade_only(pkg):
    o = PACKAGES[pkg]
    o.enable("trace")
    with o.enabled("metrics"):
        assert o.mode() == "trace"
    with o.enabled("off"):
        assert o.mode() == "trace"
    o.disable()
    with o.enabled("metrics"):
        assert o.mode() == "metrics" and o.metrics_active() and not o.trace_active()
        with o.enabled("trace", sync=False):
            assert o.mode() == "trace" and not o.sync_active()
        assert o.mode() == "metrics" and o.sync_active()
    assert o.mode() == "off"


def test_collect_timings_aggregates_by_name():
    tobs.enable("metrics")
    with tobs.collect_timings() as t:
        for name in ("phase.a", "phase.a", "phase.b"):
            with tobs.span(name):
                pass
    assert set(t) == {"phase.a", "phase.b"} and all(v >= 0.0 for v in t.values())
    h = tobs.metrics_snapshot()["histograms"]
    assert h["span.phase.a"]["count"] == 2 and h["span.phase.b"]["count"] == 1
    tobs.disable()
    with tobs.collect_timings() as t:
        with tobs.span("phase.c"):
            pass
    assert t == {}


def test_counter_gauge_and_histograms_match_the_reference():
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.random(500), rng.random(200) * 50, [0.25] * 10]).tolist()
    for o in (jobs, tobs):
        o.counter("c").inc()
        o.counter("c").inc(41)
        o.gauge("g").set(2.5)
        for x in xs:
            o.histogram("lat").observe(x)
        o.histogram("one", (1.0, 2.0)).observe(1.5)
        with pytest.raises(ValueError):
            o.counter("c").inc(-1)
    assert tobs.metrics_snapshot() == jobs.metrics_snapshot()
    assert tobs.metrics_snapshot()["counters"]["c"] == 42
    h = tobs.histogram("lat")
    for q in (0, 1, 50, 95, 99, 100):
        assert h.percentile(q) == jobs.histogram("lat").percentile(q)
    with pytest.raises(ValueError):
        h.percentile(101)


def test_histogram_percentiles_uniform_and_clamped():
    h = tobs.histogram("lat")
    for ms in range(1, 1001):
        h.observe(ms / 1e3)
    for q in (50, 95, 99):
        assert q / 100 / 2.2 <= h.percentile(q) <= q / 100 * 2.2
    s = h.summary()
    assert s["count"] == 1000 and s["p50"] <= s["p95"] <= s["p99"] <= s["max"]
    one = tobs.histogram("one")
    for _ in range(10):
        one.observe(0.25)
    s = one.summary()
    assert s["p50"] == s["p95"] == s["p99"] == pytest.approx(0.25)
    assert tobs.histogram("empty").summary()["p50"] == 0.0


@pytest.mark.parametrize("bounds", [(), (1.0, 1.0), (2.0, 1.0)])
def test_histogram_rejects_bad_bounds(bounds):
    from repro_torch.obs.metrics import Histogram

    with pytest.raises(ValueError):
        Histogram(bounds=bounds)


def test_attach_syncs_no_cpu_value(monkeypatch):
    """A span holding CPU tensors, numpy or nested containers of them
    synchronises nothing; the value passes through unchanged."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(a))
    tobs.enable("trace")
    value = (torch.ones(3), {"a": [np.ones(2), torch.zeros(1)]}, None)
    with tobs.span("s") as sp:
        assert sp.attach(value) is value
    assert calls == [] and ttrace._cuda_devices(value, set()) == set()
    assert [e[0] for e in tobs.trace_events()] == ["s"]


def test_export_trace_schema_roundtrip(tmp_path):
    tobs.enable("trace")
    with tobs.span("outer", n=64, k=torch.tensor(7), big=torch.arange(3)):
        with tobs.span("inner"):
            pass
    path = str(tmp_path / "trace.json")
    doc = tobs.export_trace(path)
    assert json.loads(open(path).read()) == doc
    complete = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in complete} == {"outer", "inner"}
    for e in complete:
        assert isinstance(e["ts"], float) and e["ts"] >= 0.0
        assert isinstance(e["dur"], float) and e["dur"] >= 0.0
        assert e["pid"] == 0 and isinstance(e["tid"], int)
    outer = next(e for e in complete if e["name"] == "outer")
    assert outer["args"] == {"n": 64, "k": 7, "big": str(torch.arange(3))}
    assert any(e.get("ph") == "M" for e in doc["traceEvents"])
    assert doc["otherData"]["dropped_events"] == 0
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        from check_trace import check

        assert check(path, ["outer", "inner"]) is None
        assert check(path, ["absent-span"]) is not None
    finally:
        sys.path.remove(str(ROOT / "tools"))


# ---------------------------------------------------------------------------
# the solve stack: both packages, the same inputs, every obs mode
# ---------------------------------------------------------------------------


def _run(pkg, mode, fn):
    """``fn()`` with the package's buffers cleared; returns the result, the
    multiset of span names recorded and the counters."""
    o = PACKAGES[pkg]
    o.reset()
    o.metrics_reset()
    out = fn()
    names = collections.Counter(e[0] for e in o.trace_events())
    return out, names, o.metrics_snapshot()["counters"]


def _solve_both(jg, spec_kw, mode, *, coarsen=None):
    jsolve.clear_plan_cache()
    tsolve.clear_plan_cache()
    jkw, tkw = dict(spec_kw), dict(spec_kw)
    if coarsen is not None:
        jkw["coarsen"], tkw["coarsen"] = JCoarsenConfig(**coarsen), TCoarsenConfig(**coarsen)
    jr = _run("reference", mode,
              lambda: jsolve.plan(jg, jsolve.SolveSpec(obs=mode, **jkw)).solve())
    tr = _run("port", mode,
              lambda: tsolve.plan(cpu_graph(jg), tsolve.SolveSpec(obs=mode, **tkw)).solve())
    return jr, tr


def _assert_same_timings_keys(jrep, trep, mode):
    assert set(trep.timings) == set(jrep.timings)
    assert bool(trep.timings) == (mode != "off")


@pytest.mark.parametrize("mode", MODES)
def test_flat_parity_across_modes(mode):
    jg = random_graph(256, 1024, seed=7)
    (jrep, jnames, jcnt), (trep, tnames, tcnt) = _solve_both(jg, {}, mode)
    assert_same_msf(jrep, trep)
    (_, _, _), (base, _, _) = _solve_both(jg, {}, "off")
    assert_same_msf(base, trep)  # obs changes no output bit
    _assert_same_timings_keys(jrep, trep, mode)
    assert tnames == jnames
    assert tcnt == jcnt
    if mode == "trace":
        assert tnames["msf.round"] == int(trep.iterations) and tnames["msf.flat"] == 1
        assert trep.timings["msf.round"] >= 0.0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fused", [False, True])
def test_coarsen_parity_across_modes(mode, fused):
    jg = random_graph(512, 2048, seed=11)
    cfg = dict(cutoff=32, rounds_per_level=2)
    (jrep, jnames, jcnt), (trep, tnames, tcnt) = _solve_both(
        jg, dict(mode="coarsen", fused=fused), mode, coarsen=cfg)
    assert_same_msf(jrep, trep)
    (_, _, _), (base, _, _) = _solve_both(jg, dict(mode="coarsen", fused=fused), "off",
                                          coarsen=cfg)
    assert_same_msf(base, trep)
    assert tuple(map(tuple, trep.levels)) == tuple(map(tuple, base.levels))
    _assert_same_timings_keys(jrep, trep, mode)
    assert tnames == jnames
    assert tcnt == jcnt
    if mode == "trace":
        assert {"coarsen.levels", "coarsen.level", "coarsen.contract", "coarsen.relabel",
                "coarsen.filter", "coarsen.residual"} <= set(tnames)
        assert tnames["coarsen.level"] >= len(trep.levels) > 0


def _stream_trace_ops(seed):
    tr = StreamTrace(48, 24, seed, p=(0.5, 0.35, 0.05, 0.1))
    return [tr.insert(30)] + [tr.next_op() for _ in range(14)]


@pytest.mark.parametrize("mode", MODES)
def test_stream_parity_across_modes(mode):
    """One op trace through both packages' stream plans: identical
    reports per op, and with the reservoir kept small, the reservoir
    counters equal over the trace; the same spans."""
    ops = _stream_trace_ops(5)
    kw = dict(mode="stream", batch_capacity=32, reservoir_capacity=16,
              reservoir_per_component=4)

    def drive(plan_fn, spec_cls):
        p = plan_fn(48, spec_cls(obs=mode, **kw))
        reps = []
        for name, args in ops:
            call = {"insert": p.update, "delete": p.delete, "compact": p.compact,
                    "recertify": p.recertify}[name]
            reps.append(call(*args))
        reps.append(p.query(np.arange(8), np.arange(8, 16)))
        return reps

    jreps, jnames, jcnt = _run("reference", mode, lambda: drive(jsolve.plan, jsolve.SolveSpec))
    treps, tnames, tcnt = _run(
        "port", mode, lambda: drive(lambda n, s: tsolve.plan(n, s, device="cpu"),
                                    tsolve.SolveSpec))
    from _torch_util import assert_same_stream_report

    for a, b in zip(jreps[:-1], treps[:-1]):
        assert set(b.timings) == set(a.timings)
        assert_same_stream_report(a._replace(timings={}), b._replace(timings={}))
    np.testing.assert_array_equal(treps[-1], np.asarray(jreps[-1]))
    assert tnames == jnames
    assert tcnt == jcnt
    if mode != "off":
        counted = {k for k in tcnt if k.startswith("stream.reservoir.")}
        assert counted, tcnt  # the small reservoir evicts
        assert tobs.metrics_snapshot()["histograms"]["span.stream.update"]["count"] == sum(
            name == "insert" for name, _ in ops)


def test_stream_engine_counters_without_plan():
    """The reservoir counters count in every mode (as the reference's do),
    on the engines directly."""
    tr = StreamTrace(48, 24, 9)
    ops = [tr.insert(30) for _ in range(4)] + [tr.delete(20) for _ in range(3)]
    kw = dict(batch_capacity=32, reservoir_capacity=16, reservoir_per_component=4)
    je, te = JStreamEngine(48, **kw), TStreamEngine(48, device="cpu", **kw)
    _, _, jcnt = _run("reference", "off", lambda: [apply_op(je, n, a) for n, a in ops])
    _, _, tcnt = _run("port", "off", lambda: [apply_op(te, n, a) for n, a in ops])
    assert tcnt == jcnt
    assert {"stream.reservoir.evictions", "stream.reservoir.hits"} <= set(tcnt)


@pytest.mark.parametrize("mode", MODES)
def test_batcher_metrics_match_the_reference(mode):
    def drive(engine, service_cls, batcher_cls, o):
        engine.insert_batch(np.arange(0, 30), np.arange(1, 31), np.ones(30))
        b = batcher_cls(service_cls(engine.snapshots), max_queue=5, retain_windows=3)
        with o.enabled(mode):
            tickets = [b.ask_connected(i, (i * 7) % 40) for i in range(12)]
            b.flush()
            return [b.result(t) for t in tickets[-6:]]

    je = JStreamEngine(40, batch_capacity=32)
    te = TStreamEngine(40, batch_capacity=32, device="cpu")
    jres, _, _ = _run("reference", mode, lambda: drive(je, JQueryService, JMicroBatcher, jobs))
    jsnap = jobs.metrics_snapshot()
    tres, _, _ = _run("port", mode, lambda: drive(te, TQueryService, TMicroBatcher, tobs))
    tsnap = tobs.metrics_snapshot()
    assert tres == jres
    assert tsnap["counters"] == jsnap["counters"]
    assert tsnap["gauges"] == jsnap["gauges"]
    assert set(tsnap["histograms"]) == set(jsnap["histograms"])
    if mode != "off":
        assert tsnap["counters"]["stream.batcher.overflow"] == 2
        assert tsnap["counters"]["stream.batcher.flushed_queries"] == 12


def test_plan_cache_counters():
    jg = random_graph(128, 512, seed=2)
    g = cpu_graph(jg)
    tsolve.clear_plan_cache()
    jsolve.clear_plan_cache()
    for _ in range(2):
        tsolve.plan(g, tsolve.SolveSpec(obs="metrics"))
        jsolve.plan(jg, jsolve.SolveSpec(obs="metrics"))
    snap = tobs.metrics_snapshot()["counters"]
    assert snap["plan.cache.miss"] == 1 and snap["plan.cache.hit"] == 1
    assert snap == jobs.metrics_snapshot()["counters"]
    hist = tobs.metrics_snapshot()["histograms"]
    assert hist["span.plan.resolve"]["count"] == 2 and hist["span.plan.build"]["count"] == 1
    tsolve.plan(g, tsolve.SolveSpec())  # obs off: nothing counted
    assert tobs.metrics_snapshot()["counters"] == snap


def test_global_enable_reaches_an_off_spec():
    """A process-wide ``obs.enable`` records through a spec whose knob is
    off (the knob only ever raises the mode), as in the reference."""
    g = cpu_graph(random_graph(64, 256, seed=4))
    tobs.enable("metrics")
    rep = tsolve.plan(g, tsolve.SolveSpec()).solve()
    assert set(rep.timings) == {"solve.flat"}
    assert "span.solve.flat" in tobs.metrics_snapshot()["histograms"]


def test_exported_solve_trace_passes_check_trace(tmp_path):
    import subprocess

    g = cpu_graph(random_graph(256, 1024, seed=3))
    tsolve.plan(g, tsolve.SolveSpec(obs="trace")).solve()
    tsolve.plan(g, tsolve.SolveSpec(mode="coarsen", obs="trace",
                                    coarsen=TCoarsenConfig(cutoff=16))).solve()
    path = tmp_path / "solve.json"
    tobs.export_trace(str(path))
    names = ["plan.resolve", "solve.flat", "msf.flat", "msf.round", "solve.coarsen",
             "coarsen.levels", "coarsen.level", "coarsen.contract", "coarsen.relabel",
             "coarsen.filter", "coarsen.residual"]
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "check_trace.py"), str(path),
                           *names], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
