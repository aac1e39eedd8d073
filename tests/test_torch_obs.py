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
PORT_ONLY = frozenset(tobs.PORT_ONLY_SPANS)
#: the port-only spans of one AS round, in order: the phases, and the
#: trace-only outgoing count between the first two
ROUND_SPANS = ("msf.min_outgoing", "msf.counts", "msf.hook", "msf.shortcut")


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


def _split_names(tnames):
    """The port's span-name multiset split into the names the reference
    also records and the port-only ones."""
    shared = collections.Counter({k: v for k, v in tnames.items() if k not in PORT_ONLY})
    own = collections.Counter({k: v for k, v in tnames.items() if k in PORT_ONLY})
    return shared, own


def _assert_port_only_counts(tnames, mode, *, reports=1):
    """Off and metrics: no port-only span. Trace: the three phase spans and
    the count span once per ``msf.round`` and one ``solve.report`` per solve."""
    _, own = _split_names(tnames)
    if mode != "trace":
        assert not own
        return
    rounds = tnames["msf.round"]
    assert own == collections.Counter({**{ph: rounds for ph in ROUND_SPANS},
                                       "solve.report": reports}), own


def _assert_same_timings_keys(jrep, trep, mode):
    assert set(trep.timings) - PORT_ONLY == set(jrep.timings)
    assert set(trep.timings) & PORT_ONLY == (PORT_ONLY if mode == "trace" else set())
    assert bool(trep.timings) == (mode != "off")


@pytest.mark.parametrize("mode", MODES)
def test_flat_parity_across_modes(mode):
    jg = random_graph(256, 1024, seed=7)
    (jrep, jnames, jcnt), (trep, tnames, tcnt) = _solve_both(jg, {}, mode)
    assert_same_msf(jrep, trep)
    (_, _, _), (base, _, _) = _solve_both(jg, {}, "off")
    assert_same_msf(base, trep)  # obs changes no output bit
    _assert_same_timings_keys(jrep, trep, mode)
    assert _split_names(tnames)[0] == jnames
    _assert_port_only_counts(tnames, mode)
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
    assert _split_names(tnames)[0] == jnames
    _assert_port_only_counts(tnames, mode)
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
    counters equal over the trace; the same spans, and the port's own
    phase spans once per AS round."""
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
        assert set(b.timings) - PORT_ONLY == set(a.timings)
        assert_same_stream_report(a._replace(timings={}), b._replace(timings={}))
    np.testing.assert_array_equal(treps[-1], np.asarray(jreps[-1]))
    assert _split_names(tnames)[0] == jnames
    _assert_port_only_counts(tnames, mode, reports=0)
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


# ---------------------------------------------------------------------------
# the port's own instruments: phase spans, the host-wait tally, the report
# span, and the spans' profiler ranges
# ---------------------------------------------------------------------------


def test_port_only_span_names_are_one_constant():
    """What a traced flat and coarsen solve record beyond the reference's
    names is exactly ``obs.PORT_ONLY_SPANS``, kept out of ``__all__``."""
    assert tobs.PORT_ONLY_SPANS is ttrace.PORT_ONLY_SPANS
    assert not set(tobs.PORT_ONLY_SPANS) & set(tobs.__all__)
    jg = random_graph(256, 1024, seed=7)
    for kw in ({}, dict(mode="coarsen")):
        (_, jnames, _), (_, tnames, _) = _solve_both(jg, kw, "trace",
                                                     coarsen=dict(cutoff=32) if kw else None)
        assert set(tnames) - set(jnames) == PORT_ONLY


def _traced_flat(g, **spec):
    tobs.reset()
    tsolve.clear_plan_cache()
    rep = tsolve.plan(g, tsolve.SolveSpec(obs="trace", **spec)).solve()
    return rep, tobs.trace_events()


def _inside(ev, outer):
    return outer[1] <= ev[1] and ev[1] + ev[2] <= outer[1] + outer[2] and ev[3] == outer[3]


FLAT_SPECS = {
    "complete": dict(),
    "complete-unpacked": dict(pack=False),
    "csp": dict(shortcut="csp"),
    "paper": dict(variant="paper"),
    "pairwise": dict(variant="pairwise"),
}


@pytest.mark.parametrize("spec", sorted(FLAT_SPECS))
def test_phase_spans_nest_in_their_round(spec):
    """Each AS round holds one msf.min_outgoing, msf.counts, msf.hook and
    msf.shortcut span, in that order, inside its msf.round span."""
    rep, events = _traced_flat(cpu_graph(random_graph(256, 1024, seed=7)), **FLAT_SPECS[spec])
    rounds = [e for e in events if e[0] == "msf.round"]
    assert len(rounds) == rep.iterations > 1
    phases = [e for e in events if e[0] in ROUND_SPANS]
    assert len(phases) == 4 * len(rounds)
    for rnd in rounds:
        inside = sorted((e for e in phases if _inside(e, rnd)), key=lambda e: e[1])
        assert [e[0] for e in inside] == list(ROUND_SPANS), rnd[4]
    report = [e for e in events if e[0] == "solve.report"]
    solve = next(e for e in events if e[0] == "solve.flat")
    assert len(report) == 1 and _inside(report[0], solve)
    assert report[0][4] == {"pinned": 0, "d2h_bytes": 0}  # a CPU result: read in place


@pytest.mark.parametrize("spec", ["complete", "complete-unpacked", "pairwise"])
def test_outgoing_counts_match_a_recount(spec):
    """msf.counts' ``edges`` and ``outgoing`` against a plain recount over
    the parent vector at the top of each round."""
    from repro_torch.core.msf import run_flat

    g = cpu_graph(random_graph(256, 1024, seed=7))
    _, events = _traced_flat(g, **FLAT_SPECS[spec])
    rounds = sorted((e for e in events if e[0] == "msf.round"), key=lambda e: e[1])
    mins = sorted((e for e in events if e[0] == "msf.counts"), key=lambda e: e[1])
    variant = FLAT_SPECS[spec].get("variant", "complete")
    for rnd, ev in zip(rounds, mins):
        k = rnd[4]["round"]
        p = run_flat(g, variant=variant, max_iters=k).parent.long()
        attrs = ev[4]
        assert attrs["edges"] == g.src.numel()
        assert attrs["outgoing"] == int(((p[g.src.long()] != p[g.dst.long()]) & g.valid).sum())
        assert 0 <= attrs["outgoing"] <= attrs["edges"]
    assert len(mins) == len(rounds) and mins[-1][4]["outgoing"] == 0


def _solve_span(events, name):
    (ev,) = [e for e in events if e[0] == name]
    return ev[4]


@pytest.mark.parametrize("pack", [True, False])
def test_host_sync_tally_of_a_flat_solve(pack):
    """host_syncs is the sum of host_syncs_by_site, and each site is what a
    replay of the rounds counts: per round 1 nonzero (2 packed) + (jumps + 1)
    .any() + 1 torch.equal; then the final shortcut's .any(), the
    iterations copy and the report's 2 waits (its scalars, then both arrays)."""
    from repro_torch.core import shortcut as sc
    from repro_torch.core.msf import hook_and_tiebreak, run_flat
    from repro_torch.core.multilinear import min_outgoing_coo

    g = cpu_graph(random_graph(256, 1024, seed=7))
    rep, events = _traced_flat(g, pack=pack)
    attrs = _solve_span(events, "solve.flat")
    by_site = attrs["host_syncs_by_site"]
    assert attrs["host_syncs"] == sum(by_site.values())
    rounds = rep.iterations
    anys = 1  # the final complete_shortcut of a star forest
    for k in range(rounds):
        p = run_flat(g, max_iters=k).parent
        r = min_outgoing_coo(p, g.src, g.dst, g.w, g.eid, g.valid, g.n)
        anys += sc.count_shortcut_subiters(hook_and_tiebreak(p, r.w, r.eid, r.payload[0])[0])[1] + 1
    want = {"record_edges.nonzero": rounds, "shortcut.any": anys, "msf.done": rounds,
            "msf.iterations": 1, "report.scalars": 1, "report.arrays": 1}
    if pack:
        want["min_outgoing.winners"] = rounds
    assert by_site == want
    assert attrs["host_syncs"] == rounds * (2 + pack) + anys + 1 + 2


def test_host_sync_tally_of_csp_and_paper_rounds():
    g = cpu_graph(random_graph(256, 1024, seed=7))
    rep, events = _traced_flat(g, shortcut="csp")
    by_site = _solve_span(events, "solve.flat")["host_syncs_by_site"]
    assert by_site["shortcut.overflow"] == rep.iterations == by_site["msf.done"]
    assert by_site["shortcut.compress_any"] >= rep.iterations
    rep, events = _traced_flat(g, variant="paper")
    by_site = _solve_span(events, "solve.flat")["host_syncs_by_site"]
    assert by_site["starcheck.mask"] == 2 * rep.iterations  # top of round, then of p_h
    assert "shortcut.any" in by_site  # the canonical labels after the loop


@pytest.mark.parametrize("fused", [True, False])
def test_host_sync_tally_of_a_coarsen_solve(fused):
    """The coarsen solve's sites pinned to its levels and rounds: the
    canonical edge set, K record nonzeros per level, the level loop's
    scalar reads, the host dedupe's copies (the CPU's default), the
    residual's rounds and reads, the final labels and the report."""
    g = cpu_graph(random_graph(512, 2048, seed=11))
    tobs.reset()
    tsolve.clear_plan_cache()
    cfg = TCoarsenConfig(cutoff=32, rounds_per_level=2, fused=fused)
    rep = tsolve.plan(g, tsolve.SolveSpec(mode="coarsen", obs="trace", coarsen=cfg)).solve()
    events = tobs.trace_events()
    attrs = _solve_span(events, "solve.coarsen")
    by_site = attrs["host_syncs_by_site"]
    assert attrs["host_syncs"] == sum(by_site.values())
    levels = len(rep.levels)
    spans = sum(e[0] == "coarsen.level" for e in events)
    rounds = sum(e[0] == "msf.round" for e in events)
    assert levels > 0 and rounds > 0
    filtered = spans if fused else levels  # the fused level filters even without progress
    assert by_site["coarsen.canonical"] == by_site["coarsen.eid_capacity"] == 1
    assert by_site["record_edges.nonzero"] == 2 * spans + rounds
    assert by_site["msf.done"] == rounds
    # n_next on every level; then n_msf_edges, weight and (fused) m_new when it progressed
    assert by_site["coarsen.level_scalars"] == spans + (3 if fused else 2) * levels
    assert by_site["filter_host.to_host"] == 6 * filtered
    assert by_site["filter_host.to_device"] == (5 if fused else 4) * filtered
    assert by_site["coarsen.residual_scalars"] == by_site["coarsen.finalize"] == 3
    assert by_site["labels.mask"] == 2
    assert by_site["report.scalars"] == 1 and by_site["report.arrays"] == 1


@pytest.mark.parametrize("mode", ["off", "metrics"])
def test_tally_and_port_spans_only_in_trace_mode(mode):
    """Off and metrics: host_sync counts nothing, no solve span carries a
    tally, and no port-only span is recorded."""
    g = cpu_graph(random_graph(256, 1024, seed=7))
    tobs.enable(mode)
    with ttrace.collect_syncs() as syncs:
        rep = tsolve.plan(g, tsolve.SolveSpec(mode="coarsen",
                                              coarsen=TCoarsenConfig(cutoff=32))).solve()
        ttrace.host_sync("anything")
    assert syncs == {} and tobs.trace_events() == []
    assert not set(rep.timings) & PORT_ONLY


@pytest.mark.parametrize("spec", sorted(FLAT_SPECS))
def test_trace_only_counts_lie_outside_the_phase_spans(spec):
    """The outgoing count is the instrument's own work: its msf.counts span
    starts after msf.min_outgoing ends and ends before msf.hook starts, so
    no phase span times it."""
    _, events = _traced_flat(cpu_graph(random_graph(256, 1024, seed=7)), **FLAT_SPECS[spec])
    spans = sorted((e for e in events if e[0] in ROUND_SPANS), key=lambda e: e[1])
    for k, ev in enumerate(spans):
        if ev[0] == "msf.counts":
            before, after = spans[k - 1], spans[k + 1]
            assert (before[0], after[0]) == ("msf.min_outgoing", "msf.hook")
            assert before[1] + before[2] <= ev[1] and ev[1] + ev[2] <= after[1]
        else:
            assert ev[4] is None, ev  # the phase spans carry no count


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("req"):
            fn()
    return list(prof.events())


SPAN_NAMES = {"plan.resolve", "solve.flat", "msf.flat", "msf.round", *PORT_ONLY}


@pytest.mark.parametrize("mode", MODES)
def test_spans_open_profiler_ranges_only_in_trace_mode(mode):
    """Under torch.profiler, trace mode opens a record_function range per
    span, nested as the spans are; off and metrics open none."""
    g = cpu_graph(random_graph(256, 1024, seed=7))
    tsolve.clear_plan_cache()
    events = _profiled(lambda: tsolve.plan(g, tsolve.SolveSpec(obs=mode)).solve())
    ranges = [e for e in events if e.name in SPAN_NAMES]
    if mode != "trace":
        assert ranges == []
        return
    assert {e.name for e in ranges} == SPAN_NAMES
    (solve,) = [e for e in ranges if e.name == "solve.flat"]
    rounds = [e for e in ranges if e.name == "msf.round"]
    assert len(rounds) == sum(e[0] == "msf.round" for e in tobs.trace_events())
    for e in ranges:
        if e.name != "plan.resolve":
            assert solve.time_range.start <= e.time_range.start
            assert e.time_range.end <= solve.time_range.end


def test_devtrace_labels_an_idle_gap_with_a_program_span():
    """msfbench's reduction lays host time outside any operation at the
    door of the innermost program span open on the host."""
    import time

    sys.path.insert(0, str(ROOT))
    try:
        from msfbench import devtrace
    finally:
        sys.path.remove(str(ROOT))
    tobs.enable("trace")

    def work():
        with tobs.span("probe.outer"):
            torch.ones(8).sum()
            with tobs.span("probe.wait"):
                time.sleep(0.05)

    prof = devtrace.reduce_events(_profiled(work), "req")
    assert prof.idle_gaps[0][0] == "probe.wait"


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1001])
def test_round_statistics_helpers(n):
    """count_true, the trace-only count of a round's outgoing edges, against
    plain torch, on a whole mask and on a view that starts mid-word."""
    from repro_torch.core.msf import count_true

    g = torch.Generator().manual_seed(n)
    mask = torch.rand(n + 8, generator=g) < 0.4
    assert int(count_true(mask[:n])) == int(mask[:n].sum())
    assert int(count_true(mask[8:])) == int(mask[8:].sum())
    if n > 1:
        with pytest.raises(RuntimeError):
            count_true(mask[1:])
