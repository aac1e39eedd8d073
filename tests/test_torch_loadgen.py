"""``repro_torch.launch.loadgen`` against ``repro.launch.loadgen`` on the
CPU: the same Poisson schedule bit for bit, ``slo-report/v1`` documents
with the reference's blocks and keys (``env`` aside) that pass
``tools/check_slo_report.py``, in process and over TCP against
``repro_torch.serve``; a missed SLO, or a writer that fails, exits
non-zero; ``serve_graph --loadgen`` reaches it."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.launch import loadgen as jload  # noqa: E402
from repro.launch import serve_graph as jsg  # noqa: E402
from repro.solve import SolveSpec as JSpec  # noqa: E402
from repro.solve import plan as jplan  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.launch import loadgen as tload  # noqa: E402
from repro_torch.launch import serve_graph as tsg  # noqa: E402
from repro_torch.solve import SolveSpec as TSpec  # noqa: E402
from repro_torch.solve import plan as tplan  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SCALE, BATCH = 8, 256
# lenient targets: these runs check the mechanism, not the machine's speed
LENIENT = ["--slo-p50-ms", "5000", "--slo-p99-ms", "20000", "--max-drop-frac", "0.9",
           "--min-qps-frac", "0.01"]
RUN = ["--qps", "120", "--duration", "1.0", "--scale", str(SCALE), "--micro-batch", "32",
       "--writer-batch", str(BATCH), "--seed", "0"]
# blocks whose counters depend on what happened in the run
RUN_DEPENDENT = ("env", "batcher", "server")


@pytest.fixture(autouse=True)
def _clean_obs():
    """A run enables metrics for its whole process: start and end every
    test with both packages' obs off and empty."""
    for o in (jobs, tobs):
        o.disable()
        o.reset()
        o.metrics_reset()
    yield
    for o in (jobs, tobs):
        o.disable()
        o.reset()
        o.metrics_reset()


def _check_slo(path, tcp=False):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import check_slo_report
    finally:
        sys.path.pop(0)
    return check_slo_report.check_report(str(path), tcp=tcp)


def _keys(doc, skip=RUN_DEPENDENT, prefix=""):
    """Every key path of a report, below the run-dependent blocks' names."""
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in skip:
            out |= _keys(v, (), prefix + k + ".")
    return out


@pytest.mark.parametrize("seed,qps,duration", [(0, 200.0, 5.0), (1, 120.0, 1.5),
                                               (7, 1e4, 10.0), (3, 0.5, 2.0)])
def test_arrival_schedule_is_the_reference_schedule(seed, qps, duration):
    want = jload._arrival_schedule(np.random.default_rng(seed), qps, duration)
    got = tload._arrival_schedule(np.random.default_rng(seed), qps, duration)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_parser_is_the_reference_parser_plus_device():
    want = vars(jload.build_parser().parse_args([]))
    got = vars(tload.build_parser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


def _run_both(tmp_path, extra=()):
    outs = {}
    for name, mod, dev in (("ref", jload, []), ("port", tload, ["--device", "cpu"])):
        out = tmp_path / f"{name}.json"
        try:
            rc = mod.main(RUN + LENIENT + list(extra) + dev + ["--out", str(out)])
        finally:
            for o in (jobs, tobs):
                o.disable()
                o.metrics_reset()
        outs[name] = (rc, json.loads(out.read_text()), out)
    return outs


def test_in_process_report_matches_reference_shape(tmp_path):
    outs = _run_both(tmp_path)
    (rc_ref, ref, _), (rc, got, path) = outs["ref"], outs["port"]
    assert rc_ref == rc == 0
    assert _check_slo(path) is None
    assert _keys(got) == _keys(ref)
    assert got["config"] == ref["config"]
    assert got["env"]["backend"] == "cpu" and "torch" in got["env"]
    q = got["queries"]
    assert q["answered"] > 0 and q["offered"] >= q["answered"] + q["dropped"]
    assert q["offered"] == ref["queries"]["offered"]  # the same schedule
    lat = got["latency_ms"]
    assert lat["count"] == q["answered"] and lat["p99"] >= lat["p95"] >= lat["p50"] > 0.0
    assert got["writer"]["updates"] > 0 and got["writer"]["snapshot_version"] > 0
    assert got["batcher"].get("flush", 0) > 0 and "queue_depth" in got["batcher"]
    assert got["slo"]["passed"] and got["slo"]["failures"] == []


def test_in_process_run_deletes_and_exits_nonzero_on_missed_slo(tmp_path):
    out = tmp_path / "fail.json"
    rc = tload.main(RUN + ["--device", "cpu", "--delete-frac", "0.5", "--slo-p50-ms",
                           "0.000001", "--out", str(out)])
    assert rc == 1
    d = json.loads(out.read_text())
    assert _check_slo(out) is None
    assert not d["slo"]["passed"] and any("p50" in f for f in d["slo"]["failures"])
    assert d["writer"]["deletes"] > 0 and d["writer"]["edges_deleted"] > 0


def test_writer_failure_fails_the_run(tmp_path, monkeypatch):
    """An update that raises on the writer thread (after the warm-up on the
    main thread) fails the run instead of ending the writer silently."""
    import threading

    from repro_torch.solve.planner import Plan

    update = Plan.update

    def broken(self, u, v, w):
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("no room")
        return update(self, u, v, w)

    monkeypatch.setattr(Plan, "update", broken)
    out = tmp_path / "broken.json"
    rc = tload.main(RUN + LENIENT + ["--device", "cpu", "--delete-frac", "0",
                                     "--out", str(out)])
    assert rc == 1
    fails = json.loads(out.read_text())["slo"]["failures"]
    assert any(f.startswith("writer failed: RuntimeError: no room") for f in fails)


def _warm_stream(pkg):
    """A stream plan warmed with the first quarter of the edge stream, as
    ``serve_graph --serve`` warms one."""
    if pkg == "ref":
        p, (lo, hi, w) = jplan(1 << SCALE, JSpec(mode="stream", batch_capacity=BATCH)), \
            jsg.edge_stream(SCALE, 8, 0)
    else:
        p = tplan(1 << SCALE, TSpec(mode="stream", batch_capacity=BATCH), device="cpu")
        lo, hi, w = tsg.edge_stream(SCALE, 8, 0)
    warm = int(len(lo) * 0.25)
    for at in range(0, warm, BATCH):
        end = min(at + BATCH, warm)
        p.update(lo[at:end], hi[at:end], w[at:end])
    return p


def _tcp_run(pkg, tmp_path, extra=()):
    serve_mod, load_mod = (jserve, jload) if pkg == "ref" else (tserve, tload)
    handle = serve_mod.start_in_thread(_warm_stream(pkg), serve_mod.ServeConfig(port=0))
    out = tmp_path / f"{pkg}_tcp.json"
    try:
        rc = load_mod.main(["--target", handle.address, "--qps", "150", "--duration", "1.0",
                            "--scale", str(SCALE), "--writer-batch", str(BATCH),
                            "--out", str(out)] + list(extra))
    finally:
        handle.drain()
    return rc, json.loads(out.read_text()), out


def test_tcp_report_matches_reference_shape(tmp_path):
    rc_ref, ref, _ = _tcp_run("ref", tmp_path)
    rc, got, path = _tcp_run("port", tmp_path)
    assert rc_ref == rc == 0
    assert _check_slo(path, tcp=True) is None
    assert _keys(got) == _keys(ref)
    assert sorted(got["server"]) == sorted(ref["server"]) == ["metrics", "status", "target"]
    assert sorted(got["server"]["metrics"]) == ["counters", "histograms"]
    assert got["server"]["metrics"]["counters"]["serve.queries"] == got["queries"]["answered"]
    assert got["writer"]["updates"] > 0 and got["writer"]["write_rejected"] == 0
    assert got["slo"]["passed"]


def test_tcp_run_exits_nonzero_on_missed_slo(tmp_path):
    rc, got, path = _tcp_run("port", tmp_path, ["--slo-p99-ms", "0.000001"])
    assert rc == 1 and _check_slo(path, tcp=True) is None
    assert any("p99" in f for f in got["slo"]["failures"])


def test_serve_graph_loadgen_reaches_the_harness(tmp_path):
    out = tmp_path / "sg.json"
    with pytest.raises(SystemExit) as exc:
        tsg.main(["--loadgen"] + RUN + LENIENT + ["--device", "cpu", "--out", str(out)])
    assert exc.value.code == 0 and _check_slo(out) is None
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_graph", "--loadgen", *RUN,
         "--duration", "0.5", "--device", "cpu", "--slo-p50-ms", "0.000001"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and "SLO: FAIL" in proc.stdout, proc.stderr
