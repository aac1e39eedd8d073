"""``repro_torch.serve`` against ``repro.serve`` on the CPU: the
``serve/v1`` codec byte for byte; both servers over loopback fed the same
request frames give the same responses (``uptime_s`` and histogram values
aside) — error codes, pipelined batches, drain; writer churn with
concurrent readers on the port's server against a recompute at every
answered version; drain checkpoints crossing between the packages; and
``repro_torch.launch.serve_graph`` in replay and ``--serve`` mode."""
import contextlib
import os
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.serve import protocol as JP  # noqa: E402
from repro.solve import SolveSpec as JSpec  # noqa: E402
from repro.solve import plan as jplan  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.serve import protocol as TP  # noqa: E402
from repro_torch.solve import SolveSpec as TSpec  # noqa: E402
from repro_torch.solve import plan as tplan  # noqa: E402
from repro_torch.stream import persist as tpersist  # noqa: E402
from test_msf_properties import _SurvivorOracle  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SPEC = dict(mode="stream", batch_capacity=256, reservoir_capacity=8192,
            reservoir_per_component=8192)
TIMEOUT = 60


@pytest.fixture(autouse=True)
def _clean_obs():
    """A server enables metrics for its whole process: start and end every
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


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

_OBJS = [
    {"schema": "serve/v1", "id": 1, "op": "connected", "u": [0, 5], "v": [3, 2],
     "deadline_ms": 250},
    {"schema": "serve/v1", "id": "x", "op": "insert", "u": [1], "v": [2], "w": [0.5]},
    {"op": "status", "id": None, "nested": {"é": [True, None, 1.25e-7]}},
    {},
]


def test_constants_match_the_reference():
    for name in ("SCHEMA", "HEADER_SIZE", "MAX_PAYLOAD", "QUERY_OPS", "WRITE_OPS", "ADMIN_OPS",
                 "OPS"):
        assert getattr(TP, name) == getattr(JP, name), name
    assert TP.HEADER.format == JP.HEADER.format
    assert TP._OP_FIELDS == JP._OP_FIELDS


@pytest.mark.parametrize("i", range(len(_OBJS)))
def test_frames_are_byte_identical(i):
    obj = _OBJS[i]
    assert TP.encode_frame(obj) == JP.encode_frame(obj)
    r = dict(snapshot_version=9, stale=True, n_unhealed=2)
    assert TP.response(obj.get("id"), "connected", {"connected": [True]}, **r) == JP.response(
        obj.get("id"), "connected", {"connected": [True]}, **r)
    assert TP.error_response(None, "insert", "overloaded", "full", **r) == \
        JP.error_response(None, "insert", "overloaded", "full", **r)
    blob = b"".join(TP.encode_frame(o) for o in _OBJS)
    assert list(TP.iter_frames(blob)) == list(JP.iter_frames(blob)) == _OBJS


def test_decoders_agree_on_fuzz():
    rng = np.random.default_rng(7)
    good = b"".join(TP.encode_frame(o) for o in _OBJS)
    for trial in range(60):
        noise = rng.integers(0, 256, size=int(rng.integers(1, 300))).astype(np.uint8).tobytes()
        blob = good[: int(rng.integers(0, len(good)))] + noise
        outs = []
        for P in (JP, TP):
            dec, items = P.FrameDecoder(max_payload=1 << 12), []
            try:
                for at in range(0, len(blob), 7):
                    items.extend(dec.feed(blob[at:at + 7]))
                end = ("ok", dec.pending_bytes)
            except P.ProtocolError as e:
                end = (e.code, e.recoverable)
            outs.append(([x if isinstance(x, dict) else (x.code, str(x)) for x in items], end))
        assert outs[0] == outs[1], trial


@pytest.mark.parametrize("obj", [
    {}, {"op": 7}, {"op": "frobnicate"}, {"op": "connected", "u": [0]},
    {"op": "connected", "u": [0], "v": [1, 2]}, {"op": "connected", "u": "xy", "v": "ab"},
    {"op": "connected", "u": [0.5], "v": [1]}, {"op": "insert", "u": [0], "v": [1]},
    {"op": "connected", "u": [0], "v": [1], "deadline_ms": -1},
    {"op": "connected", "u": [0], "v": [1], "id": []},
    {"op": "connected", "u": [True], "v": [1]},
    {"op": "insert", "u": [0], "v": [1], "w": [2], "deadline_ms": 3},
])
def test_validate_request_matches_the_reference(obj):
    got = want = None
    try:
        want = ("ok", *JP.validate_request(obj))
    except JP.ProtocolError as e:
        want = (e.code, str(e))
    try:
        got = ("ok", *TP.validate_request(obj))
    except TP.ProtocolError as e:
        got = (e.code, str(e))
    assert got == want


def test_parse_target():
    assert tserve.parse_target("tcp://127.0.0.1:9012") == ("127.0.0.1", 9012)
    assert tserve.parse_target(":77") == ("127.0.0.1", 77)
    with pytest.raises(ValueError):
        tserve.parse_target("tcp://host")


# ---------------------------------------------------------------------------
# both servers, the same frames
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _both(n=128, **cfg):
    """A reference and a port server over fresh stream plans of ``n``."""
    config = dict(port=0, micro_batch=64, queue_cap=256, **cfg)
    jp = jplan(n, JSpec(**SPEC))
    tp = tplan(n, TSpec(**SPEC), device="cpu")
    jh = jserve.start_in_thread(jp, jserve.ServeConfig(**config))
    try:
        th = tserve.start_in_thread(tp, tserve.ServeConfig(**config))
        try:
            yield (jh, jp), (th, tp)
        finally:
            th.drain(timeout=TIMEOUT)
    finally:
        jh.drain(timeout=TIMEOUT)


class _Wire:
    """A raw loopback connection: send frames, read response objects."""

    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
        self.dec = TP.FrameDecoder()
        self.buf = []

    def send(self, data: bytes, expect: int = 1) -> list:
        self.sock.sendall(data)
        while len(self.buf) < expect:
            data = self.sock.recv(1 << 16)
            assert data, "server closed the connection"
            self.buf.extend(self.dec.feed(data))
        out, self.buf = self.buf[:expect], self.buf[expect:]
        return out

    def close(self):
        self.sock.close()


def _frame(i, op, **fields):
    return TP.encode_frame({"schema": TP.SCHEMA, "id": i, "op": op, **fields})


def _normalized(resp, *, histogram_counts=True):
    """A response without its timing fields: ``uptime_s``, and histogram
    values (their names, and optionally their counts, kept)."""
    resp = dict(resp)
    res = resp.get("result")
    if isinstance(res, dict):
        res = dict(res)
        res.pop("uptime_s", None)
        if "metrics" in res:
            m = dict(res["metrics"])
            m["histograms"] = {k: (v["count"] if histogram_counts else None)
                               for k, v in m["histograms"].items()}
            res["metrics"] = m
        resp["result"] = res
    return resp


def _exchange_both(servers, frames):
    """Send each (frame, expected responses) to both servers in turn, one
    at a time; returns both response lists."""
    out = []
    for handle, _ in servers:
        w = _Wire(handle.port)
        try:
            out.append([r for data, k in frames for r in w.send(data, k)])
        finally:
            w.close()
    return out


def _whitebox(servers, **attrs):
    for handle, _ in servers:
        for k, v in attrs.items():
            setattr(handle.server, k, v)


def test_servers_answer_the_same_frames_alike():
    with _both() as servers:
        frames = [
            (_frame(1, "insert", u=[0, 1, 2], v=[1, 2, 3], w=[1.0, 2.0, 3.0]), 1),
            (_frame(2, "connected", u=[0, 0], v=[3, 5]), 1),
            (_frame(3, "component_size", u=[0]), 1),
            (_frame(4, "component_id", u=[0, 1, 5]), 1),
            (_frame(5, "delete", u=[1], v=[2]), 1),
            (_frame(6, "connected", u=[0], v=[3]), 1),
            (_frame(7, "frobnicate", u=[1]), 1),
            (_frame(8, "connected", u=[0], v=[128]), 1),
            (_frame(9, "connected", u=[], v=[]), 1),
            (_frame(10, "connected", u=[0], v=[1], deadline_ms=1e-4), 1),
            (_frame(11, "insert", u=[0], v=[1]), 1),
            (TP.HEADER.pack(12) + b"{not json!!}", 1),
            (_frame(12, "insert", u=list(range(0, 120)) * 5, v=list(range(1, 121)) * 5,
                    w=[float(x % 17 + 1) for x in range(600)]), 1),
            (_frame(13, "delete", u=[0, 5, 9, 200], v=[1, 6, 10, 3]), 1),
            (_frame(14, "component_size", u=list(range(0, 128, 3))), 1),
            (_frame(15, "status"), 1),
        ]
        want, got = _exchange_both(servers, frames)
        assert [_normalized(r) for r in got] == [_normalized(r) for r in want]
        codes = [r["error"]["code"] for r in got if not r["ok"]]
        # the delete names vertex 200 of 128: the engine raises, in-band
        assert codes == ["unknown_op", "bad_request", "bad_request", "deadline", "bad_request",
                         "bad_frame", "internal"]
        _whitebox(servers, _admitted_points=256)
        want, got = _exchange_both(servers, [(_frame(16, "connected", u=[0], v=[1]), 1)])
        _whitebox(servers, _admitted_points=0)
        assert got == want and got[0]["error"]["code"] == "overloaded"
        _whitebox(servers, _draining=True)
        try:
            want, got = _exchange_both(servers, [(_frame(17, "connected", u=[0], v=[1]), 1),
                                                 (_frame(18, "insert", u=[0], v=[1], w=[1.0]), 1),
                                                 (_frame(19, "status"), 1)])
        finally:
            _whitebox(servers, _draining=False)
        assert [_normalized(r) for r in got] == [_normalized(r) for r in want]
        assert got[2]["result"]["status"] == "draining"
        want, got = _exchange_both(servers, [(_frame(20, "metrics"), 1)])
        assert _normalized(got[0]) == _normalized(want[0])
        counters = got[0]["result"]["metrics"]["counters"]
        assert counters["serve.writes"] == 3 and counters["serve.errors.bad_request"] == 3


def test_pipelined_batches_answer_alike():
    with _both() as servers:
        setup = [(_frame(0, "insert", u=[0, 2, 4], v=[1, 3, 5], w=[1.0, 1.0, 2.0]), 1)]
        _exchange_both(servers, setup)
        blob = b"".join(
            _frame(i, ("connected", "component_id", "component_size")[i % 3], u=[i % 7, 2],
                   **({"v": [i % 5, 3]} if i % 3 == 0 else {}))
            for i in range(1, 97))
        want, got = _exchange_both(servers, [(blob, 96)])
        key = lambda r: r["id"]  # noqa: E731 — the lanes answer by id, not arrival
        assert sorted(got, key=key) == sorted(want, key=key)
        assert all(r["ok"] for r in got)
        want, got = _exchange_both(servers, [(_frame(200, "metrics"), 1)])
        m = got[0]["result"]["metrics"]
        assert m["histograms"]["serve.batch_occupancy"]["max"] > 1.0  # fused
        assert _normalized(got[0], histogram_counts=False) == _normalized(
            want[0], histogram_counts=False)


def test_garbage_then_oversize_closes_only_that_connection():
    with _both() as servers:
        for handle, _ in servers:
            w = _Wire(handle.port)
            got = w.send(TP.HEADER.pack(12) + b"{not json!!}"
                         + _frame(1, "status"), 2)
            assert got[0]["error"]["code"] == "bad_frame" and got[1]["ok"]
            w.sock.sendall(TP.HEADER.pack(TP.MAX_PAYLOAD + 1))
            tail = b""
            while data := w.sock.recv(1 << 16):
                tail += data
            assert TP.FrameDecoder().feed(tail)[-1]["error"]["code"] == "too_large"
            w.close()
            with tserve.ServeClient(handle.address, timeout=TIMEOUT) as c:
                assert c.status(check=True)["result"]["status"] == "serving"


def test_client_surfaces_errors_and_drain_refuses_connections():
    p = tplan(64, TSpec(**SPEC), device="cpu")
    h = tserve.start_in_thread(p, tserve.ServeConfig(port=0))
    try:
        with tserve.ServeClient(h.address, timeout=TIMEOUT) as c:
            assert c.insert(np.array([0]), np.array([1]), np.array([1.0], np.float32))["ok"]
            with pytest.raises(tserve.ServeError) as ei:
                c.connected([0], [999], check=True)
            assert ei.value.code == "bad_request"
    finally:
        h.drain(timeout=TIMEOUT)
    assert h.server.draining
    with pytest.raises((ConnectionError, OSError)):
        tserve.ServeClient(h.address, timeout=2)


def test_fused_batch_stays_within_the_service_limit():
    """Queued queries whose points pass ``QueryService.max_batch`` together
    go to separate flushes. (The reference fuses them into one batch, its
    service raises, and its batcher task dies: every later query waits.)"""
    p = tplan(128, TSpec(**SPEC), device="cpu")
    h = tserve.start_in_thread(p, tserve.ServeConfig(port=0, micro_batch=256, queue_cap=1 << 16))
    try:
        with tserve.ServeClient(h.address, timeout=TIMEOUT) as c:
            c.insert([0], [1], [1.0])
            k = p.service.max_batch
            futs = [c.submit("connected", u=[0] * 200, v=[1] * 200),
                    c.submit("connected", u=[0] * k, v=[1] * k)]
            got = [f.result(timeout=TIMEOUT) for f in futs]
            assert [r["ok"] for r in got] == [True, True]
            assert got[1]["result"]["connected"] == [True] * k
            assert c.connected([0], [1])["ok"]
    finally:
        h.drain(timeout=TIMEOUT)


# ---------------------------------------------------------------------------
# concurrency: answers match a recompute at the response's version
# ---------------------------------------------------------------------------


def test_concurrent_readers_during_writer_churn():
    """Reader connections hammer ``connected`` while the writer lane
    churns inserts and deletes on the port's server: every response's
    version is monotone per connection, and every answer at a version a
    completed write published matches the survivor recompute there."""
    n = 64
    p = tplan(n, TSpec(**SPEC), device="cpu")
    oracle = _SurvivorOracle(n)
    handle = tserve.start_in_thread(p, tserve.ServeConfig(port=0, micro_batch=32, queue_cap=512))
    partitions, observations, errors = {}, [], []
    stop = threading.Event()

    def writer():
        rng = np.random.default_rng(23)
        try:
            with tserve.ServeClient(handle.address, timeout=TIMEOUT) as wc:
                while not stop.is_set():
                    if rng.random() < 0.65 or not oracle.edges:
                        m = int(rng.integers(1, 10))
                        u, v = rng.integers(0, n, (2, m))
                        w = rng.integers(1, 50, m).astype(np.float64)
                        r = wc.insert(u, v, w)
                        oracle.insert(u, v, w)
                    else:
                        ks = list(oracle.edges)
                        pick = rng.choice(len(ks), size=min(3, len(ks)), replace=False)
                        uu = np.array([ks[i][0] for i in pick])
                        vv = np.array([ks[i][1] for i in pick])
                        r = wc.delete(uu, vv)
                        oracle.delete(uu, vv)
                    assert r["ok"], r
                    partitions[r["result"]["version"]] = oracle.recompute()[2]
        except Exception as e:  # surfaced below
            errors.append(e)

    def reader(seed):
        rng = np.random.default_rng(seed)
        try:
            with tserve.ServeClient(handle.address, timeout=TIMEOUT) as rc:
                last = -1
                for _ in range(60):
                    u, v = (int(x) for x in rng.integers(0, n, 2))
                    r = rc.connected([u], [v])
                    assert r["ok"] and r["snapshot_version"] >= last, (r, last)
                    last = r["snapshot_version"]
                    observations.append((last, u, v, r["result"]["connected"][0]))
        except Exception as e:  # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        wt = threading.Thread(target=writer)
        readers = [threading.Thread(target=reader, args=(100 + i,)) for i in range(3)]
        wt.start()
        for t in readers:
            t.start()
        for t in readers:
            t.join(timeout=TIMEOUT)
        stop.set()
        wt.join(timeout=TIMEOUT)
        assert not wt.is_alive() and not any(t.is_alive() for t in readers)
    finally:
        sys.setswitchinterval(old)
        handle.drain(timeout=TIMEOUT)
    assert not errors, errors
    checked = 0
    for ver, u, v, ans in observations:
        if ver in partitions:
            assert ans == bool(partitions[ver][u] == partitions[ver][v]), (ver, u, v)
            checked += 1
    assert checked > 0


# ---------------------------------------------------------------------------
# graceful drain + restart across packages
# ---------------------------------------------------------------------------

_PKG = {
    "reference": (jserve, lambda n: jplan(n, JSpec(**SPEC))),
    "port": (tserve, lambda n: tplan(n, TSpec(**SPEC), device="cpu")),
}


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference"),
                                           ("port", "port")])
def test_drain_checkpoint_warm_starts_the_other_server(tmp_path, writer, reader):
    ckpt, n = str(tmp_path / "ckpt"), 96
    ws, wplan = _PKG[writer]
    p1 = wplan(n)
    h1 = ws.start_in_thread(p1, ws.ServeConfig(port=0, checkpoint_dir=ckpt))
    rng = np.random.default_rng(5)
    try:
        with tserve.ServeClient(h1.address, timeout=TIMEOUT) as c:
            for _ in range(6):
                u, v = rng.integers(0, n, (2, 24))
                assert c.insert(u, v, rng.integers(1, 99, 24).astype(np.float64))["ok"]
            flo, fhi, _, _ = p1.engine.forest_edges()
            assert c.delete(flo[:4], fhi[:4])["ok"]
            v_final = c.status(check=True)["snapshot_version"]
    finally:
        h1.drain(timeout=TIMEOUT)
    qu, qv = rng.integers(0, n, (2, 32))
    want = np.asarray(p1.service.connected(qu, qv)).tolist()

    rs, rplan = _PKG[reader]
    p2 = rplan(n)
    h2 = rs.start_in_thread(p2, rs.ServeConfig(port=0, checkpoint_dir=ckpt))
    try:
        assert h2.server.restored_version == v_final
        assert p2.engine.weight == p1.engine.weight  # bit-identical, not approx
        assert sorted(int(g) for g in p2.engine.forest_gids()) == sorted(
            int(g) for g in p1.engine.forest_gids())
        with tserve.ServeClient(h2.address, timeout=TIMEOUT) as c:
            st = c.status(check=True)
            assert st["snapshot_version"] == v_final == st["result"]["restored_version"]
            assert c.connected(qu, qv)["result"]["connected"] == want
            r = c.insert([0, 1], [1, 2], [0.5, 0.25])
            assert r["ok"] and r["result"]["version"] == v_final + 1
    finally:
        h2.drain(timeout=TIMEOUT)


class _HeldService:
    """``QueryService`` stand-in whose answers wait for ``go``."""

    def __init__(self, service, entered, go):
        self._service, self._entered, self._go = service, entered, go

    def __getattr__(self, name):
        return getattr(self._service, name)

    def answer(self, u, v):
        self._entered.set()
        assert self._go.wait(TIMEOUT)
        return self._service.answer(u, v)


@pytest.mark.parametrize("drain_timeout_s", [10.0, 0.05])
def test_drain_answers_the_batch_and_write_in_flight(tmp_path, drain_timeout_s):
    """drain() while a query batch and a write are on their threads, one more
    of each queued: the two in flight are answered and the write is in the
    drain checkpoint; the queued ones are answered too, or refused with
    ``draining`` once the drain timeout has passed. (The reference cancels
    the ops in flight unanswered and drops a queued write.)"""
    ckpt, n = str(tmp_path / "ckpt"), 64
    p = tplan(n, TSpec(**SPEC), device="cpu")
    h = tserve.start_in_thread(p, tserve.ServeConfig(
        port=0, checkpoint_dir=ckpt, drain_timeout_s=drain_timeout_s))
    srv = h.server
    q_in, w_in, go = threading.Event(), threading.Event(), threading.Event()
    srv.service = _HeldService(srv.service, q_in, go)
    apply_write = srv._apply_write

    def held_write(op, fields):
        w_in.set()
        assert go.wait(TIMEOUT)
        return apply_write(op, fields)

    srv._apply_write = held_write
    drainer = threading.Thread(target=h.drain, kwargs=dict(timeout=TIMEOUT))
    try:
        with tserve.ServeClient(h.address, timeout=TIMEOUT) as c:
            q1 = c.submit("connected", u=[0], v=[1])
            w1 = c.submit("insert", u=[0], v=[1], w=[1.5])
            assert q_in.wait(TIMEOUT) and w_in.wait(TIMEOUT)
            q2 = c.submit("component_size", u=[1])
            w2 = c.submit("insert", u=[1], v=[2], w=[2.5])
            st = c.status(check=True)["result"]
            assert st["queue_depth"] == 1 and st["write_queue_depth"] == 1
            drainer.start()
            while not srv.draining:
                threading.Event().wait(0.005)
            threading.Event().wait(0.2)  # past the short drain timeout
            go.set()
            got = [f.result(timeout=TIMEOUT) for f in (q1, w1, q2, w2)]
            drainer.join(TIMEOUT)
    finally:
        go.set()
        if not drainer.is_alive() and not srv.draining:
            h.drain(timeout=TIMEOUT)
    assert not drainer.is_alive()
    assert got[0]["ok"] and got[1]["ok"]
    assert got[1]["result"]["version"] == 1
    if drain_timeout_s > 1:
        assert got[2]["ok"] and got[3]["ok"]
        # vertex 1's component at the version the answer names
        assert got[2]["result"]["size"] == [[1, 2, 3][got[2]["snapshot_version"]]]
    else:
        assert [r["error"]["code"] for r in got[2:]] == ["draining", "draining"]
    saved = tplan(n, TSpec(**SPEC), device="cpu")
    version = tpersist.restore_stream(ckpt, saved.engine)
    assert version == p.engine.version == (2 if drain_timeout_s > 1 else 1)
    assert saved.engine.weight == p.engine.weight


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_edge_stream_is_the_reference_stream():
    from repro.launch import serve_graph as jsg
    from repro_torch.launch import serve_graph as tsg

    for a, b in zip(jsg.edge_stream(9, 4, 3), tsg.edge_stream(9, 4, 3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


def test_serve_graph_replay_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import serve_graph as tsg

    trace = tmp_path / "trace.json"
    tsg.main(["--scale", "10", "--device", "cpu", "--trace", str(trace)])
    out = capsys.readouterr().out
    assert "-> OK" in out and "device=cpu" in out
    assert trace.exists()
    tsg.main(["--scale", "8", "--device", "cpu", "--delete-every", "2",
              "--metrics-every", "3", "--batch-size", "256"])
    out = capsys.readouterr().out
    assert "# metrics @batch 2: query p50=" in out and "-> OK" not in out


def test_serve_graph_serve_drains_on_sigterm(tmp_path):
    """``--serve`` as a process: the address line, a query, SIGTERM drains
    into a checkpoint and the metrics file; a second process restores."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [sys.executable, "-m", "repro_torch.launch.serve_graph", "--serve", "--scale", "8",
            "--device", "cpu", "--batch-capacity", "256", "--checkpoint-dir",
            str(tmp_path / "ckpt"), "--metrics-out", str(tmp_path / "m.json")]
    versions = []
    for run in range(2):
        proc = subprocess.Popen(args, cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
        try:
            for line in proc.stdout:
                if line.startswith("# serving tcp://"):
                    break
            assert line.startswith("# serving tcp://"), line
            assert ("restored v" in line) == (run == 1)
            with tserve.ServeClient(line.split()[2], timeout=TIMEOUT) as c:
                st = c.status(check=True)
                versions.append((st["snapshot_version"], st["result"]["weight"]))
                assert c.connected([0], [1])["ok"]
            proc.send_signal(signal.SIGTERM)
            rest = proc.communicate(timeout=TIMEOUT)[0]
            assert proc.returncode == 0
            assert f"# drained at v{versions[-1][0]}" in rest
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert versions[0] == versions[1] and versions[0][0] > 0
    assert "serve.requests" in (tmp_path / "m.json").read_text()
