"""``repro_torch.stream`` against ``repro.stream`` on the CPU: the batch
ingestion functions of ``delta`` (both membership-probe paths), the
reservoir, snapshots, the query service and micro-batcher, and seeded
random insert / delete / compact / recertify traces through both
``StreamEngine``s, compared after every operation (version, weight,
forest columns, snapshot, reservoir, every stats field, ``state_dict``).
The stream plans, ``plan(n, SolveSpec(mode="stream"), device="cpu")``,
report the same as the reference's, field by field. Everything is exact:
the engines' weights are float64 sums of identical float32 rows."""
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_util import (  # noqa: E402
    StreamTrace,
    apply_op,
    assert_same_engine,
    assert_same_snapshot,
    assert_same_stream_report,
)
from repro import coarsen as jco  # noqa: E402
from repro import solve as jsolve  # noqa: E402
from repro import stream as jstream  # noqa: E402
from repro.stream import delta as jdelta  # noqa: E402
from repro_torch import coarsen as tco  # noqa: E402
from repro_torch import solve as tsolve  # noqa: E402
from repro_torch import stream as tstream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.stream import delta as tdelta  # noqa: E402

#: the port's segmin requests and the reference's counterparts
JAX_SEGMIN = {"auto": "auto", "torch": "jnp", "sorted": "sorted"}


def _edges(rng, n, m):
    return rng.integers(0, n, m), rng.integers(0, n, m), rng.integers(1, 256, m).astype(float)


# ---------------------------------------------------------------------------
# delta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "scalar", "empty", "all self-loops"])
def test_prepare_batch_matches_reference(case):
    rng = np.random.default_rng(0)
    args = {"random": _edges(rng, 50, 200), "scalar": (3, 5, 1.5), "empty": ([], [], []),
            "all self-loops": ([4, 4, 7], [4, 4, 7], [1.0, 2.0, 3.0])}[case]
    want, got = jdelta.prepare_batch(*args, 50), tdelta.prepare_batch(*args, 50)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
        assert np.asarray(b).dtype == np.asarray(a).dtype


@pytest.mark.parametrize("args", [([0, 1], [1], [1.0, 2.0]), ([0], [50], [1.0]),
                                  ([-1], [2], [1.0])])
def test_prepare_batch_rejects_like_reference(args):
    with pytest.raises(ValueError) as want:
        jdelta.prepare_batch(*args, 50)
    with pytest.raises(ValueError, match=str(want.value).replace("[", r"\[").replace(")", r"\)")):
        tdelta.prepare_batch(*args, 50)


@pytest.mark.parametrize("n", [64, 4096, 70_000])
def test_build_live_index_matches_reference(n):
    rng = np.random.default_rng(n)
    lo, hi, w = tdelta.prepare_batch(*_edges(rng, n, min(n // 2, 200)), n)[:3]
    want = jdelta.build_live_index(lo, hi, w, n, n - 1)
    got = tdelta.build_live_index(lo, hi, w, n, n - 1)
    # the packed keys are the reference's uint32 values, held as int64
    np.testing.assert_array_equal(got[0], want[0].astype(np.int64))
    assert got[0].dtype == np.int64
    for a, b in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(b, a)
        assert b.dtype == a.dtype


@pytest.mark.parametrize("n", [64, 4096, 1 << 16, 70_000])
@pytest.mark.parametrize("live_count", [0, 1, 30])
def test_classify_batch_matches_reference(n, live_count):
    """Both probe paths (packed keys on the device for n <= 2^16, host
    int64 keys above): NEW / DECREASE / DROP and the sorted positions."""
    rng = np.random.default_rng(n + live_count)
    live = tdelta.prepare_batch(*_edges(rng, n, live_count), n)
    keys_j, w_j, _ = jdelta.build_live_index(live.lo, live.hi, live.w, n, n - 1)
    keys_t, w_t, _ = tdelta.build_live_index(live.lo, live.hi, live.w, n, n - 1)
    # a batch of live pairs (cheaper, equal and dearer) and fresh ones
    pick = rng.integers(0, max(live.count, 1), 40) if live.count else np.zeros(0, int)
    u = np.concatenate([live.lo[pick], rng.integers(0, n, 40)])
    v = np.concatenate([live.hi[pick], rng.integers(0, n, 40)])
    w = np.concatenate([live.w[pick] + rng.integers(-1, 2, len(pick)), rng.random(40) * 300])
    pb = tdelta.prepare_batch(u, v, w, n)
    want = jdelta.classify_batch(jdelta.prepare_batch(u, v, w, n), keys_j, w_j, n, 128)
    got = tdelta.classify_batch(pb, keys_t, w_t, n, device="cpu")
    # the engine keeps the packed keys as a tensor on its device
    on_device = torch.as_tensor(keys_t) if n <= tdelta.PACK_LIMIT else keys_t
    got_t = tdelta.classify_batch(pb, on_device, w_t, n, device="cpu")
    for a, b, c in zip(want, got, got_t):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, a)
        assert np.asarray(b).dtype == np.asarray(a).dtype
    assert want.n_new + want.n_decrease + want.n_drop >= pb.count


def test_pack_key_holds_uint32_values():
    lo = np.array([0, 1, 65534, 12345], np.int32)
    hi = np.array([1, 65535, 65535, 54321], np.int32)
    want = np.asarray(jdelta.pack_key_u32(lo, hi))
    np.testing.assert_array_equal(tdelta.pack_key_u32(lo, hi), want.astype(np.int64))
    assert tdelta.KEY_PAD == int(jdelta.KEY_PAD) and tdelta.PACK_LIMIT == jdelta.PACK_LIMIT


def _reservoir_state(r):
    return [np.asarray(x) for x in r.state_dict().values()] + [r._keys_sorted, r._rows_sorted]


@pytest.mark.parametrize("capacity,per_component", [(0, 1), (6, 2), (40, 4), (500, 500)])
def test_reservoir_matches_reference(capacity, per_component):
    n = 60
    rng = np.random.default_rng(capacity)
    rs = [pkg.Reservoir(n, capacity, per_component) for pkg in (jdelta, tdelta)]
    gid = 0
    for step in range(12):
        pb = tdelta.prepare_batch(*_edges(rng, n, 30), n)
        comp = (pb.lo % 7).astype(np.int32)
        gids = np.arange(gid, gid + pb.count, dtype=np.int32)
        gid += pb.count
        outs = [r.absorb(pb.lo, pb.hi, pb.w, gids, comp) for r in rs]
        np.testing.assert_array_equal(outs[1][0], outs[0][0])
        assert outs[1][1] == outs[0][1]
        q = tdelta.prepare_batch(*_edges(rng, n, 20), n)
        np.testing.assert_array_equal(rs[1].lookup(q.lo, q.hi), rs[0].lookup(q.lo, q.hi))
        if step % 3 == 0:
            rows = rs[0].lookup(q.lo, q.hi)
            rows = rows[rows >= 0]
            outs = [r.remove_rows(rows) for r in rs]
        elif step % 3 == 1:
            outs = [r.take_components(np.array([1, 3], np.int32)) for r in rs]
        else:
            canon = (np.arange(n) % 5).astype(np.int32)
            for r in rs:
                r.rebucket(canon)
            outs = [r.edges() for r in rs]
        for a, b in zip(*outs):
            np.testing.assert_array_equal(b, a)
        assert len(rs[1]) == len(rs[0])
        for a, b in zip(*map(_reservoir_state, rs)):
            np.testing.assert_array_equal(b, a)
    state = rs[0].state_dict()
    for r in rs:
        r.clear()
        r.restore_state(state)
    for a, b in zip(*map(_reservoir_state, rs)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("kw,msg", [(dict(capacity=-1, per_component=1), "capacity"),
                                    (dict(capacity=4, per_component=0), "per-component")])
def test_reservoir_rejects_like_reference(kw, msg):
    with pytest.raises(ValueError, match=msg):
        jdelta.Reservoir(10, **kw)
    with pytest.raises(ValueError, match=msg):
        tdelta.Reservoir(10, **kw)
    r = tdelta.Reservoir(10, 4, 1)
    with pytest.raises(ValueError, match="capacity 5"):
        r.restore_state(tdelta.Reservoir(10, 5, 1).state_dict())


# ---------------------------------------------------------------------------
# snapshots and queries
# ---------------------------------------------------------------------------

def _labels(rng, n, k):
    """Canonical labels of a random partition into about k components."""
    root = rng.integers(0, k, n)
    first = {r: i for i, r in reversed(list(enumerate(root.tolist())))}
    return np.array([first[r] for r in root.tolist()], np.int32)


@pytest.mark.parametrize("labels_on", ["host", "tensor"])
def test_make_snapshot_matches_reference(labels_on):
    parent = _labels(np.random.default_rng(1), 300, 17)
    want = jstream.make_snapshot(3, parent, 12.5, 283, stale=True, n_unhealed=2)
    arg = parent if labels_on == "host" else torch.as_tensor(parent)
    got = tstream.make_snapshot(3, arg, 12.5, 283, stale=True, n_unhealed=2, device="cpu")
    assert_same_snapshot(want, got)


def test_snapshot_store_double_buffer():
    store = tstream.SnapshotStore()
    assert store.version == -1
    with pytest.raises(RuntimeError, match="no snapshot"):
        store.acquire()
    a = tstream.make_snapshot(0, np.arange(8), 0.0, 0, device="cpu")
    store.publish(a)
    held = store.acquire()
    store.publish(tstream.make_snapshot(1, np.zeros(8, np.int32), 7.0, 7, device="cpu"))
    assert held is a and store.version == 1 and store.acquire().n_components == 1


def _services(n=300, seed=2, **kw):
    parent = _labels(np.random.default_rng(seed), n, 23)
    js, ts = jstream.SnapshotStore(), tstream.SnapshotStore()
    js.publish(jstream.make_snapshot(5, parent, 1.0, n - 23))
    ts.publish(tstream.make_snapshot(5, parent, 1.0, n - 23, device="cpu"))
    return jstream.QueryService(js, **kw), tstream.QueryService(ts, **kw)


@pytest.mark.parametrize("k", [0, 1, 17, 1000])
def test_query_service_matches_reference(k):
    jq, tq = _services(max_batch=1000)
    rng = np.random.default_rng(k)
    u, v = rng.integers(0, 300, k), rng.integers(0, 300, k)
    want, got = jq.answer(u, v), tq.answer(u, v)
    for f in ("connected", "component", "size"):
        a, b = getattr(want, f), getattr(got, f)
        np.testing.assert_array_equal(b, a)
        assert b.dtype == a.dtype, f
    assert got.snapshot is tq.store.acquire()
    np.testing.assert_array_equal(tq.connected(u, v), jq.connected(u, v))
    np.testing.assert_array_equal(tq.component_id(u), jq.component_id(u))
    np.testing.assert_array_equal(tq.component_size(u), jq.component_size(u))
    assert tq.forest_weight() == jq.forest_weight()
    assert tq.snapshot_version() == jq.snapshot_version()


@pytest.mark.parametrize("u,v,msg", [
    ([[0, 1]], [[1, 2]], "1-d"), ([0, 1], [1], "equal length"), (list(range(9)), list(range(9)),
                                                                   "max_batch=8"),
    ([0, 300], [1, 2], "out of range"), ([-1], [2], "out of range"),
])
def test_query_service_errors_match_reference(u, v, msg):
    jq, tq = _services(max_batch=8)
    with pytest.raises(ValueError, match=msg):
        jq.connected(u, v)
    with pytest.raises(ValueError, match=msg):
        tq.connected(u, v)


def test_microbatcher_matches_reference():
    jq, tq = _services()
    jb, tb = jstream.MicroBatcher(jq, max_queue=5, retain_windows=2), tstream.MicroBatcher(
        tq, max_queue=5, retain_windows=2)
    rng = np.random.default_rng(3)
    tickets = []
    for _ in range(13):
        a, b = (int(x) for x in rng.integers(0, 300, 2))
        tj, tt = jb.ask_connected(a, b), tb.ask_connected(a, b)
        assert tj == tt
        tickets.append(tt)
    assert tb.flush() == jb.flush()
    for t in tickets[5:]:
        assert tb.result(t) == jb.result(t)
    with pytest.raises(KeyError, match="stale"):
        tb.result(tickets[0])
    with pytest.raises(ValueError, match="retain_windows"):
        tstream.MicroBatcher(tq, retain_windows=0)
    assert tstream.next_pow2(0) == jstream.next_pow2(0) and tstream.next_pow2(17, 1) == 32


# ---------------------------------------------------------------------------
# StreamEngine: one trace through both engines
# ---------------------------------------------------------------------------

_TRACES = {
    # name: (n, batch_capacity, ops, engine options, trace options)
    "default": (64, 16, 40, {}, {}),
    "fractional weights (pack auto falls back)": (64, 16, 30, {}, dict(fractional=True)),
    "pack off": (96, 24, 30, dict(pack=False), {}),
    "pack on": (96, 24, 30, dict(pack=True), {}),
    "segmin torch": (64, 16, 25, dict(segmin="torch"), {}),
    "legacy deletes": (64, 16, 40, dict(exact_deletes=False), {}),
    "adaptive capacity": (128, 64, 40, dict(adaptive_capacity=True, min_capacity=4), {}),
    "coarsen, low threshold": (256, 64, 25,
                               dict(coarsen=True, coarsen_threshold=8), dict(max_w=4)),
    "coarsen, sorted dedupe": (256, 64, 15,
                               dict(coarsen=True, coarsen_threshold=8, segmin="sorted"), {}),
    "bounded reservoir to recertify": (48, 16, 40,
                                       dict(reservoir_capacity=6, reservoir_per_component=2),
                                       dict(p=(0.5, 0.4, 0.0, 0.1))),
    "no reservoir": (48, 16, 25, dict(reservoir_capacity=0), dict(p=(0.6, 0.4, 0.0, 0.0))),
    "n = 2^12": (1 << 12, 512, 12, {}, {}),
    "n > 2^16 (host probe)": (70_000, 256, 8, {}, dict(p=(0.6, 0.25, 0.05, 0.1))),
}


def _engine_kw(opts, package):
    kw = dict(opts)
    if "segmin" in kw and package == "jax":
        kw["segmin"] = JAX_SEGMIN[kw["segmin"]]
    if kw.get("coarsen") is True:
        kw["coarsen"] = (jco if package == "jax" else tco).CoarsenConfig(cutoff=4)
    return kw


def _engines(n, cap, opts):
    je = jstream.StreamEngine(n, cap, **_engine_kw(opts, "jax"))
    te = tstream.StreamEngine(n, cap, **_engine_kw(opts, "torch"), device="cpu")
    return je, te


@pytest.mark.parametrize("name", list(_TRACES))
def test_stream_trace_matches_reference(name):
    n, cap, n_ops, opts, trace_kw = _TRACES[name]
    trace = StreamTrace(n, cap, seed=len(name), **trace_kw)
    je, te = _engines(n, cap, opts)
    assert_same_engine(je, te)
    seen = set()
    ops.segment_min_flat.launches = ops.segment_min_sorted.launches = 0
    for i in range(n_ops):
        op, args = trace.insert() if i < 3 else trace.delete() if i == 3 else trace.next_op()
        want, got = apply_op(je, op, args), apply_op(te, op, args)
        assert type(got).__name__ == type(want).__name__
        assert tuple(got) == tuple(want), (i, op)
        assert_same_engine(je, te)
        if op in ("insert", "compact", "recertify"):
            assert (je.last_coarsen_stats is None) == (te.last_coarsen_stats is None)
            if te.last_coarsen_stats is not None:
                assert tuple(te.last_coarsen_stats.levels) == tuple(je.last_coarsen_stats.levels)
                seen.add("coarsen")
        seen.add(op)
        if op == "delete" and got.n_unhealed:
            seen.add("unhealed")
    # CPU tensors take the kernels' plain versions: nothing was launched
    assert ops.segment_min_flat.launches == ops.segment_min_sorted.launches == 0
    assert {"insert", "delete"} <= seen
    if opts.get("coarsen"):
        assert "coarsen" in seen
    if name == "bounded reservoir to recertify":
        assert {"unhealed", "recertify"} <= seen
    if name == "fractional weights (pack auto falls back)":
        assert not te.state_dict()["packable"]


def test_pack_true_rejects_fractional_like_reference():
    je, te = _engines(32, 8, dict(pack=True))
    for e in (je, te):
        with pytest.raises(ValueError, match="integral weights"):
            e.insert_batch([0], [1], [0.5])
    with pytest.raises(ValueError, match="pack32 index"):
        tstream.StreamEngine(1 << 24, 8, pack=True, device="cpu")


@pytest.mark.parametrize("kw,msg", [(dict(n=1), "n >= 2"), (dict(batch_capacity=0), ">= 1")])
def test_engine_rejects_like_reference(kw, msg):
    kw = {"n": 8, **kw}
    with pytest.raises(ValueError, match=msg):
        jstream.StreamEngine(**kw)
    with pytest.raises(ValueError, match=msg):
        tstream.StreamEngine(**kw, device="cpu")


def test_batch_capacity_enforced_like_reference():
    je, te = _engines(64, 4, {})
    u, v = np.arange(6), np.arange(6) + 10
    for e in (je, te):
        with pytest.raises(ValueError, match="exceeds batch_capacity=4"):
            e.insert_batch(u, v, np.ones(6))
    assert_same_engine(je, te)


def test_union_shape_follows_capacity():
    """Every update solves over exactly 2 * ((n - 1) + batch_capacity)
    directed slots, as in the reference's acceptance test."""
    n, cap = 500, 64
    je, te = _engines(n, cap, {})
    rng = np.random.default_rng(9)
    for _ in range(4):
        args = _edges(rng, n, cap)
        je.insert_batch(*args)
        te.insert_batch(*args)
        assert te.last_union_shape == je.last_union_shape == (2 * (n - 1 + cap),)
    assert te.union_edge_capacity == n - 1 + cap and te.recompiles == 1


def test_streaming_msf_shim_warns():
    with pytest.warns(DeprecationWarning, match="StreamingMSF is deprecated"):
        e = tstream.StreamingMSF(16, 4, device="cpu")
    assert isinstance(e, tstream.StreamEngine)


def test_engine_and_plan_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.StreamEngine(16, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsolve.plan(16, tsolve.SolveSpec(mode="stream"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.make_snapshot(0, np.arange(4), 0.0, 0)
    pb = tdelta.prepare_batch([0], [1], [1.0], 16)
    keys, w, _ = tdelta.build_live_index([], [], [], 16, 15)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdelta.classify_batch(pb, keys, w, 16)


# ---------------------------------------------------------------------------
# the stream plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_kw", [
    dict(batch_capacity=32),
    dict(batch_capacity=32, coarsen=True, coarsen_threshold=8, segmin="sorted"),
    dict(batch_capacity=32, reservoir_capacity=4, reservoir_per_component=1),
])
def test_stream_plan_reports_match_reference(spec_kw):
    n = 120
    jkw, tkw = dict(spec_kw), dict(spec_kw)
    if spec_kw.get("coarsen"):
        jkw["coarsen"], tkw["coarsen"] = jco.CoarsenConfig(cutoff=4), tco.CoarsenConfig(cutoff=4)
        jkw["segmin"] = JAX_SEGMIN[spec_kw["segmin"]]
    jp = jsolve.plan(n, jsolve.SolveSpec(mode="stream", **jkw))
    tp = tsolve.plan(n, tsolve.SolveSpec(mode="stream", **tkw), device="cpu")
    assert tp.engine.device == torch.device("cpu") and tp.resolved.backend == "cpu"
    assert_same_stream_report(jp.solve(), tp.solve())
    trace = StreamTrace(n, 32, seed=4)
    for i in range(20):
        op, args = trace.insert() if i < 3 else trace.next_op()
        surface = {"insert": "update"}.get(op, op)
        assert_same_stream_report(getattr(jp, surface)(*args), getattr(tp, surface)(*args))
        q = trace.rng.integers(0, n, (2, 50))
        np.testing.assert_array_equal(tp.query(*q), jp.query(*q))
    assert tp.service is tp.service
    np.testing.assert_array_equal(tp.service.answer(*q).component,
                                  jp.service.answer(*q).component)


def test_stream_plan_on_a_cpu_graph_target():
    """A graph target's own device wins over ``device=``; only n is read."""
    from repro_torch.graphs import random_graph

    g = random_graph(40, 60, seed=1, device="cpu")
    p = tsolve.plan(g, tsolve.SolveSpec(mode="stream", batch_capacity=8))
    assert p.engine.n == 40 and p.engine.device == torch.device("cpu")
    assert p.update([0, 1], [1, 2], [3.0, 4.0]).weight == 7.0


@pytest.mark.parametrize("surface", ["update", "delete", "recertify", "query", "compact",
                                     "service"])
def test_stream_surfaces_raise_on_other_modes(surface):
    from repro_torch.graphs import random_graph

    p = tsolve.plan(random_graph(10, 20, seed=0, device="cpu"), tsolve.SolveSpec())
    args = {"update": 3, "delete": 2, "recertify": 3, "query": 2, "compact": 0}.get(surface)
    with pytest.raises(ValueError, match="stream-mode surface"):
        if args is None:
            p.service
        else:
            getattr(p, surface)(*([[0]] * args))


def test_stream_is_registered_and_not_cached():
    from repro_torch.solve import planner

    assert "stream" in tsolve.registered_modes() and "stream" not in planner._NOT_PORTED
    assert set(planner._NOT_PORTED) == {"dist"}
    spec = tsolve.SolveSpec(mode="stream", batch_capacity=4)
    a, b = tsolve.plan(10, spec, device="cpu"), tsolve.plan(10, spec, device="cpu")
    assert a.engine is not b.engine
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        a.update([0], [1], [1.0])
    assert a.solve().n_msf_edges == 1 and b.solve().n_msf_edges == 0
