"""Module parity of the port's core (semiring, shortcutting, multilinear,
AS building blocks) against ``repro.core``: same numpy inputs, exact
equality."""
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_util import to_np  # noqa: E402
from repro.core import multilinear as jml  # noqa: E402
from repro.core import semiring as jsr  # noqa: E402
from repro.core import shortcut as jsc  # noqa: E402
from repro.graphs import random_graph  # noqa: E402
from repro_torch.core import msf as tmsf  # noqa: E402
from repro_torch.core import multilinear as tml  # noqa: E402
from repro_torch.core import semiring as tsr  # noqa: E402
from repro_torch.core import shortcut as tsc  # noqa: E402

# ``repro.core`` exports the function ``msf``, which shadows the submodule.
jmsf = importlib.import_module("repro.core.msf")


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_edgemin(a, b):
    np.testing.assert_array_equal(to_np(a.w), to_np(b.w))
    np.testing.assert_array_equal(to_np(a.eid), to_np(b.eid))
    assert len(a.payload) == len(b.payload)
    for x, y in zip(a.payload, b.payload):
        np.testing.assert_array_equal(to_np(x), to_np(y))


@pytest.mark.parametrize("n,e,seed", [(10, 0, 0), (37, 200, 1), (100, 2000, 2)])
def test_segment_argmin_matches(n, e, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 5, e).astype(np.float32)  # many weight ties
    eid = rng.permutation(e).astype(np.int32)
    pay = rng.integers(0, n, e).astype(np.int32)
    seg = rng.integers(0, n, e).astype(np.int32)
    valid = rng.random(e) < 0.8
    want = jsr.segment_argmin(jnp.array(w), jnp.array(eid), (jnp.array(pay),), jnp.array(seg),
                              n, valid=jnp.array(valid))
    got = tsr.segment_argmin(_t(w), _t(eid), (_t(pay),), _t(seg), n, valid=_t(valid))
    assert got.w.dtype == torch.float32 and got.eid.dtype == torch.int32
    _assert_edgemin(got, want)


def test_axis_argmin_and_combine_match():
    rng = np.random.default_rng(4)
    w = rng.integers(1, 4, (6, 9)).astype(np.float32)
    w[rng.random(w.shape) < 0.3] = np.inf
    eid = rng.integers(0, 50, (6, 9)).astype(np.int32)
    pay = rng.integers(0, 9, (6, 9)).astype(np.int32)
    want = jsr.axis_argmin(jnp.array(w), jnp.array(eid), (jnp.array(pay),), axis=1)
    got = tsr.axis_argmin(_t(w), _t(eid), (_t(pay),), axis=1)
    _assert_edgemin(got, want)
    half = [jsr.axis_argmin(jnp.array(w[:, s]), jnp.array(eid[:, s]), (jnp.array(pay[:, s]),), 1)
            for s in (slice(0, 4), slice(4, 9))]
    thalf = [tsr.axis_argmin(_t(w[:, s]), _t(eid[:, s]), (_t(pay[:, s]),), 1)
             for s in (slice(0, 4), slice(4, 9))]
    _assert_edgemin(tsr.combine_edgemin(*thalf), jsr.combine_edgemin(*half))


def test_pack32_roundtrip_matches():
    rng = np.random.default_rng(5)
    w = rng.integers(0, 256, 500).astype(np.int32)
    idx = rng.integers(0, 1 << 24, 500).astype(np.int32)
    want = np.asarray(jsr.pack32(jnp.array(w), jnp.array(idx)))
    got = tsr.pack32(_t(w), _t(idx))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(to_np(got), want.astype(np.int64))
    for a, b in zip(tsr.unpack32(got), jsr.unpack32(jnp.array(want))):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    np.testing.assert_array_equal(  # the identity key unpacks the same way
        [to_np(x) for x in tsr.unpack32(torch.tensor([tsr.PACK_IDENTITY]))],
        [np.asarray(x) for x in jsr.unpack32(jnp.array([0xFFFFFFFF], jnp.uint32))],
    )
    assert (tsr.PACK_IDX_BITS, tsr.PACK_IDX_MASK, tsr.PACK_MAX_W) == (
        jsr.PACK_IDX_BITS, jsr.PACK_IDX_MASK, jsr.PACK_MAX_W)
    for n, mw in [(1 << 24, 255), ((1 << 24) + 1, 255), (10, 256)]:
        assert tsr.packable(n, mw) == jsr.packable(n, mw)


def _random_forest(n, seed):
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    p = np.zeros(n, np.int32)
    p[order[0]] = order[0]
    for i in range(1, n):
        p[order[i]] = order[rng.integers(0, i)]
    return p


def _hooked_roots(n, seed):
    """(p_prev all stars, p after hooking half the roots acyclically)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    p = np.arange(n, dtype=np.int32)
    for i in range(1, n // 2):
        p[order[i]] = order[rng.integers(0, i)]
    return np.arange(n, dtype=np.int32), p


@pytest.mark.parametrize("seed", [0, 1])
def test_complete_shortcut_and_subiters_match(seed):
    p = _random_forest(300, seed)
    np.testing.assert_array_equal(to_np(tsc.complete_shortcut(_t(p))),
                                  np.asarray(jsc.complete_shortcut(jnp.array(p))))
    q, k = tsc.count_shortcut_subiters(_t(p))
    jq, jk = jsc.count_shortcut_subiters(jnp.array(p))
    np.testing.assert_array_equal(to_np(q), np.asarray(jq))
    assert k == int(jk)
    star = np.random.default_rng(seed).random(300) < 0.5
    np.testing.assert_array_equal(to_np(tsc.shortcut_once(_t(p), _t(star))),
                                  np.asarray(jsc.shortcut_once(jnp.array(p), jnp.array(star))))


@pytest.mark.parametrize("capacity", [1, 2, 8, 1024])
@pytest.mark.parametrize("strategy", ["complete", "csp", "os"])
def test_shortcut_strategies_match_including_overflow(strategy, capacity):
    p_prev, p = _hooked_roots(300, 7)
    want = jsc.make_shortcut_fn(strategy, capacity)(jnp.array(p), jnp.array(p_prev))
    got = tsc.make_shortcut_fn(strategy, capacity)(_t(p), _t(p_prev))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("capacity", [1, 2, 8, 64])
def test_build_changed_and_compress_match(capacity):
    p_prev, p = _hooked_roots(40, 3)
    want = jsc.build_changed(jnp.array(p), jnp.array(p_prev), capacity)
    got = tsc.build_changed(_t(p), _t(p_prev), capacity)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    jids, jvals = jsc._compress_changed_map(want[0], want[1])
    tids, tvals = tsc._compress_changed_map(got[0], got[1])
    np.testing.assert_array_equal(to_np(tids), np.asarray(jids))
    np.testing.assert_array_equal(to_np(tvals), np.asarray(jvals))


def test_unknown_shortcut_strategy_raises():
    with pytest.raises(ValueError):
        tsc.make_shortcut_fn("baseline")


def _graph_arrays(seed):
    g = random_graph(40, 120, seed=seed)
    return [np.asarray(a) for a in (g.src, g.dst, g.w, g.eid, g.valid)], g.n


@pytest.mark.parametrize("segment", ["root", "vertex"])
def test_min_outgoing_coo_and_projection_match(segment):
    arrs, n = _graph_arrays(1)
    p = np.asarray(jsc.complete_shortcut(jnp.array(_random_forest(n, 2))))
    star = np.asarray(jmsf.starcheck(jnp.array(_random_forest(n, 3))))
    for s in (None, star):
        want = jml.min_outgoing_coo(jnp.array(p), *map(jnp.array, arrs), n, segment=segment,
                                    star=None if s is None else jnp.array(s))
        got = tml.min_outgoing_coo(_t(p), *map(_t, arrs), n, segment=segment,
                                   star=None if s is None else _t(s))
        _assert_edgemin(got, want)
    _assert_edgemin(tml.project_to_roots(got, _t(p), n), jml.project_to_roots(want, jnp.array(p), n))


@pytest.mark.parametrize("use_hook", [False, True])
def test_min_outgoing_coo_packed_matches(use_hook):
    arrs, n = _graph_arrays(4)
    p = np.asarray(jsc.complete_shortcut(jnp.array(_random_forest(n, 5))))
    from repro_torch.kernels.ops import segment_min_flat

    want = jml.min_outgoing_coo_packed(jnp.array(p), *map(jnp.array, arrs), n)
    got = tml.min_outgoing_coo_packed(_t(p), *map(_t, arrs), n,
                                      segmin=segment_min_flat if use_hook else None)
    _assert_edgemin(got, want)
    # and the packed path agrees with the three-pass float path
    _assert_edgemin(got, tml.min_outgoing_coo(_t(p), *map(_t, arrs), n, segment="root"))


def test_min_outgoing_dense_matches():
    rng = np.random.default_rng(6)
    n = 30
    a = np.full((n, n), np.inf, np.float32)
    u, v = rng.integers(0, n, 90), rng.integers(0, n, 90)
    a[u, v] = rng.integers(1, 256, 90)
    p = rng.integers(0, 10, n).astype(np.int32)
    star = rng.random(n) < 0.7
    for s in (None, star):
        want = jml.min_outgoing_dense(jnp.array(p), jnp.array(a),
                                      None if s is None else jnp.array(s))
        got = tml.min_outgoing_dense(_t(p), _t(a), None if s is None else _t(s))
        _assert_edgemin(got, want)


def test_starcheck_hook_record_match():
    n = 60
    p = _random_forest(n, 8)
    np.testing.assert_array_equal(to_np(tmsf.starcheck(_t(p))),
                                  np.asarray(jmsf.starcheck(jnp.array(p))))
    rng = np.random.default_rng(9)
    p = np.asarray(jsc.complete_shortcut(jnp.array(p)))
    roots = np.flatnonzero(p == np.arange(n))
    r_w = np.full(n, np.inf, np.float32)
    r_par = np.full(n, tsr.IMAX, np.int32)
    r_eid = np.full(n, tsr.IMAX, np.int32)
    hook = roots[rng.random(len(roots)) < 0.7]
    r_w[hook] = rng.integers(1, 9, len(hook))
    r_par[hook] = rng.choice(roots, len(hook))
    r_eid[hook] = rng.permutation(1000)[: len(hook)]
    want = jmsf.hook_and_tiebreak(jnp.array(p), jnp.array(r_w), jnp.array(r_eid), jnp.array(r_par))
    got = tmsf.hook_and_tiebreak(_t(p), _t(r_w), _t(r_eid), _t(r_par))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    buf = np.full(n, tsr.IMAX, np.int32)
    buf[:3] = [5, 6, 7]
    jbuf, jnf = jmsf.record_edges(jnp.array(buf), jnp.int32(3), want[1], jnp.array(r_eid))
    tbuf, tnf = tmsf.record_edges(_t(buf.copy()), torch.tensor(3, dtype=torch.int32), got[1],
                                  _t(r_eid))
    np.testing.assert_array_equal(to_np(tbuf), np.asarray(jbuf))
    assert int(tnf) == int(jnf) and tnf.dtype == torch.int32
