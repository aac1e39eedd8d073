"""The coarsening levels of the port against ``repro.coarsen`` on the CPU:
relabel, contraction, filter, the level loop, the engine front-ends and
the level segment-min resolution, on the same numpy inputs, compared
exactly. The full ``plan(g, SolveSpec(mode="coarsen")).solve()`` over the
graph classes of ``tests/test_coarsen.py`` and every option is in
``test_torch_coarsen_solve.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_util import cpu_graph, to_np  # noqa: E402
from repro import coarsen as jco  # noqa: E402
from repro.coarsen.relabel import canonical_minvertex_labels as j_canon  # noqa: E402
from repro.graphs import from_edges, random_graph, rmat_graph  # noqa: E402
from repro_torch import coarsen as tco  # noqa: E402
from repro_torch import solve as tsolve  # noqa: E402
from repro_torch.coarsen.relabel import canonical_minvertex_labels as t_canon  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.coarsen.engine import _level_setup  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _canonical(g):
    """Undirected (lo < hi) numpy arrays of a JAX graph."""
    src, dst = np.asarray(g.src), np.asarray(g.dst)
    w, eid, valid = np.asarray(g.w), np.asarray(g.eid), np.asarray(g.valid)
    sel = valid & (src < dst)
    return src[sel], dst[sel], w[sel], eid[sel], np.ones(int(sel.sum()), bool)


def _same_fields(a, b, fields=None):
    for f in fields or a._fields:
        np.testing.assert_array_equal(to_np(getattr(b, f)), to_np(getattr(a, f)), err_msg=f)


# ---------------------------------------------------------------------------
# relabel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,roots,seed", [(8, 4, 0), (300, 17, 1), (1000, 1000, 2), (64, 1, 3)])
def test_rank_relabel_and_labels_match_reference(n, roots, seed):
    rng = np.random.default_rng(seed)
    root_ids = np.sort(rng.choice(n, roots, replace=False))
    p = root_ids[rng.integers(0, roots, n)].astype(np.int32)
    p[root_ids] = root_ids  # star-canonical: every root is its own parent
    j_new, j_next = jco.rank_relabel(jnp.array(p))
    t_new, t_next = tco.rank_relabel(_t(p))
    np.testing.assert_array_equal(t_new.numpy(), np.asarray(j_new))
    assert int(t_next) == int(j_next) == roots and t_new.dtype == torch.int32
    src, dst = rng.integers(0, n, 50).astype(np.int32), rng.integers(0, n, 50).astype(np.int32)
    for a, b in zip(tco.relabel_edges(t_new, _t(src), _t(dst)),
                    jco.relabel_edges(j_new, jnp.array(src), jnp.array(dst))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    label_map = rng.integers(0, n, 3 * n).astype(np.int32)
    np.testing.assert_array_equal(tco.compose_labels(_t(label_map), t_new).numpy(),
                                  np.asarray(jco.compose_labels(jnp.array(label_map), j_new)))
    comp = rng.integers(0, roots, 2 * n)
    np.testing.assert_array_equal(t_canon(comp, roots), j_canon(comp, roots))


# ---------------------------------------------------------------------------
# contraction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rounds", [1, 2, 3])
@pytest.mark.parametrize("pack", [False, True])
def test_contract_level_und_matches_reference(pack, rounds):
    g = random_graph(256, 1024, seed=11)
    lo, hi, w, eid, vu = _canonical(g)
    cat = [np.concatenate(x) for x in ((lo, hi), (hi, lo), (w, w), (eid, eid), (vu, vu))]
    want = jco.contract_level(*map(jnp.array, cat), n=g.n, rounds=rounds, pack=pack)
    want_und = jco.contract_level_und(lo, hi, w, eid, vu, n=g.n, eid_capacity=1024,
                                      rounds=rounds, pack=pack)
    _same_fields(want, want_und)
    segmins = (None, ref.segment_min_flat_ref, ops.segment_min_flat) if pack else (None,)
    for segmin in segmins:
        got = tco.contract_level_und(*map(_t, (lo, hi, w, eid, vu)), n=g.n,
                                     eid_capacity=1024, rounds=rounds, pack=pack,
                                     segmin=segmin)
        _same_fields(want, got)
        got_dir = tco.contract_level(*map(_t, cat), n=g.n, rounds=rounds, pack=pack,
                                     segmin=segmin)
        _same_fields(want, got_dir)


def test_contract_level_und_empty_edges():
    z = torch.zeros(0, dtype=torch.int32)
    r = tco.contract_level_und(z, z, z.float(), z, z.bool(), n=8, eid_capacity=8, pack=True)
    assert int(r.n_next) == 8 and int(r.n_msf_edges) == 0
    np.testing.assert_array_equal(r.parent.numpy(), np.arange(8))


# ---------------------------------------------------------------------------
# filter
# ---------------------------------------------------------------------------


def _filter_inputs(n, m, seed):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, n, m).astype(np.int32)
    hi = rng.integers(0, n, m).astype(np.int32)
    # few weight levels + shuffled eids: many ties, broken on eid
    w = rng.integers(1, 8, m).astype(np.float32)
    eid = rng.permutation(m).astype(np.int32)
    valid = rng.random(m) < 0.9
    new_ids = rng.integers(0, max(n // 4, 2), n).astype(np.int32)
    return lo, hi, w, eid, valid, new_ids


@pytest.mark.parametrize("n", [64, (1 << 16) + 512], ids=["n_le_2^16", "n_gt_2^16"])
@pytest.mark.parametrize("pack", [False, True])
def test_filter_level_matches_reference(pack, n):
    args = _filter_inputs(n, 512, n)
    want = jco.filter_level(*map(jnp.array, args), n=n, pack=pack)
    for segmin in ((None, ops.segment_min_sorted) if pack else (None,)):
        got = tco.filter_level(*map(_t, args), n=n, pack=pack, segmin=segmin)
        _same_fields(want, got)
    m = int(want.m_new)
    l2, h2, w2, e2 = tco.filter_level_host(*map(_t, args), n)
    jl, jh, jw, je = jco.filter_level_host(*args, n)
    for a, b in zip((l2, h2, w2, e2), (jl, jh, jw, je)):
        np.testing.assert_array_equal(a, b)
    # the device filter and the host twin keep the same (pair, eid) set
    dev = sorted(zip(*(to_np(x)[:m].tolist() for x in (got.lo, got.hi, got.eid))))
    assert dev == sorted(zip(l2.tolist(), h2.tolist(), e2.tolist()))
    cb = tco.filter_level_callback(*map(_t, args), n=n)
    _same_fields(jco.filter_level_callback(*map(jnp.array, args), n=n), cb)


@pytest.mark.parametrize("pack", [False, True])
def test_filter_equal_weight_ties_break_on_eid(pack):
    args = (np.array([0, 0], np.int32), np.array([2, 3], np.int32),
            np.array([7.0, 7.0], np.float32), np.array([20, 10], np.int32),
            np.ones(2, bool), np.array([0, 0, 1, 1], np.int32))
    got = tco.filter_level(*map(_t, args), n=4, pack=pack)
    assert int(got.m_new) == 1 and int(got.eid[0]) == 10
    _same_fields(jco.filter_level(*map(jnp.array, args), n=4, pack=pack), got)
    assert tco.filter_level_host(*args, 4)[3][0] == 10


def test_filter_level_empty_input():
    z, zw, zb = (torch.zeros(0, dtype=d) for d in (torch.int32, torch.float32, torch.bool))
    for fn in (tco.filter_level, tco.filter_level_callback):
        fr = fn(z, z, zw, z, zb, torch.zeros(4, dtype=torch.int32), n=4)
        assert int(fr.m_new) == 0 and fr.lo.shape == (0,) and fr.valid.shape == (0,)


# ---------------------------------------------------------------------------
# the level loop and the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dedupe", ["host", "device"])
def test_run_levels_match_reference_level_by_level(dedupe, fused):
    g = rmat_graph(10, 4, seed=13)
    kw = dict(rounds_per_level=1, cutoff=8, max_levels=8, dedupe=dedupe, fused=fused)
    want = jco.run_levels(g, jco.CoarsenConfig(**kw))
    got = tco.run_levels(cpu_graph(g), tco.CoarsenConfig(**kw))
    assert len(got.stats.levels) >= 2
    assert tuple(got.stats) == tuple(want.stats)
    assert (got.weight, got.level_iters) == (want.weight, want.level_iters)
    np.testing.assert_array_equal(got.msf_eids, want.msf_eids)
    np.testing.assert_array_equal(to_np(got.label_map), want.label_map)
    for f in ("src", "dst", "w", "eid", "valid"):
        np.testing.assert_array_equal(to_np(getattr(got.residual, f)),
                                      np.asarray(getattr(want.residual, f)), err_msg=f)
    assert got.residual.n == want.residual.n
    be = got.backends
    assert (be.pack, be.dedupe) == (True, dedupe)
    # the kernels' wrappers, which run the plain versions on the CPU
    assert be.hook is ops.segment_min_flat and be.dedupe_segmin is ops.segment_min_sorted


@pytest.mark.parametrize("case", ["edgeless", "below_cutoff"])
def test_edge_cases_match_reference(case):
    if case == "edgeless":
        g = from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0), 40)
        cfg = dict(cutoff=4)
    else:
        g = random_graph(100, 300, seed=23)
        cfg = dict(cutoff=1024)
    want = jco.CoarsenMSF(jco.CoarsenConfig(**cfg))
    got = tco.CoarsenMSF(tco.CoarsenConfig(**cfg))
    a, b = want(g), got(cpu_graph(g))
    np.testing.assert_array_equal(to_np(b.msf_eids), np.asarray(a.msf_eids))
    np.testing.assert_array_equal(to_np(b.parent), np.asarray(a.parent))
    assert (float(b.weight), int(b.n_msf_edges), int(b.iterations)) == (
        float(a.weight), int(a.n_msf_edges), int(a.iterations))
    assert got.last_stats == want.last_stats


def test_coarsen_msf_one_shot_matches_reference():
    g = random_graph(200, 700, seed=17)
    a = jco.coarsen_msf(g, config=jco.CoarsenConfig(cutoff=16), segmin="sorted", pack=True)
    b = tco.coarsen_msf(cpu_graph(g), config=tco.CoarsenConfig(cutoff=16), segmin="sorted",
                        pack=True, fused=True)
    np.testing.assert_array_equal(to_np(b.msf_eids), np.asarray(a.msf_eids))
    np.testing.assert_array_equal(to_np(b.parent), np.asarray(a.parent))
    assert float(b.weight) == float(a.weight)


def test_level_segmin_resolution():
    """The levels' (hook, dedupe) segment-mins, selected by request alone
    (the wrappers look at the device): the flat and sorted kernels'
    wrappers for every request but "torch" — the hook takes the flat
    kernel even for None/"auto", unlike the reference — both plain
    versions for "torch", nothing without pack32."""
    flat, srt = ops.segment_min_flat, ops.segment_min_sorted
    g = cpu_graph(random_graph(30, 90, seed=2))

    def levels(req, pack=True, segmins=None):
        be = _level_setup(g, tco.CoarsenConfig(segmin=req, pack=pack), segmins)[3]
        return be.hook, be.dedupe_segmin

    for req in (None, "auto", "cuda", "sorted"):
        assert levels(req) == (flat, srt)
    assert levels("torch") == (ref.segment_min_flat_ref, ref.segment_min_sorted_ref)
    assert levels("cuda", False) == (None, None)
    assert levels(None, segmins=(srt, flat)) == (srt, flat)  # a resolved pair as given
    p = tsolve.plan(g, tsolve.SolveSpec(mode="coarsen", coarsen=tco.CoarsenConfig(cutoff=8)))
    p.solve()
    be = p.engine.last_backends
    assert (be.pack, be.hook, be.dedupe_segmin, be.dedupe) == (True, flat, srt, "host")
    assert flat.launches == srt.launches == 0  # the CPU path launches nothing


def test_coarsen_plan_is_cached_and_registered():
    g = cpu_graph(random_graph(60, 200, seed=3))
    tsolve.clear_plan_cache()
    p1 = tsolve.plan(g, tsolve.SolveSpec(mode="coarsen"))
    p2 = tsolve.plan(g, tsolve.SolveSpec(mode="coarsen"))
    assert p1.engine is p2.engine and "coarsen" in tsolve.registered_modes()
    assert p1.resolved.coarsen == tco.CoarsenConfig()
    tsolve.clear_plan_cache()
