"""``repro_torch.solve.cost`` against ``repro.solve.cost`` on the CPU: the
same ``PlanCost`` fields and ``analyzed`` labels for flat, fused-coarsen
and unfused-coarsen plans, ``None`` for stream plans, the cost shared by
the plan, its reports and the plan cache, a model that reads shapes only
and grows with the edge count, and ``predicted_time_s`` per round."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_util import cpu_graph  # noqa: E402
from repro import solve as jsolve  # noqa: E402
from repro.coarsen.config import CoarsenConfig as JCoarsen  # noqa: E402
from repro.graphs.generators import grid_road_graph, random_graph, rmat_graph  # noqa: E402
from repro.solve import cost as jcost  # noqa: E402
from repro_torch import solve as tsolve  # noqa: E402
from repro_torch.analysis.roofline import H100_SXM, roofline_time_s  # noqa: E402
from repro_torch.coarsen import CoarsenConfig as TCoarsen  # noqa: E402
from repro_torch.graphs.structures import Graph  # noqa: E402
from repro_torch.solve import cost as tcost  # noqa: E402

_SPECS = [
    ("flat", dict()),
    ("flat_float", dict(pack=False)),
    ("flat_csp", dict(shortcut="csp")),
    ("coarsen_fused", dict(mode="coarsen", cfg=dict(cutoff=16, fused=True))),
    ("coarsen_unfused", dict(mode="coarsen", cfg=dict(cutoff=16))),
    ("coarsen_fused_float", dict(mode="coarsen", pack=False, cfg=dict(cutoff=16, fused=True))),
    ("coarsen_below_cutoff", dict(mode="coarsen", cfg=dict(cutoff=4096))),
]


def _specs(kw):
    kw = dict(kw)
    cfg = kw.pop("cfg", None)
    return (jsolve.SolveSpec(coarsen=JCoarsen(**cfg) if cfg else None, **kw),
            tsolve.SolveSpec(coarsen=TCoarsen(**cfg) if cfg else None, **kw))


@pytest.mark.parametrize("name,kw", _SPECS, ids=[s[0] for s in _SPECS])
def test_plan_cost_fields_and_labels_match_reference(name, kw):
    g = rmat_graph(8, 4, seed=1)
    jspec, tspec = _specs(kw)
    want = jsolve.plan(g, jspec).cost
    tp = tsolve.plan(cpu_graph(g), tspec)
    got = tp.cost
    assert want is not None and got is not None
    assert got._fields == want._fields
    assert sorted(got.as_dict()) == sorted(want.as_dict())
    assert got.analyzed == want.analyzed
    assert got.flops == got.dot_flops + got.ew_flops > 0 and got.bytes > 0
    assert got.collective_bytes == 0.0 and got.dot_flops == 0.0
    assert got.dynamic_loops == (1 if got.analyzed == "flat" else 0)
    rep = tp.solve()
    assert rep.cost is got  # the report carries the plan's analysis


def test_plan_cost_absent_for_stream_mode():
    want = jsolve.plan(64, jsolve.SolveSpec(mode="stream", batch_capacity=64))
    p = tsolve.plan(64, tsolve.SolveSpec(mode="stream", batch_capacity=64), device="cpu")
    assert want.cost is None and p.cost is None
    rep = p.update([0, 1], [2, 3], [1.0, 2.0])
    assert rep.cost is None and p.solve().cost is None


def test_plan_cost_out_of_scope_is_none():
    g = cpu_graph(random_graph(64, 256, seed=7))
    rs = tsolve.SolveSpec().resolve(g)
    assert tcost.plan_cost("stream", g, rs) is None
    assert tcost.plan_cost("dist", g, rs) is None
    assert tcost.plan_cost("flat", 64, rs) is None
    assert tcost.plan_cost("flat", None, rs) is None
    assert tsolve.plan(g, tsolve.SolveSpec(variant="paper")).cost is None
    assert tcost.predicted_time_s(None) is None


def test_cost_is_shared_by_plan_reports_and_cache():
    g = cpu_graph(random_graph(64, 256, seed=7))
    tsolve.clear_plan_cache()
    p = tsolve.plan(g, tsolve.SolveSpec())
    c = p.cost
    assert p.solve().cost is c and p.solve().cost is c
    assert tsolve.plan(g, tsolve.SolveSpec()).cost is c  # a cache hit reuses it
    for mode in ("metrics", "trace"):  # the observed path attaches it too
        rep = tsolve.plan(g, tsolve.SolveSpec(obs=mode)).solve()
        assert rep.cost == c and rep.timings
    tsolve.clear_plan_cache()
    assert tsolve.plan(g, tsolve.SolveSpec()).cost == c
    tsolve.clear_plan_cache()


def _meta_graph(g):
    """``g``'s shapes with no data: every pass over the edges would fail."""
    return Graph(*(torch.empty(t.shape, dtype=t.dtype, device="meta")
                   for t in (g.src, g.dst, g.w, g.eid, g.valid)), n=g.n)


@pytest.mark.parametrize("name,kw", _SPECS, ids=[s[0] for s in _SPECS])
def test_cost_reads_shapes_only(name, kw):
    g = cpu_graph(grid_road_graph(12, 12, seed=2))
    _, tspec = _specs(kw)
    rs = tspec.resolve(g)
    want = tcost.plan_cost(tspec.mode, g, rs)
    assert want is not None
    assert tcost.plan_cost(tspec.mode, _meta_graph(g), rs) == want


@pytest.mark.parametrize("mode", ["flat", "coarsen"])
def test_bytes_grow_with_edges(mode):
    spec = tsolve.SolveSpec(mode=mode, coarsen=TCoarsen(cutoff=16) if mode == "coarsen" else None)
    costs = []
    for m in (256, 1024, 4096):
        g = cpu_graph(random_graph(256, m, seed=3))
        costs.append(tcost.plan_cost(mode, g, spec.resolve(g)))
    assert costs[0].bytes < costs[1].bytes < costs[2].bytes
    assert costs[0].flops < costs[1].flops < costs[2].flops


def test_flat_segment_min_term_is_the_kernels_bound():
    """The segment-min term counts what chip_smoke.py's segmin_bytes counts
    with every key live: 8 B per key, 4 B per id, 8 B per output."""
    g = cpu_graph(rmat_graph(8, 4, seed=1))
    e = int(g.src.shape[0])
    terms = tcost.flat_round_terms(g.n, e, tsolve.SolveSpec().resolve(g))
    assert terms["segment_min"] == (12 * e + 8 * g.n, e)
    assert set(terms) == {"gathers", "index_casts", "key_build", "segment_min", "payload",
                          "hook", "record", "shortcut"}
    cost = tsolve.plan(g).cost
    assert cost.bytes == sum(b for b, _ in terms.values())


def test_predicted_time_is_per_round():
    g = cpu_graph(rmat_graph(8, 4, seed=1))
    flat = tsolve.plan(g).cost
    one = tcost.predicted_time_s(flat)
    assert one == roofline_time_s(dot_flops=0.0, ew_ops=flat.ew_flops, bytes_=flat.bytes)
    assert one == max(flat.ew_flops / H100_SXM["peak_int32"], flat.bytes / H100_SXM["hbm_bw"])
    rep = tsolve.plan(g).solve()
    assert tcost.predicted_time_s(flat, iterations=rep.iterations) == \
        pytest.approx(rep.iterations * one)
    assert tcost.predicted_time_s(flat, iterations=0) == one
    level = tsolve.plan(g, tsolve.SolveSpec(mode="coarsen", coarsen=TCoarsen(cutoff=16))).cost
    assert tcost.predicted_time_s(level, iterations=7) == tcost.predicted_time_s(level)
    # the reference's contract: the same shape, per round for flat
    want = jsolve.plan(rmat_graph(8, 4, seed=1), jsolve.SolveSpec()).cost
    assert jcost.predicted_time_s(want, iterations=3) == \
        pytest.approx(3 * jcost.predicted_time_s(want))


def test_tuned_spec_is_costed():
    """The cost follows the spec in effect: a tuned shortcut changes it."""
    from repro_torch.solve import tune as ttune

    g = cpu_graph(random_graph(64, 256, seed=7))
    base = tsolve.plan(g, tsolve.SolveSpec(tuning="db")).cost
    db = ttune.TuningDB()
    db.put(ttune.key_for("flat", g), {"shortcut": "csp"})
    tsolve.set_tuning_db(db)
    try:
        p = tsolve.plan(g, tsolve.SolveSpec(tuning="db"))
        assert p.resolved.shortcut == "csp"
        rs = dataclasses.replace(tsolve.SolveSpec(shortcut="csp")).resolve(g)
        assert p.cost == tcost.plan_cost("flat", g, rs) != base
    finally:
        tsolve.set_tuning_db(None)
        tsolve.clear_plan_cache()
