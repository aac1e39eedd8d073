"""The distributed coarsening levels (``DistCoarsenMSF``, ``mode="dist"``
with ``coarsen=``), the Partition2D pre-contraction and the dist plan
surface of the port, against the JAX package on the same numpy inputs:
1×1 in this process (a world-1 gloo host mesh beside the conftest's 1×1
``host_mesh``), and the tuning key of a 2×2 grid of spawned ranks."""
import collections
import types
import zlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_util import (  # noqa: E402
    assert_same_fields,
    cpu_graph,
    float64_weight,
    join_ranks,
    report_fields,
    start_ranks,
    stats_fields,
    to_np,
)
from repro import obs as jobs  # noqa: E402
from repro import solve as jsolve  # noqa: E402
from repro.coarsen import CoarsenConfig as JConfig  # noqa: E402
from repro.coarsen import engine as jengine  # noqa: E402
from repro.coarsen.dist import DistCoarsenMSF as JDistCoarsenMSF  # noqa: E402
from repro.graphs import grid_road_graph, random_graph  # noqa: E402
from repro.graphs.partition import partition_edges_2d as jpartition  # noqa: E402
from repro.graphs.structures import from_edges  # noqa: E402
from repro.solve import tune as jtune  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import solve as tsolve  # noqa: E402
from repro_torch.coarsen import CoarsenConfig as TConfig  # noqa: E402
from repro_torch.coarsen import engine as tengine  # noqa: E402
from repro_torch.coarsen.dist import DistCoarsenMSF as TDistCoarsenMSF  # noqa: E402
from repro_torch.graphs.partition import partition_edges_2d as tpartition  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.solve import tune as ttune  # noqa: E402

_LEVELS = dict(rounds_per_level=2, cutoff=16, fused=True)


@pytest.fixture(scope="module")
def port_mesh():
    return make_host_mesh(device="cpu")


@pytest.fixture(autouse=True)
def _clean():
    for o in (jobs, tobs):
        o.disable()
        o.reset()
        o.metrics_reset()
    jsolve.clear_plan_cache()
    tsolve.clear_plan_cache()
    yield
    for o in (jobs, tobs):
        o.disable()
        o.reset()
        o.metrics_reset()


def _parts(g, rows=1, cols=1):
    return jpartition(g, rows, cols), tpartition(cpu_graph(g), rows, cols)


def _arrays(part):
    return part.src_row, part.dst_col, part.w, part.eid, part.valid


def _assert_same_result(want, got, *, exact_weight=True):
    """Two ``MSFResult``s: every field, values and dtypes; the weight
    exactly (pack32) or to 1e-5 relative (float path)."""
    for f in want._fields:
        a, b = to_np(getattr(want, f)), to_np(getattr(got, f))
        assert b.dtype == a.dtype, f
        if f == "weight" and not exact_weight:
            assert abs(float(b) - float(a)) <= 1e-5 * abs(float(a)), (a, b)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("dedupe", ["device", "host"])
def test_dist_coarsen_matches_reference(host_mesh, port_mesh, dedupe):
    g = random_graph(300, 1000, seed=29)
    jp, tp = _parts(g)
    jd = JDistCoarsenMSF(jp, host_mesh, JConfig(**_LEVELS, dedupe=dedupe))
    td = TDistCoarsenMSF(tp, port_mesh, TConfig(**_LEVELS, dedupe=dedupe))
    want, got = jd(*_arrays(jp)), td(*_arrays(tp))
    _assert_same_result(want, got)
    assert stats_fields(td.last_stats) == stats_fields(jd.last_stats)
    st = td.last_stats
    assert len(st.levels) >= 1
    assert st.host_roundtrips == (0 if dedupe == "device" else len(st.levels))
    assert int(got.iterations) == 2 * len(st.levels) + st.residual_iters
    again = td(*_arrays(tp))  # the memo on the same inputs: the same result
    _assert_same_result(want, again)


@pytest.mark.parametrize("mode", ["metrics", "trace"])
def test_dist_coarsen_obs_matches_reference(host_mesh, port_mesh, mode):
    """The spans and counters of a dist coarsen plan: dist.level per
    level, dist.residual, dist.allreduce.{passes,elements}."""
    g = random_graph(300, 1000, seed=29)
    jp, tp = _parts(g)
    seen = []
    for pkg, solve, part, mesh, cfg in ((jobs, jsolve, jp, host_mesh, JConfig),
                                        (tobs, tsolve, tp, port_mesh, TConfig)):
        spec = solve.SolveSpec(mode="dist", coarsen=cfg(**_LEVELS, dedupe="device"), obs=mode)
        rep = solve.plan(part, spec, mesh=mesh).solve()
        snap = pkg.metrics_snapshot()
        # trace mode records events, metrics mode one histogram per span name
        names = collections.Counter(e[0] for e in pkg.trace_events()) or collections.Counter(
            {k[len("span."):]: h["count"] for k, h in snap["histograms"].items()})
        seen.append((report_fields(rep), names, snap["counters"]))
    (want, jnames, jcount), (got, tnames, tcount) = seen
    assert_same_fields(want, got)
    assert tcount == jcount and tcount["dist.allreduce.passes"] > 0
    assert tnames == jnames
    assert tnames["dist.level"] == len(got["levels"]) and tnames["dist.residual"] == 1


def test_dist_coarsen_float_path(host_mesh, port_mesh):
    """Non-integral weights: the 3-pass float combine across the mesh."""
    rng = np.random.default_rng(41)
    n, m = 220, 700
    g = from_edges(rng.integers(0, n, m), rng.integers(0, n, m), rng.random(m) + 0.5, n)
    jp, tp = _parts(g)
    jd = JDistCoarsenMSF(jp, host_mesh, JConfig(**_LEVELS, dedupe="device"))
    td = TDistCoarsenMSF(tp, port_mesh, TConfig(**_LEVELS, dedupe="device"))
    want, got = jd(*_arrays(jp)), td(*_arrays(tp))
    _assert_same_result(want, got, exact_weight=False)
    k = int(got.n_msf_edges)
    assert float64_weight(g, to_np(got.msf_eids)[:k]) == float64_weight(
        g, to_np(want.msf_eids)[:k])
    assert stats_fields(td.last_stats) == stats_fields(jd.last_stats)


def test_dist_coarsen_below_cutoff_residual_only(host_mesh, port_mesh):
    g = grid_road_graph(10, 12, seed=7)
    jp, tp = _parts(g)
    jd = JDistCoarsenMSF(jp, host_mesh, JConfig(cutoff=4096, fused=True))
    td = TDistCoarsenMSF(tp, port_mesh, TConfig(cutoff=4096, fused=True))
    want, got = jd(*_arrays(jp)), td(*_arrays(tp))
    _assert_same_result(want, got)
    assert len(td.last_stats.levels) == 0
    assert stats_fields(td.last_stats) == stats_fields(jd.last_stats)


def test_precontract_partition_merge_matches_reference(host_mesh, port_mesh):
    g = random_graph(300, 1000, seed=29)
    jpart, jpre = jengine.precontract_partition(g, 1, 1, config=JConfig(rounds_per_level=2,
                                                                         cutoff=16))
    tpart, tpre = tengine.precontract_partition(cpu_graph(g), 1, 1,
                                                config=TConfig(rounds_per_level=2, cutoff=16))
    for f in ("src_row", "dst_col", "w", "eid", "valid"):
        np.testing.assert_array_equal(getattr(tpart, f), getattr(jpart, f), err_msg=f)
    assert (tpart.n, tpart.n_pad, tpart.shard_size) == (jpart.n, jpart.n_pad, jpart.shard_size)
    assert tuple(tpre.stats) == tuple(jpre.stats) and len(tpre.stats.levels) >= 1
    spec = dict(mode="dist", shortcut="csp", capacity=512)
    jdrv = jsolve.plan(jpart, jsolve.SolveSpec(**spec), mesh=host_mesh).driver
    tdrv = tsolve.plan(tpart, tsolve.SolveSpec(**spec), mesh=port_mesh).driver
    want = jengine.merge_distributed(jpre, jdrv(*_arrays(jpart)))
    got = tengine.merge_distributed(tpre, tdrv(*_arrays(tpart)))
    _assert_same_result(want, got)
    assert int(got.iterations) == tpre.level_iters + int(tdrv(*_arrays(tpart)).iterations)


@pytest.mark.parametrize("coarsen", [False, True])
def test_dist_plan_report_driver_and_cache(host_mesh, port_mesh, coarsen):
    g = random_graph(120, 400, seed=9)
    jp, tp = _parts(g)
    jkw = dict(coarsen=JConfig(**_LEVELS, dedupe="device")) if coarsen else {}
    tkw = dict(coarsen=TConfig(**_LEVELS, dedupe="device")) if coarsen else {}
    want = jsolve.plan(jp, jsolve.SolveSpec(mode="dist", **jkw), mesh=host_mesh).solve()
    p = tsolve.plan(tp, tsolve.SolveSpec(mode="dist", **tkw), mesh=port_mesh)
    assert p.resolved.backend == "cpu" and p.resolved.pack is True
    got = p.solve()
    assert got.mode == "dist" and got.cost is None
    assert_same_fields(report_fields(want), report_fields(got))
    # the driver is the engine's, called with the five block arrays
    assert p.driver is p.engine.driver
    if coarsen:
        assert isinstance(p.driver, TDistCoarsenMSF)
        assert got.host_roundtrips == p.driver.last_stats.host_roundtrips == 0
    direct = p.driver(*_arrays(tp))
    np.testing.assert_array_equal(to_np(direct.msf_eids), to_np(got.raw.msf_eids))
    explicit = p.solve(*_arrays(tp))
    assert_same_fields(report_fields(got), report_fields(explicit))
    # the plan cache: same shape and mesh share an engine, another mesh does not
    tp2 = tpartition(cpu_graph(random_graph(120, 400, seed=10)), 1, 1)
    if tp2.e_max == tp.e_max:
        assert tsolve.plan(tp2, p.spec, mesh=port_mesh).engine is p.engine
    other = make_host_mesh(device="cpu")
    assert other is not port_mesh
    q = tsolve.plan(tp, p.spec, mesh=other)
    assert q.engine is not p.engine
    assert_same_fields(report_fields(got), report_fields(q.solve()))
    assert "part2d" in repr(p)


def test_dist_without_mesh_raises():
    tp = tpartition(cpu_graph(random_graph(10, 20, seed=0)), 1, 1)
    with pytest.raises(ValueError, match="needs a mesh"):
        tsolve.plan(tp, tsolve.SolveSpec(mode="dist"))


def _stable_timer(module):
    """Each candidate's 'latency' is a stable hash of its knobs, the same
    in both packages and on every rank."""
    import json

    def timer(spec, solve_fn):
        knobs = json.dumps(module.spec_knobs(spec), sort_keys=True, default=str)
        base = 1e-4 + (zlib.crc32(knobs.encode()) % 1000) * 1e-7
        return [base, base * 1.01, base * 0.99]
    return timer


def test_dist_tune_ranking_matches_reference(host_mesh, port_mesh):
    g = random_graph(100, 300, seed=2)
    jp, tp = _parts(g)
    kw = dict(space="full", seed=3, iters=1)
    want = jtune.tune(jp, "dist", mesh=host_mesh, timer=_stable_timer(jtune), **kw)
    got = ttune.tune(tp, "dist", mesh=port_mesh, timer=_stable_timer(ttune), **kw)
    assert [ttune.spec_knobs(r.spec) for r in got.ranking] == [
        jtune.spec_knobs(r.spec) for r in want.ranking]
    assert [r.median_us for r in got.ranking] == [r.median_us for r in want.ranking]
    assert tuple(got.key) == tuple(want.key) and got.key.mesh == "1x1"


_TUNE_RANKS = r"""
from repro_torch.launch.mesh import make_mesh
from repro_torch.solve import SolveSpec, plan, set_tuning_db
from repro_torch.solve.tune import TuningDB, tune
import json, zlib
from repro_torch.solve.tune import spec_knobs

def timer(spec, solve_fn):
    knobs = json.dumps(spec_knobs(spec), sort_keys=True, default=str)
    base = 1e-4 + (zlib.crc32(knobs.encode()) % 1000) * 1e-7 * (1 + RANK)
    return [base, base * 1.01, base * 0.99]

mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
part = INPUTS["part"]
db = TuningDB()
res = tune(part, "dist", mesh=mesh, db=db, space="full", seed=3, timer=timer)
OUT["key"] = tuple(res.key)
OUT["ranking"] = [(spec_knobs(r.spec), r.median_us) for r in res.ranking]
set_tuning_db(db)
rep = plan(part, SolveSpec(mode="dist", tuning="db"), mesh=mesh).solve()
OUT["eids"] = rep.msf_eids
OUT["weight"] = rep.weight
"""


def test_dist_tuning_key_on_a_2x2_grid(tmp_path):
    """Four spawned ranks tune one partition: the key's mesh is "2x2",
    every rank elects the same winner from the slowest rank's samples, and
    the database then resolves the same plan on every rank."""
    g = random_graph(100, 300, seed=2)
    jp, tp = _parts(g, 2, 2)
    ranks = join_ranks(start_ranks(_TUNE_RANKS, 4, {"part": tp}, tmp_path), timeout=120)
    want = jtune.key_for("dist", jp, backend="cpu", device_count=1,
                         mesh=types.SimpleNamespace(devices=np.empty((2, 2))))
    for out in ranks:
        assert out["key"] == tuple(want) and want.mesh == "2x2"
        assert out["ranking"] == ranks[-1]["ranking"]  # rank 3 is the slowest
        np.testing.assert_array_equal(out["eids"], ranks[0]["eids"])
        assert out["weight"] == ranks[0]["weight"]
    medians = [m for _, m in ranks[0]["ranking"]]
    assert medians == sorted(medians)
