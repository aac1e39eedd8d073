"""The slice end to end: ``repro_torch.solve.plan(g, SolveSpec()).solve()``
against ``repro.solve.plan(g, SolveSpec()).solve()`` on the CPU — weight,
MSF eids, parent, edge count and rounds identical — plus the spec,
resolve and plan surfaces of the port."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_util import assert_same_msf, cpu_graph, float64_weight  # noqa: E402
from repro import solve as jsolve  # noqa: E402
from repro.graphs import from_edges, grid_road_graph, random_graph  # noqa: E402
from repro.graphs.generators import components_graph  # noqa: E402
from repro_torch import solve as tsolve  # noqa: E402
from repro_torch.graphs.structures import nx_free_msf_weight  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from test_msf_properties import _FIXED_CASES, _fixed_graph  # noqa: E402

_GENERATED = {
    "random_graph": lambda: random_graph(60, 240, seed=11),
    "grid_road_graph": lambda: grid_road_graph(12, 15, seed=3),
    "components_graph": lambda: components_graph(5, 14, seed=2),
}
_CASES = [(c[0], lambda c=c: _fixed_graph(*c)) for c in _FIXED_CASES] + list(_GENERATED.items())


@pytest.mark.parametrize("name,make", _CASES, ids=[c[0] for c in _CASES])
def test_default_solve_matches_reference(name, make):
    g = make()
    want = jsolve.plan(g, jsolve.SolveSpec()).solve()
    p = tsolve.plan(cpu_graph(g), tsolve.SolveSpec())
    assert p.resolved.pack == jsolve.SolveSpec().resolve(g).pack
    got = p.solve()
    assert_same_msf(want, got)
    assert got.mode == "flat" and got.n_components == want.n_components
    raw = got.raw
    assert raw.parent.dtype == raw.msf_eids.dtype == torch.int32
    assert raw.n_msf_edges.dtype == raw.iterations.dtype == torch.int32
    assert raw.weight.dtype == torch.float32


def test_float_weights_match_as_float64_sums():
    rng = np.random.default_rng(12)
    u, v = rng.integers(0, 30, 110), rng.integers(0, 30, 110)
    g = from_edges(u, v, rng.random(110) * 10.0, 30)
    want = jsolve.plan(g, jsolve.SolveSpec()).solve()
    p = tsolve.plan(cpu_graph(g), tsolve.SolveSpec())
    assert p.resolved.pack is False
    got = p.solve()
    assert_same_msf(want, got, exact_weight=False)
    assert float64_weight(g, got.msf_eids) == float64_weight(g, want.msf_eids)
    assert abs(got.weight - float64_weight(g, got.msf_eids)) < 1e-3


def test_warm_start_matches_reference():
    g = random_graph(50, 150, seed=4)
    rng = np.random.default_rng(0)
    parent0 = np.arange(50, dtype=np.int32)
    parent0[rng.permutation(50)[:20]] = rng.integers(0, 5, 20)  # a forest of chains
    want = jsolve.plan(g, jsolve.SolveSpec()).solve(parent0=parent0)
    got = tsolve.plan(cpu_graph(g), tsolve.SolveSpec()).solve(parent0=parent0)
    assert_same_msf(want, got)


def test_cuda_request_on_cpu_graph_runs_plain_version():
    g = cpu_graph(random_graph(40, 120, seed=5))
    ops.segment_min_flat.launches = 0
    a = tsolve.plan(g, tsolve.SolveSpec(segmin="cuda")).solve()
    b = tsolve.plan(g, tsolve.SolveSpec(segmin="torch")).solve()
    assert ops.segment_min_flat.launches == 0
    np.testing.assert_array_equal(a.msf_eids, b.msf_eids)
    assert a.weight == b.weight == nx_free_msf_weight(g)


def test_flat_msf_resolves_its_string_request():
    from repro_torch.core.msf import flat_msf

    g = cpu_graph(random_graph(40, 120, seed=6))
    want = tsolve.plan(g, tsolve.SolveSpec()).solve()
    r = flat_msf(g, pack=True, segmin="sorted")  # "sorted" degrades to "auto" here
    assert int(r.n_msf_edges) == want.n_msf_edges and int(r.iterations) == want.iterations
    np.testing.assert_array_equal(r.msf_eids[: want.n_msf_edges].numpy(), want.msf_eids)


def test_resolve_keys_on_device_type():
    g = cpu_graph(random_graph(20, 50, seed=1))
    rs = tsolve.SolveSpec().resolve(g)
    assert (rs.backend, rs.pack, rs.dedupe) == ("cpu", True, "host")
    assert rs.segmin_flat is ops.segment_min_flat  # it runs the plain version on the CPU
    rs = tsolve.SolveSpec().resolve(g, backend="cuda")
    assert rs.segmin_flat is ops.segment_min_flat and rs.dedupe == "device"
    for backend in ("cpu", "cuda"):  # the device type picks the dedupe, not the segmin
        assert tsolve.SolveSpec(segmin="torch").resolve(g, backend=backend).segmin_flat is (
            ref.segment_min_flat_ref)
    assert tsolve.SolveSpec(pack=False).resolve(g).segmin_flat is None
    assert tsolve.SolveSpec().resolve(None).backend == "cuda"  # the port's default device
    assert tsolve.SolveSpec().resolve(None).pack is False
    rs = tsolve.SolveSpec(mode="coarsen", segmin="cuda").resolve(g)
    assert rs.coarsen.segmin == "cuda" and rs.shortcut == "complete"
    assert tsolve.SolveSpec(mode="dist").resolve(g).shortcut == "csp"
    assert tsolve.SolveSpec(mode="stream").resolve(g).pack is None
    with pytest.raises(ValueError, match="pack32 index"):
        tsolve.SolveSpec(mode="stream", pack=True, batch_capacity=1 << 24).resolve(g)


def test_auto_pack_matches_reference():
    from repro.solve.spec import auto_pack as jauto, weights_packable as jwp
    from repro_torch.solve.spec import auto_pack as tauto, weights_packable as twp

    w = np.array([0.0, 3.0, 255.0, np.inf], np.float32)
    eid = np.array([0, 1, 2, 2**31 - 1], np.int32)
    valid = np.array([True, True, True, False])
    for ww, ee in [(w, eid), (w + 0.5, eid), (w * 2, eid), (w, eid + (1 << 24))]:
        assert tauto(ww, ee, valid, 4) == jauto(ww, ee, valid, 4)
        assert tauto(torch.from_numpy(ww), torch.from_numpy(ee), torch.from_numpy(valid), 4) == (
            jauto(ww, ee, valid, 4))
        assert twp(ww[valid]) == jwp(ww[valid])
    assert tauto(w, eid, valid, 1 << 24) is False
    assert tauto(w, eid, np.zeros(4, bool), 4) is True


@pytest.mark.parametrize("kw", [
    dict(mode="nope"), dict(variant="x"), dict(shortcut="baseline"), dict(segmin="pallas"),
    dict(segmin="jnp"), dict(dedupe="gpu"), dict(obs="loud"), dict(tuning="always"),
    dict(segmin="sorted"), dict(pack=False, segmin="cuda"), dict(fused=True),
    dict(coarsen=True), dict(capacity=0), dict(mode="stream", batch_capacity=0),
    dict(coarsen="yes", mode="coarsen"),
])
def test_spec_static_validation(kw):
    with pytest.raises(ValueError):
        tsolve.SolveSpec(**kw)


@pytest.mark.parametrize("kw,match", [
    (dict(mode="dist"), "needs a mesh"),
])
def test_unported_surfaces_raise(kw, match):
    """Every built-in mode is ported; ``mode="dist"`` without ``mesh=``
    raises ``ValueError``, as in the reference."""
    g = cpu_graph(random_graph(10, 20, seed=0))
    with pytest.raises(ValueError, match=match):
        tsolve.plan(g, tsolve.SolveSpec(**kw))
    with pytest.raises(ValueError, match="needs a mesh"):
        jsolve.plan(random_graph(10, 20, seed=0), jsolve.SolveSpec(**kw))


def test_plan_cache_and_registry(monkeypatch):
    from repro_torch.solve import planner, spec

    tsolve.clear_plan_cache()
    g1 = cpu_graph(random_graph(30, 90, seed=1))
    g2 = cpu_graph(random_graph(30, 90, seed=2).pad_to(g1.num_directed_edges))
    p1, p2 = tsolve.plan(g1), tsolve.plan(g2)
    assert p1.engine is p2.engine  # same resolved spec and shape: one engine
    assert tsolve.plan_cache_info() == (1, tsolve.PLAN_CACHE_MAXSIZE)
    p3 = tsolve.plan(g1, pack=False)
    assert p3.engine is not p1.engine and p3.spec.pack is False
    assert p1.cost is p2.cost and p1.cost.analyzed == "flat" and "flat" in repr(p1)
    assert p3.cost != p1.cost  # the float path moves other bytes
    assert tsolve.registered_modes() == ("flat", "coarsen", "dist", "stream")
    tsolve.clear_plan_cache()
    assert tsolve.plan_cache_info()[0] == 0
    # a registered mode becomes a legal spec mode and plans through its builder
    monkeypatch.setattr(planner, "_engines", dict(planner._engines))
    monkeypatch.setattr(spec, "EXTRA_MODES", set())
    with pytest.raises(ValueError, match="unknown mode"):
        tsolve.SolveSpec(mode="echo")

    class _Echo:
        def solve(self, target):
            return target.n

    tsolve.register_engine("echo", lambda target, rs, mesh: _Echo())
    assert tsolve.registered_modes() == ("flat", "coarsen", "dist", "stream", "echo")
    assert tsolve.plan(g1, mode="echo").solve() == g1.n
