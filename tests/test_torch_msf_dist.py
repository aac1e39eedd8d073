"""The distributed Fig-2 driver (``mode="dist"``) of the port against the
JAX package on the same numpy inputs: every ``DistMSFResult`` field and
every report field equal.

- 1×1 in this process: the port on a world-1 gloo host mesh, the
  reference on the conftest's 1×1 ``host_mesh``, over every shortcut ×
  pack on/off × capacity {1, 2, 8, 64} on the graphs of
  ``tests/test_msf_dist.py``.
- 2×2, 2×4 and a (1, 2, 2) mesh with ``row_axis=("pod", "data")``: one
  spawned group of gloo ranks per world size (4 and 8) on a FileStore,
  every rank's result checked, against the reference run once in a
  subprocess on 8 forced host devices over ``tests/test_msf_dist.py``'s
  ``_SUBPROCESS`` matrix (flat csp/baseline/os, the float combine, the
  in-mesh coarsening levels with device and host dedupe), plus
  ``spmm_sum_2d`` and ``allreduce_argmin``.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_util import (  # noqa: E402
    assert_same_fields,
    cpu_graph,
    join_ranks,
    report_fields,
    start_ranks,
    stats_fields,
    to_np,
)
from repro import solve as jsolve  # noqa: E402
from repro.graphs import grid_road_graph, random_graph  # noqa: E402
from repro.graphs.partition import partition_edges_2d as jpartition  # noqa: E402
from repro_torch import solve as tsolve  # noqa: E402
from repro_torch.graphs.partition import partition_edges_2d as tpartition  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# ---------------------------------------------------------------------------
# 1×1 in process
# ---------------------------------------------------------------------------

_GRAPHS_1X1 = {
    "random_150_500_s3": lambda: random_graph(150, 500, seed=3),
    "random_200_700_s11": lambda: random_graph(200, 700, seed=11),
    "grid_14x15_s4": lambda: grid_road_graph(14, 15, seed=4),
}


@pytest.fixture(scope="module")
def port_mesh():
    return make_host_mesh(device="cpu")


def _assert_same_raw(want, got):
    """Every field of two ``DistMSFResult``s, values and dtypes."""
    assert got._fields == want._fields
    for f in want._fields:
        a, b = to_np(getattr(want, f)), to_np(getattr(got, f))
        np.testing.assert_array_equal(b, a, err_msg=f)
        assert b.dtype == a.dtype, f


@pytest.mark.parametrize("capacity", [1, 2, 8, 64])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("shortcut", ["csp", "os", "baseline"])
@pytest.mark.parametrize("graph", list(_GRAPHS_1X1))
def test_dist_1x1_matches_reference(host_mesh, port_mesh, graph, shortcut, pack, capacity):
    g = _GRAPHS_1X1[graph]()
    jp, tp = jpartition(g, 1, 1), tpartition(cpu_graph(g), 1, 1)
    spec = dict(mode="dist", shortcut=shortcut, pack=pack, capacity=capacity)
    want = jsolve.plan(jp, jsolve.SolveSpec(**spec), mesh=host_mesh).solve()
    got = tsolve.plan(tp, tsolve.SolveSpec(**spec), mesh=port_mesh).solve()
    _assert_same_raw(want.raw, got.raw)
    assert_same_fields(report_fields(want), report_fields(got))


# ---------------------------------------------------------------------------
# 2×2, 2×4 and 1×2×2: spawned rank groups against one reference subprocess
# ---------------------------------------------------------------------------

#: mesh label → (shape, axis names, row axis)
MESHES = {
    "2x2": ((2, 2), ("data", "model"), "data"),
    "2x4": ((2, 4), ("data", "model"), "data"),
    "1x2x2": ((1, 2, 2), ("pod", "data", "model"), ("pod", "data")),
}
#: the graphs of test_msf_dist._SUBPROCESS, built from the same seeds
GRAPHS = {
    "random_500_1500_s1": lambda: random_graph(500, 1500, seed=1),
    "grid_20x25_s2": lambda: grid_road_graph(20, 25, seed=2),
}
_LEVELS = dict(rounds_per_level=2, cutoff=16, fused=True)
#: spec label → SolveSpec kwargs ("coarsen": CoarsenConfig kwargs)
SPECS = {
    "csp": dict(shortcut="csp", capacity=4096),
    "baseline": dict(shortcut="baseline", capacity=4096),
    "os": dict(shortcut="os", capacity=4096),
    "csp_float": dict(shortcut="csp", capacity=4096, pack=False),
    "coarsen_device": dict(coarsen=dict(_LEVELS, dedupe="device")),
    "coarsen_host": dict(coarsen=dict(_LEVELS, dedupe="host")),
}
#: 2×4 runs _SUBPROCESS's matrix; 2×2 adds the float combine on one graph
CASES = ([("2x4", g, s) for g in GRAPHS for s in SPECS if s != "csp_float"]
         + [("2x2", "random_500_1500_s1", s)
            for s in ("csp", "csp_float", "coarsen_device", "coarsen_host")]
         + [("1x2x2", "random_500_1500_s1", s) for s in ("csp", "coarsen_device")])
EXTRA = [(m, x) for m in ("2x2", "2x4") for x in ("spmm_sum_2d", "allreduce_argmin")]
SPMM_H = 5
ARGMIN_N = 32


def _argmin_inputs(size: int):
    """Per-rank EdgeMin partials with ties in w and eid, from a seed."""
    rng = np.random.default_rng(7)
    w = rng.integers(0, 4, (size, ARGMIN_N)).astype(np.float32)
    w[rng.random((size, ARGMIN_N)) < 0.2] = np.inf
    eid = rng.integers(0, 6, (size, ARGMIN_N)).astype(np.int32)
    pay = rng.integers(0, 1000, (size, ARGMIN_N)).astype(np.int32)
    return w, eid, pay


_REFERENCE = r"""
import pickle, sys
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro import solve
from repro.coarsen import CoarsenConfig
from repro.compat import make_mesh, shard_map
from repro.core.multilinear import spmm_sum_2d
from repro.core.semiring import EdgeMin, allreduce_argmin
sys.path.insert(0, "tests")
from test_torch_msf_dist import (ARGMIN_N, CASES, EXTRA, GRAPHS, MESHES, SPECS, SPMM_H,
                                 _argmin_inputs, _reference_fields)
from repro.graphs.partition import partition_edges_2d

assert jax.device_count() == 8, jax.device_count()
meshes = {k: make_mesh(shape, axes) for k, (shape, axes, _) in MESHES.items()}
out = {}
for m, g, s in CASES:
    shape, axes, row_axis = MESHES[m]
    part = partition_edges_2d(GRAPHS[g](), int(np.prod(shape[:-1])), shape[-1])
    kw = dict(SPECS[s])
    if "coarsen" in kw:
        kw["coarsen"] = CoarsenConfig(**kw["coarsen"])
    p = solve.plan(part, solve.SolveSpec(mode="dist", row_axis=row_axis, **kw), mesh=meshes[m])
    out[(m, g, s)] = _reference_fields(p, p.solve())
for m, x in EXTRA:
    (R, C), _, _ = MESHES[m]
    mesh = meshes[m]
    if x == "spmm_sum_2d":
        part = partition_edges_2d(GRAPHS["random_500_1500_s1"](), R, C)
        xs = np.random.default_rng(0).standard_normal((part.n_pad, SPMM_H)).astype(np.float32)
        def run(x, src_row, dst_col, valid):
            return spmm_sum_2d(x, src_row.reshape(-1), dst_col.reshape(-1), valid.reshape(-1),
                               row_axis="data", col_axis="model", shard_size=part.shard_size,
                               col_block_size=R * part.shard_size)
        f = jax.jit(shard_map(run, mesh=mesh, in_specs=(P(("data", "model"), None),) + (
            P("data", "model", None),) * 3, out_specs=P(("data", "model"), None)))
        out[(m, x)] = np.asarray(f(xs, part.src_row, part.dst_col, part.valid))
    else:
        w, eid, pay = _argmin_inputs(R * C)
        def run(w, eid, pay):
            em = allreduce_argmin(EdgeMin(w=w[0], eid=eid[0], payload=(pay[0],)), "model")
            em = allreduce_argmin(em, "data")
            return em.w[None], em.eid[None], em.payload[0][None]
        spec = P(("data", "model"), None)
        f = jax.jit(shard_map(run, mesh=mesh, in_specs=(spec,) * 3, out_specs=(spec,) * 3))
        res = f(w, eid, pay)
        out[(m, x)] = tuple(np.asarray(a) for a in res)
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
"""

_RANKS = r"""
import sys
sys.path.insert(0, "tests")
from repro_torch import solve
from repro_torch.coarsen import CoarsenConfig
from repro_torch.core.multilinear import spmm_sum_2d
from repro_torch.core.semiring import EdgeMin, allreduce_argmin
from repro_torch.launch.mesh import make_mesh
from _torch_util import report_fields, stats_fields

meshes = {k: make_mesh(shape, axes, device="cpu")
          for k, (shape, axes, _) in INPUTS["meshes"].items()}
for (m, g, s), part in INPUTS["cases"].items():
    _, _, row_axis = INPUTS["meshes"][m]
    kw = dict(INPUTS["specs"][s])
    if "coarsen" in kw:
        kw["coarsen"] = CoarsenConfig(**kw["coarsen"])
    p = solve.plan(part, solve.SolveSpec(mode="dist", row_axis=row_axis, **kw), mesh=meshes[m])
    rep = p.solve()
    fields = report_fields(rep)
    if "coarsen" in kw:
        fields["stats"] = stats_fields(p.driver.last_stats)
    else:
        fields["raw"] = tuple(r.numpy() for r in rep.raw)
    OUT[(m, g, s)] = fields
for (m, x), data in INPUTS["extra"].items():
    mesh = meshes[m]
    k = mesh.axis_index(("data", "model"))
    if x == "spmm_sum_2d":
        part, xs = data
        r, s, S = mesh.axis_index("data"), mesh.axis_index("model"), part.shard_size
        y = spmm_sum_2d(torch.from_numpy(xs[k * S:(k + 1) * S]),
                        torch.from_numpy(part.src_row[r, s]), torch.from_numpy(part.dst_col[r, s]),
                        torch.from_numpy(part.valid[r, s]), mesh=mesh, row_axis="data",
                        col_axis="model", shard_size=S, col_block_size=mesh.shape[0] * S)
        OUT[(m, x)] = y.numpy()
    else:
        w, eid, pay = data
        em = EdgeMin(w=torch.from_numpy(w[k]), eid=torch.from_numpy(eid[k]),
                     payload=(torch.from_numpy(pay[k]),))
        em = allreduce_argmin(allreduce_argmin(em, mesh, "model"), mesh, "data")
        OUT[(m, x)] = (em.w.numpy(), em.eid.numpy(), em.payload[0].numpy())
"""


def _reference_fields(p, rep) -> dict:
    """What the rank groups report of a solve, from a reference plan."""
    fields = report_fields(rep)
    if p.resolved.coarsen is not None:
        fields["stats"] = stats_fields(p.driver.last_stats)
    else:
        fields["raw"] = tuple(np.asarray(r) for r in rep.raw)
    return fields


def _rank_inputs(world: int) -> dict:
    labels = [m for m, (shape, _, _) in MESHES.items() if int(np.prod(shape)) == world]
    cases = {}
    for m, g, s in CASES:
        if m in labels:
            shape = MESHES[m][0]
            cases[(m, g, s)] = tpartition(cpu_graph(GRAPHS[g]()), int(np.prod(shape[:-1])),
                                          shape[-1])
    extra = {}
    for m, x in EXTRA:
        if m in labels:
            (R, C) = MESHES[m][0]
            if x == "spmm_sum_2d":
                part = tpartition(cpu_graph(GRAPHS["random_500_1500_s1"]()), R, C)
                xs = np.random.default_rng(0).standard_normal(
                    (part.n_pad, SPMM_H)).astype(np.float32)
                extra[(m, x)] = (part, xs)
            else:
                extra[(m, x)] = _argmin_inputs(R * C)
    return {"meshes": {m: MESHES[m] for m in labels}, "specs": SPECS, "cases": cases,
            "extra": extra}


@pytest.fixture(scope="module", autouse=True)
def _grid_runs(tmp_path_factory):
    """The reference subprocess and both rank groups, started when the
    module's first test starts, so that they run beside the 1×1 tests;
    whatever still runs at the module's end is killed."""
    tmp = tmp_path_factory.mktemp("msf_dist")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref_log = open(tmp / "reference.log", "w")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(tmp / "reference.pkl")],
                           cwd=ROOT, env=env, stdout=ref_log, stderr=subprocess.STDOUT)
    groups = {}
    try:
        for w in (4, 8):
            groups[w] = start_ranks(_RANKS, w, _rank_inputs(w), tmp / f"world{w}")
        yield tmp, ref, groups
    finally:
        for p in [ref] + [q for _, procs in groups.values() for q, _ in procs]:
            if p.poll() is None:
                p.kill()
                p.wait()
        ref_log.close()
        for _, procs in groups.values():
            for _, log in procs:
                log.close()


@pytest.fixture(scope="module")
def grid_results(_grid_runs):
    """(reference results, {world: every rank's results})."""
    tmp, ref, groups = _grid_runs
    ranks = {w: join_ranks(h, timeout=240) for w, h in groups.items()}
    try:
        ref.wait(timeout=300)
    except subprocess.TimeoutExpired:
        ref.kill()
        ref.wait()
    assert ref.returncode == 0, (tmp / "reference.log").read_text()[-4000:]
    with open(tmp / "reference.pkl", "rb") as f:
        return pickle.load(f), ranks


def _ranks_of(mesh_label: str, grid_results):
    return grid_results[1][int(np.prod(MESHES[mesh_label][0]))]


def _assert_same_case(want: dict, got: dict):
    want, got = dict(want), dict(got)
    if "raw" in want:  # every DistMSFResult field, values and dtypes
        for x, y in zip(want.pop("raw"), got.pop("raw"), strict=True):
            np.testing.assert_array_equal(y, x)
            assert y.dtype == x.dtype
    assert_same_fields(want, got)


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_dist_grid_matches_reference(grid_results, case):
    want = grid_results[0][case]
    for rank, out in enumerate(_ranks_of(case[0], grid_results)):
        try:
            _assert_same_case(want, out[case])
        except AssertionError as e:
            raise AssertionError(f"rank {rank}: {e}") from e


@pytest.mark.parametrize("extra", EXTRA, ids=["-".join(c) for c in EXTRA])
def test_dist_grid_collectives_match_reference(grid_results, extra):
    m, what = extra
    want = grid_results[0][extra]
    (R, C) = MESHES[m][0]
    ranks = _ranks_of(m, grid_results)
    if what == "spmm_sum_2d":
        # Every rank holds its own shard; float sums run in another order.
        got = np.concatenate([ranks[k][extra] for k in range(R * C)])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        for k, out in enumerate(ranks):
            for a, b in zip(want, out[extra]):
                np.testing.assert_array_equal(b, a[k])


def test_dist_needs_a_matching_mesh(port_mesh):
    tp = tpartition(cpu_graph(random_graph(30, 60, seed=0)), 2, 1)
    with pytest.raises(ValueError, match="2x1"):
        tsolve.plan(tp, tsolve.SolveSpec(mode="dist"), mesh=port_mesh)


# ---------------------------------------------------------------------------
# the mesh and the plan's resolve on a Partition2D
# ---------------------------------------------------------------------------

def test_mesh_axes_groups_and_errors(port_mesh):
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    assert port_mesh.shape == (1, 1) and port_mesh.axis_names == ("data", "model")
    assert port_mesh.devices.shape == (1, 1) and port_mesh.coords == (0, 0)
    assert port_mesh.axis_index(("data", "model")) == 0 and port_mesh.axis_size("model") == 1
    assert {port_mesh: 1}[port_mesh] == 1  # hashable: it keys the plan cache
    x = torch.arange(5, dtype=torch.int32)
    assert torch.equal(port_mesh.all_gather(x, ("data", "model")), x)
    assert torch.equal(port_mesh.all_reduce(x, "min", "data"), x)
    with pytest.raises(ValueError, match="mesh order"):
        port_mesh.axis_index(("model", "data"))
    with pytest.raises(ValueError, match="unknown mesh axes"):
        port_mesh.group("pod")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    if torch.cuda.is_available():
        assert make_host_mesh().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()


@pytest.mark.parametrize("weights", ["int", "float"])
def test_resolve_probes_pack32_on_a_partition(weights):
    from repro.graphs.structures import from_edges

    rng = np.random.default_rng(5)
    w = rng.integers(1, 9, 90).astype(np.float64) + (0.5 if weights == "float" else 0.0)
    g = from_edges(rng.integers(0, 40, 90), rng.integers(0, 40, 90), w, 40)
    jp, tp = jpartition(g, 2, 2), tpartition(cpu_graph(g), 2, 2)
    want = jsolve.SolveSpec(mode="dist").resolve(jp)
    got = tsolve.SolveSpec(mode="dist").resolve(tp, backend="cpu")
    assert got.pack is want.pack is (weights == "int")
    assert got.shortcut == want.shortcut == "csp"
