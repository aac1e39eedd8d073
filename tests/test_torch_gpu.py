"""Tests of the port that need the card (marker ``gpu``): the CUDA kernels
against their plain versions, and the flat, coarsen and stream paths,
connectivity and SSSP on the card against the CPU, the tuner and the load
harness on the card, and a 1×1 NCCL dist plan. Elsewhere they skip. Run
them on an H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,e,lo,hi", [(1, 1000, 0, 1), (1000, 0, 0, 1000),
                                       (4097, 100_000, 0, 4097), (300, 50_000, -3, 310)])
def test_segment_min_flat_kernel_matches_plain(card, n, e, lo, hi):
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=card).manual_seed(n + e)
    keys = torch.randint(0, ref.PACK_IDENTITY + 1, (e,), generator=gen, device=card,
                         dtype=torch.int64)
    segs = torch.randint(lo, hi, (e,), generator=gen, device=card, dtype=torch.int32)
    before = ops.segment_min_flat.launches
    got = ops.segment_min_flat(keys, segs, n)
    torch.cuda.synchronize()
    assert ops.segment_min_flat.launches == before + 1
    assert torch.equal(got, ref.segment_min_flat_ref(keys, segs, n))


def _flat_inputs(card, e, n, seed, live_share=0.9):
    from repro_torch.kernels import ref

    gen = torch.Generator(device=card).manual_seed(seed)
    keys = torch.randint(0, ref.PACK_IDENTITY, (e,), generator=gen, device=card,
                         dtype=torch.int64)
    keys[torch.rand(e, generator=gen, device=card) >= live_share] = ref.PACK_IDENTITY
    segs = torch.randint(0, n, (e,), generator=gen, device=card, dtype=torch.int32)
    return keys, segs, gen


def _check_flat(keys, segs, n):
    from repro_torch.kernels import ops, ref

    before = ops.segment_min_flat.launches
    got = ops.segment_min_flat(keys, segs, n)
    torch.cuda.synchronize()
    assert ops.segment_min_flat.launches == before + 1
    assert torch.equal(got, ref.segment_min_flat_ref(keys, segs, n))


@pytest.mark.parametrize("view", ["keys[1:]", "segs[1:]", "segs[3:]", "keys[1:], segs[3:]"])
@pytest.mark.parametrize("e", [1, 3, 5, 33, (1 << 20) + 7])
def test_segment_min_flat_kernel_on_misaligned_views(card, view, e):
    keys, segs, _ = _flat_inputs(card, e + 3, 5000, e)
    ko = 1 if view.startswith("keys[1:]") else 0
    so = {"keys[1:]": 0, "segs[1:]": 1}.get(view, 3)
    _check_flat(keys[ko:ko + e], segs[so:so + e], 5000)


def _flat_adversarial(card, case):
    from repro_torch.kernels import ref

    ident = ref.PACK_IDENTITY
    e, n = 300_007, 20_000
    keys, segs, gen = _flat_inputs(card, e, n, 7)
    if case == "runs across warps and blocks":
        # runs of equal ids, ~300 long in the first half and ~3 in the second,
        # so that runs start and end anywhere in a warp's or block's edges
        p = torch.where(torch.arange(e, device=card) < e // 2, 1 / 300, 1 / 3)
        step = torch.rand(e, generator=gen, device=card) < p
        segs = (torch.cumsum(step, 0) % n).to(torch.int32)
    elif case == "a live key only every 9th edge":
        keys[torch.arange(e, device=card) % 9 != 0] = ident
    elif case == "all-identity warps between live ones":
        keys.view(-1)[: e - e % 512].view(-1, 512)[::2] = ident  # every other 512 edges dead
    elif case == "ids out of range inside runs of equal ids":
        segs = torch.sort(segs).values
        segs[torch.rand(e, generator=gen, device=card) < 0.2] = -1
        segs[torch.rand(e, generator=gen, device=card) < 0.2] = n
    elif case == "one segment takes 2.1M of 14.5M live edges":
        e, n = 16_085_642, 1 << 20
        keys, segs, gen = _flat_inputs(card, e, n, 8, live_share=0.903)
        segs[torch.rand(e, generator=gen, device=card) < 0.146] = 12_345
    return keys, segs.contiguous(), n


@pytest.mark.parametrize("case", [
    "runs across warps and blocks", "a live key only every 9th edge",
    "all-identity warps between live ones", "ids out of range inside runs of equal ids",
    "one segment takes 2.1M of 14.5M live edges"])
def test_segment_min_flat_kernel_adversarial(card, case):
    _check_flat(*_flat_adversarial(card, case))


def test_main_path_on_card_matches_cpu(card):
    from repro_torch.graphs import rmat_graph
    from repro_torch.kernels import ops
    from repro_torch.solve import SolveSpec, plan

    g_card = rmat_graph(12, 8, seed=3, device=card)
    g_cpu = rmat_graph(12, 8, seed=3, device="cpu")
    p = plan(g_card, SolveSpec())
    assert p.resolved.segmin_flat is ops.segment_min_flat
    ops.segment_min_flat.launches = 0
    a = p.solve()
    assert ops.segment_min_flat.launches == a.iterations > 0
    b = plan(g_cpu, SolveSpec()).solve()
    np.testing.assert_array_equal(a.msf_eids, b.msf_eids)
    np.testing.assert_array_equal(a.parent, b.parent)
    assert (a.weight, a.iterations) == (b.weight, b.iterations)


@pytest.mark.parametrize("n,e,run", [(1, 5000, 5000), (4097, 0, 1), (1 << 16, 1 << 16, 1),
                                     (300_000, 1_000_000, 7), (1000, 100_000, 90_000)])
def test_segment_min_sorted_kernel_matches_plain(card, n, e, run):
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=card).manual_seed(n + e)
    keys = torch.randint(0, ref.PACK_IDENTITY + 1, (e,), generator=gen, device=card,
                         dtype=torch.int64)
    # sorted ids in runs of about `run` edges, with gaps (empty segments)
    steps = (torch.rand(e, generator=gen, device=card) < 1.0 / run).to(torch.int32)
    segs = (torch.cumsum(steps * 3, 0, dtype=torch.int32) % max(n, 1)).sort().values
    before = ops.segment_min_sorted.launches
    got = ops.segment_min_sorted(keys, segs.contiguous(), n)
    torch.cuda.synchronize()
    assert ops.segment_min_sorted.launches == before + 1
    assert torch.equal(got, ref.segment_min_sorted_ref(keys, segs, n))
    # unsorted ids: still the exact minimum
    perm = torch.randperm(e, generator=gen, device=card)
    assert torch.equal(ops.segment_min_sorted(keys[perm], segs[perm].contiguous(), n),
                       ref.segment_min_sorted_ref(keys, segs, n))


def test_coarsen_path_on_card_matches_cpu(card):
    from repro_torch.coarsen import CoarsenConfig
    from repro_torch.graphs import grid_road_graph
    from repro_torch.kernels import ops
    from repro_torch.solve import SolveSpec, plan

    spec = SolveSpec(mode="coarsen", coarsen=CoarsenConfig(cutoff=64))
    p = plan(grid_road_graph(64, 64, seed=3, device=card), spec)
    ops.segment_min_flat.launches = ops.segment_min_sorted.launches = 0
    a = p.solve()
    be = p.engine.last_backends
    assert (be.hook, be.dedupe_segmin, be.dedupe) == (
        ops.segment_min_flat, ops.segment_min_sorted, "device")
    assert ops.segment_min_sorted.launches == len(a.levels) >= 1
    assert ops.segment_min_flat.launches > 0
    b = plan(grid_road_graph(64, 64, seed=3, device="cpu"), spec).solve()
    np.testing.assert_array_equal(a.msf_eids, b.msf_eids)
    np.testing.assert_array_equal(a.parent, b.parent)
    assert (a.weight, a.iterations, a.levels) == (b.weight, b.iterations, b.levels)


@pytest.mark.parametrize("n", [1, 31, 33, 256, 257, 4097])
def test_multilinear_dense_kernel_matches_plain(card, n):
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=card).manual_seed(n)
    a = torch.randint(1, 6, (n, n), generator=gen, device=card).to(torch.float32)  # ties
    a[torch.rand(n, n, generator=gen, device=card) < 0.3] = float("inf")
    a[torch.rand(n, n, generator=gen, device=card) < 0.05] = float("nan")
    a[torch.rand(n, n, generator=gen, device=card) < 0.01] = float("-inf")
    a[: max(1, n // 10)] = float("inf")  # rows with no entry
    for p in (torch.randint(0, max(1, n // 4), (n,), generator=gen, device=card),
              torch.zeros(n, dtype=torch.int32, device=card),
              torch.arange(n, dtype=torch.int32, device=card)):
        before = ops.multilinear_dense.launches
        got = ops.multilinear_dense(p, a)
        torch.cuda.synchronize()
        assert ops.multilinear_dense.launches == before + 1
        for g, w in zip(got, ref.multilinear_dense_ref(p.to(torch.int32), a)):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("block_rows", [8, 128, 1024])
def test_segment_min_bucketed_kernel_matches_plain(card, block_rows):
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=card).manual_seed(block_rows)
    n, e = 50_000, 400_000
    seg = torch.randint(0, n, (e,), generator=gen, device=card)
    seg[: e // 4] = 17  # one row holds a quarter of the edges
    keys = torch.randint(0, ref.PACK_IDENTITY + 1, (e,), generator=gen, device=card,
                         dtype=torch.int64)
    kb, rb = ops.bucket_edges_by_row_block(seg, keys, n, block_rows)
    rb = torch.where(torch.rand(rb.shape, generator=gen, device=card) < 0.01,
                     rb - block_rows, rb).to(torch.int32)  # some rows out of range
    before = ops.segment_min_bucketed.launches
    got = ops.segment_min_bucketed(kb, rb, block_rows=block_rows)
    torch.cuda.synchronize()
    assert ops.segment_min_bucketed.launches == before + 1
    assert torch.equal(got, ref.segment_min_bucketed_ref(kb, rb, block_rows))


@pytest.mark.parametrize("case", [
    "BE = 128, one chunk", "one 27,264-wide bucket over many chunks",
    "a bucket all padding", "one row holds a whole wide bucket",
    "wide buckets, block_rows = 8", "wide buckets, block_rows = 1024"])
def test_segment_min_bucketed_kernel_split_layouts(card, case):
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=card).manual_seed(len(case))
    nb, be, block_rows = (1, 128, 128) if case.startswith("BE = 128") else (3, 27_264, 128)
    if case.startswith("one 27,264"):
        nb = 1
    if case.startswith("wide buckets"):
        block_rows = int(case.rsplit(" ", 1)[1])
    keys = torch.randint(0, ref.PACK_IDENTITY + 1, (nb, be), generator=gen, device=card,
                         dtype=torch.int64)
    rows = torch.randint(-2, block_rows + 2, (nb, be), generator=gen, device=card,
                         dtype=torch.int32)
    if case == "a bucket all padding":
        keys[1] = ref.PACK_IDENTITY
    if case == "one row holds a whole wide bucket":
        rows[2] = block_rows - 1
    chunks, _ = ops.bucketed_split(nb, be, block_rows, ops._sm_count(keys.device))
    assert chunks == (1 if be == 128 else ops._MAX_CLUSTER)
    before = ops.segment_min_bucketed.launches
    got = ops.segment_min_bucketed(keys, rows, block_rows=block_rows)
    torch.cuda.synchronize()
    assert ops.segment_min_bucketed.launches == before + 1
    assert torch.equal(got, ref.segment_min_bucketed_ref(keys, rows, block_rows))


def test_segment_min_bucketed_refuses_too_many_block_rows(card):
    from repro_torch.kernels import ops

    keys = torch.zeros((1, 128), dtype=torch.int64, device=card)
    rows = torch.zeros((1, 128), dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="segment_min_bucketed launch failed"):
        ops.segment_min_bucketed(keys, rows, block_rows=1 << 15)  # 256 KB of slots


def test_connectivity_and_sssp_on_card_match_cpu(card):
    from repro_torch.core import connected_components
    from repro_torch.core.sssp import sssp
    from repro_torch.graphs import grid_road_graph, rmat_graph

    for make in (lambda dev: rmat_graph(12, 8, seed=3, device=dev),
                 lambda dev: grid_road_graph(40, 50, seed=3, device=dev)):
        gc, gp = make(card), make("cpu")
        a, b = connected_components(gc), connected_components(gp)
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y)
        (da, ia), (db, ib) = sssp(gc, 0), sssp(gp, 0)
        assert ia == ib and torch.equal(da.cpu(), db)


@pytest.mark.parametrize("coarsen", [False, True])
def test_stream_path_on_card_matches_cpu(card, coarsen):
    """One insert / delete / compact / recertify trace through a stream
    plan on the card and one on the CPU: every report and the durable
    state identical after every op. Without coarsening each union solve
    launches the flat kernel once per AS round; with a low threshold the
    levels launch the sorted kernel too."""
    from _torch_util import StreamTrace, assert_same_state, assert_same_stream_report
    from repro_torch.coarsen import CoarsenConfig
    from repro_torch.kernels import ops
    from repro_torch.solve import SolveSpec, plan

    n, cap = 512, 64
    extra = dict(coarsen=CoarsenConfig(cutoff=8), coarsen_threshold=128) if coarsen else {}
    spec = SolveSpec(mode="stream", batch_capacity=cap, reservoir_capacity=24,
                     reservoir_per_component=4, **extra)
    pc, pp = plan(n, spec), plan(n, spec, device="cpu")
    assert pc.engine.device.type == "cuda" and pp.engine.device.type == "cpu"
    trace = StreamTrace(n, cap, seed=5)
    ops.segment_min_flat.launches = ops.segment_min_sorted.launches = 0
    for i in range(30):
        op, args = trace.insert() if i < 3 else trace.next_op()
        surface = {"insert": "update"}.get(op, op)
        before = ops.segment_min_flat.launches
        a = getattr(pc, surface)(*args)
        torch.cuda.synchronize()
        assert_same_stream_report(getattr(pp, surface)(*args), a)
        assert_same_state(pp.engine.state_dict(), pc.engine.state_dict())
        if not coarsen and surface != "delete":
            assert ops.segment_min_flat.launches - before == a.iterations
        q = trace.rng.integers(0, n, (2, 100))
        np.testing.assert_array_equal(pc.query(*q), pp.query(*q))
    assert ops.segment_min_flat.launches > 0
    assert (ops.segment_min_sorted.launches > 0) == coarsen


def test_span_attach_synchronises_the_card(card, monkeypatch):
    """A span holding CUDA tensors synchronises their device before it
    closes; obs off, no span syncs."""
    from repro_torch import obs

    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: (calls.append(device), real(device)))
    try:
        obs.enable("trace")
        with obs.span("s") as sp:
            sp.attach({"x": (torch.ones(4, device=card), np.ones(2))})
        assert calls == [torch.device("cuda", torch.cuda.current_device())]
        obs.disable()
        with obs.span("s") as sp:
            sp.attach(torch.ones(4, device=card))
        assert len(calls) == 1
    finally:
        obs.disable()
        obs.reset()
        obs.metrics_reset()


def test_obs_modes_on_the_card(card):
    """The flat and coarsen solves with obs off, "metrics" and "trace":
    identical reports, one msf.round span per AS round, and the kernel
    launches counted in the obs registry while metrics are on."""
    from repro_torch import obs
    from repro_torch.graphs import random_graph
    from repro_torch.kernels import ops
    from repro_torch.solve import SolveSpec, plan

    g = random_graph(2048, 8192, seed=3, device=card)
    try:
        for mode in ("coarsen", "flat"):
            base = plan(g, SolveSpec(mode=mode)).solve()
            for m in ("metrics", "trace"):
                obs.reset()
                obs.metrics_reset()
                before = ops.segment_min_flat.launches
                rep = plan(g, SolveSpec(mode=mode, obs=m)).solve()
                launched = ops.segment_min_flat.launches - before
                for f in ("weight", "n_msf_edges", "iterations"):
                    assert getattr(rep, f) == getattr(base, f), (mode, m, f)
                np.testing.assert_array_equal(rep.msf_eids, base.msf_eids)
                np.testing.assert_array_equal(rep.parent, base.parent)
                counted = obs.metrics_snapshot()["counters"]
                assert counted.get("kernel.segment_min_flat.launches", 0) == launched > 0
                if m == "trace" and mode == "flat":
                    rounds = sum(e[0] == "msf.round" for e in obs.trace_events())
                    assert rounds == rep.iterations
    finally:
        obs.disable()
        obs.reset()
        obs.metrics_reset()


def test_server_on_the_card_answers_like_the_cpu_server(card):
    """The same frames to a server over a stream plan on the card and one
    on the CPU: the same responses (uptime aside)."""
    from repro_torch import obs, serve
    from repro_torch.solve import SolveSpec, plan

    spec = SolveSpec(mode="stream", batch_capacity=256)
    out = []
    try:
        for dev in ("cuda", "cpu"):
            p = plan(300, spec, device=dev)
            h = serve.start_in_thread(p, serve.ServeConfig(port=0))
            got = []
            try:
                with serve.ServeClient(h.address, timeout=60) as c:
                    r = np.random.default_rng(9)
                    for _ in range(4):
                        u, v = r.integers(0, 300, (2, 200))
                        got.append(c.insert(u, v, r.integers(1, 99, 200).astype(float)))
                        q = r.integers(0, 300, (2, 64))
                        got += [c.connected(*q), c.component_id(q[0]),
                                c.component_size(q[1])]
                    flo, fhi, _, _ = p.engine.forest_edges()
                    got.append(c.delete(flo[:5], fhi[:5]))
                    st = c.status()
                    st["result"].pop("uptime_s")
                    got.append(st)
            finally:
                h.drain(timeout=60)
            out.append(got)
    finally:
        obs.disable()
        obs.metrics_reset()
    assert out[0] == out[1]


def test_tune_on_the_card_never_runs_the_plain_segment_min(card):
    """A full flat sweep on the card: no candidate resolves to the plain
    segment-min, every pack32 candidate launches the kernel once per AS
    round, and the winner resolves to the kernel or the float path."""
    from repro_torch.graphs import rmat_graph
    from repro_torch.kernels import ops, ref
    from repro_torch.solve import tune

    g = rmat_graph(12, 8, seed=3, device=card)
    cands = tune.enumerate_candidates(g, "flat", space="full")
    assert all(c.segmin != "torch" for c in cands)
    for c in cands:
        rs = c.resolve(g)
        assert rs.segmin_flat is not ref.segment_min_flat_ref
        assert rs.segmin_flat is (ops.segment_min_flat if rs.pack else None)

    def timer(spec, solve_fn):
        samples = []
        for _ in range(2):
            before = ops.segment_min_flat.launches
            rep = solve_fn()
            torch.cuda.synchronize()
            launched = ops.segment_min_flat.launches - before
            assert launched == (rep.iterations if spec.pack else 0)
            samples.append(1.0)
        return samples

    res = tune.tune(g, "flat", space="full", timer=timer)
    assert len(res.ranking) == len(cands) and res.key.backend == "cuda"
    assert res.winner.segmin != "torch"
    res = tune.tune(g, "flat", space="smoke", iters=2)  # the real clock
    assert all(r.median_us > 0 for r in res.ranking)


def test_loadgen_on_the_card(card, tmp_path):
    """Three seconds of in-process load on the card: the report passes
    tools/check_slo_report.py and the writer's unions launched the flat
    kernel."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.launch import loadgen

    root = Path(__file__).resolve().parent.parent
    out = tmp_path / "slo.json"
    before = ops.segment_min_flat.launches
    try:
        rc = loadgen.main(["--qps", "2000", "--duration", "3", "--scale", "14",
                           "--writer-batch", "4096", "--micro-batch", "256",
                           "--out", str(out)])
    finally:
        obs.disable()
        obs.reset()
        obs.metrics_reset()
    assert rc == 0
    d = json.loads(out.read_text())
    assert d["env"]["backend"] == "cuda" and d["slo"]["passed"]
    assert d["writer"]["updates"] > 0 and d["queries"]["answered"] > 0
    assert ops.segment_min_flat.launches > before
    proc = subprocess.run([sys.executable, str(root / "tools" / "check_slo_report.py"), str(out)],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


_NCCL_1X1 = r"""
import numpy as np, torch, torch.distributed as dist
from repro_torch.coarsen import CoarsenConfig
from repro_torch.graphs import rmat_graph
from repro_torch.graphs.partition import partition_edges_2d
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.solve import SolveSpec, plan

def fields(r):
    return (r.weight, r.msf_eids.tolist(), r.parent.tolist(), r.n_msf_edges, r.iterations,
            tuple(map(tuple, r.levels)), r.host_roundtrips)

dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
mesh = make_mesh((1, 1), ("data", "model"))
assert mesh.backend == "nccl" and mesh.device.type == "cuda", mesh
g = rmat_graph(12, 8, seed=3, device="cuda")
part = partition_edges_2d(g, 1, 1)
flat = plan(g, SolveSpec()).solve()
for sc in ("csp", "os", "baseline"):
    p = plan(part, SolveSpec(mode="dist", shortcut=sc), mesh=mesh)
    assert p.resolved.pack and p.resolved.segmin_flat is ops.segment_min_flat
    before = ops.segment_min_flat.launches
    rep = p.solve()
    torch.cuda.synchronize()
    assert ops.segment_min_flat.launches - before == rep.iterations, sc
    assert rep.weight == flat.weight and rep.n_msf_edges == flat.n_msf_edges, sc
    assert set(rep.msf_eids.tolist()) == set(flat.msf_eids.tolist()), sc
    plain = plan(part, SolveSpec(mode="dist", shortcut=sc, segmin="torch"), mesh=mesh).solve()
    assert fields(plain) == fields(rep), sc
cfg = CoarsenConfig(cutoff=16, dedupe="device")
coarse = plan(g, SolveSpec(mode="coarsen", coarsen=cfg)).solve()
p = plan(part, SolveSpec(mode="dist", coarsen=cfg), mesh=mesh)
before = ops.segment_min_sorted.launches
rep = p.solve()
torch.cuda.synchronize()
assert len(rep.levels) >= 1 and rep.host_roundtrips == 0
assert ops.segment_min_sorted.launches - before >= len(rep.levels)
assert set(rep.msf_eids.tolist()) == set(coarse.msf_eids.tolist())
assert np.array_equal(rep.parent, coarse.parent) and rep.weight == coarse.weight
print("NCCL_1X1_OK")
dist.destroy_process_group()
"""


def test_dist_1x1_nccl_on_the_card(card):
    """A world-1 NCCL group in a fresh interpreter: the flat dist plan
    (csp, os, baseline) launches the flat kernel once per round and agrees
    with the flat solve and with its plain segment-min twin; the dist
    coarsen plan dedupes on the card (sorted kernel) and agrees with the
    coarsen solve."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", _NCCL_1X1], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert "NCCL_1X1_OK" in proc.stdout, proc.stdout + proc.stderr[-3000:]
