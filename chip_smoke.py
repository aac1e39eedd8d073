#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Phases:
  1. device: the card's name and power limit;
  2. build: every CUDA kernel from src/repro_torch/kernels/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card, exactly;
  4. the property-suite graph classes solved on the card and on the CPU
     (complete/csp/os x pack on/off): every SolveReport field identical;
  5. the main path, plan(graph, SolveSpec()).solve(), on R-MAT scale 20
     (Graph500 parameters, edge factor 8): pack32 and the CUDA kernel
     resolved, one kernel launch per AS round, forest weight and size
     checked against scipy, result identical to segmin="torch";
  6. the same on the 1024 x 1024 grid road proxy;
  7. times: each kernel (CUDA events) on the inputs of every AS round of
     the R-MAT main path, beside its plain version, the one PyTorch
     library call and its memory bound; end-to-end solve times with the
     kernel and with segmin="torch", host syncs per solve, and a
     torch.profiler breakdown of one solve.

Prints the kernels JSON line before the last line, and last
{"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
RMAT = dict(scale=20, edge_factor=8, seed=0)
GRID = (1024, 1024)
# (name, n, m, weight levels, multigraph, seed): the fixed-seed classes
# of tests/test_msf_properties.py, drawn the same way.
FIXED_CASES = [
    ("dense_ties", 24, 96, 3, False, 0),
    ("multigraph", 24, 96, 4, True, 1),
    ("sparse_isolated", 32, 20, 8, False, 2),
    ("duplicate_heavy_multi", 16, 80, 2, True, 3),
    ("single_edge", 16, 1, 1, False, 4),
    ("empty", 16, 0, 1, False, 5),
    ("two_cliques", 24, 60, 5, False, 6),
]


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def phase(title: str):
    print(f"== {title}", flush=True)


def fixed_graph(name, n, m, wlevels, multi, seed, device):
    import numpy as np

    from repro_torch.graphs.structures import from_edges, graph_from_canonical

    rng = np.random.default_rng(seed)
    if name == "two_cliques":
        half = n // 2
        u = rng.integers(0, half, m)
        v = rng.integers(0, half, m)
        flip = rng.random(m) < 0.5
        u = np.where(flip, u + half, u)
        v = np.where(flip, v + half, v)
    elif name == "sparse_isolated":
        u = rng.integers(0, n // 4, m)
        v = rng.integers(0, n // 4, m)
    else:
        u = rng.integers(0, n, m)
        v = rng.integers(0, n, m)
    w = rng.integers(1, wlevels + 1, m).astype(np.float64)
    if not multi:
        return from_edges(u, v, w, n, device=device)
    keep = u != v  # multigraph: duplicate pairs keep their own eids
    lo, hi = np.minimum(u, v)[keep], np.maximum(u, v)[keep]
    eid = np.arange(len(lo), dtype=np.int32)
    return graph_from_canonical(lo, hi, w[keep], eid, np.ones(len(lo), bool), n,
                                device=device)


def same_report(a, b) -> bool:
    import numpy as np
    import torch

    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if field == "raw":
            if not all(torch.equal(p.cpu(), q.cpu()) for p, q in zip(x, y)):
                return False
        elif isinstance(x, np.ndarray):
            if not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_cases(dev):
    """Phase 3: the segment-min kernel against its plain version, exactly."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(0)
    ident = ref.PACK_IDENTITY

    def keys_of(e, identity_share=0.1):
        k = torch.randint(0, ident, (e,), generator=gen, device=dev, dtype=torch.int64)
        hole = torch.rand(e, generator=gen, device=dev) < identity_share
        return torch.where(hole, ident, k)

    def segs_of(e, lo, hi):
        return torch.randint(lo, hi, (e,), generator=gen, device=dev, dtype=torch.int32)

    e_main, n_main = 16_085_642, 1 << 20
    skew = segs_of(e_main, 0, n_main)
    skew[torch.rand(e_main, generator=gen, device=dev) < 0.9] = 7
    cases = [
        ("uniform, main-path shape", keys_of(e_main), segs_of(e_main, 0, n_main), n_main),
        ("90% of edges in one segment", keys_of(e_main), skew, n_main),
        ("E = 0", keys_of(0), segs_of(0, 0, 1), 1000),
        ("single segment", keys_of(1 << 20), segs_of(1 << 20, 0, 1), 1),
        ("all keys the identity", torch.full((1 << 20,), ident, dtype=torch.int64, device=dev),
         segs_of(1 << 20, 0, 4096), 4096),
        ("num_segments not a power of two", keys_of(2_000_000), segs_of(2_000_000, 0, 1_000_003),
         1_000_003),
        ("ids out of range dropped", keys_of(1 << 20), segs_of(1 << 20, -5, 70_005), 70_000),
    ]
    max_err = 0
    for label, keys, segs, n in cases:
        got = ops.segment_min_flat(keys, segs, n)
        want = ref.segment_min_flat_ref(keys, segs, n)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape, f"{label}: shape/dtype")
        err = int((got - want).abs().max()) if n else 0
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"segment_min_flat != plain version ({label}), max err {err}")
        print(f"  segment_min_flat {label}: E={keys.numel()} n={n} exact", flush=True)
    return max_err


def small_graphs():
    """Phase 4: the property-suite classes, card vs CPU, every field."""
    from repro_torch.solve import SolveSpec, plan

    for case in FIXED_CASES:
        gc = fixed_graph(*case, device="cuda")
        gp = fixed_graph(*case, device="cpu")
        for shortcut in ("complete", "csp", "os"):
            for pack in (True, False):
                spec = SolveSpec(shortcut=shortcut, pack=pack)
                rc, rp = plan(gc, spec).solve(), plan(gp, spec).solve()
                check(same_report(rc, rp),
                      f"{case[0]} shortcut={shortcut} pack={pack}: card != CPU")
        print(f"  {case[0]}: card == CPU over complete/csp/os x pack on/off", flush=True)


def main_path(label, g):
    """Phases 5/6: drive plan(g, SolveSpec()).solve() and check it."""
    import numpy as np
    import torch

    from repro_torch.graphs.structures import nx_free_msf_weight, nx_free_n_components
    from repro_torch.kernels import ops
    from repro_torch.solve import SolveSpec, plan

    p = plan(g, SolveSpec())
    check(p.resolved.pack is True, f"{label}: SolveSpec() did not resolve pack32")
    check(p.resolved.segmin_flat is ops.segment_min_flat,
          f"{label}: the resolved segment-min is not the CUDA kernel")
    ops.segment_min_flat.launches = 0
    t0 = time.perf_counter()
    rep = p.solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ops.segment_min_flat.launches
    check(launches > 0 and launches == rep.iterations,
          f"{label}: {launches} kernel launches for {rep.iterations} AS rounds")

    valid = g.valid.cpu().numpy()
    eid = g.eid.cpu().numpy()[valid]
    w_by_eid = np.zeros(int(eid.max()) + 1, np.float64)
    w_by_eid[eid] = g.w.cpu().numpy()[valid]
    weight64 = float(w_by_eid[rep.msf_eids].sum())
    oracle = nx_free_msf_weight(g)
    ncomp = nx_free_n_components(g)
    check(weight64 == oracle, f"{label}: MSF weight {weight64} != scipy {oracle}")
    check(rep.n_msf_edges == g.n - ncomp,
          f"{label}: {rep.n_msf_edges} MSF edges != n - components = {g.n - ncomp}")
    check(len(set(rep.msf_eids.tolist())) == rep.n_msf_edges, f"{label}: repeated eids")

    plain = plan(g, SolveSpec(segmin="torch")).solve()
    check(plain.weight == rep.weight, f"{label}: weight differs from segmin='torch'")
    check(set(plain.msf_eids.tolist()) == set(rep.msf_eids.tolist()),
          f"{label}: eid set differs from segmin='torch'")
    check(np.array_equal(plain.parent, rep.parent), f"{label}: parent differs from segmin='torch'")
    check(plain.iterations == rep.iterations, f"{label}: iterations differ from segmin='torch'")
    print(f"  {label}: n={g.n} E={g.num_directed_edges} rounds={rep.iterations} "
          f"launches={launches} weight={weight64} (scipy {oracle}) "
          f"msf_edges={rep.n_msf_edges} components={ncomp} first_solve_s={first_s:.3f}",
          flush=True)
    return launches


def solve_times(g, reps: int = 3) -> dict:
    """Median end-to-end solve seconds, kernel vs segmin='torch', in turns
    after one warm-up each."""
    import torch

    from repro_torch.solve import SolveSpec, plan

    specs = {"cuda": SolveSpec(), "torch": SolveSpec(segmin="torch")}
    times = {k: [] for k in specs}
    for k in specs:
        plan(g, specs[k]).solve()
    for i in range(reps):
        for k in (("cuda", "torch") if i % 2 == 0 else ("torch", "cuda")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan(g, specs[k]).solve()
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t0)
    return {f"{k}_s": statistics.median(v) for k, v in times.items()}


def round_times(g) -> list:
    """The segment-min kernel, its plain version and the one PyTorch library
    call timed on the inputs each AS round of the default solve hands the
    segment-min (recorded in a replay of the default driver), beside the
    round's memory bound: keys and ids read once, the output written once."""
    import torch

    from repro_torch.core.msf import run_flat
    from repro_torch.kernels import ops, ref

    inputs = []

    def record(keys, segs, n):
        inputs.append((keys.clone(), segs.clone()))
        return ops.segment_min_flat(keys, segs, n)

    run_flat(g, pack=True, segmin=record)
    n = g.n
    rows = []
    for keys, segs in inputs:
        idx = segs.long()
        out = torch.full((n,), ref.PACK_IDENTITY, dtype=torch.int64, device=keys.device)
        bytes_ = keys.numel() * keys.element_size() + segs.numel() * segs.element_size() + n * 8
        rows.append({
            "kernel_ms": time_ms(lambda: ops.segment_min_flat(keys, segs, n)),
            "plain_ms": time_ms(lambda: ref.segment_min_flat_ref(keys, segs, n)),
            "library_ms": time_ms(
                lambda: out.scatter_reduce_(0, idx, keys, "amin", include_self=True)),
            "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3,
            "bytes": bytes_,
            "identity_key_share": float((keys == ref.PACK_IDENTITY).double().mean()),
        })
    return rows


def count_syncs(fn) -> int:
    """Host-device synchronisations during ``fn()``, as torch's sync debug
    mode reports them."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def profile_solve(g, top: int = 8) -> dict:
    """One default solve under torch.profiler: device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.solve import SolveSpec, plan

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        plan(g, SolveSpec()).solve()
        torch.cuda.synchronize()
    # Device-side rows only (kernels, copies): an op row repeats its kernels' time.
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "device_ms": sum(e.self_device_time_total for e in rows) / 1e3,
        "top": [{"op": e.key[:70], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
                for e in rows[:top]],
    }


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from repro_torch.graphs import grid_road_graph, rmat_graph
    from repro_torch.kernels import build

    phase("1 device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} | nvidia-smi: {smi}", flush=True)

    phase("2 build")
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)  # build from the sources, now
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    phase("3 kernels vs plain versions on the card")
    max_err = kernel_cases("cuda")

    phase("4 small graphs, card vs CPU")
    small_graphs()

    phase("5 main path: R-MAT scale 20, edge factor 8")
    t0 = time.perf_counter()
    g_rmat = rmat_graph(**RMAT, device="cuda")
    print(f"  generated in {time.perf_counter() - t0:.1f} s (host)", flush=True)
    launches = main_path("rmat_s20_ef8", g_rmat)

    phase("6 main path: grid 1024 x 1024")
    g_grid = grid_road_graph(*GRID, device="cuda")
    main_path("grid_1024x1024", g_grid)

    phase("7 times")
    per_round = round_times(g_rmat)
    print(json.dumps({"segment_min_flat_per_round_rmat_s20_ef8": per_round, "card": smi}))
    mean = {k: statistics.fmean(r[k] for r in per_round)
            for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    from repro_torch.solve import SolveSpec, plan

    solve = {}
    for label, g in (("rmat_s20_ef8", g_rmat), ("grid_1024x1024", g_grid)):
        p = plan(g, SolveSpec())
        solve[label] = {
            **solve_times(g),
            "rounds": p.solve().iterations,
            "host_syncs_per_solve": count_syncs(p.solve),
            "profile": profile_solve(g),
        }
    print(json.dumps({"solve_seconds_median_of_3": solve, "card": smi}))
    print(json.dumps({"kernels": [{
        "name": "segment_min_flat",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_min_flat.cu",
        "replaces": "src/repro/kernels/segment_min_bucketed.py:113",
        "launches": launches,
        "matches_plain": True,
        "max_abs_err": max_err,
        "ms": mean["kernel_ms"],
        "kernel_ms": mean["kernel_ms"],
        "plain_ms": mean["plain_ms"],
        "bound_ms": mean["bound_ms"],
        "bound_by": "bytes",
        "library_ms": mean["library_ms"],
        "timed_on": "each AS round's inputs of the R-MAT main path, mean per launch",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
