#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Phases:
  1. device: the card's name and power limit;
  2. build: every CUDA kernel from src/repro_torch/kernels/csrc with nvcc,
     one nvcc per source, all at once;
  3. each kernel against its plain PyTorch version on the card, exactly:
     segment_min_flat on adversarial layouts (the main-path shape, 90% of
     the edges on one segment, R-MAT's round-2 shape with 2.1M live edges
     on one segment, runs crossing warp and block boundaries, a live key
     every 9th edge, all-identity warps between live ones, ids out of range
     inside runs, misaligned views keys[1:], segs[1:], segs[3:] at
     E in {1, 3, 5, 33, 2^20 + 7}); segment_min_sorted on the
     adversarial sorted layouts (one segment, all singletons, runs over
     many tiles, empty segments and gaps, E = 0, odd tails), one run
     holding 90% of the edges, and the dedupe inputs of level 0 of both
     coarsen graphs (recorded from a replay of the levels);
     multilinear_dense at n in {1, 31, 33, 257, 4096, 4097} with empty
     rows, all-equal weights, NaN and -inf entries, p all equal and all
     distinct; segment_min_bucketed on the E = 0 layout, rows out of range
     on both sides, one row holding a whole bucket, BE = 128, 27,264-wide
     buckets split over clusters (one all padding, one row holding a whole
     bucket, and as views at an offset), block_rows in {8, 128, 1024};
  4. the property-suite graph classes solved on the card and on the CPU
     (flat: complete/csp/os x pack on/off; coarsen with a small cutoff):
     every SolveReport field identical;
  5. the flat path, plan(graph, SolveSpec()).solve(), on R-MAT scale 20
     (Graph500 parameters, edge factor 8): pack32 and the CUDA kernel
     resolved, one kernel launch per AS round, forest weight and size
     checked against scipy, result identical to segmin="torch";
  6. the same on the 1024 x 1024 grid road proxy;
  6b. the coarsen path, plan(graph, SolveSpec(mode="coarsen")).solve(), on
     R-MAT scale 19, edge factor 8: level pack32, device dedupe, the hook
     on segment_min_flat and the dedupe on segment_min_sorted resolved;
     the sorted kernel launched once per level, the flat kernel twice per
     hook round and once per residual round; weight and size against
     scipy; eid set and partition equal to the flat solve's; the report equal
     to the plain solve's (segmin="torch", dedupe="host");
  6c. the same on the 1024 x 1024 grid;
  6d. the kernel entry points at real size: multilinear_dense on the dense
     adjacency of R-MAT scale 14, edge factor 8, seed 1 and of scale 12,
     edge factor 64, seed 1 (the Fig-8 graphs of
     benchmarks/bench_multilinear.py), with p = arange(n) and with p after
     one flat AS round, against its plain version and min_outgoing_dense;
     segment_min_bucketed on bucket_edges_by_row_block(src, pack32(w, eid),
     n) of the 1024 x 1024 grid and of R-MAT scale 14 (the first AS round's
     per-vertex minimum), against its plain version and segment_min_flat;
     one launch per call;
  6e. connected_components and sssp (from vertex 0) on R-MAT scale 20 and
     the grid: component count against scipy, partition against the flat
     solve's, distances exactly against scipy's Dijkstra; rounds, host
     syncs and median solve times, and sssp with each relaxation form
     forced (every candidate scattered, as the reference does, or only
     the improving ones), in turns;
  6f. the stream path, plan(n, SolveSpec(mode="stream")): A, the
     reference's acceptance stream (R-MAT scale 16, edge factor 2, seed 7,
     batch_capacity 8192; n = 2^16, so the packed live-key probe runs on
     the card), flat and coarsen-assisted (coarsen_threshold 2^15): the
     union shape after every batch, weight and partition against scipy
     and the flat solve, the same forest gids both ways, one flat launch
     per AS round, the sorted kernel launched by the levels; B, the first
     32 of the 62 batches of 131,072 pairs of phase 5's graph (n > 2^16:
     the host probe): weight and partition against scipy, one flat launch
     per AS round, 2^14 QueryService answers against scipy's labels and
     component sizes, a third of the pairs deleted, the unhealed deletions
     recertified (coarsen-assisted: the sorted kernel), the result against
     scipy's MSF of the survivors, and a save_stream/restore_stream round
     trip into a fresh engine; insert latency (median, p95), host syncs
     and the host stages of one update, query throughput (the device's
     busy time over one more update is profiled last, in phase 7);
  6g. serving: `python -m repro_torch.launch.serve_graph --serve` on phase
     5's graph (R-MAT scale 20, edge factor 8, seed 0, batch capacity
     131,072, warmed with the first eighth of the stream) in a
     subprocess, driven with the port's ServeClient: insert frames of
     131,072 pairs of the same stream while 4 client threads pipeline
     query frames of 4,096 points of all three query ops, one delete
     frame of 2^14 forest edges (edges to degree-1 vertices: bridges, so
     scipy's forest of the survivors is known), status and metrics; every
     answer against scipy's components of the prefix its snapshot
     version names, the weight after the delete against scipy, the
     server's flat-kernel launches (its kernel.segment_min_flat.launches
     counter) against the AS rounds of the same writes replayed here;
     SIGTERM drains it into a checkpoint and a second server restores
     it: the same version, a bit-identical weight, the same answers;
     insert latency (client clock: median and maximum of the frames),
     query e2e latency (the server's
     serve.e2e_latency_s), queries per second, host syncs per insert;
  6h. obs on the card: the flat solve of R-MAT scale 20, a coarsen solve
     of the grid and one stream update with obs off, "metrics" and
     "trace": identical reports, one msf.round span per AS round, the
     exported traces accepted by tools/check_trace.py, host syncs per
     flat solve (40 with obs off and with "metrics"; "trace" adds one
     explicit sync per msf.round span and one for msf.flat) and median
     solve times per mode;
  6i. cost, tuner and load harness: plan.cost of the flat plans of phase
     5's and 6's graphs and the coarsen plans of 6b's and 6c's, its
     roofline prediction for the report's rounds beside the median solve
     and the device busy time, the cost the report's, no host sync in the
     model, the flat model's segment-min term equal to round 1's bytes
     with every key live, 40 host syncs per R-MAT s20 flat solve;
     tune(g, "flat", space="full") on R-MAT s20 and the grid and
     tune(g, "coarsen", space="full") on the grid with a timer that checks
     each measured solve's launches (one flat launch per AS round), no
     candidate or winner on the plain segment-min, every candidate the
     same forest (tune asserts it), the database through
     `python -m repro_torch.launch.tune --check`, tuning="db" solves
     equal in every field but cost to tuning="off" with the winner's knobs
     (and, flat, with the default ones), and with the default knobs the
     same weight, eid set and partition; `serve_graph
     --loadgen` on phase 5's graph in process and against a `serve_graph
     --serve` subprocess with 6g's arguments (`--target`), each at the
     highest offered rate it sustains from 10,000 queries/s, the reports
     through tools/check_slo_report.py, the writer's updates and deletes,
     the flat kernel's launches in the run (the tuner and the load
     harness run after phase 7, last: they need no profiler session, and
     after a coarsen sweep torch.profiler drops most device events);
  6j. the distributed drivers, plan(part, SolveSpec(mode="dist"),
     mesh=mesh).solve() on a Partition2D (run last, after the tuner and the
     load harness): 1x1 on NCCL in this process (world 1) — the flat
     Fig-2 solve of phase 5's graph with the csp (default, capacity 2^16),
     os and baseline shortcuts: pack32 and the flat kernel resolved, one
     flat launch per round, weight, edge count, eid set and partition equal
     to the flat solve's (checked against scipy in phase 5), the report
     identical to segmin="torch"; the in-mesh coarsening levels on 6b's and
     6c's graphs: device dedupe, no host round trip, the sorted kernel once
     per level, the flat kernel twice per hook and residual round, eid set,
     weight and partition equal to the coarsen solve's; then 2x2 over gloo,
     four spawned ranks sharing the one card (NCCL refuses two ranks on one
     device): the flat solve of phase 5's graph and the coarsen levels on
     the grid, every rank's report identical to the others' and to the
     1x1 report (the levels' m columns count per-block entries, so they
     differ by layout and are left out), every rank's launches checked;
     rounds, host syncs, launches and median solve times beside the flat
     and coarsen solves' medians (four ranks on one card are not a
     distributed measurement);
  7. times: each kernel (device time from torch.profiler, and CUDA
     events around back-to-back calls) on the inputs of its main path
     (segment_min_flat: every AS round of the R-MAT and the grid flat
     solves, each row with its live share and its bound;
     segment_min_sorted: every level's dedupe of both coarsen graphs;
     multilinear_dense and segment_min_bucketed: the inputs of 6d, with
     the split the bucketed wrapper chose),
     beside its plain version, the one PyTorch library call and its memory
     bound; end-to-end solve times (flat: kernel vs segmin="torch";
     coarsen vs flat), host syncs per solve, and torch.profiler
     breakdowns.

Prints the kernels JSON line before the last line, and last
{"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.

On a host with four cards, `python3 -c "import chip_smoke;
chip_smoke.dist_cards()"` runs phase 6j's 2x2 grid with one NCCL rank
per card against the 1x1 solve.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
RMAT = dict(scale=20, edge_factor=8, seed=0)
# The largest Graph500 R-MAT at edge factor 8 whose levels take pack32:
# they need 2 * next_pow2(m) < 2^24 - 1 (m = undirected edges).
RMAT_COARSEN = dict(scale=19, edge_factor=8, seed=0)
GRID = (1024, 1024)
# Phase 6f. A: the reference's acceptance stream (tests/test_stream.py),
# n = 2^16 so the packed live-key probe runs on the card. B: the flat main
# path's graph in batches of 131,072 (n > 2^16: the host int64 probe).
STREAM_A = dict(scale=16, edge_factor=2, seed=7)
STREAM_A_BATCH = 8192
STREAM_B_BATCH = 131_072
# A prefix of B's 62 batches: 32 batches, 4,194,304 of its 8,042,821
# pairs, keep phase 6f near 45 s, and the survivors of the delete third
# (2,796,203) fit the coarsening levels' pack32 index field
# (2 * next_pow2(m) < 2^24 - 1), so the recertify runs the sorted kernel.
STREAM_B_BATCHES = 32
# Above every insert union's live edges ((n - 1) + 131,072), below the
# survivors a recertify replays: the inserts stay flat, the recertify is
# coarsen-assisted.
STREAM_B_COARSEN_THRESHOLD = 1 << 21
STREAM_QUERIES = 1 << 14
# Phase 6g: phase 5's graph served by `serve_graph --serve` in a subprocess,
# warmed with the first eighth of its stream, then driven over loopback.
SERVE_BATCH = 131_072
SERVE_WARM_FRAC = 0.125
SERVE_INSERT_FRAMES = 6
SERVE_QUERY_POINTS = 1 << 12
SERVE_QUERY_THREADS = 4
SERVE_DELETES = 1 << 14
# 4 threads x 2 pipelined 4,096-point queries fit the admission queue;
# a flush fuses at most 4 of them, QueryService's 2^14-point batch limit.
SERVE_FLAGS = ("--micro-batch", str(1 << 14), "--queue-cap", str(1 << 16))
SERVE_START_TIMEOUT_S = 600
# Phase 6i: the load harness on phase 5's graph, in process and against a
# server started with 6g's arguments. The offered rate walks from 10,000
# queries/s, doubling while the run sustains it and halving until one does.
LOADGEN_FLAGS = ("--scale", "20", "--edge-factor", "8", "--seed", "0", "--writer-batch",
                 "131072", "--micro-batch", "4096", "--queue-cap", "65536", "--duration", "10")
LOADGEN_QPS0 = 10_000
LOADGEN_ATTEMPTS = 3
# Host syncs of one flat R-MAT s20 solve (5 AS rounds; phase 6h, PR 16).
FLAT_RMAT_SYNCS = 40
# Phase 6j: the 2x2 grid as four processes on the one card, over gloo.
DIST_GRID = (2, 2)
DIST_JOIN_TIMEOUT_S = 300
# The Fig-8 graphs of benchmarks/bench_multilinear.py, small enough for a
# dense n x n float32 adjacency (1 GiB and 64 MiB).
DENSE_GRAPHS = {"rmat_s14_ef8": dict(scale=14, edge_factor=8, seed=1),
                "rmat_s12_ef64": dict(scale=12, edge_factor=64, seed=1)}
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
    """Every field of two SolveReports equal but ``cost``: that is the
    plan's analysis, not a result, and it follows the plan's resolved
    backends (the CPU's fused coarsen plan dedupes on the host)."""
    import numpy as np
    import torch

    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if field == "cost":
            continue
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


def device_rows(fn, reps: int = 1, attempts: int = 5) -> list:
    """torch.profiler's device-side rows (kernels, copies) over ``reps``
    calls of ``fn``, each with a non-zero self time. The profiler now and
    then records no device event for a run, which would read as a 0.0 ms
    kernel: such a run is profiled again, and after ``attempts`` the script
    fails rather than report a time it did not measure."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if sum(e.count for e in rows) >= reps:  # at least one device event per call
            return rows
    fail(f"torch.profiler recorded no device time for {reps} call(s) of {fn!r:.100} "
         f"in {attempts} attempts")


def device_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Device time of one call of ``fn``: the self time of every kernel and
    copy it ran, summed by torch.profiler over ``reps`` calls. Unlike
    :func:`time_ms` it leaves out the host's time to enqueue the call,
    which bounds a small launch."""
    for _ in range(warmup):
        fn()
    rows = device_rows(fn, reps)
    return sum(e.self_device_time_total for e in rows) / 1e3 / reps


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
    # R-MAT s20 round 2: 90.3% of the keys live, 2.1M of them on one root
    round2 = segs_of(e_main, 0, n_main)
    round2[torch.rand(e_main, generator=gen, device=dev) < 0.146] = 4_321
    e_adv, n_adv = (1 << 20) + 7, 70_000
    # runs of equal ids, ~300 long in the first half and ~3 in the second
    step = torch.rand(e_adv, generator=gen, device=dev) < torch.where(
        torch.arange(e_adv, device=dev) < e_adv // 2, 1 / 300, 1 / 3)
    runs = (torch.cumsum(step, 0) % n_adv).to(torch.int32)
    ninth = keys_of(e_adv, 0.0)
    ninth[torch.arange(e_adv, device=dev) % 9 != 0] = ident
    dead_warps = keys_of(e_adv)
    dead_warps[: e_adv - e_adv % 1024].view(-1, 1024)[::2] = ident
    run_oor = torch.sort(segs_of(e_adv, 0, n_adv)).values
    run_oor[torch.rand(e_adv, generator=gen, device=dev) < 0.2] = -1
    run_oor[torch.rand(e_adv, generator=gen, device=dev) < 0.2] = n_adv
    k_view, s_view = keys_of(e_adv + 3), segs_of(e_adv + 3, 0, n_adv)
    views = [(f"view {kl}, {sl}, E = {e}", k_view[ko:ko + e], s_view[so:so + e], n_adv)
             for kl, ko, sl, so in (("keys[1:]", 1, "segs[0:]", 0), ("keys[0:]", 0, "segs[1:]", 1),
                                    ("keys[0:]", 0, "segs[3:]", 3), ("keys[1:]", 1, "segs[3:]", 3))
             for e in (1, 3, 5, 33, e_adv)]
    cases = [
        ("uniform, main-path shape", keys_of(e_main), segs_of(e_main, 0, n_main), n_main),
        ("90% of edges in one segment", keys_of(e_main), skew, n_main),
        ("R-MAT round-2 shape, 2.1M live edges on one segment", keys_of(e_main, 0.097), round2,
         n_main),
        ("runs crossing warp and block boundaries", keys_of(e_adv), runs, n_adv),
        ("a live key only every 9th edge", ninth, segs_of(e_adv, 0, n_adv), n_adv),
        ("all-identity warps between live ones", dead_warps, segs_of(e_adv, 0, n_adv), n_adv),
        ("ids out of range inside runs of equal ids", keys_of(e_adv), run_oor, n_adv),
        *views,
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


def sorted_layouts(dev):
    """Adversarial sorted-id layouts at scale: (label, segs, num_segments)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)

    def ids(n, e, run):
        # sorted ids in runs of about `run` edges, with empty segments between
        steps = (torch.rand(e, generator=gen, device=dev) < 1.0 / run).to(torch.int32)
        jump = torch.randint(1, 4, (e,), generator=gen, device=dev, dtype=torch.int32)
        return torch.clamp(torch.cumsum(steps * jump, 0, dtype=torch.int32), max=n - 1)

    e = 1 << 22
    big = torch.zeros(e, dtype=torch.int32, device=dev)
    big[e // 20:] = 1
    big[e // 20 + int(0.9 * e):] = 2
    return [
        ("one segment", torch.zeros(e, dtype=torch.int32, device=dev), 1),
        ("all singletons", torch.arange(e, dtype=torch.int32, device=dev), e),
        ("one run holding 90% of the edges", big, 3),
        ("runs of ~3000 over many tiles, gaps", ids(e, e, 3000), e),
        ("runs of ~3, gaps (empty segments)", ids(e, e, 3), e),
        ("E = 0", torch.zeros(0, dtype=torch.int32, device=dev), 1000),
        ("odd tail 1025 of 127 segments", ids(127, 1025, 9), 127),
        ("odd tail 1023 x 1023 singletons", torch.arange(1023, dtype=torch.int32, device=dev),
         1023),
        ("ids past num_segments dropped", ids(1 << 20, e, 4), 1 << 19),
    ]


def sorted_kernel_cases(dev, recorded) -> int:
    """Phase 3: the sorted-segment kernel against its plain version,
    exactly, on the adversarial layouts and on ``recorded`` dedupe inputs
    ((label, keys, segs, num_segments) from a replay of the levels)."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(2)
    cases = []
    for label, segs, n in sorted_layouts(dev):
        e = segs.numel()
        keys = torch.randint(0, ref.PACK_IDENTITY, (e,), generator=gen, device=dev,
                             dtype=torch.int64)
        hole = torch.rand(e, generator=gen, device=dev) < 0.1
        cases.append((label, torch.where(hole, ref.PACK_IDENTITY, keys), segs, n))
    max_err = 0
    for label, keys, segs, n in cases + list(recorded):
        got = ops.segment_min_sorted(keys, segs, n)
        want = ref.segment_min_sorted_ref(keys, segs, n)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape, f"{label}: shape/dtype")
        err = int((got - want).abs().max()) if n else 0
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"segment_min_sorted != plain version ({label}), "
                                      f"max err {err}")
        print(f"  segment_min_sorted {label}: E={keys.numel()} n={n} exact", flush=True)
    return max_err


def record_dedupe_inputs(g) -> list:
    """Replay the coarsen main path's levels and record what each level's
    dedupe hands the sorted segment-min: [(keys, segs, num_segments)]."""
    from repro_torch.coarsen import CoarsenConfig, run_levels
    from repro_torch.kernels import ops

    inputs = []

    def record(keys, segs, n):
        inputs.append((keys.clone(), segs.clone(), n))
        return ops.segment_min_sorted(keys, segs, n)

    run_levels(g, CoarsenConfig(), segmins=(ops.segment_min_flat, record))
    return inputs


def triple_err(got, want) -> float:
    """Largest absolute difference between two (minw, mincol, minpay)
    triples; equal entries (+inf included) count 0, an inf against a
    finite value counts inf."""
    import torch

    w_g, w_w = got[0].double(), want[0].double()
    same = (w_g == w_w) | (w_g.isnan() & w_w.isnan())
    errs = [float(torch.where(same, 0.0, (w_g - w_w).abs().nan_to_num(float("inf"))).max())]
    errs += [float((g.long() - w.long()).abs().max()) for g, w in zip(got[1:], want[1:])]
    return max(errs) if got[0].numel() else 0.0


def dense_kernel_cases(dev) -> float:
    """Phase 3: multilinear_dense against its plain version, exactly, at n
    not a multiple of 4 or 32 (the 4-byte load path) and at n = 4096 (the
    16-byte load path). Never +0.0 and -0.0 tied for a row's minimum: the
    kernel's minw takes the winning column's sign, torch.amin either."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(3)
    inf = float("inf")
    max_err = 0.0
    for n in (1, 31, 33, 257, 4096, 4097):
        def rand(lo, hi):
            return torch.randint(lo, hi, (n, n), generator=gen, device=dev).to(torch.float32)

        def mask(share):
            return torch.rand(n, n, generator=gen, device=dev) < share

        sparse = torch.where(mask(0.7), inf, rand(1, 256))
        sparse[: max(1, n // 8)] = inf  # rows with no entry
        special = rand(1, 9)
        special[mask(0.2)] = float("nan")
        special[mask(0.02)] = -inf
        cases = [
            ("random, empty rows", sparse),
            ("all-equal weights (ties to the smallest column)",
             torch.full((n, n), 7.0, device=dev)),
            ("NaN and -inf entries", special),
            ("negative weights", rand(-5, 5)),  # integer values: no -0.0
        ]
        ps = [("p random", torch.randint(0, max(1, n // 5), (n,), generator=gen, device=dev,
                                         dtype=torch.int32)),
              ("p all equal", torch.zeros(n, dtype=torch.int32, device=dev)),
              ("p all distinct", torch.arange(n, dtype=torch.int32, device=dev))]
        for label, a in cases:
            for plabel, pv in ps:
                got = ops.multilinear_dense(pv, a)
                want = ref.multilinear_dense_ref(pv, a)
                torch.cuda.synchronize()
                err = triple_err(got, want)
                max_err = max(max_err, err)
                check(all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)),
                      f"multilinear_dense != plain version (n={n}, {label}, {plabel}), "
                      f"max err {err}")
        print(f"  multilinear_dense n={n}: {len(cases)} inputs x {len(ps)} p: exact", flush=True)
    return max_err


def bucketed_kernel_cases(dev) -> int:
    """Phase 3: segment_min_bucketed against its plain version, exactly."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(4)
    ident = ref.PACK_IDENTITY
    max_err = 0
    for br in (8, 128, 1024):
        n, e = 300_000, 2_000_000
        seg = torch.randint(0, n, (e,), generator=gen, device=dev)
        keys = torch.randint(0, ident, (e,), generator=gen, device=dev, dtype=torch.int64)
        keys[torch.rand(e, generator=gen, device=dev) < 0.1] = ident
        kb, rb = ops.bucket_edges_by_row_block(seg, keys, n, br)
        wild = torch.randint(-3 * br, 3 * br, rb.shape, generator=gen, device=dev,
                             dtype=torch.int32)
        one_row = rb.clone()
        one_row[1] = br // 2  # one row holds a whole bucket
        ke, re_ = ops.bucket_edges_by_row_block(seg[:0], keys[:0], n, br)
        # a few wide buckets (R-MAT s14's width), each split over a cluster
        wide_k = torch.randint(0, ident + 1, (5, 27_264), generator=gen, device=dev,
                               dtype=torch.int64)
        wide_k[1] = ident  # a bucket all padding
        wide_r = torch.randint(-2, br + 2, wide_k.shape, generator=gen, device=dev,
                               dtype=torch.int32)
        wide_r[2] = br - 1  # one row holds a whole wide bucket
        # the same layout 8 bytes (keys) and 12 bytes (rows) into its storage
        off_k = torch.empty(wide_k.numel() + 1, dtype=torch.int64, device=dev)
        off_k[1:] = wide_k.reshape(-1)
        off_r = torch.empty(wide_r.numel() + 3, dtype=torch.int32, device=dev)
        off_r[3:] = wide_r.reshape(-1)
        cases = [
            ("uniform", kb, rb),
            ("rows out of range, negative and >= block_rows", kb, torch.where(
                torch.rand(rb.shape, generator=gen, device=dev) < 0.3, wild, rb)),
            ("one row holds a whole bucket", kb, one_row),
            ("E = 0 layout", ke, re_),
            ("BE = 128, one bucket", kb[:1, :128].contiguous(), rb[:1, :128].contiguous()),
            ("27,264-wide buckets split over chunks, one all padding, one row holding a "
             "whole bucket", wide_k, wide_r),
            ("the wide layout as views at an offset", off_k[1:].view(wide_k.shape),
             off_r[3:].view(wide_r.shape)),
        ]
        for label, k, r in cases:
            got = ops.segment_min_bucketed(k, r, block_rows=br)
            want = ref.segment_min_bucketed_ref(k, r, br)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f"segment_min_bucketed != plain version (block_rows={br}, {label}), "
                  f"max err {err}")
            split = ops.bucketed_split(*k.shape, br, ops._sm_count(k.device))
            print(f"  segment_min_bucketed block_rows={br} {label}: NB x BE = "
                  f"{tuple(k.shape)} (chunks, buckets per block) = {split} exact", flush=True)
    return max_err


def dense_adjacency(g):
    """float32 [n, n]: the least weight of the edges from i to j, +inf where
    there is none (a scatter-min of w over src * n + dst)."""
    import torch

    v = g.valid
    idx = g.src[v].long() * g.n + g.dst[v].long()
    a = torch.full((g.n * g.n,), float("inf"), dtype=torch.float32, device=g.device)
    a.scatter_reduce_(0, idx, g.w[v], "amin", include_self=True)
    return a.view(g.n, g.n)


def vertex_min_keys(g):
    """(seg, keys): the first AS round's per-vertex minimum, segment = src,
    key = pack32(w, eid) of every valid directed edge."""
    import torch

    from repro_torch.core.semiring import pack32

    v = g.valid
    return g.src[v], pack32(g.w[v].to(torch.int64), g.eid[v])


def entry_points(dense_graphs, bucket_graphs):
    """Phase 6d: drive the two kernels' entry points at real size, then
    check what they returned. Returns (launches, inputs for phase 7,
    max errors)."""
    import torch

    from repro_torch.core.msf import run_flat
    from repro_torch.core.multilinear import min_outgoing_dense
    from repro_torch.kernels import ops, ref

    dense_in = {}
    for label, g in dense_graphs.items():
        a = dense_adjacency(g)
        dense_in[label] = {"a": a, "g": g}
    bucket_in = {}
    for label, g in bucket_graphs.items():
        seg, keys = vertex_min_keys(g)
        kb, rb = ops.bucket_edges_by_row_block(seg, keys, g.n)
        bucket_in[label] = {"seg": seg, "keys": keys, "kb": kb, "rb": rb, "n": g.n}
    torch.cuda.synchronize()

    # The path: the counts are 0 just before it and read just after.
    ops.multilinear_dense.launches = ops.segment_min_bucketed.launches = 0
    ops.segment_min_flat.launches = 0
    calls = {"multilinear_dense": 0, "segment_min_bucketed": 0}
    for label, d in dense_in.items():
        g = d["g"]
        one_round = run_flat(g, max_iters=1, pack=True, segmin=ops.segment_min_flat)
        d["p"] = {"p = arange(n)": torch.arange(g.n, dtype=torch.int32, device=g.device),
                  "p after one AS round": one_round.parent}
        d["out"] = {k: ops.multilinear_dense(pv, d["a"]) for k, pv in d["p"].items()}
        calls["multilinear_dense"] += len(d["p"])
    for label, b in bucket_in.items():
        b["out"] = ops.segment_min_bucketed(b["kb"], b["rb"])
        calls["segment_min_bucketed"] += 1
    torch.cuda.synchronize()
    launches = {"multilinear_dense": ops.multilinear_dense.launches,
                "segment_min_bucketed": ops.segment_min_bucketed.launches,
                "segment_min_flat": ops.segment_min_flat.launches}
    for name, c in calls.items():
        check(launches[name] == c, f"{name}: {launches[name]} launches for {c} calls")
    check(launches["segment_min_flat"] == len(dense_in),
          f"segment_min_flat: {launches['segment_min_flat']} launches for "
          f"{len(dense_in)} one-round solves")

    err = {"multilinear_dense": 0.0, "segment_min_bucketed": 0}
    for label, d in dense_in.items():
        g, a = d["g"], d["a"]
        for plabel, pv in d["p"].items():
            got = d["out"][plabel]
            want = ref.multilinear_dense_ref(pv, a)
            em = min_outgoing_dense(pv, a)
            torch.cuda.synchronize()
            e = triple_err(got, want)
            err["multilinear_dense"] = max(err["multilinear_dense"], e)
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"{label} {plabel}: multilinear_dense != plain version, max err {e}")
            check(all(torch.equal(x, y) for x, y in zip(got, (em.w, em.eid, em.payload[0]))),
                  f"{label} {plabel}: multilinear_dense != min_outgoing_dense")
            hooked = int((got[0] < float("inf")).sum())
            print(f"  multilinear_dense {label} {plabel}: n={g.n} E={g.num_directed_edges} "
                  f"rows with an outgoing edge {hooked}; == plain, == min_outgoing_dense",
                  flush=True)
    for label, b in bucket_in.items():
        n, kb = b["n"], b["kb"]
        got = b["out"]
        want = ref.segment_min_bucketed_ref(kb, b["rb"], 128)
        flat = ops.segment_min_flat(b["keys"], b["seg"], n)
        torch.cuda.synchronize()
        e = int((got - want).abs().max())
        err["segment_min_bucketed"] = max(err["segment_min_bucketed"], e)
        check(torch.equal(got, want), f"{label}: segment_min_bucketed != plain, max err {e}")
        check(torch.equal(got[:n], flat) and bool((got[n:] == ref.PACK_IDENTITY).all()),
              f"{label}: segment_min_bucketed != segment_min_flat on the same keys")
        nb, be = kb.shape
        e_real = b["keys"].numel()
        b["fill"] = e_real / (nb * be)
        print(f"  segment_min_bucketed {label}: E={e_real} NB={nb} BE={be} "
              f"fill={b['fill']:.4f} layout_bytes={nb * be * 12}; == plain, "
              f"== segment_min_flat", flush=True)
    for b in bucket_in.values():
        del b["out"]
    for d in dense_in.values():
        del d["out"]
    return launches, dense_in, bucket_in, err


def cc_sssp(label, g, flat_rep) -> dict:
    """Phase 6e: connected_components and sssp from vertex 0 on ``g``,
    checked against scipy and the flat solve; rounds, host syncs, median
    solve times, and sssp with each relaxation form forced (every
    candidate scattered, or only the improving ones), in turns."""
    from unittest import mock

    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    import torch

    from repro_torch.coarsen.relabel import canonical_minvertex_labels
    from repro_torch.core import connected_components
    from repro_torch.core import sssp as sssp_mod
    from repro_torch.graphs.structures import nx_free_n_components

    t0 = time.perf_counter()
    cc = connected_components(g)
    torch.cuda.synchronize()
    cc_first = time.perf_counter() - t0
    ncomp = nx_free_n_components(g)
    check(int(cc.n_components) == ncomp,
          f"{label}: {int(cc.n_components)} components != scipy {ncomp}")
    same = torch.equal(canonical_minvertex_labels(cc.parent, g.n).cpu(),
                       canonical_minvertex_labels(flat_rep.parent, g.n))
    check(same, f"{label}: connected_components partition differs from the flat MSF's")

    t0 = time.perf_counter()
    d, it = sssp_mod.sssp(g, 0)
    torch.cuda.synchronize()
    sssp_first = time.perf_counter() - t0
    valid = g.valid.cpu().numpy()
    src, dst, w = (x.cpu().numpy()[valid] for x in (g.src, g.dst, g.w))
    a = sp.coo_matrix((w.astype(np.float64), (src, dst)), shape=(g.n, g.n)).tocsr()
    want = csg.dijkstra(a, directed=True, indices=0)
    got = d.cpu().numpy().astype(np.float64)
    if not np.array_equal(got, want):
        fail(f"{label}: sssp != scipy Dijkstra at {int((got != want).sum())} vertices")
    hub = int(torch.bincount(g.dst[g.valid].long(), minlength=g.n).max())
    form = "improving" if hub > sssp_mod.HUB_IN_DEGREE else "all"

    def sssp_scattering(which):
        # each form forced through the threshold, the default left as it is
        limit = {"improving": -1, "all": g.num_directed_edges}[which]
        with mock.patch.object(sssp_mod, "HUB_IN_DEGREE", limit):
            return sssp_mod.sssp(g, 0)

    for which in ("improving", "all"):
        d_f, it_f = sssp_scattering(which)
        check(torch.equal(d_f, d) and it_f == it, f"{label}: sssp scattering {which} differs")

    def timed(fn, reps=3):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out)

    forms = {"improving": [], "all": []}
    for i in range(3):  # in turns: improving, all, all, improving, ...
        for which in (("improving", "all") if i % 2 == 0 else ("all", "improving")):
            forms[which].append(timed(partial(sssp_scattering, which), reps=1))
    row = {
        "cc_rounds": int(cc.iterations),
        "components": ncomp,
        "cc_first_s": cc_first,
        "cc_s": timed(lambda: connected_components(g)),
        "cc_host_syncs": count_syncs(lambda: connected_components(g)),
        "sssp_rounds": it,
        "sssp_reached": int(np.isfinite(got).sum()),
        "sssp_first_s": sssp_first,
        "sssp_largest_in_degree": hub,
        "sssp_scatters": form,
        "sssp_s": timed(lambda: sssp_mod.sssp(g, 0)),
        "sssp_scattering_improving_s": statistics.median(forms["improving"]),
        "sssp_scattering_all_s": statistics.median(forms["all"]),
        "sssp_host_syncs": count_syncs(lambda: sssp_mod.sssp(g, 0)),
    }
    print(f"  {label}: components={ncomp} (scipy) cc_rounds={row['cc_rounds']} "
          f"partition == flat MSF; sssp_rounds={it} reached={row['sssp_reached']} "
          f"== scipy Dijkstra; {json.dumps(row)}", flush=True)
    return row


def dense_times(dense_in) -> list:
    """multilinear_dense and its plain version timed on the entry-point
    inputs, beside the bound: the adjacency read once (n^2 * 4 B), p read
    and the three outputs written once (16 B per row)."""
    from repro_torch.kernels import ops, ref

    rows = []
    for label, d in dense_in.items():
        a = d["a"]
        n = a.shape[0]
        bytes_ = n * n * 4 + n * 16
        for plabel, pv in d["p"].items():
            kernel = partial(ops.multilinear_dense, pv, a)
            rows.append({
                "input": f"{label}, {plabel}",
                "n": n,
                "kernel_ms": device_ms(kernel),
                "kernel_call_ms": time_ms(kernel),
                "plain_ms": device_ms(partial(ref.multilinear_dense_ref, pv, a), reps=3),
                "library_ms": None,
                "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3,
                "bytes": bytes_,
            })
    return rows


def bucketed_times(bucket_in) -> list:
    """segment_min_bucketed, its plain version and one scatter_reduce_ amin
    over the flattened ids b * 128 + rows, timed on the entry-point layouts,
    beside the bound: every entry's key read once, padding included (8 B);
    the row read once only where the key is not the identity (4 B), since an
    identity key leaves the result as it is whatever its row; the output
    written once (8 B per row)."""
    import torch

    from repro_torch.kernels import ops, ref

    rows = []
    for label, b in bucket_in.items():
        kb, rb = b["kb"], b["rb"]
        nb, be = kb.shape
        idx = (torch.arange(nb, device=kb.device)[:, None] * 128 + rb.long()).reshape(-1)
        flat_keys = kb.reshape(-1)
        out = torch.full((nb * 128,), ref.PACK_IDENTITY, dtype=torch.int64, device=kb.device)
        live = int((kb != ref.PACK_IDENTITY).sum())
        bytes_ = nb * be * 8 + live * 4 + nb * 128 * 8
        kernel = partial(ops.segment_min_bucketed, kb, rb)
        # The same layout with every entry's row spread over the block
        # (e % 128): the same bytes, no row holding more than its share.
        spread = (torch.arange(be, device=kb.device, dtype=torch.int32) % 128).expand(nb, be)
        chunks, per_block = ops.bucketed_split(nb, be, 128, ops._sm_count(kb.device))
        rows.append({
            "input": label,
            "NB": nb,
            "BE": be,
            "chunks": chunks,
            "buckets_per_block": per_block,
            "fill": b["fill"],
            "kernel_ms": device_ms(kernel),
            "kernel_call_ms": time_ms(kernel),
            "kernel_rows_spread_ms": device_ms(partial(ops.segment_min_bucketed, kb,
                                                       spread.contiguous())),
            "plain_ms": device_ms(partial(ref.segment_min_bucketed_ref, kb, rb, 128)),
            "library_ms": device_ms(partial(out.scatter_reduce_, 0, idx, flat_keys, "amin",
                                            include_self=True)),
            "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3,
            "bytes": bytes_,
            "live_entries": live,
        })
    return rows


def small_graphs():
    """Phase 4: the property-suite classes, card vs CPU, every field."""
    from repro_torch.coarsen import CoarsenConfig
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
        for fused in (False, True):
            spec = SolveSpec(mode="coarsen", coarsen=CoarsenConfig(cutoff=4), fused=fused)
            rc, rp = plan(gc, spec).solve(), plan(gp, spec).solve()
            check(same_report(rc, rp), f"{case[0]} coarsen fused={fused}: card != CPU")
        print(f"  {case[0]}: card == CPU over complete/csp/os x pack on/off and coarsen",
              flush=True)


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

    weight64 = eid_weight(g, rep.msf_eids)
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


def coarsen_path(label, g, flat_rep):
    """Phases 6b/6c: drive plan(g, SolveSpec(mode="coarsen")).solve() and
    check it; ``flat_rep`` is the flat solve's report on the same graph."""
    import numpy as np
    import torch

    from repro_torch.coarsen.relabel import canonical_minvertex_labels
    from repro_torch.graphs.structures import nx_free_msf_weight, nx_free_n_components
    from repro_torch.kernels import ops
    from repro_torch.solve import SolveSpec, plan

    p = plan(g, SolveSpec(mode="coarsen"))
    reset_counts()
    t0 = time.perf_counter()
    rep = p.solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    be = p.engine.last_backends
    check(be.pack is True, f"{label}: the levels did not resolve pack32")
    check(be.dedupe == "device", f"{label}: dedupe resolved to {be.dedupe!r}, not 'device'")
    check(be.hook is ops.segment_min_flat, f"{label}: the level hook is not the flat kernel")
    check(be.dedupe_segmin is ops.segment_min_sorted,
          f"{label}: the dedupe segment-min is not the sorted kernel")
    cfg = p.resolved.coarsen
    k, n_levels = cfg.rounds_per_level, len(rep.levels)
    residual_n, residual_m = (rep.levels[-1].n_next, rep.levels[-1].m_next) if n_levels else (
        g.n, None)
    # A level that made no progress ran its hook rounds but not its dedupe.
    stalled = int(n_levels < cfg.max_levels and residual_n > cfg.cutoff
                  and (residual_m or 0) > 0)
    residual_rounds = rep.iterations - k * n_levels
    check(n_levels > 0 and launches["segment_min_sorted"] == n_levels,
          f"{label}: {launches['segment_min_sorted']} sorted launches for {n_levels} levels")
    want_flat = 2 * k * (n_levels + stalled) + residual_rounds
    check(launches["segment_min_flat"] == want_flat,
          f"{label}: {launches['segment_min_flat']} flat launches, expected {want_flat}")

    weight64 = eid_weight(g, rep.msf_eids)
    oracle = nx_free_msf_weight(g)
    ncomp = nx_free_n_components(g)
    check(weight64 == oracle, f"{label}: coarsen MSF weight {weight64} != scipy {oracle}")
    check(rep.n_msf_edges == g.n - ncomp,
          f"{label}: {rep.n_msf_edges} MSF edges != n - components = {g.n - ncomp}")
    check(set(rep.msf_eids.tolist()) == set(flat_rep.msf_eids.tolist()),
          f"{label}: coarsen eid set differs from the flat solve's")
    # coarsen labels each component by its minimum vertex, the flat solve
    # by its AS root: the same partition, compared in the coarsen labeling
    flat_labels = canonical_minvertex_labels(flat_rep.parent, g.n).numpy()
    check(np.array_equal(rep.parent, flat_labels),
          f"{label}: coarsen partition differs from the flat solve's")
    plain = plan(g, SolveSpec(mode="coarsen", segmin="torch", dedupe="host")).solve()
    check(same_report(rep, plain),
          f"{label}: report differs from the plain solve (segmin='torch', dedupe='host')")
    print(f"  {label}: n={g.n} E={g.num_directed_edges} levels={list(map(tuple, rep.levels))} "
          f"rounds={rep.iterations} launches={launches} weight={weight64} (scipy {oracle}) "
          f"msf_edges={rep.n_msf_edges} components={ncomp} first_solve_s={first_s:.3f}",
          flush=True)
    return launches, rep


def undirected_stream(g, seed):
    """Host (lo, hi, w) of ``g``'s undirected edges in a default_rng(seed)
    permutation: the insert stream of tests/test_stream.py's acceptance
    test."""
    import numpy as np

    valid = g.valid.cpu().numpy()
    src, dst, w = (x.cpu().numpy() for x in (g.src, g.dst, g.w))
    sel = valid & (src < dst)
    lo, hi, w = src[sel], dst[sel], w[sel]
    perm = np.random.default_rng(seed).permutation(len(lo))
    return lo[perm], hi[perm], w[perm]


def minvertex(labels):
    """Each vertex's component labelled by its minimum vertex (numpy)."""
    import numpy as np

    labels = np.asarray(labels, np.int64)
    first = np.full(int(labels.max()) + 1, len(labels), np.int64)
    np.minimum.at(first, labels, np.arange(len(labels)))
    return first[labels]


def scipy_forest(lo, hi, w, n):
    """scipy's MSF weight, min-vertex component labels and each vertex's
    component size for the unique undirected pairs (lo, hi, w)."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    a = sp.coo_matrix((w.astype(np.float64), (lo, hi)), shape=(n, n)).tocsr()
    weight = float(csg.minimum_spanning_tree(a).sum())
    _, labels = csg.connected_components(a, directed=False)
    return weight, minvertex(labels), np.bincount(labels)[labels]


def eid_weight(g, eids) -> float:
    """float64 sum of ``g``'s weights over ``eids``."""
    import numpy as np

    valid = g.valid.cpu().numpy()
    eid = g.eid.cpu().numpy()[valid]
    w_by_eid = np.zeros(int(eid.max()) + 1, np.float64)
    w_by_eid[eid] = g.w.cpu().numpy()[valid]
    return float(w_by_eid[eids].sum())


def stream_labels(p):
    """Min-vertex labels of a stream plan's published snapshot."""
    return minvertex(p.engine.snapshots.acquire().parent.cpu().numpy())


def reset_counts():
    from repro_torch.kernels import ops

    ops.segment_min_flat.launches = ops.segment_min_sorted.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import ops

    return {"segment_min_flat": ops.segment_min_flat.launches,
            "segment_min_sorted": ops.segment_min_sorted.launches}


def stream_launches(stream_a, stream_b, kernel) -> dict:
    """``kernel``'s launches on each run of phase 6f."""
    return {
        "stream rmat_s16_ef2 inserts": stream_a["flat"]["launches"][kernel],
        "stream rmat_s16_ef2 inserts, coarsen-assisted": stream_a["coarsen"]["launches"][kernel],
        "stream rmat_s20_ef8 inserts": stream_b["launches"]["inserts"][kernel],
        "stream rmat_s20_ef8 deletes and recertify":
            stream_b["launches"]["deletes_and_recertify"][kernel],
    }


def stream_acceptance(g) -> dict:
    """Phase 6f A: the reference's acceptance stream (R-MAT scale 16, edge
    factor 2, seed 7, batch_capacity 8192, n <= 2^16 so the packed probe
    runs on the card) through plan(n, SolveSpec(mode="stream")).update,
    flat and coarsen-assisted; each checked against scipy and the flat
    solve. Returns the launches of each run."""
    import numpy as np

    from repro_torch.coarsen import CoarsenConfig
    from repro_torch.solve import SolveSpec, plan

    n, cap = g.n, STREAM_A_BATCH
    lo, hi, w = undirected_stream(g, STREAM_A["seed"])
    weight, labels, _ = scipy_forest(lo, hi, w, n)
    flat = plan(g, SolveSpec()).solve()
    check(eid_weight(g, flat.msf_eids) == weight, "stream A: flat solve weight != scipy")
    check(np.array_equal(minvertex(flat.parent), labels), "stream A: flat partition != scipy")
    runs, out = {}, {}
    for name, extra in (("flat", {}), ("coarsen", dict(coarsen=CoarsenConfig(),
                                                       coarsen_threshold=1 << 15))):
        p = plan(n, SolveSpec(mode="stream", batch_capacity=cap, **extra))
        check(p.engine.device.type == "cuda", f"stream A {name}: the engine is not on the card")
        iters, levels = 0, 0
        reset_counts()
        t0 = time.perf_counter()
        for k in range(0, len(lo), cap):
            rep = p.update(lo[k:k + cap], hi[k:k + cap], w[k:k + cap])
            iters += rep.iterations
            levels += len(rep.levels)
            check(p.engine.last_union_shape == (2 * (n - 1 + cap),),
                  f"stream A {name}: union shape {p.engine.last_union_shape}")
        secs = time.perf_counter() - t0
        launches = read_counts()
        check(p.engine.weight == weight, f"stream A {name}: weight {p.engine.weight} != {weight}")
        check(np.array_equal(stream_labels(p), labels), f"stream A {name}: partition != scipy")
        check(not rep.stale and rep.n_msf_edges == n - len(np.unique(labels)),
              f"stream A {name}: stale or wrong forest size")
        runs[name] = p
        out[name] = {"batches": -(-len(lo) // cap), "levels": levels, "iterations": iters,
                     "launches": launches, "stream_s": secs}
    check(out["flat"]["launches"] == {"segment_min_flat": out["flat"]["iterations"],
                                      "segment_min_sorted": 0},
          f"stream A flat: launches {out['flat']['launches']} for "
          f"{out['flat']['iterations']} AS rounds")
    c = out["coarsen"]
    check(c["levels"] > 0 and c["launches"]["segment_min_sorted"] > 0
          and c["launches"]["segment_min_flat"] > 0,
          f"stream A coarsen: {c['levels']} levels, launches {c['launches']}")
    check(set(runs["coarsen"].engine.forest_gids().tolist())
          == set(runs["flat"].engine.forest_gids().tolist()),
          "stream A: coarsen-assisted forest gids differ from the flat stream's")
    print(f"  rmat_s16_ef2 stream: n={n} edges={len(lo)} weight={weight} (scipy) == flat solve; "
          f"{json.dumps(out)}", flush=True)
    return out


def update_split(fn) -> dict:
    """Host seconds of one stream update by stage: each of the engine's
    stages wrapped in a timer for the call (numpy and the device solve
    run inside them; the stages nest, as listed in PERF.md)."""
    from contextlib import ExitStack
    from unittest import mock

    from repro_torch.solve import engines as plan_engines
    from repro_torch.stream import delta, engine

    eng = engine.StreamEngine
    stages = [(eng, "insert_batch"), (delta, "prepare_batch"), (eng, "_classify"),
              (eng, "_run_union"), (eng, "_union_graph"), (eng, "_solve_graph"),
              (engine, "_to_host"), (eng, "_commit"), (engine, "_canonicalize"),
              (delta.Reservoir, "absorb"), (eng, "_refresh_live_index"),
              (delta, "build_live_index"), (engine, "make_snapshot"),
              (plan_engines._StreamPlanEngine, "_report")]
    split = {}

    def timed(name, f):
        def stage(*args, **kw):
            t0 = time.perf_counter()
            try:
                return f(*args, **kw)
            finally:
                split[name] = split.get(name, 0.0) + time.perf_counter() - t0
        return stage

    with ExitStack() as stack:
        for owner, name in stages:
            stack.enter_context(mock.patch.object(owner, name, timed(name, getattr(owner, name))))
        t0 = time.perf_counter()
        fn()
        split["update"] = time.perf_counter() - t0
    return split


def profile_update(fn) -> dict:
    """The device's busy time over one stream update (every kernel and
    copy, torch.profiler) and its largest rows. Run last: on the card,
    profiler sessions after one over a stream update recorded no device
    events."""
    rows = sorted(device_rows(fn), key=lambda e: e.self_device_time_total, reverse=True)
    return {"device_busy_ms": sum(e.self_device_time_total for e in rows) / 1e3,
            "top": [{"op": e.key[:60], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3} for e in rows[:6]]}


def stream_rmat20(g):
    """Phase 6f B: the first ``STREAM_B_BATCHES`` batches of 131,072 pairs
    of the flat main path's graph (R-MAT scale 20, edge factor 8, seed 0)
    streamed through a stream plan on the card (n > 2^16: the host int64
    probe) and checked against scipy and the flat solve of the same pairs;
    a third of the pairs deleted,
    the unhealed deletions recertified (coarsen-assisted), queries
    answered, and the state saved and restored into a fresh engine. Every
    result checked against scipy; insert latencies, the host/device split
    of one update, host syncs and query throughput measured."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.coarsen import CoarsenConfig
    from repro_torch.graphs.structures import from_edges
    from repro_torch.solve import SolveSpec, plan
    from repro_torch.stream.persist import restore_stream, save_stream

    n, cap = g.n, STREAM_B_BATCH
    lo, hi, w = undirected_stream(g, RMAT["seed"])
    full = len(lo)
    lo, hi, w = (x[:STREAM_B_BATCHES * cap] for x in (lo, hi, w))
    weight, labels, sizes = scipy_forest(lo, hi, w, n)
    g_prefix = from_edges(lo, hi, w, n, device="cuda")
    flat = plan(g_prefix, SolveSpec()).solve()
    check(eid_weight(g_prefix, flat.msf_eids) == weight, "stream B: flat solve weight != scipy")
    check(np.array_equal(minvertex(flat.parent), labels), "stream B: flat partition != scipy")
    del g_prefix
    # Inserts hold at most (n - 1) + 131,072 live union edges and stay flat;
    # the recertify over the survivors passes the threshold.
    spec = SolveSpec(mode="stream", batch_capacity=cap, coarsen=CoarsenConfig(),
                     coarsen_threshold=STREAM_B_COARSEN_THRESHOLD)
    p = plan(n, spec)
    check(p.engine.device.type == "cuda", "stream B: the engine is not on the card")
    reps, lat, row = [], [], {"edges": len(lo), "edges_in_graph": full}
    starts = range(0, len(lo), cap)
    reset_counts()
    t_stream = time.perf_counter()
    for i, k in enumerate(starts):
        def update():
            reps.append(p.update(lo[k:k + cap], hi[k:k + cap], w[k:k + cap]))
        # the last two batches, where the forest is largest, are measured
        last = len(starts) - i
        if last == 2:
            row["host_syncs_per_update"] = count_syncs(update)
        elif last == 1:
            row["host_split_one_update_s"] = update_split(update)
        else:
            t0 = time.perf_counter()
            update()
            lat.append(time.perf_counter() - t0)
        check(p.engine.last_union_shape == (2 * (n - 1 + cap),),
              f"stream B: union shape {p.engine.last_union_shape}")
    row["stream_s"] = time.perf_counter() - t_stream
    launches = {"inserts": read_counts()}
    iters = sum(r.iterations for r in reps)
    check(launches["inserts"] == {"segment_min_flat": iters, "segment_min_sorted": 0},
          f"stream B: launches {launches['inserts']} for {iters} AS rounds")
    check(p.engine.weight == weight, f"stream B: weight {p.engine.weight} != scipy {weight}")
    check(np.array_equal(stream_labels(p), labels), "stream B: partition != scipy")
    lat.sort()
    row.update(batches=len(reps), iterations=iters, forest_edges=p.engine.n_forest_edges,
               insert_latency_median_s=statistics.median(lat),
               insert_latency_p95_s=lat[min(len(lat) - 1, int(0.95 * len(lat)))])

    svc = p.service
    qu, qv = np.random.default_rng(1).integers(0, n, (2, STREAM_QUERIES))
    ans = svc.answer(qu, qv)
    check(np.array_equal(ans.connected, labels[qu] == labels[qv]), "stream B: connected != scipy")
    check(np.array_equal(ans.size, sizes[qu]), "stream B: component sizes != scipy")
    check(ans.snapshot.version == p.engine.version, "stream B: answers pinned to an old version")
    reps_q = 20
    t0 = time.perf_counter()
    for _ in range(reps_q):
        svc.answer(qu, qv)
    row["query_batch"] = STREAM_QUERIES
    row["queries_per_s"] = reps_q * STREAM_QUERIES / (time.perf_counter() - t0)

    gone = np.random.default_rng(2).permutation(len(lo))[: len(lo) // 3]
    keep = np.ones(len(lo), bool)
    keep[gone] = False
    reset_counts()
    t0 = time.perf_counter()
    dels = [p.delete(lo[gone[k:k + cap]], hi[gone[k:k + cap]]) for k in range(0, len(gone), cap)]
    row["delete_batches"] = len(dels)
    row["delete_s"] = time.perf_counter() - t0
    row["unhealed_after_deletes"] = p.engine.unhealed
    if p.engine.unhealed:
        t0 = time.perf_counter()
        rec = p.recertify(lo[keep], hi[keep], w[keep])
        row["recertify_s"] = time.perf_counter() - t0
        row["recertify_levels"] = [tuple(lv) for lv in rec.levels]
        check(len(rec.levels) > 0, "stream B: the recertify was not coarsen-assisted")
    launches["deletes_and_recertify"] = read_counts()
    check(launches["deletes_and_recertify"]["segment_min_flat"] > 0,
          "stream B: the deletes' heals launched no flat segment-min")
    if "recertify_s" in row:
        check(launches["deletes_and_recertify"]["segment_min_sorted"] > 0,
              "stream B: the coarsen-assisted recertify launched no sorted segment-min")
    snap = p.engine.snapshots.acquire()
    weight_s, labels_s, _ = scipy_forest(lo[keep], hi[keep], w[keep], n)
    check(not snap.stale and snap.n_unhealed == 0, "stream B: stale snapshot after recertify")
    check(p.engine.weight == weight_s and snap.weight == weight_s,
          f"stream B: weight after deletes {p.engine.weight} != scipy {weight_s}")
    check(np.array_equal(stream_labels(p), labels_s), "stream B: partition after deletes != scipy")

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        step = save_stream(d, p.engine)
        q = plan(n, spec)
        check(restore_stream(d, q.engine) == step == p.engine.version, "stream B: restore step")
        row["save_restore_s"] = time.perf_counter() - t0
    a, b = p.engine, q.engine
    check(a.weight == b.weight and set(a.forest_gids().tolist()) == set(b.forest_gids().tolist())
          and torch.equal(a.snapshots.acquire().parent, b.snapshots.acquire().parent)
          and b.snapshots.acquire().version == a.version,
          "stream B: the restored engine differs from the saved one")
    row["launches"] = launches
    print(f"  rmat_s20_ef8 stream: n={n} edges={len(lo)} weight={weight} (scipy) == flat "
          f"solve; deletes "
          f"{len(gone)} -> weight {weight_s} (scipy); restored; {json.dumps(row)}", flush=True)
    # phase 7 profiles one more update: the first deleted batch inserted again
    again = gone[:cap]
    return row, partial(p.update, lo[again], hi[again], w[again])


def start_server(args, log_path):
    """Start ``python -m repro_torch.launch.serve_graph --serve *args`` from
    the checkout. Returns (process, its stdout lines so far, a queue of
    the lines to come, the address, the restored version or None)."""
    import os
    import queue
    import re
    import threading

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH", "")) if p))
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_graph", "--serve", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=log, text=True)
    log.close()
    lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line.rstrip("\n"))
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    seen = []
    deadline = time.monotonic() + SERVE_START_TIMEOUT_S
    while True:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            proc.kill()
            fail(f"serve_graph --serve printed no address in {SERVE_START_TIMEOUT_S} s")
        if line is None:
            fail(f"serve_graph --serve exited {proc.wait()} before serving: "
                 f"{Path(log_path).read_text()[-2000:]}")
        seen.append(line)
        if line.startswith("# serving tcp://"):
            restored = re.search(r"restored v(\d+)", line)
            return proc, seen, lines, line.split()[2], (
                int(restored.group(1)) if restored else None)


def stop_server(proc, lines, log_path) -> list:
    """SIGTERM (the graceful drain) and wait; the rest of its stdout."""
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail("serve_graph --serve did not drain within 300 s of SIGTERM")
    check(rc == 0, f"serve_graph --serve exited {rc} after SIGTERM: "
                   f"{Path(log_path).read_text()[-2000:]}")
    out = []
    while (line := lines.get(timeout=60)) is not None:
        out.append(line)
    return out


def counter(client, name: str) -> int:
    """A counter of the server's obs metrics snapshot (0 before its first
    increment)."""
    resp = client.metrics()
    check(resp["ok"], f"metrics: {resp}")
    return resp["result"]["metrics"]["counters"].get(name, 0)


def check_answer(op, u, v, resp, truth):
    """One query response against scipy's labels and sizes of the prefix
    its snapshot version names."""
    import numpy as np

    labels, sizes = truth
    check(resp["ok"], f"serve: {op} failed: {resp.get('error')}")
    r = resp["result"]
    if op == "connected":
        ok = np.array_equal(np.asarray(r["connected"]), labels[u] == labels[v])
    elif op == "component_size":
        ok = np.array_equal(np.asarray(r["size"]), sizes[u])
    else:  # a label is a vertex of u's component, one label per component
        comp = np.asarray(r["component"], np.int64)
        ok = (np.array_equal(labels[comp], labels[u])
              and len(np.unique(comp)) == len(np.unique(labels[u])))
    check(ok, f"serve: {op} answers at v{resp['snapshot_version']} != scipy")


def json_times(n: int, cap: int, reps: int = 5) -> dict:
    """Host seconds (median of ``reps``) to encode and decode, with the
    serve/v1 codec, a 4,096-point ``connected`` request and its response,
    and an insert frame of ``cap`` pairs: what the wire adds to a query
    and an insert, both ends together."""
    import numpy as np

    from repro_torch.serve import protocol as P

    rng = np.random.default_rng(0)
    u, v = rng.integers(0, n, (2, SERVE_QUERY_POINTS))
    frames = {
        "query_request": {"op": "connected", "id": 1, "u": u.tolist(), "v": v.tolist()},
        "query_response": P.response(1, "connected",
                                     {"connected": (u % 2 == v % 2).tolist()}),
        "insert_request": {"op": "insert", "id": 2, "u": rng.integers(0, n, cap).tolist(),
                           "v": rng.integers(0, n, cap).tolist(),
                           "w": rng.integers(1, 256, cap).astype(float).tolist()},
    }
    out = {}
    for name, obj in frames.items():
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            P.decode_payload(P.encode_frame(obj)[P.HEADER_SIZE:])
            times.append(time.perf_counter() - t0)
        out[name] = statistics.median(times)
    return out


def serve_path(g, cfg=RMAT, device="cuda", cap=SERVE_BATCH, deletes=SERVE_DELETES) -> dict:
    """Phase 6g: ``serve_graph --serve`` on ``g`` (the R-MAT of ``cfg``) in
    a subprocess, driven over loopback, checked against scipy and against
    the same writes replayed in this process; SIGTERM, and a restart from
    the drain checkpoint."""
    import tempfile
    import threading

    import numpy as np

    from repro_torch import obs
    from repro_torch.serve import ServeClient
    from repro_torch.solve import SolveSpec, plan
    from repro_torch.stream.persist import latest_stream_step

    n = g.n
    lo, hi, w = undirected_stream(g, cfg["seed"])
    warm = int(len(lo) * SERVE_WARM_FRAC)
    ends = [warm + i * cap for i in range(SERVE_INSERT_FRAMES + 2)]
    check(ends[-1] <= len(lo), "serve: the stream is too short for the insert frames")
    truth, prefix_of = {}, {}  # version -> (labels, sizes); version -> prefix end

    def scipy_at(version):
        if version not in truth:
            end = prefix_of[version]
            _, labels, sizes = scipy_forest(lo[:end], hi[:end], w[:end], n)
            truth[version] = (labels, sizes)
        return truth[version]

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    args = ["--scale", str(cfg["scale"]), "--edge-factor", str(cfg["edge_factor"]),
            "--seed", str(cfg["seed"]), "--batch-capacity", str(cap),
            "--warm-frac", str(SERVE_WARM_FRAC), "--checkpoint-dir", str(tmp / "ckpt"),
            "--metrics-out", str(tmp / "metrics.json"), "--device", device, *SERVE_FLAGS]
    row = {"n": n, "warm_edges": warm, "insert_frames": SERVE_INSERT_FRAMES,
           "insert_frame_pairs": cap, "query_points": SERVE_QUERY_POINTS,
           "query_threads": SERVE_QUERY_THREADS, "deletes": deletes}
    procs = []
    try:
        t0 = time.perf_counter()
        proc, out1, lines1, addr, restored = start_server(args, tmp / "server1.log")
        procs.append(proc)
        row["server_start_s"] = time.perf_counter() - t0
        check(restored is None, "serve: the first server restored a checkpoint")
        with ServeClient(addr, timeout=300) as c:
            st = c.status(check=True)
            v_warm = st["snapshot_version"]
            prefix_of[v_warm] = warm
            weight_warm, _, _ = scipy_forest(lo[:warm], hi[:warm], w[:warm], n)
            check(st["result"]["weight"] == weight_warm,
                  f"serve: warm weight {st['result']['weight']} != scipy {weight_warm}")

            # the same writes replayed here, for the AS rounds they take
            rp = plan(n, SolveSpec(mode="stream", batch_capacity=cap), device=device)
            for at in range(0, warm, cap):
                rp.update(lo[at:min(at + cap, warm)], hi[at:min(at + cap, warm)],
                          w[at:min(at + cap, warm)])
            check(rp.engine.version == v_warm and rp.engine.weight == weight_warm,
                  "serve: the replayed warm-up differs from the server's")

            answers, errors = [], []
            stop = threading.Event()

            def reader(seed):
                rng = np.random.default_rng(seed)
                kinds = ("connected", "component_id", "component_size")
                try:
                    with ServeClient(addr, timeout=300) as rc:
                        pending, i = [], 0
                        while not stop.is_set() or i < 3:
                            u, v = rng.integers(0, n, (2, SERVE_QUERY_POINTS))
                            op = kinds[i % 3]
                            i += 1
                            fields = {"u": u.tolist()}
                            if op == "connected":
                                fields["v"] = v.tolist()
                            pending.append((op, u, v, rc.submit(op, **fields)))
                            if len(pending) == 2:  # two frames in flight
                                op_, u_, v_, f = pending.pop(0)
                                answers.append((op_, u_, v_, f.result(timeout=300)))
                        for op_, u_, v_, f in pending:
                            answers.append((op_, u_, v_, f.result(timeout=300)))
                except Exception as e:  # reported below, the phase fails
                    errors.append(repr(e))

            launches0 = counter(c, "kernel.segment_min_flat.launches")
            readers = [threading.Thread(target=reader, args=(10 + k,))
                       for k in range(SERVE_QUERY_THREADS)]
            t_q = time.perf_counter()
            for t in readers:
                t.start()
            lat, replay_iters = [], 0
            reset_counts()

            def insert_frame(i):
                """Frame i to the server and to the replay; its latency."""
                nonlocal replay_iters
                sl = slice(ends[i], ends[i + 1])
                t0 = time.perf_counter()
                r = c.insert(lo[sl], hi[sl], w[sl])
                dt = time.perf_counter() - t0
                check(r["ok"], f"serve: insert failed: {r.get('error')}")
                prefix_of[r["result"]["version"]] = ends[i + 1]
                with obs.enabled("metrics"):  # the server's mode
                    if i == SERVE_INSERT_FRAMES - 1:
                        reps = []
                        row["host_syncs_per_insert"] = count_syncs(
                            lambda: reps.append(rp.update(lo[sl], hi[sl], w[sl])))
                        rep = reps[0]
                    else:
                        rep = rp.update(lo[sl], hi[sl], w[sl])
                replay_iters += rep.iterations
                check(rep.weight == r["result"]["weight"]
                      and rep.raw.version == r["result"]["version"]
                      and rep.raw.n_new == r["result"]["n_new"],
                      f"serve: insert {i} differs from its replay")
                return dt

            for i in range(SERVE_INSERT_FRAMES):
                lat.append(insert_frame(i))
            stop.set()
            for t in readers:
                t.join(timeout=600)
            row["query_window_s"] = time.perf_counter() - t_q
            check(not errors and all(not t.is_alive() for t in readers),
                  f"serve: query threads failed: {errors}")
            # one more frame with no query in flight: the insert alone
            row["insert_latency_quiet_s"] = insert_frame(SERVE_INSERT_FRAMES)
            replay_launches = read_counts()["segment_min_flat"]
            launches1 = counter(c, "kernel.segment_min_flat.launches")
            row["insert_launches"] = launches1 - launches0
            row["insert_as_rounds"] = replay_iters
            check(row["insert_launches"] == replay_iters == replay_launches,
                  f"serve: {row['insert_launches']} flat launches in the server, "
                  f"{replay_launches} in the replay, for {replay_iters} AS rounds")
            for op, u, v, resp in answers:
                check(resp["snapshot_version"] in prefix_of,
                      f"serve: an answer at unknown version {resp['snapshot_version']}")
                check_answer(op, u, v, resp, scipy_at(resp["snapshot_version"]))
            row["query_frames"] = len(answers)
            row["versions_answered"] = sorted({a[3]["snapshot_version"] for a in answers})
            row["queries_per_s"] = len(answers) * SERVE_QUERY_POINTS / row["query_window_s"]
            lat.sort()
            row["insert_latency_median_s"] = statistics.median(lat)
            row["insert_latency_max_s"] = lat[-1]  # of SERVE_INSERT_FRAMES: too few for a p95

            # one delete frame: edges to degree-1 vertices, forest edges and
            # bridges, so the survivors' forest is the old one without them
            end = ends[-1]
            deg = np.bincount(lo[:end], minlength=n) + np.bincount(hi[:end], minlength=n)
            leaf = np.flatnonzero((deg[lo[:end]] == 1) | (deg[hi[:end]] == 1))
            check(len(leaf) >= deletes, f"serve: only {len(leaf)} leaf edges")
            gone = np.random.default_rng(3).choice(leaf, deletes, replace=False)
            keep = np.ones(end, bool)
            keep[gone] = False
            reset_counts()
            t0 = time.perf_counter()
            d = c.delete(lo[gone], hi[gone])
            row["delete_s"] = time.perf_counter() - t0
            with obs.enabled("metrics"):
                rep_d = rp.delete(lo[gone], hi[gone])
            replay_del = read_counts()["segment_min_flat"]
            check(d["ok"] and d["result"]["n_deleted"] == deletes,
                  f"serve: delete: {d.get('result') or d.get('error')}")
            weight_s, labels_s, sizes_s = scipy_forest(lo[:end][keep], hi[:end][keep],
                                                       w[:end][keep], n)
            check(d["result"]["weight"] == weight_s == rep_d.weight,
                  f"serve: weight after the delete {d['result']['weight']} != scipy {weight_s}")
            row["delete_launches"] = counter(c, "kernel.segment_min_flat.launches") - launches1
            check(row["delete_launches"] == replay_del,
                  f"serve: the delete's flat launches {row['delete_launches']} != its "
                  f"replay's {replay_del}")
            v_del = d["result"]["version"]
            truth[v_del] = (labels_s, sizes_s)
            final_q = []
            qu, qv = np.random.default_rng(4).integers(0, n, (2, SERVE_QUERY_POINTS))
            for op in ("connected", "component_id", "component_size"):
                resp = c.call(op, u=qu.tolist(), **({"v": qv.tolist()} if op == "connected"
                                                    else {}))
                check(resp["snapshot_version"] == v_del, "serve: a query after the delete "
                      "did not see it")
                check_answer(op, qu, qv, resp, truth[v_del])
                final_q.append((op, resp["result"]))
            st = c.status(check=True)["result"]
            m = c.metrics(check=True)["result"]["metrics"]
        e2e = m["histograms"]["serve.e2e_latency_s"]
        for name in ("span.solve.stream.update", "span.stream.update",
                     "span.stream.union_solve", "span.stream.query"):
            h = m["histograms"][name]
            row[f"server_{name[5:]}_s"] = {k: h[k] for k in ("count", "p50", "max")}
        row["json_s_per_frame"] = json_times(n, cap)
        row.update(
            query_e2e_p50_s=e2e["p50"], query_e2e_p95_s=e2e["p95"], query_e2e_p99_s=e2e["p99"],
            query_e2e_count=e2e["count"],
            batch_occupancy=m["histograms"]["serve.batch_occupancy"],
            served_queries=st["served_queries"], served_writes=st["served_writes"])
        check(st["weight"] == weight_s, "serve: status weight after the delete != scipy")

        out1 += stop_server(proc, lines1, tmp / "server1.log")
        check(f"# drained at v{v_del} weight={weight_s:.0f}" in out1,
              f"serve: drain line missing: {out1[-3:]}")
        check(latest_stream_step(str(tmp / "ckpt")) == v_del,
              "serve: the drain checkpoint is not at the last version")
        drained = json.loads((tmp / "metrics.json").read_text())
        check(drained["counters"]["serve.writes"] == SERVE_INSERT_FRAMES + 2,
              "serve: the drained metrics snapshot misses writes")

        t0 = time.perf_counter()
        proc2, out2, lines2, addr2, restored2 = start_server(args, tmp / "server2.log")
        procs.append(proc2)
        row["restart_s"] = time.perf_counter() - t0
        check(restored2 == v_del, f"serve: restored v{restored2}, drained at v{v_del}")
        with ServeClient(addr2, timeout=300) as c2:
            st2 = c2.status(check=True)
            check(st2["snapshot_version"] == v_del and st2["result"]["restored_version"] == v_del
                  and st2["result"]["weight"] == st["weight"],
                  "serve: the restarted server's state differs from the drained one")
            for op, result in final_q:
                resp = c2.call(op, u=qu.tolist(), **({"v": qv.tolist()} if op == "connected"
                                                     else {}))
                check(resp["ok"] and resp["result"] == result
                      and resp["snapshot_version"] == v_del,
                      f"serve: {op} answers differ after the restart")
        stop_server(proc2, lines2, tmp / "server2.log")
        row["restored_version"] = restored2
        row["weight_after_delete"] = weight_s
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return row


def trace_check(path, names) -> None:
    """tools/check_trace.py over an exported trace, as a subprocess."""
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "check_trace.py"), str(path),
                           *names], capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"check_trace {path}: {proc.stderr.strip()}")


def same_solve(a, b) -> bool:
    """Two reports equal in every field but the obs timings; ``raw`` holds
    tensors (an MSFResult) or plain values (a stream update's stats)."""
    import torch

    if not all(torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(a.raw, b.raw)):
        return False
    return same_report(a._replace(timings={}, raw=()), b._replace(timings={}, raw=()))


def obs_path(g_flat, g_coarsen, device="cuda") -> dict:
    """Phase 6h: the flat solve of ``g_flat``, a coarsen solve of
    ``g_coarsen`` and one stream update, each with obs off, "metrics" and
    "trace": identical reports, the spans, exported traces through
    tools/check_trace.py, host syncs and solve times per mode."""
    import tempfile

    from repro_torch import obs
    from repro_torch.solve import SolveSpec, plan

    modes = ("off", "metrics", "trace")
    row = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_obs_"))
    try:
        # flat
        reps = {}
        for m in modes:
            obs.reset()
            reset_counts()
            reps[m] = plan(g_flat, SolveSpec(obs=m)).solve()
            if m == "trace":
                rounds = [e for e in obs.trace_events() if e[0] == "msf.round"]
                check(len(rounds) == reps[m].iterations,
                      f"obs: {len(rounds)} msf.round spans for {reps[m].iterations} rounds")
                check(read_counts()["segment_min_flat"] == reps[m].iterations or device == "cpu",
                      "obs: the traced flat solve did not launch the kernel once a round")
                obs.export_trace(str(tmp / "flat.json"))
                trace_check(tmp / "flat.json", ["msf.flat", "msf.round", "solve.flat"])
            check(same_solve(reps["off"], reps[m]), f"obs: flat report with obs={m} differs")
            check(bool(reps[m].timings) == (m != "off"), f"obs: flat timings with obs={m}")
        row["flat_rounds"] = reps["off"].iterations
        row["flat_msf_round_spans"] = len(rounds)
        row["host_syncs_per_flat_solve"] = {
            m: count_syncs(plan(g_flat, SolveSpec(obs=m)).solve) for m in modes}
        syncs = row["host_syncs_per_flat_solve"]
        check(device == "cpu" or syncs["off"] == 40,
              f"obs: {syncs['off']} host syncs per flat solve with obs off, not 40")
        check(device == "cpu" or syncs["metrics"] == syncs["off"]
              and syncs["trace"] == syncs["off"] + reps["off"].iterations + 1,
              f"obs: host syncs per flat solve {syncs} for {reps['off'].iterations} rounds")
        row["flat_solve_median_s"] = solve_times(
            g_flat, {m: SolveSpec(obs=m) for m in modes})
        obs.reset()

        # coarsen
        spec = SolveSpec(mode="coarsen")
        base = plan(g_coarsen, spec).solve()
        for m in modes[1:]:
            obs.reset()
            rep = plan(g_coarsen, SolveSpec(mode="coarsen", obs=m)).solve()
            check(same_solve(base, rep), f"obs: coarsen report with obs={m} differs")
        names = ["coarsen.levels", "coarsen.level", "coarsen.contract", "coarsen.relabel",
                 "coarsen.filter", "coarsen.residual", "msf.flat", "msf.round", "solve.coarsen"]
        obs.export_trace(str(tmp / "coarsen.json"))
        trace_check(tmp / "coarsen.json", names)
        row["coarsen_levels"] = len(base.levels)
        row["coarsen_span_names"] = sorted({e[0] for e in obs.trace_events()})
        obs.reset()

        # one stream update
        lo, hi, w = undirected_stream(g_flat, RMAT["seed"])
        k = min(STREAM_B_BATCH, len(lo))
        ups = {}
        for m in modes:
            obs.reset()
            sp = plan(g_flat.n, SolveSpec(mode="stream", batch_capacity=STREAM_B_BATCH, obs=m),
                      device=device)
            ups[m] = sp.update(lo[:k], hi[:k], w[:k])
            check(same_solve(ups["off"], ups[m]), f"obs: stream report with obs={m} differs")
        obs.export_trace(str(tmp / "stream.json"))
        trace_check(tmp / "stream.json", ["solve.stream.update", "stream.update",
                                          "stream.union_solve", "msf.flat", "msf.round"])
        row["stream_update_rounds"] = ups["off"].iterations
    finally:
        obs.disable()
        obs.reset()
        obs.metrics_reset()
        shutil.rmtree(tmp, ignore_errors=True)
    return row


# ---------------------------------------------------------------------------
# phase 6i: plan cost, tuner, load harness
# ---------------------------------------------------------------------------

def cost_path(plans: dict) -> dict:
    """Phase 6i, cost: ``plan.cost`` of each (label, graph, spec), its
    roofline prediction for the report's rounds beside the measured median
    solve and the device busy time; the cost is the report's, costs no
    host sync, and the flat model's segment-min term is round 1's
    ``segmin_bytes`` with every key live."""
    from repro_torch.core.msf import run_flat
    from repro_torch.kernels import ops
    from repro_torch.solve import plan
    from repro_torch.solve.cost import flat_round_terms, plan_cost, predicted_time_s

    rows = {}
    for label, (g, spec) in plans.items():
        p = plan(g, spec)
        rep = p.solve()
        cost = p.cost
        check(cost is not None and rep.cost is cost,
              f"cost {label}: the report's cost is not the plan's ({rep.cost!r})")
        check(count_syncs(lambda: plan_cost(spec.mode, g, p.resolved)) == 0,
              f"cost {label}: the cost model synchronised the card")
        predicted = predicted_time_s(cost, iterations=rep.iterations)
        measured = solve_times(g, {"solve": spec})["solve_s"]
        busy = profile_solve(g, spec)["device_ms"] / 1e3
        rows[label] = {"cost": cost.as_dict(), "rounds": rep.iterations,
                       "predicted_s": predicted, "median_solve_s": measured,
                       "device_busy_s": busy, "predicted_over_solve": predicted / measured,
                       "predicted_over_busy": predicted / busy}
        if spec.mode == "flat":
            keys = []

            def first_round(k, segs, n):
                if not keys:
                    keys.append(k.clone())
                return ops.segment_min_flat(k, segs, n)

            run_flat(g, pack=True, segmin=first_round)
            bytes_, live = segmin_bytes(keys[0], g.n)
            upper = bytes_ + (keys[0].numel() - live) * 4  # every key live
            terms = flat_round_terms(g.n, int(g.src.shape[0]), p.resolved)
            check(terms["segment_min"][0] == upper,
                  f"cost {label}: segment-min term {terms['segment_min'][0]} B != round 1's "
                  f"{upper} B at live == E")
            rows[label]["terms_bytes"] = {k: v[0] for k, v in terms.items()}
        print(f"  {label}: {cost.analyzed} {cost.bytes:.4g} B x {rep.iterations if cost.dynamic_loops else 1}"
              f" -> predicted {predicted * 1e3:.3f} ms; solve {measured * 1e3:.3f} ms, "
              f"device busy {busy * 1e3:.3f} ms", flush=True)
    return rows


def counting_timer(mode: str):
    """``tune``'s timer: three solves, each ended by a device sync, timed
    on the host clock, each checked for its kernel launches (flat: one
    flat launch per AS round under pack32, none on the float path;
    coarsen: flat launches, and a sorted launch per level with the device
    dedupe, none with the host's)."""
    import torch

    def timer(spec, solve_fn):
        samples = []
        for _ in range(3):
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = solve_fn()
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
            got = {k: v - before[k] for k, v in read_counts().items()}
            if mode == "flat":
                want = rep.iterations if spec.pack else 0
                check(got["segment_min_flat"] == want,
                      f"tune: {got['segment_min_flat']} flat launches for {rep.iterations} "
                      f"rounds of {spec}")
            else:
                check(got["segment_min_flat"] > 0, f"tune: no flat launch in {spec}")
                sorted_ok = (got["segment_min_sorted"] >= len(rep.levels) > 0
                             if spec.dedupe == "device" else got["segment_min_sorted"] == 0)
                check(sorted_ok, f"tune: {got['segment_min_sorted']} sorted launches for "
                                 f"{len(rep.levels)} levels of {spec}")
        return samples
    return timer


def tune_path(graphs: dict) -> tuple[dict, dict]:
    """Phase 6i, tuner: ``tune(g, mode, space="full")`` for each (label,
    mode, graph); no candidate or winner on the plain segment-min; the
    database through ``repro_torch.launch.tune --check``; a ``tuning="db"``
    solve equal in every report field but ``cost`` to the ``"off"`` solve
    with the winner's knobs, and to the default one in its forest.
    Returns (rows, launches by run)."""
    import dataclasses
    import os
    import tempfile

    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.solve import SolveSpec, plan, set_tuning_db
    from repro_torch.solve import tune as T

    db = T.TuningDB()
    rows, launches = {}, {}
    for (label, mode), g in graphs.items():
        reset_counts()
        t0 = time.perf_counter()
        res = T.tune(g, mode, db=db, space="full", timer=counting_timer(mode))
        launches[f"tune {mode} {label}"] = read_counts()
        for r in res.ranking:
            check(r.spec.segmin != T.PLAIN_SEGMIN
                  and r.spec.resolve(g).segmin_flat is not ref.segment_min_flat_ref,
                  f"tune {label}: candidate {T.spec_knobs(r.spec)} runs the plain segment-min")
        check(res.winner.segmin != T.PLAIN_SEGMIN, f"tune {label}: the plain version won")
        rows[f"{mode} {label}"] = {
            "key": res.key._asdict(), "pruned": res.pruned, "seconds": time.perf_counter() - t0,
            "winner": T.spec_knobs(res.winner),
            "ranking": [{"knobs": T.spec_knobs(r.spec), "median_us": r.median_us,
                         "iqr_us": r.iqr_us, "predicted_s": r.predicted_s}
                        for r in res.ranking]}
        print(f"  tune {mode} {label}: {len(res.ranking)} measured, {res.pruned} pruned, "
              f"winner {T.spec_knobs(res.winner)} at {res.ranking[0].median_us:.1f} us "
              f"(slowest {res.ranking[-1].median_us:.1f} us)", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tune_"))
    try:
        path = db.save(str(tmp / "tuning-db.json"))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH", "")) if p))
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.tune", "--check", path],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"tune --check: {proc.stdout} {proc.stderr}")
        set_tuning_db(db)
        for (label, mode), g in graphs.items():
            tuned = plan(g, SolveSpec(mode=mode, tuning="db"))
            check(tuned.resolved.spec.segmin != T.PLAIN_SEGMIN,
                  f"tune {label}: tuning='db' resolved the plain segment-min")
            rep = tuned.solve()
            # every field of the solve with the winner's knobs and tuning off
            same = plan(g, dataclasses.replace(tuned.resolved.spec, tuning="off")).solve()
            check(same_report(same, rep),
                  f"tune {label}: the tuning='db' {mode} solve differs from tuning='off' "
                  f"with the same knobs")
            # the default solve's forest: a tuned coarsen cutoff or round
            # count changes the levels, the rounds and the eids' order
            off = plan(g, SolveSpec(mode=mode)).solve()
            check(rep.weight == off.weight and rep.n_msf_edges == off.n_msf_edges
                  and set(rep.msf_eids.tolist()) == set(off.msf_eids.tolist())
                  and np.array_equal(rep.parent, off.parent),
                  f"tune {label}: the tuning='db' {mode} forest differs from tuning='off'")
            if mode == "flat":
                check(same_report(off, rep),
                      f"tune {label}: the tuning='db' flat solve differs from tuning='off'")
    finally:
        set_tuning_db(None)
        shutil.rmtree(tmp, ignore_errors=True)
    return rows, launches


LOADGEN_CHILD = """
import json, sys
from repro_torch import obs
from repro_torch.launch import serve_graph
try:
    serve_graph.main(["--loadgen", *sys.argv[2:]])
    rc = 0
except SystemExit as e:
    rc = e.code
with open(sys.argv[1], "w") as f:
    json.dump(obs.metrics_snapshot(), f)
sys.exit(rc)
"""


def loadgen_attempt(qps: int, tmp: Path, extra=(), device="cuda") -> dict:
    """``python -m repro_torch.launch.serve_graph --loadgen`` at ``qps`` in
    a subprocess (a wrapper dumps its process's obs metrics after it):
    exit code, report, metrics, and whether the run sustained the rate
    (exit 0, achieved ≥ 0.9 × offered, under 1% dropped, rejected or
    failed)."""
    import os

    out, metrics = tmp / f"slo_{qps}.json", tmp / f"metrics_{qps}.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH", "")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", LOADGEN_CHILD, str(metrics), *LOADGEN_FLAGS,
                           "--qps", str(qps), "--out", str(out), "--device", device, *extra],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(out.exists(), f"loadgen --qps {qps} wrote no report (exit {proc.returncode}): "
                        f"{proc.stderr[-2000:]}")
    rep = json.loads(out.read_text())
    q = rep["queries"]
    lost = (q["dropped"] + q.get("rejected", 0) + q.get("errors", 0)) / max(1, q["offered"])
    rate_ok = rep["achieved_qps"] >= 0.9 * qps and lost < 0.01
    return {"qps": qps, "rc": proc.returncode, "report": rep, "path": out,
            "metrics": json.loads(metrics.read_text()) if metrics.exists() else {},
            "lost_frac": lost, "sustained": proc.returncode == 0 and rate_ok,
            "latency_only": rate_ok and proc.returncode != 0,
            "seconds": time.perf_counter() - t0}


def rate_search(attempt) -> tuple[dict, list]:
    """The highest offered rate a loadgen run sustains: from
    ``LOADGEN_QPS0``, doubling while sustained; below it, halving until
    one is, unless only the latency targets were missed (a window of
    queries fills faster at a higher rate, so the rate doubles then)."""
    rate, best, runs, tried = LOADGEN_QPS0, None, [], set()
    step = 2
    while len(runs) < LOADGEN_ATTEMPTS and rate not in tried:
        tried.add(rate)
        r = attempt(rate)
        runs.append(r)
        print(f"    --qps {rate}: exit {r['rc']}, achieved {r['report']['achieved_qps']:.1f}, "
              f"lost {r['lost_frac']:.4f}, p50/p99 {r['report']['latency_ms']['p50']:.1f} / "
              f"{r['report']['latency_ms']['p99']:.1f} ms, failures "
              f"{r['report']['slo']['failures']} ({r['seconds']:.1f} s)", flush=True)
        if r["sustained"]:
            best = r
            if step < 1:
                break  # walking down: the first sustained rate is the highest
            step = 2
        elif best is not None:
            break
        else:
            step = 2 if r["latency_only"] and step > 1 else 0.5
        rate = int(rate * step)
    check(best is not None, f"loadgen: no offered rate sustained in {[r['qps'] for r in runs]}")
    return best, runs


def check_slo(path: Path, tcp: bool) -> None:
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "check_slo_report.py"),
                           str(path), *(["--tcp"] if tcp else [])],
                          capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"check_slo_report {path}: {proc.stderr.strip()}")


def loadgen_row(best: dict, runs: list, launches: int) -> dict:
    rep = best["report"]
    return {"sustained_qps": best["qps"], "achieved_qps": rep["achieved_qps"],
            "latency_ms": rep["latency_ms"], "queries": rep["queries"], "writer": rep["writer"],
            "lost_frac": best["lost_frac"], "flat_launches": launches,
            "attempts": [{"qps": r["qps"], "rc": r["rc"], "sustained": r["sustained"],
                          "achieved_qps": r["report"]["achieved_qps"],
                          "p50_ms": r["report"]["latency_ms"]["p50"],
                          "p99_ms": r["report"]["latency_ms"]["p99"],
                          "lost_frac": r["lost_frac"], "queries": r["report"]["queries"],
                          "failures": r["report"]["slo"]["failures"],
                          "seconds": r["seconds"]} for r in runs]}


def loadgen_path(device="cuda") -> tuple[dict, dict]:
    """Phase 6i, load harness: in process, then over TCP against a
    ``serve_graph --serve`` subprocess with 6g's arguments. Each at the
    highest rate it sustains; the report through tools/check_slo_report.py;
    the writer applied updates and deletes; the flat kernel launched in
    the run (the in-process run's own metrics; the server's counter)."""
    import tempfile

    from repro_torch.serve import ServeClient

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_loadgen_"))
    (tmp / "in_process").mkdir()
    (tmp / "tcp").mkdir()
    rows, launches = {}, {}
    proc = None
    try:
        best, runs = rate_search(lambda q: loadgen_attempt(q, tmp / "in_process",
                                                           device=device))
        check_slo(best["path"], tcp=False)
        rep = best["report"]
        check(rep["writer"]["updates"] > 0 and rep["writer"]["deletes"] > 0,
              f"loadgen: the writer applied {rep['writer']['updates']} updates and "
              f"{rep['writer']['deletes']} deletes")
        n_flat = best["metrics"].get("counters", {}).get("kernel.segment_min_flat.launches", 0)
        check(n_flat > 0, "loadgen: kernel.segment_min_flat.launches is 0 in the run's metrics")
        launches["loadgen rmat_s20_ef8 in process"] = n_flat
        rows["in_process"] = loadgen_row(best, runs, n_flat)

        graph = LOADGEN_FLAGS[:6]  # --scale, --edge-factor, --seed
        args = [*graph, "--batch-capacity", LOADGEN_FLAGS[7], "--warm-frac",
                str(SERVE_WARM_FRAC), "--device", device, *SERVE_FLAGS]
        t0 = time.perf_counter()
        proc, _, lines, addr, _ = start_server(args, tmp / "server.log")
        rows["server_start_s"] = time.perf_counter() - t0
        counts = {}

        def attempt(q):
            with ServeClient(addr, timeout=300) as c:
                before = counter(c, "kernel.segment_min_flat.launches")
            r = loadgen_attempt(q, tmp / "tcp", ("--target", addr,
                                                 "--warm-frac", str(SERVE_WARM_FRAC)), device)
            with ServeClient(addr, timeout=300) as c:
                counts[q] = counter(c, "kernel.segment_min_flat.launches") - before
            return r

        best, runs = rate_search(attempt)
        check_slo(best["path"], tcp=True)
        rep = best["report"]
        check(rep["writer"]["updates"] > 0 and rep["writer"]["deletes"] > 0,
              f"loadgen --target: the writer applied {rep['writer']['updates']} updates and "
              f"{rep['writer']['deletes']} deletes")
        check(counts[best["qps"]] > 0, "loadgen --target: the server launched no flat kernel")
        launches["loadgen rmat_s20_ef8 over tcp"] = counts[best["qps"]]
        rows["tcp"] = loadgen_row(best, runs, counts[best["qps"]])
        rows["tcp"]["server_counters"] = rep["server"]["metrics"]["counters"]
        stop_server(proc, lines, tmp / "server.log")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return rows, launches


# ---------------------------------------------------------------------------
# phase 6j: the distributed drivers
# ---------------------------------------------------------------------------

PART_FIELDS = ("src_row", "dst_col", "w", "eid", "valid")
PART_STATICS = ("rows", "cols", "shard_size", "n", "n_pad")


def save_partition(part, path: Path) -> None:
    """A ``Partition2D`` as one .npy per array and its statics as JSON."""
    import numpy as np

    path.mkdir(parents=True, exist_ok=True)
    for f in PART_FIELDS:
        np.save(path / f"{f}.npy", getattr(part, f))
    (path / "statics.json").write_text(json.dumps({k: getattr(part, k) for k in PART_STATICS}))


def load_partition(path: Path):
    """:func:`save_partition`'s partition, its arrays mapped copy-on-write
    (a rank copies only its own block)."""
    import numpy as np

    from repro_torch.graphs.partition import Partition2D

    arrays = {f: np.load(path / f"{f}.npy", mmap_mode="c") for f in PART_FIELDS}
    return Partition2D(**arrays, **json.loads((path / "statics.json").read_text()))


def dist_digest(rep) -> dict:
    """A dist report as JSON-able values: the arrays by hash."""
    import hashlib

    import numpy as np

    def h(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    return {"weight": rep.weight, "msf_eids": h(rep.msf_eids), "parent": h(rep.parent),
            "n_msf_edges": rep.n_msf_edges, "iterations": rep.iterations,
            "levels": [list(map(int, lv)) for lv in rep.levels],
            "host_roundtrips": rep.host_roundtrips}


def grid_independent(digest: dict) -> dict:
    """A coarsen digest without the levels' m and m_next columns: they
    count per-block entries (a pair deduped per block survives once per
    rank holding it), so they depend on the grid."""
    out = dict(digest)
    out["levels"] = [[n, n_next, hooked] for n, _, n_next, _, hooked in digest["levels"]]
    return out


def dist_coarsen_launches(levels, n: int, cfg: list, residual_iters: int) -> dict:
    """The launches a dist coarsen solve must make, from its levels (rows
    of (n, m, n_next, m_next, hooked)), the graph's n, its config
    ``[rounds_per_level, max_levels, cutoff]`` and its residual rounds:
    every level, a stalled last one included, makes 2 flat segment-mins
    per hook round and then dedupes once (the sorted kernel); every
    residual round makes 2 flat ones."""
    k, max_levels, cutoff = cfg
    residual_n, residual_m = (levels[-1][2], levels[-1][3]) if levels else (n, 0)
    stalled = int(len(levels) < max_levels and residual_n > cutoff and residual_m > 0)
    return {"segment_min_flat": 2 * k * (len(levels) + stalled) + 2 * residual_iters,
            "segment_min_sorted": len(levels) + stalled}


def turn_times(fns: dict, reps: int = 3) -> dict:
    """Median seconds of each callable, in turns after one warm-up each,
    every call ended by a device sync."""
    import torch

    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    order = list(fns)
    for i in range(reps):
        for k in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t0)
    return {f"{k}_s": statistics.median(v) for k, v in times.items()}


DIST_RANK = r"""
import json, os, statistics, sys, time
from datetime import timedelta
from pathlib import Path
import torch
import torch.distributed as dist

sys.path.insert(0, os.environ["ROOT"])
from chip_smoke import (dist_digest, load_partition, read_counts, reset_counts,
                        DIST_GRID)
from repro_torch.coarsen import CoarsenConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.solve import SolveSpec, plan

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group(os.environ["BACKEND"], store=dist.FileStore(os.environ["STORE"], world),
                        rank=rank, world_size=world, timeout=timedelta(seconds=240))
mesh = make_mesh(DIST_GRID, ("data", "model"))
out = {"rank": rank, "device": str(mesh.device), "backend": mesh.backend}
# CUDA tensors, every dtype and op the port's collectives use.
axes = ("data", "model")
for dt in (torch.int32, torch.int64, torch.float32, torch.float64):
    x = torch.full((3,), rank + 1, dtype=dt, device=mesh.device)
    for op, want in (("min", 1), ("max", world), ("sum", world * (world + 1) // 2)):
        if mesh.all_reduce(x, op, axes).tolist() != [want] * 3:
            raise RuntimeError(f"all_reduce {op} of {dt} on {mesh.device} is wrong")
    if mesh.all_gather(x, axes).tolist() != [r + 1 for r in range(world) for _ in range(3)]:
        raise RuntimeError(f"all_gather of {dt} on {mesh.device} is wrong")
out["collectives"] = "all_gather, all_reduce min/max/sum of int32/int64/float32/float64"
# pack=True: the plan's probe, like the reference's, counts the R*C*Emax
# slots of a 2x2 partition of R-MAT s20 as pack32 positions (more than
# 2^24), though only its eids (< 2^24) enter the keys; 1x1 resolves pack32.
for label, spec in (("flat rmat_s20_ef8", SolveSpec(mode="dist", pack=True)),
                    ("coarsen grid_1024x1024",
                     SolveSpec(mode="dist", coarsen=CoarsenConfig(), dedupe="device"))):
    part = load_partition(Path(os.environ["DIST_DIR"]) / label.split()[1])
    p = plan(part, spec, mesh=mesh)
    reset_counts()
    rep = p.solve()
    torch.cuda.synchronize()
    row = {"digest": dist_digest(rep), "launches": read_counts(),
           "segmin_flat_is_kernel": p.resolved.segmin_flat is ops.segment_min_flat}
    if p.resolved.coarsen is not None:
        cfg = p.resolved.coarsen
        row["residual_iters"] = p.driver.last_stats.residual_iters
        row["cfg"] = [cfg.rounds_per_level, cfg.max_levels, cfg.cutoff]
        row["n"] = part.n
    times = []
    for _ in range(3):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p.solve()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    row["median_s"] = statistics.median(times)
    out[label] = row
with open(os.environ["OUT"], "w") as f:
    json.dump(out, f)
dist.barrier()
os._exit(0)  # leave without tearing the gloo groups down under the other ranks
"""


def dist_grid_ranks(parts: dict, workdir: Path, backend: str = "gloo") -> list:
    """Run :data:`DIST_RANK` as ``prod(DIST_GRID)`` processes over
    ``backend`` (rank r on ``cuda:{r % device_count}``: gloo shares one
    card, NCCL needs a card per rank), on ``parts`` (label →
    Partition2D) saved under ``workdir``; every rank's JSON row. Fails if
    a rank fails or the group outlives :data:`DIST_JOIN_TIMEOUT_S`; kills
    every rank either way."""
    import math
    import os

    shutil.rmtree(workdir, ignore_errors=True)
    for label, part in parts.items():
        save_partition(part, workdir / label)
    world = math.prod(DIST_GRID)
    # Two intra-op threads per rank: four ranks share the host's cores.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), ROOT=str(ROOT), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="2", WORLD_SIZE=str(world), STORE=str(workdir / "store"),
               DIST_DIR=str(workdir), BACKEND=backend)
    procs = []
    try:
        for r in range(world):
            log = open(workdir / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", DIST_RANK], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT,
                env=dict(env, RANK=str(r), OUT=str(workdir / f"rank{r}.json"))), log))
        deadline = time.monotonic() + DIST_JOIN_TIMEOUT_S
        for p, _ in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
            if p.returncode != 0:
                break
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            print((workdir / f"rank{r}.log").read_text()[-3000:], file=sys.stderr)
        fail(f"dist 2x2: ranks {bad} failed or outlived {DIST_JOIN_TIMEOUT_S} s")
    rows = [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(world)]
    shutil.rmtree(workdir, ignore_errors=True)
    return rows


def dist_path(g_rmat, g_rmat19, g_grid, flat_rep, coarsen_reps, device="cuda"):
    """Phase 6j: ``(row, launches)``. ``flat_rep``: phase 5's flat report
    (its weight checked against scipy there); ``coarsen_reps``: 6b's and
    6c's coarsen reports by graph label. ``device="cpu"`` rehearses the
    1x1 half on a gloo group (the kernel checks then fail, as they must)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.coarsen import CoarsenConfig
    from repro_torch.coarsen.relabel import canonical_minvertex_labels
    from repro_torch.graphs.partition import partition_edges_2d
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.solve import SolveSpec, clear_plan_cache, plan

    on_card = device == "cuda"
    dist.init_process_group("nccl" if on_card else "gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    row = {}
    launches = {"segment_min_flat": {}, "segment_min_sorted": {}}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=None if on_card else device)
        print(f"  {mesh}", flush=True)
        t0 = time.perf_counter()
        part = partition_edges_2d(g_rmat, 1, 1)
        print(f"  rmat_s20_ef8 1x1 partition: e_max={part.e_max}, "
              f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
        n = g_rmat.n
        flat_eids = set(flat_rep.msf_eids.tolist())
        flat_weight64 = eid_weight(g_rmat, flat_rep.msf_eids)
        flat_labels = canonical_minvertex_labels(flat_rep.parent, n).numpy()
        flat_row = {}
        for sc in ("csp", "os", "baseline"):
            label = f"dist rmat_s20_ef8 {sc} 1x1"
            p = plan(part, SolveSpec(mode="dist", shortcut=sc), mesh=mesh)
            check(p.resolved.pack is True, f"{label}: pack32 not resolved")
            check(p.resolved.segmin_flat is ops.segment_min_flat,
                  f"{label}: the resolved segment-min is not the CUDA kernel")
            reset_counts()
            rep = p.solve()
            torch.cuda.synchronize()
            counts = read_counts()
            check(0 < counts["segment_min_flat"] == rep.iterations,
                  f"{label}: {counts['segment_min_flat']} flat launches for "
                  f"{rep.iterations} rounds")
            weight64 = eid_weight(g_rmat, rep.msf_eids)
            check(weight64 == flat_weight64,
                  f"{label}: weight {weight64} != the flat solve's (scipy's) {flat_weight64}")
            check(rep.n_msf_edges == flat_rep.n_msf_edges,
                  f"{label}: {rep.n_msf_edges} edges != {flat_rep.n_msf_edges}")
            check(set(rep.msf_eids.tolist()) == flat_eids,
                  f"{label}: eid set differs from the flat solve's")
            check(np.array_equal(canonical_minvertex_labels(rep.parent[:n], n).numpy(),
                                 flat_labels), f"{label}: partition differs from the flat solve's")
            plain = plan(part, SolveSpec(mode="dist", shortcut=sc, segmin="torch"),
                         mesh=mesh).solve()
            check(same_report(rep, plain), f"{label}: report differs from segmin='torch'")
            launches["segment_min_flat"][label] = counts["segment_min_flat"]
            flat_row[sc] = {"rounds": rep.iterations, "launches": counts,
                            "host_syncs_per_solve": count_syncs(p.solve),
                            "digest": dist_digest(rep)}
            print(f"  {label}: rounds={rep.iterations} launches={counts} weight={weight64} "
                  f"syncs={flat_row[sc]['host_syncs_per_solve']}", flush=True)
        flat_row["times"] = turn_times({
            "flat": plan(g_rmat, SolveSpec()).solve,
            **{f"dist_{sc}_1x1": plan(part, SolveSpec(mode="dist", shortcut=sc),
                                      mesh=mesh).solve for sc in ("csp", "os", "baseline")}})
        row["flat rmat_s20_ef8"] = flat_row
        print(f"  medians: {json.dumps(flat_row['times'])}", flush=True)

        coarsen_parts = {}
        for label, g in (("rmat_s19_ef8", g_rmat19), ("grid_1024x1024", g_grid)):
            tag = f"dist coarsen {label} 1x1"
            coarsen_parts[label] = part_c = partition_edges_2d(g, 1, 1)
            spec = SolveSpec(mode="dist", coarsen=CoarsenConfig(), dedupe="device")
            p = plan(part_c, spec, mesh=mesh)
            reset_counts()
            rep = p.solve()
            torch.cuda.synchronize()
            counts = read_counts()
            st = p.driver.last_stats
            check(len(rep.levels) > 0 and rep.host_roundtrips == st.host_roundtrips == 0,
                  f"{tag}: {len(rep.levels)} levels, {rep.host_roundtrips} host round trips")
            cfg = p.resolved.coarsen
            want = dist_coarsen_launches([list(lv) for lv in rep.levels], g.n,
                                         [cfg.rounds_per_level, cfg.max_levels, cfg.cutoff],
                                         st.residual_iters)
            check(counts == want, f"{tag}: launches {counts}, expected {want}")
            ref = coarsen_reps[label]
            check(set(rep.msf_eids.tolist()) == set(ref.msf_eids.tolist()),
                  f"{tag}: eid set differs from the coarsen solve's")
            check(np.array_equal(rep.parent, ref.parent),
                  f"{tag}: partition differs from the coarsen solve's")
            check(eid_weight(g, rep.msf_eids) == eid_weight(g, ref.msf_eids),
                  f"{tag}: weight differs from the coarsen solve's")
            for kernel, k in counts.items():
                launches[kernel][tag] = k
            row[f"coarsen {label}"] = {
                "levels": [list(map(int, lv)) for lv in rep.levels],
                "residual_iters": st.residual_iters, "rounds": rep.iterations,
                "launches": counts, "host_syncs_per_solve": count_syncs(p.solve),
                "digest": dist_digest(rep),
                "times": turn_times({"coarsen": plan(g, SolveSpec(mode="coarsen")).solve,
                                     "dist_coarsen_1x1": p.solve}),
            }
            print(f"  {tag}: {json.dumps({k: v for k, v in row[f'coarsen {label}'].items() if k != 'digest'})}",
                  flush=True)
        clear_plan_cache()

        t0 = time.perf_counter()
        grid = partition_edges_2d(g_rmat, *DIST_GRID), partition_edges_2d(g_grid, *DIST_GRID)
        ranks = dist_grid_ranks({"rmat_s20_ef8": grid[0], "grid_1024x1024": grid[1]},
                                build.BUILD_DIR / "dist_grid")
        del grid
        tag = "x".join(map(str, DIST_GRID))
        for label, one, same in (
                ("flat rmat_s20_ef8", flat_row["csp"]["digest"], dict),
                ("coarsen grid_1024x1024", row["coarsen grid_1024x1024"]["digest"],
                 grid_independent)):
            want = same(json.loads(json.dumps(one)))
            for r in ranks:
                got = r[label]
                check(same(got["digest"]) == want,
                      f"dist {label} {tag}, rank {r['rank']}: report differs from the 1x1 "
                      f"report")
                check(r["device"].startswith("cuda") and r["backend"] == "gloo",
                      f"dist {tag}, rank {r['rank']}: {r['backend']} on {r['device']}")
                check(got["segmin_flat_is_kernel"],
                      f"dist {label} {tag}, rank {r['rank']}: the resolved segment-min is "
                      f"not the CUDA kernel")
                if "cfg" in got:
                    want_l = dist_coarsen_launches(got["digest"]["levels"], got["n"], got["cfg"],
                                                   got["residual_iters"])
                else:
                    want_l = {"segment_min_flat": got["digest"]["iterations"],
                              "segment_min_sorted": 0}
                check(got["launches"] == want_l,
                      f"dist {label} {tag}, rank {r['rank']}: launches {got['launches']}, "
                      f"expected {want_l}")
            row[f"{label} {tag} (four ranks sharing one card)"] = {
                "median_s_by_rank": [r[label]["median_s"] for r in ranks],
                "launches_per_rank": ranks[0][label]["launches"]}
            for kernel, k in ranks[0][label]["launches"].items():
                if k:
                    launches[kernel][f"dist {label} {tag} (per rank)"] = k
        print(f"  {tag} over gloo, {len(ranks)} ranks on one card: every rank's report equal to "
              f"the others' and to 1x1; medians by rank "
              f"{[r['flat rmat_s20_ef8']['median_s'] for r in ranks]} (flat), "
              f"{[r['coarsen grid_1024x1024']['median_s'] for r in ranks]} (coarsen) "
              f"({time.perf_counter() - t0:.1f} s with partitions and start-up)", flush=True)
    finally:
        clear_plan_cache()
        dist.destroy_process_group()
    return row, launches


def dist_cards():
    """The 2x2 grid with one NCCL rank per card, on a host with four cards:

        python3 -c "import chip_smoke; chip_smoke.dist_cards()"

    Builds the kernels, solves phase 5's graph (Fig-2, ``pack=True``) and
    the grid (dist levels) 1x1 on NCCL in this process and 2x2 as four
    processes on four cards, checks every rank's report against the 1x1
    one (as phase 6j does) and each rank's launches, and prints the
    medians beside the 1x1 ones and the single-card flat (coarsen) solve."""
    import torch
    import torch.distributed as dist

    if torch.cuda.device_count() < 4:
        fail(f"dist_cards needs four cards, found {torch.cuda.device_count()}")
    from repro_torch.coarsen import CoarsenConfig
    from repro_torch.graphs import grid_road_graph, rmat_graph
    from repro_torch.graphs.partition import partition_edges_2d
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.solve import SolveSpec, clear_plan_cache, plan

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(f"cards: {smi}", flush=True)
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    build.build_all()
    graphs = {"flat rmat_s20_ef8": rmat_graph(**RMAT, device="cuda"),
              "coarsen grid_1024x1024": grid_road_graph(*GRID, device="cuda")}
    specs = {"flat rmat_s20_ef8": (SolveSpec(mode="dist", pack=True), SolveSpec()),
             "coarsen grid_1024x1024": (
                 SolveSpec(mode="dist", coarsen=CoarsenConfig(), dedupe="device"),
                 SolveSpec(mode="coarsen"))}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    one = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        for label, g in graphs.items():
            p = plan(partition_edges_2d(g, 1, 1), specs[label][0], mesh=mesh)
            one[label] = {"digest": dist_digest(p.solve()),
                          **turn_times({"dist_1x1": p.solve,
                                        "one_card": plan(g, specs[label][1]).solve})}
    finally:
        clear_plan_cache()
        dist.destroy_process_group()
    ranks = dist_grid_ranks({k.split()[1]: partition_edges_2d(g, *DIST_GRID)
                             for k, g in graphs.items()},
                            build.BUILD_DIR / "dist_cards", backend="nccl")
    check(sorted(r["device"] for r in ranks) == [f"cuda:{i}" for i in range(len(ranks))],
          f"dist_cards: ranks not one per card: {[r['device'] for r in ranks]}")
    row = {}
    for label, same in (("flat rmat_s20_ef8", dict), ("coarsen grid_1024x1024", grid_independent)):
        want = same(json.loads(json.dumps(one[label]["digest"])))
        for r in ranks:
            got = r[label]
            check(r["backend"] == "nccl" and got["segmin_flat_is_kernel"],
                  f"dist_cards {label}, rank {r['rank']}: {r['backend']}, not the kernel")
            check(same(got["digest"]) == want,
                  f"dist_cards {label}, rank {r['rank']}: report differs from the 1x1 report")
            want_l = (dist_coarsen_launches(got["digest"]["levels"], got["n"], got["cfg"],
                                            got["residual_iters"]) if "cfg" in got else
                      {"segment_min_flat": got["digest"]["iterations"], "segment_min_sorted": 0})
            check(got["launches"] == want_l,
                  f"dist_cards {label}, rank {r['rank']}: launches {got['launches']}, "
                  f"expected {want_l}")
        row[label] = {**{k: v for k, v in one[label].items() if k != "digest"},
                      "dist_2x2_nccl_median_s_by_rank": [r[label]["median_s"] for r in ranks],
                      "launches_per_rank": ranks[0][label]["launches"]}
    print(json.dumps({"dist_cards_2x2_nccl": row, "cards": smi}))


def solve_times(g, specs: dict, reps: int = 3) -> dict:
    """Median end-to-end solve seconds of each spec (planning included),
    in turns after one warm-up each."""
    from repro_torch.solve import plan

    return turn_times({k: partial(lambda s: plan(g, s).solve(), s) for k, s in specs.items()},
                      reps)


def segmin_bytes(keys, n) -> tuple[int, int]:
    """(bytes, live entries) that a packed segment-min over ``keys`` into
    ``n`` segments must move: every 8-byte key read once, a 4-byte id read
    only under a live (non-identity) key, since an identity key leaves the
    result as it is whatever its id, and the output written once (8 B per
    segment)."""
    from repro_torch.kernels import ref

    live = int((keys != ref.PACK_IDENTITY).sum())
    return keys.numel() * 8 + live * 4 + n * 8, live


def round_times(g) -> list:
    """The segment-min kernel, its plain version and the one PyTorch library
    call timed on the inputs each AS round of the default solve hands the
    segment-min (recorded in a replay of the default driver), beside the
    round's memory bound (:func:`segmin_bytes`)."""
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
        bytes_, live = segmin_bytes(keys, n)
        kernel = partial(ops.segment_min_flat, keys, segs, n)
        library = partial(out.scatter_reduce_, 0, idx, keys, "amin", include_self=True)
        row = {
            "E": keys.numel(),
            "live_entries": live,
            "live_share": live / max(1, keys.numel()),
            "kernel_ms": device_ms(kernel),
            "kernel_call_ms": time_ms(kernel),
            "plain_ms": device_ms(partial(ref.segment_min_flat_ref, keys, segs, n)),
            "library_ms": device_ms(library),
            "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3,
            "bytes": bytes_,
        }
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        rows.append(row)
    return rows


def level_times(inputs) -> list:
    """The sorted kernel, its plain version and the one PyTorch library call
    timed on each level's dedupe inputs, beside the level's memory bound
    (:func:`segmin_bytes`)."""
    import torch

    from repro_torch.kernels import ops, ref

    rows = []
    for keys, segs, n in inputs:
        idx = segs.long()
        out = torch.full((n,), ref.PACK_IDENTITY, dtype=torch.int64, device=keys.device)
        bytes_, live = segmin_bytes(keys, n)
        kernel = partial(ops.segment_min_sorted, keys, segs, n)
        library = partial(out.scatter_reduce_, 0, idx, keys, "amin", include_self=True)
        rows.append({
            "E": keys.numel(),
            "num_segments": n,
            "live_entries": live,
            "kernel_ms": device_ms(kernel),
            "kernel_call_ms": time_ms(kernel),
            "plain_ms": device_ms(partial(ref.segment_min_sorted_ref, keys, segs, n)),
            "library_ms": device_ms(library),
            "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3,
            "bytes": bytes_,
        })
    return rows


def coarsen_breakdown(g) -> dict:
    """Host seconds of the default coarsen solve's stages, each ended by a
    device sync: the levels, the residual flat solve, and the rest (the
    merge into original ids and the report)."""
    import torch

    from repro_torch.coarsen import CoarsenConfig, run_levels
    from repro_torch.core.msf import flat_msf
    from repro_torch.solve import SolveSpec, plan

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, total = timed(plan(g, SolveSpec(mode="coarsen")).solve)
    prelude, levels = timed(lambda: run_levels(g, CoarsenConfig()))
    _, residual = timed(lambda: flat_msf(prelude.residual, pack=True))
    return {"total_s": total, "levels_s": levels, "residual_s": residual,
            "rest_s": total - levels - residual}


def count_syncs(fn) -> int:
    """Host-device synchronisations during ``fn()``: those torch's sync
    debug mode reports (copies to the host, ``.item()``, ``nonzero``...)
    plus the explicit ``torch.cuda.synchronize`` calls, which it does not
    report (an obs span's sync in trace mode)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    sync = torch.cuda.synchronize
    explicit = 0

    def counted(*a, **k):
        nonlocal explicit
        explicit += 1
        return sync(*a, **k)

    torch.cuda.synchronize = counted
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize = sync
    return explicit + sum("synchroniz" in str(w.message) for w in caught)


def profile_solve(g, spec=None, top: int = 8) -> dict:
    """One solve (default: ``SolveSpec()``) under torch.profiler: device
    time by kernel."""
    from repro_torch.solve import SolveSpec, plan

    # Device-side rows only (kernels, copies): an op row repeats its kernels' time.
    rows = device_rows(lambda: plan(g, spec or SolveSpec()).solve())
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
    t0 = time.perf_counter()
    g_rmat19 = rmat_graph(**RMAT_COARSEN, device="cuda")
    g_grid = grid_road_graph(*GRID, device="cuda")
    print(f"  coarsen graphs generated in {time.perf_counter() - t0:.1f} s (host)", flush=True)
    dedupe_in = {"rmat_s19_ef8": record_dedupe_inputs(g_rmat19),
                 "grid_1024x1024": record_dedupe_inputs(g_grid)}
    level0 = [(f"level-0 dedupe of {label}", *ins[0]) for label, ins in dedupe_in.items()]
    max_err_sorted = sorted_kernel_cases("cuda", level0)
    max_err_dense = dense_kernel_cases("cuda")
    max_err_bucketed = bucketed_kernel_cases("cuda")

    phase("4 small graphs, card vs CPU")
    small_graphs()

    phase("5 main path: R-MAT scale 20, edge factor 8")
    t0 = time.perf_counter()
    g_rmat = rmat_graph(**RMAT, device="cuda")
    print(f"  generated in {time.perf_counter() - t0:.1f} s (host)", flush=True)
    launches = main_path("rmat_s20_ef8", g_rmat)

    phase("6 main path: grid 1024 x 1024")
    launches_grid = main_path("grid_1024x1024", g_grid)

    from repro_torch.solve import SolveSpec, plan

    coarsen_launches, coarsen_reps = {}, {}
    flat_reps = {"rmat_s20_ef8": plan(g_rmat, SolveSpec()).solve(),
                 "grid_1024x1024": plan(g_grid, SolveSpec()).solve()}
    for ph, label, g in (("6b", "rmat_s19_ef8", g_rmat19), ("6c", "grid_1024x1024", g_grid)):
        phase(f"{ph} coarsen path: {label}")
        flat_rep = flat_reps[label] if label in flat_reps else plan(g, SolveSpec()).solve()
        coarsen_launches[label], coarsen_reps[label] = coarsen_path(label, g, flat_rep)

    phase("6d kernel entry points at real size")
    t0 = time.perf_counter()
    dense_graphs = {k: rmat_graph(**v, device="cuda") for k, v in DENSE_GRAPHS.items()}
    print(f"  graphs generated in {time.perf_counter() - t0:.1f} s (host)", flush=True)
    entry_launches, dense_in, bucket_in, entry_err = entry_points(
        dense_graphs, {"grid_1024x1024": g_grid, "rmat_s14_ef8": dense_graphs["rmat_s14_ef8"]})
    print(f"  launches on the entry-point path: {json.dumps(entry_launches)}", flush=True)

    phase("6e connectivity and SSSP")
    cc_rows = {label: cc_sssp(label, g, flat_reps[label])
               for label, g in (("rmat_s20_ef8", g_rmat), ("grid_1024x1024", g_grid))}

    phase("6f stream path")
    t6f = t0 = time.perf_counter()
    g_s16 = rmat_graph(**STREAM_A, device="cuda")
    print(f"  rmat_s16_ef2 generated in {time.perf_counter() - t0:.1f} s (host)", flush=True)
    stream_a = stream_acceptance(g_s16)
    stream_b, stream_update = stream_rmat20(g_rmat)
    print(json.dumps({"stream_rmat_s20_ef8": stream_b, "card": smi}))
    print(f"  phase 6f took {time.perf_counter() - t6f:.1f} s", flush=True)

    phase("6g serving: serve_graph --serve on R-MAT scale 20")
    t0 = time.perf_counter()
    serve_row = serve_path(g_rmat)
    print(json.dumps({"serve_rmat_s20_ef8": serve_row, "card": smi}))
    print(f"  phase 6g took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("6h obs on the card")
    t0 = time.perf_counter()
    obs_row = obs_path(g_rmat, g_grid)
    print(json.dumps({"obs_on_the_card": obs_row, "card": smi}))
    print(f"  phase 6h took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("6i plan cost (the tuner and the load harness run after phase 7)")
    t0 = time.perf_counter()
    cost_rows = cost_path({
        "flat rmat_s20_ef8": (g_rmat, SolveSpec()),
        "flat grid_1024x1024": (g_grid, SolveSpec()),
        "coarsen rmat_s19_ef8": (g_rmat19, SolveSpec(mode="coarsen")),
        "coarsen grid_1024x1024": (g_grid, SolveSpec(mode="coarsen")),
    })
    flat_syncs = count_syncs(plan(g_rmat, SolveSpec()).solve)
    check(flat_syncs == FLAT_RMAT_SYNCS,
          f"cost: {flat_syncs} host syncs per flat R-MAT s20 solve, not {FLAT_RMAT_SYNCS}")
    print(json.dumps({"plan_cost": cost_rows, "flat_rmat_s20_ef8_syncs": flat_syncs,
                      "card": smi}))
    print(f"  phase 6i (plan cost) took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("7 times")
    per_round = round_times(g_rmat)
    print(json.dumps({"segment_min_flat_per_round_rmat_s20_ef8": per_round, "card": smi}))
    per_round_grid = round_times(g_grid)
    print(json.dumps({"segment_min_flat_per_round_grid_1024x1024": per_round_grid, "card": smi}))
    fields = ("kernel_ms", "kernel_call_ms", "plain_ms", "library_ms", "bound_ms")
    mean = {k: statistics.fmean(r[k] for r in per_round) for k in fields}
    mean_grid = {k: statistics.fmean(r[k] for r in per_round_grid) for k in fields}
    per_level = {label: level_times(ins) for label, ins in dedupe_in.items()}
    del dedupe_in, level0
    print(json.dumps({"segment_min_sorted_per_level": per_level, "card": smi}))
    all_levels = [r for rows in per_level.values() for r in rows]
    mean_sorted = {k: statistics.fmean(r[k] for r in all_levels) for k in fields}

    solve = {}
    for label, g in (("rmat_s20_ef8", g_rmat), ("grid_1024x1024", g_grid)):
        p = plan(g, SolveSpec())
        solve[label] = {
            **solve_times(g, {"cuda": SolveSpec(), "torch": SolveSpec(segmin="torch")}),
            "rounds": p.solve().iterations,
            "host_syncs_per_solve": count_syncs(p.solve),
            "profile": profile_solve(g),
        }
    print(json.dumps({"solve_seconds_median_of_3": solve, "card": smi}))
    coarsen = {}
    coarsen_spec = SolveSpec(mode="coarsen")
    for label, g in (("rmat_s19_ef8", g_rmat19), ("grid_1024x1024", g_grid)):
        p = plan(g, coarsen_spec)
        rep = p.solve()
        coarsen[label] = {
            **solve_times(g, {"coarsen": coarsen_spec, "flat": SolveSpec()}),
            "levels": [tuple(lv) for lv in rep.levels],
            "rounds": rep.iterations,
            "host_syncs_per_coarsen_solve": count_syncs(p.solve),
            "stages": coarsen_breakdown(g),
            "profile_coarsen": profile_solve(g, coarsen_spec),
        }
    print(json.dumps({"coarsen_vs_flat_seconds_median_of_3": coarsen, "card": smi}))
    print(json.dumps({"connectivity_and_sssp": cc_rows, "card": smi}))
    dense_rows = dense_times(dense_in)
    del dense_in
    print(json.dumps({"multilinear_dense_entry_points": dense_rows, "card": smi}))
    bucket_rows = bucketed_times(bucket_in)
    print(json.dumps({"segment_min_bucketed_entry_points": bucket_rows, "card": smi}))
    prof = profile_update(stream_update)
    prof["host_share_of_median_update"] = 1 - (prof["device_busy_ms"] / 1e3
                                               / stream_b["insert_latency_median_s"])
    print(json.dumps({"stream_rmat_s20_ef8_one_update_profiled": prof, "card": smi}))

    # Last, after every profiler session: neither needs one, and after a
    # coarsen sweep torch.profiler drops most device events of later runs.
    phase("6i tuner and load harness")
    t0 = time.perf_counter()
    tune_rows, tune_launches = tune_path({("rmat_s20_ef8", "flat"): g_rmat,
                                          ("grid_1024x1024", "flat"): g_grid,
                                          ("grid_1024x1024", "coarsen"): g_grid})
    print(json.dumps({"tune": tune_rows, "card": smi}))
    loadgen_rows, loadgen_launches = loadgen_path()
    print(json.dumps({"loadgen": loadgen_rows, "card": smi}))
    print(f"  phase 6i (tuner, load harness) took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("6j distributed drivers: 1x1 on NCCL, 2x2 over gloo on the one card")
    t0 = time.perf_counter()
    dist_row, dist_launches = dist_path(g_rmat, g_rmat19, g_grid, flat_reps["rmat_s20_ef8"],
                                        coarsen_reps)
    print(json.dumps({"dist": dist_row, "card": smi}))
    print(f"  phase 6j took {time.perf_counter() - t0:.1f} s", flush=True)
    mean_dense = {k: statistics.fmean(r[k] for r in dense_rows) for k in fields
                  if k != "library_ms"}
    mean_bucketed = {k: statistics.fmean(r[k] for r in bucket_rows) for k in fields}
    entry_note = ("ms, plain_ms, library_ms: device time (torch.profiler); call_ms: CUDA "
                  "events around back-to-back calls, the wrapper's host time included")
    print(json.dumps({"kernels": [{
        "name": "segment_min_flat",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_min_flat.cu",
        "replaces": "src/repro/kernels/segment_min_bucketed.py:113",
        "launches": launches,
        "launches_by_path": {
            "flat rmat_s20_ef8": launches, "flat grid_1024x1024": launches_grid,
            **{f"coarsen {k}": v["segment_min_flat"] for k, v in coarsen_launches.items()},
            "entry points (one AS round for the dense kernel's p)":
                entry_launches["segment_min_flat"],
            **stream_launches(stream_a, stream_b, "segment_min_flat"),
            "serve rmat_s20_ef8 inserts": serve_row["insert_launches"],
            "serve rmat_s20_ef8 delete": serve_row["delete_launches"],
            **{k: v["segment_min_flat"] for k, v in tune_launches.items()},
            **loadgen_launches,
            **dist_launches["segment_min_flat"]},
        "matches_plain": True,
        "max_abs_err": max_err,
        "ms": mean["kernel_ms"],
        "call_ms": mean["kernel_call_ms"],
        "plain_ms": mean["plain_ms"],
        "bound_ms": mean["bound_ms"],
        "bound_by": "bytes",
        "library_ms": mean["library_ms"],
        "grid_1024x1024": mean_grid,
        "timed_on": "each AS round's inputs of the R-MAT flat main path, mean per launch "
                    "(grid_1024x1024: the same over the grid's rounds); "
                    "ms, plain_ms, library_ms: device time (torch.profiler); call_ms: CUDA "
                    "events around back-to-back calls, the wrapper's host time included",
    }, {
        "name": "segment_min_sorted",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_min_sorted.cu",
        "replaces": "src/repro/kernels/segment_min_sorted.py:117",
        "launches": coarsen_launches["rmat_s19_ef8"]["segment_min_sorted"],
        "launches_by_path": {**{f"coarsen {k}": v["segment_min_sorted"]
                                for k, v in coarsen_launches.items()},
                             **stream_launches(stream_a, stream_b, "segment_min_sorted"),
                             **{k: v["segment_min_sorted"] for k, v in tune_launches.items()
                                if k.startswith("tune coarsen")},
                             **dist_launches["segment_min_sorted"]},
        "matches_plain": True,
        "max_abs_err": max_err_sorted,
        "ms": mean_sorted["kernel_ms"],
        "call_ms": mean_sorted["kernel_call_ms"],
        "plain_ms": mean_sorted["plain_ms"],
        "bound_ms": mean_sorted["bound_ms"],
        "bound_by": "bytes",
        "library_ms": mean_sorted["library_ms"],
        "timed_on": "each level's dedupe inputs of both coarsen main paths, mean per launch; "
                    "ms, plain_ms, library_ms: device time (torch.profiler); call_ms: CUDA "
                    "events around back-to-back calls, the wrapper's host time included",
    }, {
        "name": "multilinear_dense",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/multilinear_dense.cu",
        "replaces": "src/repro/kernels/multilinear_dense.py:68",
        "launches": entry_launches["multilinear_dense"],
        "launches_by_path": {"entry points": entry_launches["multilinear_dense"]},
        "matches_plain": True,
        "max_abs_err": max(max_err_dense, entry_err["multilinear_dense"]),
        "ms": mean_dense["kernel_ms"],
        "call_ms": mean_dense["kernel_call_ms"],
        "plain_ms": mean_dense["plain_ms"],
        "bound_ms": mean_dense["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes a masked lexicographic argmin "
                        "with payload",
        "timed_on": "the dense adjacencies of R-MAT s14 ef8 and s12 ef64 (seed 1), p = "
                    "arange(n) and p after one AS round, mean per launch; " + entry_note,
    }, {
        "name": "segment_min_bucketed",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_min_bucketed.cu",
        "replaces": "src/repro/kernels/segment_min_bucketed.py:62",
        "launches": entry_launches["segment_min_bucketed"],
        "launches_by_path": {"entry points": entry_launches["segment_min_bucketed"]},
        "matches_plain": True,
        "max_abs_err": max(max_err_bucketed, entry_err["segment_min_bucketed"]),
        "ms": mean_bucketed["kernel_ms"],
        "call_ms": mean_bucketed["kernel_call_ms"],
        "plain_ms": mean_bucketed["plain_ms"],
        "bound_ms": mean_bucketed["bound_ms"],
        "bound_by": "bytes",
        "library_ms": mean_bucketed["library_ms"],
        "timed_on": "the bucketed layouts of the grid 1024 x 1024 and R-MAT s14 ef8 (segment "
                    "= source vertex), mean per launch; library: scatter_reduce_ amin over "
                    "b * 128 + rows; " + entry_note,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
