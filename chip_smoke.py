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
     flat solve (36 with obs off and with "metrics"; "trace" adds five a
     round, the spans' own, and one for msf.flat; the traced solve's
     host_syncs tally equals the untraced count) and median solve times
     per mode; the report through page-locked buffers: equal to a read of
     each field into pageable memory, a kept report unchanged by later
     solves of other graphs, the solve.report span's pinned and d2h_bytes,
     two waits; the card's page-locked and pageable copy rates of 128 MiB
     and the cost of a fresh page-locked 128 MiB; then each benchmark
     cell's graph (BENCHMARK.json, made as msfbench makes it): the tally
     against the untraced and the traced solve's syncs and the cell's own
     count, the report span, the per-round spans, and the cost of tracing
     (``python3 chip_smoke.py --phase 6h`` runs the build and this phase
     alone);
  6i. cost, tuner and load harness: plan.cost of the flat plans of phase
     5's and 6's graphs and the coarsen plans of 6b's and 6c's, its
     roofline prediction for the report's rounds beside the median solve
     and the device busy time, the cost the report's, no host sync in the
     model, the flat model's segment-min term equal to round 1's bytes
     with every key live, 36 host syncs per R-MAT s20 flat solve;
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
  6k. the GNN and recsys trainer (run last, after 6j, outside any
     profiler session): (a) `repro_torch.launch.train.run` on the card for
     gat-cora, meshgraphnet, gatedgcn, nequip and xdeepfm at their smoke
     configs, 60 steps (nequip 200: its learning rate warms up over 100),
     each loss falling; gat-cora crashed at step 17 and resumed from its
     checkpoints, its last loss within rel 1e-4 of the uninterrupted run's
     (index_add_ on the card adds in no fixed order); each arch's first
     step on the card from the CPU's weights, its loss within rel 1e-4 of
     the CPU's, every parameter and optimizer tensor on the card. (b) each
     GNN at its published CONFIG on the registry's shape cell: gat-cora at
     full_graph_sm (make_planted_graph_task, 2,708 nodes, 21,112 edges,
     1,433 features), gatedgcn and meshgraphnet at minibatch_lg (one
     NeighborSampler draw of 1,024 seeds, fanouts (15, 10), over phase 5's
     CSR, padded to (169,984, 168,960), 602 features and targets planted
     on the draw), nequip at molecule (MoleculeBatchSource(30, 64, 128));
     xdeepfm at 120M rows through build_training("xdeepfm", full=True)
     (batch 256), then recsys_serve_step at serve_p99 (512) and
     recsys_retrieval_step at retrieval_cand (1 query, 10^6 candidates,
     top 100, against a full sort): per run the median step ms over 5
     steps after 2, the allocator's peak, the first and last loss
     (finite) and the card; none of the five kernels launched;
  6l. the LM family (last, after 6k, in a fresh process: after a coarsen
     sweep torch.profiler drops device events, and the full-width models
     want the card's memory): (a) `launch.train.run` on the card for
     qwen2-7b, mixtral-8x7b, qwen3-32b, command-r-35b and kimi-k2 at their
     smoke configs, 60 steps, each loss falling; mixtral crashed at step
     25 under `--supervise` and resumed, its last loss within rel 1e-3 of
     the uninterrupted run's; each arch's first step on the card from the
     CPU's weights within rel 1e-4 of the CPU's loss; the prefill/decode
     check of tests/test_models_lm.py (3e-2). (b) `launch.serve.generate`
     at full width: qwen2-7b's CONFIG (28 layers) with serve's default
     request (batch 4, prompt 32, 16 tokens) and a 32,768-token prompt at
     batch 1 with 64 tokens; mixtral-8x7b at 4 of 32 layers, an
     8,192-token prompt (past the 4,096 window: the cache rolls) and 64
     tokens; qwen3-32b at 8 of 64 layers, 4,096 and 32; per run the
     prefill seconds, decode ms per token beside its bound (the float32
     weights but the embedding table and the attended cache read once at
     3.35 TB/s), tokens/s, the allocator's peak, and at the end the last
     token decoded on the cache against a prefill of the whole sequence
     (3e-2, scaled by the largest logit above 1); the blockwise
     flash_attention on layer 0's q/k/v at 32k beside
     F.scaled_dot_product_attention(is_causal=True) with the GQA heads
     expanded, for the record. (c) lm_train_step at the train_4k cell's
     4,096 tokens: qwen2-7b at 2 layers, batch 2; mixtral-8x7b at 1
     layer, batch 1: median step ms over 5 after 2, peak, first and last
     loss (finite). (d) torch.profiler over one qwen2-7b decode step on
     the 32k cache and one layer's 32k prefill: top device operations and
     the busy share. None of the five kernels launched;
  6m. the mesh-sharded LM (last, after 6l, in a fresh process): each run
     first on one rank (the whole model on the card), then on four gloo
     ranks sharing the card, with the same weights (init_lm, seed 0):
     (a) qwen2-7b whole (28 layers) on a 1x4 mesh, 7 query heads and 1 KV
     head a rank: a float32 default request (4 x 32, 16 tokens), its
     prefill logits within 1e-3 of the largest of one rank's and its
     greedy tokens equal; the float32 end check at LM_CHECK, both logits
     within 1e-3 of one rank's and decode within 1e-3 of prefill; the
     bfloat16 default request timed (prefill s, decode ms/token beside the
     rank's weights-read bound), its tokens' agreement with one rank's
     recorded; torch.profiler over one decode step on rank 0 (the gloo
     collectives' share); (b) mixtral-8x7b at 2 of 32 layers on 2x2 (4
     experts a rank) under a capacity that drops no token: a float32
     prompt of 2 x 8,192 (past the 4,096 window) and 16 tokens, logits
     and tokens compared, then bfloat16, timed; (c) qwen2-7b at 2 layers
     on 2x2: one float32 lm_train_step at 2 x 4,096 from the same state,
     loss and gnorm within rel 1e-4 of one rank's, then a second step,
     timed; each rank's peak per run, logits equal on every rank, and
     none of the five kernels launched;
  6n. the dry run (last, after 6m): (a) `python -m
     repro_torch.launch.dryrun --mesh both` for mixtral-8x7b decode_32k,
     gatedgcn full_graph_sm, xdeepfm train_batch and the MSF rmat_s23_e8
     (each ok on 16x16 and 2x16x16) and qwen2-7b train_4k (which must fail
     with check_mesh's ValueError), five processes at once; (b) in a fresh
     process, the dry-run cell of qwen2-7b at 2 layers, 2 x 4,096 tokens,
     train step, at 1x1, counted on meta tensors over a fake process group
     and then run on the card over a 1x1 NCCL group: FlopCounterMode's
     FLOPs and the argument bytes equal, the counted peak temporary bytes
     within 25% of the allocator's peak above what was resident, the
     cell's bound no larger than the measured step (median of 3 after a
     warm-up); (c) the collective bytes of the fake 1x4 qwen2-7b decode
     cell of 6m's request (its float32 weights) equal to those rank 0
     counted over one real decode step of 6m (a); (d) solve.cost's
     dist_round_terms bound of one 1x1 pack32 round of phase 5's R-MAT s20
     no larger than 6j's measured round, beside 6i's flat predicted/solve;
     none of the five kernels launched;
  6o. the 64-bit min-outgoing kernel of the unpacked flat round (run
     after 6h; ``python3 chip_smoke.py --phase 6o`` runs the build and this phase
     alone): on phase 5's graph with its weights + 0.5 and on the
     g500-s25.solve cell's graph (made as msfbench makes it), the planner
     declines pack32, a solve launches the kernel once per AS round; on
     each round's parent vector the kernel equals the segment_argmin route
     it replaced (weights up to the sign of zero, eids and payloads
     exactly) and its in-kernel count the mask's; per round the device
     time of its reduce and payload passes (and the fill and decode)
     beside the round's bound (17 B an edge, 16 B a vertex), the replaced
     route's device time and, on R-MAT, the plain twin's; the median solve;
  6p. the same kernel's undirected mode in the coarsen levels (run after 6o;
     ``python3 chip_smoke.py --phase 6p`` runs the build and this phase
     alone): ptxas's registers and spills of each instantiation of the
     kernel, directed and undirected; on the g500-s24.coarsen cell's graph
     (made as msfbench makes it), a coarsen solve launches it once per
     level round and the flat kernel once per residual round; on each
     level round's arrays and parent vector it equals the four scatter-mins
     it replaced (weights up to the sign of zero, eids exactly, payloads
     wherever the weight is finite) and its in-kernel count the mask's;
     per round the device time of its reduce and payload passes beside the
     round's bound (17 B an edge, 16 B a vertex) and the replaced route's
     device time; the median solve;
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
per card against the 1x1 solve, and `python3 -c "import chip_smoke;
chip_smoke.lm_dist_cards()"` the sharded LM with one NCCL rank per card
(models one card cannot hold: see lm_dist_cards).
"""
from __future__ import annotations

import json
import math
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
# Host syncs of one flat R-MAT s20 solve (5 AS rounds; phase 6h): the report
# waits twice, for its scalars and then for both arrays.
FLAT_RMAT_SYNCS = 36
# Phase 6h on the benchmark's cells (BENCHMARK.json): solves timed per obs
# mode, and the host syncs of one solve of the cell's graph.
BENCH_CELLS = {"g500-s25.solve": 3, "g500-s24.coarsen": 6}
BENCH_CELL_SYNCS = {"g500-s25.solve": 38, "g500-s24.coarsen": 56}
# Phase 6h: the report's arrays are int32 [n] at most, 128 MiB at scale 25.
REPORT_PROBE_BYTES = 1 << 27
# Phase 6o: the 64-bit min-outgoing kernel per AS round on phase 5's graph
# made unpacked (weights + 0.5) and on this cell's own graph.
FLAT64_CELL = "g500-s25.solve"
# Phase 6p: the undirected mode per coarsen level round on this cell's graph.
UND64_CELL = "g500-s24.coarsen"
# Phase 6j: the 2x2 grid as four processes on the one card, over gloo.
DIST_GRID = (2, 2)
DIST_JOIN_TIMEOUT_S = 300
# Phase 6k: the trainer. nequip runs 200 steps: the reference's own run()
# does not lower its smoke loss in 60 (263.58 -> 274.75 on the CPU; the
# learning rate warms up over 100 steps), it does by 100 (231.87).
TRAIN_ARCHS = ("gat-cora", "meshgraphnet", "gatedgcn", "nequip", "xdeepfm")
TRAIN_STEPS = 60
TRAIN_STEPS_OF = {"nequip": 200}
TRAIN_FAULT_AT = 17
# index_add_ on the card adds in no fixed order, so two runs of the same
# steps round apart; both tolerances are float32 rounding over 60 steps.
TRAIN_RESUME_REL = 1e-4
TRAIN_CARD_CPU_REL = 1e-4
MINIBATCH_PAD = (169_984, 168_960)  # max_sample_sizes(1024, (15, 10))
FULL_WARMUP, FULL_TIMED = 2, 5
SERVE_REPS = 12
RETRIEVAL_K = 100
# Phase 6l: the LM family. The reference's own 60-step CPU run lowers every
# LM arch's smoke loss (qwen2-7b 6.2495 -> 6.1905, mixtral-8x7b 6.2491 ->
# 6.1907, qwen3-32b 6.2468 -> 6.1964, command-r-35b 6.2494 -> 6.1906,
# kimi-k2 6.2468 -> 6.1902), so each runs 60 steps.
LM_ARCHS = ("qwen2-7b", "mixtral-8x7b", "qwen3-32b", "command-r-35b", "kimi-k2-1t-a32b")
LM_STEPS = 60
LM_FAULT = ("mixtral-8x7b", 25)
# bfloat16 matmuls whose float32 inputs differ in the last bit (an
# embedding gradient summed by atomics in another order) may round a step
# apart, so a resumed run and the uninterrupted one agree to bfloat16
# rounding over 35 steps, not to float32's; the card against the CPU on
# one step is held to the trainer's 1e-4.
LM_RESUME_REL = 1e-3
LM_CARD_CPU_REL = 1e-4
# The prefill/decode bound of tests/test_models_lm.py (max abs logit
# error); at full width it scales with the largest logit, when above 1,
# and gives way to twice the model's measured bfloat16 noise (lm_serve).
LM_PARITY = 3e-2
# The float32 end check at full width: (batch, prompt, tokens), a prompt
# past two 2,048-token chunks and the 4,096 window, and its bound
# relative to the largest logit (float32 rounding over up to 28 layers).
LM_CHECK = (1, 4_200, 8)
LM_F32_REL = 1e-3
# (arch, layers or None for all, requests (batch, prompt, tokens)): qwen2-7b
# whole (30.5 GB of float32 weights) with launch.serve's default request,
# then prefill_32k at batch 1 (cut from 32) and 64 decodes as decode_32k at
# batch 1 (cut from 128: its cache alone would be 240 GB); mixtral-8x7b at
# 4 of 32 layers (the whole model is 187 GB) past its 4,096 window;
# qwen3-32b at 8 of 64 layers (qk_norm, head_dim 128 != d / h).
LM_SERVE = (("qwen2-7b", None, ((4, 32, 16), (1, 32_768, 64))),
            ("mixtral-8x7b", 4, ((1, 8_192, 64),)),
            ("qwen3-32b", 8, ((1, 4_096, 32),)))
# (arch, layers, batch) at the train_4k cell's 4,096 tokens (batch cut from
# 256): parameters, gradients and AdamW moments of the whole qwen2-7b are
# 122 GB.
LM_TRAIN = (("qwen2-7b", 2, 2), ("mixtral-8x7b", 1, 1))
LM_CHILD_TIMEOUT_S = 600
# Phase 6m: four gloo ranks on the one card against one rank, the same
# weights. (a) qwen2-7b whole on 1x4 (7 query heads and 1 KV head a rank)
# with launch.serve's default request (batch, prompt, tokens) and the
# float32 end check at LM_CHECK; (b) (arch, layers, request): mixtral at 2
# of 32 layers on 2x2 (4 experts a rank) past its 4,096 window; (c) (arch,
# layers, (batch, seq)): one float32 lm_train_step on 2x2, its loss and
# gnorm within LM_MESH_STEP_REL of one rank's, at the train_4k cell's
# 4,096 tokens (batch cut from 256).
LM_MESH_WORLD = 4
LM_MESH_REQUEST = (4, 32, 16)
LM_MESH_MOE = ("mixtral-8x7b", 2, (2, 8_192, 16))
LM_MESH_TRAIN = ("qwen2-7b", 2, (2, 4_096))
LM_MESH_STEP_REL = 1e-4
LM_MESH_TIMEOUT_S = 900
LM_MESH_CHILD_TIMEOUT_S = 1200
# lm_dist_cards (four cards, one NCCL rank each): (arch, layers or None
# for all, mesh, requests (batch, prompt, tokens)) in order of priority,
# then (arch, (batch, seq), steps) trained at 1x4.
LM_CARDS_SERVE = (
    ("mixtral-8x7b", None, (1, 4), ((4, 32, 16), (1, 8_192, 16))),
    ("qwen3-32b", None, (1, 4), ((4, 32, 16),)),
    ("command-r-35b", None, (1, 4), ((4, 32, 16),)),
    ("kimi-k2-1t-a32b", 1, (2, 2), ((2, 4_096, 16),)),
)
LM_CARDS_TRAIN = ("qwen2-7b", (2, 4_096), 3)
KERNEL_NAMES = ("segment_min_flat", "segment_min_sorted", "multilinear_dense",
                "segment_min_bucketed", "min_outgoing_flat64", "min_outgoing_und64")
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

    for k in KERNEL_NAMES:
        getattr(ops, k).launches = 0


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
                tally = [e[4]["host_syncs"] for e in obs.trace_events() if e[0] == "solve.flat"]
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
        check(device == "cpu" or syncs["off"] == FLAT_RMAT_SYNCS,
              f"obs: {syncs['off']} host syncs per flat solve with obs off, "
              f"not {FLAT_RMAT_SYNCS}")
        # trace adds the spans' own syncs: msf.round, its three phase spans
        # and the read of msf.counts each round, msf.flat once; the
        # program's tally counts what the untraced solve waits
        check(device == "cpu" or syncs["metrics"] == syncs["off"]
              and syncs["trace"] == syncs["off"] + 5 * reps["off"].iterations + 1,
              f"obs: host syncs per flat solve {syncs} for {reps['off'].iterations} rounds")
        row["host_syncs_tally_flat"] = tally[0]
        check(device == "cpu" or tally == [syncs["off"]],
              f"obs: the traced solve's host_syncs {tally}, count_syncs {syncs['off']}")
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


def report_bytes(n: int, n_f: int) -> int:
    """Bytes a card result's report copies to the host: ``parent`` and
    ``msf_eids[:n_f]`` (int32), the float32 weight and two int32 counts."""
    return 4 * (n + n_f) + 12


def pageable_report(rep):
    """``rep`` as reading each field of ``rep.raw`` into pageable memory
    gives it: ``.cpu().numpy()`` of the whole arrays, the eids trimmed on
    the host."""
    import numpy as np

    r = rep.raw
    n_f = int(r.n_msf_edges.cpu())
    return rep._replace(weight=float(r.weight.cpu()),
                        msf_eids=r.msf_eids.cpu().numpy()[:n_f].astype(np.int32),
                        parent=r.parent.cpu().numpy(), n_msf_edges=n_f,
                        iterations=int(r.iterations.cpu()))


def report_path(g_flat, g_coarsen, device="cuda") -> dict:
    """Phase 6h, the report: on the flat solve of ``g_flat`` and the
    coarsen solve of ``g_coarsen``, the page-locked report equal to the
    pageable read of its result, its arrays page-locked, two host waits,
    the solve.report span's ``pinned`` and ``d2h_bytes``; a flat report
    kept while two graphs of its size are solved (the first of them
    dropped) keeps its values in memory of its own; then
    :func:`pinned_copy_probe`."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.graphs import rmat_graph
    from repro_torch.solve import SolveSpec, plan
    from repro_torch.solve.report import report_from_msf_result

    row = {}
    for label, g, spec in (("flat", g_flat, SolveSpec()),
                           ("coarsen", g_coarsen, SolveSpec(mode="coarsen"))):
        rep = plan(g, spec).solve()
        check(same_report(rep, pageable_report(rep)),
              f"report: {label}: the page-locked report differs from the pageable read")
        check(device == "cpu" or all(torch.from_numpy(a).is_pinned()
                                     for a in (rep.msf_eids, rep.parent)),
              f"report: {label}: the arrays are not page-locked")
        syncs = count_syncs(lambda: report_from_msf_result(rep.mode, rep.raw, levels=rep.levels))
        check(device == "cpu" or syncs == 2, f"report: {label}: {syncs} host syncs, not 2")
        obs.reset()
        traced = plan(g, SolveSpec(mode=spec.mode, obs="trace")).solve()
        (span,) = [e for e in obs.trace_events() if e[0] == "solve.report"]
        want = {"pinned": int(device != "cpu"),
                "d2h_bytes": report_bytes(g.n, traced.n_msf_edges) if device != "cpu" else 0}
        check(span[4] == want, f"report: {label}: solve.report attributes {span[4]}, not {want}")
        obs.reset()
        row[label] = {"report_ms": span[2] / 1e6, **span[4], "host_syncs": syncs}
    kept = plan(g_flat, SolveSpec()).solve()
    want = pageable_report(kept)
    for seed in (RMAT["seed"] + 1, RMAT["seed"] + 2):
        other = plan(rmat_graph(**{**RMAT, "seed": seed}, device=g_flat.device),
                     SolveSpec()).solve()
        check(not any(np.shares_memory(a, b) for a in (kept.msf_eids, kept.parent)
                      for b in (other.msf_eids, other.parent)),
              "report: a later report shares memory with a kept one")
        del other  # its blocks go back to the cache before the next solve
    check(same_report(kept, want), "report: a kept report changed under later solves")
    row["copy_probe"] = pinned_copy_probe() if device != "cpu" else {}
    print(json.dumps({"report_on_the_card": row}), flush=True)
    return row


def pinned_copy_probe(nbytes: int = REPORT_PROBE_BYTES, reps: int = 8) -> dict:
    """The card's device-to-host copy of ``nbytes`` into a reused
    page-locked buffer (a non-blocking copy and a stream wait) and into
    fresh pageable memory (``.cpu()``), GB/s by the host clock; and the
    host time of fresh page-locked allocations of that size (each held, so
    none comes from the cache) beside one the cache hands back."""
    import torch

    src = torch.ones(nbytes // 4, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream()
    buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)

    def pinned():
        buf.copy_(src, non_blocking=True)
        stream.synchronize()

    def pageable():
        return src.cpu()

    rates = {}
    for name, fn in (("pinned", pinned), ("pageable", pageable)):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        rates[f"{name}_gb_per_s"] = [nbytes / t / 1e9 for t in times]
        rates[f"{name}_median_ms"] = statistics.median(times) * 1e3
    check(bool(torch.equal(buf, src.cpu())), "report probe: the page-locked copy differs")
    fresh, held = [], [buf]  # buf held too: no allocation below finds a free block
    for _ in range(4):
        t0 = time.perf_counter()
        held.append(torch.empty(nbytes // 4, dtype=torch.int32, pin_memory=True))
        fresh.append((time.perf_counter() - t0) * 1e3)
    held.pop()
    t0 = time.perf_counter()
    held.append(torch.empty(nbytes // 4, dtype=torch.int32, pin_memory=True))
    cached_ms = (time.perf_counter() - t0) * 1e3
    del held, buf, src
    return {"bytes": nbytes, **rates, "fresh_alloc_ms": fresh, "cached_alloc_ms": cached_ms}


def bench_cell_graph(cell: str):
    """The graph and the ``SolveSpec`` keywords of one cell of
    BENCHMARK.json, made on the card as ``msfbench`` makes them."""
    sys.path.insert(0, str(ROOT))
    from msfbench import harness
    from msfbench.gen import kronecker
    from msfbench.loops.solve import PortSolver

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    w = harness.workload(bench, cell)
    cfg = harness.load_json(ROOT / harness.config_entry(bench, w["config"])["file"])
    spec = harness.load_json(harness.traffic_path(w["traffic"])).get("spec") or {}
    e = kronecker.base_edges(cfg, int(cfg["graph_seed"]), 0, "cuda")
    return PortSolver("cuda", spec).graph(e), spec


def bench_cells_obs(cells=BENCH_CELLS) -> dict:
    """Phase 6h on each benchmark cell's own graph and path: the traced
    solve's ``host_syncs`` tally against the untraced solve's syncs, and
    against the traced solve's less the spans' own (the synced spans'
    explicit syncs, one msf.counts read per AS round); the per-round spans
    of one traced solve; the cost of tracing: solves with obs off and
    trace in turns, no profiler."""
    import gc

    import torch

    from repro_torch import obs
    from repro_torch.solve import SolveSpec, clear_plan_cache, plan

    rows = {}
    for cell, reps in cells.items():
        gc.collect()
        torch.cuda.empty_cache()
        g, kw = bench_cell_graph(cell)
        spec = {m: SolveSpec(**kw, obs=m) for m in ("off", "trace")}
        solve_span = f"solve.{spec['off'].mode}"
        plan(g, spec["off"]).solve()  # warm-up
        off = count_syncs_split(plan(g, spec["off"]).solve)
        obs.reset()
        traced_rep = []
        traced = count_syncs_split(lambda: traced_rep.append(plan(g, spec["trace"]).solve()))
        events = obs.trace_events()
        (solve,) = [e[4] for e in events if e[0] == solve_span]
        rounds = sorted((e for e in events if e[0] == "msf.round"), key=lambda e: e[1])
        # the spans' own: each synced span's explicit sync, each msf.counts read
        check(off[1] == 0 and solve["host_syncs"] == off[0] == traced[0] - len(rounds),
              f"obs: {cell}: host_syncs {solve['host_syncs']}, count_syncs_split off {off}, "
              f"trace {traced}, {len(rounds)} rounds")
        check(off[0] == BENCH_CELL_SYNCS[cell],
              f"obs: {cell}: {off[0]} host syncs per solve, not {BENCH_CELL_SYNCS[cell]}")
        (report,) = [e for e in events if e[0] == "solve.report"]
        want = {"pinned": 1, "d2h_bytes": report_bytes(g.n, traced_rep.pop().n_msf_edges)}
        check(report[4] == want, f"obs: {cell}: solve.report attributes {report[4]}, not {want}")
        table = []
        for rnd in rounds:
            inside = {e[0]: e for e in events
                      if e[0] in obs.PORT_ONLY_SPANS and e[3] == rnd[3]
                      and rnd[1] <= e[1] and e[1] + e[2] <= rnd[1] + rnd[2]}
            counts = inside["msf.counts"][4]
            table.append({"round": rnd[4]["round"], "msf.round_ms": rnd[2] / 1e6,
                          **{f"{k}_ms": inside[k][2] / 1e6 for k in obs.PORT_ONLY_SPANS
                             if k in inside},
                          "outgoing_share": counts["outgoing"] / counts["edges"]})
        obs.reset()
        times = {"off": [], "trace": []}
        for i in range(reps):
            for m in (("off", "trace") if i % 2 == 0 else ("trace", "off")):
                clear_plan_cache()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plan(g, spec[m]).solve()
                times[m].append(time.perf_counter() - t0)
                obs.reset()
        mean = {m: statistics.fmean(v) for m, v in times.items()}
        rows[cell] = {
            "host_syncs_tally": solve["host_syncs"], "host_syncs_by_site": solve["host_syncs_by_site"],
            "count_syncs_off": sum(off), "count_syncs_trace": sum(traced),
            "trace_explicit_syncs": traced[1], "rounds": len(rounds),
            "report_span": report[4], "report_ms": report[2] / 1e6,
            "rounds_table": table, "solve_s": times,
            "trace_cost": mean["trace"] / mean["off"] - 1,
        }
        print(json.dumps({"obs_bench_cell": cell, **rows[cell]}), flush=True)
        del g
    obs.reset()
    return rows


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
    dedupe, none with the host's); a flat round without pack32 launches
    the 64-bit min-outgoing kernel."""
    import torch

    from repro_torch.kernels import ops

    def timer(spec, solve_fn):
        samples = []
        for _ in range(3):
            before = read_counts()
            before64 = ops.min_outgoing_flat64.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = solve_fn()
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
            got = {k: v - before[k] for k, v in read_counts().items()}
            got64 = ops.min_outgoing_flat64.launches - before64
            if mode == "flat":
                want = rep.iterations if spec.pack else 0
                check(got["segment_min_flat"] == want and got64 == rep.iterations - want,
                      f"tune: {got['segment_min_flat']} flat and {got64} min-outgoing "
                      f"launches for {rep.iterations} rounds of {spec}")
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

    from repro_torch.kernels import ops, ref
    from repro_torch.solve import SolveSpec, plan, set_tuning_db
    from repro_torch.solve import tune as T

    db = T.TuningDB()
    rows, launches = {}, {}
    for (label, mode), g in graphs.items():
        reset_counts()
        t0 = time.perf_counter()
        res = T.tune(g, mode, db=db, space="full", timer=counting_timer(mode))
        launches[f"tune {mode} {label}"] = {
            **read_counts(), "min_outgoing_flat64": ops.min_outgoing_flat64.launches,
            "min_outgoing_und64": ops.min_outgoing_und64.launches}
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
for dt in (torch.int32, torch.int64, torch.float32, torch.float64, torch.bfloat16):
    x = torch.full((3,), rank + 1, dtype=dt, device=mesh.device)
    for op, want in (("min", 1), ("max", world), ("sum", world * (world + 1) // 2)):
        if mesh.all_reduce(x, op, axes).tolist() != [want] * 3:
            raise RuntimeError(f"all_reduce {op} of {dt} on {mesh.device} is wrong")
    if mesh.all_gather(x, axes).tolist() != [r + 1 for r in range(world) for _ in range(3)]:
        raise RuntimeError(f"all_gather of {dt} on {mesh.device} is wrong")
out["collectives"] = ("all_gather, all_reduce min/max/sum of "
                      "int32/int64/float32/float64/bfloat16")
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
        flat_row.update(n=n, e_max=part.e_max)
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


# ---------------------------------------------------------------------------
# phase 6k: the GNN and recsys trainer
# ---------------------------------------------------------------------------

def train_args(**kw):
    import types

    d = dict(arch="gat-cora", steps=TRAIN_STEPS, seed=0, ckpt_dir=None, ckpt_every=10,
             fault_at=None, supervise=False)
    d.update(kw)
    return types.SimpleNamespace(**d)


def all_launches() -> dict:
    from repro_torch.kernels import ops

    return {k: getattr(ops, k).launches for k in KERNEL_NAMES}


def on_card(tree) -> bool:
    """Every tensor of a params dict or an AdamWState on the card."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return all(on_card(v) for v in tree.values())
    return all(on_card(v) for v in tree)


def train_smoke(workdir: Path, device="cuda") -> dict:
    """Phase 6k (a): ``launch.train.run`` on the card for every GNN and
    recsys arch at its smoke config, a fault and resume, and the first
    step's loss on the card against the CPU's on the same weights."""
    import torch

    from repro_torch.launch import train

    rows = {}
    for arch in TRAIN_ARCHS:
        t0 = time.perf_counter()
        out = train.run(train_args(arch=arch, steps=TRAIN_STEPS_OF.get(arch, TRAIN_STEPS),
                                   device=device))
        torch.cuda.synchronize()
        check(out["last_loss"] < out["first_loss"],
              f"train {arch}: loss {out['first_loss']} -> {out['last_loss']} did not fall")
        rows[arch] = {**out, "seconds": time.perf_counter() - t0}
    args = train_args(ckpt_dir=str(workdir / "gat-cora"), ckpt_every=5, fault_at=TRAIN_FAULT_AT,
                      device=device)
    try:
        train.run(args)
        fail("train gat-cora: the injected fault did not fire")
    except train.FaultInjected:
        pass
    resumed = train.run(args)
    diff = abs(resumed["last_loss"] - rows["gat-cora"]["last_loss"])
    check(diff <= TRAIN_RESUME_REL * abs(rows["gat-cora"]["last_loss"]),
          f"train gat-cora: resumed last loss {resumed['last_loss']} against "
          f"{rows['gat-cora']['last_loss']} uninterrupted")
    rows[f"gat-cora resumed after a fault at step {TRAIN_FAULT_AT}"] = {**resumed,
                                                                      "abs_diff": diff}
    first_step = {}
    for arch in TRAIN_ARCHS:
        cpu_p, cpu_o, cpu_step = train.build_training(arch, device="cpu")
        p, o, step = train.build_training(arch, device=device)
        with torch.no_grad():
            for k in p:
                p[k].copy_(cpu_p[k])
        _, o, m = step(p, o, 0)
        check(on_card(p) and on_card(o), f"train {arch}: state off the card")
        want = float(cpu_step(cpu_p, cpu_o, 0)[2]["loss"])
        rel = abs(float(m["loss"]) - want) / abs(want)
        check(rel <= TRAIN_CARD_CPU_REL,
              f"train {arch}: first-step loss {float(m['loss'])} on the card, {want} on the CPU")
        first_step[arch] = {"card": float(m["loss"]), "cpu": want, "rel_diff": rel}
    rows["first step, card vs CPU"] = first_step
    return rows


def plant_on_draw(sub, d_feat: int, n_out: int, classify: bool, seed: int, device) -> dict:
    """A batch on the card from one sampler draw: features on the valid
    nodes and targets from own plus mean-neighbour features through a
    seeded projection, as ``make_planted_graph_task`` plants them; the loss
    is taken on the seed nodes."""
    import torch

    from repro_torch.models.gnn import segment_sum

    gen = torch.Generator(device=device).manual_seed(seed)
    put = partial(torch.as_tensor, device=device)
    src, dst, ev = put(sub.src), put(sub.dst), put(sub.edge_valid)
    n = len(sub.node_ids)
    x = torch.randn((n, d_feat), generator=gen, device=device) * put(sub.node_valid)[:, None]
    w_true = torch.randn((d_feat, n_out), generator=gen, device=device)
    agg = segment_sum(x[src] * ev[:, None], dst, n)
    deg = torch.clamp(segment_sum(ev.float(), dst, n), min=1)[:, None]
    planted = (x + agg / deg) @ w_true
    mask = torch.zeros(n, device=device)
    mask[:sub.n_seeds] = 1
    batch = dict(src=src, dst=dst, edge_valid=ev, x=x, node_mask=mask)
    if classify:
        batch["labels"] = planted.argmax(-1).to(torch.int32)
    else:
        batch["targets"] = planted
    return batch


def memory_mark() -> int:
    """Bytes allocated now; the allocator's peak restarts from here."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def free_card() -> None:
    """Drop unreachable tensors and hand the allocator's cache back."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def time_training(label: str, shape: str, params, opt, step_fn, smi: str, resident: int) -> dict:
    """Median step ms over ``FULL_TIMED`` steps after ``FULL_WARMUP``, the
    allocator's peak since ``resident`` was marked (before the model was
    built), the first and last loss (finite), printed as one line."""
    import math

    import torch

    losses, times = [], []
    for i in range(FULL_WARMUP + FULL_TIMED):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    check(on_card(params) and on_card(opt), f"train {label}: state off the card")
    check(all(math.isfinite(v) for v in losses), f"train {label}: losses {losses}")
    row = {"arch": label, "shape": shape,
           "step_ms_median": statistics.median(times[FULL_WARMUP:]) * 1e3,
           "step_ms": [t * 1e3 for t in times],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "resident_before": resident,
           "own_peak_bytes": torch.cuda.max_memory_allocated() - resident,
           "first_loss": losses[0], "last_loss": losses[-1]}
    print(json.dumps({"train_full_width": row, "card": smi}), flush=True)
    return row


def padding_cost(sub, width: int, device) -> dict:
    """Device ms of one ``segment_sum`` of the draw's [E_pad, width] rows by
    destination (the forward of every aggregation, the gradient of every
    gather): as padded, where every padded edge lands on node 0, and over
    the valid edges alone."""
    import torch

    from repro_torch.models.gnn import segment_sum

    dst = torch.as_tensor(sub.dst, device=device)
    ev = torch.as_tensor(sub.edge_valid, device=device)
    rows = torch.ones((len(dst), width), device=device)
    n = len(sub.node_ids)
    return {"padded_ms": time_ms(lambda: segment_sum(rows, dst, n)),
            "valid_only_ms": time_ms(lambda: segment_sum(rows[ev], dst[ev], n)),
            "padded_edges": int((~ev).sum()), "width": width}


def train_full(g_rmat, smi: str, device="cuda") -> list:
    """Phase 6k (b): each GNN at its published CONFIG on the registry's
    shape cell, xDeepFM at 120M rows through ``build_training(full=True)``,
    then its serve and retrieval steps."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import MoleculeBatchSource, make_planted_graph_task
    from repro_torch.graphs import to_csr
    from repro_torch.graphs.sampler import NeighborSampler, max_sample_sizes
    from repro_torch.launch import train
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as R
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import steps as S

    def cfg_at(arch, shape):
        cell = registry.get_shape(arch, shape)
        return dataclasses.replace(registry.get_config(arch), d_in=cell.d_feat), cell

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def gnn_run(arch, shape, init, batch, n_graphs=1):
        cfg = cfg_at(arch, shape)[0]
        resident = memory_mark()
        gen = torch.Generator(device=device).manual_seed(0)
        params = init(cfg, gen, device).params
        batches = batch if isinstance(batch, list) else None

        def step_fn(p, o, i):
            b = batches[i] if batches else batch
            return S.gnn_train_step(p, o, b, cfg, n_graphs)

        return time_training(arch, shape, params, adamw_init(params), step_fn, smi, resident)

    rows = []
    cfg, cell = cfg_at("gat-cora", "full_graph_sm")
    task = make_planted_graph_task(cell.n_nodes, 2 * cell.n_edges, cell.d_feat, cfg.n_classes, 0)
    batch = {k: torch.as_tensor(v, device=device) for k, v in task.items()}
    batch["node_mask"] = torch.ones(cell.n_nodes, device=device)
    rows.append(gnn_run("gat-cora", "full_graph_sm", G.init_gat, batch))
    del task, batch
    free()

    cell = registry.get_shape("gatedgcn", "minibatch_lg")
    t0 = time.perf_counter()
    indptr, indices, _, _ = to_csr(g_rmat)
    deg = np.diff(indptr)
    seeds = np.random.default_rng(0).choice(np.flatnonzero(deg), cell.batch_nodes, replace=False)
    sub = NeighborSampler(indptr, indices, seed=0).sample(seeds, cell.fanout)
    check((len(sub.node_ids), len(sub.src)) == max_sample_sizes(cell.batch_nodes, cell.fanout)
          == MINIBATCH_PAD, f"train: sampler padding {len(sub.node_ids)}, {len(sub.src)}")
    print(f"  minibatch_lg draw: {int(sub.node_valid.sum())} nodes, {int(sub.edge_valid.sum())} "
          f"edges of {MINIBATCH_PAD} ({time.perf_counter() - t0:.1f} s, host)", flush=True)
    n_e = len(sub.src)
    pad = padding_cost(sub, registry.get_config("gatedgcn").d_hidden, device)
    print(json.dumps({"minibatch_lg_segment_sum": pad, "card": smi}), flush=True)
    batch = plant_on_draw(sub, cell.d_feat, registry.get_config("gatedgcn").n_classes, True, 1,
                          device)
    batch["e_feat"] = torch.ones((n_e, 1), device=device)
    rows.append(gnn_run("gatedgcn", "minibatch_lg", G.init_gatedgcn, batch))
    del batch
    free()
    batch = plant_on_draw(sub, cell.d_feat, registry.get_config("meshgraphnet").d_out, False, 2,
                          device)
    batch["e_feat"] = torch.randn((n_e, 4), device=device,
                                  generator=torch.Generator(device=device).manual_seed(3))
    rows.append(gnn_run("meshgraphnet", "minibatch_lg", G.init_meshgraphnet, batch))
    del batch, sub
    free()

    cell = registry.get_shape("nequip", "molecule")
    src = MoleculeBatchSource(cell.n_nodes, cell.n_edges, cell.batch_graphs, seed=0)
    batches = [{k: torch.as_tensor(v, device=device) for k, v in src.batch_at(i).items()}
               for i in range(FULL_WARMUP + FULL_TIMED)]  # built before the timed steps
    rows.append(gnn_run("nequip", "molecule", G.init_nequip, batches, cell.batch_graphs))
    del batches
    free()

    resident = memory_mark()
    params, opt, step_fn = train.build_training("xdeepfm", full=True, device=device)
    rows.append(time_training("xdeepfm", "train (batch 256, the reference's full path)", params,
                              opt, step_fn, smi, resident))
    del params, opt, step_fn
    free()

    cfg = registry.get_config("xdeepfm")
    offs, sizes = R.field_offsets(cfg)
    gen = torch.Generator(device=device).manual_seed(4)
    rng = np.random.default_rng(4)

    def ids_of(b):
        vals = (rng.pareto(1.2, size=(b, cfg.n_sparse)) * 3).astype(np.int64) % sizes
        return torch.as_tensor((offs[None, :] + vals).astype(np.int32), device=device)

    for shape, init, call, check_out in (
            ("serve_p99", lambda c: R.init_xdeepfm(c, gen, device),
             lambda p, ids, c: S.recsys_serve_step(p, ids, c), serve_ok),
            ("retrieval_cand", lambda c: R.init_retrieval(
                c, registry.get_shape("xdeepfm", "retrieval_cand").n_candidates, gen, device),
             lambda p, ids, c: S.recsys_retrieval_step(p, ids, c, k=RETRIEVAL_K), retrieval_ok)):
        cell = registry.get_shape("xdeepfm", shape)
        resident = memory_mark()
        model = init(cfg)
        ids = ids_of(cell.batch)
        times = []
        for _ in range(SERVE_REPS):
            t0 = time.perf_counter()
            out = call(model.params, ids, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        check_out(model.params, ids, cfg, out)
        row = {"arch": "xdeepfm", "shape": shape, "batch": cell.batch,
               "step_ms_median": statistics.median(times[2:]) * 1e3,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "resident_before": resident,
               "own_peak_bytes": torch.cuda.max_memory_allocated() - resident}
        print(json.dumps({"train_full_width": row, "card": smi}), flush=True)
        rows.append(row)
        del model, out
        free()
    return rows


def serve_ok(params, ids, cfg, probs):
    import torch

    from repro_torch.models import recsys as R

    check(probs.shape == (ids.shape[0],) and bool(torch.isfinite(probs).all()),
          "serve_p99: probabilities not finite")
    with torch.no_grad():
        want = torch.sigmoid(R.xdeepfm_logits(params, ids, cfg))
    check(torch.allclose(probs, want, rtol=1e-6, atol=0),
          "serve_p99: probabilities differ from sigmoid(logits)")


def retrieval_ok(params, ids, cfg, out):
    """The top k against a full sort of the same scores on the card."""
    import torch

    from repro_torch.models import recsys as R

    scores, idx = out
    with torch.no_grad():
        emb = R.embedding_bag(params["table"], ids).reshape(ids.shape[0], -1)
        full = (emb @ params["tower_w"]) @ params["items"].T
    want = torch.sort(full, dim=-1, descending=True).values[:, :RETRIEVAL_K]
    check(bool(torch.isfinite(scores).all()) and torch.allclose(scores, want, rtol=1e-6, atol=0),
          "retrieval_cand: the top k differ from a full sort")
    check(torch.allclose(torch.gather(full, 1, idx), scores, rtol=1e-6, atol=0),
          "retrieval_cand: indices off their scores")


def train_path(g_rmat, smi: str, device="cuda") -> dict:
    """Phase 6k: (a) and (b); returns the kernel launches of the whole
    phase (the trainer runs none of the five kernels)."""
    import tempfile

    from repro_torch.kernels import build

    reset_counts()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        smoke = train_smoke(Path(tmp), device)
    print(json.dumps({"train_smoke": smoke, "card": smi}), flush=True)
    train_full(g_rmat, smi, device)
    launches = all_launches()
    check(not any(launches.values()), f"train: kernel launches {launches}, expected none")
    return launches


# ---------------------------------------------------------------------------
# phase 6l: the LM family (run in a fresh process, see lm_child)
# ---------------------------------------------------------------------------

def smi_line() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def copy_tree(dst, src) -> None:
    """Copy a parameter tree into another of the same structure, in place."""
    import torch

    from repro_torch.optim.adamw import tree_leaves

    with torch.no_grad():
        for d, s in zip(tree_leaves(dst), tree_leaves(src), strict=True):
            d.copy_(s)


def lm_smoke(workdir: Path, device="cuda") -> dict:
    """Phase 6l (a): ``launch.train.run`` on the card for every LM arch at
    its smoke config, mixtral crashed and resumed under ``--supervise``,
    the first step's loss on the card against the CPU's from the same
    weights, and the prefill/decode check of tests/test_models_lm.py."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    rows = {}
    for arch in LM_ARCHS:
        t0 = time.perf_counter()
        out = train.run(train_args(arch=arch, steps=LM_STEPS, device=device))
        torch.cuda.synchronize()
        check(out["last_loss"] < out["first_loss"],
              f"lm train {arch}: loss {out['first_loss']} -> {out['last_loss']} did not fall")
        rows[arch] = {**out, "seconds": time.perf_counter() - t0}
    arch, fault_at = LM_FAULT
    resumed = train.main(["--arch", arch, "--steps", str(LM_STEPS), "--ckpt-dir",
                          str(workdir / arch), "--ckpt-every", "5", "--fault-at", str(fault_at),
                          "--supervise", "--device", device])
    check(resumed["steps"] < LM_STEPS, f"lm train {arch}: the supervisor did not resume")
    diff = abs(resumed["last_loss"] - rows[arch]["last_loss"])
    check(diff <= LM_RESUME_REL * abs(rows[arch]["last_loss"]),
          f"lm train {arch}: resumed last loss {resumed['last_loss']} against "
          f"{rows[arch]['last_loss']} uninterrupted")
    rows[f"{arch} under --supervise, faulted at step {fault_at}"] = {**resumed, "abs_diff": diff}
    first_step, parity = {}, {}
    for arch in LM_ARCHS:
        cpu_p, cpu_o, cpu_step = train.build_training(arch, device="cpu")
        p, o, step = train.build_training(arch, device=device)
        copy_tree(p, cpu_p)
        _, o, m = step(p, o, 0)
        check(on_card(p) and on_card(o), f"lm train {arch}: state off the card")
        want = float(cpu_step(cpu_p, cpu_o, 0)[2]["loss"])
        rel = abs(float(m["loss"]) - want) / abs(want)
        check(rel <= LM_CARD_CPU_REL,
              f"lm train {arch}: first-step loss {float(m['loss'])} on the card, {want} on the CPU")
        first_step[arch] = {"card": float(m["loss"]), "cpu": want, "rel_diff": rel}
        cfg = registry.get_config(arch, smoke=True)
        gen = torch.Generator(device=device).manual_seed(0)
        params = T.init_lm(cfg, gen, device).params
        toks = torch.randint(0, cfg.vocab, (2, 32), device=device, generator=gen)
        full, _ = T.lm_prefill(params, toks, cfg)
        _, cache = T.lm_prefill(params, toks[:, :-1], cfg)
        want_t = min(cfg.sliding_window or 32, 32)
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, want_t - v.shape[2]))
                 for k, v in cache.items()}
        dec, _ = T.lm_decode_step(params, toks[:, -1], cache, 31, cfg)
        err = float((full - dec).abs().max())
        check(err < LM_PARITY, f"lm {arch}: prefill vs decode max abs error {err}")
        parity[arch] = err
    rows["first step, card vs CPU"] = first_step
    rows["prefill vs decode, max abs error"] = parity
    return rows


def lm_weight_bytes(params, active_experts=None) -> int:
    """Bytes of the float32 weights one decode step must read: every
    parameter but the embedding table, of which it gathers one row per
    token (MoE: the routed experts' only, with ``active_experts``)."""
    from repro_torch.optim.adamw import tree_leaves

    total = 0
    for k, v in params["layers"].items():
        n = v.numel()
        if active_experts is not None and k in ("ewi", "ewg", "ewo"):
            n = n // v.shape[1] * active_experts
        total += n * v.element_size()
    return total + sum(t.numel() * t.element_size()
                       for t in tree_leaves({k: v for k, v in params.items()
                                             if k not in ("layers", "embed")}))


def profile_call(fn, top: int = 10) -> dict:
    """One call of ``fn`` under torch.profiler: device time by kernel, and
    the device's busy share of one unprofiled call's wall time."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = device_rows(fn)
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    return {"wall_ms": wall * 1e3, "device_ms": busy, "busy_share": busy / (wall * 1e3),
            "top": [{"op": e.key[:70], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
                    for e in rows[:top]]}


def sdpa_yardstick(params, toks, cfg) -> dict:
    """The blockwise flash_attention (as lm_prefill calls it) on layer 0's
    q/k/v of the prompt, beside F.scaled_dot_product_attention(is_causal)
    on the same inputs with the GQA heads expanded: device times (CUDA
    events around back-to-back calls), the library's achieved rate, and
    the largest difference of their outputs. For the record: the port
    does not call the library."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import transformer as T
    from repro_torch.models.layers import flash_attention, rms_norm

    with torch.no_grad():
        lp = {k: v[0] for k, v in params["layers"].items()}
        sh = T._shard_of(cfg, None)
        x = T._embed(params["embed"], toks, T.dtype_of(cfg.dtype), sh, cfg.vocab)
        q, k, v = T._qkv(rms_norm(x, lp["ln1"], cfg.norm_eps), lp, cfg,
                         torch.arange(toks.shape[1], device=toks.device), sh)
        del x

        def port():
            return flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                                   q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)

        b, s, kvh, g, hd = q.shape
        qh = q.reshape(b, s, kvh * g, hd).transpose(1, 2)
        kh = k.repeat_interleave(g, dim=2).transpose(1, 2)
        vh = v.repeat_interleave(g, dim=2).transpose(1, 2)

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

        err = float((port().reshape(b, s, -1).float()
                     - library().transpose(1, 2).reshape(b, s, -1).float()).abs().max())
        flops = 2 * b * kvh * g * s * s * hd  # QK^T and PV over the causal half
        port_ms, library_ms = time_ms(port, reps=2, warmup=1), time_ms(library, reps=5, warmup=2)
        return {"seq_len": s, "heads": kvh * g, "kv_heads": kvh, "head_dim": hd,
                "flash_attention_ms": port_ms, "sdpa_ms": library_ms,
                "sdpa_tflops": flops / library_ms / 1e9, "causal_flops": flops,
                "max_abs_diff": err}


def no_drop(cfg):
    """``cfg`` with an MoE capacity that drops no token (every expert may
    take every token). A decode, one token at a time, never exceeds an
    expert's capacity; a prefill of many tokens may drop some from an
    expert (the reference's capacity rule), which changes their hidden
    states and so the cache, so an MoE end check runs under this config."""
    import dataclasses

    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def end_check(params, cfg, toks, tokens, mesh=None):
    """``launch.serve.generate``, then the last generated token decoded on
    its cache against a prefill of the whole sequence: a dict of
    generate's prefill and decode seconds, the decode's logits, the
    prefill's and its seconds, the whole sequence, and the last decode as
    a function for the profiler (on ``mesh``: every rank alike)."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    out, cache, prefill_s, decode_s = serve.generate(params, toks, cfg, tokens, mesh)
    pos = toks.shape[1] + tokens - 1

    def last_decode():
        return T.lm_decode_step(params, out[:, -1], cache, pos, cfg, mesh)[0]

    dec = last_decode()
    seq = torch.cat([toks, out], dim=1)
    t0 = time.perf_counter()
    full, _ = T.lm_prefill(params, seq, cfg, mesh)
    torch.cuda.synchronize()
    return {"prefill_s": prefill_s, "decode_s": decode_s, "dec": dec, "full": full,
            "full_s": time.perf_counter() - t0, "seq": seq, "last_decode": last_decode}


def lm_profile(params, toks, cfg, last_decode) -> dict:
    """Phase 6l (d): one decode step and one layer's prefill of ``toks``
    under torch.profiler, and the SDPA yardstick."""
    from repro_torch.models import transformer as T

    one = {**params, "layers": {k: v[:1] for k, v in params["layers"].items()}}
    return {"decode_step": profile_call(last_decode),
            "prefill_one_layer": profile_call(lambda: T.lm_prefill(one, toks, cfg)),
            "sdpa_yardstick": sdpa_yardstick(params, toks, cfg)}


def lm_serve(smi: str, device="cuda") -> list:
    """Phase 6l (b) and (d): ``launch.serve.generate`` at full width, each
    run checked at its end. First, per model, the end check in float32 at
    ``LM_CHECK`` (a prompt past the 2,048-token chunks and the 4,096
    window): decode and prefill agree to float32 rounding; the bfloat16
    prefill's distance from that float32 prefill is the model's bfloat16
    noise. Each bfloat16 run's end error is then held to twice that noise
    (the decode and the prefill may each sit that far from float32), and
    at least to ``LM_PARITY``. qwen2-7b's 32k run also profiles one
    prefill layer and its last decode step, and times the SDPA
    yardstick."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.models import transformer as T

    rows = []
    for arch, layers, requests in LM_SERVE:
        cfg = registry.get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        resident = memory_mark()
        gen = torch.Generator(device=device).manual_seed(0)
        params = T.init_lm(cfg, gen, device).params
        weights = lm_weight_bytes(params)
        batch, prompt, tokens = LM_CHECK
        toks = torch.randint(0, cfg.vocab, (batch, prompt), device=device, generator=gen)
        f32 = dataclasses.replace(no_drop(cfg), dtype="float32")
        ref = end_check(params, f32, toks, tokens)
        err32 = float((ref["full"] - ref["dec"]).abs().max())
        scale32 = float(ref["full"].abs().max())
        check(err32 <= LM_F32_REL * max(1.0, scale32),
              f"lm serve {arch}: float32 decode vs prefill max abs error {err32} "
              f"(logits up to {scale32})")
        noise = float((T.lm_prefill(params, ref["seq"], no_drop(cfg))[0] - ref["full"])
                      .abs().max())
        del ref
        calib = {"arch": arch, "layers": cfg.n_layers, "check": LM_CHECK,
                 "float32_end_max_abs_err": err32, "float32_logit_scale": scale32,
                 "bfloat16_prefill_vs_float32_max_abs": noise}
        print(json.dumps({"lm_serve_float32_check": calib, "card": smi}), flush=True)
        for batch, prompt, tokens in requests:
            toks = torch.randint(0, cfg.vocab, (batch, prompt), device=device, generator=gen)
            memory_mark()
            run = end_check(params, cfg, toks, tokens)
            peak = torch.cuda.max_memory_allocated()
            prof = (lm_profile(params, toks, cfg, run["last_decode"])
                    if arch == "qwen2-7b" and prompt == max(r[1] for r in requests) else {})
            # an MoE prefill of many tokens drops some from full experts: check without drops
            checked = run if cfg.moe is None else end_check(params, no_drop(cfg), toks, tokens)
            dec, full = checked["dec"], checked["full"]
            err, scale = float((full - dec).abs().max()), float(full.abs().max())
            tol = max(LM_PARITY * max(1.0, scale), 2 * noise)
            check(bool(torch.isfinite(dec).all()) and err <= tol,
                  f"lm serve {arch} {batch}x{prompt}: decode vs prefill max abs error {err} "
                  f"over {tol} (logits up to {scale})")
            t_att = T.cache_shape(cfg, batch, prompt + tokens)["k"].shape[2]
            kv_bytes = 2 * cfg.n_layers * batch * t_att * cfg.n_kv_heads * cfg.hd * 2
            row = {"arch": arch, "layers": cfg.n_layers, "batch": batch, "prompt": prompt,
                   "tokens": tokens, "prefill_s": run["prefill_s"],
                   "decode_ms_per_token": run["decode_s"] / (tokens - 1) * 1e3,
                   "decode_bound_ms": (weights + kv_bytes) / HBM_BYTES_PER_S * 1e3,
                   "weights_read_bytes": weights, "kv_read_bytes": kv_bytes,
                   "tokens_per_s": (tokens - 1) * batch / run["decode_s"],
                   "max_memory_allocated": peak, "resident_before": resident,
                   "end_check_prefill_s": checked["full_s"], "end_max_abs_err": err,
                   "end_tolerance": tol, "end_logit_scale": scale}
            if cfg.moe is not None:
                row["decode_bound_ms_routed_experts"] = (
                    lm_weight_bytes(params, cfg.moe.top_k * batch) + kv_bytes
                ) / HBM_BYTES_PER_S * 1e3
            print(json.dumps({"lm_serve_full_width": row, "card": smi}), flush=True)
            if prof:
                print(json.dumps({"lm_profile_qwen2_7b_32k": prof, "card": smi}), flush=True)
            rows.append(row)
            del run, checked, dec, full
        del params, toks
        free_card()
    return rows


def lm_train_full(smi: str, device="cuda") -> list:
    """Phase 6l (c): ``lm_train_step`` at full width with depth cut, on the
    train_4k cell's sequence length."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import LMBatchSource
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import steps as S

    seq = registry.get_shape("qwen2-7b", "train_4k").seq_len
    rows = []
    for arch, layers, batch in LM_TRAIN:
        cfg = dataclasses.replace(registry.get_config(arch), n_layers=layers)
        src = LMBatchSource(cfg.vocab, seq_len=seq, batch=batch, seed=0)
        batches = [tuple(torch.as_tensor(a, device=device) for a in src.batch_at(i))
                   for i in range(FULL_WARMUP + FULL_TIMED)]
        resident = memory_mark()
        params = T.init_lm(cfg, torch.Generator(device=device).manual_seed(0), device).params

        def step_fn(p, o, i):
            return S.lm_train_step(p, o, *batches[i], cfg)

        rows.append(time_training(f"{arch} ({layers} of {registry.get_config(arch).n_layers} "
                                  f"layers, batch {batch})", f"train_4k (seq {seq})", params,
                                  adamw_init(params), step_fn, smi, resident))
        del params, batches
        free_card()
    return rows


def lm_path(smi: str, device="cuda") -> dict:
    """Phase 6l: (a)-(d); returns the kernel launches of the whole phase
    (the LM path runs none of the five kernels)."""
    import tempfile

    from repro_torch.kernels import build

    reset_counts()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        smoke = lm_smoke(Path(tmp), device)
    print(json.dumps({"lm_smoke": smoke, "card": smi}), flush=True)
    lm_serve(smi, device)
    lm_train_full(smi, device)
    launches = all_launches()
    check(not any(launches.values()), f"lm: kernel launches {launches}, expected none")
    return launches


def lm_child(out_path: str) -> None:
    """Phase 6l's process: a fresh CUDA context and profiler, after the
    earlier phases' sessions (after a coarsen sweep torch.profiler drops
    device events) and memory. Writes the phase's launches to ``out_path``."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = smi_line()
    t0 = time.perf_counter()
    launches = lm_path(smi)
    Path(out_path).write_text(json.dumps(launches))
    print(f"  phase 6l took {time.perf_counter() - t0:.1f} s in its process", flush=True)


LM_CHILD = "import sys, chip_smoke; chip_smoke.lm_child(sys.argv[1])"


def run_lm_phase() -> dict:
    """Phase 6l in its own process (``lm_child``); its launches."""
    return run_child(LM_CHILD, "6l", LM_CHILD_TIMEOUT_S)



# ---------------------------------------------------------------------------
# phase 6m: the mesh-sharded LM (four gloo ranks on the one card, in fresh
# processes); lm_dist_cards: one NCCL rank per card on a four-card host
# ---------------------------------------------------------------------------

LM_MESH_RANK = r"""
import os, sys
from datetime import timedelta
from pathlib import Path
import torch
import torch.distributed as dist

sys.path.insert(0, os.environ["ROOT"])
import chip_smoke as C
from repro_torch.launch.mesh import make_mesh

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group(os.environ["BACKEND"], store=dist.FileStore(os.environ["STORE"], world),
                        rank=rank, world_size=world, timeout=timedelta(seconds=600))
device = os.environ.get("DEVICE") or None
meshes = {shape: make_mesh(shape, ("data", "model"), device=device)
          for shape in ((1, 4), (2, 2))}
C.reset_counts()
out = getattr(C, os.environ["WORK"])(meshes, device=meshes[(1, 4)].device)
out.update(rank=rank, device=str(meshes[(1, 4)].device), backend=meshes[(1, 4)].backend,
           launches=C.all_launches())
torch.save(out, Path(os.environ["OUT_DIR"]) / f"rank{rank}.pt")
dist.barrier()
os._exit(0)  # leave without tearing the process groups down under the other ranks
"""


def mesh_ranks(work: str, workdir: Path, backend: str = "gloo", device=None) -> list:
    """Run ``chip_smoke.<work>(meshes, device=...)`` on four ranks over
    ``backend`` (rank r on ``cuda:{r % device_count}``: gloo shares one
    card, NCCL needs a card per rank; ``device="cpu"`` rehearses), each
    with a 1x4 and a 2x2 mesh; every rank's result. Fails if a rank fails
    or outlives ``LM_MESH_TIMEOUT_S``; kills every rank either way."""
    import os

    import torch

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), ROOT=str(ROOT), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="2", WORLD_SIZE=str(LM_MESH_WORLD),
               STORE=str(workdir / "store"), OUT_DIR=str(workdir), BACKEND=backend, WORK=work,
               DEVICE=device or "")
    procs = []
    try:
        for r in range(LM_MESH_WORLD):
            log = open(workdir / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", LM_MESH_RANK], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT, env=dict(env, RANK=str(r))), log))
        deadline = time.monotonic() + LM_MESH_TIMEOUT_S
        while time.monotonic() < deadline:  # until all succeed or one fails
            codes = [p.poll() for p, _ in procs]
            if all(c == 0 for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.5)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    print((workdir / "rank0.log").read_text()[-20000:], flush=True)
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            print((workdir / f"rank{r}.log").read_text()[-4000:], file=sys.stderr)
        fail(f"lm mesh ({work}): ranks {bad} failed or outlived {LM_MESH_TIMEOUT_S} s")
    return [torch.load(workdir / f"rank{r}.pt") for r in range(LM_MESH_WORLD)]


def collective_share(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its wall ms, the host time of
    the collectives it made (the backend's ``gloo:``/``nccl:`` ops; gloo's
    include the copies of CUDA tensors through host memory), their share of
    the wall time, and the top host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    coll = [e for e in rows if e.key.startswith(("gloo:", "nccl:"))]
    coll_ms = sum(e.cpu_time_total for e in coll) / 1e3
    by_op = {}  # an op may have a host row and a device row
    for e in coll:
        row = by_op.setdefault(e.key, {"calls": 0, "host_ms": 0.0})
        row["calls"] = max(row["calls"], e.count)
        row["host_ms"] += e.cpu_time_total / 1e3
    top = sorted(rows, key=lambda e: e.cpu_time_total, reverse=True)[:12]
    return {"wall_ms": wall, "collectives_host_ms": coll_ms, "collectives_share": coll_ms / wall,
            "collectives": by_op,
            "top_host_ops": [{"op": e.key[:60], "calls": e.count,
                              "host_ms": e.cpu_time_total / 1e3} for e in top]}


def lm_mesh_work(meshes, device="cuda") -> dict:
    """Phase 6m's runs, on one rank (``meshes`` None: the whole model on the
    card, no mesh) or on a rank of the four (``meshes`` by shape), with the
    same weights (``init_lm`` from seed 0) and tokens: (a) qwen2-7b whole
    on 1x4: a float32 default request (logits and greedy tokens compared),
    the float32 end check at ``LM_CHECK``, and a timed bfloat16 default
    request; (b) mixtral-8x7b at 2 of 32 layers on 2x2 under ``no_drop``:
    a float32 prompt of 2 x 8,192 past the window, then decodes (compared),
    and the same in bfloat16, timed; (c) qwen2-7b at 2 layers on 2x2: one
    float32 ``lm_train_step`` from the same state (loss and gnorm compared),
    then a second, timed. Results as CPU tensors and numbers."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import LMBatchSource
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import steps as S

    def mesh_of(shape):
        return None if meshes is None else meshes[shape]

    def toks_of(cfg, shape, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randint(0, cfg.vocab, shape, device=device, generator=gen)

    def weights(cfg, mesh):
        gen = torch.Generator(device=device).manual_seed(0)
        return T.init_lm(cfg, gen, device, mesh=mesh).params

    out = {}
    t_part = time.perf_counter()
    # (a) qwen2-7b whole, 1x4
    mesh = mesh_of((1, 4))
    cfg = registry.get_config("qwen2-7b")
    f32 = dataclasses.replace(cfg, dtype="float32")
    resident = memory_mark()
    params = weights(cfg, mesh)
    b, p, n = LM_MESH_REQUEST
    toks = toks_of(cfg, (b, p), 1)
    first, _ = T.lm_prefill(params, toks, f32, mesh)
    gen32, _, _, _ = serve.generate(params, toks, f32, n, mesh)
    ends = end_check(params, f32, toks_of(cfg, LM_CHECK[:2], 2), LM_CHECK[2], mesh)
    serve.generate(params, toks, cfg, 2, mesh)  # warm the bfloat16 path
    memory_mark()
    gen16, _, prefill_s, decode_s = serve.generate(params, toks, cfg, n, mesh)
    last = serve.generate(params, toks, cfg, 2, mesh)

    def decode():
        return T.lm_decode_step(params, last[0][:, -1], last[1], p + 1, cfg, mesh)

    decode_coll = None
    if mesh is None:
        prof = collective_share(decode)
    else:  # the bytes phase 6n (c) holds the dry run's decode cell against
        with mesh.count_collectives() as counted:
            prof = collective_share(decode)
        decode_coll = {",".join(k): v for k, v in counted.items()}
    out["a"] = {"first_logits": first.cpu(), "tokens_f32": gen32.cpu(),
                "check_dec": ends["dec"].cpu(), "check_full": ends["full"].cpu(),
                "check_tokens": ends["seq"].cpu(), "tokens_bf16": gen16.cpu(),
                "prefill_s": prefill_s, "decode_ms_per_token": decode_s / (n - 1) * 1e3,
                "weights_read_bytes": lm_weight_bytes(params),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "resident_before": resident, "decode_profile": prof,
                "decode_collectives": decode_coll, "seconds": time.perf_counter() - t_part}
    del params, first, ends, last
    free_card()
    t_part = time.perf_counter()
    # (b) mixtral-8x7b, 2 of 32 layers, 2x2, no drops
    mesh = mesh_of((2, 2))
    arch, layers, (b, p, n) = LM_MESH_MOE
    cfg = no_drop(dataclasses.replace(registry.get_config(arch), n_layers=layers))
    f32 = dataclasses.replace(cfg, dtype="float32")
    params = weights(cfg, mesh)
    toks = toks_of(cfg, (b, p), 3)
    logits32, _ = T.lm_prefill(params, toks, f32, mesh)
    gen32, _, _, _ = serve.generate(params, toks, f32, n, mesh)
    memory_mark()
    gen16, _, prefill_s, decode_s = serve.generate(params, toks, cfg, n, mesh)
    out["b"] = {"prefill_logits": logits32.cpu(), "tokens_f32": gen32.cpu(),
                "tokens_bf16": gen16.cpu(), "prefill_s": prefill_s,
                "decode_ms_per_token": decode_s / (n - 1) * 1e3,
                "weights_read_bytes": lm_weight_bytes(params),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "seconds": time.perf_counter() - t_part}
    del params, logits32
    free_card()
    t_part = time.perf_counter()
    # (c) qwen2-7b, 2 layers, 2x2: float32 train steps
    mesh = mesh_of((2, 2))
    arch, layers, (b, seq) = LM_MESH_TRAIN
    cfg = dataclasses.replace(registry.get_config(arch), n_layers=layers, dtype="float32")
    src = LMBatchSource(cfg.vocab, seq_len=seq, batch=b, seed=0)
    batch = [torch.as_tensor(a, device=device) for a in src.batch_at(0)]
    resident = memory_mark()
    params = weights(cfg, mesh)
    opt = adamw_init(params)
    step_ms, metrics = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = S.lm_train_step(params, opt, *batch, cfg, mesh)
        metrics.append({k: float(v) for k, v in m.items()})
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["c"] = {"metrics": metrics, "step_ms": step_ms,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "resident_before": resident, "seconds": time.perf_counter() - t_part}
    if mesh is not None:
        out["c"]["save"] = sharded_save(params["layers"], T.lm_param_specs(cfg, mesh)["layers"],
                                        mesh)
    del params, opt, batch
    free_card()
    return out


def sharded_save(tree, specs, mesh) -> dict:
    """``save_checkpoint`` of this rank's blocks of ``tree`` (stacked
    ``[L, ...]`` layer weights) on ``mesh``, synchronously, into a scratch
    directory: its seconds, the device memory it added at its peak, the
    whole tree's bytes and the bound on that peak (an all-gather's parts,
    its result and a contiguous copy of it, four pieces of at most
    ``SAVE_PIECE_BYTES`` or one layer of one weight, whole)."""
    import tempfile

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import live_axes

    whole = {k: v.numel() * v.element_size() * math.prod(
        mesh.axis_size(live_axes(mesh, e)) for e in specs[k] if live_axes(mesh, e))
        for k, v in tree.items()}
    layer = max(b // tree[k].shape[0] for k, b in whole.items())
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    before = memory_mark()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        ckpt.save_checkpoint(d, 0, tree, async_save=False, mesh=mesh, specs=specs)
    return {"seconds": time.perf_counter() - t0,
            "extra_peak": torch.cuda.max_memory_allocated() - before,
            "whole_bytes": sum(whole.values()),
            "bound": 4 * max(ckpt.SAVE_PIECE_BYTES, layer)}


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def lm_mesh_path(smi: str, workdir: Path, device="cuda") -> tuple[dict, dict]:
    """Phase 6m: :func:`lm_mesh_work` on one rank in this process, then on
    four gloo ranks on the one card, each checked against the one-rank
    run; returns the whole phase's kernel launches (the ranks' summed) and
    the collective bytes rank 0 counted over one 1x4 decode step (by axis
    set), which phase 6n (c) holds the dry run's count against."""
    import torch

    reset_counts()
    t0 = time.perf_counter()
    one = lm_mesh_work(None, device)
    one_s = time.perf_counter() - t0
    free_card()
    t0 = time.perf_counter()
    ranks = mesh_ranks("lm_mesh_work", workdir, device="cpu" if device == "cpu" else None)
    ranks_s = time.perf_counter() - t0
    check(all(r["backend"] == "gloo" and r["device"] == ("cpu" if device == "cpu" else "cuda:0")
              for r in ranks),
          f"lm mesh: ranks not gloo on cuda:0: {[(r['backend'], r['device']) for r in ranks]}")
    rows = {"one_rank_s": one_s, "four_ranks_s": ranks_s}
    for r in ranks:
        a, b, c = r["a"], r["b"], r["c"]
        errs = {"a_first_logits": rel_err(a["first_logits"], one["a"]["first_logits"]),
                "a_check_dec": rel_err(a["check_dec"], one["a"]["check_dec"]),
                "a_check_full": rel_err(a["check_full"], one["a"]["check_full"]),
                "a_end_dec_vs_full": rel_err(a["check_dec"], a["check_full"]),
                "b_prefill_logits": rel_err(b["prefill_logits"], one["b"]["prefill_logits"])}
        for k, e in errs.items():
            check(e <= LM_F32_REL, f"lm mesh rank {r['rank']}: {k} off by {e} of the largest "
                                   f"logit (over {LM_F32_REL})")
        for part, key in (("a", "tokens_f32"), ("a", "check_tokens"), ("b", "tokens_f32")):
            check(torch.equal(r[part][key], one[part][key]),
                  f"lm mesh rank {r['rank']}: greedy {part} {key} differ from one rank's")
        for k in ("first_logits", "check_dec"):
            check(torch.equal(a[k], ranks[0]["a"][k]), f"lm mesh: {k} differ between ranks")
        for k in ("loss", "gnorm"):
            got, want = c["metrics"][0][k], one["c"]["metrics"][0][k]
            check(abs(got - want) <= LM_MESH_STEP_REL * abs(want),
                  f"lm mesh rank {r['rank']}: train step {k} {got}, one rank {want}")
        save = c["save"]
        check(save["extra_peak"] <= min(save["bound"], save["whole_bytes"]),
              f"lm mesh rank {r['rank']}: a sharded save added {save['extra_peak']} bytes at "
              f"its peak (bound {save['bound']}, the whole layers {save['whole_bytes']})")
        rows[f"rank{r['rank']}"] = {
            "rel_errs": errs, "train_step": c["metrics"][0],
            "bf16_tokens_equal_to_one_rank": {
                "a": float((a["tokens_bf16"] == one["a"]["tokens_bf16"]).float().mean()),
                "b": float((b["tokens_bf16"] == one["b"]["tokens_bf16"]).float().mean())},
            "peaks": {"a": a["max_memory_allocated"], "b": b["max_memory_allocated"],
                      "c": c["max_memory_allocated"]},
            "sharded_save": c["save"]}
    launches = {k: sum(r["launches"][k] for r in ranks) for k in KERNEL_NAMES}
    launches = {k: launches[k] + v for k, v in all_launches().items()}
    check(not any(launches.values()), f"lm mesh: kernel launches {launches}, expected none")

    def timing(res, part):
        t = dict(res[part])
        keep = ("prefill_s", "decode_ms_per_token", "weights_read_bytes", "max_memory_allocated",
                "step_ms", "decode_profile", "seconds")
        out = {k: t[k] for k in keep if k in t}
        if "weights_read_bytes" in t:
            out["decode_bound_ms"] = t["weights_read_bytes"] / HBM_BYTES_PER_S * 1e3
        return out

    r0 = ranks[0]
    rows.update({
        "a_qwen2_7b_whole": {"one_rank": timing(one, "a"), "1x4_rank0": timing(r0, "a")},
        "b_mixtral_8x7b_2_layers": {"one_rank": timing(one, "b"), "2x2_rank0": timing(r0, "b")},
        "c_qwen2_7b_2_layers_train": {"one_rank": timing(one, "c"), "2x2_rank0": timing(r0, "c"),
                                      "one_rank_metrics": one["c"]["metrics"]},
        "launches": launches})
    print(json.dumps({"lm_mesh": rows, "card": smi}), flush=True)
    return launches, r0["a"]["decode_collectives"]


def lm_mesh_child(out_path: str) -> None:
    """Phase 6m's process: a fresh CUDA context and profiler, and the card's
    memory free for the one-rank run and then the four ranks. Writes the
    phase's launches and rank 0's decode-step collective bytes to
    ``out_path``."""
    import tempfile

    import torch

    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = smi_line()
    t0 = time.perf_counter()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        launches, decode_coll = lm_mesh_path(smi, Path(tmp) / "ranks")
    Path(out_path).write_text(json.dumps({"launches": launches,
                                          "decode_collectives": decode_coll}))
    print(f"  phase 6m took {time.perf_counter() - t0:.1f} s in its process", flush=True)


def run_child(code: str, name: str, timeout: int) -> dict:
    """``code`` (which writes JSON to the path it is given) in a fresh
    interpreter; what it wrote."""
    import os
    import tempfile

    from repro_torch.kernels import build

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH", "")) if p))
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        out = Path(tmp) / "launches.json"
        proc = subprocess.run([sys.executable, "-c", code, str(out)], cwd=ROOT, env=env,
                              timeout=timeout)
        check(proc.returncode == 0 and out.exists(), f"phase {name} exited {proc.returncode}")
        return json.loads(out.read_text())


LM_MESH_CHILD = "import sys, chip_smoke; chip_smoke.lm_mesh_child(sys.argv[1])"


def kv_read_bytes(cfg, batch: int, t_att: int, mesh) -> int:
    """Bytes of bfloat16 cache one decode step attends on this rank."""
    from repro_torch.models import transformer as T

    sh = T._shard_of(cfg, mesh)
    b = batch // sh.dpn if sh.dpn > 1 and batch % sh.dpn == 0 else batch
    return 2 * cfg.n_layers * b * t_att * sh.kv_used * cfg.hd * 2


def lm_cards_serve(smi: str, arch: str, layers, requests, mesh, failures: list) -> list:
    """``launch.serve.generate`` of ``arch`` (``layers`` of it, or all) on
    ``mesh``, every rank alike: per request (batch, prompt, tokens), the
    float32 end check under ``no_drop`` (the last decode within
    ``LM_F32_REL`` of the largest logit of a prefill of the whole
    sequence), then the bfloat16 run at the configured capacity, timed
    (prefill s, decode ms/token beside the bound over this rank's blocks
    of the weights and cache), its logits finite. Rank 0 prints each row;
    a failed check is appended to ``failures`` and the runs go on (every
    rank fails alike: the checks read logits equal on every rank)."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.models import transformer as T

    cfg = registry.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    f32 = dataclasses.replace(no_drop(cfg), dtype="float32")
    resident = memory_mark()
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    t0 = time.perf_counter()
    params = T.init_lm(cfg, gen, mesh=mesh).params
    init_s = time.perf_counter() - t0
    weights = lm_weight_bytes(params)
    rows = []
    for batch, prompt, tokens in requests:
        toks = torch.randint(0, cfg.vocab, (batch, prompt), device=mesh.device, generator=gen)
        ref = end_check(params, f32, toks, tokens, mesh)
        err32, scale32 = float((ref["full"] - ref["dec"]).abs().max()), float(ref["full"].abs().max())
        if err32 > LM_F32_REL * max(1.0, scale32):
            failures.append(f"lm cards {arch} {batch}x{prompt}: float32 decode vs prefill "
                            f"max abs error {err32} (logits up to {scale32})")
        del ref
        memory_mark()
        run = end_check(params, cfg, toks, tokens, mesh)
        if not bool(torch.isfinite(run["dec"]).all() and torch.isfinite(run["full"]).all()):
            failures.append(f"lm cards {arch} {batch}x{prompt}: bfloat16 logits not finite")
        t_att = T.cache_shape(cfg, batch, prompt + tokens)["k"].shape[2]
        kv_bytes = kv_read_bytes(cfg, batch, t_att, mesh)
        row = {"arch": arch, "layers": cfg.n_layers, "mesh": dict(zip(mesh.axis_names, mesh.shape)),
               "batch": batch, "prompt": prompt, "tokens": tokens, "init_s": init_s,
               "float32_end_max_abs_err": err32, "float32_logit_scale": scale32,
               "prefill_s": run["prefill_s"],
               "decode_ms_per_token": run["decode_s"] / (tokens - 1) * 1e3,
               "decode_bound_ms": (weights + kv_bytes) / HBM_BYTES_PER_S * 1e3,
               "weights_read_bytes": weights, "kv_read_bytes": kv_bytes,
               "tokens_per_s": (tokens - 1) * batch / run["decode_s"],
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "resident_before": resident}
        if mesh.rank == 0:
            print(json.dumps({"lm_cards_serve": row, "card": smi}), flush=True)
        rows.append(row)
        del run
    del params
    free_card()
    return rows


def lm_cards_work(meshes, device=None) -> dict:
    """``lm_dist_cards``'s runs on one NCCL rank of four (one card each)."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import LMBatchSource
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import steps as S

    smi = smi_line()
    m14, m22 = meshes[(1, 4)], meshes[(2, 2)]
    say = print if m14.rank == 0 else (lambda *a, **k: None)
    for dt in (torch.float32, torch.bfloat16):  # the FSDP gradient's reduce-scatter
        x = torch.arange(24, dtype=dt, device=m22.device).reshape(8, 3) * (m22.rank + 1)
        i = m22.axis_index("data")
        want = m22.all_reduce(x, "sum", "data").narrow(0, 4 * i, 4)
        check(torch.equal(m22.reduce_scatter(x, "data", 0), want),
              f"lm cards: {m22.backend} reduce_scatter of {dt} differs from all_reduce")
    out, failures = {}, []
    for arch, layers, shape, requests in LM_CARDS_SERVE:
        t0 = time.perf_counter()
        out[arch] = lm_cards_serve(smi, arch, layers, requests, meshes[shape], failures)
        say(f"  {arch} on {shape} took {time.perf_counter() - t0:.1f} s", flush=True)
    # qwen2-7b whole, trained at 1x4 on one batch from a state past warm-up
    arch, (b, seq), steps = LM_CARDS_TRAIN
    cfg = registry.get_config(arch)
    src = LMBatchSource(cfg.vocab, seq_len=seq, batch=b, seed=0)
    batch = [torch.as_tensor(a, device=m14.device) for a in src.batch_at(0)]
    resident = memory_mark()
    params = T.init_lm(cfg, torch.Generator(device=m14.device).manual_seed(0),
                       mesh=m14).params
    opt = adamw_init(params)
    opt = opt._replace(step=torch.full_like(opt.step, S.LR["warmup"]))
    losses, step_ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = S.lm_train_step(params, opt, *batch, cfg, m14)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(losses[-1] < losses[0], f"lm cards train {arch}: losses {losses} did not fall")
    out["train"] = {"arch": arch, "batch": b, "seq": seq, "losses": losses, "step_ms": step_ms,
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "resident_before": resident}
    say(json.dumps({"lm_cards_train_1x4": out["train"], "card": smi}), flush=True)
    del params, opt, batch
    free_card()
    # qwen2-7b decode ms/token at 1x1 (rank 0 alone), 1x4 and 2x2
    cfg = registry.get_config("qwen2-7b")
    b, p, n = LM_MESH_REQUEST
    decode = {}
    for label, mesh in (("1x1", None), ("1x4", m14), ("2x2", m22)):
        if mesh is None and m14.rank != 0:
            m14.barrier()
            continue
        dev = m14.device
        params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                           mesh=mesh).params
        toks = torch.randint(0, cfg.vocab, (b, p), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(1))
        serve.generate(params, toks, cfg, 2, mesh)
        _, _, prefill_s, decode_s = serve.generate(params, toks, cfg, n, mesh)
        decode[label] = {"prefill_s": prefill_s, "decode_ms_per_token": decode_s / (n - 1) * 1e3,
                         "decode_bound_ms": lm_weight_bytes(params) / HBM_BYTES_PER_S * 1e3}
        del params
        free_card()
        if mesh is None:
            m14.barrier()
    out["decode"] = decode
    say(json.dumps({"lm_cards_qwen2_7b_decode": decode, "card": smi}), flush=True)
    check(not failures, "; ".join(failures))
    return out


def lm_dist_cards():
    """The sharded LM with one NCCL rank per card, on a host with four cards:

        python3 -c "import chip_smoke; chip_smoke.lm_dist_cards()"

    In order (``lm_cards_serve``: each request's decode checked against a
    prefill of the whole sequence in float32 under ``no_drop``, then run
    in bfloat16, timed): mixtral-8x7b whole at 1x4, serve's default
    request and an 8,192-token prompt; qwen3-32b and command-r-35b whole
    at 1x4, the default request; kimi-k2 at its published widths, 1 of 61
    layers, at 2x2 with FSDP over ``data`` and experts over ``model``, 2 x
    4,096 tokens;
    qwen2-7b whole trained at 1x4 for 3 steps on one batch of 2 x 4,096
    from a state past warm-up (the loss falls); qwen2-7b's decode ms/token
    at 1x1, 1x4 and 2x2. Rank 0 prints every row with the cards' names and
    power limits."""
    import torch

    if torch.cuda.device_count() < 4:
        fail(f"lm_dist_cards needs four cards, found {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(f"cards: {smi}", flush=True)
    from repro_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ranks = mesh_ranks("lm_cards_work", build.BUILD_DIR / "lm_cards", backend="nccl")
    check(sorted(r["device"] for r in ranks) == [f"cuda:{i}" for i in range(4)],
          f"lm_dist_cards: ranks not one per card: {[r['device'] for r in ranks]}")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in KERNEL_NAMES}
    check(not any(launches.values()), f"lm_dist_cards: kernel launches {launches}")
    print(json.dumps({"lm_dist_cards": {
        "seconds": time.perf_counter() - t0, "launches": launches,
        "peaks_by_rank": [{k: [row["max_memory_allocated"] for row in v]
                           for k, v in r.items() if isinstance(v, list)} for r in ranks]},
        "cards": smi}), flush=True)

# ---------------------------------------------------------------------------
# phase 6n: the dry run (one rank's program counted on a fake world of
# H100s, launch/dryrun.py) and its counts held against the card
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (("--arch", "mixtral-8x7b", "--shape", "decode_32k"),
                ("--arch", "gatedgcn", "--shape", "full_graph_sm"),
                ("--arch", "xdeepfm", "--shape", "train_batch"),
                ("--msf-only", "--shape", "rmat_s23_e8"),
                ("--arch", "qwen2-7b", "--shape", "train_4k"))  # must fail by name
DRYRUN_QWEN_ERROR = "ValueError: n_heads = 28 does not split over model = 16 ranks"
DRYRUN_TIMEOUT_S = 300
DRYRUN_TRAIN = ("qwen2-7b", 2, 2, 4_096)  # 6l (c)'s cell: arch, layers, batch, tokens
DRYRUN_PEAK_REL = 0.25
DRYRUN_CHILD_TIMEOUT_S = 600


def dryrun_cli(workdir: Path) -> tuple[list, dict]:
    """Phase 6n (a): start ``python -m repro_torch.launch.dryrun --mesh
    both`` once for each of :data:`DRYRUN_CELLS`, all at once; wait for
    them. Returns the processes and the dry-run records by cell id; the
    checks are :func:`check_dryrun_cli`'s."""
    import os

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    try:
        for i, flags in enumerate(DRYRUN_CELLS):
            log = open(workdir / f"cli{i}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "both",
                 "--outdir", str(workdir / f"cli{i}"), *flags], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        for p, _ in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    records = {}
    for i, (p, _) in enumerate(procs):
        for line in (workdir / f"cli{i}.log").read_text().splitlines():
            if line.startswith(("[OK ]", "[FAIL]", "dry-run:")):
                print(f"  {line[:260]}", flush=True)
        for f in sorted((workdir / f"cli{i}").glob("*.json")):
            rec = json.loads(f.read_text())
            records[rec["cell"]] = rec
    return [p.returncode for p, _ in procs], records


def check_dryrun_cli(codes: list, records: dict) -> None:
    """Every cell of :data:`DRYRUN_CELLS` recorded on both meshes; the
    qwen2-7b cells failed with ``check_mesh``'s error (exit 1), every
    other is ok (exit 0)."""
    for flags, code in zip(DRYRUN_CELLS, codes):
        want = 1 if "qwen2-7b" in flags else 0
        check(code == want, f"dryrun {' '.join(flags)}: exit {code}, expected {want}")
    check(len(records) == 2 * len(DRYRUN_CELLS),
          f"dryrun: {len(records)} records for {len(DRYRUN_CELLS)} cells on two meshes")
    for cell, rec in records.items():
        if cell.startswith("qwen2-7b:"):
            check(not rec["ok"] and rec.get("error") == DRYRUN_QWEN_ERROR,
                  f"dryrun {cell}: {rec.get('error')!r}, expected {DRYRUN_QWEN_ERROR!r}")
        else:
            check(rec["ok"], f"dryrun {cell} failed: {rec.get('error')}")


def dryrun_counts(device=None) -> dict:
    """Phase 6n (b) and (c): the dry-run cell of :data:`DRYRUN_TRAIN` at a
    1x1 mesh counted on meta tensors over a fake world, and the default
    request's qwen2-7b decode cell at 1x4 (its collective bytes); then the
    same train cell run for real on a 1x1 NCCL mesh on the card (``device
    ="cpu"``: a gloo group on the CPU, to rehearse): its inputs' bytes,
    ``FlopCounterMode``'s FLOPs over one step, the step's seconds (median
    of 3 after a warm-up) and the allocator's peak above what was resident
    before it. Checks the FLOPs and argument bytes equal, the peak within
    :data:`DRYRUN_PEAK_REL` and the bound no larger than the step."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.roofline import roofline
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import cells, fakedist
    from repro_torch.launch.mesh import make_mesh

    arch, layers, batch, tokens = DRYRUN_TRAIN
    cfg = dataclasses.replace(registry.get_config(arch), n_layers=layers)
    shape = ShapeCell(name=f"train_{tokens}_b{batch}", kind="train", seq_len=tokens,
                      global_batch=batch)
    reset_counts()
    t0 = time.perf_counter()
    cell = cells.make_cell(arch, cfg, shape, fakedist.fake_mesh((1, 1), ("data", "model")))
    fake = cells.run_cell(cell)
    with FlopCounterMode(display=False) as fc:
        cell.fn(*cell.make_args(fakedist.FAKE_DEVICE))
    fake["flop_counter_mode"] = fc.get_total_flops()
    rf = roofline(fake, n_devices=1)
    b, p, n = LM_MESH_REQUEST
    request = ShapeCell(name="request", kind="decode", seq_len=p + n, global_batch=b)
    # 6m (a) serves its float32 master weights: the embedding rows are
    # all-reduced in the table's dtype before the cast
    dec = cells.run_cell(cells.make_cell(arch, registry.get_config(arch), request,
                                         fakedist.fake_mesh((1, 4), ("data", "model")),
                                         {"serve_param_dtype": "float32"}))
    fakedist.teardown()
    fake_s = time.perf_counter() - t0

    on_card = device != "cpu"
    dist.init_process_group("nccl" if on_card else "gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=device)
        cell = cells.make_cell(arch, cfg, shape, mesh)
        args = cell.make_args(mesh.device)
        arg_bytes = cells.tree_nbytes(args)
        cell.fn(*args)  # warm-up: the allocator's pools, cuBLAS's workspace
        times, peaks, requested = [], [], []
        for _ in range(3):
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            asked = torch.cuda.memory_stats().get("requested_bytes.all.current", 0)
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            cell.fn(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            peaks.append(torch.cuda.max_memory_allocated() - resident)
            # the bytes the program asked for, before the allocator's rounding
            requested.append(torch.cuda.memory_stats().get("requested_bytes.all.peak", 0) - asked)
        with FlopCounterMode(display=False) as fc:
            cell.fn(*args)
        real_flops = fc.get_total_flops()
        del args
    finally:
        dist.destroy_process_group()
    step_s, peak = statistics.median(times), max(peaks)
    fake_flops = sum(fake["flops"].values())
    row = {"cell": f"{arch} {layers} layers, {batch} x {tokens}, train step, 1x1",
           "fake_count_s": fake_s,
           "flops": {"meta": fake_flops, "meta_flop_counter_mode": fake["flop_counter_mode"],
                     "card_flop_counter_mode": real_flops},
           "arg_bytes": {"meta": fake["arg_bytes"], "card": arg_bytes},
           "temp_bytes": {"meta": fake["temp_bytes"], "card_peak_above_resident": peak,
                          "meta_over_card": fake["temp_bytes"] / peak if peak else None,
                          "card_requested_peak_above_resident": max(requested)},
           "step_s": {"median": step_s, "all": times},
           "roofline": {k: rf[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s",
                                           "dominant", "bound_time_s")},
           "bound_share_of_step": rf["bound_time_s"] / step_s,
           "decode_1x4_collectives": {",".join(k): v for k, v in dec["collective"].items()},
           "launches": all_launches()}
    print(f"  (b) {row['cell']}: FLOPs meta {fake_flops} / card {real_flops}; args "
          f"{fake['arg_bytes']} / {arg_bytes} B; temp meta {fake['temp_bytes']} B, card peak "
          f"{peak} B ({row['temp_bytes']['meta_over_card']}); step {step_s * 1e3:.1f} ms, "
          f"bound {rf['bound_time_s'] * 1e3:.1f} ms ({rf['dominant']}), "
          f"{row['bound_share_of_step']:.3f} of the step", flush=True)
    check(fake_flops == fake["flop_counter_mode"] == real_flops,
          f"dryrun (b): FLOPs {fake_flops} (meta, by dtype), {fake['flop_counter_mode']} (meta, "
          f"FlopCounterMode), {real_flops} (card) differ")
    check(fake["arg_bytes"] == arg_bytes,
          f"dryrun (b): argument bytes {fake['arg_bytes']} (meta) != {arg_bytes} (card)")
    if on_card:
        check(abs(fake["temp_bytes"] - peak) <= DRYRUN_PEAK_REL * peak,
              f"dryrun (b): temporary bytes {fake['temp_bytes']} (meta) not within "
              f"{DRYRUN_PEAK_REL} of the card's peak {peak}")
    check(rf["bound_time_s"] <= step_s,
          f"dryrun (b): bound {rf['bound_time_s']} s above the measured step {step_s} s")
    return row


def dryrun_child(out_path: str) -> None:
    """Phase 6n (b) and (c)'s process: a fake process group and then a real
    one, each the process's default group in turn."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    Path(out_path).write_text(json.dumps(dryrun_counts()))


DRYRUN_CHILD = "import sys, chip_smoke; chip_smoke.dryrun_child(sys.argv[1])"


def dryrun_path(smi: str, decode_coll: dict, dist_row: dict, flat_cost: dict) -> dict:
    """Phase 6n: (a) the dry-run CLI on both production meshes for a cell of
    each family and the MSF, beside (b) and (c) in a child process; (c)
    the fake 1x4 decode cell's collective bytes against rank 0's over one
    real decode step of 6m (``decode_coll``); (d) ``dist_round_terms``'s
    bound of one 1x1 R-MAT s20 pack32 round against 6j's measured round
    (``dist_row``), beside the flat model's predicted/solve (``flat_cost``)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.analysis.roofline import roofline_time_s
    from repro_torch.graphs.partition import pad_n
    from repro_torch.kernels import build
    from repro_torch.solve import SolveSpec
    from repro_torch.solve.cost import dist_round_terms

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp, \
            ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        cli = pool.submit(dryrun_cli, Path(tmp) / "cli")
        counts = run_child(DRYRUN_CHILD, "6n", DRYRUN_CHILD_TIMEOUT_S)
        codes, records = cli.result()
        cli_s = time.perf_counter() - t0
    check_dryrun_cli(codes, records)
    row = {"cli_records": {k: {f: v.get(f) for f in (
        "ok", "error", "compile_s", "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "collective_bytes_by_axes", "dominant", "bound_time_s",
        "t_compute_s", "t_memory_s", "t_collective_s", "arg_bytes_per_device",
        "temp_bytes_per_device")} for k, v in records.items()},
        "cli_and_child_s": cli_s, "counts_on_the_card": counts}

    # (c)
    fake_coll = counts["decode_1x4_collectives"]
    print(f"  (c) qwen2-7b decode at 1x4: meta cell {fake_coll}, 6m rank 0 {decode_coll}",
          flush=True)
    check(fake_coll == decode_coll,
          f"dryrun (c): the decode cell's collective bytes {fake_coll} != 6m's {decode_coll}")
    row["decode_1x4_collectives"] = {"meta_cell": fake_coll, "card_6m_rank0": decode_coll}

    # (d)
    fr = dist_row["flat rmat_s20_ef8"]
    n_pad, size = pad_n(fr["n"], 1, 1)
    rnd = dist_round_terms(rows=1, cols=1, e_max=fr["e_max"], shard_size=size, pack=True,
                           capacity=min(SolveSpec().capacity, n_pad))
    bound = roofline_time_s(dot_flops=0.0, ew_ops=sum(o for _, o in rnd.terms.values()),
                            bytes_=sum(b for b, _ in rnd.terms.values()))
    measured = fr["times"]["dist_csp_1x1_s"] / fr["csp"]["rounds"]
    row["dist_round_1x1"] = {"bound_s": bound, "measured_round_s": measured,
                             "bound_over_round": bound / measured,
                             "flat_model_predicted_over_solve": flat_cost["predicted_over_solve"],
                             "terms_bytes": {k: v[0] for k, v in rnd.terms.items()}}
    print(f"  (d) R-MAT s20 dist round at 1x1: bound {bound * 1e3:.3f} ms, measured "
          f"{measured * 1e3:.3f} ms ({bound / measured:.3f}; the flat model's "
          f"predicted/solve {flat_cost['predicted_over_solve']:.3f})", flush=True)
    check(bound <= measured,
          f"dryrun (d): the dist round's bound {bound} s above the measured round {measured} s")
    print(json.dumps({"dryrun": row, "card": smi}), flush=True)
    return row


# ---------------------------------------------------------------------------
# phase 6o: the 64-bit min-outgoing kernel of the unpacked flat round
# ---------------------------------------------------------------------------

def unpacked_graph(g):
    """``g`` with every weight + 0.5 (each undirected edge keeps one): no
    longer integers, so the planner cannot pack it at any size."""
    from repro_torch.graphs.structures import Graph

    return Graph(g.src, g.dst, g.w + 0.5, g.eid, g.valid, n=g.n)


def flat64_bound_bytes(e: int, n: int) -> int:
    """The least bytes of one round of the min-outgoing kernel: every
    input byte read once (src, dst, w, eid: 4 B an edge, valid 1 B; p 4 B a
    vertex) and every output byte written once (w, eid, payload: 12 B a
    root)."""
    return 17 * e + 16 * n


def argmin_route(p, g):
    """The route the kernel replaced (``segment_argmin``'s three masked
    scatters over every edge), as ``min_outgoing_coo`` ran it, with its
    outgoing mask."""
    from repro_torch.core.semiring import segment_argmin

    ps, pd = p[g.src], p[g.dst]
    outgoing = (ps != pd) & g.valid
    return segment_argmin(g.w, g.eid, (pd,), ps, g.n, valid=outgoing), outgoing


def flat64_round_inputs(g) -> list:
    """The parent vector at the top of each AS round of ``g``'s default
    flat solve, replayed with the driver's own steps."""
    import torch

    from repro_torch.core import shortcut as sc
    from repro_torch.core.msf import hook_and_tiebreak
    from repro_torch.kernels import ops

    p = torch.arange(g.n, dtype=torch.int32, device=g.device)
    rounds = [p]
    while True:
        r, _ = ops.min_outgoing_flat64(p, g.src, g.dst, g.w, g.eid, g.valid, g.n)
        p_next = sc.complete_shortcut(hook_and_tiebreak(p, r.w, r.eid, r.payload[0])[0])
        if torch.equal(p_next, p):
            return rounds
        p = p_next
        rounds.append(p)


def flat64_rounds(label: str, g, *, plain: bool) -> list:
    """Phase 6o: ``ops.min_outgoing_flat64`` on each AS round's parent
    vector of ``g``'s default solve, checked against the route it replaced
    (weights compared with zeros' signs made equal, eid and payload
    exactly; the in-kernel count against ``count_true`` of the mask), then
    timed: the device time of each of its four kernels (torch.profiler,
    by name), the call (CUDA events), the round's bound
    (:func:`flat64_bound_bytes`), the replaced route's device time (one
    call: it takes seconds a round at scale 25) and, with ``plain``, the
    plain twin's on the card."""
    import torch

    from repro_torch.core.msf import count_true
    from repro_torch.kernels import ops, ref

    rows = []
    e = g.src.numel()
    for k, p in enumerate(flat64_round_inputs(g)):
        call = partial(ops.min_outgoing_flat64, p, g.src, g.dst, g.w, g.eid, g.valid, g.n)
        got, count = call(count=True)
        want, outgoing = argmin_route(p, g)
        outgoing = int(count_true(outgoing))
        same = (torch.equal((got.w + 0.0).view(torch.int32), (want.w + 0.0).view(torch.int32))
                and torch.equal(got.eid, want.eid)
                and torch.equal(got.payload[0], want.payload[0]))
        check(same, f"6o {label} round {k}: the kernel differs from segment_argmin's route")
        check(int(count) == outgoing,
              f"6o {label} round {k}: in-kernel count {int(count)} != {outgoing}")
        del got, want, count
        for _ in range(2):
            call()
        reps = 5
        by_name = {}
        for ev in device_rows(call, reps):
            name = next((kn for kn in ("fill", "reduce", "payload", "decode")
                         if f"{kn}_kernel" in ev.key), "other")
            by_name[name] = by_name.get(name, 0.0) + ev.self_device_time_total / 1e3 / reps
        bytes_ = flat64_bound_bytes(e, g.n)
        row = {"round": k, "E": e, "outgoing": outgoing, "outgoing_share": outgoing / max(1, e),
               **{f"{kn}_ms": by_name.get(kn, 0.0) for kn in ("fill", "reduce", "payload",
                                                              "decode")},
               "kernel_ms": sum(by_name.values()), "kernel_call_ms": time_ms(call, reps, 1),
               "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3, "bytes": bytes_,
               "library_ms": device_ms(partial(argmin_route, p, g), reps=1, warmup=0)}
        if plain:
            row["plain_ms"] = device_ms(partial(ref.min_outgoing_flat64_ref, p, g.src, g.dst,
                                                g.w, g.eid, g.valid, g.n), reps=3, warmup=1)
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        rows.append(row)
        print(f"  {label} round {k}: outgoing {row['outgoing_share']:.4f}, reduce "
              f"{row['reduce_ms']:.3f} + payload {row['payload_ms']:.3f} ms (kernel "
              f"{row['kernel_ms']:.3f}, call {row['kernel_call_ms']:.3f}, bound "
              f"{row['bound_ms']:.3f}), replaced route {row['library_ms']:.3f} ms", flush=True)
    return rows


def flat64_path(g_rmat, smi: str) -> dict:
    """Phase 6o on phase 5's graph made unpacked and on the benchmark cell
    :data:`FLAT64_CELL`'s graph: the per-round rows, then the default
    solve of each (median of 3, one launch per AS round, planned without
    pack32)."""
    import gc

    import torch

    from repro_torch.kernels import ops
    from repro_torch.solve import SolveSpec, plan

    out = {}
    for label, make, plain in (("rmat_s20_ef8_unpacked", lambda: unpacked_graph(g_rmat), True),
                               (FLAT64_CELL, lambda: bench_cell_graph(FLAT64_CELL)[0], False)):
        g = make()
        p = plan(g, SolveSpec())
        check(p.resolved.pack is False, f"6o {label}: the planner packed the graph")
        before = ops.min_outgoing_flat64.launches
        rep = p.solve()
        torch.cuda.synchronize()
        launches = ops.min_outgoing_flat64.launches - before
        check(launches == rep.iterations > 0,
              f"6o {label}: {launches} min-outgoing launches for {rep.iterations} rounds")
        rows = flat64_rounds(label, g, plain=plain)
        check(len(rows) == rep.iterations, f"6o {label}: {len(rows)} replayed rounds, "
                                           f"{rep.iterations} solved")
        out[label] = {"rounds": rows, "launches_per_solve": launches,
                      "solve_s": solve_times(g, {"solve": SolveSpec()})["solve_s"],
                      "edges": g.src.numel(), "n": g.n}
        print(json.dumps({f"min_outgoing_flat64 {label}": out[label], "card": smi}), flush=True)
        del g, p, rep
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6p: the undirected mode of the 64-bit min-outgoing kernel
# ---------------------------------------------------------------------------

def und_scatter_reduce(lo, hi, w, eid, valid, n: int, eid_capacity: int):
    """The route the undirected mode replaced in ``make_und_reduce`` (one
    device, no pack32): ``reduce_fn(p) -> EdgeMin`` by four scatter-mins
    over every edge (the weight by ``p[lo]`` and by ``p[hi]``, then the eid
    of the edges that hold it), the payload gathered back through an eid
    → position table built once per level. At a root whose least weight is
    +inf its payload is IMAX, which the hook never reads."""
    import torch

    from repro_torch.core.semiring import IMAX, INF, EdgeMin, segment_min

    dev = lo.device
    e = lo.shape[0]
    lo_l, hi_l = lo.long(), hi.long()
    keep = valid & (eid >= 0) & (eid < eid_capacity)
    pos_of_eid = torch.full((eid_capacity + 1,), -1, dtype=torch.int32, device=dev)
    pos_of_eid[torch.where(keep, eid, eid_capacity).long()] = torch.arange(
        e, dtype=torch.int32, device=dev)
    pos_of_eid = pos_of_eid[:eid_capacity]
    i_n = torch.arange(n, dtype=torch.int32, device=dev)

    def reduce_fn(p):
        plo, phi = p[lo_l], p[hi_l]
        out = (plo != phi) & valid
        wm = torch.where(out, w, INF)
        minw = torch.minimum(segment_min(wm, plo, n, INF), segment_min(wm, phi, n, INF))
        on1 = out & (wm == minw[plo.long()])
        on2 = out & (wm == minw[phi.long()])
        mineid = torch.minimum(
            segment_min(torch.where(on1, eid, IMAX), plo, n, IMAX),
            segment_min(torch.where(on2, eid, IMAX), phi, n, IMAX),
        )
        empty = minw == INF
        if e == 0:
            return EdgeMin(w=minw, eid=mineid,
                           payload=(torch.full((n,), IMAX, dtype=torch.int32, device=dev),))
        pos = pos_of_eid[mineid.clamp(0, eid_capacity - 1).long()]
        safe = pos.clamp(0, e - 1).long()
        plo_w, phi_w = p[lo_l[safe]], p[hi_l[safe]]
        pd = torch.where(plo_w == i_n, phi_w, plo_w)
        return EdgeMin(w=minw, eid=mineid,
                       payload=(torch.where((pos >= 0) & ~empty, pd, IMAX),))

    return reduce_fn


def und_scatter_route(p, lo, hi, w, eid, valid, n: int):
    """One call of :func:`und_scatter_reduce` with the eid bound read off
    ``eid``: ``(EdgeMin, None)``, as ``ops.min_outgoing_und64`` returns."""
    live = eid[valid]
    cap = max(8, 1 << int(live.max()).bit_length()) if live.numel() else 8
    return und_scatter_reduce(lo, hi, w, eid, valid, n, cap)(p), None


def same_und_minima(got, want) -> bool:
    """The kernel's per-root minima against :func:`und_scatter_reduce`'s:
    weights with zeros' signs made equal, eids exactly, payloads wherever
    the weight is finite (the replaced route left IMAX at a root whose
    least weight is +inf)."""
    import torch

    from repro_torch.core.semiring import IMAX

    pay = torch.where(got.w < float("inf"), got.payload[0], IMAX)
    return (torch.equal((got.w + 0.0).view(torch.int32), (want.w + 0.0).view(torch.int32))
            and torch.equal(got.eid, want.eid) and torch.equal(pay, want.payload[0]))


def und64_round_inputs(g, spec_kw: dict) -> tuple:
    """``(rounds, report, launches)`` of one coarsen solve of ``g``: the
    arguments of each ``ops.min_outgoing_und64`` call (the level's arrays
    and a copy of the parent vector), the solve's report and the launches
    of both modes of the kernel."""
    import types

    from repro_torch.coarsen import contract
    from repro_torch.kernels import ops
    from repro_torch.solve import SolveSpec, plan

    rounds = []

    def recorder(p, lo, hi, w, eid, valid, n, **kw):
        rounds.append((p.clone(), lo, hi, w, eid, valid, n))
        return ops.min_outgoing_und64(p, lo, hi, w, eid, valid, n, **kw)

    before = (ops.min_outgoing_und64.launches, ops.min_outgoing_flat64.launches)
    # the levels reach the wrapper as contract.ops.min_outgoing_und64; the
    # wrapper itself stays in place, with its launch counter
    contract.ops = types.SimpleNamespace(min_outgoing_und64=recorder)
    try:
        p = plan(g, SolveSpec(**spec_kw))
        rep = p.solve()
    finally:
        contract.ops = ops
    launches = {"und": ops.min_outgoing_und64.launches - before[0],
                "flat": ops.min_outgoing_flat64.launches - before[1],
                "levels": len(rep.levels),
                "rounds_per_level": p.resolved.coarsen.rounds_per_level}
    return rounds, rep, launches


def und64_rounds(label: str, rounds: list) -> list:
    """Phase 6p: ``ops.min_outgoing_und64`` on each recorded level round,
    checked against the route it replaced (:func:`same_und_minima`; the
    in-kernel count against ``count_true`` of the mask), then timed: the
    device time of each of its four kernels (torch.profiler, by name), the
    call (CUDA events), the round's bound (:func:`flat64_bound_bytes`) and
    the replaced route's device time (one call; its eid → position table
    is built once per level and not timed)."""
    import torch

    from repro_torch.core.msf import count_true
    from repro_torch.kernels import ops

    rows = []
    route = {}
    for k, (p, lo, hi, w, eid, valid, n) in enumerate(rounds):
        key = lo.data_ptr(), lo.numel()
        if key not in route:  # a new level
            route.clear()
            live = eid[valid]
            cap = max(8, 1 << int(live.max()).bit_length()) if live.numel() else 8
            route[key] = und_scatter_reduce(lo, hi, w, eid, valid, n, cap)
        call = partial(ops.min_outgoing_und64, p, lo, hi, w, eid, valid, n)
        got, count = call(count=True)
        want = route[key](p)
        outgoing = int(count_true((p[lo] != p[hi]) & valid))
        check(same_und_minima(got, want),
              f"6p {label} round {k}: the kernel differs from the scatter route")
        check(int(count) == outgoing,
              f"6p {label} round {k}: in-kernel count {int(count)} != {outgoing}")
        del got, want, count
        for _ in range(2):
            call()
        reps = 5
        by_name = {}
        for ev in device_rows(call, reps):
            name = next((kn for kn in ("fill", "reduce", "payload", "decode")
                         if f"{kn}_kernel" in ev.key), "other")
            by_name[name] = by_name.get(name, 0.0) + ev.self_device_time_total / 1e3 / reps
        bytes_ = flat64_bound_bytes(lo.numel(), n)
        row = {"round": k, "E": lo.numel(), "n": n, "outgoing": outgoing,
               "outgoing_share": outgoing / max(1, lo.numel()),
               **{f"{kn}_ms": by_name.get(kn, 0.0) for kn in ("fill", "reduce", "payload",
                                                              "decode")},
               "kernel_ms": sum(by_name.values()), "kernel_call_ms": time_ms(call, reps, 1),
               "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3, "bytes": bytes_,
               "scatter_route_ms": device_ms(partial(route[key], p), reps=1, warmup=0)}
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        rows.append(row)
        print(f"  {label} round {k}: E {row['E']}, n {n}, outgoing {row['outgoing_share']:.4f}, "
              f"reduce {row['reduce_ms']:.3f} + payload {row['payload_ms']:.3f} ms (kernel "
              f"{row['kernel_ms']:.3f}, call {row['kernel_call_ms']:.3f}, bound "
              f"{row['bound_ms']:.3f}), scatter route {row['scatter_route_ms']:.3f} ms",
              flush=True)
    return rows


def ptxas_registers(log: str) -> dict:
    """Registers and spill bytes of each entry function in an ``nvcc
    -Xptxas -v`` report: ``{mangled name: "N registers, S spill stores,
    L spill loads"}``."""
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.split(",", 1)[1].strip()
        elif "Used" in line and "registers" in line and name is not None:
            out[name] = f"{line.split('Used', 1)[1].split(',')[0].strip()}, {spill}"
    return out


def und64_path(smi: str) -> dict:
    """Phase 6p on the benchmark cell :data:`UND64_CELL`'s graph: the
    launches of one coarsen solve, the per-round rows, the median solve."""
    import gc

    import torch

    from repro_torch.kernels import build
    from repro_torch.solve import SolveSpec

    log = build.library_path("min_outgoing_flat64").with_suffix(".log").read_text()
    regs = ptxas_registers(log)
    for name, line in regs.items():
        print(f"  ptxas {name}: {line}", flush=True)
    g, kw = bench_cell_graph(UND64_CELL)
    rounds, rep, launches = und64_round_inputs(g, kw)
    torch.cuda.synchronize()
    level_rounds = launches["levels"] * launches["rounds_per_level"]
    check(launches["und"] == level_rounds == len(rounds) > 0,
          f"6p {UND64_CELL}: {launches['und']} undirected launches, {len(rounds)} recorded, "
          f"{level_rounds} level rounds")
    check(launches["flat"] == rep.iterations - level_rounds,
          f"6p {UND64_CELL}: {launches['flat']} flat launches for "
          f"{rep.iterations - level_rounds} residual rounds")
    rows = und64_rounds(UND64_CELL, rounds)
    del rounds
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"registers": regs, "launches": launches, "rounds": rows,
           "solve_s": solve_times(g, {"solve": SolveSpec(**kw)})["solve_s"],
           "peak_bytes_of_solves": torch.cuda.max_memory_allocated(),
           "edges": g.src.numel(), "n": g.n}
    print(json.dumps({f"min_outgoing_und64 {UND64_CELL}": out, "card": smi}), flush=True)
    del g
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
    return sum(count_syncs_split(fn))


def count_syncs_split(fn) -> tuple[int, int]:
    """(synchronisations torch's sync debug mode reports, explicit
    ``torch.cuda.synchronize`` calls) during ``fn()``."""
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
    return sum("synchroniz" in str(w.message) for w in caught), explicit


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


def obs_phase(g_rmat, g_grid, smi) -> None:
    phase("6h obs on the card")
    t0 = time.perf_counter()
    obs_row = obs_path(g_rmat, g_grid)
    obs_row["report"] = report_path(g_rmat, g_grid)
    obs_row["bench_cells"] = bench_cells_obs()
    print(json.dumps({"obs_on_the_card": obs_row, "card": smi}))
    print(f"  phase 6h took {time.perf_counter() - t0:.1f} s", flush=True)


def flat64_phase(g_rmat, smi) -> dict:
    phase("6o the 64-bit min-outgoing kernel per AS round")
    t0 = time.perf_counter()
    out = flat64_path(g_rmat, smi)
    print(f"  phase 6o took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def und64_phase(smi) -> dict:
    phase("6p the undirected mode of the 64-bit min-outgoing kernel per level round")
    t0 = time.perf_counter()
    out = und64_path(smi)
    print(f"  phase 6p took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def obs_only() -> None:
    """``python chip_smoke.py --phase 6h``: the build and phase 6h alone."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from repro_torch.graphs import grid_road_graph, rmat_graph
    from repro_torch.kernels import build

    phase("1 device")
    smi = smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    phase("2 build")
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    build.build_all()
    obs_phase(rmat_graph(**RMAT, device="cuda"), grid_road_graph(*GRID, device="cuda"), smi)
    print(json.dumps({"ok": True, "phases": ["6h"]}))


def flat64_only() -> None:
    """``python chip_smoke.py --phase 6o``: the build and phase 6o alone."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from repro_torch.graphs import rmat_graph
    from repro_torch.kernels import build

    phase("1 device")
    smi = smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    phase("2 build")
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    libs = build.build_all()
    for line in libs["min_outgoing_flat64"].with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    flat64_phase(rmat_graph(**RMAT, device="cuda"), smi)
    print(json.dumps({"ok": True, "phases": ["6o"]}))


def und64_only() -> None:
    """``python chip_smoke.py --phase 6p``: the build and phase 6p alone."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from repro_torch.kernels import build

    phase("1 device")
    smi = smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    phase("2 build")
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    build.build_all()
    und64_phase(smi)
    print(json.dumps({"ok": True, "phases": ["6p"]}))


def main():
    import gc

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    from repro_torch.graphs import grid_road_graph, rmat_graph
    from repro_torch.kernels import build

    phase("1 device")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
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

    obs_phase(g_rmat, g_grid, smi)
    flat64 = flat64_phase(g_rmat, smi)
    und64 = und64_phase(smi)

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

    phase("6k the GNN and recsys trainer")
    t0 = time.perf_counter()
    train_launches = train_path(g_rmat, smi)
    print(f"  phase 6k took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("6l the LM family (in its own process)")
    t0 = time.perf_counter()
    del g_rmat, g_rmat19, g_grid, g_s16, dense_graphs, bucket_in, stream_update
    gc.collect()
    torch.cuda.empty_cache()
    lm_launches = run_lm_phase()
    check(not any(lm_launches.values()), f"lm: kernel launches {lm_launches}, expected none")
    print(f"  phase 6l took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("6m the mesh-sharded LM: four gloo ranks on the one card (in its own process)")
    t0 = time.perf_counter()
    lm_mesh_out = run_child(LM_MESH_CHILD, "6m", LM_MESH_CHILD_TIMEOUT_S)
    lm_mesh_launches = lm_mesh_out["launches"]
    check(not any(lm_mesh_launches.values()),
          f"lm mesh: kernel launches {lm_mesh_launches}, expected none")
    print(f"  phase 6m took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("6n the dry run: cells on fake production meshes, counts held against the card")
    t0 = time.perf_counter()
    dryrun_row = dryrun_path(smi, lm_mesh_out["decode_collectives"], dist_row,
                             cost_rows["flat rmat_s20_ef8"])
    dryrun_launches = dryrun_row["counts_on_the_card"]["launches"]
    check(not any(dryrun_launches.values()),
          f"dryrun: kernel launches {dryrun_launches}, expected none")
    print(f"  phase 6n took {time.perf_counter() - t0:.1f} s", flush=True)
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
            **dist_launches["segment_min_flat"],
            "train": train_launches["segment_min_flat"],
            "lm": lm_launches["segment_min_flat"],
            "lm_sharded": lm_mesh_launches["segment_min_flat"],
            "dryrun": dryrun_launches["segment_min_flat"]},
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
                             **dist_launches["segment_min_sorted"],
                             "train": train_launches["segment_min_sorted"],
                             "lm": lm_launches["segment_min_sorted"],
                             "lm_sharded": lm_mesh_launches["segment_min_sorted"],
            "dryrun": dryrun_launches["segment_min_sorted"]},
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
        "launches_by_path": {"entry points": entry_launches["multilinear_dense"],
                             "train": train_launches["multilinear_dense"],
                             "lm": lm_launches["multilinear_dense"],
                             "lm_sharded": lm_mesh_launches["multilinear_dense"],
            "dryrun": dryrun_launches["multilinear_dense"]},
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
        "launches_by_path": {"entry points": entry_launches["segment_min_bucketed"],
                             "train": train_launches["segment_min_bucketed"],
                             "lm": lm_launches["segment_min_bucketed"],
                             "lm_sharded": lm_mesh_launches["segment_min_bucketed"],
            "dryrun": dryrun_launches["segment_min_bucketed"]},
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
    }, {
        "name": "min_outgoing_flat64",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/min_outgoing_flat64.cu",
        "replaces": "no TPU kernel: segment_argmin's three masked scatters of the unpacked "
                    "root route (src/repro/core/multilinear.py::min_outgoing_coo)",
        "launches": flat64["rmat_s20_ef8_unpacked"]["launches_per_solve"],
        "launches_by_path": {
            **{f"flat {k}": v["launches_per_solve"] for k, v in flat64.items()},
            **{k: v["min_outgoing_flat64"] for k, v in tune_launches.items()},
            "train": train_launches["min_outgoing_flat64"],
            "lm": lm_launches["min_outgoing_flat64"],
            "lm_sharded": lm_mesh_launches["min_outgoing_flat64"],
            "dryrun": dryrun_launches["min_outgoing_flat64"]},
        "matches_plain": True,
        **{k: {f: statistics.fmean(r[f] for r in v["rounds"])
               for f in ("reduce_ms", "payload_ms", "kernel_ms", "kernel_call_ms", "bound_ms",
                         "library_ms", *(("plain_ms",) if "plain_ms" in v["rounds"][0] else ()))}
           for k, v in flat64.items()},
        "bound_by": "bytes",
        "timed_on": "every AS round's parent vector of the default solve of R-MAT s20 ef8 "
                    "with weights + 0.5 and of the g500-s25.solve cell's graph, mean per "
                    "launch; library: the segment_argmin route it replaced; " + entry_note,
    }, {
        "name": "min_outgoing_und64",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/min_outgoing_flat64.cu (undirected mode)",
        "replaces": "no TPU kernel: make_und_reduce's four scatter-mins over every edge of "
                    "a coarsen level round (src/repro/coarsen/contract.py)",
        "launches": und64["launches"]["und"],
        "launches_by_path": {
            f"coarsen {UND64_CELL}": und64["launches"]["und"],
            **{k: v["min_outgoing_und64"] for k, v in tune_launches.items()},
            "train": train_launches["min_outgoing_und64"],
            "lm": lm_launches["min_outgoing_und64"],
            "lm_sharded": lm_mesh_launches["min_outgoing_und64"],
            "dryrun": dryrun_launches["min_outgoing_und64"]},
        "matches_plain": True,
        **{f: statistics.fmean(r[f] for r in und64["rounds"])
           for f in ("reduce_ms", "payload_ms", "kernel_ms", "kernel_call_ms", "bound_ms",
                     "scatter_route_ms")},
        "bound_by": "bytes",
        "timed_on": f"every level round of one coarsen solve of the {UND64_CELL} cell's graph, "
                    "mean per launch; library: the four scatter-mins it replaced",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--phase", "6h"]:
        obs_only()
    elif sys.argv[1:] == ["--phase", "6o"]:
        flat64_only()
    elif sys.argv[1:] == ["--phase", "6p"]:
        und64_only()
    else:
        main()
