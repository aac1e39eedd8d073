"""Streaming MSF serving demo: replay a synthetic insert/query workload
(counterpart of ``repro.launch.serve_graph``).

Entry modes:

- default — in-process replay: generates an R-MAT edge stream, feeds it
  to a stream plan (``SolveSpec(mode="stream")``) in fixed-size insert
  batches, interleaves batched connectivity queries answered from the
  published snapshots, then reports update latency percentiles, query
  throughput, and verifies the final forest against a from-scratch flat
  plan::

    PYTHONPATH=src python -m repro_torch.launch.serve_graph --scale 12 \\
        --edge-factor 8 --batch-size 2048 --queries-per-batch 8192

- ``--serve`` — the network serving tier: wire a stream plan into
  :class:`repro_torch.serve.MSFServer`, warm it with the first
  ``--warm-frac`` of the deterministic edge stream, and serve ``serve/v1``
  TCP until SIGTERM/SIGINT completes the graceful drain::

    PYTHONPATH=src python -m repro_torch.launch.serve_graph --serve \\
        --scale 10 --port 9012 --checkpoint-dir /tmp/msf-ckpt

  A client regenerates the same shuffled edge stream from (``--scale``,
  ``--edge-factor``, ``--seed``) with :func:`edge_stream`. With
  ``--checkpoint-dir`` the server warm-starts from the newest checkpoint
  (skipping the warm-up replay) and checkpoints again on drain;
  ``--metrics-out`` dumps the final ``repro_torch.obs`` metrics snapshot
  JSON on shutdown;

- ``--loadgen`` — the open-loop SLO harness instead (every other flag
  goes to :mod:`repro_torch.launch.loadgen`; with ``--target
  tcp://HOST:PORT`` it drives a ``--serve`` server started with the same
  ``--scale``, ``--edge-factor``, ``--seed`` and ``--warm-frac``).

Every mode runs on the card unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def undirected_edges(g):
    """Recover the (lo, hi, w) undirected edge list of a symmetric Graph,
    as host arrays."""
    from repro_torch.graphs.structures import host_array

    src, dst, w = host_array(g.src), host_array(g.dst), host_array(g.w)
    sel = host_array(g.valid) & (src < dst)
    return src[sel], dst[sel], w[sel]


def edge_stream(scale: int, edge_factor: int, seed: int):
    """The canonical shuffled undirected R-MAT edge stream for
    ``(scale, edge_factor, seed)`` — deterministic, and the reference's
    own numbers (the port's ``rmat_graph`` draws what the reference's
    does), so a server and a client regenerating it independently see
    identical edges in identical order."""
    from repro_torch.graphs.generators import rmat_graph

    g = rmat_graph(scale, edge_factor, seed=seed, device="cpu")
    lo, hi, w = undirected_edges(g)
    perm = np.random.default_rng(seed).permutation(len(lo))
    return lo[perm], hi[perm], w[perm]


# ---------------------------------------------------------------------------
# --serve mode
# ---------------------------------------------------------------------------

def _serve_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="serve_graph --serve",
        description="serve a stream plan over serve/v1 TCP",
    )
    ap.add_argument("--scale", type=int, default=10, help="n = 2**scale")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warm-frac", type=float, default=0.25,
                    help="fraction of the edge stream inserted before "
                         "serving (skipped on checkpoint warm-start)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (printed at startup)")
    ap.add_argument("--batch-capacity", type=int, default=512,
                    help="stream-engine insert batch capacity")
    ap.add_argument("--micro-batch", type=int, default=256,
                    help="fused query points per server flush")
    ap.add_argument("--queue-cap", type=int, default=8192)
    ap.add_argument("--deadline-ms", type=float, default=1000.0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="durable engine state: warm-start from the "
                         "newest checkpoint here, checkpoint on drain")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="autosave every K write ops (0 = drain only)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final obs metrics snapshot JSON "
                         "here on drain")
    ap.add_argument("--device", default="cuda",
                    help="where the stream engine runs (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch import obs, serve
    from repro_torch.solve import SolveSpec, plan
    from repro_torch.stream import persist

    n = 1 << args.scale
    stream = plan(
        n, SolveSpec(mode="stream", batch_capacity=args.batch_capacity),
        device=args.device,
    )
    warm_start = bool(
        args.checkpoint_dir
        and persist.latest_stream_step(args.checkpoint_dir) is not None
    )
    if not warm_start and args.warm_frac > 0:
        lo, hi, w = edge_stream(args.scale, args.edge_factor, args.seed)
        warm = int(len(lo) * args.warm_frac)
        cap = args.batch_capacity
        for at in range(0, warm, cap):
            end = min(at + cap, warm)
            stream.update(lo[at:end], hi[at:end], w[at:end])
        print(f"# warmed with {warm} edges "
              f"(v{stream.engine.version}, weight={stream.engine.weight:.0f})",
              flush=True)

    cfg = serve.ServeConfig(
        host=args.host, port=args.port, micro_batch=args.micro_batch,
        queue_cap=args.queue_cap, deadline_ms=args.deadline_ms,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    serve.serve_forever(stream, cfg)  # blocks until drain completes

    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(obs.metrics_snapshot(), f, indent=1, sort_keys=True)
        print(f"# metrics snapshot written to {args.metrics_out}")
    print(f"# drained at v{stream.engine.version} "
          f"weight={stream.engine.weight:.0f}")
    return 0


# ---------------------------------------------------------------------------
# default replay mode
# ---------------------------------------------------------------------------

def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--loadgen" in argv:
        from repro_torch.launch.loadgen import main as loadgen_main

        raise SystemExit(loadgen_main([a for a in argv if a != "--loadgen"]))
    if "--serve" in argv:
        raise SystemExit(
            _serve_main([a for a in argv if a != "--serve"])
        )
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=12, help="n = 2**scale vertices")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--queries-per-batch", type=int, default=8192)
    ap.add_argument("--delete-every", type=int, default=0,
                    help="if >0, delete a small batch of forest edges after "
                         "every k-th insert")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="export a Chrome-trace/Perfetto JSON of the run")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="K",
                    help="if >0, dump the obs metrics snapshot (incl. "
                         "query-latency p50/p95/p99) every K batches")
    ap.add_argument("--device", default="cuda",
                    help="where the plans run (default: the card)")
    args = ap.parse_args(argv)
    if args.batch_size < 1:
        ap.error("--batch-size must be >= 1")
    if args.queries_per_batch < 1:
        ap.error("--queries-per-batch must be >= 1")

    from repro_torch import obs
    from repro_torch.graphs.structures import from_edges
    from repro_torch.solve import SolveSpec, plan

    if args.trace:
        obs.enable("trace")
    elif args.metrics_every:
        obs.enable("metrics")

    n = 1 << args.scale
    lo, hi, w = edge_stream(args.scale, args.edge_factor, args.seed)
    rng = np.random.default_rng(args.seed)
    n_batches = (len(lo) + args.batch_size - 1) // args.batch_size

    stream = plan(
        n, SolveSpec(mode="stream", batch_capacity=args.batch_size),
        device=args.device,
    )
    engine = stream.engine  # forest introspection for --delete-every
    print(
        f"# n={n} edges={len(lo)} batches={n_batches} "
        f"union_buffer={2 * engine.union_edge_capacity} directed slots "
        f"device={engine.device}"
    )

    up_lat, q_tp = [], []
    for k in range(n_batches):
        sl = slice(k * args.batch_size, (k + 1) * args.batch_size)
        t0 = time.perf_counter()
        rep = stream.update(lo[sl], hi[sl], w[sl])
        up_lat.append(time.perf_counter() - t0)
        if args.delete_every and (k + 1) % args.delete_every == 0:
            flo, fhi, _, _ = engine.forest_edges()
            kill = rng.integers(0, len(flo), size=min(8, len(flo)))
            stream.delete(flo[kill], fhi[kill])
        qu = rng.integers(0, n, args.queries_per_batch)
        qv = rng.integers(0, n, args.queries_per_batch)
        t0 = time.perf_counter()
        stream.query(qu, qv)
        q_tp.append(args.queries_per_batch / (time.perf_counter() - t0))
        if k % max(1, n_batches // 10) == 0:
            print(
                f"batch {k:4d}: v{rep.raw.version} weight={rep.weight:.0f} "
                f"ncc={rep.n_components} update={up_lat[-1] * 1e3:.1f}ms "
                f"queries={q_tp[-1] / 1e6:.2f}M/s"
            )
        if args.metrics_every and (k + 1) % args.metrics_every == 0:
            snap = obs.metrics_snapshot()["histograms"]
            qs = snap.get("span.stream.query")
            us = snap.get("span.stream.update")
            parts = [f"# metrics @batch {k}:"]
            for tag, s in (("query", qs), ("update", us)):
                if s:
                    parts.append(
                        f"{tag} p50={s['p50'] * 1e3:.2f}ms "
                        f"p95={s['p95'] * 1e3:.2f}ms "
                        f"p99={s['p99'] * 1e3:.2f}ms n={s['count']}"
                    )
            print(" ".join(parts))

    lat = np.asarray(up_lat[1:] or up_lat)  # drop the first (warm-up) call
    print(
        f"updates: p50={np.percentile(lat, 50) * 1e3:.1f}ms "
        f"p95={np.percentile(lat, 95) * 1e3:.1f}ms "
        f"({args.batch_size / np.median(lat):.0f} edges/s sustained)"
    )
    print(f"queries: median {np.median(q_tp) / 1e6:.2f}M/s "
          f"(batch={args.queries_per_batch})")
    if args.trace:
        obs.export_trace(args.trace)
        print(f"# trace written to {args.trace} "
              f"({len(obs.trace_events())} spans) — open in ui.perfetto.dev")

    if not args.delete_every:
        full = plan(
            from_edges(lo, hi, w.astype(np.float64), n, device=args.device),
            SolveSpec(),
        ).solve()
        weight = stream.solve().weight
        ok = abs(full.weight - weight) < max(1.0, 1e-6 * weight)
        print(f"verify vs full recompute: weight {weight:.0f} vs "
              f"{full.weight:.0f} -> {'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
