"""Open-loop SLO load harness for the streaming serving path (counterpart
of ``repro.launch.loadgen``).

Drives :class:`~repro_torch.stream.service.QueryService` /
:class:`~repro_torch.stream.service.MicroBatcher` with **open-loop** Poisson
arrivals — inter-arrival gaps are drawn from a seeded exponential at the
offered QPS and queries are *admitted on schedule regardless of how the
server keeps up* (closed-loop harnesses hide overload by slowing the
client down; an open loop exposes it as queue growth, drops and tail
latency). Meanwhile a concurrent writer thread keeps mutating the graph
through the stream plan's ``update``, so the measured latencies include
snapshot churn, exactly like the serving deployment.

Three actors:

- **producer** (thread): walks the precomputed Poisson arrival schedule
  and pushes ``(deadline, u, v)`` into a *bounded* admission queue;
  ``queue.Full`` is a drop (counted, never blocks — open loop);
- **writer** (thread): mutates the graph every ``--writer-interval-ms``
  — inserts edge batches via ``plan.update`` (wrapping around the edge
  stream) and, on a ``--delete-frac`` fraction of rounds, deletes a
  slice of previously-inserted edges via ``plan.delete`` (exact
  replacement-edge deletions, so snapshots stay true MSFs under churn);
- **consumer** (main thread): pulls admitted queries into the
  MicroBatcher and flushes either at the micro-batch size or when the
  queue momentarily empties; per-query end-to-end latency (scheduled
  arrival → host-resident answer, i.e. including queue wait) goes into a
  ``repro_torch.obs`` histogram.

The writer and the consumer issue onto one CUDA stream, the one current
where the run starts (a new thread would otherwise start on the
device's default stream), so a published snapshot is never read before
its publisher's work, as in ``repro_torch.serve``.

The run emits an ``slo-report/v1`` JSON document (offered vs achieved
QPS, p50/p95/p99, drop/timeout counters, MicroBatcher admission
metrics) and the process exits nonzero when configured SLO targets are
missed — the smoke gate of the serving path (``tools/check_slo_report.py``
validates the report)::

    PYTHONPATH=src python -m repro_torch.launch.loadgen --qps 200 \
        --duration 5 --out SLO_loadgen_smoke.json [--device cpu]

Also reachable as ``python -m repro_torch.launch.serve_graph --loadgen ...``.
The stream plan runs on the card unless ``--device cpu`` asks for the CPU.

``--target tcp://host:port`` switches both load lanes onto the wire:
point queries are pipelined over a ``serve/v1`` connection to a
``repro_torch.serve`` server (started with ``serve_graph --serve``),
which fuses them into micro-batches
server-side; the writer churns inserts/deletes over a second
connection. The report keeps the ``slo-report/v1`` schema and adds a
``server`` block (end-of-run status + ``serve.*`` metrics) in place of
the in-process ``batcher`` block.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import queue
import threading
import time
import traceback

import numpy as np

SCHEMA = "slo-report/v1"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="loadgen", description="open-loop SLO load harness"
    )
    ap.add_argument("--target", metavar="tcp://HOST:PORT", default=None,
                    help="drive a repro_torch.serve server over the wire instead "
                         "of an in-process plan (serve/v1 protocol; start "
                         "one with `serve_graph --serve`). scale/edge-factor/"
                         "seed/warm-frac must match the server's so the "
                         "writer continues the same edge stream")
    ap.add_argument("--warm-frac", type=float, default=0.25,
                    help="[--target] fraction of the edge stream the server "
                         "already inserted at warm-up; the remote writer "
                         "starts after it")
    ap.add_argument("--max-inflight", type=int, default=1024,
                    help="[--target] pipelined queries in flight before "
                         "arrivals drop (the open-loop admission bound)")
    ap.add_argument("--qps", type=float, default=200.0,
                    help="offered arrival rate (Poisson)")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="seconds of offered load")
    ap.add_argument("--scale", type=int, default=10,
                    help="n = 2**scale vertices")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--micro-batch", type=int, default=256,
                    help="MicroBatcher window (auto-flush threshold)")
    ap.add_argument("--queue-cap", type=int, default=4096,
                    help="admission queue bound; arrivals past it drop")
    ap.add_argument("--timeout-ms", type=float, default=250.0,
                    help="per-query latency budget; slower answers count "
                         "as timeouts (still answered)")
    ap.add_argument("--writer-batch", type=int, default=512)
    ap.add_argument("--writer-interval-ms", type=float, default=20.0)
    ap.add_argument("--delete-frac", type=float, default=0.2,
                    help="fraction of writer rounds that delete a slice "
                         "of previously-inserted edges (exact "
                         "replacement-edge deletions); 0 disables the "
                         "delete mix")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", metavar="PATH", default=None,
                    help="write the slo-report/v1 JSON here")
    ap.add_argument("--slo-p50-ms", type=float, default=250.0)
    ap.add_argument("--slo-p99-ms", type=float, default=2000.0)
    ap.add_argument("--max-drop-frac", type=float, default=0.2)
    ap.add_argument("--min-qps-frac", type=float, default=0.5,
                    help="achieved/offered QPS floor")
    ap.add_argument("--device", default="cuda",
                    help="where the in-process stream plan runs (default: "
                         "the card); with --target it only labels the "
                         "report's env")
    return ap


def _env(device: str) -> dict:
    import torch

    return {
        "torch": torch.__version__,
        "backend": torch.device(device).type,
        "device_count": torch.cuda.device_count(),
        "python": platform.python_version(),
        "machine": platform.machine(),
        "cpu_count": os.cpu_count(),
    }


def _config(args) -> dict:
    """The run's flags as the reference reports them; the device is
    ``env.backend``."""
    return {k: v for k, v in vars(args).items() if k not in ("out", "device")}


def _arrival_schedule(rng, qps: float, duration: float) -> np.ndarray:
    """Poisson arrival offsets (seconds from start) within [0, duration)."""
    # E[count] = qps * duration; draw with slack, trim at the horizon.
    draw = max(16, int(qps * duration * 1.5) + 64)
    offs = np.cumsum(rng.exponential(1.0 / qps, size=draw))
    while offs[-1] < duration:  # pathological under-draw; extend
        offs = np.concatenate(
            [offs, offs[-1] + np.cumsum(rng.exponential(1.0 / qps, size=draw))]
        )
    return offs[offs < duration]


def run(args) -> dict:
    import torch

    from repro_torch import obs
    from repro_torch.launch.serve_graph import edge_stream
    from repro_torch.serve.server import _use_stream
    from repro_torch.solve import SolveSpec, plan
    from repro_torch.stream.service import MicroBatcher, QueryService

    obs.enable("metrics")
    obs.metrics_reset()

    n = 1 << args.scale
    lo, hi, w = edge_stream(args.scale, args.edge_factor, args.seed)
    rng = np.random.default_rng(args.seed)

    stream = plan(
        n, SolveSpec(mode="stream", batch_capacity=args.writer_batch),
        device=args.device,
    )
    dev = stream.engine.device
    cuda_stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    # Seed the forest with the first quarter of the stream (chunked —
    # insert_batch rejects batches above capacity), leaving the rest for
    # the concurrent writer to churn through during the run.
    warm = max(args.writer_batch, len(lo) // 4)
    for at in range(0, warm, args.writer_batch):
        end = min(at + args.writer_batch, warm)
        stream.update(lo[at:end], hi[at:end], w[at:end])

    service = QueryService(stream.engine.snapshots)
    batcher = MicroBatcher(service, max_queue=args.micro_batch)
    # One warm query batch: nothing compiles per width here, so there is
    # no padded-width sweep.
    z = np.zeros(min(args.micro_batch, service.max_batch), np.int32)
    service.connected(z, z)

    hist = obs.histogram("loadgen.e2e_latency_s")
    dropped = obs.counter("loadgen.dropped")
    timeouts = obs.counter("loadgen.timeout")

    admission: queue.Queue = queue.Queue(maxsize=args.queue_cap)
    producer_done = threading.Event()
    stop_writer = threading.Event()
    writer_stats = {
        "updates": 0,
        "edges": 0,
        "deletes": 0,
        "edges_deleted": 0,
        "replacements": 0,
        "unhealed": 0,
    }
    writer_error: list = []

    offs = _arrival_schedule(rng, args.qps, args.duration)
    qu = rng.integers(0, n, size=len(offs))
    qv = rng.integers(0, n, size=len(offs))
    t_start = time.perf_counter()

    def producer() -> None:
        for i, off in enumerate(offs):
            lag = (t_start + off) - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            try:  # never blocks: open loop — overload shows up as drops
                admission.put_nowait((t_start + off, int(qu[i]), int(qv[i])))
            except queue.Full:
                dropped.inc()
        producer_done.set()

    def writer() -> None:
        try:
            _use_stream(cuda_stream)
            write_rounds()
        except Exception as e:  # reported as an SLO failure below
            traceback.print_exc()
            writer_error.append(f"{type(e).__name__}: {e}")

    def write_rounds() -> None:
        pos = warm
        interval = args.writer_interval_ms / 1e3
        wrng = np.random.default_rng(args.seed + 1)
        while not stop_writer.is_set():
            if args.delete_frac > 0 and wrng.random() < args.delete_frac:
                # Delete-churn round: tombstone-and-heal a random slice
                # of the edges inserted so far (exact replacement-edge
                # deletions; re-inserting them later is an MSF no-op, so
                # the wrap-around keeps the graph statistically stable).
                at = int(wrng.integers(0, max(1, pos - args.writer_batch)))
                end = min(at + max(1, args.writer_batch // 4), pos)
                rep = stream.delete(lo[at:end], hi[at:end])
                writer_stats["deletes"] += 1
                writer_stats["edges_deleted"] += end - at
                if rep.raw is not None:
                    writer_stats["replacements"] += rep.raw.n_replacements
                writer_stats["unhealed"] = rep.n_unhealed
            else:
                if pos >= len(lo):
                    pos = warm  # wrap; duplicate inserts are MSF no-ops
                end = min(pos + args.writer_batch, len(lo))
                stream.update(lo[pos:end], hi[pos:end], w[pos:end])
                writer_stats["updates"] += 1
                writer_stats["edges"] += end - pos
                pos = end
            stop_writer.wait(interval)

    answered = 0
    pending: list[float] = []  # scheduled arrival times of the open window

    def flush_window() -> None:
        nonlocal answered
        if not pending:
            return
        batcher.flush()  # idempotent after a MicroBatcher auto-flush
        t_now = time.perf_counter()
        for t_arr in pending:
            lat = t_now - t_arr
            hist.observe(lat)
            if lat > args.timeout_ms / 1e3:
                timeouts.inc()
        answered += len(pending)
        pending.clear()

    threads = [threading.Thread(target=producer, daemon=True),
               threading.Thread(target=writer, daemon=True)]
    for t in threads:
        t.start()
    while True:
        try:
            t_arr, u, v = admission.get(timeout=0.02)
        except queue.Empty:
            flush_window()  # partial window: bound tail latency
            if producer_done.is_set() and admission.empty():
                break
            continue
        batcher.ask_connected(u, v)
        pending.append(t_arr)
        if len(pending) >= args.micro_batch:
            flush_window()
    flush_window()
    elapsed = time.perf_counter() - t_start
    stop_writer.set()
    for t in threads:
        t.join(timeout=10.0)

    s = hist.summary() or {}
    snap = obs.metrics_snapshot()
    n_dropped = int(snap["counters"].get("loadgen.dropped", 0))
    n_timeout = int(snap["counters"].get("loadgen.timeout", 0))
    offered = len(offs)
    achieved_qps = answered / elapsed if elapsed > 0 else 0.0
    drop_frac = n_dropped / offered if offered else 0.0

    p50_ms = float(s.get("p50", 0.0)) * 1e3
    p99_ms = float(s.get("p99", 0.0)) * 1e3
    failures: list[str] = [f"writer failed: {e}" for e in writer_error]
    if p50_ms > args.slo_p50_ms:
        failures.append(f"p50 {p50_ms:.1f}ms > target {args.slo_p50_ms}ms")
    if p99_ms > args.slo_p99_ms:
        failures.append(f"p99 {p99_ms:.1f}ms > target {args.slo_p99_ms}ms")
    if drop_frac > args.max_drop_frac:
        failures.append(
            f"drop fraction {drop_frac:.3f} > target {args.max_drop_frac}"
        )
    if achieved_qps < args.min_qps_frac * args.qps:
        failures.append(
            f"achieved {achieved_qps:.1f} qps < "
            f"{args.min_qps_frac:.2f} x offered {args.qps}"
        )

    batcher_metrics = {
        k.removeprefix("stream.batcher."): v
        for k, v in snap["counters"].items()
        if k.startswith("stream.batcher.")
    }
    batcher_metrics["queue_depth"] = snap["gauges"].get(
        "stream.batcher.queue_depth", 0
    )
    return {
        "schema": SCHEMA,
        "env": _env(args.device),
        "config": _config(args),
        "offered_qps": args.qps,
        "achieved_qps": achieved_qps,
        "duration_s": elapsed,
        "queries": {
            "offered": offered,
            "answered": answered,
            "dropped": n_dropped,
            "timeouts": n_timeout,
        },
        "latency_ms": {
            "p50": p50_ms,
            "p95": float(s.get("p95", 0.0)) * 1e3,
            "p99": p99_ms,
            "min": float(s.get("min", 0.0)) * 1e3,
            "max": float(s.get("max", 0.0)) * 1e3,
            "mean": (float(s["sum"]) / s["count"] * 1e3) if s.get("count")
            else 0.0,
            "count": int(s.get("count", 0)),
        },
        "writer": {
            "updates": writer_stats["updates"],
            "edges_inserted": writer_stats["edges"],
            "deletes": writer_stats["deletes"],
            "edges_deleted": writer_stats["edges_deleted"],
            "replacements": writer_stats["replacements"],
            "unhealed": writer_stats["unhealed"],
            "snapshot_version": service.snapshot_version(),
        },
        "batcher": batcher_metrics,
        "slo": {
            "targets": {
                "p50_ms": args.slo_p50_ms,
                "p99_ms": args.slo_p99_ms,
                "max_drop_frac": args.max_drop_frac,
                "min_qps_frac": args.min_qps_frac,
            },
            "failures": failures,
            "passed": not failures,
        },
    }


def run_tcp(args) -> dict:
    """Open-loop load over the wire: drive a ``repro_torch.serve`` server with
    pipelined ``serve/v1`` point queries (the server fuses them into
    micro-batches) while a writer connection churns inserts/deletes.

    Same three actors as :func:`run`, network-shaped: the **producer**
    walks the Poisson schedule and pipelines one ``connected`` request
    per arrival — admission is bounded by ``--max-inflight`` outstanding
    futures and arrivals past the bound *drop* (open loop, never
    blocks); a completion callback records end-to-end latency (scheduled
    arrival → response decoded) and in-band rejections (``overloaded`` /
    ``deadline`` from the server's own admission control). The
    **writer** uses a second socket so write frames never head-of-line
    block the pipelined query stream.
    """
    from repro_torch import obs
    from repro_torch.launch.serve_graph import edge_stream
    from repro_torch.serve import ServeClient

    obs.enable("metrics")
    obs.metrics_reset()

    qc = ServeClient(args.target)  # pipelined query connection
    wc = ServeClient(args.target)  # writer connection (own socket)
    try:
        return _run_tcp(args, qc, wc, obs, edge_stream)
    finally:
        qc.close()
        wc.close()


def _run_tcp(args, qc, wc, obs, edge_stream) -> dict:
    status0 = qc.status(check=True)["result"]
    n = int(status0["n"])
    if n != 1 << args.scale:
        raise SystemExit(
            f"server has n={n} but --scale {args.scale} implies "
            f"n={1 << args.scale}; match the server's --scale"
        )
    lo, hi, w = edge_stream(args.scale, args.edge_factor, args.seed)
    warm = int(len(lo) * args.warm_frac)

    hist = obs.histogram("loadgen.e2e_latency_s")
    dropped = obs.counter("loadgen.dropped")
    timeouts = obs.counter("loadgen.timeout")

    rng = np.random.default_rng(args.seed)
    offs = _arrival_schedule(rng, args.qps, args.duration)
    qu = rng.integers(0, n, size=len(offs))
    qv = rng.integers(0, n, size=len(offs))

    inflight = threading.Semaphore(args.max_inflight)
    done = threading.Event()
    lock = threading.Lock()
    stats = {"answered": 0, "rejected": 0, "errors": 0, "max_version": -1}
    outstanding = [0]

    def on_response(fut, t_arr: float) -> None:
        t_now = time.perf_counter()
        inflight.release()
        with lock:
            outstanding[0] -= 1
            if outstanding[0] == 0:
                done.set()
            try:
                resp = fut.result()
            except Exception:
                stats["errors"] += 1
                return
            if resp.get("ok"):
                stats["answered"] += 1
                stats["max_version"] = max(
                    stats["max_version"], resp.get("snapshot_version", -1)
                )
                lat = t_now - t_arr
                hist.observe(lat)
                if lat > args.timeout_ms / 1e3:
                    timeouts.inc()
            else:
                # the server's admission control said no — that's a drop
                # from the SLO's point of view, tracked separately
                stats["rejected"] += 1
                code = (resp.get("error") or {}).get("code", "unknown")
                obs.counter(f"loadgen.rejected.{code}").inc()

    stop_writer = threading.Event()
    writer_stats = {
        "updates": 0, "edges": 0, "deletes": 0, "edges_deleted": 0,
        "replacements": 0, "unhealed": 0, "write_rejected": 0,
    }

    def writer() -> None:
        pos = warm
        interval = args.writer_interval_ms / 1e3
        wrng = np.random.default_rng(args.seed + 1)
        while not stop_writer.is_set():
            try:
                if args.delete_frac > 0 and wrng.random() < args.delete_frac:
                    at = int(wrng.integers(0, max(1, pos - args.writer_batch)))
                    end = min(at + max(1, args.writer_batch // 4), pos)
                    resp = wc.delete(lo[at:end], hi[at:end])
                    if resp.get("ok"):
                        r = resp["result"]
                        writer_stats["deletes"] += 1
                        writer_stats["edges_deleted"] += end - at
                        writer_stats["replacements"] += r["n_replacements"]
                        writer_stats["unhealed"] = r["n_unhealed_new"]
                    else:
                        writer_stats["write_rejected"] += 1
                else:
                    if pos >= len(lo):
                        pos = warm  # wrap; duplicate inserts are MSF no-ops
                    end = min(pos + args.writer_batch, len(lo))
                    resp = wc.insert(lo[pos:end], hi[pos:end], w[pos:end])
                    if resp.get("ok"):
                        writer_stats["updates"] += 1
                        writer_stats["edges"] += end - pos
                        pos = end
                    else:
                        writer_stats["write_rejected"] += 1
            except (ConnectionError, OSError):
                return  # server went away; the SLO gate will say so
            stop_writer.wait(interval)

    t_start = time.perf_counter()
    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    for i, off in enumerate(offs):
        lag = (t_start + off) - time.perf_counter()
        if lag > 0:
            time.sleep(lag)
        if not inflight.acquire(blocking=False):
            dropped.inc()  # admission bound hit: open-loop drop
            continue
        t_arr = t_start + off
        with lock:
            outstanding[0] += 1
            done.clear()
        try:
            fut = qc.submit("connected", u=[int(qu[i])], v=[int(qv[i])],
                            deadline_ms=args.timeout_ms)
        except (ConnectionError, OSError):
            inflight.release()
            with lock:
                outstanding[0] -= 1
                stats["errors"] += 1
            break
        fut.add_done_callback(lambda f, t=t_arr: on_response(f, t))
    # drain the pipeline: every submitted query gets its callback
    with lock:
        all_done = outstanding[0] == 0
    if not all_done:
        done.wait(timeout=max(10.0, 4 * args.timeout_ms / 1e3))
    elapsed = time.perf_counter() - t_start
    stop_writer.set()
    wt.join(timeout=10.0)

    try:
        server_status = qc.status(check=True)["result"]
        server_metrics = qc.metrics(check=True)["result"]["metrics"]
    except Exception:
        server_status, server_metrics = {}, {}

    s = hist.summary() or {}
    snap = obs.metrics_snapshot()
    n_dropped = int(snap["counters"].get("loadgen.dropped", 0))
    n_timeout = int(snap["counters"].get("loadgen.timeout", 0))
    offered = len(offs)
    answered = stats["answered"]
    achieved_qps = answered / elapsed if elapsed > 0 else 0.0
    # server-side rejections are unanswered offered load, same as drops
    drop_frac = ((n_dropped + stats["rejected"] + stats["errors"]) / offered
                 if offered else 0.0)

    p50_ms = float(s.get("p50", 0.0)) * 1e3
    p99_ms = float(s.get("p99", 0.0)) * 1e3
    failures: list[str] = []
    if answered == 0:
        failures.append("no queries answered")
    if p50_ms > args.slo_p50_ms:
        failures.append(f"p50 {p50_ms:.1f}ms > target {args.slo_p50_ms}ms")
    if p99_ms > args.slo_p99_ms:
        failures.append(f"p99 {p99_ms:.1f}ms > target {args.slo_p99_ms}ms")
    if drop_frac > args.max_drop_frac:
        failures.append(
            f"drop fraction {drop_frac:.3f} > target {args.max_drop_frac}"
        )
    if achieved_qps < args.min_qps_frac * args.qps:
        failures.append(
            f"achieved {achieved_qps:.1f} qps < "
            f"{args.min_qps_frac:.2f} x offered {args.qps}"
        )

    return {
        "schema": SCHEMA,
        "env": _env(args.device),
        "config": _config(args),
        "offered_qps": args.qps,
        "achieved_qps": achieved_qps,
        "duration_s": elapsed,
        "queries": {
            "offered": offered,
            "answered": answered,
            "dropped": n_dropped,
            "rejected": stats["rejected"],
            "errors": stats["errors"],
            "timeouts": n_timeout,
        },
        "latency_ms": {
            "p50": p50_ms,
            "p95": float(s.get("p95", 0.0)) * 1e3,
            "p99": p99_ms,
            "min": float(s.get("min", 0.0)) * 1e3,
            "max": float(s.get("max", 0.0)) * 1e3,
            "mean": (float(s["sum"]) / s["count"] * 1e3) if s.get("count")
            else 0.0,
            "count": int(s.get("count", 0)),
        },
        "writer": {
            "updates": writer_stats["updates"],
            "edges_inserted": writer_stats["edges"],
            "deletes": writer_stats["deletes"],
            "edges_deleted": writer_stats["edges_deleted"],
            "replacements": writer_stats["replacements"],
            "unhealed": writer_stats["unhealed"],
            "write_rejected": writer_stats["write_rejected"],
            "snapshot_version": stats["max_version"],
        },
        "server": {
            "target": args.target,
            "status": server_status,
            "metrics": {
                "counters": {
                    k: v for k, v in server_metrics.get("counters", {}).items()
                    if k.startswith("serve.")
                },
                "histograms": {
                    k: v
                    for k, v in server_metrics.get("histograms", {}).items()
                    if k.startswith("serve.")
                },
            },
        },
        "slo": {
            "targets": {
                "p50_ms": args.slo_p50_ms,
                "p99_ms": args.slo_p99_ms,
                "max_drop_frac": args.max_drop_frac,
                "min_qps_frac": args.min_qps_frac,
            },
            "failures": failures,
            "passed": not failures,
        },
    }


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    report = run_tcp(args) if args.target else run(args)
    lat = report["latency_ms"]
    print(
        f"offered {report['offered_qps']:.0f} qps for "
        f"{report['duration_s']:.1f}s -> achieved "
        f"{report['achieved_qps']:.1f} qps; "
        f"p50={lat['p50']:.1f}ms p95={lat['p95']:.1f}ms "
        f"p99={lat['p99']:.1f}ms "
        f"(answered {report['queries']['answered']}, "
        f"dropped {report['queries']['dropped']}, "
        f"timeouts {report['queries']['timeouts']})"
    )
    print(
        f"writer: {report['writer']['updates']} updates, "
        f"{report['writer']['edges_inserted']} edges, "
        f"{report['writer']['deletes']} delete rounds "
        f"({report['writer']['edges_deleted']} edges, "
        f"{report['writer']['replacements']} replacements, "
        f"{report['writer']['unhealed']} unhealed), snapshot "
        f"v{report['writer']['snapshot_version']}; "
        + (f"batcher: {report['batcher']}" if "batcher" in report
           else f"server: {report['server']['metrics']['counters']}")
    )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"# slo report written to {args.out}")
    slo = report["slo"]
    if slo["passed"]:
        print("SLO: PASS")
        return 0
    print("SLO: FAIL")
    for msg in slo["failures"]:
        print(f"  {msg}")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
