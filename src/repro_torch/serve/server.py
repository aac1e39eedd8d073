"""Asyncio TCP server fronting a ``mode="stream"`` solve plan (counterpart
of ``repro.serve.server``, DESIGN.md §13.2).

Dataflow — admission → fused batch → snapshot pin → response:

- every connection gets one reader coroutine that decodes ``serve/v1``
  frames (:mod:`repro_torch.serve.protocol`) and routes them by op class;
- **query ops** (connected / component_id / component_size) land in one
  *bounded* admission queue (``queue_cap`` query points; a full queue
  answers ``overloaded`` immediately — backpressure, never unbounded
  buffering). The batcher task drains up to ``micro_batch`` points per
  event-loop tick, drops entries whose per-op deadline expired while
  queued (``deadline`` errors), and answers the rest through
  :meth:`QueryService.answer` as **one fused batch pinned to one
  published snapshot** — every response in the batch carries that
  snapshot's ``snapshot_version`` / ``stale`` / ``n_unhealed``. The
  fused device call runs on a dedicated thread so the event loop keeps
  admitting while the card works;
- **write ops** (insert / delete) go to a single-consumer write queue
  applied by *the one writer task* via ``plan.update`` / ``plan.delete``
  on its own thread — the engine keeps its single-writer contract while
  readers serve from the double-buffered snapshots, which is the whole
  point of the snapshot protocol (DESIGN.md §6.3). Oversized insert
  batches are chunked to the engine's ``batch_capacity``;
- **one CUDA stream**: the query thread and the writer thread both touch
  the card, so both issue onto the stream that was current when the
  server was built. A snapshot's labels and sizes are enqueued before the
  snapshot is published, so a query batch pinned to version v, enqueued
  after it acquired v, runs after them on the same stream and never reads
  what the writer is still producing for v+1 (published snapshots are
  never written again);
- **admin ops**: ``status`` is the ``/healthz`` probe (version, weight,
  queue depths, draining flag), ``metrics`` returns the ``repro_torch.obs``
  registry snapshot (query p50/p95/p99 via the ``serve.e2e_latency_s``
  histogram, queue depth gauge, batch occupancy, reservoir counters).

Graceful drain (SIGTERM/SIGINT under :func:`serve_forever`, or
:meth:`MSFServer.drain`): stop accepting connections, answer queued
queries and writes already admitted, refuse new ops with ``draining``,
checkpoint to ``checkpoint_dir`` when configured, close the open
connections, then stop. Ops still
queued after ``drain_timeout_s`` are refused with ``draining``; a query
batch or a write already on its thread is always waited for and
answered (the reference cancels it unanswered). A
checkpointed server warm-starts: construction restores the newest
completed checkpoint and resumes serving at the saved snapshot version
with a bit-identical forest (``repro_torch.stream.persist``; the
checkpoints restore across packages).

Obs surface (metrics mode is enabled at server start): counters
``serve.requests`` / ``serve.queries`` / ``serve.writes`` /
``serve.errors.<code>``, gauge ``serve.queue_depth``, histograms
``serve.e2e_latency_s`` (admission → host-resident answer) and
``serve.batch_occupancy`` (fused points per flush).
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.serve import protocol as P
from repro_torch.stream import persist

#: fused-points-per-flush histogram bucket bounds (powers of two)
_OCCUPANCY_BOUNDS = tuple(float(1 << k) for k in range(15))


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static configuration of one :class:`MSFServer`."""

    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral; read MSFServer.port after start()
    micro_batch: int = 256  # fused query points per batcher flush
    queue_cap: int = 8192  # admission bound in query points
    write_queue_cap: int = 64  # pending write ops before overload
    deadline_ms: float = 1000.0  # default per-query deadline in the queue
    max_payload: int = P.MAX_PAYLOAD
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # writes between autosaves (0 = drain only)
    drain_timeout_s: float = 10.0

    def __post_init__(self):
        if self.micro_batch < 1:
            raise ValueError("micro_batch must be >= 1")
        if self.queue_cap < self.micro_batch:
            raise ValueError("queue_cap must be >= micro_batch")
        if self.write_queue_cap < 1:
            raise ValueError("write_queue_cap must be >= 1")
        if self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0")


class _Conn:
    """Per-connection send side: a writer + an asyncio lock so batcher,
    writer task and the reader's own error responses never interleave
    partial frames on one socket."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.lock = asyncio.Lock()
        self.open = True

    async def send(self, obj: dict, *, max_payload: int) -> None:
        if not self.open:
            return
        try:
            frame = P.encode_frame(obj, max_payload=max_payload)
        except P.ProtocolError:
            # a response we cannot frame (pathological batch): drop it —
            # the client's timeout handles the rest
            obs.counter("serve.errors.response_too_large").inc()
            return
        async with self.lock:
            if not self.open:
                return
            try:
                self.writer.write(frame)
                await self.writer.drain()
            except (ConnectionError, RuntimeError):
                self.open = False


class _PendingQuery(NamedTuple):
    conn: _Conn
    req_id: object
    op: str
    u: np.ndarray
    v: np.ndarray
    deadline: float  # absolute loop time
    t_admit: float


class _PendingWrite(NamedTuple):
    conn: _Conn
    req_id: object
    op: str
    fields: dict


def _use_stream(stream) -> None:
    """Pool-thread initializer: make ``stream`` this thread's current CUDA
    stream (``None``: a CPU engine, nothing to do)."""
    if stream is not None:
        torch.cuda.set_stream(stream)


class MSFServer:
    """One stream plan behind one TCP listener (see module docstring)."""

    def __init__(self, plan, config: ServeConfig = ServeConfig()):
        if not hasattr(plan, "update"):
            raise ValueError(
                "MSFServer needs a stream-mode plan "
                "(repro_torch.solve.plan(n, SolveSpec(mode='stream', ...)))"
            )
        self.plan = plan
        self.config = config
        self.service = plan.service
        self._engine = plan.engine
        self._admission: deque = deque()  # _PendingQuery entries
        self._admitted_points = 0
        self._admit_event: Optional[asyncio.Event] = None
        self._writeq: Optional[asyncio.Queue] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._tasks: list = []
        self._draining = False
        self._stopped: Optional[asyncio.Event] = None
        self._t0 = time.monotonic()
        self._served_queries = 0
        self._served_writes = 0
        self._writes_since_ckpt = 0
        self._inflight = 0  # query batches and writes taken off their queues, unanswered
        self._conns: set = set()  # open connections, closed at the end of a drain
        self.restored_version: Optional[int] = None
        # One thread each: queries fuse into one device call at a time,
        # and the engine's single-writer contract maps to a 1-thread pool.
        # Both threads issue onto one CUDA stream (module docstring).
        dev = self._engine.device
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        self._query_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-query",
            initializer=_use_stream, initargs=(stream,),
        )
        self._write_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-write",
            initializer=_use_stream, initargs=(stream,),
        )

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        obs.enable("metrics")
        if self.config.checkpoint_dir:
            if persist.latest_stream_step(self.config.checkpoint_dir) is not None:
                self.restored_version = persist.restore_stream(
                    self.config.checkpoint_dir, self._engine
                )
        self._admit_event = asyncio.Event()
        self._writeq = asyncio.Queue(maxsize=self.config.write_queue_cap)
        self._stopped = asyncio.Event()
        self._server = await asyncio.start_server(
            self._handle_conn, self.config.host, self.config.port
        )
        # cache: the listener's socket list empties once drain closes it
        self._port = self._server.sockets[0].getsockname()[1]
        self._t0 = time.monotonic()
        self._tasks = [
            asyncio.create_task(self._batch_loop(), name="serve-batcher"),
            asyncio.create_task(self._write_loop(), name="serve-writer"),
        ]

    @property
    def port(self) -> int:
        assert self._server is not None, "server not started"
        return self._port

    @property
    def draining(self) -> bool:
        return self._draining

    async def wait_stopped(self) -> None:
        await self._stopped.wait()

    async def drain(self) -> None:
        """Graceful shutdown: answer what was admitted, refuse the rest,
        checkpoint, stop. Idempotent."""
        if self._draining:
            await self._stopped.wait()
            return
        self._draining = True
        # stop accepting; the open connections stay up until everything
        # admitted is answered (the reference waits here for every client
        # to hang up first, and so never stops while one stays connected)
        self._server.close()
        deadline = time.monotonic() + self.config.drain_timeout_s
        while (self._admission or not self._writeq.empty() or self._inflight) \
                and time.monotonic() < deadline:
            self._admit_event.set()
            await asyncio.sleep(0.01)
        # anything still queued past the timeout is refused, not dropped
        while self._admission:
            q = self._admission.popleft()
            self._admitted_points -= len(q.u)
            await self._error(q.conn, q.req_id, q.op, "draining",
                              "server drained before this query ran")
        while not self._writeq.empty():
            wr = self._writeq.get_nowait()
            await self._error(wr.conn, wr.req_id, wr.op, "draining",
                              "server drained before this write ran")
        # a batch or write already handed to its thread runs to its end
        # whatever the timeout: wait for it and answer it, so no admitted
        # op goes unanswered and no applied write goes unacknowledged
        while self._inflight:
            await asyncio.sleep(0.01)
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            with contextlib.suppress(asyncio.CancelledError):
                await t
        if self.config.checkpoint_dir:
            await asyncio.get_running_loop().run_in_executor(
                self._write_pool,
                lambda: persist.save_stream(
                    self.config.checkpoint_dir, self._engine
                ),
            )
        self._query_pool.shutdown(wait=True)
        self._write_pool.shutdown(wait=True)
        for conn in list(self._conns):
            conn.open = False
            conn.writer.close()
        await self._server.wait_closed()
        self._stopped.set()

    # -- connection handling ----------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        conn = _Conn(writer)
        self._conns.add(conn)
        decoder = P.FrameDecoder(max_payload=self.config.max_payload)
        try:
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    break
                try:
                    items = decoder.feed(data)
                except P.ProtocolError as e:
                    # unrecoverable framing violation: answer, then close
                    obs.counter(f"serve.errors.{e.code}").inc()
                    await conn.send(
                        P.error_response(None, None, e.code, str(e)),
                        max_payload=self.config.max_payload,
                    )
                    break
                for item in items:
                    if isinstance(item, P.ProtocolError):
                        obs.counter(f"serve.errors.{item.code}").inc()
                        await conn.send(
                            P.error_response(None, None, item.code, str(item)),
                            max_payload=self.config.max_payload,
                        )
                        continue
                    await self._route(conn, item)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            conn.open = False
            self._conns.discard(conn)
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    async def _route(self, conn: _Conn, obj: dict) -> None:
        obs.counter("serve.requests").inc()
        req_id = obj.get("id") if isinstance(obj.get("id"), (int, str)) else None
        try:
            op, fields = P.validate_request(obj)
        except P.ProtocolError as e:
            obs.counter(f"serve.errors.{e.code}").inc()
            await conn.send(
                P.error_response(req_id, obj.get("op"), e.code, str(e)),
                max_payload=self.config.max_payload,
            )
            return
        if op in P.ADMIN_OPS:
            await self._answer_admin(conn, req_id, op)
            return
        if self._draining:
            await self._error(conn, req_id, op, "draining",
                              "server is draining; not accepting new ops")
            return
        if op in P.QUERY_OPS:
            await self._admit_query(conn, req_id, op, fields)
        else:
            await self._admit_write(conn, req_id, op, fields)

    async def _error(self, conn: _Conn, req_id, op, code: str,
                     message: str) -> None:
        obs.counter(f"serve.errors.{code}").inc()
        snap = self._engine.snapshots.acquire()
        await conn.send(
            P.error_response(
                req_id, op, code, message,
                snapshot_version=snap.version, stale=snap.stale,
                n_unhealed=snap.n_unhealed,
            ),
            max_payload=self.config.max_payload,
        )

    # -- query lane --------------------------------------------------------

    async def _admit_query(self, conn: _Conn, req_id, op: str,
                           fields: dict) -> None:
        u = np.asarray(fields["u"], np.int64)
        v = np.asarray(fields.get("v", fields["u"]), np.int64)
        k = len(u)
        if k == 0 or k > self.service.max_batch:
            await self._error(
                conn, req_id, op, "bad_request",
                f"query batch must have 1..{self.service.max_batch} points",
            )
            return
        n = self._engine.n
        if u.min() < 0 or v.min() < 0 or max(u.max(), v.max()) >= n:
            await self._error(conn, req_id, op, "bad_request",
                              f"query vertex out of range [0, {n})")
            return
        if self._admitted_points + k > self.config.queue_cap:
            await self._error(conn, req_id, op, "overloaded",
                              "admission queue full; retry with backoff")
            return
        now = time.monotonic()
        deadline_ms = fields.get("deadline_ms", self.config.deadline_ms)
        self._admission.append(_PendingQuery(
            conn, req_id, op, u.astype(np.int32), v.astype(np.int32),
            deadline=now + deadline_ms / 1e3, t_admit=now,
        ))
        self._admitted_points += k
        obs.gauge("serve.queue_depth").set(self._admitted_points)
        self._admit_event.set()

    async def _batch_loop(self) -> None:
        """Micro-batched admission: one fused padded batch per tick."""
        while True:
            await self._admit_event.wait()
            self._admit_event.clear()
            # let same-tick arrivals join this flush before assembling
            await asyncio.sleep(0)
            while self._admission:
                self._inflight += 1
                try:
                    await self._flush()
                finally:
                    self._inflight -= 1

    async def _flush(self) -> None:
        """Take one micro-batch off the admission queue and answer it."""
        cfg = self.config
        batch: list[_PendingQuery] = []
        points = 0
        now = time.monotonic()
        # a flush never passes the service's batch limit (the reference's
        # can, and its batcher task then dies)
        while self._admission and points < cfg.micro_batch and (
                points + len(self._admission[0].u) <= self.service.max_batch):
            q = self._admission.popleft()
            self._admitted_points -= len(q.u)
            if now > q.deadline:
                await self._error(
                    q.conn, q.req_id, q.op, "deadline",
                    "query deadline expired in the admission queue",
                )
                continue
            batch.append(q)
            points += len(q.u)
        obs.gauge("serve.queue_depth").set(self._admitted_points)
        if not batch:
            return
        u = np.concatenate([q.u for q in batch])
        v = np.concatenate([q.v for q in batch])
        obs.histogram(
            "serve.batch_occupancy", _OCCUPANCY_BOUNDS
        ).observe(float(len(u)))
        # the fused device call off the loop: admission continues
        ans = await asyncio.get_running_loop().run_in_executor(
            self._query_pool, self.service.answer, u, v
        )
        t_done = time.monotonic()
        hist = obs.histogram("serve.e2e_latency_s")
        snap = ans.snapshot
        at = 0
        for q in batch:
            k = len(q.u)
            sl = slice(at, at + k)
            at += k
            if q.op == "connected":
                result = {"connected": [bool(x) for x in ans.connected[sl]]}
            elif q.op == "component_id":
                result = {"component": [int(x) for x in ans.component[sl]]}
            else:
                result = {"size": [int(x) for x in ans.size[sl]]}
            self._served_queries += k
            obs.counter("serve.queries").inc(k)
            hist.observe(t_done - q.t_admit)
            await q.conn.send(
                P.response(
                    q.req_id, q.op, result,
                    snapshot_version=snap.version, stale=snap.stale,
                    n_unhealed=snap.n_unhealed,
                ),
                max_payload=cfg.max_payload,
            )

    # -- write lane --------------------------------------------------------

    async def _admit_write(self, conn: _Conn, req_id, op: str,
                           fields: dict) -> None:
        try:
            self._writeq.put_nowait(_PendingWrite(conn, req_id, op, fields))
        except asyncio.QueueFull:
            await self._error(conn, req_id, op, "overloaded",
                              "write queue full; retry with backoff")

    def _apply_write(self, op: str, fields: dict) -> dict:
        """Runs on the single writer thread — the only engine mutator."""
        u = np.asarray(fields["u"], np.int64)
        v = np.asarray(fields["v"], np.int64)
        if op == "insert":
            w = np.asarray(fields["w"], np.float64)
            cap = self._engine.batch_capacity
            n_new = n_drop = 0
            rep = None
            for at in range(0, len(u), cap):
                rep = self.plan.update(u[at:at + cap], v[at:at + cap],
                                       w[at:at + cap])
                n_new += rep.raw.n_new
                n_drop += rep.raw.n_drop
            return {
                "n_edges": int(len(u)),
                "n_new": int(n_new),
                "n_drop": int(n_drop),
                "weight": float(rep.weight) if rep is not None
                else float(self._engine.weight),
                "version": int(self._engine.version),
            }
        rep = self.plan.delete(u, v)
        raw = rep.raw
        return {
            "n_deleted": int(raw.n_deleted),
            "n_missing": int(raw.n_missing),
            "n_replacements": int(raw.n_replacements),
            "n_unhealed_new": int(raw.n_unhealed),
            "weight": float(rep.weight),
            "version": int(self._engine.version),
        }

    async def _write_loop(self) -> None:
        while True:
            wr: _PendingWrite = await self._writeq.get()
            self._inflight += 1
            try:
                await self._serve_write(wr)
            finally:
                self._inflight -= 1

    async def _serve_write(self, wr: _PendingWrite) -> None:
        """Apply one write on the writer thread and acknowledge it."""
        loop = asyncio.get_running_loop()
        cfg = self.config
        try:
            result = await loop.run_in_executor(
                self._write_pool, self._apply_write, wr.op, wr.fields
            )
        except Exception as e:  # engine rejection → in-band error
            await self._error(wr.conn, wr.req_id, wr.op, "internal", str(e))
            return
        self._served_writes += 1
        obs.counter("serve.writes").inc()
        snap = self._engine.snapshots.acquire()
        await wr.conn.send(
            P.response(
                wr.req_id, wr.op, result,
                snapshot_version=snap.version, stale=snap.stale,
                n_unhealed=snap.n_unhealed,
            ),
            max_payload=cfg.max_payload,
        )
        if cfg.checkpoint_dir and cfg.checkpoint_every > 0:
            self._writes_since_ckpt += 1
            if self._writes_since_ckpt >= cfg.checkpoint_every:
                self._writes_since_ckpt = 0
                await loop.run_in_executor(
                    self._write_pool,
                    lambda: persist.save_stream(
                        cfg.checkpoint_dir, self._engine, async_save=True
                    ),
                )

    # -- admin lane --------------------------------------------------------

    async def _answer_admin(self, conn: _Conn, req_id, op: str) -> None:
        snap = self._engine.snapshots.acquire()
        if op == "status":
            result = {
                "status": "draining" if self._draining else "serving",
                "uptime_s": time.monotonic() - self._t0,
                "n": int(self._engine.n),
                "weight": float(snap.weight),
                "n_forest_edges": int(snap.n_forest_edges),
                "n_components": int(snap.n_components),
                "reservoir_size": int(self._engine.reservoir_size),
                "queue_depth": int(self._admitted_points),
                "write_queue_depth": int(self._writeq.qsize()),
                "served_queries": int(self._served_queries),
                "served_writes": int(self._served_writes),
                "restored_version": self.restored_version,
                "checkpoint_dir": self.config.checkpoint_dir,
            }
        else:
            result = {"metrics": obs.metrics_snapshot()}
        await conn.send(
            P.response(
                req_id, op, result,
                snapshot_version=snap.version, stale=snap.stale,
                n_unhealed=snap.n_unhealed,
            ),
            max_payload=self.config.max_payload,
        )


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


async def _serve_until_signalled(plan, config: ServeConfig) -> None:
    import signal

    server = MSFServer(plan, config)
    await server.start()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        with contextlib.suppress(NotImplementedError, RuntimeError):
            loop.add_signal_handler(
                sig, lambda: asyncio.ensure_future(server.drain())
            )
    print(f"# serving tcp://{config.host}:{server.port} "
          f"(micro_batch={config.micro_batch}, queue_cap={config.queue_cap}"
          + (f", restored v{server.restored_version}"
             if server.restored_version is not None else "")
          + ")", flush=True)
    await server.wait_stopped()


def serve_forever(plan, config: ServeConfig) -> None:
    """Run one server until SIGTERM/SIGINT completes the graceful drain
    (the ``repro_torch.launch.serve_graph --serve`` entry)."""
    asyncio.run(_serve_until_signalled(plan, config))


class ServerHandle:
    """A server running on a background thread with its own event loop —
    the in-process harness the tests drive."""

    def __init__(self, server: MSFServer, loop: asyncio.AbstractEventLoop,
                 thread: threading.Thread):
        self.server = server
        self._loop = loop
        self._thread = thread

    @property
    def port(self) -> int:
        return self.server.port

    @property
    def address(self) -> str:
        return f"tcp://{self.server.config.host}:{self.port}"

    def drain(self, timeout: float = 30.0) -> None:
        """Trigger the graceful drain and join the loop thread."""
        fut = asyncio.run_coroutine_threadsafe(self.server.drain(), self._loop)
        fut.result(timeout=timeout)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=timeout)


def start_in_thread(plan, config: ServeConfig = ServeConfig()) -> ServerHandle:
    """Start an :class:`MSFServer` on a dedicated event-loop thread and
    block until it accepts connections; ``handle.drain()`` shuts it down."""
    loop = asyncio.new_event_loop()
    server = MSFServer(plan, config)
    started = threading.Event()
    boot_err: list = []

    def runner():
        asyncio.set_event_loop(loop)

        async def boot():
            try:
                await server.start()
            except Exception as e:  # surface construction failures
                boot_err.append(e)
            finally:
                started.set()

        loop.run_until_complete(boot())
        if not boot_err:
            loop.run_forever()
        loop.close()

    thread = threading.Thread(target=runner, daemon=True,
                              name="serve-loop")
    thread.start()
    started.wait(timeout=30.0)
    if boot_err:
        raise boot_err[0]
    return ServerHandle(server, loop, thread)
