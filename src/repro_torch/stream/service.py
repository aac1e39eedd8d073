"""Batched connectivity query serving (counterpart of
``repro.stream.service``).

Queries are answered from a published :class:`~repro_torch.stream.snapshot.Snapshot`
— never from the engine's in-flight state — by two gathers on the
snapshot's device (labels of both endpoints, the size of u's component)
and one copy of the three answer columns back to the host per batch.
Nothing is compiled per batch size, so batches are not padded.

Two entry styles:

- :class:`QueryService` — array-in/array-out batched calls (the serving
  hot path);
- :class:`MicroBatcher` — accumulates point queries and answers them all
  in one batch on ``flush()`` (the microbatching layer a request frontend
  would sit on).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.coarsen.engine import next_pow2  # noqa: F401 — re-exported
from repro_torch.stream.snapshot import Snapshot, SnapshotStore


def _answer(parent, comp_size, u, v):
    """(connected[u,v], component_id[u], component_size[u]) as host arrays:
    the gathers run on the labels' device, one copy returns all three."""
    dev = parent.device
    u = torch.as_tensor(u).to(dev).long()
    v = torch.as_tensor(v).to(dev).long()
    pu = parent[u]
    out = torch.stack([(pu == parent[v]).to(torch.int32), pu, comp_size[u]]).cpu().numpy()
    return out[0].astype(bool), out[1], out[2]


class BatchAnswer(NamedTuple):
    """One batch's answers plus the snapshot they were pinned to.

    The serving tier needs the *coordinates* of every answer — which
    published version it reflects, whether that version was stale and how
    many deletions were unhealed. ``snapshot`` is the exact immutable
    :class:`~repro_torch.stream.snapshot.Snapshot` the whole batch was
    answered from (one ``acquire()`` per batch, never per query).
    """

    connected: np.ndarray  # bool [k]
    component: np.ndarray  # int32 [k]: canonical component label of u[i]
    size: np.ndarray  # int32 [k]: component size of u[i]
    snapshot: Snapshot


class QueryService:
    """Answer connectivity queries from the latest published snapshot."""

    def __init__(self, store: SnapshotStore, *, max_batch: int = 1 << 14):
        self.store = store
        self.max_batch = int(max_batch)

    # -- batched query API -------------------------------------------------

    def connected(self, u, v) -> np.ndarray:
        """bool [k]: are u[i] and v[i] in the same component?"""
        conn, _, _, _ = self._run(u, v)
        return conn

    def component_id(self, u) -> np.ndarray:
        """int32 [k]: canonical component label of each u[i]."""
        _, comp, _, _ = self._run(u, u)
        return comp

    def component_size(self, u) -> np.ndarray:
        """int32 [k]: size of the component containing each u[i]."""
        _, _, size, _ = self._run(u, u)
        return size

    def answer(self, u, v) -> BatchAnswer:
        """All three answer columns *and* the pinned snapshot, one batch —
        the serving-tier entry."""
        conn, comp, size, snap = self._run(u, v)
        return BatchAnswer(conn, comp, size, snap)

    def forest_weight(self) -> float:
        return self.store.acquire().weight

    def snapshot_version(self) -> int:
        return self.store.version

    # -- internals ---------------------------------------------------------

    def _run(self, u, v) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Snapshot]:
        # the answers come back to the host inside the span, so it closes
        # on the user-visible latency (what the p50/p95/p99 summary shows)
        with obs.span("stream.query"):
            snap = self.store.acquire()  # one consistent version per batch
            u = np.asarray(u, np.int32)
            v = np.asarray(v, np.int32)
            if u.shape != v.shape or u.ndim != 1:
                raise ValueError("query endpoints must be 1-d arrays of equal length")
            k = len(u)
            if k == 0:
                z = np.zeros(0, np.int32)
                return np.zeros(0, bool), z, z, snap
            if k > self.max_batch:
                raise ValueError(f"query batch {k} exceeds max_batch={self.max_batch}")
            n = snap.parent.shape[0]
            if u.min() < 0 or v.min() < 0 or max(u.max(), v.max()) >= n:
                raise ValueError(f"query vertex out of range [0, {n})")
            conn, comp, size = _answer(snap.parent, snap.comp_size, u, v)
            return conn, comp, size, snap


class MicroBatcher:
    """Accumulate point queries; answer them in one batch.

    ``ask_connected(u, v)`` returns an opaque ticket; ``flush()`` answers
    every queued query against a *single* snapshot version and returns the
    list of results in ticket order. Auto-flushes when the queue reaches
    ``max_queue``; asking again after a flush starts a new window. Results
    of the last ``retain_windows`` flushed windows (default 1 — exactly
    the just-flushed window) stay redeemable via ``result``; tickets from
    windows past the retention horizon raise ``KeyError`` instead of ever
    serving a wrong answer.

    Thread-safe: ``ask_connected`` / ``flush`` / ``result`` may be called
    concurrently from any number of threads (one re-entrant lock guards
    the window state; the batch runs under it, so two racing flushes
    never double-answer a window). A multi-threaded frontend should raise
    ``retain_windows`` so a thread that asked right before another
    thread's flush can still redeem its ticket.

    When ``repro_torch.obs`` metrics mode is on, the batcher reports its
    admission state: ``stream.batcher.queue_depth`` (gauge — pending
    queries in the open window), ``stream.batcher.overflow`` (counter —
    windows force-flushed at ``max_queue``), and ``stream.batcher.flush``
    / ``stream.batcher.flushed_queries`` (counters).
    """

    def __init__(self, service: QueryService, max_queue: int = 4096, *,
                 retain_windows: int = 1):
        if retain_windows < 1:
            raise ValueError("retain_windows must be >= 1")
        self.service = service
        self.max_queue = int(max_queue)
        self.retain_windows = int(retain_windows)
        self._lock = threading.RLock()
        self._window = 0
        self._pairs: List[Tuple[int, int]] = []
        self._results: List[bool] | None = None
        #: window id -> results of already-flushed windows (bounded LRU)
        self._done: "OrderedDict[int, List[bool]]" = OrderedDict()

    def ask_connected(self, u: int, v: int) -> Tuple[int, int]:
        with self._lock:
            if self._results is not None:  # start a new window
                self._window += 1
                self._pairs, self._results = [], None
            self._pairs.append((int(u), int(v)))
            ticket = (self._window, len(self._pairs) - 1)
            if obs.metrics_active():
                obs.gauge("stream.batcher.queue_depth").set(len(self._pairs))
            if len(self._pairs) >= self.max_queue:
                if obs.metrics_active():
                    obs.counter("stream.batcher.overflow").inc()
                self.flush()
            return ticket

    def flush(self) -> List[bool]:
        with self._lock:
            if self._results is not None:
                return self._results
            if not self._pairs:
                self._results = []
            else:
                arr = np.asarray(self._pairs, np.int32)
                conn = self.service.connected(arr[:, 0], arr[:, 1])
                self._results = [bool(x) for x in conn]
            self._done[self._window] = self._results
            while len(self._done) > self.retain_windows:
                self._done.popitem(last=False)
            if obs.metrics_active() and self._results:
                obs.counter("stream.batcher.flush").inc()
                obs.counter("stream.batcher.flushed_queries").inc(len(self._results))
                obs.gauge("stream.batcher.queue_depth").set(0)
            return self._results

    def result(self, ticket: Tuple[int, int]) -> bool:
        """Result for a ticket; raises ``KeyError`` once its window has
        aged past the retention horizon."""
        window, idx = ticket
        with self._lock:
            if window == self._window:
                if self._results is None:
                    self.flush()
                return self._results[idx]
            done = self._done.get(window)
            if done is None:
                raise KeyError(
                    f"ticket from window {window} is stale (current window "
                    f"{self._window}, retaining {self.retain_windows} "
                    f"flushed windows)"
                )
            return done[idx]
