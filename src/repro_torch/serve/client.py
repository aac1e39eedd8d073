"""Pipelined blocking client for the ``serve/v1`` protocol (counterpart
of ``repro.serve.client``, DESIGN.md §13.3).

One socket, many in-flight requests: ``call`` assigns a request id,
frames the request, and parks a ``Future``; a single reader thread
decodes response frames and resolves futures by id. Because the server
answers query ops out of fused micro-batches, a client that pipelines —
sending the next request before the previous answer lands — is what
actually exercises the batching path; the client is thread-safe (a
send lock orders request frames, the reader thread owns the receive
side), so many threads may share one connection.

    with ServeClient("tcp://127.0.0.1:9012") as c:
        c.insert([0, 1], [1, 2], [0.5, 0.25])
        resp = c.connected([0], [2])
        resp["result"]["connected"], resp["snapshot_version"]

Every returned dict is the full wire response (``ok``, ``result`` or
``error``, ``snapshot_version``, ``stale``, ``n_unhealed``). In-band
errors do **not** raise by default — serving-tier callers usually want
to count ``overloaded`` / ``deadline`` rather than crash; pass
``check=True`` to get :class:`ServeError` instead.
"""
from __future__ import annotations

import itertools
import socket
import threading
from concurrent.futures import Future
from typing import Dict, Optional, Sequence

from repro_torch.serve import protocol as P


def parse_target(target: str) -> tuple:
    """``"tcp://host:port"`` → ``(host, port)``; bare ``host:port`` works
    too."""
    if target.startswith("tcp://"):
        target = target[len("tcp://"):]
    host, sep, port = target.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(
            f"target must look like tcp://host:port, got {target!r}"
        )
    return host or "127.0.0.1", int(port)


class ServeError(RuntimeError):
    """An in-band error response, surfaced when ``check=True``."""

    def __init__(self, response: dict):
        err = response.get("error") or {}
        super().__init__(f"{err.get('code')}: {err.get('message')}")
        self.code = err.get("code")
        self.response = response


class ServeClient:
    """Thread-safe pipelined connection to one :class:`MSFServer`."""

    def __init__(self, target: str, *, timeout: float = 30.0):
        self.host, self.port = parse_target(target)
        self.timeout = timeout
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = threading.Lock()
        self._ids = itertools.count(1)
        self._pending: Dict[int, Future] = {}
        self._pending_lock = threading.Lock()
        self._closed = False
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name="serve-client-reader"
        )
        self._reader.start()

    # -- plumbing ----------------------------------------------------------

    def _read_loop(self) -> None:
        decoder = P.FrameDecoder()
        try:
            while True:
                data = self._sock.recv(1 << 16)
                if not data:
                    break
                for item in decoder.feed(data):
                    if isinstance(item, P.ProtocolError):
                        continue  # server never sends malformed frames
                    self._resolve(item)
        except (OSError, P.ProtocolError):
            pass
        finally:
            self._fail_pending(ConnectionError("server connection closed"))

    def _resolve(self, resp: dict) -> None:
        req_id = resp.get("id")
        with self._pending_lock:
            fut = self._pending.pop(req_id, None)
        if fut is not None:
            fut.set_result(resp)
        # id-less responses (framing errors for unparseable requests) are
        # dropped here; submit() futures for them time out at the caller.

    def _fail_pending(self, exc: Exception) -> None:
        with self._pending_lock:
            pending, self._pending = dict(self._pending), {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc)

    # -- request API -------------------------------------------------------

    def submit(self, op: str, **fields) -> Future:
        """Pipeline one request; the Future resolves to the response dict."""
        if self._closed:
            raise ConnectionError("client is closed")
        req_id = next(self._ids)
        req = {"schema": P.SCHEMA, "id": req_id, "op": op, **fields}
        frame = P.encode_frame(req)
        fut: Future = Future()
        with self._pending_lock:
            self._pending[req_id] = fut
        try:
            with self._send_lock:
                self._sock.sendall(frame)
        except OSError:
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise
        return fut

    def call(self, op: str, *, check: bool = False,
             timeout: Optional[float] = None, **fields) -> dict:
        """Send one request and block for its response dict."""
        resp = self.submit(op, **fields).result(
            timeout=self.timeout if timeout is None else timeout
        )
        if check and not resp.get("ok"):
            raise ServeError(resp)
        return resp

    # -- convenience ops ---------------------------------------------------
    # numpy arrays / scalars are welcome: endpoints coerce to python ints
    # (json won't serialize np.int32) and weights to floats.

    @staticmethod
    def _ints(xs: Sequence[int]) -> list:
        return [int(x) for x in xs]

    def connected(self, u: Sequence[int], v: Sequence[int], **kw) -> dict:
        return self.call("connected", u=self._ints(u), v=self._ints(v), **kw)

    def component_id(self, u: Sequence[int], **kw) -> dict:
        return self.call("component_id", u=self._ints(u), **kw)

    def component_size(self, u: Sequence[int], **kw) -> dict:
        return self.call("component_size", u=self._ints(u), **kw)

    def insert(self, u: Sequence[int], v: Sequence[int],
               w: Sequence[float], **kw) -> dict:
        return self.call("insert", u=self._ints(u), v=self._ints(v),
                         w=[float(x) for x in w], **kw)

    def delete(self, u: Sequence[int], v: Sequence[int], **kw) -> dict:
        return self.call("delete", u=self._ints(u), v=self._ints(v), **kw)

    def status(self, **kw) -> dict:
        return self.call("status", **kw)

    def metrics(self, **kw) -> dict:
        return self.call("metrics", **kw)

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._reader.join(timeout=5.0)
        self._fail_pending(ConnectionError("client closed"))

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
