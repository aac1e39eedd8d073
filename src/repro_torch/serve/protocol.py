"""Wire protocol of the serving tier — versioned ``serve/v1`` frames
(counterpart of ``repro.serve.protocol``, DESIGN.md §13.1; only ``json``
and ``struct``, copied so that the port imports nothing of ``repro``:
frames are byte-identical).

Framing is length-prefixed binary: a 4-byte big-endian unsigned payload
length followed by that many bytes of UTF-8 JSON. The JSON body keeps the
protocol debuggable (``nc`` + a hex header is a working client) while the
prefix makes message boundaries exact — no sentinel scanning, and a
decoder that never over-reads. One request object per frame, one response
frame per request, ordered per operation class (the server answers query
frames in admission order and write frames in arrival order, but a
pipelined client must match on ``id``, not arrival order, because query
and write lanes drain independently).

Request objects::

    {"op": "connected",      "id": 7, "u": [0, 5], "v": [3, 2],
     "deadline_ms": 250}                      # deadline is optional
    {"op": "component_id",   "id": 8, "u": [0, 5]}
    {"op": "component_size", "id": 9, "u": [0]}
    {"op": "insert", "id": 10, "u": [...], "v": [...], "w": [...]}
    {"op": "delete", "id": 11, "u": [...], "v": [...]}
    {"op": "status",  "id": 12}               # /healthz-style probe
    {"op": "metrics", "id": 13}               # repro_torch.obs snapshot

Every response carries the schema tag, the echoed ``id`` and ``op``, and
the **snapshot coordinates** the answer was computed against — queries
pin one published :class:`~repro_torch.stream.snapshot.Snapshot` per fused
batch, so ``snapshot_version`` / ``stale`` / ``n_unhealed`` let a client
reason about exactly which forest state it observed::

    {"schema": "serve/v1", "id": 7, "op": "connected", "ok": true,
     "result": {"connected": [true, false]},
     "snapshot_version": 42, "stale": false, "n_unhealed": 0}

Failures are in-band (``ok: false`` + ``error.code``), never a dropped
connection, except for framing violations the stream cannot recover from
(an oversized declared length) where the server answers once and closes.

Error codes: ``bad_frame`` (undecodable payload), ``bad_request``
(well-formed JSON, invalid fields), ``unknown_op``, ``too_large``
(declared frame length above the negotiated cap), ``overloaded``
(admission or write queue full — the backpressure signal), ``deadline``
(query expired in the admission queue), ``draining`` (server is in
graceful shutdown), ``internal`` (engine raised; message carries the
exception text).
"""
from __future__ import annotations

import json
import struct
from typing import Iterator, List, Tuple, Union

SCHEMA = "serve/v1"

HEADER = struct.Struct("!I")
HEADER_SIZE = HEADER.size
#: default cap on one frame's JSON payload (requests and responses)
MAX_PAYLOAD = 8 << 20

QUERY_OPS = ("connected", "component_id", "component_size")
WRITE_OPS = ("insert", "delete")
ADMIN_OPS = ("status", "metrics")
OPS = QUERY_OPS + WRITE_OPS + ADMIN_OPS

#: required array fields per op (validated to be same-length int/float lists)
_OP_FIELDS = {
    "connected": ("u", "v"),
    "component_id": ("u",),
    "component_size": ("u",),
    "insert": ("u", "v", "w"),
    "delete": ("u", "v"),
    "status": (),
    "metrics": (),
}


class ProtocolError(ValueError):
    """A malformed frame or request.

    ``code`` is the wire error code; ``recoverable`` says whether the
    byte stream is still frame-aligned after the failure (bad JSON inside
    a correctly-framed payload: yes; an oversized declared length whose
    body we refuse to buffer: no — the server answers and closes).
    """

    def __init__(self, code: str, message: str, *, recoverable: bool = True):
        super().__init__(message)
        self.code = code
        self.recoverable = recoverable


def encode_frame(obj: dict, *, max_payload: int = MAX_PAYLOAD) -> bytes:
    """Serialize one request/response object into a length-prefixed frame."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > max_payload:
        raise ProtocolError(
            "too_large",
            f"frame payload {len(payload)} bytes exceeds cap {max_payload}",
        )
    return HEADER.pack(len(payload)) + payload


def decode_payload(payload: bytes) -> dict:
    """Decode one frame payload into a request/response object."""
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError("bad_frame", f"undecodable frame payload: {e}")
    if not isinstance(obj, dict):
        raise ProtocolError(
            "bad_frame", f"frame payload must be a JSON object, got "
            f"{type(obj).__name__}"
        )
    return obj


class FrameDecoder:
    """Incremental frame decoder over an arbitrary byte-chunk stream.

    ``feed(data)`` returns the objects completed by ``data`` — each entry
    either a decoded ``dict`` or a *recoverable* :class:`ProtocolError`
    (bad JSON inside a well-framed payload: the stream stays aligned, the
    caller answers with ``error.code`` and keeps reading). Unrecoverable
    violations — a declared length above ``max_payload``, which this
    decoder refuses to buffer — raise instead; the connection must close.
    """

    def __init__(self, *, max_payload: int = MAX_PAYLOAD):
        self.max_payload = int(max_payload)
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Union[dict, ProtocolError]]:
        self._buf.extend(data)
        out: List[Union[dict, ProtocolError]] = []
        while True:
            if len(self._buf) < HEADER_SIZE:
                return out
            (length,) = HEADER.unpack_from(self._buf)
            if length > self.max_payload:
                raise ProtocolError(
                    "too_large",
                    f"declared frame length {length} exceeds cap "
                    f"{self.max_payload}",
                    recoverable=False,
                )
            if len(self._buf) < HEADER_SIZE + length:
                return out
            payload = bytes(self._buf[HEADER_SIZE : HEADER_SIZE + length])
            del self._buf[: HEADER_SIZE + length]
            try:
                out.append(decode_payload(payload))
            except ProtocolError as e:
                out.append(e)

    @property
    def pending_bytes(self) -> int:
        """Bytes buffered toward the next (incomplete) frame."""
        return len(self._buf)


def iter_frames(data: bytes, *, max_payload: int = MAX_PAYLOAD) -> Iterator[dict]:
    """Decode a complete byte string of concatenated frames (tests)."""
    dec = FrameDecoder(max_payload=max_payload)
    for item in dec.feed(data):
        if isinstance(item, ProtocolError):
            raise item
        yield item
    if dec.pending_bytes:
        raise ProtocolError(
            "bad_frame", f"{dec.pending_bytes} trailing bytes after the "
            "last complete frame"
        )


def _as_number_list(obj: dict, op: str, field: str) -> list:
    # vertex endpoints must be integers; only weights ('w') take floats
    kinds = (int, float) if field == "w" else (int,)
    val = obj.get(field)
    if not isinstance(val, list) or not all(
        isinstance(x, kinds) and not isinstance(x, bool) for x in val
    ):
        want = "numbers" if field == "w" else "integers"
        raise ProtocolError(
            "bad_request", f"op {op!r} needs {field!r} as a list of {want}"
        )
    return val


def validate_request(obj: dict) -> Tuple[str, dict]:
    """Validate one decoded request object → ``(op, fields)``.

    ``fields`` holds the op's array arguments (plain lists) plus the
    optional ``deadline_ms`` float. Raises :class:`ProtocolError` with
    ``unknown_op`` / ``bad_request`` on anything else.
    """
    op = obj.get("op")
    if not isinstance(op, str):
        raise ProtocolError("bad_request", "request needs a string 'op'")
    if op not in OPS:
        raise ProtocolError(
            "unknown_op", f"unknown op {op!r} (known: {', '.join(OPS)})"
        )
    req_id = obj.get("id")
    if req_id is not None and not isinstance(req_id, (int, str)):
        raise ProtocolError("bad_request", "'id' must be an int or string")
    fields: dict = {}
    lengths = set()
    for field in _OP_FIELDS[op]:
        fields[field] = _as_number_list(obj, op, field)
        lengths.add(len(fields[field]))
    if len(lengths) > 1:
        raise ProtocolError(
            "bad_request", f"op {op!r} array fields must have equal lengths"
        )
    deadline = obj.get("deadline_ms")
    if deadline is not None:
        if not isinstance(deadline, (int, float)) or isinstance(deadline, bool) \
                or deadline <= 0:
            raise ProtocolError(
                "bad_request", "'deadline_ms' must be a positive number"
            )
        fields["deadline_ms"] = float(deadline)
    return op, fields


def response(
    req_id, op: str, result: dict, *,
    snapshot_version: int = -1, stale: bool = False, n_unhealed: int = 0,
) -> dict:
    """A successful ``serve/v1`` response object."""
    return {
        "schema": SCHEMA,
        "id": req_id,
        "op": op,
        "ok": True,
        "result": result,
        "snapshot_version": int(snapshot_version),
        "stale": bool(stale),
        "n_unhealed": int(n_unhealed),
    }


def error_response(
    req_id, op, code: str, message: str, *,
    snapshot_version: int = -1, stale: bool = False, n_unhealed: int = 0,
) -> dict:
    """An in-band ``serve/v1`` failure response object."""
    return {
        "schema": SCHEMA,
        "id": req_id,
        "op": op,
        "ok": False,
        "error": {"code": code, "message": message},
        "snapshot_version": int(snapshot_version),
        "stale": bool(stale),
        "n_unhealed": int(n_unhealed),
    }
