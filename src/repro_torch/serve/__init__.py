"""Network serving tier over the port's stream engine (counterpart of
``repro.serve``, DESIGN.md §13).

``repro_torch.serve`` turns a ``SolveSpec(mode="stream")`` plan into a TCP
service: an asyncio server that fuses concurrent point queries into
single device batches (one published snapshot per batch, its version
stamped on every response) while one writer task applies
inserts/deletes — the network-facing form of the single-writer /
snapshot-reader architecture the stream engine already enforces
in-process.

    from repro_torch import serve
    handle = serve.start_in_thread(plan, serve.ServeConfig(port=0))
    with serve.ServeClient(handle.address) as c:
        c.connected([0], [1])
    handle.drain()

Ships: :mod:`~repro_torch.serve.protocol` (the ``serve/v1`` wire codec, frames
byte-identical to the reference's), :mod:`~repro_torch.serve.server`
(:class:`MSFServer`), and :mod:`~repro_torch.serve.client`
(:class:`ServeClient`, the pipelined client).
"""
from repro_torch.serve.client import ServeClient, ServeError, parse_target
from repro_torch.serve.protocol import (
    SCHEMA,
    FrameDecoder,
    ProtocolError,
    decode_payload,
    encode_frame,
    error_response,
    response,
    validate_request,
)
from repro_torch.serve.server import (
    MSFServer,
    ServeConfig,
    ServerHandle,
    serve_forever,
    start_in_thread,
)

__all__ = [
    "SCHEMA",
    "FrameDecoder",
    "MSFServer",
    "ProtocolError",
    "ServeClient",
    "ServeConfig",
    "ServeError",
    "ServerHandle",
    "decode_payload",
    "encode_frame",
    "error_response",
    "parse_target",
    "response",
    "serve_forever",
    "start_in_thread",
    "validate_request",
]
