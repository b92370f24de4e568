"""Cross-process trace propagation for internal RPC.

Raft envelopes are never modified: adding trace fields inline would
invalidate the byte-splice caches and raw-offset unpacks on the
replication hot path (raft/service.py heartbeat prefix cache, the
native AppendEntries gate). Instead a traced call is wrapped at the
transport: the frame's method id becomes `TRACED_CALL` and the payload
becomes `TraceCtx.encode() + inner_payload`. `Dispatcher.dispatch`
unwraps it BEFORE the service handler runs, so every handler — and
every byte-splice consumer — sees the exact same payload bytes as an
untraced call.

Only `TcpTransport` wraps (and only when a span is actually open —
`trace.propagation_ctx()` returns None otherwise, making the untraced
path zero-cost). The in-process loopback never wraps: contextvars
propagate naturally there, and NemesisNet fault rules key on the real
method id."""

from __future__ import annotations

import os
from typing import Optional

from ..utils.iobuf import IOBufParser
from ..utils.serde import Envelope, string, u32, u64

# wrapper method id, outside every service id range ("TRC" in LE hex)
TRACED_CALL = 0x00545243

# process-local origin stamped into outgoing contexts; the broker sets
# "node<N>" at startup, otherwise the pid identifies the process
_origin = f"pid{os.getpid()}"


def set_local_origin(origin: str) -> None:
    global _origin
    _origin = origin


def local_origin() -> str:
    return _origin


class TraceCtx(Envelope):
    SERDE_FIELDS = [
        ("trace_id", u64),
        ("span_id", u64),
        ("method", u32),  # the wrapped (real) method id
        ("origin", string),
    ]


def wrap(method_id: int, payload: bytes) -> tuple[int, bytes]:
    """(method_id, payload) -> possibly (TRACED_CALL, ctx + payload).
    Identity when tracing is off or no span is open."""
    from ..observability import trace

    ctx = trace.propagation_ctx()
    if ctx is None:
        return method_id, payload
    trace_id, span_id = ctx
    head = TraceCtx(
        trace_id=trace_id,
        span_id=span_id,
        method=method_id,
        origin=_origin,
    ).encode()
    return TRACED_CALL, head + payload


def unwrap(payload: bytes) -> tuple[TraceCtx, bytes]:
    """Split a TRACED_CALL payload back into (ctx, inner_payload).
    TraceCtx.decode consumes exactly its envelope bytes, so the inner
    payload slice is byte-identical to the sender's original."""
    p = IOBufParser(payload)
    ctx = TraceCtx.decode(p)
    return ctx, payload[p.pos():]
