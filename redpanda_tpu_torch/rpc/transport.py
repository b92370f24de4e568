"""RPC client transports (reference: src/v/rpc/transport.{h,cc},
reconnect_transport.{h,cc}, backoff_policy.h).

`TcpTransport` multiplexes concurrent calls over one connection with a
correlation-id → future map and a background reader task.
`ReconnectTransport` wraps any transport factory with exponential-
backoff reconnection. Both satisfy the `Transport` protocol consumed by
raft/cluster clients, as does the in-memory loopback (loopback.py).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from typing import Optional, Protocol

from . import tracectx
from ..utils.tasks import cancel_and_wait
from .types import (
    HEADER_SIZE,
    FrameHeader,
    RpcError,
    Status,
    make_frame,
    verify_payload,
    write_frame,
)

logger = logging.getLogger("rpc.transport")


class Transport(Protocol):
    async def call(
        self, method_id: int, payload: bytes, timeout: float | None = None
    ) -> bytes: ...

    async def close(self) -> None: ...

    def is_connected(self) -> bool: ...


class TcpTransport:
    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._correlation = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._write_lock = asyncio.Lock()

    def is_connected(self) -> bool:
        return self._writer is not None and not self._writer.is_closing()

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, limit=1 << 21
        )
        # request/response RPC on a warm connection: Nagle + delayed
        # ACK turns every small raft frame into a ~40 ms stall once
        # brokers are real processes (mp bench); the reference sets
        # nodelay on all rpc sockets (net/server.cc)
        sock = self._writer.get_extra_info("socket")
        if sock is not None:
            import socket as _socket

            try:
                sock.setsockopt(
                    _socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1
                )
            except OSError:
                pass
        self._reader_task = asyncio.ensure_future(self._read_loop())

    async def _read_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                head = await self._reader.readexactly(HEADER_SIZE)
                hdr = FrameHeader.unpack(head)
                payload = (
                    await self._reader.readexactly(hdr.payload_size)
                    if hdr.payload_size
                    else b""
                )
                verify_payload(hdr, payload)
                fut = self._pending.pop(hdr.correlation, None)
                if fut is not None and not fut.done():
                    if hdr.status == Status.OK:
                        fut.set_result(payload)
                    else:
                        fut.set_exception(
                            RpcError(hdr.status, payload.decode(errors="replace"))
                        )
        except (asyncio.IncompleteReadError, ConnectionResetError, asyncio.CancelledError):
            pass
        except RpcError as e:
            logger.warning("read loop terminated: %s", e)
        finally:
            # mark the transport dead so is_connected() goes False and
            # callers see ConnectionError instead of hanging forever
            if self._writer is not None:
                self._writer.close()
            self._fail_pending(ConnectionError("transport closed"))

    def _fail_pending(self, exc: Exception) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    async def call(
        self, method_id: int, payload: bytes, timeout: float | None = None
    ) -> bytes:
        if not self.is_connected():
            raise ConnectionError("not connected")
        corr = next(self._correlation)
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[corr] = fut
        # cross-process trace propagation: identity unless a span is
        # open (the loopback transport never wraps — contextvars cover
        # in-process delivery and NemesisNet keys on real method ids)
        method_id, payload = tracectx.wrap(method_id, payload)
        frame = make_frame(method_id, corr, payload)
        async with self._write_lock:
            assert self._writer is not None
            write_frame(self._writer, frame)
            await self._writer.drain()
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._pending.pop(corr, None)
            raise RpcError(Status.TIMEOUT, f"method {method_id} timed out")

    async def close(self) -> None:
        reader_task, self._reader_task = self._reader_task, None
        await cancel_and_wait(reader_task)
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass
        self._fail_pending(ConnectionError("transport closed"))


class ReconnectTransport:
    """Exp-backoff reconnect wrapper (rpc/reconnect_transport.{h,cc}).

    `factory` builds a fresh unconnected transport; anything with an
    async `connect()` works (TcpTransport, LoopbackTransport)."""

    def __init__(
        self,
        factory,
        base_backoff_s: float = 0.05,
        max_backoff_s: float = 2.0,
    ):
        self._factory = factory
        self._base = base_backoff_s
        self._max = max_backoff_s
        self._transport = None
        self._fails = 0
        self._next_attempt = 0.0
        self._lock = asyncio.Lock()
        # bumps on every successful (re)connect: consumers that push
        # deltas over this link (metadata dissemination) watch it to
        # detect a peer restart — a new connection means the peer may
        # have lost in-memory state and needs a full re-push
        self.generation = 0

    def is_connected(self) -> bool:
        return self._transport is not None and self._transport.is_connected()

    async def _ensure(self):
        async with self._lock:
            if self.is_connected():
                return self._transport
            if self._transport is not None:  # stale: release its socket
                await self._transport.close()
                self._transport = None
            now = asyncio.get_event_loop().time()
            if now < self._next_attempt:
                raise ConnectionError("reconnect backoff in effect")
            try:
                t = self._factory()
                await t.connect()
            except OSError as e:
                self._fails += 1
                backoff = min(self._max, self._base * (2 ** min(self._fails, 10)))
                self._next_attempt = now + backoff
                raise ConnectionError(f"connect failed: {e}")
            self._fails = 0
            self._transport = t
            self.generation += 1
            return t

    async def call(
        self, method_id: int, payload: bytes, timeout: float | None = None
    ) -> bytes:
        # connected fast path: skip the async lock + reconnect dance
        # (one async CM + lock churn per RPC on the hot append path)
        t = self._transport
        if t is None or not t.is_connected():
            t = await self._ensure()
        try:
            return await t.call(method_id, payload, timeout)
        except ConnectionError:
            await self._drop(t)
            await t.close()
            raise

    async def _drop(self, t) -> None:
        # retire a broken transport under the connect lock, and only if
        # it is still the installed one — a concurrent _ensure() may
        # already have replaced it with a fresh connection that a bare
        # `self._transport = None` would throw away
        async with self._lock:
            if self._transport is t:
                self._transport = None

    async def close(self) -> None:
        t, self._transport = self._transport, None
        if t is not None:
            await t.close()
