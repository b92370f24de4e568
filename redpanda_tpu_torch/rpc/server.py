"""RPC server + service registry (reference: src/v/net/server.h:98,
src/v/rpc/rpc_server.h, service codegen rpc/rpc_compiler.py).

Where the reference generates C++ service stubs from *.json, here a
`Service` subclass declares async handler methods with the `@method(id)`
decorator; the server keeps a flat method_id → handler dispatch table.
Every dispatch consults the failure-probe registry (finjector analog,
finjector/hbadger.h:23-70) so tests can inject delays/errors per method.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, Optional

from ..observability import trace
from ..utils.hbadger import honey_badger
from . import tracectx
from .types import (
    HEADER_SIZE,
    FrameHeader,
    RpcError,
    Status,
    make_frame,
    verify_payload,
    write_frame,
)

logger = logging.getLogger("rpc.server")

Handler = Callable[[bytes], Awaitable[bytes]]


def method(method_id: int):
    """Mark an async service method as an RPC handler."""

    def wrap(fn):
        fn.__rpc_method_id__ = method_id
        return fn

    return wrap


class Service:
    """Base class; service_name used for failure-probe scoping."""

    service_name = "service"

    def rpc_methods(self) -> dict[int, tuple[str, Handler]]:
        out: dict[int, tuple[str, Handler]] = {}
        for name in dir(self):
            fn = getattr(self, name)
            mid = getattr(fn, "__rpc_method_id__", None)
            if mid is not None:
                if mid in out:
                    raise ValueError(f"duplicate method id {mid}")
                out[mid] = (name, fn)
        return out


class Dispatcher:
    """method_id → handler table shared by TCP server and loopback."""

    def __init__(self):
        self._methods: dict[int, tuple[str, str, Handler]] = {}
        # flight recorder for traced-call continuation spans (the
        # broker embedding assigns its own; None = module default)
        self.recorder = None

    def register(self, service: Service) -> None:
        for mid, (name, fn) in service.rpc_methods().items():
            if mid in self._methods:
                raise ValueError(f"method id {mid} already registered")
            self._methods[mid] = (service.service_name, name, fn)

    async def dispatch(self, method_id: int, payload: bytes) -> bytes:
        if method_id == tracectx.TRACED_CALL:
            # unwrap BEFORE the handler: byte-splice consumers (raft
            # prefix caches, native gates) must see the exact payload
            # bytes an untraced peer would have sent
            ctx, payload = tracectx.unwrap(payload)
            token = trace.set_remote_parent(
                ctx.trace_id, ctx.span_id, ctx.origin
            )
            try:
                with trace.span(
                    "rpc.dispatch", recorder=self.recorder, method=ctx.method
                ):
                    return await self._dispatch_inner(ctx.method, payload)
            finally:
                trace.reset_remote_parent(token)
        return await self._dispatch_inner(method_id, payload)

    async def _dispatch_inner(self, method_id: int, payload: bytes) -> bytes:
        entry = self._methods.get(method_id)
        if entry is None:
            raise RpcError(Status.METHOD_NOT_FOUND, f"method {method_id}")
        svc, name, fn = entry
        if honey_badger.active:  # skip a coroutine per dispatch when idle
            await honey_badger.maybe_inject(svc, name)
        return await fn(payload)


class RpcServer:
    """asyncio TCP accept loop (net/server.cc analog). Responses go out
    in completion order, matched by correlation id client-side; each
    request runs as its own task so one slow handler doesn't block the
    connection (the reference gets this from per-request futures)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self.dispatcher = Dispatcher()
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set[asyncio.Task] = set()

    def register(self, service: Service) -> None:
        self.dispatcher.register(service)

    async def start(self) -> None:
        # 2 MiB stream high-water: append_entries/recovery rounds ship
        # ~1 MiB payloads; the 64 KiB default drowns them in
        # pause/resume churn (same fix as the kafka listener)
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, limit=1 << 21
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        # cancel live connection handlers BEFORE wait_closed(): since
        # py3.12 wait_closed() waits for handlers, which otherwise sit
        # in readexactly() until the peer hangs up
        for t in list(self._conn_tasks):
            t.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
            self._conn_tasks.clear()
        server, self._server = self._server, None
        if server is not None:
            await server.wait_closed()

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
        # mirror the client side: response frames are small and must
        # not sit behind Nagle when the peer is a real process
        sock = writer.get_extra_info("socket")
        if sock is not None:
            import socket as _socket

            try:
                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            except OSError:
                pass
        write_lock = asyncio.Lock()
        pending: set[asyncio.Task] = set()
        try:
            while True:
                try:
                    head = await reader.readexactly(HEADER_SIZE)
                except (
                    asyncio.IncompleteReadError,
                    ConnectionResetError,
                    asyncio.CancelledError,
                ):
                    break
                try:
                    hdr = FrameHeader.unpack(head)
                    payload = (
                        await reader.readexactly(hdr.payload_size)
                        if hdr.payload_size
                        else b""
                    )
                    verify_payload(hdr, payload)
                except (RpcError, asyncio.IncompleteReadError) as e:
                    # corrupt frame: we cannot trust the correlation id,
                    # so log and drop the connection cleanly
                    logger.warning("corrupt frame from peer: %s", e)
                    break
                req = asyncio.ensure_future(
                    self._run_one(hdr, payload, writer, write_lock)
                )
                pending.add(req)
                req.add_done_callback(pending.discard)
        finally:
            if task is not None:
                self._conn_tasks.discard(task)
            for t in pending:
                t.cancel()
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def _run_one(
        self,
        hdr: FrameHeader,
        payload: bytes,
        writer: asyncio.StreamWriter,
        write_lock: asyncio.Lock,
    ) -> None:
        try:
            reply = await self.dispatcher.dispatch(hdr.method_id, payload)
            status = Status.OK
        except RpcError as e:
            reply, status = e.message.encode(), e.status
        except Exception as e:  # service error → status frame, keep conn
            logger.exception("handler failure method=%d", hdr.method_id)
            reply, status = str(e).encode(), Status.SERVICE_ERROR
        frame = make_frame(hdr.method_id, hdr.correlation, reply, status=status)
        async with write_lock:
            try:
                write_frame(writer, frame)
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass
