"""Async HTTP/1.1 client over asyncio streams.

Reference: src/v/http/client.{h,cc} — the seastar HTTP client under
cloud_storage_clients. Persistent per-host connection pool with
keep-alive reuse, content-length and chunked transfer decoding, and
bounded response sizes. TLS via the stdlib ssl module when the scheme
is https.
"""

from __future__ import annotations

import asyncio
import ssl as ssl_mod
from typing import Optional

_MAX_RESPONSE = 512 << 20
_MAX_HEADER = 64 << 10


class HttpError(Exception):
    pass


class HttpResponse:
    __slots__ = ("status", "headers", "body")

    def __init__(self, status: int, headers: dict[str, str], body: bytes):
        self.status = status
        self.headers = headers
        self.body = body


class _Conn:
    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer


class HttpClient:
    """One client per endpoint (host, port, tls); connections are
    pooled and reused across requests (client_pool.cc)."""

    def __init__(
        self,
        host: str,
        port: int,
        tls: bool = False,
        pool_size: int = 4,
        timeout_s: float = 30.0,
    ):
        self.host = host
        self.port = port
        self.tls = tls
        self.timeout_s = timeout_s
        self._pool: list[_Conn] = []
        self._pool_size = pool_size

    async def _connect(self) -> _Conn:
        ctx = None
        if self.tls:
            ctx = ssl_mod.create_default_context()
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port, ssl=ctx),
            timeout=self.timeout_s,
        )
        return _Conn(reader, writer)

    async def close(self) -> None:
        for c in self._pool:
            c.writer.close()
            try:
                await c.writer.wait_closed()
            except Exception:
                pass
        self._pool.clear()

    async def request(
        self,
        method: str,
        path: str,
        headers: Optional[dict[str, str]] = None,
        body: bytes = b"",
    ) -> HttpResponse:
        conn = self._pool.pop() if self._pool else await self._connect()
        try:
            resp = await asyncio.wait_for(
                self._do(conn, method, path, headers or {}, body),
                timeout=self.timeout_s,
            )
        except Exception:
            conn.writer.close()
            raise
        if (
            resp.headers.get("connection", "").lower() != "close"
            and len(self._pool) < self._pool_size
        ):
            self._pool.append(conn)
        else:
            conn.writer.close()
        return resp

    async def _do(
        self, conn: _Conn, method: str, path: str, headers: dict, body: bytes
    ) -> HttpResponse:
        out = [f"{method} {path} HTTP/1.1"]
        hdrs = {"host": f"{self.host}:{self.port}", **headers}
        if body or method in ("PUT", "POST"):
            hdrs.setdefault("content-length", str(len(body)))
        for k, v in hdrs.items():
            out.append(f"{k}: {v}")
        out.append("")
        out.append("")
        conn.writer.write("\r\n".join(out).encode() + body)
        await conn.writer.drain()

        status_line = await conn.reader.readline()
        if not status_line:
            raise HttpError("connection closed before status line")
        parts = status_line.decode("latin-1").split(None, 2)
        if len(parts) < 2 or not parts[1].isdigit():
            raise HttpError(f"bad status line {status_line!r}")
        status = int(parts[1])
        resp_headers: dict[str, str] = {}
        total = 0
        while True:
            line = await conn.reader.readline()
            total += len(line)
            if total > _MAX_HEADER:
                raise HttpError("response headers too large")
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode("latin-1").partition(":")
            resp_headers[name.strip().lower()] = value.strip()

        if method == "HEAD":
            # HEAD carries entity headers (content-length of the WOULD-BE
            # body) but no body bytes on the wire
            return HttpResponse(status, resp_headers, b"")

        if resp_headers.get("transfer-encoding", "").lower() == "chunked":
            body_out = bytearray()
            while True:
                size_line = await conn.reader.readline()
                size = int(size_line.strip().split(b";")[0], 16)
                if size > _MAX_RESPONSE or len(body_out) + size > _MAX_RESPONSE:
                    raise HttpError("chunked response too large")
                if size == 0:
                    await conn.reader.readline()  # trailing CRLF
                    break
                body_out += await conn.reader.readexactly(size)
                await conn.reader.readexactly(2)  # chunk CRLF
            return HttpResponse(status, resp_headers, bytes(body_out))

        n = int(resp_headers.get("content-length", "0"))
        if n > _MAX_RESPONSE:
            raise HttpError("response too large")
        data = await conn.reader.readexactly(n) if n else b""
        return HttpResponse(status, resp_headers, data)
