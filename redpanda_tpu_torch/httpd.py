"""Minimal asyncio HTTP/1.1 server base.

Reference analog: the seastar httpd wrapper every HTTP-facing service
shares (src/v/pandaproxy/server.h, redpanda/admin_server.h both sit on
seastar::httpd). One dependency-free implementation here backs the
admin API, the REST proxy, and the schema registry: regex routing,
JSON bodies, keep-alive, and uniform error payloads.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

logger = logging.getLogger("httpd")

_MAX_BODY = 4 << 20

_REASONS = {
    200: "OK",
    204: "No Content",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    409: "Conflict",
    422: "Unprocessable Entity",
    500: "Internal Server Error",
    503: "Service Unavailable",
}


class HttpError(Exception):
    def __init__(self, status: int, message: str, error_code: int | None = None):
        super().__init__(message)
        self.status = status
        self.message = message
        # schema-registry style payloads carry a numeric error_code
        self.error_code = error_code if error_code is not None else status


class HttpServer:
    """Subclasses call route() (usually from _install_routes) and get a
    full keep-alive HTTP server. Handlers are
    `async handler(match, query, body) -> dict | list | str | bytes | None`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._routes: list[tuple[str, re.Pattern, Callable]] = []
        self._install_routes()

    def _install_routes(self) -> None:  # pragma: no cover - subclass hook
        pass

    def route(self, method: str, pattern: str, handler: Callable) -> None:
        self._routes.append((method, re.compile(f"^{pattern}$"), handler))

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.close()
            await server.wait_closed()

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    # -- plumbing ------------------------------------------------------
    async def _on_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                try:
                    method, target, _version = line.decode().split(" ", 2)
                except ValueError:
                    return
                headers: dict[str, str] = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()
                try:
                    length = int(headers.get("content-length", "0") or 0)
                except ValueError:
                    length = -1
                if length < 0 or length > _MAX_BODY:
                    bad = b'{"message": "invalid content-length"}'
                    writer.write(
                        b"HTTP/1.1 400 Bad Request\r\n"
                        b"Content-Type: application/json\r\n"
                        b"Content-Length: %d\r\n"
                        b"Connection: close\r\n\r\n%s" % (len(bad), bad)
                    )
                    await writer.drain()
                    return
                body = await reader.readexactly(length) if length else b""
                status, ctype, payload = await self._dispatch(
                    method.upper(), target, body
                )
                reason = _REASONS.get(status, "Unknown")
                head = (
                    f"HTTP/1.1 {status} {reason}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(payload)}\r\n"
                    "Connection: keep-alive\r\n\r\n"
                )
                writer.write(head.encode() + payload)
                await writer.drain()
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            asyncio.CancelledError,
        ):
            pass
        finally:
            writer.close()

    async def _dispatch(
        self, method: str, target: str, body: bytes
    ) -> tuple[int, str, bytes]:
        url = urlparse(target)
        path = url.path
        query = {k: v[-1] for k, v in parse_qs(url.query).items()}
        path_seen = False
        for m, pattern, handler in self._routes:
            match = pattern.match(path)
            if match is None:
                continue
            path_seen = True
            if m != method:
                continue
            try:
                result = await handler(match, query, body)
            except HttpError as e:
                # both keys: the admin API documented "code", the
                # schema-registry convention is "error_code"
                return (
                    e.status,
                    "application/json",
                    json.dumps(
                        {
                            "message": e.message,
                            "error_code": e.error_code,
                            "code": e.error_code,
                        }
                    ).encode(),
                )
            except Exception as e:
                logger.exception("%s %s failed", method, path)
                return (
                    500,
                    "application/json",
                    json.dumps(
                        {"message": str(e), "error_code": 500, "code": 500}
                    ).encode(),
                )
            if result is None:
                return 204, "application/json", b""
            if isinstance(result, (bytes, str)):
                data = result.encode() if isinstance(result, str) else result
                return 200, "text/plain; version=0.0.4", data
            return 200, "application/json", json.dumps(result).encode()
        if path_seen:
            return (
                405,
                "application/json",
                b'{"message": "method not allowed", "error_code": 405}',
            )
        return 404, "application/json", b'{"message": "not found", "error_code": 404}'

    @staticmethod
    def json_body(body: bytes) -> dict:
        if not body:
            return {}
        try:
            out = json.loads(body)
        except json.JSONDecodeError as e:
            raise HttpError(400, f"invalid json: {e}") from None
        if not isinstance(out, dict):
            raise HttpError(400, "body must be a json object")
        return out
