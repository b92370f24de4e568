"""S3 client: the ObjectStore backed by a real S3-compatible endpoint.

Reference: src/v/cloud_storage_clients/s3_client.{h,cc} over http/ and
cloud_roles/ (sigv4 + short-lived credentials). Speaks the S3 REST
API — PUT/GET/HEAD/DELETE object and ListObjectsV2 with continuation
tokens — over the in-tree HTTP client, signing every request with
SigV4 from a credentials provider that can rotate keys mid-flight
(instance-metadata-style refresh).

Differentially tested against an in-process S3 imposter whose
signature verification is independent of the signer
(tests/s3_imposter.py; the reference tests the same way,
cloud_storage/tests/s3_imposter.{h,cc}).
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Awaitable, Callable, Optional

from .http_client import HttpClient, HttpError
from .object_store import StoreError
from .signature import sign_request


@dataclasses.dataclass
class Credentials:
    access_key: str
    secret_key: str
    expires_at: float | None = None  # monotonic-epoch seconds; None = static


class StaticCredentialsProvider:
    def __init__(self, access_key: str, secret_key: str):
        self._creds = Credentials(access_key, secret_key)

    async def get(self) -> Credentials:
        return self._creds


class RefreshingCredentialsProvider:
    """Short-lived credential refresh (cloud_roles/refresh_credentials):
    `fetch` is the instance-metadata/STS call; credentials refresh
    ahead of expiry with single-flight de-duplication."""

    def __init__(
        self,
        fetch: Callable[[], Awaitable[Credentials]],
        refresh_ahead_s: float = 60.0,
    ):
        self._fetch = fetch
        self._ahead = refresh_ahead_s
        self._creds: Credentials | None = None
        self._lock = asyncio.Lock()

    async def get(self) -> Credentials:
        c = self._creds
        if c is not None and (
            c.expires_at is None or c.expires_at - time.time() > self._ahead
        ):
            return c
        async with self._lock:
            c = self._creds
            if c is not None and (
                c.expires_at is None
                or c.expires_at - time.time() > self._ahead
            ):
                return c
            self._creds = await self._fetch()
            return self._creds


class S3ObjectStore:
    """ObjectStore protocol over S3 (path-style addressing)."""

    def __init__(
        self,
        host: str,
        port: int,
        bucket: str,
        credentials,  # provider with async get() -> Credentials
        region: str = "us-east-1",
        tls: bool = False,
    ):
        self.bucket = bucket
        self.region = region
        self._http = HttpClient(host, port, tls=tls)
        self._creds = credentials

    async def close(self) -> None:
        await self._http.close()

    async def _request(
        self, method: str, path: str, body: bytes = b"", extra=None
    ) -> tuple[int, bytes]:
        creds = await self._creds.get()
        headers = {"host": f"{self._http.host}:{self._http.port}"}
        if extra:
            headers.update(extra)
        signed = sign_request(
            creds.access_key,
            creds.secret_key,
            self.region,
            method,
            path,
            headers,
            body,
        )
        try:
            resp = await self._http.request(method, path, signed, body)
        except (
            OSError,
            EOFError,  # IncompleteReadError: server hung up mid-response
            asyncio.TimeoutError,
            HttpError,  # stale keep-alive, malformed response
        ) as e:
            raise StoreError(f"s3 {method} {path}: {e}") from e
        if resp.status >= 500:
            raise StoreError(f"s3 {method} {path}: HTTP {resp.status}")
        return resp.status, resp.body

    def _key_path(self, key: str) -> str:
        return f"/{self.bucket}/" + urllib.parse.quote(key, safe="/-_.~")

    # -- ObjectStore protocol -----------------------------------------
    async def put(self, key: str, data: bytes) -> None:
        status, body = await self._request("PUT", self._key_path(key), data)
        if status != 200:
            raise StoreError(f"s3 put {key}: HTTP {status}")

    async def get(self, key: str) -> bytes:
        status, body = await self._request("GET", self._key_path(key))
        if status == 404:
            raise StoreError(f"s3 get {key}: not found")
        if status != 200:
            raise StoreError(f"s3 get {key}: HTTP {status}")
        return body

    async def get_range(self, key: str, start: int, end: int) -> bytes:
        """RFC 9110 ranged GET (chunk hydration path; the reference's
        remote_segment chunk API issues the same Range requests). The
        Range header participates in the sigv4 canonical headers."""
        status, body = await self._request(
            "GET",
            self._key_path(key),
            extra={"range": f"bytes={start}-{end - 1}"},
        )
        if status == 404:
            raise StoreError(f"s3 get {key}: not found")
        if status not in (200, 206):
            raise StoreError(f"s3 get {key} range: HTTP {status}")
        if status == 200:
            # server ignored the Range header: slice locally
            return body[start:end]
        return body

    async def exists(self, key: str) -> bool:
        status, _ = await self._request("HEAD", self._key_path(key))
        if status == 200:
            return True
        if status == 404:
            return False
        raise StoreError(f"s3 head {key}: HTTP {status}")

    async def list(self, prefix: str) -> list[str]:
        out: list[str] = []
        token: Optional[str] = None
        while True:
            q = "list-type=2&prefix=" + urllib.parse.quote(prefix, safe="")
            if token:
                q += "&continuation-token=" + urllib.parse.quote(token, safe="")
            status, body = await self._request("GET", f"/{self.bucket}?{q}")
            if status != 200:
                raise StoreError(f"s3 list {prefix}: HTTP {status}")
            ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
            root = ET.fromstring(body)
            for c in root.findall(f"{ns}Contents/{ns}Key") or root.findall(
                "Contents/Key"
            ):
                out.append(c.text or "")
            trunc = root.findtext(f"{ns}IsTruncated") or root.findtext(
                "IsTruncated"
            )
            token = root.findtext(
                f"{ns}NextContinuationToken"
            ) or root.findtext("NextContinuationToken")
            if trunc != "true" or not token:
                return out

    async def delete(self, key: str) -> None:
        status, _ = await self._request("DELETE", self._key_path(key))
        if status not in (200, 204, 404):
            raise StoreError(f"s3 delete {key}: HTTP {status}")
