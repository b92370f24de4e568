"""Azure Blob Storage client: the ObjectStore over ABS shared-key auth.

Reference: src/v/cloud_storage_clients/abs_client.{h,cc}. Speaks the
Blob REST API — Put/Get/Head/Delete Blob and List Blobs with marker
pagination — over the in-tree HTTP client, signing every request with
the SharedKey scheme (HMAC-SHA256 over the canonicalized string-to-
sign; `shared_key_signature` is also used by the test imposter to
verify requests server-side, so sign/verify are exercised as a pair
against the documented canonicalization rules).
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import urllib.parse
import xml.etree.ElementTree as ET

from .http_client import HttpClient, HttpError
from .object_store import StoreError

_VERSION = "2021-08-06"


def _rfc1123(now: datetime.datetime | None = None) -> str:
    now = now or datetime.datetime.now(datetime.timezone.utc)
    return now.strftime("%a, %d %b %Y %H:%M:%S GMT")


def shared_key_string_to_sign(
    account: str, method: str, path: str, headers: dict[str, str]
) -> str:
    """The documented SharedKey canonicalization (Storage services
    auth): positional standard headers, then sorted x-ms-* headers,
    then /account/resource with sorted query name:value lines."""
    h = {k.lower(): v for k, v in headers.items()}
    length = h.get("content-length", "")
    if length == "0":
        length = ""  # 2015-02-21+ rule: zero length signs as empty
    positional = [
        method,
        h.get("content-encoding", ""),
        h.get("content-language", ""),
        length,
        h.get("content-md5", ""),
        h.get("content-type", ""),
        "",  # Date: empty because x-ms-date is set
        h.get("if-modified-since", ""),
        h.get("if-match", ""),
        h.get("if-none-match", ""),
        h.get("if-unmodified-since", ""),
        h.get("range", ""),
    ]
    canon_headers = "".join(
        f"{k}:{h[k]}\n" for k in sorted(h) if k.startswith("x-ms-")
    )
    uri, _, query = path.partition("?")
    canon_resource = f"/{account}{uri}"
    if query:
        params: dict[str, list[str]] = {}
        for part in query.split("&"):
            k, _, v = part.partition("=")
            params.setdefault(
                urllib.parse.unquote(k).lower(), []
            ).append(urllib.parse.unquote(v))
        for k in sorted(params):
            canon_resource += f"\n{k}:{','.join(sorted(params[k]))}"
    return "\n".join(positional) + "\n" + canon_headers + canon_resource


def shared_key_signature(
    account: str, key_b64: str, method: str, path: str, headers: dict[str, str]
) -> str:
    sts = shared_key_string_to_sign(account, method, path, headers)
    mac = hmac.new(
        base64.b64decode(key_b64), sts.encode("utf-8"), hashlib.sha256
    )
    return base64.b64encode(mac.digest()).decode()


class AbsObjectStore:
    """ObjectStore protocol over an ABS-compatible endpoint
    (path-style: /container/blob against host:port)."""

    def __init__(
        self,
        host: str,
        port: int,
        account: str,
        shared_key_b64: str,
        container: str,
        tls: bool = False,
    ):
        self.account = account
        self.key = shared_key_b64
        self.container = container
        self._http = HttpClient(host, port, tls=tls)

    async def close(self) -> None:
        await self._http.close()

    async def _request(
        self, method: str, path: str, body: bytes = b"", extra: dict | None = None
    ) -> tuple[int, bytes]:
        headers = {
            "host": f"{self._http.host}:{self._http.port}",
            "x-ms-date": _rfc1123(),
            "x-ms-version": _VERSION,
            "content-length": str(len(body)),
            **(extra or {}),
        }
        sig = shared_key_signature(
            self.account, self.key, method, path, headers
        )
        headers["authorization"] = f"SharedKey {self.account}:{sig}"
        try:
            resp = await self._http.request(method, path, headers, body)
        except (OSError, EOFError, HttpError, TimeoutError) as e:
            raise StoreError(f"abs {method} {path}: {e}") from e
        if resp.status >= 500:
            raise StoreError(f"abs {method} {path}: HTTP {resp.status}")
        return resp.status, resp.body

    def _blob_path(self, key: str) -> str:
        return f"/{self.container}/" + urllib.parse.quote(key, safe="/-_.~")

    # -- ObjectStore protocol -----------------------------------------
    async def put(self, key: str, data: bytes) -> None:
        status, _ = await self._request(
            "PUT",
            self._blob_path(key),
            data,
            extra={"x-ms-blob-type": "BlockBlob"},
        )
        if status not in (200, 201):
            raise StoreError(f"abs put {key}: HTTP {status}")

    async def get(self, key: str) -> bytes:
        status, body = await self._request("GET", self._blob_path(key))
        if status == 404:
            raise StoreError(f"abs get {key}: not found")
        if status != 200:
            raise StoreError(f"abs get {key}: HTTP {status}")
        return body

    async def get_range(self, key: str, start: int, end: int) -> bytes:
        """Ranged blob GET via x-ms-range (chunk hydration path)."""
        status, body = await self._request(
            "GET",
            self._blob_path(key),
            extra={"x-ms-range": f"bytes={start}-{end - 1}"},
        )
        if status == 404:
            raise StoreError(f"abs get {key}: not found")
        if status not in (200, 206):
            raise StoreError(f"abs get {key} range: HTTP {status}")
        if status == 200:
            return body[start:end]
        return body

    async def exists(self, key: str) -> bool:
        status, _ = await self._request("HEAD", self._blob_path(key))
        if status == 200:
            return True
        if status == 404:
            return False
        raise StoreError(f"abs head {key}: HTTP {status}")

    async def list(self, prefix: str) -> list[str]:
        out: list[str] = []
        marker = ""
        while True:
            q = (
                "restype=container&comp=list&prefix="
                + urllib.parse.quote(prefix, safe="")
            )
            if marker:
                q += "&marker=" + urllib.parse.quote(marker, safe="")
            status, body = await self._request(
                "GET", f"/{self.container}?{q}"
            )
            if status != 200:
                raise StoreError(f"abs list {prefix}: HTTP {status}")
            root = ET.fromstring(body)
            for name in root.findall("./Blobs/Blob/Name"):
                out.append(name.text or "")
            marker = root.findtext("NextMarker") or ""
            if not marker:
                return out

    async def delete(self, key: str) -> None:
        status, _ = await self._request("DELETE", self._blob_path(key))
        if status not in (200, 202, 404):
            raise StoreError(f"abs delete {key}: HTTP {status}")
