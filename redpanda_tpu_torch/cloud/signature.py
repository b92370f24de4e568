"""AWS Signature Version 4 request signing + verification.

Reference: src/v/cloud_roles/signature.{h,cc} (gnutls HMAC there;
stdlib hmac/hashlib here). `sign_request` produces the Authorization
header for the S3 client; `verify_request` re-derives it server-side
— used by the in-process S3 imposter so tests prove the signature
math against an independent consumer, not just round-trip.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse

_ALGO = "AWS4-HMAC-SHA256"


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def amz_date(now: datetime.datetime | None = None) -> str:
    now = now or datetime.datetime.now(datetime.timezone.utc)
    return now.strftime("%Y%m%dT%H%M%SZ")


def _canonical_query(query: str) -> str:
    if not query:
        return ""
    pairs = []
    for part in query.split("&"):
        if not part:
            continue
        k, _, v = part.partition("=")
        pairs.append(
            (
                urllib.parse.quote(urllib.parse.unquote(k), safe="-_.~"),
                urllib.parse.quote(urllib.parse.unquote(v), safe="-_.~"),
            )
        )
    return "&".join(f"{k}={v}" for k, v in sorted(pairs))


def _signature(
    secret_key: str,
    region: str,
    service: str,
    method: str,
    uri: str,
    query: str,
    signed_headers: list[tuple[str, str]],
    payload_hash: str,
    date: str,
) -> tuple[str, str]:
    """(signature, signed_header_names). signed_headers must include
    host and x-amz-date, lowercase names, sorted."""
    day = date[:8]
    canonical_headers = "".join(f"{k}:{v}\n" for k, v in signed_headers)
    names = ";".join(k for k, _ in signed_headers)
    # S3 canonical URI = the path AS SENT (already percent-encoded
    # once by the caller); re-encoding here would turn %20 into %2520
    # and real S3 would answer SignatureDoesNotMatch
    canonical = "\n".join(
        [
            method,
            uri,
            _canonical_query(query),
            canonical_headers,
            names,
            payload_hash,
        ]
    )
    scope = f"{day}/{region}/{service}/aws4_request"
    to_sign = "\n".join([_ALGO, date, scope, _sha256(canonical.encode())])
    k = _hmac(("AWS4" + secret_key).encode(), day)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    return hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest(), names


def sign_request(
    access_key: str,
    secret_key: str,
    region: str,
    method: str,
    path: str,
    headers: dict[str, str],
    body: bytes,
    service: str = "s3",
    date: str | None = None,
) -> dict[str, str]:
    """Returns `headers` plus x-amz-date, x-amz-content-sha256 and
    Authorization (the S3 client entry point)."""
    date = date or amz_date()
    uri, _, query = path.partition("?")
    payload_hash = _sha256(body)
    out = dict(headers)
    out["x-amz-date"] = date
    out["x-amz-content-sha256"] = payload_hash
    signed = sorted(
        (k.lower(), " ".join(v.split()))
        for k, v in out.items()
        if k.lower() in ("host", "content-type", "range")
        or k.lower().startswith("x-amz-")
    )
    sig, names = _signature(
        secret_key, region, service, method, uri, query, signed,
        payload_hash, date,
    )
    day = date[:8]
    out["authorization"] = (
        f"{_ALGO} Credential={access_key}/{day}/{region}/{service}/"
        f"aws4_request, SignedHeaders={names}, Signature={sig}"
    )
    return out


def verify_request(
    secret_for_key,  # access_key -> secret | None
    method: str,
    path: str,
    headers: dict[str, str],
    body: bytes,
    clock_skew_s: int = 900,
) -> str | None:
    """Server-side verification (the imposter): returns the access key
    on success, None on any mismatch."""
    auth = headers.get("authorization", "")
    if not auth.startswith(_ALGO):
        return None
    try:
        fields = dict(
            f.strip().split("=", 1) for f in auth[len(_ALGO) :].split(",")
        )
        cred = fields["Credential"].split("/")
        access_key, day, region, service = cred[0], cred[1], cred[2], cred[3]
        names = fields["SignedHeaders"].split(";")
        want_sig = fields["Signature"]
    except (KeyError, IndexError, ValueError):
        return None
    secret = secret_for_key(access_key)
    if secret is None:
        return None
    date = headers.get("x-amz-date", "")
    if not date.startswith(day):
        return None
    # freshness: a captured signed request must not verify forever
    try:
        when = datetime.datetime.strptime(date, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=datetime.timezone.utc
        )
    except ValueError:
        return None
    now = datetime.datetime.now(datetime.timezone.utc)
    if abs((now - when).total_seconds()) > clock_skew_s:
        return None
    # payload must match its declared hash
    if headers.get("x-amz-content-sha256") != _sha256(body):
        return None
    uri, _, query = path.partition("?")
    signed = [(n, " ".join(headers.get(n, "").split())) for n in sorted(names)]
    sig, _ = _signature(
        secret, region, service, method, uri, query, signed,
        _sha256(body), date,
    )
    if not hmac.compare_digest(sig, want_sig):
        return None
    return access_key
