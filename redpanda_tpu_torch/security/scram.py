"""SCRAM-SHA-256 / SCRAM-SHA-512 server-side authentication (RFC 5802).

Reference: src/v/security/scram_algorithm.{h,cc} and
scram_credential.h — the server stores only (salt, iterations,
StoredKey = H(ClientKey), ServerKey); the client proves possession of
ClientKey without the password ever crossing the wire, and the server
proves possession of ServerKey back.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import hmac
import os
import secrets

from ..utils import serde

MECHANISMS = ("SCRAM-SHA-256", "SCRAM-SHA-512")

_HASHES = {
    "SCRAM-SHA-256": hashlib.sha256,
    "SCRAM-SHA-512": hashlib.sha512,
}

DEFAULT_ITERATIONS = 4096


@dataclasses.dataclass(slots=True)
class ScramCredential:
    mechanism: str
    salt: bytes
    iterations: int
    stored_key: bytes
    server_key: bytes


class _CredentialE(serde.Envelope):
    SERDE_FIELDS = [
        ("mechanism", serde.string),
        ("salt", serde.bytes_t),
        ("iterations", serde.i32),
        ("stored_key", serde.bytes_t),
        ("server_key", serde.bytes_t),
    ]


def make_credential(
    password: str,
    mechanism: str = "SCRAM-SHA-256",
    iterations: int = DEFAULT_ITERATIONS,
    salt: bytes | None = None,
) -> ScramCredential:
    h = _HASHES[mechanism]
    salt = salt if salt is not None else os.urandom(16)
    salted = hashlib.pbkdf2_hmac(
        h().name, password.encode(), salt, iterations
    )
    client_key = hmac.new(salted, b"Client Key", h).digest()
    stored_key = h(client_key).digest()
    server_key = hmac.new(salted, b"Server Key", h).digest()
    return ScramCredential(mechanism, salt, iterations, stored_key, server_key)


def encode_credential(c: ScramCredential) -> bytes:
    return _CredentialE(
        mechanism=c.mechanism,
        salt=c.salt,
        iterations=c.iterations,
        stored_key=c.stored_key,
        server_key=c.server_key,
    ).encode()


def decode_credential(raw: bytes) -> ScramCredential:
    e = _CredentialE.decode(raw)
    return ScramCredential(
        e.mechanism, e.salt, int(e.iterations), e.stored_key, e.server_key
    )


class CredentialStore:
    """username -> per-mechanism credentials (security/credential_store.h)."""

    def __init__(self) -> None:
        self._users: dict[str, dict[str, ScramCredential]] = {}

    def put(self, user: str, cred: ScramCredential) -> None:
        self._users.setdefault(user, {})[cred.mechanism] = cred

    def remove(self, user: str) -> None:
        self._users.pop(user, None)

    def get(self, user: str, mechanism: str) -> ScramCredential | None:
        return self._users.get(user, {}).get(mechanism)

    def contains(self, user: str) -> bool:
        return user in self._users

    def users(self) -> list[str]:
        return sorted(self._users)


class ScramError(Exception):
    pass


def _parse_attrs(msg: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for part in msg.split(","):
        if len(part) >= 2 and part[1] == "=":
            out[part[0]] = part[2:]
    return out


class ScramServerExchange:
    """One connection's SCRAM exchange: client-first -> server-first ->
    client-final -> server-final (scram_algorithm.h handle_*)."""

    def __init__(self, store: CredentialStore, mechanism: str):
        if mechanism not in _HASHES:
            raise ScramError(f"unsupported mechanism {mechanism}")
        self._store = store
        self._mech = mechanism
        self._hash = _HASHES[mechanism]
        self._state = "start"
        self.username: str | None = None
        self._cred: ScramCredential | None = None
        self._nonce = ""
        self._client_first_bare = ""
        self._server_first = ""

    def handle_client_first(self, payload: bytes) -> bytes:
        if self._state != "start":
            raise ScramError("protocol state")
        msg = payload.decode("utf-8")
        # gs2 header: "n,," (no channel binding) then bare message
        if not (msg.startswith("n,") or msg.startswith("y,")):
            raise ScramError("channel binding not supported")
        bare = msg.split(",", 2)[2]
        attrs = _parse_attrs(bare)
        user = attrs.get("n")
        cnonce = attrs.get("r")
        if not user or not cnonce:
            raise ScramError("malformed client-first")
        self.username = user.replace("=2C", ",").replace("=3D", "=")
        self._cred = self._store.get(self.username, self._mech)
        self._client_first_bare = bare
        self._nonce = cnonce + secrets.token_urlsafe(18)
        if self._cred is None:
            # don't leak user existence: answer with a throwaway salt
            # and fail at client-final (scram_algorithm.cc behavior)
            salt, iters = os.urandom(16), DEFAULT_ITERATIONS
        else:
            salt, iters = self._cred.salt, self._cred.iterations
        self._server_first = (
            f"r={self._nonce},s={base64.b64encode(salt).decode()},i={iters}"
        )
        self._state = "sent-first"
        return self._server_first.encode()

    def handle_client_final(self, payload: bytes) -> bytes:
        if self._state != "sent-first":
            raise ScramError("protocol state")
        msg = payload.decode("utf-8")
        attrs = _parse_attrs(msg)
        if attrs.get("r") != self._nonce:
            raise ScramError("nonce mismatch")
        proof_b64 = attrs.get("p")
        if proof_b64 is None:
            raise ScramError("missing proof")
        if self._cred is None:
            raise ScramError("authentication failed")
        without_proof = msg[: msg.rfind(",p=")]
        auth_message = (
            f"{self._client_first_bare},{self._server_first},{without_proof}"
        ).encode()
        client_signature = hmac.new(
            self._cred.stored_key, auth_message, self._hash
        ).digest()
        proof = base64.b64decode(proof_b64)
        client_key = bytes(a ^ b for a, b in zip(proof, client_signature))
        if not hmac.compare_digest(
            self._hash(client_key).digest(), self._cred.stored_key
        ):
            raise ScramError("authentication failed")
        server_signature = hmac.new(
            self._cred.server_key, auth_message, self._hash
        ).digest()
        self._state = "done"
        return f"v={base64.b64encode(server_signature).decode()}".encode()

    @property
    def done(self) -> bool:
        return self._state == "done"

    @property
    def state(self) -> str:
        return self._state


def client_first_message(user: str) -> tuple[str, str]:
    """(message, client_nonce) — test/client helper."""
    nonce = secrets.token_urlsafe(18)
    safe = user.replace("=", "=3D").replace(",", "=2C")
    return f"n,,n={safe},r={nonce}", nonce


def client_final_message(
    password: str,
    mechanism: str,
    client_first: str,
    server_first: bytes,
    client_nonce: str,
) -> tuple[str, bytes]:
    """(client-final message, expected server signature) — the client
    half of the exchange, used by the internal client and tests."""
    h = _HASHES[mechanism]
    attrs = _parse_attrs(server_first.decode())
    nonce, salt, iters = attrs["r"], base64.b64decode(attrs["s"]), int(attrs["i"])
    if not nonce.startswith(client_nonce):
        raise ScramError("server nonce mismatch")
    salted = hashlib.pbkdf2_hmac(h().name, password.encode(), salt, iters)
    client_key = hmac.new(salted, b"Client Key", h).digest()
    stored_key = h(client_key).digest()
    bare = client_first.split(",", 2)[2]
    without_proof = f"c={base64.b64encode(b'n,,').decode()},r={nonce}"
    auth_message = f"{bare},{server_first.decode()},{without_proof}".encode()
    client_signature = hmac.new(stored_key, auth_message, h).digest()
    proof = bytes(a ^ b for a, b in zip(client_key, client_signature))
    server_key = hmac.new(salted, b"Server Key", h).digest()
    server_signature = hmac.new(server_key, auth_message, h).digest()
    final = f"{without_proof},p={base64.b64encode(proof).decode()}"
    return final, server_signature
