"""OIDC / JWT authentication: SASL OAUTHBEARER for the Kafka listener.

Reference: src/v/security/oidc_service.h, oidc_authenticator.h and
oidc_principal_mapping.h — Redpanda validates OAuth2 bearer JWTs
against the issuer's JWKS and maps a token claim to the Kafka
principal. This rebuild keeps the same verification pipeline
(JWS signature -> temporal claims -> issuer -> audience -> principal
claim) but sources the JWKS from a local file or inline document:
the build environment has zero egress, and production deployments
front the same code with a refresher that pulls
`{issuer}/.well-known/jwks.json` on a timer (oidc_service.cc does the
HTTP fetch; the validation below is the part that must be right).

Supported algorithms: RS256 (RSA PKCS#1 v1.5 + SHA-256) and ES256
(ECDSA P-256 + SHA-256) — the two JOSE algs OIDC providers actually
use. `alg: none` and HMAC algs are rejected outright (the classic
JWT confusion attacks).
"""

from __future__ import annotations

import base64
import dataclasses
import json
import time


class OidcError(Exception):
    pass


def _b64url_decode(s: str | bytes) -> bytes:
    if isinstance(s, str):
        s = s.encode()
    pad = -len(s) % 4
    try:
        return base64.urlsafe_b64decode(s + b"=" * pad)
    except Exception as e:
        raise OidcError(f"bad base64url segment: {e}") from e


def _b64url_uint(s: str) -> int:
    return int.from_bytes(_b64url_decode(s), "big")


@dataclasses.dataclass(slots=True)
class OidcConfig:
    """Validation policy (config analogs: oidc_discovery_url ->
    issuer, oidc_token_audience -> audience, oidc_principal_mapping ->
    principal_claim, oidc_clock_skew -> clock_skew_s)."""

    issuer: str
    audience: str
    jwks: dict  # parsed JWKS document {"keys": [...]}
    principal_claim: str = "sub"
    clock_skew_s: int = 30


class OidcAuthenticator:
    """Validates a compact JWS and returns the mapped principal."""

    def __init__(self, config: OidcConfig):
        self.config = config
        self._keys: dict[str, object] = {}
        keys = config.jwks.get("keys", [])
        for jwk in keys:
            try:
                kid, key = self._load_jwk(jwk)
            except OidcError:
                continue  # skip unusable keys, keep the rest
            self._keys[kid] = key
        if not self._keys:
            raise OidcError("JWKS contains no usable RS256/ES256 keys")

    @staticmethod
    def _load_jwk(jwk: dict) -> tuple[str, object]:
        from cryptography.hazmat.primitives.asymmetric import ec, rsa

        kty = jwk.get("kty")
        kid = jwk.get("kid", "")
        if kty == "RSA":
            if "n" not in jwk or "e" not in jwk:
                raise OidcError("RSA jwk missing n/e")
            pub = rsa.RSAPublicNumbers(
                _b64url_uint(jwk["e"]), _b64url_uint(jwk["n"])
            ).public_key()
            return kid, pub
        if kty == "EC":
            if jwk.get("crv") != "P-256":
                raise OidcError(f"unsupported curve {jwk.get('crv')}")
            pub = ec.EllipticCurvePublicNumbers(
                _b64url_uint(jwk["x"]), _b64url_uint(jwk["y"]), ec.SECP256R1()
            ).public_key()
            return kid, pub
        raise OidcError(f"unsupported kty {kty}")

    # -- verification pipeline ---------------------------------------
    def authenticate(self, token: str) -> str:
        """Full check chain; returns the principal name (without the
        'User:' prefix). Raises OidcError on any failure."""
        return self.authenticate_with_expiry(token)[0]

    def authenticate_with_expiry(self, token: str) -> tuple[str, float]:
        """Like authenticate() but also returns the token's exp (unix
        seconds) so the SASL session can be bounded by it."""
        header, payload = self._verify_signature(token)
        claims = self._decode_claims(payload)
        self._check_temporal(claims)
        self._check_issuer_audience(claims)
        principal = claims.get(self.config.principal_claim)
        if not isinstance(principal, str) or not principal:
            raise OidcError(
                f"claim {self.config.principal_claim!r} missing or not a string"
            )
        return principal, float(claims["exp"])

    def _verify_signature(self, token: str) -> tuple[dict, bytes]:
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import ec, padding, rsa
        from cryptography.hazmat.primitives.asymmetric.utils import (
            encode_dss_signature,
        )

        parts = token.split(".")
        if len(parts) != 3:
            raise OidcError("not a compact JWS (need 3 dot-parts)")
        try:
            header = json.loads(_b64url_decode(parts[0]))
        except (ValueError, OidcError) as e:
            raise OidcError(f"bad JOSE header: {e}") from e
        alg = header.get("alg")
        if alg not in ("RS256", "ES256"):
            # includes 'none' and HS* — reject before any key lookup
            raise OidcError(f"disallowed alg {alg!r}")
        kid = header.get("kid", "")
        key = self._keys.get(kid)
        if key is None and not kid and len(self._keys) == 1:
            key = next(iter(self._keys.values()))  # sole key, no kid
        if key is None:
            raise OidcError(f"no JWKS key for kid {kid!r}")
        signing_input = f"{parts[0]}.{parts[1]}".encode()
        sig = _b64url_decode(parts[2])
        try:
            if alg == "RS256":
                if not isinstance(key, rsa.RSAPublicKey):
                    raise OidcError("alg/key type mismatch")
                key.verify(
                    sig, signing_input, padding.PKCS1v15(), hashes.SHA256()
                )
            else:  # ES256: JOSE raw r||s -> DER
                if not isinstance(key, ec.EllipticCurvePublicKey):
                    raise OidcError("alg/key type mismatch")
                if len(sig) != 64:
                    raise OidcError("bad ES256 signature length")
                der = encode_dss_signature(
                    int.from_bytes(sig[:32], "big"),
                    int.from_bytes(sig[32:], "big"),
                )
                key.verify(der, signing_input, ec.ECDSA(hashes.SHA256()))
        except InvalidSignature:
            raise OidcError("signature verification failed") from None
        return header, _b64url_decode(parts[1])

    @staticmethod
    def _decode_claims(payload: bytes) -> dict:
        try:
            claims = json.loads(payload)
        except ValueError as e:
            raise OidcError(f"bad claims JSON: {e}") from e
        if not isinstance(claims, dict):
            raise OidcError("claims not an object")
        return claims

    def _check_temporal(self, claims: dict) -> None:
        now = time.time()
        skew = self.config.clock_skew_s
        exp = claims.get("exp")
        if not isinstance(exp, (int, float)):
            raise OidcError("exp claim missing")
        if now - skew >= exp:
            raise OidcError("token expired")
        nbf = claims.get("nbf")
        if isinstance(nbf, (int, float)) and now + skew < nbf:
            raise OidcError("token not yet valid")

    def _check_issuer_audience(self, claims: dict) -> None:
        if claims.get("iss") != self.config.issuer:
            raise OidcError(f"issuer mismatch: {claims.get('iss')!r}")
        aud = claims.get("aud")
        auds = aud if isinstance(aud, list) else [aud]
        if self.config.audience not in auds:
            raise OidcError(f"audience mismatch: {aud!r}")


# -- SASL OAUTHBEARER (RFC 7628) ------------------------------------

SASL_MECHANISM = "OAUTHBEARER"


def client_first_message(token: str) -> bytes:
    """OAUTHBEARER initial client response: gs2 header, then the
    auth kv-pair, \\x01-separated (RFC 7628 §3.1)."""
    return b"n,,\x01auth=Bearer " + token.encode() + b"\x01\x01"


def parse_client_first(data: bytes) -> str:
    """Extract the bearer token from the initial client response."""
    try:
        text = data.decode()
    except UnicodeDecodeError as e:
        raise OidcError(f"bad OAUTHBEARER message encoding: {e}") from e
    if "," in text.split("\x01", 1)[0]:
        # gs2 header present (e.g. "n,,"); kv pairs follow the first \x01
        _, _, rest = text.partition("\x01")
    else:
        rest = text
    for kv in rest.split("\x01"):
        if kv.startswith("auth="):
            scheme, _, token = kv[5:].partition(" ")
            if scheme.lower() != "bearer" or not token:
                raise OidcError("auth kv-pair is not a Bearer token")
            return token.strip()
    raise OidcError("no auth kv-pair in OAUTHBEARER message")


class OauthBearerExchange:
    """Server-side single-round SASL exchange, duck-compatible with
    ScramServerExchange (state / done / username / handle_client_first)
    so the kafka connection code treats both mechanisms uniformly."""

    def __init__(self, authenticator: OidcAuthenticator):
        self._auth = authenticator
        self.state = "start"
        self.done = False
        self.username: str | None = None
        self.expires_at: float | None = None  # unix seconds (token exp)

    def handle_client_first(self, data: bytes) -> bytes:
        # state flips only on success: a rejected token leaves the
        # exchange retryable (SCRAM behaves the same on a malformed
        # client-first), instead of wedging the connection in
        # illegal_sasl_state
        token = parse_client_first(data)
        self.username, self.expires_at = self._auth.authenticate_with_expiry(
            token
        )
        self.state = "complete"
        self.done = True
        return b""

    def handle_client_final(self, data: bytes) -> bytes:  # pragma: no cover
        raise OidcError("OAUTHBEARER is a single-round exchange")


# -- test/ops helpers ------------------------------------------------


def jwk_from_public_key(key, kid: str) -> dict:
    """Build a JWKS entry from a cryptography public key (used by
    tests and by ops tooling generating local-issuer configs)."""
    from cryptography.hazmat.primitives.asymmetric import ec, rsa

    def enc_uint(v: int, length: int | None = None) -> str:
        raw = v.to_bytes(length or (v.bit_length() + 7) // 8, "big")
        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()

    if isinstance(key, rsa.RSAPublicKey):
        nums = key.public_numbers()
        return {
            "kty": "RSA",
            "kid": kid,
            "alg": "RS256",
            "use": "sig",
            "n": enc_uint(nums.n),
            "e": enc_uint(nums.e),
        }
    if isinstance(key, ec.EllipticCurvePublicKey):
        nums = key.public_numbers()
        return {
            "kty": "EC",
            "kid": kid,
            "alg": "ES256",
            "use": "sig",
            "crv": "P-256",
            "x": enc_uint(nums.x, 32),
            "y": enc_uint(nums.y, 32),
        }
    raise OidcError(f"unsupported key type {type(key).__name__}")


def sign_jwt(private_key, claims: dict, kid: str, alg: str = "RS256") -> str:
    """Mint a compact JWS (tests / local-issuer tooling)."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec, padding
    from cryptography.hazmat.primitives.asymmetric.utils import (
        decode_dss_signature,
    )

    def enc(d: bytes) -> str:
        return base64.urlsafe_b64encode(d).rstrip(b"=").decode()

    header = {"alg": alg, "typ": "JWT", "kid": kid}
    signing_input = (
        enc(json.dumps(header, separators=(",", ":")).encode())
        + "."
        + enc(json.dumps(claims, separators=(",", ":")).encode())
    )
    if alg == "RS256":
        sig = private_key.sign(
            signing_input.encode(), padding.PKCS1v15(), hashes.SHA256()
        )
    elif alg == "ES256":
        der = private_key.sign(signing_input.encode(), ec.ECDSA(hashes.SHA256()))
        r, s = decode_dss_signature(der)
        sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
    else:
        raise OidcError(f"unsupported signing alg {alg}")
    return signing_input + "." + enc(sig)
