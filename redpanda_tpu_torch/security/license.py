"""Enterprise license validation and feature gating.

License wire format (reference: src/v/security/license.{h,cc}):
``base64(json-data) "." base64(signature)`` where the signature is an
RSA PKCS#1 v1.5 / SHA-256 signature over the *encoded* data section
(license.cc verify_license — the base64 string itself is signed, so the
license file stays printable UTF-8). The data section is a JSON object
``{"version": n, "org": str, "type": 0|1, "expiry": epoch_seconds}``
with no additional properties (license.cc license_data_validator_schema).

Enforcement model (feature_manager / license nag in the reference):
enterprise features may be *configured* without a license, but the
cluster reports them as violations; `LicenseService.violations()`
surfaces the list for the admin API and logs a periodic warning.

The default verification key is the framework's test/vendor key; real
deployments override it via `public_key_pem`. The paired signing key
ships under tests/data/ so the test suite can mint licenses.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import json
import time
from dataclasses import dataclass
from typing import Iterable, Optional

__all__ = [
    "License",
    "LicenseError",
    "LicenseMalformed",
    "LicenseInvalid",
    "LicenseVerificationError",
    "LicenseService",
    "ENTERPRISE_FEATURES",
    "make_license",
    "sign_license",
]


class LicenseError(Exception):
    pass


class LicenseMalformed(LicenseError):
    """Envelope/encoding damage (license_malformed_exception)."""


class LicenseInvalid(LicenseError):
    """Well-formed but unacceptable: bad schema value, expired
    (license_invalid_exception)."""


class LicenseVerificationError(LicenseError):
    """Signature did not verify (license_verifcation_exception)."""


# Enterprise feature set gated by the license (feature_manager's
# enterprise feature report; names follow our config surface).
ENTERPRISE_FEATURES: tuple[str, ...] = (
    "tiered_storage",
    "gssapi",
    "oidc",
    "audit_logging",
    "schema_id_validation",
    "continuous_balancing",
    "fips",
)

FREE_TRIAL = 0
ENTERPRISE = 1

_TYPE_NAMES = {FREE_TRIAL: "free_trial", ENTERPRISE: "enterprise"}

# Default verification key. The matching signing key lives in
# tests/data/license_signing_key.pem — this default is for the test
# suite and demo clusters; production overrides public_key_pem.
DEFAULT_PUBLIC_KEY_PEM = b"""-----BEGIN PUBLIC KEY-----
MIIBIjANBgkqhkiG9w0BAQEFAAOCAQ8AMIIBCgKCAQEA7AvZuTJFM5DIeK/6d6M0
I3jVrqzX35Y/Ca2SJzeRdFjQZJ2clQZyZELFZxqiYu55E33QAW9zjuOthVX9qXci
TF/jW4pGvTZOplDz7nfnrcQNJATzIMo92Ny4jnyZpPFF3IFWTIMSyi4qfGHKzMC6
IPMcLj1RTWIyFWlC9Rvy0ccFmsBnnD16zYsNkU/+VoG8hnEn3NP1+Rj9QnWozAu7
2g3rU0Z/g+/WzQm4leV0yFXMVyCIEOU4i3MRHlqyTnwUWUv9Pzbf1+Az/XCnrGyV
u04RmJj95JkamnmYsLrjesqfsya4B0FraS4W/Ukug9PRpW/acwQHtOyUDJqrjxvi
NwIDAQAB
-----END PUBLIC KEY-----
"""


@dataclass(frozen=True)
class License:
    """Parsed, schema-valid license (security/license.h struct
    license)."""

    format_version: int
    type: int
    organization: str
    expiry: int  # seconds since epoch
    checksum: str  # sha256 hex of the raw license string

    @property
    def type_name(self) -> str:
        return _TYPE_NAMES.get(self.type, "unknown")

    def is_expired(self, now: Optional[float] = None) -> bool:
        return (now if now is not None else time.time()) > self.expiry

    def expires_in(self, now: Optional[float] = None) -> int:
        """Seconds until expiry (license.h expires())."""
        return int(self.expiry - (now if now is not None else time.time()))

    def properties(self) -> dict:
        """Admin-API shape (GET /v1/features/license)."""
        return {
            "format_version": self.format_version,
            "org": self.organization,
            "type": self.type_name,
            "expires": self.expiry,
            "sha256": self.checksum,
        }


def _b64decode_strict(s: str, what: str) -> bytes:
    try:
        return base64.b64decode(s, validate=True)
    except (binascii.Error, ValueError) as e:
        raise LicenseMalformed(f"{what}: invalid base64: {e}") from None


def _verify_signature(
    data_b64: str, signature: bytes, public_key_pem: bytes
) -> None:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding

    key = serialization.load_pem_public_key(public_key_pem)
    try:
        key.verify(
            signature, data_b64.encode(), padding.PKCS1v15(), hashes.SHA256()
        )
    except InvalidSignature:
        raise LicenseVerificationError(
            "license signature verification failed"
        ) from None


def make_license(
    raw_license: str,
    public_key_pem: bytes = DEFAULT_PUBLIC_KEY_PEM,
    now: Optional[float] = None,
    allow_expired: bool = False,
) -> License:
    """Parse + verify + schema-check one license string
    (license.cc make_license). Raises a LicenseError subclass on any
    failure; returns the parsed License otherwise. `allow_expired`
    admits a correctly-signed but expired license — used on config
    replay so a restarted node keeps reporting the expired license
    (expiry is enforced at check time, not load time, there)."""
    raw_license = raw_license.strip()
    dot = raw_license.find(".")
    if dot < 0:
        raise LicenseMalformed("Outer envelope malformed")
    data_b64 = raw_license[:dot]
    signature = _b64decode_strict(raw_license[dot + 1 :], "signature")
    _verify_signature(data_b64, signature, public_key_pem)
    data = _b64decode_strict(data_b64, "data section")
    try:
        doc = json.loads(data)
    except ValueError as e:
        raise LicenseMalformed(f"data section is not JSON: {e}") from None
    if not isinstance(doc, dict):
        raise LicenseMalformed("data section must be a JSON object")
    required = {"version", "org", "type", "expiry"}
    if set(doc) != required:
        raise LicenseMalformed(
            "License data section failed to match schema"
        )
    if not isinstance(doc["version"], int) or isinstance(doc["version"], bool):
        raise LicenseMalformed("version must be a number")
    if not isinstance(doc["org"], str):
        raise LicenseMalformed("org must be a string")
    if not isinstance(doc["type"], int) or isinstance(doc["type"], bool):
        raise LicenseMalformed("type must be a number")
    if not isinstance(doc["expiry"], (int, float)) or isinstance(
        doc["expiry"], bool
    ):
        raise LicenseMalformed("expiry must be a number")
    if doc["version"] < 0:
        raise LicenseInvalid("Invalid format_version, is < 0")
    if doc["org"] == "":
        raise LicenseInvalid("Cannot have empty string for org")
    if doc["type"] not in _TYPE_NAMES:
        raise LicenseInvalid(f"Unknown license_type: {doc['type']}")
    lic = License(
        format_version=int(doc["version"]),
        type=int(doc["type"]),
        organization=doc["org"],
        expiry=int(doc["expiry"]),
        checksum=hashlib.sha256(raw_license.encode()).hexdigest(),
    )
    if lic.is_expired(now) and not allow_expired:
        raise LicenseInvalid("Expiry date behind todays date")
    return lic


def sign_license(
    org: str,
    expiry: int,
    private_key_pem: bytes,
    type: int = ENTERPRISE,
    version: int = 3,
) -> str:
    """Mint a license string (test/tooling helper — the reference's
    vendor-side signer is not public; this mirrors its output shape)."""
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding

    payload = json.dumps(
        {"version": version, "org": org, "type": type, "expiry": expiry},
        separators=(",", ":"),
    ).encode()
    data_b64 = base64.b64encode(payload).decode()
    key = serialization.load_pem_private_key(private_key_pem, password=None)
    sig = key.sign(data_b64.encode(), padding.PKCS1v15(), hashes.SHA256())
    return data_b64 + "." + base64.b64encode(sig).decode()


class LicenseService:
    """Holds the cluster license and reports enterprise-feature
    violations (feature_manager's license state + nagging)."""

    def __init__(self, public_key_pem: bytes = DEFAULT_PUBLIC_KEY_PEM):
        self._public_key_pem = public_key_pem
        self._license: Optional[License] = None

    @property
    def license(self) -> Optional[License]:
        return self._license

    def validate(self, raw_license: str) -> License:
        """Strict parse+verify against this service's key WITHOUT
        installing — the admin PUT gate."""
        return make_license(raw_license, self._public_key_pem)

    def load(self, raw_license: str, allow_expired: bool = False) -> License:
        """Validate and install a license. Raises on invalid input and
        leaves any previously-loaded license in place. Config replay
        passes allow_expired=True so a node restarted after expiry
        still reports the license (as expired) instead of dropping it."""
        lic = make_license(
            raw_license, self._public_key_pem, allow_expired=allow_expired
        )
        self._license = lic
        return lic

    def clear(self) -> None:
        self._license = None

    def has_valid_license(self, now: Optional[float] = None) -> bool:
        return self._license is not None and not self._license.is_expired(now)

    def check(self, feature: str, now: Optional[float] = None) -> bool:
        """True when `feature` may be used without violation — either
        it is not an enterprise feature or a valid license is loaded."""
        if feature not in ENTERPRISE_FEATURES:
            return True
        return self.has_valid_license(now)

    def violations(
        self, enabled_features: Iterable[str], now: Optional[float] = None
    ) -> list[str]:
        """Enterprise features in use without a valid license — the
        admin-API / nag-log payload."""
        if self.has_valid_license(now):
            return []
        return sorted(
            f for f in set(enabled_features) if f in ENTERPRISE_FEATURES
        )

    def status(self, now: Optional[float] = None) -> dict:
        """GET /v1/features/license response shape."""
        if self._license is None:
            return {"loaded": False, "license": None}
        return {
            "loaded": True,
            "license": self._license.properties(),
            "expired": self._license.is_expired(now),
        }
