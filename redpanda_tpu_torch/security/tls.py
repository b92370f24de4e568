"""TLS listener contexts + mTLS principal mapping.

Reference: src/v/security/mtls.{h,cc} (principal mapping rules over
the client certificate DN) and the per-listener TLS config the
reference threads through config::tls_config. Contexts come from the
stdlib ssl module; principal mapping implements the Kafka-style
RULE syntax subset the reference supports:

    RULE:pattern/replacement/[LU]   (first matching rule wins)
    DEFAULT                         (the full DN)

The extracted principal enters authorization exactly like a SASL
identity ("User:<name>"), so ACLs work identically for both
authentication paths.
"""

from __future__ import annotations

import re
import ssl


def server_context(
    cert: str, key: str, ca: str | None = None, require_client_auth: bool = False
) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    if require_client_auth:
        if ca is None:
            raise ValueError("mTLS requires a CA to verify client certs")
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(ca)
    elif ca is not None:
        ctx.verify_mode = ssl.CERT_OPTIONAL
        ctx.load_verify_locations(ca)
    return ctx


def client_context(
    ca: str | None = None,
    cert: str | None = None,
    key: str | None = None,
    check_hostname: bool = True,
) -> ssl.SSLContext:
    """When a CA is given, hostname verification is ON by default so a
    CA-issued cert for host A cannot impersonate host B; pass
    check_hostname=False only for SAN-less test certificates."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if ca is not None:
        ctx.load_verify_locations(ca)
        ctx.check_hostname = check_hostname
    else:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    if cert is not None:
        ctx.load_cert_chain(cert, key)
    return ctx


# -- principal mapping (mtls.cc rules) ---------------------------------
_RULE = re.compile(r"^RULE:(.*?)/(.*?)/([LU]?)$")


def _dn_of(peercert: dict) -> str:
    """RFC2253-ish DN string from ssl.getpeercert()'s subject tuples,
    most-specific first (CN=...,OU=...,O=...) — the form the
    reference's matcher consumes."""
    parts = []
    for rdn in reversed(peercert.get("subject", ())):
        for name, value in rdn:
            abbrev = {
                "commonName": "CN",
                "organizationalUnitName": "OU",
                "organizationName": "O",
                "localityName": "L",
                "stateOrProvinceName": "ST",
                "countryName": "C",
            }.get(name, name)
            parts.append(f"{abbrev}={value}")
    return ",".join(parts)


class PrincipalMapper:
    def __init__(self, rules: list[str] | None = None):
        self._rules: list[tuple[re.Pattern, str, str] | None] = []
        for raw in rules or ["DEFAULT"]:
            raw = raw.strip()
            if raw == "DEFAULT":
                self._rules.append(None)
                continue
            m = _RULE.match(raw)
            if m is None:
                raise ValueError(f"bad mTLS principal rule {raw!r}")
            self._rules.append(
                (re.compile(m.group(1)), m.group(2), m.group(3))
            )

    def principal_for(self, peercert: dict) -> str | None:
        return self.principal_for_dn(_dn_of(peercert))

    def principal_for_dn(self, dn: str) -> str | None:
        if not dn:
            return None
        for rule in self._rules:
            if rule is None:
                return dn
            pattern, repl, flag = rule
            m = pattern.match(dn)
            if m is None:
                continue
            # translate $1 -> \1 backreference syntax
            out = re.sub(r"\$(\d+)", r"\\\1", repl)
            name = m.expand(out)
            if flag == "L":
                name = name.lower()
            elif flag == "U":
                name = name.upper()
            return name
        return None
