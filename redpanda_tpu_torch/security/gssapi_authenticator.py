"""SASL/GSSAPI (Kerberos) authenticator — offline acceptor.

Reference: src/v/security/gssapi_authenticator.cc (which drives MIT
libgssapi). This build implements the acceptor side of the RFC 4752
SASL GSSAPI profile directly on the krb5 primitives in krb5.py:

  C→S  InitialContextToken{AP-REQ}     (krb5 mutual-auth requested)
  S→C  InitialContextToken{AP-REP}     (proves service-key possession)
  C→S  (empty)                         (client context complete)
  S→C  wrap(offer: layer-mask, max)    (we offer "no security layer")
  C→S  wrap(choice + authzid)          (client picks none, names authz)

The authenticated Kerberos principal (crealm/cname from the decrypted
ticket) then runs through the auth_to_local rules
(gssapi.GssapiPrincipalMapper) to produce the local principal, exactly
like gssapi_principal_mapper.cc.

Replay protection: an in-memory (cname, ctime, cusec) cache bounded to
the clock-skew window (rd_req replay cache analog).
"""

from __future__ import annotations

import time
from typing import Optional

from . import krb5
from .gssapi import GssapiName, GssapiPrincipalMapper

SASL_MECHANISM = "GSSAPI"

# RFC 4752 security layer bitmask: 0x01 = none supported/selected
SEC_LAYER_NONE = 0x01
MAX_TOKEN = 0x0FFFFF


class GssapiError(Exception):
    pass


class GssapiAuthenticator:
    """Broker-wide GSSAPI state: keytab + mapping rules + replay cache."""

    def __init__(
        self,
        keytab: krb5.Keytab,
        service_principal: str,
        principal_mapping_rules: Optional[list[str]] = None,
        clock_skew_s: float = 300.0,
    ):
        self.keytab = keytab
        self.service_principal = service_principal
        self.mapper = GssapiPrincipalMapper(principal_mapping_rules or [])
        self.clock_skew_s = clock_skew_s
        self.default_realm = (
            service_principal.split("@", 1)[1]
            if "@" in service_principal
            else ""
        )
        # two-generation replay cache: the current and previous window
        # together cover every authenticator the clock-skew check can
        # still accept, rotation is O(1), and memory is bounded by two
        # windows of auth traffic (rd_req replay cache analog; no
        # per-auth full-dict rebuilds under sustained load)
        self._replay_cur: set[tuple] = set()
        self._replay_prev: set[tuple] = set()
        self._replay_rotated = 0.0

    def check_replay(self, key: tuple, now: float) -> bool:
        """True if fresh (and records it); False on replay."""
        if now - self._replay_rotated > 2 * self.clock_skew_s:
            self._replay_prev = self._replay_cur
            self._replay_cur = set()
            self._replay_rotated = now
        if key in self._replay_cur or key in self._replay_prev:
            return False
        self._replay_cur.add(key)
        return True

    def new_exchange(self) -> "GssapiServerExchange":
        return GssapiServerExchange(self)


class GssapiServerExchange:
    """One connection's SASL exchange; duck-compatible with the kafka
    server's SASL dispatch via step()/done/username."""

    def __init__(self, auth: GssapiAuthenticator):
        self._auth = auth
        self.state = "start"  # start → context → negotiate → done
        self.username: Optional[str] = None
        self.kerberos_principal: Optional[str] = None
        self._ctx_key: Optional[bytes] = None
        self._seq = 0

    @property
    def done(self) -> bool:
        return self.state == "done"

    # generic multi-round entry point (the kafka server prefers this
    # over the two-step scram interface when present)
    def step(self, token: bytes) -> bytes:
        if self.state == "start":
            return self._accept_ap_req(token)
        if self.state == "context":
            # client consumed the AP-REP; empty token completes its
            # context. Reply with the security-layer offer.
            if token:
                raise GssapiError("unexpected token after AP-REP")
            return self._send_offer()
        if self.state == "negotiate":
            return self._finish(token)
        raise GssapiError("exchange already complete")

    def _accept_ap_req(self, token: bytes) -> bytes:
        auth = self._auth
        now = time.time()
        try:
            tok_id, inner = krb5.gss_unframe(token)
        except krb5.DerError as e:
            raise GssapiError(f"bad GSS token: {e}") from None
        if tok_id != krb5.TOK_AP_REQ:
            raise GssapiError(f"expected AP-REQ token, got {tok_id!r}")
        try:
            ap_req = krb5.ApReq.decode(inner)
        except krb5.DerError as e:
            raise GssapiError(f"malformed AP-REQ: {e}") from None
        tkt = ap_req.ticket
        sprinc = "/".join(tkt.sname) + "@" + tkt.realm
        sk = auth.keytab.get(sprinc, tkt.etype)
        if sk is None:
            raise GssapiError(
                f"no key for {sprinc} etype {tkt.etype} in keytab"
            )
        try:
            enc_part = krb5.EncTicketPart.decode(
                krb5.decrypt(sk.key, krb5.KU_TICKET, tkt.cipher)
            )
        except (krb5.KrbCryptoError, krb5.DerError) as e:
            raise GssapiError(f"ticket decryption failed: {e}") from None
        skew = auth.clock_skew_s
        if enc_part.starttime is not None and enc_part.starttime > now + skew:
            raise GssapiError("ticket not yet valid")
        if enc_part.endtime < now - skew:
            raise GssapiError("ticket expired")
        try:
            authenticator = krb5.Authenticator.decode(
                krb5.decrypt(
                    enc_part.session_key,
                    krb5.KU_AP_REQ_AUTH,
                    ap_req.authenticator_cipher,
                )
            )
        except (krb5.KrbCryptoError, krb5.DerError) as e:
            raise GssapiError(f"authenticator decryption failed: {e}") from None
        if (
            authenticator.cname != enc_part.cname
            or authenticator.crealm != enc_part.crealm
        ):
            raise GssapiError("authenticator/ticket client mismatch")
        if abs(authenticator.ctime - now) > skew:
            raise GssapiError("authenticator clock skew too great")
        replay_key = (
            tuple(authenticator.cname),
            authenticator.crealm,
            authenticator.ctime,
            authenticator.cusec,
        )
        if not auth.check_replay(replay_key, now):
            raise GssapiError("AP-REQ replay detected")
        self.kerberos_principal = (
            "/".join(enc_part.cname) + "@" + enc_part.crealm
        )
        # context key: the authenticator subkey when offered, else the
        # ticket session key (RFC 4121 §1)
        self._ctx_key = authenticator.subkey or enc_part.session_key
        self._session_key = enc_part.session_key
        # mutual auth: AP-REP over the session key proves we hold the
        # service key (RFC 4120 §3.2.4)
        rep = krb5.ApRep(
            krb5.encrypt(
                enc_part.session_key,
                krb5.KU_AP_REP_ENC,
                krb5.enc_ap_rep_part(
                    authenticator.ctime,
                    authenticator.cusec,
                    authenticator.seq_number,
                ),
            ),
            enc_part.key_etype,
        )
        self.state = "context"
        return krb5.gss_frame(krb5.TOK_AP_REP, rep.encode())

    def _send_offer(self) -> bytes:
        payload = bytes([SEC_LAYER_NONE]) + MAX_TOKEN.to_bytes(3, "big")
        tok = krb5.wrap_token(
            self._ctx_key, payload, self._seq, acceptor=True, seal=False
        )
        self._seq += 1
        self.state = "negotiate"
        return tok

    def _finish(self, token: bytes) -> bytes:
        try:
            payload = krb5.unwrap_token(
                self._ctx_key, token, expect_from_acceptor=False
            )
        except krb5.KrbCryptoError as e:
            raise GssapiError(f"bad negotiation wrap: {e}") from None
        if len(payload) < 4:
            raise GssapiError("negotiation payload too short")
        if not payload[0] & SEC_LAYER_NONE:
            raise GssapiError(
                "client demanded a SASL security layer (unsupported)"
            )
        authzid = payload[4:].decode("utf-8", "replace")
        name = GssapiName.parse(self.kerberos_principal)
        if name is None:
            raise GssapiError(
                f"unparseable principal {self.kerberos_principal!r}"
            )
        mapped = self._auth.mapper.apply(self._auth.default_realm, name)
        if mapped is None:
            raise GssapiError(
                f"no auth_to_local rule maps {self.kerberos_principal!r}"
            )
        if authzid and authzid != mapped:
            raise GssapiError(
                f"authzid {authzid!r} does not match principal {mapped!r}"
            )
        self.username = mapped
        self.state = "done"
        return b""


class GssapiClient:
    """Minimal initiator for tests and loopback tooling: the caller
    supplies the ticket material a KDC would have issued (the test IS
    the KDC — it holds the service key)."""

    def __init__(
        self,
        ticket: krb5.Ticket,
        session_key: bytes,
        cname: list[str],
        crealm: str,
        key_etype: int = krb5.AES256_CTS_HMAC_SHA1,
    ):
        self.ticket = ticket
        self.session_key = session_key
        self.cname = cname
        self.crealm = crealm
        self.key_etype = key_etype
        self._seq = 0
        self.ctime = time.time()
        self.cusec = int((self.ctime % 1) * 1e6)

    def initial_token(self, seq_number: int = 0) -> bytes:
        authenticator = krb5.Authenticator(
            crealm=self.crealm,
            cname=self.cname,
            ctime=self.ctime,
            cusec=self.cusec,
            seq_number=seq_number,
        )
        ap_req = krb5.ApReq(
            self.ticket,
            krb5.encrypt(
                self.session_key,
                krb5.KU_AP_REQ_AUTH,
                authenticator.encode(),
            ),
            self.key_etype,
        )
        return krb5.gss_frame(krb5.TOK_AP_REQ, ap_req.encode())

    def verify_ap_rep(self, token: bytes) -> None:
        tok_id, inner = krb5.gss_unframe(token)
        if tok_id != krb5.TOK_AP_REP:
            raise GssapiError(f"expected AP-REP, got {tok_id!r}")
        rep = krb5.ApRep.decode(inner)
        ctime, cusec, _seq = krb5.parse_enc_ap_rep_part(
            krb5.decrypt(self.session_key, krb5.KU_AP_REP_ENC, rep.enc_cipher)
        )
        if cusec != self.cusec or abs(ctime - self.ctime) > 1.0:
            raise GssapiError("AP-REP does not echo our authenticator time")

    def negotiate(self, offer_token: bytes, authzid: str = "") -> bytes:
        payload = krb5.unwrap_token(
            self.session_key, offer_token, expect_from_acceptor=True
        )
        if not payload or not payload[0] & SEC_LAYER_NONE:
            raise GssapiError("server does not offer 'no security layer'")
        out = bytes([SEC_LAYER_NONE]) + MAX_TOKEN.to_bytes(3, "big")
        out += authzid.encode()
        tok = krb5.wrap_token(
            self.session_key, out, self._seq, acceptor=False, seal=False
        )
        self._seq += 1
        return tok
