"""Offline Kerberos v5 primitives for SASL/GSSAPI.

The reference authenticates GSSAPI via MIT libgssapi
(src/v/security/gssapi_authenticator.cc, krb5.{h,cc}); this build has
no KDC and no libgssapi, so the token path is implemented directly:

  - minimal DER encode/decode for the RFC 4120 messages (AP-REQ,
    Ticket, Authenticator, AP-REP) with their explicit context tags,
  - RFC 3961/3962 crypto for aes256/aes128-cts-hmac-sha1-96
    (n-fold, DK key derivation, PBKDF2 string-to-key, CBC-CTS with
    confounder + HMAC-SHA1-96 integrity),
  - RFC 2743 §3.1 InitialContextToken framing and the RFC 4121 wrap
    tokens the SASL security-layer negotiation rides on.

Everything is testable against fixed vectors (RFC 6070 PBKDF2, RFC
3961 §A.1 n-fold) plus full-handshake tests where the test IS the KDC
(it mints the service key and ticket). No network, no clock authority
beyond the configured skew.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
import struct
import time
from dataclasses import dataclass, field
from typing import Optional

# ------------------------------------------------------------------ DER

SEQUENCE = 0x30


def der_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = b""
    while n:
        out = bytes([n & 0xFF]) + out
        n >>= 8
    return bytes([0x80 | len(out)]) + out


def tlv(tag: int, content: bytes) -> bytes:
    return bytes([tag]) + der_len(len(content)) + content


def ctx(n: int, content: bytes) -> bytes:
    """[n] EXPLICIT constructed context tag."""
    return tlv(0xA0 | n, content)


def app(n: int, content: bytes) -> bytes:
    """[APPLICATION n] constructed tag."""
    return tlv(0x60 | n, content)


def der_int(v: int) -> bytes:
    if v == 0:
        return tlv(0x02, b"\x00")
    out = b""
    x = v
    while x > 0:
        out = bytes([x & 0xFF]) + out
        x >>= 8
    if out[0] & 0x80:
        out = b"\x00" + out
    return tlv(0x02, out)


def der_octets(b: bytes) -> bytes:
    return tlv(0x04, b)


def der_gstring(s: str) -> bytes:
    return tlv(0x1B, s.encode())


def der_gtime(t: float) -> bytes:
    return tlv(0x18, time.strftime("%Y%m%d%H%M%SZ", time.gmtime(t)).encode())


def der_bitstring(bits: int, nbytes: int = 4) -> bytes:
    return tlv(0x03, b"\x00" + bits.to_bytes(nbytes, "big"))


class DerError(ValueError):
    pass


def _read_tlv(buf: bytes, pos: int) -> tuple[int, bytes, int]:
    """Returns (tag, content, next_pos)."""
    if pos >= len(buf):
        raise DerError("truncated DER")
    tag = buf[pos]
    pos += 1
    if pos >= len(buf):
        raise DerError("truncated DER length")
    l = buf[pos]
    pos += 1
    if l & 0x80:
        nlen = l & 0x7F
        if nlen == 0 or nlen > 4 or pos + nlen > len(buf):
            raise DerError("bad DER length")
        l = int.from_bytes(buf[pos : pos + nlen], "big")
        pos += nlen
    if pos + l > len(buf):
        raise DerError("DER content overruns buffer")
    return tag, buf[pos : pos + l], pos + l


def der_parse(buf: bytes) -> tuple[int, bytes]:
    tag, content, end = _read_tlv(buf, 0)
    if end != len(buf):
        raise DerError("trailing bytes after DER value")
    return tag, content


def der_seq_items(content: bytes) -> list[tuple[int, bytes]]:
    items = []
    pos = 0
    while pos < len(content):
        tag, inner, pos = _read_tlv(content, pos)
        items.append((tag, inner))
    return items


def der_fields(content: bytes) -> dict[int, bytes]:
    """Context-tagged fields of a SEQUENCE body → {n: inner_der}."""
    out: dict[int, bytes] = {}
    for tag, inner in der_seq_items(content):
        if tag & 0xE0 == 0xA0:
            out[tag & 0x1F] = inner
    return out


def parse_int(der: bytes) -> int:
    tag, content = der_parse(der)
    if tag != 0x02:
        raise DerError(f"expected INTEGER, got tag {tag:#x}")
    return int.from_bytes(content, "big", signed=True)


def parse_octets(der: bytes) -> bytes:
    tag, content = der_parse(der)
    if tag != 0x04:
        raise DerError(f"expected OCTET STRING, got tag {tag:#x}")
    return content


def parse_gstring(der: bytes) -> str:
    tag, content = der_parse(der)
    if tag not in (0x1B, 0x0C):  # GeneralString / UTF8String
        raise DerError(f"expected GeneralString, got tag {tag:#x}")
    return content.decode()


def parse_gtime(der: bytes) -> float:
    tag, content = der_parse(der)
    if tag != 0x18:
        raise DerError(f"expected GeneralizedTime, got tag {tag:#x}")
    import calendar

    return float(
        calendar.timegm(time.strptime(content.decode(), "%Y%m%d%H%M%SZ"))
    )


# ------------------------------------------------- RFC 3961 primitives


def nfold(data: bytes, nbits: int) -> bytes:
    """RFC 3961 §5.1 n-fold: stretch/compress `data` to nbits. Copy i
    of the input is rotated right by 13*i bits; the lcm-length
    concatenation is summed in nbits-chunks with ones'-complement
    (end-around-carry) addition."""
    nbytes = nbits // 8
    dlen = len(data)

    def gcd(a: int, b: int) -> int:
        while b:
            a, b = b, a % b
        return a

    lcm = nbytes * dlen // gcd(nbytes, dlen)
    dbits = dlen * 8
    big = int.from_bytes(data, "big")
    buf = bytearray()
    for i in range(lcm // dlen):
        rot = (13 * i) % dbits
        r = ((big >> rot) | (big << (dbits - rot))) & ((1 << dbits) - 1)
        buf += r.to_bytes(dlen, "big")
    total = 0
    for i in range(0, lcm, nbytes):
        total += int.from_bytes(buf[i : i + nbytes], "big")
    mask = (1 << nbits) - 1
    while total >> nbits:
        total = (total & mask) + (total >> nbits)
    return total.to_bytes(nbytes, "big")


def _aes_cbc(key: bytes, iv: bytes, data: bytes, encrypt: bool) -> bytes:
    from cryptography.hazmat.primitives.ciphers import (
        Cipher,
        algorithms,
        modes,
    )

    c = Cipher(algorithms.AES(key), modes.CBC(iv))
    op = c.encryptor() if encrypt else c.decryptor()
    return op.update(data) + op.finalize()


def _cts_encrypt(key: bytes, data: bytes) -> bytes:
    """AES-CBC-CS3 (RFC 3962 §5): swap the last two blocks and truncate
    the stolen tail. data must be >= 16 bytes."""
    n = len(data)
    if n < 16:
        raise ValueError("CTS needs at least one block")
    if n == 16:
        return _aes_cbc(key, b"\x00" * 16, data, True)
    pad = (-n) % 16
    padded = data + b"\x00" * pad
    cbc = _aes_cbc(key, b"\x00" * 16, padded, True)
    # swap last two blocks; final (stolen) block is truncated
    last = cbc[-16:]
    second_last = cbc[-32:-16]
    return cbc[:-32] + last + second_last[: 16 - pad if pad else 16]


def _cts_decrypt(key: bytes, data: bytes) -> bytes:
    from cryptography.hazmat.primitives.ciphers import (
        Cipher,
        algorithms,
        modes,
    )

    n = len(data)
    if n < 16:
        raise ValueError("CTS needs at least one block")
    if n == 16:
        return _aes_cbc(key, b"\x00" * 16, data, False)
    rem = n % 16
    tail = rem if rem else 16
    # Cn is the last (possibly partial) block; Cn-1 the full block
    # before it. Decrypt Cn-1 with ECB to recover the stolen bytes.
    cn = data[n - tail :]
    cn1 = data[n - tail - 16 : n - tail]
    c = Cipher(algorithms.AES(key), modes.ECB())
    dec = c.decryptor()
    dn1 = dec.update(cn1) + dec.finalize()
    cn_full = cn + dn1[tail:]
    # reassemble standard CBC order: ..., Cn_full, Cn-1
    cbc = data[: n - tail - 16] + cn_full + cn1
    out = _aes_cbc(key, b"\x00" * 16, cbc, False)
    return out[: n]


AES128_CTS_HMAC_SHA1 = 17
AES256_CTS_HMAC_SHA1 = 18

_KEYSIZE = {AES128_CTS_HMAC_SHA1: 16, AES256_CTS_HMAC_SHA1: 32}


def derive(key: bytes, constant: bytes) -> bytes:
    """DK(key, constant) — RFC 3961 §5.1 derive-key via AES-CBC
    chaining over n-fold(constant)."""
    keylen = len(key)
    if len(constant) != 16:
        constant = nfold(constant, 128)
    out = b""
    block = constant
    while len(out) < keylen:
        block = _aes_cbc(key, b"\x00" * 16, block, True)
        out += block
    return out[:keylen]


def _usage_keys(key: bytes, usage: int) -> tuple[bytes, bytes]:
    """(Ke, Ki) for one key-usage number."""
    u = struct.pack(">I", usage)
    return derive(key, u + b"\xaa"), derive(key, u + b"\x55")


def _checksum_key(key: bytes, usage: int) -> bytes:
    return derive(key, struct.pack(">I", usage) + b"\x99")


def encrypt(key: bytes, usage: int, plaintext: bytes) -> bytes:
    """RFC 3962 encryption: CTS(Ke, confounder||plain) || HMAC-SHA1-96
    over (confounder||plain) with Ki."""
    ke, ki = _usage_keys(key, usage)
    conf = os.urandom(16)
    data = conf + plaintext
    mac = hmac_mod.new(ki, data, hashlib.sha1).digest()[:12]
    return _cts_encrypt(ke, data) + mac


class KrbCryptoError(Exception):
    pass


def decrypt(key: bytes, usage: int, ciphertext: bytes) -> bytes:
    if len(ciphertext) < 16 + 12:
        raise KrbCryptoError("ciphertext too short")
    ke, ki = _usage_keys(key, usage)
    body, mac = ciphertext[:-12], ciphertext[-12:]
    data = _cts_decrypt(ke, body)
    expect = hmac_mod.new(ki, data, hashlib.sha1).digest()[:12]
    if not hmac_mod.compare_digest(mac, expect):
        raise KrbCryptoError("integrity check failed")
    return data[16:]  # strip confounder


def checksum(key: bytes, usage: int, data: bytes) -> bytes:
    """hmac-sha1-96-aes keyed checksum (RFC 3962 §7)."""
    kc = _checksum_key(key, usage)
    return hmac_mod.new(kc, data, hashlib.sha1).digest()[:12]


def string_to_key(
    password: str, salt: str, etype: int = AES256_CTS_HMAC_SHA1,
    iterations: int = 4096,
) -> bytes:
    """RFC 3962 §4: PBKDF2-HMAC-SHA1 then DK with "kerberos"."""
    size = _KEYSIZE[etype]
    tkey = hashlib.pbkdf2_hmac(
        "sha1", password.encode(), salt.encode(), iterations, size
    )
    return derive(tkey, b"kerberos")


# Key usage numbers (RFC 4120 §7.5.1)
KU_TICKET = 2
KU_AP_REQ_AUTH = 11
KU_AP_REP_ENC = 12
# RFC 4121 §2: acceptor seal/sign, initiator seal/sign
KU_ACCEPTOR_SEAL = 22
KU_ACCEPTOR_SIGN = 23
KU_INITIATOR_SEAL = 24
KU_INITIATOR_SIGN = 25


# --------------------------------------------------- RFC 4120 messages

NT_PRINCIPAL = 1
NT_SRV_INST = 2


def principal_name(components: list[str], name_type: int = NT_PRINCIPAL) -> bytes:
    return tlv(
        SEQUENCE,
        ctx(0, der_int(name_type))
        + ctx(1, tlv(SEQUENCE, b"".join(der_gstring(c) for c in components))),
    )


def parse_principal(der: bytes) -> tuple[int, list[str]]:
    tag, content = der_parse(der)
    if tag != SEQUENCE:
        raise DerError("PrincipalName must be a SEQUENCE")
    f = der_fields(content)
    ntype = parse_int(f[0])
    tag, inner = der_parse(f[1])
    comps = [
        content.decode()
        for t, content in der_seq_items(inner)
        if t in (0x1B, 0x0C)
    ]
    return ntype, comps


def encrypted_data(etype: int, cipher: bytes, kvno: Optional[int] = None) -> bytes:
    body = ctx(0, der_int(etype))
    if kvno is not None:
        body += ctx(1, der_int(kvno))
    body += ctx(2, der_octets(cipher))
    return tlv(SEQUENCE, body)


def parse_encrypted_data(der: bytes) -> tuple[int, Optional[int], bytes]:
    tag, content = der_parse(der)
    if tag != SEQUENCE:
        raise DerError("EncryptedData must be a SEQUENCE")
    f = der_fields(content)
    kvno = parse_int(f[1]) if 1 in f else None
    return parse_int(f[0]), kvno, parse_octets(f[2])


@dataclass
class Ticket:
    realm: str
    sname: list[str]
    etype: int
    kvno: Optional[int]
    cipher: bytes

    def encode(self) -> bytes:
        return app(
            1,
            tlv(
                SEQUENCE,
                ctx(0, der_int(5))
                + ctx(1, der_gstring(self.realm))
                + ctx(2, principal_name(self.sname, NT_SRV_INST))
                + ctx(3, encrypted_data(self.etype, self.cipher, self.kvno)),
            ),
        )

    @classmethod
    def decode(cls, der: bytes) -> "Ticket":
        tag, content = der_parse(der)
        if tag != 0x61:
            raise DerError("not a Ticket (APPLICATION 1)")
        tag, content = der_parse(content)
        f = der_fields(content)
        if parse_int(f[0]) != 5:
            raise DerError("tkt-vno != 5")
        _, sname = parse_principal(f[2])
        etype, kvno, cipher = parse_encrypted_data(f[3])
        return cls(parse_gstring(f[1]), sname, etype, kvno, cipher)


@dataclass
class EncTicketPart:
    """The decrypted ticket payload (subset we enforce)."""

    session_key: bytes
    key_etype: int
    crealm: str
    cname: list[str]
    authtime: float
    endtime: float
    starttime: Optional[float] = None

    def encode(self) -> bytes:
        body = ctx(0, der_bitstring(0))  # flags
        body += ctx(
            1,
            tlv(
                SEQUENCE,
                ctx(0, der_int(self.key_etype))
                + ctx(1, der_octets(self.session_key)),
            ),
        )
        body += ctx(2, der_gstring(self.crealm))
        body += ctx(3, principal_name(self.cname))
        body += ctx(4, tlv(SEQUENCE, b""))  # transited (empty)
        body += ctx(5, der_gtime(self.authtime))
        if self.starttime is not None:
            body += ctx(6, der_gtime(self.starttime))
        body += ctx(7, der_gtime(self.endtime))
        return app(3, tlv(SEQUENCE, body))

    @classmethod
    def decode(cls, der: bytes) -> "EncTicketPart":
        tag, content = der_parse(der)
        if tag != 0x63:
            raise DerError("not EncTicketPart (APPLICATION 3)")
        tag, content = der_parse(content)
        f = der_fields(content)
        ktag, kcontent = der_parse(f[1])
        kf = der_fields(kcontent)
        _, cname = parse_principal(f[3])
        return cls(
            session_key=parse_octets(kf[1]),
            key_etype=parse_int(kf[0]),
            crealm=parse_gstring(f[2]),
            cname=cname,
            authtime=parse_gtime(f[5]),
            endtime=parse_gtime(f[7]),
            starttime=parse_gtime(f[6]) if 6 in f else None,
        )


@dataclass
class Authenticator:
    crealm: str
    cname: list[str]
    ctime: float
    cusec: int
    subkey: Optional[bytes] = None
    subkey_etype: int = AES256_CTS_HMAC_SHA1
    seq_number: Optional[int] = None

    def encode(self) -> bytes:
        body = ctx(0, der_int(5))
        body += ctx(1, der_gstring(self.crealm))
        body += ctx(2, principal_name(self.cname))
        body += ctx(4, der_int(self.cusec))
        body += ctx(5, der_gtime(self.ctime))
        if self.subkey is not None:
            body += ctx(
                6,
                tlv(
                    SEQUENCE,
                    ctx(0, der_int(self.subkey_etype))
                    + ctx(1, der_octets(self.subkey)),
                ),
            )
        if self.seq_number is not None:
            body += ctx(7, der_int(self.seq_number))
        return app(2, tlv(SEQUENCE, body))

    @classmethod
    def decode(cls, der: bytes) -> "Authenticator":
        tag, content = der_parse(der)
        if tag != 0x62:
            raise DerError("not an Authenticator (APPLICATION 2)")
        tag, content = der_parse(content)
        f = der_fields(content)
        if parse_int(f[0]) != 5:
            raise DerError("authenticator-vno != 5")
        _, cname = parse_principal(f[2])
        subkey = None
        subkey_etype = AES256_CTS_HMAC_SHA1
        if 6 in f:
            _, kcontent = der_parse(f[6])
            kf = der_fields(kcontent)
            subkey = parse_octets(kf[1])
            subkey_etype = parse_int(kf[0])
        return cls(
            crealm=parse_gstring(f[1]),
            cname=cname,
            ctime=parse_gtime(f[5]),
            cusec=parse_int(f[4]),
            subkey=subkey,
            subkey_etype=subkey_etype,
            seq_number=parse_int(f[7]) if 7 in f else None,
        )


AP_OPTION_MUTUAL_REQUIRED = 0x20000000


@dataclass
class ApReq:
    ticket: Ticket
    authenticator_cipher: bytes
    auth_etype: int
    ap_options: int = AP_OPTION_MUTUAL_REQUIRED

    def encode(self) -> bytes:
        return app(
            14,
            tlv(
                SEQUENCE,
                ctx(0, der_int(5))
                + ctx(1, der_int(14))
                + ctx(2, der_bitstring(self.ap_options))
                + ctx(3, self.ticket.encode())
                + ctx(
                    4,
                    encrypted_data(
                        self.auth_etype, self.authenticator_cipher
                    ),
                ),
            ),
        )

    @classmethod
    def decode(cls, der: bytes) -> "ApReq":
        tag, content = der_parse(der)
        if tag != 0x6E:
            raise DerError("not an AP-REQ (APPLICATION 14)")
        tag, content = der_parse(content)
        f = der_fields(content)
        if parse_int(f[0]) != 5 or parse_int(f[1]) != 14:
            raise DerError("bad AP-REQ version/type")
        btag, bcontent = der_parse(f[2])
        opts = int.from_bytes(bcontent[1:5], "big") if len(bcontent) >= 5 else 0
        etype, _, cipher = parse_encrypted_data(f[4])
        return cls(Ticket.decode(f[3]), cipher, etype, opts)


@dataclass
class ApRep:
    enc_cipher: bytes
    etype: int

    def encode(self) -> bytes:
        return app(
            15,
            tlv(
                SEQUENCE,
                ctx(0, der_int(5))
                + ctx(1, der_int(15))
                + ctx(2, encrypted_data(self.etype, self.enc_cipher)),
            ),
        )

    @classmethod
    def decode(cls, der: bytes) -> "ApRep":
        tag, content = der_parse(der)
        if tag != 0x6F:
            raise DerError("not an AP-REP (APPLICATION 15)")
        tag, content = der_parse(content)
        f = der_fields(content)
        if parse_int(f[0]) != 5 or parse_int(f[1]) != 15:
            raise DerError("bad AP-REP version/type")
        etype, _, cipher = parse_encrypted_data(f[2])
        return cls(cipher, etype)


def enc_ap_rep_part(
    ctime: float, cusec: int, seq_number: Optional[int] = None
) -> bytes:
    body = ctx(0, der_gtime(ctime)) + ctx(1, der_int(cusec))
    if seq_number is not None:
        body += ctx(3, der_int(seq_number))
    return app(27, tlv(SEQUENCE, body))


def parse_enc_ap_rep_part(der: bytes) -> tuple[float, int, Optional[int]]:
    tag, content = der_parse(der)
    if tag != 0x7B:
        raise DerError("not EncAPRepPart (APPLICATION 27)")
    tag, content = der_parse(content)
    f = der_fields(content)
    return (
        parse_gtime(f[0]),
        parse_int(f[1]),
        parse_int(f[3]) if 3 in f else None,
    )


# ------------------------------------------ GSS framing (RFC 2743/4121)

KRB5_OID = bytes.fromhex("06092a864886f712010202")  # 1.2.840.113554.1.2.2
TOK_AP_REQ = b"\x01\x00"
TOK_AP_REP = b"\x02\x00"
TOK_ERROR = b"\x03\x00"


def gss_frame(tok_id: bytes, inner: bytes) -> bytes:
    """InitialContextToken: [APPLICATION 0] IMPLICIT { OID, token }."""
    return tlv(0x60, KRB5_OID + tok_id + inner)


def gss_unframe(token: bytes) -> tuple[bytes, bytes]:
    tag, content = der_parse(token)
    if tag != 0x60:
        raise DerError("not a GSS InitialContextToken")
    if not content.startswith(KRB5_OID):
        raise DerError("mech OID is not krb5")
    rest = content[len(KRB5_OID) :]
    if len(rest) < 2:
        raise DerError("missing TOK_ID")
    return rest[:2], rest[2:]


# RFC 4121 §4.2.6.2 wrap tokens
_WRAP_HDR = b"\x05\x04"
FLAG_SENT_BY_ACCEPTOR = 0x01
FLAG_SEALED = 0x02
FLAG_ACCEPTOR_SUBKEY = 0x04


def wrap_token(
    key: bytes,
    payload: bytes,
    seq: int,
    acceptor: bool,
    seal: bool = False,
) -> bytes:
    flags = (FLAG_SENT_BY_ACCEPTOR if acceptor else 0) | (
        FLAG_SEALED if seal else 0
    )
    if seal:
        usage = KU_ACCEPTOR_SEAL if acceptor else KU_INITIATOR_SEAL
        hdr = _WRAP_HDR + bytes([flags, 0xFF]) + struct.pack(
            ">HHQ", 16, 0, seq  # EC=16 (RRC 0)
        )
        return hdr + encrypt(key, usage, payload + hdr)
    usage = KU_ACCEPTOR_SIGN if acceptor else KU_INITIATOR_SIGN
    hdr = _WRAP_HDR + bytes([flags, 0xFF]) + struct.pack(">HHQ", 12, 0, seq)
    mac = checksum(key, usage, payload + hdr)
    return hdr + payload + mac


def unwrap_token(
    key: bytes, token: bytes, expect_from_acceptor: bool
) -> bytes:
    if len(token) < 16 or token[:2] != _WRAP_HDR:
        raise KrbCryptoError("not a v2 wrap token")
    flags = token[2]
    if bool(flags & FLAG_SENT_BY_ACCEPTOR) != expect_from_acceptor:
        raise KrbCryptoError("wrap token direction mismatch")
    ec, rrc, _seq = struct.unpack(">HHQ", token[4:16])
    body = token[16:]
    sealed = bool(flags & FLAG_SEALED)
    acceptor = bool(flags & FLAG_SENT_BY_ACCEPTOR)
    if sealed:
        if rrc:
            raise KrbCryptoError("RRC rotation unsupported")
        usage = KU_ACCEPTOR_SEAL if acceptor else KU_INITIATOR_SEAL
        plain = decrypt(key, usage, body)
        if len(plain) < 16 or plain[-16:] != token[:16]:
            raise KrbCryptoError("wrap header echo mismatch")
        return plain[:-16]
    usage = KU_ACCEPTOR_SIGN if acceptor else KU_INITIATOR_SIGN
    if len(body) < 12:
        raise KrbCryptoError("wrap token too short")
    payload, mac = body[:-12], body[-12:]
    expect = checksum(key, usage, payload + token[:16])
    if not hmac_mod.compare_digest(mac, expect):
        raise KrbCryptoError("wrap token checksum mismatch")
    return payload


# ------------------------------------------------------ service keytab


@dataclass
class ServiceKey:
    principal: str  # "primary/host@REALM"
    key: bytes
    etype: int = AES256_CTS_HMAC_SHA1
    kvno: int = 1


class Keytab:
    """In-memory keytab analog: (principal) → keys by etype."""

    def __init__(self) -> None:
        self._keys: dict[tuple[str, int], ServiceKey] = {}

    def add(self, sk: ServiceKey) -> None:
        self._keys[(sk.principal, sk.etype)] = sk

    def add_password(
        self,
        principal: str,
        password: str,
        realm: Optional[str] = None,
        etype: int = AES256_CTS_HMAC_SHA1,
    ) -> ServiceKey:
        """Standard krb5 salt: realm + unseparated principal comps."""
        if realm is None:
            realm = principal.split("@", 1)[1] if "@" in principal else ""
        base = principal.split("@", 1)[0]
        salt = realm + "".join(base.split("/"))
        sk = ServiceKey(principal, string_to_key(password, salt, etype), etype)
        self.add(sk)
        return sk

    def get(self, principal: str, etype: int) -> Optional[ServiceKey]:
        return self._keys.get((principal, etype))
