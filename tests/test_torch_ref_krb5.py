"""tests/test_krb5.py run on the port: all 18 test functions, with
imports pointed at redpanda_tpu_torch. Every broker is the port's on the
CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.


Kerberos crypto + GSSAPI handshake tests.

External oracles:
  - RFC 3961 §A.1 n-fold vectors (pinned bytes),
  - RFC 6070 PBKDF2-HMAC-SHA1 vectors (the string-to-key core),
  - CBC-CS3 == CBC-with-swapped-tail for aligned inputs (cryptography's
    CBC as the reference implementation),
then full-handshake tests where the test plays KDC (it mints the
service key and ticket), mirroring what the reference exercises through
libgssapi in gssapi_authenticator.cc.
"""

import time

import pytest

from redpanda_tpu_torch.security import krb5
from redpanda_tpu_torch.security.gssapi_authenticator import (
    GssapiAuthenticator,
    GssapiClient,
    GssapiError,
)
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


# ------------------------------------------------------ crypto oracles


@pytest.mark.parametrize(
    "data,nbits,expect",
    [
        # RFC 3961 appendix A.1
        (b"012345", 64, "be072631276b1955"),
        (b"password", 56, "78a07b6caf85fa"),
        (b"Rough Consensus, and Running Code", 64, "bb6ed30870b7f0e0"),
        (
            b"MASSACHVSETTS INSTITVTE OF TECHNOLOGY",
            192,
            "db3b0d8f0b061e603282b308a50841229ad798fab9540c1b",
        ),
        (b"Q", 168, "518a54a215a8452a518a54a215a8452a518a54a215"),
        (b"ba", 168, "fb25d531ae8974499f52fd92ea9857c4ba24cf297e"),
    ],
)
def test_nfold_rfc3961_vectors(data, nbits, expect):
    assert krb5.nfold(data, nbits).hex() == expect


def test_pbkdf2_rfc6070_vectors():
    import hashlib

    assert (
        hashlib.pbkdf2_hmac(b"sha1".decode(), b"password", b"salt", 1, 20).hex()
        == "0c60c80f961f0e71f3a9b524af6012062fe037a6"
    )
    assert (
        hashlib.pbkdf2_hmac("sha1", b"password", b"salt", 4096, 20).hex()
        == "4b007901b765489abead49d926f721d065a429c1"
    )


def test_cts_matches_cbc_for_aligned_input():
    """CBC-CS3 on a block-aligned input is CBC with the last two
    ciphertext blocks swapped (RFC 3962 §5)."""
    key = bytes(range(32))
    data = bytes(range(64))  # 4 blocks
    cbc = krb5._aes_cbc(key, b"\x00" * 16, data, True)
    expect = cbc[:32] + cbc[48:64] + cbc[32:48]
    assert krb5._cts_encrypt(key, data) == expect
    assert krb5._cts_decrypt(key, expect) == data


@pytest.mark.parametrize("n", [16, 17, 31, 32, 33, 48, 100, 255])
def test_cts_round_trip_all_tail_shapes(n):
    key = bytes(range(16))
    data = bytes((i * 7) & 0xFF for i in range(n))
    ct = krb5._cts_encrypt(key, data)
    assert len(ct) == n
    assert krb5._cts_decrypt(key, ct) == data


def test_encrypt_decrypt_and_tamper():
    key = krb5.string_to_key("hunter2", "EXAMPLE.COMsvchost")
    assert len(key) == 32
    pt = b"attack at dawn"
    ct = krb5.encrypt(key, krb5.KU_TICKET, pt)
    assert krb5.decrypt(key, krb5.KU_TICKET, ct) == pt
    # different usage number must not decrypt
    with pytest.raises(krb5.KrbCryptoError):
        krb5.decrypt(key, krb5.KU_AP_REQ_AUTH, ct)
    # bit flip anywhere fails integrity
    bad = bytearray(ct)
    bad[3] ^= 1
    with pytest.raises(krb5.KrbCryptoError):
        krb5.decrypt(key, krb5.KU_TICKET, bytes(bad))


def test_string_to_key_distinct_per_salt_and_etype():
    a = krb5.string_to_key("pw", "REALMa")
    b = krb5.string_to_key("pw", "REALMb")
    c = krb5.string_to_key("pw", "REALMa", etype=krb5.AES128_CTS_HMAC_SHA1)
    assert a != b and len(c) == 16


def test_wrap_token_round_trip_and_direction():
    key = bytes(range(32))
    payload = b"\x01\x0f\xff\xff"
    tok = krb5.wrap_token(key, payload, 7, acceptor=True)
    assert krb5.unwrap_token(key, tok, expect_from_acceptor=True) == payload
    with pytest.raises(krb5.KrbCryptoError):
        krb5.unwrap_token(key, tok, expect_from_acceptor=False)
    sealed = krb5.wrap_token(key, payload, 8, acceptor=False, seal=True)
    assert (
        krb5.unwrap_token(key, sealed, expect_from_acceptor=False) == payload
    )


# ----------------------------------------------------- DER round trips


def test_der_structures_round_trip():
    session = bytes(range(32))
    now = float(int(time.time()))
    enc = krb5.EncTicketPart(
        session_key=session,
        key_etype=krb5.AES256_CTS_HMAC_SHA1,
        crealm="EXAMPLE.COM",
        cname=["alice"],
        authtime=now,
        endtime=now + 3600,
    )
    back = krb5.EncTicketPart.decode(enc.encode())
    assert back.session_key == session
    assert back.cname == ["alice"] and back.crealm == "EXAMPLE.COM"
    assert back.endtime == now + 3600

    auth = krb5.Authenticator(
        crealm="EXAMPLE.COM",
        cname=["alice"],
        ctime=now,
        cusec=123456,
        seq_number=42,
    )
    aback = krb5.Authenticator.decode(auth.encode())
    assert aback.cname == ["alice"] and aback.cusec == 123456
    assert aback.seq_number == 42

    tkt = krb5.Ticket(
        realm="EXAMPLE.COM",
        sname=["kafka", "broker.example.com"],
        etype=krb5.AES256_CTS_HMAC_SHA1,
        kvno=1,
        cipher=b"\xde\xad\xbe\xef",
    )
    tback = krb5.Ticket.decode(tkt.encode())
    assert tback.sname == ["kafka", "broker.example.com"]
    assert tback.cipher == b"\xde\xad\xbe\xef"

    req = krb5.ApReq(tkt, b"ciphertext", krb5.AES256_CTS_HMAC_SHA1)
    rback = krb5.ApReq.decode(req.encode())
    assert rback.ticket.realm == "EXAMPLE.COM"
    assert rback.ap_options & krb5.AP_OPTION_MUTUAL_REQUIRED


def test_gss_framing():
    tok = krb5.gss_frame(krb5.TOK_AP_REQ, b"payload")
    tok_id, inner = krb5.gss_unframe(tok)
    assert tok_id == krb5.TOK_AP_REQ and inner == b"payload"
    with pytest.raises(krb5.DerError):
        krb5.gss_unframe(b"\x30\x03abc")


# ------------------------------------------------- KDC-in-test fixture

REALM = "EXAMPLE.COM"
SERVICE = f"kafka/broker.example.com@{REALM}"


def mint(auth_password="svc-pw", cname=("alice",), life=3600.0, skew=0.0):
    """Play KDC: build (keytab, ticket, session_key) for a client."""
    import os

    keytab = krb5.Keytab()
    sk = keytab.add_password(SERVICE, auth_password)
    session = os.urandom(32)
    now = time.time() + skew
    enc = krb5.EncTicketPart(
        session_key=session,
        key_etype=krb5.AES256_CTS_HMAC_SHA1,
        crealm=REALM,
        cname=list(cname),
        authtime=now,
        endtime=now + life,
    )
    tkt = krb5.Ticket(
        realm=REALM,
        sname=["kafka", "broker.example.com"],
        etype=sk.etype,
        kvno=sk.kvno,
        cipher=krb5.encrypt(sk.key, krb5.KU_TICKET, enc.encode()),
    )
    return keytab, tkt, session


def run_handshake(keytab, tkt, session, cname=("alice",), rules=None,
                  authzid=""):
    auth = GssapiAuthenticator(
        keytab, SERVICE, principal_mapping_rules=rules
    )
    ex = auth.new_exchange()
    client = GssapiClient(tkt, session, list(cname), REALM)
    ap_rep = ex.step(client.initial_token())
    client.verify_ap_rep(ap_rep)
    offer = ex.step(b"")
    final = ex.step(client.negotiate(offer, authzid=authzid))
    assert final == b"" and ex.done
    return ex


def test_full_handshake_maps_principal():
    keytab, tkt, session = mint()
    ex = run_handshake(keytab, tkt, session)
    assert ex.kerberos_principal == f"alice@{REALM}"
    assert ex.username == "alice"  # DEFAULT rule, matching realm


def test_handshake_with_mapping_rules():
    keytab, tkt, session = mint(cname=("App.svc", "h1"))
    ex = run_handshake(
        keytab,
        tkt,
        session,
        cname=("App.svc", "h1"),
        rules=[r"RULE:[2:$1](App\..*)s/App\.(.*)/$1/g", "DEFAULT"],
    )
    assert ex.username == "svc"


def test_wrong_service_key_rejected():
    keytab, tkt, session = mint()
    # a keytab holding a different password cannot decrypt the ticket
    bad = krb5.Keytab()
    bad.add_password(SERVICE, "not-the-password")
    auth = GssapiAuthenticator(bad, SERVICE)
    client = GssapiClient(tkt, session, ["alice"], REALM)
    with pytest.raises(GssapiError, match="ticket decryption"):
        auth.new_exchange().step(client.initial_token())


def test_expired_ticket_rejected():
    keytab, tkt, session = mint(life=10.0, skew=-4000.0)
    auth = GssapiAuthenticator(keytab, SERVICE)
    client = GssapiClient(tkt, session, ["alice"], REALM)
    with pytest.raises(GssapiError, match="expired"):
        auth.new_exchange().step(client.initial_token())


def test_replay_rejected():
    keytab, tkt, session = mint()
    auth = GssapiAuthenticator(keytab, SERVICE)
    client = GssapiClient(tkt, session, ["alice"], REALM)
    token = client.initial_token()
    auth.new_exchange().step(token)
    with pytest.raises(GssapiError, match="replay"):
        auth.new_exchange().step(token)


def test_authzid_mismatch_rejected():
    keytab, tkt, session = mint()
    auth = GssapiAuthenticator(keytab, SERVICE)
    ex = auth.new_exchange()
    client = GssapiClient(tkt, session, ["alice"], REALM)
    client.verify_ap_rep(ex.step(client.initial_token()))
    offer = ex.step(b"")
    with pytest.raises(GssapiError, match="authzid"):
        ex.step(client.negotiate(offer, authzid="mallory"))


def test_tampered_ap_req_rejected():
    keytab, tkt, session = mint()
    auth = GssapiAuthenticator(keytab, SERVICE)
    client = GssapiClient(tkt, session, ["alice"], REALM)
    tok = bytearray(client.initial_token())
    tok[-5] ^= 0x40  # flip a bit inside the authenticator ciphertext
    with pytest.raises(GssapiError):
        auth.new_exchange().step(bytes(tok))


def test_unmapped_principal_rejected():
    keytab, tkt, session = mint(cname=("bob",))
    auth = GssapiAuthenticator(
        keytab, SERVICE, principal_mapping_rules=["RULE:[1:$1](alice)"]
    )
    ex = auth.new_exchange()
    client = GssapiClient(tkt, session, ["bob"], REALM)
    client.verify_ap_rep(ex.step(client.initial_token()))
    offer = ex.step(b"")
    with pytest.raises(GssapiError, match="no auth_to_local rule"):
        ex.step(client.negotiate(offer))


# -- kafka listener e2e ------------------------------------------------


def test_gssapi_kafka_e2e(tmp_path):
    """Full SASL/GSSAPI over the real kafka listener: broker configured
    with a JSON keytab, client holding a KDC-minted ticket (the test is
    the KDC) authenticates, produces and fetches; a forged ticket is
    rejected (gssapi_authenticator.cc's role, end to end)."""
    import asyncio
    import json

    from redpanda_tpu_torch.app import Broker, BrokerConfig
    from redpanda_tpu_torch.kafka.client import KafkaClient, KafkaClientError
    from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

    keytab_path = tmp_path / "keytab.json"
    keytab_path.write_text(
        json.dumps([{"principal": SERVICE, "password": "svc-pw"}])
    )

    async def main():
        net = LoopbackNetwork()
        b = Broker(
            BrokerConfig(
                device="cpu",
                node_id=0,
                data_dir=str(tmp_path / "n0"),
                members=[0],
                election_timeout_s=0.15,
                heartbeat_interval_s=0.03,
                enable_sasl=True,
                superusers=["alice"],
                gssapi_principal=SERVICE,
                gssapi_keytab_file=str(keytab_path),
                gssapi_principal_mapping_rules=["DEFAULT"],
            ),
            loopback=net,
        )
        await b.start()
        b.config.peer_kafka_addresses = {0: b.kafka_advertised}
        await b.wait_controller_leader()
        try:
            _, tkt, session = mint()

            def fresh_client():
                return GssapiClient(tkt, session, ["alice"], REALM)

            c = KafkaClient(
                [b.kafka_advertised], gssapi_factory=fresh_client
            )
            await c.create_topic("krb", partitions=1)
            await c.produce("krb", 0, [(b"k", b"v")])
            records = await c.fetch("krb", 0, 0)  # [(offset, key, value)]
            assert [(bytes(k), bytes(v)) for _, k, v in records] == [
                (b"k", b"v")
            ]
            await c.close()

            # wrong session key (forged ticket): authentication fails
            _, tkt2, _ = mint(auth_password="other-pw")
            bad = KafkaClient(
                [b.kafka_advertised],
                gssapi_factory=lambda: GssapiClient(
                    tkt2, session, ["mallory"], REALM
                ),
            )
            with pytest.raises((KafkaClientError, Exception)):
                await bad.create_topic("nope", partitions=1)
            await bad.close()
        finally:
            await b.stop()

    asyncio.run(main())
