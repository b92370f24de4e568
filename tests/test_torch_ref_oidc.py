"""tests/test_oidc.py run on the port: all 10 test functions, with
imports pointed at redpanda_tpu_torch. Every broker is the port's on the
CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.


OIDC / SASL OAUTHBEARER authentication tests.

Reference test model: src/v/security/tests/jwt_test.cc (validation
matrix over signature/issuer/audience/temporal claims) and
rptest/tests/sasl_oauthbearer-style e2e: a client presenting a JWT
minted by the configured issuer authenticates and is authorized by
principal ACLs; everything else is rejected at the SASL layer.
"""

import asyncio
import contextlib
import json
import time

import pytest
from cryptography.hazmat.primitives.asymmetric import ec, rsa

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.kafka.client import KafkaClient, KafkaClientError
from redpanda_tpu_torch.kafka.protocol import ErrorCode
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
from redpanda_tpu_torch.security.acl import (
    AclBinding,
    AclOperation,
    AclPatternType,
    AclPermission,
    AclResourceType,
)
from redpanda_tpu_torch.security.oidc import (
    OauthBearerExchange,
    OidcAuthenticator,
    OidcConfig,
    OidcError,
    client_first_message,
    jwk_from_public_key,
    parse_client_first,
    sign_jwt,
)
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")

ISSUER = "https://issuer.test"
AUDIENCE = "redpanda"


@pytest.fixture(scope="module")
def rsa_key():
    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


@pytest.fixture(scope="module")
def ec_key():
    return ec.generate_private_key(ec.SECP256R1())


def _claims(**over):
    base = {
        "iss": ISSUER,
        "aud": AUDIENCE,
        "sub": "svc-producer",
        "exp": int(time.time()) + 600,
        "iat": int(time.time()),
    }
    base.update(over)
    return {k: v for k, v in base.items() if v is not None}


def _auth(rsa_key, extra_keys=(), **cfg_over):
    jwks = {"keys": [jwk_from_public_key(rsa_key.public_key(), "k1"), *extra_keys]}
    cfg = dict(issuer=ISSUER, audience=AUDIENCE, jwks=jwks)
    cfg.update(cfg_over)
    return OidcAuthenticator(OidcConfig(**cfg))


# -- validation matrix ------------------------------------------------


def test_good_token_rs256(rsa_key):
    auth = _auth(rsa_key)
    tok = sign_jwt(rsa_key, _claims(), "k1")
    assert auth.authenticate(tok) == "svc-producer"


def test_good_token_es256(ec_key):
    jwks = {"keys": [jwk_from_public_key(ec_key.public_key(), "e1")]}
    auth = OidcAuthenticator(OidcConfig(ISSUER, AUDIENCE, jwks))
    tok = sign_jwt(ec_key, _claims(), "e1", alg="ES256")
    assert auth.authenticate(tok) == "svc-producer"


def test_rejections(rsa_key, ec_key):
    auth = _auth(rsa_key)
    cases = {
        "expired": sign_jwt(rsa_key, _claims(exp=int(time.time()) - 120), "k1"),
        "not yet valid": sign_jwt(
            rsa_key, _claims(nbf=int(time.time()) + 600), "k1"
        ),
        "wrong issuer": sign_jwt(rsa_key, _claims(iss="https://evil"), "k1"),
        "wrong audience": sign_jwt(rsa_key, _claims(aud="other"), "k1"),
        "missing exp": sign_jwt(rsa_key, _claims(exp=None), "k1"),
        "unknown kid": sign_jwt(rsa_key, _claims(), "nope"),
        "wrong key": sign_jwt(
            rsa.generate_private_key(public_exponent=65537, key_size=2048),
            _claims(),
            "k1",
        ),
    }
    for name, tok in cases.items():
        with pytest.raises(OidcError):
            auth.authenticate(tok)
        # and through the SASL exchange wrapper — which must stay
        # retryable after a rejected token
        ex = OauthBearerExchange(auth)
        with pytest.raises(OidcError):
            ex.handle_client_first(client_first_message(tok))
        assert not ex.done and ex.state == "start", name
        good = sign_jwt(rsa_key, _claims(), "k1")
        ex.handle_client_first(client_first_message(good))
        assert ex.done and ex.username == "svc-producer", name
        assert ex.expires_at is not None and ex.expires_at > time.time()


def test_aud_list_matches(rsa_key):
    auth = _auth(rsa_key)
    tok = sign_jwt(rsa_key, _claims(aud=["other", AUDIENCE]), "k1")
    assert auth.authenticate(tok) == "svc-producer"


def test_alg_none_and_hmac_confusion_rejected(rsa_key):
    """alg:none and HS256 (signed with the public key bytes) must be
    rejected before any verification is attempted."""
    import base64
    import hashlib
    import hmac as hmac_mod

    auth = _auth(rsa_key)

    def enc(d: bytes) -> str:
        return base64.urlsafe_b64encode(d).rstrip(b"=").decode()

    payload = enc(json.dumps(_claims()).encode())
    none_tok = (
        enc(json.dumps({"alg": "none", "kid": "k1"}).encode()) + "." + payload + "."
    )
    with pytest.raises(OidcError, match="alg"):
        auth.authenticate(none_tok)

    hs_header = enc(json.dumps({"alg": "HS256", "kid": "k1"}).encode())
    signing_input = f"{hs_header}.{payload}".encode()
    fake_sig = hmac_mod.new(b"public-key-bytes", signing_input, hashlib.sha256)
    hs_tok = f"{hs_header}.{payload}." + enc(fake_sig.digest())
    with pytest.raises(OidcError, match="alg"):
        auth.authenticate(hs_tok)


def test_principal_claim_config(rsa_key):
    auth = _auth(rsa_key, principal_claim="azp")
    tok = sign_jwt(rsa_key, _claims(azp="client-7"), "k1")
    assert auth.authenticate(tok) == "client-7"
    with pytest.raises(OidcError, match="azp"):
        auth.authenticate(sign_jwt(rsa_key, _claims(), "k1"))


def test_client_first_message_roundtrip():
    msg = client_first_message("tok.abc.def")
    assert parse_client_first(msg) == "tok.abc.def"
    with pytest.raises(OidcError):
        parse_client_first(b"n,,\x01host=x\x01\x01")
    with pytest.raises(OidcError):
        parse_client_first(b"n,,\x01auth=Basic zzz\x01\x01")


# -- e2e: OAUTHBEARER against a real broker ---------------------------


@contextlib.asynccontextmanager
async def oidc_cluster(tmp_path, rsa_key):
    jwks_path = str(tmp_path / "jwks.json")
    with open(jwks_path, "w") as f:
        json.dump({"keys": [jwk_from_public_key(rsa_key.public_key(), "k1")]}, f)
    b = Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
            enable_sasl=True,
            superusers=["boss"],
            oidc_issuer=ISSUER,
            oidc_audience=AUDIENCE,
            oidc_jwks_file=jwks_path,
        ),
        loopback=LoopbackNetwork(),
    )
    await b.start()
    b.config.peer_kafka_addresses = {0: b.kafka_advertised}
    await b.wait_controller_leader()
    try:
        yield b
    finally:
        await b.stop()


async def _oauthbearer_e2e(tmp_path, rsa_key):
    async with oidc_cluster(tmp_path, rsa_key) as b:
        boss_tok = sign_jwt(rsa_key, _claims(sub="boss"), "k1")
        boss = KafkaClient(
            [b.kafka_advertised], sasl=("", boss_tok, "OAUTHBEARER")
        )
        await boss.create_topic("t", partitions=1, replication_factor=1)
        await boss.produce("t", 0, [(b"k", b"v")])
        got = await boss.fetch("t", 0, 0)
        assert [(k, v) for _o, k, v in got] == [(b"k", b"v")]
        await boss.close()

        # valid token, non-superuser principal, no ACLs: authn ok,
        # authz denied
        alice_tok = sign_jwt(rsa_key, _claims(sub="alice"), "k1")
        alice = KafkaClient(
            [b.kafka_advertised], sasl=("", alice_tok, "OAUTHBEARER")
        )
        with pytest.raises(KafkaClientError) as ei:
            await alice.produce("t", 0, [(b"x", b"y")])
        assert ei.value.code == int(ErrorCode.topic_authorization_failed)

        # ACL grant to the JWT-derived principal unlocks produce —
        # OIDC principals and SCRAM principals share the ACL space
        await b.controller.create_acls(
            [
                AclBinding(
                    AclResourceType.topic,
                    AclPatternType.literal,
                    "t",
                    "User:alice",
                    "*",
                    AclOperation.all,
                    AclPermission.allow,
                )
            ]
        )
        assert await alice.produce("t", 0, [(b"x", b"y")]) == 1
        await alice.close()

        # expired token fails at the SASL layer
        stale = sign_jwt(rsa_key, _claims(exp=int(time.time()) - 120), "k1")
        bad = KafkaClient([b.kafka_advertised], sasl=("", stale, "OAUTHBEARER"))
        with pytest.raises(KafkaClientError) as ei:
            await bad.metadata()
        assert ei.value.code == int(ErrorCode.sasl_authentication_failed)
        await bad.close()

        # SCRAM still works side by side on the same listener
        from redpanda_tpu_torch.security.scram import encode_credential, make_credential

        await b.controller.create_user(
            "scramuser", encode_credential(make_credential("pw"))
        )
        await b.controller.create_acls(
            [
                AclBinding(
                    AclResourceType.topic,
                    AclPatternType.literal,
                    "t",
                    "User:scramuser",
                    "*",
                    AclOperation.read,
                    AclPermission.allow,
                )
            ]
        )
        sc = KafkaClient(
            [b.kafka_advertised], sasl=("scramuser", "pw", "SCRAM-SHA-256")
        )
        got = await sc.fetch("t", 0, 0)
        assert len(got) == 2
        await sc.close()


def test_oauthbearer_e2e(tmp_path, rsa_key):
    asyncio.run(_oauthbearer_e2e(tmp_path, rsa_key))


def test_partial_oidc_config_rejected(tmp_path):
    """1-2 of the three OIDC fields set must fail startup loudly, not
    silently run without OAUTHBEARER."""
    with pytest.raises(ValueError, match="OIDC config incomplete"):
        Broker(
            BrokerConfig(
                device="cpu",
                node_id=0,
                data_dir=str(tmp_path / "n0"),
                members=[0],
                oidc_issuer=ISSUER,  # audience + jwks missing
            ),
            loopback=LoopbackNetwork(),
        )


async def _session_bounded_by_exp(tmp_path, rsa_key):
    async with oidc_cluster(tmp_path, rsa_key) as b:
        # the session must die at the token's exp even though the
        # connection stays up. Deterministic: authenticate with a
        # 60s token, then advance the SERVER's clock past exp instead
        # of racing a short-lived token against suite load.
        import redpanda_tpu_torch.kafka.server as kserver

        exp = int(time.time()) + 60
        tok = sign_jwt(rsa_key, _claims(sub="boss", exp=exp), "k1")
        c = KafkaClient([b.kafka_advertised], sasl=("", tok, "OAUTHBEARER"))
        await c.create_topic("t2", partitions=1, replication_factor=1)
        await c.produce("t2", 0, [(b"k", b"v")])
        real_time = kserver.time.time
        kserver.time = type(
            "T", (), {"time": staticmethod(lambda: real_time() + 120)}
        )()
        try:
            with pytest.raises(Exception):  # broker closes the connection
                await c.produce("t2", 0, [(b"k2", b"v2")])
        finally:
            import time as _time

            kserver.time = _time
        await c.close()


def test_session_bounded_by_token_exp(tmp_path, rsa_key):
    asyncio.run(_session_bounded_by_exp(tmp_path, rsa_key))
