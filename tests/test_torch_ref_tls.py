"""tests/test_tls.py run on the port: all 4 test functions, with imports
pointed at redpanda_tpu_torch. Every broker is the port's on the CPU
(`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
`broker_cluster` comes from `test_torch_ref_kafka_e2e`. Nothing is left
out.


TLS + mTLS on the kafka listener.

Reference model: security/mtls.{h,cc} principal mapping and the
per-listener tls_config. Certs are minted with the system openssl —
an independent implementation of the X.509 machinery.
"""

import asyncio
import subprocess

import pytest

from redpanda_tpu_torch.kafka.client import KafkaClient
from redpanda_tpu_torch.security.tls import PrincipalMapper, client_context

from test_torch_ref_kafka_e2e import broker_cluster  # noqa: F401  (fixture helpers)
from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def make_certs(d, clients=("alice",)):
    """CA + server cert (CN=127.0.0.1 w/ SAN) + one cert per client CN."""

    def run(*args, **kw):
        subprocess.run(args, check=True, capture_output=True, **kw)

    ca_key, ca = f"{d}/ca.key", f"{d}/ca.pem"
    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
        "-keyout", ca_key, "-out", ca, "-days", "2", "-subj", "/CN=test-ca")
    certs = {}
    for cn, san in [("127.0.0.1", "IP:127.0.0.1")] + [
        (c, None) for c in clients
    ]:
        key, csr, crt = f"{d}/{cn}.key", f"{d}/{cn}.csr", f"{d}/{cn}.pem"
        run("openssl", "req", "-newkey", "rsa:2048", "-nodes",
            "-keyout", key, "-out", csr,
            "-subj", f"/O=redpanda-tpu/OU=clients/CN={cn}")
        ext = []
        if san:
            extfile = f"{d}/{cn}.ext"
            open(extfile, "w").write(f"subjectAltName={san}\n")
            ext = ["-extfile", extfile]
        run("openssl", "x509", "-req", "-in", csr, "-CA", ca,
            "-CAkey", ca_key, "-CAcreateserial", "-out", crt,
            "-days", "2", *ext)
        certs[cn] = (crt, key)
    return ca, certs


async def _tls_roundtrip(tmp_path):
    ca, certs = make_certs(str(tmp_path))
    srv_crt, srv_key = certs["127.0.0.1"]
    b = Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            kafka_tls_cert=srv_crt,
            kafka_tls_key=srv_key,
        ),
        loopback=LoopbackNetwork(),
    )
    await b.start()
    try:
        c = KafkaClient(
            [b.kafka_advertised], ssl=client_context(ca=ca)
        )
        await c.create_topic("sec", partitions=1, replication_factor=1)
        await c.produce("sec", 0, [(b"k", b"encrypted")])
        got = await c.fetch("sec", 0, 0)
        assert [(k, v) for _o, k, v in got] == [(b"k", b"encrypted")]
        await c.close()

        # a plaintext client cannot speak to a TLS listener
        plain = KafkaClient([b.kafka_advertised])
        with pytest.raises(Exception):
            await asyncio.wait_for(plain.metadata(), timeout=3)
        await plain.close()
    finally:
        await b.stop()


def test_tls_listener(tmp_path):
    asyncio.run(_tls_roundtrip(tmp_path))


async def _mtls(tmp_path):
    ca, certs = make_certs(str(tmp_path), clients=("alice", "mallory"))
    srv_crt, srv_key = certs["127.0.0.1"]
    b = Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            kafka_tls_cert=srv_crt,
            kafka_tls_key=srv_key,
            kafka_tls_ca=ca,
            kafka_tls_require_client_auth=True,
            mtls_principal_rules=[r"RULE:^CN=([^,]+).*$/$1/"],
            enable_authorization=True,
            superusers=["User:alice"],
        ),
        loopback=LoopbackNetwork(),
    )
    await b.start()
    try:
        # alice (superuser by cert CN) can do everything
        alice = KafkaClient(
            [b.kafka_advertised],
            ssl=client_context(ca=ca, cert=certs["alice"][0], key=certs["alice"][1]),
        )
        await alice.create_topic("mt", partitions=1, replication_factor=1)
        await alice.produce("mt", 0, [(b"k", b"v")])
        await alice.close()

        # mallory authenticates (valid cert) but is NOT authorized
        mallory = KafkaClient(
            [b.kafka_advertised],
            ssl=client_context(
                ca=ca, cert=certs["mallory"][0], key=certs["mallory"][1]
            ),
        )
        from redpanda_tpu_torch.kafka.client import KafkaClientError

        with pytest.raises(KafkaClientError):
            await mallory.produce("mt", 0, [(b"k", b"nope")])
        await mallory.close()

        # no client cert at all: the handshake itself fails
        anon = KafkaClient([b.kafka_advertised], ssl=client_context(ca=ca))
        with pytest.raises(Exception):
            await asyncio.wait_for(anon.metadata(), timeout=3)
        await anon.close()
    finally:
        await b.stop()


def test_mtls_principal_authorization(tmp_path):
    asyncio.run(_mtls(tmp_path))


async def _internal_services_under_tls(tmp_path):
    """In-broker clients (transforms) must keep working when the
    public listener is mTLS: they ride the loopback internal
    listener with the implicit broker principal."""
    from redpanda_tpu_torch.transforms import TransformSpec

    ca, certs = make_certs(str(tmp_path))
    srv_crt, srv_key = certs["127.0.0.1"]
    b = Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            kafka_tls_cert=srv_crt,
            kafka_tls_key=srv_key,
            kafka_tls_ca=ca,
            kafka_tls_require_client_auth=True,
            mtls_principal_rules=[r"RULE:^CN=([^,]+).*$/$1/"],
            enable_authorization=True,
            superusers=["User:alice"],
        ),
        loopback=LoopbackNetwork(),
    )
    await b.start()
    try:
        alice = KafkaClient(
            [b.kafka_advertised],
            ssl=client_context(
                ca=ca, cert=certs["alice"][0], key=certs["alice"][1]
            ),
        )
        await alice.create_topic("src", partitions=1, replication_factor=1)
        await alice.create_topic("dst", partitions=1, replication_factor=1)
        b.transforms.register(
            TransformSpec("tlsfan", "src", "dst", lambda k, v: (k, v.upper()))
        )
        await alice.produce("src", 0, [(b"k", b"secret")])
        deadline = asyncio.get_event_loop().time() + 15
        got = []
        while asyncio.get_event_loop().time() < deadline:
            got = await alice.fetch("dst", 0, 0)
            if got:
                break
            await asyncio.sleep(0.2)
        assert [(k, v) for _o, k, v in got] == [(b"k", b"SECRET")], got
        await alice.close()
    finally:
        await b.stop()


def test_internal_services_under_tls(tmp_path):
    asyncio.run(_internal_services_under_tls(tmp_path))


def test_principal_mapping_rules():
    cert = {
        "subject": (
            (("organizationName", "redpanda-tpu"),),
            (("organizationalUnitName", "clients"),),
            (("commonName", "Alice.Smith"),),
        )
    }
    assert PrincipalMapper().principal_for(cert) == (
        "CN=Alice.Smith,OU=clients,O=redpanda-tpu"
    )
    assert (
        PrincipalMapper([r"RULE:^CN=([^,]+).*$/$1/"]).principal_for(cert)
        == "Alice.Smith"
    )
    assert (
        PrincipalMapper([r"RULE:^CN=([^,]+).*$/$1/L"]).principal_for(cert)
        == "alice.smith"
    )
    # first matching rule wins; non-matching falls through to DEFAULT
    m = PrincipalMapper([r"RULE:^OU=x.*$/no/", "DEFAULT"])
    assert m.principal_for(cert).startswith("CN=Alice.Smith")
    with pytest.raises(ValueError):
        PrincipalMapper(["GARBAGE"])
