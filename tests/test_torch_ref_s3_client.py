"""tests/test_s3_client.py run on the port: all 9 test functions, with
imports pointed at redpanda_tpu_torch. Every broker is the port's on the
CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.


S3 client + SigV4 + HTTP client against the in-process imposter.

Reference coverage model: cloud_storage_clients/tests/s3_client_test
over s3_imposter, cloud_roles signature tests.
"""

import asyncio
import time

import pytest

from redpanda_tpu_torch.cloud.object_store import StoreError
from redpanda_tpu_torch.cloud.s3_client import (
    Credentials,
    RefreshingCredentialsProvider,
    S3ObjectStore,
    StaticCredentialsProvider,
)
from redpanda_tpu_torch.cloud.signature import sign_request, verify_request

from s3_imposter import S3Imposter
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def test_sigv4_known_vector():
    """AWS documentation test vector (GET iam, us-east-1) — proves the
    canonicalization/derivation math against a published constant."""
    headers = {
        "host": "iam.amazonaws.com",
        "content-type": "application/x-www-form-urlencoded; charset=utf-8",
    }
    out = sign_request(
        "AKIDEXAMPLE",
        "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
        "us-east-1",
        "GET",
        "/?Action=ListUsers&Version=2010-05-08",
        headers,
        b"",
        service="iam",
        date="20150830T123600Z",
    )
    # the signature from the AWS sigv4 test suite for this request
    assert out["authorization"].endswith(
        "Signature=dd479fa8a80364edf2119ec24bebde66712ee9c9cb2b0d92eb3ab9ccdc0c3947"
    ), out["authorization"]


def test_sigv4_sign_verify_mismatch_cases():
    headers = {"host": "h:1"}
    signed = sign_request("AK", "SK", "r1", "PUT", "/b/k", headers, b"data")
    ok = verify_request(
        lambda a: "SK" if a == "AK" else None, "PUT", "/b/k", signed, b"data"
    )
    assert ok == "AK"
    # tampered body
    assert (
        verify_request(lambda a: "SK", "PUT", "/b/k", signed, b"datX") is None
    )
    # wrong secret
    assert (
        verify_request(lambda a: "EVIL", "PUT", "/b/k", signed, b"data") is None
    )
    # tampered path
    assert (
        verify_request(lambda a: "SK", "PUT", "/b/other", signed, b"data")
        is None
    )
    # replayed (stale) request: signature math checks out but the
    # x-amz-date is outside the skew window — must not verify forever
    stale = sign_request(
        "AK", "SK", "r1", "PUT", "/b/k", {"host": "h:1"}, b"data",
        date="20150830T123600Z",
    )
    assert verify_request(lambda a: "SK", "PUT", "/b/k", stale, b"data") is None
    # ...and a narrow skew rejects an otherwise-fresh request
    assert (
        verify_request(
            lambda a: "SK", "PUT", "/b/k", signed, b"data", clock_skew_s=-1
        )
        is None
    )


async def _roundtrip():
    imp = S3Imposter()
    await imp.start()
    store = S3ObjectStore(
        "127.0.0.1",
        imp.port,
        "bkt",
        StaticCredentialsProvider("AK", "SK"),
    )
    try:
        await store.put("seg/a-0.log", b"alpha" * 100)
        await store.put("seg/a-1.log", b"beta")
        await store.put("manifest.json", b"{}")
        assert await store.get("seg/a-0.log") == b"alpha" * 100
        assert await store.exists("seg/a-1.log")
        assert not await store.exists("nope")
        # 5 keys through page size 2 -> continuation tokens exercised
        await store.put("seg/a-2.log", b"x")
        await store.put("seg/a-3.log", b"x")
        keys = await store.list("seg/")
        assert keys == sorted(keys) and len(keys) == 4
        assert await store.list("") == sorted(imp.objects)
        await store.delete("seg/a-1.log")
        assert not await store.exists("seg/a-1.log")
        with pytest.raises(StoreError, match="not found"):
            await store.get("seg/a-1.log")
    finally:
        await store.close()
        await imp.stop()


def test_s3_roundtrip_signed():
    asyncio.run(_roundtrip())


async def _bad_creds():
    imp = S3Imposter()
    await imp.start()
    store = S3ObjectStore(
        "127.0.0.1", imp.port, "bkt", StaticCredentialsProvider("AK", "WRONG")
    )
    try:
        with pytest.raises(StoreError):
            await store.put("k", b"v")
        assert imp.objects == {}
    finally:
        await store.close()
        await imp.stop()


def test_bad_credentials_rejected():
    asyncio.run(_bad_creds())


async def _rotation():
    imp = S3Imposter()
    await imp.start()
    fetches = []

    async def fetch():
        fetches.append(1)
        # first credential expires immediately; the second is good
        if len(fetches) == 1:
            return Credentials("AK", "SK", expires_at=time.time() + 0.01)
        return Credentials("AK", "SK", expires_at=time.time() + 3600)

    store = S3ObjectStore(
        "127.0.0.1",
        imp.port,
        "bkt",
        RefreshingCredentialsProvider(fetch, refresh_ahead_s=0.5),
    )
    try:
        await store.put("k1", b"v")
        await asyncio.sleep(0.05)
        await store.put("k2", b"v")  # triggers refresh
        assert len(fetches) >= 2
        assert set(imp.objects) == {"k1", "k2"}
    finally:
        await store.close()
        await imp.stop()


def test_credential_rotation():
    asyncio.run(_rotation())


async def _retries():
    imp = S3Imposter()
    await imp.start()
    from redpanda_tpu_torch.cloud.object_store import RetryingStore

    store = RetryingStore(
        S3ObjectStore(
            "127.0.0.1", imp.port, "bkt", StaticCredentialsProvider("AK", "SK")
        ),
        attempts=4,
        base_backoff_s=0.01,
    )
    try:
        imp.fail_next = 2  # two 500s, then success
        await store.put("k", b"v")
        assert imp.objects["k"] == b"v"
    finally:
        await imp.stop()


def test_retry_through_injected_500s():
    asyncio.run(_retries())


async def _special_keys():
    imp = S3Imposter()
    await imp.start()
    store = S3ObjectStore(
        "127.0.0.1", imp.port, "bkt", StaticCredentialsProvider("AK", "SK")
    )
    try:
        # reserved characters exercise the canonical-URI rule (the
        # path is encoded ONCE as sent; re-encoding it in the
        # signature turns %20 into %2520 and real S3 rejects it)
        for key in ("a b/c+d.seg", "x=y&z.bin", "pct%41.seg"):
            await store.put(key, key.encode())
            assert await store.get(key) == key.encode()
            assert await store.exists(key)
    finally:
        await store.close()
        await imp.stop()


def test_keys_with_reserved_characters():
    asyncio.run(_special_keys())


async def _stale_keepalive():
    imp = S3Imposter()
    await imp.start()
    from redpanda_tpu_torch.cloud.object_store import RetryingStore

    store = RetryingStore(
        S3ObjectStore(
            "127.0.0.1", imp.port, "bkt", StaticCredentialsProvider("AK", "SK")
        ),
        attempts=3,
        base_backoff_s=0.01,
    )
    try:
        await store.put("k", b"v")
        # server drops every keep-alive connection: the pooled socket
        # is stale; the failure must surface as a retriable StoreError,
        # not escape as HttpError/IncompleteReadError
        for w in list(imp._writers):
            w.close()
        await asyncio.sleep(0.02)
        assert await store.get("k") == b"v"  # retried on a fresh conn
    finally:
        await store.close()
        await imp.stop()


def test_stale_keepalive_connection_retried():
    asyncio.run(_stale_keepalive())


async def _tiered_e2e(tmp_path):
    """Full tiered storage over the S3 wire: archive to the imposter,
    prefix-truncate locally, serve the old data via remote reads."""
    from redpanda_tpu_torch.app import Broker, BrokerConfig
    from redpanda_tpu_torch.kafka.client import KafkaClient
    from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

    imp = S3Imposter()
    await imp.start()
    b = Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            archival_interval_s=0.2,
            cloud_storage_endpoint=f"127.0.0.1:{imp.port}",
            cloud_storage_bucket="bkt",
            cloud_storage_access_key="AK",
            cloud_storage_secret_key="SK",
        ),
        loopback=LoopbackNetwork(),
    )
    await b.start()
    c = KafkaClient([b.kafka_advertised])
    try:
        await c.create_topic(
            "arch",
            partitions=1,
            replication_factor=1,
            configs={
                "redpanda.remote.write": "true",
                "redpanda.remote.read": "true",
                "segment.bytes": "2048",
            },
        )
        for i in range(40):
            await c.produce("arch", 0, [(b"k%d" % i, b"v" * 200)])
        deadline = asyncio.get_event_loop().time() + 15
        while not any(k.endswith(".seg") for k in imp.objects):
            assert asyncio.get_event_loop().time() < deadline, (
                "nothing archived to S3"
            )
            await asyncio.sleep(0.1)
        assert any("manifest" in k for k in imp.objects)
        recs = await c.fetch("arch", 0, 0)
        assert len(recs) >= 40
    finally:
        await c.close()
        await b.stop()
        await imp.stop()


def test_tiered_storage_over_s3_wire(tmp_path):
    asyncio.run(_tiered_e2e(tmp_path))
