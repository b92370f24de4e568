"""tests/test_abs_client.py run on the port: all 4 test functions, with
imports pointed at redpanda_tpu_torch. Every broker is the port's on the
CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.


Azure Blob client + SharedKey auth against the in-process imposter.

Reference model: cloud_storage_clients/tests abs coverage.
"""

import asyncio

import pytest

from redpanda_tpu_torch.cloud.abs_client import AbsObjectStore
from redpanda_tpu_torch.cloud.object_store import StoreError

from abs_imposter import AbsImposter
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


async def _mk():
    imp = AbsImposter()
    await imp.start()
    store = AbsObjectStore(
        "127.0.0.1", imp.port, "acct", imp.key_b64, "cont"
    )
    return imp, store


async def _roundtrip():
    imp, store = await _mk()
    try:
        await store.put("seg/a 0.log", b"alpha" * 50)  # space in key
        await store.put("seg/a-1.log", b"beta")
        await store.put("m.json", b"{}")
        assert await store.get("seg/a 0.log") == b"alpha" * 50
        assert await store.exists("seg/a-1.log")
        assert not await store.exists("ghost")
        await store.put("seg/a-2.log", b"x")
        await store.put("seg/a-3.log", b"x")
        keys = await store.list("seg/")
        assert len(keys) == 4 and keys == sorted(keys)  # marker paging
        await store.delete("seg/a-1.log")
        assert not await store.exists("seg/a-1.log")
        with pytest.raises(StoreError, match="not found"):
            await store.get("seg/a-1.log")
    finally:
        await store.close()
        await imp.stop()


def test_abs_roundtrip_signed():
    asyncio.run(_roundtrip())


async def _bad_key():
    imp = AbsImposter()
    await imp.start()
    store = AbsObjectStore(
        "127.0.0.1", imp.port, "acct", "d3Jvbmcta2V5", "cont"  # wrong key
    )
    try:
        with pytest.raises(StoreError):
            await store.put("k", b"v")
        assert imp.blobs == {}
    finally:
        await store.close()
        await imp.stop()


def test_abs_bad_key_rejected():
    asyncio.run(_bad_key())


async def _retries():
    from redpanda_tpu_torch.cloud.object_store import RetryingStore

    imp, inner = await _mk()
    store = RetryingStore(inner, attempts=4, base_backoff_s=0.01)
    try:
        imp.fail_next = 2
        await store.put("k", b"v")
        assert imp.blobs["k"] == b"v"
    finally:
        await store.close()
        await imp.stop()


def test_abs_retry_through_500s():
    asyncio.run(_retries())


async def _tiered(tmp_path):
    """Archival + remote read over the ABS wire (store injected — the
    endpoint/bucket config path is S3; ABS slots in via the same
    ObjectStore seam)."""
    from redpanda_tpu_torch.app import Broker, BrokerConfig
    from redpanda_tpu_torch.kafka.client import KafkaClient
    from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

    imp, store = await _mk()
    b = Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            archival_interval_s=0.2,
        ),
        loopback=LoopbackNetwork(),
        object_store=store,
    )
    await b.start()
    c = KafkaClient([b.kafka_advertised])
    try:
        await c.create_topic(
            "abs",
            partitions=1,
            replication_factor=1,
            configs={
                "redpanda.remote.write": "true",
                "segment.bytes": "2048",
            },
        )
        for i in range(30):
            await c.produce("abs", 0, [(b"k%d" % i, b"v" * 200)])
        deadline = asyncio.get_event_loop().time() + 15
        while not any(k.endswith(".seg") for k in imp.blobs):
            assert asyncio.get_event_loop().time() < deadline
            await asyncio.sleep(0.1)
        assert any("manifest" in k for k in imp.blobs)
    finally:
        await c.close()
        await b.stop()
        await imp.stop()


def test_tiered_storage_over_abs(tmp_path):
    asyncio.run(_tiered(tmp_path))
