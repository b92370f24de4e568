"""tests/test_kafka_e2e.py run on the port: all 10 cases, with imports
pointed at redpanda_tpu_torch. Every broker is the port's on the CPU
(`BrokerConfig(device="cpu")`: the raft lanes and the kernels' plain
PyTorch versions), and an autouse fixture sets `ops.default_device` (the
codec and CRC entries' device) to "cpu". `broker_cluster` and
`client_for` are imported from here by `test_torch_ref_fused_codec.py`
and `test_torch_broker.py`. Nothing is left out.

End-to-end Kafka tests: full brokers in-process, real TCP kafka
listeners, loopback internal RPC.

Reference test model: redpanda/tests/fixture.h:63
(redpanda_thread_fixture boots a whole application),
cluster/tests/cluster_test_fixture.h (several applications in one
process), kafka/server/tests/produce_consume_test.cc.
"""

import asyncio
import contextlib

import pytest

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.kafka.client import KafkaClient, KafkaClientError
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


@contextlib.asynccontextmanager
async def broker_cluster(tmp_path, n: int):
    """N brokers over loopback internal RPC, real kafka TCP ports."""
    net = LoopbackNetwork()
    members = list(range(n))
    brokers = [
        Broker(
            BrokerConfig(
                device="cpu",
                node_id=i,
                data_dir=str(tmp_path / f"node{i}"),
                members=members,
                election_timeout_s=0.15,
                heartbeat_interval_s=0.03,
            ),
            loopback=net,
        )
        for i in members
    ]
    for b in brokers:
        await b.start()
    # static peer kafka address map (stage-7 members_table replaces it)
    addrs = {b.node_id: b.kafka_advertised for b in brokers}
    for b in brokers:
        b.config.peer_kafka_addresses = addrs
    try:
        await brokers[0].wait_controller_leader()
        yield brokers
    finally:
        for b in brokers:
            await b.stop()


@contextlib.asynccontextmanager
async def client_for(brokers):
    client = KafkaClient([b.kafka_advertised for b in brokers])
    try:
        yield client
    finally:
        await client.close()


async def _roundtrip(tmp_path, n_brokers, partitions, rf, acks):
    async with broker_cluster(tmp_path, n_brokers) as brokers:
        async with client_for(brokers) as client:
            await client.create_topic(
                "t1", partitions=partitions, replication_factor=rf
            )
            md = await client.metadata(["t1"])
            assert md.topics[0].error_code == 0
            assert len(md.topics[0].partitions) == partitions

            for p in range(partitions):
                base = await client.produce(
                    "t1",
                    p,
                    [(b"k%d" % i, b"v%d" % i) for i in range(10)],
                    acks=acks,
                )
                if acks != 0:
                    assert base == 0
            # fetch every partition back
            for p in range(partitions):
                got = await client.fetch("t1", p, 0)
                assert [(o, k) for o, k, _ in got] == [
                    (i, b"k%d" % i) for i in range(10)
                ]
                assert got[5][2] == b"v5"


def test_single_broker_roundtrip(tmp_path):
    asyncio.run(_roundtrip(tmp_path, 1, 1, 1, acks=-1))


def test_single_broker_multi_partition(tmp_path):
    asyncio.run(_roundtrip(tmp_path, 1, 3, 1, acks=-1))


def test_three_broker_rf3_acks_all(tmp_path):
    asyncio.run(_roundtrip(tmp_path, 3, 3, 3, acks=-1))


def test_acks_one(tmp_path):
    asyncio.run(_roundtrip(tmp_path, 1, 1, 1, acks=1))


def test_list_offsets_and_empty_fetch(tmp_path):
    async def run():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                await client.create_topic("t2", partitions=1)
                assert await client.list_offset("t2", 0, -2) == 0  # earliest
                assert await client.list_offset("t2", 0, -1) == 0  # latest
                assert await client.fetch("t2", 0, 0, max_wait_ms=10) == []
                await client.produce("t2", 0, [(None, b"x")] * 5)
                assert await client.list_offset("t2", 0, -1) == 5
                got = await client.fetch("t2", 0, 3)
                assert [o for o, _, _ in got] == [3, 4]

    asyncio.run(run())


def test_create_errors(tmp_path):
    async def run():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                await client.create_topic("dup", partitions=1)
                with pytest.raises(KafkaClientError) as ei:
                    await client.create_topic("dup", partitions=1)
                assert ei.value.code == 36  # topic_already_exists
                with pytest.raises(KafkaClientError):
                    await client.create_topic("bad-rf", replication_factor=3)

    asyncio.run(run())


def test_unknown_topic_errors(tmp_path):
    async def run():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                with pytest.raises(KafkaClientError):
                    await client.produce("nope", 0, [(None, b"v")])
                with pytest.raises(KafkaClientError):
                    await client.fetch("nope", 0, 0)

    asyncio.run(run())


def test_offset_out_of_range(tmp_path):
    async def run():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                await client.create_topic("t3", partitions=1)
                await client.produce("t3", 0, [(None, b"a")])
                with pytest.raises(KafkaClientError) as ei:
                    await client.fetch("t3", 0, 99)
                assert ei.value.code == 1  # offset_out_of_range

    asyncio.run(run())


def test_long_poll_fetch_wakes_on_produce(tmp_path):
    async def run():
        async with broker_cluster(tmp_path, 1) as brokers:
            async with client_for(brokers) as client:
                await client.create_topic("t4", partitions=1)
                # writer client is separate so the long-poll doesn't
                # serialize with the produce on one connection
                async with client_for(brokers) as writer:
                    await writer.metadata(["t4"])

                    async def produce_later():
                        await asyncio.sleep(0.1)
                        await writer.produce("t4", 0, [(None, b"late")])

                    t0 = asyncio.get_event_loop().time()
                    task = asyncio.ensure_future(produce_later())
                    got = await client.fetch(
                        "t4", 0, 0, max_wait_ms=5000, min_bytes=1
                    )
                    elapsed = asyncio.get_event_loop().time() - t0
                    await task
                    assert [v for _, _, v in got] == [b"late"]
                    assert elapsed < 4.0  # long-poll returned on data, not timeout

    asyncio.run(run())


def test_restart_preserves_data(tmp_path):
    async def run():
        net = LoopbackNetwork()
        cfg = BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "node0"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
        )
        b = Broker(cfg, loopback=net)
        await b.start()
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic("persist", partitions=1)
        await client.produce("persist", 0, [(None, b"v%d" % i) for i in range(7)])
        await client.close()
        await b.stop()

        net2 = LoopbackNetwork()
        b2 = Broker(cfg, loopback=net2)
        await b2.start()
        try:
            await b2.wait_controller_leader()
            client = KafkaClient([b2.kafka_advertised])
            # topic table rebuilt from controller log replay
            deadline = asyncio.get_event_loop().time() + 5
            while True:
                try:
                    got = await client.fetch("persist", 0, 0)
                    break
                except KafkaClientError:
                    if asyncio.get_event_loop().time() > deadline:
                        raise
                    await asyncio.sleep(0.05)
            assert [v for _, _, v in got] == [b"v%d" % i for i in range(7)]
            await client.close()
        finally:
            await b2.stop()

    asyncio.run(run())
