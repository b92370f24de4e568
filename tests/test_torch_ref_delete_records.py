"""tests/test_delete_records.py run on the port: all 2 cases, with
imports pointed at redpanda_tpu_torch. Brokers run on the CPU
(`BrokerConfig(device="cpu")`). An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu" (the
kernels' plain versions). Nothing is left out.

DeleteRecords (API 21) and OffsetDelete (API 47).

Reference test model: kafka/server/tests delete-records coverage and
rptest offset-delete tests — log-start movement must replicate to
every replica and survive restart/replay.
"""

import asyncio
import contextlib

import pytest

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.kafka.client import KafkaClient, KafkaClientError
from redpanda_tpu_torch.kafka.protocol import ErrorCode, Msg
from redpanda_tpu_torch.kafka.protocol.admin_apis import DELETE_RECORDS, OFFSET_DELETE
from redpanda_tpu_torch.models.fundamental import kafka_ntp
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


@contextlib.asynccontextmanager
async def cluster(tmp_path, n=3):
    net = LoopbackNetwork()
    members = list(range(n))
    brokers = [
        Broker(
            BrokerConfig(
                device="cpu",
                node_id=i,
                data_dir=str(tmp_path / f"n{i}"),
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
    addrs = {b.node_id: b.kafka_advertised for b in brokers}
    for b in brokers:
        b.config.peer_kafka_addresses = addrs
    try:
        await brokers[0].wait_controller_leader()
        yield brokers
    finally:
        for b in brokers:
            await b.stop()


async def _delete_records(tmp_path):
    async with cluster(tmp_path) as brokers:
        client = KafkaClient([brokers[0].kafka_advertised])
        await client.create_topic("dr", partitions=1, replication_factor=3)
        for i in range(10):
            await client.produce("dr", 0, [(b"k%d" % i, b"v%d" % i)])

        conn = await client.leader_conn("dr", 0)
        resp = await conn.request(
            DELETE_RECORDS,
            Msg(
                topics=[
                    Msg(
                        name="dr",
                        partitions=[Msg(partition_index=0, offset=4)],
                    )
                ],
                timeout_ms=5000,
            ),
            1,
        )
        row = resp.topics[0].partitions[0]
        assert row.error_code == 0 and row.low_watermark == 4, row

        # reads below the floor are out of range; from the floor fine
        with pytest.raises(KafkaClientError) as ei:
            await client.fetch("dr", 0, 0)
        assert ei.value.code == int(ErrorCode.offset_out_of_range)
        got = await client.fetch("dr", 0, 4)
        assert [k for _o, k, _v in got] == [b"k%d" % i for i in range(4, 10)]
        assert got[0][0] == 4  # offsets preserved

        # the floor replicates: followers converge via housekeeping
        # once their commit index covers the marker
        for b in brokers:
            p = b.partition_manager.get(kafka_ntp("dr", 0))
            deadline = asyncio.get_event_loop().time() + 5
            while asyncio.get_event_loop().time() < deadline:
                p.housekeeping()
                if p.start_offset() == 4:
                    break
                await asyncio.sleep(0.05)
            assert p.start_offset() == 4, (b.node_id, p.start_offset())

        # out-of-range request rejected
        resp = await conn.request(
            DELETE_RECORDS,
            Msg(
                topics=[
                    Msg(
                        name="dr",
                        partitions=[Msg(partition_index=0, offset=999)],
                    )
                ],
                timeout_ms=5000,
            ),
            1,
        )
        assert resp.topics[0].partitions[0].error_code == int(
            ErrorCode.offset_out_of_range
        )
        # -1 = truncate to high watermark
        resp = await conn.request(
            DELETE_RECORDS,
            Msg(
                topics=[
                    Msg(
                        name="dr",
                        partitions=[Msg(partition_index=0, offset=-1)],
                    )
                ],
                timeout_ms=5000,
            ),
            1,
        )
        row = resp.topics[0].partitions[0]
        assert row.error_code == 0 and row.low_watermark == 10
        # appends continue at the next offset
        off = await client.produce("dr", 0, [(b"new", b"post")])
        assert off == 10
        await client.close()


def test_delete_records(tmp_path):
    asyncio.run(_delete_records(tmp_path))


async def _offset_delete(tmp_path):
    async with cluster(tmp_path, n=1) as brokers:
        client = KafkaClient([brokers[0].kafka_advertised])
        await client.create_topic("od", partitions=2, replication_factor=1)
        await client.produce("od", 0, [(b"k", b"v")])
        gc = client.group("og")
        await gc.commit_offsets({("od", 0): 0, ("od", 1): 5})
        assert await gc.fetch_offsets({"od": [0, 1]}) == {
            ("od", 0): 0,
            ("od", 1): 5,
        }
        conn = await gc.coordinator()
        resp = await conn.request(
            OFFSET_DELETE,
            Msg(
                group_id="og",
                topics=[
                    Msg(name="od", partitions=[Msg(partition_index=1)])
                ],
            ),
            0,
        )
        assert resp.error_code == 0
        assert resp.topics[0].partitions[0].error_code == 0
        # partition 1's offset gone, partition 0 intact
        assert await gc.fetch_offsets({"od": [0, 1]}) == {("od", 0): 0}
        await client.close()


def test_offset_delete(tmp_path):
    asyncio.run(_offset_delete(tmp_path))
