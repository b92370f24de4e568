"""tests/test_fetch_sessions_quotas.py run on the port: all 3 cases, with
imports pointed at redpanda_tpu_torch. Brokers run on the CPU
(`BrokerConfig(device="cpu")`). An autouse fixture sets the codec and
CRC modules' `DEFAULT_DEVICE` to "cpu" (the kernels' plain versions).
Nothing is left out.

Incremental fetch sessions (KIP-227) and per-client quotas.

Reference test model: kafka/server/tests/fetch_session_test.cc and
quota_manager tests; rptest fetch-session and client-quota coverage.
"""

import asyncio
import contextlib

import pytest

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.kafka.client import KafkaClient
from redpanda_tpu_torch.kafka.protocol import FETCH, ErrorCode, Msg
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
from redpanda_tpu_torch.ops import crc32c as crc_ops
from redpanda_tpu_torch.ops import fused as fused_ops
from redpanda_tpu_torch.ops import lz4 as lz4_ops
from redpanda_tpu_torch.ops import snappy as snappy_ops
from redpanda_tpu_torch.ops import zstd as zstd_ops


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    for mod in (lz4_ops, snappy_ops, zstd_ops, fused_ops, crc_ops):
        monkeypatch.setattr(mod, "DEFAULT_DEVICE", "cpu")


@contextlib.asynccontextmanager
async def broker(tmp_path):
    net = LoopbackNetwork()
    b = Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
        ),
        loopback=net,
    )
    await b.start()
    b.config.peer_kafka_addresses = {0: b.kafka_advertised}
    try:
        await b.wait_controller_leader()
        yield b
    finally:
        await b.stop()


def _fetch_req(topics, session_id=0, epoch=-1, forgotten=(), max_wait=0):
    return Msg(
        replica_id=-1,
        max_wait_ms=max_wait,
        min_bytes=0,
        max_bytes=1 << 20,
        isolation_level=0,
        session_id=session_id,
        session_epoch=epoch,
        topics=[
            Msg(
                topic=t,
                partitions=[
                    Msg(
                        partition=p,
                        current_leader_epoch=-1,
                        fetch_offset=off,
                        log_start_offset=-1,
                        partition_max_bytes=1 << 20,
                    )
                    for p, off in parts
                ],
            )
            for t, parts in topics
        ],
        forgotten_topics_data=[
            Msg(topic=t, partitions=list(ps)) for t, ps in forgotten
        ],
        rack_id="",
    )


async def _incremental_sessions(tmp_path):
    async with broker(tmp_path) as b:
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic("fs", partitions=2, replication_factor=1)
        await client.produce("fs", 0, [(b"a", b"1")])
        await client.produce("fs", 1, [(b"b", b"2")])
        conn = await client.leader_conn("fs", 0)

        # establish a session over both partitions (id 0, epoch 0)
        resp = await conn.request(
            FETCH,
            _fetch_req([("fs", [(0, 0), (1, 0)])], session_id=0, epoch=0),
            11,
        )
        assert resp.error_code == 0
        sid = resp.session_id
        assert sid > 0
        got = {
            p.partition_index: p.records
            for t in resp.responses
            for p in t.partitions
        }
        assert got[0] is not None and got[1] is not None

        # consumer advanced both positions; nothing new: EMPTY response
        # (the steady-state saving sessions exist for)
        resp = await conn.request(
            FETCH,
            _fetch_req([("fs", [(0, 1), (1, 1)])], session_id=sid, epoch=1),
            11,
        )
        assert resp.error_code == 0 and resp.session_id == sid
        assert resp.responses == []

        # produce to one partition; a NO-TOPICS incremental poll now
        # carries ONLY that partition (the other is omitted)
        await client.produce("fs", 1, [(b"c", b"3")])
        resp = await conn.request(
            FETCH, _fetch_req([], session_id=sid, epoch=2), 11
        )
        rows = [
            (t.topic, p.partition_index)
            for t in resp.responses
            for p in t.partitions
        ]
        assert rows == [("fs", 1)]
        p1 = resp.responses[0].partitions[0]
        assert p1.records

        # client advances partition 1 past the new record: empty again
        resp = await conn.request(
            FETCH,
            _fetch_req([("fs", [(1, 2)])], session_id=sid, epoch=3),
            11,
        )
        rows = {
            p.partition_index: p.records
            for t in resp.responses
            for p in t.partitions
        }
        assert 1 not in rows or not rows[1]

        # forget partition 0; produce to it; incremental poll stays empty
        resp = await conn.request(
            FETCH,
            _fetch_req(
                [], session_id=sid, epoch=4, forgotten=[("fs", [0])]
            ),
            11,
        )
        assert resp.error_code == 0
        await client.produce("fs", 0, [(b"d", b"4")])
        resp = await conn.request(
            FETCH, _fetch_req([], session_id=sid, epoch=5), 11
        )
        assert all(
            p.partition_index != 0
            for t in resp.responses
            for p in t.partitions
        )

        # wrong epoch → INVALID_FETCH_SESSION_EPOCH
        resp = await conn.request(
            FETCH, _fetch_req([], session_id=sid, epoch=99), 11
        )
        assert resp.error_code == int(ErrorCode.invalid_fetch_session_epoch)
        # unknown session id → FETCH_SESSION_ID_NOT_FOUND
        resp = await conn.request(
            FETCH, _fetch_req([], session_id=777777, epoch=1), 11
        )
        assert resp.error_code == int(ErrorCode.fetch_session_id_not_found)

        # epoch -1 closes the session; the id no longer resolves
        resp = await conn.request(
            FETCH,
            _fetch_req([("fs", [(0, 0)])], session_id=sid, epoch=-1),
            11,
        )
        assert resp.error_code == 0 and resp.session_id == 0
        resp = await conn.request(
            FETCH, _fetch_req([], session_id=sid, epoch=6), 11
        )
        assert resp.error_code == int(ErrorCode.fetch_session_id_not_found)
        await client.close()


def test_incremental_fetch_sessions(tmp_path):
    asyncio.run(_incremental_sessions(tmp_path))


async def _quotas(tmp_path):
    async with broker(tmp_path) as b:
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic("qt", partitions=1, replication_factor=1)
        # unlimited by default: no throttle
        conn = await client.leader_conn("qt", 0)
        await client.produce("qt", 0, [(b"k", b"v" * 1000)])

        # set a tiny produce quota through replicated cluster config
        await b.controller.set_cluster_config(
            {"quota_produce_bytes_per_s": "1024"}
        )
        from redpanda_tpu_torch.kafka.protocol import PRODUCE
        from redpanda_tpu_torch.models.record import RecordBatchBuilder

        throttles = []
        for i in range(4):
            builder = RecordBatchBuilder()
            builder.add(b"x" * 2000, key=b"k")
            resp = await conn.request(
                PRODUCE,
                Msg(
                    transactional_id=None,
                    acks=-1,
                    timeout_ms=5000,
                    topics=[
                        Msg(
                            name="qt",
                            partitions=[
                                Msg(
                                    index=0,
                                    records=builder.build().to_kafka_wire(),
                                )
                            ],
                        )
                    ],
                ),
                7,
            )
            assert resp.responses[0].partition_responses[0].error_code == 0
            throttles.append(resp.throttle_time_ms)
        # overshooting 1 KiB/s with ~2 KiB batches must throttle, and
        # the deficit (hence delay) grows with each batch
        assert throttles[-1] > 0
        assert throttles[-1] >= throttles[1]

        # removing the quota stops throttling
        await b.controller.set_cluster_config(
            {}, removes=["quota_produce_bytes_per_s"]
        )
        resp = await client.produce("qt", 0, [(b"k", b"v" * 2000)])
        # fetch quota: tiny limit throttles a large read
        await b.controller.set_cluster_config(
            {"quota_fetch_bytes_per_s": "512"}
        )
        got = await client.fetch("qt", 0, 0, max_bytes=1 << 20)
        assert got  # data still served; throttle is advisory
        await client.close()


def test_quotas(tmp_path):
    asyncio.run(_quotas(tmp_path))


def test_follower_fetch_kip392(tmp_path):
    """KIP-392: a consumer advertising its rack is redirected by the
    leader to the same-rack replica, which serves the read bounded by
    its high watermark; consumers without a rack keep leader-only
    routing."""

    async def run():
        from redpanda_tpu_torch.app import Broker, BrokerConfig
        from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
        from redpanda_tpu_torch.models.fundamental import kafka_ntp

        net = LoopbackNetwork()
        racks = {0: "rack-a", 1: "rack-b", 2: "rack-c"}
        brokers = [
            Broker(
                BrokerConfig(
                    device="cpu",
                    node_id=i,
                    data_dir=str(tmp_path / f"n{i}"),
                    members=[0, 1, 2],
                    election_timeout_s=0.15,
                    heartbeat_interval_s=0.03,
                    rack=racks[i],
                ),
                loopback=net,
            )
            for i in range(3)
        ]
        for b in brokers:
            await b.start()
        addrs = {b.node_id: b.kafka_advertised for b in brokers}
        for b in brokers:
            b.config.peer_kafka_addresses = addrs
        await brokers[0].wait_controller_leader()
        client = KafkaClient([b.kafka_advertised for b in brokers])
        try:
            await client.create_topic("ff", partitions=1, replication_factor=3)
            for i in range(10):
                await client.produce("ff", 0, [(b"k%d" % i, b"v%d" % i)], acks=-1)

            leader_b = next(
                b
                for b in brokers
                if b.partition_manager.get(kafka_ntp("ff", 0)) is not None
                and b.partition_manager.get(kafka_ntp("ff", 0)).is_leader
            )
            follower_b = next(b for b in brokers if b is not leader_b)
            follower_rack = follower_b.config.rack

            # wait for the follower's high watermark to catch up
            fp = follower_b.partition_manager.get(kafka_ntp("ff", 0))
            deadline = asyncio.get_event_loop().time() + 5.0
            while asyncio.get_event_loop().time() < deadline:
                if fp.high_watermark() >= 10:
                    break
                await asyncio.sleep(0.05)

            # rack-aware consumer: redirected + served the full data
            got = await client.fetch("ff", 0, 0, rack=follower_rack)
            assert [(k, v) for _o, k, v in got] == [
                (b"k%d" % i, b"v%d" % i) for i in range(10)
            ]
            # the leader really redirects (raw probe from the leader)
            from redpanda_tpu_torch.kafka.protocol import FETCH

            conn = await client._connect_addr(addrs[leader_b.node_id])
            req = KafkaClient._fetch_request(
                "ff", 0, 0, 1 << 20, 0, 0, False, rack=follower_rack
            )
            resp = await conn.request(FETCH, req, 11)
            pr = resp.responses[0].partitions[0]
            assert pr.preferred_read_replica == follower_b.node_id
            assert not pr.records
            # an unknown rack is served by the leader directly
            got = await client.fetch("ff", 0, 0, rack="nowhere")
            assert len(got) == 10
            # and rackless fetches never touch the follower path
            got = await client.fetch("ff", 0, 0)
            assert len(got) == 10

            # lagging follower: isolate it, commit more on the leader
            # (quorum 2/3 holds), then rack-fetch past its HW — the
            # follower answers EMPTY (retriable), never out_of_range
            net.isolate(follower_b.node_id)
            for i in range(10, 12):
                await client.produce(
                    "ff", 0, [(b"k%d" % i, b"v%d" % i)], acks=-1
                )
            got = await client.fetch(
                "ff", 0, 10, rack=follower_rack, max_wait_ms=0
            )
            assert got == []  # no crash, no stale error
            net.heal()
        finally:
            await client.close()
            for b in brokers:
                await b.stop()

    asyncio.run(run())
