"""tests/test_kafka_introspection.py run on the port: all 4 cases, with
imports pointed at redpanda_tpu_torch. The brokers come from
`test_torch_ref_kafka_e2e`'s fixtures, on the CPU
(`BrokerConfig(device="cpu")`). An autouse fixture sets the codec and
CRC modules' `DEFAULT_DEVICE` to "cpu" (the kernels' plain versions).
Nothing is left out.

Introspection APIs: DescribeLogDirs, Alter/ListPartitionReassignments,
DescribeProducers, Describe/ListTransactions.

Reference test model: src/v/kafka/server/tests semantics of
handlers/{describe_log_dirs,alter_partition_reassignments,
describe_producers,describe_transactions}.cc.
"""

import asyncio

from redpanda_tpu_torch.kafka.client import KafkaClient, TransactionalProducer
from redpanda_tpu_torch.kafka.protocol import Msg
from redpanda_tpu_torch.kafka.protocol.admin_apis import (
    ALTER_PARTITION_REASSIGNMENTS,
    DESCRIBE_LOG_DIRS,
    DESCRIBE_PRODUCERS,
    LIST_PARTITION_REASSIGNMENTS,
)
from redpanda_tpu_torch.kafka.protocol.tx_apis import (
    DESCRIBE_TRANSACTIONS,
    LIST_TRANSACTIONS,
)

from test_torch_ref_kafka_e2e import broker_cluster, client_for
import pytest

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


async def _describe_log_dirs(tmp_path):
    async with broker_cluster(tmp_path, 1) as brokers:
        async with client_for(brokers) as client:
            await client.create_topic("dirs", partitions=2, replication_factor=1)
            for _ in range(3):
                await client.produce("dirs", 0, [(None, b"x" * 512)])
            conn = await client.any_conn()

            resp = await conn.request(DESCRIBE_LOG_DIRS, Msg(topics=None), 2)
            assert len(resp.results) == 1
            r = resp.results[0]
            assert r.error_code == 0 and r.log_dir
            by_topic = {t.name: t for t in r.topics}
            parts = {p.partition_index: p for p in by_topic["dirs"].partitions}
            assert set(parts) == {0, 1}
            # p0 got 3×512B of data; p1 holds only the raft config batch
            assert parts[0].partition_size > parts[1].partition_size
            assert parts[0].offset_lag == 0  # acks=-1 produce flushed

            # filtered to partition 0 only
            resp = await conn.request(
                DESCRIBE_LOG_DIRS,
                Msg(topics=[Msg(topic="dirs", partitions=[0])]),
                2,
            )
            tops = resp.results[0].topics
            assert len(tops) == 1
            assert [p.partition_index for p in tops[0].partitions] == [0]

            # v3 carries a top-level error code
            resp = await conn.request(DESCRIBE_LOG_DIRS, Msg(topics=None), 3)
            assert resp.error_code == 0


def test_describe_log_dirs(tmp_path):
    asyncio.run(_describe_log_dirs(tmp_path))


async def _reassignments(tmp_path):
    async with broker_cluster(tmp_path, 3) as brokers:
        async with client_for(brokers) as client:
            await client.create_topic("move", partitions=1, replication_factor=1)
            table = brokers[0].controller.topic_table
            from redpanda_tpu_torch.models.fundamental import TopicNamespace, kafka_ntp

            tp_ns = TopicNamespace("kafka", "move")
            cur = table.get(tp_ns).assignments[0].replicas
            assert len(cur) == 1
            target = next(i for i in range(3) if i != cur[0])
            conn = await client.any_conn()

            # cancel with nothing in flight
            resp = await conn.request(
                ALTER_PARTITION_REASSIGNMENTS,
                Msg(
                    timeout_ms=10000,
                    topics=[
                        Msg(
                            name="move",
                            partitions=[Msg(partition_index=0, replicas=None)],
                        )
                    ],
                ),
                0,
            )
            p = resp.responses[0].partitions[0]
            assert p.error_code == 85  # no_reassignment_in_progress

            # unknown topic
            resp = await conn.request(
                ALTER_PARTITION_REASSIGNMENTS,
                Msg(
                    timeout_ms=10000,
                    topics=[
                        Msg(
                            name="nope",
                            partitions=[
                                Msg(partition_index=0, replicas=[target])
                            ],
                        )
                    ],
                ),
                0,
            )
            assert resp.responses[0].partitions[0].error_code == 3

            # a real move
            resp = await conn.request(
                ALTER_PARTITION_REASSIGNMENTS,
                Msg(
                    timeout_ms=10000,
                    topics=[
                        Msg(
                            name="move",
                            partitions=[
                                Msg(partition_index=0, replicas=[target])
                            ],
                        )
                    ],
                ),
                0,
            )
            assert resp.error_code == 0
            assert resp.responses[0].partitions[0].error_code == 0

            # the replicated in-progress view drives the listing until
            # the data group's reconfiguration completes
            ntp = kafka_ntp("move", 0)
            deadline = asyncio.get_event_loop().time() + 10.0
            while asyncio.get_event_loop().time() < deadline:
                if (
                    table.get(tp_ns).assignments[0].replicas == [target]
                    and ntp not in table.updates_in_progress
                ):
                    break
                await asyncio.sleep(0.05)
            assert table.get(tp_ns).assignments[0].replicas == [target]

            resp = await conn.request(
                LIST_PARTITION_REASSIGNMENTS,
                Msg(timeout_ms=10000, topics=None),
                0,
            )
            assert resp.error_code == 0 and resp.topics == []


def test_reassignments(tmp_path):
    asyncio.run(_reassignments(tmp_path))


def test_reassignment_bookkeeping():
    """updates_in_progress carries the pre-move set; a cancel (move
    back) clears it; finish_move clears it."""
    from redpanda_tpu_torch.cluster.commands import CmdType, MoveReplicasCmd
    from redpanda_tpu_torch.cluster.topic_table import TopicTable
    from redpanda_tpu_torch.models.fundamental import kafka_ntp

    def mk_table():
        t = TopicTable()
        from redpanda_tpu_torch.cluster.commands import (
            CreateTopicCmd,
            PartitionAssignmentE,
        )

        t.apply(
            CmdType.create_topic,
            CreateTopicCmd(
                ns="kafka",
                topic="t",
                partition_count=1,
                replication_factor=1,
                revision=1,
                assignments=[
                    PartitionAssignmentE(partition=0, group=7, replicas=[0])
                ],
                config={},
            ),
            1,
        )
        return t

    t = mk_table()
    ntp = kafka_ntp("t", 0)
    move = MoveReplicasCmd(ns="kafka", topic="t", partition=0, replicas=[1])
    t.apply(CmdType.move_replicas, move, 2)
    assert t.updates_in_progress[ntp] == [0]
    # cancel = move back to the original set: STILL converging (the
    # balancer concurrency bound holds until finish_move lands)
    back = MoveReplicasCmd(ns="kafka", topic="t", partition=0, replicas=[0])
    t.apply(CmdType.move_replicas, back, 3)
    assert t.updates_in_progress[ntp] == [0]
    assert t.get(ntp.tp_ns).assignments[0].replicas == [0]
    from redpanda_tpu_torch.cluster.commands import FinishMoveCmd

    t.apply(
        CmdType.finish_move,
        FinishMoveCmd(ns="kafka", topic="t", partition=0, replicas=[0]),
        4,
    )
    assert ntp not in t.updates_in_progress

    # topic deletion mid-move clears the entry and keeps the dict shape
    # (further moves must still apply)
    from redpanda_tpu_torch.cluster.commands import DeleteTopicCmd

    t = mk_table()
    t.apply(CmdType.move_replicas, move, 2)
    assert t.updates_in_progress[ntp] == [0]
    t.apply(CmdType.delete_topic, DeleteTopicCmd(ns="kafka", topic="t"), 3)
    assert t.updates_in_progress == {}
    t2 = mk_table()
    t2.updates_in_progress = t.updates_in_progress
    t2.apply(CmdType.move_replicas, move, 4)  # must not crash on shape
    assert t2.updates_in_progress[ntp] == [0]


async def _describe_producers_and_txs(tmp_path):
    async with broker_cluster(tmp_path, 1) as brokers:
        async with client_for(brokers) as client:
            await client.create_topic("txd", partitions=1, replication_factor=1)
            producer = TransactionalProducer(client, "tid-1")
            await producer.init()
            producer.begin()
            await producer.produce("txd", 0, [(b"k", b"v")])
            conn = await client.any_conn()

            resp = await conn.request(
                DESCRIBE_PRODUCERS,
                Msg(topics=[Msg(name="txd", partition_indexes=[0, 7])]),
                0,
            )
            parts = {
                p.partition_index: p for p in resp.topics[0].partitions
            }
            assert parts[7].error_code != 0  # not a partition here
            p0 = parts[0]
            assert p0.error_code == 0
            assert len(p0.active_producers) == 1
            ap = p0.active_producers[0]
            assert ap.producer_id == producer.pid
            assert ap.producer_epoch == producer.epoch
            assert ap.current_txn_start_offset >= 0

            resp = await conn.request(
                DESCRIBE_TRANSACTIONS, Msg(transactional_ids=["tid-1"]), 0
            )
            st = resp.transaction_states[0]
            assert st.error_code == 0
            assert st.transaction_state == "Ongoing"
            assert st.producer_id == producer.pid
            assert [(t.topic, list(t.partitions)) for t in st.topics] == [
                ("txd", [0])
            ]

            resp = await conn.request(
                LIST_TRANSACTIONS,
                Msg(state_filters=[], producer_id_filters=[]),
                0,
            )
            assert resp.error_code == 0
            assert [
                (s.transactional_id, s.transaction_state)
                for s in resp.transaction_states
            ] == [("tid-1", "Ongoing")]

            # state filter excludes; unknown filters reported
            resp = await conn.request(
                LIST_TRANSACTIONS,
                Msg(
                    state_filters=["Empty", "Bogus"],
                    producer_id_filters=[],
                ),
                0,
            )
            assert resp.unknown_state_filters == ["Bogus"]
            assert resp.transaction_states == []

            await producer.commit()
            resp = await conn.request(
                DESCRIBE_TRANSACTIONS, Msg(transactional_ids=["tid-1"]), 0
            )
            st = resp.transaction_states[0]
            assert st.transaction_state == "Empty" and st.topics == []

            # unknown id
            resp = await conn.request(
                DESCRIBE_TRANSACTIONS, Msg(transactional_ids=["ghost"]), 0
            )
            assert resp.transaction_states[0].error_code != 0


def test_describe_producers_and_txs(tmp_path):
    asyncio.run(_describe_producers_and_txs(tmp_path))
