"""tests/test_kafka_admin.py run on the port: all 4 cases, with imports
pointed at redpanda_tpu_torch. The brokers come from
`test_torch_ref_kafka_e2e`'s fixtures, on the CPU
(`BrokerConfig(device="cpu")`). An autouse fixture sets the codec and
CRC modules' `DEFAULT_DEVICE` to "cpu" (the kernels' plain versions).
Nothing is left out.

Config / create-partitions / offset-for-leader-epoch admin APIs.

Reference test model: src/v/kafka/server/tests/{alter_config_test,
create_partition_test}.cc and offset_for_leader_epoch.cc semantics.
"""

import asyncio

from redpanda_tpu_torch.kafka.client import KafkaClient
from redpanda_tpu_torch.kafka.protocol import Msg
from redpanda_tpu_torch.kafka.protocol.admin_apis import (
    ALTER_CONFIGS,
    CREATE_PARTITIONS,
    DESCRIBE_CONFIGS,
    INCREMENTAL_ALTER_CONFIGS,
    OFFSET_FOR_LEADER_EPOCH,
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


async def _configs_roundtrip(tmp_path):
    async with broker_cluster(tmp_path, 1) as brokers:
        async with client_for(brokers) as client:
            await client.create_topic("cfg", partitions=1, replication_factor=1)
            conn = await client.any_conn()

            resp = await conn.request(
                DESCRIBE_CONFIGS,
                Msg(
                    resources=[
                        Msg(
                            resource_type=2,
                            resource_name="cfg",
                            configuration_keys=None,
                        )
                    ]
                ),
                0,
            )
            r = resp.results[0]
            assert r.error_code == 0
            by_name = {c.name: c for c in r.configs}
            assert by_name["cleanup.policy"].value == "delete"
            assert by_name["cleanup.policy"].is_default

            # set an override incrementally
            resp = await conn.request(
                INCREMENTAL_ALTER_CONFIGS,
                Msg(
                    resources=[
                        Msg(
                            resource_type=2,
                            resource_name="cfg",
                            configs=[
                                Msg(
                                    name="retention.ms",
                                    config_operation=0,
                                    value="1234",
                                )
                            ],
                        )
                    ],
                    validate_only=False,
                ),
                0,
            )
            assert resp.responses[0].error_code == 0
            resp = await conn.request(
                DESCRIBE_CONFIGS,
                Msg(
                    resources=[
                        Msg(
                            resource_type=2,
                            resource_name="cfg",
                            configuration_keys=["retention.ms"],
                        )
                    ]
                ),
                0,
            )
            c = resp.results[0].configs[0]
            assert c.value == "1234" and not c.is_default

            # full AlterConfigs replaces the override set: retention.ms
            # reverts to default, max.message.bytes set
            resp = await conn.request(
                ALTER_CONFIGS,
                Msg(
                    resources=[
                        Msg(
                            resource_type=2,
                            resource_name="cfg",
                            configs=[
                                Msg(name="max.message.bytes", value="2097152")
                            ],
                        )
                    ],
                    validate_only=False,
                ),
                0,
            )
            assert resp.responses[0].error_code == 0
            resp = await conn.request(
                DESCRIBE_CONFIGS,
                Msg(
                    resources=[
                        Msg(
                            resource_type=2,
                            resource_name="cfg",
                            configuration_keys=["retention.ms", "max.message.bytes"],
                        )
                    ]
                ),
                0,
            )
            by_name = {c.name: c for c in resp.results[0].configs}
            assert by_name["retention.ms"].is_default
            assert by_name["max.message.bytes"].value == "2097152"

            # unknown topic errors
            resp = await conn.request(
                DESCRIBE_CONFIGS,
                Msg(
                    resources=[
                        Msg(
                            resource_type=2,
                            resource_name="nope",
                            configuration_keys=None,
                        )
                    ]
                ),
                0,
            )
            assert resp.results[0].error_code == 3  # unknown_topic_or_partition


def test_configs_roundtrip(tmp_path):
    asyncio.run(_configs_roundtrip(tmp_path))


async def _create_partitions(tmp_path, n):
    async with broker_cluster(tmp_path, n) as brokers:
        async with client_for(brokers) as client:
            rf = 1 if n == 1 else 3
            await client.create_topic("grow", partitions=2, replication_factor=rf)
            conn = await client.any_conn()
            resp = await conn.request(
                CREATE_PARTITIONS,
                Msg(
                    topics=[Msg(name="grow", count=5, assignments=None)],
                    timeout_ms=10000,
                    validate_only=False,
                ),
                1,
            )
            assert resp.results[0].error_code == 0, resp.results[0]
            # metadata shows 5 partitions; new ones are usable
            md = await client.metadata(["grow"])
            assert len(md.topics[0].partitions) == 5
            off = await client.produce("grow", 4, [(b"k", b"v")])
            assert off == 0
            got = await client.fetch("grow", 4, 0)
            assert [(k, v) for _o, k, v in got] == [(b"k", b"v")]
            # shrinking is rejected
            resp = await conn.request(
                CREATE_PARTITIONS,
                Msg(
                    topics=[Msg(name="grow", count=3, assignments=None)],
                    timeout_ms=10000,
                    validate_only=False,
                ),
                1,
            )
            assert resp.results[0].error_code != 0


def test_create_partitions_single(tmp_path):
    asyncio.run(_create_partitions(tmp_path, 1))


def test_create_partitions_rf3(tmp_path):
    asyncio.run(_create_partitions(tmp_path, 3))


async def _offset_for_leader_epoch(tmp_path):
    async with broker_cluster(tmp_path, 3) as brokers:
        async with client_for(brokers) as client:
            await client.create_topic("ofle", partitions=1, replication_factor=3)
            from redpanda_tpu_torch.models.fundamental import kafka_ntp

            ntp = kafka_ntp("ofle", 0)
            await client.produce("ofle", 0, [(b"a", b"1"), (b"b", b"2")])

            # move leadership to bump the epoch, then write more
            leader = next(
                b
                for b in brokers
                if (p := b.partition_manager.get(ntp)) and p.is_leader
            )
            target = next(
                b.node_id for b in brokers if b.node_id != leader.node_id
            )
            epoch1 = leader.partition_manager.get(ntp).consensus.term
            await leader.partition_manager.get(ntp).consensus.transfer_leadership(
                target
            )
            await asyncio.sleep(0.3)
            await client.produce("ofle", 0, [(b"c", b"3")])

            conn = await client.leader_conn("ofle", 0, refresh=True)
            resp = await conn.request(
                OFFSET_FOR_LEADER_EPOCH,
                Msg(
                    topics=[
                        Msg(
                            topic="ofle",
                            partitions=[
                                Msg(
                                    partition=0,
                                    current_leader_epoch=-1,
                                    leader_epoch=epoch1,
                                )
                            ],
                        )
                    ]
                ),
                2,
            )
            p = resp.topics[0].partitions[0]
            assert p.error_code == 0
            # epoch1's records end at kafka offset 2 (a, b)
            assert p.leader_epoch == epoch1
            assert p.end_offset == 2
            # asking for the current epoch returns the log end
            cur_epoch = max(
                b.partition_manager.get(ntp).consensus.term
                for b in brokers
                if b.partition_manager.get(ntp) is not None
            )
            resp = await conn.request(
                OFFSET_FOR_LEADER_EPOCH,
                Msg(
                    topics=[
                        Msg(
                            topic="ofle",
                            partitions=[
                                Msg(
                                    partition=0,
                                    current_leader_epoch=-1,
                                    leader_epoch=cur_epoch,
                                )
                            ],
                        )
                    ]
                ),
                2,
            )
            p = resp.topics[0].partitions[0]
            assert p.error_code == 0 and p.end_offset == 3


def test_offset_for_leader_epoch(tmp_path):
    asyncio.run(_offset_for_leader_epoch(tmp_path))
