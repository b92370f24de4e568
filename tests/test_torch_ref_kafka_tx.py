"""tests/test_kafka_tx.py run on the port: all 9 cases, with imports
pointed at redpanda_tpu_torch. The brokers come from
`test_torch_ref_kafka_e2e`'s fixtures, on the CPU
(`BrokerConfig(device="cpu")`). An autouse fixture sets the codec and
CRC modules' `DEFAULT_DEVICE` to "cpu" (the kernels' plain versions).
Nothing is left out.

Transactions end-to-end: tx coordinator, markers, LSO, aborted
filtering, transactional offset commits, coordinator failover.

Reference test model: src/v/cluster/tests/rm_stm_tests.cc,
tm_stm_tests.cc, kafka/server/tests (produce_consume + tx paths) and
rptest/tests/transactions_test.py.
"""

import asyncio

import pytest

from redpanda_tpu_torch.kafka.client import (
    KafkaClient,
    KafkaClientError,
    TransactionalProducer,
)
from redpanda_tpu_torch.kafka.protocol import ErrorCode
from redpanda_tpu_torch.models.fundamental import kafka_ntp

from test_torch_ref_kafka_e2e import broker_cluster, client_for
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


def _partition(brokers, ntp):
    for b in brokers:
        p = b.partition_manager.get(ntp)
        if p is not None and p.is_leader:
            return p
    return None


async def _commit_roundtrip(tmp_path, n):
    async with broker_cluster(tmp_path, n) as brokers:
        async with client_for(brokers) as client:
            rf = 1 if n == 1 else 3
            await client.create_topic("t", partitions=2, replication_factor=rf)
            tx = TransactionalProducer(client, "tx-1")
            await tx.init()
            assert tx.pid >= 0 and tx.epoch == 0

            tx.begin()
            await tx.produce("t", 0, [(b"a", b"1"), (b"b", b"2")])
            await tx.produce("t", 1, [(b"c", b"3")])

            # before commit: uncommitted data invisible to READ_COMMITTED
            got = await client.fetch(
                "t", 0, 0, read_committed=True, max_wait_ms=50
            )
            assert got == []
            # ...but visible to READ_UNCOMMITTED
            got = await client.fetch("t", 0, 0, max_wait_ms=50)
            assert [(k, v) for _o, k, v in got] == [(b"a", b"1"), (b"b", b"2")]

            await tx.commit()

            got = await client.fetch(
                "t", 0, 0, read_committed=True, max_wait_ms=500
            )
            assert [(k, v) for _o, k, v in got] == [(b"a", b"1"), (b"b", b"2")]
            got = await client.fetch(
                "t", 1, 0, read_committed=True, max_wait_ms=500
            )
            assert [(k, v) for _o, k, v in got] == [(b"c", b"3")]


def test_tx_commit_single(tmp_path):
    asyncio.run(_commit_roundtrip(tmp_path, 1))


@pytest.mark.timing
def test_tx_commit_rf3(tmp_path):
    asyncio.run(_commit_roundtrip(tmp_path, 3))


async def _abort_invisible(tmp_path):
    async with broker_cluster(tmp_path, 1) as brokers:
        async with client_for(brokers) as client:
            await client.create_topic("t", partitions=1, replication_factor=1)
            tx = TransactionalProducer(client, "tx-abort")
            await tx.init()

            tx.begin()
            await tx.produce("t", 0, [(b"dead", b"x")])
            await tx.abort()

            tx.begin()
            await tx.produce("t", 0, [(b"live", b"y")])
            await tx.commit()

            # READ_COMMITTED: aborted records filtered out
            got = await client.fetch(
                "t", 0, 0, read_committed=True, max_wait_ms=500
            )
            assert [(k, v) for _o, k, v in got] == [(b"live", b"y")]

            # interleaved with a plain producer
            await client.produce("t", 0, [(b"plain", b"z")])
            got = await client.fetch(
                "t", 0, 0, read_committed=True, max_wait_ms=500
            )
            assert [k for _o, k, _v in got] == [b"live", b"plain"]


def test_tx_abort_invisible(tmp_path):
    asyncio.run(_abort_invisible(tmp_path))


async def _lso_blocks_read_committed(tmp_path):
    async with broker_cluster(tmp_path, 1) as brokers:
        async with client_for(brokers) as client:
            await client.create_topic("t", partitions=1, replication_factor=1)
            # a committed prefix
            await client.produce("t", 0, [(b"k0", b"v0")])

            tx = TransactionalProducer(client, "tx-lso")
            await tx.init()
            tx.begin()
            await tx.produce("t", 0, [(b"open", b"tx")])

            p = _partition(brokers, kafka_ntp("t", 0))
            assert p is not None
            # LSO pinned at the open tx's first offset
            assert p.last_stable_offset() == 1
            assert p.high_watermark() == 2

            got = await client.fetch(
                "t", 0, 0, read_committed=True, max_wait_ms=50
            )
            assert [k for _o, k, _v in got] == [b"k0"]

            await tx.commit()
            assert p.last_stable_offset() == p.high_watermark() == 3
            got = await client.fetch(
                "t", 0, 0, read_committed=True, max_wait_ms=500
            )
            assert [k for _o, k, _v in got] == [b"k0", b"open"]


def test_tx_lso(tmp_path):
    asyncio.run(_lso_blocks_read_committed(tmp_path))


async def _txn_offset_commit(tmp_path):
    async with broker_cluster(tmp_path, 1) as brokers:
        async with client_for(brokers) as client:
            await client.create_topic("src", partitions=1, replication_factor=1)
            await client.create_topic("dst", partitions=1, replication_factor=1)
            await client.produce("src", 0, [(b"in", b"1")])

            # consume-transform-produce with EOS offsets
            tx = TransactionalProducer(client, "tx-eos")
            await tx.init()
            tx.begin()
            await tx.produce("dst", 0, [(b"out", b"1")])
            await tx.send_offsets("g-eos", {("src", 0): 1})

            # offsets invisible until commit
            g = client.group("g-eos")
            offs = await g.fetch_offsets({"src": [0]})
            assert offs == {}

            await tx.commit()
            offs = await g.fetch_offsets({"src": [0]})
            assert offs == {("src", 0): 1}


def test_txn_offset_commit(tmp_path):
    asyncio.run(_txn_offset_commit(tmp_path))


async def _txn_offset_abort(tmp_path):
    async with broker_cluster(tmp_path, 1) as brokers:
        async with client_for(brokers) as client:
            await client.create_topic("src", partitions=1, replication_factor=1)
            tx = TransactionalProducer(client, "tx-eos-abort")
            await tx.init()
            tx.begin()
            await tx.send_offsets("g-ab", {("src", 0): 7})
            await tx.abort()
            g = client.group("g-ab")
            offs = await g.fetch_offsets({"src": [0]})
            assert offs == {}


def test_txn_offset_abort(tmp_path):
    asyncio.run(_txn_offset_abort(tmp_path))


async def _epoch_fencing(tmp_path):
    async with broker_cluster(tmp_path, 1) as brokers:
        async with client_for(brokers) as client:
            await client.create_topic("t", partitions=1, replication_factor=1)
            old = TransactionalProducer(client, "tx-fence")
            await old.init()
            old.begin()
            await old.produce("t", 0, [(b"zombie-tx", b"x")])

            # a new incarnation takes over: aborts the old tx, bumps epoch
            new = TransactionalProducer(client, "tx-fence")
            await new.init()
            assert new.pid == old.pid
            assert new.epoch == old.epoch + 1

            # the zombie's writes were aborted
            got = await client.fetch(
                "t", 0, 0, read_committed=True, max_wait_ms=50
            )
            assert got == []

            # zombie produce is fenced
            with pytest.raises(KafkaClientError) as ei:
                await old.produce("t", 0, [(b"more", b"x")])
            assert ei.value.code in (
                int(ErrorCode.invalid_producer_epoch),
                int(ErrorCode.producer_fenced),
            )
            # zombie end_txn is fenced at the coordinator
            with pytest.raises(KafkaClientError):
                await old.commit()

            # the new incarnation works
            new.begin()
            await new.produce("t", 0, [(b"fresh", b"y")])
            await new.commit()
            got = await client.fetch(
                "t", 0, 0, read_committed=True, max_wait_ms=500
            )
            assert [k for _o, k, _v in got] == [b"fresh"]


def test_tx_epoch_fencing(tmp_path):
    asyncio.run(_epoch_fencing(tmp_path))


async def _coordinator_failover(tmp_path):
    """A tx prepared on one coordinator completes after leadership
    moves: the new leader's replay resumes marker delivery."""
    async with broker_cluster(tmp_path, 3) as brokers:
        async with client_for(brokers) as client:
            await client.create_topic("t", partitions=1, replication_factor=3)
            tx = TransactionalProducer(client, "tx-failover")
            await tx.init()
            tx.begin()
            await tx.produce("t", 0, [(b"k", b"v")])

            # find the tx coordinator partition and transfer leadership
            coord = brokers[0].tx_coordinator
            ntp = coord.ntp_for("tx-failover")
            leader_broker = None
            for b in brokers:
                p = b.partition_manager.get(ntp)
                if p is not None and p.is_leader:
                    leader_broker = b
                    break
            assert leader_broker is not None
            others = [
                b.node_id for b in brokers if b.node_id != leader_broker.node_id
            ]
            p = leader_broker.partition_manager.get(ntp)
            await p.consensus.transfer_leadership(others[0])

            # the client re-resolves the coordinator and commits
            await asyncio.sleep(0.3)
            await tx.commit()
            got = await client.fetch(
                "t", 0, 0, read_committed=True, max_wait_ms=1000
            )
            assert [(k, v) for _o, k, v in got] == [(b"k", b"v")]


def test_tx_coordinator_failover(tmp_path):
    asyncio.run(_coordinator_failover(tmp_path))


async def _tx_timeout_abort(tmp_path):
    """An abandoned transaction is aborted by the expiry sweep and the
    producer fenced by the epoch bump."""
    async with broker_cluster(tmp_path, 1) as brokers:
        async with client_for(brokers) as client:
            await client.create_topic("t", partitions=1, replication_factor=1)
            tx = TransactionalProducer(client, "tx-expire", timeout_ms=300)
            await tx.init()
            tx.begin()
            await tx.produce("t", 0, [(b"stale", b"x")])

            p = _partition(brokers, kafka_ntp("t", 0))
            deadline = asyncio.get_event_loop().time() + 5.0
            while p.last_stable_offset() != p.high_watermark():
                assert asyncio.get_event_loop().time() < deadline, (
                    "expiry sweep never aborted the tx"
                )
                await asyncio.sleep(0.1)
            got = await client.fetch(
                "t", 0, 0, read_committed=True, max_wait_ms=50
            )
            assert got == []


def test_tx_timeout_abort(tmp_path):
    asyncio.run(_tx_timeout_abort(tmp_path))
