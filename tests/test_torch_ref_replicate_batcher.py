"""tests/test_replicate_batcher.py run on the port: all 6 cases, with
imports pointed at redpanda_tpu_torch. `RaftCluster`, `data_batch` and
`run` come from `test_torch_ref_raft` (every GroupManager on the CPU,
`device="cpu"`), and the end-to-end broker is the port's on the CPU
(`BrokerConfig(device="cpu")`). As the reference's conftest does for
test_replicate_batcher.py, an autouse fixture arms the SAME-frame
fingerprint check (`shard_state.SAME_DEBUG`); another sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.

Replicate batcher + staged produce tests.

Reference: src/v/raft/replicate_batcher.cc (write coalescing),
kafka/server/handlers/produce.cc:95-111 (two-stage dispatch). The
contract under test: fsync rounds stay O(1) as concurrent producer
count grows, per-partition offsets stay ordered, and idempotent
retries that race the first attempt alias its result instead of
double-appending.
"""

import asyncio

import pytest

from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.models.record import RecordBatchBuilder, RecordBatchType
from redpanda_tpu_torch.cluster.partition import Partition
from redpanda_tpu_torch.cluster.producer_state import DuplicateSequence

from test_torch_ref_raft import RaftCluster, data_batch, run
from redpanda_tpu_torch.ops import default_device
from redpanda_tpu_torch.raft import shard_state


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


@pytest.fixture(autouse=True)
def _same_debug(monkeypatch):
    # the reference's conftest arms the SAME-frame fingerprint check for
    # test_replicate_batcher.py; the port's flag is its own
    monkeypatch.setattr(shard_state, "SAME_DEBUG", True)


def test_concurrent_replicates_coalesce_fsyncs(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=1)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        start_rounds = leader._batcher.flush_rounds

        n = 64
        results = await asyncio.gather(
            *(leader.replicate(data_batch(b"c%d" % i), acks=-1) for i in range(n))
        )
        rounds = leader._batcher.flush_rounds - start_rounds
        # all succeeded, all offsets distinct and committed
        lasts = sorted(last for _b, last in results)
        assert len(set(lasts)) == n
        assert leader.commit_index >= lasts[-1]
        # the point of the batcher: far fewer fsync rounds than writes
        assert rounds < n / 4, f"{rounds} rounds for {n} writes"
        await cluster.stop()

    run(main())


def test_staged_replicate_preserves_order(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=1)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()

        stages = []
        for i in range(10):
            s = await leader.replicate_in_stages(data_batch(b"o%d" % i), acks=-1)
            stages.append(s)
            assert s.enqueued.done()  # dispatched resolves at cache time
        done = [await asyncio.shield(s.done) for s in stages]
        bases = [b for b, _l in done]
        # FIFO cache order == assigned log order
        assert bases == sorted(bases)
        assert len(set(bases)) == len(bases)
        await cluster.stop()

    run(main())


def test_quorum_round_waiter_fails_on_leadership_loss(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        await leader.replicate(data_batch(b"seed"), acks=-1)

        # partition the leader, then write: quorum can never form
        cluster.net.isolate(leader.node_id)
        from redpanda_tpu_torch.raft.consensus import NotLeaderError, ReplicateTimeout

        with pytest.raises((NotLeaderError, ReplicateTimeout)):
            await leader.replicate(data_batch(b"doomed"), acks=-1, timeout=1.5)
        await cluster.stop()

    run(main())


def test_inflight_duplicate_aliases_first_attempt(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=1)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        part = Partition(NTP("kafka", "t", 0), 1, leader)

        def pbatch(seq):
            b = RecordBatchBuilder(
                batch_type=RecordBatchType.raft_data,
                producer_id=9,
                producer_epoch=0,
                base_sequence=seq,
            )
            b.add(value=b"v", key=b"k")
            return b.build()

        # two racing identical attempts: the retry aliases the first,
        # both resolve to the SAME offset, only one batch lands
        hw_before = part.high_watermark()
        r1, r2 = await asyncio.gather(
            part.replicate(pbatch(0), acks=-1),
            part.replicate(pbatch(0), acks=-1),
        )
        assert r1 == r2
        assert part.high_watermark() == hw_before + 1

        # an already-applied duplicate reports the original offset too
        r3 = await part.replicate(pbatch(0), acks=-1)
        assert r3 == r1
        await cluster.stop()

    run(main())


def test_pipelined_sequences_not_out_of_order(tmp_path):
    """Next-in-sequence batches dispatched while earlier ones are still
    in the batcher must check clean against the in-flight horizon, not
    the (lagging) applied table."""

    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=1)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        part = Partition(NTP("kafka", "t", 0), 1, leader)

        def pbatch(seq):
            b = RecordBatchBuilder(
                batch_type=RecordBatchType.raft_data,
                producer_id=5,
                producer_epoch=0,
                base_sequence=seq,
            )
            b.add(value=b"v%d" % seq, key=b"k")
            return b.build()

        # dispatch 5 consecutive sequence ranges without awaiting done
        stages = []
        for seq in range(5):
            stages.append(await part.replicate_in_stages(pbatch(seq), acks=-1))
        bases = [await asyncio.shield(s.done) for s in stages]
        assert bases == sorted(bases)
        assert len(set(bases)) == 5
        # horizon cleaned up after everything applied
        assert part._inflight_seq == {}
        # a real gap still rejects
        from redpanda_tpu_torch.cluster.producer_state import OutOfOrderSequence

        with pytest.raises(OutOfOrderSequence):
            await part.replicate_in_stages(pbatch(99), acks=-1)
        await cluster.stop()

    run(main())


def test_produce_pipelining_overlaps_rounds(tmp_path):
    """Many concurrent producers over the kafka path: correctness
    (every record lands exactly once, in per-partition order) while the
    batcher coalesces the disk work underneath."""

    async def main():
        import tempfile

        from redpanda_tpu_torch.app import Broker, BrokerConfig
        from redpanda_tpu_torch.kafka.client import KafkaClient
        from redpanda_tpu_torch.rpc import LoopbackNetwork

        d = tempfile.mkdtemp(dir=tmp_path)
        b = Broker(
            BrokerConfig(node_id=0, data_dir=d, members=[0], device="cpu"),
            loopback=LoopbackNetwork(),
        )
        await b.start()
        # several CONNECTIONS so server-side concurrency is structural
        # (a single pipelined connection only overlaps via the staged
        # produce, which can collapse on a loaded box and flake the
        # coalescing assertion)
        clients = [KafkaClient([b.kafka_advertised]) for _ in range(4)]
        try:
            await clients[0].create_topic("pp", partitions=1)
            ntp = NTP("kafka", "pp", 0)
            # topic creation returns when the controller command
            # commits; the partition materializes asynchronously
            for _ in range(100):
                part = b.partition_manager.get(ntp)
                if part is not None:
                    break
                await asyncio.sleep(0.02)
            assert part is not None, "partition never materialized"
            rounds_before = part.consensus._batcher.flush_rounds

            n = 40
            offsets = await asyncio.gather(
                *(
                    clients[i % 4].produce("pp", 0, [(b"k", b"m%d" % i)])
                    for i in range(n)
                )
            )
            assert sorted(set(offsets)) == sorted(offsets)  # unique bases
            got = await clients[0].fetch("pp", 0, 0)
            assert len(got) == n
            rounds = part.consensus._batcher.flush_rounds - rounds_before
            assert rounds < n, f"no coalescing: {rounds} rounds for {n}"
        finally:
            for client in clients:
                await client.close()
            await b.stop()

    run(main())
