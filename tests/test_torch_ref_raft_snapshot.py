"""tests/test_raft_snapshot.py run on the port: all 7 cases, with imports
pointed at redpanda_tpu_torch. `RaftCluster`, `data_batch` and `run`
come from `test_torch_ref_raft` (every GroupManager on the CPU,
`device="cpu"`). As the reference's conftest does for
test_raft_snapshot.py, an autouse fixture arms the SAME-frame
fingerprint check (`shard_state.SAME_DEBUG`); another sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.

Raft snapshot + install_snapshot recovery tests.

Reference test model: raft/tests — snapshot recovery paths of
recovery_stm.cc (install_snapshot fallback) and consensus.cc
install_snapshot handling. The headline scenario from VERDICT.md: a
follower that fell below the leader's log start (after retention /
prefix truncation) recovers via snapshot streaming instead of being
permanently stranded.
"""

import asyncio
import os

import pytest

from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.models.record import RecordBatchBuilder, RecordBatchType
from redpanda_tpu_torch.cluster.partition import Partition
from redpanda_tpu_torch.raft import Role
from redpanda_tpu_torch.storage.log import LogConfig

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
    # test_raft_snapshot.py; the port's flag is its own
    monkeypatch.setattr(shard_state, "SAME_DEBUG", True)

SMALL_SEGMENTS = LogConfig(segment_max_bytes=2048)


async def create_small_segment_group(cluster, group_id=1):
    voters = list(cluster.nodes)
    for gm in cluster.nodes.values():
        await gm.create_group(
            group_id, voters, log_config=LogConfig(segment_max_bytes=2048)
        )


def test_snapshot_write_prefix_truncates_and_survives_restart(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=1)
        await cluster.start()
        await create_small_segment_group(cluster)
        leader = await cluster.wait_leader()
        last = -1
        for i in range(30):
            _, last = await leader.replicate(data_batch(b"x" * 100, 2), acks=-1)
        assert leader.log.segment_count() > 3

        # keep a suffix out of the snapshot so we can prove it stays
        # readable (prefix truncation is batch-granular now: a snapshot
        # at commit_index reclaims the ENTIRE history below it)
        snap_at = leader.commit_index - 4
        snap = leader.write_snapshot(snap_at)
        assert snap == snap_at
        offs = leader.log.offsets()
        assert offs.start_offset == snap + 1
        assert os.path.exists(os.path.join(leader.log.directory, "snapshot"))
        # data above the snapshot remains readable
        assert leader.log.read(offs.start_offset)

        # appends continue after the snapshot
        _, last2 = await leader.replicate(data_batch(b"after"), acks=-1)
        assert last2 > snap
        await cluster.stop()

        # restart: snapshot state reloads, group still serves writes
        cluster2 = RaftCluster(tmp_path, n_nodes=1)
        await cluster2.start()
        await create_small_segment_group(cluster2)
        leader2 = await cluster2.wait_leader()
        assert leader2.snapshot_index == snap
        assert leader2.log.offsets().start_offset > 0
        _, last3 = await leader2.replicate(data_batch(b"again"), acks=-1)
        assert leader2.commit_index >= last3
        await cluster2.stop()

    run(main())


def test_stranded_follower_recovers_via_install_snapshot(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await create_small_segment_group(cluster)
        leader = await cluster.wait_leader()
        await leader.replicate(data_batch(b"seed", 2), acks=-1)

        # pick a follower and cut it off
        follower_id = next(
            nid for nid in cluster.nodes
            if cluster.consensus(nid).role != Role.LEADER
        )
        cluster.net.isolate(follower_id)
        stranded = cluster.consensus(follower_id)
        stranded_dirty = stranded.dirty_offset()

        # write enough to roll many segments, then snapshot past the
        # stranded follower's position
        for _ in range(40):
            await leader.replicate(data_batch(b"y" * 100, 2), acks=-1)
        snap = leader.write_snapshot(leader.commit_index)
        assert snap > stranded_dirty
        assert leader.log.offsets().start_offset > stranded_dirty

        cluster.net.heal(follower_id)
        # recovery: heartbeat sweep notices the laggard, catch-up fiber
        # falls back to install_snapshot, then appends resume
        deadline = asyncio.get_event_loop().time() + 10.0
        while asyncio.get_event_loop().time() < deadline:
            if (
                stranded.snapshot_index == snap
                and stranded.commit_index >= leader.commit_index
            ):
                break
            await asyncio.sleep(0.05)
        assert stranded.snapshot_index == snap, "follower never installed snapshot"
        assert stranded.commit_index >= snap

        # the follower's log restarts exactly past the snapshot
        offs = stranded.log.offsets()
        assert offs.start_offset == snap + 1

        # it participates in new quorum writes and serves reads above
        # the snapshot boundary
        _, last = await leader.replicate(data_batch(b"post-recovery"), acks=-1)
        await asyncio.sleep(0.3)
        assert stranded.dirty_offset() >= last
        assert stranded.log.read(snap + 1)
        await cluster.stop()

    run(main())


def test_empty_follower_recovers_via_install_snapshot(tmp_path):
    """A brand-new/wiped replica (log at -1) must receive the snapshot
    when the leader's log start is above 0 — the prev == -1 case."""

    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await create_small_segment_group(cluster)
        leader = await cluster.wait_leader()

        # one follower never sees any data
        follower_id = next(
            nid for nid in cluster.nodes
            if cluster.consensus(nid).role != Role.LEADER
        )
        cluster.net.isolate(follower_id)
        empty = cluster.consensus(follower_id)

        for _ in range(40):
            await leader.replicate(data_batch(b"e" * 100, 2), acks=-1)
        snap = leader.write_snapshot(leader.commit_index)
        assert leader.log.offsets().start_offset > 0
        assert empty.dirty_offset() == -1 or empty.dirty_offset() < snap

        cluster.net.heal(follower_id)
        deadline = asyncio.get_event_loop().time() + 10.0
        while asyncio.get_event_loop().time() < deadline:
            if empty.commit_index >= snap:
                break
            await asyncio.sleep(0.05)
        assert empty.snapshot_index == snap, "wiped follower never got snapshot"
        assert empty.commit_index >= snap
        await cluster.stop()

    run(main())


@pytest.mark.timing
def test_install_snapshot_discards_divergent_follower_suffix(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await create_small_segment_group(cluster)
        leader = await cluster.wait_leader()
        await leader.replicate(data_batch(b"base"), acks=-1)
        old_id = leader.node_id

        # isolate the leader and write uncommitted garbage to it
        cluster.net.isolate(old_id)
        old_leader = cluster.consensus(old_id)
        try:
            for _ in range(5):
                await old_leader.replicate(data_batch(b"garbage"), acks=0)
        except Exception:
            pass

        # remaining nodes elect a new leader, write + snapshot
        new_leader = await cluster.wait_leader()
        assert new_leader.node_id != old_id
        for _ in range(40):
            await new_leader.replicate(data_batch(b"z" * 100, 2), acks=-1)
        snap = new_leader.write_snapshot(new_leader.commit_index)
        assert snap >= 0

        cluster.net.heal(old_id)
        # generous deadline: under full-suite CPU load the heal →
        # step-down → install_snapshot → catch-up chain can take a while
        deadline = asyncio.get_event_loop().time() + 25.0
        while asyncio.get_event_loop().time() < deadline:
            if old_leader.commit_index >= new_leader.commit_index and \
               old_leader.role == Role.FOLLOWER:
                break
            await asyncio.sleep(0.05)
        assert old_leader.commit_index >= snap, (
            f"stale leader never converged: commit {old_leader.commit_index} "
            f"< snapshot {snap} (role {old_leader.role})"
        )
        # divergent suffix gone: its log agrees with the new leader's
        for off in range(
            old_leader.log.offsets().start_offset,
            min(old_leader.dirty_offset(), new_leader.dirty_offset()) + 1,
        ):
            assert old_leader.term_at(off) == new_leader.term_at(off)
        await cluster.stop()

    run(main())


def test_partition_snapshot_restores_translator_and_producers(tmp_path):
    """Kafka-offset consistency across install_snapshot: the restored
    follower answers the same raft↔kafka translation as the leader
    even though the config batches that shifted the mapping are gone
    from its log."""

    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await create_small_segment_group(cluster)
        ntp = NTP("kafka", "t", 0)
        parts = {
            nid: Partition(ntp, 1, cluster.consensus(nid))
            for nid in cluster.nodes
        }
        leader = await cluster.wait_leader()
        leader_part = parts[leader.node_id]

        def pbatch(i, pid=7, seq=None):
            b = RecordBatchBuilder(
                batch_type=RecordBatchType.raft_data,
                producer_id=pid,
                producer_epoch=0,
                base_sequence=seq if seq is not None else i,
            )
            b.add(value=b"v%d" % i, key=b"k")
            return b.build()

        ko = []
        for i in range(10):
            ko.append(await leader_part.replicate(pbatch(i), acks=-1))
        assert ko == sorted(ko)

        follower_id = next(
            nid for nid in cluster.nodes
            if cluster.consensus(nid).role != Role.LEADER
        )
        cluster.net.isolate(follower_id)

        for i in range(10, 50):
            await leader_part.replicate(pbatch(i), acks=-1)
        snap = leader.write_snapshot(leader.commit_index)
        assert snap > 0

        cluster.net.heal(follower_id)
        stranded = cluster.consensus(follower_id)
        deadline = asyncio.get_event_loop().time() + 10.0
        while asyncio.get_event_loop().time() < deadline:
            if stranded.commit_index >= leader.commit_index:
                break
            await asyncio.sleep(0.05)
        assert stranded.snapshot_index == snap

        fpart = parts[follower_id]
        # translation agrees wherever both logs hold data
        assert fpart.high_watermark() == leader_part.high_watermark()
        start_raft = stranded.log.offsets().start_offset
        for b in stranded.log.read(start_raft, max_bytes=1 << 20):
            if b.header.type == RecordBatchType.raft_data:
                assert fpart.translator.to_kafka(b.header.base_offset) == \
                    leader_part.translator.to_kafka(b.header.base_offset)
        # producer dedupe state survived: a retried old sequence on the
        # restored table reports a duplicate, not an accept
        from redpanda_tpu_torch.cluster.producer_state import DuplicateSequence
        with pytest.raises(DuplicateSequence):
            fpart.producers.check(7, 0, 49, 49)
        await cluster.stop()

    run(main())


def test_restart_restores_stm_state_below_log_start(tmp_path):
    """Regression: a NORMAL restart (not install_snapshot) must restore
    the partition's snapshot payload. Producer-dedupe state whose
    batches were prefix-truncated by the snapshot lives ONLY there —
    before the fix, log-suffix replay silently dropped it and a retried
    old sequence was accepted as new data (duplicate)."""

    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=1)
        await cluster.start()
        await create_small_segment_group(cluster)
        leader = await cluster.wait_leader()
        part = Partition(NTP("kafka", "t", 0), 1, leader)

        def pbatch(pid, i, value):
            b = RecordBatchBuilder(
                batch_type=RecordBatchType.raft_data,
                producer_id=pid,
                producer_epoch=0,
                base_sequence=i,
            )
            b.add(value=value, key=b"k")
            return b.build()

        last7 = -1
        for i in range(30):
            last7 = await part.replicate(pbatch(7, i, b"x" * 100), acks=-1)

        # fill with a SECOND producer until every producer-7 batch sits
        # in a closed segment, then snapshot: prefix truncation drops
        # those segments entirely — pid 7's history is physically
        # unreplayable and survives ONLY in the snapshot payload
        for i in range(15):
            await part.replicate(pbatch(8, i, b"y" * 200), acks=-1)
        snap = leader.write_snapshot(leader.commit_index)
        assert snap > 0
        start = leader.log.offsets().start_offset
        raft_last7 = part.translator.from_kafka(last7)
        assert start > raft_last7, (start, raft_last7)
        await cluster.stop()

        cluster2 = RaftCluster(tmp_path, n_nodes=1)
        await cluster2.start()
        await create_small_segment_group(cluster2)
        leader2 = await cluster2.wait_leader()
        part2 = Partition(NTP("kafka", "t", 0), 1, leader2)
        # the restored table must remember producer 7's sequences
        from redpanda_tpu_torch.cluster.producer_state import DuplicateSequence

        with pytest.raises(DuplicateSequence):
            part2.producers.check(7, 0, 29, 29)
        # and the translator agrees with pre-restart kafka offsets
        assert part2.high_watermark() == part.high_watermark()
        await cluster2.stop()

    run(main())


def test_housekeeping_gates_retention_on_snapshot(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=1)
        await cluster.start()
        voters = list(cluster.nodes)
        for gm in cluster.nodes.values():
            await gm.create_group(
                1, voters,
                log_config=LogConfig(
                    segment_max_bytes=2048, retention_bytes=4096
                ),
            )
        leader = await cluster.wait_leader()
        ntp = NTP("kafka", "r", 0)
        part = Partition(ntp, 1, leader)
        for i in range(40):
            await part.replicate(data_batch(b"w" * 100, 2).build(), acks=-1)
        assert leader.log.segment_count() > 4

        part.housekeeping()
        # retention dropped segments, but only below the snapshot
        offs = leader.log.offsets()
        assert offs.start_offset > 0
        assert leader.snapshot_index >= offs.start_offset - 1
        # log above the snapshot is intact and readable
        assert leader.log.read(offs.start_offset)
        await cluster.stop()

    run(main())
