"""tests/test_raft.py run on the port: all 16 cases, with imports pointed
at redpanda_tpu_torch. Every `GroupManager` and `ShardGroupArrays` is
the port's on the CPU (`device="cpu"`) with RP_QUORUM_BACKEND left
unset, so the live clusters run the port's default device leg: the
kernels' plain PyTorch versions under live consensus. As the
reference's conftest does for test_raft.py, an autouse fixture arms the
SAME-frame fingerprint check (`shard_state.SAME_DEBUG`). Nothing is
left out.

Multi-node in-process raft tests over the loopback network
(reference test model: raft/tests/raft_group_fixture.h:83,
append_entries_test.cc, leadership_test.cc, membership_test.cc).
"""

import asyncio

import pytest

from redpanda_tpu_torch.models.record import RecordBatchBuilder, RecordBatchType
from redpanda_tpu_torch.raft import GroupManager, Role, StateMachine
from redpanda_tpu_torch.raft.consensus import NotLeaderError
from redpanda_tpu_torch.raft.offset_translator import OffsetTranslator
from redpanda_tpu_torch.rpc import LoopbackNetwork, LoopbackTransport
from redpanda_tpu_torch.raft import shard_state


@pytest.fixture(autouse=True)
def _same_debug(monkeypatch):
    # the reference's conftest arms the SAME-frame fingerprint check for
    # test_raft.py; the port's flag is its own. The clusters run the
    # port's default quorum backend, the device leg.
    monkeypatch.setattr(shard_state, "SAME_DEBUG", True)
    monkeypatch.delenv("RP_QUORUM_BACKEND", raising=False)


class RaftCluster:
    """N in-process raft nodes over loopback (raft_group_fixture)."""

    def __init__(self, tmp_path, n_nodes=3):
        self.net = LoopbackNetwork()
        self.nodes: dict[int, GroupManager] = {}
        self.tmp = tmp_path
        self.n = n_nodes

    async def start(self, election_timeout=0.15, heartbeat=0.03):
        for nid in range(1, self.n + 1):
            gm = GroupManager(
                node_id=nid,
                data_dir=str(self.tmp / f"node_{nid}"),
                send=self._sender(nid),
                election_timeout_s=election_timeout,
                heartbeat_interval_s=heartbeat,
                device="cpu",
            )
            self.net.register(nid, gm.service)
            self.nodes[nid] = gm
            await gm.start()

    def _sender(self, src):
        async def send(dst, method_id, payload, timeout):
            t = LoopbackTransport(self.net, src, dst)
            return await t.call(method_id, payload, timeout)

        return send

    async def create_group(self, group_id=1):
        voters = list(self.nodes)
        for gm in self.nodes.values():
            await gm.create_group(group_id, voters)

    async def stop(self):
        for gm in self.nodes.values():
            await gm.stop()

    def consensus(self, node_id, group_id=1):
        return self.nodes[node_id].get(group_id)

    async def wait_leader(self, group_id=1, timeout=5.0):
        deadline = asyncio.get_event_loop().time() + timeout
        while asyncio.get_event_loop().time() < deadline:
            leaders = [
                c
                for nid in self.nodes
                if (c := self.consensus(nid, group_id)) is not None
                and c.role == Role.LEADER
                and not self.net._isolated.intersection({nid})
            ]
            if leaders:
                return leaders[0]
            await asyncio.sleep(0.02)
        raise TimeoutError("no leader elected")


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def data_batch(payload: bytes, n: int = 1):
    b = RecordBatchBuilder(batch_type=RecordBatchType.raft_data)
    for i in range(n):
        b.add(value=payload + str(i).encode(), key=b"k")
    return b


def test_single_node_election_and_replicate(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=1)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        base, last = await leader.replicate(data_batch(b"solo"), acks=-1)
        assert leader.commit_index >= last
        await cluster.stop()

    run(main())


def test_three_node_election_and_quorum_replicate(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        # exactly one leader
        leaders = [
            c for nid in cluster.nodes
            if (c := cluster.consensus(nid)).role == Role.LEADER
        ]
        assert len(leaders) == 1

        base, last = await leader.replicate(data_batch(b"hello", 5), acks=-1)
        assert leader.commit_index >= last

        # followers converge (heartbeats propagate commit)
        await asyncio.sleep(0.3)
        for nid in cluster.nodes:
            c = cluster.consensus(nid)
            assert c.dirty_offset() >= last
            assert c.commit_index >= last
            batches = c.log.read(base, upto=last)
            assert sum(b.record_count for b in batches) == 5
        await cluster.stop()

    run(main())


def test_replicate_on_follower_raises_not_leader(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        follower = next(
            cluster.consensus(nid)
            for nid in cluster.nodes
            if cluster.consensus(nid) is not leader
        )
        with pytest.raises(NotLeaderError):
            await follower.replicate(data_batch(b"x"), acks=-1)
        await cluster.stop()

    run(main())


def test_leader_failover_and_data_survival(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        base, last = await leader.replicate(data_batch(b"before", 3), acks=-1)
        old_leader_id = leader.node_id

        # partition the leader away → a new leader must emerge
        cluster.net.isolate(old_leader_id)
        new_leader = None
        deadline = asyncio.get_event_loop().time() + 5.0
        while asyncio.get_event_loop().time() < deadline:
            cands = [
                c
                for nid in cluster.nodes
                if nid != old_leader_id
                and (c := cluster.consensus(nid)).role == Role.LEADER
            ]
            if cands:
                new_leader = cands[0]
                break
            await asyncio.sleep(0.02)
        assert new_leader is not None, "no failover"
        assert new_leader.term > leader.term or leader.role != Role.LEADER

        # committed data survives on the new leader
        batches = new_leader.log.read(base, upto=last)
        assert sum(b.record_count for b in batches) == 3
        b2, l2 = await new_leader.replicate(data_batch(b"after", 2), acks=-1)

        # heal: old leader rejoins as follower and converges
        cluster.net.heal()
        deadline = asyncio.get_event_loop().time() + 5.0
        old = cluster.consensus(old_leader_id)
        while asyncio.get_event_loop().time() < deadline:
            if old.role == Role.FOLLOWER and old.dirty_offset() >= l2:
                break
            await asyncio.sleep(0.02)
        assert old.role == Role.FOLLOWER
        assert old.dirty_offset() >= l2
        # commit index propagates via subsequent heartbeats
        deadline = asyncio.get_event_loop().time() + 5.0
        while (
            old.commit_index < l2
            and asyncio.get_event_loop().time() < deadline
        ):
            await asyncio.sleep(0.02)
        assert old.commit_index >= l2
        await cluster.stop()

    run(main())


def test_divergent_follower_truncates(tmp_path):
    """A partitioned leader appends uncommitted entries; after healing
    its log suffix is truncated to match the new leader (log matching,
    consensus.cc:1869 truncation path)."""

    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        await leader.replicate(data_batch(b"common"), acks=-1)
        old_id = leader.node_id

        # isolate leader, then write to it (acks=0: append locally only)
        cluster.net.isolate(old_id)
        await asyncio.sleep(0.05)
        try:
            await leader.replicate(data_batch(b"lost", 2), acks=0)
        except NotLeaderError:
            pass
        lost_dirty = leader.dirty_offset()

        # majority side elects a new leader and commits new data
        new_leader = await cluster.wait_leader()
        assert new_leader.node_id != old_id
        nb, nl = await new_leader.replicate(data_batch(b"kept", 3), acks=-1)

        cluster.net.heal()
        deadline = asyncio.get_event_loop().time() + 5.0
        old = cluster.consensus(old_id)
        while asyncio.get_event_loop().time() < deadline:
            if old.dirty_offset() >= nl and old.role == Role.FOLLOWER:
                kept = old.log.read(nb, upto=nl)
                if sum(b.record_count for b in kept) == 3:
                    break
            await asyncio.sleep(0.02)
        kept = old.log.read(nb, upto=nl)
        assert sum(b.record_count for b in kept) == 3
        # the lost suffix must not be visible anywhere committed
        assert old.commit_index <= old.dirty_offset()
        await cluster.stop()

    run(main())


def test_state_machine_applies_committed(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()

        class CountingStm(StateMachine):
            def __init__(self, c):
                super().__init__(c)
                self.records = []

            async def apply(self, batch):
                for rec in batch.records():
                    self.records.append(rec.value)

        stm = CountingStm(leader)
        await stm.start()
        base, last = await leader.replicate(data_batch(b"stm", 4), acks=-1)
        await stm.wait_applied(last, timeout=5.0)
        assert len(stm.records) == 4
        await stm.stop()
        await cluster.stop()

    run(main())


def test_prevote_isolated_node_does_not_bump_terms(tmp_path):
    """A partitioned node must not advance its term (prevote_stm.cc):
    its prevotes go unanswered, so the real election never starts, and
    on heal it rejoins without forcing the leader to step down.

    (Previously retry-marked: a loop stall could queue heartbeats
    across the prevote gather, so a node whose prevote round succeeded
    off stale silence went on to bump terms cluster-wide. try_election
    now re-checks leader liveness between the prevote and vote phases,
    so the race is fixed rather than retried away.)"""

    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        stable_term = leader.term
        victim = next(
            nid for nid in cluster.nodes if nid != leader.node_id
        )
        victim_c = cluster.consensus(victim)
        cluster.net.isolate(victim)
        # several election timeouts' worth of isolation
        await asyncio.sleep(1.0)
        assert victim_c.term == stable_term, (
            "isolated node bumped its term despite prevote"
        )
        assert victim_c.role != Role.LEADER
        cluster.net.heal(victim)
        await asyncio.sleep(0.3)
        # leader undisturbed, victim follows at the same term
        assert leader.role == Role.LEADER
        assert leader.term == stable_term
        assert victim_c.term == stable_term
        await cluster.stop()

    run(main())


def test_prevote_denied_while_leader_live(tmp_path):
    """A node that merely missed heartbeats (not partitioned) asks for
    prevotes; peers that still hear the leader deny them."""

    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        follower = next(
            nid for nid in cluster.nodes if nid != leader.node_id
        )
        fc = cluster.consensus(follower)
        # peers hear the leader: prevote at term+1 must be denied
        granted = await fc.dispatch_prevote()
        assert not granted
        # kill the leader: prevotes are now granted and an election runs
        cluster.net.isolate(leader.node_id)
        new_leader = await cluster.wait_leader()
        assert new_leader.node_id != leader.node_id
        await cluster.stop()

    run(main())


def test_leadership_transfer(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await cluster.create_group()
        # under full-suite load the leader can step down between
        # wait_leader() and the calls below; re-acquire and retry
        # instead of trusting one leadership observation
        deadline = asyncio.get_event_loop().time() + 20.0
        target = None
        while True:
            leader = await cluster.wait_leader()
            target = next(
                nid for nid in cluster.nodes if nid != leader.node_id
            )
            try:
                await leader.replicate(data_batch(b"pre"), acks=-1)
                await leader.transfer_leadership(target)
                break
            except NotLeaderError:
                if asyncio.get_event_loop().time() > deadline:
                    raise
                await asyncio.sleep(0.05)
        deadline = asyncio.get_event_loop().time() + 10.0
        while asyncio.get_event_loop().time() < deadline:
            c = cluster.consensus(target)
            if c.role == Role.LEADER:
                break
            await asyncio.sleep(0.02)
        assert cluster.consensus(target).role == Role.LEADER
        await cluster.stop()

    run(main())


def test_restart_preserves_term_and_log(tmp_path):
    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=1)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        base, last = await leader.replicate(data_batch(b"durable", 2), acks=-1)
        term = leader.term
        await cluster.stop()

        # reboot the same node dirs
        cluster2 = RaftCluster(tmp_path, n_nodes=1)
        await cluster2.start()
        await cluster2.create_group()
        leader2 = await cluster2.wait_leader()
        assert leader2.term >= term  # durable vote state
        batches = leader2.log.read(base, upto=last)
        assert sum(b.record_count for b in batches) == 2
        await cluster2.stop()

    run(main())


# ------------------------------------------------- offset translator


def test_offset_translator_basic():
    ot = OffsetTranslator()
    # raft log: cfg@0 data@1 data@2 cfg@3 data@4
    ot.track(RecordBatchType.raft_configuration, 0, 0)
    ot.track(RecordBatchType.raft_data, 1, 2)
    ot.track(RecordBatchType.raft_configuration, 3, 3)
    ot.track(RecordBatchType.raft_data, 4, 4)
    assert ot.to_kafka(1) == 0
    assert ot.to_kafka(2) == 1
    assert ot.to_kafka(4) == 2
    assert ot.from_kafka(0) == 1
    assert ot.from_kafka(1) == 2
    assert ot.from_kafka(2) == 4
    ot.truncate(3)
    assert ot.to_kafka(2) == 1


def test_offset_translator_roundtrip_many():
    import random as rnd

    rnd.seed(7)
    ot = OffsetTranslator()
    kafka = []
    for off in range(200):
        if rnd.random() < 0.3:
            ot.track(RecordBatchType.raft_configuration, off, off)
        else:
            ot.track(RecordBatchType.raft_data, off, off)
            kafka.append(off)
    for k, raft in enumerate(kafka):
        assert ot.to_kafka(raft) == k
        assert ot.from_kafka(k) == raft


# --------------------------------------- scalar ↔ device differential


def test_shard_arrays_scalar_vs_device_differential():
    """The batched device sweep must be bit-identical to the scalar
    reference backend (SURVEY.md §8b) — randomized state fuzz."""
    import random as rnd

    import numpy as np

    from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays

    rnd.seed(42)
    for trial in range(20):
        n_groups, n_replicas = 16, rnd.choice([3, 5])
        a = ShardGroupArrays(capacity=n_groups, device="cpu")
        b = ShardGroupArrays(capacity=n_groups, device="cpu")
        for arrays in (a, b):
            for g in range(n_groups):
                arrays.alloc_row()
        for g in range(n_groups):
            term = rnd.randint(1, 5)
            leader = rnd.random() < 0.8
            commit = rnd.randint(-1, 50)
            tstart = rnd.randint(0, 60)
            for arrays in (a, b):
                arrays.term[g] = term
                arrays.is_leader[g] = leader
                arrays.commit_index[g] = commit
                arrays.term_start[g] = tstart
            for r in range(n_replicas):
                match = rnd.randint(-1, 100)
                flushed = rnd.randint(-1, match) if match >= 0 else -1
                voter = rnd.random() < 0.9
                for arrays in (a, b):
                    arrays.match_index[g, r] = match
                    arrays.flushed_index[g, r] = flushed
                    arrays.is_voter[g, r] = voter
        # a: scalar backend per group; b: one device sweep. The sweep
        # is incremental (recomputes only changed rows), so directly-
        # seeded state must be flagged dirty to request the full
        # recompute the scalar loop performs.
        for g in range(n_groups):
            a.scalar_commit_update(g)
        b.quorum_dirty[:] = True
        empty = np.array([], np.int64)
        b.device_tick(empty, empty, empty, empty, empty)
        assert np.array_equal(a.commit_index, b.commit_index), (
            trial,
            a.commit_index,
            b.commit_index,
        )


def test_offset_translator_prefix_truncate_stability():
    """Kafka offsets of retained records must not shift when the
    prefix (including filtered entries) is truncated away."""
    ot = OffsetTranslator()
    ot.track(RecordBatchType.raft_configuration, 0, 0)
    ot.track(RecordBatchType.raft_data, 1, 4)
    ot.track(RecordBatchType.raft_configuration, 5, 5)
    ot.track(RecordBatchType.raft_data, 6, 9)
    before = {raft: ot.to_kafka(raft) for raft in range(6, 10)}
    ot.prefix_truncate(3)  # drops filtered offset 0
    for raft in range(6, 10):
        assert ot.to_kafka(raft) == before[raft]
        assert ot.from_kafka(before[raft]) == raft


def test_same_rearm_preserves_other_senders_coverage():
    """Regression (r4 advisor, medium): when sender L re-arms its SAME
    coverage, rows that another sender C has since taken over must NOT
    be cleared — otherwise C's coverage of a migrated row only
    refreshes on its forced-full cadence (FORCE_FULL_EVERY ticks,
    longer than the election timeout → spurious election)."""
    import numpy as np

    from redpanda_tpu_torch.raft.service import RaftService
    from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays

    arrays = ShardGroupArrays(capacity=4, device="cpu")
    for _ in range(4):
        arrays.alloc_row()
    svc = RaftService.__new__(RaftService)
    svc._same_rows = {}

    L, C = 7, 9
    # L arms covering rows {0, 1}
    svc._arm_same_coverage(L, arrays, np.array([0, 1], np.int64))
    assert list(arrays.same_cover_node[:2]) == [L, L]
    # leadership of row 0 migrates: C arms covering {0, 2}
    svc._arm_same_coverage(C, arrays, np.array([0, 2], np.int64))
    assert int(arrays.same_cover_node[0]) == C
    # L re-arms covering only {1}: must not wipe C's coverage of row 0
    svc._arm_same_coverage(L, arrays, np.array([1], np.int64))
    assert int(arrays.same_cover_node[0]) == C, (
        "re-arm wiped another sender's coverage"
    )
    assert int(arrays.same_cover_node[1]) == L
    assert int(arrays.same_cover_node[2]) == C
    # and rows L abandoned that are still attributed to L are cleared
    svc._arm_same_coverage(L, arrays, np.array([3], np.int64))
    assert int(arrays.same_cover_node[1]) == -1


def test_quiesced_same_heartbeat_path(tmp_path):
    """The O(1) HEARTBEAT_SAME path: arms after a byte-stable full
    exchange, keeps followers' liveness fresh via node-level stamps,
    de-arms on ANY raft mutation (leader or follower side), and the
    forced-full cadence bounds staleness. Replication through a
    quiesced->active->quiesced cycle stays correct."""

    async def main():
        cluster = RaftCluster(tmp_path, 2)
        # manual ticks: disable the background drivers
        await cluster.start(election_timeout=3600.0, heartbeat=3600.0)
        await cluster.create_group(1)
        c1 = cluster.consensus(1)
        c1.arrays.term[c1.row] = 0
        c1._become_leader()
        hb = cluster.nodes[1].heartbeat_manager
        follower_gm = cluster.nodes[2]

        # drive to steady state: config batch replicated + committed
        for _ in range(30):
            await hb.tick()
            await asyncio.sleep(0)
            if all(
                cluster.consensus(n).commit_index >= c1.term_start
                for n in (1, 2)
            ):
                break
        plan = hb._plan or hb._build_plan()
        # a few more ticks: splice caches arm, then SAME arms
        for _ in range(4):
            await hb.tick()
        p = next(iter(hb._plan.values()))
        assert p.same_epoch is not None, "SAME path never armed"
        counter0 = p.same_counter
        await hb.tick()
        assert p.same_counter == counter0 + 1, "SAME tick did not run"
        # node-level liveness stamp landed on the follower
        assert follower_gm.arrays.node_hb.get(1, 0) > 0

        # mutation on the LEADER de-arms and the next exchange is full
        b = data_batch(b"quiesce-test")
        stages = await c1.replicate_in_stages(b.build(), acks=-1)
        await asyncio.wait_for(stages.done, 10)
        for _ in range(4):
            await hb.tick()  # full frames re-settle the caches
        assert cluster.consensus(2).commit_index >= 0

        # re-arms after the churn settles
        for _ in range(4):
            await hb.tick()
        assert p.same_epoch is not None, "SAME did not re-arm after churn"

        # follower-side mutation (epoch bump) forces NEED_FULL exactly once
        follower_c = cluster.consensus(2)
        follower_c.arrays.touch()
        before = p.same_counter
        await hb.tick()  # SAME sent, follower answers NEED_FULL
        assert p.same_epoch is None and p.same_counter == before
        await hb.tick()  # full frame
        for _ in range(3):
            await hb.tick()
        assert p.same_epoch is not None, "SAME did not re-arm after NEED_FULL"

        # forced-full cadence: after FORCE_FULL_EVERY SAME ticks, one
        # full frame runs even with zero mutations
        for _ in range(hb.FORCE_FULL_EVERY + 2):
            await hb.tick()
        assert p.same_epoch is not None  # re-armed right after the full

        await cluster.stop()

    run(main())
