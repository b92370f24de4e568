"""tests/test_placement.py run on the port: all 18 cases, with imports
pointed at redpanda_tpu_torch. Brokers run on the CPU
(`BrokerConfig(device="cpu")`), so a lane move seeds and unseeds rows of
the port's `ShardGroupArrays` on that device (the mesh case under
RP_QUORUM_BACKEND=mesh too); an autouse fixture sets the codec and CRC
modules' `DEFAULT_DEVICE` to "cpu". Nothing is left out.

Placement layer: the unified group → (shard, lane) table, live
partition moves, and the alert-driven bounded rebalancer.

The move protocol tests run the REAL hosts — two single-node brokers
standing in for two shards of one placement domain, the same
(partition_manager, group_manager, log_manager) triple a worker shard
wraps — so complete-or-rollback is exercised against real raft state,
real segment files, and real kvstore seeding, not mocks. Fault
injection uses the MoveHost.fault seam at every protocol stage; the
invariant under test is the one that matters in production: after ANY
outcome, exactly one shard serves the partition and every committed
record is there exactly once.
"""

import asyncio
import contextlib

import pytest

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.models.fundamental import NTP, kafka_ntp
from redpanda_tpu_torch.models.record import RecordBatchBuilder, RecordBatchType
from redpanda_tpu_torch.placement import (
    MoveBudget,
    MoveBudgetExhausted,
    MoveError,
    MoveFault,
    MoveHost,
    PartitionMover,
    PlacementTable,
    Rebalancer,
    compute_shard,
)
from redpanda_tpu_torch.raft.consensus import NotLeaderError
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

GROUP = 7331


def data_batch(payload: bytes, n: int = 1):
    b = RecordBatchBuilder(batch_type=RecordBatchType.raft_data)
    for i in range(n):
        b.add(value=payload + str(i).encode(), key=b"k")
    return b.build()


# -- policy / table ----------------------------------------------------


def test_compute_shard_degenerate_and_spread():
    assert compute_shard(7, 1) == 0
    assert compute_shard(7, 0) == 0
    assert compute_shard(0, 4) == 0  # controller group
    assert compute_shard(-3, 4) == 0
    assert [compute_shard(g, 3) for g in (1, 2, 3, 4)] == [1, 2, 0, 1]


def test_assign_policy(monkeypatch):
    monkeypatch.delenv("RP_PLACEMENT_PIN", raising=False)
    t = PlacementTable(shard_count=3)
    data = kafka_ntp("topic", 0)
    # data partitions spread, replicated or not
    assert t.assign(data, 5, [0], 0) == compute_shard(5, 3)
    assert t.assign(data, 5, [0, 1, 2], 0) == compute_shard(5, 3)
    # internal/coordinator topics and foreign namespaces stay on shard 0
    assert t.assign(kafka_ntp("__consumer_offsets", 3), 5, [0], 0) == 0
    assert t.assign(NTP("redpanda", "controller", 0), 5, [0], 0) == 0
    # single-shard topology is always shard 0
    assert PlacementTable(shard_count=1).assign(data, 5, [0], 0) == 0


def test_assign_pin_knob_restores_v1(monkeypatch):
    monkeypatch.setenv("RP_PLACEMENT_PIN", "1")
    t = PlacementTable(shard_count=3)
    data = kafka_ntp("topic", 0)
    # replicated groups pin to shard 0 (the v1 baseline) ...
    assert t.assign(data, 5, [0, 1, 2], 0) == 0
    # ... single-replica groups still spread
    assert t.assign(data, 5, [0], 0) == compute_shard(5, 3)


def test_table_map_lane_epoch():
    t = PlacementTable(shard_count=4)
    ntp = kafka_ntp("a", 0)
    e0 = t.epoch
    t.insert(ntp, 11, shard=2)
    assert t.epoch == e0 + 1
    assert t.shard_for(ntp) == 2
    assert t.shard_for_group(11) == 2
    assert t.group_of(ntp) == 11
    t.bind_lane(11, 5)
    assert t.lane_for(11) == 5
    # back-compat: bare bind_lane lands on chip 0
    assert t.chip_lane_for(11) == (0, 5)
    assert t.group_at(0, 5, shard=2) == 11
    t.record_move(ntp, 11, 3)
    assert t.shard_for(ntp) == 3
    assert t.moves_executed == 1
    assert t.epoch == e0 + 2
    [entry] = t.entries()
    assert entry == {
        "ntp": "kafka/a/0", "group": 11, "shard": 3, "lane": 5, "chip": 0,
    }
    assert t.counts() == {3: 1}
    # lane rebind onto another chip: old (chip, row) key released
    t.bind_lane(11, 9, chip=3)
    assert t.chip_lane_for(11) == (3, 9)
    assert t.group_at(0, 5, shard=2) is None
    assert t.group_at(3, 9, shard=3) == 11
    t.bind_lane(11, -1)  # source freed its row
    assert t.lane_for(11) is None
    assert t.chip_lane_for(11) is None
    assert t.group_at(3, 9, shard=3) is None
    t.erase(ntp, 11)
    assert t.shard_for(ntp) is None
    assert t.shard_for_group(11) is None
    d = t.describe()
    assert d["partitions"] == 0 and d["moves_executed"] == 1


def test_move_budget_window():
    clock = [0.0]
    b = MoveBudget(moves_per_window=2, window_s=30.0, clock=lambda: clock[0])
    assert b.try_acquire() and b.try_acquire()
    assert not b.try_acquire()
    assert b.denied == 1 and b.available() == 0
    clock[0] = 31.0  # window slides: tokens refill
    assert b.available() == 2
    assert b.try_acquire()


# -- live moves (real hosts) -------------------------------------------


@contextlib.asynccontextmanager
async def two_shards(tmp_path):
    """Two single-node brokers standing in for shard 0 (source) and
    shard 1 (target) of one placement domain, plus a mover wired over
    their real MoveHosts."""
    brokers = []
    for name in ("src", "dst"):
        b = Broker(
            BrokerConfig(
                device="cpu",
                node_id=0,
                data_dir=str(tmp_path / name),
                members=[0],
                election_timeout_s=0.15,
                heartbeat_interval_s=0.03,
            ),
            loopback=LoopbackNetwork(),
        )
        await b.start()
        brokers.append(b)
    src, dst = brokers

    hosts = {
        0: MoveHost(src.partition_manager, src.group_manager,
                    src.storage.log_mgr),
        1: MoveHost(dst.partition_manager, dst.group_manager,
                    dst.storage.log_mgr),
    }

    class HostRouter:
        async def move_invoke(self, shard, method, payload):
            return await hosts[shard].handle(method, payload)

    table = PlacementTable(shard_count=2)
    mover = PartitionMover(
        table, hosts[0], router=HostRouter(),
        budget=MoveBudget(moves_per_window=100),
    )
    try:
        yield src, dst, hosts, table, mover
    finally:
        for b in brokers:
            await b.stop()


async def _wait_leader(p, timeout=8.0):
    deadline = asyncio.get_event_loop().time() + timeout
    while asyncio.get_event_loop().time() < deadline:
        if p.is_leader:
            return
        await asyncio.sleep(0.02)
    raise AssertionError("partition never elected a leader")


def _record_values(log):
    """Every record value in the log, in offset order — the
    exactly-once ledger the move must preserve."""
    out = []
    for batch in log.read(0, max_bytes=1 << 30):
        if batch.header.type != RecordBatchType.raft_data:
            continue
        for rec in batch.records():
            out.append(bytes(rec.value))
    return out


async def _seed_partition(broker, ntp, n_batches=6):
    p = await broker.partition_manager.manage(ntp, GROUP, [0])
    await _wait_leader(p)
    for i in range(n_batches):
        await p.replicate(data_batch(b"rec-%d-" % i, n=3), acks=-1)
    return p


async def _live_move_ships_everything(tmp_path):
    async with two_shards(tmp_path) as (src, dst, _hosts, table, mover):
        ntp = kafka_ntp("mv", 0)
        p = await _seed_partition(src, ntp)
        before = _record_values(p.log)
        assert len(before) == 18
        table.insert(ntp, GROUP, shard=0)

        out = await mover.move(ntp, 1)
        assert out["moved"] and out["from"] == 0 and out["to"] == 1
        assert out["batches"] > 0

        # the table rebound and the move was accounted
        assert table.shard_for(ntp) == 1
        assert table.shard_for_group(GROUP) == 1
        assert table.moves_executed == 1
        assert mover.stats.ok == 1 and mover.stats.freeze_ms

        # the source retired its copy; the target owns the group
        assert src.partition_manager.get(ntp) is None
        q = dst.partition_manager.get(ntp)
        assert q is not None and q.group_id == GROUP

        # exactly-once: every committed record, none duplicated
        assert _record_values(q.log) == before

        # the adopted raft state is live: it elects and serves appends
        await _wait_leader(q)
        await q.replicate(data_batch(b"post-move-"), acks=-1)
        assert _record_values(q.log) == before + [b"post-move-0"]


def test_live_move_ships_everything(tmp_path):
    asyncio.run(_live_move_ships_everything(tmp_path))


async def _frozen_source_rejects_appends(tmp_path):
    async with two_shards(tmp_path) as (src, _dst, _hosts, _table, _mover):
        ntp = kafka_ntp("fz", 0)
        p = await _seed_partition(src, ntp, n_batches=1)
        await src.group_manager.freeze_group(GROUP)
        with pytest.raises(NotLeaderError):
            await p.replicate(data_batch(b"while-frozen-"), acks=-1)
        src.group_manager.thaw_group(GROUP)
        await _wait_leader(p)
        await p.replicate(data_batch(b"after-thaw-"), acks=-1)
        assert _record_values(p.log)[-1] == b"after-thaw-0"


def test_frozen_source_rejects_appends(tmp_path):
    asyncio.run(_frozen_source_rejects_appends(tmp_path))


async def _fault_at_every_stage_rolls_back(tmp_path):
    async with two_shards(tmp_path) as (src, dst, hosts, table, mover):
        ntp = kafka_ntp("rb", 0)
        p = await _seed_partition(src, ntp)
        table.insert(ntp, GROUP, shard=0)
        committed = _record_values(p.log)

        def arm(host, stage):
            def hook(s):
                if s == stage:
                    raise MoveFault(f"injected at {s}")
            host.fault = hook

        # (host-side, stage) for every protocol step that can die
        for host, stage in (
            (hosts[0], "freeze"),
            (hosts[1], "begin"),
            (hosts[0], "read"),
            (hosts[1], "write"),
            (hosts[1], "commit"),
        ):
            arm(host, stage)
            with pytest.raises(MoveError):
                await mover.move(ntp, 1)
            host.fault = None

            # rollback: the source still owns and still serves
            assert table.shard_for(ntp) == 0, stage
            assert src.partition_manager.get(ntp) is p, stage
            assert dst.partition_manager.get(ntp) is None, stage
            assert dst.storage.log_mgr.get(ntp) is None, stage
            await _wait_leader(p)
            await p.replicate(data_batch(b"post-%s-" % stage.encode()))
            committed.append(b"post-%s-0" % stage.encode())
            assert _record_values(p.log) == committed, stage

        assert mover.stats.rolled_back == 4  # freeze fails pre-rollback
        assert mover.stats.failed == 1

        # and with the faults cleared, the same partition still moves —
        # including every record committed between the rollbacks
        out = await mover.move(ntp, 1)
        assert out["moved"]
        q = dst.partition_manager.get(ntp)
        assert _record_values(q.log) == committed
        await _wait_leader(q)


def test_fault_at_every_stage_rolls_back(tmp_path):
    asyncio.run(_fault_at_every_stage_rolls_back(tmp_path))


async def _budget_exhaustion_blocks_moves(tmp_path):
    async with two_shards(tmp_path) as (src, _dst, hosts, table, _):
        ntp = kafka_ntp("bg", 0)
        await _seed_partition(src, ntp, n_batches=1)
        table.insert(ntp, GROUP, shard=0)
        clock = [0.0]
        mover = PartitionMover(
            table, hosts[0],
            router=type(
                "R", (), {
                    "move_invoke":
                        staticmethod(lambda s, m, p: hosts[s].handle(m, p))
                },
            )(),
            budget=MoveBudget(
                moves_per_window=1, window_s=30.0, clock=lambda: clock[0]
            ),
        )
        out = await mover.move(ntp, 1)
        assert out["moved"]
        with pytest.raises(MoveBudgetExhausted):
            await mover.move(ntp, 0)
        assert table.shard_for(ntp) == 1  # denied move changed nothing
        clock[0] = 31.0  # window slides: the move back is admitted
        out = await mover.move(ntp, 0)
        assert out["moved"] and table.shard_for(ntp) == 0


async def _lane_move_across_chips(tmp_path, monkeypatch):
    monkeypatch.setenv("RP_QUORUM_BACKEND", "mesh")
    monkeypatch.setenv("RP_MESH_DEVICES", "2")
    broker = Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "lane"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
        ),
        loopback=LoopbackNetwork(),
    )
    await broker.start()
    try:
        ntp = kafka_ntp("lane", 0)
        p = await _seed_partition(broker, ntp)
        committed = _record_values(p.log)
        arrays = broker.group_manager.arrays
        assert arrays.chip_count() == 2
        host = MoveHost(
            broker.partition_manager,
            broker.group_manager,
            broker.storage.log_mgr,
        )
        # the broker's own table — already attached to the tick frame,
        # so the post-move replicate exercises (chip, row) → group
        # residue resolution through the REBOUND binding
        table = broker.shard_table
        table.insert(ntp, GROUP, shard=0)
        src_row = p.consensus.row
        src_chip = arrays.chip_of(src_row)
        table.bind_lane(GROUP, src_row, chip=src_chip)
        mover = PartitionMover(
            table, host, budget=MoveBudget(moves_per_window=100)
        )
        dst_chip = 1 - src_chip

        def arm(stage):
            def hook(s):
                if s == stage:
                    raise MoveFault(f"injected at {s}")
            host.fault = hook

        alloc_before = arrays._alloc_count
        for stage in (
            "lane_freeze", "lane_evacuate", "lane_adopt", "lane_rebind"
        ):
            arm(stage)
            with pytest.raises(MoveError):
                await mover.move_lane(ntp, dst_chip)
            host.fault = None
            # rollback: same row, no leaked staged rows, still serving
            assert p.consensus.row == src_row, stage
            assert arrays._alloc_count == alloc_before, stage
            assert table.chip_lane_for(GROUP) == (src_chip, src_row), stage
            await _wait_leader(p)
            await p.replicate(
                data_batch(b"post-%s-" % stage.encode()), acks=-1
            )
            committed.append(b"post-%s-0" % stage.encode())
            assert _record_values(p.log) == committed, stage
        assert mover.stats.rolled_back == 4

        out = await mover.move_lane(ntp, dst_chip)
        assert out["moved"] and out["to_chip"] == dst_chip
        new_row = p.consensus.row
        assert new_row != src_row
        assert arrays.chip_of(new_row) == dst_chip
        assert arrays._alloc_count == alloc_before  # src freed
        assert table.chip_lane_for(GROUP) == (dst_chip, new_row)
        assert table.group_at(dst_chip, new_row) == GROUP
        assert table.group_at(src_chip, src_row) is None
        # the rebound lane still serves: quorum advance + the
        # table-mediated commit-advance residue both work post-rebind
        await _wait_leader(p)
        await p.replicate(data_batch(b"post-move-"), acks=-1)
        committed.append(b"post-move-0")
        assert _record_values(p.log) == committed
        # idempotence: moving to the chip it lives on is a no-op
        out2 = await mover.move_lane(ntp, dst_chip)
        assert not out2["moved"] and out2["chip"] == dst_chip
    finally:
        await broker.stop()


def test_lane_move_fault_matrix(tmp_path, monkeypatch):
    asyncio.run(_lane_move_across_chips(tmp_path, monkeypatch))


def test_budget_exhaustion_blocks_moves(tmp_path):
    asyncio.run(_budget_exhaustion_blocks_moves(tmp_path))


# -- rebalancer decisions ----------------------------------------------


class FakeMover:
    def __init__(self, table, fail_with=None):
        self.table = table
        self.calls = []
        self.fail_with = fail_with

    async def move(self, ntp, dst):
        self.calls.append((ntp, dst))
        if self.fail_with is not None:
            raise self.fail_with
        src = self.table.shard_for(ntp)
        self.table.record_move(ntp, self.table.group_of(ntp), dst)
        return {"moved": True, "from": src, "to": dst}


def _hot_table():
    t = PlacementTable(shard_count=2)
    for i in range(4):
        t.insert(kafka_ntp("hot", i), 100 + i, shard=0)
    t.insert(kafka_ntp("cold", 0), 200, shard=1)
    return t


def _hot(reb):
    # shard 0 runs hot, shard 1 cold
    reb._note_rate(0, 1000.0)
    reb._note_rate(1, 10.0)


def test_rebalance_moves_hot_ntps_to_cold_shard():
    async def main():
        t = _hot_table()
        mover = FakeMover(t)
        reb = Rebalancer(broker=None, mover=mover, table=t,
                         max_moves_per_alert=2)
        _hot(reb)
        hot_list = [
            {"key": "kafka/__consumer_offsets/1"},  # internal: filtered
            {"key": "kafka/cold/0"},                # not on hot shard
            {"key": "kafka/hot/2"},
            {"key": "kafka/hot/0"},
            {"key": "kafka/hot/1"},                 # over the bound
            {"key": "garbage"},
        ]
        v = await reb.rebalance_once(hot_ntps=hot_list, reason="test")
        assert v["outcome"] == "moved" and v["moved"] == 2
        assert v["from_shard"] == 0 and v["to_shard"] == 1
        # hottest first, bounded at max_moves_per_alert
        assert mover.calls == [
            (kafka_ntp("hot", 2), 1), (kafka_ntp("hot", 0), 1)
        ]
        assert t.shard_for(kafka_ntp("hot", 2)) == 1
        assert reb.history[-1] is v

    asyncio.run(main())


def test_rebalance_falls_back_to_table_scan():
    async def main():
        t = _hot_table()
        mover = FakeMover(t)
        reb = Rebalancer(broker=None, mover=mover, table=t,
                         max_moves_per_alert=1)
        _hot(reb)
        v = await reb.rebalance_once(hot_ntps=[], reason="test")
        assert v["moved"] == 1 and len(mover.calls) == 1
        ntp, dst = mover.calls[0]
        assert ntp.topic == "hot" and dst == 1

    asyncio.run(main())


def test_rebalance_stops_on_budget_exhaustion():
    async def main():
        t = _hot_table()
        mover = FakeMover(t, fail_with=MoveBudgetExhausted("window spent"))
        reb = Rebalancer(broker=None, mover=mover, table=t,
                         max_moves_per_alert=3)
        _hot(reb)
        v = await reb.rebalance_once(
            hot_ntps=[{"key": f"kafka/hot/{i}"} for i in range(4)],
            reason="test",
        )
        assert v["outcome"] == "no_moves"
        assert len(mover.calls) == 1  # exhaustion halts the batch
        assert "window spent" in v["moves"][0]["reason"]

    asyncio.run(main())


def test_on_alert_gating():
    async def main():
        t = _hot_table()
        reb = Rebalancer(broker=None, mover=FakeMover(t), table=t)
        _hot(reb)
        # not a placement alert: no action
        out = await reb.on_alert({"name": "disk_full", "hot_ntps": []})
        assert out == {"acted": False, "reason": "not a placement alert"}
        # a firing shard_skew alert drives a bounded rebalance
        out = await reb.on_alert(
            {"name": "shard_skew", "hot_ntps": [{"key": "kafka/hot/0"}]}
        )
        assert out["outcome"] == "moved" and reb.alerts_handled == 1

    asyncio.run(main())


def test_skew_index():
    t = PlacementTable(shard_count=2)
    reb = Rebalancer(broker=None, mover=None, table=t)
    assert reb.skew() == 1.0  # no samples yet: balanced
    reb._note_rate(0, 900.0)
    reb._note_rate(1, 100.0)
    assert reb.skew() > 1.5  # one shard carrying ~all the load
    one = Rebalancer(broker=None, mover=None,
                     table=PlacementTable(shard_count=1))
    assert one.skew() == 1.0  # single shard can't skew


# -- elastic lifecycle: table + scale signal --------------------------
def test_table_lifecycle_activate_deactivate():
    t = PlacementTable(shard_count=2)
    assert t.active_shards() == [0, 1]
    e0 = t.epoch
    # shard 0 is the parent: never retirable
    with pytest.raises(ValueError):
        t.deactivate(0)
    t.deactivate(1)
    assert t.active_shards() == [0]
    assert not t.is_available(1)
    assert t.epoch > e0
    # NEW placements route over the active set only
    for i in range(8):
        assert t.assign(kafka_ntp("t", i), 100 + i, [0], 0) == 0
    # activating a sid past shard_count grows the universe
    t.activate(3)
    assert t.shard_count == 4
    assert t.active_shards() == [0, 2, 3]
    assert t.is_available(3)
    d = t.describe()
    assert d["retired"] == [1] and d["unavailable"] == []


def test_table_unavailable_window_is_reversible():
    t = PlacementTable(shard_count=2)
    e0 = t.epoch
    t.set_unavailable(1, True)
    assert not t.is_available(1)
    assert t.active_shards() == [0, 1]  # still active, just down
    t.set_unavailable(1, False)
    assert t.is_available(1)
    assert t.epoch > e0
    d = t.describe()
    assert d["unavailable"] == []


def test_rebalancer_elastic_scale_signal():
    """Grow-on-hot / retire-on-idle: sustained all-hot EWMA forks a
    shard, a sustained idle worker (of several) is retired — one
    action per trigger, counters reset so a single spike can't
    double-fire."""

    class FakeLifecycle:
        auto = True

        def __init__(self):
            self.grown = 0
            self.retired = []

        async def grow(self):
            self.grown += 1
            return 2

        async def retire(self, sid):
            self.retired.append(sid)

    class FakeRouter:
        def worker_shards(self):
            return [1, 2]

    class FakeBroker:
        shard_router = FakeRouter()

    async def main():
        t = PlacementTable(shard_count=3)
        reb = Rebalancer(broker=FakeBroker(), mover=None, table=t)
        lc = FakeLifecycle()
        reb.lifecycle = lc
        reb.grow_bps, reb.idle_bps, reb.scale_ticks = 100.0, 1.0, 3
        # both workers hot for scale_ticks consecutive samples -> grow
        for _ in range(3):
            reb._rate = {1: 500.0, 2: 500.0}
            act = await reb.maybe_scale()
        assert lc.grown == 1
        assert act["action"] == "grow" and act["shard"] == 2
        assert reb._hot_ticks == 0  # reset: no double-fire
        # one worker idle that long -> retire exactly it
        for _ in range(3):
            reb._rate = {1: 500.0, 2: 0.5}
            act = await reb.maybe_scale()
        assert lc.retired == [2]
        assert act["action"] == "retire" and act["shard"] == 2
        # inert when auto is off
        lc.auto = False
        reb._rate = {1: 500.0, 2: 0.5}
        assert await reb.maybe_scale() is None

    asyncio.run(main())
