"""tests/test_procnemesis.py run on the port: all 8 test functions, with
imports pointed at redpanda_tpu_torch. Every broker is the port's on the
CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
`_echo_child`, `_retry` and `run` come from `test_torch_ref_shards`.
Nothing is left out.


ProcNemesis: the seeded process-fault plane (ssx/procnemesis.py)
and the fault matrix over the elastic shard lifecycle.

Determinism contract first (same as NemesisNet: trace is a pure
function of seed + event sequence, replayable byte-equal), then the
matrix the ISSUE demands: SIGKILL injected at every grow/retire/
restart/produce boundary must leave zero orphaned processes, zero
lost acked records, and a consistent placement table — complete or
rollback, nothing in between. The broker legs run the REAL forked
runtime, not mocks.
"""

import asyncio
import os
import signal

import pytest

from redpanda_tpu_torch.ssx import ForkFailInjected, ProcRule, ProcSchedule
from redpanda_tpu_torch.ssx.shards import ShardRuntime

from test_torch_ref_shards import _echo_child, _retry, run
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


# ------------------------------------------------------- determinism
def test_rule_match_contract():
    sched = ProcSchedule(rules=[ProcRule(shard=1, event="produce", nth=2,
                                         count=2)], seed=7)
    r = sched.rules[0]
    # wrong shard / wrong event never match, never advance `seen`
    assert sched.act(2, "produce") is None
    assert sched.act(1, "retire.stop") is None
    assert r.seen == 0
    # nth=2: first matching boundary passes, second fires
    assert sched.act(1, "produce") is None
    assert sched.act(1, "produce") is r
    assert sched.act(1, "produce") is None
    assert sched.act(1, "produce") is r
    # count=2 exhausted: silent forever after
    assert sched.act(1, "produce") is None
    assert r.fired == 2


def test_trace_replays_byte_equal_from_seed():
    """The acceptance criterion verbatim: feeding the same (shard,
    event) sequence through a fresh same-seed schedule reproduces the
    firing trace byte-for-byte — prob draws, nth counters and all."""

    def rules():
        return [
            ProcRule(event="produce", action="kill", prob=0.4, count=5),
            ProcRule(event="retire.evacuate", action="pause", prob=0.7,
                     count=3, pause_s=0.1, jitter_s=0.05),
            ProcRule(shard=2, action="slow_start", nth=3, count=4),
        ]

    events = [
        (1, "produce"), (2, "produce"), (1, "retire.evacuate"),
        (2, "spawn.fork"), (2, "grow.ready"), (1, "produce"),
        (2, "retire.evacuate"), (2, "produce"), (1, "spawn.fork"),
        (2, "restart.readopt"), (1, "produce"), (2, "produce"),
    ] * 4
    a = ProcSchedule(rules=rules(), seed=1234)
    for s, e in events:
        rule = a.act(s, e)
        if rule is not None:
            a.effect_jitter(rule)  # fx draws must NOT shift the trace
    b = ProcSchedule(rules=rules(), seed=1234)
    for s, e in events:
        b.act(s, e)  # no effect draws at all this time
    assert a.trace == b.trace
    assert a.trace  # the schedule actually fired
    # a different seed diverges (prob draws differ)
    c = ProcSchedule(rules=rules(), seed=4321)
    for s, e in events:
        c.act(s, e)
    assert c.trace != a.trace


def test_effect_jitter_is_seeded_and_separate():
    r = ProcRule(action="pause", pause_s=0.1, jitter_s=0.5, count=99)
    a = ProcSchedule(rules=[ProcRule(**{**r.__dict__})], seed=5)
    b = ProcSchedule(rules=[ProcRule(**{**r.__dict__})], seed=5)
    ja = [a.effect_jitter(a.rules[0]) for _ in range(8)]
    jb = [b.effect_jitter(b.rules[0]) for _ in range(8)]
    assert ja == jb
    assert all(0.0 <= j <= 0.5 for j in ja)
    assert ProcSchedule(rules=[], seed=5).effect_jitter(
        ProcRule(jitter_s=0.0)
    ) == 0.0


# ------------------------------------------- runtime-level injection
def test_fork_fail_injection_leaves_no_partial_state():
    async def main():
        rt = ShardRuntime(2, _echo_child)
        rt.nemesis = ProcSchedule(
            rules=[ProcRule(event="spawn.fork", action="fork_fail")], seed=0
        )
        await rt.start()
        try:
            with pytest.raises(ForkFailInjected):
                await rt.spawn_shard()
            assert 2 not in rt.shard_pids
            assert rt.n_shards == 2
            assert rt.spawns == 0
            # next attempt (rule exhausted) succeeds on the SAME sid
            sid = await rt.spawn_shard()
            assert sid == 2
            assert await rt.invoke_on(2, "echo", "whoami") == b"2"
        finally:
            await rt.stop()

    run(main())


def test_kill_mid_spawn_handshake_reaps_the_child():
    """SIGKILL right after fork (spawn.forked boundary): spawn_shard
    must fail fast — not stall out the ready timeout — and reap the
    dead child, leaving zero orphans and no channel residue."""

    async def main():
        rt = ShardRuntime(2, _echo_child, ready_timeout=20.0)
        rt.nemesis = ProcSchedule(
            rules=[ProcRule(event="spawn.forked", action="kill")], seed=0
        )
        await rt.start()
        try:
            t0 = asyncio.get_event_loop().time()
            with pytest.raises(RuntimeError):
                await rt.spawn_shard()
            assert asyncio.get_event_loop().time() - t0 < 10.0
            assert 2 not in rt.shard_pids
            assert 2 not in rt.ctx._channels
            # no zombie: every child pid the runtime knows is alive
            for pid in rt.shard_pids.values():
                os.kill(pid, 0)
        finally:
            await rt.stop()

    run(main())


def test_slow_start_injection_delays_but_completes():
    async def main():
        rt = ShardRuntime(2, _echo_child)
        rt.nemesis = ProcSchedule(
            rules=[ProcRule(event="spawn.fork", action="slow_start",
                            delay_s=0.5)],
            seed=0,
        )
        await rt.start()
        try:
            t0 = asyncio.get_event_loop().time()
            sid = await rt.spawn_shard()
            dt = asyncio.get_event_loop().time() - t0
            assert dt >= 0.5, f"slow start not applied ({dt:.2f}s)"
            assert await rt.invoke_on(sid, "echo", "whoami") == b"%d" % sid
        finally:
            await rt.stop()

    run(main())


# ------------------------------------------------- broker fault matrix
def _cfg(tmp_path):
    from redpanda_tpu_torch.app import BrokerConfig

    return BrokerConfig(
        device="cpu",
        node_id=0,
        data_dir=str(tmp_path / "n0"),
        members=[0],
        election_timeout_s=0.3,
        heartbeat_interval_s=0.05,
        enable_admin=False,
    )


async def _boot(tmp_path, n_shards=2):
    from redpanda_tpu_torch.ssx.sharded_broker import ShardedBroker

    sb = ShardedBroker(_cfg(tmp_path), n_shards=n_shards)
    await sb.start()
    assert sb.active, f"unexpected stand-down: {sb.standdown}"
    return sb


async def _seed_topic(sb, c, partitions=4):
    await _retry(
        lambda: c.create_topic("t", partitions=partitions,
                               replication_factor=1)
    )
    deadline = asyncio.get_event_loop().time() + 10.0
    while not sb.broker.shard_table.counts().get(1, 0):
        if asyncio.get_event_loop().time() > deadline:
            raise TimeoutError("no partitions routed to shard 1")
        await asyncio.sleep(0.1)
    acked = {}
    for p in range(partitions):
        acked[p] = await _retry(
            lambda p=p: c.produce("t", p, [(b"k", b"v%d" % p)])
        )
    return acked


def _assert_no_orphans(rt):
    # every pid the runtime tracks is alive; no reaped-but-tracked or
    # tracked-but-dead residue
    for sid, pid in rt.shard_pids.items():
        os.kill(pid, 0)


def _assert_table_consistent(sb):
    table = sb.broker.shard_table
    live = {0} | set(sb.runtime.shard_pids)
    for ntp, shard in table._ntp.items():
        assert shard in live, f"{ntp} mapped to dead shard {shard}"
        assert shard not in table._retired, (
            f"{ntp} mapped to retired shard {shard}"
        )


@pytest.mark.slow
def test_proc_fault_matrix_grow_retire_produce(tmp_path, monkeypatch):
    """SIGKILL at every lifecycle boundary, one broker boot: each
    injection must end complete-or-rollback with zero orphans, zero
    lost acked records, and a consistent table."""
    from redpanda_tpu_torch.kafka.client import KafkaClient

    monkeypatch.setenv("RP_LIFECYCLE_OPS", "64")

    async def main():
        sb = await _boot(tmp_path)
        rt = sb.runtime
        lc = sb.lifecycle
        c = KafkaClient([("127.0.0.1", sb.kafka_port)])
        try:
            acked = await _seed_topic(sb, c)

            async def settle():
                """Wait for every mapped shard to be live+available."""
                deadline = asyncio.get_event_loop().time() + 20.0
                while True:
                    table = sb.broker.shard_table
                    ok = all(
                        (s == 0 or s in rt.shard_pids)
                        and table.is_available(s)
                        for s in set(table._ntp.values())
                    )
                    if ok:
                        return
                    if asyncio.get_event_loop().time() > deadline:
                        raise TimeoutError(
                            f"shards never settled: {table.describe()}"
                        )
                    await asyncio.sleep(0.1)

            async def check_invariants():
                await settle()
                _assert_no_orphans(rt)
                _assert_table_consistent(sb)
                for p, off in acked.items():
                    rows = await _retry(
                        lambda p=p, off=off: c.fetch("t", p, off)
                    )
                    assert rows, f"acked record lost on partition {p}"

            # -- kill at each GROW boundary: grow fails, rolls back --
            for event in ("spawn.forked", "grow.ready"):
                rt.nemesis = ProcSchedule(
                    rules=[ProcRule(event=event, action="kill")], seed=1
                )
                before = set(rt.shard_pids)
                with pytest.raises(Exception):
                    await lc.grow()
                assert set(rt.shard_pids) == before, event
                await check_invariants()
            # fork_fail at spawn.fork: grow reports failure, no state
            rt.nemesis = ProcSchedule(
                rules=[ProcRule(event="spawn.fork", action="fork_fail")],
                seed=1,
            )
            with pytest.raises(ForkFailInjected):
                await lc.grow()
            await check_invariants()
            # kill at grow.activate: the shard IS activated (placement
            # visible) before the supervisor restarts it in place
            rt.nemesis = ProcSchedule(
                rules=[ProcRule(event="grow.activate", action="kill")],
                seed=1,
            )
            sid = await lc.grow()
            await check_invariants()
            assert sid in rt.shard_pids

            # -- kill at each RETIRE boundary ------------------------
            # mid-freeze / mid-evacuate / mid-drain: the dying worker
            # is restarted in place by the supervisor; retire either
            # completes against the reborn shard or rolls back to
            # active — the table never strands a group
            for event in ("retire.freeze", "retire.evacuate",
                          "retire.drain", "retire.stop"):
                rt.nemesis = ProcSchedule(
                    rules=[ProcRule(event=event, action="kill")], seed=1
                )
                try:
                    await lc.retire(sid)
                    retired = True
                except Exception:
                    retired = False
                await check_invariants()
                if retired:
                    assert sid not in rt.shard_pids
                    # grow a fresh provisional shard for the next leg
                    rt.nemesis = None
                    sid = await lc.grow()
                    await check_invariants()
            rt.nemesis = None
            if sid in rt.shard_pids:
                await lc.retire(sid)
                await check_invariants()

            # -- kill mid-PRODUCE ------------------------------------
            rt.nemesis = ProcSchedule(
                rules=[ProcRule(event="produce", action="kill")], seed=1
            )
            # the in-flight produce answers a retriable error (client
            # retries through it) and NEVER hangs; the record that was
            # finally acked is durable
            off = await asyncio.wait_for(
                _retry(lambda: c.produce("t", 0, [(b"k", b"mid-fault")]),
                       timeout=30.0),
                60.0,
            )
            await check_invariants()
            rows = await _retry(lambda: c.fetch("t", 0, off))
            assert rows, "record acked through the produce fault lost"

            # -- kill mid-RESTART (restart.readopt) ------------------
            rt.nemesis = ProcSchedule(
                rules=[ProcRule(event="restart.readopt", action="kill")],
                seed=1,
            )
            os.kill(rt.shard_pids[1], signal.SIGKILL)
            await check_invariants()
            assert rt.shard_restarts.get(1, 0) >= 2  # killed twice over
            # trace is replayable: same seed + recorded events ==
            # byte-equal firing trace
            trace = rt.nemesis.trace
            replay = ProcSchedule(
                rules=[ProcRule(event="restart.readopt", action="kill")],
                seed=1,
            )
            for line in trace:
                # "#i action sN event"
                _, _, s, event = line.split(" ", 3)
                replay.act(int(s[1:]), event)
            assert replay.trace == trace
        finally:
            await c.close()
            await sb.stop()
        # post-stop: every worker is reaped, nothing orphaned
        assert not rt.shard_pids

    run(main())


def test_unavailable_shard_answers_retriable_not_hang(tmp_path):
    """The graceful-degradation contract, enforced directly: while a
    shard's groups are marked UNAVAILABLE, produce/fetch/list_offsets
    answer retriable errors within the RPC deadline — no hang, no
    invoke into the dead channel."""
    from redpanda_tpu_torch.kafka.client import KafkaClient
    from redpanda_tpu_torch.models.fundamental import kafka_ntp

    async def main():
        sb = await _boot(tmp_path)
        c = KafkaClient([("127.0.0.1", sb.kafka_port)])
        try:
            await _seed_topic(sb, c)
            table = sb.broker.shard_table
            victims = [
                p for p in range(4)
                if table.shard_for(kafka_ntp("t", p)) == 1
            ]
            assert victims, "no partition on shard 1"
            p = victims[0]
            table.set_unavailable(1, True)
            try:
                t0 = asyncio.get_event_loop().time()
                with pytest.raises(Exception) as ei:
                    # client-side leader retry gives up once the
                    # retriable error persists past its window
                    await asyncio.wait_for(
                        c.produce("t", p, [(b"k", b"x")], timeout_ms=2000),
                        30.0,
                    )
                assert not isinstance(ei.value, asyncio.TimeoutError), (
                    "produce to an unavailable shard HUNG"
                )
                # fetch: answers not_leader (retriable) immediately
                with pytest.raises(Exception) as ei:
                    await asyncio.wait_for(c.fetch("t", p, 0), 30.0)
                assert not isinstance(ei.value, asyncio.TimeoutError), (
                    "fetch from an unavailable shard HUNG"
                )
            finally:
                table.set_unavailable(1, False)
            # marker lifted: traffic flows again
            off = await _retry(lambda: c.produce("t", p, [(b"k", b"y")]))
            rows = await _retry(lambda: c.fetch("t", p, off))
            assert rows
        finally:
            await c.close()
            await sb.stop()

    run(main())
