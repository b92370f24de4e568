"""tests/test_nemesis.py run on the port: all 14 cases, with imports
pointed at redpanda_tpu_torch. `RaftCluster`, `data_batch` and `run`
come from `test_torch_ref_raft` (every GroupManager on the CPU,
`device="cpu"`), `ChaosCluster`, `SeqProducer` and `validate` from the
port's harness copy (`test_torch_chaos_harness`, brokers on the CPU),
and `linear_check` is imported as it is (it imports only the standard
library). An autouse fixture sets `ops.default_device` (the codec and
CRC entries' device) to "cpu". Nothing is left out.

NemesisNet: seeded network-fault schedules + raft message hardening.

Covers the fault layer itself (every NetRule action, deterministic
same-seed replay of the firing trace), the raft consumers' staleness
guards (a replayed/duplicated old append-entries SUCCESS or FAILURE
must move nothing), and whole-cluster runs: duplicate/reorder fuzz on
the heartbeat + append paths with commit monotonicity sampled live,
and a mixed drop/dup/reorder/jitter/asymmetric-partition schedule
under produce-consume load holding chaos invariants I1–I3 plus the
linear_check history checks L1–L4.

Reference model: the reference's network fault injection lives in
rptest/services/failure_injector.py (iptables) and chaos/tests; here
the loopback network hosts the same fault surface in-process.
"""

import asyncio
import contextlib
import random
import time

import pytest

import linear_check
import redpanda_tpu_torch.raft.types as rt
from test_torch_chaos_harness import ChaosCluster, SeqProducer, validate
from redpanda_tpu_torch.kafka.client import KafkaClient, KafkaClientError
from redpanda_tpu_torch.rpc import (
    LoopbackNetwork,
    LoopbackTransport,
    NemesisSchedule,
    NetRule,
)
from redpanda_tpu_torch.rpc.server import Service, method
from redpanda_tpu_torch.rpc.types import RpcError, Status
from test_torch_ref_raft import RaftCluster, data_batch, run
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")

ECHO = 7


class EchoService(Service):
    service_name = "echo"

    def __init__(self):
        self.calls: list[bytes] = []

    @method(ECHO)
    async def echo(self, payload: bytes) -> bytes:
        self.calls.append(payload)
        return b"re:" + payload


def echo_net(n: int = 2) -> tuple[LoopbackNetwork, dict[int, EchoService]]:
    net = LoopbackNetwork()
    svcs = {}
    for nid in range(1, n + 1):
        svcs[nid] = EchoService()
        net.register(nid, svcs[nid])
    return net, svcs


# ---------------------------------------------------------------- rules


def test_netrule_matching_filters_nth_count():
    rng = random.Random(0)
    r = NetRule(src=1, dst=2, method=ECHO, action="drop")
    assert r.matches(1, 2, ECHO, rng)
    assert not r.matches(3, 2, ECHO, rng)  # src filter
    assert not r.matches(1, 3, ECHO, rng)  # dst filter
    assert not r.matches(1, 2, 99, rng)  # method filter

    every_2nd = NetRule(action="drop", nth=2)
    hits = [every_2nd.matches(1, 2, ECHO, rng) for _ in range(6)]
    assert hits == [False, True, False, True, False, True]

    capped = NetRule(action="drop", count=2)
    assert [capped.matches(1, 2, ECHO, rng) for _ in range(4)] == [
        True,
        True,
        False,
        False,
    ]


def test_drop_rule_never_reaches_handler():
    async def main():
        net, svcs = echo_net()
        sched = NemesisSchedule(rules=[NetRule(method=ECHO, action="drop")])
        net.install_nemesis(sched)
        with pytest.raises(ConnectionError, match="nemesis: drop"):
            await net.deliver(1, 2, ECHO, b"x")
        assert svcs[2].calls == []
        assert sched.injected == {"drop": 1}
        assert sched.trace == [f"#0 drop 1->2 m{ECHO}"]
        # clearing the schedule heals the link
        net.clear_nemesis()
        assert await net.deliver(1, 2, ECHO, b"x") == b"re:x"

    run(main())


def test_one_way_partition_is_directional():
    async def main():
        net, svcs = echo_net()
        net.install_nemesis(
            NemesisSchedule(rules=[NetRule(src=1, dst=2, action="one_way")])
        )
        with pytest.raises(ConnectionError, match="one_way"):
            await net.deliver(1, 2, ECHO, b"x")
        # the reverse direction stays up: asymmetric partition
        assert await net.deliver(2, 1, ECHO, b"y") == b"re:y"

    run(main())


def test_corrupt_payload_rejected_by_crc_never_dispatched():
    async def main():
        net, svcs = echo_net()
        sched = NemesisSchedule(rules=[NetRule(action="corrupt")])
        net.install_nemesis(sched)
        with pytest.raises(RpcError) as ei:
            await net.deliver(1, 2, ECHO, b"payload-bytes")
        assert ei.value.status == Status.BAD_CHECKSUM
        assert svcs[2].calls == []  # rejected, never applied
        assert sched.injected == {"corrupt": 1}

    run(main())


def test_duplicate_invokes_handler_twice_returns_first_reply():
    async def main():
        net, svcs = echo_net()
        net.install_nemesis(
            NemesisSchedule(rules=[NetRule(action="duplicate", count=1)])
        )
        assert await net.deliver(1, 2, ECHO, b"dup") == b"re:dup"
        assert svcs[2].calls == [b"dup", b"dup"]
        # count cap hit: next delivery is clean
        assert await net.deliver(1, 2, ECHO, b"one") == b"re:one"
        assert svcs[2].calls == [b"dup", b"dup", b"one"]

    run(main())


def test_slow_link_latency_scales_with_payload():
    async def main():
        net, _ = echo_net()
        net.install_nemesis(
            NemesisSchedule(
                rules=[NetRule(action="slow", bandwidth_bps=1_000_000)]
            )
        )
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        await net.deliver(1, 2, ECHO, b"z" * 100_000)  # => >= 0.1s
        assert loop.time() - t0 >= 0.09

    run(main())


def test_delay_with_jitter_applied():
    async def main():
        net, _ = echo_net()
        net.install_nemesis(
            NemesisSchedule(
                rules=[NetRule(action="delay", delay_s=0.05, jitter_s=0.02)]
            )
        )
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        await net.deliver(1, 2, ECHO, b"x")
        assert loop.time() - t0 >= 0.04

    run(main())


# -------------------------------------------------------------- reorder


async def _reorder_once(seed: int, payloads: list[bytes]) -> list[bytes]:
    """Deliver `payloads` concurrently in list order on a link whose
    reorder window equals len(payloads); return handler arrival order."""
    net, svcs = echo_net()
    net.install_nemesis(
        NemesisSchedule(
            rules=[
                NetRule(
                    action="reorder",
                    reorder_window=len(payloads),
                    reorder_hold_s=5.0,  # failsafe must not fire here
                )
            ],
            seed=seed,
        )
    )
    tasks = []
    for p in payloads:
        tasks.append(asyncio.ensure_future(net.deliver(1, 2, ECHO, p)))
        await asyncio.sleep(0)  # pin arrival order
    replies = await asyncio.gather(*tasks)
    assert replies == [b"re:" + p for p in payloads]  # replies still match
    return list(svcs[2].calls)


def test_reorder_shuffles_deterministically_per_seed():
    payloads = [b"a", b"b", b"c", b"d"]
    order1 = run(_reorder_once(9, payloads))
    order2 = run(_reorder_once(9, payloads))
    assert sorted(order1) == sorted(payloads)  # nothing lost or duped
    assert order1 == order2  # same seed => same release order
    assert order1 != payloads  # seed 9 actually reorders this window


def test_reorder_failsafe_releases_partial_window():
    async def main():
        net, _ = echo_net()
        net.install_nemesis(
            NemesisSchedule(
                rules=[
                    NetRule(
                        action="reorder",
                        reorder_window=8,
                        reorder_hold_s=0.06,
                    )
                ]
            )
        )
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        # a lone message in an 8-wide window: only the hold timer frees it
        assert await net.deliver(1, 2, ECHO, b"solo") == b"re:solo"
        assert loop.time() - t0 >= 0.05

    run(main())


# ------------------------------------------------------ trace determinism


def _mixed_rules() -> list[NetRule]:
    return [
        NetRule(method=ECHO, action="drop", prob=0.2),
        NetRule(src=1, action="delay", prob=0.3, delay_s=0.0, jitter_s=0.0),
        NetRule(action="duplicate", prob=0.15),
        NetRule(action="corrupt", prob=0.1),
    ]


async def _scripted_run(seed: int) -> NemesisSchedule:
    net, _ = echo_net(3)
    sched = NemesisSchedule(rules=_mixed_rules(), seed=seed)
    net.install_nemesis(sched)
    pairs = [(1, 2), (2, 3), (3, 1), (1, 3)]
    for i in range(80):
        src, dst = pairs[i % len(pairs)]
        with contextlib.suppress(RpcError, ConnectionError):
            await net.deliver(src, dst, ECHO, b"m%d" % i)
    return sched


def test_same_seed_same_delivery_sequence_byte_equal_trace():
    s1 = run(_scripted_run(1234))
    s2 = run(_scripted_run(1234))
    assert len(s1.trace) > 10  # the schedule actually fired
    assert "\n".join(s1.trace).encode() == "\n".join(s2.trace).encode()
    assert s1.injected == s2.injected
    s3 = run(_scripted_run(4321))
    assert s3.trace != s1.trace  # a different seed gives a different run


# ------------------------------------------- raft staleness regressions


def test_stale_append_reply_success_cannot_advance(tmp_path):
    """Acceptance regression: a replayed stale append-entries SUCCESS
    (old seq) must advance neither match_index nor commit_index, no
    matter how large a dirty offset it claims."""

    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        await leader.replicate(data_batch(b"seqguard", 4), acks=-1)
        await asyncio.sleep(0.2)

        peer = leader.peers()[0]
        row, slot = leader.row, leader._slot_map[peer]
        # no awaits below this read: the sampled state stays consistent
        seq0 = int(leader.arrays.last_seq[row, slot])
        match0 = int(leader.arrays.match_index[row, slot])
        commit0 = leader.commit_index
        assert match0 >= 0 and seq0 > 0

        # replayed SUCCESS with the seq of an already-folded reply,
        # claiming an absurdly advanced log: must be a no-op
        leader.process_append_reply(peer, match0 + 100, match0 + 100, seq0)
        assert int(leader.arrays.match_index[row, slot]) == match0
        assert leader.commit_index == commit0
        # ancient seq (long-delayed packet finally arriving): no-op too
        leader.process_append_reply(peer, match0 + 50, match0 + 50, 0)
        assert int(leader.arrays.match_index[row, slot]) == match0
        assert leader.commit_index == commit0
        assert int(leader.arrays.last_seq[row, slot]) == seq0

        # a FRESH reply still folds (the guard is staleness, not a wall)
        leader.process_append_reply(peer, match0, match0, seq0 + 1)
        assert int(leader.arrays.last_seq[row, slot]) == seq0 + 1

        await cluster.stop()

    run(main())


def test_stale_heartbeat_failure_cannot_rewind_match(tmp_path):
    """A duplicated/reordered heartbeat FAILURE echo must not rewind
    match_index off old evidence; a fresh FAILURE still does (and the
    catch-up fiber then restores the follower)."""

    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()
        await leader.replicate(data_batch(b"hbguard", 4), acks=-1)
        await asyncio.sleep(0.2)

        hbm = cluster.nodes[leader.node_id].heartbeat_manager
        peer = leader.peers()[0]
        row, slot = leader.row, leader._slot_map[peer]
        seq0 = int(leader.arrays.last_seq[row, slot])
        match0 = int(leader.arrays.match_index[row, slot])
        assert match0 > 0

        def failure_reply(seq: int) -> rt.HeartbeatReply:
            return rt.HeartbeatReply(
                node_id=peer,
                groups=[leader.group_id],
                terms=[leader.term],
                last_dirty=[0],
                last_flushed=[0],
                seqs=[seq],
                statuses=[rt.AppendEntriesReply.FAILURE],
            )

        # stale echo: seq already folded — match must not move
        hbm._handle_failure(leader, peer, failure_reply(seq0), 0)
        assert int(leader.arrays.match_index[row, slot]) == match0
        hbm._handle_failure(leader, peer, failure_reply(0), 0)
        assert int(leader.arrays.match_index[row, slot]) == match0

        # fresh FAILURE rewinds and engages catch-up
        hbm._handle_failure(leader, peer, failure_reply(seq0 + 1), 0)
        assert int(leader.arrays.match_index[row, slot]) == 0
        assert int(leader.arrays.last_seq[row, slot]) == seq0 + 1
        # ...and the catch-up fiber re-advances the follower
        deadline = asyncio.get_event_loop().time() + 3.0
        while asyncio.get_event_loop().time() < deadline:
            if int(leader.arrays.match_index[row, slot]) >= match0:
                break
            await asyncio.sleep(0.05)
        assert int(leader.arrays.match_index[row, slot]) >= match0

        await cluster.stop()

    run(main())


# -------------------------------------------- cluster runs under nemesis


def test_duplicate_reorder_fuzz_no_commit_regression(tmp_path):
    """Satellite: duplicate + reorder delivery fuzz through NemesisNet
    on the heartbeat and append paths. Commit indices are sampled after
    every replicate and must never regress; afterwards the recorded
    arrival sequence replayed through a fresh same-seed schedule must
    reproduce the firing trace byte-for-byte."""

    SEED = 42

    def fuzz_rules() -> list[NetRule]:
        return [
            NetRule(method=rt.HEARTBEAT, action="duplicate", prob=0.25),
            NetRule(method=rt.HEARTBEAT_SAME, action="duplicate", prob=0.25),
            NetRule(method=rt.APPEND_ENTRIES, action="duplicate", prob=0.25),
            NetRule(
                method=rt.APPEND_ENTRIES,
                action="reorder",
                prob=0.2,
                reorder_window=4,
                reorder_hold_s=0.03,
            ),
        ]

    async def main():
        cluster = RaftCluster(tmp_path, n_nodes=3)
        await cluster.start()
        await cluster.create_group()
        leader = await cluster.wait_leader()

        sched = NemesisSchedule(rules=fuzz_rules(), seed=SEED)
        arrivals: list[tuple[int, int, int]] = []
        orig_deliver = cluster.net.deliver

        async def spying_deliver(src, dst, method_id, payload):
            if cluster.net._nemesis is not None:
                arrivals.append((src, dst, method_id))
            return await orig_deliver(src, dst, method_id, payload)

        cluster.net.deliver = spying_deliver
        cluster.net.install_nemesis(sched)

        low_water = {
            nid: cluster.consensus(nid).commit_index for nid in cluster.nodes
        }
        last = -1
        for i in range(30):
            try:
                _, last = await asyncio.wait_for(
                    leader.replicate(data_batch(b"fz%d-" % i, 2), acks=-1),
                    timeout=5.0,
                )
            except Exception:
                leader = await cluster.wait_leader()
            for nid in cluster.nodes:
                c = cluster.consensus(nid)
                ci = c.commit_index
                assert ci >= low_water[nid], (
                    f"node {nid}: commit regressed {low_water[nid]} -> {ci}"
                )
                low_water[nid] = ci

        cluster.net.clear_nemesis()
        assert last >= 0
        # convergence after the nemesis heals
        deadline = asyncio.get_event_loop().time() + 5.0
        while asyncio.get_event_loop().time() < deadline:
            if all(
                cluster.consensus(nid).commit_index >= last
                for nid in cluster.nodes
            ):
                break
            await asyncio.sleep(0.05)
        for nid in cluster.nodes:
            assert cluster.consensus(nid).commit_index >= last

        assert sched.injected.get("duplicate", 0) > 0
        assert sched.injected.get("reorder", 0) > 0

        # byte-equal replay: the trace is a pure function of
        # (seed, arrival sequence)
        replay = NemesisSchedule(rules=fuzz_rules(), seed=SEED)
        for src, dst, method_id in arrivals:
            replay.act(src, dst, method_id)
        assert (
            "\n".join(replay.trace).encode()
            == "\n".join(sched.trace).encode()
        )
        assert replay.injected == sched.injected

        await cluster.stop()

    run(main())


def test_nemesis_mixed_schedule_under_load(tmp_path):
    """Acceptance capstone: drop 5% + duplicate 2% + reorder window 4 +
    jitter on inter-broker RPC, with one asymmetric partition episode
    mid-run, under produce-consume load. The run must hold the chaos
    invariants I1–I3 (chaos_harness.validate) and the history checks
    L1–L4 (linear_check) over a live fetch stream."""

    TOPIC = "nemesis"

    async def main():
        cluster = ChaosCluster(tmp_path, n=3)
        await cluster.start()
        sched = NemesisSchedule(
            rules=[
                NetRule(method=rt.APPEND_ENTRIES, action="drop", prob=0.05),
                NetRule(
                    method=rt.APPEND_ENTRIES, action="duplicate", prob=0.02
                ),
                NetRule(method=rt.HEARTBEAT, action="duplicate", prob=0.02),
                NetRule(
                    method=rt.HEARTBEAT_SAME, action="duplicate", prob=0.02
                ),
                NetRule(
                    method=rt.APPEND_ENTRIES,
                    action="reorder",
                    prob=0.04,
                    reorder_window=4,
                    reorder_hold_s=0.03,
                ),
                NetRule(method=rt.APPEND_ENTRIES, action="corrupt", prob=0.01),
                NetRule(action="delay", prob=0.05, delay_s=0.001, jitter_s=0.004),
            ],
            seed=20260804,
        )
        hist = linear_check.LinearHistory()
        bookkeeper = SeqProducer(cluster, TOPIC, 1)  # acked ground truth
        stop = [False]
        try:
            boot = KafkaClient(cluster.addresses())
            await boot.create_topic(TOPIC, partitions=1, replication_factor=3)
            await boot.close()
            cluster.net.install_nemesis(sched)

            async def produce_loop():
                client = KafkaClient(cluster.addresses())
                seq = 0
                try:
                    while not stop[0]:
                        op = hist.begin_produce(0, seq)
                        bookkeeper.attempts += 1
                        try:
                            off = await asyncio.wait_for(
                                client.produce(
                                    TOPIC,
                                    0,
                                    [
                                        (
                                            b"seq-%d" % seq,
                                            b"payload-%d" % seq,
                                        )
                                    ],
                                    acks=-1,
                                ),
                                timeout=3.0,
                            )
                            hist.ack(op, off)
                            bookkeeper.acked.append((0, off, seq))
                        except (
                            KafkaClientError,
                            asyncio.TimeoutError,
                            OSError,
                        ):
                            with contextlib.suppress(Exception):
                                await client.close()
                            client = KafkaClient(cluster.addresses())
                        seq += 1
                        await asyncio.sleep(0.01)
                finally:
                    with contextlib.suppress(Exception):
                        await client.close()

            async def fetch_loop():
                client = KafkaClient(cluster.addresses())
                try:
                    while not stop[0]:
                        t0 = time.monotonic()
                        try:
                            recs = await asyncio.wait_for(
                                client.fetch(
                                    TOPIC,
                                    0,
                                    0,
                                    max_bytes=1 << 24,
                                    max_wait_ms=50,
                                ),
                                timeout=3.0,
                            )
                            hist.record_fetch(0, 0, t0, recs)
                        except (
                            KafkaClientError,
                            asyncio.TimeoutError,
                            OSError,
                        ):
                            with contextlib.suppress(Exception):
                                await client.close()
                            client = KafkaClient(cluster.addresses())
                        await asyncio.sleep(0.05)
                finally:
                    with contextlib.suppress(Exception):
                        await client.close()

            ptask = asyncio.ensure_future(produce_loop())
            ftask = asyncio.ensure_future(fetch_loop())

            await asyncio.sleep(1.2)
            # asymmetric partition episode: 2 -> 0 dies, 0 -> 2 stays up
            one_way = NetRule(src=2, dst=0, action="one_way")
            sched.rules.insert(0, one_way)
            await asyncio.sleep(1.2)
            sched.rules.remove(one_way)
            await asyncio.sleep(1.6)

            cluster.net.clear_nemesis()  # heal
            await asyncio.sleep(1.0)
            stop[0] = True
            with contextlib.suppress(Exception):
                await asyncio.wait_for(ptask, timeout=5.0)
            with contextlib.suppress(Exception):
                await asyncio.wait_for(ftask, timeout=5.0)
            await asyncio.sleep(0.3)

            # I1–I3 against the acked ground truth
            stats = await validate(cluster, TOPIC, 1, bookkeeper)
            # L1–L4 against the live operation history
            lin = linear_check.check(hist)

            assert stats["acked"] > 15, stats
            assert lin["acked"] == len(bookkeeper.acked)
            assert lin["fetches"] > 10, lin
            # every scheduled fault class actually fired
            assert sched.injected.get("drop", 0) > 0, sched.injected
            assert sched.injected.get("duplicate", 0) > 0, sched.injected
            assert sched.injected.get("reorder", 0) > 0, sched.injected
            assert sched.injected.get("one_way", 0) > 0, sched.injected
            assert len(sched.trace) == sum(sched.injected.values())
        finally:
            await cluster.stop()

    run(main())
