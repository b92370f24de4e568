"""tests/test_iofaults.py run on the port: all 10 cases, with imports
pointed at redpanda_tpu_torch. `ChaosCluster`, `SeqProducer` and
`validate` come from the port's harness copy (`test_torch_chaos_harness`,
brokers on the CPU) and `linear_check` is imported as it is. An autouse
fixture sets `ops.default_device` (the codec and CRC entries' device) to
"cpu". Nothing is left out.

iofaults + linearizability (VERDICT r4 #5).

The reference's consistency stack runs a FUSE passthrough injecting
per-op faults under live workloads (consistency-testing/iofaults).
Here: the in-process iofault layer (storage/iofaults.py) + the
linearizability checker (linear_check.py), validated both ways —
clean runs pass, and a planted fsync lie (the firmware-lies bug
class) is DETECTED as acked-data loss after a simulated power cut.
"""

import asyncio
import contextlib
import os
import time

import pytest

from redpanda_tpu_torch.kafka.client import KafkaClient, KafkaClientError
from redpanda_tpu_torch.storage import iofaults
from redpanda_tpu_torch.storage.iofaults import FaultSchedule, Rule

from test_torch_chaos_harness import ChaosCluster, SeqProducer, validate
from linear_check import LinearHistory, check
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


@pytest.fixture(autouse=True)
def _clear_iofaults():
    yield
    iofaults.clear()


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ---------------------------------------------------------------- unit
def test_rules_fire_and_power_cut_truncates(tmp_path):
    sched = FaultSchedule(
        rules=[Rule(path_glob="*/lied.bin", op="fsync", action="lie_fsync")],
        seed=1,
    )
    iofaults.install(sched)
    honest = str(tmp_path / "honest.bin")
    lied = str(tmp_path / "lied.bin")
    for path in (honest, lied):
        f = open(path, "wb")
        f.write(b"A" * 100)
        f.flush()
        os.fsync(f.fileno())  # honest file records synced=100; lied lies
        f.write(b"B" * 50)  # unsynced tail on both
        f.flush()
        f.close()
    lost = iofaults.simulate_power_cut(str(tmp_path))
    sizes = {os.path.basename(p): (old, new) for p, old, new in lost}
    assert os.path.getsize(honest) == 100  # synced prefix survives
    assert os.path.getsize(lied) == 0  # every byte was unsynced
    assert sizes["honest.bin"] == (150, 100)
    assert sizes["lied.bin"] == (150, 0)
    assert sched.injected.get("lie_fsync", 0) == 1


def test_dir_entry_durability_unit(tmp_path):
    """Directory-entry simulation: a file created during the fault
    window vanishes on power cut unless an HONEST dir fsync captured
    its name — even when the file's own bytes were fsynced."""
    from redpanda_tpu_torch.storage import dirsync

    pre = str(tmp_path / "pre.bin")
    with open(pre, "wb") as f:
        f.write(b"old")
    iofaults.install(FaultSchedule(rules=[], seed=7), watch_dir=str(tmp_path))

    def make(path):
        with open(path, "wb") as f:
            f.write(b"A" * 64)
            f.flush()
            os.fsync(f.fileno())  # bytes synced; entry still volatile

    entry_synced = str(tmp_path / "entry_synced.bin")
    entry_lost = str(tmp_path / "entry_lost.bin")
    make(entry_synced)
    dirsync.fsync_dir(str(tmp_path))  # captures entry_synced (+ pre)
    make(entry_lost)  # created AFTER the dir sync: entry volatile
    lost = iofaults.simulate_power_cut(str(tmp_path))
    assert os.path.exists(pre), "baseline file predates the window"
    assert os.path.exists(entry_synced), "dir-fsynced entry must survive"
    assert not os.path.exists(entry_lost), "unsynced entry must vanish"
    assert (entry_lost, 64, -1) in lost


def test_dir_entry_rename_tracks_synced_size(tmp_path):
    """tmp-write + fsync + os.replace: the synced-size record follows
    the rename, and the renamed entry is durable once the dir is."""
    from redpanda_tpu_torch.storage import dirsync

    iofaults.install(FaultSchedule(rules=[], seed=8), watch_dir=str(tmp_path))
    tmp = str(tmp_path / "state.tmp")
    final = str(tmp_path / "state")
    with open(tmp, "wb") as f:
        f.write(b"S" * 32)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    dirsync.fsync_dir(str(tmp_path))
    iofaults.simulate_power_cut(str(tmp_path))
    assert os.path.getsize(final) == 32  # not truncated to 0


def test_write_error_and_delay_rules(tmp_path):
    sched = FaultSchedule(
        rules=[
            Rule(
                path_glob="*/f.bin", op="write", action="error", nth=2,
                count=1,
            ),
        ],
        seed=2,
    )
    iofaults.install(sched)
    f = iofaults.wrap(open(tmp_path / "f.bin", "wb"), str(tmp_path / "f.bin"))
    f.write(b"ok")  # 1st matching op: nth=2 → no fire
    with pytest.raises(OSError):
        f.write(b"boom")  # 2nd: EIO
    f.write(b"ok2")  # count=1 exhausted
    f.close()


# ----------------------------------------------------- cluster durability
async def _produce_some(cluster, topic, n_partitions, n_records):
    client = KafkaClient(cluster.addresses())
    acked = []
    try:
        await client.create_topic(
            topic, partitions=n_partitions, replication_factor=3
        )
        for i in range(n_records):
            pid = i % n_partitions
            off = await client.produce(
                topic, pid, [(b"seq-%d" % i, b"payload-%d" % i)], acks=-1
            )
            acked.append((pid, off, i))
    finally:
        await client.close()
    return acked


async def _read_back(cluster, topic, n_partitions, timeout_s=45.0):
    """Post-restart read: the controller replays/reconciles and
    partitions materialize asynchronously — retry until every
    partition answers (or the deadline passes, returning partials so
    the caller's asserts show what's missing)."""
    out = {}
    deadline = time.monotonic() + timeout_s
    while len(out) < n_partitions and time.monotonic() < deadline:
        client = KafkaClient(cluster.addresses())
        try:
            for pid in range(n_partitions):
                if pid in out:
                    continue
                got = await client.fetch(
                    topic, pid, 0, max_bytes=1 << 24, max_wait_ms=100
                )
                out[pid] = {o: (k, v) for o, k, v in got}
        except (KafkaClientError, OSError, asyncio.TimeoutError):
            await asyncio.sleep(0.5)
        finally:
            with contextlib.suppress(Exception):
                await client.close()
    for pid in range(n_partitions):
        out.setdefault(pid, {})
    return out


def test_power_cut_durability_honest_fsync(tmp_path):
    """Whole-cluster power cut with HONEST fsyncs: every acks=-1
    record must survive files being truncated to their fsynced sizes —
    the strongest offline probe of the stable-offset contract."""

    async def main():
        iofaults.install(FaultSchedule(rules=[], seed=3))
        cluster = ChaosCluster(tmp_path, 3)
        await cluster.start()
        acked = await _produce_some(cluster, "dur", 4, 60)
        assert len(acked) == 60
        await cluster.stop()
        lost = iofaults.simulate_power_cut(str(tmp_path))
        # restart the world on the truncated state
        for nid in range(3):
            await cluster.restart(nid)
        data = await _read_back(cluster, "dur", 4)
        for pid, off, seq in acked:
            entry = data[pid].get(off)
            assert entry is not None, (
                f"p{pid}@{off} (seq {seq}) lost after honest power cut; "
                f"truncated files: {[(os.path.basename(p), o, n) for p, o, n in lost][:10]}"
            )
            assert entry == (b"seq-%d" % seq, b"payload-%d" % seq)
        await cluster.stop()

    run(main())


def test_lying_fsync_detected_after_power_cut(tmp_path):
    """Seeded-bug validation: with fsync LYING on every node's segment
    files, a whole-cluster power cut chops the acked tail and the
    read-back check MUST detect the loss (proves the harness can see
    the bug class it exists for)."""

    async def main():
        iofaults.install(
            FaultSchedule(
                rules=[
                    Rule(
                        path_glob="*.log", op="fsync", action="lie_fsync"
                    ),
                ],
                seed=4,
            )
        )
        cluster = ChaosCluster(tmp_path, 3)
        await cluster.start()
        acked = await _produce_some(cluster, "lie", 2, 40)
        await cluster.stop()
        iofaults.simulate_power_cut(str(tmp_path))
        for nid in range(3):
            await cluster.restart(nid)
        data = await _read_back(cluster, "lie", 2)
        missing = [
            (pid, off, seq)
            for pid, off, seq in acked
            if data[pid].get(off) != (b"seq-%d" % seq, b"payload-%d" % seq)
        ]
        await cluster.stop()
        return missing

    missing = run(main())
    assert missing, (
        "lying fsync + power cut lost nothing — the probe cannot see "
        "the bug class it exists for"
    )


def test_power_cut_dir_entry_durability(tmp_path):
    """Power cut WITH directory-entry simulation armed: acked data
    must still survive — the storage layer's parent-dir fsyncs
    (segments at create, kvstore WAL at open, start-offset and
    snapshot renames) are what keep every acked file's NAME on the
    platter, not just its bytes."""

    async def main():
        iofaults.install(
            FaultSchedule(rules=[], seed=9), watch_dir=str(tmp_path)
        )
        cluster = ChaosCluster(tmp_path, 3)
        await cluster.start()
        acked = await _produce_some(cluster, "dirdur", 2, 40)
        assert len(acked) == 40
        await cluster.stop()
        lost = iofaults.simulate_power_cut(str(tmp_path))
        vanished = [p for p, _o, n in lost if n == -1]
        for nid in range(3):
            await cluster.restart(nid)
        data = await _read_back(cluster, "dirdur", 2)
        for pid, off, seq in acked:
            entry = data[pid].get(off)
            assert entry is not None, (
                f"p{pid}@{off} (seq {seq}) lost after dir-entry power cut; "
                f"vanished files: {[os.path.basename(p) for p in vanished][:10]}"
            )
            assert entry == (b"seq-%d" % seq, b"payload-%d" % seq)
        await cluster.stop()

    run(main())


def test_lying_dirsync_detected_after_power_cut(tmp_path):
    """Seeded-bug validation for the dir-entry gap: with every
    DIRECTORY fsync lying, created files' names never reach the
    platter, the power cut unlinks them, and read-back MUST observe
    acked-data loss (proves the probe sees this bug class)."""

    async def main():
        iofaults.install(
            FaultSchedule(
                rules=[Rule(path_glob="*", op="dirsync", action="lie_fsync")],
                seed=10,
            ),
            watch_dir=str(tmp_path),
        )
        cluster = ChaosCluster(tmp_path, 3)
        await cluster.start()
        acked = await _produce_some(cluster, "dirlie", 2, 30)
        await cluster.stop()
        lost = iofaults.simulate_power_cut(str(tmp_path))
        assert any(n == -1 for _p, _o, n in lost), (
            "lying dirsync left every entry durable — simulation inert"
        )
        for nid in range(3):
            await cluster.restart(nid)
        data = await _read_back(cluster, "dirlie", 2, timeout_s=10.0)
        missing = [
            (pid, off, seq)
            for pid, off, seq in acked
            if data[pid].get(off) != (b"seq-%d" % seq, b"payload-%d" % seq)
        ]
        await cluster.stop()
        return missing

    missing = run(main())
    assert missing, (
        "lying dirsync + power cut lost nothing — the probe cannot see "
        "the dir-entry bug class it exists for"
    )


# ----------------------------------------------- live linearizability
def test_linearizable_under_injected_write_delays(tmp_path):
    """Concurrent producers + readers under per-op write delays: the
    history must check clean (L1-L4) — faults slow the log, they must
    never reorder or hole it."""

    async def main():
        iofaults.install(
            FaultSchedule(
                rules=[
                    Rule(
                        path_glob="*.log", op="write", action="delay",
                        delay_s=0.005, nth=7, count=200,
                    ),
                ],
                seed=5,
            )
        )
        cluster = ChaosCluster(tmp_path, 3)
        await cluster.start()
        topic, n_partitions = "lin", 2
        client = KafkaClient(cluster.addresses())
        await client.create_topic(
            topic, partitions=n_partitions, replication_factor=3
        )
        await client.close()
        hist = LinearHistory()
        stop = [False]

        async def producer(idx: int):
            c = KafkaClient(cluster.addresses())
            seq = idx * 100000
            try:
                while not stop[0]:
                    seq += 1
                    pid = seq % n_partitions
                    op = hist.begin_produce(pid, seq)
                    try:
                        off = await asyncio.wait_for(
                            c.produce(
                                topic, pid,
                                [(b"seq-%d" % seq, b"payload-%d" % seq)],
                                acks=-1,
                            ),
                            timeout=5.0,
                        )
                        hist.ack(op, off)
                    except (KafkaClientError, asyncio.TimeoutError, OSError):
                        pass
                    await asyncio.sleep(0.002)
            finally:
                with contextlib.suppress(Exception):
                    await c.close()

        async def reader():
            c = KafkaClient(cluster.addresses())
            try:
                while not stop[0]:
                    for pid in range(n_partitions):
                        t0 = time.monotonic()
                        try:
                            got = await c.fetch(
                                topic, pid, 0, max_bytes=1 << 24,
                                max_wait_ms=50,
                            )
                            hist.record_fetch(pid, 0, t0, got)
                        except (KafkaClientError, OSError):
                            pass
                    await asyncio.sleep(0.02)
            finally:
                with contextlib.suppress(Exception):
                    await c.close()

        tasks = [
            asyncio.ensure_future(producer(0)),
            asyncio.ensure_future(producer(1)),
            asyncio.ensure_future(reader()),
        ]
        await asyncio.sleep(6.0)
        stop[0] = True
        await asyncio.gather(*tasks)
        stats = check(hist)
        assert stats["acked"] >= 50, stats  # delays must not starve it
        sched_stats = iofaults._schedule.injected
        assert sched_stats.get("delay", 0) > 0, "no faults actually fired"
        await cluster.stop()
        return stats

    stats = run(main())


def test_linear_checker_catches_seeded_violations():
    """The checker itself must see planted L2/L3 bugs (meta-test)."""
    h = LinearHistory()
    a = h.begin_produce(0, 1)
    h.ack(a, 5)
    b = h.begin_produce(0, 2)  # invoked after a acked
    h.ack(b, 3)  # offset went BACKWARD: L2 violation
    with pytest.raises(AssertionError, match="L2"):
        check(h)

    h2 = LinearHistory()
    p = h2.begin_produce(0, 1)
    h2.ack(p, 2)
    t0 = time.monotonic()
    # fetch AFTER the ack returns offsets 1 and 3 but skips acked 2
    h2.record_fetch(
        0, 0, t0,
        [(1, b"seq-0", b"payload-0"), (3, b"seq-9", b"payload-9")],
    )
    with pytest.raises(AssertionError, match="L3"):
        check(h2)
