"""tests/test_tiered_storage.py run on the port: all 11 test functions,
with imports pointed at redpanda_tpu_torch. Every broker is the port's
on the CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.


Tiered storage: archival upload, archive-gated retention, remote
reads below the local log start, and topic recovery from manifests.

Reference test model: cloud_storage/tests/remote_partition_test.cc,
archival/tests/ntp_archiver_test.cc, rptest shadow-indexing tests.
"""

import asyncio
import contextlib

import pytest

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.cloud import (
    FilesystemObjectStore,
    MemoryObjectStore,
    PartitionManifest,
    RemoteReader,
    SegmentMeta,
)
from redpanda_tpu_torch.cloud.object_store import RetryingStore, StoreError
from redpanda_tpu_torch.kafka.client import KafkaClient, KafkaClientError
from redpanda_tpu_torch.models.fundamental import kafka_ntp
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


# -- object store unit level ------------------------------------------
def test_filesystem_store_roundtrip(tmp_path):
    async def main():
        store = FilesystemObjectStore(str(tmp_path / "bucket"))
        await store.put("a/b/seg.bin", b"data1")
        await store.put("a/b/manifest.bin", b"m")
        assert await store.get("a/b/seg.bin") == b"data1"
        assert await store.exists("a/b/manifest.bin")
        assert await store.list("a/b/") == ["a/b/manifest.bin", "a/b/seg.bin"]
        await store.delete("a/b/seg.bin")
        assert not await store.exists("a/b/seg.bin")
        with pytest.raises(StoreError):
            await store.get("a/b/seg.bin")
        with pytest.raises(StoreError):
            await store.get("../escape")

    asyncio.run(main())


def test_retrying_store_survives_transient_failures(tmp_path):
    from redpanda_tpu_torch.cloud import (
        NemesisObjectStore,
        StoreFaultSchedule,
        StoreRule,
    )

    def failing(op, n):
        return StoreFaultSchedule(
            rules=[StoreRule(op=op, action="error", count=n)], seed=1
        )

    async def main():
        nem = NemesisObjectStore(MemoryObjectStore())
        store = RetryingStore(nem, attempts=4, base_backoff_s=0.001)
        nem.install(failing("put", 2))
        await store.put("k", b"v")
        nem.install(failing("get", 3))
        assert await store.get("k") == b"v"
        nem.install(failing("get", 4))  # exceeds attempts
        with pytest.raises(StoreError):
            await store.get("k")

    asyncio.run(main())


# -- broker e2e -------------------------------------------------------
@contextlib.asynccontextmanager
async def tiered_broker(tmp_path, store, **cfg):
    net = LoopbackNetwork()
    b = Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
            housekeeping_interval_s=0,  # drive manually
            archival_interval_s=0,  # drive manually
            **cfg,
        ),
        loopback=net,
        object_store=store,
    )
    await b.start()
    b.config.peer_kafka_addresses = {0: b.kafka_advertised}
    try:
        await b.wait_controller_leader()
        yield b
    finally:
        await b.stop()


async def _produce_n(client, topic, n, start=0):
    for i in range(start, start + n):
        await client.produce(topic, 0, [(b"k%d" % i, b"v%d" % i)])


async def _archive_cycle(tmp_path):
    store = MemoryObjectStore()
    async with tiered_broker(tmp_path, store) as b:
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic(
            "tt",
            partitions=1,
            replication_factor=1,
            configs={
                "redpanda.remote.write": "true",
                "redpanda.remote.read": "true",
                "segment.bytes": "400",
                "retention.bytes": "400",
            },
        )
        await _produce_n(client, "tt", 12)
        p = b.partition_manager.get(kafka_ntp("tt", 0))
        p.log.flush()
        n_segs = p.log.segment_count()
        assert n_segs > 2

        # archival uploads every closed, committed segment
        uploaded = await b.archival.run_once()
        assert uploaded == n_segs - 1
        manifest = p.archiver.manifest
        assert manifest.archived_upto >= 0
        # segments land before the manifest that references them
        for meta in manifest.segments:
            assert await store.exists(manifest.segment_key(meta))

        # retention trims the local log only within the archived range
        b.storage.log_mgr.housekeeping()
        start_after = p.log.offsets().start_offset
        assert start_after > 0, "retention should trim archived prefix"
        assert start_after <= manifest.archived_upto + 1

        # fetch from offset 0: served from the object store (below the
        # local start), stitched seamlessly with local data
        got = await client.fetch("tt", 0, 0, max_bytes=1 << 22)
        assert [(k, v) for _o, k, v in got] == [
            (b"k%d" % i, b"v%d" % i) for i in range(12)
        ]
        offsets = [o for o, _k, _v in got]
        assert offsets == list(range(12))
        assert b.remote_reader.hydrations > 0

        # an offset below the cloud start is a genuine out-of-range
        # (nothing is below cloud start here, so probe metadata only)
        cstart = p.cloud_start_kafka()
        assert cstart == 0
        await client.close()
        return store


def test_archive_retention_remote_read(tmp_path):
    asyncio.run(_archive_cycle(tmp_path))


async def _recovery(tmp_path):
    # phase 1: produce + archive, then destroy the broker's data dir
    store = MemoryObjectStore()
    async with tiered_broker(tmp_path, store) as b:
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic(
            "rt",
            partitions=1,
            replication_factor=1,
            configs={
                "redpanda.remote.write": "true",
                "redpanda.remote.read": "true",
                "segment.bytes": "400",
            },
        )
        await _produce_n(client, "rt", 10)
        p = b.partition_manager.get(kafka_ntp("rt", 0))
        p.log.flush()
        await b.archival.run_once()
        archived = p.archiver.manifest.archived_upto
        assert archived >= 0
        await client.close()

    # phase 2: a FRESH broker (new data dir) recovers the topic from
    # the object store
    async with tiered_broker(tmp_path / "fresh", store) as b2:
        await b2.recover_topic_from_cloud("rt")
        # the controller backend materializes the partition from the
        # replicated delta asynchronously: wait, don't race it
        deadline = asyncio.get_event_loop().time() + 15.0
        while b2.partition_manager.get(kafka_ntp("rt", 0)) is None:
            assert asyncio.get_event_loop().time() < deadline, (
                "recovered partition never materialized"
            )
            await asyncio.sleep(0.05)
        p2 = b2.partition_manager.get(kafka_ntp("rt", 0))
        assert p2 is not None

        client = KafkaClient([b2.kafka_advertised])
        # archived data serves from the cloud
        got = await client.fetch("rt", 0, 0, max_bytes=1 << 22)
        kvs = [(k, v) for _o, k, v in got]
        # everything the manifest covered is readable
        assert (b"k0", b"v0") in kvs
        assert len(kvs) >= 8
        # new appends continue AFTER the archived range (offsets never
        # regress or collide)
        first_new = await client.produce("rt", 0, [(b"post", b"recovery")])
        assert first_new > max(o for o, _k, _v in got)
        got2 = await client.fetch("rt", 0, first_new)
        assert [(k, v) for _o, k, v in got2] == [(b"post", b"recovery")]
        await client.close()


@pytest.mark.timing
def test_topic_recovery_from_cloud(tmp_path):
    asyncio.run(_recovery(tmp_path))


async def _replicated_archival_stm(tmp_path):
    """archival_metadata_stm behavior: followers learn the archived
    boundary from the raft log (zero object-store reads), and a new
    leader whose replicated state lags the store converges via a
    replicated reset."""
    net = LoopbackNetwork()
    store = MemoryObjectStore()
    members = [0, 1, 2]
    brokers = [
        Broker(
            BrokerConfig(
                device="cpu",
                node_id=i,
                data_dir=str(tmp_path / f"n{i}"),
                members=members,
                election_timeout_s=0.15,
                heartbeat_interval_s=0.03,
                housekeeping_interval_s=0,
                archival_interval_s=0,
            ),
            loopback=net,
            object_store=store,
        )
        for i in members
    ]
    for b in brokers:
        await b.start()
    addrs = {b.node_id: b.kafka_advertised for b in brokers}
    for b in brokers:
        b.config.peer_kafka_addresses = addrs
    try:
        await brokers[0].wait_controller_leader()
        client = KafkaClient([b.kafka_advertised for b in brokers])
        await client.create_topic(
            "rt",
            partitions=1,
            replication_factor=3,
            configs={
                "redpanda.remote.write": "true",
                "segment.bytes": "400",
            },
        )
        for i in range(10):
            await client.produce("rt", 0, [(b"k%d" % i, b"v%d" % i)], acks=-1)

        parts = {}
        for b in brokers:
            p = b.partition_manager.get(kafka_ntp("rt", 0))
            assert p is not None
            parts[b.node_id] = p
        leader = next(
            b for b in brokers if parts[b.node_id].consensus.is_leader()
        )
        lp = parts[leader.node_id]
        lp.log.flush()
        uploaded = await leader.archival.run_once()
        assert uploaded >= 1
        # follower passes attach their archivers and do NOTHING else —
        # no store reads, no uploads (state arrives via the log)
        gets_before = store.get_count
        for b in brokers:
            if b is not leader:
                assert await b.archival.run_once() == 0
        assert store.get_count == gets_before, "follower touched the store"

        # every follower sees the archived boundary via REPLICATION —
        # none of them ever ran an upload or read the store. The
        # archiver property folds committed commands before reading.
        upto = lp.archiver.archived_upto
        assert upto >= 0
        for _ in range(100):
            if all(
                p.archiver.archived_upto == upto for p in parts.values()
            ):
                break
            await asyncio.sleep(0.02)
        for nid, p in parts.items():
            assert p.archiver.archived_upto == upto, f"node {nid} lags"

        # store-ahead heal: wipe the replicated state on the leader
        # (stand-in for a crash after the store put but before the
        # command committed) — the next leader pass replicates a reset
        # that restores it cluster-wide from the store manifest
        lp.archival.clear()
        lp.archiver._synced_term = -1
        assert lp.archival.archived_upto == -1
        await leader.archival.run_once()
        # the heal restores AT LEAST the lost state; the pass may also
        # upload segments that closed since (metadata batches roll the
        # 400-byte segments), so compare against the leader's new value
        upto2 = lp.archiver.archived_upto
        assert upto2 >= upto
        for _ in range(100):
            if all(
                p.archiver.archived_upto == upto2 for p in parts.values()
            ):
                break
            await asyncio.sleep(0.02)
        for nid, p in parts.items():
            assert p.archiver.archived_upto == upto2, f"node {nid} not healed"

        # opposite skew: replicated state AHEAD of the store manifest
        # (crash between the committed add_segment and the manifest
        # put) — the next pass re-exports manifest.bin even with no
        # new segments to upload
        mkey = lp.archiver._manifest_key()
        del store._data[mkey]
        lp.archiver._synced_term = -1
        await leader.archival.run_once()
        assert await store.exists(mkey), "manifest.bin not re-exported"
        healed = PartitionManifest.decode(await store.get(mkey))
        assert healed.archived_upto == lp.archiver.archived_upto

        # snapshot round-trip carries the archival state
        blob = lp.capture_snapshot(lp.consensus.commit_index)
        from redpanda_tpu_torch.cluster.partition import _PartitionSnapshot
        from redpanda_tpu_torch.cluster.archival_stm import ArchivalState

        ps = _PartitionSnapshot.decode(blob)
        restored = ArchivalState.decode(ps.archival)
        assert restored.archived_upto == lp.archiver.archived_upto
        assert [s.base_offset for s in restored.segments] == [
            s.base_offset for s in lp.archival.segments
        ]
        await client.close()
    finally:
        for b in brokers:
            await b.stop()


def test_replicated_archival_stm(tmp_path):
    asyncio.run(_replicated_archival_stm(tmp_path))


def test_remote_reader_segment_location():
    m = PartitionManifest(ns="kafka", topic="t", partition=0, revision=1, segments=[])
    m.add(SegmentMeta(base_offset=0, last_offset=9, term=1, size_bytes=100,
                      base_timestamp=-1, max_timestamp=-1, delta_offset=0,
                      delta_offset_end=1))
    m.add(SegmentMeta(base_offset=10, last_offset=25, term=2, size_bytes=100,
                      base_timestamp=-1, max_timestamp=-1, delta_offset=1,
                      delta_offset_end=2))
    r = RemoteReader(MemoryObjectStore())
    assert r.cloud_start_kafka(m) == 0
    # kafka 8 is still in segment 1 (raft 0..9, delta 0 → kafka 0..8ish)
    assert r.find_segment(m, 8).base_offset == 0
    # kafka 9 = raft 10 - delta 1 → segment 2's first kafka offset
    assert r.find_segment(m, 9).base_offset == 10
    # overlap rejected
    with pytest.raises(ValueError):
        m.add(SegmentMeta(base_offset=20, last_offset=30, term=2, size_bytes=1,
                          base_timestamp=-1, max_timestamp=-1, delta_offset=0,
                          delta_offset_end=0))


async def _cloud_retention(tmp_path):
    """Split retention (Redpanda semantics): retention.local.target.*
    trims the local log, retention.* bounds the ARCHIVED history — the
    replicated TRUNCATE drops leading segments from every replica's
    view and the objects are deleted from the bucket."""
    store = MemoryObjectStore()
    async with tiered_broker(tmp_path, store) as b:
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic(
            "cr",
            partitions=1,
            replication_factor=1,
            configs={
                "redpanda.remote.write": "true",
                "redpanda.remote.read": "true",
                "segment.bytes": "400",
                "retention.local.target.bytes": "400",
                "retention.bytes": "500",
            },
        )
        # wave 1: one closed segment, inside the cloud budget
        await _produce_n(client, "cr", 6)
        p = b.partition_manager.get(kafka_ntp("cr", 0))
        p.log.flush()
        await b.archival.run_once()
        objects_before = {k for k in store._data if ".seg" in k.rsplit("/", 1)[-1]}
        assert objects_before, "nothing archived"
        oldest = min(objects_before)
        upto_before = p.archiver.archived_upto

        # wave 2: more data pushes the ARCHIVED total over
        # retention.bytes — the pass uploads the new segments, then
        # cloud retention drops the oldest
        await _produce_n(client, "cr", 6, start=6)
        p.log.flush()
        await b.archival.run_once()
        b.storage.log_mgr.housekeeping()  # local trim by local target
        assert p.log.offsets().start_offset > 0
        objects_after = {k for k in store._data if ".seg" in k.rsplit("/", 1)[-1]}
        assert oldest not in objects_after, sorted(objects_after)
        stm_total = sum(int(s.size_bytes) for s in p.archival.segments)
        assert stm_total <= 500 or len(p.archival.segments) == 1
        # the newest archived range always survives
        assert p.archiver.archived_upto >= upto_before
        # the exported manifest reflects the truncation
        m = PartitionManifest.decode(
            await store.get(p.archiver._manifest_key())
        )
        assert len(m.segments) == len(p.archival.segments)

        # reads: below the new cloud start -> out_of_range; from the
        # new start -> served (remote+local stitched)
        cstart = p.cloud_start_kafka()
        assert cstart is not None and cstart > 0
        with pytest.raises(KafkaClientError):
            await client.fetch("cr", 0, 0)
        got = await client.fetch("cr", 0, cstart, max_bytes=1 << 22)
        offsets = [o for o, _k, _v in got]
        assert offsets and offsets[0] == cstart and offsets[-1] == 11
        await client.close()


def test_cloud_retention(tmp_path):
    asyncio.run(_cloud_retention(tmp_path))


async def _boundary_spanning_segment(tmp_path):
    """Regression (chaos-found): when the archived boundary lands
    INSIDE a local segment — leadership moved between replicas with
    different segment layouts, or a local merge re-cut them — the
    archiver must upload the unarchived SUFFIX sliced at the batch
    boundary, not skip the segment (which left a hole like raft
    167-168 missing between manifest entries (160,166) and (169,173))."""
    from redpanda_tpu_torch.storage.compaction import merge_adjacent

    store = MemoryObjectStore()
    async with tiered_broker(tmp_path, store) as b:
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic(
            "bs",
            partitions=1,
            replication_factor=1,
            configs={
                "redpanda.remote.write": "true",
                "redpanda.remote.read": "true",
                "segment.bytes": "400",
            },
        )
        await _produce_n(client, "bs", 10)
        p = b.partition_manager.get(kafka_ntp("bs", 0))
        p.log.flush()
        assert p.log.segment_count() >= 3
        # archive ONLY the first closed segment by capping the pass at
        # its dirty offset (simulates the previous leader's progress)
        # pass 1: archive every closed segment
        await b.archival.run_once()
        upto_before = p.archiver.archived_upto
        assert upto_before >= 0

        # produce more, then MERGE two closed segments so a single
        # local segment now spans the archived boundary
        await _produce_n(client, "bs", 2, start=10)
        p.log.flush()
        merged = merge_adjacent(p.log, max_bytes=1 << 20)
        spanning = [
            s
            for s in p.log._segments
            if s.base_offset <= upto_before < s.dirty_offset
        ]
        assert merged > 0 or spanning, "setup failed to span the boundary"

        await b.archival.run_once()
        m = p.archiver.manifest
        # no gaps: every segment starts right after the previous ends
        last = None
        for s in m.segments:
            if last is not None:
                assert int(s.base_offset) == last + 1, (
                    f"archive gap: ...{last} then {int(s.base_offset)}..."
                )
            last = int(s.last_offset)
        assert m.archived_upto > upto_before  # suffix got archived
        # and the whole history reads back across the seam
        b.storage.log_mgr.housekeeping()
        got = await client.fetch("bs", 0, 0, max_bytes=1 << 22)
        assert [k for _o, k, _v in got] == [b"k%d" % i for i in range(12)]
        await client.close()


def test_archiver_slices_boundary_spanning_segment(tmp_path):
    asyncio.run(_boundary_spanning_segment(tmp_path))


# -- fault-injected archival (ObjectNemesis) --------------------------
async def _faulted_archival(tmp_path):
    """Partial uploads + torn manifest writes against the archiver:
    the manifest must never reference a missing/truncated object, and
    the retry/verify loop must converge on a whole archive."""
    from redpanda_tpu_torch.cloud import (
        NemesisObjectStore,
        StoreFaultSchedule,
        StoreRule,
    )

    inner = MemoryObjectStore()
    store = NemesisObjectStore(inner)
    async with tiered_broker(tmp_path, store) as b:
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic(
            "ft",
            partitions=1,
            replication_factor=1,
            configs={
                "redpanda.remote.write": "true",
                "redpanda.remote.read": "true",
                "segment.bytes": "400",
                "retention.bytes": "400",
            },
        )
        await _produce_n(client, "ft", 12)
        p = b.partition_manager.get(kafka_ntp("ft", 0))
        p.log.flush()

        # every other put tears: segment uploads persist a truncated
        # prefix then error; manifest exports tear the store manifest
        sched = StoreFaultSchedule(
            rules=[StoreRule(op="put", action="partial", nth=2)],
            seed=99,
        )
        store.install(sched)
        await b.archival.run_once()
        store.clear()

        # invariant: whatever the manifest references exists WHOLE
        # (stored length is size_compressed when the archiver
        # compressed the segment, size_bytes otherwise)
        m = p.archiver.manifest
        for meta in m.segments:
            key = m.segment_key(meta)
            assert await inner.exists(key), f"dangling reference {key}"
            want = int(getattr(meta, "size_compressed", 0)) or int(
                meta.size_bytes
            )
            assert len(inner._data[key]) == want, (
                f"truncated object referenced: {key}"
            )
        # the faults fired (otherwise this test asserts nothing)
        assert sched.injected

        # a clean pass converges the archive and the full history reads
        await b.archival.run_once()
        b.storage.log_mgr.housekeeping()
        got = await client.fetch("ft", 0, 0, max_bytes=1 << 22)
        assert [(k, v) for _o, k, v in got] == [
            (b"k%d" % i, b"v%d" % i) for i in range(12)
        ]
        await client.close()


def test_archiver_survives_partial_uploads(tmp_path):
    asyncio.run(_faulted_archival(tmp_path))


async def _torn_manifest_recovery(tmp_path):
    """A manifest cut mid-write must fall back to the replicated state
    and re-export — never decode-and-serve a dangling reference."""
    store = MemoryObjectStore()
    async with tiered_broker(tmp_path, store) as b:
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic(
            "tm",
            partitions=1,
            replication_factor=1,
            configs={
                "redpanda.remote.write": "true",
                "redpanda.remote.read": "true",
                "segment.bytes": "400",
                "retention.bytes": "400",
            },
        )
        await _produce_n(client, "tm", 12)
        p = b.partition_manager.get(kafka_ntp("tm", 0))
        p.log.flush()
        await b.archival.run_once()
        a = p.archiver
        key = a._manifest_key()
        good = store._data[key]

        # tear the store manifest (a non-atomic backend's partial PUT)
        store._data[key] = good[: len(good) // 2]
        degradations = []
        # service-level hook: run_once propagates it to each archiver
        b.archival.on_degraded = degradations.append
        # force a fresh-term sync: the torn copy must not be served
        a._synced_term = -1
        await b.archival.run_once()
        assert "torn_manifest" in degradations
        # the re-export healed the store copy: decodes whole, and no
        # segment it references is missing or truncated
        healed = PartitionManifest.decode(store._data[key])
        assert healed.archived_upto == a.archived_upto
        for meta in healed.segments:
            k = healed.segment_key(meta)
            assert await store.exists(k)
            want = int(getattr(meta, "size_compressed", 0)) or int(
                meta.size_bytes
            )
            assert len(store._data[k]) == want

        # and archived reads still serve the full history
        b.storage.log_mgr.housekeeping()
        got = await client.fetch("tm", 0, 0, max_bytes=1 << 22)
        assert [k for _o, k, _v in got] == [b"k%d" % i for i in range(12)]
        await client.close()


def test_torn_manifest_recovery(tmp_path):
    asyncio.run(_torn_manifest_recovery(tmp_path))


async def _wedged_store_fetch(tmp_path):
    """A wedged object store must degrade archived-range fetches to a
    RETRIABLE storage error and never block local-log fetches."""
    from redpanda_tpu_torch.cloud import (
        NemesisObjectStore,
        StoreFaultSchedule,
        StoreRule,
    )
    from redpanda_tpu_torch.kafka.protocol.headers import ErrorCode

    inner = MemoryObjectStore()
    store = NemesisObjectStore(inner)
    async with tiered_broker(
        tmp_path,
        store,
        cloud_fetch_timeout_s=0.5,
        cloud_hydration_timeout_s=0.2,
    ) as b:
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic(
            "wt",
            partitions=1,
            replication_factor=1,
            configs={
                "redpanda.remote.write": "true",
                "redpanda.remote.read": "true",
                "segment.bytes": "400",
                "retention.bytes": "400",
            },
        )
        await _produce_n(client, "wt", 12)
        p = b.partition_manager.get(kafka_ntp("wt", 0))
        p.log.flush()
        await b.archival.run_once()
        b.storage.log_mgr.housekeeping()
        local_start = p.log.offsets().start_offset
        assert local_start > 0

        # wedge every read op on the store
        store.install(
            StoreFaultSchedule(
                rules=[
                    StoreRule(op="get", action="hang"),
                    StoreRule(op="get_range", action="hang"),
                ],
                seed=1,
            )
        )
        # archived-range fetch: typed retriable error, bounded time
        t0 = asyncio.get_event_loop().time()
        with pytest.raises(KafkaClientError) as ei:
            await client.fetch("wt", 0, 0, max_bytes=1 << 22)
        assert ei.value.code == int(ErrorCode.kafka_storage_error)
        assert asyncio.get_event_loop().time() - t0 < 10.0

        # local-log fetch through the SAME broker: unaffected
        got = await client.fetch("wt", 0, local_start, max_bytes=1 << 22)
        assert [k for _o, k, _v in got] == [
            b"k%d" % i for i in range(local_start, 12)
        ]

        # store recovers: the archived range serves again
        store.clear()
        got = await client.fetch("wt", 0, 0, max_bytes=1 << 22)
        assert [k for _o, k, _v in got] == [b"k%d" % i for i in range(12)]
        await client.close()


def test_wedged_store_never_blocks_local_fetch(tmp_path):
    asyncio.run(_wedged_store_fetch(tmp_path))
