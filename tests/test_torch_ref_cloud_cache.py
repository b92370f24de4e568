"""tests/test_cloud_cache.py run on the port: all 13 test functions,
with imports pointed at redpanda_tpu_torch. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.


Disk-backed chunk cache + chunked remote reads.

Reference behaviors under test: cache_service.{h,cc} (LRU trim to a
size budget, restart recovery from disk), remote_segment.cc chunk
hydration (only touched byte ranges are downloaded, coalesced ranged
GETs), and remote_segment_index (mid-segment reads skip the scan
prefix after a first pass).
"""

import asyncio
import os

import pytest

from redpanda_tpu_torch.cloud.cache_service import CloudCache
from redpanda_tpu_torch.cloud.object_store import (
    FilesystemObjectStore,
    MemoryObjectStore,
    RetryingStore,
)
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def _payload(n: int) -> bytes:
    return bytes((i * 31 + (i >> 8)) & 0xFF for i in range(n))


# -- CloudCache unit ---------------------------------------------------


def test_chunk_assembly_matches_source(tmp_path):
    async def main():
        data = _payload(10_000)
        cache = CloudCache(str(tmp_path / "c"), max_bytes=1 << 20, chunk_size=1024)
        fetches = []

        async def fetch(lo, hi):
            fetches.append((lo, hi))
            return data[lo:hi]

        # unaligned window spanning several chunks
        got = await cache.read("k", 1500, 7321, len(data), fetch)
        assert got == data[1500:7321]
        # one coalesced fetch covering chunks 1..7
        assert fetches == [(1024, 8 * 1024)]
        # fully cached now: no new fetches
        got = await cache.read("k", 2000, 6000, len(data), fetch)
        assert got == data[2000:6000]
        assert len(fetches) == 1
        # tail read clamps to object size
        got = await cache.read("k", 9000, 1 << 30, len(data), fetch)
        assert got == data[9000:]

    asyncio.run(main())


def test_eviction_respects_budget_and_lru(tmp_path):
    async def main():
        data = _payload(8192)
        cache = CloudCache(str(tmp_path / "c"), max_bytes=4096, chunk_size=1024)

        async def fetch(lo, hi):
            return data[lo:hi]

        await cache.read("k", 0, 8192, len(data), fetch)
        assert cache.cached_bytes <= 4096
        assert cache.evictions > 0
        # most-recent chunks survived: reading the tail is all hits
        before = cache.misses
        await cache.read("k", 4096, 8192, len(data), fetch)
        assert cache.misses == before

    asyncio.run(main())


def test_restart_recovery_serves_warm_chunks(tmp_path):
    async def main():
        data = _payload(4096)
        d = str(tmp_path / "c")
        cache = CloudCache(d, max_bytes=1 << 20, chunk_size=1024)

        async def fetch(lo, hi):
            return data[lo:hi]

        await cache.read("k", 0, 4096, len(data), fetch)

        # new instance over the same directory: all hits, no fetches
        cache2 = CloudCache(d, max_bytes=1 << 20, chunk_size=1024)
        assert cache2.cached_bytes == 4096

        async def must_not_fetch(lo, hi):
            raise AssertionError("cold fetch after recovery")

        got = await cache2.read("k", 100, 3900, len(data), must_not_fetch)
        assert got == data[100:3900]

    asyncio.run(main())


def test_invalidate_drops_all_chunks(tmp_path):
    async def main():
        data = _payload(4096)
        cache = CloudCache(str(tmp_path / "c"), max_bytes=1 << 20, chunk_size=1024)

        async def fetch(lo, hi):
            return data[lo:hi]

        await cache.read("k", 0, 4096, len(data), fetch)
        await cache.invalidate("k")
        assert cache.cached_bytes == 0
        assert not [
            n
            for n in os.listdir(str(tmp_path / "c"))
            if not n.endswith(".tmp") and n != "geometry"
        ]

    asyncio.run(main())


# -- store get_range ---------------------------------------------------


def test_store_get_range_variants(tmp_path):
    async def main():
        data = _payload(5000)
        mem = MemoryObjectStore()
        await mem.put("k", data)
        assert await mem.get_range("k", 10, 200) == data[10:200]

        fs = FilesystemObjectStore(str(tmp_path / "b"))
        await fs.put("k", data)
        assert await fs.get_range("k", 4990, 6000) == data[4990:]

        retry = RetryingStore(mem)
        assert await retry.get_range("k", 0, 5) == data[:5]

        class NoRange:
            async def get(self, key):
                return data

        assert await RetryingStore(NoRange()).get_range("k", 3, 9) == data[3:9]

    asyncio.run(main())


def test_s3_ranged_get(tmp_path):
    from s3_imposter import S3Imposter

    from redpanda_tpu_torch.cloud.s3_client import (
        S3ObjectStore,
        StaticCredentialsProvider,
    )

    async def main():
        imp = S3Imposter()
        await imp.start()
        try:
            store = S3ObjectStore(
                "127.0.0.1",
                imp.port,
                "bkt",
                StaticCredentialsProvider("AK", "SK"),
            )
            data = _payload(3000)
            await store.put("seg/a", data)
            assert await store.get_range("seg/a", 100, 900) == data[100:900]
            # range off the end clamps like S3 does
            assert await store.get_range("seg/a", 2500, 4000) == data[2500:]
            await store.close()
        finally:
            await imp.stop()

    asyncio.run(main())


def test_abs_ranged_get(tmp_path):
    from abs_imposter import AbsImposter

    from redpanda_tpu_torch.cloud.abs_client import AbsObjectStore

    async def main():
        imp = AbsImposter()
        await imp.start()
        try:
            store = AbsObjectStore(
                "127.0.0.1", imp.port, imp.account, imp.key_b64, "cont"
            )
            data = _payload(3000)
            await store.put("seg/a", data)
            assert await store.get_range("seg/a", 64, 2048) == data[64:2048]
            await store.close()
        finally:
            await imp.stop()

    asyncio.run(main())


# -- RemoteReader chunked scan ----------------------------------------


def _archived_manifest(n_batches=40, recs=50):
    """Build a synthetic archived segment + manifest."""
    from redpanda_tpu_torch.cloud.manifest import PartitionManifest, SegmentMeta
    from redpanda_tpu_torch.models.record import RecordBatchBuilder

    blob = b""
    base = 0
    for b in range(n_batches):
        rb = RecordBatchBuilder(base_offset=base)
        for r in range(recs):
            rb.add(_payload(100) + bytes(f"{b}:{r}", "ascii"))
        batch = rb.build()
        blob += batch.serialize()
        base += recs
    meta = SegmentMeta(
        base_offset=0,
        last_offset=base - 1,
        size_bytes=len(blob),
        base_timestamp=0,
        max_timestamp=0,
        delta_offset=0,
        term=1,
        delta_offset_end=0,
    )
    manifest = PartitionManifest(
        ns="kafka", topic="t", partition=0, revision=0, segments=[meta]
    )
    return manifest, blob, base


def test_remote_reader_chunked_and_indexed(tmp_path):
    from redpanda_tpu_torch.cloud.remote_partition import RemoteReader

    async def main():
        manifest, blob, last = _archived_manifest()
        store = MemoryObjectStore()
        key = manifest.segment_key(manifest.segments[0])
        await store.put(key, blob)
        cache = CloudCache(
            str(tmp_path / "c"), max_bytes=64 << 20, chunk_size=16 << 10
        )
        rr = RemoteReader(store, cache=cache)

        got = await rr.read_kafka(manifest, 0, max_bytes=1 << 30)
        flat = [
            kbase + i
            for kbase, batch in got
            for i in range(batch.header.last_offset_delta + 1)
        ]
        assert flat == list(range(last))

        # a mid-segment read on a WARM index starts near the target:
        # it must not re-touch chunk 0
        cache2 = CloudCache(
            str(tmp_path / "c2"), max_bytes=64 << 20, chunk_size=16 << 10
        )
        rr._mem.clear()
        rr.cache = cache2
        target = last - 60
        got = await rr.read_kafka(manifest, target, max_bytes=1 << 30)
        assert got, "tail read returned nothing"
        assert got[0][0] <= target <= got[0][0] + got[0][1].header.last_offset_delta
        total_chunks = -(-len(blob) // (16 << 10))
        assert cache2.misses < total_chunks * 3 // 4, (
            f"indexed tail read hydrated {cache2.misses} of "
            f"{total_chunks} chunks — index seek did not skip the prefix"
        )

    asyncio.run(main())


def test_remote_reader_cold_tail_read_correct(tmp_path):
    """No index yet: a tail read still returns the right batches."""
    from redpanda_tpu_torch.cloud.remote_partition import RemoteReader

    async def main():
        manifest, blob, last = _archived_manifest(n_batches=10)
        store = MemoryObjectStore()
        await store.put(manifest.segment_key(manifest.segments[0]), blob)
        rr = RemoteReader(
            store,
            cache=CloudCache(str(tmp_path / "c"), chunk_size=8 << 10),
        )
        target = last - 5
        got = await rr.read_kafka(manifest, target, max_bytes=1 << 30)
        offs = [
            kbase + i
            for kbase, batch in got
            for i in range(batch.header.last_offset_delta + 1)
        ]
        assert offs and offs[-1] == last - 1
        assert min(offs) <= target

    asyncio.run(main())

def test_geometry_change_wipes_cache(tmp_path):
    async def main():
        data = _payload(4096)
        d = str(tmp_path / "c")
        cache = CloudCache(d, max_bytes=1 << 20, chunk_size=1024)

        async def fetch(lo, hi):
            return data[lo:hi]

        await cache.read("k", 0, 4096, len(data), fetch)
        # restart with DIFFERENT chunk size: old files must not be
        # reinterpreted at the new geometry
        cache2 = CloudCache(d, max_bytes=1 << 20, chunk_size=512)
        assert cache2.cached_bytes == 0
        got = await cache2.read("k", 100, 3000, len(data), fetch)
        assert got == data[100:3000]
        # same-geometry restart still recovers
        cache3 = CloudCache(d, max_bytes=1 << 20, chunk_size=512)
        assert cache3.cached_bytes > 0

    asyncio.run(main())


def test_concurrent_same_chunk_single_fetch(tmp_path):
    async def main():
        data = _payload(64 << 10)
        cache = CloudCache(
            str(tmp_path / "c"), max_bytes=1 << 20, chunk_size=4096
        )
        fetches = []

        async def fetch(lo, hi):
            fetches.append((lo, hi))
            await asyncio.sleep(0.02)  # widen the race window
            return data[lo:hi]

        outs = await asyncio.gather(
            *(cache.read("k", 0, 64 << 10, len(data), fetch) for _ in range(4))
        )
        assert all(o == data for o in outs)
        assert len(fetches) == 1, f"duplicate in-flight fetches: {fetches}"

    asyncio.run(main())


def test_truncated_object_degrades_typed(tmp_path):
    """Object shorter than manifest size_bytes with nothing readable:
    a typed CloudUnavailableError (retriable at the Kafka layer), not
    a hang and not a silent empty success."""
    from redpanda_tpu_torch.cloud.object_store import CloudUnavailableError
    from redpanda_tpu_torch.cloud.remote_partition import RemoteReader

    async def main():
        manifest, blob, last = _archived_manifest(n_batches=10)
        store = MemoryObjectStore()
        key = manifest.segment_key(manifest.segments[0])
        await store.put(key, blob[: len(blob) // 2])  # truncated upload
        rr = RemoteReader(
            store,
            cache=CloudCache(str(tmp_path / "c"), chunk_size=8 << 10),
        )
        with pytest.raises(CloudUnavailableError):
            await rr.read_kafka(manifest, 0, max_bytes=1 << 30)

    asyncio.run(main())


def test_recovery_trims_to_shrunk_budget(tmp_path):
    async def main():
        data = _payload(8192)
        d = str(tmp_path / "c")
        cache = CloudCache(d, max_bytes=1 << 20, chunk_size=1024)

        async def fetch(lo, hi):
            return data[lo:hi]

        await cache.read("k", 0, 8192, len(data), fetch)
        # operator shrinks the budget, broker restarts
        cache2 = CloudCache(d, max_bytes=2048, chunk_size=1024)
        assert cache2.cached_bytes <= 2048
        assert cache2.evictions > 0

    asyncio.run(main())
