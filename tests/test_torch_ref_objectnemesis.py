"""tests/test_objectnemesis.py run on the port: all 14 cases, with
imports pointed at redpanda_tpu_torch. `_archived_manifest` comes from
`test_torch_ref_cloud_cache`. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.

ObjectNemesis: the seeded object-store fault layer and the
hardened consumers above it.

Layer contract under test: rules match (op, key-glob) and fire
deterministically from (seed, op sequence); the dual-RNG split keeps
the firing trace byte-replayable while effect parameters draw from a
separate stream. Consumer contracts: RetryingStore bounds hangs and
honors throttle retry-after; CloudCache bounds hydrations and drops
poisoned chunks; RemoteReader degrades to a typed CloudUnavailable
instead of hanging or silently serving nothing.
"""

import asyncio
import os
import time

import pytest

from redpanda_tpu_torch.cloud.cache_service import CloudCache
from redpanda_tpu_torch.cloud.nemesis import (
    NemesisObjectStore,
    StoreFaultSchedule,
    StoreRule,
    replay_trace,
)
from redpanda_tpu_torch.cloud.object_store import (
    CloudUnavailableError,
    MemoryObjectStore,
    RetryingStore,
    StoreError,
    StoreThrottled,
)

from test_torch_ref_cloud_cache import _archived_manifest
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def _nem(rules, seed=7):
    return NemesisObjectStore(
        MemoryObjectStore(), StoreFaultSchedule(rules=rules, seed=seed)
    )


# -- rule matching ----------------------------------------------------
def test_rule_glob_nth_count():
    async def main():
        nem = _nem(
            [
                StoreRule(
                    op="put",
                    key_glob="*manifest.bin",
                    action="error",
                    nth=2,
                    count=1,
                )
            ]
        )
        # segment keys never match the glob
        await nem.put("a/0-1.seg", b"x")
        # 1st matching manifest put: nth=2 skips it
        await nem.put("a/manifest.bin", b"m1")
        # 2nd fires ...
        with pytest.raises(StoreError):
            await nem.put("a/manifest.bin", b"m2")
        # ... and count=1 exhausts the rule
        await nem.put("a/manifest.bin", b"m3")
        assert nem.schedule.injected == {"error": 1}
        assert await nem.get("a/manifest.bin") == b"m3"

    asyncio.run(main())


def test_wildcard_op_matches_everything():
    async def main():
        nem = _nem([StoreRule(op="*", action="error", count=2)])
        with pytest.raises(StoreError):
            await nem.put("k", b"v")
        with pytest.raises(StoreError):
            await nem.exists("k")
        assert not await nem.exists("k")

    asyncio.run(main())


# -- actions ----------------------------------------------------------
def test_throttle_carries_retry_after():
    async def main():
        nem = _nem(
            [StoreRule(op="get", action="throttle", delay_s=0.25, count=1)]
        )
        await nem.put("k", b"v")
        with pytest.raises(StoreThrottled) as ei:
            await nem.get("k")
        assert ei.value.retry_after_s == 0.25
        assert await nem.get("k") == b"v"

    asyncio.run(main())


def test_slow_link_caps_bandwidth():
    async def main():
        data = bytes(4096)
        nem = _nem(
            [
                StoreRule(
                    op="get",
                    action="slow",
                    delay_s=0.0,
                    bandwidth_bps=64 * 1024,
                )
            ]
        )
        await nem.put("k", data)
        t0 = time.monotonic()
        assert await nem.get("k") == data
        # 4096 B over a 64 KiB/s link >= 62.5 ms
        assert time.monotonic() - t0 >= 0.05

    asyncio.run(main())


def test_partial_upload_persists_truncated_prefix():
    async def main():
        inner = MemoryObjectStore()
        nem = NemesisObjectStore(
            inner,
            StoreFaultSchedule(
                rules=[StoreRule(op="put", action="partial", count=1)], seed=3
            ),
        )
        data = bytes(range(256)) * 8
        with pytest.raises(StoreError, match="partial upload"):
            await nem.put("k", data)
        # a truncated PREFIX was persisted — the dangerous half-object
        stored = inner._data["k"]
        assert 0 < len(stored) < len(data)
        assert data.startswith(stored)
        # the retry overwrites it whole
        await nem.put("k", data)
        assert inner._data["k"] == data

    asyncio.run(main())


def test_hang_is_bounded_only_by_caller():
    async def main():
        nem = _nem([StoreRule(op="get", action="hang", hang_s=30.0, count=1)])
        await nem.put("k", b"v")
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(nem.get("k"), timeout=0.05)
        assert await nem.get("k") == b"v"

    asyncio.run(main())


# -- determinism ------------------------------------------------------
def test_trace_replays_byte_equal():
    from dataclasses import replace

    async def main():
        rules = [
            StoreRule(op="put", action="partial", prob=0.4, count=3),
            StoreRule(op="get", action="error", prob=0.3),
            StoreRule(op="*", key_glob="*manifest*", action="throttle", prob=0.5),
        ]
        nem = _nem([replace(r) for r in rules], seed=42)
        for i in range(60):
            key = f"p/{i % 5}-{i}.seg" if i % 3 else "p/manifest.bin"
            try:
                if i % 2:
                    await nem.put(key, bytes(64 + i))
                else:
                    await nem.get(key)
            except StoreError:
                pass
        sched = nem.schedule
        assert sched.trace, "schedule never fired"
        # byte-equal replay from (seed, op sequence) with fresh rules
        replayed = replay_trace(rules, 42, sched.ops)
        assert replayed == sched.trace
        # different seed diverges (the trace is seed-dependent)
        assert replay_trace(rules, 43, sched.ops) != sched.trace

    asyncio.run(main())


# -- RetryingStore hardening ------------------------------------------
def test_retrying_store_honors_throttle():
    async def main():
        nem = _nem(
            [StoreRule(op="get", action="throttle", delay_s=0.05, count=2)]
        )
        store = RetryingStore(nem, attempts=4, base_backoff_s=0.001)
        await store.put("k", b"v")
        t0 = time.monotonic()
        assert await store.get("k") == b"v"
        # two throttles, each honoring a 50ms retry-after
        assert time.monotonic() - t0 >= 0.1

    asyncio.run(main())


def test_retrying_store_attempt_timeout_bounds_hang():
    async def main():
        nem = _nem([StoreRule(op="get", action="hang", count=1)])
        store = RetryingStore(
            nem, attempts=3, base_backoff_s=0.001, attempt_timeout_s=0.05
        )
        await store.put("k", b"v")
        t0 = time.monotonic()
        # the hang burns ONE bounded attempt, the retry serves
        assert await store.get("k") == b"v"
        assert time.monotonic() - t0 < 5.0

    asyncio.run(main())


def test_retrying_store_op_deadline():
    async def main():
        nem = _nem([StoreRule(op="get", action="error")])
        store = RetryingStore(
            nem, attempts=1 << 30, base_backoff_s=0.02, op_deadline_s=0.2
        )
        await store.put("k", b"v")
        t0 = time.monotonic()
        with pytest.raises(StoreError):
            await store.get("k")
        # unbounded attempts, but the per-op deadline caps the loop
        assert time.monotonic() - t0 < 5.0

    asyncio.run(main())


# -- CloudCache hardening ---------------------------------------------
def test_hydration_timeout_surfaces_store_error(tmp_path):
    async def main():
        cache = CloudCache(
            str(tmp_path / "c"), chunk_size=1024, hydrate_timeout_s=0.05
        )

        async def wedged(lo, hi):
            await asyncio.sleep(60)

        t0 = time.monotonic()
        with pytest.raises(StoreError, match="timed out"):
            await cache.read("k", 0, 4096, 4096, wedged)
        assert time.monotonic() - t0 < 5.0

    asyncio.run(main())


def test_invalidate_range_drops_covering_chunks(tmp_path):
    async def main():
        data = bytes(range(256)) * 16  # 4 KiB
        cache = CloudCache(str(tmp_path / "c"), chunk_size=1024)

        async def fetch(lo, hi):
            return data[lo:hi]

        await cache.read("k", 0, 4096, 4096, fetch)
        chunks_before = len(cache._index)
        await cache.invalidate_range("k", 1500, 2500)  # chunks 1..2
        assert len(cache._index) == chunks_before - 2
        # dropped chunks re-hydrate; the rest stay warm
        before = cache.misses
        assert await cache.read("k", 0, 4096, 4096, fetch) == data
        assert cache.misses == before + 2

    asyncio.run(main())


# -- RemoteReader degradation -----------------------------------------
def test_poisoned_chunk_invalidated_and_healed(tmp_path):
    from redpanda_tpu_torch.cloud.remote_partition import RemoteReader

    async def main():
        manifest, blob, last = _archived_manifest(n_batches=6)
        store = MemoryObjectStore()
        key = manifest.segment_key(manifest.segments[0])
        await store.put(key, blob)
        cache = CloudCache(str(tmp_path / "c"), chunk_size=4 << 10)
        rr = RemoteReader(store, cache=cache)
        got = await rr.read_kafka(manifest, 0, max_bytes=1 << 30)
        assert sum(b.header.last_offset_delta + 1 for _k, b in got) == last

        # poison one cached chunk on disk (bit flip mid-batch)
        kh = cache._hash(key)
        path = cache._path(kh, 0)
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(path, "wb").write(bytes(raw))

        degradations = []
        rr.on_degraded = degradations.append
        with pytest.raises(CloudUnavailableError, match="CRC mismatch"):
            await rr.read_kafka(manifest, 0, max_bytes=1 << 30)
        assert "crc_mismatch" in degradations
        # the poisoned chunks were dropped: the retry re-hydrates from
        # the (intact) store and heals
        got = await rr.read_kafka(manifest, 0, max_bytes=1 << 30)
        assert sum(b.header.last_offset_delta + 1 for _k, b in got) == last

    asyncio.run(main())


def test_wedged_store_degrades_not_hangs(tmp_path):
    from redpanda_tpu_torch.cloud.remote_partition import RemoteReader

    async def main():
        manifest, blob, last = _archived_manifest(n_batches=4)
        inner = MemoryObjectStore()
        key = manifest.segment_key(manifest.segments[0])
        await inner.put(key, blob)
        nem = NemesisObjectStore(
            inner,
            StoreFaultSchedule(
                rules=[StoreRule(op="get_range", action="hang")], seed=5
            ),
        )
        rr = RemoteReader(
            RetryingStore(
                nem, attempts=2, base_backoff_s=0.001, attempt_timeout_s=0.05
            ),
            cache=CloudCache(
                str(tmp_path / "c"), chunk_size=4 << 10, hydrate_timeout_s=0.2
            ),
        )
        t0 = time.monotonic()
        with pytest.raises(CloudUnavailableError):
            await rr.read_kafka(manifest, 0, max_bytes=1 << 30)
        # bounded: attempts x attempt_timeout, not the hang duration
        assert time.monotonic() - t0 < 10.0

    asyncio.run(main())
