"""tests/test_fetch_session.py run on the port: all 9 cases, with
imports pointed at redpanda_tpu_torch. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu" (the
kernels' plain versions). Nothing is left out.

Unit coverage for kafka/fetch_session.py (KIP-227 cache).

The e2e flow lives in tests/test_fetch_sessions_quotas.py; this file
pins the cache's own contracts — epoch bump/stale rejection, LRU
eviction order under the memory cap, per-session memory accounting,
and the changed-partitions-only filter — at the unit level, where a
regression points at the exact method instead of a wire trace.
"""

import asyncio

import pytest

from redpanda_tpu_torch.kafka.fetch_session import (
    FetchSession,
    FetchSessionCache,
    _SESSION_COST,
    _part_cost,
)
from redpanda_tpu_torch.kafka.protocol import ErrorCode, Msg
from redpanda_tpu_torch.kafka.server import KafkaServer
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _topics(name, *pids, offset=0):
    return [
        Msg(
            topic=name,
            partitions=[
                Msg(partition=p, fetch_offset=offset, partition_max_bytes=1 << 20)
                for p in pids
            ],
        )
    ]


# -- epoch semantics ---------------------------------------------------


def test_use_bumps_epoch_and_rejects_stale():
    async def main():
        cache = FetchSessionCache()
        s = cache.create()
        assert s is not None and s.epoch == 1
        got, err = cache.use(s.id, 1)
        assert got is s and err == 0 and s.epoch == 2
        # replaying the consumed epoch is stale
        got, err = cache.use(s.id, 1)
        assert got is None
        assert err == int(ErrorCode.invalid_fetch_session_epoch)
        # so is racing ahead
        got, err = cache.use(s.id, 99)
        assert got is None
        assert err == int(ErrorCode.invalid_fetch_session_epoch)
        # the current epoch still works after the failed attempts
        got, err = cache.use(s.id, 2)
        assert got is s and err == 0 and s.epoch == 3

    _run(main())


def test_unknown_session_id():
    async def main():
        cache = FetchSessionCache()
        got, err = cache.use(123456, 1)
        assert got is None
        assert err == int(ErrorCode.fetch_session_id_not_found)

    _run(main())


def test_remove_then_use():
    async def main():
        cache = FetchSessionCache()
        s = cache.create()
        cache.remove(s.id)
        assert len(cache) == 0
        got, err = cache.use(s.id, 1)
        assert got is None
        assert err == int(ErrorCode.fetch_session_id_not_found)

    _run(main())


# -- slot pressure: decline, never evict live sessions ----------------


def test_full_cache_declines():
    async def main():
        cache = FetchSessionCache(max_sessions=3)
        live = [cache.create() for _ in range(3)]
        assert all(s is not None for s in live)
        assert cache.create() is None  # all three are fresh: decline
        assert len(cache) == 3  # and nobody was evicted for the ask

    _run(main())


# -- memory accounting + LRU eviction order ---------------------------


def test_mem_accounting_tracks_partitions():
    async def main():
        cache = FetchSessionCache()
        s = cache.create()
        base = cache.mem_bytes()
        assert base == _SESSION_COST
        s.apply_request(_topics("logs", 0, 1, 2), None)
        assert s.mem_bytes == _SESSION_COST + 3 * _part_cost("logs")
        assert cache.mem_bytes() == s.mem_bytes
        # upsert of an existing partition is free
        s.apply_request(_topics("logs", 1, offset=500), None)
        assert cache.mem_bytes() == s.mem_bytes
        # forgotten partitions give their bytes back
        s.apply_request(None, [Msg(topic="logs", partitions=[0, 2])])
        assert s.mem_bytes == _SESSION_COST + _part_cost("logs")
        assert cache.mem_bytes() == s.mem_bytes
        cache.remove(s.id)
        assert cache.mem_bytes() == 0

    _run(main())


def test_mem_pressure_evicts_lru_first():
    async def main():
        # one byte under two full sessions: the third create's
        # pre-insert sweep must reclaim exactly the LRU front
        cap = 2 * (_SESSION_COST + _part_cost("t")) - 1
        cache = FetchSessionCache(max_sessions=100, max_mem_bytes=cap)
        a = cache.create()
        b = cache.create()
        a.apply_request(_topics("t", 0), None)
        b.apply_request(_topics("t", 0), None)
        # touch a AFTER b: b becomes least-recently-used
        cache.use(b.id, b.epoch)
        cache.use(a.id, a.epoch)
        c = cache.create()  # pushes over the cap -> b evicted, a kept
        assert c is not None
        assert cache.use(b.id, b.epoch)[0] is None
        got, err = cache.use(a.id, a.epoch)
        assert got is a and err == 0
        assert cache.evicted == 1
        assert cache.mem_bytes() <= cap

    _run(main())


def test_mem_pressure_eviction_is_in_lru_order():
    async def main():
        one = _SESSION_COST + _part_cost("t")
        # cap one byte under four full sessions: every create that
        # grows a fifth must reclaim exactly one from the LRU front
        cache = FetchSessionCache(max_sessions=100, max_mem_bytes=4 * one - 1)
        ss = [cache.create() for _ in range(4)]
        for s in ss:
            s.apply_request(_topics("t", 0), None)
        # refresh order ss[2], ss[0], ss[3], ss[1] -> that IS the
        # expected eviction order (front-to-back of the LRU)
        for i in (2, 0, 3, 1):
            cache.use(ss[i].id, ss[i].epoch)
        expect_gone = []
        for i in (2, 0, 3):
            grew = cache.create()
            assert grew is not None
            grew.apply_request(_topics("t", 0), None)
            expect_gone.append(i)
            # peek membership directly: use() would re-order the LRU
            gone = sorted(
                j for j, s in enumerate(ss) if s.id not in cache._sessions
            )
            assert gone == sorted(expect_gone), (i, gone)

    _run(main())


# -- changed-partitions-only reuse ------------------------------------


def _resp(topic, pid, hw, records=None, error=0):
    return Msg(
        topic=topic,
        partitions=[
            Msg(
                partition_index=pid,
                error_code=error,
                high_watermark=hw,
                last_stable_offset=hw,
                log_start_offset=0,
                records=records,
            )
        ],
    )


def test_incremental_response_keeps_only_news():
    session = FetchSession(7)
    session.apply_request(_topics("t", 0, 1), None)
    # first (non-incremental) answer primes the cached state and keeps
    # every partition
    full = [_resp("t", 0, hw=5), _resp("t", 1, hw=9)]
    out = KafkaServer._finish_session_fetch(session, full, incremental=False)
    assert len(out) == 2
    # steady-state poll with no movement: nothing comes back
    again = [_resp("t", 0, hw=5), _resp("t", 1, hw=9)]
    out = KafkaServer._finish_session_fetch(session, again, incremental=True)
    assert out == []
    # hw moved on partition 1 only -> only partition 1 returns
    moved = [_resp("t", 0, hw=5), _resp("t", 1, hw=12)]
    out = KafkaServer._finish_session_fetch(session, moved, incremental=True)
    assert len(out) == 1
    assert out[0].partitions[0].partition_index == 1
    # records are always news even at an unchanged hw
    data = [_resp("t", 0, hw=5, records=b"xx"), _resp("t", 1, hw=12)]
    out = KafkaServer._finish_session_fetch(session, data, incremental=True)
    assert len(out) == 1
    assert out[0].partitions[0].partition_index == 0
    # so are errors
    err = [_resp("t", 0, hw=5, error=3), _resp("t", 1, hw=12)]
    out = KafkaServer._finish_session_fetch(session, err, incremental=True)
    assert len(out) == 1
    assert out[0].partitions[0].error_code == 3


def test_stale_session_object_cannot_corrupt_cache_accounting():
    async def main():
        cache = FetchSessionCache()
        s = cache.create()
        s.apply_request(_topics("t", 0), None)
        before = cache.mem_bytes()
        assert before > 0
        cache.remove(s.id)
        # an in-flight fetch may still mutate the detached session;
        # the cache's total must not move
        s.apply_request(_topics("t", 1, 2), None)
        assert cache.mem_bytes() == 0

    _run(main())
