"""Incremental fetch sessions (KIP-227).

Reference: src/v/kafka/server/fetch_session_cache.{h,cc} and
fetch_session.h. A session remembers the client's partition set and
the last (high watermark, LSO, log start) each partition was answered
with, so steady-state polls send no partition list and receive only
partitions with news — the dominant traffic saver for consumers over
many partitions.

Concurrency-era bounds: the cache is LRU-ordered (every use() moves
the session to the back) and accounts per-session memory with a flat
cost model, so 100k churned consumers cannot grow the broker
unbounded. Slot pressure still DECLINES new sessions rather than
evicting live ones (fetch_session_cache.cc: eviction would cascade —
every new session kills an active one whose owner recreates it,
killing another), but memory pressure DOES evict from the LRU front:
a bounded broker beats session affinity, and the evicted consumer
re-establishes with epoch 0 on its next poll.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random

from .protocol import ErrorCode

_MAX_SESSIONS = 1000
_EVICT_IDLE_S = 120.0
_MAX_MEM_BYTES = 16 << 20

# flat cost model (fetch_session.h fetch_session_partition mem_usage
# analog): close enough to steer eviction, cheap enough to maintain
# incrementally on every apply_request
_SESSION_COST = 200       # FetchSession + dict slot + id
_PARTITION_COST = 120     # SessionPartition + key tuple + dict slot


def _part_cost(topic: str) -> int:
    return _PARTITION_COST + len(topic)


@dataclasses.dataclass(slots=True)
class SessionPartition:
    fetch_offset: int
    max_bytes: int
    # last values answered to the client (None = never answered):
    # a partition re-enters a response when any of them move
    last_hw: int | None = None
    last_lso: int | None = None
    last_start: int | None = None


class FetchSession:
    def __init__(self, session_id: int, cache: "FetchSessionCache | None" = None):
        self.id = session_id
        self.epoch = 1
        # insertion-ordered (topic, partition) -> SessionPartition
        self.partitions: dict[tuple[str, int], SessionPartition] = {}
        self.last_used = 0.0
        self.mem_bytes = _SESSION_COST
        self._cache = cache

    def _mem_delta(self, delta: int) -> None:
        self.mem_bytes += delta
        if self._cache is not None:
            self._cache._mem += delta

    def apply_request(self, topics, forgotten) -> None:
        """Merge an incremental request: named partitions upsert their
        position; forgotten ones leave the session."""
        for t in topics or []:
            for p in t.partitions:
                cur = self.partitions.get((t.topic, p.partition))
                if cur is not None:
                    # position update: the answered-state cache stays —
                    # wiping it would force the partition back into the
                    # next response with no news
                    cur.fetch_offset = p.fetch_offset
                    cur.max_bytes = p.partition_max_bytes
                else:
                    self.partitions[(t.topic, p.partition)] = SessionPartition(
                        fetch_offset=p.fetch_offset,
                        max_bytes=p.partition_max_bytes,
                    )
                    self._mem_delta(_part_cost(t.topic))
        for f in forgotten or []:
            for pid in f.partitions:
                if self.partitions.pop((f.topic, pid), None) is not None:
                    self._mem_delta(-_part_cost(f.topic))


class FetchSessionCache:
    def __init__(
        self,
        max_sessions: int = _MAX_SESSIONS,
        max_mem_bytes: int = _MAX_MEM_BYTES,
    ):
        # plain dict doubles as the LRU list: iteration order is
        # least-recently-used first because use() reinserts at the back
        self._sessions: dict[int, FetchSession] = {}
        self.max_sessions = max_sessions
        self.max_mem_bytes = max_mem_bytes
        self._mem = 0
        self.evicted = 0  # lifetime LRU/mem evictions (observability)

    def _now(self) -> float:
        return asyncio.get_event_loop().time()

    def mem_bytes(self) -> int:
        """Accounted bytes across all sessions (cost model, not RSS)."""
        return self._mem

    def create(self) -> FetchSession | None:
        """New session, or None when the cache is full of ACTIVE
        sessions — the caller then answers sessionless (session_id 0),
        exactly how fetch_session_cache.cc declines rather than
        evicting a live consumer's session."""
        self._evict_mem()
        if len(self._sessions) >= self.max_sessions:
            self._evict_idle()
            if len(self._sessions) >= self.max_sessions:
                return None
        # randomized ids (Kafka does the same): sequential ids let any
        # client guess and close another client's session
        while True:
            sid = random.randrange(1, 1 << 31)
            if sid not in self._sessions:
                break
        s = FetchSession(sid, cache=self)
        s.last_used = self._now()
        self._sessions[sid] = s
        self._mem += s.mem_bytes
        return s

    def use(
        self, session_id: int, epoch: int
    ) -> tuple[FetchSession | None, int]:
        """Resolve an established session; returns (session, error)."""
        s = self._sessions.get(session_id)
        if s is None:
            return None, int(ErrorCode.fetch_session_id_not_found)
        if epoch != s.epoch:
            return None, int(ErrorCode.invalid_fetch_session_epoch)
        s.epoch += 1
        s.last_used = self._now()
        # move to the LRU back: pop + reinsert is O(1) on a dict
        del self._sessions[session_id]
        self._sessions[session_id] = s
        return s, 0

    def remove(self, session_id: int) -> None:
        s = self._sessions.pop(session_id, None)
        if s is not None:
            self._mem -= s.mem_bytes
            s._cache = None

    def _evict_mem(self) -> None:
        """Memory pressure reclaims from the LRU front until under the
        cap — unlike slot pressure, which declines instead (a session
        ballooning its partition set must not be able to pin unbounded
        broker memory behind a fixed session count)."""
        while self._mem > self.max_mem_bytes and self._sessions:
            sid = next(iter(self._sessions))
            self.remove(sid)
            self.evicted += 1

    def _evict_idle(self) -> None:
        """Drop sessions idle past the threshold — crashed/disconnected
        consumers never send the closing epoch=-1, so idle expiry is
        what actually reclaims their slots."""
        now = self._now()
        for sid in [
            sid
            for sid, s in self._sessions.items()
            if now - s.last_used > _EVICT_IDLE_S
        ]:
            self.remove(sid)

    def __len__(self) -> int:
        return len(self._sessions)
