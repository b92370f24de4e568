"""Idempotent producer dedupe state (the rm_stm seam).

Reference: src/v/cluster/rm_stm.{h,cc} (rm_stm.h:57-190) — per
partition, per producer-id: epoch fencing and the last 5 batch
sequence ranges with their assigned offsets, so a retried produce
returns the original offset instead of appending a duplicate. State
is rebuilt deterministically from the log (every data batch carries
pid/epoch/base_sequence in its header), which is what makes follower
takeover safe; the reference adds snapshots as an optimization.
"""

from __future__ import annotations

import struct
from collections import deque

_CACHED_BATCHES = 5  # kafka's max in-flight per producer


class ProducerFenced(Exception):
    pass


class OutOfOrderSequence(Exception):
    pass


class DuplicateSequence(Exception):
    def __init__(self, base_offset: int):
        super().__init__(f"duplicate, original at {base_offset}")
        self.base_offset = base_offset


class _Producer:
    __slots__ = ("epoch", "last_seq", "batches", "last_ts_ms")

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.last_seq = -1
        # (first_seq, last_seq, kafka_base_offset)
        self.batches: deque[tuple[int, int, int]] = deque(
            maxlen=_CACHED_BATCHES
        )
        # batch max_timestamp of the latest observation: replay-stable
        # (comes from the record, not the wall), drives idle-producer
        # eviction (rm_stm producer expiration)
        self.last_ts_ms = 0


class ProducerStateTable:
    def __init__(self):
        self._pids: dict[int, _Producer] = {}

    def check(
        self,
        pid: int,
        epoch: int,
        first_seq: int,
        last_seq: int,
        inflight_last_seq: int | None = None,
    ) -> None:
        """Validate before append. Raises DuplicateSequence (with the
        original offset) / OutOfOrderSequence / ProducerFenced.

        `inflight_last_seq`: highest sequence already dispatched to the
        replicate batcher but not yet applied to this table — with
        deferred appends the table alone lags dispatch order, and a
        pipelined next-in-sequence batch must not read as a gap
        (rm_stm keeps the same in-flight horizon)."""
        p = self._pids.get(pid)
        expected = -1
        if p is not None:
            if epoch < p.epoch:
                raise ProducerFenced(f"pid {pid} epoch {epoch} < {p.epoch}")
            if epoch > p.epoch:
                return  # new epoch resets sequencing
            for f, l, base in p.batches:
                if f == first_seq and l == last_seq:
                    raise DuplicateSequence(base)
            expected = p.last_seq
        elif inflight_last_seq is None:
            return  # new producer (or state aged out): accept
        if inflight_last_seq is not None:
            expected = max(expected, inflight_last_seq)
        if first_seq == expected + 1:
            return
        if first_seq > expected + 1:
            raise OutOfOrderSequence(
                f"pid {pid}: seq {first_seq} after {expected}"
            )
        raise OutOfOrderSequence(
            f"pid {pid}: stale seq {first_seq} <= {expected} (uncached)"
        )

    def observe(
        self,
        pid: int,
        epoch: int,
        first_seq: int,
        last_seq: int,
        kafka_base: int,
        ts_ms: int = 0,
    ) -> None:
        """Fold an appended batch into the table (log-replay safe:
        called from the log-append observer on leader AND follower)."""
        p = self._pids.get(pid)
        if p is None or epoch > p.epoch:
            p = _Producer(epoch)
            self._pids[pid] = p
        if epoch < p.epoch:
            return  # stale batch from a fenced producer (replay)
        for f, l, _ in p.batches:
            if f == first_seq and l == last_seq:
                return  # already tracked (snapshot restore + re-replay)
        p.batches.append((first_seq, last_seq, kafka_base))
        p.last_seq = max(p.last_seq, last_seq)
        p.last_ts_ms = max(p.last_ts_ms, ts_ms)

    def snapshot(self) -> list[tuple[int, int, int]]:
        """(producer_id, epoch, last_seq) rows for introspection
        (DescribeProducers), sorted by producer id."""
        return [
            (pid, p.epoch, p.last_seq)
            for pid, p in sorted(self._pids.items())
        ]

    def truncate(self) -> None:
        """Raft truncation: rebuild from scratch on next replay — rare
        event, and partial rollback of seq state is not worth the
        bookkeeping (the reference snapshots+rebuilds too)."""
        self._pids.clear()

    # -- snapshot capture/restore (rm_stm.h:182 snapshot analog) ------
    def expire(
        self, now_ms: int, retention_ms: int, active: set[int] | None = None
    ) -> list[int]:
        """Evict producers idle longer than retention (rm_stm
        producer-id expiration): their dedupe window is long past its
        usefulness and the table must not grow with every producer id
        ever seen. Producers in `active` (in-flight dispatches) and
        those with unknown timestamps never expire here."""
        if retention_ms <= 0:
            return []
        evicted = [
            pid
            for pid, p in self._pids.items()
            if p.last_ts_ms > 0
            and now_ms - p.last_ts_ms >= retention_ms
            and (active is None or pid not in active)
        ]
        for pid in evicted:
            del self._pids[pid]
        return evicted

    def encode(self) -> bytes:
        out = bytearray()
        out += struct.pack("<I", len(self._pids))
        for pid, p in self._pids.items():
            out += struct.pack("<qiqI", pid, p.epoch, p.last_seq, len(p.batches))
            for f, l, base in p.batches:
                out += struct.pack("<qqq", f, l, base)
        # appended timestamp trailer: decoders that predate it ignore
        # trailing bytes; new decoders treat its absence as unknown
        out += struct.pack("<I", len(self._pids))
        for pid, p in self._pids.items():
            out += struct.pack("<qq", pid, p.last_ts_ms)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "ProducerStateTable":
        t = cls()
        pos = 0
        (n,) = struct.unpack_from("<I", data, pos)
        pos += 4
        for _ in range(n):
            pid, epoch, last_seq, nb = struct.unpack_from("<qiqI", data, pos)
            pos += struct.calcsize("<qiqI")
            p = _Producer(epoch)
            p.last_seq = last_seq
            for _ in range(nb):
                f, l, base = struct.unpack_from("<qqq", data, pos)
                pos += 24
                p.batches.append((f, l, base))
            t._pids[pid] = p
        if pos < len(data):  # timestamp trailer (absent in old blobs)
            (nt,) = struct.unpack_from("<I", data, pos)
            pos += 4
            for _ in range(nt):
                pid, ts = struct.unpack_from("<qq", data, pos)
                pos += 16
                if pid in t._pids:
                    t._pids[pid].last_ts_ms = ts
        return t
