"""Partition-side transaction state (the tx half of rm_stm).

Reference: src/v/cluster/rm_stm.{h,cc} (rm_stm.h:57-190) — per
partition the leader tracks, for every transactional producer-id:

* the OPEN transaction's first offset (bounds the last stable offset:
  a READ_COMMITTED consumer must not see past the earliest open tx);
* ABORTED ranges [first, marker] so fetch responses can report them
  (Kafka `AbortedTransaction(producer_id, first_offset)` entries — the
  consumer drops aborted batches client-side using the control
  markers that terminate each range);
* an epoch FENCE so a zombie producer from an older epoch cannot
  append after its successor took over (rm_stm fence batches).

Everything is rebuilt deterministically from the log: transactional
data batches open a tx, control batches (commit/abort markers written
by the tx coordinator through the gateway) close it. Snapshots carry
the encoded state so a follower restored via install_snapshot does not
need the discarded prefix.

Control markers use the Kafka wire control-record key format
(version:i16, type:i16; 0=abort 1=commit) so external consumers can
interpret fetched marker batches.
"""

from __future__ import annotations

import struct

CONTROL_KEY = struct.Struct(">hh")
ABORT_MARKER = 0
COMMIT_MARKER = 1


def control_record_key(commit: bool) -> bytes:
    return CONTROL_KEY.pack(0, COMMIT_MARKER if commit else ABORT_MARKER)


def parse_control_key(key: bytes) -> int | None:
    """Marker type, or None if not a recognised control key."""
    if key is None or len(key) < CONTROL_KEY.size:
        return None
    version, kind = CONTROL_KEY.unpack_from(key)
    if version != 0:
        return None
    return kind


class TxTracker:
    """Open-transaction + aborted-range + fence bookkeeping for one
    partition. All offsets are *kafka* offsets except where named."""

    def __init__(self) -> None:
        # pid -> (epoch, first_kafka_offset)
        self.open: dict[int, tuple[int, int]] = {}
        # closed aborted ranges: (pid, first_kafka, marker_kafka)
        self.aborted: list[tuple[int, int, int]] = []
        # pid -> highest epoch ever observed (fence)
        self.fences: dict[int, int] = {}

    # -- log observation (leader append, follower append, replay) ----
    def observe_data(self, pid: int, epoch: int, first_kafka: int) -> None:
        if epoch > self.fences.get(pid, -1):
            self.fences[pid] = epoch
        cur = self.open.get(pid)
        if cur is None or epoch > cur[0]:
            # a higher-epoch tx after an unclosed lower-epoch one can
            # only appear if the older one was already resolved (its
            # marker is later in the log during replay ordering quirks
            # are impossible — markers precede the epoch bump); track
            # the newest
            self.open[pid] = (epoch, first_kafka)

    def observe_marker(
        self, pid: int, epoch: int, commit: bool, marker_kafka: int
    ) -> None:
        if epoch > self.fences.get(pid, -1):
            self.fences[pid] = epoch
        cur = self.open.get(pid)
        if cur is None or cur[0] > epoch:
            return  # stale duplicate marker
        del self.open[pid]
        if not commit:
            self.aborted.append((pid, cur[1], marker_kafka))

    # -- queries ------------------------------------------------------
    def fence_epoch(self, pid: int) -> int:
        return self.fences.get(pid, -1)

    def first_open_offset(self) -> int | None:
        if not self.open:
            return None
        return min(first for _e, first in self.open.values())

    def has_open(self, pid: int, epoch: int) -> bool:
        """An open tx a marker at `epoch` would close: same epoch, or a
        lower one (a bumped-epoch abort fencing the old incarnation)."""
        cur = self.open.get(pid)
        return cur is not None and cur[0] <= epoch

    def aborted_in(self, start: int, end: int) -> list[tuple[int, int]]:
        """(pid, first_offset) of aborted ranges overlapping
        [start, end): the entries a fetch response must report."""
        return [
            (pid, first)
            for pid, first, marker in self.aborted
            if marker >= start and first < end
        ]

    # -- retention ----------------------------------------------------
    def prune(self, log_start_kafka: int) -> None:
        """Drop aborted ranges wholly below the log start — no fetch
        can begin before it, so they can never be reported again."""
        self.aborted = [
            r for r in self.aborted if r[2] >= log_start_kafka
        ]

    def clear(self) -> None:
        self.open.clear()
        self.aborted.clear()
        self.fences.clear()

    # -- snapshot -----------------------------------------------------
    def encode(self) -> bytes:
        out = bytearray()
        out += struct.pack("<I", len(self.open))
        for pid, (epoch, first) in self.open.items():
            out += struct.pack("<qhq", pid, epoch, first)
        out += struct.pack("<I", len(self.aborted))
        for pid, first, marker in self.aborted:
            out += struct.pack("<qqq", pid, first, marker)
        out += struct.pack("<I", len(self.fences))
        for pid, epoch in self.fences.items():
            out += struct.pack("<qh", pid, epoch)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "TxTracker":
        t = cls()
        pos = 0
        (n,) = struct.unpack_from("<I", data, pos)
        pos += 4
        for _ in range(n):
            pid, epoch, first = struct.unpack_from("<qhq", data, pos)
            pos += struct.calcsize("<qhq")
            t.open[pid] = (epoch, first)
        (n,) = struct.unpack_from("<I", data, pos)
        pos += 4
        for _ in range(n):
            pid, first, marker = struct.unpack_from("<qqq", data, pos)
            pos += 24
            t.aborted.append((pid, first, marker))
        (n,) = struct.unpack_from("<I", data, pos)
        pos += 4
        for _ in range(n):
            pid, epoch = struct.unpack_from("<qh", data, pos)
            pos += struct.calcsize("<qh")
            t.fences[pid] = epoch
        return t
