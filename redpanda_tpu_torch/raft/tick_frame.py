"""Per-shard tick frame: the live replication plane's batching seam.

The reference handles every append reply with per-group scalar work
(consensus.cc:274 update_follower_index → maybe_update_leader_commit
_idx); our per-reply analog was `scalar_commit_update` — a Python
quorum fold per reply, the dominant interpreter cost of the live
produce path at high partition counts. The tick frame
turns that per-reply math into an O(1) enqueue: reply ingestion sites
(consensus.process_append_reply, replicate_batcher._flush_round) push
into pending-reply COLUMNS here, and one loop-soon flush folds the
whole window through `ShardGroupArrays.frame_tick` — a single
vectorized call covering fold + quorum-commit advance (+ heartbeat
payload gather on the device backend) — then fires the registered
commit-advance callbacks for the rows that moved.

Division of labor (the documented punt): per-reply CELL bookkeeping
(match/flushed/last_seq writes behind the seq guard) stays inline at
the ingestion site, because the catch-up fiber's progress detection
reads those lanes synchronously between awaits
(consensus._catch_up_locked's before/after compare). Only the
quorum/commit MATH — the part that is O(replica_slots · log) per
reply in Python — is deferred into the frame. Pre-applied rows reach
the sweep via `force_rows`, since the incremental movement detection
cannot see lanes that were already written.

Everything per-group that remains after the frame (config changes,
term bumps, follower errors) is residue handled by consensus.py —
rplint RPL011 enforces that no per-group Python loop over the
registered-group set creeps back into tick-frame code paths.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

_EMPTY = np.empty(0, np.int64)


class TickFrame:
    """Pending-reply columns + per-row commit-advance callbacks for
    one shard's GroupManager. Single event loop, no locks."""

    def __init__(self, arrays, probe=None):
        self.arrays = arrays
        self.probe = probe
        self._cbs: dict[int, object] = {}
        # group-keyed callbacks + the placement table: when a table is
        # attached, changed-row resolution goes (chip, row) → group
        # through it (the mesh's chip coordinate is derived from the
        # row's block; a live lane move rebinds both), falling back to
        # the row-keyed map for rows the table doesn't cover
        self._gcbs: dict[int, object] = {}
        self._table = None
        self._table_shard = 0
        cap = 64
        self._cap = cap
        self._n = 0
        self._rows = np.zeros(cap, np.int64)
        self._slots = np.zeros(cap, np.int64)
        self._dirty = np.zeros(cap, np.int64)
        self._flushed = np.zeros(cap, np.int64)
        self._seqs = np.zeros(cap, np.int64)
        # rows needing a quorum recompute at the next flush: enqueued
        # replies (lanes pre-applied inline) and local SELF-slot moves
        self._force: set[int] = set()
        self._scheduled = False
        self._closed = False
        # observability counters (per-shard gauges sample these)
        self.flushes = 0
        self.replies_folded = 0
        self.max_batch = 0

    # -- registration (control plane) ---------------------------------
    def register(self, row: int, on_advance, group_id: int | None = None) -> None:
        """Route commit advances for `row` to `on_advance` (the
        group's waiter-resolution residue). With `group_id` the
        callback is also group-keyed, so table-mediated (chip, row) →
        group resolution survives a lane rebind."""
        self._cbs[int(row)] = on_advance
        if group_id is not None:
            self._gcbs[int(group_id)] = on_advance

    def deregister(self, row: int, group_id: int | None = None) -> None:
        self._cbs.pop(int(row), None)
        if group_id is not None:
            self._gcbs.pop(int(group_id), None)
        self._force.discard(int(row))

    def attach_table(self, table, shard: int = 0) -> None:
        """Wire the placement table in: advanced-row residue resolves
        (chip, row) → group through it from now on. `shard` is this
        frame's shard id — rows are per-shard, so the reverse lookup
        keys on it."""
        self._table = table
        self._table_shard = int(shard)

    @property
    def pending(self) -> int:
        return self._n + len(self._force)

    def health_totals(self) -> dict:
        """Aggregate partition-health view over this shard's lanes.
        The per-frame sweep (host) / fused frame program (device) keeps
        the lanes warm for every row the window touched; refresh first
        so rows that moved OUTSIDE a frame (leadership changes, frozen
        followers with no reply traffic) are also current."""
        self.arrays.health_refresh()
        return self.arrays.health_totals()

    # -- ingestion (hot path, O(1) each) ------------------------------
    def enqueue_reply(
        self, row: int, slot: int, dirty: int, flushed: int, seq: int
    ) -> None:
        """One append reply. The caller has already folded the cell
        updates behind the seq guard; the pair still rides the columns
        so the device-backend fold sees the same inputs, and the row
        joins the force set for the quorum recompute."""
        i = self._n
        if i == self._cap:
            self._grow()
        self._rows[i] = row
        self._slots[i] = slot
        self._dirty[i] = dirty
        self._flushed[i] = flushed
        self._seqs[i] = seq
        self._n = i + 1
        self._force.add(int(row))
        if not self._scheduled:
            self._schedule()

    def note_self(self, row: int) -> None:
        """Local append/fsync moved the SELF slot (the flush-clamp
        release); recompute the row's quorum at the next flush."""
        self._force.add(int(row))
        if not self._scheduled:
            self._schedule()

    # -- the frame ----------------------------------------------------
    def flush(self) -> np.ndarray:
        """Drain the window: one vectorized frame over every pending
        reply and forced row. Returns rows whose commit advanced
        (callbacks already fired)."""
        return self.fold_now(_EMPTY, _EMPTY, _EMPTY, _EMPTY, _EMPTY)

    def fold_now(
        self,
        rows: np.ndarray,
        slots: np.ndarray,
        dirty: np.ndarray,
        flushed: np.ndarray,
        seqs: np.ndarray,
    ) -> np.ndarray:
        """Heartbeat-tick entry: merge the tick's accumulated reply
        vectors with the pending columns and run the frame now —
        the heartbeat fold and the replicate-path window share one
        device call instead of two."""
        n = self._n
        if n == 0 and not self._force and not len(rows):
            return _EMPTY
        t0 = time.monotonic()
        if n:
            pr = self._rows[:n]
            ps = self._slots[:n]
            pd = self._dirty[:n]
            pf = self._flushed[:n]
            pq = self._seqs[:n]
            if len(rows):
                rows = np.concatenate([rows, pr])
                slots = np.concatenate([slots, ps])
                dirty = np.concatenate([dirty, pd])
                flushed = np.concatenate([flushed, pf])
                seqs = np.concatenate([seqs, pq])
            else:
                rows, slots, dirty, flushed, seqs = (
                    pr.copy(), ps.copy(), pd.copy(), pf.copy(), pq.copy()
                )
        if len(rows):
            # a row can be freed (and even reallocated) between enqueue
            # and flush: mask non-leader rows so a stale pair never
            # pollutes a recycled row's lanes — same still_leader mask
            # the heartbeat fold applies to its reply batch
            alive = self.arrays.is_leader[rows]
            if not alive.all():
                rows = rows[alive]
                slots = slots[alive]
                dirty = dirty[alive]
                flushed = flushed[alive]
                seqs = seqs[alive]
        force = (
            np.fromiter(self._force, np.int64, len(self._force))
            if self._force
            else None
        )
        self._n = 0
        self._force.clear()
        self.flushes += 1
        self.replies_folded += len(rows)
        if len(rows) > self.max_batch:
            self.max_batch = len(rows)
        advanced, _ = self.arrays.frame_tick(
            rows, slots, dirty, flushed, seqs, force_rows=force
        )
        probe = self.probe
        if probe is not None:
            probe.observe_stage_frame(time.monotonic() - t0)
            probe.tick_frame_flushes.inc()
            if len(rows):
                probe.tick_frame_replies.inc(float(len(rows)))
        cbs = self._cbs
        # residue loop: ADVANCED rows only (bounded by this window's
        # quorum movements), never a sweep over registered groups
        table = self._table
        if table is not None and len(advanced):
            # (chip, row) → group through the placement table: the
            # chip is derived from the row's block, and group_at
            # confirms the row still belongs to the group that bound
            # it (a live lane move rebinds both atomically under the
            # frame's single-threaded event loop)
            chips = self.arrays.chip_of_rows(advanced)
            gcbs = self._gcbs
            shard = self._table_shard
            for c, r in zip(chips, advanced):
                gid = table.group_at(int(c), int(r), shard)
                cb = gcbs.get(gid) if gid is not None else None
                if cb is None:
                    cb = cbs.get(int(r))
                if cb is not None:
                    cb()
            return advanced
        for r in advanced:
            cb = cbs.get(int(r))
            if cb is not None:
                cb()
        return advanced

    # -- plumbing -----------------------------------------------------
    def _grow(self) -> None:
        new = self._cap * 2
        for name in ("_rows", "_slots", "_dirty", "_flushed", "_seqs"):
            arr = getattr(self, name)
            grown = np.zeros(new, np.int64)
            grown[: self._cap] = arr
            setattr(self, name, grown)
        self._cap = new

    def _schedule(self) -> None:
        if self._closed:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # no running loop (synchronous tests / teardown): the next
            # explicit flush()/fold_now() drains the window instead
            return
        self._scheduled = True
        loop.call_soon(self._run_scheduled)

    def _run_scheduled(self) -> None:
        self._scheduled = False
        if not self._closed:
            try:
                self.flush()
            except Exception:  # pragma: no cover - defensive
                import logging

                logging.getLogger(__name__).exception("tick frame flush")

    def close(self) -> None:
        self._closed = True
        self._cbs.clear()
        self._force.clear()
        self._n = 0
