"""Batched heartbeat manager — the 50k-partition sweep
(reference: src/v/raft/heartbeat_manager.{h,cc}).

The reference batches heartbeats of all raft groups per target node
into one RPC (heartbeat_manager.h:54-83) but still builds and folds
them with per-group scalar loops (heartbeat_manager.cc:203). Here both
directions are array programs over the shard SoA:

  build:  a CACHED per-peer plan (rows/slots arrays, invalidated on
          role/config changes via Consensus.on_topology_change) turns
          the steady-state build into a handful of numpy gathers —
          seq increment, match/term/commit reads and the prev-term
          lookup (term-boundary mirror, shard_state.term_at_batch)
          are all vectorized; no per-group log walks on the tick.
  fold:   ONE jitted device call (ops.quorum.heartbeat_tick_jit) folds
          every reply from every node AND advances every group's
          commit index (the north-star kernel; bench.py measures it).
          Replies aligned with the request (the common case) fold via
          vector ops; stragglers take the per-entry slow path.

Leaders whose followers lag (match < dirty) get a catch-up fiber
scheduled — the recovery_stm hand-off.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Awaitable, Callable, Optional

import numpy as np

from . import shard_state
from . import types as rt
from .consensus import Consensus, Role
from ..models.consensus_state import SELF_SLOT
from ..observability import trace

logger = logging.getLogger("raft.heartbeat")

SendFn = Callable[[int, int, bytes, float], Awaitable[bytes]]


_NO_SUPPRESS = np.zeros(0, bool)

class _PeerPlan:
    """Precomputed build vectors for one target node."""

    __slots__ = (
        "rows", "slots", "gids", "gids_arr", "cons", "pos_by_gid",
        "tb_cache", "frame_cache", "reply_cache",
        "same_epoch", "same_counter", "same_ticks", "same_crc",
        "same_fp", "row_slice", "slot_u",
    )

    def __init__(self, pairs: list[tuple[Consensus, int]]):
        self.rows = np.array([c.row for c, _ in pairs], np.int64)
        self.slots = np.array([s for _, s in pairs], np.int64)
        # contiguity fast path: rows are allocated sequentially, so in
        # the common case the plan covers a dense row range with one
        # uniform slot — every 50k-wide fancy gather/scatter in the
        # tick then becomes a strided slice op (4-10x cheaper measured;
        # a 50k fancy gather is 0.2-0.5 ms, the slice copy 0.02 ms)
        n = len(self.rows)
        self.row_slice = None
        if n and int(self.rows[-1]) - int(self.rows[0]) + 1 == n:
            if n == 1 or bool((np.diff(self.rows) == 1).all()):
                r0 = int(self.rows[0])
                self.row_slice = slice(r0, r0 + n)
        self.slot_u = (
            int(self.slots[0])
            if n and bool((self.slots == self.slots[0]).all())
            else None
        )
        self.gids = [c.group_id for c, _ in pairs]
        self.gids_arr = np.array(self.gids, np.int64)
        self.cons = [c for c, _ in pairs]
        self.pos_by_gid = {g: i for i, g in enumerate(self.gids)}
        # (tb_epoch, prevs, prev_terms, known): prev-term lookups are
        # identical tick after tick in steady state — recompute only
        # rows whose prev offset moved or when a term boundary changed
        self.tb_cache: tuple | None = None
        # (prevs, terms, commits, tb_epoch, frame_prefix): in a steady
        # tick the ONLY field of the request that changes is the seq
        # vector — the last field of the envelope — so the whole frame
        # up to it is spliced from cache instead of re-encoded
        self.frame_cache: tuple | None = None
        # (reply_prefix, reply_suffix): raw bytes of the last all-
        # SUCCESS reply around its seq echo; a byte-equal reply needs
        # only the seq-guard fold, not a decode + full fold
        self.reply_cache: tuple | None = None
        # quiesced SAME-frame state: armed when a spliced full frame
        # drew a byte-identical reply with no local mutation in
        # between; while armed AND arrays.mut_epoch is unchanged the
        # tick sends a fixed-size HEARTBEAT_SAME instead of the
        # O(groups) vector frame. same_crc caches (prefix_id, crc32).
        self.same_epoch: int | None = None
        self.same_counter = 0
        self.same_ticks = 0
        self.same_crc: tuple | None = None
        self.same_fp: int | None = None  # RP_SAME_DEBUG lane checksum

    def col2(self, arr: np.ndarray) -> np.ndarray:
        """Contiguous SNAPSHOT of arr[rows, slots] (callers compare,
        encode, or hold it across awaits — explicit .copy(): with the
        lanes column-major the slice is already contiguous and
        ascontiguousarray would alias the live lane)."""
        if self.row_slice is not None and self.slot_u is not None:
            return arr[self.row_slice, self.slot_u].copy()
        return arr[self.rows, self.slots]

    def lane1(self, arr: np.ndarray) -> np.ndarray:
        """arr[rows]: a contiguous VIEW when rows are dense (callers
        must .copy() before caching), else a fancy-index copy."""
        if self.row_slice is not None:
            return arr[self.row_slice]
        return arr[self.rows]

    def prev_terms_cached(self, arrays, prevs: np.ndarray):
        from .shard_state import term_at_batch_cached

        terms, known, self.tb_cache = term_at_batch_cached(
            arrays, self.tb_cache, self.rows, prevs
        )
        return terms, known


class HeartbeatManager:
    def __init__(
        self,
        node_id: int,
        send: SendFn,
        interval_s: float = 0.05,
        rpc_timeout_s: float = 1.0,
    ):
        self.node_id = node_id
        self._send = send
        self.interval = interval_s
        self._rpc_timeout = rpc_timeout_s
        self._groups: dict[int, Consensus] = {}
        self._by_row: dict[int, Consensus] = {}
        self._plan: Optional[dict[int, _PeerPlan]] = None
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        # RaftProbe set by GroupManager; None for direct fixtures
        self.probe = None
        # shard TickFrame set by GroupManager: the tick's reply fold
        # merges with the replicate path's pending window into one
        # fused frame call; None (direct fixtures) folds directly
        self.tick_frame = None

    def register(self, c: Consensus) -> None:
        self._groups[c.group_id] = c
        self._by_row[c.row] = c
        c.on_topology_change.append(self._invalidate_plan)
        self._plan = None

    def deregister(self, group_id: int) -> None:
        c = self._groups.pop(group_id, None)
        if c is not None:
            self._by_row.pop(c.row, None)
            if self._invalidate_plan in c.on_topology_change:
                c.on_topology_change.remove(self._invalidate_plan)
        self._plan = None

    def _invalidate_plan(self) -> None:
        self._plan = None

    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._loop())

    async def stop(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _loop(self) -> None:
        while not self._closed:
            try:
                t0 = time.perf_counter()
                await self.tick()
                if self.probe is not None:
                    self.probe.heartbeat_tick_hist.observe(
                        time.perf_counter() - t0
                    )
            except Exception:
                logger.exception("heartbeat tick failed")
            await asyncio.sleep(self.interval)

    def _build_plan(self) -> dict[int, _PeerPlan]:
        per_node: dict[int, list[tuple[Consensus, int]]] = {}
        for c in self._groups.values():
            if c.role != Role.LEADER:
                continue
            for peer in c.peers():
                slot = c._slot_map.get(peer)
                if slot is not None:
                    per_node.setdefault(peer, []).append((c, slot))
        # sort by row: sequentially created groups then form ONE dense
        # run, so the plan's gathers take the slice fast path (the
        # follower's rows follow this gid order too — its allocation
        # sequence mirrors ours, keeping both sides dense)
        return {
            peer: _PeerPlan(sorted(pairs, key=lambda cs: cs[0].row))
            for peer, pairs in per_node.items()
        }

    # forced full-frame cadence while quiesced: bounds the staleness
    # window of any mutation-epoch bump a writer site might miss
    FORCE_FULL_EVERY = 64

    async def tick(self) -> None:
        """One sweep: vector-build per-node batches from the SoA, send
        in parallel, fold ALL replies with one device call. Peers whose
        state (ours AND theirs) has been byte-stable across a full
        exchange ride the O(1) HEARTBEAT_SAME path instead."""
        if self._plan is None:
            self._plan = self._build_plan()
        plan = self._plan
        if not plan:
            return
        arrays = next(iter(self._groups.values())).arrays
        epoch0 = arrays.mut_epoch
        # the build and the fold + scan hold the loop; the send between
        # them is an await, outside the section
        metrics = self.probe.registry if self.probe is not None else None
        with trace.section("tick_host", metrics):
            sent, same_sent = self._build_frames(plan, arrays)

        async def one_node(peer: int, msg: bytes):
            try:
                raw = await self._send(peer, rt.HEARTBEAT, msg, self._rpc_timeout)
                return peer, raw
            except Exception:
                return peer, None

        async def one_same(peer: int, msg: bytes):
            p = plan[peer]
            try:
                raw = await self._send(
                    peer, rt.HEARTBEAT_SAME, msg, self._rpc_timeout
                )
                status, counter = rt.decode_same_reply(raw)
            except Exception:
                p.same_epoch = None
                return
            if status == rt.SAME_OK and counter == p.same_counter + 1:
                p.same_counter += 1
                p.same_ticks += 1
            else:
                p.same_epoch = None  # follower diverged: full next tick

        results = await asyncio.gather(
            *(one_node(peer, entry[3]) for peer, entry in sent.items()),
            *(one_same(peer, msg) for peer, msg in same_sent.items()),
        )
        with trace.section("tick_host", metrics):
            self._fold_replies(plan, arrays, epoch0, sent, results[: len(sent)])
            self._kick_laggards(plan, arrays, same_sent)

    def _build_frames(self, plan: dict, arrays) -> tuple[dict, dict]:
        """(sent, same_sent): each peer's full heartbeat frame with what
        its fold needs, and the peers that ride HEARTBEAT_SAME."""
        same_sent: dict[int, bytes] = {}

        # vector build per peer (build_heartbeats analog): seqs, prevs,
        # terms, commits and prev-terms in a handful of gathers.
        # Suppression (consensus::suppress_heartbeats semantics): slots
        # with a live append/catch-up fiber are skipped — every dispatch
        # already carries term/commit — so under full produce load the
        # tick covers only the idle groups and its cost tracks the idle
        # set, not the partition count. The moment a fiber exits, its
        # slot re-enters the beat + lag scan: the recovery-fallback
        # role of the tick is unchanged.
        sent: dict[int, tuple] = {}
        for peer, p in plan.items():
            if (
                p.same_epoch is not None
                and p.same_epoch == arrays.mut_epoch
                and arrays.hb_suppress_total == 0
                and p.same_ticks < self.FORCE_FULL_EVERY
            ):
                if shard_state.SAME_DEBUG and p.same_fp is not None:
                    fp = arrays.same_fingerprint()
                    if fp != p.same_fp:
                        raise AssertionError(
                            "SAME-frame mask (leader): raft lanes "
                            "changed while mut_epoch did not — a "
                            "write site missed touch() (armed fp "
                            f"{p.same_fp:#x}, now {fp:#x})"
                        )
                same_sent[peer] = rt.encode_same_req(
                    self.node_id,
                    len(p.gids),
                    p.same_counter + 1,
                    p.same_crc[1],
                )
                continue
            p.same_epoch = None  # full frame; fold may re-arm
            p.same_ticks = 0
            if arrays.hb_suppress_total:
                suppress = arrays.hb_suppress[p.rows, p.slots] > 0
            else:
                suppress = _NO_SUPPRESS
            if suppress.any():
                keep = ~suppress
                if not keep.any():
                    continue  # every group talked via appends: no beat
                keep_idx = np.flatnonzero(keep)
                rows = p.rows[keep]
                slots = p.slots[keep]
                gids = p.gids_arr[keep]
                arrays.next_seq[rows, slots] += 1
                seqs = arrays.next_seq[rows, slots]
                prevs = arrays.match_index[rows, slots]
                prev_terms, known = arrays.term_at_batch(rows, prevs)
                if not known.all():
                    for i in np.flatnonzero(~known):
                        c = p.cons[int(keep_idx[i])]
                        t = c.term_at(int(prevs[i]))
                        prev_terms[i] = t if t is not None else -1
                msg = rt.HeartbeatRequest(
                    node_id=self.node_id,
                    target_node_id=peer,
                    groups=gids,
                    terms=arrays.term[rows],
                    prev_log_indices=prevs,
                    prev_log_terms=prev_terms,
                    commit_indices=arrays.commit_index[rows],
                    seqs=seqs,
                ).encode()
                sent[peer] = (
                    p, prevs, seqs, msg, rows, slots, gids, keep_idx, False,
                )
                continue
            if p.row_slice is not None and p.slot_u is not None:
                nsv = arrays.next_seq[p.row_slice, p.slot_u]
                nsv += 1
                seqs = np.ascontiguousarray(nsv)
            else:
                arrays.next_seq[p.rows, p.slots] += 1
                seqs = arrays.next_seq[p.rows, p.slots]
            prevs = p.col2(arrays.match_index)
            terms = p.lane1(arrays.term)
            commits = p.lane1(arrays.commit_index)
            fc = p.frame_cache
            if (
                fc is not None
                and fc[3] == arrays.tb_epoch
                and np.array_equal(prevs, fc[0])
                and np.array_equal(terms, fc[1])
                and np.array_equal(commits, fc[2])
            ):
                # steady tick: splice cached frame + fresh seq vector
                spliced = True
                msg = fc[4] + np.ascontiguousarray(seqs, "<q").tobytes()
            else:
                spliced = False
                prev_terms, known = p.prev_terms_cached(arrays, prevs)
                if not known.all():
                    # rare laggards below the mirrored boundary window:
                    # per-group log walk fallback. Mark the row known
                    # afterwards — the walked answer is cached with the
                    # same (prevs, tb_epoch) key, so re-walking every
                    # steady tick would defeat the cache.
                    for i in np.flatnonzero(~known):
                        t = p.cons[i].term_at(int(prevs[i]))
                        prev_terms[i] = t if t is not None else -1
                        known[i] = True
                msg = rt.HeartbeatRequest(
                    node_id=self.node_id,
                    target_node_id=peer,
                    groups=p.gids_arr,
                    terms=terms,
                    prev_log_indices=prevs,
                    prev_log_terms=prev_terms,
                    commit_indices=commits,
                    seqs=seqs,
                ).encode()
                # prefix ends right after the seq vector's u32 count.
                # SNAPSHOT the lanes (lane1 returns live views on the
                # dense-row path — caching a view would track future
                # mutations and falsify the steady-state compare)
                p.frame_cache = (
                    prevs.copy(),
                    terms.copy(),
                    commits.copy(),
                    arrays.tb_epoch,
                    msg[: len(msg) - 8 * len(p.gids)],
                )
            sent[peer] = (
                p, prevs, seqs, msg, p.rows, p.slots, p.gids_arr, None,
                spliced,
            )

        return sent, same_sent

    def _fold_replies(
        self, plan: dict, arrays, epoch0: int, sent: dict, results: list
    ) -> None:
        """Fold every reply into one device call (or the tick frame)."""
        # fold: flatten every successful reply into one batch
        rows_acc: list[np.ndarray] = []
        slots_acc: list[np.ndarray] = []
        dirty_acc: list[np.ndarray] = []
        flushed_acc: list[np.ndarray] = []
        seqs_acc: list[np.ndarray] = []
        for peer, raw in results:
            if raw is None:
                continue
            entry = sent.get(peer)
            if entry is None:
                continue
            p, prevs, seqs, _msg, rows, slots, gids, keep_idx, spliced = entry
            # steady-state reply: byte-identical to the last all-SUCCESS
            # reply except the echoed seq vector — fold only the seq
            # guard and skip decode + the full min/mask pass. The skip
            # is sound only if the LEADER's own state also sat still:
            # a local append/fsync between ticks (flush-clamp release)
            # or a config change must take the full fold. Subset sends
            # (suppression active) never take or arm this cache.
            n = len(gids)
            seq_lo = len(raw) - (4 + n) - 8 * n
            rc = p.reply_cache
            fast = keep_idx is None and p.row_slice is not None
            if (
                keep_idx is None
                and rc is not None
                and self._plan is plan
                and len(raw) == rc[2]
                and raw[:seq_lo] == rc[0]
                and raw[seq_lo + 8 * n :] == rc[1]
                and not arrays.quorum_dirty.any()
                and np.array_equal(
                    np.ascontiguousarray(
                        arrays.match_index[p.row_slice, SELF_SLOT]
                    )
                    if fast
                    else arrays.match_index[rows, SELF_SLOT],
                    arrays._folded_self_m[p.row_slice]
                    if fast
                    else arrays._folded_self_m[rows],
                )
                and np.array_equal(
                    np.ascontiguousarray(
                        arrays.flushed_index[p.row_slice, SELF_SLOT]
                    )
                    if fast
                    else arrays.flushed_index[rows, SELF_SLOT],
                    arrays._folded_self_f[p.row_slice]
                    if fast
                    else arrays._folded_self_f[rows],
                )
            ):
                r_seqs = np.frombuffer(
                    raw[seq_lo : seq_lo + 8 * n], "<q"
                ).astype(np.int64, copy=False)
                if fast and p.slot_u is not None:
                    lsv = arrays.last_seq[p.row_slice, p.slot_u]
                    np.maximum(lsv, r_seqs, out=lsv)
                else:
                    # (rows, slots) pairs are unique within one plan:
                    # gather+max+scatter beats the unbuffered ufunc.at
                    arrays.last_seq[rows, slots] = np.maximum(
                        arrays.last_seq[rows, slots], r_seqs
                    )
                if spliced and arrays.mut_epoch == epoch0:
                    # spliced frame + byte-identical reply + no local
                    # mutation during the RPC: both sides are armed for
                    # the O(1) SAME path. The crc binds to the cached
                    # frame prefix (identity-keyed: recomputed only
                    # when the prefix bytes object changes).
                    prefix = p.frame_cache[4]
                    if p.same_crc is None or p.same_crc[0] is not prefix:
                        import zlib

                        p.same_crc = (prefix, zlib.crc32(prefix))
                    p.same_epoch = epoch0
                    p.same_ticks = 0
                    p.same_fp = (
                        arrays.same_fingerprint()
                        if shard_state.SAME_DEBUG
                        else None
                    )
                continue
            reply = rt.HeartbeatReply.decode(raw)
            r_groups = np.asarray(reply.groups, np.int64)
            statuses = np.asarray(reply.statuses, np.int64)
            # the fast path indexes through the send's row/slot vectors,
            # which is only sound while the plan is still current — a
            # topology change during the RPC gather (reconfig moving a
            # peer to a different slot) sends stragglers down the
            # per-entry path with fresh slot lookups
            aligned = (
                self._plan is plan
                and len(r_groups) == n
                and bool((r_groups == gids).all())
            )
            if aligned:
                still_leader = arrays.is_leader[rows]
                ok = (statuses == rt.AppendEntriesReply.SUCCESS) & still_leader
                if ok.any():
                    # heartbeat SUCCESS only proves the follower
                    # matches up to the prev we sent: cap at prev
                    d = np.minimum(
                        np.asarray(reply.last_dirty, np.int64), prevs
                    )
                    f = np.minimum(np.asarray(reply.last_flushed, np.int64), d)
                    rows_acc.append(rows[ok])
                    slots_acc.append(slots[ok])
                    dirty_acc.append(d[ok])
                    flushed_acc.append(f[ok])
                    seqs_acc.append(np.asarray(reply.seqs, np.int64)[ok])
                bad = np.flatnonzero(
                    (statuses != rt.AppendEntriesReply.SUCCESS) & still_leader
                )
                for i in bad:
                    ci = int(i) if keep_idx is None else int(keep_idx[i])
                    self._handle_failure(p.cons[ci], peer, reply, int(i))
                # only a full-batch all-SUCCESS reply may arm the
                # byte-splice fast path: FAILURE rows have per-tick side
                # effects (match rewind, catch-up spawns) a skip would
                # suppress, and subset replies don't cover the plan
                if keep_idx is None and len(bad) == 0 and bool(ok.all()):
                    p.reply_cache = (
                        raw[:seq_lo], raw[seq_lo + 8 * n :], len(raw)
                    )
                else:
                    p.reply_cache = None
            else:
                # misaligned reply (defensive): per-entry slow path
                pos_by_gid = (
                    p.pos_by_gid
                    if keep_idx is None
                    else {int(g): i for i, g in enumerate(gids)}
                )
                for i, gid in enumerate(reply.groups):
                    pos = pos_by_gid.get(gid)
                    c = self._groups.get(gid)
                    if pos is None or c is None or c.role != Role.LEADER:
                        continue
                    if reply.statuses[i] != rt.AppendEntriesReply.SUCCESS:
                        self._handle_failure(c, peer, reply, i)
                        continue
                    slot = c._slot_map.get(peer)
                    if slot is None:
                        continue
                    cap = int(prevs[pos])
                    d = min(int(reply.last_dirty[i]), cap)
                    rows_acc.append(np.array([c.row], np.int64))
                    slots_acc.append(np.array([slot], np.int64))
                    dirty_acc.append(np.array([d], np.int64))
                    flushed_acc.append(
                        np.array([min(int(reply.last_flushed[i]), d)], np.int64)
                    )
                    seqs_acc.append(np.array([int(reply.seqs[i])], np.int64))
        frame = self.tick_frame
        if rows_acc:
            gr = np.concatenate(rows_acc)
            gs = np.concatenate(slots_acc)
            gd = np.concatenate(dirty_acc)
            gf = np.concatenate(flushed_acc)
            gq = np.concatenate(seqs_acc)
            if frame is not None:
                # merge with the replicate path's pending-reply window:
                # one fused frame per tick covers both reply streams
                # (advance callbacks fire inside fold_now)
                frame.fold_now(gr, gs, gd, gf, gq)
            else:
                advanced = arrays.device_tick(gr, gs, gd, gf, gq)
                for r in advanced:
                    c = self._by_row.get(int(r))
                    if c is not None:
                        c.on_batched_commit_advance()
        elif frame is not None and frame.pending:
            # no heartbeat replies this tick, but the replicate window
            # has pending rows: drain them on the tick cadence too
            frame.flush()

    def _kick_laggards(self, plan: dict, arrays, same_sent: dict) -> None:
        # recovery: schedule catch-up for lagging followers, found with
        # one vector compare per peer (match/flushed vs leader dirty).
        # Slots with a live fiber are excluded — their lag is in-flight
        # replication that fiber is already driving, and spawning a
        # task per group per tick for them is pure overhead (the spawn
        # would bounce off the peer lock anyway).
        for peer, p in plan.items():
            if peer in same_sent:
                continue  # quiesced: nothing moved, nothing to scan
            if p.row_slice is not None and p.slot_u is not None:
                sl, su = p.row_slice, p.slot_u
                # contiguous copies first: strided-view compares cost
                # ~10x a contiguous op at 50k (measured)
                m_peer = np.ascontiguousarray(arrays.match_index[sl, su])
                m_self = np.ascontiguousarray(
                    arrays.match_index[sl, SELF_SLOT]
                )
                f_peer = np.ascontiguousarray(
                    arrays.flushed_index[sl, su]
                )
                sup = np.ascontiguousarray(arrays.hb_suppress[sl, su])
                lag = (
                    arrays.is_leader[sl]
                    & ((m_peer < m_self) | (f_peer < m_peer))
                    & (sup == 0)
                )
            else:
                lag = (
                    arrays.is_leader[p.rows]
                    & (
                        (
                            arrays.match_index[p.rows, p.slots]
                            < arrays.match_index[p.rows, SELF_SLOT]
                        )
                        | (
                            arrays.flushed_index[p.rows, p.slots]
                            < arrays.match_index[p.rows, p.slots]
                        )
                    )
                    & (arrays.hb_suppress[p.rows, p.slots] == 0)
                )
            for i in np.flatnonzero(lag):
                c = p.cons[int(i)]
                if c.role == Role.LEADER:
                    c.kick_catch_up(peer)

    def _handle_failure(
        self, c: Consensus, peer: int, reply: rt.HeartbeatReply, i: int
    ) -> None:
        if reply.terms[i] > c.term:
            c._step_down(int(reply.terms[i]))
        elif reply.statuses[i] == rt.AppendEntriesReply.FAILURE:
            # log-mismatch/gap rejection: our match estimate is wrong
            # (e.g. follower lost its tail). Rewind it host-side so the
            # catch-up fiber engages — the device fold is monotone and
            # cannot. (GROUP_UNAVAILABLE is NOT a mismatch: the group
            # isn't constructed there yet; rewinding would force a
            # pointless re-replication from 0.)
            slot = c._slot_map.get(peer)
            if slot is None:
                return
            seq = int(reply.seqs[i])
            if seq <= int(c.arrays.last_seq[c.row, slot]):
                # stale echo (duplicated or reordered reply): a newer
                # reply already folded for this peer — rewinding match
                # off old evidence would re-trigger catch-up forever
                # under nemesis duplicate/reorder schedules
                return
            c.arrays.last_seq[c.row, slot] = seq
            c.arrays.match_index[c.row, slot] = min(
                int(c.arrays.match_index[c.row, slot]),
                int(reply.last_dirty[i]),
            )
            c.arrays.touch()  # match_index + last_seq are SAME lanes
            c.kick_catch_up(peer)


# RP_SAN=1: the plan cache is rebuilt inside the tick and invalidated
# by topology callbacks — exactly the cross-task rebind shape the
# sanitizer watches. No-op when RP_SAN is unset.
from ..utils import rpsan as _rpsan  # noqa: E402

_rpsan.instrument(HeartbeatManager, ("_plan", "_closed"))
