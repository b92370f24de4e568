"""Raft RPC service (reference: src/v/raft/service.h:45-117).

Dispatches vote/append_entries/timeout_now per group, and handles the
node-level heartbeat batch: the reference regroups the batch by
destination shard (service.h:83-90); here all groups of the node live
on one event loop, so the batch is answered in one pass with no
per-group RPC overhead — the follower side of the batched sweep.
"""

from __future__ import annotations

import asyncio
import logging
import struct

from ..rpc import Service, method
from ..storage import file_sanitizer, iofaults
from ..utils import native as native_mod
from ..utils import spans
from . import types as rt

logger = logging.getLogger("raft.service")

import numpy as _np

_EMPTY = _np.empty(0, _np.int64)


class RaftService(Service):
    service_name = "raft"

    def __init__(self, group_manager):
        self._gm = group_manager
        # heartbeat batches repeat the same group list tick after tick:
        # cache the group->(consensus, row) resolution PER SENDER (each
        # peer leads a different group set — one shared slot would
        # thrash), invalidated by the registry epoch
        self._hb_plans: dict[int, tuple] = {}
        # per-sender prev-term answer cache (steady-state prev offsets
        # repeat; see _PeerPlan.prev_terms_cached for the leader twin)
        self._tb_cache: dict[int, tuple] = {}
        # per-sender steady-state reply cache: when neither the request
        # vectors nor this node's per-group state moved, the reply is
        # byte-identical except the echoed seq vector — splice it
        self._reply_cache: dict[int, tuple] = {}
        # per-sender SAME-frame arming: (mut_epoch at arm, n_groups,
        # crc32 of the armed request minus its seq vector). A SAME
        # frame is honored only while our own state epoch is unchanged
        # — any local raft mutation de-arms implicitly.
        self._same_armed: dict[int, tuple] = {}
        # rows whose liveness the sender's armed batch covers (for
        # clearing arrays.same_cover_node on re-arm)
        self._same_rows: dict[int, "object"] = {}
        # per-sender dense-row slice (None = sparse; see _resolve_batch)
        self._hb_row_slice: dict[int, "object"] = {}
        # placement shard seam (ssx/sharded_broker.py): groups the
        # placement table hosts on a worker shard of THIS node get
        # their frames forwarded there. All three hooks are set
        # together by ShardedBroker.start(); unset = single-process
        # broker, every group local.
        #   shard_resolver(group_id) -> owning shard (0/None = local)
        #   shard_forward(shard, method_id, payload) -> reply bytes
        #   shard_epoch() -> placement table epoch (split-plan cache)
        self.shard_resolver = None
        self.shard_forward = None
        self.shard_epoch = None
        # per-sender heartbeat split plan: (registry_epoch, placement
        # epoch, request-groups key, per-position shards or None when
        # every group is local)
        self._fwd_hb: dict[int, tuple] = {}
        # senders whose last full frame was split across shards: their
        # SAME frames bind to the FULL frame's crc, which no single
        # shard saw — always demand a full exchange
        self._split_senders: set[int] = set()

    def _consensus(self, group_id: int):
        return self._gm.get(group_id)

    # -- placement shard seam -----------------------------------------
    def _worker_shard_of(self, group_id: int) -> int:
        """Owning worker shard for a group NOT hosted locally, or 0."""
        if self.shard_resolver is None:
            return 0
        s = self.shard_resolver(int(group_id))
        return int(s) if s else 0

    async def _maybe_forward(
        self, group_id: int, method_id: int, payload: bytes
    ) -> bytes | None:
        """Forward a single-group frame to the owning worker shard.
        None = not forwardable (truly unknown group or forward failed);
        the caller answers with its usual unavailable reply."""
        if self.shard_forward is None:
            return None
        shard = self._worker_shard_of(group_id)
        if shard <= 0:
            return None
        try:
            return await self.shard_forward(shard, method_id, payload)
        except Exception:
            logger.exception(
                "raft forward of method %d (group %d) to shard %d failed",
                method_id, group_id, shard,
            )
            return None

    def invalidate_heartbeat_plans(self) -> None:
        """Called on group removal so stale plans don't pin stopped
        Consensus objects (and their logs) in memory."""
        self._hb_plans.clear()
        self._tb_cache.clear()
        self._hb_row_slice.clear()

    def _resolve_batch(self, sender: int, groups) -> tuple[list, "object"]:
        import numpy as np

        gids = np.asarray(groups, np.int64)
        epoch = self._gm.registry_epoch
        plan = self._hb_plans.get(sender)
        if (
            plan is not None
            and plan[0] == epoch
            and np.array_equal(plan[1], gids)
        ):
            return plan[2], plan[3]
        cons = [self._gm.get(int(g)) for g in groups]
        rows = np.fromiter(
            (c.row if c is not None else -1 for c in cons),
            np.int64,
            len(cons),
        )
        self._hb_plans[sender] = (epoch, gids.copy(), cons, rows)
        self._tb_cache.pop(sender, None)
        self._reply_cache.pop(sender, None)
        # dense-row fast path (see _PeerPlan.row_slice): when every
        # group resolves and rows form one contiguous run, the
        # steady-state compare gathers become strided slice reads
        n = len(rows)
        sl = None
        if (
            n
            and int(rows[0]) >= 0
            and int(rows[-1]) - int(rows[0]) + 1 == n
            and (n == 1 or bool((np.diff(rows) == 1).all()))
        ):
            sl = slice(int(rows[0]), int(rows[0]) + n)
        self._hb_row_slice[sender] = sl
        return cons, rows

    def _arm_same_coverage(self, sender: int, arrays, rows) -> None:
        """Liveness coverage: node-level SAME stamps from `sender`
        credit exactly `rows`, nothing else. On re-arm, clear ONLY the
        previous rows still attributed to this sender — after a
        leadership migration another sender may have taken over some of
        them, and wiping its coverage would stall their last_hb refresh
        until its next forced-full frame (up to FORCE_FULL_EVERY ticks,
        longer than the election timeout — a spurious election)."""
        if isinstance(rows, slice):  # dense-path liveness rows
            rows = _np.arange(rows.start, rows.stop, dtype=_np.int64)
        prev = self._same_rows.get(sender)
        if prev is not None:
            mine = prev[arrays.same_cover_node[prev] == sender]
            arrays.same_cover_node[mine] = -1
        arrays.same_cover_node[rows] = sender
        self._same_rows[sender] = rows

    def _prev_terms_cached(self, sender: int, arrays, rows, prevs):
        from .shard_state import term_at_batch_cached

        terms, known, self._tb_cache[sender] = term_at_batch_cached(
            arrays, self._tb_cache.get(sender), rows, prevs
        )
        return terms, known

    @method(rt.VOTE)
    async def vote(self, payload: bytes) -> bytes:
        req = rt.VoteRequest.decode(payload)
        c = self._consensus(int(req.group))
        if c is None:
            out = await self._maybe_forward(int(req.group), rt.VOTE, payload)
            if out is not None:
                return out
            return rt.VoteReply(
                group=int(req.group), term=-1, granted=False, log_ok=False
            ).encode()
        return (await c.handle_vote(req)).encode()

    @method(rt.APPEND_ENTRIES)
    async def append_entries(self, payload: bytes) -> bytes:
        # Native follower fast path: parse + guards + per-batch CRC +
        # reply framing in one C call over the raw frame
        # (native/append_frame.cc via Consensus.try_native_append).
        # Debug instrumentation that must observe the Python write path
        # (spans, file sanitizer, iofault injection) disables it, and
        # any in-frame anomaly punts to the decode route below.
        if (
            not spans.ENABLED
            and not file_sanitizer.enabled()
            and not iofaults.active()
            and native_mod.append_frame_ready()
            and len(payload) >= 14
        ):
            gid = struct.unpack_from("<q", payload, 6)[0]
            c = self._consensus(int(gid))
            if c is not None:
                out = await c.try_native_append(payload)
                if out is not None:
                    return out
        req = rt.AppendEntriesRequest.decode(payload)
        c = self._consensus(int(req.group))
        if c is None:
            out = await self._maybe_forward(
                int(req.group), rt.APPEND_ENTRIES, payload
            )
            if out is not None:
                return out
            return rt.AppendEntriesReply(
                group=int(req.group),
                node_id=self._gm.node_id,
                term=-1,
                last_dirty_log_index=-1,
                last_flushed_log_index=-1,
                seq=int(req.seq),
                status=rt.AppendEntriesReply.GROUP_UNAVAILABLE,
            ).encode()
        return (await c.handle_append_entries(req)).encode()

    @method(rt.HEARTBEAT)
    async def heartbeat(self, payload: bytes) -> bytes:
        """Answer the whole node-batch with vector ops over the shard
        SoA — the follower half of the batched sweep. Mirrors
        Consensus.handle_heartbeat exactly; groups that need state
        transitions the arrays can't express (term bumps/step-downs,
        term lookups below the mirrored boundary window) drop to the
        per-group scalar path."""
        import asyncio

        import numpy as np

        from ..models.consensus_state import SELF_SLOT

        import struct as _struct

        # placement split: frames naming worker-owned groups fan out
        # per shard and re-merge; all-local senders fall through to the
        # vectorized fast path below (verdict cached per sender)
        if self.shard_forward is not None:
            out = await self._heartbeat_split(payload)
            if out is not None:
                return out

        gm = self._gm
        arrays = gm.arrays
        # raw-prefix gate: the seq vector is the LAST request field
        # (types.py layout contract), so when everything before it is
        # byte-identical to this sender's previous frame the request
        # vectors are unchanged — reuse the cached decode (skips ~6
        # 400 KB vector decodes + 4 vector compares per 50k tick).
        sender = _struct.unpack_from("<i", payload, 6)[0]
        rc = self._reply_cache.get(sender)
        prefix_hit = False
        import os as _os
        if _os.environ.get("RP_NO_HB_PREFIX") != "1" and rc is not None and rc[14] is not None:
            c_reqpfx = rc[14]
            n = len(rc[0])
            pfx_len = len(payload) - 8 * n
            plan_ent = self._hb_plans.get(sender)
            if (
                plan_ent is not None
                and plan_ent[0] == gm.registry_epoch
                and pfx_len == len(c_reqpfx)
                and memoryview(payload)[:pfx_len] == c_reqpfx
            ):
                prefix_hit = True
                cons, rows = plan_ent[2], plan_ent[3]
                t_req, prevs, pterms, lcommits = rc[0], rc[1], rc[2], rc[3]
                seqs = np.frombuffer(payload[pfx_len:], "<q")
                groups = plan_ent[1]
        if not prefix_hit:
            req = rt.HeartbeatRequest.decode(payload)
            n = len(req.groups)
            cons, rows = self._resolve_batch(int(req.node_id), req.groups)
            sender = int(req.node_id)
            t_req = np.asarray(req.terms, np.int64)
            prevs = np.asarray(req.prev_log_indices, np.int64)
            pterms = np.asarray(req.prev_log_terms, np.int64)
            lcommits = np.asarray(req.commit_indices, np.int64)
            seqs = req.seqs
            groups = req.groups
        avail = rows >= 0

        # dense-row fast path: slice reads instead of 50k-wide fancy
        # gathers (4-10x cheaper; the full-frame tick is gather-bound)
        sl = self._hb_row_slice.get(sender)
        if sl is not None:
            r = rows
            my_term = arrays.term[sl]
            g_dirty = np.ascontiguousarray(arrays.match_index[sl, SELF_SLOT])
            g_flushed = np.ascontiguousarray(
                arrays.flushed_index[sl, SELF_SLOT]
            )
            g_commit = arrays.commit_index[sl]
            g_follower = arrays.is_follower[sl]
            g_lstart = arrays.log_start[sl]
            g_snap = arrays.snap_index[sl]
        else:
            r = np.where(avail, rows, 0)
            my_term = arrays.term[r]
            g_dirty = arrays.match_index[r, SELF_SLOT]
            g_flushed = arrays.flushed_index[r, SELF_SLOT]
            g_commit = arrays.commit_index[r]
            g_follower = arrays.is_follower[r]
            g_lstart = arrays.log_start[r]
            g_snap = arrays.snap_index[r]
        # steady-state fast path: if the request vectors AND this
        # node's per-group state are unchanged since the last batch
        # from this sender, the reply is byte-identical except the
        # echoed seq vector — splice it around cached bytes. State is
        # compared by value (gathers are the cheap part; it's the ~15
        # downstream vector ops + re-encode that dominate a tick).
        if rc is not None:
            (
                c_treq, c_prevs, c_pterms, c_lcommits, c_myterm,
                c_dirty, c_flushed, c_commit, c_follower, c_lstart,
                c_snap, c_lr, c_prefix, c_suffix, _c_reqpfx,
            ) = rc
            if (
                prefix_hit
                or (
                    np.array_equal(t_req, c_treq)
                    and np.array_equal(prevs, c_prevs)
                    and np.array_equal(pterms, c_pterms)
                    and np.array_equal(lcommits, c_lcommits)
                )
            ) and (
                np.array_equal(my_term, c_myterm)
                and np.array_equal(g_dirty, c_dirty)
                and np.array_equal(g_flushed, c_flushed)
                and np.array_equal(g_commit, c_commit)
                and np.array_equal(g_follower, c_follower)
                and np.array_equal(g_lstart, c_lstart)
                and np.array_equal(g_snap, c_snap)
            ):
                if isinstance(c_lr, slice) or len(c_lr):
                    now = asyncio.get_event_loop().time()
                    arrays.last_hb[c_lr] = now
                # steady across >=1 full exchange: arm the SAME path.
                # crc binds to the request bytes minus the trailing
                # seq vector data (the only per-tick variance). Skip
                # the O(n) crc + slice when an identical arm is in
                # place (leader stuck on spliced-full frames — e.g.
                # suppression active elsewhere — would otherwise pay
                # this every tick).
                ent = self._same_armed.get(sender)
                if ent is None or ent[0] != arrays.mut_epoch or ent[1] != n:
                    import zlib

                    from .shard_state import SAME_DEBUG

                    # coverage BEFORE the armed entry: if arming raises
                    # partway, an armed-but-uncovered entry would serve
                    # SAME_OK forever while the liveness merge stays
                    # dead (cover=-1) — and never retry, because the
                    # entry already matches mut_epoch
                    self._arm_same_coverage(sender, arrays, c_lr)
                    self._same_armed[sender] = (
                        arrays.mut_epoch,
                        n,
                        zlib.crc32(payload[: len(payload) - 8 * n]),
                        arrays.same_fingerprint() if SAME_DEBUG else None,
                    )
                # the reply echoes the request's seq vector verbatim —
                # splice the raw request tail straight in
                seq_bytes = (
                    payload[len(payload) - 8 * n :]
                    if prefix_hit
                    else np.ascontiguousarray(seqs, "<q").tobytes()
                )
                return c_prefix + seq_bytes + c_suffix
        if sl is not None:
            dirty_out = g_dirty.copy()
            flushed_out = g_flushed.copy()
            terms_out = my_term.copy()
        else:
            dirty_out = np.where(avail, g_dirty, -1)
            flushed_out = np.where(avail, g_flushed, -1)
            terms_out = np.where(avail, my_term, -1)
        statuses = np.full(n, rt.AppendEntriesReply.GROUP_UNAVAILABLE, np.int64)

        follower = avail & g_follower
        tb_terms, known = self._prev_terms_cached(
            sender, arrays, r, prevs
        )
        in_log = (prevs >= 0) & ((prevs >= g_lstart) | (prevs == g_snap))
        # scalar-path groups: term bump / step-down needed, or the
        # prev-term answer lies below the mirrored boundary window
        slow = avail & (
            (t_req > my_term)
            | (~follower & (t_req >= my_term))
            | (in_log & ~known)
        )
        fast = avail & ~slow
        stale = fast & (t_req < my_term)
        statuses[stale] = rt.AppendEntriesReply.FAILURE
        live = fast & ~stale  # term == my_term, role FOLLOWER
        live_all = bool(live.all())
        if live_all and sl is not None:
            now = asyncio.get_event_loop().time()
            arrays.last_hb[sl] = now
            arrays.leader_id[sl] = sender
        elif live.any():
            now = asyncio.get_event_loop().time()
            lr = r[live]
            arrays.last_hb[lr] = now
            arrays.leader_id[lr] = sender
        gap = live & (prevs > dirty_out)
        mismatch = live & in_log & known & (tb_terms != pterms)
        bad = gap | mismatch
        statuses[bad] = rt.AppendEntriesReply.FAILURE
        ok = live & ~bad
        statuses[ok] = rt.AppendEntriesReply.SUCCESS
        # follower commit rule (qs.follower_commit_index), Raft §5.3:
        # only the prefix confirmed identical to the leader may commit
        capped = np.where(prevs >= 0, np.minimum(lcommits, prevs), -1)
        my_commit = g_commit
        proposed = np.minimum(capped, flushed_out)
        adv = ok & (capped > my_commit) & (proposed > my_commit)
        if adv.any():
            idxs = np.flatnonzero(adv)
            ar = r[idxs]
            arrays.commit_index[ar] = proposed[idxs]
            arrays.touch()
            arrays.last_visible[ar] = np.maximum(
                arrays.last_visible[ar], proposed[idxs]
            )
            for i in idxs:
                cons[int(i)]._notify_commit()
        slow_rows = np.flatnonzero(slow)
        for i in slow_rows:
            i = int(i)
            t, d, f, _s, st = cons[i].handle_heartbeat(
                sender,
                int(t_req[i]),
                int(prevs[i]),
                int(pterms[i]),
                int(lcommits[i]),
                int(seqs[i]),
            )
            terms_out[i] = t
            dirty_out[i] = d
            flushed_out[i] = f
            statuses[i] = st
        out = rt.HeartbeatReply(
            node_id=gm.node_id,
            groups=groups,
            terms=terms_out,
            last_dirty=dirty_out,
            last_flushed=flushed_out,
            seqs=seqs,
            statuses=statuses,
        ).encode()
        if len(slow_rows) == 0:
            # cacheable: no scalar-path side effects this batch. The
            # seq vector sits between the flushed and status fields —
            # remember the bytes around it.
            suffix_len = 4 + n  # u32 count + n × i8 statuses
            if sl is not None:
                c_lr = sl if live_all else (r[live] if live.any() else _EMPTY)
            else:
                c_lr = r[live] if live.any() else _EMPTY
            # g_* are live views on the dense path: snapshot them (a
            # cached view would track future lane writes and make the
            # steady compare vacuously true — stale replies)
            self._reply_cache[sender] = (
                t_req, prevs, pterms, lcommits, my_term.copy(),
                g_dirty.copy(),
                g_flushed.copy(),
                g_commit.copy(),
                g_follower.copy(),
                g_lstart.copy(),
                g_snap.copy(),
                c_lr,
                out[: len(out) - suffix_len - 8 * n],
                out[len(out) - suffix_len :],
                bytes(payload[: len(payload) - 8 * n]),
            )
        else:
            self._reply_cache.pop(sender, None)
        return out

    async def _heartbeat_split(self, payload: bytes) -> bytes | None:
        """Split a node heartbeat batch across the shards that own its
        groups. None = every group is local (the caller's vectorized
        path handles the frame). The split plan is cached per
        (sender, n) — keyed on registry/placement epochs and a crc of
        the group-id vector — so steady-state split frames skip the
        per-group resolution. The local subset recurses into
        heartbeat() as its own (smaller) frame, so the reply/SAME
        caches keep working on the local half."""
        import asyncio
        import struct as _struct
        import zlib

        import numpy as np

        gm = self._gm
        # layout (types.py): 6B envelope header, node_id i32 @6,
        # target i32 @10, groups vector count u32 @14, gids @18
        sender = _struct.unpack_from("<i", payload, 6)[0]
        n = _struct.unpack_from("<I", payload, 14)[0]
        groups_raw = bytes(payload[18 : 18 + 8 * n])
        key = (
            gm.registry_epoch,
            self.shard_epoch() if self.shard_epoch is not None else 0,
            zlib.crc32(groups_raw),
        )
        ent = self._fwd_hb.get((sender, n))
        if ent is not None and ent[0] == key:
            shards = ent[1]
        else:
            gids = np.frombuffer(groups_raw, "<q")
            shards = np.zeros(n, np.int64)
            for i, g in enumerate(gids.tolist()):
                if gm.get(g) is None:
                    s = self._worker_shard_of(g)
                    if s > 0:
                        shards[i] = s
            if not shards.any():
                shards = None
            self._fwd_hb[(sender, n)] = (key, shards)
            if shards is None:
                self._split_senders.discard(sender)
            else:
                self._split_senders.add(sender)
        if shards is None:
            return None
        req = rt.HeartbeatRequest.decode(payload)
        gids = np.asarray(req.groups, np.int64)
        t_req = np.asarray(req.terms, np.int64)
        prevs = np.asarray(req.prev_log_indices, np.int64)
        pterms = np.asarray(req.prev_log_terms, np.int64)
        commits = np.asarray(req.commit_indices, np.int64)
        seqs = np.asarray(req.seqs, np.int64)
        terms_out = np.full(n, -1, np.int64)
        dirty_out = np.full(n, -1, np.int64)
        flushed_out = np.full(n, -1, np.int64)
        statuses = np.full(
            n, rt.AppendEntriesReply.GROUP_UNAVAILABLE, np.int64
        )

        async def do(shard: int, idx) -> None:
            sub = rt.HeartbeatRequest(
                node_id=req.node_id,
                target_node_id=req.target_node_id,
                groups=gids[idx],
                terms=t_req[idx],
                prev_log_indices=prevs[idx],
                prev_log_terms=pterms[idx],
                commit_indices=commits[idx],
                seqs=seqs[idx],
            ).encode()
            try:
                if shard == 0:
                    raw = await self.heartbeat(sub)
                else:
                    raw = await self.shard_forward(shard, rt.HEARTBEAT, sub)
            except Exception:
                logger.exception(
                    "heartbeat forward to shard %d failed", shard
                )
                return  # those positions stay GROUP_UNAVAILABLE
            rep = rt.HeartbeatReply.decode(raw)
            terms_out[idx] = np.asarray(rep.terms, np.int64)
            dirty_out[idx] = np.asarray(rep.last_dirty, np.int64)
            flushed_out[idx] = np.asarray(rep.last_flushed, np.int64)
            statuses[idx] = np.asarray(rep.statuses, np.int64)

        tasks = []
        local_idx = np.flatnonzero(shards == 0)
        if len(local_idx):
            tasks.append(do(0, local_idx))
        for s in np.unique(shards[shards > 0]).tolist():
            tasks.append(do(int(s), np.flatnonzero(shards == s)))
        await asyncio.gather(*tasks)
        return rt.HeartbeatReply(
            node_id=gm.node_id,
            groups=gids,
            terms=terms_out,
            last_dirty=dirty_out,
            last_flushed=flushed_out,
            seqs=seqs,
            statuses=statuses,
        ).encode()

    @method(rt.HEARTBEAT_SAME)
    async def heartbeat_same(self, payload: bytes) -> bytes:
        """Quiesced steady-state heartbeat: O(1) validation instead of
        the O(groups) vector pass. Honored only while (a) this node's
        raft state epoch is unchanged since the arming full exchange
        and (b) the sender's frame CRC matches the armed one — i.e.
        both sides still agree byte-for-byte on the last full frame.
        Liveness lands as a node-level stamp the election sweeper
        merges with per-row last_hb."""
        import asyncio

        node_id, n, counter, crc = rt.decode_same_req(payload)
        if node_id in self._split_senders:
            # this sender's full frames are split across shards: the
            # SAME crc binds to the full frame, which no single shard
            # validated — demand the full exchange every time
            return rt.encode_same_reply(rt.SAME_NEED_FULL, counter)
        ent = self._same_armed.get(node_id)
        arrays = self._gm.arrays
        if (
            ent is None
            or ent[0] != arrays.mut_epoch
            or ent[1] != n
            or ent[2] != crc
        ):
            return rt.encode_same_reply(rt.SAME_NEED_FULL, counter)
        from .shard_state import SAME_DEBUG

        if SAME_DEBUG and ent[3] is not None:
            fp = arrays.same_fingerprint()
            if fp != ent[3]:
                raise AssertionError(
                    "SAME-frame mask: raft lanes changed while "
                    "mut_epoch did not — a write site missed touch() "
                    f"(armed fp {ent[3]:#x}, now {fp:#x})"
                )
        arrays.node_hb[node_id] = asyncio.get_event_loop().time()
        return rt.encode_same_reply(rt.SAME_OK, counter)

    @method(rt.APPEND_ENTRIES_BATCH)
    async def append_entries_batch(self, payload: bytes) -> bytes:
        """Many groups' appends in one frame (append_aggregator): one
        sequential pass — with coalesced/inline fsync each per-group
        handler rarely suspends, so no per-group task spawn is needed —
        and one multiplexed reply. The pass yields every 8 groups:
        at 1k partitions a full frame is a multi-ms inline chunk on
        the shared loop, and unsplit it sits in front of every other
        connection's epoll readiness — the dominant p99 tail driver
        on the replicated bench (groups in one frame are independent,
        so the yield is safe; the multiplexed reply waits for all of
        them either way)."""
        items = rt.decode_multi(payload)
        # placement split: fan sub-batches out to the worker shards
        # that own their groups, re-multiplex replies in order
        if self.shard_forward is not None:
            by_shard: dict[int, list[int]] = {}
            for i, item in enumerate(items):
                gid = struct.unpack_from("<q", item, 6)[0]
                if self._gm.get(int(gid)) is None:
                    shard = self._worker_shard_of(int(gid))
                    if shard > 0:
                        by_shard.setdefault(shard, []).append(i)
            if by_shard:
                return await self._append_batch_split(items, by_shard)
        replies: list[bytes] = []
        for n, item in enumerate(items):
            if n and (n & 7) == 0:
                await asyncio.sleep(0)
            replies.append(await self.append_entries(item))
        return rt.encode_multi(replies)

    async def _append_batch_split(
        self, items: list[bytes], by_shard: dict[int, list[int]]
    ) -> bytes:
        replies: list[bytes | None] = [None] * len(items)
        forwarded = {i for idxs in by_shard.values() for i in idxs}

        async def fwd(shard: int, idxs: list[int]) -> None:
            sub = rt.encode_multi([items[i] for i in idxs])
            try:
                out = rt.decode_multi(
                    await self.shard_forward(
                        shard, rt.APPEND_ENTRIES_BATCH, sub
                    )
                )
                if len(out) != len(idxs):
                    raise ValueError("sub-batch reply count mismatch")
            except Exception:
                logger.exception(
                    "append batch forward to shard %d failed", shard
                )
                # fallback below answers GROUP_UNAVAILABLE per item
                out = [None] * len(idxs)
            for i, rep in zip(idxs, out):
                replies[i] = rep

        async def local() -> None:
            n = 0
            for i, item in enumerate(items):
                if i in forwarded:
                    continue
                if n and (n & 7) == 0:
                    await asyncio.sleep(0)
                n += 1
                replies[i] = await self.append_entries(item)

        await asyncio.gather(
            local(), *(fwd(s, idxs) for s, idxs in by_shard.items())
        )
        out: list[bytes] = []
        for i, rep in enumerate(replies):
            if rep is None:
                req = rt.AppendEntriesRequest.decode(items[i])
                rep = rt.AppendEntriesReply(
                    group=int(req.group),
                    node_id=self._gm.node_id,
                    term=-1,
                    last_dirty_log_index=-1,
                    last_flushed_log_index=-1,
                    seq=int(req.seq),
                    status=rt.AppendEntriesReply.GROUP_UNAVAILABLE,
                ).encode()
            out.append(rep)
        return rt.encode_multi(out)

    @method(rt.INSTALL_SNAPSHOT)
    async def install_snapshot(self, payload: bytes) -> bytes:
        req = rt.InstallSnapshotRequest.decode(payload)
        c = self._consensus(int(req.group))
        if c is None:
            out = await self._maybe_forward(
                int(req.group), rt.INSTALL_SNAPSHOT, payload
            )
            if out is not None:
                return out
            return rt.InstallSnapshotReply(
                group=int(req.group), term=-1, bytes_stored=0, success=False
            ).encode()
        return (await c.handle_install_snapshot(req)).encode()

    @method(rt.TRANSFER_LEADERSHIP)
    async def transfer_leadership(self, payload: bytes) -> bytes:
        """Balancer/operator entry point: this node must currently lead
        the group; it drives the timeout_now handshake to the target."""
        req = rt.TransferLeadershipRequest.decode(payload)
        c = self._consensus(int(req.group))
        if c is None:
            out = await self._maybe_forward(
                int(req.group), rt.TRANSFER_LEADERSHIP, payload
            )
            if out is not None:
                return out
        if c is None or not c.is_leader():
            return rt.TransferLeadershipReply(
                group=int(req.group), success=False, error="not leader here"
            ).encode()
        target = int(req.target)
        if target < 0:
            peers = c.peers()
            if not peers:
                return rt.TransferLeadershipReply(
                    group=int(req.group), success=False, error="no peer"
                ).encode()
            target = peers[0]
        try:
            await c.transfer_leadership(target)
        except Exception as e:
            return rt.TransferLeadershipReply(
                group=int(req.group), success=False, error=str(e)
            ).encode()
        return rt.TransferLeadershipReply(
            group=int(req.group), success=True, error=""
        ).encode()

    @method(rt.TIMEOUT_NOW)
    async def timeout_now(self, payload: bytes) -> bytes:
        req = rt.TimeoutNowRequest.decode(payload)
        c = self._consensus(int(req.group))
        if c is None:
            out = await self._maybe_forward(
                int(req.group), rt.TIMEOUT_NOW, payload
            )
            if out is not None:
                return out
            return rt.TimeoutNowReply(group=int(req.group), term=-1).encode()
        return (await c.handle_timeout_now(req)).encode()
