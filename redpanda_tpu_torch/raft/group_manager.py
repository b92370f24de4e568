"""Per-node raft group registry (reference: src/v/raft/group_manager.{h,cc}).

Creates/removes consensus instances, owns the shared shard SoA
(ShardGroupArrays), the batched HeartbeatManager, and the RaftService,
and wires peer I/O through a Transport-protocol send function
(connection cache in production, loopback network in fixtures).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from ..storage.kvstore import KvStore
from ..storage.log import Log, LogConfig
from .configuration import GroupConfiguration
from .consensus import Consensus
from .heartbeat_manager import HeartbeatManager
from .service import RaftService
from .shard_state import ShardGroupArrays
from ..utils.tasks import cancel_and_wait


class GroupManager:
    def __init__(
        self,
        node_id: int,
        data_dir: str,
        send: Callable,  # async (node_id, method_id, payload, timeout) -> bytes
        election_timeout_s: float = 0.3,
        heartbeat_interval_s: float = 0.05,
        kvstore: Optional[KvStore] = None,
        metrics=None,
        shard_id: int = 0,
        shard_count: int = 1,
        load_ledger=None,
        device="cuda",
    ):
        self.node_id = node_id
        self.data_dir = data_dir
        # shard-per-core (ssx): which slice of the group-id space this
        # manager may own. The default (0 of 1) owns everything.
        self.shard_id = shard_id
        self.shard_count = shard_count
        os.makedirs(data_dir, exist_ok=True)
        # append RPCs to a peer multiplex into one frame per dispatch
        # window (append_aggregator); all other methods pass through
        from .append_aggregator import AppendAggregator

        self.append_aggregator = AppendAggregator(send)
        # RP_NO_APPEND_AGG=1: measurement knob — raw per-call sends
        self._send = (
            send
            if os.environ.get("RP_NO_APPEND_AGG", "0") == "1"
            else self.append_aggregator.send
        )
        self._election_timeout = election_timeout_s
        self.kvstore = kvstore or KvStore(os.path.join(data_dir, "kvstore"))
        self._owns_kvstore = kvstore is None
        # torch device of the shard's lanes ("cpu" runs the kernels'
        # plain PyTorch versions)
        self.arrays = ShardGroupArrays(device=device)
        # node-wide recovery rate + memory budget shared by all groups
        # (raft/recovery.py; ref recovery_throttle.h, group_manager.h:47)
        from .recovery import RecoveryThrottle

        self.recovery_throttle = RecoveryThrottle()
        # node-level probe shared by every group (raft/probe.cc wires
        # one per partition; the families aggregate the same way)
        from .probe import RaftProbe

        self.probe = RaftProbe(metrics, ledger=load_ledger)
        # shard tick frame: per-reply quorum math from every group
        # batches into one vectorized call per dispatch window
        # (raft/tick_frame.py); the heartbeat fold merges into it too
        from .tick_frame import TickFrame

        self.tick_frame = TickFrame(self.arrays, probe=self.probe)
        self.heartbeat_manager = HeartbeatManager(
            node_id, send, interval_s=heartbeat_interval_s
        )
        self.heartbeat_manager.probe = self.probe
        self.heartbeat_manager.tick_frame = self.tick_frame
        self.service = RaftService(self)
        self._groups: dict[int, Consensus] = {}
        self._by_row: dict[int, Consensus] = {}
        # bumped on every create/remove: lets the heartbeat service
        # cache group->row resolution across ticks
        self.registry_epoch = 0
        self._started = False
        # node-batched election scheduling (see Consensus.try_election):
        # one sweeper task scans the el_* SoA lanes instead of one
        # asyncio timer per group
        self._sweeper_task = None
        self._lag_skips = 0

        self._rows_cache: tuple[int, "object"] | None = None
        self._min_el_timeout = 3600.0

    def get(self, group_id: int) -> Optional[Consensus]:
        return self._groups.get(group_id)

    def groups(self) -> list[Consensus]:
        return list(self._groups.values())

    async def start(self) -> None:
        import asyncio

        self.arrays.prewarm()
        await self.heartbeat_manager.start()
        self._sweeper_task = asyncio.ensure_future(self._election_sweeper())
        self._started = True

    async def stop(self) -> None:
        sweeper, self._sweeper_task = self._sweeper_task, None
        await cancel_and_wait(sweeper)
        # abort the node-wide retry tree FIRST: every group's catch-up
        # backoff / snapshot retry wakes immediately instead of the
        # per-group stop() waiting out jittered sleeps
        self.recovery_throttle.retry_root.abort()
        await self.heartbeat_manager.stop()
        self.tick_frame.close()
        for c in list(self._groups.values()):
            await c.stop()
        if self._owns_kvstore:
            self.kvstore.close()
        self._started = False

    async def _election_sweeper(self) -> None:
        """Node-level election timer: a handful of vector ops over the
        el_* lanes replaces one asyncio timer task per group (the timer
        heap cost ~6% of the core at 3k groups in r4's sampling
        profile). Fires Consensus.try_election when a group's
        randomized deadline expires, re-rolling its jitter and
        rate-limiting to one attempt per timeout."""
        import asyncio
        import random

        import numpy as np

        arrays = self.arrays
        loop = asyncio.get_event_loop()
        while True:
            # adaptive cadence: a quarter of the shortest registered
            # timeout, re-evaluated every wake so a group created with
            # a short timeout right after start isn't stuck behind one
            # long initial sleep
            interval = min(0.05, max(0.005, self._min_el_timeout / 4.0))
            t_sleep = loop.time()
            await asyncio.sleep(interval)
            # loop-lag compensation: if this sweep itself was starved
            # (event loop stalled — GC, inline fsync burst, append
            # backlog), inbound appends/heartbeats were sitting
            # unprocessed in socket buffers, so last_hb staleness is an
            # observer artifact, not peer death. Firing elections off a
            # stalled observation is exactly the storm that tanks the
            # acks=all bench; skip this pass and let the next clean
            # sweep decide.
            lag = loop.time() - t_sleep - interval
            if lag > max(0.25 * self._min_el_timeout, 2.0 * interval):
                # liveness bound: sustained lag must not suppress
                # elections forever — a genuinely dead remote leader
                # still has to be replaced even on a struggling node.
                # Skipping only bursts (< ~1 timeout's worth in a row)
                # filters stall artifacts without capping detection at
                # worse than ~2x the configured timeout.
                self._lag_skips += 1
                if self._lag_skips * interval < self._min_el_timeout:
                    continue
            self._lag_skips = 0
            if not self._groups:
                continue
            cache = self._rows_cache
            if cache is None or cache[0] != self.registry_epoch:
                rows = np.fromiter(
                    (c.row for c in self._groups.values()),
                    np.int64,
                    len(self._groups),
                )
                self._rows_cache = (self.registry_epoch, rows)
            else:
                rows = cache[1]
            now = loop.time()
            to = arrays.el_timeout[rows]
            last_hb = arrays.last_hb[rows]
            if arrays.node_hb:
                # merge node-level SAME stamps — but ONLY onto rows the
                # sender's armed batch actually covers (same_cover_node,
                # written at arm time). Crediting by leader_id alone
                # would let a node that still SAMEs other groups
                # suppress elections for a group it no longer leads.
                cover = arrays.same_cover_node[rows]
                for lid, stamp in arrays.node_hb.items():
                    mask = cover == lid
                    if mask.any():
                        last_hb = np.maximum(
                            last_hb, np.where(mask, stamp, -np.inf)
                        )
            fire = (
                (~arrays.is_leader[rows])
                & (now - last_hb > to * (1.0 + arrays.el_jitter[rows]))
                & (now - arrays.last_el[rows] > to)
            )
            if not fire.any():
                continue
            for i in np.flatnonzero(fire):
                row = int(rows[i])
                c = self._by_row.get(row)
                if c is None or c._closed:
                    continue
                arrays.last_el[row] = now
                arrays.el_jitter[row] = random.random()
                # de-quantize: the sweep grid would otherwise align
                # independent nodes' candidacies into the same instant
                # (split-vote livelock under load) — restore the
                # continuous-time spread per-fire
                c._spawn(self._fire_election(c, random.random() * interval))

    @staticmethod
    async def _fire_election(c: Consensus, delay: float) -> None:
        import asyncio

        await asyncio.sleep(delay)
        await c.try_election()

    def health_report(self, top_k: int = 10) -> dict:
        """Partition-health rollup over this shard's raft lanes: one
        vectorized refresh (ops.health via the selected backend), then
        aggregate counts, the fixed lag distribution, and a top-k laggy
        list resolved row -> group through the registry — never a walk
        over all groups."""
        import numpy as np

        from ..observability.health import lag_histogram

        a = self.arrays
        a.health_refresh()
        rep = a.health_totals()
        lag = a.health_max_lag
        lead = a.is_leader & a.row_active
        rep["lag_histogram"] = lag_histogram(lag[lead])
        top: list[dict] = []
        k = min(top_k, len(lag))
        if k and lead.any():
            idx = np.argpartition(lag, -k)[-k:]
            idx = idx[np.argsort(lag[idx])[::-1]]
            for row in idx:
                row = int(row)
                if lag[row] <= 0:
                    break
                c = self._by_row.get(row)
                if c is None:
                    continue
                top.append(
                    {
                        "key": c.ledger_key,
                        "group": c.group_id,
                        "lag": int(lag[row]),
                        "under_replicated": bool(a.health_under[row]),
                    }
                )
        rep["top_laggy"] = top
        return rep

    async def create_group(
        self,
        group_id: int,
        voters: list[int],
        log: Optional[Log] = None,
        log_config: Optional[LogConfig] = None,
        election_timeout_s: Optional[float] = None,
    ) -> Consensus:
        if group_id in self._groups:
            raise ValueError(f"group {group_id} exists")
        # no shard-ownership assertion here: which shard hosts a group
        # is the PlacementTable's call (placement/table.py), and live
        # moves deliberately land groups away from their hash-home
        if log is None:
            log_dir = os.path.join(self.data_dir, f"group_{group_id}")
            log = Log(log_dir, config=log_config)
        c = Consensus(
            group_id=group_id,
            node_id=self.node_id,
            config=GroupConfiguration.simple(voters),
            log=log,
            kvstore=self.kvstore,
            arrays=self.arrays,
            send=self._send,
            election_timeout_s=election_timeout_s or self._election_timeout,
            recovery_throttle=self.recovery_throttle,
            probe=self.probe,
            tick_frame=self.tick_frame,
        )
        self._groups[group_id] = c
        self._by_row[c.row] = c
        self.tick_frame.register(
            c.row, c.on_batched_commit_advance, group_id=group_id
        )
        self.registry_epoch += 1
        await c.start()
        self._min_el_timeout = min(
            self._min_el_timeout, float(c._election_timeout)
        )
        self.heartbeat_manager.register(c)
        return c

    async def freeze_group(self, group_id: int) -> Consensus:
        """Quiesce a group for a live shard move: stop heartbeating it
        (the peer's SAME covers stay valid — the group just goes silent)
        and freeze the consensus instance. Returns it so the move host
        can read the manifest fields."""
        c = self._groups.get(group_id)
        if c is None:
            raise LookupError(f"group {group_id} not hosted here")
        self.heartbeat_manager.deregister(group_id)
        self.service.invalidate_heartbeat_plans()
        await c.freeze()
        return c

    def thaw_group(self, group_id: int) -> Consensus:
        """Roll back freeze_group after a failed move."""
        c = self._groups.get(group_id)
        if c is None:
            raise LookupError(f"group {group_id} not hosted here")
        c.thaw()
        self.heartbeat_manager.register(c)
        self.service.invalidate_heartbeat_plans()
        return c

    # -- cross-chip lane migration (mesh backend) ----------------------
    def stage_lane(self, group_id: int, dst_chip: int) -> int:
        """Lane evacuate + adopt: copy a FROZEN group's lane row into a
        fresh row inside `dst_chip`'s block. The source row stays
        canonical; the copy is disposable until commit_lane swaps the
        binding (abort_lane frees it with nothing lost). Returns the
        staged row; raises if the chip's block is exhausted (the caller
        rolls back — reserve() a larger capacity first)."""
        c = self._groups.get(group_id)
        if c is None:
            raise LookupError(f"group {group_id} not hosted here")
        dst = self.arrays.alloc_row_on_chip(dst_chip)
        self.arrays.migrate_row(c.row, dst)
        return dst

    def abort_lane(self, dst_row: int) -> None:
        """Roll back stage_lane: drop the disposable copy."""
        self.arrays.free_row(dst_row)

    def commit_lane(self, group_id: int, dst_row: int) -> int:
        """Lane rebind: swap the (still frozen) group onto its staged
        row and retire the source row. Registry, tick-frame callbacks
        and heartbeat plans all re-key atomically under the event loop
        — after this the move is final. Returns the old row."""
        c = self._groups.get(group_id)
        if c is None:
            raise LookupError(f"group {group_id} not hosted here")
        src = c.row
        # re-copy: freeze parks elections/heartbeats but inbound vote
        # lanes can still be touched between stage and commit — the
        # rebind must carry the latest state, not the staged snapshot
        self.arrays.migrate_row(src, dst_row)
        self._by_row.pop(src, None)
        self.tick_frame.deregister(src, group_id=group_id)
        c.row = dst_row
        self._by_row[dst_row] = c
        self.tick_frame.register(
            dst_row, c.on_batched_commit_advance, group_id=group_id
        )
        self.arrays.free_row(src)
        self.registry_epoch += 1
        self.service.invalidate_heartbeat_plans()
        return src

    async def remove_group(self, group_id: int) -> None:
        c = self._groups.pop(group_id, None)
        self.registry_epoch += 1
        self.service.invalidate_heartbeat_plans()
        if c is not None:
            self._by_row.pop(c.row, None)
            self.tick_frame.deregister(c.row, group_id=group_id)
            self.heartbeat_manager.deregister(group_id)
            await c.stop()
            self.arrays.free_row(c.row)


# RP_SAN=1: sweeper-vs-registration rebinds (rows cache, election
# floor, lifecycle flags). No-op when RP_SAN is unset.
from ..utils import rpsan as _rpsan  # noqa: E402

_rpsan.instrument(
    GroupManager,
    ("_rows_cache", "_min_el_timeout", "_started", "registry_epoch"),
)
