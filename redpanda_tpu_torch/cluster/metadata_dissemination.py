"""Leadership dissemination to non-replica nodes.

Reference: src/v/cluster/metadata_dissemination_{service,handler}.{h,cc}
(metadata_dissemination_rpc.json) — brokers that host a partition learn
its leader from raft directly; everyone else needs the leader hints
gossiped so their Kafka metadata responses route clients correctly.

Push-based with periodic anti-entropy: each broker batches the
(ntp, term, leader) of every partition it currently leads into ONE
RPC per peer per tick (the heartbeat-batching idiom, SURVEY §2.11 P4),
and receivers keep the highest-term hint per ntp.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING

from ..models.fundamental import NTP
from ..rpc.server import Service, method
from ..utils import serde

if TYPE_CHECKING:  # pragma: no cover
    from ..app import Broker

logger = logging.getLogger("cluster.metadata")

UPDATE_LEADERSHIP = 210


class _LeaderEntry(serde.Envelope):
    SERDE_FIELDS = [
        ("ns", serde.string),
        ("topic", serde.string),
        ("partition", serde.i32),
        ("term", serde.i64),
        ("leader", serde.i32),
    ]


class _LeaderUpdate(serde.Envelope):
    SERDE_FIELDS = [
        ("from_node", serde.i32),
        ("entries", serde.vector(_LeaderEntry.serde())),
    ]


class _Ack(serde.Envelope):
    SERDE_FIELDS = [("ok", serde.boolean)]


class MetadataDisseminationService(Service):
    def __init__(self, dissemination: "MetadataDissemination"):
        self._d = dissemination

    @method(UPDATE_LEADERSHIP)
    async def update_leadership(self, payload: bytes) -> bytes:
        upd = _LeaderUpdate.decode(payload)
        for e in upd.entries:
            self._d.apply_hint(
                NTP(e.ns, e.topic, int(e.partition)),
                int(e.term),
                int(e.leader),
            )
        return _Ack(ok=True).encode()


class MetadataDissemination:
    def __init__(self, broker: "Broker", interval_s: float = 0.2):
        self.broker = broker
        self.interval = interval_s
        self.service = MetadataDisseminationService(self)
        # ntp → (term, leader): highest term wins (stale gossip from a
        # deposed leader must not overwrite the new leader's hint)
        self._hints: dict[NTP, tuple[int, int]] = {}
        self._task: asyncio.Task | None = None
        self._closed = False
        # delta gossip state, PER AUDIENCE (peer node id, plus self):
        # audience → ntp → (term, leader) last delivered. Per-peer so a
        # restarted peer (which lost its in-memory hints) is re-pushed
        # everything as soon as its outage is observed, and one down
        # peer doesn't force re-pushing deltas to every healthy peer.
        self._sent_by_peer: dict[int, dict[NTP, tuple[int, int]]] = {}
        # peer → connection generation at last delivery: a bumped
        # generation means the link was re-established (peer possibly
        # restarted with empty hints) → wipe sent-state, full re-push
        self._peer_gen: dict[int, int] = {}
        self._tick_no = 0
        # steady-state early-out: (registry_epoch, n_partitions) →
        # (ntps, rows) map into the raft SoA, plus last tick's
        # is_leader/term lane snapshots. When the lanes are unchanged
        # and everything was delivered, the tick is two vector
        # compares instead of a 1k-partition Python scan (~670 µs →
        # ~10 µs measured at 1024 partitions).
        self._scan_cache: tuple | None = None
        self._lanes_prev: tuple | None = None
        self._all_delivered = False

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

    def apply_hint(self, ntp: NTP, term: int, leader: int) -> None:
        cur = self._hints.get(ntp)
        if cur is not None and cur[0] > term:
            return
        self._hints[ntp] = (term, leader)
        self.broker.leaders.update(ntp, leader)

    async def _loop(self) -> None:
        while not self._closed:
            try:
                await self._tick()
            except Exception:
                logger.exception("dissemination tick failed")
            await asyncio.sleep(self.interval)

    # full anti-entropy every Nth tick; in between only deltas go out.
    # The reference disseminates leadership UPDATES (queued on change,
    # metadata_dissemination_service.cc) rather than re-gossiping the
    # whole leader table — at 1k partitions the full-table tick was
    # ~18% of the replicated-bench core (encode + 2 peer decodes of
    # ~340 entries, 5 Hz, x3 brokers, all steady-state no-ops).
    FULL_EVERY = 50

    async def _tick(self) -> None:
        self._tick_no += 1
        full = self._tick_no % self.FULL_EVERY == 1
        me = self.broker.node_id
        parts = self.broker.partition_manager.partitions()
        gm = getattr(self.broker, "group_manager", None)
        led: dict[NTP, int]
        if gm is None:
            # unit fixtures without a raft SoA: plain scan
            led = {
                p.ntp: p.consensus.term
                for p in parts.values()
                if p.is_leader
            }
        else:
            # vectorized leadership scan over the raft SoA lanes
            import numpy as np

            key = (gm.registry_epoch, len(parts))
            cache = self._scan_cache
            if cache is None or cache[0] != key:
                plist = list(parts.values())
                rows = np.fromiter(
                    (p.consensus.row for p in plist), np.int64, len(plist)
                )
                self._scan_cache = cache = (key, plist, rows)
                self._lanes_prev = None
            _, plist, rows = cache
            arrays = gm.arrays
            lv = arrays.is_leader[rows]
            tv = arrays.term[rows]
            prev = self._lanes_prev
            if (
                not full
                and self._all_delivered
                and prev is not None
                and np.array_equal(lv, prev[0])
                and np.array_equal(tv, prev[1])
                # membership is part of the steady-state key: a newly
                # joined peer has no connection yet (generation 0 ==
                # the _peer_gen default), and only push() would dial
                # it — without this it would starve until anti-entropy
                and set(self.broker.controller.members)
                == set(self._sent_by_peer) | {me}
                and all(
                    self._peer_gen.get(p, 0) == self._gen_of(p)
                    for p in self.broker.controller.members
                    if p != me
                )
            ):
                return  # steady: nothing changed, everything delivered
            self._lanes_prev = (lv, tv)
            led = {}
            for i in np.flatnonzero(lv):
                p = plist[int(i)]
                led[p.ntp] = int(tv[i])
        members = set(self.broker.controller.members)
        # drop per-peer state for departed peers
        for gone in [a for a in self._sent_by_peer if a not in members]:
            del self._sent_by_peer[gone]
            self._peer_gen.pop(gone, None)

        def delta_for(sent: dict[NTP, tuple[int, int]]) -> list[NTP]:
            # prune unconditionally: deposed/removed partitions must
            # not pin entries (unbounded growth; a deleted-then-
            # recreated topic landing on the same (term, leader) would
            # otherwise be suppressed until the anti-entropy pass)
            for ntp in [n for n in sent if n not in led]:
                del sent[ntp]
            return [
                ntp
                for ntp, term in led.items()
                if full or sent.get(ntp) != (term, me)
            ]

        # a broker is its own gossip audience too: keeps the RAW hints
        # table consistent on the new leader itself. Client-visible
        # metadata is already correct without this (leader_of prefers
        # the hosted partition's consensus view) — this is hygiene for
        # direct `leaders` readers and debugging, not a client fix.
        self_sent = self._sent_by_peer.setdefault(me, {})
        for ntp in delta_for(self_sent):
            self.apply_hint(ntp, led[ntp], me)
            self_sent[ntp] = (led[ntp], me)

        async def push(peer: int) -> bool:
            sent = self._sent_by_peer.setdefault(peer, {})
            gen = self._gen_of(peer)
            if gen != self._peer_gen.get(peer, 0):
                # link re-established since our last delivery: the peer
                # may have restarted and lost its hints — re-push all
                sent.clear()
            ntps = delta_for(sent)
            if not ntps:
                return True
            msg = _LeaderUpdate(
                from_node=me,
                entries=[
                    _LeaderEntry(
                        ns=ntp.ns,
                        topic=ntp.topic,
                        partition=ntp.partition,
                        term=led[ntp],
                        leader=me,
                    )
                    for ntp in ntps
                ],
            ).encode()
            try:
                await self.broker._conn_cache.call(
                    peer, UPDATE_LEADERSHIP, msg, 1.0
                )
            except Exception:
                # peer down or restarting: wipe its sent-state so the
                # whole leadership set is re-pushed once it's back —
                # a restarted peer lost its in-memory hints and must
                # not wait for the FULL_EVERY anti-entropy pass
                sent.clear()
                return False
            for ntp in ntps:
                sent[ntp] = (led[ntp], me)
            # record the PRE-call generation: if the call itself
            # reconnected (peer restarted, lost its hints), only this
            # delta was delivered — the next tick must see the bumped
            # generation and full-re-push. Cost when the reconnect was
            # benign: one redundant full push.
            self._peer_gen[peer] = gen
            return True

        peers = [m for m in members if m != me]
        if peers:
            results = await asyncio.gather(*(push(p) for p in peers))
            self._all_delivered = all(results)
        else:
            self._all_delivered = True

    def _gen_of(self, peer: int) -> int:
        gen_fn = getattr(self.broker._conn_cache, "generation", None)
        return gen_fn(peer) if gen_fn is not None else 0
