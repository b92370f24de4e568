"""Tag-based cluster rendezvous for coordinated upgrades.

Reference: src/v/cluster/feature_barrier.{h,cc} (feature_barrier_state,
finjector/hbadger.h:23-70 documents the tag model) — before taking an
upgrade step that every node must be ready for, a node enters a named
barrier and exchanges "who has entered" state with its peers until it
has seen the whole membership enter. Unlike the registration-time
version check, the barrier confirms nodes are ALIVE and ready at the
moment of the step: a crashed or lagging node blocks it.

Auto-enter hooks let a node answer a barrier it has not explicitly
joined: when an exchange for a tag arrives, registered predicates are
evaluated and, if satisfied, the node enters implicitly. The feature
manager registers a hook for "feature:<name>:<version>" tags that
enters when the local build speaks that version — so followers
participate in activation barriers without their own driver loop.
"""

from __future__ import annotations

import asyncio
import logging
from collections import OrderedDict
from typing import Callable

from ..rpc.server import Service, method
from ..utils import serde

logger = logging.getLogger("cluster.feature_barrier")

FEATURE_BARRIER = 245


class _BarrierMsg(serde.Envelope):
    """Exchange: 'I am `node_id`; for `tag` I know `entered` entered.'
    The reply carries the receiver's merged knowledge back."""

    SERDE_FIELDS = [
        ("tag", serde.string),
        ("node_id", serde.i32),
        ("entered", serde.vector(serde.i32)),
    ]


class FeatureBarrier(Service):
    service_name = "feature_barrier"

    def __init__(
        self,
        node_id: int,
        send: Callable,  # async (node, method, payload, timeout) -> bytes
        members: Callable[[], list[int]],
    ):
        self.node_id = node_id
        self._send = send
        self._members = members
        # tag -> set of node ids known to have entered (LRU-capped)
        self._state: OrderedDict[str, set[int]] = OrderedDict()
        # (prefix, predicate(tag) -> bool) auto-enter hooks
        self._hooks: list[tuple[str, Callable[[str], bool]]] = []

    def register_auto_enter(
        self, prefix: str, predicate: Callable[[str], bool]
    ) -> None:
        self._hooks.append((prefix, predicate))

    def _tag_state(self, tag: str) -> set[int]:
        st = self._state.get(tag)
        if st is None:
            st = self._state[tag] = set()
        self._state.move_to_end(tag)
        while len(self._state) > 64:
            self._state.popitem(last=False)
        return st

    def _maybe_auto_enter(self, tag: str, st: set[int]) -> None:
        if self.node_id in st:
            return
        for prefix, pred in self._hooks:
            if tag.startswith(prefix):
                try:
                    if pred(tag):
                        st.add(self.node_id)
                except Exception:
                    logger.exception("auto-enter hook failed for %s", tag)
                return  # first matching hook decides

    @method(FEATURE_BARRIER)
    async def exchange(self, payload: bytes) -> bytes:
        req = _BarrierMsg.decode(payload)
        st = self._tag_state(str(req.tag))
        st |= set(int(n) for n in req.entered)
        st.add(int(req.node_id))  # the sender has entered by sending
        self._maybe_auto_enter(str(req.tag), st)
        return _BarrierMsg(
            tag=str(req.tag), node_id=self.node_id, entered=sorted(st)
        ).encode()

    async def enter(self, tag: str, timeout: float = 5.0) -> bool:
        """Enter `tag` and exchange with peers until the WHOLE current
        membership has entered. True on rendezvous; False on timeout
        (some member missing/not ready) — callers retry later."""
        st = self._tag_state(tag)
        st.add(self.node_id)
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        while True:
            members = set(self._members())
            if members <= st:
                return True
            remaining = deadline - loop.time()
            if remaining <= 0:
                return False
            msg = _BarrierMsg(
                tag=tag, node_id=self.node_id, entered=sorted(st)
            ).encode()
            # per-send timeout clamped to the remaining budget: a dead
            # peer must not stall the caller past its own timeout
            per_send = min(2.0, remaining)

            async def one(peer: int) -> set[int]:
                try:
                    r = _BarrierMsg.decode(
                        await self._send(peer, FEATURE_BARRIER, msg, per_send)
                    )
                    return set(int(n) for n in r.entered)
                except Exception:
                    return set()

            gathered = await asyncio.gather(
                *(one(p) for p in members - st)
            )
            for got in gathered:
                st |= got
            if members <= st:
                return True
            if loop.time() >= deadline:
                return False
            await asyncio.sleep(0.05)
