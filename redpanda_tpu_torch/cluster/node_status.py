"""Node liveness (reference: src/v/cluster/node_status_backend.{h,cc},
node_status_rpc.json).

Every broker periodically pings every other known member over the
internal RPC and records the last successful round-trip. Liveness is a
LOCAL observation (each node has its own view), exactly like the
reference — the health monitor aggregates it, it is never replicated.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable

from ..rpc.server import Service, method
from ..utils import serde
from ..utils.tasks import cancel_and_wait

logger = logging.getLogger("cluster.node_status")

NODE_PING = 230


class _Ping(serde.Envelope):
    SERDE_FIELDS = [("node_id", serde.i32)]


class _Pong(serde.Envelope):
    SERDE_FIELDS = [("node_id", serde.i32)]


class NodeStatusService(Service):
    def __init__(self, node_id: int):
        self._node_id = node_id

    @method(NODE_PING)
    async def ping(self, payload: bytes) -> bytes:
        _Ping.decode(payload)  # sender id unused; decode validates
        return _Pong(node_id=self._node_id).encode()


class NodeStatusBackend:
    """Ping fan-out + last-seen table (node_status_backend.cc:121
    periodic tick). `peers` is a callable so membership changes are
    picked up without rewiring."""

    def __init__(
        self,
        node_id: int,
        send: Callable,  # async (node, method, payload, timeout) -> bytes
        peers: Callable[[], list[int]],
        interval_s: float = 0.5,
    ):
        self.node_id = node_id
        self._send = send
        self._peers = peers
        self.interval_s = interval_s
        # node_id → monotonic time of last successful pong
        self.last_seen: dict[int, float] = {}
        self._task: asyncio.Task | None = None

    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._loop())

    async def stop(self) -> None:
        task, self._task = self._task, None
        await cancel_and_wait(task)

    async def _loop(self) -> None:
        req = _Ping(node_id=self.node_id).encode()
        while True:
            peers = [p for p in self._peers() if p != self.node_id]
            await asyncio.gather(*(self._ping(p, req) for p in peers))
            await asyncio.sleep(self.interval_s)

    async def _ping(self, peer: int, req: bytes) -> None:
        try:
            raw = await self._send(
                peer, NODE_PING, req, max(self.interval_s, 0.2)
            )
            _Pong.decode(raw)
            self.last_seen[peer] = asyncio.get_event_loop().time()
        except Exception:
            pass  # missed ping: liveness decays via last_seen age

    def is_alive(self, node_id: int) -> bool:
        """A node is alive when a pong arrived within 3 intervals
        (node_status_table.h is_alive threshold analog). Self is
        trivially alive."""
        if node_id == self.node_id:
            return True
        seen = self.last_seen.get(node_id)
        if seen is None:
            return False
        now = asyncio.get_event_loop().time()
        return now - seen < 3 * self.interval_s
