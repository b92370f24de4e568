"""Per-node client connection cache
(reference: src/v/rpc/connection_cache.{h,cc}).

Maps node_id → ReconnectTransport; raft and cluster clients route all
peer calls through it. A factory callback supplies the transport for a
node (TCP in production, loopback in fixtures), mirroring how the
reference resolves broker addresses from members_table.
"""

from __future__ import annotations

from typing import Callable

from .transport import ReconnectTransport


class ConnectionCache:
    def __init__(self, transport_factory: Callable[[int], object]):
        """transport_factory(node_id) -> unconnected transport."""
        self._factory = transport_factory
        self._conns: dict[int, ReconnectTransport] = {}

    def get(self, node_id: int) -> ReconnectTransport:
        conn = self._conns.get(node_id)
        if conn is None:
            conn = ReconnectTransport(lambda nid=node_id: self._factory(nid))
            self._conns[node_id] = conn
        return conn

    def remove(self, node_id: int) -> None:
        self._conns.pop(node_id, None)

    def generation(self, node_id: int) -> int:
        """Reconnect count for the node's link (0 = never connected).
        A change between observations means the link was re-established
        — the peer may have restarted and lost in-memory state."""
        conn = self._conns.get(node_id)
        return conn.generation if conn is not None else 0

    async def call(
        self,
        node_id: int,
        method_id: int,
        payload: bytes,
        timeout: float | None = None,
    ) -> bytes:
        return await self.get(node_id).call(method_id, payload, timeout)

    async def close(self) -> None:
        for conn in self._conns.values():
            await conn.close()
        self._conns.clear()
