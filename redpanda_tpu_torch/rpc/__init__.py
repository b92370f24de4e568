"""Internal RPC (reference: src/v/rpc + src/v/net).

Framed request/response protocol with correlation-id multiplexing,
header + payload checksums, an asyncio TCP transport/server pair, a
zero-socket loopback transport for multi-node in-process fixtures
(SURVEY.md §4.2), reconnect with exponential backoff, and a per-node
connection cache.
"""

from .types import FrameHeader, RpcError, Status
from .transport import Transport, TcpTransport, ReconnectTransport
from .server import RpcServer, Service, method
from .loopback import LoopbackNetwork, LoopbackTransport, NemesisSchedule, NetRule
from .connection_cache import ConnectionCache

__all__ = [
    "FrameHeader",
    "RpcError",
    "Status",
    "Transport",
    "TcpTransport",
    "ReconnectTransport",
    "RpcServer",
    "Service",
    "method",
    "LoopbackNetwork",
    "LoopbackTransport",
    "NemesisSchedule",
    "NetRule",
    "ConnectionCache",
]
