"""ssx: shard-per-core runtime (seastar `ss::sharded<T>` / smp analog).

The only package allowed to fork worker processes (rplint RPL009);
everything above it talks to shards through `invoke_on` with serde
envelope payloads.
"""

from .procnemesis import ForkFailInjected, ProcRule, ProcSchedule
from .shards import (
    InvokeError,
    InvokeReply,
    InvokeRequest,
    ShardChannel,
    ShardContext,
    ShardRuntime,
    bind_reuse_port,
    pin_to_core,
    reserve_reuse_port,
    standdown_reason,
)

__all__ = [
    "ForkFailInjected",
    "InvokeError",
    "InvokeReply",
    "InvokeRequest",
    "ProcRule",
    "ProcSchedule",
    "ShardChannel",
    "ShardContext",
    "ShardRuntime",
    "bind_reuse_port",
    "pin_to_core",
    "reserve_reuse_port",
    "standdown_reason",
]
