"""Admin HTTP API (reference: src/v/redpanda/admin_server.{h,cc})."""

from .server import AdminServer

__all__ = ["AdminServer"]
