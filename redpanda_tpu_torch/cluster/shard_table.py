"""ntp/group → shard lookup (reference: src/v/cluster/shard_table.h:26-46).

The implementation moved to the placement layer (PR 12): the broker's
`shard_table` is now a full `placement.PlacementTable` — same
insert/erase/shard_for/shard_for_group/counts surface this module
always had, plus the placement policy (`assign`), the lane map, and
the live-move rebind (`record_move`). This module stays as the compat
import site so existing callers and fixtures keep working.
"""

from __future__ import annotations

from ..placement.table import PlacementTable as ShardTable

__all__ = ["ShardTable"]
