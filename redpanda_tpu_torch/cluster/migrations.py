"""One-shot cluster migrations, driven by feature activation.

Reference: src/v/migrations — feature-gated migrators run ONCE per
cluster by the controller leader (e.g. translating cloud-storage
config shapes). Completion is replicated through the controller log
(MigrationDoneCmd), so a migration survives leadership changes without
re-running and a lagging node learns it happened by replay.

A migration is (name, feature, apply): when `feature` is active (the
whole membership supports it) and `name` is not in the replicated
done-set, the leader awaits `apply(controller)` and then replicates
the marker. apply() must be idempotent — a leader crash between apply
and the marker re-runs it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Awaitable, Callable

logger = logging.getLogger("cluster.migrations")


@dataclasses.dataclass(frozen=True)
class Migration:
    name: str
    feature: str
    apply: Callable[..., Awaitable[None]]


_REGISTRY: list[Migration] = []


def register_migration(
    name: str, feature: str, apply: Callable[..., Awaitable[None]]
) -> None:
    if any(m.name == name for m in _REGISTRY):
        raise ValueError(f"duplicate migration {name}")
    _REGISTRY.append(Migration(name, feature, apply))


def registered() -> list[Migration]:
    return list(_REGISTRY)


# -- built-in migrations ----------------------------------------------
async def _offsets_topic_compaction(controller) -> None:
    """Backfill cleanup.policy=compact on __consumer_offsets for
    clusters created before the coordinator set it at creation —
    without compaction the offsets topic grows without bound."""
    from ..kafka.coordinator.group_manager import OFFSETS_TOPIC
    from ..models.fundamental import DEFAULT_NS, TopicNamespace

    md = controller.topic_table.get(TopicNamespace(DEFAULT_NS, OFFSETS_TOPIC))
    if md is None:
        return  # topic not created yet: creation will set it
    if "compact" in (md.config.get("cleanup.policy") or ""):
        return
    await controller.update_topic_config(
        OFFSETS_TOPIC, {"cleanup.policy": "compact"}, []
    )
    logger.info("migration: __consumer_offsets cleanup.policy -> compact")


register_migration(
    "offsets_topic_compaction", "migrations", _offsets_topic_compaction
)
