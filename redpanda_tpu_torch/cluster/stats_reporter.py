"""Cluster stats reporter (metrics_reporter analog).

Reference: src/v/cluster/metrics_reporter.cc periodically aggregates
cluster-level stats on the controller leader and phones them home.
This environment has zero egress, so the report goes to the log and
the admin API (GET /v1/cluster/stats) instead — same aggregation,
operator-facing sink.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..utils.tasks import cancel_and_wait
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from ..app import Broker

logger = logging.getLogger("cluster.stats")


class StatsReporter:
    def __init__(self, broker: "Broker", interval_s: float = 900.0):
        self.broker = broker
        self.interval_s = interval_s
        self._task: asyncio.Task | None = None
        self._started_at = time.time()

    def report(self) -> dict:
        """Aggregate this node's view of the cluster (the leader's is
        authoritative; every node can answer for its local slice)."""
        c = self.broker.controller
        topics = c.topic_table.topics()
        partitions = sum(md.partition_count for md in topics.values())
        local = self.broker.partition_manager.partitions()
        local_leaders = sum(1 for p in local.values() if p.is_leader)
        local_bytes = sum(p.log.size_bytes() for p in local.values())
        health = None
        try:
            rep = self.broker.health_monitor.report()
            health = {
                "nodes_down": rep.nodes_down,
                "leaderless_partitions": rep.leaderless_partitions,
            }
        except Exception:
            pass
        # live partition-health plane (this shard's raft lanes + load
        # ledger) — cheap: one vectorized refresh behind a 0.25s cache
        try:
            live = self.broker.health_sampler.report()
            if health is None:
                health = {}
            health.update(
                {
                    "max_follower_lag": live["max_follower_lag"],
                    "under_replicated": live["under_replicated"],
                    "load_skew": live["skew"],
                }
            )
        except Exception:
            pass
        # shard-per-core liveness: until PR 6 this report silently
        # described only the parent process even under --shards N
        router = getattr(self.broker, "shard_router", None)
        if router is not None:
            shards = router.liveness()
        else:
            shards = {
                "n_shards": 1,
                "alive": {},
                "cores": {},
                "crashed": {},
                "restarts": 0,
                "failed": False,
            }
        return {
            "node_id": self.broker.node_id,
            "is_controller_leader": c.is_leader,
            "uptime_s": round(time.time() - self._started_at, 1),
            "cluster_version": c.features.cluster_version,
            "members": len(c.members_table.node_ids()),
            "topics": len(topics),
            "partitions": partitions,
            "local_replicas": len(local),
            "local_leaders": local_leaders,
            "local_log_bytes": local_bytes,
            "migrations_done": sorted(c.migrations_done),
            "shards": shards,
            "health": health,
        }

    async def start(self) -> None:
        if self.interval_s > 0:
            self._task = asyncio.ensure_future(self._loop())

    async def stop(self) -> None:
        task, self._task = self._task, None
        await cancel_and_wait(task)

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                if self.broker.controller.is_leader:
                    logger.info("cluster stats: %s", self.report())
            except Exception:
                logger.exception("stats report failed")
