"""Admin HTTP server.

Reference: src/v/redpanda/admin_server.cc (71 routes over seastar
httpd). Sits on the shared asyncio HTTP base (redpanda_tpu.httpd),
exposing the operational surface the implemented subsystems have:
cluster health, brokers, topics/partitions, leadership transfer,
membership (decommission/recommission), SCRAM users, replicated
cluster config, fault injection (hbadger), and Prometheus /metrics.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Optional

from ..httpd import HttpError, HttpServer
from ..resource_mgmt import MemoryGovernor

if TYPE_CHECKING:  # pragma: no cover
    from ..app import Broker

logger = logging.getLogger("admin")


class AdminServer(HttpServer):
    def __init__(self, broker: "Broker", host: str = "127.0.0.1", port: int = 0):
        self.broker = broker
        # per-logger generation counters for expiring level overrides
        self._log_level_gen: dict[str, int] = {}
        super().__init__(host, port)

    async def start(self) -> None:
        if self.host not in ("127.0.0.1", "localhost", "::1"):
            # the admin surface is UNAUTHENTICATED (user creation,
            # decommission, fault injection): widening the bind beyond
            # loopback hands those to the network even when the Kafka
            # listener enforces SASL
            logger.warning(
                "admin API bound to %s WITHOUT authentication — "
                "anyone reaching it can mint SCRAM users and "
                "decommission nodes",
                self.host,
            )
        await super().start()

    _json_body = staticmethod(HttpServer.json_body)

    # -- routes --------------------------------------------------------
    def _install_routes(self) -> None:
        r = self.route
        r("GET", r"/v1/status/ready", self._ready)
        r("GET", r"/v1/brokers", self._brokers)
        r("POST", r"/v1/brokers/(\d+)/decommission", self._decommission)
        r("POST", r"/v1/brokers/(\d+)/recommission", self._recommission)
        r("PUT", r"/v1/brokers/(\d+)/maintenance", self._maintenance_on)
        r("DELETE", r"/v1/brokers/(\d+)/maintenance", self._maintenance_off)
        r("GET", r"/v1/cluster/health_overview", self._health)
        r("GET", r"/v1/cluster/partition_health", self._partition_health)
        r("GET", r"/v1/cluster/stats", self._cluster_stats)
        r("GET", r"/v1/cluster_config", self._get_config)
        r("PUT", r"/v1/cluster_config", self._put_config)
        r("GET", r"/v1/cluster_config/schema", self._config_schema)
        r("GET", r"/v1/topics", self._list_topics)
        r("POST", r"/v1/topics", self._create_topic)
        r("GET", r"/v1/topics/([^/]+)", self._get_topic)
        r("DELETE", r"/v1/topics/([^/]+)", self._delete_topic)
        r(
            "GET",
            r"/v1/partitions/([^/]+)/([^/]+)/(\d+)",
            self._get_partition,
        )
        r(
            "POST",
            r"/v1/partitions/([^/]+)/([^/]+)/(\d+)/transfer_leadership",
            self._transfer_leadership,
        )
        r(
            "POST",
            r"/v1/partitions/([^/]+)/([^/]+)/(\d+)/move_replicas",
            self._move_replicas,
        )
        r("PUT", r"/v1/security/users", self._create_user)
        r("DELETE", r"/v1/security/users/([^/]+)", self._delete_user)
        r("POST", r"/v1/debug/fault_injection", self._fault_injection)
        r("DELETE", r"/v1/debug/fault_injection", self._fault_clear)
        r("GET", r"/v1/cluster/uuid", self._cluster_uuid)
        r("POST", r"/v1/debug/self_test", self._self_test)
        r("POST", r"/v1/debug/self_test/start", self._self_test_start)
        r("POST", r"/v1/debug/self_test/stop", self._self_test_stop)
        r("GET", r"/v1/debug/self_test/status", self._self_test_status)
        r("GET", r"/v1/debug/scheduler", self._scheduler_stats)
        r("GET", r"/v1/transforms", self._transforms)
        r("GET", r"/v1/features", self._features)
        r("GET", r"/v1/loggers", self._get_loggers)
        r("PUT", r"/v1/loggers/([\w.\-]+)", self._set_log_level)
        # -- r3 additions toward admin_server.cc route parity ----------
        r("GET", r"/v1/usage", self._usage)
        r("GET", r"/v1/brokers/(\d+)", self._broker_detail)
        r("GET", r"/v1/node_config", self._node_config)
        r("GET", r"/v1/raft/(\d+)/status", self._raft_status)
        r("GET", r"/v1/transactions", self._transactions)
        r("GET", r"/v1/partitions", self._list_partitions)
        r("GET", r"/v1/cluster/partition_balancer/status",
          self._balancer_status)
        r("POST", r"/v1/cluster/partition_balancer/cancel",
          self._balancer_cancel)
        r("GET", r"/v1/raft/recovery/status", self._recovery_status)
        r("GET", r"/v1/debug/blocked_reactor", self._blocked_reactor)
        r("GET", r"/v1/debug/traces", self._debug_traces)
        r("GET", r"/v1/debug/probes", self._debug_probes)
        r("POST", r"/v1/debug/cpu_profiler", self._cpu_profile)
        r("GET", r"/v1/shadow_indexing/manifest/([^/]+)/(\d+)",
          self._si_manifest)
        r("GET", r"/v1/cloud_storage/status/([^/]+)/(\d+)",
          self._cloud_status)
        r("GET", r"/metrics", self._metrics)
        r("GET", r"/v1/shards/(\d+)/metrics", self._shard_metrics)
        # -- flight-data plane -----------------------------------------
        r("GET", r"/v1/metrics/history", self._metrics_history)
        r("GET", r"/v1/alerts", self._alerts)
        r("GET", r"/v1/debug/profile", self._debug_profile)
        r("GET", r"/v1/devplane", self._devplane)
        # -- placement layer -------------------------------------------
        r("GET", r"/v1/placement", self._placement)
        r(
            "POST",
            r"/v1/placement/move/([^/]+)/([^/]+)/(\d+)",
            self._placement_move,
        )
        r("POST", r"/v1/placement/rebalance", self._placement_rebalance)
        # -- elastic shard lifecycle -----------------------------------
        r("GET", r"/v1/shards", self._shards)
        r("GET", r"/v1/shards/(\d+)", self._shard_detail)
        r("POST", r"/v1/shards/grow", self._shard_grow)
        r("POST", r"/v1/shards/(\d+)/retire", self._shard_retire)
        # -- r4 additions toward admin_server.cc route parity ----------
        r(
            "POST",
            r"/v1/partitions/([^/]+)/([^/]+)/(\d+)/replicas",
            self._move_replicas,  # reference-shaped alias of move
        )
        r("GET", r"/v1/partitions/local_summary", self._partitions_summary)
        r("GET", r"/v1/partitions/reconfigurations", self._reconfigurations)
        r("GET", r"/v1/partitions/([^/]+)/([^/]+)", self._topic_partitions)
        r(
            "POST",
            r"/v1/partitions/([^/]+)/([^/]+)/(\d+)/cancel_reconfiguration",
            self._cancel_reconfiguration,
        )
        r(
            "POST",
            r"/v1/partitions/([^/]+)/([^/]+)/(\d+)"
            r"/unclean_abort_reconfiguration",
            self._cancel_reconfiguration,  # no separate force path: the
            # cancel restores the previous set either way
        )
        r(
            "POST",
            r"/v1/cluster/cancel_reconfigurations",
            self._cancel_all_reconfigurations,
        )
        r(
            "POST",
            r"/v1/brokers/(\d+)/cancel_partition_moves",
            self._cancel_broker_moves,
        )
        r("POST", r"/v1/partitions/rebalance", self._rebalance)
        r("GET", r"/v1/cluster_config/status", self._config_status)
        r("GET", r"/v1/cluster_view", self._cluster_view)
        r("GET", r"/v1/debug/controller_status", self._controller_status)
        r("GET", r"/v1/debug/is_node_isolated", self._is_node_isolated)
        r(
            "GET",
            r"/v1/debug/partition_leaders_table",
            self._leaders_table,
        )
        r("GET", r"/v1/debug/peer_status/(\d+)", self._peer_status)
        r("POST", r"/v1/debug/reset_leaders", self._reset_leaders)
        r("GET", r"/v1/debug/cloud_storage_usage", self._cloud_usage)
        r("GET", r"/v1/maintenance", self._local_maintenance)
        r("PUT", r"/v1/features/license", self._put_license)
        r("GET", r"/v1/features/license", self._get_license)
        r("PUT", r"/v1/features/([\w]+)", self._put_feature)
        r(
            "GET",
            r"/v1/cloud_storage/manifest/([^/]+)/(\d+)",
            self._si_manifest,  # reference-shaped alias
        )
        r(
            "POST",
            r"/v1/cloud_storage/automated_recovery",
            self._automated_recovery,
        )
        r(
            "POST",
            r"/v1/cloud_storage/sync_local_state/([^/]+)/(\d+)",
            self._sync_local_state,
        )
        r(
            "POST",
            r"/v1/debug/refresh_disk_health_info",
            self._refresh_disk_health,
        )
        r(
            "GET",
            r"/v1/debug/blocked_reactor_notify_ms",
            self._get_blocked_reactor_ms,
        )
        r(
            "PUT",
            r"/v1/debug/blocked_reactor_notify_ms",
            self._put_blocked_reactor_ms,
        )
        r("POST", r"/v1/debug/restart_service", self._restart_service)

    async def _ready(self, _m, _q, _b):
        return {"status": "ready" if self.broker._started else "booting"}

    async def _brokers(self, _m, _q, _b):
        ctrl = self.broker.controller
        out = []
        for nid in ctrl.members_table.node_ids():
            ep = ctrl.members_table.get(nid)
            out.append(
                {
                    "node_id": nid,
                    "membership_status": (
                        ep.state.value if ep is not None else "unregistered"
                    ),
                    "is_alive": self.broker.node_status.is_alive(nid),
                    "internal_rpc": list(ep.rpc_addr) if ep else None,
                    "kafka_api": list(ep.kafka_addr) if ep else None,
                    "rack": (ep.rack or None) if ep else None,
                }
            )
        return {"brokers": out, "controller_id": ctrl.leader_id}

    async def _decommission(self, m, _q, _b):
        from ..cluster.controller import TopicError

        try:
            await self.broker.controller.decommission_node(int(m.group(1)))
        except TopicError as e:
            raise HttpError(400, e.message) from None
        return None

    async def _recommission(self, m, _q, _b):
        await self.broker.controller.recommission_node(int(m.group(1)))
        return None

    async def _set_maintenance(self, m, on: bool):
        from ..cluster.controller import TopicError

        try:
            await self.broker.controller.set_maintenance(int(m.group(1)), on)
        except TopicError as e:
            raise HttpError(400, e.message) from None
        return None

    async def _maintenance_on(self, m, _q, _b):
        return await self._set_maintenance(m, True)

    async def _maintenance_off(self, m, _q, _b):
        return await self._set_maintenance(m, False)

    async def _local_health_reports(self, top_k: int = 10) -> list[dict]:
        """This node's per-shard partition-health reports: the local
        shard's live ledger plus every worker shard over invoke_on.
        Unreachable workers are skipped (and counted like a failed
        fleet scrape) rather than failing the endpoint."""
        from ..observability import health as _health

        local = _health.build_report(
            self.broker.group_manager,
            self.broker.load_ledger,
            top_k=top_k,
            storage=getattr(self.broker, "storage", None),
        )
        for row in local["top_laggy"]:
            row["shard"] = 0
        for row in local["top_hot"]:
            row["shard"] = 0
        reports = [local]
        router = getattr(self.broker, "shard_router", None)
        if router is not None:
            from ..ssx.shards import InvokeError

            for sid in router.worker_shards():
                try:
                    reports.append(await router.obs_health(sid))
                except InvokeError:
                    self.broker.metrics.counter(
                        "fleet_scrape_errors_total",
                        "worker shard snapshots that failed during a "
                        "fleet scrape",
                    ).inc(shard=str(sid))
        return reports

    async def _health(self, _m, _q, _b):
        # node/membership view still comes from the health monitor, but
        # the partition counts are derived from the live raft health
        # lanes (leaderless/under-replicated within one tick frame)
        # rather than the thin controller snapshot. Additive keys only:
        # the pre-existing schema is unchanged.
        from ..observability.health import merge_reports

        rep = self.broker.health_monitor.report()
        live = merge_reports(await self._local_health_reports())
        # burn-rate alert state rides along (additive keys): a health
        # poller sees "SLO burning" without a second request
        alerts_mgr = getattr(self.broker, "alerts", None)
        alert_keys = (
            alerts_mgr.overview()
            if alerts_mgr is not None
            else {"alerts_firing": 0, "alerts": []}
        )
        return {
            **alert_keys,
            "controller_id": rep.controller_id,
            "all_nodes": [n.node_id for n in rep.nodes],
            "nodes_down": rep.nodes_down,
            "leaderless_partitions": live["leaderless"],
            "under_replicated_partitions": live["under_replicated"],
            "max_follower_lag": live["max_follower_lag"],
            "active_partitions": live["active"],
            "nodes": [
                {
                    "node_id": n.node_id,
                    "is_alive": n.is_alive,
                    "membership": n.membership,
                }
                for n in rep.nodes
            ],
        }

    async def _partition_health(self, _m, q, _b):
        """Bounded partition-health detail: merged per-shard reports —
        aggregate counters, top-k laggy/hot partitions, the fixed lag
        distribution, and the shard skew index."""
        from ..observability.health import lag_bucket_edges, merge_reports

        try:
            top_k = max(1, min(100, int(q.get("top_k", 10) or 10)))
        except ValueError:
            raise HttpError(
                400, f"bad top_k {q.get('top_k')!r}"
            ) from None
        merged = merge_reports(
            await self._local_health_reports(top_k), top_k=top_k
        )
        merged["node_id"] = self.broker.node_id
        merged["lag_bucket_edges"] = lag_bucket_edges()
        return merged

    async def _get_config(self, _m, _q, _b):
        cfg = self.broker.controller.cluster_config
        return {
            "version": cfg.version,
            "values": cfg.snapshot(),
        }

    async def _config_schema(self, _m, _q, _b):
        cfg = self.broker.controller.cluster_config
        return {
            name: {
                "type": p.type,
                "default": p.default,
                "description": p.description,
                "needs_restart": p.needs_restart,
            }
            for name, p in cfg.properties().items()
        }

    async def _put_config(self, _m, _q, body):
        from ..cluster.controller import TopicError

        payload = self._json_body(body)
        upserts = {
            str(k): str(v) for k, v in (payload.get("upsert") or {}).items()
        }
        removes = [str(k) for k in (payload.get("remove") or [])]
        try:
            await self.broker.controller.set_cluster_config(upserts, removes)
        except TopicError as e:
            raise HttpError(400, e.message) from None
        return {"version": self.broker.controller.cluster_config.version}

    async def _list_topics(self, _m, _q, _b):
        table = self.broker.controller.topic_table
        return {
            "topics": [
                {
                    "ns": tp.ns,
                    "topic": tp.topic,
                    "partition_count": md.partition_count,
                    "replication_factor": md.replication_factor,
                }
                for tp, md in table.topics().items()
            ]
        }

    async def _create_topic(self, _m, _q, body):
        from ..cluster.controller import TopicError

        payload = self._json_body(body)
        name = payload.get("name")
        if not name:
            raise HttpError(400, "missing topic name")
        try:
            await self.broker.controller.create_topic(
                str(name),
                partitions=int(payload.get("partitions", 1)),
                replication_factor=int(payload.get("replication_factor", 1)),
                config={
                    str(k): (None if v is None else str(v))
                    for k, v in (payload.get("configs") or {}).items()
                },
            )
        except TopicError as e:
            raise HttpError(400, f"{e.code}: {e.message}") from None
        return {"name": name}

    def _topic_md(self, topic: str):
        from ..models.fundamental import DEFAULT_NS, TopicNamespace

        md = self.broker.controller.topic_table.get(
            TopicNamespace(DEFAULT_NS, topic)
        )
        if md is None:
            raise HttpError(404, f"no such topic {topic}")
        return md

    async def _get_topic(self, m, _q, _b):
        md = self._topic_md(m.group(1))
        return {
            "topic": m.group(1),
            "partition_count": md.partition_count,
            "replication_factor": md.replication_factor,
            "config": md.config,
            "partitions": [
                {
                    "partition": a.partition,
                    "group": a.group,
                    "replicas": a.replicas,
                }
                for a in md.assignments.values()
            ],
        }

    async def _delete_topic(self, m, _q, _b):
        from ..cluster.controller import TopicError

        try:
            await self.broker.controller.delete_topic(m.group(1))
        except TopicError as e:
            status = 404 if e.code == "unknown_topic_or_partition" else 400
            raise HttpError(status, e.message) from None
        return None

    def _partition(self, ns: str, topic: str, pid: int):
        from ..models.fundamental import NTP

        p = self.broker.partition_manager.get(NTP(ns, topic, pid))
        if p is None:
            raise HttpError(404, f"{ns}/{topic}/{pid} not hosted here")
        return p

    async def _get_partition(self, m, _q, _b):
        ns, topic, pid = m.group(1), m.group(2), int(m.group(3))
        from ..models.fundamental import NTP, TopicNamespace

        md = self.broker.controller.topic_table.get(TopicNamespace(ns, topic))
        if md is None or pid not in md.assignments:
            raise HttpError(404, f"no such partition {ns}/{topic}/{pid}")
        a = md.assignments[pid]
        ntp = NTP(ns, topic, pid)
        local = self.broker.partition_manager.get(ntp)
        out = {
            "ns": ns,
            "topic": topic,
            "partition": pid,
            "group": a.group,
            "replicas": a.replicas,
            "leader": self.broker.metadata_cache.leader_of(ntp),
        }
        if local is not None:
            out.update(
                {
                    "high_watermark": local.high_watermark(),
                    "last_stable_offset": local.last_stable_offset(),
                    "start_offset": local.start_offset(),
                    "term": local.consensus.term,
                    "is_leader": local.is_leader,
                }
            )
        return out

    async def _transfer_leadership(self, m, q, _b):
        ns, topic, pid = m.group(1), m.group(2), int(m.group(3))
        p = self._partition(ns, topic, pid)
        if not p.consensus.is_leader():
            raise HttpError(
                409, f"this node is not the leader (try {p.consensus.leader_id})"
            )
        target = q.get("target")
        if target is None:
            peers = p.consensus.peers()
            if not peers:
                raise HttpError(400, "no peer to transfer to")
            target = peers[0]
        try:
            await p.consensus.transfer_leadership(int(target))
        except Exception as e:
            raise HttpError(400, str(e)) from None
        return None

    async def _move_replicas(self, m, _q, body):
        from ..cluster.controller import TopicError

        ns, topic, pid = m.group(1), m.group(2), int(m.group(3))
        payload = self._json_body(body)
        replicas = payload.get("replicas")
        if not isinstance(replicas, list):
            raise HttpError(400, "body must carry a replicas list")
        try:
            await self.broker.controller.move_partition_replicas(
                topic, pid, [int(r) for r in replicas], ns=ns
            )
        except TopicError as e:
            raise HttpError(400, f"{e.code}: {e.message}") from None
        return None

    async def _create_user(self, _m, _q, body):
        from ..security.scram import encode_credential, make_credential

        payload = self._json_body(body)
        user = payload.get("username")
        password = payload.get("password")
        if not user or not password:
            raise HttpError(400, "username and password required")
        mech = payload.get("algorithm", "SCRAM-SHA-256")
        await self.broker.controller.create_user(
            str(user), encode_credential(make_credential(str(password), mech))
        )
        return None

    async def _delete_user(self, m, _q, _b):
        from ..cluster.controller import TopicError

        try:
            await self.broker.controller.delete_user(m.group(1))
        except TopicError as e:
            raise HttpError(404, e.message) from None
        return None

    async def _fault_injection(self, _m, _q, body):
        from ..utils.hbadger import Probe, honey_badger

        payload = self._json_body(body)
        module = payload.get("module")
        point = payload.get("point", "")
        if not module:
            raise HttpError(400, "module required")
        exc = None
        if payload.get("fail"):
            exc = ConnectionError("hbadger injected failure")
        count = payload.get("count")
        honey_badger.arm(
            str(module),
            str(point),
            Probe(
                delay_s=float(payload.get("delay_s", 0.0)),
                exception=exc,
                count=int(count) if count is not None else None,
            ),
        )
        return None

    async def _fault_clear(self, _m, _q, _b):
        from ..utils.hbadger import honey_badger

        honey_badger.clear()
        return None

    async def _cluster_uuid(self, _m, _q, _b):
        """Cluster UUID from genesis (bootstrap_backend; GET
        /v1/cluster/uuid). Empty until the first leader bootstraps."""
        return {"cluster_uuid": self.broker.controller.cluster_uuid}

    async def _self_test_start(self, _m, _q, body):
        """Start the distributed self-test on every member (reference
        cluster/self_test_frontend — POST /v1/debug/self_test/start)."""
        payload = self._json_body(body)
        return await self.broker.self_test.start(
            disk_mb=max(1, min(int(payload.get("disk_mb", 16)), 256)),
            net_mb=max(1, min(int(payload.get("net_mb", 8)), 256)),
            nodes=payload.get("nodes"),
        )

    async def _self_test_stop(self, _m, _q, _body):
        return await self.broker.self_test.stop()

    async def _self_test_status(self, _m, _q, _body):
        return await self.broker.self_test.status()

    async def _self_test(self, _m, _q, body):
        """Synchronous LOCAL disk+network probe on this node (the
        original single-node form of cluster/self_test). Delegates to
        the same SelfTestBackend checks the distributed path runs, so
        there is one implementation of each benchmark."""
        import asyncio

        payload = self._json_body(body)
        size_mb = max(1, min(int(payload.get("disk_mb", 16)), 256))
        net_mb = max(1, min(int(payload.get("net_mb", 1)), 256))
        backend = self.broker.self_test_backend
        loop = asyncio.get_event_loop()
        results: dict = {"node_id": self.broker.node_id}
        results["disk"] = await loop.run_in_executor(
            None, backend._diskcheck, size_mb
        )
        peers = [
            p
            for p in self.broker.controller.members
            if p != self.broker.node_id
        ]
        probes = await asyncio.gather(
            *(backend._netcheck_peer(p, net_mb) for p in peers)
        )
        results["network"] = {str(p): r for p, r in zip(peers, probes)}
        return results

    async def _features(self, _m, _q, _b):
        return self.broker.controller.features.snapshot()

    async def _get_loggers(self, _m, _q, _b):
        """Logger names + effective levels (admin loggers API analog:
        the reference sets per-logger levels at runtime)."""
        out = {"root": logging.getLevelName(logging.getLogger().getEffectiveLevel())}
        for name in sorted(logging.Logger.manager.loggerDict):
            lg = logging.getLogger(name)
            out[name] = logging.getLevelName(lg.getEffectiveLevel())
        return out

    async def _set_log_level(self, m, q, _b):
        """PUT /v1/loggers/<name>?level=debug[&expires_s=30] — set a
        logger's level at runtime, optionally reverting after
        expires_s (reference: admin_server.cc set_log_level with
        expiry)."""
        name = m.group(1)
        level_name = (q.get("level") or "").upper()
        level = logging.getLevelNamesMapping().get(level_name)
        if level is None:
            raise HttpError(400, f"unknown level {q.get('level')!r}")
        try:
            expires_s = float(q.get("expires_s", 0) or 0)
        except ValueError:
            raise HttpError(400, f"bad expires_s {q.get('expires_s')!r}") from None
        lg = logging.getLogger(None if name == "root" else name)
        previous = lg.level
        lg.setLevel(level)
        # generation guard: a later PUT on the same logger invalidates
        # any in-flight expiry revert (otherwise a stale timer clobbers
        # the newer setting)
        gen = self._log_level_gen.get(name, 0) + 1
        self._log_level_gen[name] = gen
        if expires_s > 0:
            def revert(lg=lg, previous=previous, name=name, gen=gen):
                if self._log_level_gen.get(name) == gen:
                    lg.setLevel(previous)

            asyncio.get_event_loop().call_later(expires_s, revert)
        return {
            "logger": name,
            "level": level_name,
            "expires_s": expires_s or None,
        }

    async def _cluster_stats(self, _m, _q, _b):
        """Aggregated cluster/node stats (metrics_reporter analog)."""
        return self.broker.stats_reporter.report()

    # -- r3 additions toward admin_server.cc route parity --------------
    async def _broker_detail(self, m, _q, _b):
        """Single-broker view (admin_server.cc get_broker)."""
        nid = int(m.group(1))
        ctrl = self.broker.controller
        ep = ctrl.members_table.get(nid)
        if ep is None and nid not in ctrl.members_table:
            raise HttpError(404, f"unknown broker {nid}")
        leads = sum(
            1
            for p in self.broker.partition_manager.partitions().values()
            if p.is_leader
        ) if nid == self.broker.node_id else None
        return {
            "node_id": nid,
            "membership_status": ep.state.value if ep else "unregistered",
            "is_alive": self.broker.node_status.is_alive(nid),
            "internal_rpc": list(ep.rpc_addr) if ep else None,
            "kafka_api": list(ep.kafka_addr) if ep else None,
            "rack": (ep.rack or None) if ep else None,
            "logical_version": ep.logical_version if ep else None,
            "local_leaderships": leads,
        }

    async def _node_config(self, _m, _q, _b):
        """This node's effective BrokerConfig (node_config admin view);
        secret-bearing fields are never included."""
        import dataclasses as _dc

        cfg = self.broker.config
        redact = {
            "kafka_tls_key",
            "superusers",
            "cloud_storage_access_key",
            "cloud_storage_secret_key",
        }
        out = {}
        for f in _dc.fields(cfg):
            if f.name in redact:
                continue
            v = getattr(cfg, f.name)
            if isinstance(v, (str, int, float, bool, type(None), list)):
                out[f.name] = v
            elif isinstance(v, dict):
                out[f.name] = {str(k): str(x) for k, x in v.items()}
        return out

    async def _raft_status(self, m, _q, _b):
        """Per-group raft state on this node (raft admin routes /
        debug partition view)."""
        gid = int(m.group(1))
        c = self.broker.group_manager.get(gid)
        if c is None:
            raise HttpError(404, f"group {gid} not on this node")
        offs = c.log.offsets()
        return {
            "group": gid,
            "role": c.role.name,
            "term": c.term,
            "leader_id": c.leader_id,
            "commit_index": c.commit_index,
            "dirty_offset": offs.dirty_offset,
            "flushed_offset": offs.committed_offset,
            "log_start": offs.start_offset,
            "snapshot_index": c.snapshot_index,
            "voters": list(c.config.voters),
            "learners": list(c.config.learners),
            "joint": c.config.is_joint(),
        }

    async def _transactions(self, _m, _q, _b):
        """Transactional-id registry over the tx partitions this
        broker LEADS (admin_server.cc get_all_transactions), through
        the coordinator's replay-aware listing — a fresh broker
        hydrates from the tx log instead of answering from an empty
        cache."""
        tx = getattr(self.broker, "tx_coordinator", None)
        if tx is None:
            return {"transactions": [], "complete": True}
        metas, complete = await tx.list_local_txs()
        return {
            "complete": complete,
            "transactions": [
                {
                    "transactional_id": meta.tx_id,
                    "producer_id": meta.pid,
                    "producer_epoch": meta.epoch,
                    "status": meta.status,
                    "timeout_ms": meta.timeout_ms,
                    "partitions": [
                        f"{n.ns}/{n.topic}/{n.partition}"
                        for n in sorted(
                            meta.partitions,
                            key=lambda n: (n.ns, n.topic, n.partition),
                        )
                    ],
                    "groups": sorted(meta.groups),
                }
                for meta in metas
            ],
        }

    async def _usage(self, _m, _q, _b):
        """Usage accounting (admin_server.cc usage/ + kvstore usage
        keyspace intent): bytes/requests served plus on-disk footprint."""
        b = self.broker
        disk = 0
        partitions = 0
        for ntp, p in b.partition_manager.partitions().items():
            partitions += 1
            disk += p.log.size_bytes()
        counters = {}
        for name, m in b.metrics._metrics.items():
            if name.endswith(("_requests_total", "_bytes_total")) and hasattr(
                m, "_values"
            ):
                counters[name] = sum(m._values.values())
        return {
            "node_id": b.node_id,
            "partitions": partitions,
            "log_bytes_on_disk": disk,
            "counters": counters,
        }

    async def _list_partitions(self, _m, _q, _b):
        """All partitions hosted by this node (admin partitions list)."""
        out = []
        for ntp, p in self.broker.partition_manager.partitions().items():
            offs = p.log.offsets()
            out.append(
                {
                    "ns": ntp.ns,
                    "topic": ntp.topic,
                    "partition_id": ntp.partition,
                    "raft_group_id": p.group_id,
                    "is_leader": p.is_leader,
                    "start_offset": offs.start_offset,
                    "dirty_offset": offs.dirty_offset,
                    "committed_offset": offs.committed_offset,
                }
            )
        return out

    async def _balancer_status(self, _m, _q, _b):
        """partition_balancer_backend status (admin_server.cc
        get_partition_balancer_status)."""
        ctrl = self.broker.controller
        moves = [
            {
                "ns": ntp.ns,
                "topic": ntp.topic,
                "partition": ntp.partition,
                "previous_replicas": old,
            }
            for ntp, old in ctrl.topic_table.updates_in_progress.items()
        ]
        return {
            "status": "in_progress" if moves else "ready",
            "partitions_pending_force_recovery_count": 0,
            "current_reassignments_count": len(moves),
            "reassignments": moves,
            "leader_balancer_enabled": ctrl.leader_balancer_enabled,
            "partition_balancer_enabled": ctrl.partition_balancer_enabled,
        }

    async def _balancer_cancel(self, _m, _q, _b):
        """Cancel all in-flight replica moves by restoring the previous
        assignment (admin_server.cc cancel_all_partitions_reconfigs)."""
        ctrl = self.broker.controller
        cancelled = []
        for ntp, old in list(ctrl.topic_table.updates_in_progress.items()):
            try:
                await ctrl.move_partition_replicas(
                    ntp.topic, ntp.partition, list(old), ns=ntp.ns
                )
                cancelled.append(f"{ntp.ns}/{ntp.topic}/{ntp.partition}")
            except Exception as e:  # a finished move loses the race: fine
                logger.info("balancer cancel %s skipped: %s", ntp, e)
        return {"cancelled": cancelled}

    async def _recovery_status(self, _m, _q, _b):
        """Raft catch-up status + node-wide throttle accounting
        (recovery_throttle.h observability)."""
        gm = self.broker.group_manager
        recovering = []
        for c in gm.groups():
            if c.role.name != "LEADER":
                continue
            for peer in c.peers():
                slot = c._slot_map.get(peer)
                if slot is None:
                    continue
                match = int(c.arrays.match_index[c.row, slot])
                dirty = c.dirty_offset()
                if match < dirty:
                    recovering.append(
                        {
                            "group": c.group_id,
                            "follower": peer,
                            "match_offset": match,
                            "leader_dirty_offset": dirty,
                            "lag": dirty - match,
                        }
                    )
        t = gm.recovery_throttle
        return {
            "recovering": recovering,
            "throttle_rate_bytes_s": t._bucket.rate,
            "throttled_seconds_total": round(t.throttled_s, 3),
        }

    @property
    def blocked_reactor_notify_ms(self) -> float:
        """The loop's stall threshold, process-wide as the loop is: it
        also sets which iterations `reactor_stall_seconds` counts
        (resource_mgmt.LoopMonitor)."""
        return MemoryGovernor.instance().loop.stall_ms

    @blocked_reactor_notify_ms.setter
    def blocked_reactor_notify_ms(self, ms: float) -> None:
        MemoryGovernor.instance().loop.stall_ms = ms

    async def _partitions_summary(self, _m, _q, _b):
        """Local partition counts (partition_api.cc local_summary)."""
        pm = self.broker.partition_manager
        total = leaders = leaderless = 0
        for _ntp, p in pm.partitions().items():
            total += 1
            if p.consensus.is_leader():
                leaders += 1
            elif p.consensus.leader_id is None:
                leaderless += 1
        return {"count": total, "leaders": leaders, "leaderless": leaderless}

    async def _reconfigurations(self, _m, _q, _b):
        """In-flight replica moves (ListPartitionReassignments view)."""
        ctrl = self.broker.controller
        out = []
        for ntp, previous in ctrl.topic_table.updates_in_progress.items():
            md = ctrl.topic_table.get(ntp.tp_ns)
            current = (
                md.assignments[ntp.partition].replicas
                if md is not None and ntp.partition in md.assignments
                else []
            )
            out.append(
                {
                    "ns": ntp.ns,
                    "topic": ntp.topic,
                    "partition": ntp.partition,
                    "previous_replicas": list(previous),
                    "current_replicas": list(current),
                }
            )
        return out

    async def _topic_partitions(self, m, _q, _b):
        from ..models.fundamental import TopicNamespace

        ns, topic = m.group(1), m.group(2)
        md = self.broker.controller.topic_table.get(
            TopicNamespace(ns, topic)
        )
        if md is None:
            raise HttpError(404, f"no topic {ns}/{topic}")
        out = []
        for pid in sorted(md.assignments):
            a = md.assignments[pid]
            from ..models.fundamental import NTP

            leader = self.broker.leaders.get(NTP(ns, topic, pid))
            out.append(
                {
                    "ns": ns,
                    "topic": topic,
                    "partition_id": pid,
                    "replicas": list(a.replicas),
                    "leader_id": leader,
                }
            )
        return out

    async def _cancel_reconfiguration(self, m, _q, _b):
        """Restore the pre-move replica set (cancel_partition_move)."""
        from ..cluster.controller import TopicError
        from ..models.fundamental import NTP

        ns, topic, pid = m.group(1), m.group(2), int(m.group(3))
        ntp = NTP(ns, topic, pid)
        ctrl = self.broker.controller
        previous = ctrl.topic_table.updates_in_progress.get(ntp)
        if previous is None:
            raise HttpError(404, f"no reconfiguration in flight for {ntp}")
        try:
            await ctrl.move_partition_replicas(
                topic, pid, list(previous), ns=ns
            )
        except TopicError as e:
            raise HttpError(400, f"{e.code}: {e.message}") from None
        return None

    async def _cancel_all_reconfigurations(self, _m, _q, _b):
        from ..cluster.controller import TopicError

        ctrl = self.broker.controller
        cancelled = []
        for ntp, previous in list(
            ctrl.topic_table.updates_in_progress.items()
        ):
            try:
                await ctrl.move_partition_replicas(
                    ntp.topic, ntp.partition, list(previous), ns=ntp.ns
                )
                cancelled.append(str(ntp))
            except TopicError:
                pass
        return {"cancelled": cancelled}

    async def _cancel_broker_moves(self, m, _q, _b):
        """Cancel every in-flight move ADDING replicas to this broker
        (brokers/{id}/cancel_partition_moves)."""
        from ..cluster.controller import TopicError

        nid = int(m.group(1))
        ctrl = self.broker.controller
        cancelled = []
        for ntp, previous in list(
            ctrl.topic_table.updates_in_progress.items()
        ):
            md = ctrl.topic_table.get(ntp.tp_ns)
            current = (
                md.assignments[ntp.partition].replicas
                if md is not None and ntp.partition in md.assignments
                else []
            )
            if nid in current and nid not in previous:
                try:
                    await ctrl.move_partition_replicas(
                        ntp.topic, ntp.partition, list(previous), ns=ntp.ns
                    )
                    cancelled.append(str(ntp))
                except TopicError:
                    pass
        return {"cancelled": cancelled}

    async def _rebalance(self, _m, _q, _b):
        """Run one on-demand balancer pass (partitions/rebalance)."""
        ctrl = self.broker.controller
        if not ctrl.is_leader:
            raise HttpError(400, "not the controller leader")
        await ctrl._leader_balance_pass()
        await ctrl._partition_balance_pass()
        return None

    async def _config_status(self, _m, _q, _b):
        """Per-node config application status (cluster_config/status):
        every node applies replicated config at the same version, so
        the status reports the shared version per member."""
        ctrl = self.broker.controller
        v = ctrl.cluster_config.version
        return [
            {
                "node_id": nid,
                "restart": False,
                "config_version": v,
                "invalid": [],
                "unknown": [],
            }
            for nid in ctrl.members_table.node_ids()
        ]

    async def _cluster_view(self, _m, _q, _b):
        brokers = await self._brokers(None, None, None)
        return {
            "version": self.broker.controller.topic_table.revision,
            "brokers": brokers["brokers"],
        }

    async def _controller_status(self, _m, _q, _b):
        c = self.broker.controller.consensus
        if c is None:
            return {"started": False}
        return {
            "started": True,
            "leader_id": c.leader_id,
            "term": c.term,
            "commit_index": c.commit_index,
            "dirty_offset": c.log.offsets().dirty_offset,
        }

    async def _is_node_isolated(self, _m, _q, _b):
        """True when this node can reach NO other member
        (debug/is_node_isolated)."""
        ns = self.broker.node_status
        others = [
            n
            for n in self.broker.controller.members
            if n != self.broker.node_id
        ]
        return bool(others) and not any(ns.is_alive(n) for n in others)

    async def _leaders_table(self, _m, _q, _b):
        out = []
        for ntp, leader in self.broker.leaders.items():
            out.append(
                {
                    "ns": ntp.ns,
                    "topic": ntp.topic,
                    "partition_id": ntp.partition,
                    "leader": leader,
                }
            )
        return out

    async def _peer_status(self, m, _q, _b):
        import asyncio

        nid = int(m.group(1))
        ns = self.broker.node_status
        seen = ns.last_seen.get(nid)
        now = asyncio.get_event_loop().time()
        return {
            "since_last_status_ms": (
                round((now - seen) * 1e3, 1) if seen is not None else None
            ),
            "is_alive": ns.is_alive(nid),
        }

    async def _reset_leaders(self, _m, _q, _b):
        """Drop leadership hints; they repopulate via dissemination
        (debug/reset_leaders)."""
        self.broker.leaders.clear()
        return None

    async def _cloud_usage(self, _m, _q, _b):
        """Bytes this cluster accounts in the object store, from the
        replicated archival metadata (debug/cloud_storage_usage)."""
        total = 0
        segments = 0
        for _ntp, p in self.broker.partition_manager.partitions().items():
            stm = getattr(p, "archival", None)
            if stm is None:
                continue
            stm.apply_committed(p.consensus.commit_index)
            for seg in stm.segments:
                total += int(seg.size_bytes)
                segments += 1
        return {"total_size_bytes": total, "segments": segments}

    async def _local_maintenance(self, _m, _q, _b):
        """THIS node's maintenance status (GET /v1/maintenance)."""
        ctrl = self.broker.controller
        ep = ctrl.members_table.get(self.broker.node_id)
        from ..cluster.members import MembershipState

        draining = (
            ep is not None and ep.state == MembershipState.maintenance
        )
        pm = self.broker.partition_manager
        leaders = sum(
            1
            for _ntp, p in pm.partitions().items()
            if p.consensus.is_leader()
        )
        return {
            "node_id": self.broker.node_id,
            "draining": draining,
            "finished": draining and leaders == 0,
            "partitions_with_leadership": leaders,
        }

    async def _put_feature(self, m, _q, body):
        """Administratively set a feature state (PUT
        /v1/features/{name}; feature_manager set_feature_state)."""
        from ..cluster.commands import CmdType, FeatureUpdateCmd
        from ..cluster.features import FEATURES

        name = m.group(1)
        if name not in {f.name for f in FEATURES}:
            raise HttpError(404, f"unknown feature {name}")
        payload = self._json_body(body)
        state = payload.get("state")
        if state not in ("active", "disabled"):
            raise HttpError(400, "state must be 'active' or 'disabled'")
        ctrl = self.broker.controller
        await ctrl.replicate_cmd(
            CmdType.feature_update,
            FeatureUpdateCmd(
                name=name,
                state=state,
                cluster_version=ctrl.features.cluster_version,
            ),
        )
        return None

    async def _get_license(self, _m, _q, _b):
        """License properties + enterprise violations
        (GET /v1/features/license; security/license.h properties)."""
        status = self.broker.license.status()
        status["violations"] = self.broker.license.violations(
            self.broker.enterprise_features_in_use()
        )
        return status

    async def _put_license(self, _m, _q, body):
        """Validate (signature/schema/expiry) BEFORE replicating — a bad
        key must never enter the replicated config
        (admin_server.cc put_license)."""
        from ..security.license import LicenseError

        if not body:
            raise HttpError(400, "license body required")
        raw = body.decode("utf-8", "replace").strip()
        try:
            self.broker.license.validate(raw)
        except LicenseError as e:
            raise HttpError(400, f"invalid license: {e}") from None
        await self.broker.controller.set_cluster_config(
            {"cluster_license": raw}
        )
        return None

    async def _automated_recovery(self, _m, _q, body):
        """Recreate topics from uploaded manifests (cloud_storage
        automated_recovery)."""
        payload = self._json_body(body)
        topic = payload.get("topic")
        if not topic:
            raise HttpError(400, "topic required")
        if self.broker.archival is None:
            raise HttpError(400, "tiered storage is not configured")
        try:
            await self.broker.recover_topic_from_cloud(
                str(topic), ns=str(payload.get("ns", "kafka"))
            )
        except Exception as e:
            raise HttpError(400, f"recovery failed: {e}") from None
        return {"topic": topic, "status": "recovery started"}

    async def _sync_local_state(self, m, _q, _b):
        """Force the archiver to re-sync its view from the store
        manifest (cloud_storage/sync_local_state)."""
        from ..models.fundamental import kafka_ntp

        topic, pid = m.group(1), int(m.group(2))
        p = self.broker.partition_manager.get(kafka_ntp(topic, pid))
        if p is None or getattr(p, "archiver", None) is None:
            raise HttpError(404, f"no archived partition {topic}/{pid}")
        p.archiver._synced_term = -1
        await p.archiver._sync_from_store()
        return None

    async def _refresh_disk_health(self, _m, _q, _b):
        import shutil as _shutil

        du = _shutil.disk_usage(self.broker.config.data_dir)
        return {
            "total_bytes": du.total,
            "free_bytes": du.free,
            "used_ratio": round(1 - du.free / du.total, 4),
        }

    async def _get_blocked_reactor_ms(self, _m, _q, _b):
        return {"blocked_reactor_notify_ms": self.blocked_reactor_notify_ms}

    async def _put_blocked_reactor_ms(self, _m, q, _b):
        try:
            self.blocked_reactor_notify_ms = float((q or {}).get("v", ""))
        except ValueError:
            raise HttpError(400, "query param v=<ms> required") from None
        return None

    async def _restart_service(self, _m, q, _b):
        """Restart a named subsystem loop (debug/restart_service)."""
        name = (q or {}).get("service", "")
        if name == "archival":
            if self.broker.archival is None:
                raise HttpError(400, "archival not configured")
            await self.broker.archival.stop()
            self.broker.archival.store._chain.reset()
            await self.broker.archival.start()
        elif name == "transforms":
            await self.broker.transforms.stop()
            await self.broker.transforms.start()
        else:
            raise HttpError(
                400, "service must be 'archival' or 'transforms'"
            )
        return None

    async def _blocked_reactor(self, _m, _q, _b):
        """Event-loop stall probe (the reference's blocked-reactor
        notifications): measures scheduling delay of an immediate
        wakeup a few times and reports the worst."""
        loop = asyncio.get_event_loop()
        worst = 0.0
        for _ in range(5):
            t0 = loop.time()
            await asyncio.sleep(0)
            worst = max(worst, loop.time() - t0)
        t = self.blocked_reactor_notify_ms
        return {
            "max_scheduling_delay_ms": round(worst * 1e3, 3),
            "threshold_ms": t,
            "blocked": worst * 1e3 > t,
        }

    async def _cpu_profile(self, _m, q, _b):
        """Sampling wall-clock profile (admin_server.cc cpu_profiler
        routes). Samples the SUSPENDED stack of every asyncio task plus
        every non-loop thread for `seconds` (default 1) and returns
        collapsed frames by count. Sampling from the loop itself cannot
        observe a CPU-bound stall mid-callback (the sampler only runs
        when the loop yields) — use /v1/debug/blocked_reactor to DETECT
        stalls; this endpoint attributes where tasks spend wall time."""
        import sys
        import threading
        import traceback

        try:
            seconds = float((q or {}).get("seconds", "1"))
        except ValueError:
            raise HttpError(400, "seconds must be a number") from None
        seconds = min(max(seconds, 0.05), 10.0)
        interval = 0.01
        counts: dict[str, int] = {}
        loop_thread = threading.get_ident()
        me = asyncio.current_task()
        end = asyncio.get_event_loop().time() + seconds

        def collapse(frames) -> str:
            return ";".join(
                f"{f.name}@{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                for f in frames[-6:]
            )

        while asyncio.get_event_loop().time() < end:
            for task in asyncio.all_tasks():
                if task is me or task.done():
                    continue
                stack = task.get_stack(limit=6)
                if not stack:
                    continue
                key = "task:" + collapse(
                    [f for fr in stack for f in traceback.extract_stack(fr)]
                )
                counts[key] = counts.get(key, 0) + 1
            for tid, frame in sys._current_frames().items():
                if tid == loop_thread:
                    continue  # the loop thread's frame is this sampler
                key = "thread:" + collapse(traceback.extract_stack(frame))
                counts[key] = counts.get(key, 0) + 1
            await asyncio.sleep(interval)
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:50]
        return {
            "seconds": seconds,
            "samples": sum(counts.values()),
            "frames": [{"stack": k, "count": v} for k, v in top],
        }

    def _partition_or_404(self, ns: str, topic: str, pid: int):
        from ..models.fundamental import NTP

        p = self.broker.partition_manager.get(NTP(ns, topic, pid))
        if p is None:
            raise HttpError(404, "partition not found on this node")
        return p

    async def _si_manifest(self, m, _q, _b):
        """Archived-range manifest (shadow_indexing admin routes)."""
        topic, pid = m.group(1), int(m.group(2))
        p = self._partition_or_404("kafka", topic, pid)
        manifest = p.cloud_manifest()
        if manifest is None:
            raise HttpError(404, "no archived data for partition")
        return {
            "ns": manifest.ns,
            "topic": manifest.topic,
            "partition": int(manifest.partition),
            "revision": int(manifest.revision),
            "segments": [
                {
                    "name": s.name,
                    "base_offset": int(s.base_offset),
                    "last_offset": int(s.last_offset),
                    "term": int(s.term),
                    "size_bytes": int(s.size_bytes),
                }
                for s in manifest.segments
            ],
        }

    async def _cloud_status(self, m, _q, _b):
        """Per-partition tiered-storage status (admin cloud_storage
        status route)."""
        topic, pid = m.group(1), int(m.group(2))
        p = self._partition_or_404("kafka", topic, pid)
        offs = p.log.offsets()
        st = p.archival
        return {
            "cloud_storage_mode": (
                "full" if st.segments else "disabled_or_empty"
            ),
            "local_log_start_offset": offs.start_offset,
            "local_log_last_offset": offs.dirty_offset,
            "cloud_log_segment_count": len(st.segments),
            "cloud_log_start_offset": (
                int(st.segments[0].base_offset) if st.segments else -1
            ),
            "cloud_log_last_offset": (
                int(st.segments[-1].last_offset) if st.segments else -1
            ),
        }

    async def _transforms(self, _m, _q, _b):
        """Per-transform per-partition fiber status (coproc status)."""
        return self.broker.transforms.status()

    async def _scheduler_stats(self, _m, _q, _b):
        """Per-group shares/queue/consumption of the background
        weighted-fair scheduler (resource_mgmt)."""
        return self.broker.scheduler.stats()

    async def _debug_traces(self, _m, q, _b):
        """Flight-recorder dump: frozen slow-request span trees, the
        ring tail of recent trees, and the fault-event log
        (observability/trace.py). `?tail=N` bounds the ring slice."""
        try:
            tail = int(q.get("tail", 50) or 50)
        except ValueError:
            raise HttpError(400, f"bad tail {q.get('tail')!r}") from None
        dump = self.broker.recorder.dump(tail=tail)
        # nemesis events recorded through the module default recorder
        # (rpc/loopback fires them without broker context) surface in
        # the same dump so a fault and the spans it hit read together
        from ..observability.trace import default_recorder

        shared = default_recorder()
        if shared is not self.broker.recorder and shared.events():
            dump["events"] = dump["events"] + shared.events()
        router = getattr(self.broker, "shard_router", None)
        if router is not None:
            # fleet collection: worker rings over invoke_on, then trees
            # sharing a propagated trace_id merge into stitched trees
            from ..observability import fleet
            from ..ssx.shards import InvokeError

            worker_dumps = {}
            for sid in router.worker_shards():
                try:
                    worker_dumps[str(sid)] = await router.obs_traces(sid)
                except InvokeError:
                    pass
            dump["shards"] = worker_dumps
            all_trees = list(dump["frozen"]) + list(dump["ring"])
            for wd in worker_dumps.values():
                all_trees.extend(wd["ring"])
            dump["stitched"] = fleet.stitch_trees(all_trees)
        return dump

    async def _debug_probes(self, _m, _q, _b):
        """Per-partition raft state + live histogram snapshots (the
        probe families as quantiles rather than Prometheus buckets)."""
        groups = []
        for c in self.broker.group_manager.groups():
            offs = c.log.offsets()
            groups.append(
                {
                    "group": c.group_id,
                    "role": c.role.name,
                    "term": c.term,
                    "leader_id": c.leader_id,
                    "commit_index": c.commit_index,
                    "dirty_offset": offs.dirty_offset,
                    "flushed_offset": offs.committed_offset,
                }
            )
        router = getattr(self.broker, "shard_router", None)
        shards = (
            router.liveness()
            if router is not None
            else {
                "n_shards": 1,
                "alive": {},
                "cores": {},
                "crashed": {},
                "restarts": 0,
                "failed": False,
            }
        )
        return {
            "node_id": self.broker.node_id,
            "groups": groups,
            "shards": shards,
            "histograms": {
                name: h.snapshot()
                for name, h in sorted(
                    self.broker.metrics.histograms().items()
                )
            },
        }

    async def _metrics(self, _m, _q, _b):
        """Prometheus scrape. Single-process: the local registry.
        Sharded: the merged fleet view — every worker's registry is
        snapshotted over invoke_on and every sample (this shard's
        included) carries a `shard` label."""
        router = getattr(self.broker, "shard_router", None)
        if router is None:
            return self.broker.metrics.render()
        from ..observability import fleet
        from ..ssx.shards import InvokeError

        snaps = [
            fleet.snapshot_registry(
                self.broker.metrics, 0, self.broker.node_id
            )
        ]
        for sid in router.worker_shards():
            try:
                snaps.append(await router.obs_metrics(sid))
            except InvokeError:
                self.broker.metrics.counter(
                    "fleet_scrape_errors_total",
                    "worker shard snapshots that failed during a fleet scrape",
                ).inc(shard=str(sid))
        return fleet.render_fleet(snaps)

    async def _shard_metrics(self, m, _q, _b):
        """Raw per-shard registry view (no fleet merge, no shard label):
        shard 0 is the local registry, workers answer over invoke_on."""
        sid = int(m.group(1))
        router = getattr(self.broker, "shard_router", None)
        n_shards = router.n_shards if router is not None else 1
        if sid >= n_shards:
            raise HttpError(404, f"no shard {sid} (n_shards={n_shards})")
        if sid == 0:
            return self.broker.metrics.render()
        from ..observability import fleet
        from ..ssx.shards import InvokeError

        try:
            snap = await router.obs_metrics(sid)
        except InvokeError as e:
            raise HttpError(503, f"shard {sid} unreachable: {e}") from None
        return fleet.render_snapshot(snap)

    # -- flight-data plane --------------------------------------------
    @staticmethod
    def _parse_labels(raw: str) -> Optional[dict]:
        """`labels=api=produce,stage=done` query form."""
        if not raw:
            return None
        out = {}
        for part in raw.split(","):
            k, sep, v = part.partition("=")
            if not sep or not k:
                raise HttpError(400, f"bad labels clause {part!r}")
            out[k.strip()] = v.strip()
        return out

    async def _metrics_history(self, _m, q, _b):
        """Windowed queries over the metrics-history ring: counter
        rate/delta, exact windowed histogram quantiles, gauge window
        stats. No `family` -> the catalog. Sharded brokers merge every
        worker's ring over invoke_on (exactly like /metrics), unless
        `fleet=0` asks for the local shard only."""
        from ..observability import flightdata as _fd

        hist = self.broker.flightdata
        family = (q.get("family", "") or "").strip()
        if not family:
            cat = hist.families()
            cat["enabled"] = _fd.ENABLED
            return cat
        prefixed = f"{self.broker.metrics.prefix}_{family}"
        if hist.kind_of(family) is None and hist.kind_of(prefixed):
            family = prefixed  # short names accepted
        try:
            window_s = float(q.get("window_s", 60) or 60)
            quant = float(q.get("q", 0.99) or 0.99)
        except ValueError:
            raise HttpError(400, "window_s and q must be numbers") from None
        reduce = (q.get("reduce", "") or "").strip() or None
        labels = self._parse_labels((q.get("labels", "") or "").strip())
        router = getattr(self.broker, "shard_router", None)
        if router is None or (q.get("fleet", "") or "") == "0":
            try:
                out = hist.query(family, window_s, reduce, quant, labels)
            except ValueError as e:
                raise HttpError(400, str(e)) from None
            if out is None:
                raise HttpError(404, f"no history for family {family!r}")
            out["shards"] = 1
            return out
        # fleet merge: the local windowed view plus each worker's,
        # counters summed by label set and histogram diff buckets
        # merged before the quantile — exact, like render_fleet
        from ..ssx.shards import InvokeError

        wq = _fd.WindowQuery(
            family=family, window_s=window_s, labels=labels or {}
        )
        replies = [_fd.window_reply(hist, 0, wq)]
        for sid in router.worker_shards():
            try:
                replies.append(await router.obs_history(sid, wq))
            except InvokeError:
                self.broker.metrics.counter(
                    "fleet_scrape_errors_total",
                    "worker shard snapshots that failed during a fleet "
                    "scrape",
                ).inc(shard=str(sid))
        merged = _fd.merge_window_replies(replies, q=quant)
        if merged["kind"] is None:
            raise HttpError(404, f"no history for family {family!r}")
        merged["family"] = family
        return merged

    async def _alerts(self, _m, _q, _b):
        """Burn-rate SLO alert state: firing + recently cleared alerts
        with their breaching quantiles, hot NTPs, and auto-captured
        profiles (observability/alerts.py)."""
        from ..observability import alerts as _alerts_mod
        from ..observability import flightdata as _fd

        mgr = getattr(self.broker, "alerts", None)
        if mgr is None or not (_alerts_mod.ENABLED and _fd.ENABLED):
            return {
                "enabled": False,
                "rules": [],
                "firing": [],
                "recent": [],
            }
        return mgr.status()

    async def _devplane(self, _m, q, _b):
        """Device-plane flight data (observability/devplane.py): frame
        dispatch->ready quantiles, cross-chip folds per frame (the
        RPL018 runtime invariant), host<->device transfer bytes,
        per-kernel latency, and warmup-vs-steady compile counts.
        Sharded brokers merge every worker's devplane registry over
        invoke_on — raw buckets on the wire, exact quantiles — unless
        `fleet=0` asks for the local process only."""
        from ..observability import devplane as _devplane

        if not _devplane.ENABLED:
            return {"enabled": False}
        snaps = [_devplane.snapshot(0, self.broker.node_id)]
        router = getattr(self.broker, "shard_router", None)
        if router is not None and (q.get("fleet", "") or "") != "0":
            from ..ssx.shards import InvokeError

            for sid in router.worker_shards():
                try:
                    snaps.append(await router.obs_devplane(sid))
                except InvokeError:
                    self.broker.metrics.counter(
                        "fleet_scrape_errors_total",
                        "worker shard snapshots that failed during a "
                        "fleet scrape",
                    ).inc(shard=str(sid))
        return _devplane.merged_status(snaps)

    # -- placement layer ----------------------------------------------
    async def _placement(self, _m, _q, _b):
        """Placement-layer state: the live ntp/group → shard map with
        lane bindings, move budget/stats, and the rebalancer's verdict
        history (placement/)."""
        table = self.broker.shard_table
        out = {
            "table": table.describe(),
            "entries": table.entries(),
            "mover": None,
            "rebalancer": None,
        }
        mover = getattr(self.broker, "placement_mover", None)
        if mover is not None:
            out["mover"] = mover.describe()
        reb = getattr(self.broker, "placement_rebalancer", None)
        if reb is not None:
            out["rebalancer"] = reb.describe()
        return out

    async def _placement_move(self, m, q, b):
        """Trigger one live partition move (smoke/operator entry
        point): POST /v1/placement/move/<ns>/<topic>/<pid>?shard=K."""
        from ..models.fundamental import NTP
        from ..placement import MoveError

        mover = getattr(self.broker, "placement_mover", None)
        if mover is None:
            raise HttpError(400, "placement mover not active (1 shard?)")
        body = self._json_body(b) if b else {}
        shard = q.get("shard", body.get("shard"))
        if shard is None:
            raise HttpError(400, "target shard required (?shard=K)")
        ntp = NTP(m.group(1), m.group(2), int(m.group(3)))
        try:
            return await mover.move(ntp, int(shard))
        except MoveError as e:
            raise HttpError(400, str(e)) from None

    async def _placement_rebalance(self, _m, _q, b):
        """Trigger one bounded rebalance pass using the ledger's
        current hot-NTP list (same path an alert fires)."""
        reb = getattr(self.broker, "placement_rebalancer", None)
        if reb is None:
            raise HttpError(400, "rebalancer not active (1 shard?)")
        led = getattr(self.broker, "load_ledger", None)
        hot = led.top(8) if led is not None else []
        await reb.sample()
        return await reb.rebalance_once(hot_ntps=hot, reason="manual")

    # -- elastic shard lifecycle --------------------------------------
    async def _shards(self, _m, _q, _b):
        """Fleet lifecycle view: supervisor liveness (pids, restarts,
        gray failures, retirements) plus the lifecycle coordinator's
        budget and latency accounting."""
        router = getattr(self.broker, "shard_router", None)
        if router is None:
            return {"sharded": False}
        out = {"sharded": True, "liveness": router.liveness()}
        lc = getattr(self.broker, "shard_lifecycle", None)
        if lc is not None:
            out["lifecycle"] = lc.describe()
        return out

    async def _shard_detail(self, m, _q, _b):
        """One shard's crash/restart record: pid, core, restart and
        gray-failure counts, availability, resident partitions."""
        router = getattr(self.broker, "shard_router", None)
        if router is None:
            raise HttpError(400, "shard runtime not active")
        sid = int(m.group(1))
        live = router.liveness()
        table = self.broker.shard_table
        return {
            "shard": sid,
            "pid": live["alive"].get(str(sid)),
            "core": live["cores"].get(str(sid)),
            "alive": str(sid) in live["alive"] or sid == 0,
            "available": table.is_available(sid),
            "retired": sid in live["retired"],
            "restarts": live["shard_restarts"].get(str(sid), 0),
            "gray_failures": live["gray_failures"].get(str(sid), 0),
            "crashed_status": live["crashed"].get(str(sid)),
            "partitions": len(table.ntps_on(sid)),
        }

    async def _shard_grow(self, _m, _q, _b):
        """Fork + mesh + activate one new worker shard."""
        lc = getattr(self.broker, "shard_lifecycle", None)
        if lc is None:
            raise HttpError(400, "shard lifecycle not active (1 shard?)")
        try:
            sid = await lc.grow()
        except Exception as e:
            raise HttpError(400, f"grow failed: {e}") from None
        return {"grown": True, "shard": sid}

    async def _shard_retire(self, m, _q, _b):
        """Freeze → evacuate → drain → stop one worker shard."""
        lc = getattr(self.broker, "shard_lifecycle", None)
        if lc is None:
            raise HttpError(400, "shard lifecycle not active (1 shard?)")
        try:
            await lc.retire(int(m.group(1)))
        except ValueError as e:
            raise HttpError(400, str(e)) from None
        except Exception as e:
            raise HttpError(400, f"retire failed: {e}") from None
        return {"retired": True, "shard": int(m.group(1))}

    async def _debug_profile(self, _m, q, _b):
        """Continuous-profiler window: collapsed wall stacks over the
        last `seconds`, per shard (workers answer over invoke_on).
        `fmt=collapsed` renders flamegraph.pl input with a `shardN`
        root frame; the default JSON keeps shards separate plus a
        merged top list."""
        from ..observability import profiler as _prof

        try:
            seconds = float(q.get("seconds", 30) or 30)
            limit = int(q.get("limit", 50) or 50)
        except ValueError:
            raise HttpError(400, "seconds/limit must be numbers") from None
        seconds = min(max(seconds, 1.0), 3600.0)
        limit = min(max(limit, 1), 1000)
        fmt = (q.get("fmt", "json") or "json").strip()
        prof = getattr(self.broker, "profiler", None)
        pq = _prof.ProfileQuery(seconds=seconds, limit=limit)
        replies = [_prof.profile_reply(prof, 0, pq)]
        router = getattr(self.broker, "shard_router", None)
        if router is not None and (q.get("fleet", "") or "") != "0":
            from ..ssx.shards import InvokeError

            for sid in router.worker_shards():
                try:
                    replies.append(await router.obs_profile(sid, pq))
                except InvokeError:
                    pass
        if fmt == "collapsed":
            lines = []
            for rep in replies:
                for row in rep.rows:
                    lines.append(f"shard{rep.shard};{row.stack} {row.count}")
            return "\n".join(lines) + ("\n" if lines else "")
        merged: dict[str, int] = {}
        for rep in replies:
            for row in rep.rows:
                merged[row.stack] = merged.get(row.stack, 0) + row.count
        top = sorted(merged.items(), key=lambda kv: (-kv[1], kv[0]))[:limit]
        return {
            "seconds": seconds,
            "enabled": any(rep.enabled for rep in replies),
            "samples": sum(rep.samples for rep in replies),
            "shards": {
                str(rep.shard): {
                    "enabled": rep.enabled,
                    "samples": rep.samples,
                    "stacks": [
                        {"stack": row.stack, "count": row.count}
                        for row in rep.rows
                    ],
                }
                for rep in replies
            },
            "merged": [{"stack": s, "count": n} for s, n in top],
        }
