"""Broker composition root (reference: src/v/redpanda/application.{h,cc}).

Wires storage → raft → cluster → kafka in the reference's startup
order (application.cc:1814 wire_up_and_start): storage api + internal
RPC first, then group_manager/partition_manager, the controller (raft
group 0 replay rebuilds the topic table, backend reconciles local
partitions), and finally the Kafka listener.

Two transport modes, both first-class (SURVEY §4.2 fixture strategy):
- loopback: N brokers in one process over an in-memory network — the
  cluster_test_fixture analog used by the test suite;
- tcp: real framed RPC server + kafka listener on sockets.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
from typing import Optional

from .cluster import (
    Controller,
    MetadataCache,
    PartitionLeadersTable,
    PartitionManager,
    ShardTable,
)
from .admin import AdminServer
from .cluster.health_monitor import HealthMonitor
from .cluster.metadata_dissemination import MetadataDissemination
from .cluster.node_status import NodeStatusBackend, NodeStatusService
from .cluster.tx_coordinator import TxCoordinator
from .metrics import MetricsRegistry
from .kafka.coordinator import GroupCoordinator
from .kafka.server import KafkaServer
from .raft.group_manager import GroupManager
from .rpc.connection_cache import ConnectionCache
from .rpc.loopback import LoopbackNetwork, LoopbackTransport
from .rpc.server import RpcServer
from .rpc.transport import TcpTransport
from .storage.log_manager import StorageApi
from .utils.tasks import cancel_and_wait


@dataclasses.dataclass
class BrokerConfig:
    node_id: int
    data_dir: str
    members: list[int]  # seed cluster membership (stage-7: join protocol)
    # tcp mode: node_id → (host, rpc_port); None = loopback mode
    peer_addresses: Optional[dict[int, tuple[str, int]]] = None
    kafka_host: str = "127.0.0.1"
    kafka_port: int = 0  # 0 = ephemeral
    # SO_REUSEPORT kafka listener: set by ssx.ShardedBroker so every
    # shard's frontend binds the same pre-reserved port (requires a
    # concrete kafka_port, not 0)
    kafka_reuse_port: bool = False
    rpc_host: str = "127.0.0.1"
    rpc_port: int = 0
    advertised_host: Optional[str] = None
    # rack/failure-domain label for rack-aware replica placement
    rack: Optional[str] = None
    # node_id → advertised (host, kafka_port) of peers; bootstrap
    # fallback only — the replicated members table takes precedence
    # once nodes register
    peer_kafka_addresses: Optional[dict[int, tuple[str, int]]] = None
    # reference default: election_timeout_ms=1500 (config.cc). The old
    # 0.3 s default was tuned for fast tests (which all pin their own
    # value) but storms under load when brokers share one starved core.
    election_timeout_s: float = 1.5
    # reference default: raft_heartbeat_interval_ms=150
    # (config/configuration.cc:224) — at 1k+ groups the batched sweep
    # is ~0.6 ms/tick, so tick rate is a direct CPU tax
    heartbeat_interval_s: float = 0.15
    # liveness ping cadence (node_status_backend); <= 0 disables
    node_status_interval_s: float = 0.5
    # register this node's endpoints with the cluster at startup (and
    # join raft0 as a voter when not a seed); loopback fixtures that
    # don't exercise membership can turn it off
    auto_join: bool = True
    # TLS on the kafka listener (config::tls_config analog): cert/key
    # enable TLS; require_client_auth turns on mTLS, with the client
    # certificate's DN mapped to a principal by mtls_principal_rules
    kafka_tls_cert: Optional[str] = None
    kafka_tls_key: Optional[str] = None
    kafka_tls_ca: Optional[str] = None
    kafka_tls_require_client_auth: bool = False
    # hostname verification for in-broker clients (transforms, proxy,
    # schema registry). Disable only for certs lacking a SAN for the
    # advertised host.
    kafka_tls_verify_hostname: bool = True
    mtls_principal_rules: Optional[list[str]] = None
    # SASL/SCRAM authentication on the kafka listener; when on,
    # authorization (ACLs) is enforced too unless overridden
    enable_sasl: bool = False
    enable_authorization: Optional[bool] = None  # None = follow enable_sasl
    superusers: Optional[list[str]] = None
    # OIDC / SASL OAUTHBEARER (oidc_service analogs). Setting all
    # three of issuer/audience/jwks enables the OAUTHBEARER mechanism
    # alongside SCRAM when enable_sasl is on. jwks is a path to a JWKS
    # JSON document (zero-egress stand-in for the issuer's
    # .well-known endpoint; a production refresher would rewrite it).
    oidc_issuer: Optional[str] = None
    oidc_audience: Optional[str] = None
    oidc_jwks_file: Optional[str] = None
    oidc_principal_claim: str = "sub"
    # retention + compaction pass interval (log_compaction_interval_ms
    # analog); <= 0 disables the timer (tests drive housekeeping directly)
    housekeeping_interval_s: float = 10.0
    # GC discipline (resource_mgmt.MemoryGovernor): freeze the settled
    # boot graph out of the collector + rare gen2 passes. Measured
    # 3x acks=all throughput and 4x better p99 on this box.
    gc_governor: bool = True
    # SLO declaration the live burn-rate alerting evaluates
    # (observability/alerts.py): a bench_profiles/slo_*.json profile
    # name or a path to one; None follows RP_SLO_PROFILE (default
    # "default")
    slo_profile: Optional[str] = None
    # PEM file overriding the license verification key (the built-in
    # default is the test/vendor key whose SIGNING half ships in
    # tests/data/ — a production deployment MUST set this)
    license_public_key_file: Optional[str] = None
    # SASL/GSSAPI (Kerberos): service principal this broker accepts
    # tickets for, and a JSON keytab file
    # ([{"principal": ..., "password"|"key_hex": ..., "etype": 18}]);
    # both set => the GSSAPI mechanism is offered on the kafka listener
    gssapi_principal: Optional[str] = None
    gssapi_keytab_file: Optional[str] = None
    gssapi_principal_mapping_rules: Optional[list] = None
    # tiered storage: directory backing the filesystem object store
    # (cloud_storage_enabled + bucket analog); None disables tiering
    # unless an object store is injected on the Broker directly
    cloud_storage_dir: Optional[str] = None
    # ... or a real S3-compatible endpoint (cloud_storage_clients/s3):
    # "host:port" + bucket + sigv4 credentials; takes precedence over
    # cloud_storage_dir
    cloud_storage_endpoint: Optional[str] = None
    cloud_storage_bucket: str = "redpanda"
    cloud_storage_region: str = "us-east-1"
    cloud_storage_access_key: str = ""
    cloud_storage_secret_key: str = ""
    cloud_storage_tls: bool = False
    # archival upload pass cadence; <= 0 disables the timer
    archival_interval_s: float = 1.0
    # disk-backed chunk cache for remote reads (cache_service.cc
    # cloud_storage_cache_size); 0 disables the disk cache (falls back
    # to a small in-memory whole-segment LRU)
    cloud_storage_cache_size_bytes: int = 1 << 30
    cloud_storage_cache_chunk_size: int = 1 << 20
    # hard bound on one partition's archived-range read inside a fetch:
    # a wedged object store degrades that partition to a retriable
    # KAFKA_STORAGE_ERROR row instead of stalling the whole fetch (and
    # the local-log partitions sharing it)
    cloud_fetch_timeout_s: float = 5.0
    # bound on each coalesced chunk hydration in the disk cache
    cloud_hydration_timeout_s: float = 10.0
    # adjacent-segment merging (archival housekeeping): archived
    # segments smaller than min are merged into objects up to target;
    # 0 disables (opt-in, like cloud_storage_enable_segment_merging)
    cloud_storage_segment_merge_min_bytes: int = 0
    cloud_storage_segment_merge_target_bytes: int = 16 << 20
    # cluster stats report cadence (metrics_reporter analog); <= 0 off
    stats_interval_s: float = 900.0
    # advertise an older feature level (mixed-version upgrade testing;
    # None = this build's LATEST_LOGICAL_VERSION)
    logical_version: Optional[int] = None
    # admin HTTP listener (admin_server.cc); port 0 = ephemeral
    admin_host: str = "127.0.0.1"
    admin_port: int = 0
    enable_admin: bool = True
    # HTTP ecosystem services (src/v/pandaproxy): opt-in per broker
    enable_pandaproxy: bool = False
    pandaproxy_port: int = 0
    enable_schema_registry: bool = False
    schema_registry_port: int = 0
    # torch device of the raft lanes ("cpu" runs the kernels' plain
    # PyTorch versions)
    device: str = "cuda"


class Broker:
    def __init__(
        self,
        config: BrokerConfig,
        loopback: Optional[LoopbackNetwork] = None,
        object_store=None,
    ):
        self.config = config
        self.node_id = config.node_id
        self._loopback = loopback

        self.metrics = MetricsRegistry()
        self.storage = StorageApi(config.data_dir, metrics=self.metrics)
        # flight recorder (observability/trace.py): per-broker ring of
        # span trees + slow-request freezer, dumped at /v1/debug/traces
        from .observability import FlightRecorder
        from .observability.load_ledger import LoadLedger

        self.recorder = FlightRecorder(node_id=config.node_id)
        # one per-NTP load ledger per broker, shared by the kafka and
        # raft probes so produce/fetch/append rates merge per partition
        self.load_ledger = LoadLedger()
        if object_store is None and config.cloud_storage_endpoint is not None:
            from .cloud.s3_client import S3ObjectStore, StaticCredentialsProvider

            host, _, port = config.cloud_storage_endpoint.partition(":")
            object_store = S3ObjectStore(
                host,
                int(port or (443 if config.cloud_storage_tls else 80)),
                config.cloud_storage_bucket,
                StaticCredentialsProvider(
                    config.cloud_storage_access_key,
                    config.cloud_storage_secret_key,
                ),
                region=config.cloud_storage_region,
                tls=config.cloud_storage_tls,
            )
        if object_store is None and config.cloud_storage_dir is not None:
            from .cloud import FilesystemObjectStore

            object_store = FilesystemObjectStore(config.cloud_storage_dir)
        self.object_store = object_store

        if loopback is not None:
            self._conn_cache = ConnectionCache(
                lambda nid: LoopbackTransport(loopback, self.node_id, nid)
            )
            self._rpc_server: Optional[RpcServer] = None
            self._dispatcher = loopback.register_node(config.node_id)
        else:
            self._conn_cache = ConnectionCache(
                lambda nid: TcpTransport(*self._rpc_addr_of(nid))
            )
            self._rpc_server = RpcServer(config.rpc_host, config.rpc_port)
            self._dispatcher = None
            # traced-call continuations (TRACED_CALL wrapper) land in
            # this broker's recorder, stamped with its identity
            self._rpc_server.dispatcher.recorder = self.recorder
            from .rpc import tracectx

            tracectx.set_local_origin(f"node{config.node_id}")

        send = self._conn_cache.call
        self.group_manager = GroupManager(
            config.node_id,
            config.data_dir,
            send,
            election_timeout_s=config.election_timeout_s,
            heartbeat_interval_s=config.heartbeat_interval_s,
            kvstore=self.storage.kvs,
            metrics=self.metrics,
            load_ledger=self.load_ledger,
            device=config.device,
        )
        # bounded partition-health exporter over the raft health lanes
        # + load ledger (observability/health.py is the one RPL012-
        # exempt surface where per-NTP keys become label values)
        from .observability.health import HealthSampler, register_exporter

        self.health_sampler = HealthSampler(
            self.group_manager, self.load_ledger
        )
        register_exporter(self.metrics, self.health_sampler)
        # flight-data plane (observability/flightdata|alerts|profiler):
        # metrics-history ring with windowed reducers, live burn-rate
        # SLO evaluation of the bench_profiles/slo_*.json declarations,
        # and the always-on wall-stack profiler the alert auto-capture
        # snapshots from. Each piece has its own stand-down env knob.
        from .observability import alerts as _alerts
        from .observability import devplane as _devplane
        from .observability import flightdata as _flightdata
        from .observability import profiler as _profiler

        # device-plane flight data (observability/devplane.py): the
        # process-global frame/kernel/compile families join this
        # broker's registry BEFORE the history ring is built, so
        # windowed devplane quantiles feed the alert rules below
        _devplane.register(self.metrics)
        self.flightdata = _flightdata.MetricsHistory(self.metrics)
        self.profiler = _profiler.get_profiler()
        self.alerts = _alerts.AlertManager(
            self.flightdata,
            profile=config.slo_profile,
            ledger=self.load_ledger,
            profiler=self.profiler,
            registry=self.metrics,
        )
        self.alerts.rules.extend(_devplane.alert_rules())
        self.shard_table = ShardTable()
        # (chip, row) → group residue resolution for the tick frame:
        # the table is the one map that survives live lane rebinds
        self.group_manager.tick_frame.attach_table(self.shard_table, shard=0)
        # set by ssx.ShardedBroker when worker shards are active; None
        # keeps every kafka/controller shard seam on the local path
        self.shard_router = None
        self.partition_manager = PartitionManager(
            self.storage.log_mgr, self.group_manager
        )
        self.controller = Controller(
            config.node_id,
            self.group_manager,
            self.partition_manager,
            self.shard_table,
            config.members,
            send,
        )
        self.controller.authorizer.superusers = set(config.superusers or [])
        # license state follows the replicated cluster config on every
        # node (feature_manager license propagation); an invalid stored
        # value logs rather than wedging config replay
        from .security.license import LicenseService

        if config.license_public_key_file:
            with open(config.license_public_key_file, "rb") as f:
                self.license = LicenseService(public_key_pem=f.read())
        else:
            self.license = LicenseService()

        def _on_license(raw) -> None:
            raw = (raw or "").strip()
            if not raw:
                self.license.clear()
                return
            try:
                # allow_expired: a restarted node must keep reporting an
                # expired license rather than silently dropping it
                lic = self.license.load(raw, allow_expired=True)
                logging.getLogger("app").info(
                    "cluster license loaded: org=%s type=%s",
                    lic.organization, lic.type_name,
                )
            except Exception as e:
                logging.getLogger("app").warning(
                    "stored cluster license rejected: %s", e
                )

        self.controller.cluster_config.bind("cluster_license", _on_license)
        self.oidc = None
        _oidc_fields = (
            config.oidc_issuer,
            config.oidc_audience,
            config.oidc_jwks_file,
        )
        if any(_oidc_fields) and not all(_oidc_fields):
            raise ValueError(
                "OIDC config incomplete: oidc_issuer, oidc_audience and "
                "oidc_jwks_file must all be set to enable OAUTHBEARER "
                f"(got issuer={config.oidc_issuer!r}, "
                f"audience={config.oidc_audience!r}, "
                f"jwks_file={config.oidc_jwks_file!r})"
            )
        if all(_oidc_fields):
            import json as _json

            from .security.oidc import OidcAuthenticator, OidcConfig

            with open(config.oidc_jwks_file) as f:
                jwks = _json.load(f)
            self.oidc = OidcAuthenticator(
                OidcConfig(
                    issuer=config.oidc_issuer,
                    audience=config.oidc_audience,
                    jwks=jwks,
                    principal_claim=config.oidc_principal_claim,
                )
            )
        self.gssapi = None
        if bool(config.gssapi_principal) != bool(config.gssapi_keytab_file):
            raise ValueError(
                "GSSAPI config incomplete: gssapi_principal and "
                "gssapi_keytab_file must both be set"
            )
        if config.gssapi_principal:
            import json as _json

            from .security import krb5 as _krb5
            from .security.gssapi_authenticator import GssapiAuthenticator

            keytab = _krb5.Keytab()
            with open(config.gssapi_keytab_file) as f:
                for entry in _json.load(f):
                    etype = int(entry.get("etype", _krb5.AES256_CTS_HMAC_SHA1))
                    if "key_hex" in entry:
                        keytab.add(
                            _krb5.ServiceKey(
                                entry["principal"],
                                bytes.fromhex(entry["key_hex"]),
                                etype,
                                int(entry.get("kvno", 1)),
                            )
                        )
                    else:
                        keytab.add_password(
                            entry["principal"], entry["password"], etype=etype
                        )
            self.gssapi = GssapiAuthenticator(
                keytab,
                config.gssapi_principal,
                principal_mapping_rules=config.gssapi_principal_mapping_rules,
            )
        self.controller.logical_version_override = config.logical_version
        self.leaders = PartitionLeadersTable()
        self.controller.leaders_table = self.leaders
        self.metadata_cache = MetadataCache(
            self.controller.topic_table, self.partition_manager, self.leaders
        )
        self.group_coordinator = GroupCoordinator(self)
        self.tx_coordinator = TxCoordinator(self)
        self.metadata_dissemination = MetadataDissemination(self)
        self.kafka_server = KafkaServer(self)
        self.node_status = NodeStatusBackend(
            config.node_id,
            send,
            peers=lambda: self.controller.members,
            interval_s=config.node_status_interval_s,
        )
        self.node_status_service = NodeStatusService(config.node_id)
        from .cluster.self_test import (
            SelfTestBackend,
            SelfTestFrontend,
            SelfTestService,
        )

        self.self_test_backend = SelfTestBackend(
            config.node_id,
            config.data_dir,
            send,
            peers=lambda: self.controller.members,
        )
        self.self_test = SelfTestFrontend(
            config.node_id,
            self.self_test_backend,
            send,
            members=lambda: self.controller.members,
        )
        self._self_test_service = SelfTestService(self.self_test_backend)
        self.health_monitor = HealthMonitor(self)
        from .cluster.stats_reporter import StatsReporter

        self.stats_reporter = StatsReporter(
            self, interval_s=config.stats_interval_s
        )
        from .transforms import TransformService

        self.transforms = TransformService(self)
        self._register_probes()
        self.admin = AdminServer(
            self, config.admin_host, config.admin_port
        ) if config.enable_admin else None
        # weighted-fair scheduling groups for background work
        # (resource_mgmt/cpu_scheduling.h shares): compaction/archival
        # units interleave instead of monopolizing the event loop
        from .resource_mgmt import FairScheduler

        self.scheduler = FairScheduler()
        self.archival = None
        self.remote_reader = None
        self.cloud_cache = None
        if self.object_store is not None:
            from .cloud import ArchivalService, RemoteReader
            from .cloud.object_store import RetryingStore

            self.archival = ArchivalService(
                self.object_store,
                partitions=self.partition_manager.partitions,
                topic_table=self.controller.topic_table,
                interval_s=config.archival_interval_s,
                sched_group=self.scheduler.group("archival"),
                merge_min_bytes=config.cloud_storage_segment_merge_min_bytes,
                merge_target_bytes=(
                    config.cloud_storage_segment_merge_target_bytes
                ),
            )
            cache = None
            if config.cloud_storage_cache_size_bytes > 0:
                from .cloud.cache_service import CloudCache

                cache = CloudCache(
                    os.path.join(config.data_dir, "cloud_storage_cache"),
                    max_bytes=config.cloud_storage_cache_size_bytes,
                    chunk_size=config.cloud_storage_cache_chunk_size,
                    hydrate_timeout_s=config.cloud_hydration_timeout_s,
                )
            self.cloud_cache = cache
            self.remote_reader = RemoteReader(
                RetryingStore(self.object_store), cache=cache
            )
            self.archival.on_replaced = self.remote_reader.invalidate
            self.controller.on_partition_added = self._maybe_recover_partition
            from .cloud.probe import CloudProbe

            self.cloud_probe = CloudProbe(
                self.metrics,
                archival=self.archival,
                cache=cache,
                reader=self.remote_reader,
            )
        else:
            self.cloud_probe = None
        self._bind_cluster_config()
        self.pandaproxy = None
        self.schema_registry = None
        self._started = False

    def _bind_cluster_config(self) -> None:
        """Live bindings from replicated cluster config onto running
        subsystems (config/property.h:280 binding<T>). Only explicitly
        SET values override BrokerConfig — defaults never clobber what
        the operator passed at construction."""
        cfg = self.controller.cluster_config

        def bind_override(name: str, fn, original) -> None:
            """Apply SET values; restore the constructed BrokerConfig
            value when the override is removed (never let the registry
            default clobber what the operator passed at boot)."""

            def wrapper(value):
                fn(value if not cfg.is_default(name) else original)

            cfg.bind(name, wrapper)

        bind_override(
            "log_compaction_interval_s",
            lambda v: setattr(self.config, "housekeeping_interval_s", v),
            self.config.housekeeping_interval_s,
        )

        def set_archival(v):
            self.config.archival_interval_s = v
            if self.archival is not None:
                self.archival.interval_s = v

        bind_override(
            "archival_interval_s", set_archival, self.config.archival_interval_s
        )

        def set_producer_expiry(v):
            # per-broker, not process-global: loopback fixtures run
            # several brokers (even clusters) in one process
            self.partition_manager.producer_expiry_ms = v
            for p in self.partition_manager.partitions().values():
                p.producer_expiry_ms = v

        cfg.bind("producer_id_expiration_ms", set_producer_expiry)

        # node-wide raft recovery budget (ref raft_learner_recovery_rate)
        cfg.bind(
            "raft_learner_recovery_rate",
            lambda v: self.group_manager.recovery_throttle.set_rate(v),
        )

    def _register_probes(self) -> None:
        """Scrape-time gauges over live subsystem state (the probe
        objects of raft/probe.cc and kafka server probes, pull-based)."""
        m = self.metrics
        m.gauge(
            "partitions_total",
            lambda: len(self.partition_manager.partitions()),
            "Locally hosted partitions",
        )
        m.gauge(
            "partition_leaders_total",
            lambda: sum(
                1
                for p in self.partition_manager.partitions().values()
                if p.is_leader
            ),
            "Locally led partitions",
        )
        m.gauge(
            "raft_groups_total",
            lambda: len(self.group_manager.groups()),
            "Raft groups on this node",
        )
        m.gauge(
            "controller_is_leader",
            lambda: 1 if self.controller.is_leader else 0,
            "1 when this node leads raft group 0",
        )
        m.gauge(
            "cluster_members_total",
            lambda: len(self.controller.members),
            "Known cluster members",
        )
        m.gauge(
            "batch_cache_hits_total",
            lambda: self.storage.cache.hits,
            "Batch cache hits",
        )
        m.gauge(
            "batch_cache_misses_total",
            lambda: self.storage.cache.misses,
            "Batch cache misses",
        )
        m.gauge(
            "batch_cache_bytes",
            lambda: self.storage.cache.size_bytes,
            "Batch cache resident bytes",
        )
        from .resource_mgmt import MemoryGovernor

        m.gauge(
            "raft_recovery_throttled_seconds_total",
            lambda: self.group_manager.recovery_throttle.throttled_s,
            "Cumulative recovery-throttle wait (recovery_throttle.h)",
        )
        m.gauge(
            "trace_trees_total",
            lambda: self.recorder.trees_total,
            "Flight-recorder span trees completed",
        )
        m.gauge(
            "trace_slow_frozen_total",
            lambda: self.recorder.frozen_total,
            "Flight-recorder slow-request trees frozen",
        )
        m.gauge(
            "gc_pause_max_ms",
            lambda: MemoryGovernor.instance().pause_max_ms,
            "Largest collector pause since start (reactor-stall probe analog)",
        )
        m.gauge(
            "gc_gen2_collections_total",
            lambda: MemoryGovernor.instance().gen2_total,
            "Full-heap (gen2) collections since start",
        )
        m.gauge(
            "log_segments_total",
            lambda: sum(
                log.segment_count()
                for log in self.storage.log_mgr.logs().values()
            ),
            "Open log segments across all local logs",
        )
        m.gauge(
            "nodes_alive_total",
            lambda: sum(
                1
                for nid in self.controller.members
                if self.node_status.is_alive(nid)
            ),
            "Members answering liveness pings",
        )

    async def _maybe_recover_partition(self, ntp, partition) -> None:
        """Backend hook: a partition of a topic created with
        redpanda.remote.recovery seeds itself from the cloud manifest
        (cloud_storage topic recovery / partition_downloader analog)."""
        md = self.controller.topic_table.get(ntp.tp_ns)
        if md is None or str(
            md.config.get("redpanda.remote.recovery")
        ).lower() not in ("true", "1", "yes"):
            return
        from .cloud import PartitionManifest
        from .cloud.object_store import StoreError

        key = (
            f"{PartitionManifest.prefix(ntp.ns, ntp.topic, ntp.partition)}"
            "/manifest.bin"
        )
        try:
            # exists() first: a permanent miss must not spin the retry
            # backoff inside the serial reconciliation loop; the
            # wait_for bounds recovery so a wedged store cannot stall
            # the serial partition-reconciliation loop behind it
            if not await asyncio.wait_for(
                self.archival.store.exists(key), timeout=30.0
            ):
                return
            raw = await asyncio.wait_for(
                self.archival.store.get(key), timeout=30.0
            )
        except (StoreError, asyncio.TimeoutError):
            return  # store unavailable; archiver heals later
        try:
            manifest = PartitionManifest.decode(raw)
        except Exception:
            # torn store manifest: recovery must never attach dangling
            # segment references; the leader's sync pass re-exports a
            # whole manifest and a later recovery attempt succeeds
            logging.getLogger("app").warning(
                "%s: torn cloud manifest; skipping recovery", ntp
            )
            return
        # attach the archiver up-front so remote reads work immediately
        a = self.archival.archiver_for(partition)
        a.manifest = manifest
        if partition.recover_from_cloud(manifest):
            logging.getLogger("app").info(
                "%s: recovered from cloud upto offset %d",
                ntp,
                manifest.archived_upto,
            )

    def enterprise_features_in_use(self) -> list[str]:
        """Enterprise features this broker currently has configured —
        input to the license violation report (feature_manager's
        enterprise feature snapshot)."""
        used: list[str] = []
        if self.archival is not None:
            used.append("tiered_storage")
        if self.oidc is not None:
            used.append("oidc")
        if self.gssapi is not None:
            used.append("gssapi")
        return used

    def _rpc_addr_of(self, node_id: int) -> tuple[str, int]:
        """Peer RPC address: replicated members table first (dynamic
        joins), static seed map as bootstrap fallback."""
        addr = self.controller.members_table.rpc_addr(node_id)
        if addr is not None:
            return addr
        static = self.config.peer_addresses or {}
        if node_id in static:
            return static[node_id]
        raise KeyError(f"no rpc address for node {node_id}")

    # -- lifecycle ---------------------------------------------------
    async def start(self) -> None:
        # environment checks + crash-loop tracking (syschecks,
        # application.cc:357): unclean-shutdown counting is advisory;
        # an un-fsyncable data dir is fatal
        from . import syschecks

        syschecks.run_startup_checks(self.config.data_dir)
        syschecks.note_startup(self.config.data_dir)
        self.scheduler.start()
        for svc in (
            self.group_manager.service,
            self.controller.service,
            self.metadata_dissemination.service,
            self.tx_coordinator.service,
            self.node_status_service,
            self._self_test_service,
            self.controller.barrier,
        ):
            if self._rpc_server is not None:
                self._rpc_server.register(svc)
            else:
                self._dispatcher.register(svc)
        if self._rpc_server is not None:
            await self._rpc_server.start()
        await self.group_manager.start()
        await self.controller.start()
        await self.group_coordinator.start()
        await self.tx_coordinator.start()
        await self.metadata_dissemination.start()
        await self.kafka_server.start()
        if self.config.node_status_interval_s > 0:
            await self.node_status.start()
        if self.archival is not None and self.config.archival_interval_s > 0:
            await self.archival.start()
        await self.stats_reporter.start()
        # flight-data plane: history ring sampling, burn-rate alert
        # evaluation, continuous profiler — each behind its own
        # stand-down knob (RP_FLIGHTDATA/RP_ALERTS/RP_PROFILE)
        from .observability import alerts as _alerts
        from .observability import flightdata as _flightdata
        from .observability import profiler as _profiler

        if _flightdata.ENABLED:
            self.flightdata.start()
        if _profiler.ENABLED:
            self.profiler.acquire()
        if _alerts.ENABLED and _flightdata.ENABLED:
            self.alerts.start()
        await self.transforms.start()
        if self.admin is not None:
            await self.admin.start()
        self.pandaproxy = None
        self.schema_registry = None
        if self.config.enable_pandaproxy:
            from .proxy import PandaproxyServer

            self.pandaproxy = PandaproxyServer(
                self, port=self.config.pandaproxy_port
            )
            await self.pandaproxy.start()
        if self.config.enable_schema_registry:
            from .proxy import SchemaRegistryServer

            self.schema_registry = SchemaRegistryServer(
                self, port=self.config.schema_registry_port
            )
            await self.schema_registry.start()
        self._join_task = None
        if self.config.auto_join:
            self._join_task = asyncio.ensure_future(self._register_self())
        self._housekeeping_task = None
        if self.config.housekeeping_interval_s > 0:
            self._housekeeping_task = asyncio.ensure_future(
                self._housekeeping_loop()
            )
        self._gc_governor = None
        if self.config.gc_governor:
            # GC discipline: freeze the settled boot graph + rare gen2
            # passes. Measured on the replicated acks=all path:
            # 10 -> 28 MB/s, p99 233 -> 59 ms (resource_mgmt.MemoryGovernor)
            from .resource_mgmt import MemoryGovernor

            self._gc_governor = MemoryGovernor.instance()
            self._gc_governor.start(self.metrics)
        self._started = True

    async def _register_self(self) -> None:
        """Announce this node's endpoints through the controller log
        (cluster_discovery.cc startup registration). For a node not in
        the seed set this IS the join: the leader adds it to raft0."""
        rpc_addr = (
            self.config.advertised_host or self.config.rpc_host,
            self._rpc_server.port if self._rpc_server is not None else 0,
        )
        try:
            await self.controller.join_cluster(
                rpc_addr,
                self.kafka_advertised,
                rack=self.config.rack or "",
                timeout=30.0,
            )
        except Exception:
            logging.getLogger("app").exception(
                "node %d: cluster registration failed", self.node_id
            )

    async def _housekeeping_loop(self) -> None:
        """Periodic retention + compaction sweep (log_manager.h:228-244
        housekeeping timer). Each log's pass is ONE unit through the
        `compaction` scheduling group: the sweep no longer blocks the
        event loop for all partitions at once, and competing background
        groups interleave by their shares."""
        import time as _time

        group = self.scheduler.group("compaction")
        while True:
            await asyncio.sleep(self.config.housekeeping_interval_s)
            now_ms = int(_time.time() * 1000)
            for ntp, log in self.storage.log_mgr.logs().items():

                async def unit(ntp=ntp, log=log):
                    # the sweep awaits between units: a partition
                    # deleted mid-sweep must not get a retention pass
                    # on its closed, file-deleted log
                    if self.storage.log_mgr.get(ntp) is not log:
                        return
                    self.storage.log_mgr.housekeeping_one(log, now_ms)

                try:
                    await group.run(unit)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    logging.getLogger("app").exception(
                        "housekeeping pass failed"
                    )

    async def stop(self) -> None:
        if not self._started:
            return
        self._started = False
        if getattr(self, "_gc_governor", None) is not None:
            self._gc_governor.stop(self.metrics)
            self._gc_governor = None
        join_task, self._join_task = self._join_task, None
        await cancel_and_wait(join_task)
        await self.node_status.stop()
        await self.self_test_backend.stop()
        await self.transforms.stop()
        await self.stats_reporter.stop()
        from .observability import profiler as _profiler

        await self.alerts.stop()
        await self.flightdata.stop()
        if _profiler.ENABLED:
            self.profiler.release()
        pandaproxy, self.pandaproxy = self.pandaproxy, None
        if pandaproxy is not None:
            await pandaproxy.stop()
        schema_registry, self.schema_registry = self.schema_registry, None
        if schema_registry is not None:
            await schema_registry.stop()
        if self.admin is not None:
            await self.admin.stop()
        if self.archival is not None:
            await self.archival.stop()
        hk_task, self._housekeeping_task = self._housekeeping_task, None
        await cancel_and_wait(hk_task)
        await self.kafka_server.stop()
        await self.metadata_dissemination.stop()
        await self.tx_coordinator.stop()
        await self.group_coordinator.stop()
        await self.controller.stop()
        await self.group_manager.stop()
        await self.scheduler.stop()
        await self._conn_cache.close()
        if self._rpc_server is not None:
            await self._rpc_server.stop()
        store_close = getattr(self.object_store, "close", None)
        if store_close is not None:
            await store_close()  # S3 client: drain the connection pool
        self.storage.close()
        from . import syschecks

        syschecks.note_clean_stop(self.config.data_dir)

    async def send_rpc(
        self, node_id: int, method_id: int, payload: bytes, timeout: float
    ) -> bytes:
        """Internal RPC to a peer (the `send` seam the subsystems use)."""
        return await self._conn_cache.call(node_id, method_id, payload, timeout)

    @property
    def kafka_advertised(self) -> tuple[str, int]:
        host = self.config.advertised_host or self.config.kafka_host
        return host, self.kafka_server.port

    @property
    def internal_kafka_address(self) -> tuple[str, int]:
        """Where IN-BROKER clients (transforms, proxy, schema registry)
        connect; pair with internal_kafka_ssl()."""
        return self.kafka_advertised

    def internal_kafka_ssl(self):
        """ssl context for in-broker clients. Under mTLS they present
        the broker's OWN certificate; the receiving listener pins the
        internal identity to an exact (full-DER) certificate match, so
        cross-broker internal traffic under mTLS requires all brokers
        to share one certificate (or explicit ACLs for the per-broker
        cert DNs) — a DN that merely equals ours grants nothing."""
        cfg = self.config
        if cfg.kafka_tls_cert is None:
            return None
        from .security.tls import client_context

        return client_context(
            ca=cfg.kafka_tls_ca,
            cert=(
                cfg.kafka_tls_cert
                if cfg.kafka_tls_require_client_auth
                else None
            ),
            key=(
                cfg.kafka_tls_key
                if cfg.kafka_tls_require_client_auth
                else None
            ),
            check_hostname=cfg.kafka_tls_verify_hostname,
        )

    def kafka_address_of(self, node_id: int) -> Optional[tuple[str, int]]:
        if node_id == self.node_id:
            return self.kafka_advertised
        addr = self.controller.members_table.kafka_addr(node_id)
        if addr is not None:
            return addr
        peers = self.config.peer_kafka_addresses
        if peers is not None:
            return peers.get(node_id)
        return None

    async def wait_controller_leader(self, timeout: float = 10.0) -> int:
        return await self.controller.wait_leader(timeout)

    async def recover_topic_from_cloud(
        self, topic: str, ns: str = "kafka", timeout: float = 10.0
    ) -> None:
        """Disaster recovery: recreate a topic from its uploaded
        manifests (cloud_storage topic recovery). The topic is created
        with its archived config plus redpanda.remote.recovery=true;
        each replica then seeds itself from the partition manifest via
        the backend hook, so the archived range serves reads and new
        appends continue at archived_upto + 1."""
        from .cloud import TopicManifest

        if self.archival is None:
            raise RuntimeError("tiered storage is not configured")
        raw = await asyncio.wait_for(
            self.archival.store.get(TopicManifest.key_for(ns, topic)),
            timeout=30.0,
        )
        tm = TopicManifest.decode(raw)
        config = dict(tm.config)
        config["redpanda.remote.recovery"] = "true"
        await self.controller.create_topic(
            topic,
            partitions=int(tm.partition_count),
            replication_factor=int(tm.replication_factor),
            config=config,
            ns=ns,
            timeout=timeout,
        )
