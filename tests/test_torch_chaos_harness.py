"""tests/chaos_harness.py on the port: ChaosCluster, SeqProducer,
validate, run_chaos and _validate_tiered with imports pointed at
redpanda_tpu_torch. Its additions: ChaosCluster and run_chaos take
`device` (default "cpu"), passed to every BrokerConfig; run_chaos takes
`topic_configs`, merged into the chaos topic's configs; and
_validate_tiered holds a zstd-archived object
(RP_ARCHIVE_COMPRESSION=zstd) to its manifest's `size_compressed`, the
size stored, where the reference's check, which never meets a
compressed archive, reads `size_bytes`, the segment's logical size. No
case lives here; chip_smoke.py's phase 15 drives it on the card.

Chaos harness: faults injected into a live cluster under load, with
cluster-wide invariant checks.

Reference: tests/rptest/services/failure_injector.py:142-214 (kill /
suspend / isolate a broker during traffic) and the consistency
validations of rptest's produce-consume-validator workloads. In-process
analog: network partitions via LoopbackNetwork.isolate, crashes via
Broker.stop + a fresh Broker over the SAME data dir (kill -9 then
restart), leadership churn via raft transfer.

Invariants checked:
  I1  every ACKED record is readable at its acked offset (committed
      data survives every fault)
  I2  a partition's high watermark never regresses below an acked
      offset (no un-commit)
  I3  offsets are served in order with no duplicates at distinct
      offsets per fetch
"""

from __future__ import annotations

import asyncio
import contextlib
import random

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.kafka.client import KafkaClient, KafkaClientError
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork


class ChaosCluster:
    def __init__(self, tmp_path, n: int = 3, object_store=None, device: str = "cpu"):
        self.tmp = tmp_path
        self.n = n
        self.device = device
        self.net = LoopbackNetwork()
        self.brokers: dict[int, Broker] = {}
        self.object_store = object_store

    def _config(self, nid: int) -> BrokerConfig:
        return BrokerConfig(
            node_id=nid,
            data_dir=str(self.tmp / f"n{nid}"),
            members=list(range(self.n)),
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
            node_status_interval_s=0.2,
            enable_admin=False,
            housekeeping_interval_s=0 if self.object_store else 10.0,
            archival_interval_s=0,
            device=self.device,
        )

    def _make_broker(self, nid: int) -> Broker:
        return Broker(
            self._config(nid),
            loopback=self.net,
            object_store=self.object_store,
        )

    async def start(self) -> None:
        for nid in range(self.n):
            b = self._make_broker(nid)
            self.brokers[nid] = b
            await b.start()
        addrs = {b.node_id: b.kafka_advertised for b in self.brokers.values()}
        for b in self.brokers.values():
            b.config.peer_kafka_addresses = dict(addrs)
        await self.brokers[0].wait_controller_leader()

    async def stop(self) -> None:
        for b in self.brokers.values():
            await b.stop()

    async def crash(self, nid: int) -> None:
        """kill -9: stop serving immediately; data stays on disk."""
        await self.brokers[nid].stop()

    async def restart(self, nid: int) -> None:
        """Boot a fresh broker process over the surviving data dir."""
        b = self._make_broker(nid)
        self.brokers[nid] = b
        await b.start()
        addrs = {
            x.node_id: x.kafka_advertised for x in self.brokers.values()
        }
        for x in self.brokers.values():
            x.config.peer_kafka_addresses = dict(addrs)

    def partition_network(self, nid: int) -> None:
        self.net.isolate(nid)

    def heal_network(self) -> None:
        self.net.heal()

    def addresses(self) -> list[tuple[str, int]]:
        return [b.kafka_advertised for b in self.brokers.values()]


class SeqProducer:
    """Producer of sequenced records; remembers every ACK as
    (partition, offset, seq) — the ground truth the validator holds
    the cluster to."""

    def __init__(self, cluster: ChaosCluster, topic: str, partitions: int):
        self.cluster = cluster
        self.topic = topic
        self.partitions = partitions
        self.acked: list[tuple[int, int, int]] = []
        self.attempts = 0
        self._seq = 0
        self._stop = False

    async def run(self) -> None:
        client = KafkaClient(self.cluster.addresses())
        try:
            while not self._stop:
                seq = self._seq
                self._seq += 1
                pid = seq % self.partitions
                self.attempts += 1
                try:
                    off = await asyncio.wait_for(
                        client.produce(
                            self.topic,
                            pid,
                            [(b"seq-%d" % seq, b"payload-%d" % seq)],
                            acks=-1,
                        ),
                        timeout=3.0,
                    )
                    self.acked.append((pid, off, seq))
                except (KafkaClientError, asyncio.TimeoutError, OSError):
                    # unacked: may or may not be committed — the
                    # validator makes no claim about it
                    with contextlib.suppress(Exception):
                        await client.close()
                    client = KafkaClient(self.cluster.addresses())
                await asyncio.sleep(0.01)
        finally:
            with contextlib.suppress(Exception):
                await client.close()

    def stop(self) -> None:
        self._stop = True


async def validate(
    cluster: ChaosCluster, topic: str, partitions: int, producer: SeqProducer
) -> dict:
    """Post-chaos invariant sweep (see module docstring)."""
    client = KafkaClient(cluster.addresses())
    by_partition: dict[int, dict[int, int]] = {}
    for pid, off, seq in producer.acked:
        by_partition.setdefault(pid, {})[off] = seq
    stats = {"acked": len(producer.acked), "attempts": producer.attempts}
    try:
        for pid in range(partitions):
            got = await client.fetch(
                topic, pid, 0, max_bytes=1 << 24, max_wait_ms=100
            )
            offsets = [o for o, _k, _v in got]
            # I3: order + uniqueness
            assert offsets == sorted(set(offsets)), (
                f"p{pid}: unordered or duplicated offsets"
            )
            seen = {o: (k, v) for o, k, v in got}
            hw_top = max(offsets) if offsets else -1
            for off, seq in by_partition.get(pid, {}).items():
                # I2: no acked offset above the final high watermark
                assert off <= hw_top, (
                    f"p{pid}: acked offset {off} (seq {seq}) beyond "
                    f"final watermark {hw_top} — committed data lost"
                )
                # I1: the acked record is THE record at that offset
                entry = seen.get(off)
                assert entry is not None, (
                    f"p{pid}@{off}: acked seq {seq} missing from fetch "
                    f"below watermark {hw_top} — committed data lost"
                )
                k, v = entry
                assert k == b"seq-%d" % seq and v == b"payload-%d" % seq, (
                    f"p{pid}@{off}: expected seq {seq}, found {k!r}"
                )
    finally:
        await client.close()
    return stats


async def transfer_random_leadership(
    cluster: ChaosCluster, rng: random.Random, topic: str | None = None
) -> bool:
    """Pick a random led partition (optionally restricted to `topic`)
    and hand leadership to a random peer. Shared by the fault loop and
    the admin-ops fuzzer."""
    for b in cluster.brokers.values():
        parts = [
            p
            for p in b.partition_manager.partitions().values()
            if p.is_leader and (topic is None or p.ntp.topic == topic)
        ]
        if parts:
            p = rng.choice(parts)
            peers = p.consensus.peers()
            if peers:
                with contextlib.suppress(Exception):
                    await asyncio.wait_for(
                        p.consensus.transfer_leadership(rng.choice(peers)),
                        timeout=3.0,
                    )
            return True
    return False


async def admin_ops_fuzzer(
    cluster: ChaosCluster, rng: random.Random, stop: list
) -> dict:
    """Randomized admin-plane churn DURING the replicated workload
    (ref: rptest/services/admin_ops_fuzzer.py): aux-topic create/
    delete, config alters, partition grows, leadership transfers —
    every op either succeeds or fails with a clean client error while
    the main topic's acked-data invariants must keep holding."""
    counts: dict[str, int] = {}
    aux: list[str] = []
    n_created = 0
    client = KafkaClient(cluster.addresses())
    try:
        while not stop[0]:
            op = rng.choice(
                ("create", "delete", "alter", "grow", "transfer", "describe")
            )
            counts[op] = counts.get(op, 0) + 1
            try:
                if op == "create":
                    name = f"fuzz-{n_created}"
                    n_created += 1
                    await asyncio.wait_for(
                        client.create_topic(
                            name,
                            partitions=rng.randrange(1, 3),
                            replication_factor=3,
                        ),
                        timeout=3.0,
                    )
                    aux.append(name)
                elif op == "delete" and aux:
                    name = aux.pop(rng.randrange(len(aux)))
                    await asyncio.wait_for(
                        client.delete_topic(name), timeout=3.0
                    )
                elif op == "alter" and aux:
                    name = rng.choice(aux)
                    await asyncio.wait_for(
                        client.alter_topic_configs(
                            name,
                            {
                                "retention.ms": str(
                                    rng.randrange(10000, 100000000)
                                )
                            },
                        ),
                        timeout=3.0,
                    )
                elif op == "grow" and aux:
                    name = rng.choice(aux)
                    await asyncio.wait_for(
                        client.create_partitions(name, rng.randrange(2, 5)),
                        timeout=3.0,
                    )
                elif op == "transfer":
                    await transfer_random_leadership(cluster, rng)
                elif op == "describe" and aux:
                    await asyncio.wait_for(
                        client.describe_configs(rng.choice(aux)), timeout=3.0
                    )
            except (KafkaClientError, asyncio.TimeoutError, OSError):
                # clean failure under faults is fine; crashes are not
                counts["errors"] = counts.get("errors", 0) + 1
                with contextlib.suppress(Exception):
                    await client.close()
                client = KafkaClient(cluster.addresses())
            await asyncio.sleep(rng.uniform(0.05, 0.2))
    finally:
        with contextlib.suppress(Exception):
            await client.close()
    return counts


async def run_chaos(
    tmp_path,
    seed: int,
    duration_s: float = 6.0,
    partitions: int = 2,
    faults=("partition", "crash", "transfer"),
    tiered: bool = False,
    admin_ops: bool = False,
    nemesis=None,
    store_faults=None,
    device: str = "cpu",
    topic_configs: dict | None = None,
) -> dict:
    """`tiered=True` runs the same fault schedule against a
    remote.write topic with aggressive segment roll + retention, with
    archival passes + housekeeping churning THROUGHOUT the faults —
    the validator's fetch-from-0 then crosses the remote/local seam,
    so I1..I3 hold the whole tiered read path to the acked ground
    truth, and the replicated archival boundary is checked for
    cluster-wide agreement afterwards.

    `nemesis` (an rpc.loopback.NemesisSchedule) arms probabilistic
    link faults — drop/dup/reorder/jitter/corrupt — for the whole
    fault window; it is cleared (like a heal) before the settle +
    validate phase, and its firing counts ride back in the stats. To
    replay a run byte-identically, rebuild the same schedule with the
    same seed (see README "Fault injection").

    `store_faults` (a cloud.nemesis.StoreFaultSchedule, tiered only)
    arms the object-store nemesis for the fault window — partial
    uploads, torn manifests, throttles, slow links, wedged gets — and
    is cleared before the settle sweeps so the post-chaos validation
    examines a healed store. Its firing counts and trace length ride
    back in the stats; `cloud.nemesis.replay_trace` rebuilds the trace
    byte-equal from (rules, seed, recorded op sequence)."""
    rng = random.Random(seed)
    store = None
    if store_faults is not None and not tiered:
        raise ValueError("store_faults requires tiered=True")
    if tiered:
        from redpanda_tpu_torch.cloud import MemoryObjectStore, NemesisObjectStore

        store = MemoryObjectStore()
        if store_faults is not None:
            store = NemesisObjectStore(store, store_faults)
    cluster = ChaosCluster(tmp_path, n=3, object_store=store, device=device)
    await cluster.start()
    if nemesis is not None:
        cluster.net.install_nemesis(nemesis)
    housekeeper: asyncio.Task | None = None
    try:
        boot = KafkaClient(cluster.addresses())
        configs = None
        if tiered:
            configs = {
                "redpanda.remote.write": "true",
                "redpanda.remote.read": "true",
                "segment.bytes": "600",
                "retention.bytes": "600",
            }
        if topic_configs:
            configs = {**(configs or {}), **topic_configs}
        await boot.create_topic(
            "chaos",
            partitions=partitions,
            replication_factor=3,
            configs=configs,
        )
        await boot.close()

        if tiered:

            async def _housekeep() -> None:
                while True:
                    await asyncio.sleep(0.25)
                    for b in list(cluster.brokers.values()):
                        # bound each pass: an upload whose replicate
                        # straddles a leadership change can wait out
                        # its full raft timeout — that must not wedge
                        # the sweep for the whole chaos window
                        with contextlib.suppress(Exception):
                            await asyncio.wait_for(
                                b.archival.run_once(), timeout=1.5
                            )
                        with contextlib.suppress(Exception):
                            b.storage.log_mgr.housekeeping()

            housekeeper = asyncio.ensure_future(_housekeep())
        producer = SeqProducer(cluster, "chaos", partitions)
        ptask = asyncio.ensure_future(producer.run())
        fuzz_stop = [False]
        fuzz_task = None
        if admin_ops:
            fuzz_task = asyncio.ensure_future(
                admin_ops_fuzzer(cluster, random.Random(seed ^ 0x5EED), fuzz_stop)
            )

        deadline = asyncio.get_event_loop().time() + duration_s
        down: int | None = None
        events = []
        while asyncio.get_event_loop().time() < deadline:
            await asyncio.sleep(rng.uniform(0.4, 0.9))
            action = rng.choice(faults)
            if down is not None:
                # one fault at a time: heal/restart before the next
                # (a 3-node RF3 cluster tolerates exactly one failure)
                if events and events[-1][0] == "crash":
                    await cluster.restart(down)
                else:
                    cluster.heal_network()
                events.append(("recover", down))
                down = None
                continue
            victim = rng.randrange(cluster.n)
            if action == "partition":
                cluster.partition_network(victim)
                events.append(("partition", victim))
                down = victim
            elif action == "crash":
                await cluster.crash(victim)
                events.append(("crash", victim))
                down = victim
            elif action == "transfer":
                await transfer_random_leadership(cluster, rng, topic="chaos")
                events.append(("transfer", -1))

        # heal everything, let the cluster settle, then validate
        if down is not None:
            if events and events[-1][0] == "crash":
                await cluster.restart(down)
            else:
                cluster.heal_network()
        cluster.heal_network()
        if nemesis is not None:
            cluster.net.clear_nemesis()  # the nemesis heals too
        if store_faults is not None:
            store.clear()  # the object store heals too
        await asyncio.sleep(1.0)
        producer.stop()
        fuzz_stop[0] = True
        with contextlib.suppress(Exception):
            await asyncio.wait_for(ptask, timeout=5.0)
        if fuzz_task is not None:
            # only a hang is tolerable here: a fuzzer crash means the
            # admin sweep silently didn't run — surface it
            admin_counts = {}
            with contextlib.suppress(asyncio.TimeoutError):
                admin_counts = await asyncio.wait_for(fuzz_task, timeout=8.0)
        await asyncio.sleep(0.5)
        stats = await validate(cluster, "chaos", partitions, producer)
        stats["events"] = events
        if nemesis is not None:
            stats["nemesis"] = dict(nemesis.injected)
            stats["nemesis_trace_len"] = len(nemesis.trace)
        if store_faults is not None:
            stats["store_faults"] = dict(store_faults.injected)
            stats["store_trace_len"] = len(store_faults.trace)
            stats["store_ops"] = len(store_faults.ops)
        if fuzz_task is not None:
            stats["admin_ops"] = admin_counts
        if tiered:
            if housekeeper is not None:
                housekeeper.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await housekeeper
                housekeeper = None
            # healed-cluster settle sweeps: uploads that were cut off
            # mid-fault finish now, so the post-chaos checks examine a
            # converged tiered state (skew healing included)
            for _ in range(4):
                for b in list(cluster.brokers.values()):
                    with contextlib.suppress(Exception):
                        await asyncio.wait_for(
                            b.archival.run_once(), timeout=5.0
                        )
                    with contextlib.suppress(Exception):
                        b.storage.log_mgr.housekeeping()
                await asyncio.sleep(0.2)
            stats.update(
                await _validate_tiered(cluster, store, "chaos", partitions)
            )
        return stats
    finally:
        if housekeeper is not None:
            housekeeper.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await housekeeper
        await cluster.stop()


async def _validate_tiered(cluster, store, topic, partitions) -> dict:
    """Post-chaos tiered checks: retention actually trimmed behind the
    archived boundary somewhere (the seam was exercised), every
    manifest-listed segment object exists, and no replica claims an
    archived boundary beyond what the object store can back — the
    independent reference that catches a replica applying uncommitted
    archived-facts (which would let retention reclaim unarchived
    data)."""
    from redpanda_tpu_torch.cloud.manifest import PartitionManifest
    from redpanda_tpu_torch.models.fundamental import DEFAULT_NS, kafka_ntp

    trimmed = 0
    archived = 0
    for pid in range(partitions):
        store_key = (
            f"{PartitionManifest.prefix(DEFAULT_NS, topic, pid)}/manifest.bin"
        )
        store_upto = -1
        if await store.exists(store_key):
            store_upto = PartitionManifest.decode(
                await store.get(store_key)
            ).archived_upto
        for nid, b in cluster.brokers.items():
            p = b.partition_manager.get(kafka_ntp(topic, pid))
            if p is None:
                continue
            p.archival.apply_committed(p.consensus.commit_index)
            v = p.archival.archived_upto
            # independent reference: after the settle sweeps exported
            # the manifest, no replica may claim more archived than
            # the store records
            assert v <= store_upto, (
                f"p{pid}: node {nid} claims archived_upto {v} beyond "
                f"the store manifest's {store_upto}"
            )
            if p.log.offsets().start_offset > 0:
                trimmed += 1
            m = p.cloud_manifest()
            if m is not None:
                for meta in m.segments:
                    key = m.segment_key(meta)
                    assert await store.exists(key), (
                        f"p{pid}: manifest references missing object "
                        f"{key}"
                    )
                    size = await store.head(key)
                    # a zstd-archived segment's object is its compressed
                    # size (size_compressed); size_bytes stays the
                    # segment's logical size (cloud/manifest.py)
                    stored = meta.size_compressed or meta.size_bytes
                    assert size == stored, (
                        f"p{pid}: manifest references truncated object "
                        f"{key}: {size} of {stored} bytes"
                    )
        if store_upto >= 0:
            archived += 1
    return {"tiered_trimmed": trimmed, "tiered_archived": archived}
