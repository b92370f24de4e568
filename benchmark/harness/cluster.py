"""The system under test: `app.Broker`s of the port in this process,
over loopback internal RPC (no injected delay between nodes), each with
its real Kafka TCP listener.

A frozen copy of chip_smoke.py's `KafkaCluster` start-up, leader
placement and replica read-back, so that a later change there cannot
move the benchmark. Everything of the port is reached through `pkg`
(see `port`), imported only once the run has checked for a card.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import time
from types import SimpleNamespace


def port() -> SimpleNamespace:
    """The port's entry points the cluster uses."""
    from redpanda_tpu_torch.app import Broker, BrokerConfig
    from redpanda_tpu_torch.kafka.client import KafkaClient
    from redpanda_tpu_torch.models.fundamental import kafka_ntp
    from redpanda_tpu_torch.raft.consensus import NotLeaderError
    from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

    return SimpleNamespace(Broker=Broker, BrokerConfig=BrokerConfig, KafkaClient=KafkaClient,
                           kafka_ntp=kafka_ntp, NotLeaderError=NotLeaderError, LoopbackNetwork=LoopbackNetwork)


class Cluster:
    def __init__(self, pkg, data_dir: str, nodes: int, **cfg):
        self.pkg, self.data_dir, self.nodes, self.cfg = pkg, data_dir, nodes, cfg
        self.brokers: list = []
        self.client = None

    async def start(self) -> None:
        net = self.pkg.LoopbackNetwork()
        members = list(range(self.nodes))
        for i in members:
            cfg = self.pkg.BrokerConfig(node_id=i, data_dir=os.path.join(self.data_dir, f"node{i}"),
                                        members=members, **self.cfg)
            self.brokers.append(self.pkg.Broker(cfg, loopback=net))
        for b in self.brokers:
            # leaders are placed by `create`; the controller's leader
            # balancer would move one mid-window
            b.controller.leader_balancer_enabled = False
            await b.start()
        addrs = {b.node_id: b.kafka_advertised for b in self.brokers}
        for b in self.brokers:
            b.config.peer_kafka_addresses = addrs
        await self.brokers[0].wait_controller_leader(timeout=60.0)
        self.client = self.pkg.KafkaClient([b.kafka_advertised for b in self.brokers])

    def bootstrap(self) -> list:
        return [list(b.kafka_advertised) for b in self.brokers]

    def replicas(self, what) -> list:
        if what == "controller":
            return [b.controller for b in self.brokers]
        return [b.partition_manager.get(self.pkg.kafka_ntp(*what)) for b in self.brokers]

    async def create(self, topic: str, partitions: int, rf: int, configs: dict) -> None:
        """Create the topic, then lead the controller from node 0 and
        partition p from node p % nodes (or its first replica where RF
        leaves that node out), so two runs lead alike."""
        await self.client.create_topic(topic, partitions=partitions, replication_factor=rf, configs=configs)
        await self.lead("controller", 0, self.nodes)
        for p in range(partitions):
            await self.lead((topic, p), p % self.nodes, rf)
        await self.client.metadata([topic])

    async def lead(self, what, target: int, rf: int, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        while True:
            reps = self.replicas(what)
            have = [i for i, r in enumerate(reps) if r is not None]
            if len(have) >= rf:
                node = target if reps[target] is not None else have[0]
                if reps[node].is_leader:
                    return
                leader = next((r for r in reps if r is not None and r.is_leader), None)
                if leader is not None:
                    with contextlib.suppress(self.pkg.NotLeaderError, TimeoutError):
                        await leader.consensus.transfer_leadership(node)
            if time.monotonic() > deadline:
                raise TimeoutError(f"{what}: node {target} never became leader")
            await asyncio.sleep(0.02)

    def stored(self, topic: str, partitions: int) -> dict:
        """{partition: [one list a node, None where the node holds no
        replica]}: each replica's data batches in log order as
        (kafka-visible header fields, body bytes)."""
        out = {}
        for p in range(partitions):
            rows = []
            for rep in self.replicas((topic, p)):
                if rep is None:
                    rows.append(None)
                    continue
                batches = []
                for b in rep.log.read(0, max_bytes=1 << 62):
                    if b.header.type.name != "raft_data":
                        continue
                    h = b.header
                    batches.append(((h.crc & 0xFFFFFFFF, h.attrs, h.last_offset_delta, h.first_timestamp,
                                     h.max_timestamp, h.producer_id, h.producer_epoch, h.base_sequence,
                                     h.record_count), bytes(b.body)))
                rows.append(batches)
            out[p] = rows
        return out

    def histograms(self) -> list:
        """Each broker's histogram families as {name: [(labels, sum,
        count)]}."""
        out = []
        for b in self.brokers:
            fams = {}
            for name, h in b.metrics.histograms().items():
                fams[name] = [(labels, *child.counts()[2:]) for labels, child in h.series()]
            out.append(fams)
        return out

    async def stop(self) -> None:
        if self.client is not None:
            await self.client.close()
            self.client = None
        for b in self.brokers:
            await b.stop()
        self.brokers = []
