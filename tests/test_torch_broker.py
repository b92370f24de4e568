"""The port's Kafka broker against the JAX package's, exact.

One three-broker cluster of each package over LoopbackNetwork, real Kafka
TCP listeners and a KafkaClient (chip_smoke.py's KafkaCluster and
broker_scenario, given either package's entry points), both under
RP_CODEC_BACKEND=device and RP_FETCH_VERIFY=1. The port's brokers run
with `device="cpu"` (the kernels' plain PyTorch versions; an autouse
fixture points the codec and CRC modules' DEFAULT_DEVICE at the CPU),
the JAX package's with its default quorum backend on the CPU. Both get
the same seeded traffic: a topic of 4 partitions with
compression.type=lz4 and an uncompressed topic of 2, RF=3, batches of
16 x 1 KiB records (half JSON-like, half random), acks=-1. Compared,
exactly: the produce base offsets, the high watermarks, the records
fetched back, the stored batch bodies of both topics (the fused LZ4
programs of the two packages are byte-equal) and node 0's
health_report. The port's run also counts its seams: one fused CRC +
LZ4 call for each lz4 batch, one CRC verify for each fetch response with
records.

A broker's data_dir carries across the packages both ways: a broker of
one package creates topics and takes traffic, stops, and a broker of the
other serves the same topics (the controller log's topic table) and the
same fetches from that directory.
"""

import asyncio

import pytest

import chip_smoke as cs
from redpanda_tpu_torch.ops import crc32c as crc_ops
from redpanda_tpu_torch.ops import fused as fused_ops
from redpanda_tpu_torch.ops import lz4 as lz4_ops
from redpanda_tpu_torch.ops import snappy as snappy_ops
from redpanda_tpu_torch.ops import zstd as zstd_ops

SEED = 20_260_118
LZ4, PLAIN = ("lz4-t", 4, {"compression.type": "lz4"}), ("plain-t", 2, {})
TOPICS = [LZ4, PLAIN]
# the port's plain fused chain takes about a second a batch on the CPU:
# 6 lz4 batches and 6 uncompressed ones
BATCHES = 12


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    for mod in (lz4_ops, snappy_ops, zstd_ops, fused_ops, crc_ops):
        monkeypatch.setattr(mod, "DEFAULT_DEVICE", "cpu")


def ref_broker():
    """The JAX package's Kafka entry points, as KafkaCluster takes them."""
    from types import SimpleNamespace

    from redpanda_tpu.app import Broker, BrokerConfig
    from redpanda_tpu.kafka.client import KafkaClient, KafkaClientError
    from redpanda_tpu.models.fundamental import kafka_ntp
    from redpanda_tpu.raft.consensus import NotLeaderError
    from redpanda_tpu.rpc.loopback import LoopbackNetwork

    return SimpleNamespace(Broker=Broker, BrokerConfig=BrokerConfig, KafkaClient=KafkaClient,
                           KafkaClientError=KafkaClientError, LoopbackNetwork=LoopbackNetwork,
                           kafka_ntp=kafka_ntp, NotLeaderError=NotLeaderError)


def _batches():
    return cs.broker_batches(SEED, [(name, parts) for name, parts, _ in TOPICS], BATCHES)


def _count_calls(monkeypatch, module, name: str) -> list:
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_broker_matches_jax_package(tmp_path, monkeypatch):
    batches = _batches()
    stored = [(name, parts) for name, parts, _ in TOPICS]
    with cs.environ(cs.BROKER_DEVICE_ENV):
        ref = asyncio.run(cs.broker_scenario(ref_broker(), str(tmp_path / "ref"), TOPICS, batches, stored=stored))
        # the port's two seams, counted where the broker calls them
        fused_calls = _count_calls(monkeypatch, fused_ops, "crc_lz4_fused")
        verify_calls = _count_calls(monkeypatch, crc_ops, "crc32c_batch_device")
        phases = {}

        def mark(phase):
            phases[phase] = (len(fused_calls), len(verify_calls))

        port = asyncio.run(cs.broker_scenario(cs.port_broker(), str(tmp_path / "port"), TOPICS, batches,
                                              on_phase=mark, stored=stored, device="cpu"))
    lz4_batches = sum(1 for name, *_ in batches if name == LZ4[0])
    assert phases["fetch"][0] - phases["produce"][0] == lz4_batches
    assert phases["end"][1] - phases["fetch"][1] == port["fetch_responses"] > 0
    assert port["bases"] == ref["bases"]
    assert port["hwm"] == ref["hwm"]
    assert port["records"] == ref["records"]
    assert port["stored"] == ref["stored"]
    codecs = {codec for (name, _), rows in port["stored"].items() if name == LZ4[0] for codec, _ in rows}
    assert codecs == {3}  # every stored batch of the lz4 topic is LZ4
    assert port["health"] == ref["health"]
    assert port["health"]["active"] == 1 + sum(parts for _, parts, _ in TOPICS)


async def _serve(pkg, data_dir: str, topics, batches=None, **cfg) -> dict:
    """One single-node cluster of `pkg` on data_dir: create `topics` and
    produce `batches` when given, else find the topics there; then the
    topic table and every record fetched back."""
    cluster = cs.KafkaCluster(pkg, data_dir, nodes=1, **cfg)
    try:
        await cluster.start()
        bases = None
        if batches is not None:
            await cluster.create(topics, rf=1)
            bases = (await cluster.produce(batches))["bases"]
        else:
            await cluster.place(topics)
        out = await cluster.fetch_all(topics)
        out["bases"] = bases
        # the controller log's topic table, keyed "ns/topic" (each
        # package has its own TopicNamespace class)
        out["table"] = {
            str(ns): (md.partition_count, md.replication_factor, dict(md.config),
                      {p: list(a.replicas) for p, a in md.assignments.items()})
            for ns, md in cluster.brokers[0].controller.topic_table.topics().items()
        }
    finally:
        await cluster.stop()
    return out


@pytest.mark.parametrize("first,then", [("jax", "port"), ("port", "jax")])
def test_data_dir_carries_across_packages(tmp_path, first, then):
    pkgs = {"jax": (ref_broker(), {}), "port": (cs.port_broker(), {"device": "cpu"})}
    topics = [("carry-lz4", 2, {"compression.type": "lz4"}), ("carry-plain", 1, {})]
    batches = cs.broker_batches(SEED + 1, [(n, p) for n, p, _ in topics], 6)
    data_dir = str(tmp_path / "broker")
    with cs.environ(cs.BROKER_DEVICE_ENV):
        pkg, cfg = pkgs[first]
        before = asyncio.run(_serve(pkg, data_dir, topics, batches, **cfg))
        pkg, cfg = pkgs[then]
        after = asyncio.run(_serve(pkg, data_dir, topics, **cfg))
    cs.check_broker_run(before, batches, topics)
    assert after["table"] == before["table"]
    assert after["table"]["kafka/carry-lz4"][:3] == (2, 1, {"compression.type": "lz4"})
    assert after["hwm"] == before["hwm"]
    assert after["records"] == before["records"]



def test_phase_13_runs_on_the_cpu():
    """chip_smoke's phase 13 (run_broker: the device leg's seams, then
    the host leg, on the same batches) at a small size on the CPU: both
    legs acknowledge, store and fetch back every record alike."""
    run = cs.run_broker("cpu", partitions=4, count=8)
    assert run["batches"] == 8 and run["fetch_responses"] > 0
    assert run["records"] == run["host"]["records"]
    assert run["bases"] == run["host"]["bases"] and run["hwm"] == run["host"]["hwm"]
    assert run["health"] == run["host"]["health"]
