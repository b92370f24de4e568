"""The port's brokers on a zstd topic and a codec-mismatch topic against
the JAX package's, exact.

One three-broker cluster of each package over LoopbackNetwork with real
Kafka TCP listeners (chip_smoke.py's KafkaCluster and broker_scenario,
given either package's entry points), both under RP_ZSTD_BACKEND=tpu
(the zstd codec's device leg), RP_CODEC_BACKEND=device and
RP_FETCH_VERIFY=1: the port's brokers on `device="cpu"` (the kernels'
plain PyTorch versions; an autouse fixture points `ops.default_device`
at the CPU), the JAX package's on the CPU. Both get the same seeded
traffic at RF=3, acks=-1: uncompressed batches of 16 x 1 KiB records
(half JSON-like, half random) to a topic of 4 partitions with
compression.type=zstd, which each leader recompresses with the device
zstd encode, then JSON-like batches the producer compressed with zstd
(the port's RecordBatchBuilder under RP_ZSTD_BACKEND=tpu) to a topic of
2 partitions with compression.type=lz4, which each leader decodes with
the device zstd decode and re-encodes with the fused CRC + LZ4 program.
Compared, exactly: the produce base offsets, the high watermarks, the
records fetched back and the stored batch bytes of both topics (both
packages' zstd encodes, and their fused LZ4 programs, are byte-equal).
"""

import asyncio

import pytest

import chip_smoke as cs
from redpanda_tpu_torch.compression import CompressionType
from redpanda_tpu_torch.ops import default_device

SEED = 20_260_120
ZSTD_T, MISMATCH_T = ("zstd-t", 4, {"compression.type": "zstd"}), ("mismatch-t", 2, {"compression.type": "lz4"})
TOPICS = [ZSTD_T, MISMATCH_T]
BATCHES, MISMATCH = 8, 4


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


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


def _warm_reference(batches) -> None:
    """The JAX package's recompression and decode of every batch once,
    outside its brokers: a program's first call compiles for seconds on
    the CPU, and inside a broker that stalls the shared event loop past
    the produce timeout."""
    from redpanda_tpu.compression import CompressionType as RefCodec
    from redpanda_tpu.models.record import RecordBatch

    for name, _, wire, _ in batches:
        b = RecordBatch.from_kafka_wire(wire)
        out = b.recompressed(RefCodec.zstd if name == ZSTD_T[0] else RefCodec.lz4, verify_crc=b.header.crc)
        out.records()


def test_zstd_topics_match_jax_package(tmp_path):
    a1 = cs.broker_batches(SEED, [ZSTD_T[:2]], BATCHES)
    stored = [(name, parts) for name, parts, _ in TOPICS]
    with cs.environ(cs.SEAMS_ENV_A):
        a2 = cs.broker_batches(SEED + 1, [MISMATCH_T[:2]], MISMATCH, compression=CompressionType.zstd,
                               json_only=True)
        _warm_reference(a1 + a2)
        ref = asyncio.run(cs.broker_scenario(ref_broker(), str(tmp_path / "ref"), TOPICS, a1, stored=stored,
                                             then=a2))
        port = asyncio.run(cs.broker_scenario(cs.port_broker(), str(tmp_path / "port"), TOPICS, a1, stored=stored,
                                              then=a2, device="cpu"))
    assert port["bases"] == ref["bases"]
    assert port["then"]["bases"] == ref["then"]["bases"]
    assert port["hwm"] == ref["hwm"]
    assert port["records"] == ref["records"]
    assert port["stored"] == ref["stored"]
    codecs = {name: {codec for (n, _), rows in port["stored"].items() if n == name for codec, _ in rows}
              for name, _, _ in TOPICS}
    assert codecs == {ZSTD_T[0]: {int(CompressionType.zstd)}, MISMATCH_T[0]: {int(CompressionType.lz4)}}
    # every stored zstd batch decodes through libzstd to the body sent
    assert cs.check_zstd_stored(port["stored"], a1, int(CompressionType.zstd)) == BATCHES
