"""The port stands alone and never falls back to the CPU quietly.

* redpanda_tpu_torch and chip_smoke.py import neither jax nor anything
  of redpanda_tpu: checked in a fresh interpreter (this process has
  jax loaded by tests/conftest.py) and by an AST scan of the sources.
* Without a CUDA device, the default device path raises instead of
  running the plain versions on the CPU (the mesh backend, the ring
  cluster step, a GroupManager and a Kafka Broker included), and
  chip_smoke.py exits non-zero without printing a result.
* ops.default_device reaches the callers that pass no device: the
  broker's fetch verify and models/record.batch_crcs.
* No kernel wrapper holds a try statement that could route a CUDA
  tensor to its plain version.
* The zstd leg's punt to the host codec sees only the host walk's
  ZstdFormatError: a decode failure propagates.
"""

import ast
import json
import os
import pathlib
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import redpanda_tpu_torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "redpanda_tpu_torch"


def _modules():
    names = [redpanda_tpu_torch.__name__]
    for info in pkgutil.walk_packages(redpanda_tpu_torch.__path__, "redpanda_tpu_torch."):
        names.append(info.name)
    return names


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "redpanda_tpu")


# modules every later check must reach (the device-plane telemetry and
# the host modules it stands on; the Raft layer: storage, rpc, the
# consensus, heartbeat and group managers and the utils they import)
RAFT_LAYER = (
    *(f"redpanda_tpu_torch.utils.{m}" for m in ("rpsan", "spans", "hbadger", "retry_chain", "token_bucket")),
    *(f"redpanda_tpu_torch.storage{m}" for m in (
        "", ".dirsync", ".iofaults", ".file_sanitizer", ".flush_coalescer", ".probe", ".snapshot", ".kvstore",
        ".batch_cache", ".segment", ".compaction", ".log", ".log_manager")),
    *(f"redpanda_tpu_torch.rpc{m}" for m in (
        "", ".types", ".tracectx", ".transport", ".connection_cache", ".server", ".loopback")),
    *(f"redpanda_tpu_torch.raft.{m}" for m in (
        "types", "configuration", "snapshot", "probe", "offset_translator", "recovery", "state_machine",
        "append_aggregator", "consensus", "replicate_batcher", "heartbeat_manager", "service", "group_manager")),
)
# the Kafka broker: app.Broker with cluster/, kafka/, cloud/, placement/,
# ssx/ and the host leaves they import
BROKER = tuple(f"redpanda_tpu_torch.{m}" for m in (
    "config", "config.properties", "security", "security.acl", "security.scram", "security.license",
    "utils.hdr_hist", "resource_mgmt", "syschecks", "observability.profiler", "httpd",
    "placement", "placement.envelopes", "placement.table", "placement.host", "placement.mover",
    "placement.rebalancer",
    "kafka", "kafka.protocol", "kafka.protocol.wire", "kafka.protocol.schema", "kafka.protocol.apis",
    "kafka.protocol.headers", "kafka.protocol.admin_apis", "kafka.protocol.group_apis",
    "kafka.protocol.tx_apis", "kafka.protocol.produce_fast", "kafka.framing", "kafka.probe", "kafka.quotas",
    "kafka.fetch_session",
    "ssx", "ssx.procnemesis", "ssx.shards",
    "cloud", "cloud.object_store", "cloud.nemesis", "cloud.cache_service", "cloud.cstore", "cloud.manifest",
    "cloud.archiver", "cloud.remote_partition",
    "cluster", *(f"cluster.{m}" for m in (
        "allocator", "archival_stm", "commands", "controller", "controller_snapshot", "feature_barrier",
        "features", "health_monitor", "members", "metadata_cache", "metadata_dissemination", "migrations",
        "node_status", "partition", "partition_manager", "producer_state", "self_test", "shard_table",
        "stats_reporter", "topic_table", "tx_coordinator", "tx_state")),
    "kafka.server", "kafka.server_admin", "kafka.server_groups", "kafka.server_tx", "kafka.coordinator",
    "kafka.coordinator.group", "kafka.coordinator.group_manager", "kafka.client",
    "admin", "admin.server", "transforms", "app",
))
REQUIRED = RAFT_LAYER + BROKER + (
    "redpanda_tpu_torch.entry",
    "redpanda_tpu_torch.metrics",
    "redpanda_tpu_torch.utils.tasks",
    "redpanda_tpu_torch.utils.serde",
    "redpanda_tpu_torch.utils.locks",
    "redpanda_tpu_torch.utils.compileguard",
    "redpanda_tpu_torch.observability.trace",
    "redpanda_tpu_torch.observability.load_ledger",
    "redpanda_tpu_torch.observability.health",
    "redpanda_tpu_torch.observability.fleet",
    "redpanda_tpu_torch.observability.flightdata",
    "redpanda_tpu_torch.observability.alerts",
    "redpanda_tpu_torch.observability.devplane",
)


# what chip_smoke.py's phase 15 imports from tests/: the port's chaos
# harness and the history checker
HARNESS = ("test_torch_chaos_harness", "linear_check")


def test_every_module_imports_without_jax_or_reference():
    names = _modules()
    assert len(names) > 20
    assert set(REQUIRED) <= set(names)
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"sys.path.append({str(REPO / 'tests')!r})\n"
        f"for n in {names!r} + ['chip_smoke'] + {list(HARNESS)!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'redpanda_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd="/"
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_import_nothing_forbidden():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"] + [REPO / "tests" / f"{n}.py" for n in HARNESS]
    assert len(files) > 20
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad = [a.name for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                bad = [node.module] if _forbidden(node.module or "") else []
            else:
                continue
            assert not bad, f"{path.relative_to(REPO)}:{node.lineno} imports {bad}"


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-fallback checks need a machine without one")


def test_default_device_tick_raises_without_cuda(monkeypatch):
    _require_no_cuda()
    from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays

    monkeypatch.delenv("RP_QUORUM_BACKEND", raising=False)
    arrays = ShardGroupArrays(capacity=64)
    assert arrays._backend() == "device"
    empty = np.empty(0, np.int64)
    with pytest.raises(RuntimeError, match="CUDA"):
        arrays.device_tick(empty, empty, empty, empty, empty)
    with pytest.raises(RuntimeError, match="CUDA"):
        arrays.health_refresh()


def test_group_manager_on_cuda_raises_without_cuda(monkeypatch, tmp_path):
    """A GroupManager on the default device (the card) raises at its
    first device call, the prewarm tick in start(), instead of running
    the plain versions on the CPU; so do a tick and a health report."""
    _require_no_cuda()
    import asyncio

    from redpanda_tpu_torch.raft import GroupManager

    async def no_send(dst, method_id, payload, timeout):
        raise RuntimeError("single node: no peers")

    monkeypatch.delenv("RP_QUORUM_BACKEND", raising=False)
    gm = GroupManager(node_id=1, data_dir=str(tmp_path / "n1"), send=no_send)
    try:
        assert gm.arrays.device == "cuda" and gm.arrays._backend() == "device"
        with pytest.raises(RuntimeError, match="CUDA"):
            asyncio.run(gm.start())
        empty = np.empty(0, np.int64)
        with pytest.raises(RuntimeError, match="CUDA"):
            gm.arrays.device_tick(empty, empty, empty, empty, empty)
        with pytest.raises(RuntimeError, match="CUDA"):
            gm.health_report()
    finally:
        gm.kvstore.close()


def test_default_crc_device_raises_without_cuda(monkeypatch):
    _require_no_cuda()
    from redpanda_tpu_torch.models.record import RecordBatchBuilder, batch_crcs
    from redpanda_tpu_torch.ops.crc32c import crc32c_batch_device

    with pytest.raises(RuntimeError, match="CUDA"):
        crc32c_batch_device(np.zeros((2, 16), np.uint8), np.array([3, 4]))
    batch = RecordBatchBuilder(timestamp_ms=0).add(b"v").build()
    monkeypatch.delenv("RP_CRC_BACKEND", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_crcs([batch])


def test_crc_default_device_reaches_the_broker_seams(monkeypatch):
    """ops.default_device is what the callers without a device
    argument run on: the fetch verify (kafka/server.py
    _verify_fetch_response) and models/record.batch_crcs. Set to "cpu",
    both run the plain version and agree with the host CRC; left at the
    card, both raise on a machine without CUDA."""
    _require_no_cuda()
    from types import SimpleNamespace

    from redpanda_tpu_torch.kafka.server import KafkaServer
    from redpanda_tpu_torch.models.record import RecordBatchBuilder, batch_crcs
    from redpanda_tpu_torch.ops import crc32c as crc_ops
    from redpanda_tpu_torch.ops import default_device
    from redpanda_tpu_torch.utils import crc as host_crc

    monkeypatch.delenv("RP_CRC_BACKEND", raising=False)
    batches = [RecordBatchBuilder(timestamp_ms=0).add(b"v%d" % i * 40, key=b"k").build() for i in range(3)]
    wire = b"".join(b.to_kafka_wire() for b in batches)
    row = SimpleNamespace(records=wire, error_code=0, partition_index=0)
    response = [SimpleNamespace(topic="t", partitions=[row])]
    assert default_device.DEVICE == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_crcs(batches)
    with pytest.raises(RuntimeError, match="CUDA"):
        KafkaServer._verify_fetch_response(None, response)

    seen = []
    plain = crc_ops.crc32c_device

    def spy(data, lens):
        seen.append(data.device.type)
        return plain(data, lens)

    monkeypatch.setattr(default_device, "DEVICE", "cpu")
    monkeypatch.setattr(crc_ops, "crc32c_device", spy)
    want = [host_crc.crc32c(b.body, host_crc.crc32c(b.header.crc_prefix())) for b in batches]
    assert [int(c) for c in batch_crcs(batches)] == want
    KafkaServer._verify_fetch_response(None, response)
    assert row.error_code == 0 and row.records == wire
    assert seen == ["cpu", "cpu"]


def test_default_device_broker_raises_without_cuda(tmp_path):
    """A Broker on the default device (the card) raises at start on a
    machine without CUDA instead of running on the CPU."""
    _require_no_cuda()
    import asyncio
    import contextlib

    from redpanda_tpu_torch.app import Broker, BrokerConfig
    from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

    cfg = BrokerConfig(node_id=0, data_dir=str(tmp_path / "n0"), members=[0])
    assert cfg.device == "cuda"

    async def run():
        broker = Broker(cfg, loopback=LoopbackNetwork())
        assert broker.group_manager.arrays.device == "cuda"
        try:
            await broker.start()
        finally:
            with contextlib.suppress(Exception):
                await broker.stop()

    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(run())


def test_chip_smoke_refuses_without_cuda(tmp_path):
    _require_no_cuda()
    run = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run(
        [sys.executable, str(alone)], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env=env,
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout


def test_mesh_seam_raises_without_cuda(monkeypatch):
    """RP_QUORUM_BACKEND=mesh on the default device (the card) raises on
    a machine without one, at every seam, instead of running the plain
    versions on the CPU; so do the mesh and the ring cluster entries."""
    _require_no_cuda()
    from redpanda_tpu_torch.parallel import make_cluster_state, make_mesh
    from redpanda_tpu_torch.parallel.mesh_frame import MeshFrame
    from redpanda_tpu_torch.raft.shard_state import ShardGroupArrays

    monkeypatch.setenv("RP_QUORUM_BACKEND", "mesh")
    monkeypatch.setenv("RP_MESH_DEVICES", "8")
    arrays = ShardGroupArrays(capacity=8)
    rows = np.array([arrays.alloc_row() for _ in range(4)], np.int64)
    arrays.is_leader[rows] = True
    empty = np.empty(0, np.int64)
    one = np.ones(1, np.int64)
    calls = (
        lambda: arrays.chip_count(),
        lambda: arrays.prewarm(),
        lambda: arrays.health_refresh(),
        # a small window runs the chip-local host sweep, then attributes
        # its changed rows to chip blocks
        lambda: arrays.frame_tick(rows[:1], one, one, one, one, force_rows=rows),
        lambda: MeshFrame(),
        lambda: make_mesh(8),
        lambda: make_cluster_state(24),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    monkeypatch.setenv("RP_MESH_FULL", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        arrays.device_tick(empty, empty, empty, empty, empty)
    assert arrays._mesh_frame is None


def test_default_codec_device_raises_without_cuda(monkeypatch):
    _require_no_cuda()
    from redpanda_tpu_torch.compression import CompressionType, tpu_backend
    from redpanda_tpu_torch.models.record import RecordBatchBuilder
    from redpanda_tpu_torch.ops import fused, lz4, snappy

    for call in (
        lambda: lz4.compress_chunks([b"abc" * 50]),
        lambda: snappy.compress_chunks([b"abc" * 50]),
        lambda: lz4.compress_chunks([b"abc" * 50], device="cuda"),
        lambda: fused.crc_lz4_fused([b"\x00" * 40], [b"abc" * 50]),
        lambda: fused.crc_snappy_fused([b"\x00" * 40], [b"abc" * 50], device="cuda"),
        lambda: tpu_backend.compress(b"abc" * 50),
        lambda: tpu_backend.compress_snappy(b"abc" * 50),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    monkeypatch.setenv("RP_CODEC_BACKEND", "device")
    batch = RecordBatchBuilder(timestamp_ms=0).add(b"v" * 100).build()
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.recompressed(CompressionType.lz4)
    _zstd_entries_raise(monkeypatch, batch)


def _compressed_zstd_frame() -> bytes:
    """A frame holding one compressed block, so its decode launches:
    a raw-only or RLE-only frame decodes on the host in the reference
    as in the port."""
    from redpanda_tpu_torch.compression import zstd_frame as zf
    from redpanda_tpu_torch.ops import zstd

    data = b'{"key":"user-000001","topic":"orders","seq":12345},' * 40
    nbits, streams = zstd.encode_chunks([data], device="cpu")[0]
    frame = zf.frame_header(len(data)) + zf.build_block(data, nbits, streams, True)
    assert (int.from_bytes(frame[zf.parse_frame_header(frame)[1]:][:3], "little") >> 1) & 3 == 2
    return frame


def _zstd_entries_raise(monkeypatch, batch):
    """The zstd device entries, the registry under RP_ZSTD_BACKEND=tpu
    and recompressed(zstd) raise on a machine without CUDA."""
    from redpanda_tpu_torch import compression
    from redpanda_tpu_torch.compression import CompressionType, tpu_backend
    from redpanda_tpu_torch.ops import fused, zstd

    frame = _compressed_zstd_frame()
    data = b"abc" * 50
    for call in (
        lambda: zstd.encode_chunks([data]),
        lambda: zstd.decode_streams([b"\x01"], [1], [(np.zeros(2048, np.uint8), np.ones(2048, np.int32))]),
        lambda: fused.crc_zstd_fused([b"\x00" * 40], [data]),
        lambda: tpu_backend.compress_zstd(data),
        lambda: tpu_backend.compress_many_zstd([data]),
        lambda: tpu_backend.uncompress_zstd(frame),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    monkeypatch.setenv("RP_ZSTD_BACKEND", "tpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        compression.compress(data, CompressionType.zstd)
    with pytest.raises(RuntimeError, match="CUDA"):
        compression.uncompress(frame, CompressionType.zstd)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.recompressed(CompressionType.zstd)


def test_zstd_decode_failure_is_not_punted(monkeypatch):
    """uncompress_zstd hands only the host walk's ZstdFormatError to the
    host codec: a ValueError from decode_streams (a corrupt stream)
    propagates, and so does a kernel's RuntimeError."""
    from redpanda_tpu_torch import compression
    from redpanda_tpu_torch.compression import tpu_backend
    from redpanda_tpu_torch.compression import zstd_frame as zf
    from redpanda_tpu_torch.ops import _build, default_device, zstd

    def no_punt(_data):
        raise AssertionError("punted to the host codec")

    monkeypatch.setattr(compression, "_zstd_uncompress_host", no_punt)
    monkeypatch.setattr(default_device, "DEVICE", "cpu")
    frame = _compressed_zstd_frame()
    assert tpu_backend.uncompress_zstd(frame) == zf.reference_decompress(frame)
    for err in (ValueError("huffman stream 0 did not consume its bits exactly (3 left)"),
                _build.KernelError("zstd_decode: CUDA error 700")):
        def failing(*_args, err=err):
            raise err

        monkeypatch.setattr(zstd, "decode_streams", failing)
        with pytest.raises(type(err)) as got:
            tpu_backend.uncompress_zstd(frame)
        assert got.value is err


def test_codec_wrappers_have_no_fallback():
    """A CUDA tensor launches its kernel or raises: the codec wrappers,
    the quorum and health wrappers and the mesh / ring cluster modules
    hold no try statement that could route it to the plain version."""
    for path in (
        *(f"ops/{name}.py" for name in ("cellparse", "lz4", "snappy", "fused", "zstd", "quorum", "health")),
        "parallel/mesh.py",
        "parallel/mesh_frame.py",
        "parallel/cluster_step.py",
    ):
        tree = ast.parse((PKG / path).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], path
