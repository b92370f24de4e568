"""The port's process entry points against the JAX package's, on the CPU.

- One node of each package started as users start one
  (`python -m redpanda_tpu_torch --device cpu --shards 2` and
  `python -m redpanda_tpu --shards 2`) takes the same seeded traffic
  (8 partitions, compression.type=lz4, acks=all): equal base offsets,
  high watermarks and records.
- A worker shard of the port, killed after its parent has run torch's
  intra-op pool (an OpenMP pool does not survive a fork), is restarted
  by the fork server and serves produce and fetch.
- Every wire type the reference's corpus walker finds has a
  counterpart in the port under the same corpus key, and seeded
  instances encode byte-equal in both packages.
- A tiered broker of each package, on the same traffic with the host
  zstd leg, stores the same segment objects and serves the same
  records from offset 0 by hydration. The one part of a stored segment
  that differs from run to run in either package is the raft
  configuration batch's wall-clock timestamps (and so its CRCs): those
  batches compare by every other header field and their records.
- The two faults a missing module caused: a SASL/SCRAM client
  authenticates against a port broker (`security.oidc` and
  `security.gssapi_authenticator` were imported by the handshake), and
  a tiered port broker constructs (`cloud.probe`), archives and hydrates.
- `python -m redpanda_tpu_torch` without `--device` runs on the card,
  so it exits non-zero here, without CUDA, before it serves.
- chip_smoke's phase 14 (run_processes, run_tiered) at a small size.
- Every kernel wrapper's launch counter rides the devplane registry, as
  phase 14 reads it from each shard process.

Every process this file starts has its own timeout.
"""

import asyncio
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

import chip_smoke as cs
from redpanda_tpu_torch.ops import default_device
from test_torch_broker import ref_broker

SEED = 20_261_019
PARTITIONS, BATCHES = 8, 16
TOPICS = [("entry-lz4", PARTITIONS, {"compression.type": "lz4"})]
TIERED_SEGMENT, TIERED_TOTAL, TIERED_PER_REQUEST = 64 << 10, 192 << 10, 4
TIERED_CFG = dict(archival_interval_s=0, housekeeping_interval_s=0)


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


def _run(coro, timeout: float):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# ------------------------------------------------------ process nodes
async def _node_traffic(tmp, command) -> dict:
    """One node (`command`, two shards) takes BATCHES acks=all batches
    over TOPICS and is read back."""
    batches = cs.broker_batches(SEED, [(name, parts) for name, parts, _ in TOPICS], BATCHES)
    cluster = cs.ProcessCluster(str(tmp), "cpu", nodes=1, shards=2, command=command)
    try:
        await cluster.start(timeout=90.0)
        await cluster.create(TOPICS, rf=1)
        run = await cs.fetched(cluster, await cluster.produce(batches), TOPICS)
        run["sharded"] = cluster.shards_view(0)["sharded"]
    finally:
        await cluster.stop()
    cs.check_broker_run(run, batches, TOPICS)
    return run


def test_sharded_node_matches_jax_package(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    port = _run(_node_traffic(tmp_path / "port", None), 240)
    ref = _run(_node_traffic(tmp_path / "ref", [sys.executable, "-m", "redpanda_tpu"]), 240)
    assert port["sharded"] and ref["sharded"]
    assert port["bases"] == ref["bases"]
    assert port["hwm"] == ref["hwm"]
    assert port["records"] == ref["records"]


def test_node_without_device_flag_exits_without_cuda(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "redpanda_tpu_torch", "--node-id", "0", "--data-dir", str(tmp_path / "n0"),
         "--kafka-port", "0", "--rpc-port", "0", "--admin-port", "0"],
        cwd=cs.REPO, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr


# ------------------------------------------- worker restart, CPU trap
async def _restart_after_torch_work(tmp) -> tuple:
    from redpanda_tpu_torch.app import BrokerConfig
    from redpanda_tpu_torch.kafka.client import KafkaClient
    from redpanda_tpu_torch.ssx.sharded_broker import ShardedBroker

    # the parent's intra-op pool runs before the fork server exists,
    # and again before the restart
    a = torch.randn(512, 512)
    float((a @ a).sum())
    sb = ShardedBroker(
        BrokerConfig(device="cpu", node_id=0, data_dir=str(tmp / "n0"), members=[0],
                     election_timeout_s=0.3, heartbeat_interval_s=0.05, enable_admin=False),
        n_shards=2,
    )
    await sb.start()
    c = KafkaClient([("127.0.0.1", sb.kafka_port)])
    try:
        assert sb.active, sb.standdown
        deadline = time.monotonic() + 30
        while True:
            try:
                await c.create_topic("t", partitions=4, replication_factor=1)
                break
            except Exception:
                assert time.monotonic() < deadline
                await asyncio.sleep(0.2)
        while not sb.broker.shard_table.counts().get(1, 0):
            assert time.monotonic() < deadline, "no partition on the worker"
            await asyncio.sleep(0.1)
        owned = [p for p in range(4) if sb.broker.shard_table.shard_for(cs.port_broker().kafka_ntp("t", p)) == 1]
        float((a @ a).sum())
        rt = sb.runtime
        victim = rt.shard_pids[1]
        os.kill(victim, signal.SIGKILL)
        while not (rt.shard_restarts.get(1) == 1 and rt.shard_pids.get(1, victim) != victim
                   and sb.broker.shard_table.is_available(1)):
            assert time.monotonic() < deadline + 30, "the worker never came back"
            await asyncio.sleep(0.05)
        got = []
        for p in owned:
            off = None
            while off is None:
                try:
                    off = await c.produce("t", p, [(b"k%d" % p, b"after-restart")])
                except Exception:
                    assert time.monotonic() < deadline + 60
                    await asyncio.sleep(0.2)
            got.append(await c.fetch("t", p, off))
        return owned, got, rt.restarts
    finally:
        await c.close()
        await sb.stop()


def test_worker_restarted_after_torch_work_serves(tmp_path):
    owned, got, restarts = _run(_restart_after_torch_work(tmp_path), 180)
    assert owned and restarts == 1
    assert [[(k, v) for _, k, v in rows] for rows in got] == [
        [(b"k%d" % p, b"after-restart")] for p in owned
    ]


# ------------------------------------------------------- wire types
def test_wire_types_encode_alike_in_both_packages():
    from redpanda_tpu.utils import compat as ref_compat
    from redpanda_tpu_torch.utils import compat as port_compat

    ref_types = ref_compat.all_envelope_types()
    port_types = port_compat.all_envelope_types()
    assert not ref_compat.discovery_failures and not port_compat.discovery_failures
    assert sorted(port_types) == sorted(ref_types)
    for q in sorted(ref_types):
        want, want_values = ref_compat.corpus_cases(q, ref_types[q])
        got, got_values = port_compat.corpus_cases(q, port_types[q])
        assert got == want, q
        assert got_values == want_values, q
        assert (port_types[q].SERDE_VERSION, port_types[q].SERDE_COMPAT_VERSION) == (
            ref_types[q].SERDE_VERSION, ref_types[q].SERDE_COMPAT_VERSION), q


# -------------------------------------------------------- tiered storage
def _segment_batches(body: bytes) -> list:
    """The batches of a segment: raft_data batches as their bytes,
    others as their header without timestamps and CRCs, and records."""
    from redpanda_tpu_torch.models.record import HEADER_SIZE, RecordBatchHeader, RecordBatchType

    out, pos = [], 0
    while pos + HEADER_SIZE <= len(body):
        h = RecordBatchHeader.unpack(body[pos:pos + HEADER_SIZE])
        raw = body[pos:pos + h.size_bytes]
        if h.type == RecordBatchType.raft_data:
            out.append(raw)
        else:
            out.append((int(h.type), h.base_offset, h.size_bytes, h.attrs, h.last_offset_delta, h.producer_id,
                        h.record_count, h.term, raw[HEADER_SIZE:]))
        pos += h.size_bytes
    assert pos == len(body)
    return out


def _tiered(pkg, tmp, monkeypatch, **cfg) -> dict:
    monkeypatch.setenv("RP_ARCHIVE_COMPRESSION", "zstd")
    monkeypatch.setenv("RP_ZSTD_BACKEND", "host")
    batches = cs.tiered_batches(SEED, TIERED_TOTAL)
    run = _run(cs.tiered_scenario(pkg, str(tmp), batches, TIERED_SEGMENT, TIERED_PER_REQUEST, nodes=1,
                                  cloud_storage_dir=str(tmp / "bucket"), **TIERED_CFG, **cfg), 180)
    cs.check_tiered(run, batches, TIERED_PER_REQUEST)
    return run


def test_tiered_broker_matches_jax_package(tmp_path, monkeypatch):
    from redpanda_tpu_torch import compression

    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    port = _tiered(cs.port_broker(), tmp_path / "port", monkeypatch, device="cpu")
    ref = _tiered(ref_broker(), tmp_path / "ref", monkeypatch)
    assert port["hydrations"] > 0 and ref["hydrations"] > 0
    assert port["records"] == ref["records"] and port["bases"] == ref["bases"]
    assert [o[0] for o in port["objects"]] == [o[0] for o in ref["objects"]]
    for (base, blob, size, _), (_, ref_blob, ref_size, _) in zip(port["objects"], ref["objects"]):
        assert size == ref_size, base
        assert _segment_batches(compression._zstd_uncompress_host(blob)) == _segment_batches(
            compression._zstd_uncompress_host(ref_blob)), base


def test_tiered_port_broker_archives_and_hydrates(tmp_path, monkeypatch):
    """Before the port had cloud/probe.py, a Broker with a bucket did
    not construct."""
    run = _tiered(cs.port_broker(), tmp_path, monkeypatch, device="cpu")
    assert run["uploaded"] >= 2 and run["local_start"] > 0 and run["hydrations"] > 0


# ------------------------------------------------------------ SASL
async def _scram_client(tmp) -> list:
    from redpanda_tpu_torch.app import Broker, BrokerConfig
    from redpanda_tpu_torch.kafka.client import KafkaClient
    from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
    from redpanda_tpu_torch.security.scram import encode_credential, make_credential

    b = Broker(
        BrokerConfig(device="cpu", node_id=0, data_dir=str(tmp / "n0"), members=[0], enable_sasl=True,
                     superusers=["admin"]),
        loopback=LoopbackNetwork(),
    )
    await b.start()
    b.config.peer_kafka_addresses = {0: b.kafka_advertised}
    try:
        await b.wait_controller_leader()
        await b.controller.create_user("admin", encode_credential(make_credential("secret")))
        c = KafkaClient([b.kafka_advertised], sasl=("admin", "secret", "SCRAM-SHA-256"))
        try:
            await c.create_topic("sasl-t", partitions=1, replication_factor=1)
            off = await c.produce("sasl-t", 0, [(b"k", b"v")])
            return await c.fetch("sasl-t", 0, off)
        finally:
            await c.close()
    finally:
        await b.stop()


def test_scram_client_authenticates_against_port_broker(tmp_path):
    """Before the port had security/oidc.py, the SaslHandshake handler's
    import failed and the client saw its connection die."""
    rows = _run(_scram_client(tmp_path), 120)
    assert [(k, v) for _, k, v in rows] == [(b"k", b"v")]


# ------------------------------------------------------------- phase 14
def test_phase_14_runs_on_the_cpu():
    """chip_smoke's phase 14 at a small size: part A's three node
    processes on `--device cpu` (one worker each, node 0's killed,
    restarted and made leader again), part B's tiered brokers on the
    zstd leg and the host leg. Part A runs
    the host LZ4 codec here: the plain fused chain takes ~1.2 s a batch
    on the CPU, and a shard's loop stalled that long lets its followers
    elect and a client retry a produce that was written (test_torch_broker
    and test_torch_ref_fused_codec hold the fused seam on the CPU)."""
    a = cs.run_processes("cpu", partitions=8, count=16, restart_count=8, env={"RP_CODEC_BACKEND": None})
    assert a["back"] and a["restart_s"] > 0
    calls = a["path"][cs.SAMPLES]
    assert calls["crc32c.device"] > 0 and calls["quorum.heartbeat_tick"] > 0
    # the plain versions launch nothing, so count nothing
    assert a["launches"] == {}
    b = cs.run_tiered("cpu", total=TIERED_TOTAL, segment_bytes=TIERED_SEGMENT, per_request=TIERED_PER_REQUEST)
    assert b["records"] == b["host"]["records"] and b["hydrations"] > 0


def test_launch_counters_ride_the_devplane_registry(monkeypatch):
    """Every kernel wrapper's launch counter is exported as the devplane
    family chip_smoke reads from each shard process's registry."""
    from redpanda_tpu_torch.observability import devplane
    from redpanda_tpu_torch.ops import quorum

    monkeypatch.setitem(quorum.LAUNCHES, "fold_replies", 7)
    got = cs.by_kernel(devplane.registry.render(), cs.LAUNCH_COUNTS)
    assert got["fold_replies"] == 7
    assert set(cs.KERNELS) <= set(got)
