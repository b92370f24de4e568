"""tests/test_admin_server.py run on the port: all 10 test functions,
with imports pointed at redpanda_tpu_torch. Every broker is the port's
on the CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
`cluster` and `http` are imported from here by the other carried files.
Nothing is left out.


Admin HTTP API, cluster config system, and Prometheus metrics.

Reference test model: redpanda/tests/admin_server_test, rptest
admin-API tests (cluster config, users, leadership transfer), and the
/metrics endpoints of application.cc:460-520.
"""

import asyncio
import contextlib
import json

import pytest

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.kafka.client import KafkaClient
from redpanda_tpu_torch.models.fundamental import kafka_ntp
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


async def http(addr, method, path, body=None):
    """Minimal HTTP/1.1 client over asyncio streams."""
    reader, writer = await asyncio.open_connection(*addr)
    payload = b"" if body is None else json.dumps(body).encode()
    req = (
        f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n"
    ).encode() + payload
    writer.write(req)
    await writer.drain()
    status_line = await reader.readline()
    status = int(status_line.split()[1])
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    length = int(headers.get("content-length", "0") or 0)
    data = await reader.readexactly(length) if length else b""
    writer.close()
    if headers.get("content-type", "").startswith("application/json") and data:
        return status, json.loads(data)
    return status, data


@contextlib.asynccontextmanager
async def cluster(tmp_path, n=3):
    net = LoopbackNetwork()
    members = list(range(n))
    brokers = [
        Broker(
            BrokerConfig(
                device="cpu",
                node_id=i,
                data_dir=str(tmp_path / f"n{i}"),
                members=members,
                election_timeout_s=0.15,
                heartbeat_interval_s=0.03,
                node_status_interval_s=0.1,
            ),
            loopback=net,
        )
        for i in members
    ]
    for b in brokers:
        await b.start()
    addrs = {b.node_id: b.kafka_advertised for b in brokers}
    for b in brokers:
        b.config.peer_kafka_addresses = addrs
    try:
        await brokers[0].wait_controller_leader()
        yield brokers
    finally:
        for b in brokers:
            await b.stop()


async def _admin_surface(tmp_path):
    async with cluster(tmp_path) as brokers:
        b = brokers[0]
        addr = b.admin.address

        # readiness + brokers + health
        st, body = await http(addr, "GET", "/v1/status/ready")
        assert st == 200 and body["status"] == "ready"
        st, body = await http(addr, "GET", "/v1/brokers")
        assert st == 200 and len(body["brokers"]) == 3
        st, body = await http(addr, "GET", "/v1/cluster/health_overview")
        assert st == 200 and body["nodes_down"] == []

        # topic lifecycle over HTTP
        st, body = await http(
            addr,
            "POST",
            "/v1/topics",
            {"name": "ht", "partitions": 2, "replication_factor": 3,
             "configs": {"retention.ms": "1000000"}},
        )
        assert st == 200, body
        st, body = await http(addr, "GET", "/v1/topics/ht")
        assert st == 200
        assert body["partition_count"] == 2
        assert body["config"]["retention.ms"] == "1000000"

        # partition detail + leadership transfer (leader election for
        # the fresh group may be in flight: poll)
        deadline = asyncio.get_event_loop().time() + 5
        leader = None
        while asyncio.get_event_loop().time() < deadline:
            st, body = await http(addr, "GET", "/v1/partitions/kafka/ht/0")
            assert st == 200 and sorted(body["replicas"]) == [0, 1, 2]
            leader = body["leader"]
            if leader is not None:
                break
            await asyncio.sleep(0.05)
        assert leader is not None
        ldr_broker = next(x for x in brokers if x.node_id == leader)
        target = next(i for i in (0, 1, 2) if i != leader)
        st, _ = await http(
            ldr_broker.admin.address,
            "POST",
            f"/v1/partitions/kafka/ht/0/transfer_leadership?target={target}",
        )
        assert st == 204
        deadline = asyncio.get_event_loop().time() + 5
        while asyncio.get_event_loop().time() < deadline:
            p = ldr_broker.partition_manager.get(kafka_ntp("ht", 0))
            if p is not None and not p.is_leader:
                break
            await asyncio.sleep(0.05)
        st, body = await http(addr, "GET", "/v1/partitions/kafka/ht/0")
        assert body["leader"] != leader or body["leader"] is None

        # SCRAM user management
        st, _ = await http(
            addr, "PUT", "/v1/security/users",
            {"username": "op", "password": "pw"},
        )
        assert st == 204
        # the 204 proves QUORUM commit; a specific follower applies on
        # its next commit-carrying beat/append — poll briefly
        deadline = asyncio.get_event_loop().time() + 3
        while (
            not brokers[2].controller.credentials.contains("op")
            and asyncio.get_event_loop().time() < deadline
        ):
            await asyncio.sleep(0.02)
        assert brokers[2].controller.credentials.contains("op")
        st, _ = await http(addr, "DELETE", "/v1/security/users/op")
        assert st == 204

        # 404s + validation errors
        st, _ = await http(addr, "GET", "/v1/topics/nope")
        assert st == 404
        st, _ = await http(addr, "POST", "/v1/topics", {"partitions": 3})
        assert st == 400
        st, _ = await http(addr, "GET", "/v1/nonsense")
        assert st == 404

        # topic deletion
        st, _ = await http(addr, "DELETE", "/v1/topics/ht")
        assert st == 204


@pytest.mark.timing
def test_admin_surface(tmp_path):
    asyncio.run(_admin_surface(tmp_path))


async def _cluster_config(tmp_path):
    async with cluster(tmp_path) as brokers:
        addr = brokers[0].admin.address
        st, schema = await http(addr, "GET", "/v1/cluster_config/schema")
        assert st == 200 and "log_compaction_interval_s" in schema

        # set through node 0; visible on ALL nodes (replicated)
        st, body = await http(
            addr, "PUT", "/v1/cluster_config",
            {"upsert": {"log_compaction_interval_s": "3.5",
                        "kafka_max_request_bytes": "1048576"}},
        )
        assert st == 200, body
        for b in brokers:
            deadline = asyncio.get_event_loop().time() + 5
            while asyncio.get_event_loop().time() < deadline:
                if b.controller.cluster_config.get(
                    "log_compaction_interval_s"
                ) == 3.5:
                    break
                await asyncio.sleep(0.05)
            assert b.controller.cluster_config.get(
                "log_compaction_interval_s"
            ) == 3.5
            # live binding fired into the running broker
            assert b.config.housekeeping_interval_s == 3.5

        # follower-routed write converges too (read-your-writes)
        st, _ = await http(
            brokers[2].admin.address, "PUT", "/v1/cluster_config",
            {"upsert": {"fetch_max_wait_cap_ms": "2500"}},
        )
        assert st == 200
        assert brokers[2].controller.cluster_config.get(
            "fetch_max_wait_cap_ms"
        ) == 2500

        # validation: bad type and unknown key rejected
        st, _ = await http(
            addr, "PUT", "/v1/cluster_config",
            {"upsert": {"log_compaction_interval_s": "banana"}},
        )
        assert st == 400
        st, _ = await http(
            addr, "PUT", "/v1/cluster_config", {"upsert": {"no_such_knob": "1"}}
        )
        assert st == 400

        # remove reverts to default AND the live binding restores the
        # broker's constructed value (not the registry default)
        st, _ = await http(
            addr, "PUT", "/v1/cluster_config",
            {"remove": ["kafka_max_request_bytes", "log_compaction_interval_s"]},
        )
        assert st == 200
        assert brokers[0].controller.cluster_config.is_default(
            "kafka_max_request_bytes"
        )
        for b in brokers:
            deadline = asyncio.get_event_loop().time() + 5
            while asyncio.get_event_loop().time() < deadline:
                if b.config.housekeeping_interval_s == 10.0:
                    break
                await asyncio.sleep(0.05)
            # constructed value was the default 10.0 in this fixture
            assert b.config.housekeeping_interval_s == 10.0


def test_cluster_config(tmp_path):
    asyncio.run(_cluster_config(tmp_path))


async def _metrics_endpoint(tmp_path):
    async with cluster(tmp_path, n=1) as brokers:
        b = brokers[0]
        client = KafkaClient([b.kafka_advertised])
        await client.create_topic("mt", partitions=1, replication_factor=1)
        await client.produce("mt", 0, [(b"k", b"v")])
        await client.fetch("mt", 0, 0)
        await client.close()

        st, text = await http(b.admin.address, "GET", "/metrics")
        assert st == 200
        text = text.decode()
        assert "redpanda_tpu_partitions_total 1" in text
        assert "redpanda_tpu_controller_is_leader 1" in text
        assert 'redpanda_tpu_kafka_requests_total{api="produce"} 1' in text
        assert 'api="fetch"' in text
        assert "redpanda_tpu_kafka_handler_seconds_count" in text
        assert "redpanda_tpu_log_segments_total" in text


def test_metrics_endpoint(tmp_path):
    asyncio.run(_metrics_endpoint(tmp_path))


async def _fault_injection(tmp_path):
    from redpanda_tpu_torch.utils.hbadger import honey_badger

    async with cluster(tmp_path, n=1) as brokers:
        b = brokers[0]
        st, _ = await http(
            b.admin.address, "POST", "/v1/debug/fault_injection",
            {"module": "raft", "point": "append_entries", "delay_s": 0.0,
             "count": 1},
        )
        assert st == 204
        assert honey_badger._probes, "probe should be armed"
        st, _ = await http(b.admin.address, "DELETE", "/v1/debug/fault_injection")
        assert st == 204
        assert not honey_badger._probes


def test_fault_injection_endpoint(tmp_path):
    asyncio.run(_fault_injection(tmp_path))


async def _self_test(tmp_path):
    async with cluster(tmp_path, n=3) as brokers:
        st, body = await http(
            brokers[0].admin.address, "POST", "/v1/debug/self_test",
            {"disk_mb": 4},
        )
        assert st == 200, body
        assert body["disk"]["write_mbps"] > 0
        assert body["disk"]["read_mbps"] > 0
        assert set(body["network"]) == {"1", "2"}
        for peer in ("1", "2"):
            assert body["network"][peer]["rtt_ms_avg"] >= 0


def test_self_test(tmp_path):
    asyncio.run(_self_test(tmp_path))


async def _self_test_distributed(tmp_path):
    """Cluster-wide start/status/stop (self_test_frontend/backend over
    internal RPC): any node coordinates, every node runs, reports
    aggregate, double-start conflicts, stop cancels."""
    import threading

    async with cluster(tmp_path, n=3) as brokers:
        addr = brokers[0].admin.address
        # Gate every node's disk check behind one Event: the first run
        # is then GUARANTEED still in flight when the double-start
        # arrives, with no wall-clock assumption about how fast a small
        # write+fsync completes under full-suite load. The check runs
        # in an executor thread, so the blocking wait is safe.
        gate = threading.Event()
        originals = [
            (b.self_test_backend, b.self_test_backend._diskcheck)
            for b in brokers
        ]

        def gated(orig):
            def check(size_mb):
                gate.wait(timeout=30.0)
                return orig(size_mb)

            return check

        for backend, orig in originals:
            backend._diskcheck = gated(orig)
        try:
            st, body = await http(
                addr, "POST", "/v1/debug/self_test/start",
                {"disk_mb": 2, "net_mb": 1},
            )
            assert st == 200, body
            test_id = body["test_id"]
            assert all(n["ok"] for n in body["nodes"].values()), body

            # a second start while the first still runs must report
            # per-node conflicts on every node (all are gated)
            st, body2 = await http(
                addr, "POST", "/v1/debug/self_test/start", {"disk_mb": 2}
            )
            conflicts = [n for n in body2["nodes"].values() if not n["ok"]]
            assert len(conflicts) == 3, body2
            assert all("already running" in n["error"] for n in conflicts)
        finally:
            gate.set()
            for backend, orig in originals:
                backend._diskcheck = orig

        deadline = asyncio.get_event_loop().time() + 30.0
        status = []
        while asyncio.get_event_loop().time() < deadline:
            st, status = await http(addr, "GET", "/v1/debug/self_test/status")
            assert st == 200
            if status and all(n["status"] == "idle" for n in status):
                break
            await asyncio.sleep(0.05)
        assert status and all(n["status"] == "idle" for n in status), status
        assert {n["node_id"] for n in status} == {0, 1, 2}
        # whichever test ran LAST on each node, its report is complete
        for n in status:
            rep = n["report"]
            assert rep["disk"]["write_mbps"] > 0
            others = {str(p) for p in (0, 1, 2) if p != n["node_id"]}
            assert set(rep["network"]) == others
            for peer in others:
                assert rep["network"][peer]["throughput_mbps"] > 0

        # stop on an idle cluster is a clean no-op
        st, body = await http(addr, "POST", "/v1/debug/self_test/stop")
        assert st == 200
        assert all(n["ok"] for n in body.values())

        # a FOLLOWER-coordinated run works too (state is per-backend)
        st, body = await http(
            brokers[1].admin.address, "POST", "/v1/debug/self_test/start",
            {"disk_mb": 1, "net_mb": 1},
        )
        assert st == 200 and body["test_id"] != test_id
        st, body = await http(
            brokers[1].admin.address, "POST", "/v1/debug/self_test/stop"
        )
        assert st == 200


def test_self_test_distributed(tmp_path):
    asyncio.run(_self_test_distributed(tmp_path))


async def _features(tmp_path):
    async with cluster(tmp_path, n=3) as brokers:
        # activation needs every member registered + the leader's pass
        deadline = asyncio.get_event_loop().time() + 10
        while asyncio.get_event_loop().time() < deadline:
            st, body = await http(brokers[1].admin.address, "GET", "/v1/features")
            assert st == 200
            states = {f["name"]: f["state"] for f in body["features"]}
            if all(s == "active" for s in states.values()):
                break
            await asyncio.sleep(0.1)
        assert all(s == "active" for s in states.values()), states
        assert body["cluster_version"] == body["latest_version"]
        # the table is replicated: every node agrees
        for b in brokers:
            assert b.controller.features.is_active("delete_records")


def test_features(tmp_path):
    asyncio.run(_features(tmp_path))


async def _r3_routes(tmp_path):
    """r3 route additions: usage, partitions list, balancer status,
    recovery status, blocked reactor, cpu profiler (admin_server.cc
    route-parity work)."""
    async with cluster(tmp_path, n=3) as brokers:
        b = brokers[0]
        client = KafkaClient([x.kafka_advertised for x in brokers])
        await client.create_topic("adm", partitions=2, replication_factor=3)
        await client.produce("adm", 0, [(b"k", b"v" * 100)])
        await client.close()
        addr = b.admin.address

        st, usage = await http(addr, "GET", "/v1/usage")
        assert st == 200 and usage["partitions"] >= 2
        assert usage["log_bytes_on_disk"] > 0

        st, parts = await http(addr, "GET", "/v1/partitions")
        assert st == 200
        assert any(p["topic"] == "adm" for p in parts)
        row = next(p for p in parts if p["topic"] == "adm")
        assert {"raft_group_id", "is_leader", "dirty_offset"} <= set(row)

        st, bal = await http(
            addr, "GET", "/v1/cluster/partition_balancer/status"
        )
        assert st == 200 and bal["status"] in ("ready", "in_progress")
        st, cancelled = await http(
            addr, "POST", "/v1/cluster/partition_balancer/cancel"
        )
        assert st == 200 and cancelled["cancelled"] == []

        st, rec = await http(addr, "GET", "/v1/raft/recovery/status")
        assert st == 200
        assert rec["throttle_rate_bytes_s"] > 0
        assert isinstance(rec["recovering"], list)

        st, blocked = await http(addr, "GET", "/v1/debug/blocked_reactor")
        assert st == 200 and "max_scheduling_delay_ms" in blocked

        st, prof = await http(
            addr, "POST", "/v1/debug/cpu_profiler?seconds=0.2"
        )
        assert st == 200 and prof["samples"] > 0 and prof["frames"]

        # no archived data yet: shadow-indexing routes answer 404
        st, _ = await http(
            addr, "GET", "/v1/shadow_indexing/manifest/adm/0"
        )
        assert st == 404
        st, cs = await http(addr, "GET", "/v1/cloud_storage/status/adm/0")
        assert st == 200 and cs["cloud_log_segment_count"] == 0


def test_r3_routes(tmp_path):
    asyncio.run(_r3_routes(tmp_path))


async def _r3b_routes(tmp_path):
    """Broker detail, node config, raft group status, transactions."""
    async with cluster(tmp_path, n=3) as brokers:
        b = brokers[0]
        client = KafkaClient([x.kafka_advertised for x in brokers])
        await client.create_topic("ad2", partitions=1, replication_factor=3)
        await client.produce("ad2", 0, [(b"k", b"v")])
        addr = b.admin.address

        # broker detail (wait for self-registration)
        deadline = asyncio.get_event_loop().time() + 15
        while b.controller.members_table.get(0) is None:
            assert asyncio.get_event_loop().time() < deadline
            await asyncio.sleep(0.1)
        st, det = await http(addr, "GET", "/v1/brokers/0")
        assert st == 200 and det["node_id"] == 0
        assert det["membership_status"] == "active"
        st, _ = await http(addr, "GET", "/v1/brokers/99")
        assert st == 404

        st, cfg = await http(addr, "GET", "/v1/node_config")
        assert st == 200 and cfg["node_id"] == 0
        for secret in (
            "kafka_tls_key",
            "cloud_storage_access_key",
            "cloud_storage_secret_key",
        ):
            assert secret not in cfg  # secrets redacted

        ntp = kafka_ntp("ad2", 0)
        gid = b.controller.topic_table.group_of(ntp)
        st, rs = await http(addr, "GET", f"/v1/raft/{gid}/status")
        assert st == 200
        assert rs["group"] == gid and rs["role"] in (
            "LEADER", "FOLLOWER", "CANDIDATE",
        )
        assert set(rs["voters"]) == {0, 1, 2}
        st, _ = await http(addr, "GET", "/v1/raft/999999/status")
        assert st == 404

        st, txs = await http(addr, "GET", "/v1/transactions")
        assert st == 200 and isinstance(txs["transactions"], list)
        assert txs["complete"] is True
        await client.close()


def test_r3b_routes(tmp_path):
    asyncio.run(_r3b_routes(tmp_path))


async def _shard_lifecycle_routes(tmp_path):
    """/v1/shards surface over a live sharded broker: fleet liveness +
    lifecycle accounting, per-shard crash/restart detail, and the
    grow/retire verbs driving real fork/evacuate cycles."""
    from redpanda_tpu_torch.ssx.sharded_broker import ShardedBroker

    sb = ShardedBroker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.3,
            heartbeat_interval_s=0.05,
        ),
        n_shards=2,
    )
    await sb.start()
    assert sb.active, f"unexpected stand-down: {sb.standdown}"
    addr = sb.broker.admin.address
    try:
        st, body = await http(addr, "GET", "/v1/shards")
        assert st == 200 and body["sharded"] is True
        assert body["liveness"]["n_shards"] == 2
        assert "budget" in body["lifecycle"]
        st, body = await http(addr, "GET", "/v1/shards/1")
        assert st == 200 and body["alive"] and body["available"]
        assert body["restarts"] == 0 and not body["retired"]
        # grow: a third shard forks, meshes in, and turns available
        st, body = await http(addr, "POST", "/v1/shards/grow")
        assert st == 200 and body == {"grown": True, "shard": 2}
        st, body = await http(addr, "GET", "/v1/shards/2")
        assert st == 200 and body["alive"] and body["available"]
        # retire it again: evacuate + drain + reap
        st, body = await http(addr, "POST", "/v1/shards/2/retire")
        assert st == 200 and body == {"retired": True, "shard": 2}
        st, body = await http(addr, "GET", "/v1/shards/2")
        assert st == 200 and body["retired"] and not body["available"]
        # shard 0 (the parent) is never retirable
        st, _ = await http(addr, "POST", "/v1/shards/0/retire")
        assert st == 400
    finally:
        await sb.stop()


def test_shard_lifecycle_routes(tmp_path):
    asyncio.run(_shard_lifecycle_routes(tmp_path))
