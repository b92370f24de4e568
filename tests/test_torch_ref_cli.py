"""tests/test_cli.py run on the port: all 3 test functions, with imports
pointed at redpanda_tpu_torch. Every broker is the port's on the CPU
(`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu". The
CLI runs as `python -m redpanda_tpu_torch.cli` (the one edited string);
`test_admin_server`'s `http` comes from `test_torch_ref_admin_server`.
Nothing is left out.


rpk-style CLI driven as a SUBPROCESS against a live broker — the
external-tooling conformance check (rpk command families over the real
kafka + admin listeners).
"""

import asyncio
import contextlib
import json
import pathlib
import subprocess
import sys

import pytest

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
from redpanda_tpu_torch.ops import default_device


REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


@contextlib.asynccontextmanager
async def broker(tmp_path):
    b = Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
        ),
        loopback=LoopbackNetwork(),
    )
    await b.start()
    b.config.peer_kafka_addresses = {0: b.kafka_advertised}
    try:
        await b.wait_controller_leader()
        yield b
    finally:
        await b.stop()


async def rpk(b, *argv):
    proc = await asyncio.create_subprocess_exec(
        sys.executable,
        "-m",
        "redpanda_tpu_torch.cli",
        "--brokers",
        f"127.0.0.1:{b.kafka_server.port}",
        "--admin",
        f"http://127.0.0.1:{b.admin.port}",
        *argv,
        stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.PIPE,
        cwd=REPO_ROOT,
    )
    out, err = await asyncio.wait_for(proc.communicate(), timeout=30)
    return proc.returncode, out.decode(), err.decode()


async def _cli(tmp_path):
    async with broker(tmp_path) as b:
        rc, out, err = await rpk(b, "topic", "create", "ct", "-p", "2")
        assert rc == 0, err
        rc, out, _ = await rpk(b, "topic", "list")
        assert "ct" in json.loads(out)
        rc, out, _ = await rpk(
            b, "topic", "produce", "ct", "-k", "k1", "-v", "hello"
        )
        assert rc == 0 and "offset 0" in out
        rc, out, _ = await rpk(
            b, "topic", "consume", "ct", "--partition", "0", "-n", "1"
        )
        assert rc == 0
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec == {"offset": 0, "key": "k1", "value": "hello"}
        rc, out, _ = await rpk(b, "topic", "describe", "ct")
        desc = json.loads(out)
        assert len(desc["partitions"]) == 2
        assert "retention.ms" in desc["configs"]
        rc, out, _ = await rpk(
            b, "topic", "alter-config", "ct", "--set", "retention.ms=1234"
        )
        assert rc == 0
        rc, out, _ = await rpk(b, "topic", "describe", "ct")
        assert json.loads(out)["configs"]["retention.ms"] == "1234"
        rc, out, _ = await rpk(b, "cluster", "health")
        assert json.loads(out)["nodes_down"] == []
        rc, out, _ = await rpk(b, "cluster", "metadata")
        assert json.loads(out)["controller"] == 0
        rc, out, _ = await rpk(
            b, "cluster", "config-set", "--set", "fetch_max_wait_cap_ms=900"
        )
        assert rc == 0
        rc, out, _ = await rpk(b, "cluster", "config-get")
        assert json.loads(out)["values"]["fetch_max_wait_cap_ms"] == 900
        rc, out, _ = await rpk(
            b, "user", "create", "alice", "--user-password", "pw"
        )
        assert rc == 0
        assert b.controller.credentials.contains("alice")
        rc, out, _ = await rpk(
            b, "acl", "create", "--resource-name", "ct",
            "--principal", "User:alice", "--operation", "read",
        )
        assert rc == 0, out
        rc, out, _ = await rpk(b, "acl", "list")
        acls = json.loads(out)
        assert any(a["principal"] == "User:alice" for a in acls)
        rc, out, _ = await rpk(b, "topic", "trim-prefix", "ct",
                               "--partition", "0", "-o", "1")
        assert rc == 0 and "low watermark 1" in out
        rc, out, _ = await rpk(b, "topic", "delete", "ct")
        assert rc == 0


def test_cli_families(tmp_path):
    asyncio.run(_cli(tmp_path))


async def _debug_bundle(tmp_path):
    import gzip

    async with broker(tmp_path) as b:
        out_path = str(tmp_path / "bundle.json.gz")
        rc, out, err = await rpk(b, "debug", "bundle", "-o", out_path)
        assert rc == 0, err
        assert "0 errors" in out, out
        with gzip.open(out_path) as f:
            bundle = json.load(f)
        s = bundle["sections"]
        assert s["brokers"] and s["health"] and s["cluster_config"]
        assert "redpanda_tpu" in s["metrics"] or "# TYPE" in s["metrics"]
        assert "root" in s["loggers"]


def test_debug_bundle(tmp_path):
    asyncio.run(_debug_bundle(tmp_path))


async def _log_levels(tmp_path):
    import logging

    from test_torch_ref_admin_server import http

    async with broker(tmp_path) as b:
        addr = b.admin.address
        st, levels = await http(addr, "GET", "/v1/loggers")
        assert st == 200 and "root" in levels
        st, resp = await http(
            addr, "PUT", "/v1/loggers/raft?level=debug&expires_s=0.3"
        )
        assert st == 200, resp
        assert logging.getLogger("raft").level == logging.DEBUG
        await asyncio.sleep(0.5)  # expiry reverts the level
        assert logging.getLogger("raft").level != logging.DEBUG
        st, resp = await http(addr, "PUT", "/v1/loggers/raft?level=bogus")
        assert st == 400


def test_runtime_log_levels(tmp_path):
    asyncio.run(_log_levels(tmp_path))
