"""tests/test_standalone.py run on the port: all 3 test functions, with
imports pointed at redpanda_tpu_torch. Every broker is the port's on the
CPU (`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu". The
three node processes run `python -m redpanda_tpu_torch --device cpu` and
the CLI `python -m redpanda_tpu_torch.cli` (the edited strings);
`tools/log_viewer.py`, unedited, reads the port broker's data dir.
Nothing is left out.


Standalone entrypoint + tooling.

Reference models: redpanda/main.cc (process entrypoint), src/go/rpk
generate (manifests), tools/offline_log_viewer.
"""

import asyncio
import signal
import socket
import subprocess
import sys
import time

import pytest
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")

REPO = __file__.rsplit("/tests/", 1)[0]


def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def test_standalone_three_process_cluster(tmp_path):
    """Three REAL OS processes via `python -m redpanda_tpu_torch`: form a
    cluster over TCP, serve rf=3 produce/consume, answer admin health,
    exit 0 on SIGTERM."""
    ports = _free_ports(9)
    rpc, kafka, admin = ports[0:3], ports[3:6], ports[6:9]
    seeds = ",".join(f"127.0.0.1:{p}" for p in rpc)
    procs = []
    logs = []
    for i in range(3):
        # stderr to a FILE: a PIPE nobody drains would deadlock a
        # chatty child once the 64KB buffer fills
        log = open(tmp_path / f"n{i}.stderr", "w+")
        logs.append(log)
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m", "redpanda_tpu_torch", "--device", "cpu",
                    "--node-id", str(i),
                    "--data-dir", str(tmp_path / f"n{i}"),
                    "--seeds", seeds,
                    "--kafka-host", "127.0.0.1",
                    "--kafka-port", str(kafka[i]),
                    "--rpc-port", str(rpc[i]),
                    "--admin-port", str(admin[i]),
                ],
                cwd=REPO,
                stderr=log,
                text=True,
            )
        )

    async def drive():
        from redpanda_tpu_torch.kafka.client import KafkaClient

        c = KafkaClient([("127.0.0.1", p) for p in kafka])
        deadline = time.time() + 30
        while True:
            try:
                await c.create_topic("proc", partitions=3, replication_factor=3)
                break
            except Exception:
                if time.time() > deadline:
                    raise
                await asyncio.sleep(0.5)
        for i in range(30):
            await c.produce("proc", i % 3, [(b"k%d" % i, b"v%d" % i)])
        total = 0
        for p in range(3):
            total += len(await c.fetch("proc", p, 0))
        assert total == 30
        await c.close()

    def tail(i):
        logs[i].seek(0)
        return logs[i].read()[-800:]

    try:
        asyncio.run(drive())
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for i, p in enumerate(procs):
            assert p.wait(timeout=20) == 0, tail(i)
    finally:
        for i, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
            logs[i].close()


def test_generate_k8s_manifests():
    r = subprocess.run(
        [
            sys.executable, "-m", "redpanda_tpu_torch.cli",
            "generate", "k8s", "--name", "rp", "--replicas", "5",
        ],
        cwd=REPO,
        capture_output=True,
        text=True,
    )
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert "kind: StatefulSet" in out and "kind: Service" in out
    assert "replicas: 5" in out
    assert "--node-id-from-hostname" in out
    # seed list covers every replica's stable DNS name
    for i in range(5):
        assert f"rp-{i}.rp.default.svc:33145" in out
    # well-formed YAML if a parser is available
    try:
        import yaml

        docs = list(yaml.safe_load_all(out))
        assert len(docs) == 2
        assert docs[1]["spec"]["replicas"] == 5
    except ImportError:
        pass


def test_log_viewer_offline(tmp_path):
    async def build():
        from redpanda_tpu_torch.app import Broker, BrokerConfig
        from redpanda_tpu_torch.kafka.client import KafkaClient
        from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork

        b = Broker(
            BrokerConfig(device="cpu", node_id=0, data_dir=str(tmp_path / "n0"), members=[0]),
            loopback=LoopbackNetwork(),
        )
        await b.start()
        c = KafkaClient([b.kafka_advertised])
        await c.create_topic("viewme", partitions=1, replication_factor=1)
        await c.produce("viewme", 0, [(b"key-a", b"value-a")])
        await c.close()
        await b.stop()

    asyncio.run(build())
    d = str(tmp_path / "n0")
    # overview
    r = subprocess.run(
        [sys.executable, "tools/log_viewer.py", d],
        cwd=REPO, capture_output=True, text=True,
    )
    assert r.returncode == 0 and "kafka/viewme/0" in r.stdout
    # verbose single-ntp dump shows the record
    r = subprocess.run(
        [sys.executable, "tools/log_viewer.py", d, "--ntp", "kafka/viewme/0", "-v"],
        cwd=REPO, capture_output=True, text=True,
    )
    assert "'key-a'" in r.stdout and "'value-a'" in r.stdout
    # controller decode names the create_topic command
    r = subprocess.run(
        [sys.executable, "tools/log_viewer.py", d, "--controller"],
        cwd=REPO, capture_output=True, text=True,
    )
    assert "create_topic" in r.stdout and "viewme" in r.stdout
