"""tests/test_transforms.py run on the port: all 5 cases, with imports
pointed at redpanda_tpu_torch. The brokers come from
`test_torch_ref_kafka_e2e`'s fixtures, on the CPU
(`BrokerConfig(device="cpu")`). An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu" (the
kernels' plain versions). Nothing is left out.

Data transforms (coproc analog).

Reference test model: coproc/tests — scripts consume source partitions
and write materialized topics; progress survives restarts; errors
don't wedge the stream.
"""

import asyncio

import pytest

from redpanda_tpu_torch.kafka.client import KafkaClient
from redpanda_tpu_torch.transforms import TransformSpec

from test_torch_ref_kafka_e2e import broker_cluster, client_for
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


async def _poll_dest(client, topic, pid, want, timeout=15.0):
    deadline = asyncio.get_event_loop().time() + timeout
    got = []
    while asyncio.get_event_loop().time() < deadline:
        got = await client.fetch(topic, pid, 0)
        if len(got) >= want:
            return got
        await asyncio.sleep(0.2)
    return got


async def _basic(tmp_path):
    async with broker_cluster(tmp_path, 1) as brokers:
        b = brokers[0]
        async with client_for(brokers) as client:
            await client.create_topic("src", partitions=2, replication_factor=1)
            await client.create_topic("dst", partitions=2, replication_factor=1)

            def upper(k, v):
                if v == b"drop-me":
                    return None  # filtering
                if v == b"fan-out":
                    return [(k, b"A"), (k, b"B")]  # 1 -> N
                return (k, v.upper())

            b.transforms.register(
                TransformSpec("upper", "src", "dst", upper)
            )
            await client.produce("src", 0, [(b"k1", b"hello")])
            await client.produce("src", 0, [(None, b"drop-me")])
            await client.produce("src", 0, [(b"k2", b"fan-out")])
            await client.produce("src", 1, [(b"k3", b"world")])

            got0 = await _poll_dest(client, "dst", 0, 3)
            assert [(k, v) for _o, k, v in got0] == [
                (b"k1", b"HELLO"),
                (b"k2", b"A"),
                (b"k2", b"B"),
            ]
            got1 = await _poll_dest(client, "dst", 1, 1)
            assert [(k, v) for _o, k, v in got1] == [(b"k3", b"WORLD")]

            # the counter bumps only after the fiber's offset-commit
            # lands, which can trail the (already visible) dst produce
            # on a loaded box — poll instead of reading instantly
            deadline = asyncio.get_event_loop().time() + 15.0
            while asyncio.get_event_loop().time() < deadline:
                st = b.transforms.status()
                if st.get("upper", {}).get("0", {}).get("transformed") == 3:
                    break
                await asyncio.sleep(0.05)
            assert st["upper"]["0"]["transformed"] == 3
            assert st["upper"]["0"]["errors"] == 0


def test_transform_basic(tmp_path):
    asyncio.run(_basic(tmp_path))


async def _resume(tmp_path):
    """Progress is a committed group offset: a re-registered transform
    (service restart analog) resumes where it left off — no replays
    into the destination beyond the at-least-once window."""
    async with broker_cluster(tmp_path, 1) as brokers:
        b = brokers[0]
        async with client_for(brokers) as client:
            await client.create_topic("src", partitions=1, replication_factor=1)
            await client.create_topic("dst", partitions=1, replication_factor=1)
            b.transforms.register(
                TransformSpec("echo", "src", "dst", lambda k, v: (k, v))
            )
            for i in range(5):
                await client.produce("src", 0, [(b"k", b"v%d" % i)])
            assert len(await _poll_dest(client, "dst", 0, 5)) == 5
            # wait for the fiber's offset-commit to land before the
            # "restart": deregistering inside the produce→commit window
            # legitimately replays (at-least-once) and is not what this
            # test pins
            deadline = asyncio.get_event_loop().time() + 15.0
            while asyncio.get_event_loop().time() < deadline:
                st = b.transforms.status().get("echo", {}).get("0", {})
                if st.get("offset") == 5:
                    break
                await asyncio.sleep(0.05)
            assert st.get("offset") == 5, st

            # stop fibers (deregister), produce more, re-register
            b.transforms.deregister("echo")
            await asyncio.sleep(0.2)
            for i in range(5, 8):
                await client.produce("src", 0, [(b"k", b"v%d" % i)])
            b.transforms.register(
                TransformSpec("echo", "src", "dst", lambda k, v: (k, v))
            )
            got = await _poll_dest(client, "dst", 0, 8)
            values = [v for _o, _k, v in got]
            assert values == [b"v%d" % i for i in range(8)], values


def test_transform_resume_from_committed_offset(tmp_path):
    asyncio.run(_resume(tmp_path))


async def _poison(tmp_path):
    async with broker_cluster(tmp_path, 1) as brokers:
        b = brokers[0]
        async with client_for(brokers) as client:
            await client.create_topic("src", partitions=1, replication_factor=1)
            await client.create_topic("dst", partitions=1, replication_factor=1)

            def explode(k, v):
                if v == b"poison":
                    raise ValueError("bad record")
                return (k, v)

            b.transforms.register(TransformSpec("p", "src", "dst", explode))
            await client.produce("src", 0, [(b"a", b"ok1")])
            await client.produce("src", 0, [(b"b", b"poison")])
            await client.produce("src", 0, [(b"c", b"ok2")])
            got = await _poll_dest(client, "dst", 0, 2)
            assert [v for _o, _k, v in got] == [b"ok1", b"ok2"]
            st = b.transforms.status()
            assert st["p"]["0"]["errors"] >= 1
            assert "bad record" in st["p"]["0"]["last_error"]


def test_transform_poison_record_skipped(tmp_path):
    asyncio.run(_poison(tmp_path))


async def _follows_leadership(tmp_path):
    """Fibers run only on the source partition's leader; on a 3-broker
    cluster exactly one broker runs each partition's fiber."""
    async with broker_cluster(tmp_path, 3) as brokers:
        async with client_for(brokers) as client:
            await client.create_topic("src", partitions=3, replication_factor=3)
            await client.create_topic("dst", partitions=3, replication_factor=3)
            for b in brokers:
                b.transforms.register(
                    TransformSpec("fan", "src", "dst", lambda k, v: (k, v))
                )
            for pid in range(3):
                await client.produce("src", pid, [(b"k", b"v-%d" % pid)])
            for pid in range(3):
                got = await _poll_dest(client, "dst", pid, 1)
                assert [v for _o, _k, v in got] == [b"v-%d" % pid]
            # each partition's fiber settles onto exactly one broker
            # (poll: pacemaker scans + fiber teardown race a fixed
            # sleep on a loaded 1-core machine)
            deadline = asyncio.get_event_loop().time() + 20
            while True:
                owners_by_pid = {
                    pid: [
                        b.node_id
                        for b in brokers
                        if b.transforms.status()
                        .get("fan", {})
                        .get(str(pid), {})
                        .get("running")
                    ]
                    for pid in range(3)
                }
                if all(len(o) == 1 for o in owners_by_pid.values()):
                    break
                assert (
                    asyncio.get_event_loop().time() < deadline
                ), owners_by_pid
                await asyncio.sleep(0.2)


def test_transform_follows_leadership(tmp_path):
    asyncio.run(_follows_leadership(tmp_path))


async def _failover_continuity(tmp_path):
    """Chaos: kill the broker running a partition's transform fiber
    mid-stream. The new leader's pacemaker resumes from the committed
    group offset: EVERY source record eventually reaches the
    destination (at-least-once — duplicates allowed, loss is not)."""
    async with broker_cluster(tmp_path, 3) as brokers:
        alive = dict(enumerate(brokers))
        async with client_for(brokers) as client:
            await client.create_topic("src", partitions=1, replication_factor=3)
            await client.create_topic("dst", partitions=1, replication_factor=3)
            for b in brokers:
                b.transforms.register(
                    TransformSpec("ha", "src", "dst", lambda k, v: (k, v))
                )
            n_pre = 20
            for i in range(n_pre):
                await client.produce("src", 0, [(b"k", b"v%d" % i)])
            # wait until the fiber made progress, then kill its broker
            deadline = asyncio.get_event_loop().time() + 40
            owner = None
            while owner is None:
                for nid, b in alive.items():
                    st = b.transforms.status().get("ha", {}).get("0")
                    if st and st["transformed"] > 0 and st["running"]:
                        owner = nid
                        break
                assert asyncio.get_event_loop().time() < deadline, {
                    nid: b.transforms.status().get("ha")
                    for nid, b in alive.items()
                }
                await asyncio.sleep(0.1)
            await alive.pop(owner).stop()

            # keep producing through the failover
            for i in range(n_pre, 35):
                ok_deadline = asyncio.get_event_loop().time() + 20
                while True:
                    try:
                        await client.produce("src", 0, [(b"k", b"v%d" % i)])
                        break
                    except Exception as e:
                        assert (
                            asyncio.get_event_loop().time() < ok_deadline
                        ), f"produce v{i} stuck on: {type(e).__name__}: {e}"
                        await asyncio.sleep(0.2)

            # every record lands in dst (dupes fine), in order per dup
            deadline = asyncio.get_event_loop().time() + 30
            last_err = None
            while True:
                try:
                    got = await client.fetch("dst", 0, 0, max_bytes=1 << 22)
                except Exception as e:  # dst leadership also failing over
                    got, last_err = [], e
                values = {v for _o, _k, v in got}
                want = {b"v%d" % i for i in range(35)}
                if want <= values:
                    break
                assert asyncio.get_event_loop().time() < deadline, (
                    sorted(want - values)[:5],
                    last_err,
                )
                await asyncio.sleep(0.3)
            # the fiber moved to a surviving broker
            owners = [
                nid
                for nid, b in alive.items()
                if b.transforms.status().get("ha", {}).get("0", {}).get(
                    "running"
                )
            ]
            assert owner not in owners and len(owners) >= 1


@pytest.mark.timing
def test_transform_failover_continuity(tmp_path):
    asyncio.run(_failover_continuity(tmp_path))
