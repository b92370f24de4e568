"""tests/test_kafka_frontend.py run on the port: all 8 cases, with
imports pointed at redpanda_tpu_torch (the framing's native scanner is
the port's `utils.native`). Brokers run on the CPU
(`BrokerConfig(device="cpu")`) and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.

Front-end regression coverage: request framing parity, the
per-connection pipelining window, and connection-churn teardown.

The million-client front end moved framing into kafka/framing.py
(native rp_frame_scan + pure-Python twin) and made the read loop
decode ahead behind a bounded inflight window, with per-connection
protocol state (fetch sessions, quota refs) released on ANY exit
path. These tests hold the two framing legs byte-equal, pin the
window's stall/ordering behavior over a real socket, and drive an
abort storm to prove nothing leaks.
"""

import asyncio
import contextlib
import struct

import pytest

from redpanda_tpu_torch.app import Broker, BrokerConfig
from redpanda_tpu_torch.kafka.client import BrokerConnection, KafkaClient
from redpanda_tpu_torch.kafka.framing import FrameError, FrameScanner
from redpanda_tpu_torch.kafka.protocol import FETCH, Msg
from redpanda_tpu_torch.rpc.loopback import LoopbackNetwork
from redpanda_tpu_torch.utils import native
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")

MAX_FRAME = 1 << 20


def _frame(payload: bytes) -> bytes:
    return struct.pack(">i", len(payload)) + payload


def _payload(api_key, api_version, corr, body=b"") -> bytes:
    return struct.pack(">hhi", api_key, api_version, corr) + body


def _scan_all(scanner, stream, chunk):
    out = []
    for i in range(0, len(stream), chunk):
        scanner.feed(stream[i : i + chunk])
        out.extend(scanner.scan())
    return out


# -- framing: native leg vs pure-Python twin ---------------------------


def _stream(n_frames):
    return b"".join(
        _frame(_payload(k % 50, k % 12, k, body=bytes(k % 97)))
        for k in range(n_frames)
    )


def test_framing_parity_native_vs_python(monkeypatch):
    if not native.frame_scan_ready():
        pytest.skip("native library unavailable")
    stream = _stream(150)  # >64 frames exercises the refill loop too
    # every chunking, down to byte-by-byte boundary resume
    for chunk in (1, 3, 7, 64, 1000, len(stream)):
        nat = _scan_all(FrameScanner(MAX_FRAME), stream, chunk)
        monkeypatch.setenv("RP_NATIVE_FRAME", "0")
        py = _scan_all(FrameScanner(MAX_FRAME), stream, chunk)
        monkeypatch.delenv("RP_NATIVE_FRAME")
        assert nat == py, f"legs diverge at chunk={chunk}"
        assert len(nat) == 150


def test_framing_descriptor_fields():
    scanner = FrameScanner(MAX_FRAME)
    scanner.feed(_frame(_payload(18, 3, 777, body=b"hello")))
    ((payload, key, ver, corr),) = scanner.scan()
    assert (key, ver, corr) == (18, 3, 777)
    assert payload == _payload(18, 3, 777, body=b"hello")
    assert scanner.buffered == 0


def test_framing_partial_resume():
    scanner = FrameScanner(MAX_FRAME)
    whole = _frame(_payload(1, 1, 42))
    scanner.feed(whole[:5])  # size prefix + one header byte
    assert scanner.scan() == []
    assert scanner.buffered == 5
    scanner.feed(whole[5:])
    ((_, key, _, corr),) = scanner.scan()
    assert (key, corr) == (1, 42)


@pytest.mark.parametrize("native_on", [True, False])
def test_framing_garbage_rejected(monkeypatch, native_on):
    if not native_on:
        monkeypatch.setenv("RP_NATIVE_FRAME", "0")
    elif not native.frame_scan_ready():
        pytest.skip("native library unavailable")
    # below the 8-byte header floor
    s = FrameScanner(MAX_FRAME)
    s.feed(struct.pack(">i", 4) + b"abcd")
    with pytest.raises(FrameError):
        s.scan()
    # above max_frame
    s = FrameScanner(64)
    s.feed(struct.pack(">i", 65) + b"x" * 65)
    with pytest.raises(FrameError):
        s.scan()
    # negative size (random bytes / TLS-on-plaintext shapes)
    s = FrameScanner(MAX_FRAME)
    s.feed(b"\xff\xff\xff\xff\x00\x00\x00\x00\x00\x00\x00\x00")
    with pytest.raises(FrameError):
        s.scan()
    # frames BEFORE the garbage still come out of the python twin and
    # the native leg identically (the error is positional)
    s = FrameScanner(MAX_FRAME)
    s.feed(_frame(_payload(2, 0, 9)) + struct.pack(">i", 2) + b"xx")
    with pytest.raises(FrameError):
        s.scan()


# -- live broker harness ----------------------------------------------


@contextlib.asynccontextmanager
async def broker(tmp_path):
    net = LoopbackNetwork()
    b = Broker(
        BrokerConfig(
            device="cpu",
            node_id=0,
            data_dir=str(tmp_path / "n0"),
            members=[0],
            election_timeout_s=0.15,
            heartbeat_interval_s=0.03,
        ),
        loopback=net,
    )
    await b.start()
    b.config.peer_kafka_addresses = {0: b.kafka_advertised}
    try:
        await b.wait_controller_leader()
        yield b
    finally:
        await b.stop()


def _cval(counter) -> float:
    return sum(v for _, v in counter.samples())


async def _settles(check, timeout=5.0, what="condition"):
    deadline = asyncio.get_event_loop().time() + timeout
    while not check():
        if asyncio.get_event_loop().time() > deadline:
            raise AssertionError(f"{what} did not settle in {timeout}s")
        await asyncio.sleep(0.02)


def _fetch_req(topic, session_id=0, epoch=0):
    return Msg(
        replica_id=-1,
        max_wait_ms=0,
        min_bytes=0,
        max_bytes=1 << 20,
        isolation_level=0,
        session_id=session_id,
        session_epoch=epoch,
        topics=[
            Msg(
                topic=topic,
                partitions=[
                    Msg(
                        partition=0,
                        current_leader_epoch=-1,
                        fetch_offset=0,
                        log_start_offset=-1,
                        partition_max_bytes=1 << 20,
                    )
                ],
            )
        ],
        forgotten_topics_data=[],
        rack_id="",
    )


# -- pipelining window over a real socket ------------------------------


def test_inflight_window_stalls_and_preserves_order(tmp_path):
    async def run():
        async with broker(tmp_path) as b:
            server = b.kafka_server
            await b.controller.set_cluster_config(
                {"kafka_max_inflight_per_connection": "2"}
            )
            host, port = b.kafka_advertised
            reader, writer = await asyncio.open_connection(host, port)
            # one TCP write carrying 60 ApiVersions requests: the
            # reader must decode ahead only 2 at a time, stall, and
            # still answer strictly in correlation order
            n = 60
            burst = b"".join(
                _frame(
                    _payload(18, 0, 1000 + i)
                    + struct.pack(">h", 4)
                    + b"test"
                )
                for i in range(n)
            )
            stalls_before = _cval(server._inflight_stalls)
            writer.write(burst)
            await writer.drain()
            corrs = []
            for _ in range(n):
                (size,) = struct.unpack(">i", await reader.readexactly(4))
                body = await reader.readexactly(size)
                corrs.append(struct.unpack(">i", body[:4])[0])
            assert corrs == [1000 + i for i in range(n)]
            assert _cval(server._inflight_stalls) > stalls_before
            writer.close()
            await _settles(
                lambda: server._inflight == 0, what="inflight gauge"
            )

    asyncio.run(run())


# -- churn storm: aborted connections leak nothing --------------------


def test_abort_storm_releases_sessions_and_quota_state(tmp_path):
    async def run():
        async with broker(tmp_path) as b:
            server = b.kafka_server
            client = KafkaClient([b.kafka_advertised])
            await client.create_topic("churn", partitions=1, replication_factor=1)
            await client.produce("churn", 0, [(b"k", b"v")])
            await client.close()
            # server-side teardown lags the client close; settle first
            await _settles(
                lambda: len(server._conns) == 0, what="admin teardown"
            )
            assert len(server.fetch_sessions) == 0

            # 25 clients each establish a fetch session (distinct
            # client_ids -> distinct quota refs), then vanish with an
            # RST instead of a clean close/epoch=-1
            conns = []
            for i in range(25):
                c = BrokerConnection(*b.kafka_advertised, f"churner-{i}")
                await c.connect()
                resp = await c.request(FETCH, _fetch_req("churn"), 11)
                assert resp.error_code == 0 and resp.session_id > 0
                conns.append(c)
            assert len(server.fetch_sessions) == 25
            refs = server.quotas.live_state()[2]
            assert refs >= 25

            for c in conns:
                c._writer.transport.abort()
                if c._read_task is not None:
                    c._read_task.cancel()

            await _settles(
                lambda: len(server._conns) == 0, what="connection set"
            )
            # EVERY abort released its session and its quota refs —
            # the leak the churn-storm satellite exists to catch
            assert len(server.fetch_sessions) == 0
            assert server.fetch_sessions.mem_bytes() == 0
            assert server.quotas.live_state() == (0, 0, 0)
            assert server._inflight == 0

    asyncio.run(run())


def test_mid_frame_abort_is_clean(tmp_path):
    async def run():
        async with broker(tmp_path) as b:
            server = b.kafka_server
            host, port = b.kafka_advertised
            base = len(server._conns)
            # half-written frames + garbage prefixes, then abort
            for i in range(10):
                reader, writer = await asyncio.open_connection(host, port)
                if i % 2:
                    writer.write(struct.pack(">i", 500) + b"partial")
                else:
                    writer.write(b"\x00\x00\x00\x02xx")  # under the floor
                await writer.drain()
                writer.transport.abort()
            await _settles(
                lambda: len(server._conns) == base, what="connection set"
            )
            assert server._inflight == 0

    asyncio.run(run())
