"""tests/test_kreq_fuzz.py run on the port: its 1 case, with imports
pointed at redpanda_tpu_torch. `broker_cluster` and `client_for` come
from `test_torch_ref_kafka_e2e` (brokers on the CPU,
`BrokerConfig(device="cpu")`), and an autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
Nothing is left out.

Kafka protocol robustness fuzz (kreq-gen analog).

Reference: src/go/kreq-gen emits arbitrary Kafka protocol requests for
compat fuzzing. Here a seeded generator throws garbage frames,
truncated headers, unknown api keys/versions, and random-but-framed
payloads for every advertised API at the REAL TCP listener; the oracle
is that the broker never crashes and keeps serving valid clients —
malformed input may close that one connection, never the server.
"""

import asyncio
import random
import struct

from redpanda_tpu_torch.kafka.client import KafkaClient
from redpanda_tpu_torch.kafka.protocol.apis import ALL_APIS

from test_torch_ref_kafka_e2e import broker_cluster, client_for
import pytest

from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")


async def _send_raw(host, port, payload: bytes, await_reply: bool) -> bytes:
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(payload)
        await writer.drain()
        if await_reply:
            try:
                return await asyncio.wait_for(reader.read(256), timeout=0.5)
            except asyncio.TimeoutError:
                return b""
        return b""
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass


def _frame(body: bytes) -> bytes:
    return struct.pack(">i", len(body)) + body


def _header(api_key: int, version: int, corr: int, client: bytes = b"fuzz") -> bytes:
    return (
        struct.pack(">hhi", api_key, version, corr)
        + struct.pack(">h", len(client))
        + client
    )


async def _fuzz(tmp_path):
    rng = random.Random(1234)
    async with broker_cluster(tmp_path, 1) as brokers:
        host, port = brokers[0].kafka_advertised

        async def still_alive():
            async with client_for(brokers) as client:
                md = await client.metadata()
                assert md.brokers

        # 1. pure garbage bytes (no framing)
        for _ in range(10):
            await _send_raw(host, port, rng.randbytes(rng.randrange(1, 300)), False)

        # 2. framed garbage: valid length prefix, random body
        for _ in range(20):
            await _send_raw(
                host, port, _frame(rng.randbytes(rng.randrange(0, 200))), True
            )

        # 3. oversized / negative length prefixes
        for n in (0x7FFFFFFF, -1, -1000, 1 << 30):
            await _send_raw(host, port, struct.pack(">i", n) + b"xx", False)

        # 4. truncated headers (every prefix length of a real one)
        hdr = _header(3, 9, 1)
        for cut in range(len(hdr)):
            await _send_raw(host, port, _frame(hdr[:cut]), True)

        await still_alive()

        # 5. unknown api keys and far-future versions
        for key, ver in [(999, 0), (-5, 0), (3, 99), (0, -3), (18, 32767)]:
            await _send_raw(
                host, port, _frame(_header(key, ver, 7) + b"\x00" * 8), True
            )

        # 6. every advertised API with random framed payload junk
        for api in ALL_APIS:
            for v in range(api.min_version, api.max_version + 1):
                body = _header(api.key, v, rng.randrange(1 << 20)) + rng.randbytes(
                    rng.randrange(0, 64)
                )
                await _send_raw(host, port, _frame(body), True)

        # 7. a VALID api_versions must still work on a fresh connection,
        # and the full client path must be intact
        resp = await _send_raw(
            host, port, _frame(_header(18, 0, 42)), True
        )
        assert len(resp) >= 8  # length + correlation id at minimum
        (corr,) = struct.unpack(">i", resp[4:8])
        assert corr == 42
        await still_alive()


def test_kreq_fuzz(tmp_path):
    asyncio.run(_fuzz(tmp_path))
