"""tests/test_rpc.py run on the port: all 11 cases, with imports pointed
at redpanda_tpu_torch. Nothing is left out.

Serde envelope + RPC transport/server tests
(reference test model: rpc/test/rpc_gen_cycling_test.cc, serde tests)."""

import asyncio

import pytest

from redpanda_tpu_torch.rpc import (
    ConnectionCache,
    FrameHeader,
    LoopbackNetwork,
    LoopbackTransport,
    ReconnectTransport,
    RpcError,
    RpcServer,
    Service,
    Status,
    TcpTransport,
    method,
)
from redpanda_tpu_torch.rpc.types import make_frame
from redpanda_tpu_torch.utils import serde
from redpanda_tpu_torch.utils.hbadger import Probe, honey_badger


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


# ---------------------------------------------------------------- serde


class Inner(serde.Envelope):
    SERDE_FIELDS = [("x", serde.i32), ("name", serde.string)]


class Outer(serde.Envelope):
    SERDE_VERSION = 2
    SERDE_FIELDS = [
        ("id", serde.i64),
        ("flag", serde.boolean),
        ("blob", serde.bytes_t),
        ("maybe", serde.optional(serde.i32)),
        ("items", serde.vector(serde.envelope(Inner))),
        ("table", serde.mapping(serde.string, serde.i64)),
    ]


def test_serde_roundtrip():
    msg = Outer(
        id=-5,
        flag=True,
        blob=b"\x00\x01",
        maybe=None,
        items=[Inner(x=1, name="a"), Inner(x=-2, name="é")],
        table={"k": 2**40},
    )
    out = Outer.decode(msg.encode())
    assert out == msg
    assert out.maybe is None
    assert out.items[1].name == "é"


def test_serde_forward_compat_skips_unknown_tail():
    # a "newer peer" appends an extra field: decoder must skip it
    msg = Inner(x=7, name="n")
    raw = bytearray(msg.encode())
    raw += b"\xde\xad\xbe\xef"  # unknown trailing field bytes
    # patch payload_size (+4)
    import struct

    size = struct.unpack("<I", raw[2:6])[0] + 4
    raw[2:6] = struct.pack("<I", size)
    out = Inner.decode(bytes(raw))
    assert out.x == 7 and out.name == "n"


def test_serde_compat_version_rejected():
    msg = Inner(x=1, name="z")
    raw = bytearray(msg.encode())
    raw[1] = 9  # compat_version 9 > known version 1
    with pytest.raises(serde.SerdeError):
        Inner.decode(bytes(raw))


# ---------------------------------------------------------------- frame


def test_frame_header_roundtrip_and_crc():
    frame = bytes(make_frame(7, 42, b"hello"))  # IOBuf of fragments
    hdr = FrameHeader.unpack(frame[:24])
    assert hdr.method_id == 7 and hdr.correlation == 42
    assert hdr.payload_size == 5
    corrupted = bytearray(frame)
    corrupted[4] ^= 0xFF
    with pytest.raises(RpcError):
        FrameHeader.unpack(bytes(corrupted[:24]))


def test_frame_over_fragmented_payload():
    """A multi-fragment IOBuf payload frames without linearizing and
    CRCs identically to the equivalent contiguous payload."""
    from redpanda_tpu_torch.utils.iobuf import IOBuf

    parts = [b"alpha", b"-", b"beta" * 100, b"!"]
    buf = IOBuf()
    for p in parts:
        buf.append(p)
    flat = b"".join(parts)
    framed = make_frame(9, 1, buf)
    assert framed.num_fragments() >= len(parts)  # nothing was joined
    framed_flat = bytes(make_frame(9, 1, flat))
    assert bytes(framed) == framed_flat
    hdr = FrameHeader.unpack(bytes(framed)[:24])
    assert hdr.payload_size == len(flat)


# ---------------------------------------------------------------- services


class EchoService(Service):
    service_name = "echo"

    @method(1)
    async def echo(self, payload: bytes) -> bytes:
        return payload

    @method(2)
    async def boom(self, payload: bytes) -> bytes:
        raise ValueError("kaboom")

    @method(3)
    async def slow(self, payload: bytes) -> bytes:
        await asyncio.sleep(0.2)
        return b"slow"


def test_tcp_rpc_roundtrip():
    async def main():
        server = RpcServer()
        server.register(EchoService())
        await server.start()
        client = TcpTransport("127.0.0.1", server.port)
        await client.connect()
        try:
            assert await client.call(1, b"ping") == b"ping"
            with pytest.raises(RpcError) as ei:
                await client.call(2, b"")
            assert ei.value.status == Status.SERVICE_ERROR
            with pytest.raises(RpcError) as ei:
                await client.call(99, b"")
            assert ei.value.status == Status.METHOD_NOT_FOUND
        finally:
            await client.close()
            await server.stop()

    run(main())


def test_tcp_rpc_concurrent_multiplexing():
    async def main():
        server = RpcServer()
        server.register(EchoService())
        await server.start()
        client = TcpTransport("127.0.0.1", server.port)
        await client.connect()
        try:
            # slow call does not block fast ones on the same connection
            slow = asyncio.ensure_future(client.call(3, b""))
            fast = await asyncio.gather(
                *(client.call(1, f"m{i}".encode()) for i in range(20))
            )
            assert fast == [f"m{i}".encode() for i in range(20)]
            assert await slow == b"slow"
        finally:
            await client.close()
            await server.stop()

    run(main())


def test_rpc_timeout():
    async def main():
        server = RpcServer()
        server.register(EchoService())
        await server.start()
        client = TcpTransport("127.0.0.1", server.port)
        await client.connect()
        try:
            with pytest.raises(RpcError) as ei:
                await client.call(3, b"", timeout=0.02)
            assert ei.value.status == Status.TIMEOUT
        finally:
            await client.close()
            await server.stop()

    run(main())


def test_reconnect_transport_and_connection_cache():
    async def main():
        server = RpcServer()
        server.register(EchoService())
        await server.start()
        port = server.port

        cache = ConnectionCache(lambda nid: TcpTransport("127.0.0.1", port))
        assert await cache.call(1, 1, b"x") == b"x"

        # kill the server: next call must raise, then backoff blocks
        await server.stop()
        with pytest.raises((ConnectionError, RpcError)):
            await cache.call(1, 1, b"y", timeout=0.2)

        # restart on the same port and wait out the backoff
        server2 = RpcServer(port=port)
        server2.register(EchoService())
        await server2.start()
        deadline = asyncio.get_event_loop().time() + 5.0
        while True:
            try:
                assert await cache.call(1, 1, b"z") == b"z"
                break
            except (ConnectionError, RpcError):
                if asyncio.get_event_loop().time() > deadline:
                    raise
                await asyncio.sleep(0.05)
        await cache.close()
        await server2.stop()

    run(main())


def test_loopback_network_and_partitions():
    async def main():
        net = LoopbackNetwork()
        net.register(1, EchoService())
        t = LoopbackTransport(net, src=2, dst=1)
        await t.connect()
        assert await t.call(1, b"hi") == b"hi"

        net.isolate(1)
        with pytest.raises(ConnectionError):
            await t.call(1, b"hi")
        net.heal()
        assert await t.call(1, b"hi") == b"hi"

        net.cut_link(2, 1)
        with pytest.raises(ConnectionError):
            await t.call(1, b"hi")
        net.heal(1)
        assert await t.call(1, b"hi") == b"hi"

    run(main())


def test_honey_badger_injection():
    async def main():
        net = LoopbackNetwork()
        net.register(1, EchoService())
        t = LoopbackTransport(net, src=0, dst=1)
        honey_badger.arm("echo", "echo", Probe(exception=RuntimeError("inj"), count=1))
        try:
            # surfaces with the TCP contract: RpcError(SERVICE_ERROR)
            with pytest.raises(RpcError) as ei:
                await t.call(1, b"hi")
            assert ei.value.status == Status.SERVICE_ERROR
            # count exhausted → next call succeeds
            assert await t.call(1, b"hi") == b"hi"
        finally:
            honey_badger.clear()

    run(main())
