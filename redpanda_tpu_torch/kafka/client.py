"""Internal Kafka protocol client.

Reference: src/v/kafka/client/ — the self-contained client
(client.{h,cc}, producer, consumer, brokers) used by pandaproxy,
schema registry and the test suite. Speaks the public protocol, so it
doubles as a protocol-conformance check against our own server (and
works against any Kafka broker).
"""

from __future__ import annotations

import asyncio
import itertools
import struct
import time
from collections import deque
from typing import Optional, Sequence

from ..models.record import RecordBatch, RecordBatchBuilder
from ..utils.locks import LockMap
from .protocol import (
    API_VERSIONS,
    CREATE_TOPICS,
    FETCH,
    LIST_OFFSETS,
    METADATA,
    PRODUCE,
    ErrorCode,
    Msg,
    Reader,
    RequestHeader,
    encode_request_header,
)
from .protocol import produce_fast

_SIZE = struct.Struct(">i")


class KafkaClientError(Exception):
    def __init__(self, code: int, context: str = ""):
        try:
            name = ErrorCode(code).name
        except ValueError:
            name = str(code)
        super().__init__(f"{context}: {name}" if context else name)
        self.code = code


class _RxStampProtocol(asyncio.StreamReaderProtocol):
    """StreamReaderProtocol stamping time.monotonic() on the first
    data_received after being armed (rx_t0 = -1.0) — the response's
    first-byte arrival for serial_reads latency accounting. Mirrors
    the server's request-side rx stamp: on a shared single-core loop
    the gap between bytes arriving and the awaiting task resuming is
    scheduling backlog, not broker latency, and a load generator that
    stamps at task resume charges that backlog to the broker."""

    def __init__(self, stream_reader, loop):
        super().__init__(stream_reader, loop=loop)
        self.rx_t0 = -1.0

    def data_received(self, data: bytes) -> None:
        if self.rx_t0 < 0.0:
            self.rx_t0 = time.monotonic()
        super().data_received(data)


class BrokerConnection:
    def __init__(
        self,
        host: str,
        port: int,
        client_id: str,
        sasl: tuple[str, str, str] | None = None,  # (user, password, mechanism)
        ssl=None,  # ssl.SSLContext for TLS/mTLS listeners
        gssapi=None,  # security.gssapi_authenticator.GssapiClient
        serial_reads: bool = False,
    ):
        self.host = host
        self.port = port
        self._client_id = client_id
        self._sasl = sasl
        self._ssl = ssl
        self._gssapi = gssapi
        # serial_reads: no background read loop — the caller reads its
        # own response inline while holding the write lock, so the
        # socket's data_received wakes the requester directly instead
        # of read-loop → set_result → requester (one scheduling hop
        # fewer per round trip, a real millisecond on a loaded loop).
        # Trades away pipelining: requests on the connection serialize.
        # Load generators use it so the client's dispatch machinery
        # doesn't pollute broker latency numbers (same reasoning as
        # produce_wire's encode-once contract).
        self._serial = serial_reads
        self._rx_proto: Optional[_RxStampProtocol] = None
        # arrival stamp (time.monotonic) of the newest serial response
        self.last_rx_monotonic = 0.0
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._corr = itertools.count(1)
        self._lock = asyncio.Lock()
        # pipelining: in-flight requests answered strictly in order
        # (kafka guarantees per-connection response order)
        self._pending: "deque[tuple[int, asyncio.Future]]" = deque()
        self._read_task: Optional[asyncio.Task] = None
        self._dead: Optional[str] = None  # terminal read-loop error
        self.api_versions: dict[int, tuple[int, int]] = {}

    async def connect(self) -> None:
        if self._serial:
            # custom protocol so the response arrival instant is
            # observable (asyncio.open_connection hides the protocol)
            loop = asyncio.get_event_loop()
            reader = asyncio.StreamReader(limit=1 << 21, loop=loop)
            proto = _RxStampProtocol(reader, loop)
            transport, _ = await loop.create_connection(
                lambda: proto, self.host, self.port, ssl=self._ssl
            )
            self._rx_proto = proto
            self._reader = reader
            self._writer = asyncio.StreamWriter(
                transport, proto, reader, loop
            )
        else:
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port, ssl=self._ssl, limit=1 << 21
            )
            self._read_task = asyncio.ensure_future(self._read_loop())
        resp = await self.request(API_VERSIONS, Msg(), version=2)
        if resp.error_code != 0:
            raise KafkaClientError(resp.error_code, "api_versions")
        self.api_versions = {
            k.api_key: (k.min_version, k.max_version) for k in resp.api_keys
        }
        if self._gssapi is not None:
            await self._authenticate_gssapi()
        elif self._sasl is not None:
            await self._authenticate(*self._sasl)

    async def _authenticate_gssapi(self) -> None:
        """SASL/GSSAPI (RFC 4752): AP-REQ -> AP-REP -> empty -> wrap
        offer -> wrap choice, over SaslHandshake + SaslAuthenticate."""
        from .protocol.admin_apis import SASL_AUTHENTICATE, SASL_HANDSHAKE

        resp = await self.request(
            SASL_HANDSHAKE, Msg(mechanism="GSSAPI"), version=1
        )
        if resp.error_code != 0:
            raise KafkaClientError(resp.error_code, "sasl_handshake")

        async def step(payload: bytes) -> bytes:
            r = await self.request(
                SASL_AUTHENTICATE, Msg(auth_bytes=payload), version=1
            )
            if r.error_code != 0:
                raise KafkaClientError(r.error_code, "gssapi auth")
            return bytes(r.auth_bytes)

        ap_rep = await step(self._gssapi.initial_token())
        self._gssapi.verify_ap_rep(ap_rep)
        offer = await step(b"")
        await step(self._gssapi.negotiate(offer))

    async def _authenticate(
        self, user: str, password: str, mechanism: str
    ) -> None:
        """SCRAM client exchange (RFC 5802) or OAUTHBEARER (RFC 7628,
        token passed in the password slot) over SaslHandshake +
        SaslAuthenticate."""
        from ..security import scram as sc
        from .protocol.admin_apis import SASL_AUTHENTICATE, SASL_HANDSHAKE

        resp = await self.request(
            SASL_HANDSHAKE, Msg(mechanism=mechanism), version=1
        )
        if resp.error_code != 0:
            raise KafkaClientError(resp.error_code, "sasl_handshake")
        if mechanism == "OAUTHBEARER":
            from ..security import oidc as oidc_mod

            resp = await self.request(
                SASL_AUTHENTICATE,
                Msg(auth_bytes=oidc_mod.client_first_message(password)),
                version=1,
            )
            if resp.error_code != 0:
                raise KafkaClientError(resp.error_code, "oauthbearer auth")
            return
        first, nonce = sc.client_first_message(user)
        resp = await self.request(
            SASL_AUTHENTICATE, Msg(auth_bytes=first.encode()), version=1
        )
        if resp.error_code != 0:
            raise KafkaClientError(resp.error_code, "sasl server-first")
        final, expect_sig = sc.client_final_message(
            password, mechanism, first, bytes(resp.auth_bytes), nonce
        )
        resp = await self.request(
            SASL_AUTHENTICATE, Msg(auth_bytes=final.encode()), version=1
        )
        if resp.error_code != 0:
            raise KafkaClientError(resp.error_code, "sasl client-final")
        server_final = bytes(resp.auth_bytes).decode()
        import base64

        if server_final != f"v={base64.b64encode(expect_sig).decode()}":
            raise KafkaClientError(
                int(ErrorCode.sasl_authentication_failed),
                "server signature mismatch",
            )

    async def _read_loop(self) -> None:
        try:
            while True:
                raw_size = await self._reader.readexactly(4)
                (size,) = _SIZE.unpack(raw_size)
                payload = await self._reader.readexactly(size)
                if not self._pending:
                    raise KafkaClientError(
                        int(ErrorCode.network_exception), "unsolicited response"
                    )
                corr, fut = self._pending.popleft()
                if not fut.done():
                    fut.set_result(payload)
        except asyncio.CancelledError:
            # _dead is a monotonic poison flag (None -> reason): any
            # writer's value is terminal, readers only check is-dead,
            # so the read loop needn't take the serial-request lock
            self._dead = "closed"  # rplint: disable=RPL016
            raise
        except Exception as e:
            self._dead = str(e) or type(e).__name__  # rplint: disable=RPL016
            while self._pending:
                _corr, fut = self._pending.popleft()
                if not fut.done():
                    fut.set_exception(
                        KafkaClientError(
                            int(ErrorCode.network_exception), str(e)
                        )
                    )

    def pick_version(self, api, preferred: int) -> int:
        rng = self.api_versions.get(api.key)
        if rng is None:
            return preferred
        lo, hi = rng
        v = min(preferred, hi, api.max_version)
        if v < max(lo, api.min_version):
            raise KafkaClientError(
                int(ErrorCode.unsupported_version), api.name
            )
        return v

    async def request(self, api, req, version: int) -> Msg:
        return await self.request_raw(
            api, api.encode_request(req, version), version
        )

    async def request_raw(self, api, body: bytes, version: int) -> Msg:
        """Send a PRE-ENCODED request body. Benchmarks measuring broker
        throughput encode the (identical) body once so client-side
        encoding doesn't pollute the server number; normal callers use
        request()."""
        rbody = await self.request_body(api, body, version)
        if api.key == API_VERSIONS.key and version > 0:
            # the broker may have replied with the v0 downgrade body
            # (error 35 + api_keys, no throttle field), which fails to
            # decode at the requested version — decode v0 first and
            # only trust the requested-version decode when the reply
            # is not a downgrade
            try:
                resp = api.decode_response(rbody, version)
                if resp.error_code != int(ErrorCode.unsupported_version):
                    return resp
            except Exception:
                pass
            return api.decode_response(rbody, 0)
        return api.decode_response(rbody, version)

    async def request_body(self, api, body: bytes, version: int):
        """Send a pre-encoded body; return the RAW response body
        (correlation checked, response-header tags skipped) — callers
        with a hand-rolled decoder (produce fast path) skip the
        generic tree decode."""
        hdr = RequestHeader(api.key, version, next(self._corr), self._client_id)
        head = encode_request_header(hdr)
        if self._dead is not None:
            raise KafkaClientError(
                int(ErrorCode.network_exception), f"connection dead: {self._dead}"
            )
        if self._serial:
            payload = await self._request_serial(head, body)
        else:
            fut = asyncio.get_event_loop().create_future()
            async with self._lock:  # order registration with the write
                self._pending.append((hdr.correlation_id, fut))
                # writelines joins once in the transport — no
                # intermediate size+head+body concat of MB-scale
                # produce frames here
                self._writer.writelines(
                    (_SIZE.pack(len(head) + len(body)), head, body)
                )
                await self._writer.drain()
            # belt-and-braces: if the read loop died while we drained,
            # our future was in _pending and is already failed; this
            # catches any path where it wasn't
            if self._dead is not None and not fut.done():
                try:
                    self._pending.remove((hdr.correlation_id, fut))
                except ValueError:
                    pass
                raise KafkaClientError(
                    int(ErrorCode.network_exception),
                    f"connection dead: {self._dead}",
                )
            payload = await fut
        r = Reader(payload)
        corr = r.read_int32()
        if corr != hdr.correlation_id:
            raise KafkaClientError(
                int(ErrorCode.network_exception),
                f"correlation mismatch {corr} != {hdr.correlation_id}",
            )
        from .protocol.headers import response_header_version

        if response_header_version(api.key, version) >= 1:
            r.skip_tagged_fields()
        return payload[len(payload) - r.remaining :]

    async def _request_serial(self, head: bytes, body: bytes) -> bytes:
        """serial_reads round trip: write, then read the response
        inline while still holding the connection lock. A caller
        cancelled or failing mid-read leaves a partial frame on the
        stream, so the connection is poisoned (marked dead) rather
        than resynchronized."""
        async with self._lock:
            rx = self._rx_proto
            if rx is not None:
                rx.rx_t0 = -1.0  # arm: next data_received is the reply
            self._writer.writelines(
                (_SIZE.pack(len(head) + len(body)), head, body)
            )
            await self._writer.drain()
            try:
                raw_size = await self._reader.readexactly(4)
                (size,) = _SIZE.unpack(raw_size)
                payload = await self._reader.readexactly(size)
                self.last_rx_monotonic = (
                    rx.rx_t0
                    if rx is not None and rx.rx_t0 >= 0.0
                    else time.monotonic()
                )
                return payload
            except asyncio.CancelledError:
                self._dead = "cancelled mid-read"
                try:
                    self._writer.close()
                except Exception:
                    pass
                raise
            except Exception as e:
                self._dead = str(e) or type(e).__name__
                raise KafkaClientError(
                    int(ErrorCode.network_exception), str(e)
                )

    async def close(self) -> None:
        if self._read_task is not None:
            self._read_task.cancel()
            try:
                await self._read_task
            except (asyncio.CancelledError, Exception):
                pass
        while self._pending:
            _corr, fut = self._pending.popleft()
            fut.cancel()
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:
                pass


class _LeaderRetry:
    """Deadline-based leadership retry: a time budget, not a fixed
    attempt count — on a loaded 1-core host an election can take
    several seconds, so attempt-counted loops flake while a time
    budget holds steady. First pass never sleeps; `refresh` is False
    only on that first pass."""

    __slots__ = ("_deadline", "attempt")

    def __init__(self, budget_s: float):
        self._deadline = asyncio.get_event_loop().time() + budget_s
        self.attempt = 0

    def more(self) -> bool:
        return (
            self.attempt == 0
            or asyncio.get_event_loop().time() < self._deadline
        )

    async def pause(self) -> None:
        if self.attempt:
            await asyncio.sleep(0.1)
        self.attempt += 1

    @property
    def refresh(self) -> bool:
        return self.attempt > 1


class KafkaClient:
    """Metadata-aware client: routes produce/fetch to partition leaders."""

    LEADER_WAIT_S = 8.0  # _LeaderRetry budget for this client's calls

    def __init__(
        self,
        bootstrap: Sequence[tuple[str, int]],
        client_id: str = "redpanda-tpu-client",
        sasl: tuple[str, str, str] | None = None,  # (user, password, mechanism)
        ssl=None,  # ssl.SSLContext (security.tls.client_context)
        # zero-arg factory returning a fresh GssapiClient per broker
        # connection (each AP-REQ must be unique — the broker's replay
        # cache rejects a reused authenticator)
        gssapi_factory=None,
        serial_reads: bool = False,  # see BrokerConnection.serial_reads
    ):
        self._bootstrap = list(bootstrap)
        self._client_id = client_id
        self._sasl = sasl
        self._ssl = ssl
        self._gssapi_factory = gssapi_factory
        self._serial_reads = serial_reads
        self._conns: dict[tuple[str, int], BrokerConnection] = {}
        self._conn_locks = LockMap()
        self._brokers: dict[int, tuple[str, int]] = {}
        self._leaders: dict[tuple[str, int], int] = {}  # (topic,part)→node
        self._topic_errors: dict[str, int] = {}

    def last_rx_monotonic(self) -> float:
        """Arrival stamp (time.monotonic) of this client's most recent
        serial_reads response — the newest stamp across connections.
        Meaningful for sequential callers (one request at a time, as a
        bench producer is); 0.0 before any serial response."""
        return max(
            (c.last_rx_monotonic for c in self._conns.values()),
            default=0.0,
        )

    async def _connect_addr(self, addr: tuple[str, int]) -> BrokerConnection:
        # per-address serialization: concurrent callers racing a
        # reconnect would each open a socket and the loser's
        # connection (+ read task) would leak
        lock = self._conn_locks.lock(addr)
        async with lock:
            conn = self._conns.get(addr)
            if conn is not None and conn._dead is not None:
                # a cached connection whose read loop died (broker
                # restart/crash) must not be handed out: every request
                # on it fails instantly and any_conn's per-seed
                # fallback never fires (the CONNECT succeeded long
                # ago) — wedging the whole client on one dead broker
                await conn.close()
                self._conns.pop(addr, None)
                conn = None
            if conn is None:
                conn = BrokerConnection(
                    addr[0], addr[1], self._client_id, sasl=self._sasl,
                    ssl=self._ssl,
                    gssapi=(
                        self._gssapi_factory()
                        if self._gssapi_factory is not None
                        else None
                    ),
                    serial_reads=self._serial_reads,
                )
                await conn.connect()
                self._conns[addr] = conn
            return conn

    async def any_conn(self) -> BrokerConnection:
        last: Exception | None = None
        for addr in self._bootstrap:
            try:
                return await self._connect_addr(addr)
            except Exception as e:  # broker down: try next seed
                last = e
        raise last if last else RuntimeError("no bootstrap brokers")

    async def close(self) -> None:
        for conn in self._conns.values():
            await conn.close()
        self._conns.clear()
        # connect locks for addresses nobody is dialing are dead weight
        self._conn_locks.prune()

    # -- metadata ----------------------------------------------------
    async def metadata(self, topics: Optional[list[str]] = None) -> Msg:
        conn = await self.any_conn()
        v = conn.pick_version(METADATA, 5)
        req = Msg(
            topics=None if topics is None else [Msg(name=t) for t in topics]
        )
        resp = await conn.request(METADATA, req, v)
        for b in resp.brokers:
            self._brokers[b.node_id] = (b.host, b.port)
        for t in resp.topics:
            self._topic_errors[t.name] = t.error_code
            if t.error_code == 0:
                for p in t.partitions:
                    if p.leader_id >= 0:
                        self._leaders[(t.name, p.partition_index)] = p.leader_id
        return resp

    async def leader_conn(
        self, topic: str, partition: int, refresh: bool = False
    ) -> BrokerConnection:
        """Resolve the partition leader, retrying metadata while the
        leader is unknown (election in flight) like real clients do."""
        key = (topic, partition)
        deadline = asyncio.get_event_loop().time() + 5.0
        while True:
            if refresh or key not in self._leaders:
                await self.metadata([topic])
            leader = self._leaders.get(key)
            if leader is not None and leader in self._brokers:
                try:
                    return await self._connect_addr(self._brokers[leader])
                except (OSError, KafkaClientError):
                    # the cached "leader" is unreachable or dies during
                    # the handshake (connect refused = OSError; socket
                    # reset mid-API_VERSIONS = KafkaClientError): treat
                    # exactly like not_leader — drop the cache entry
                    # and re-resolve, instead of letting the error
                    # escape and strand every caller on attempt-0
                    # stale state
                    self._leaders.pop(key, None)
            terr = self._topic_errors.get(topic, 0)
            if terr in (
                int(ErrorCode.unknown_topic_or_partition),
                int(ErrorCode.topic_authorization_failed),
            ):
                raise KafkaClientError(terr, f"{topic}/{partition}")
            if asyncio.get_event_loop().time() > deadline:
                raise KafkaClientError(
                    int(ErrorCode.leader_not_available), f"{topic}/{partition}"
                )
            refresh = True
            await asyncio.sleep(0.05)

    # -- admin -------------------------------------------------------
    async def create_topic(
        self,
        name: str,
        partitions: int = 1,
        replication_factor: int = 1,
        timeout_ms: int = 10000,
        configs: Optional[dict[str, str]] = None,
    ) -> None:
        conn = await self.any_conn()
        v = conn.pick_version(CREATE_TOPICS, 4)
        req = Msg(
            topics=[
                Msg(
                    name=name,
                    num_partitions=partitions,
                    replication_factor=replication_factor,
                    assignments=[],
                    configs=[
                        Msg(name=k, value=val)
                        for k, val in (configs or {}).items()
                    ],
                )
            ],
            timeout_ms=timeout_ms,
            validate_only=False,
        )
        resp = await conn.request(CREATE_TOPICS, req, v)
        code = resp.topics[0].error_code
        if code != 0:
            raise KafkaClientError(code, f"create_topic {name}")

    def group(self, group_id: str) -> "GroupClient":
        return GroupClient(self, group_id)

    async def delete_topic(self, name: str, timeout_ms: int = 10000) -> None:
        from .protocol.group_apis import DELETE_TOPICS

        conn = await self.any_conn()
        v = conn.pick_version(DELETE_TOPICS, 1)
        req = Msg(topic_names=[name], timeout_ms=timeout_ms)
        resp = await conn.request(DELETE_TOPICS, req, v)
        code = resp.responses[0].error_code
        if code != 0:
            raise KafkaClientError(code, f"delete_topic {name}")

    async def delete_topics(
        self, names: list[str], timeout_ms: int = 10000
    ) -> list[tuple[str, int]]:
        """Per-topic (name, error_code) — does not raise on denial."""
        from .protocol.group_apis import DELETE_TOPICS

        conn = await self.any_conn()
        v = conn.pick_version(DELETE_TOPICS, 1)
        resp = await conn.request(
            DELETE_TOPICS, Msg(topic_names=names, timeout_ms=timeout_ms), v
        )
        return [(r.name, r.error_code) for r in resp.responses]

    async def describe_configs(
        self, topic: str, keys: Optional[list[str]] = None
    ) -> list[tuple[str, Optional[str]]]:
        from .protocol.admin_apis import DESCRIBE_CONFIGS

        conn = await self.any_conn()
        v = conn.pick_version(DESCRIBE_CONFIGS, 1)
        resp = await conn.request(
            DESCRIBE_CONFIGS,
            Msg(
                resources=[
                    Msg(
                        resource_type=2,
                        resource_name=topic,
                        configuration_keys=keys,
                    )
                ],
                include_synonyms=False,
            ),
            v,
        )
        r = resp.results[0]
        if r.error_code != 0:
            raise KafkaClientError(r.error_code, f"describe_configs {topic}")
        return [(c.name, c.value) for c in r.configs]

    async def alter_topic_configs(
        self, topic: str, sets: dict[str, str], removes: Sequence[str] = ()
    ) -> None:
        """Incremental alter: SET the given keys, DELETE `removes`."""
        from .protocol.admin_apis import INCREMENTAL_ALTER_CONFIGS

        conn = await self.any_conn()
        v = conn.pick_version(INCREMENTAL_ALTER_CONFIGS, 0)
        cfgs = [
            Msg(name=k, config_operation=0, value=val)
            for k, val in sets.items()
        ] + [Msg(name=k, config_operation=1, value=None) for k in removes]
        resp = await conn.request(
            INCREMENTAL_ALTER_CONFIGS,
            Msg(
                resources=[
                    Msg(resource_type=2, resource_name=topic, configs=cfgs)
                ],
                validate_only=False,
            ),
            v,
        )
        r = resp.responses[0]
        if r.error_code != 0:
            raise KafkaClientError(r.error_code, f"alter_configs {topic}")

    async def create_partitions(
        self, topic: str, count: int, timeout_ms: int = 10000
    ) -> None:
        from .protocol.admin_apis import CREATE_PARTITIONS

        conn = await self.any_conn()
        v = conn.pick_version(CREATE_PARTITIONS, 1)
        resp = await conn.request(
            CREATE_PARTITIONS,
            Msg(
                topics=[Msg(name=topic, count=count, assignments=None)],
                timeout_ms=timeout_ms,
                validate_only=False,
            ),
            v,
        )
        r = resp.results[0]
        if r.error_code != 0:
            raise KafkaClientError(r.error_code, f"create_partitions {topic}")

    # -- produce -----------------------------------------------------
    async def produce(
        self,
        topic: str,
        partition: int,
        records: Sequence[tuple[bytes | None, bytes | None]],  # (key, value)
        acks: int = -1,
        timeout_ms: int = 10000,
    ) -> int:
        """Returns the base offset assigned to the batch."""
        builder = RecordBatchBuilder()
        for key, value in records:
            builder.add(value, key=key)
        wire = builder.build().to_kafka_wire()
        return await self.produce_wire(
            topic, partition, wire, acks=acks, timeout_ms=timeout_ms
        )

    async def produce_wire(
        self,
        topic: str,
        partition: int,
        wire: bytes,
        acks: int = -1,
        timeout_ms: int = 10000,
    ) -> int:
        """Produce a pre-built kafka-wire record batch. Real producers
        encode once on the client machine; benchmarks measuring broker
        throughput reuse one encoded batch so client-side record
        encoding doesn't pollute the server number."""
        # leadership can be mid-flight (fresh topic, election, replica
        # move): retry with metadata refresh like real clients do
        retry = _LeaderRetry(self.LEADER_WAIT_S)
        while retry.more():
            await retry.pause()
            conn = await self.leader_conn(
                topic, partition, refresh=retry.refresh
            )
            v = conn.pick_version(PRODUCE, 7)
            flex = PRODUCE.flexible(v)
            # hand-rolled single-topic/single-partition codec (byte-
            # parity with the generic walker asserted by
            # tests/test_produce_fast.py)
            body = produce_fast.encode_request_single(
                v, flex, None, acks, timeout_ms, topic, partition, wire
            )
            if body is None:
                body = PRODUCE.encode_request(
                    Msg(
                        transactional_id=None,
                        acks=acks,
                        timeout_ms=timeout_ms,
                        topics=[
                            Msg(
                                name=topic,
                                partitions=[
                                    Msg(index=partition, records=wire)
                                ],
                            )
                        ],
                    ),
                    v,
                )
            if acks == 0:
                # fire-and-forget: no response frame on the wire
                hdr = RequestHeader(
                    PRODUCE.key, v, next(conn._corr), self._client_id
                )
                frame = encode_request_header(hdr) + body
                async with conn._lock:
                    conn._writer.write(_SIZE.pack(len(frame)) + frame)
                    await conn._writer.drain()
                return -1
            rbody = await conn.request_body(PRODUCE, body, v)
            fast = produce_fast.decode_response_single(rbody, v, flex)
            if fast is not None:
                error_code, base_offset = fast
            else:
                resp = PRODUCE.decode_response(rbody, v)
                pr = resp.responses[0].partition_responses[0]
                error_code, base_offset = pr.error_code, pr.base_offset
            if error_code == int(ErrorCode.not_leader_for_partition):
                continue
            if error_code != 0:
                raise KafkaClientError(
                    error_code, f"produce {topic}/{partition}"
                )
            return base_offset
        raise KafkaClientError(
            int(ErrorCode.not_leader_for_partition), f"produce {topic}/{partition}"
        )

    # -- fetch -------------------------------------------------------
    @staticmethod
    def _fetch_request(
        topic: str,
        partition: int,
        offset: int,
        max_bytes: int,
        max_wait_ms: int,
        min_bytes: int,
        read_committed: bool,
        rack: str | None = None,
    ) -> Msg:
        """One sessionless single-partition FETCH request (shared by
        fetch/fetch_raw so the wire shape can't diverge)."""
        return Msg(
            rack_id=rack or "",
            replica_id=-1,
            max_wait_ms=max_wait_ms,
            min_bytes=min_bytes,
            max_bytes=max_bytes,
            isolation_level=1 if read_committed else 0,
            session_id=0,
            session_epoch=-1,
            topics=[
                Msg(
                    topic=topic,
                    partitions=[
                        Msg(
                            partition=partition,
                            current_leader_epoch=-1,
                            fetch_offset=offset,
                            log_start_offset=0,
                            partition_max_bytes=max_bytes,
                        )
                    ],
                )
            ],
            forgotten_topics_data=[],
        )

    async def fetch(
        self,
        topic: str,
        partition: int,
        offset: int,
        max_bytes: int = 1 << 20,
        max_wait_ms: int = 500,
        min_bytes: int = 1,
        read_committed: bool = False,
        rack: str | None = None,
    ) -> list[tuple[int, bytes | None, bytes | None]]:
        """Returns [(offset, key, value)] at-or-after `offset`.
        `rack` opts into KIP-392 follower fetching: the leader may
        redirect to a same-rack replica via preferred_read_replica,
        which this client follows."""
        read_node: int | None = None  # KIP-392 redirect target
        redirects = 0
        retry = _LeaderRetry(self.LEADER_WAIT_S)
        while retry.more():
            if read_node is not None:
                # follow the redirect immediately: it is routing, not a
                # failure — no backoff, no pause consumed
                if read_node not in self._brokers:
                    await self.metadata([topic])
                addr = self._brokers.get(read_node)
                conn = None
                if addr is not None:
                    try:
                        conn = await self._connect_addr(addr)
                    except (OSError, KafkaClientError):
                        conn = None  # dead replica: leader still serves
                if conn is None:
                    read_node = None
                    rack = None  # stop advertising: read from the leader
                    retry.attempt += 1
                    continue
            else:
                await retry.pause()
                conn = await self.leader_conn(
                    topic, partition, refresh=retry.refresh
                )
            v = conn.pick_version(FETCH, 11)
            req = self._fetch_request(
                topic, partition, offset, max_bytes, max_wait_ms,
                min_bytes, read_committed, rack=rack,
            )
            resp = await conn.request(FETCH, req, v)
            pr = resp.responses[0].partitions[0]
            if pr.error_code == int(ErrorCode.not_leader_for_partition):
                read_node = None
                retry.attempt += 1
                continue
            preferred = getattr(pr, "preferred_read_replica", -1)
            if (
                pr.error_code == 0
                and preferred is not None
                and preferred >= 0
                and not pr.records
            ):
                redirects += 1
                if redirects > 2:  # redirect loop guard: use the leader
                    read_node = None
                    rack = None
                    retry.attempt += 1
                    continue
                read_node = preferred
                continue
            if pr.error_code != 0:
                raise KafkaClientError(
                    pr.error_code, f"fetch {topic}/{partition}"
                )
            aborted = None
            if read_committed:
                aborted = [
                    (a.producer_id, a.first_offset)
                    for a in (pr.aborted_transactions or [])
                ]
            return decode_record_set(
                pr.records, from_offset=offset, aborted=aborted
            )
        raise KafkaClientError(
            int(ErrorCode.not_leader_for_partition), f"fetch {topic}/{partition}"
        )

    async def fetch_raw(
        self,
        topic: str,
        partition: int,
        offset: int,
        max_bytes: int = 1 << 20,
        max_wait_ms: int = 0,
        return_lso: bool = False,
    ) -> tuple[bytes, int] | tuple[bytes, int, int]:
        """One fetch round returning (raw records wire, next_offset[,
        last_stable_offset]) without per-record decode —
        broker-throughput measurement, mirroring consumers that hand
        wire bytes onward, and position probes over windows whose
        committed view is empty (all aborted/control batches)."""
        pr = None
        retry = _LeaderRetry(self.LEADER_WAIT_S)
        while retry.more():
            await retry.pause()
            conn = await self.leader_conn(
                topic, partition, refresh=retry.refresh
            )
            v = conn.pick_version(FETCH, 11)
            req = self._fetch_request(
                topic, partition, offset, max_bytes, max_wait_ms, 0, False
            )
            resp = await conn.request(FETCH, req, v)
            pr = resp.responses[0].partitions[0]
            if pr.error_code == int(ErrorCode.not_leader_for_partition):
                continue
            break
        if pr is None or pr.error_code != 0:
            raise KafkaClientError(
                pr.error_code if pr is not None else -1,
                f"fetch {topic}/{partition}",
            )
        wire = bytes(pr.records or b"")
        # next position: walk only the fixed batch headers (cheap)
        next_off = offset
        pos = 0
        while pos + 12 <= len(wire):
            base = int.from_bytes(wire[pos : pos + 8], "big", signed=True)
            blen = int.from_bytes(wire[pos + 8 : pos + 12], "big", signed=True)
            if pos + 12 + blen > len(wire) or blen <= 0:
                break
            # kafka batch layout: base(8) len(4) epoch(4) magic(1)
            # crc(4) attrs(2) last_offset_delta(4) → delta at +23
            lod = int.from_bytes(wire[pos + 23 : pos + 27], "big", signed=True)
            next_off = max(next_off, base + lod + 1)
            pos += 12 + blen
        if return_lso:
            return wire, next_off, getattr(pr, "last_stable_offset", -1)
        return wire, next_off

    async def list_offset(
        self, topic: str, partition: int, timestamp: int
    ) -> int:
        """timestamp: -2 earliest, -1 latest, else timequery."""
        conn = await self.leader_conn(topic, partition)
        v = conn.pick_version(LIST_OFFSETS, 3)
        req = Msg(
            replica_id=-1,
            isolation_level=0,
            topics=[
                Msg(
                    name=topic,
                    partitions=[
                        Msg(
                            partition_index=partition,
                            current_leader_epoch=-1,
                            timestamp=timestamp,
                        )
                    ],
                )
            ],
        )
        resp = await conn.request(LIST_OFFSETS, req, v)
        pr = resp.topics[0].partitions[0]
        if pr.error_code != 0:
            raise KafkaClientError(
                pr.error_code, f"list_offsets {topic}/{partition}"
            )
        return pr.offset


class GroupClient:
    """Consumer-group protocol driver bound to one group id
    (reference: kafka/client/consumer.{h,cc} group membership flow)."""

    def __init__(self, client: "KafkaClient", group_id: str):
        self.client = client
        self.group_id = group_id
        self.member_id = ""
        self.generation = -1
        self._coord: Optional[BrokerConnection] = None

    async def coordinator(self, refresh: bool = False) -> BrokerConnection:
        from .protocol.group_apis import FIND_COORDINATOR

        if self._coord is not None and not refresh:
            if self._coord._dead is None:
                return self._coord
            # cached coordinator connection died (broker restart):
            # re-resolve instead of failing every request forever —
            # the object cache bypasses _connect_addr's eviction
            self._coord = None
        deadline = asyncio.get_event_loop().time() + 5.0
        while True:
            conn = await self.client.any_conn()
            v = conn.pick_version(FIND_COORDINATOR, 1)
            req = Msg(key=self.group_id, key_type=0)
            resp = await conn.request(FIND_COORDINATOR, req, v)
            if resp.error_code == 0 and resp.node_id >= 0:
                self._coord = await self.client._connect_addr(
                    (resp.host, resp.port)
                )
                return self._coord
            if asyncio.get_event_loop().time() > deadline:
                raise KafkaClientError(
                    resp.error_code or int(ErrorCode.coordinator_not_available),
                    f"find_coordinator {self.group_id}",
                )
            await asyncio.sleep(0.05)

    @staticmethod
    def _coord_error(resp: Msg) -> int:
        """Coordinator-level error of a response: the top-level
        error_code, or — for APIs like OffsetCommit that only carry
        per-partition codes — a NOT_COORDINATOR /
        COORDINATOR_LOAD_IN_PROGRESS found inside topics[].partitions[]
        (the server fans one coordinator error out to every row)."""
        code = getattr(resp, "error_code", 0)
        if code:
            return int(code)
        for t in getattr(resp, "topics", None) or []:
            for p in getattr(t, "partitions", None) or []:
                pc = int(getattr(p, "error_code", 0) or 0)
                if pc in (
                    int(ErrorCode.not_coordinator),
                    int(ErrorCode.coordinator_load_in_progress),
                ):
                    return pc
        return 0

    async def _coord_request(self, api, req, version: int) -> Msg:
        """Send to the coordinator, re-resolving on NOT_COORDINATOR and
        retrying in place on COORDINATOR_LOAD_IN_PROGRESS (the new
        leader's replay barrier is settling — same node, just wait)."""
        refresh = False
        deadline = asyncio.get_event_loop().time() + 10.0
        while True:
            conn = await self.coordinator(refresh=refresh)
            refresh = False
            resp = await conn.request(api, req, version)
            code = self._coord_error(resp)
            if code == int(ErrorCode.not_coordinator):
                refresh = True
            elif code != int(ErrorCode.coordinator_load_in_progress):
                return resp
            if asyncio.get_event_loop().time() > deadline:
                return resp
            await asyncio.sleep(0.05)

    async def join(
        self,
        protocols: list[tuple[str, bytes]],
        protocol_type: str = "consumer",
        session_timeout_ms: int = 10000,
        rebalance_timeout_ms: int = 30000,
        group_instance_id: str | None = None,
    ) -> Msg:
        from .protocol.group_apis import JOIN_GROUP

        conn = await self.coordinator()
        # always prefer v5: the leader's member list carries
        # group_instance_id only from v5 up. A static join MUST NOT
        # silently downgrade below it (the instance id would be
        # dropped on the wire and the member become dynamic).
        v = conn.pick_version(JOIN_GROUP, 5)
        if group_instance_id is not None and v < 5:
            raise KafkaClientError(
                int(ErrorCode.unsupported_version),
                "broker too old for static membership (JoinGroup v5)",
            )
        req = Msg(
            group_id=self.group_id,
            session_timeout_ms=session_timeout_ms,
            rebalance_timeout_ms=rebalance_timeout_ms,
            member_id=self.member_id,
            group_instance_id=group_instance_id,
            protocol_type=protocol_type,
            protocols=[Msg(name=n, metadata=md) for n, md in protocols],
        )
        resp = await self._coord_request(JOIN_GROUP, req, v)
        if resp.error_code != 0:
            raise KafkaClientError(resp.error_code, f"join {self.group_id}")
        # the member-id handoff IS the protocol: send the old id, store
        # the coordinator's reply; join/sync are serialized by the
        # consumer state machine, never raced on one GroupClient
        self.member_id = resp.member_id  # rplint: disable=RPL015
        self.generation = resp.generation_id
        return resp

    async def sync(self, assignments: list[tuple[str, bytes]]) -> bytes:
        from .protocol.group_apis import SYNC_GROUP

        conn = await self.coordinator()
        v = conn.pick_version(SYNC_GROUP, 1)
        req = Msg(
            group_id=self.group_id,
            generation_id=self.generation,
            member_id=self.member_id,
            assignments=[
                Msg(member_id=m, assignment=a) for m, a in assignments
            ],
        )
        resp = await self._coord_request(SYNC_GROUP, req, v)
        if resp.error_code != 0:
            raise KafkaClientError(resp.error_code, f"sync {self.group_id}")
        return bytes(resp.assignment)

    async def heartbeat(self) -> int:
        from .protocol.group_apis import HEARTBEAT

        conn = await self.coordinator()
        v = conn.pick_version(HEARTBEAT, 1)
        req = Msg(
            group_id=self.group_id,
            generation_id=self.generation,
            member_id=self.member_id,
        )
        resp = await self._coord_request(HEARTBEAT, req, v)
        return resp.error_code

    async def leave(self) -> None:
        from .protocol.group_apis import LEAVE_GROUP

        conn = await self.coordinator()
        v = conn.pick_version(LEAVE_GROUP, 1)
        req = Msg(group_id=self.group_id, member_id=self.member_id)
        await self._coord_request(LEAVE_GROUP, req, v)
        self.member_id = ""
        self.generation = -1

    async def remove_members(
        self, members: list[tuple[str | None, str | None]]
    ) -> list[Msg]:
        """LeaveGroup v4 batched removal: (member_id, group_instance_id)
        pairs — instance id alone removes a static member that is not
        running (KIP-345 admin removal). Returns per-member rows."""
        from .protocol.group_apis import LEAVE_GROUP

        conn = await self.coordinator()
        v = conn.pick_version(LEAVE_GROUP, 4)
        if v < 3:
            # below v3 there is no members array at all — downgrading
            # would send a semantically different single-member leave
            raise KafkaClientError(
                int(ErrorCode.unsupported_version),
                "broker too old for batched LeaveGroup (v3)",
            )
        req = Msg(
            group_id=self.group_id,
            members=[
                Msg(member_id=mid or "", group_instance_id=iid)
                for mid, iid in members
            ],
        )
        resp = await self._coord_request(LEAVE_GROUP, req, v)
        if resp.error_code != 0:
            raise KafkaClientError(resp.error_code, "leave_group v4")
        return list(resp.members)

    async def commit_offsets(
        self, offsets: dict[tuple[str, int], int], metadata: str | None = None
    ) -> None:
        from .protocol.group_apis import OFFSET_COMMIT

        conn = await self.coordinator()
        v = conn.pick_version(OFFSET_COMMIT, 3)
        by_topic: dict[str, list[Msg]] = {}
        for (topic, part), off in offsets.items():
            by_topic.setdefault(topic, []).append(
                Msg(
                    partition_index=part,
                    committed_offset=off,
                    committed_metadata=metadata,
                )
            )
        req = Msg(
            group_id=self.group_id,
            generation_id=self.generation,
            member_id=self.member_id,
            retention_time_ms=-1,
            topics=[Msg(name=t, partitions=ps) for t, ps in by_topic.items()],
        )
        resp = await self._coord_request(OFFSET_COMMIT, req, v)
        for t in resp.topics:
            for p in t.partitions:
                if p.error_code != 0:
                    raise KafkaClientError(
                        p.error_code, f"offset_commit {t.name}/{p.partition_index}"
                    )

    async def fetch_offsets(
        self, topics: dict[str, list[int]] | None = None
    ) -> dict[tuple[str, int], int]:
        from .protocol.group_apis import OFFSET_FETCH

        conn = await self.coordinator()
        v = conn.pick_version(OFFSET_FETCH, 3)
        req = Msg(
            group_id=self.group_id,
            topics=(
                None
                if topics is None
                else [
                    Msg(name=t, partition_indexes=ps)
                    for t, ps in topics.items()
                ]
            ),
        )
        resp = await self._coord_request(OFFSET_FETCH, req, v)
        if getattr(resp, "error_code", 0) != 0:
            raise KafkaClientError(resp.error_code, f"offset_fetch {self.group_id}")
        out = {}
        for t in resp.topics:
            for p in t.partitions:
                if p.committed_offset >= 0:
                    out[(t.name, p.partition_index)] = p.committed_offset
        return out


def decode_record_set(
    records: bytes | memoryview | None,
    from_offset: int = 0,
    aborted: list[tuple[int, int]] | None = None,
) -> list[tuple[int, bytes | None, bytes | None]]:
    """Kafka wire record set → [(abs_offset, key, value)].

    Control batches (tx markers) never surface as records. With
    `aborted` (the fetch response's AbortedTransaction rows as
    (producer_id, first_offset)), aborted transactional batches are
    dropped the way a READ_COMMITTED consumer does: a pid enters the
    aborted set when the scan reaches its range's first offset and
    leaves it at its abort control marker."""
    from ..cluster.tx_state import ABORT_MARKER, parse_control_key
    from ..utils.iobuf import IOBufParser

    if records is None or len(records) == 0:
        return []
    pending = sorted(aborted or [], key=lambda a: a[1])  # by first_offset
    live_aborts: set[int] = set()
    out: list[tuple[int, bytes | None, bytes | None]] = []
    parser = IOBufParser(bytes(records))
    while parser.bytes_left() > 0:
        batch = RecordBatch.from_kafka_wire(parser, verify=True)
        h = batch.header
        base = h.base_offset
        while pending and pending[0][1] <= base:
            live_aborts.add(pending.pop(0)[0])
        if h.is_control:
            if h.producer_id in live_aborts:
                try:
                    kind = parse_control_key(batch.records()[0].key)
                except Exception:
                    kind = None
                if kind == ABORT_MARKER:
                    live_aborts.discard(h.producer_id)
            continue
        if h.is_transactional and h.producer_id in live_aborts:
            continue
        for rec in batch.records():
            off = base + rec.offset_delta
            if off >= from_offset:
                out.append((off, rec.key, rec.value))
    return out


class TransactionalProducer:
    """Exactly-once producer driver (reference: the transactional flow
    of kafka/client/producer + tx_gateway_frontend semantics): init →
    begin → produce/send_offsets → commit/abort, with per-partition
    sequence tracking and automatic AddPartitionsToTxn."""

    def __init__(
        self, client: "KafkaClient", tx_id: str, timeout_ms: int = 60000
    ):
        self.client = client
        self.tx_id = tx_id
        self.timeout_ms = timeout_ms
        self.pid = -1
        self.epoch = -1
        self._seqs: dict[tuple[str, int], int] = {}
        self._in_tx: set[tuple[str, int]] = set()
        self._coord: Optional[BrokerConnection] = None

    async def _coordinator(self, refresh: bool = False) -> BrokerConnection:
        from .protocol.group_apis import FIND_COORDINATOR

        if self._coord is not None and not refresh:
            if self._coord._dead is None:
                return self._coord
            # cached coordinator connection died (broker restart):
            # re-resolve instead of failing every request forever —
            # the object cache bypasses _connect_addr's eviction
            self._coord = None
        deadline = asyncio.get_event_loop().time() + 5.0
        while True:
            conn = await self.client.any_conn()
            v = conn.pick_version(FIND_COORDINATOR, 1)
            resp = await conn.request(
                FIND_COORDINATOR, Msg(key=self.tx_id, key_type=1), v
            )
            if resp.error_code == 0 and resp.node_id >= 0:
                self._coord = await self.client._connect_addr(
                    (resp.host, resp.port)
                )
                return self._coord
            if asyncio.get_event_loop().time() > deadline:
                raise KafkaClientError(
                    resp.error_code or int(ErrorCode.coordinator_not_available),
                    f"find_tx_coordinator {self.tx_id}",
                )
            await asyncio.sleep(0.05)

    async def _coord_request(self, api, req, version: int) -> Msg:
        refresh = False
        deadline = asyncio.get_event_loop().time() + 10.0
        while True:
            conn = await self._coordinator(refresh=refresh)
            refresh = False
            resp = await conn.request(api, req, version)
            code = int(getattr(resp, "error_code", 0) or 0)
            if code == int(ErrorCode.not_coordinator):
                refresh = True
            elif code != int(ErrorCode.concurrent_transactions):
                return resp
            if asyncio.get_event_loop().time() > deadline:
                return resp
            await asyncio.sleep(0.05)

    async def init(self) -> None:
        from .protocol.group_apis import INIT_PRODUCER_ID

        conn = await self._coordinator()
        v = conn.pick_version(INIT_PRODUCER_ID, 1)
        resp = await self._coord_request(
            INIT_PRODUCER_ID,
            Msg(
                transactional_id=self.tx_id,
                transaction_timeout_ms=self.timeout_ms,
            ),
            v,
        )
        if resp.error_code != 0:
            raise KafkaClientError(resp.error_code, f"init_tx {self.tx_id}")
        self.pid = resp.producer_id
        self.epoch = resp.producer_epoch
        self._seqs.clear()
        self._in_tx.clear()

    def begin(self) -> None:
        self._in_tx.clear()

    async def _add_partitions(self, tps: list[tuple[str, int]]) -> None:
        from .protocol.tx_apis import ADD_PARTITIONS_TO_TXN

        by_topic: dict[str, list[int]] = {}
        for t, p in tps:
            by_topic.setdefault(t, []).append(p)
        conn = await self._coordinator()
        v = conn.pick_version(ADD_PARTITIONS_TO_TXN, 1)
        resp = await self._coord_request(
            ADD_PARTITIONS_TO_TXN,
            Msg(
                transactional_id=self.tx_id,
                producer_id=self.pid,
                producer_epoch=self.epoch,
                topics=[
                    Msg(name=t, partitions=ps) for t, ps in by_topic.items()
                ],
            ),
            v,
        )
        for t in resp.results:
            for r in t.results:
                if r.error_code != 0:
                    raise KafkaClientError(
                        r.error_code,
                        f"add_partitions_to_txn {t.name}/{r.partition_index}",
                    )

    async def produce(
        self,
        topic: str,
        partition: int,
        records: Sequence[tuple[bytes | None, bytes | None]],
    ) -> int:
        if self.pid < 0:
            raise RuntimeError("init() first")
        tp = (topic, partition)
        if tp not in self._in_tx:
            await self._add_partitions([tp])
            self._in_tx.add(tp)
        seq = self._seqs.get(tp, 0)
        builder = RecordBatchBuilder(
            producer_id=self.pid,
            producer_epoch=self.epoch,
            base_sequence=seq,
            transactional=True,
        )
        for key, value in records:
            builder.add(value, key=key)
        wire = builder.build().to_kafka_wire()
        retry = _LeaderRetry(self.client.LEADER_WAIT_S)
        while retry.more():
            await retry.pause()
            conn = await self.client.leader_conn(
                topic, partition, refresh=retry.refresh
            )
            v = conn.pick_version(PRODUCE, 7)
            req = Msg(
                transactional_id=self.tx_id,
                acks=-1,
                timeout_ms=10000,
                topics=[
                    Msg(
                        name=topic,
                        partitions=[Msg(index=partition, records=wire)],
                    )
                ],
            )
            resp = await conn.request(PRODUCE, req, v)
            pr = resp.responses[0].partition_responses[0]
            if pr.error_code == int(ErrorCode.not_leader_for_partition):
                continue
            if pr.error_code != 0:
                raise KafkaClientError(
                    pr.error_code, f"tx produce {topic}/{partition}"
                )
            self._seqs[tp] = seq + len(records)
            return pr.base_offset
        raise KafkaClientError(
            int(ErrorCode.not_leader_for_partition),
            f"tx produce {topic}/{partition}",
        )

    async def send_offsets(
        self, group_id: str, offsets: dict[tuple[str, int], int]
    ) -> None:
        """Commit consumer offsets within the transaction
        (AddOffsetsToTxn + TxnOffsetCommit to the group coordinator)."""
        from .protocol.tx_apis import ADD_OFFSETS_TO_TXN, TXN_OFFSET_COMMIT

        conn = await self._coordinator()
        v = conn.pick_version(ADD_OFFSETS_TO_TXN, 1)
        resp = await self._coord_request(
            ADD_OFFSETS_TO_TXN,
            Msg(
                transactional_id=self.tx_id,
                producer_id=self.pid,
                producer_epoch=self.epoch,
                group_id=group_id,
            ),
            v,
        )
        if resp.error_code != 0:
            raise KafkaClientError(resp.error_code, "add_offsets_to_txn")
        # stage the offsets at the GROUP coordinator
        gc = GroupClient(self.client, group_id)
        gconn = await gc.coordinator()
        v = gconn.pick_version(TXN_OFFSET_COMMIT, 2)
        by_topic: dict[str, list[Msg]] = {}
        for (topic, part), off in offsets.items():
            by_topic.setdefault(topic, []).append(
                Msg(
                    partition_index=part,
                    committed_offset=off,
                    committed_metadata=None,
                )
            )
        req = Msg(
            transactional_id=self.tx_id,
            group_id=group_id,
            producer_id=self.pid,
            producer_epoch=self.epoch,
            topics=[Msg(name=t, partitions=ps) for t, ps in by_topic.items()],
        )
        deadline = asyncio.get_event_loop().time() + 10.0
        while True:
            resp = await gconn.request(TXN_OFFSET_COMMIT, req, v)
            codes = {
                p.error_code for t in resp.topics for p in t.partitions
            }
            if codes <= {0}:
                return
            retriable = {
                int(ErrorCode.not_coordinator),
                int(ErrorCode.coordinator_load_in_progress),
            }
            bad = codes - retriable - {0}
            if bad:
                raise KafkaClientError(bad.pop(), "txn_offset_commit")
            if asyncio.get_event_loop().time() > deadline:
                raise KafkaClientError(
                    int(ErrorCode.request_timed_out), "txn_offset_commit"
                )
            gconn = await gc.coordinator(refresh=True)
            await asyncio.sleep(0.05)

    async def _end(self, commit: bool) -> None:
        from .protocol.tx_apis import END_TXN

        conn = await self._coordinator()
        v = conn.pick_version(END_TXN, 1)
        resp = await self._coord_request(
            END_TXN,
            Msg(
                transactional_id=self.tx_id,
                producer_id=self.pid,
                producer_epoch=self.epoch,
                committed=commit,
            ),
            v,
        )
        if resp.error_code != 0:
            raise KafkaClientError(
                resp.error_code, f"end_txn commit={commit}"
            )
        self._in_tx.clear()

    async def commit(self) -> None:
        await self._end(True)

    async def abort(self) -> None:
        await self._end(False)
