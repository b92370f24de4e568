"""Kafka TCP server + request handlers.

Reference: src/v/kafka/server/server.{h,cc} (net::server subclass),
connection_context.cc:55 (process_one_request), requests.cc:285
(handler dispatch) and handlers/{api_versions,metadata,create_topics,
produce,fetch,list_offsets}.cc.

Requests on one connection are ANSWERED strictly in order (the writer
fiber emits responses in request order), but the reader decodes ahead:
framing runs through kafka/framing.py (native rp_frame_scan splits a
whole read buffer into frames in one C call; pure-Python twin behind
RP_NATIVE_FRAME=0), and produce pipelining lets stage-1 dispatch of
request N+1 overlap request N's ack wait, bounded by the
kafka_max_inflight_per_connection window so a firehose client cannot
queue unbounded unwritten responses.

Produce CRC verification rides the model's batched CRC path
(kafka_batch_adapter.cc:99 analog): every batch in the request is
CRC-checked before replication.
"""

from __future__ import annotations

import asyncio
import contextvars
import dataclasses
import logging
import os
import struct
import time
from typing import TYPE_CHECKING

from ..cluster.producer_state import (
    DuplicateSequence,
    OutOfOrderSequence,
    ProducerFenced,
)
from ..models.fundamental import NTP, DEFAULT_NS, TopicNamespace, kafka_ntp
from ..compression import CompressionType
from ..models.record import (
    CrcMismatch,
    RecordBatch,
    pack_wire_base,
    wire_crc_payloads,
)
from ..observability import trace
from ..raft.consensus import NotLeaderError, ReplicateTimeout
from ..security.acl import AclOperation, AclResourceType
from ..ssx import InvokeError
from ..utils.iobuf import IOBufParser
from ..utils.tasks import cancel_and_wait
from .framing import FrameError, FrameScanner
from .protocol import (
    ALL_APIS,
    API_BY_KEY,
    API_VERSIONS,
    CREATE_TOPICS,
    FETCH,
    LIST_OFFSETS,
    METADATA,
    PRODUCE,
    ErrorCode,
    Msg,
    Reader,
    decode_request_header,
    encode_response_header,
)
from .protocol import produce_fast
from .protocol.headers import RequestHeader

if TYPE_CHECKING:  # pragma: no cover
    from ..app import Broker

logger = logging.getLogger("kafka.server")

_SIZE = struct.Struct(">i")

# socket read granularity for the framing loop: large enough that an
# MB-sized produce frame arrives in a handful of wakeups, small enough
# not to balloon per-connection buffers at 10k+ connections
_RECV_CHUNK = 1 << 18

# TopicError.code strings → kafka error codes (names match ErrorCode)
def _topic_error_code(code: str) -> int:
    try:
        return int(ErrorCode[code])
    except KeyError:
        return int(ErrorCode.unknown_server_error)


def _default_rf(n_brokers: int) -> int:
    """Broker-chosen replication factor: min(3, brokers), forced odd."""
    rf = min(3, n_brokers)
    return max(rf - 1 if rf % 2 == 0 else rf, 1)


class _CloseConnection(Exception):
    """Raised by the request pipeline to drop the connection — the
    reference closes on unparseable/unanswerable requests."""


class _RxStampProtocol(asyncio.StreamReaderProtocol):
    """StreamReaderProtocol that stamps when a request's first bytes
    reach the broker. data_received runs in the same loop iteration
    the selector reports the socket readable — BEFORE the connection
    task's readexactly wakes — so the stamp includes the reader-task
    wakeup delay on a backlogged loop: request queueing the client's
    clock counts but a _process-entry stamp misses."""

    def __init__(self, stream_reader, client_connected_cb, loop):
        super().__init__(stream_reader, client_connected_cb, loop=loop)
        self.rx_t0 = -1.0  # re-armed by the reader after each frame

    def data_received(self, data: bytes) -> None:
        if self.rx_t0 < 0.0:
            self.rx_t0 = time.monotonic()
        super().data_received(data)


class _TrackedResponse:
    """Response plus a callback fired once the frame is on the wire.

    The produce/fetch `done` stage closes at write time, not at
    handler-return time: on a saturated loop the hop through the
    pending queue, the write task's wakeup, and head-of-line blocking
    behind earlier responses on the shared connection are all real
    milliseconds the client's clock sees — without this the probe's
    p99 under-reports the e2e p99 by ~2x the scheduling latency."""

    __slots__ = ("resp", "on_written")

    def __init__(self, resp, on_written):
        self.resp = resp  # bytes | None | coroutine
        self.on_written = on_written


def _consume_exc(fut: "asyncio.Future") -> None:
    """Mark a future's eventual exception as retrieved (abandoned
    stage after an earlier batch failed)."""

    def cb(f: "asyncio.Future") -> None:
        if not f.cancelled():
            f.exception()

    fut.add_done_callback(cb)


class ConnectionContext:
    """Per-connection state: SASL exchange + authenticated principal
    (reference: kafka/server/connection_context.h sasl state)."""

    __slots__ = (
        "principal",
        "mechanism",
        "scram",
        "authenticated",
        "session_expires_mono",
        "internal",
        "fetch_session_ids",
        "client_ids",
    )

    def __init__(self) -> None:
        self.principal: str | None = None
        self.mechanism: str | None = None
        self.scram = None
        self.authenticated = False
        # per-connection protocol state released at teardown: fetch
        # sessions created/adopted here and client_ids whose quota
        # buckets this connection holds a reference on — an aborted
        # connection under a churn storm must not leak either
        self.fetch_session_ids: set[int] = set()
        self.client_ids: set[str] = set()
        # monotonic deadline after which the SASL session is no longer
        # valid (OAUTHBEARER: derived from the token's exp at auth
        # time; None = unbounded). Monotonic, not wall: the expiry
        # check runs on every request, and a wall-clock step must not
        # kill — or immortalize — live sessions (rplint RPL014)
        self.session_expires_mono: float | None = None
        # True ONLY when the peer presented the broker's own certificate
        # (exact DER match) under mTLS. A flag, not a principal name, so
        # no SASL username or DN-mapping output can ever collide with it.
        self.internal = False


# the principal of the request currently being handled (set around the
# handler call so deep call-sites can authorize without threading ctx)
CURRENT_PRINCIPAL: "contextvars.ContextVar[str | None]" = contextvars.ContextVar(
    "kafka_principal", default=None
)
# mirrors ConnectionContext.internal for the current request: set only
# for cert-pinned in-broker connections, short-circuits authorization
CURRENT_INTERNAL: "contextvars.ContextVar[bool]" = contextvars.ContextVar(
    "kafka_internal", default=False
)
# the owning connection's context, set for the connection task's whole
# lifetime: deep call-sites (fetch-session create/adopt) record
# per-connection protocol state for teardown release without threading
# ctx through every handler signature
CURRENT_CONN: "contextvars.ContextVar[ConnectionContext | None]" = (
    contextvars.ContextVar("kafka_conn", default=None)
)


class KafkaServer:
    # display name for cert-pinned in-broker connections; authorization
    # ignores it (the ConnectionContext.internal flag is what grants
    # access), so a SASL user or mapped DN of the same name gains nothing
    INTERNAL_PRINCIPAL = "User:__redpanda_tpu_internal__"

    def __init__(self, broker: "Broker"):
        self.broker = broker
        self._server: asyncio.AbstractServer | None = None
        self.port: int = 0
        self._conns: set[asyncio.Task] = set()
        self._handlers = {
            API_VERSIONS.key: self.handle_api_versions,
            METADATA.key: self.handle_metadata,
            CREATE_TOPICS.key: self.handle_create_topics,
            PRODUCE.key: self.handle_produce,
            FETCH.key: self.handle_fetch,
            LIST_OFFSETS.key: self.handle_list_offsets,
        }
        from . import server_admin, server_groups, server_tx

        server_groups.install(self)
        server_tx.install(self)
        server_admin.install(self)
        # resolved once: the request hot path only pays .inc/.observe
        self._req_counter = broker.metrics.counter(
            "kafka_requests_total", "Kafka requests by api"
        )
        self._latency_hist = broker.metrics.histogram(
            "kafka_handler_seconds", "Kafka handler latency"
        )
        # cumulative produce payload bytes: the flight-data history
        # ring turns this into exact windowed ingest rates
        # (/v1/metrics/history?family=kafka_produce_bytes_total), and
        # bench.py cross-checks that rate against its own throughput
        self._produce_bytes = broker.metrics.counter(
            "kafka_produce_bytes_total",
            "record-batch bytes accepted by produce",
        )
        # per-stage produce/fetch probe (latency_probe.h analog): all
        # label children resolved here, hot path pays bound observes
        from .probe import KafkaProbe

        self.probe = KafkaProbe(
            broker.metrics, ledger=getattr(broker, "load_ledger", None)
        )
        # hdr_hist quantiles (latency_probe.h): bounded-relative-error
        # percentiles the log2 Prometheus buckets cannot resolve
        from ..utils.hdr_hist import HdrHist

        self._latency_hdr = HdrHist()  # microseconds, 1us..60s
        for q in (50, 99, 99.9):
            broker.metrics.gauge(
                f"kafka_request_latency_p{str(q).replace('.', '_')}_us",
                lambda q=q: self._latency_hdr.value_at_percentile(q),
                f"Kafka handler latency p{q} (us, hdr_hist)",
            )
        self._mtls_mapper = None
        self._own_cert_der = None
        from .fetch_session import FetchSessionCache
        from .quotas import QuotaManager

        # quota degradation couples to the load ledger's hot-NTP list:
        # under node-wide pressure, tenants hammering the hottest
        # partitions (and tenants above their fair rate share) throttle
        # first — heavy tenants degrade before the fleet does
        self.quotas = QuotaManager(
            broker.controller.cluster_config,
            ledger=getattr(broker, "load_ledger", None),
        )
        self.fetch_sessions = FetchSessionCache()
        # front-end concurrency plane: connection-count + pipelining
        # window visibility (the traffic bench and churn smoke assert
        # these return to baseline after a storm)
        broker.metrics.gauge(
            "kafka_connections_open",
            lambda: len(self._conns),
            "Open Kafka connections",
        )
        self._conn_total = broker.metrics.counter(
            "kafka_connections_total", "Kafka connections accepted"
        )
        self._inflight = 0
        broker.metrics.gauge(
            "kafka_inflight_responses",
            lambda: self._inflight,
            "Responses decoded but not yet written, all connections",
        )
        self._inflight_stalls = broker.metrics.counter(
            "kafka_inflight_stalls_total",
            "Reader stalls on a full per-connection inflight window",
        )
        broker.metrics.gauge(
            "kafka_fetch_sessions_open",
            lambda: len(self.fetch_sessions),
            "Live incremental fetch sessions",
        )
        broker.metrics.gauge(
            "kafka_fetch_sessions_mem_bytes",
            lambda: self.fetch_sessions.mem_bytes(),
            "Accounted fetch-session memory (cost model bytes)",
        )

    # -- authorization -------------------------------------------------
    @property
    def authorization_enabled(self) -> bool:
        cfg = self.broker.config
        if cfg.enable_authorization is not None:
            return cfg.enable_authorization
        return cfg.enable_sasl

    def authorize(self, operation, resource_type, name: str) -> bool:
        """ACL check for the current request's principal; always true
        when authorization is off (authorizer.h authorized())."""
        if not self.authorization_enabled:
            return True
        if CURRENT_INTERNAL.get():
            # cert-pinned in-broker connection (exact DER match against
            # our own certificate): implicitly super
            return True
        principal = CURRENT_PRINCIPAL.get() or "User:anonymous"
        return self.broker.controller.authorizer.authorized(
            resource_type, name, operation, principal
        )

    async def start(self) -> None:
        cfg = self.broker.config
        ssl_ctx = None
        self._mtls_mapper = None
        if cfg.kafka_tls_cert is not None:
            from ..security.tls import PrincipalMapper, server_context

            ssl_ctx = server_context(
                cfg.kafka_tls_cert,
                cfg.kafka_tls_key,
                ca=cfg.kafka_tls_ca,
                require_client_auth=cfg.kafka_tls_require_client_auth,
            )
            if cfg.kafka_tls_require_client_auth:
                self._mtls_mapper = PrincipalMapper(
                    cfg.mtls_principal_rules
                )
                # in-broker clients (transforms, proxy, schema registry)
                # authenticate with the broker's OWN certificate. The
                # internal identity is pinned to the exact certificate
                # (full DER compare), NOT the mapped DN — a CA-issued
                # cert that merely shares the subject DN maps to its DN
                # principal like any client and gains nothing. Computed
                # BEFORE the listener opens so the first accepted
                # connection classifies correctly.
                from cryptography import x509
                from cryptography.hazmat.primitives.serialization import (
                    Encoding,
                )

                with open(cfg.kafka_tls_cert, "rb") as f:
                    own = x509.load_pem_x509_certificate(f.read())
                self._own_cert_der = own.public_bytes(Encoding.DER)
        loop = asyncio.get_event_loop()

        def _proto_factory() -> _RxStampProtocol:
            # default 64 KiB stream high-water drowns MB-sized produce
            # frames in pause/resume churn (~15% of a produce round)
            reader = asyncio.StreamReader(limit=1 << 21, loop=loop)
            return _RxStampProtocol(reader, self._on_conn, loop)

        # create_server instead of start_server: the protocol factory
        # is how the rx stamp gets under the stream reader
        if getattr(cfg, "kafka_reuse_port", False):
            # shard-per-core mode: every shard's frontend binds the same
            # pre-reserved port and the kernel spreads accepted conns
            from ..ssx import bind_reuse_port

            sock = bind_reuse_port(cfg.kafka_host, cfg.kafka_port)
            self._server = await loop.create_server(
                _proto_factory, sock=sock, ssl=ssl_ctx
            )
        else:
            self._server = await loop.create_server(
                _proto_factory, cfg.kafka_host, cfg.kafka_port, ssl=ssl_ctx
            )
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        # cancel live connection handlers BEFORE wait_closed(): since
        # py3.12 wait_closed() waits for handlers, which otherwise sit
        # in the read loop for as long as a client keeps the socket open
        for t in list(self._conns):
            t.cancel()
        for t in list(self._conns):
            try:
                await cancel_and_wait(t)
            except (ConnectionError, OSError):
                pass  # peer-shaped teardown noise; real bugs propagate
        if self._server is not None:
            await self._server.wait_closed()

    # -- connection loop ---------------------------------------------
    async def _on_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """Pipelined request loop (connection_context.cc:55 +
        produce.cc:383 two-stage dispatch): a handler may return its
        response bytes immediately OR a coroutine producing them later
        (produce awaiting quorum). The reader drains COMPLETE frames
        from the scanner seam (kafka/framing.py: native rp_frame_scan
        splits everything buffered in one call) and keeps decoding
        ahead while slow responses settle, bounded by the
        per-connection inflight window; a writer fiber emits responses
        strictly in request order."""
        task = asyncio.current_task()
        self._conns.add(task)
        self._conn_total.inc()
        ctx = ConnectionContext()
        CURRENT_CONN.set(ctx)
        if self._mtls_mapper is not None:
            # mTLS: the verified client certificate IS the identity
            # (mtls.cc) — mapped through the principal rules and fed to
            # authorization exactly like a SASL identity
            ssl_obj = writer.get_extra_info("ssl_object")
            peercert = ssl_obj.getpeercert() if ssl_obj is not None else None
            peer_der = (
                ssl_obj.getpeercert(binary_form=True)
                if ssl_obj is not None
                else None
            )
            if (
                self._own_cert_der is not None
                and peer_der == self._own_cert_der
            ):
                # in-broker client presenting the broker's exact cert
                ctx.principal = self.INTERNAL_PRINCIPAL
                ctx.authenticated = True
                ctx.internal = True
            else:
                name = (
                    self._mtls_mapper.principal_for(peercert)
                    if peercert
                    else None
                )
                if name is None:
                    writer.close()
                    self._conns.discard(task)
                    return
                ctx.principal = f"User:{name}"
                ctx.authenticated = True
        pending: asyncio.Queue = asyncio.Queue()
        conn_failed = asyncio.Event()
        proto = writer.transport.get_protocol()
        rx = proto if isinstance(proto, _RxStampProtocol) else None
        cfg = self.broker.controller.cluster_config
        scanner = FrameScanner(cfg.get("kafka_max_request_bytes"))
        window = cfg.get("kafka_max_inflight_per_connection")
        # unwritten responses this connection has queued; the reader
        # stops decoding ahead at `window` and resumes as the writer
        # settles them
        inflight = 0
        window_open = asyncio.Event()
        window_open.set()

        def settle() -> None:
            nonlocal inflight
            inflight -= 1
            self._inflight -= 1
            if inflight < window:
                window_open.set()

        async def write_loop() -> None:
            while True:
                item = await pending.get()
                if item is None:
                    return
                fut, on_written = item
                try:
                    resp = await fut
                except _CloseConnection as e:
                    settle()
                    if e.args and e.args[0]:
                        writer.write(_SIZE.pack(len(e.args[0])) + e.args[0])
                        await writer.drain()
                    conn_failed.set()
                    window_open.set()  # a stalled reader must observe it
                    writer.close()  # unblocks the reader side
                    return
                except Exception:
                    settle()
                    conn_failed.set()
                    window_open.set()
                    try:
                        writer.close()
                    except Exception:
                        pass
                    raise
                if resp is not None:
                    # two writes, not a size+body concat: a MB-scale
                    # fetch response would pay a full extra copy just
                    # to prepend 4 bytes
                    writer.write(_SIZE.pack(len(resp)))
                    writer.write(resp)
                    await writer.drain()
                settle()
                if on_written is not None:
                    on_written()

        write_task = asyncio.ensure_future(write_loop())

        async def enqueue(resp) -> None:
            """Queue one response (or the future of one) for the
            writer fiber, charging the inflight window."""
            nonlocal inflight
            on_written = None
            if type(resp) is _TrackedResponse:
                on_written = resp.on_written
                resp = resp.resp
            if asyncio.iscoroutine(resp):
                fut = asyncio.ensure_future(resp)
            else:
                fut = asyncio.get_event_loop().create_future()
                fut.set_result(resp)
            inflight += 1
            self._inflight += 1
            await pending.put((fut, on_written))

        async def process_frames(frames, t_req: float) -> bool:
            """Run one scanned burst through _process in arrival
            order; False ends the connection (close request from the
            pipeline or a writer-side failure)."""
            nonlocal inflight
            for frame, _api_key, _api_version, _corr in frames:
                if inflight >= window:
                    # pipelining window full: stop decoding ahead
                    # until the writer settles responses
                    self._inflight_stalls.inc()
                    window_open.clear()
                    await window_open.wait()
                if conn_failed.is_set():
                    return False
                try:
                    resp = await self._process(frame, ctx, t_req)
                except _CloseConnection as e:
                    fut = asyncio.get_event_loop().create_future()
                    fut.set_exception(e)
                    inflight += 1
                    self._inflight += 1
                    await pending.put((fut, None))
                    return False
                await enqueue(resp)
                # later frames of the burst were decode-ahead work:
                # their request clock starts when the reader reaches
                # them (conservative, matches the old loop's fallback)
                t_req = time.monotonic()
            return True

        try:
            while not conn_failed.is_set():
                try:
                    frames = scanner.scan()
                except FrameError:
                    return  # oversize/garbage size prefix
                if frames:
                    # the burst's request clock starts at wire arrival
                    # when the stamp is armed; fallback (bytes were
                    # already buffered) is "now" — conservative
                    if rx is not None and rx.rx_t0 >= 0.0:
                        t_burst = rx.rx_t0
                        rx.rx_t0 = -1.0
                    else:
                        t_burst = time.monotonic()
                    if not await process_frames(frames, t_burst):
                        break
                    continue
                if rx is not None and scanner.buffered == 0:
                    rx.rx_t0 = -1.0  # re-arm: next bytes stamp arrival
                try:
                    data = await reader.read(_RECV_CHUNK)
                except ConnectionError:
                    return
                if not data:
                    return  # EOF
                # live config rebind once per socket read, off the
                # per-frame path
                scanner.max_frame = cfg.get("kafka_max_request_bytes")
                scanner.feed(data)
            await pending.put(None)  # writer drains then exits
            await write_task
        except (asyncio.CancelledError, ConnectionError):
            pass
        finally:
            # release everything BEFORE leaving self._conns: observers
            # (the churn smoke, admin scrapes) treat "no connections"
            # as "nothing accounted", so the connection must not be
            # discarded while its sessions/quota refs are still live
            try:
                try:
                    await cancel_and_wait(write_task)
                except (ConnectionError, OSError):
                    pass  # write-side teardown noise; real bugs propagate
                # settle any still-pending response futures
                while not pending.empty():
                    item = pending.get_nowait()
                    if item is not None:
                        item[0].cancel()
                # reconcile the fleet inflight gauge for responses the
                # writer never settled
                self._inflight -= inflight
                # release per-connection protocol state: an aborted
                # connection must not leak its fetch sessions or its
                # quota-bucket references through a churn storm
                for sid in ctx.fetch_session_ids:
                    self.fetch_sessions.remove(sid)
                for cid in ctx.client_ids:
                    self.quotas.release(cid)
                try:
                    writer.close()
                except Exception:
                    pass
            finally:
                self._conns.discard(task)

    async def _process(
        self, frame: bytes, ctx: ConnectionContext, t_req: float | None = None
    ) -> bytes | None:
        from .protocol.admin_apis import SASL_AUTHENTICATE, SASL_HANDSHAKE

        # Native produce frontend: header decode + body decode +
        # per-batch wire CRC verification in one C call over the frame
        # (native/produce_frame.cc). Punts (None) on anything but the
        # hot single-topic/single-partition shape; all the gates below
        # still run on the returned header, so SASL/session/version
        # semantics are unchanged.
        if t_req is None:  # callers without an rx stamp
            t_req = time.monotonic()
        req = None
        native_path = False
        if produce_fast.native_ready():
            nat = produce_fast.decode_request_native(frame)
            if nat is not None:
                hdr, req = nat
                native_path = True
                self.probe.decode[(0, True)](time.monotonic() - t_req)
        if req is None:
            r = Reader(frame)
            hdr = decode_request_header(r)
        api = API_BY_KEY.get(hdr.api_key)
        if api is None:
            logger.warning("unknown api key %d", hdr.api_key)
            raise _CloseConnection(b"")
        # anonymous clients account under "" (record_and_throttle's
        # fallback key) — acquire that principal too, or its rate
        # window outlives every anonymous connection until the idle GC
        cid = hdr.client_id or ""
        if cid not in ctx.client_ids:
            # first use of this client_id on the connection: pin its
            # quota state until teardown releases the reference
            ctx.client_ids.add(cid)
            self.quotas.acquire(cid)
        if (
            self.broker.config.enable_sasl
            and not ctx.authenticated
            and hdr.api_key
            not in (API_VERSIONS.key, SASL_HANDSHAKE.key, SASL_AUTHENTICATE.key)
        ):
            # the reference disconnects unauthenticated requests
            # (connection_context.cc sasl gate)
            logger.warning(
                "unauthenticated %s request: closing connection", api.name
            )
            raise _CloseConnection(b"")
        if (
            ctx.authenticated
            and ctx.session_expires_mono is not None
            and time.monotonic() >= ctx.session_expires_mono
            and hdr.api_key
            not in (API_VERSIONS.key, SASL_HANDSHAKE.key, SASL_AUTHENTICATE.key)
        ):
            # SASL session bounded by token expiry (KIP-368 semantics:
            # past the lifetime the broker disconnects unless the
            # client re-authenticates; handshake/authenticate stay
            # allowed so re-auth on the live connection works)
            logger.info(
                "sasl session expired for %s: closing connection",
                ctx.principal,
            )
            raise _CloseConnection(b"")
        if not api.supports(hdr.api_version):
            # only ApiVersions has a downgrade contract (reply v0 +
            # UNSUPPORTED_VERSION so the client renegotiates); for any
            # other api there is no version both sides can parse — send
            # the ApiVersions-style error THEN close, matching the
            # reference's disconnect (kafka/server/protocol_utils.cc)
            if hdr.api_key == API_VERSIONS.key:
                return self._unsupported_version(hdr)
            logger.warning(
                "%s v%d unsupported (range %d-%d): closing connection",
                api.name, hdr.api_version, api.min_version, api.max_version,
            )
            raise _CloseConnection(b"")
        if req is None:
            body_mv = frame[len(frame) - r.remaining :]
            if hdr.api_key == 0:  # PRODUCE: hand-rolled single-shape codec
                req = produce_fast.decode_request(
                    body_mv, hdr.api_version, api.flexible(hdr.api_version)
                )
                if req is None:
                    req = api.decode_request(body_mv, hdr.api_version)
                self.probe.decode[(0, False)](time.monotonic() - t_req)
            else:
                req = api.decode_request(body_mv, hdr.api_version)
                if hdr.api_key == 1:
                    self.probe.decode[(1, False)](time.monotonic() - t_req)
        probe_key = (
            (hdr.api_key, native_path) if hdr.api_key in (0, 1) else None
        )
        root = None
        if hdr.api_key == SASL_HANDSHAKE.key:
            resp = self.handle_sasl_handshake(ctx, hdr, req)
        elif hdr.api_key == SASL_AUTHENTICATE.key:
            resp = self.handle_sasl_authenticate(ctx, hdr, req)
        else:
            handler = self._handlers.get(hdr.api_key)
            if handler is None:
                raise _CloseConnection(b"")
            # anonymous non-internal connections match the contextvar
            # defaults — skip two set/reset pairs on the hot path
            has_identity = ctx.principal is not None or ctx.internal
            if has_identity:
                token = CURRENT_PRINCIPAL.set(ctx.principal)
                itoken = CURRENT_INTERNAL.set(ctx.internal)
            if probe_key is not None and trace.ENABLED:
                # flight-recorder root; its lifetime crosses into the
                # write loop (on_written), so the contextvar scope
                # (detach) and the end stamp (finish) split
                root = self.broker.recorder.span(
                    "kafka.produce" if hdr.api_key == 0 else "kafka.fetch",
                    path="native" if native_path else "python",
                )
                root.__enter__()
            t0 = asyncio.get_event_loop().time()
            try:
                resp = await handler(hdr, req)
            except Exception:
                if root is not None:
                    # error path never reaches the write loop, so the
                    # span can't close at write time — stamp it here
                    root.finish()
                logger.exception(
                    "%s v%d handler failed", api.name, hdr.api_version
                )
                raise
            finally:
                if has_identity:
                    CURRENT_PRINCIPAL.reset(token)
                    CURRENT_INTERNAL.reset(itoken)
                self._req_counter.inc(api=api.name)
                elapsed = asyncio.get_event_loop().time() - t0
                self._latency_hist.observe(elapsed)
                self._latency_hdr.record(int(elapsed * 1e6))
                if probe_key is not None:
                    self.probe.dispatch[probe_key](elapsed)
                if root is not None:
                    root.detach()
        on_written = None
        if probe_key is not None:
            # fires in write_loop after writer.drain(): the done window
            # matches what the client's own clock measures (see
            # _TrackedResponse)
            def on_written(
                done_obs=self.probe.done[probe_key], t_req=t_req, root=root
            ):
                done_obs(time.monotonic() - t_req)
                if root is not None:
                    root.finish()

        if asyncio.iscoroutine(resp):
            # staged handler (produce): dispatch done, response later —
            # encode when it settles, off the reader path
            async def finish(inner=resp, hdr=hdr, api=api, root=root):
                if root is not None:
                    with trace.span("produce.ack_wait", parent=root):
                        body = await inner
                else:
                    body = await inner
                if body is None:
                    return None
                head = encode_response_header(
                    hdr.api_key, hdr.api_version, hdr.correlation_id
                )
                return head + self._encode_response(
                    api, body, hdr.api_version
                )

            if on_written is not None:
                return _TrackedResponse(finish(), on_written)
            return finish()
        if resp is None:  # acks=0 produce: no response on the wire
            return None
        head = encode_response_header(
            hdr.api_key, hdr.api_version, hdr.correlation_id
        )
        out = head + self._encode_response(api, resp, hdr.api_version)
        if on_written is not None:
            return _TrackedResponse(out, on_written)
        return out

    @staticmethod
    def _encode_response(api, msg, version: int) -> bytes:
        if api.key == 0:  # PRODUCE: hand-rolled single-shape codec
            try:
                resps = msg["responses"]
                if len(resps) == 1:
                    prs = resps[0]["partition_responses"]
                    pr = prs[0]
                    if (
                        len(prs) == 1
                        and "record_errors" not in pr
                        and msg.get("throttle_time_ms", 0) == 0
                    ):
                        fast = produce_fast.encode_response_single(
                            version,
                            api.flexible(version),
                            resps[0]["name"],
                            pr["index"],
                            pr["error_code"],
                            pr["base_offset"],
                            log_start_offset=pr.get("log_start_offset", -1),
                        )
                        if fast is not None:
                            return fast
            except (KeyError, IndexError):
                pass
        return api.encode_response(msg, version)

    def _unsupported_version(self, hdr: RequestHeader) -> bytes:
        """ApiVersions contract: reply v0 + UNSUPPORTED_VERSION so the
        client can downgrade (kafka/server/protocol_utils.cc)."""
        head = encode_response_header(hdr.api_key, 0, hdr.correlation_id)
        body = API_VERSIONS.encode_response(
            Msg(
                error_code=int(ErrorCode.unsupported_version),
                api_keys=self._api_version_keys(),
                throttle_time_ms=0,
            ),
            0,
        )
        return head + body

    def _api_version_keys(self) -> list[Msg]:
        return [
            Msg(
                api_key=a.key,
                min_version=a.min_version,
                max_version=a.max_version,
            )
            for a in sorted(ALL_APIS, key=lambda a: a.key)
        ]

    # -- sasl ---------------------------------------------------------
    def handle_sasl_handshake(
        self, ctx: ConnectionContext, hdr: RequestHeader, req: Msg
    ) -> Msg:
        from ..security import oidc as oidc_mod
        from ..security.scram import MECHANISMS, ScramServerExchange

        supported = list(MECHANISMS)
        if self.broker.oidc is not None:
            supported.append(oidc_mod.SASL_MECHANISM)
        if self.broker.gssapi is not None:
            supported.append("GSSAPI")
        if req.mechanism not in supported:
            return Msg(
                error_code=int(ErrorCode.unsupported_sasl_mechanism),
                mechanisms=supported,
            )
        ctx.mechanism = req.mechanism
        if req.mechanism == oidc_mod.SASL_MECHANISM:
            ctx.scram = oidc_mod.OauthBearerExchange(self.broker.oidc)
        elif req.mechanism == "GSSAPI":
            ctx.scram = self.broker.gssapi.new_exchange()
        else:
            ctx.scram = ScramServerExchange(
                self.broker.controller.credentials, req.mechanism
            )
        return Msg(error_code=0, mechanisms=supported)

    def handle_sasl_authenticate(
        self, ctx: ConnectionContext, hdr: RequestHeader, req: Msg
    ) -> Msg:
        from ..security.gssapi_authenticator import GssapiError
        from ..security.oidc import OidcError
        from ..security.scram import ScramError

        def err(code: int, message: str) -> Msg:
            return Msg(
                error_code=code,
                error_message=message,
                auth_bytes=b"",
                session_lifetime_ms=0,
            )

        if ctx.scram is None:
            return err(int(ErrorCode.illegal_sasl_state), "handshake first")
        try:
            if hasattr(ctx.scram, "step"):
                # multi-round mechanisms (GSSAPI) drive themselves via
                # a generic step() until done
                if ctx.scram.done:
                    return err(
                        int(ErrorCode.illegal_sasl_state), "exchange complete"
                    )
                out = ctx.scram.step(bytes(req.auth_bytes))
            elif ctx.scram.state == "start":
                out = ctx.scram.handle_client_first(bytes(req.auth_bytes))
            elif ctx.scram.state == "sent-first":
                out = ctx.scram.handle_client_final(bytes(req.auth_bytes))
            else:
                return err(
                    int(ErrorCode.illegal_sasl_state), "exchange complete"
                )
        except (ScramError, OidcError, GssapiError) as e:
            logger.info("sasl authentication failed: %s", e)
            return err(int(ErrorCode.sasl_authentication_failed), str(e))
        except Exception as e:
            # malformed client-first/final messages (bad UTF-8, missing
            # fields, invalid base64) must fail the exchange, not the
            # connection task
            logger.info("sasl: malformed auth bytes: %r", e)
            return err(
                int(ErrorCode.sasl_authentication_failed),
                "malformed SASL message",
            )
        lifetime_ms = 0
        if ctx.scram.done:
            ctx.principal = f"User:{ctx.scram.username}"
            ctx.authenticated = True
            expires_at = getattr(ctx.scram, "expires_at", None)
            ctx.session_expires_mono = None
            if expires_at is not None:
                # one wall-clock read converts the token's absolute exp
                # into a relative lifetime; every later expiry check is
                # monotonic-only
                remaining = expires_at - time.time()  # rplint: disable=RPL014
                ctx.session_expires_mono = time.monotonic() + remaining
                lifetime_ms = max(0, int(remaining * 1000))
            logger.info("sasl: authenticated %s", ctx.principal)
        return Msg(
            error_code=0,
            error_message=None,
            auth_bytes=out,
            session_lifetime_ms=lifetime_ms,
        )

    # -- handlers ----------------------------------------------------
    async def handle_api_versions(self, hdr: RequestHeader, req: Msg) -> Msg:
        return Msg(
            error_code=0,
            api_keys=self._api_version_keys(),
            throttle_time_ms=0,
        )

    async def handle_metadata(self, hdr: RequestHeader, req: Msg) -> Msg:
        b = self.broker
        cache = b.metadata_cache
        # v0: empty list means all topics; v1+: null means all
        want_all = req.topics is None or (
            hdr.api_version == 0 and len(req.topics) == 0
        )
        if want_all:
            # unauthorized topics are silently filtered from a
            # list-all, matching metadata.cc (no existence leak)
            names = [
                tp.topic
                for tp in cache.topics()
                if tp.ns == DEFAULT_NS
                and self.authorize(
                    AclOperation.describe, AclResourceType.topic, tp.topic
                )
            ]
        else:
            names = [t.name for t in req.topics]

        topics_out = []
        for name in names:
            if not want_all and not self.authorize(
                AclOperation.describe, AclResourceType.topic, name
            ):
                topics_out.append(
                    Msg(
                        error_code=int(ErrorCode.topic_authorization_failed),
                        name=name,
                        is_internal=False,
                        partitions=[],
                    )
                )
                continue
            md = cache.get_topic(TopicNamespace(DEFAULT_NS, name))
            if md is None:
                topics_out.append(
                    Msg(
                        error_code=int(ErrorCode.unknown_topic_or_partition),
                        name=name,
                        is_internal=False,
                        partitions=[],
                    )
                )
                continue
            parts = []
            for pid, a in sorted(md.assignments.items()):
                ntp = kafka_ntp(name, pid)
                leader = cache.leader_of(ntp)
                parts.append(
                    Msg(
                        error_code=(
                            0
                            if leader is not None
                            else int(ErrorCode.leader_not_available)
                        ),
                        partition_index=pid,
                        leader_id=leader if leader is not None else -1,
                        leader_epoch=-1,
                        replica_nodes=list(a.replicas),
                        isr_nodes=list(a.replicas),
                        offline_replicas=[],
                    )
                )
            topics_out.append(
                Msg(
                    error_code=0,
                    name=name,
                    is_internal=False,
                    partitions=parts,
                )
            )

        brokers = []
        for nid in b.controller.members:
            addr = b.kafka_address_of(nid)
            if addr is not None:
                ep = b.controller.members_table.get(nid)
                brokers.append(
                    Msg(
                        node_id=nid,
                        host=addr[0],
                        port=addr[1],
                        rack=(ep.rack or None) if ep is not None else None,
                    )
                )
        controller_id = b.controller.leader_id
        return Msg(
            throttle_time_ms=0,
            brokers=brokers,
            cluster_id="redpanda-tpu",
            controller_id=controller_id if controller_id is not None else -1,
            topics=topics_out,
        )

    async def handle_create_topics(self, hdr: RequestHeader, req: Msg) -> Msg:
        from ..cluster.controller import TopicError

        out = []
        for t in req.topics:
            code, message = 0, None
            if not self.authorize(
                AclOperation.create, AclResourceType.topic, t.name
            ) and not self.authorize(
                AclOperation.create, AclResourceType.cluster, "kafka-cluster"
            ):
                out.append(
                    Msg(
                        name=t.name,
                        error_code=int(ErrorCode.topic_authorization_failed),
                        error_message=None,
                    )
                )
                continue
            if req.validate_only:
                if self.broker.controller.topic_table.contains(
                    TopicNamespace(DEFAULT_NS, t.name)
                ):
                    code = int(ErrorCode.topic_already_exists)
            else:
                try:
                    await self.broker.controller.create_topic(
                        t.name,
                        partitions=t.num_partitions if t.num_partitions > 0 else 1,
                        replication_factor=(
                            t.replication_factor
                            if t.replication_factor > 0
                            else _default_rf(len(self.broker.controller.members))
                        ),
                        config={c.name: c.value for c in t.configs},
                        timeout=max(req.timeout_ms / 1000.0, 1.0),
                    )
                except TopicError as e:
                    code, message = _topic_error_code(e.code), e.message
                except TimeoutError:
                    code = int(ErrorCode.request_timed_out)
            out.append(Msg(name=t.name, error_code=code, error_message=message))
        return Msg(throttle_time_ms=0, topics=out)

    async def handle_produce(self, hdr: RequestHeader, req: Msg) -> Msg | None:
        acks = req.acks
        if acks not in (-1, 0, 1):
            resp = Msg(
                responses=[
                    Msg(
                        name=t.name,
                        partition_responses=[
                            Msg(
                                index=p.index,
                                error_code=int(ErrorCode.invalid_required_acks),
                                base_offset=-1,
                            )
                            for p in t.partitions
                        ],
                    )
                    for t in req.topics
                ],
                throttle_time_ms=0,
            )
            return resp

        def produce_error(exc: BaseException) -> int:
            if isinstance(exc, CrcMismatch):
                return int(ErrorCode.corrupt_message)
            if isinstance(exc, NotLeaderError):
                return int(ErrorCode.not_leader_for_partition)
            if isinstance(exc, (ReplicateTimeout, asyncio.TimeoutError)):
                return int(ErrorCode.request_timed_out)
            if isinstance(exc, OutOfOrderSequence):
                return int(ErrorCode.out_of_order_sequence_number)
            if isinstance(exc, ProducerFenced):
                return int(ErrorCode.invalid_producer_epoch)
            if isinstance(exc, ValueError):
                return int(ErrorCode.corrupt_message)
            if isinstance(exc, InvokeError):
                # cross-shard hop failed (timeout / shard down):
                # retriable from the client's perspective
                return int(ErrorCode.request_timed_out)
            return int(ErrorCode.unknown_server_error)

        async def dispatch_partition(topic: str, p: Msg):
            """Stage 1 (produce.cc dispatched): parse, CRC-verify and
            enqueue every batch in log order. Returns either an error
            Msg (terminal) or the list of in-flight stages."""
            if not self.authorize(AclOperation.write, AclResourceType.topic, topic):
                return Msg(
                    index=p.index,
                    error_code=int(ErrorCode.topic_authorization_failed),
                    base_offset=-1,
                )
            ntp = kafka_ntp(topic, p.index)
            partition = self.broker.partition_manager.get(ntp)
            if partition is None and self.broker.shard_router is not None:
                # shard-owned partition: this broker is the leader but
                # the raft group lives on another core — forward the
                # raw record set through invoke_on and let stage 2
                # await the shard's ack (ssx shard seam)
                shard = self.broker.shard_table.shard_for(ntp)
                if shard:
                    if not self.broker.shard_table.is_available(shard):
                        # crash/restart window: the group stays mapped
                        # while the child re-forks, but invoking into
                        # it would hang — answer RETRIABLE immediately
                        # (graceful degradation, never a stuck client)
                        return Msg(
                            index=p.index,
                            error_code=int(
                                ErrorCode.not_leader_for_partition
                            ),
                            base_offset=-1,
                        )
                    if p.records is None:
                        return Msg(
                            index=p.index,
                            error_code=int(ErrorCode.invalid_request),
                            base_offset=-1,
                        )
                    self.probe.note_produce(
                        f"{ntp.ns}/{ntp.topic}/{ntp.partition}",
                        len(p.records),
                    )
                    fut = asyncio.ensure_future(
                        self.broker.shard_router.produce(
                            shard, ntp, bytes(p.records), acks
                        )
                    )
                    return (p.index, [("shard", fut)])
            if partition is None:
                known = self.broker.controller.topic_table.group_of(ntp)
                err = int(
                    ErrorCode.not_leader_for_partition
                    if known is not None
                    else ErrorCode.unknown_topic_or_partition
                )
                return Msg(index=p.index, error_code=err, base_offset=-1)
            if p.records is None:
                return Msg(
                    index=p.index,
                    error_code=int(ErrorCode.invalid_request),
                    base_offset=-1,
                )
            # request-order entries: ("dup", offset) for already-applied
            # retries, ("ps", stages) for in-flight batches — the
            # response base_offset is the FIRST batch's offset either way
            # compression.type topic config: "producer" (default) keeps
            # the client's codec; a concrete codec makes the BROKER
            # recompress uncompressed batches (real Kafka semantics).
            # The lz4 case can take the fused device CRC+LZ4 kernel
            # behind RP_CODEC_BACKEND=device (models/record.recompressed)
            ctype_cfg = None
            md = self.broker.controller.topic_table.get(
                TopicNamespace(DEFAULT_NS, topic)
            )
            if md is not None:
                want = (md.config.get("compression.type") or "").lower()
                ctype_cfg = {
                    "gzip": CompressionType.gzip,
                    "snappy": CompressionType.snappy,
                    "lz4": CompressionType.lz4,
                    "zstd": CompressionType.zstd,
                    # valid Kafka value: force broker-side decompression
                    "uncompressed": CompressionType.none,
                    "none": CompressionType.none,
                }.get(want)
            self.probe.note_produce(
                f"{ntp.ns}/{ntp.topic}/{ntp.partition}", len(p.records)
            )
            entries: list[tuple] = []
            try:
                # memoryview straight from the request frame: the
                # parser walks it in place and from_kafka_wire copies
                # only the body out — one fewer full-payload memcpy
                parser = IOBufParser(p.records)
                prev_enqueued = None
                while parser.bytes_left() > 0:
                    # when recompressing, CRC verification folds into
                    # the same pass (device: literally one program)
                    recompress = (
                        ctype_cfg is not None
                        and parser.bytes_left() > 57  # header floor
                    )
                    # _crc_ok: the native frontend already verified
                    # every batch's wire crc in its one-pass decode
                    batch = RecordBatch.from_kafka_wire(
                        parser,
                        verify=not recompress and not p.get("_crc_ok"),
                    )
                    if recompress:
                        # recompressed() verifies the wire crc in the
                        # same pass, transcodes codec mismatches, and
                        # no-ops when the codec already matches
                        with trace.section("recompress", self.probe.registry):
                            batch = batch.recompressed(
                                ctype_cfg, verify_crc=batch.header.crc
                            )
                    # order guard: the PREVIOUS batch must be cached in
                    # FIFO order before this one dispatches. Awaiting
                    # lazily (instead of after every replicate) makes
                    # the common single-batch partition shield-free.
                    if prev_enqueued is not None:
                        await asyncio.shield(prev_enqueued)
                    try:
                        ps = await partition.replicate_in_stages(
                            batch, acks=acks
                        )
                    except DuplicateSequence as dup:
                        entries.append(("dup", dup.base_offset))
                        continue
                    entries.append(("ps", ps))
                    prev_enqueued = ps.enqueued
            except Exception as e:
                for kind, v in entries:
                    if kind == "ps":
                        _consume_exc(v.enqueued)
                        _consume_exc(v.done)
                return Msg(
                    index=p.index, error_code=produce_error(e), base_offset=-1
                )
            return (p.index, entries)

        async def finish_partition(work) -> Msg:
            """Stage 2 (produced): await the requested ack level."""
            if isinstance(work, Msg):
                return work
            index, entries = work
            base = -1
            err = 0
            for i, (kind, v) in enumerate(entries):
                if kind == "dup":
                    if base < 0:
                        base = v
                    continue
                if kind == "shard":
                    # cross-shard produce: one future covering the whole
                    # record set, resolved to (error_code, base_offset)
                    try:
                        serr, kbase = await asyncio.wait_for(
                            asyncio.shield(v), 15.0
                        )
                    except Exception as e:
                        err = produce_error(e)
                        _consume_exc(v)
                        break
                    if serr:
                        err = serr
                        break
                    if base < 0:
                        base = kbase
                    continue
                try:
                    kbase = await asyncio.wait_for(asyncio.shield(v.done), 10.0)
                    if base < 0:
                        base = kbase
                except Exception as e:
                    err = produce_error(e)
                    for kind2, v2 in entries[i:]:
                        if kind2 == "ps":
                            _consume_exc(v2.done)
                    break
            return Msg(index=index, error_code=err, base_offset=base if not err else -1)

        # stage 1 runs before this handler returns: per-connection
        # order is fixed by enqueue order
        work = []
        produced_bytes = 0
        ntp_keys = []
        with trace.span("produce.dispatch"):
            for t in req.topics:
                for p in t.partitions:
                    produced_bytes += len(p.records or b"")
                    ntp_keys.append(f"{DEFAULT_NS}/{t.name}/{p.index}")
                partition_work = [
                    await dispatch_partition(t.name, p) for p in t.partitions
                ]
                work.append((t.name, partition_work))
        self._produce_bytes.inc(produced_bytes)
        throttle = self.quotas.record_and_throttle(
            "produce", hdr.client_id, produced_bytes, ntps=ntp_keys
        )
        if throttle and acks == 0:
            # no response exists to carry throttle_time_ms for acks=0 —
            # stall the reader loop itself so the firehose cannot
            # bypass the quota by never waiting for responses
            await asyncio.sleep(min(throttle, 1000) / 1000.0)

        async def finish():
            responses = []
            for name, partition_work in work:
                prs = await asyncio.gather(
                    *(finish_partition(w) for w in partition_work)
                )
                responses.append(
                    Msg(name=name, partition_responses=list(prs))
                )
            if acks == 0:
                return None
            if throttle:
                # enforced delay on the ordered response stream (see
                # handle_fetch) — a quota a client can ignore is no quota
                await asyncio.sleep(min(throttle, 1000) / 1000.0)
            return Msg(responses=responses, throttle_time_ms=throttle)

        return finish()

    def _remote_read_enabled(self, topic: str) -> bool:
        """Per-topic gate for serving archived data
        (redpanda.remote.read; shadow-indexing fetch config)."""
        md = self.broker.controller.topic_table.get(
            TopicNamespace(DEFAULT_NS, topic)
        )
        return md is not None and str(
            md.config.get("redpanda.remote.read")
        ).lower() in ("true", "1", "yes")

    async def handle_fetch(self, hdr: RequestHeader, req: Msg) -> Msg:
        wait_cap = self.broker.controller.cluster_config.get(
            "fetch_max_wait_cap_ms"
        )
        deadline = (
            asyncio.get_event_loop().time()
            + min(max(req.max_wait_ms, 0), wait_cap) / 1000.0
        )
        min_bytes = max(req.min_bytes, 0)
        # isolation 1 = READ_COMMITTED: serve only below the LSO and
        # report aborted ranges (fetch.cc read_result + rm_stm LSO)
        read_committed = getattr(req, "isolation_level", 0) == 1
        # KIP-392 follower fetching: a consumer advertising its rack
        # may be redirected by the leader to a same-rack replica, and
        # that replica serves the read bounded by ITS high watermark
        rack_id = getattr(req, "rack_id", "") or ""

        def rack_replica(topic: str, pid: int) -> int | None:
            """A replica (not us) whose broker sits in the consumer's
            rack, or None (replica_selector / rack_aware_replica_selector
            analog)."""
            from ..models.fundamental import TopicNamespace

            md = self.broker.controller.topic_table.get(
                TopicNamespace(DEFAULT_NS, topic)
            )
            if md is None:
                return None
            a = md.assignments.get(pid)
            if a is None:
                return None
            members = self.broker.controller.members_table
            for nid in a.replicas:
                if nid == self.broker.node_id:
                    continue
                ep = members.get(nid)
                if ep is not None and ep.rack == rack_id:
                    return nid
            return None

        # -- fetch sessions (KIP-227, fetch_session_cache.h) ----------
        # epoch -1: sessionless full fetch. id 0 + epoch 0: create a
        # session from this request. Otherwise: incremental — merge the
        # request into the session and serve ITS partition set.
        session = None
        incremental = False
        if hdr.api_version >= 7 and self.broker.controller.features.is_active(
            "fetch_sessions"
        ):
            sid = getattr(req, "session_id", 0) or 0
            epoch = getattr(req, "session_epoch", -1)
            conn = CURRENT_CONN.get()
            if epoch == -1:
                if sid:
                    self.fetch_sessions.remove(sid)
                    if conn is not None:
                        conn.fetch_session_ids.discard(sid)
            elif epoch == 0:
                # KIP-227: epoch 0 creates a NEW session regardless of
                # the id field (a client re-establishing after an error
                # may still carry its stale id)
                if sid:
                    self.fetch_sessions.remove(sid)
                    if conn is not None:
                        conn.fetch_session_ids.discard(sid)
                session = self.fetch_sessions.create()
                if session is not None and conn is not None:
                    # owned by this connection: teardown releases it
                    conn.fetch_session_ids.add(session.id)
                if session is not None:
                    session.apply_request(req.topics, None)
                # cache full of active sessions: answer sessionless
            else:
                session, err = self.fetch_sessions.use(sid, epoch)
                if session is None:
                    return Msg(
                        throttle_time_ms=0,
                        error_code=err,
                        session_id=0,
                        responses=[],
                    )
                if conn is not None:
                    # adoption: a client resuming its session over a
                    # NEW connection moves ownership here, so the
                    # session dies with the connection actually using it
                    conn.fetch_session_ids.add(sid)
                incremental = True
                session.apply_request(
                    req.topics, getattr(req, "forgotten_topics_data", None)
                )
        if session is not None:
            by_topic: dict[str, list[Msg]] = {}
            for (topic, pid), sp in session.partitions.items():
                by_topic.setdefault(topic, []).append(
                    Msg(
                        partition=pid,
                        fetch_offset=sp.fetch_offset,
                        partition_max_bytes=sp.max_bytes,
                    )
                )
            plan_topics = [
                Msg(topic=topic, partitions=parts)
                for topic, parts in by_topic.items()
            ]
        else:
            plan_topics = list(req.topics)

        # authorize once per request, not once per ~5ms poll iteration
        # (fetch.cc authorizes at plan time)
        authorized = {
            t.topic: self.authorize(
                AclOperation.read, AclResourceType.topic, t.topic
            )
            for t in plan_topics
        }
        # archived-range pre-pass: offsets below the LOCAL log start
        # that tiered storage still covers are read from the object
        # store ONCE up front (immutable data — no reason to re-read
        # in the poll loop). remote_partition.cc read path.
        remote_rows: dict[tuple[str, int], Msg] = {}
        reader = self.broker.remote_reader
        if reader is not None:
            from ..cloud.object_store import CloudUnavailableError, StoreError

            remote_timeout = getattr(
                self.broker.config, "cloud_fetch_timeout_s", 5.0
            )

            # ONE budget across all remote rows, mirroring the local
            # read loop's `budget - total` accounting. The hydrations
            # themselves run CONCURRENTLY (parallel_fetch_plan_executor
            # analog — the parallel axis here is object-store I/O, not
            # shards): each candidate reads under its own per-partition
            # cap and the global budget is settled in plan order.
            remote_budget = req.max_bytes if req.max_bytes > 0 else 1 << 30
            candidates = []
            for t in plan_topics:
                if not authorized.get(t.topic):
                    continue
                if not self._remote_read_enabled(t.topic):
                    continue
                for p in t.partitions:
                    partition = self.broker.partition_manager.get(
                        kafka_ntp(t.topic, p.partition)
                    )
                    if partition is None or not partition.is_leader:
                        continue
                    start = partition.start_offset()
                    cstart = partition.cloud_start_kafka()
                    if (
                        p.fetch_offset >= start
                        or cstart is None
                        or p.fetch_offset < cstart
                    ):
                        continue
                    candidates.append((t.topic, p, partition, cstart))

            async def read_one(p, partition, budget):
                lso = partition.last_stable_offset()
                upto = lso if read_committed else None
                try:
                    # the wait_for is the wedge guard: a hung object
                    # store burns THIS partition's bounded slot, and
                    # local-log rows in the same fetch are served by
                    # the poll loop untouched
                    pairs = await asyncio.wait_for(
                        partition.read_kafka_remote(
                            reader,
                            p.fetch_offset,
                            max_bytes=budget,
                            upto_kafka=upto,
                        ),
                        timeout=remote_timeout,
                    )
                except (CloudUnavailableError, asyncio.TimeoutError):
                    # typed degradation: the archived range exists but
                    # the cloud path is wedged/corrupt past its retry
                    # budget — answer a RETRIABLE storage error for
                    # this one partition (never out_of_range, which
                    # would teleport consumers; never a hung fetch)
                    return "cloud_unavailable"
                except StoreError:
                    # corrupt/missing object: fail ONE partition
                    # (out_of_range via the poll loop), not the fetch
                    return None
                # stitch the local tail into the same response when
                # the archived range hands over within budget
                used = sum(b.size_bytes() for _kb, b in pairs)
                next_off = (
                    pairs[-1][0] + pairs[-1][1].header.last_offset_delta + 1
                    if pairs
                    else p.fetch_offset
                )
                if used < budget and next_off >= partition.start_offset():
                    pairs += partition.read_kafka(
                        next_off,
                        max_bytes=budget - used,
                        upto_kafka=upto,
                    )
                wire = b"".join(_frame_kafka(b, kb) for kb, b in pairs)
                aborted = None
                if read_committed and pairs:
                    fetch_end = (
                        pairs[-1][0]
                        + pairs[-1][1].header.last_offset_delta
                        + 1
                    )
                    aborted = [
                        Msg(producer_id=pid, first_offset=first)
                        for pid, first in partition.aborted_in(
                            p.fetch_offset, fetch_end
                        )
                    ]
                return wire, aborted, lso

            # hydrate in CHUNKS: reads within a chunk run concurrently,
            # the budget settles between chunks — so an exhausted
            # budget stops issuing object-store reads (no wasted
            # hydrations), and overshoot is bounded by one chunk's
            # worth of partition_max_bytes (Kafka's max_bytes is
            # explicitly approximate; unbounded N-way overshoot is not)
            CHUNK = 4
            for i in range(0, len(candidates), CHUNK):
                if remote_budget <= 0:
                    break
                chunk = candidates[i : i + CHUNK]
                results = await asyncio.gather(
                    *(
                        read_one(
                            p,
                            partition,
                            min(p.partition_max_bytes, remote_budget),
                        )
                        for _topic, p, partition, _cs in chunk
                    )
                )
                for (topic, p, partition, cstart), res in zip(
                    chunk, results
                ):
                    if res is None or remote_budget <= 0:
                        continue
                    if res == "cloud_unavailable":
                        remote_rows[(topic, p.partition)] = Msg(
                            partition_index=p.partition,
                            error_code=int(ErrorCode.kafka_storage_error),
                            high_watermark=partition.high_watermark(),
                            last_stable_offset=partition.last_stable_offset(),
                            log_start_offset=cstart,
                            aborted_transactions=None,
                            records=None,
                        )
                        continue
                    wire, aborted, lso = res
                    remote_budget -= len(wire)
                    remote_rows[(topic, p.partition)] = Msg(
                        partition_index=p.partition,
                        error_code=0,
                        high_watermark=partition.high_watermark(),
                        last_stable_offset=lso,
                        log_start_offset=cstart,
                        aborted_transactions=aborted,
                        records=wire if wire else None,
                    )

        # shard-owned partitions: reads happen on the owning shard, so
        # they run as an async pre-pass per poll iteration (read_all
        # itself must stay synchronous) and read_all serves the rows
        shard_rows: dict[tuple[str, int], Msg] = {}
        shard_router = self.broker.shard_router

        async def shard_prepass() -> None:
            shard_rows.clear()
            budget = req.max_bytes if req.max_bytes > 0 else 1 << 30
            for t in plan_topics:
                if not authorized.get(t.topic):
                    continue
                for p in t.partitions:
                    ntp = kafka_ntp(t.topic, p.partition)
                    if self.broker.partition_manager.get(ntp) is not None:
                        continue
                    shard = self.broker.shard_table.shard_for(ntp)
                    if (
                        not shard
                        or budget <= 0
                        # crash/restart window: skip the invoke, let
                        # read_all answer not_leader (retriable)
                        or not self.broker.shard_table.is_available(shard)
                    ):
                        continue
                    try:
                        rep = await shard_router.fetch(
                            shard,
                            ntp,
                            p.fetch_offset,
                            min(p.partition_max_bytes, budget),
                            read_committed,
                        )
                    except InvokeError:
                        continue  # read_all answers not_leader (retriable)
                    wire = bytes(rep.records)
                    budget -= len(wire)
                    if wire:
                        self.probe.note_fetch(
                            f"{ntp.ns}/{ntp.topic}/{ntp.partition}",
                            len(wire),
                        )
                    shard_rows[(t.topic, p.partition)] = Msg(
                        partition_index=p.partition,
                        error_code=rep.error,
                        high_watermark=rep.high_watermark,
                        last_stable_offset=rep.last_stable_offset,
                        log_start_offset=rep.log_start,
                        aborted_transactions=None,
                        records=wire if wire else None,
                    )

        def read_all() -> tuple[list[Msg], int, bool]:
            total = 0
            has_error = False
            out = []
            budget = req.max_bytes if req.max_bytes > 0 else 1 << 30
            for t in plan_topics:
                parts = []
                topic_ok = authorized[t.topic]
                for p in t.partitions:
                    if not topic_ok:
                        has_error = True
                        parts.append(
                            Msg(
                                partition_index=p.partition,
                                error_code=int(
                                    ErrorCode.topic_authorization_failed
                                ),
                                high_watermark=-1,
                                last_stable_offset=-1,
                                log_start_offset=-1,
                                aborted_transactions=None,
                                records=None,
                            )
                        )
                        continue
                    ntp = kafka_ntp(t.topic, p.partition)
                    partition = self.broker.partition_manager.get(ntp)
                    if partition is None:
                        row = shard_rows.get((t.topic, p.partition))
                        if row is not None:
                            if row.error_code:
                                has_error = True
                            total += len(row.records or b"")
                            parts.append(row)
                            continue
                        known = self.broker.controller.topic_table.group_of(ntp)
                        has_error = True
                        parts.append(
                            Msg(
                                partition_index=p.partition,
                                error_code=int(
                                    ErrorCode.not_leader_for_partition
                                    if known is not None
                                    else ErrorCode.unknown_topic_or_partition
                                ),
                                high_watermark=-1,
                                last_stable_offset=-1,
                                log_start_offset=-1,
                                aborted_transactions=None,
                                records=None,
                            )
                        )
                        continue
                    follower_serve = (
                        not partition.is_leader
                        and rack_id != ""
                        and (self.broker.config.rack or "") == rack_id
                    )
                    if not partition.is_leader and not follower_serve:
                        has_error = True
                        parts.append(
                            Msg(
                                partition_index=p.partition,
                                error_code=int(ErrorCode.not_leader_for_partition),
                                high_watermark=-1,
                                last_stable_offset=-1,
                                log_start_offset=-1,
                                aborted_transactions=None,
                                records=None,
                            )
                        )
                        continue
                    if (
                        partition.is_leader
                        and rack_id != ""
                        and (self.broker.config.rack or "") != rack_id
                    ):
                        nid = rack_replica(t.topic, p.partition)
                        if nid is not None:
                            # redirect: empty row naming the same-rack
                            # replica; fast-exit the poll so the client
                            # switches immediately (fetch.cc
                            # preferred_read_replica)
                            has_error = True
                            parts.append(
                                Msg(
                                    partition_index=p.partition,
                                    error_code=0,
                                    high_watermark=partition.high_watermark(),
                                    last_stable_offset=partition.last_stable_offset(),
                                    log_start_offset=partition.start_offset(),
                                    aborted_transactions=None,
                                    preferred_read_replica=nid,
                                    records=None,
                                )
                            )
                            continue
                    hw = partition.high_watermark()
                    lso = partition.last_stable_offset()
                    start = partition.start_offset()
                    # range validity is judged against the HW even for
                    # READ_COMMITTED: an offset in (LSO, HW] is a valid
                    # position that simply reads empty until the open
                    # tx resolves and the LSO advances past it
                    if p.fetch_offset < start or p.fetch_offset > hw:
                        remote = remote_rows.get((t.topic, p.partition))
                        if remote is not None:
                            # served from the archived range — or a
                            # typed degradation row (retriable
                            # KAFKA_STORAGE_ERROR) when the cloud path
                            # was wedged; either way never a bogus
                            # out_of_range for data the archive holds
                            if remote.error_code:
                                has_error = True
                            total += len(remote.records or b"")
                            parts.append(remote)
                            continue
                        if follower_serve and p.fetch_offset > hw:
                            # lagging replica: the offset may be valid
                            # on the leader — answer EMPTY (retriable),
                            # never out_of_range, or a redirected
                            # rack consumer crashes on data the
                            # cluster definitely has (KIP-392)
                            parts.append(
                                Msg(
                                    partition_index=p.partition,
                                    error_code=0,
                                    high_watermark=hw,
                                    last_stable_offset=lso,
                                    log_start_offset=start,
                                    aborted_transactions=None,
                                    records=None,
                                )
                            )
                            continue
                        cloud_start = partition.cloud_start_kafka()
                        has_error = True
                        parts.append(
                            Msg(
                                partition_index=p.partition,
                                error_code=int(ErrorCode.offset_out_of_range),
                                high_watermark=hw,
                                last_stable_offset=lso,
                                log_start_offset=(
                                    cloud_start
                                    if cloud_start is not None
                                    and cloud_start < start
                                    else start
                                ),
                                aborted_transactions=None,
                                records=None,
                            )
                        )
                        continue
                    wire, fetch_end = read_fetch_rows(
                        partition,
                        p.fetch_offset,
                        max_bytes=min(p.partition_max_bytes, budget - total)
                        if budget - total > 0
                        else 0,
                        upto_kafka=lso if read_committed else None,
                    )
                    total += len(wire)
                    if wire:
                        self.probe.note_fetch(
                            f"{DEFAULT_NS}/{t.topic}/{p.partition}",
                            len(wire),
                        )
                    aborted = None
                    if read_committed and fetch_end is not None:
                        aborted = [
                            Msg(producer_id=pid, first_offset=first)
                            for pid, first in partition.aborted_in(
                                p.fetch_offset, fetch_end
                            )
                        ]
                    parts.append(
                        Msg(
                            partition_index=p.partition,
                            error_code=0,
                            high_watermark=hw,
                            last_stable_offset=lso,
                            log_start_offset=start,
                            aborted_transactions=aborted,
                            records=wire if wire else None,
                        )
                    )
                out.append(Msg(topic=t.topic, partitions=parts))
            return out, total, has_error

        # long-poll: debounced re-read until min_bytes or max_wait
        # (fetch.cc:432 over_min_bytes, :546 debounce)
        metrics = self.probe.registry
        polls = 0
        while True:
            if shard_router is not None:
                await shard_prepass()
            polls += 1
            with trace.section("fetch_read", metrics, span=False):
                responses, total, has_error = read_all()
            # error partitions complete the fetch immediately — holding
            # the long-poll would stall the client's metadata refresh
            if has_error or total >= min_bytes:
                break
            now = asyncio.get_event_loop().time()
            if now >= deadline:
                break
            await asyncio.sleep(min(0.005, deadline - now))
        self.probe.fetch_polls(polls)
        trace.tag_current(polls=polls)

        if fetch_verify_enabled():
            with trace.section("fetch_verify", metrics):
                self._verify_fetch_response(responses)
        if session is not None:
            responses = self._finish_session_fetch(
                session, responses, incremental
            )
        fetched_bytes = 0
        fetched_ntps = []
        for t in responses:
            for p in t.partitions:
                if p.records:
                    fetched_bytes += len(p.records)
                    fetched_ntps.append(
                        f"{DEFAULT_NS}/{t.topic}/{p.partition_index}"
                    )
        throttle = self.quotas.record_and_throttle(
            "fetch", hdr.client_id, fetched_bytes, ntps=fetched_ntps
        )
        if throttle:
            # ENFORCE, don't just advise: the connection's ordered
            # response stream stalls for the throttle window, bounding
            # a client that ignores throttle_time_ms
            # (quota_manager.cc throttling via response delay)
            await asyncio.sleep(min(throttle, 1000) / 1000.0)
        return Msg(
            throttle_time_ms=throttle,
            error_code=0,
            session_id=session.id if session is not None else 0,
            responses=responses,
        )

    def _verify_fetch_response(self, responses) -> None:
        """Device-batched CRC verify-on-read (RP_FETCH_VERIFY=1).

        Stages every span of every partition row in this fetch response
        into ONE row_bucket-padded ops/crc32c dispatch (the Kafka body
        CRC covers attributes onward, so the base-offset patch never
        invalidates it). A mismatching row — a span corrupted on disk
        below append-time verification — is replaced with a retriable
        KAFKA_STORAGE_ERROR and the owning log's wire plane is dropped
        so the client's retry re-reads from disk instead of re-serving
        the cached corrupt copy."""
        import numpy as np

        payloads: list[bytes] = []
        expected: list[int] = []
        rows: list[tuple] = []  # (row Msg, topic, start index, count)
        for t in responses:
            for p in t.partitions:
                if not p.records:
                    continue
                bufs, crcs = wire_crc_payloads(p.records)
                if not bufs:
                    continue
                rows.append((p, t.topic, len(payloads), len(bufs)))
                payloads.extend(bufs)
                expected.extend(crcs)
        if not payloads:
            return
        from ..ops.crc32c import crc32c_batch_device

        stride = max(len(b) for b in payloads)
        mat = np.zeros((len(payloads), stride), dtype=np.uint8)
        lens = np.zeros(len(payloads), dtype=np.int64)
        for i, b in enumerate(payloads):
            mat[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            lens[i] = len(b)
        got = crc32c_batch_device(mat, lens)
        for p, topic, start, n in rows:
            ok = all(
                int(got[start + i]) == expected[start + i] for i in range(n)
            )
            if ok:
                continue
            logger.warning(
                "fetch verify: CRC mismatch in %s/%s — answering "
                "retriable storage error",
                topic,
                p.partition_index,
            )
            p.error_code = int(ErrorCode.kafka_storage_error)
            p.records = None
            part = self.broker.partition_manager.get(
                kafka_ntp(topic, p.partition_index)
            )
            if part is not None:
                part.log.drop_wire_cache()

    @staticmethod
    def _finish_session_fetch(session, responses, incremental):
        """Record what each partition was answered with; incremental
        responses then carry only partitions with NEWS — records, an
        error, or hw/lso/log-start movement (fetch_session.h
        fetch_partition cached-state comparison)."""
        out = []
        for t in responses:
            keep = []
            for p in t.partitions:
                sp = session.partitions.get((t.topic, p.partition_index))
                changed = (
                    sp is None
                    or p.records
                    or p.error_code != 0
                    # a KIP-392 redirect is always news: suppressing it
                    # strands a sessioned rack consumer on instant
                    # empty responses with no preferred replica
                    or getattr(p, "preferred_read_replica", -1) >= 0
                    or sp.last_hw != p.high_watermark
                    or sp.last_lso != p.last_stable_offset
                    or sp.last_start != p.log_start_offset
                )
                if sp is not None:
                    sp.last_hw = p.high_watermark
                    sp.last_lso = p.last_stable_offset
                    sp.last_start = p.log_start_offset
                if changed or not incremental:
                    keep.append(p)
            if keep:
                out.append(Msg(topic=t.topic, partitions=keep))
        return out

    async def handle_list_offsets(self, hdr: RequestHeader, req: Msg) -> Msg:
        out = []
        for t in req.topics:
            parts = []
            topic_ok = self.authorize(
                AclOperation.describe, AclResourceType.topic, t.name
            )
            for p in t.partitions:
                if not topic_ok:
                    parts.append(
                        Msg(
                            partition_index=p.partition_index,
                            error_code=int(
                                ErrorCode.topic_authorization_failed
                            ),
                            old_style_offsets=[],
                            timestamp=-1,
                            offset=-1,
                        )
                    )
                    continue
                ntp = kafka_ntp(t.name, p.partition_index)
                partition = self.broker.partition_manager.get(ntp)
                if partition is None and self.broker.shard_router is not None:
                    shard = self.broker.shard_table.shard_for(ntp)
                    if shard:
                        try:
                            if not self.broker.shard_table.is_available(
                                shard
                            ):
                                # crash/restart window: retriable, no
                                # invoke into the dead channel
                                raise InvokeError(
                                    f"shard {shard} unavailable"
                                )
                            err, off, ts = (
                                await self.broker.shard_router.list_offsets(
                                    shard, ntp, p.timestamp
                                )
                            )
                        except InvokeError:
                            err, off, ts = (
                                int(ErrorCode.not_leader_for_partition),
                                -1,
                                -1,
                            )
                        parts.append(
                            Msg(
                                partition_index=p.partition_index,
                                error_code=err,
                                old_style_offsets=[off] if off >= 0 else [],
                                timestamp=ts,
                                offset=off,
                            )
                        )
                        continue
                if partition is None:
                    parts.append(
                        Msg(
                            partition_index=p.partition_index,
                            error_code=int(ErrorCode.unknown_topic_or_partition),
                            old_style_offsets=[],
                            timestamp=-1,
                            offset=-1,
                        )
                    )
                    continue
                if not partition.is_leader:
                    parts.append(
                        Msg(
                            partition_index=p.partition_index,
                            error_code=int(ErrorCode.not_leader_for_partition),
                            old_style_offsets=[],
                            timestamp=-1,
                            offset=-1,
                        )
                    )
                    continue
                if p.timestamp == -2:  # earliest
                    off, ts = partition.start_offset(), -1
                elif p.timestamp == -1:  # latest
                    off, ts = partition.high_watermark(), -1
                else:
                    q = partition.timequery(p.timestamp)
                    off, ts = (q, p.timestamp) if q is not None else (-1, -1)
                parts.append(
                    Msg(
                        partition_index=p.partition_index,
                        error_code=0,
                        old_style_offsets=[off] if off >= 0 else [],
                        timestamp=ts,
                        offset=off,
                    )
                )
            out.append(Msg(name=t.name, partitions=parts))
        return Msg(throttle_time_ms=0, topics=out)


def _frame_kafka(batch: RecordBatch, kafka_base: int) -> bytes:
    """Kafka wire framing with the translated base offset. The kafka
    body CRC starts at `attributes`, so rewriting base_offset needs no
    payload recompute (replicated_partition offset translation)."""
    if batch.header.base_offset == kafka_base:
        return batch.to_kafka_wire()
    hdr = dataclasses.replace(batch.header, base_offset=kafka_base)
    return RecordBatch(hdr, batch.body).to_kafka_wire()


def fetch_wire_enabled() -> bool:
    """Zero-copy fetch plane gate. RP_FETCH_WIRE=0 stands down to the
    decoded read_kafka + _frame_kafka path, byte-for-byte the pre-wire
    behavior (checked per call, same idiom as file_sanitizer.enabled)."""
    return os.environ.get("RP_FETCH_WIRE", "1") != "0"


def fetch_verify_enabled() -> bool:
    """RP_FETCH_VERIFY=1 opt-in: device-batched CRC verify-on-read,
    one ops/crc32c dispatch per fetch response. Stand-down (default)
    is the trust-append-time behavior."""
    return os.environ.get("RP_FETCH_VERIFY", "0") == "1"


def read_fetch_rows(
    partition, fetch_offset: int, max_bytes: int, upto_kafka: int | None
) -> tuple[bytes, int | None]:
    """One partition's fetch records as (concatenated wire, fetch_end).

    The shared serving seam for the local-leader read_all path and the
    shard-router fetch relay. Wire plane (default): WireSpan rows out
    of Partition.read_kafka_wire, framed by patching the translated
    base offset into the first 8 bytes of each span — no RecordBatch
    is constructed. RP_FETCH_WIRE=0: the decoded path, unchanged.
    fetch_end is the exclusive kafka end offset of the last row (None
    when empty) — the aborted-transaction window bound."""
    if fetch_wire_enabled():
        rows = partition.read_kafka_wire(
            fetch_offset, max_bytes=max_bytes, upto_kafka=upto_kafka
        )
        if not rows:
            return b"", None
        # single-allocation concat: copy each cached span once into the
        # response buffer and stamp the translated base in place — the
        # whole fetch body is ONE copy of the cached bytes (the protocol
        # writer appends buffers without normalizing, so no re-copy)
        total = 0
        for _kbase, row in rows:
            total += len(row.wire)
        out = bytearray(total)
        at = 0
        for kbase, row in rows:
            w = row.wire
            out[at : at + len(w)] = w
            if kbase != row.base_offset:
                pack_wire_base(out, at, kbase)
            at += len(w)
        last_kbase, last = rows[-1]
        return out, last_kbase + (last.last_offset - last.base_offset) + 1
    pairs = partition.read_kafka(
        fetch_offset, max_bytes=max_bytes, upto_kafka=upto_kafka
    )
    if not pairs:
        return b"", None
    wire = b"".join(_frame_kafka(batch, kbase) for kbase, batch in pairs)
    return wire, pairs[-1][0] + pairs[-1][1].header.last_offset_delta + 1
