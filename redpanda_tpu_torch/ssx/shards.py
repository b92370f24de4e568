"""Shard-per-core runtime (reference: seastar ss::sharded<T> / smp).

The reference runs one reactor per core and moves work between them
with `sharded<T>::invoke_on(shard, fn)` (seastar/include/seastar/core/
sharded.hh). CPython cannot do that inside one process — the GIL makes
N asyncio loops in one interpreter time-share a single core — so the
shard here is a forked *process*: same memory image at fork time, own
interpreter and event loop afterwards, pinned to a core with
`os.sched_setaffinity`.

Topology: the parent IS shard 0 (seastar's main thread), shards
1..N-1 are forked children. Every pair of shards shares a pre-fork
AF_UNIX socketpair, so `invoke_on` between any two shards is one hop —
no broker process in the middle. Each message is a serde envelope
(`InvokeRequest`/`InvokeReply`) behind a 4-byte length + 1-byte kind
frame, the same framing discipline as rpc/transport.py; payloads are
themselves serde envelopes (rplint RPL009 — no pickled object graphs
crossing the shard boundary).

Supervision (shard 0 only): a reaper task polls `waitpid(WNOHANG)`
plus a heartbeat deadline (a SIGSTOP'd child is alive to waitpid but
answers nothing — the gray failure only the deadline can see). With
`restart_limit > 0` the default response to an unexpected child exit
is a per-shard in-place restart: only the dead shard is re-forked
over a fresh parent<->child socketpair, siblings keep running, and
their direct legs to the reborn shard are replaced by relay through
shard 0 (`ssx.relay`). The legacy whole-group restart survives as
`restart_mode="all"`. When the limit is exhausted `failed` is set and
`on_crash` fires (wrapped — a throwing hook never kills the reaper).

Elastic lifecycle: `spawn_shard()` forks a new pinned worker at
runtime (single parent<->child socketpair; peer legs relay via shard
0), `retire_shard(sid)` walks the polite-invoke → SIGTERM → SIGKILL
ladder with a per-shard deadline. The higher-level grow/retire
protocol (placement activation, evacuation through the
PartitionMover, on-disk re-adoption) lives in sharded_broker.py's
ShardLifecycle; seeded process-fault injection for every boundary is
ssx/procnemesis.py, installed as `runtime.nemesis`.

Worker start (this package only; the JAX package forks each worker
from the live parent): `start()` forks a *fork server* before anything
else of the runtime, and every worker — at launch, on a crash restart
and on `spawn_shard` — is forked from it, never from shard 0. A CUDA
context does not survive `fork`, and shard 0 initialises CUDA as soon
as it builds its Broker, so a worker forked from shard 0 after that
could not use the card; the fork server is forked before shard 0
touches the card and never touches it itself. The shard's channel
sockets travel to the fork server over SCM_RIGHTS. The fork server
double-forks each worker and shard 0 is a child subreaper
(PR_SET_CHILD_SUBREAPER), so the worker is reparented to shard 0, which
waits on it, signals it and reads its exit status as before. One
mechanism on the CPU and on the card.

Stand-down discipline mirrors the native gates (raft/service.py):
fault-injection layers (file_sanitizer, iofaults) instrument
*in-process* state that a forked shard cannot see, so the runtime
refuses to activate while they are armed, and `RP_SHARDS=0` is the
operator escape hatch.
"""

from __future__ import annotations

import array
import asyncio
import logging
import os
import signal
import socket
import struct
import sys
import traceback
from typing import Awaitable, Callable, Optional

from ..observability import trace
from ..utils.serde import Envelope, bytes_t, string, u8, u16, u64

logger = logging.getLogger("ssx")

# the supervisor's reap loop polls its children this often (s)
REAP_POLL_S = 0.1

# frame: [u32 size][u8 kind][envelope bytes]; size counts kind + envelope
_HDR = struct.Struct("<IB")
_KIND_REQUEST = 0
_KIND_REPLY = 1

# InvokeReply.status
_ST_OK = 0
_ST_APP_ERROR = 1
_ST_NO_SERVICE = 2


class InvokeError(Exception):
    """An invoke_on failed on the remote shard (or the channel died)."""


class InvokeRequest(Envelope):
    # trace_id/span_id/origin: cross-shard trace propagation (PR 6) —
    # trailing fields with defaults so pre-upgrade peers interoperate
    SERDE_FIELDS = [
        ("corr", u64),
        ("service", string),
        ("method", string),
        ("payload", bytes_t),
        ("trace_id", u64),
        ("span_id", u64),
        ("origin", string),
    ]
    SERDE_DEFAULTS = {"trace_id": 0, "span_id": 0, "origin": ""}


class InvokeReply(Envelope):
    SERDE_FIELDS = [
        ("corr", u64),
        ("status", u8),
        ("payload", bytes_t),
    ]


class ShardReady(Envelope):
    SERDE_FIELDS = [("shard", u16), ("pid", u64), ("core", u64)]


class ShardRelay(Envelope):
    """An invoke_on hop relayed through shard 0 when the sender has no
    (live) direct channel to the target — dynamically spawned shards
    and reborn crash-restart shards have a parent leg only."""

    SERDE_FIELDS = [
        ("shard", u16),
        ("service", string),
        ("method", string),
        ("payload", bytes_t),
        ("timeout", u16),  # seconds, saturating
    ]


# ------------------------------------------------------------------ util
# Placement moved to its own layer (PR 12): the deterministic
# group → shard hash lives in placement/table.py and actual routing
# goes through the PlacementTable, which live moves can rebind. The
# v1 `shard_of` deprecation shim is gone (PR 17); rplint RPL017
# forbids reintroducing placement decisions here.


def pin_to_core(shard_id: int) -> Optional[int]:
    """Best-effort affinity pin: shard i takes the i-th available core
    (mod the cpuset — honest on 1-core boxes: every shard shares it)."""
    try:
        avail = sorted(os.sched_getaffinity(0))
        core = avail[shard_id % len(avail)]
        os.sched_setaffinity(0, {core})
        return core
    except (AttributeError, OSError):
        return None


def standdown_reason() -> Optional[str]:
    """Why the shard runtime must NOT activate right now, or None.
    Same discipline as the native-gate stand-down in raft/service.py:
    fault-injection layers hold in-process state a forked shard cannot
    observe, so sharding silently changes their semantics."""
    if os.environ.get("RP_SHARDS", "") == "0":
        return "RP_SHARDS=0"
    from ..storage import file_sanitizer, iofaults

    if file_sanitizer.enabled():
        return "file_sanitizer active"
    if iofaults.active():
        return "iofaults active"
    return None


def reserve_reuse_port(
    host: str = "127.0.0.1", port: int = 0
) -> tuple[socket.socket, int]:
    """Reserve the port that N listeners will share: bind a
    SO_REUSEPORT socket on `port` (0 = ephemeral) and keep it open
    until every shard has bound its own (the kernel refuses cross-uid
    squatting, and the held socket keeps an ephemeral port out of the
    pool meanwhile)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind((host, port))
    return s, s.getsockname()[1]


def bind_reuse_port(host: str, port: int) -> socket.socket:
    """A bound (not yet listening) SO_REUSEPORT socket for one shard's
    listener; pass to loop.create_server(sock=...). The kernel hashes
    the 4-tuple across all sockets bound to (host, port), spreading
    accepted connections over the shards."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind((host, port))
    return s


def _close_inherited_sockets(keep: set[int]) -> None:
    """Fork hygiene for DYNAMIC spawns: the child of a live broker
    inherits every open fd — listeners, established connections,
    sibling channel ends. Sockets are the dangerous ones (a connection
    the parent closes stays half-open until the child's copy dies, so
    peers never see FIN); pipes and files are left alone so pytest's
    capture machinery keeps working."""
    import stat

    try:
        fds = os.listdir("/proc/self/fd")
    except OSError:
        return
    for name in fds:
        try:
            fd = int(name)
        except ValueError:
            continue
        if fd < 3 or fd in keep:
            continue
        try:
            if stat.S_ISSOCK(os.fstat(fd).st_mode):
                os.close(fd)
        except OSError:
            continue


# --------------------------------------------------------- fork server
_PR_SET_CHILD_SUBREAPER = 36
# request: [u16 shard][u16 n_shards][f64 slow_start_s][u16 peer]*, one
# socket fd a peer in SCM_RIGHTS (peer _GATE: the read end of a pipe the
# worker waits on before it starts); reply: [i64 worker pid], or -1 and
# an error text
_FORK_REQ = struct.Struct("<HHd")
_FORK_REPLY = struct.Struct("<q")
_MAX_FDS = 1024
_GATE = 0xFFFF


def _become_subreaper() -> None:
    """Make this process the reaper of its orphaned descendants, so a
    worker the fork server double-forks is reparented here."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(_PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        err = ctypes.get_errno()
        raise OSError(err, f"prctl(PR_SET_CHILD_SUBREAPER): {os.strerror(err)}")


class ForkServer:
    """A process forked from shard 0 before it touches the card, that
    forks the workers on request (see the module docstring). `fork()`
    blocks until the worker exists and is shard 0's child, and returns
    its pid."""

    def __init__(self, body: Callable[[int, int, float, dict, Optional[int]], None]):
        # body(sid, n_shards, slow_start_s, socks, gate) runs in the
        # worker and never returns
        self._body = body
        self.pid: Optional[int] = None
        self._sock: Optional[socket.socket] = None

    def start(self) -> None:
        _become_subreaper()
        a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_SEQPACKET)
        pid = os.fork()
        if pid:
            b.close()
            self.pid, self._sock = pid, a
            return
        # ---- fork server: never returns ----
        status = 1
        try:
            a.close()
            # the parent's loop wakes on its own self-pipe; a signal
            # here must not write to our copy of it
            signal.set_wakeup_fd(-1)
            signal.signal(signal.SIGINT, signal.SIG_IGN)
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            _close_inherited_sockets({b.fileno()})
            self._serve(b)
            status = 0
        except BaseException:
            traceback.print_exc()
        finally:
            os._exit(status)

    def fork(
        self, sid: int, n_shards: int, slow_start_s: float,
        socks: dict[int, socket.socket], gate: Optional[int] = None,
    ) -> int:
        """`gate`: the read end of a pipe; the worker starts once its
        write end is closed."""
        if self._sock is None:
            raise RuntimeError("fork server not running")
        peers = sorted(socks)
        fds = array.array("i", [socks[p].fileno() for p in peers])
        if gate is not None:
            peers.append(_GATE)
            fds.append(gate)
        msg = _FORK_REQ.pack(sid, n_shards, slow_start_s) + struct.pack(
            f"<{len(peers)}H", *peers
        )
        self._sock.sendmsg(
            [msg], [(socket.SOL_SOCKET, socket.SCM_RIGHTS, fds)]
        )
        reply = self._sock.recv(4096)
        if len(reply) < _FORK_REPLY.size:
            raise RuntimeError("fork server closed its channel")
        (pid,) = _FORK_REPLY.unpack_from(reply)
        if pid < 0:
            raise OSError(
                f"fork server: {reply[_FORK_REPLY.size:].decode(errors='replace')}"
            )
        return pid

    def stop(self) -> None:
        """Close the channel (the server exits on EOF) and reap it."""
        sock, self._sock = self._sock, None
        if sock is not None:
            sock.close()
        pid, self.pid = self.pid, None
        if pid is None:
            return
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass

    # -- server side ---------------------------------------------------
    def _serve(self, sock: socket.socket) -> None:
        fd_bytes = _MAX_FDS * array.array("i").itemsize
        while True:
            msg, anc, _flags, _addr = sock.recvmsg(
                65536, socket.CMSG_SPACE(fd_bytes)
            )
            if not msg:
                return  # shard 0 closed the channel
            fds = array.array("i")
            for level, kind, data in anc:
                if level == socket.SOL_SOCKET and kind == socket.SCM_RIGHTS:
                    fds.frombytes(data[: len(data) - len(data) % fds.itemsize])
            sid, n_shards, slow = _FORK_REQ.unpack_from(msg)
            n = (len(msg) - _FORK_REQ.size) // 2
            peers = struct.unpack_from(f"<{n}H", msg, _FORK_REQ.size)
            gate = None
            socks = {}
            for p, fd in zip(peers, fds):
                if p == _GATE:
                    gate = fd
                else:
                    socks[p] = socket.socket(fileno=fd)
            try:
                pid = self._double_fork(sid, n_shards, slow, socks, gate)
                reply = _FORK_REPLY.pack(pid)
            except Exception as e:
                reply = _FORK_REPLY.pack(-1) + repr(e).encode()[:1024]
            finally:
                for s in socks.values():
                    s.close()
                if gate is not None:
                    os.close(gate)
            sock.send(reply)

    def _double_fork(
        self, sid: int, n_shards: int, slow: float,
        socks: dict[int, socket.socket], gate: Optional[int],
    ) -> int:
        r, w = os.pipe()
        mid = os.fork()
        if mid == 0:
            # ---- intermediate: fork the worker, report its pid, exit
            status = 1
            try:
                os.close(r)
                pid = os.fork()
                if pid == 0:
                    os.close(w)
                    self._body(sid, n_shards, slow, socks, gate)
                os.write(w, _FORK_REPLY.pack(pid))
                status = 0
            finally:
                os._exit(status)
        os.close(w)
        try:
            data = os.read(r, _FORK_REPLY.size)
        finally:
            os.close(r)
        # once the intermediate is reaped, its orphan is shard 0's child
        os.waitpid(mid, 0)
        if len(data) != _FORK_REPLY.size:
            raise RuntimeError(f"worker fork for shard {sid} failed")
        return _FORK_REPLY.unpack(data)[0]


# ------------------------------------------------------------- channel
class ShardChannel:
    """Full-duplex correlation-multiplexed stream over one socketpair
    end — both sides initiate requests and serve the peer's (the
    symmetric sibling of rpc/transport.py's client-only TcpTransport).
    Replies may arrive out of request order; the correlation id pairs
    them back up."""

    def __init__(
        self, sock: socket.socket, dispatch, label: str = "", origin: str = ""
    ):
        self._sock = sock
        self._dispatch = dispatch  # async (InvokeRequest) -> bytes
        self.label = label
        # precomputed sender identity stamped into propagated trace
        # contexts (never built per request)
        self.origin = origin
        self._corr = 0
        self._pending: dict[int, asyncio.Future] = {}
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._task: Optional[asyncio.Future] = None
        self._closed = False
        # set once the read loop exits: the peer is gone and every
        # future call would fail — callers may fall back to relaying
        self.dead = False

    async def open(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            sock=self._sock, limit=1 << 21
        )
        self._task = asyncio.ensure_future(self._read_loop())

    async def call(
        self, service: str, method: str, payload: bytes, timeout: float = 30.0
    ) -> bytes:
        if self._closed:
            raise InvokeError(f"channel {self.label} closed")
        self._corr += 1
        corr = self._corr
        fut = asyncio.get_event_loop().create_future()
        self._pending[corr] = fut
        tctx = trace.propagation_ctx()
        trace_id, span_id = tctx if tctx is not None else (0, 0)
        env = InvokeRequest(
            corr=corr,
            service=service,
            method=method,
            payload=payload,
            trace_id=trace_id,
            span_id=span_id,
            origin=self.origin if trace_id else "",
        ).encode()
        try:
            self._send(_KIND_REQUEST, env)
            await self._writer.drain()
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            raise InvokeError(
                f"invoke_on timeout ({self.label} {service}.{method})"
            ) from None
        except (ConnectionError, OSError, RuntimeError) as e:
            raise InvokeError(
                f"invoke_on failed ({self.label} {service}.{method}): {e}"
            ) from None
        finally:
            self._pending.pop(corr, None)

    def _send(self, kind: int, env: bytes) -> None:
        # one write() per frame keeps concurrent senders interleave-free
        self._writer.write(_HDR.pack(len(env) + 1, kind) + env)

    async def _serve(self, req: InvokeRequest) -> None:
        try:
            result = await self._dispatch(req)
            status, payload = _ST_OK, (result if result is not None else b"")
        except LookupError as e:
            status, payload = _ST_NO_SERVICE, str(e).encode()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            status = _ST_APP_ERROR
            payload = f"{type(e).__name__}: {e}".encode()
        if self._closed:
            return
        try:
            self._send(
                _KIND_REPLY,
                InvokeReply(
                    corr=req.corr, status=status, payload=payload
                ).encode(),
            )
            await self._writer.drain()
        except (ConnectionError, RuntimeError):
            pass  # peer went away; its caller sees the channel failure

    async def _read_loop(self) -> None:
        try:
            while True:
                hdr = await self._reader.readexactly(_HDR.size)
                size, kind = _HDR.unpack(hdr)
                body = await self._reader.readexactly(size - 1)
                if kind == _KIND_REQUEST:
                    req = InvokeRequest.decode(body)
                    asyncio.ensure_future(self._serve(req))
                else:
                    rep = InvokeReply.decode(body)
                    fut = self._pending.pop(rep.corr, None)
                    if fut is None or fut.done():
                        continue
                    if rep.status == _ST_OK:
                        fut.set_result(bytes(rep.payload))
                    else:
                        fut.set_exception(
                            InvokeError(rep.payload.decode(errors="replace"))
                        )
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            asyncio.CancelledError,
            OSError,
        ):
            pass
        finally:
            self.dead = True
            self._fail_pending("peer channel closed")

    def _fail_pending(self, why: str) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(InvokeError(f"{self.label}: {why}"))
        self._pending.clear()

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
        self._fail_pending("channel closed")


# ------------------------------------------------------------- context
class ShardContext:
    """What a shard sees: its id, channels to every sibling, and the
    service registry this shard exposes to invoke_on (the local half
    of `ss::sharded<T>`)."""

    def __init__(self, shard_id: int, n_shards: int):
        self.shard_id = shard_id
        self.n_shards = n_shards
        self.core: Optional[int] = None
        self._services: dict[str, Callable[[str, bytes], Awaitable[bytes]]] = {}
        self._channels: dict[int, ShardChannel] = {}
        self.shutdown = asyncio.Event()
        # flight recorder for spans opened on the invoke_on serving path
        # (the broker embedding assigns its own; None = module default)
        self.recorder = None

    def register(
        self, service: str, handler: Callable[[str, bytes], Awaitable[bytes]]
    ) -> None:
        self._services[service] = handler

    async def dispatch(self, service: str, method: str, payload: bytes) -> bytes:
        h = self._services.get(service)
        if h is None:
            raise LookupError(
                f"shard {self.shard_id}: no such service {service!r}"
            )
        return await h(method, payload)

    async def dispatch_request(self, req: InvokeRequest) -> bytes:
        """Serve one remote invoke. When the sender propagated a trace
        context, the handler runs under an `ssx.dispatch` root span that
        joins the sender's trace (stitched by trace_id at dump time)."""
        if req.trace_id and trace.ENABLED:
            token = trace.set_remote_parent(
                req.trace_id, req.span_id, req.origin
            )
            try:
                with trace.span(
                    "ssx.dispatch",
                    recorder=self.recorder,
                    service=req.service,
                    method=req.method,
                ):
                    return await self.dispatch(
                        req.service, req.method, bytes(req.payload)
                    )
            finally:
                trace.reset_remote_parent(token)
        return await self.dispatch(req.service, req.method, bytes(req.payload))

    async def invoke_on(
        self,
        shard: int,
        service: str,
        method: str,
        payload: bytes = b"",
        timeout: float = 30.0,
    ) -> bytes:
        """The `ss::sharded<T>::invoke_on` analog. Local shard runs the
        handler inline (no serialization round-trip, matching seastar's
        same-shard fast path); remote goes over the socketpair. A
        missing or dead peer leg falls back to relaying through shard 0
        (`ssx.relay`) — dynamically spawned and crash-restarted shards
        only ever hold a parent leg, and a sibling's leg to a reborn
        shard died with the old process."""
        if shard == self.shard_id:
            return await self.dispatch(service, method, payload)
        ch = self._channels.get(shard)
        if ch is None or ch.dead:
            zero = self._channels.get(0)
            if shard != 0 and self.shard_id != 0 and zero is not None:
                env = ShardRelay(
                    shard=shard,
                    service=service,
                    method=method,
                    payload=payload,
                    timeout=min(int(timeout) or 1, (1 << 16) - 1),
                ).encode()
                return await zero.call("ssx", "relay", env, timeout)
            raise InvokeError(
                f"shard {self.shard_id}: no channel to shard {shard}"
            )
        return await ch.call(service, method, payload, timeout)

    async def _close_channels(self) -> None:
        for ch in self._channels.values():
            await ch.close()
        self._channels.clear()


# ------------------------------------------------------------- runtime
class ShardRuntime:
    """Fork-and-supervise shard group; the constructing process is
    shard 0. `child_main(ctx)` runs once in every child after the fork
    (fresh event loop, core pinned, channels open): it registers the
    shard's services and may return an async cleanup callable invoked
    at shutdown. The child signals readiness only after child_main
    returns, so `start()` completing means every shard is serving."""

    PARENT_SHARD = 0

    def __init__(
        self,
        n_shards: int,
        child_main: Callable[[ShardContext], Awaitable],
        *,
        restart_limit: int = 0,
        restart_mode: str = "shard",
        ready_timeout: float = 30.0,
        shutdown_timeout: float = 8.0,
        heartbeat_interval: float = 0.5,
        heartbeat_deadline: float = 0.0,
    ):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if restart_mode not in ("shard", "all"):
            raise ValueError(f"restart_mode {restart_mode!r}")
        self.n_shards = n_shards
        self._child_main = child_main
        self._restart_limit = restart_limit
        self._restart_mode = restart_mode
        self._ready_timeout = ready_timeout
        self._shutdown_timeout = shutdown_timeout
        # gray-failure detection: a child that waitpid reports alive
        # but that misses `heartbeat_deadline` seconds of pings (e.g.
        # SIGSTOP'd) is declared dead and SIGKILLed so the normal
        # restart path takes over. 0 disables the heartbeat.
        self._hb_interval = heartbeat_interval
        self._hb_deadline = heartbeat_deadline

        self.ctx: Optional[ShardContext] = None
        self.failed = asyncio.Event()
        self.crashed: dict[int, int] = {}  # shard -> last wait status
        self.restarts = 0
        self.shard_restarts: dict[int, int] = {}  # per-shard restarts
        self.gray_failures: dict[int, int] = {}  # heartbeat kills
        self.restart_ms: list[float] = []  # crash -> serving again
        self.spawns = 0
        self.retired: set[int] = set()
        self.shard_pids: dict[int, int] = {}
        self.shard_cores: dict[int, Optional[int]] = {}
        # on_crash(shard_id, status): escalation hook (sync or async),
        # fired when a dead shard will NOT be restarted
        self.on_crash = None
        # on_restart(runtime): fired after any successful restart
        self.on_restart = None
        # per-shard restart seams for the broker embedding:
        # on_shard_down(sid, status) right after the death is noticed,
        # on_shard_up(sid) once the reborn shard answered ready
        self.on_shard_down = None
        self.on_shard_up = None
        # seeded process-fault injection (ssx/procnemesis.py)
        self.nemesis = None

        self._pairs: dict[tuple[int, int], tuple[socket.socket, socket.socket]] = {}
        self._ready_futs: dict[int, asyncio.Future] = {}
        self._reaper: Optional[asyncio.Future] = None
        self._stopping = False
        self._started = False
        self._retiring: set[int] = set()
        self._spawning: set[int] = set()
        self._next_sid = n_shards
        self._hb_last: dict[int, float] = {}
        self._hb_inflight: set[int] = set()
        self._hb_pass: Optional[float] = None  # the last heartbeat pass
        # services registered before start() land on the parent ctx
        self._pre_services: dict[str, Callable] = {}
        # every worker is forked from here (module docstring)
        self.fork_server: Optional[ForkServer] = None

    # -- parent-side service registry (usable before start) ----------
    def register(self, service: str, handler) -> None:
        if self.ctx is not None:
            self.ctx.register(service, handler)
        else:
            self._pre_services[service] = handler

    async def invoke_on(
        self,
        shard: int,
        service: str,
        method: str,
        payload: bytes = b"",
        timeout: float = 30.0,
    ) -> bytes:
        assert self.ctx is not None, "runtime not started"
        return await self.ctx.invoke_on(shard, service, method, payload, timeout)

    # -- lifecycle ----------------------------------------------------
    async def start(self) -> None:
        if self._started:
            raise RuntimeError("ShardRuntime already started")
        reason = standdown_reason()
        if reason is not None:
            raise RuntimeError(f"shard runtime stand-down: {reason}")
        self._started = True
        self.fork_server = ForkServer(self._worker_main)
        self.fork_server.start()
        try:
            await self._launch()
        except BaseException:
            self.fork_server.stop()
            self._started = False
            raise
        self._reaper = asyncio.ensure_future(self._reap_loop())

    async def _launch(self) -> None:
        n = self.n_shards
        self.ctx = ShardContext(self.PARENT_SHARD, n)
        for name, h in self._pre_services.items():
            self.ctx.register(name, h)
        self.ctx.register("ssx", self._parent_ssx)
        loop = asyncio.get_event_loop()
        self._ready_futs = {
            sid: loop.create_future() for sid in range(1, n)
        }
        # full mesh, created BEFORE any fork so every child inherits
        # the ends it needs and closes the rest
        self._pairs = {
            (i, j): socket.socketpair()
            for i in range(n)
            for j in range(i + 1, n)
        }
        for sid in range(1, n):
            self.shard_pids[sid] = self._fork_child(sid)
        # parent keeps its own ends, closes everything else
        for (i, j), (a, b) in self._pairs.items():
            if i == self.PARENT_SHARD:
                b.close()
            else:
                a.close()
                b.close()
        for (i, j), (a, b) in list(self._pairs.items()):
            if i != self.PARENT_SHARD:
                continue
            ch = ShardChannel(
                a, self.ctx.dispatch_request, label=f"0<->{j}", origin="shard0"
            )
            await ch.open()
            self.ctx._channels[j] = ch
        if self._ready_futs:
            try:
                await asyncio.wait_for(
                    asyncio.gather(*self._ready_futs.values()),
                    self._ready_timeout,
                )
            except asyncio.TimeoutError:
                missing = [
                    sid for sid, f in self._ready_futs.items() if not f.done()
                ]
                await self._kill_all()
                raise RuntimeError(
                    f"shards {missing} not ready within "
                    f"{self._ready_timeout}s"
                ) from None
        now = loop.time()
        for sid in range(1, n):
            self._hb_last[sid] = now
        logger.info(
            "shard runtime up: %d shards, pids=%s cores=%s",
            n,
            self.shard_pids,
            self.shard_cores,
        )

    async def _parent_ssx(self, method: str, payload: bytes) -> bytes:
        if method == "ready":
            r = ShardReady.decode(payload)
            self.shard_cores[r.shard] = r.core if r.core != (1 << 63) else None
            fut = self._ready_futs.get(r.shard)
            if fut is not None and not fut.done():
                fut.set_result(None)
            return b""
        if method == "ping":
            return payload
        if method == "relay":
            # worker -> worker hop brokered through shard 0: the
            # sender has no live direct leg to the target
            req = ShardRelay.decode(payload)
            return await self.ctx.invoke_on(
                int(req.shard),
                req.service,
                req.method,
                bytes(req.payload),
                timeout=float(req.timeout),
            )
        raise LookupError(f"ssx: no such method {method!r}")

    def _fork_child(
        self,
        sid: int,
        socks: Optional[dict[int, socket.socket]] = None,
        slow_start_s: float = 0.0,
        gate: Optional[int] = None,
    ) -> int:
        """Fork one worker through the fork server. `socks=None` is the
        launch path (the child's channel ends are its ends of the full
        mesh in `self._pairs`); a dict is the dynamic-spawn path. The
        worker keeps exactly those peer sockets and no other socket fd
        (listeners, sibling channels — keeping them open would mask
        EOFs fleet-wide)."""
        if socks is None:
            socks = {}
            for (i, j), (a, b) in self._pairs.items():
                if i == sid:
                    socks[j] = a
                elif j == sid:
                    socks[i] = b
        return self.fork_server.fork(
            sid, max(self.n_shards, sid + 1), slow_start_s, socks, gate
        )

    def _worker_main(
        self,
        sid: int,
        n_shards: int,
        slow_start_s: float,
        socks: dict[int, socket.socket],
        gate: Optional[int],
    ) -> None:
        """A worker's body, in the process the fork server forked for
        it (`self` is the fork server's copy, made before shard 0 built
        anything but its config)."""
        status = 1
        try:
            if gate is not None:
                os.read(gate, 1)  # EOF: shard 0 let this worker start
                os.close(gate)
            _close_inherited_sockets({s.fileno() for s in socks.values()})
            signal.signal(signal.SIGINT, signal.default_int_handler)
            torch = sys.modules.get("torch")
            if torch is not None:
                # an OpenMP pool that ran before a fork hangs the
                # child's first parallel op; a shard is pinned to one
                # core, so it runs one intra-op thread
                torch.set_num_threads(1)
            self.n_shards = n_shards
            core = pin_to_core(sid)
            if slow_start_s > 0:
                # procnemesis slow_start: stall before the event loop
                # (and so the ready handshake) comes up
                import time as _time

                _time.sleep(slow_start_s)
            # the forked thread-state still marks the parent's loop as
            # running; clear it so a fresh loop can run here
            asyncio.events._set_running_loop(None)
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            loop.run_until_complete(self._child_body(sid, core, socks))
            status = 0
        except BaseException:
            traceback.print_exc()
        finally:
            # NEVER unwind into the parent's stack/atexit machinery
            os._exit(status)

    async def _child_body(
        self, sid: int, core: Optional[int], socks: dict[int, socket.socket]
    ) -> None:
        ctx = ShardContext(sid, max(self.n_shards, sid + 1))
        ctx.core = core

        async def _ssx(method: str, payload: bytes) -> bytes:
            if method == "ping":
                return payload
            if method == "shutdown":
                ctx.shutdown.set()
                return b""
            raise LookupError(f"ssx: no such method {method!r}")

        ctx.register("ssx", _ssx)
        for peer in sorted(socks):
            ch = ShardChannel(
                socks[peer],
                ctx.dispatch_request,
                label=f"{sid}<->{peer}",
                origin=f"shard{sid}",
            )
            await ch.open()
            ctx._channels[peer] = ch
        cleanup = await self._child_main(ctx)
        await ctx.invoke_on(
            0,
            "ssx",
            "ready",
            ShardReady(
                shard=sid,
                pid=os.getpid(),
                core=core if core is not None else (1 << 63),
            ).encode(),
        )
        await ctx.shutdown.wait()
        if cleanup is not None:
            try:
                await cleanup()
            except Exception:
                traceback.print_exc()
        await ctx._close_channels()

    # -- elastic lifecycle --------------------------------------------
    def _nemesis_act(self, event: str, sid: int, pid: Optional[int] = None):
        """Consult the installed ProcSchedule at one operation
        boundary and apply the firing's process action. `fork_fail`
        raises ForkFailInjected; `slow_start` rules are returned for
        the caller to thread into the fork; kill/pause act on the
        shard's pid right here. All RNG draws happen synchronously
        (the trace is a pure function of seed + boundary sequence)."""
        sched = self.nemesis
        if sched is None:
            return None
        rule = sched.act(sid, event)
        if rule is None:
            return None
        from .procnemesis import ForkFailInjected

        if rule.action == "fork_fail":
            raise ForkFailInjected(
                f"injected fork failure at {event} (shard {sid})"
            )
        if rule.action == "slow_start":
            return rule
        if pid is None:
            pid = self.shard_pids.get(sid)
        if pid is None:
            return rule
        if rule.action == "kill":
            logger.warning(
                "procnemesis: SIGKILL shard %d (pid %d) at %s",
                sid, pid, event,
            )
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        elif rule.action == "pause":
            dur = rule.pause_s + sched.effect_jitter(rule)
            logger.warning(
                "procnemesis: SIGSTOP shard %d (pid %d) at %s for %.3fs",
                sid, pid, event, dur,
            )
            try:
                os.kill(pid, signal.SIGSTOP)
            except ProcessLookupError:
                return rule

            def _cont(p=pid):
                try:
                    os.kill(p, signal.SIGCONT)
                except (ProcessLookupError, PermissionError):
                    pass

            asyncio.get_event_loop().call_later(dur, _cont)
        return rule

    async def spawn_shard(self, sid: Optional[int] = None) -> int:
        """Fork one NEW pinned worker into the running group and mesh
        it in: the parent brokers a fresh socketpair leg; peer-to-peer
        invokes reach the new shard by relaying through shard 0.
        Returns the shard id. On any failure (fork-fail injection,
        killed mid-handshake, ready timeout) the partial spawn is
        reaped — no orphan process, no channel, no pid entry."""
        if not self._started:
            raise RuntimeError("runtime not started")
        if sid is None:
            sid = self._next_sid
        if sid == 0 or sid in self.shard_pids:
            raise ValueError(f"shard {sid} already exists")
        slow = 0.0
        rule = self._nemesis_act("spawn.fork", sid)
        if rule is not None and rule.action == "slow_start":
            slow = rule.delay_s + self.nemesis.effect_jitter(rule)
        await self._spawn(sid, slow_start_s=slow)
        self._next_sid = max(self._next_sid, sid + 1)
        self.n_shards = max(self.n_shards, sid + 1)
        if self.ctx is not None:
            self.ctx.n_shards = self.n_shards
        self.spawns += 1
        self.retired.discard(sid)
        return sid

    async def _spawn(self, sid: int, *, slow_start_s: float = 0.0) -> None:
        """Fork + channel + ready handshake for one shard (grow and
        in-place restart share this). The caller owns placement-level
        bookkeeping; failure cleans up the partial spawn and raises."""
        loop = asyncio.get_event_loop()
        self._spawning.add(sid)
        try:
            fut = self._ready_futs[sid] = loop.create_future()
            a, b = socket.socketpair()
            # the worker waits at its gate until shard 0 has passed the
            # spawn.forked boundary, as a child of a plain fork would
            # still be starting there
            gate_r, gate_w = os.pipe()
            try:
                pid = self._fork_child(
                    sid, socks={0: b}, slow_start_s=slow_start_s,
                    gate=gate_r,
                )
            except BaseException:
                os.close(gate_w)
                raise
            finally:
                os.close(gate_r)
            b.close()
            self.shard_pids[sid] = pid
            old = self.ctx._channels.pop(sid, None)
            if old is not None:
                await old.close()
            ch = ShardChannel(
                a, self.ctx.dispatch_request, label=f"0<->{sid}",
                origin="shard0",
            )
            await ch.open()
            self.ctx._channels[sid] = ch
            try:
                self._nemesis_act("spawn.forked", sid, pid=pid)
            finally:
                os.close(gate_w)
            deadline = loop.time() + self._ready_timeout
            while not fut.done():
                if loop.time() >= deadline:
                    await self._abort_spawn(sid)
                    raise RuntimeError(
                        f"shard {sid} not ready within "
                        f"{self._ready_timeout}s"
                    )
                try:
                    wpid, st = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    wpid, st = pid, -1
                if wpid:
                    # died mid-handshake (e.g. an injected SIGKILL):
                    # the pid is already reaped, just unwind the rest
                    self.shard_pids.pop(sid, None)
                    await self._abort_spawn(sid)
                    raise RuntimeError(
                        f"shard {sid} died during spawn (status {st})"
                    )
                await asyncio.sleep(0.02)
            self._hb_last[sid] = loop.time()
            logger.info(
                "shard %d spawned (pid %d, core %s)",
                sid, pid, self.shard_cores.get(sid),
            )
        finally:
            self._spawning.discard(sid)
            self._ready_futs.pop(sid, None)

    async def _abort_spawn(self, sid: int) -> None:
        """Unwind a failed spawn: close the channel, kill + reap the
        child if it is still around. Leaves zero trace of the shard."""
        ch = self.ctx._channels.pop(sid, None)
        if ch is not None:
            await ch.close()
        pid = self.shard_pids.pop(sid, None)
        self._hb_last.pop(sid, None)
        if pid is None:
            return
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        for _ in range(100):
            try:
                wpid, _st = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                return
            if wpid:
                return
            await asyncio.sleep(0.02)
        logger.error("aborted spawn of shard %d: pid %d unreaped", sid, pid)

    def begin_retire(self, sid: int) -> None:
        """Mark a shard's upcoming exit as expected so the reaper does
        not treat the retire ladder's kill as a crash."""
        self._retiring.add(sid)

    def abort_retire(self, sid: int) -> None:
        self._retiring.discard(sid)

    async def retire_shard(self, sid: int) -> None:
        """Process-level retire: polite shutdown invoke, then the
        SIGTERM -> SIGKILL ladder with the per-shard deadline. The
        data plane must already be drained (ShardLifecycle evacuates
        through the PartitionMover before calling this)."""
        if sid == 0:
            raise ValueError("cannot retire shard 0 (the parent)")
        self._retiring.add(sid)
        try:
            if sid in self.shard_pids:
                await self._stop_one(sid)
        finally:
            self._retiring.discard(sid)
        self.retired.add(sid)
        self.shard_cores.pop(sid, None)
        self._hb_last.pop(sid, None)
        self.crashed.pop(sid, None)
        if self.ctx is not None:
            ch = self.ctx._channels.pop(sid, None)
            if ch is not None:
                await ch.close()
        logger.info("shard %d retired", sid)

    # -- supervision --------------------------------------------------
    async def _run_hook(self, hook, *args) -> None:
        """Supervisor hooks are advisory: a throwing hook is logged,
        never allowed to kill the reap loop."""
        if hook is None:
            return
        try:
            res = hook(*args)
            if asyncio.iscoroutine(res):
                await res
        except Exception:
            logger.exception(
                "shard hook %s failed",
                getattr(hook, "__qualname__", repr(hook)),
            )

    async def _reap_loop(self) -> None:
        loop = asyncio.get_event_loop()
        hb_next = loop.time() + self._hb_interval
        while True:
            await asyncio.sleep(REAP_POLL_S)
            now = loop.time()
            if (
                self._hb_deadline > 0
                and not self._stopping
                and now >= hb_next
            ):
                hb_next = now + self._hb_interval
                self._heartbeat(now)
            dead: list[tuple[int, int]] = []
            for sid, pid in list(self.shard_pids.items()):
                if sid in self._retiring or sid in self._spawning:
                    continue
                try:
                    wpid, st = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    wpid, st = pid, -1
                if wpid == 0:
                    continue
                del self.shard_pids[sid]
                dead.append((sid, st))
            if not dead or self._stopping:
                continue
            for sid, st in dead:
                self.crashed[sid] = st
                logger.error(
                    "shard %d crashed (wait status %d)", sid, st
                )
            if self._restart_mode == "all":
                if self._restart_limit > self.restarts:
                    self.restarts += 1
                    try:
                        await self._restart_all()
                        await self._run_hook(self.on_restart, self)
                        continue
                    except Exception:
                        logger.exception("shard group restart failed")
                self.failed.set()
                for sid, st in dead:
                    await self._run_hook(self.on_crash, sid, st)
                # hardened: keep supervising the survivors
                continue
            for sid, st in dead:
                await self._handle_dead_shard(sid, st)

    def _heartbeat(self, now: float) -> None:
        """Gray-failure detection: waitpid cannot see a SIGSTOP'd (or
        wedged) child — only a missed ping deadline can. A shard past
        the deadline is SIGKILLed; the normal waitpid path then drives
        the per-shard restart. A pass that comes late (shard 0's loop
        stalled, or a restart's hooks held the reap loop) credits every
        shard with the lateness: no ping went out in that time, so no
        answer could come back."""
        prev, self._hb_pass = self._hb_pass, now
        late = now - prev - self._hb_interval - REAP_POLL_S if prev is not None else 0.0
        if late > 0:
            for sid, last in self._hb_last.items():
                self._hb_last[sid] = min(now, last + late)
        for sid in list(self.shard_pids):
            if sid in self._retiring or sid in self._spawning:
                continue
            self._hb_last.setdefault(sid, now)
            if sid not in self._hb_inflight:
                self._hb_inflight.add(sid)
                asyncio.ensure_future(self._hb_ping(sid))
            if now - self._hb_last[sid] > self._hb_deadline:
                pid = self.shard_pids.get(sid)
                if pid is None:
                    continue
                self.gray_failures[sid] = self.gray_failures.get(sid, 0) + 1
                logger.error(
                    "shard %d (pid %d) missed the heartbeat deadline "
                    "(%.1fs): gray failure, escalating to SIGKILL",
                    sid, pid, self._hb_deadline,
                )
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                self._hb_last[sid] = now  # one escalation per deadline

    async def _hb_ping(self, sid: int) -> None:
        try:
            await self.ctx.invoke_on(
                sid, "ssx", "ping", b"hb",
                timeout=max(self._hb_deadline, 1.0),
            )
            self._hb_last[sid] = asyncio.get_event_loop().time()
        except (InvokeError, RuntimeError, AttributeError):
            pass
        finally:
            self._hb_inflight.discard(sid)

    async def _handle_dead_shard(self, sid: int, st: int) -> None:
        """Per-shard in-place restart (the default crash response):
        re-fork ONLY the dead shard; siblings keep serving. The broker
        seams run around the respawn — on_shard_down marks the shard's
        groups unavailable, on_shard_up re-adopts from disk."""
        loop = asyncio.get_event_loop()
        t0 = loop.time()
        if self.ctx is not None:
            ch = self.ctx._channels.pop(sid, None)
            if ch is not None:
                await ch.close()
        await self._run_hook(self.on_shard_down, sid, st)
        while self._restart_limit > self.restarts:
            self.restarts += 1
            self.shard_restarts[sid] = self.shard_restarts.get(sid, 0) + 1
            try:
                self._nemesis_act("restart.fork", sid)
                await self._spawn(sid)
            except Exception:
                logger.exception("shard %d in-place restart failed", sid)
                if sid in self._retiring or sid in self.retired:
                    # a retire took the shard over mid-restart (its
                    # stop reaped the reborn worker): not a crash
                    return
                continue
            await self._run_hook(self.on_shard_up, sid)
            self.restart_ms.append((loop.time() - t0) * 1e3)
            logger.warning(
                "shard %d restarted in place (pid %d, %d/%d restarts)",
                sid, self.shard_pids.get(sid, -1),
                self.restarts, self._restart_limit,
            )
            await self._run_hook(self.on_restart, self)
            return
        self.failed.set()
        await self._run_hook(self.on_crash, sid, st)

    async def _restart_all(self) -> None:
        """Restart policy: tear down the whole shard group and re-fork
        it (crash-only restart — every shard rebuilds via child_main)."""
        logger.warning(
            "restarting shard group (%d/%d)", self.restarts, self._restart_limit
        )
        await self._kill_all()
        if self.ctx is not None:
            await self.ctx._close_channels()
        await self._launch()

    async def _kill_all(self) -> None:
        for sid, pid in list(self.shard_pids.items()):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        await self._wait_children(2.0)
        self.shard_pids.clear()

    async def _wait_children(self, timeout: float) -> bool:
        deadline = asyncio.get_event_loop().time() + timeout
        while self.shard_pids:
            for sid, pid in list(self.shard_pids.items()):
                try:
                    wpid, _ = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    wpid = pid
                if wpid:
                    del self.shard_pids[sid]
            if not self.shard_pids:
                return True
            if asyncio.get_event_loop().time() >= deadline:
                return False
            await asyncio.sleep(0.05)
        return True

    async def _wait_child(self, sid: int, timeout: float) -> bool:
        """Poll ONE child for exit; reap and drop its pid on success."""
        pid = self.shard_pids.get(sid)
        if pid is None:
            return True
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            try:
                wpid, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                wpid = pid
            if wpid:
                self.shard_pids.pop(sid, None)
                return True
            if asyncio.get_event_loop().time() >= deadline:
                return False
            await asyncio.sleep(0.05)

    async def _stop_one(self, sid: int) -> None:
        """Polite invoke -> SIGTERM -> SIGKILL ladder for ONE shard,
        each rung bounded by its own deadline, so a wedged child only
        burns its own budget — it cannot stall its siblings' shutdown
        (the old ladder shared one global deadline across the group)."""
        if self.ctx is not None and sid in self.ctx._channels:
            try:
                await self.ctx.invoke_on(sid, "ssx", "shutdown", b"", timeout=2.0)
            except (InvokeError, RuntimeError):
                pass
        if await self._wait_child(sid, self._shutdown_timeout):
            return
        pid = self.shard_pids.get(sid)
        if pid is not None:
            logger.warning("shard %d ignored shutdown; SIGTERM pid %d", sid, pid)
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        if await self._wait_child(sid, 2.0):
            return
        pid = self.shard_pids.get(sid)
        if pid is not None:
            logger.warning("shard %d ignored SIGTERM; SIGKILL pid %d", sid, pid)
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        await self._wait_child(sid, 2.0)

    async def stop(self) -> None:
        """Clean shutdown: the polite -> SIGTERM -> SIGKILL ladder runs
        per shard with per-shard deadlines, all shards concurrently."""
        if not self._started:
            return
        self._stopping = True
        if self._reaper is not None:
            self._reaper.cancel()
            try:
                await self._reaper
            except (asyncio.CancelledError, Exception):
                pass
        await asyncio.gather(
            *(self._stop_one(sid) for sid in list(self.shard_pids)),
            return_exceptions=True,
        )
        if self.ctx is not None:
            await self.ctx._close_channels()
        if self.fork_server is not None:
            self.fork_server.stop()
        self._started = False
