"""Distributed self-test framework.

Reference: src/v/cluster/self_test_{frontend,backend}.{h,cc} +
src/v/cluster/self_test/{diskcheck,netcheck}.{h,cc} — an operator
starts a cluster-wide disk/network benchmark via the admin API; the
frontend fans the request to every node's backend over internal RPC,
each backend runs the checks asynchronously (one test at a time,
cancellable), and status polls aggregate per-node reports.

Netcheck measures real internal-RPC throughput: the client streams
payload frames at a peer's sink method and reports MB/s plus RTT
percentiles, mirroring the reference's pairwise network benchmark.
"""

from __future__ import annotations

import asyncio
import logging
import os
import secrets
import time
from typing import Callable, Optional

from ..rpc.server import Service, method
from ..utils import serde

logger = logging.getLogger("cluster.self_test")

SELF_TEST_START = 240
SELF_TEST_STOP = 241
SELF_TEST_STATUS = 242
SELF_TEST_NETSINK = 243

NET_FRAME = 64 << 10


class _StartReq(serde.Envelope):
    SERDE_FIELDS = [
        ("test_id", serde.string),
        ("disk_mb", serde.i32),
        ("net_mb", serde.i32),
    ]


class _Ack(serde.Envelope):
    SERDE_FIELDS = [("ok", serde.i8), ("error", serde.string)]


class _StatusReply(serde.Envelope):
    SERDE_FIELDS = [
        ("node_id", serde.i32),
        ("status", serde.string),  # idle | running
        ("test_id", serde.string),
        ("report_json", serde.string),
    ]


class SelfTestBackend:
    """Per-node test runner (self_test_backend.cc): at most one test
    in flight; a new start while running is rejected; stop cancels."""

    def __init__(
        self,
        node_id: int,
        data_dir: str,
        send: Callable,  # async (node, method, payload, timeout) -> bytes
        peers: Callable[[], list[int]],
    ):
        self.node_id = node_id
        self.data_dir = data_dir
        self._send = send
        self._peers = peers
        self._task: Optional[asyncio.Task] = None
        self.test_id = ""
        self.report: dict = {}

    @property
    def status(self) -> str:
        return (
            "running" if self._task is not None and not self._task.done()
            else "idle"
        )

    def start(self, test_id: str, disk_mb: int, net_mb: int) -> str:
        """'' on success, else an error string."""
        if self.status == "running":
            return f"test {self.test_id} already running"
        self.test_id = test_id
        self.report = {"test_id": test_id, "node_id": self.node_id}
        self._task = asyncio.ensure_future(self._run(disk_mb, net_mb))
        return ""

    async def stop(self) -> None:
        t = self._task
        if t is not None and not t.done():
            t.cancel()
            try:
                await t
            except asyncio.CancelledError:
                pass
            self.report["cancelled"] = True

    # -- checks -------------------------------------------------------
    def _diskcheck(self, size_mb: int) -> dict:
        """Sequential write+fsync then read-back under data_dir
        (self_test/diskcheck.cc). Unique file name: concurrent probes
        must not share; removal guaranteed even on ENOSPC."""
        path = os.path.join(
            self.data_dir, f".self_test.{secrets.token_hex(6)}.tmp"
        )
        block = os.urandom(1 << 20)
        try:
            t0 = time.perf_counter()
            with open(path, "wb") as f:
                for _ in range(size_mb):
                    f.write(block)
                f.flush()
                os.fsync(f.fileno())
            w = time.perf_counter() - t0
            t0 = time.perf_counter()
            with open(path, "rb") as f:
                while f.read(1 << 20):
                    pass
            r = time.perf_counter() - t0
        finally:
            try:
                os.remove(path)
            except OSError:
                pass
        return {
            "write_mbps": round(size_mb / max(w, 1e-9), 1),
            "read_mbps": round(size_mb / max(r, 1e-9), 1),
            "size_mb": size_mb,
        }

    async def _netcheck_peer(self, peer: int, net_mb: int) -> dict:
        """RTT samples + streamed throughput against one peer's sink."""
        rtts = []
        small = b"\x00"
        try:
            for _ in range(5):
                t0 = time.perf_counter()
                await self._send(peer, SELF_TEST_NETSINK, small, 2.0)
                rtts.append((time.perf_counter() - t0) * 1e3)
        except Exception:
            return {"error": "unreachable"}
        frame = os.urandom(NET_FRAME)
        frames = max(1, (net_mb << 20) // NET_FRAME)
        t0 = time.perf_counter()
        try:
            for _ in range(frames):
                await self._send(peer, SELF_TEST_NETSINK, frame, 5.0)
        except Exception:
            return {"error": "failed mid-stream", "rtt_ms_min": min(rtts)}
        dt = max(time.perf_counter() - t0, 1e-9)
        return {
            "throughput_mbps": round(frames * NET_FRAME / (1 << 20) / dt, 1),
            "rtt_ms_min": round(min(rtts), 3),
            "rtt_ms_avg": round(sum(rtts) / len(rtts), 3),
        }

    async def _run(self, disk_mb: int, net_mb: int) -> None:
        loop = asyncio.get_event_loop()
        try:
            self.report["disk"] = await loop.run_in_executor(
                None, self._diskcheck, disk_mb
            )
            peers = [p for p in self._peers() if p != self.node_id]
            results = await asyncio.gather(
                *(self._netcheck_peer(p, net_mb) for p in peers)
            )
            self.report["network"] = {
                str(p): r for p, r in zip(peers, results)
            }
        except asyncio.CancelledError:
            raise
        except Exception as e:  # a failed check is a report, not a crash
            logger.exception("self test failed")
            self.report["error"] = str(e)


class SelfTestService(Service):
    service_name = "self_test"

    def __init__(self, backend: SelfTestBackend):
        self._b = backend

    @method(SELF_TEST_START)
    async def start(self, payload: bytes) -> bytes:
        req = _StartReq.decode(payload)
        err = self._b.start(req.test_id, int(req.disk_mb), int(req.net_mb))
        return _Ack(ok=0 if err else 1, error=err).encode()

    @method(SELF_TEST_STOP)
    async def stop(self, _payload: bytes) -> bytes:
        await self._b.stop()
        return _Ack(ok=1, error="").encode()

    @method(SELF_TEST_STATUS)
    async def status(self, _payload: bytes) -> bytes:
        import json

        return _StatusReply(
            node_id=self._b.node_id,
            status=self._b.status,
            test_id=self._b.test_id,
            report_json=json.dumps(self._b.report),
        ).encode()

    @method(SELF_TEST_NETSINK)
    async def netsink(self, payload: bytes) -> bytes:
        # netcheck sink: swallow the frame, ack its size
        return len(payload).to_bytes(4, "little")


class SelfTestFrontend:
    """Cluster coordinator (self_test_frontend.cc): fans start/stop to
    every requested node's backend (local backend called directly) and
    aggregates status. Any node can coordinate — state lives on the
    backends."""

    def __init__(
        self,
        node_id: int,
        backend: SelfTestBackend,
        send: Callable,
        members: Callable[[], list[int]],
    ):
        self.node_id = node_id
        self.backend = backend
        self._send = send
        self._members = members

    async def start(
        self,
        disk_mb: int = 16,
        net_mb: int = 8,
        nodes: Optional[list[int]] = None,
    ) -> dict:
        test_id = secrets.token_hex(8)
        targets = nodes if nodes else self._members()
        req = _StartReq(
            test_id=test_id, disk_mb=disk_mb, net_mb=net_mb
        ).encode()

        # concurrent fan-out: a dead peer costs ONE timeout for the
        # whole call, not one per node
        async def one(n: int) -> tuple[str, dict]:
            if n == self.node_id:
                err = self.backend.start(test_id, disk_mb, net_mb)
                return str(n), {"ok": not err, "error": err}
            try:
                ack = _Ack.decode(
                    await self._send(n, SELF_TEST_START, req, 5.0)
                )
                return str(n), {"ok": bool(ack.ok), "error": str(ack.error)}
            except Exception as e:
                return str(n), {"ok": False, "error": str(e)}

        results = dict(await asyncio.gather(*(one(n) for n in targets)))
        return {"test_id": test_id, "nodes": results}

    async def stop(self) -> dict:
        async def one(n: int) -> tuple[str, dict]:
            if n == self.node_id:
                await self.backend.stop()
                return str(n), {"ok": True}
            try:
                await self._send(n, SELF_TEST_STOP, b"", 5.0)
                return str(n), {"ok": True}
            except Exception as e:
                return str(n), {"ok": False, "error": str(e)}

        return dict(
            await asyncio.gather(*(one(n) for n in self._members()))
        )

    async def status(self) -> list[dict]:
        import json

        async def one(n: int) -> dict:
            if n == self.node_id:
                b = self.backend
                return {
                    "node_id": n,
                    "status": b.status,
                    "test_id": b.test_id,
                    "report": b.report,
                }
            try:
                r = _StatusReply.decode(
                    await self._send(n, SELF_TEST_STATUS, b"", 5.0)
                )
                return {
                    "node_id": int(r.node_id),
                    "status": str(r.status),
                    "test_id": str(r.test_id),
                    "report": json.loads(str(r.report_json) or "{}"),
                }
            except Exception as e:
                return {
                    "node_id": n,
                    "status": "unreachable",
                    "error": str(e),
                }

        return list(
            await asyncio.gather(*(one(n) for n in self._members()))
        )
