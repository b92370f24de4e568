"""The load generator: Kafka producers and consumers in a process of
their own, with their own wire client (harness/wire.py), so that they
share neither the brokers' event loop nor any of the program's code.

    python3 benchmark/loadgen.py SPEC.json

SPEC holds the run's parameters (harness/traffic.py `plan`), the seed, the window's
seconds and the path of the results file. The generator talks with the
brokers' process over its standard streams, one word a line:

    out  POOL   its batches are built (before any connection)
    in   START {"bootstrap": [[host, port], ...], "topic": ..., "partitions": ...}
    out  WARM   the warm-up has run; traffic goes on
    in   GO     the window starts now
    out  END    the window closed; no new batch is sent
    out  DONE   every reply and every acknowledged batch's fetch is in,
                or the drain's time ran out; results written

Open loop at the mix's fixed rate (`batches_per_s`, one batch a
produce request, acks as the deployment says): a batch falls due
whatever is in flight and is timed from when it was due. Partition p
belongs to producer p % producers and to consumer p % consumers. Each
producer and each consumer holds one connection to each broker it
needs; requests on a connection are pipelined, at most `max_in_flight`
at a time (Kafka's max.in.flight.requests.per.connection), so where the
brokers fall behind the backlog waits in the producers, as it does in a
Kafka client, and not in the brokers. Consumers long-poll every
partition they own from its first offset. Times are this process's
monotonic clock.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import json
import os
import struct
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from harness import traffic, wire  # noqa: E402


class Conn:
    """One pipelined connection: replies come back in request order."""

    def __init__(self, client_id: str, in_flight: int):
        self.client_id = client_id
        self.slots = asyncio.Semaphore(in_flight)
        self.reader = self.writer = self.task = None
        self.pending: collections.deque = collections.deque()
        self.corr = 0
        self.dead = None

    async def open(self, host: str, port: int) -> None:
        self.reader, self.writer = await asyncio.open_connection(host, port, limit=1 << 24)
        self.task = asyncio.ensure_future(self._read())

    async def _read(self) -> None:
        try:
            while True:
                (size,) = struct.unpack(">i", await self.reader.readexactly(4))
                frame = await self.reader.readexactly(size)
                t = time.monotonic()
                fut = self.pending.popleft()
                if not fut.done():
                    fut.set_result((t, memoryview(frame)[4:]))
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            self.dead = e
            while self.pending:
                fut = self.pending.popleft()
                if not fut.done():
                    fut.set_exception(ConnectionError(str(e)))

    def send(self, api: int, version: int, body: bytes) -> tuple:
        """Write one request; returns (send time, future of (reply time,
        reply body))."""
        if self.dead is not None:
            raise ConnectionError(str(self.dead))
        self.corr += 1
        fut = asyncio.get_running_loop().create_future()
        self.pending.append(fut)
        t = time.monotonic()
        self.writer.write(wire.request(api, version, self.corr, self.client_id, body))
        return t, fut

    async def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            with contextlib.suppress(Exception, asyncio.CancelledError):
                await self.writer.wait_closed()
        if self.task is not None:
            self.task.cancel()
            with contextlib.suppress(Exception, asyncio.CancelledError):
                await self.task


class Client:
    """A producer or a consumer: a connection to each broker it needs."""

    def __init__(self, gen, name: str):
        self.gen, self.name, self.conns = gen, name, {}

    async def conn(self, node: int) -> Conn:
        c = self.conns.get(node)
        if c is None or c.dead is not None:
            c = Conn(self.name, int(self.gen.mix["max_in_flight"]))
            host, port = self.gen.brokers[node]
            await c.open(host, port)
            self.conns[node] = c
        return c

    async def close(self) -> None:
        for c in self.conns.values():
            await c.close()


class Generator:
    def __init__(self, spec: dict):
        self.mix, self.seed, self.seconds = spec["mix"], int(spec["seed"]), float(spec["seconds"])
        self.out_path = spec["out"]
        self.pool = traffic.pool(self.mix, self.seed)
        self.brokers: dict = {}
        self.leaders: dict = {}
        self.t0 = self.t1 = None
        self.stopping = False
        self.drain_end = None
        self.attempts: list = []  # [partition, k, t send, t reply or None, error]
        self.sent: list = []  # [partition, k, pool index, t due, t sent]
        self.acks: list = []  # [partition, k, pool index, t due, t ack, base offset]
        self.failed: list = []  # [partition, k, error]
        self.receipts: list = []  # [partition, base, t, digest, length, crc, count, verify bytes]
        self.hwm: dict = {}
        self.refreshes = 0
        self.slot_waits = 0  # produce requests that waited for a free in-flight slot
        self._meta_lock = asyncio.Lock()

    # -------------------------------------------------------- metadata
    async def refresh(self) -> None:
        async with self._meta_lock:
            self.refreshes += 1
            for host, port in self.bootstrap:
                c = Conn("metadata", 1)
                try:
                    await c.open(host, port)
                    _, fut = c.send(wire.METADATA, wire.METADATA_V, wire.metadata_request([self.topic]))
                    _, body = await asyncio.wait_for(fut, 10.0)
                    brokers, parts = wire.metadata_response(body)
                except (OSError, ConnectionError, asyncio.TimeoutError):
                    continue
                finally:
                    await c.close()
                self.brokers.update(brokers)
                for (name, p), (err, leader) in parts.items():
                    if name == self.topic and err == 0 and leader >= 0:
                        self.leaders[p] = leader
                if all(p in self.leaders for p in range(self.partitions)):
                    return

    # -------------------------------------------------------- producing
    async def pace(self, producers: list) -> list:
        """Open loop: batch j is due at start + j / rate, to partition
        order[j % partitions] (its k = j // partitions-th batch), and is
        sent when due whatever is still in flight. The seed orders the
        partitions; every seed offers the same arrivals. Returns the
        send tasks once no batch falls due before the window's end."""
        rate, n = float(self.mix["batches_per_s"]), self.partitions
        order = [int(p) for p in np.random.default_rng(self.seed).permutation(n)]
        tasks, start, j = [], time.monotonic(), 0
        while True:
            due = start + j / rate
            if self.t1 is not None and due >= self.t1:
                return tasks
            delay = due - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            p = order[j % n]
            tasks.append(asyncio.ensure_future(self.send_batch(producers[p % len(producers)], p, j // n, due)))
            j += 1

    async def send_batch(self, producer: Client, p: int, k: int, due: float) -> None:
        """Produce partition p's k-th batch, retrying what a Kafka client
        retries until the drain's time runs out."""
        acks, timeout_ms = int(self.mix["acks"]), int(self.mix["request_timeout_ms"])
        idx = traffic.pool_index(self.mix, p, k)
        batch = self.pool[idx]["wire"]
        self.sent.append([p, k, idx, due, time.monotonic()])
        while True:
            err, base, t_send, t_reply = -1, -1, time.monotonic(), None
            try:
                conn = await producer.conn(self.leaders[p])
                body = wire.produce_request(self.topic, p, batch, acks, timeout_ms)
                self.slot_waits += conn.slots.locked()
                async with conn.slots:
                    t_send, fut = conn.send(wire.PRODUCE, wire.PRODUCE_V, body)
                    t_reply, reply = await asyncio.wait_for(fut, timeout_ms / 1000.0)
                err, base = wire.produce_response(reply)
            except (OSError, ConnectionError, asyncio.TimeoutError):
                pass
            self.attempts.append([p, k, t_send, t_reply, err])
            if err == 0:
                self.acks.append([p, k, idx, due, t_reply, base])
                return
            late = self.drain_end is not None and time.monotonic() > self.drain_end
            if late or (err != -1 and err not in wire.RETRIABLE):
                self.failed.append([p, k, err])
                return
            await asyncio.sleep(0.05)
            await self.refresh()

    # -------------------------------------------------------- consuming
    async def consume_loop(self, consumer: Client, node: int, parts: list, offsets: dict, target: dict) -> None:
        mix = self.mix
        while True:
            mine = [p for p in parts if self.leaders.get(p) == node]
            if self.stopping and target and all(offsets[p] >= target.get(p, 0) for p in parts):
                return
            if not mine:
                await asyncio.sleep(0.05)
                continue
            body = wire.fetch_request(self.topic, [(p, offsets[p]) for p in mine], int(mix["fetch_max_wait_ms"]),
                                      1, int(mix["fetch_max_bytes"]), int(mix["fetch_partition_max_bytes"]))
            try:
                conn = await consumer.conn(node)
                _, fut = conn.send(wire.FETCH, wire.FETCH_V, body)
                t, reply = await asyncio.wait_for(fut, 30.0)
                rows = wire.fetch_response(reply)
            except (OSError, ConnectionError, asyncio.TimeoutError):
                await asyncio.sleep(0.05)
                continue
            stale = False
            for p, err, hwm, blob in rows:
                if err:
                    stale = stale or err in wire.RETRIABLE
                    continue
                self.hwm[p] = hwm
                for base, batch in wire.split_batches(blob or b""):
                    if base < offsets[p]:
                        continue
                    f = wire.batch_fields(batch)
                    self.receipts.append([p, base, t, zlib.crc32(batch[wire.CRC_FROM:]), f["length"], f["crc"],
                                          f["record_count"], f["length"] - 9])
                    offsets[p] = base + f["last_offset_delta"] + 1
            if stale:
                await asyncio.sleep(0.05)
                await self.refresh()

    # -------------------------------------------------------- the run
    async def run(self, lines) -> None:
        say("POOL")
        start = json.loads((await expect(lines, "START")).split(" ", 1)[1])
        self.bootstrap = [tuple(a) for a in start["bootstrap"]]
        self.topic, self.partitions = start["topic"], int(start["partitions"])
        await self.refresh()
        mix = self.mix
        producers = [Client(self, f"producer-{i}") for i in range(int(mix["producers"]))]
        consumers = [Client(self, f"consumer-{i}") for i in range(int(mix["consumers"]))]
        offsets = {p: 0 for p in range(self.partitions)}
        target: dict = {}
        pacer = asyncio.ensure_future(self.pace(producers))
        cons = []
        for i, c in enumerate(consumers):
            parts = [p for p in range(self.partitions) if p % len(consumers) == i]
            cons += [asyncio.ensure_future(self.consume_loop(c, node, parts, offsets, target))
                     for node in sorted(self.brokers)]
        await asyncio.sleep(float(mix["warmup_s"]))
        say("WARM")
        await expect(lines, "GO")
        self.t0 = time.monotonic()
        self.t1 = self.t0 + self.seconds
        await asyncio.sleep(self.seconds)
        self.stopping = True
        self.drain_end = time.monotonic() + float(mix["drain_s"])
        say("END")
        await asyncio.gather(*await pacer)
        for p, k, idx, _, _, base in self.acks:
            target[p] = max(target.get(p, 0), base + len(self.pool[idx]["records"]))
        for p in range(self.partitions):
            target.setdefault(p, 0)
        done, late = await asyncio.wait(cons, timeout=float(mix["drain_s"]))
        for t in late:
            t.cancel()
        for t in done:
            t.result()
        for c in producers + consumers:
            await c.close()
        rest = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        for t in rest:
            t.cancel()
        await asyncio.gather(*rest, return_exceptions=True)
        with open(self.out_path, "w") as f:
            json.dump({"t0": self.t0, "t1": self.t1, "sent": self.sent, "attempts": self.attempts, "acks": self.acks,
                       "failed": self.failed, "receipts": self.receipts, "hwm": self.hwm,
                       "consumers_late": len(late), "refreshes": self.refreshes, "slot_waits": self.slot_waits}, f)
        say("DONE")


def say(word: str) -> None:
    sys.stdout.write(word + "\n")
    sys.stdout.flush()


async def expect(lines, word: str) -> str:
    line = (await lines.readline()).decode().strip()
    if not line.startswith(word):
        raise SystemExit(f"loadgen: expected {word}, got {line!r}")
    return line


async def main(spec_path: str) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    gen = Generator(spec)
    loop = asyncio.get_running_loop()
    lines = asyncio.StreamReader()
    await loop.connect_read_pipe(lambda: asyncio.StreamReaderProtocol(lines), sys.stdin)
    await gen.run(lines)


if __name__ == "__main__":
    asyncio.run(main(sys.argv[1]))
