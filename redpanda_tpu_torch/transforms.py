"""Data transforms: server-hosted source→destination topic functions.

Reference: src/v/coproc — the pacemaker drives per-script fibers that
read source partitions and write transformed records to materialized
topics (script_context_{frontend,backend}). The sandboxed-JS sidecar
is replaced by in-process Python callables (the deployment seam a
WASM runtime would slot into); everything else keeps the reference's
shape:

  - fibers run on the SOURCE partition's leader, so work distributes
    with leadership and moves on failover (pacemaker.cc routing);
  - progress is a committed consumer-group offset per transform
    (group "__transforms.<name>") — durable, replicated, resumable,
    inspectable with ordinary group tooling;
  - delivery is at-least-once: produce to the destination, then
    commit the source offset (a crash between the two replays).

Transforms consume and produce through the broker's OWN Kafka
listener with the internal client — the same surface an external
processor would use, so routing (leadership, coordinator moves) is
already handled.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from typing import TYPE_CHECKING, Callable, Optional

if TYPE_CHECKING:  # pragma: no cover
    from .app import Broker

logger = logging.getLogger("transforms")

GROUP_PREFIX = "__transforms."


@dataclasses.dataclass
class TransformSpec:
    name: str
    source_topic: str
    dest_topic: str
    # fn(key, value) -> iterable[(key, value)] | (key, value) | None
    fn: Callable


class _Stats:
    """Per-(transform, partition) counters, owned by the SERVICE and
    carried across fiber restarts — a leadership bounce must not zero
    the observable progress counters."""

    __slots__ = ("offset", "transformed", "errors", "last_error")

    def __init__(self) -> None:
        self.offset = -1
        self.transformed = 0
        self.errors = 0
        self.last_error: Optional[str] = None


class _Fiber:
    def __init__(self, task: asyncio.Task):
        self.task = task


class TransformService:
    def __init__(self, broker: "Broker", scan_interval_s: float = 0.5):
        self.broker = broker
        self.scan_interval_s = scan_interval_s
        self._specs: dict[str, TransformSpec] = {}
        self._fibers: dict[tuple[str, int], _Fiber] = {}
        self._stats: dict[tuple[str, int], _Stats] = {}
        self._client = None
        self._task: Optional[asyncio.Task] = None
        self._closed = False

    # -- registration -------------------------------------------------
    def register(self, spec: TransformSpec) -> None:
        if spec.name in self._specs:
            raise ValueError(f"transform {spec.name} already registered")
        self._specs[spec.name] = spec

    def deregister(self, name: str) -> None:
        self._specs.pop(name, None)
        for key, fiber in list(self._fibers.items()):
            if key[0] == name:
                fiber.task.cancel()
                del self._fibers[key]
        for key in list(self._stats):
            if key[0] == name:
                del self._stats[key]

    def status(self) -> dict:
        out: dict = {}
        for (name, pid), st in sorted(self._stats.items()):
            f = self._fibers.get((name, pid))
            out.setdefault(name, {})[str(pid)] = {
                "offset": st.offset,
                "transformed": st.transformed,
                "errors": st.errors,
                "last_error": st.last_error,
                "running": f is not None and not f.task.done(),
            }
        return out

    # -- lifecycle ----------------------------------------------------
    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._pacemaker())

    async def stop(self) -> None:
        self._closed = True
        tasks = [f.task for f in self._fibers.values()]
        if self._task is not None:
            tasks.append(self._task)
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._fibers.clear()
        client, self._client = self._client, None
        if client is not None:
            await client.close()

    async def _get_client(self):
        if self._client is None:
            from .kafka.client import KafkaClient

            self._client = KafkaClient(
                [self.broker.internal_kafka_address],
                ssl=self.broker.internal_kafka_ssl(),
            )
        return self._client

    # -- the pacemaker (coproc/pacemaker.cc) --------------------------
    async def _pacemaker(self) -> None:
        from .models.fundamental import kafka_ntp

        while not self._closed:
            await asyncio.sleep(self.scan_interval_s)
            try:
                from .models.fundamental import DEFAULT_NS, TopicNamespace

                for spec in list(self._specs.values()):
                    md = self.broker.controller.topic_table.get(
                        TopicNamespace(DEFAULT_NS, spec.source_topic)
                    )
                    if md is None:
                        continue
                    for pid in range(md.partition_count):
                        p = self.broker.partition_manager.get(
                            kafka_ntp(spec.source_topic, pid)
                        )
                        is_leader = p is not None and p.is_leader
                        key = (spec.name, pid)
                        fiber = self._fibers.get(key)
                        if is_leader and (fiber is None or fiber.task.done()):
                            task = asyncio.ensure_future(
                                self._run_fiber(spec, pid)
                            )
                            self._stats.setdefault(key, _Stats())
                            self._fibers[key] = _Fiber(task)
                        elif not is_leader and fiber is not None:
                            # leadership moved: the new leader's
                            # pacemaker resumes from the committed
                            # offset
                            fiber.task.cancel()
                            del self._fibers[key]
            except Exception:
                logger.exception("transform pacemaker scan failed")

    # -- one (transform, partition) fiber -----------------------------
    async def _run_fiber(self, spec: TransformSpec, pid: int) -> None:
        key = (spec.name, pid)
        try:
            await self._fiber_body(spec, pid, key)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # record + throttle: the pacemaker respawns done fibers
            # every scan, and an unhandled setup error (listener not
            # ready, client connect failure) must not crash-loop hot
            st = self._stats.setdefault(key, _Stats())
            st.errors += 1
            st.last_error = f"fiber: {e}"
            await asyncio.sleep(1.0)

    async def _fiber_body(self, spec: TransformSpec, pid: int, key) -> None:
        from .models.fundamental import kafka_ntp

        client = await self._get_client()
        group = client.group(GROUP_PREFIX + spec.name)
        # the committed offset must be READ, not guessed: defaulting to
        # 0 on a transient coordinator error would replay the whole
        # source into the destination. Retry briefly, then die — the
        # pacemaker restarts the fiber.
        offset = None
        for _ in range(5):
            try:
                committed = await group.fetch_offsets(
                    {spec.source_topic: [pid]}
                )
                offset = max(0, committed.get((spec.source_topic, pid), 0))
                break
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self._stats.setdefault(key, _Stats()).last_error = (
                    f"offset_fetch: {e}"
                )
                await asyncio.sleep(0.2)
        if offset is None:
            return
        backoff = 0.05
        while not self._closed:
            p = self.broker.partition_manager.get(
                kafka_ntp(spec.source_topic, pid)
            )
            if p is None or not p.is_leader:
                return
            st = self._stats.setdefault(key, _Stats())
            try:
                # read_committed: aborted-transaction records must
                # never materialize into the destination
                recs = await client.fetch(
                    spec.source_topic,
                    pid,
                    offset,
                    max_wait_ms=250,
                    min_bytes=1,
                    read_committed=True,
                )
            except asyncio.CancelledError:
                raise
            except Exception as e:
                from .kafka.client import KafkaClientError
                from .kafka.protocol import ErrorCode

                if (
                    isinstance(e, KafkaClientError)
                    and e.code == int(ErrorCode.offset_out_of_range)
                ):
                    # retention trimmed past our position: resume at
                    # the earliest available offset (records between
                    # are gone — the stream continues rather than
                    # wedging forever)
                    try:
                        offset = await client.list_offset(
                            spec.source_topic, pid, -2
                        )
                        st.last_error = (
                            f"offset reset to log start {offset}"
                        )
                        continue
                    except Exception:
                        pass
                st.errors += 1
                st.last_error = f"fetch: {e}"
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
                continue
            backoff = 0.05
            if not recs:
                # an empty COMMITTED view can hide a full window of
                # aborted/control batches; without advancing past them
                # the fiber would re-read the same window forever. Skip
                # to the window's end, clamped to the LSO (never past
                # records whose transaction could still commit).
                try:
                    _w, nxt, lso = await client.fetch_raw(
                        spec.source_topic,
                        pid,
                        offset,
                        max_wait_ms=0,
                        return_lso=True,
                    )
                    if lso >= 0:
                        nxt = min(nxt, lso)
                    if nxt > offset:
                        offset = nxt
                        continue
                except asyncio.CancelledError:
                    raise
                except Exception:
                    pass
                await asyncio.sleep(0.05)
                continue
            outs: list[tuple[bytes | None, bytes | None]] = []
            for off, k, v in recs:
                try:
                    res = spec.fn(k, v)
                except Exception as e:
                    # a poisoned record must not wedge the partition:
                    # count it, skip it (the reference aborts the
                    # script; skipping keeps at-least-once for the rest)
                    st.errors += 1
                    st.last_error = f"fn@{off}: {e}"
                    continue
                if res is None:
                    continue
                if isinstance(res, tuple):
                    res = [res]
                outs.extend(res)
            try:
                if outs:
                    await client.produce(
                        spec.dest_topic, pid % await self._dest_parts(spec),
                        outs,
                    )
                new_offset = recs[-1][0] + 1
                await group.commit_offsets(
                    {(spec.source_topic, pid): new_offset}
                )
                offset = new_offset
                st.offset = offset
                st.transformed += len(outs)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                st.errors += 1
                st.last_error = f"produce/commit: {e}"
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 2.0)

    async def _dest_parts(self, spec: TransformSpec) -> int:
        from .models.fundamental import DEFAULT_NS, TopicNamespace

        md = self.broker.controller.topic_table.get(
            TopicNamespace(DEFAULT_NS, spec.dest_topic)
        )
        return md.partition_count if md is not None else 1
