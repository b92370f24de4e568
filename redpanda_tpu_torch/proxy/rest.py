"""HTTP REST proxy (pandaproxy).

Reference: src/v/pandaproxy/rest/ (proxy.cc, handlers.cc) — produce and
consume over HTTP with JSON or base64-binary embedded formats, plus
consumer-group instances pinned to the node that created them (the
reference's kafka_client consumer cache behaves the same way).
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import secrets
from typing import TYPE_CHECKING, Optional

from ..httpd import HttpError, HttpServer
from ..utils.tasks import cancel_and_wait

if TYPE_CHECKING:  # pragma: no cover
    from ..app import Broker

logger = logging.getLogger("pandaproxy")

_INSTANCE_TTL_S = 300.0


def _decode_embedded(value, fmt: str) -> bytes | None:
    if value is None:
        return None
    if fmt == "binary":
        try:
            return base64.b64decode(value)
        except Exception:
            raise HttpError(422, "invalid base64 payload", 42205) from None
    return json.dumps(value).encode()


def _encode_embedded(raw: bytes | None, fmt: str):
    if raw is None:
        return None
    if fmt == "binary":
        return base64.b64encode(raw).decode()
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError):
        return base64.b64encode(raw).decode()


class ConsumerInstance:
    """One named consumer in a group, pinned to this node. Uses the
    internal group client for membership; assignment is all partitions
    of the subscription split round-robin by member index (the
    range-assignor analog, computed by the group leader)."""

    def __init__(self, broker: "Broker", group: str, name: str, fmt: str):
        self.broker = broker
        self.group_id = group
        self.name = name
        self.fmt = fmt
        self.topics: list[str] = []
        self.assignment: list[tuple[str, int]] = []
        self.positions: dict[tuple[str, int], int] = {}
        self.last_used = asyncio.get_event_loop().time()
        from ..kafka.client import KafkaClient

        self.client = KafkaClient(
            [broker.internal_kafka_address], ssl=broker.internal_kafka_ssl()
        )
        self.gc = self.client.group(group)
        self._hb_task: Optional[asyncio.Task] = None

    async def subscribe(self, topics: list[str]) -> None:
        self.topics = list(topics)
        meta = json.dumps({"topics": self.topics}).encode()
        res = await self.gc.join([("roundrobin", meta)])
        if res.leader == res.member_id:
            # leader assigns: every member's subscription, partitions
            # split by member order
            members = [(m.member_id, json.loads(bytes(m.metadata))) for m in res.members]
            plan: dict[str, list[tuple[str, int]]] = {
                mid: [] for mid, _ in members
            }
            all_tps: list[tuple[str, int]] = []
            seen_topics = sorted(
                {t for _mid, md in members for t in md.get("topics", [])}
            )
            from ..models.fundamental import DEFAULT_NS, TopicNamespace

            for topic in seen_topics:
                md = self.broker.controller.topic_table.get(
                    TopicNamespace(DEFAULT_NS, topic)
                )
                if md is None:
                    continue
                for pid in sorted(md.assignments):
                    all_tps.append((topic, pid))
            for i, tp in enumerate(all_tps):
                mid = members[i % len(members)][0]
                plan[mid].append(tp)
            assignments = [
                (mid, json.dumps({"tps": tps}).encode())
                for mid, tps in plan.items()
            ]
            raw = await self.gc.sync(assignments)
        else:
            raw = await self.gc.sync([])
        self.assignment = [
            (t, int(p)) for t, p in json.loads(bytes(raw)).get("tps", [])
        ]
        # start positions from committed offsets (0 when none)
        wanted: dict[str, list[int]] = {}
        for t, p in self.assignment:
            wanted.setdefault(t, []).append(p)
        committed = await self.gc.fetch_offsets(wanted) if wanted else {}
        for t, p in self.assignment:
            off = committed.get((t, p), -1)
            self.positions[(t, p)] = off + 1 if off >= 0 else 0
        if self._hb_task is None:
            self._hb_task = asyncio.ensure_future(self._heartbeat_loop())

    async def _heartbeat_loop(self) -> None:
        from ..kafka.protocol import ErrorCode

        rejoin_codes = {
            int(ErrorCode.rebalance_in_progress),
            int(ErrorCode.illegal_generation),
            int(ErrorCode.unknown_member_id),
        }
        while True:
            await asyncio.sleep(3.0)
            try:
                code = await self.gc.heartbeat()
            except Exception:
                continue
            if code in rejoin_codes and self.topics:
                # generation moved (another member joined/left):
                # rejoin and take the fresh assignment
                try:
                    await self.subscribe(self.topics)
                except Exception:
                    logger.exception(
                        "consumer %s/%s rejoin failed",
                        self.group_id,
                        self.name,
                    )

    async def poll(self, max_bytes: int) -> list[dict]:
        self.last_used = asyncio.get_event_loop().time()
        out: list[dict] = []
        budget = max_bytes
        from ..kafka.client import KafkaClientError
        from ..kafka.protocol import ErrorCode

        for t, p in self.assignment:
            if budget <= 0:
                break
            pos = self.positions.get((t, p), 0)
            try:
                got = await self.client.fetch(
                    t, p, pos, max_bytes=budget, max_wait_ms=50
                )
            except KafkaClientError as e:
                if e.code == int(ErrorCode.offset_out_of_range):
                    # auto-reset to earliest (retention/compaction moved
                    # the log start), like auto.offset.reset=earliest
                    try:
                        self.positions[(t, p)] = await self.client.list_offset(
                            t, p, -2
                        )
                    except Exception:
                        pass
                    continue
                raise  # surface real failures as a 500, not silence
            for off, k, v in got:
                out.append(
                    {
                        "topic": t,
                        "partition": p,
                        "offset": off,
                        "key": _encode_embedded(k, self.fmt),
                        "value": _encode_embedded(v, self.fmt),
                    }
                )
                budget -= len(k or b"") + len(v or b"")
                self.positions[(t, p)] = off + 1
        return out

    async def commit(self, offsets: list[dict] | None) -> None:
        if offsets:
            items = {
                (o["topic"], int(o["partition"])): int(o["offset"])
                for o in offsets
            }
        else:
            items = {
                (t, p): pos - 1
                for (t, p), pos in self.positions.items()
                if pos > 0
            }
        if items:
            await self.gc.commit_offsets(items)

    async def close(self) -> None:
        if self._hb_task is not None:
            self._hb_task.cancel()
        try:
            await self.gc.leave()
        except Exception:
            pass
        await self.client.close()


class PandaproxyServer(HttpServer):
    def __init__(self, broker: "Broker", host: str = "127.0.0.1", port: int = 0):
        self.broker = broker
        self._client = None
        # (group, instance) -> ConsumerInstance
        self._instances: dict[tuple[str, str], ConsumerInstance] = {}
        self._gc_task: Optional[asyncio.Task] = None
        super().__init__(host, port)

    async def start(self) -> None:
        from ..kafka.client import KafkaClient

        self._client = KafkaClient(
                [self.broker.internal_kafka_address],
                ssl=self.broker.internal_kafka_ssl(),
            )
        self._gc_task = asyncio.ensure_future(self._gc_loop())
        await super().start()

    async def stop(self) -> None:
        await super().stop()
        gc_task, self._gc_task = self._gc_task, None
        await cancel_and_wait(gc_task)
        for inst in list(self._instances.values()):
            await inst.close()
        self._instances.clear()
        if self._client is not None:
            await self._client.close()

    async def _gc_loop(self) -> None:
        """Abandoned instances must leave their group: a dead member
        holding an assignment shadows partitions from live consumers."""
        while True:
            await asyncio.sleep(30.0)
            now = asyncio.get_event_loop().time()
            for key, inst in list(self._instances.items()):
                if now - inst.last_used > _INSTANCE_TTL_S:
                    del self._instances[key]
                    await inst.close()

    # -- routes --------------------------------------------------------
    def _install_routes(self) -> None:
        r = self.route
        r("GET", r"/topics", self._topics)
        r("GET", r"/topics/([^/]+)", self._topic)
        r("POST", r"/topics/([^/]+)", self._produce)
        r("GET", r"/brokers", self._brokers)
        r("POST", r"/consumers/([^/]+)", self._create_consumer)
        r(
            "DELETE",
            r"/consumers/([^/]+)/instances/([^/]+)",
            self._delete_consumer,
        )
        r(
            "POST",
            r"/consumers/([^/]+)/instances/([^/]+)/subscription",
            self._subscribe,
        )
        r(
            "GET",
            r"/consumers/([^/]+)/instances/([^/]+)/records",
            self._records,
        )
        r(
            "POST",
            r"/consumers/([^/]+)/instances/([^/]+)/offsets",
            self._commit,
        )

    async def _topics(self, _m, _q, _b):
        from ..models.fundamental import DEFAULT_NS

        return sorted(
            tp.topic
            for tp in self.broker.controller.topic_table.topics()
            if tp.ns == DEFAULT_NS
        )

    async def _topic(self, m, _q, _b):
        from ..models.fundamental import DEFAULT_NS, TopicNamespace

        md = self.broker.controller.topic_table.get(
            TopicNamespace(DEFAULT_NS, m.group(1))
        )
        if md is None:
            raise HttpError(404, f"topic {m.group(1)} not found", 40401)
        return {
            "name": m.group(1),
            "partitions": [
                {"partition": a.partition, "replicas": a.replicas}
                for a in md.assignments.values()
            ],
        }

    async def _produce(self, m, q, body):
        topic = m.group(1)
        fmt = q.get("format", "json")
        payload = self.json_body(body)
        records = payload.get("records")
        if not isinstance(records, list) or not records:
            raise HttpError(422, "records list required", 42201)
        offsets = []
        for rec in records:
            partition = int(rec.get("partition", 0))
            key = _decode_embedded(rec.get("key"), fmt)
            value = _decode_embedded(rec.get("value"), fmt)
            try:
                off = await self._client.produce(
                    topic, partition, [(key, value)]
                )
            except Exception as e:
                offsets.append(
                    {"partition": partition, "error_code": 50002, "error": str(e)}
                )
                continue
            offsets.append({"partition": partition, "offset": off})
        return {"offsets": offsets}

    async def _brokers(self, _m, _q, _b):
        return {"brokers": self.broker.controller.members}

    async def _create_consumer(self, m, _q, body):
        group = m.group(1)
        payload = self.json_body(body)
        name = payload.get("name") or f"rp-{secrets.token_hex(6)}"
        fmt = payload.get("format", "json")
        if (group, name) in self._instances:
            raise HttpError(409, f"consumer {name} exists", 40902)
        inst = ConsumerInstance(self.broker, group, name, fmt)
        self._instances[(group, name)] = inst
        return {
            "instance_id": name,
            "base_uri": f"http://{self.host}:{self.port}"
            f"/consumers/{group}/instances/{name}",
        }

    def _instance(self, group: str, name: str) -> ConsumerInstance:
        inst = self._instances.get((group, name))
        if inst is None:
            raise HttpError(404, f"consumer {name} not found", 40403)
        return inst

    async def _delete_consumer(self, m, _q, _b):
        inst = self._instance(m.group(1), m.group(2))
        del self._instances[(m.group(1), m.group(2))]
        await inst.close()
        return None

    async def _subscribe(self, m, _q, body):
        inst = self._instance(m.group(1), m.group(2))
        payload = self.json_body(body)
        topics = payload.get("topics")
        if not isinstance(topics, list) or not topics:
            raise HttpError(422, "topics list required", 42201)
        await inst.subscribe([str(t) for t in topics])
        return None

    async def _records(self, m, q, _b):
        inst = self._instance(m.group(1), m.group(2))
        max_bytes = int(q.get("max_bytes", 1 << 20))
        return await inst.poll(max_bytes)

    async def _commit(self, m, _q, body):
        inst = self._instance(m.group(1), m.group(2))
        payload = self.json_body(body) if body else {}
        await inst.commit(payload.get("offsets"))
        return None
