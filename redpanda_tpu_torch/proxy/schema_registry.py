"""Schema registry.

Reference: src/v/pandaproxy/schema_registry/ (service.cc REST surface,
sharded_store.h state, seq_writer.cc:optimistic write protocol). State
lives in the compacted single-partition `_schemas` topic: every node
replays the same log, so subjects/versions/ids converge everywhere;
the REST layer on any node writes through Kafka produce and waits for
its own record to apply (read-your-writes), retrying when a concurrent
writer won the slot — exactly the seq_writer protocol.

Compatibility checking implements the Avro-record structural subset
(field add/remove with defaults, recursive type equality) for
schemaType=AVRO, structural PROTOBUF checks over an in-tree descriptor
parser (protobuf_compat.py — wire-kind, label, oneof and
message-removal rules per protobuf.cc), and JSON Schema
permissiveness-subset checks (json_compat.py — type/enum/bound
narrowing, required additions, closed additionalProperties; exotic
keywords fail closed to equality).
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import TYPE_CHECKING, Optional

from ..httpd import HttpError, HttpServer

if TYPE_CHECKING:  # pragma: no cover
    from ..app import Broker

logger = logging.getLogger("schema_registry")

SCHEMAS_TOPIC = "_schemas"
LEVELS = {
    "NONE",
    "BACKWARD",
    "BACKWARD_TRANSITIVE",
    "FORWARD",
    "FORWARD_TRANSITIVE",
    "FULL",
    "FULL_TRANSITIVE",
}


def canonicalize(schema: str, schema_type: str) -> str:
    """Canonical text for dedupe: parsed-and-redumped JSON when the
    schema is JSON-shaped (AVRO/JSON); PROTOBUF is parse-validated
    (protobuf.cc compiles descriptors at registration) and kept
    verbatim."""
    if schema_type in ("AVRO", "JSON"):
        try:
            return json.dumps(json.loads(schema), sort_keys=True)
        except (json.JSONDecodeError, ValueError):
            raise HttpError(
                422, f"invalid {schema_type} schema", 42201
            ) from None
    if schema_type == "PROTOBUF":
        from . import protobuf_compat

        try:
            protobuf_compat.parse_proto(schema)
        except protobuf_compat.ProtoError as e:
            raise HttpError(
                422, f"invalid PROTOBUF schema: {e}", 42201
            ) from None
    return schema


# -- avro structural compatibility ------------------------------------
def _type_of(s):
    if isinstance(s, str):
        return s
    if isinstance(s, list):
        return "union"
    if isinstance(s, dict):
        return s.get("type")
    return None


def _reader_can_read(reader, writer) -> bool:
    """Avro-subset resolution: can data written with `writer` be read
    with `reader`? (schema_registry/avro.cc check_compatible, trimmed
    to records/arrays/maps/unions/primitives.)"""
    rt, wt = _type_of(reader), _type_of(writer)
    promotions = {
        ("long", "int"),
        ("float", "int"),
        ("float", "long"),
        ("double", "int"),
        ("double", "long"),
        ("double", "float"),
        ("string", "bytes"),
        ("bytes", "string"),
    }
    if rt == "union" or wt == "union":
        writers = writer if isinstance(writer, list) else [writer]
        readers = reader if isinstance(reader, list) else [reader]
        return all(
            any(_reader_can_read(r, w) for r in readers) for w in writers
        )
    if rt != wt:
        return (rt, wt) in promotions
    if rt == "record":
        wfields = {f["name"]: f for f in writer.get("fields", [])}
        for rf in reader.get("fields", []):
            wf = wfields.get(rf["name"])
            if wf is None:
                if "default" not in rf:
                    return False  # new required field: reader can't fill
            elif not _reader_can_read(rf["type"], wf["type"]):
                return False
        return True
    if rt == "array":
        return _reader_can_read(reader.get("items"), writer.get("items"))
    if rt == "map":
        return _reader_can_read(reader.get("values"), writer.get("values"))
    if rt in ("enum", "fixed"):
        return reader.get("name") == writer.get("name")
    return True  # identical primitives


def compatible(level: str, new: dict, olds: list[dict]) -> bool:
    """`new` (candidate) against existing versions, newest-first.
    Non-transitive levels check only the latest."""
    if level == "NONE" or not olds:
        return True
    check = olds if level.endswith("_TRANSITIVE") else olds[:1]

    def one(old: dict) -> bool:
        if new["type"] == "PROTOBUF" and old["type"] == "PROTOBUF":
            from . import protobuf_compat

            try:
                back = not protobuf_compat.check_backward(
                    new["canonical"], old["canonical"]
                )
                fwd = not protobuf_compat.check_backward(
                    old["canonical"], new["canonical"]
                )
            except protobuf_compat.ProtoError:
                # a legacy version that predates parse validation (or
                # uses syntax beyond the subset parser): fall back to
                # the only known-safe check rather than erroring the
                # whole subject
                return new["canonical"] == old["canonical"]
        elif new["type"] == "JSON" and old["type"] == "JSON":
            from . import json_compat

            try:
                n = json.loads(new["canonical"])
                o = json.loads(old["canonical"])
                back = not json_compat.check_backward(n, o)
                fwd = not json_compat.check_backward(o, n)
            except (json.JSONDecodeError, json_compat.JsonCompatError):
                # parses as JSON but is not schema-shaped: equality is
                # the only known-safe check (protobuf-branch pattern)
                return new["canonical"] == old["canonical"]
        elif new["type"] != "AVRO" or old["type"] != "AVRO":
            # mixed schema types: only exact equality is known-safe
            return new["canonical"] == old["canonical"]
        else:
            n, o = json.loads(new["canonical"]), json.loads(old["canonical"])
            back = _reader_can_read(n, o)
            fwd = _reader_can_read(o, n)
        if level.startswith("BACKWARD"):
            return back
        if level.startswith("FORWARD"):
            return fwd
        return back and fwd  # FULL

    return all(one(o) for o in check)


class SchemaStore:
    """Replayed view of the _schemas log — identical on every node."""

    def __init__(self):
        # subject -> version -> row {id, canonical, type, deleted}
        self.subjects: dict[str, dict[int, dict]] = {}
        self.by_id: dict[int, dict] = {}
        self.id_by_canonical: dict[str, int] = {}
        self.configs: dict[str, str] = {}  # "" = global default
        self.applied_offset = -1

    def next_id(self) -> int:
        return max(self.by_id, default=0) + 1

    def next_version(self, subject: str) -> int:
        return max(self.subjects.get(subject, {}), default=0) + 1

    def live_versions(self, subject: str) -> list[int]:
        return sorted(
            v
            for v, row in self.subjects.get(subject, {}).items()
            if not row["deleted"]
        )

    def lookup(self, subject: str, canonical: str) -> Optional[dict]:
        for v, row in sorted(self.subjects.get(subject, {}).items()):
            if not row["deleted"] and row["canonical"] == canonical:
                return {"version": v, **row}
        return None

    # -- log application ----------------------------------------------
    def apply(self, offset: int, key: bytes, value: bytes | None) -> None:
        self.applied_offset = max(self.applied_offset, offset)
        try:
            k = json.loads(key)
        except (json.JSONDecodeError, TypeError):
            return
        ktype = k.get("keytype")
        if ktype == "CONFIG":
            if value:
                v = json.loads(value)
                self.configs[k.get("subject") or ""] = v["compatibilityLevel"]
            else:
                self.configs.pop(k.get("subject") or "", None)
        elif ktype == "SCHEMA":
            subject, version = k["subject"], int(k["version"])
            if not value:
                # tombstone: hard-delete the version
                self.subjects.get(subject, {}).pop(version, None)
                return
            v = json.loads(value)
            canonical = v["schema"]
            # deterministic id resolution: the same schema text always
            # maps to ONE id cluster-wide, even when two concurrent
            # writers proposed different ids — log order decides
            sid = self.id_by_canonical.get(canonical)
            if sid is None:
                sid = int(v["id"])
                if sid in self.by_id and self.by_id[sid]["canonical"] != canonical:
                    sid = self.next_id()
                self.id_by_canonical[canonical] = sid
            row = {
                "id": sid,
                "canonical": canonical,
                "type": v.get("schemaType", "AVRO"),
                "deleted": bool(v.get("deleted", False)),
            }
            self.by_id.setdefault(
                sid, {"canonical": canonical, "type": row["type"]}
            )
            self.subjects.setdefault(subject, {})[version] = row

    def config_for(self, subject: str) -> str:
        return self.configs.get(subject) or self.configs.get("") or "BACKWARD"


class SchemaRegistryServer(HttpServer):
    def __init__(self, broker: "Broker", host: str = "127.0.0.1", port: int = 0):
        self.broker = broker
        self.store = SchemaStore()
        self._client = None
        self._consume_task: Optional[asyncio.Task] = None
        self._write_lock = asyncio.Lock()
        self._ready = asyncio.Event()
        super().__init__(host, port)

    # -- lifecycle -----------------------------------------------------
    async def start(self) -> None:
        from ..kafka.client import KafkaClient

        self._client = KafkaClient(
                [self.broker.internal_kafka_address],
                ssl=self.broker.internal_kafka_ssl(),
            )
        # bootstrap in the background: creating _schemas needs a
        # controller quorum, which may not exist yet when brokers boot
        # sequentially — gating Broker.start() on it would deadlock the
        # cluster formation it is waiting for
        self._consume_task = asyncio.ensure_future(self._bootstrap())
        await super().start()

    async def _bootstrap(self) -> None:
        while True:
            try:
                await self._ensure_topic()
                break
            except asyncio.CancelledError:
                raise
            except Exception:
                await asyncio.sleep(0.5)
        self._ready.set()
        await self._consume_loop()

    async def stop(self) -> None:
        await super().stop()
        if self._consume_task is not None:
            self._consume_task.cancel()
            try:
                await self._consume_task
            except asyncio.CancelledError:
                pass
        if self._client is not None:
            await self._client.close()

    async def _ensure_topic(self) -> None:
        from ..cluster.controller import TopicError

        n = len(self.broker.controller.members)
        rf = min(3, n)
        rf = rf if rf % 2 == 1 else rf - 1
        try:
            await self.broker.controller.create_topic(
                SCHEMAS_TOPIC,
                partitions=1,
                replication_factor=max(rf, 1),
                config={"cleanup.policy": "compact"},
            )
        except TopicError as e:
            if e.code != "topic_already_exists":
                raise

    async def _consume_loop(self) -> None:
        pos = 0
        while True:
            try:
                got = await self._client.fetch(
                    SCHEMAS_TOPIC, 0, pos, max_wait_ms=250, max_bytes=1 << 20
                )
            except Exception:
                await asyncio.sleep(0.25)
                continue
            if not got:
                # caught up at least to pos-1
                self.store.applied_offset = max(
                    self.store.applied_offset, pos - 1
                )
                await asyncio.sleep(0.05)
                continue
            for off, key, value in got:
                if key is not None:
                    try:
                        self.store.apply(off, key, value)
                    except Exception:
                        # a malformed record (anyone can produce to
                        # _schemas over plain Kafka) must not kill the
                        # replay — skip it, keep the registry live
                        logger.exception(
                            "skipping malformed _schemas record @%d", off
                        )
                        self.store.applied_offset = max(
                            self.store.applied_offset, off
                        )
                pos = off + 1

    async def _write(self, key: dict, value: dict | None) -> int:
        """Produce one registry record and wait until the local replay
        has applied it (seq_writer.cc wait for _schemas consumption)."""
        try:
            await asyncio.wait_for(self._ready.wait(), timeout=10.0)
        except asyncio.TimeoutError:
            raise HttpError(
                503, "registry bootstrapping (no controller quorum yet)", 50003
            ) from None
        off = await self._client.produce(
            SCHEMAS_TOPIC,
            0,
            [
                (
                    json.dumps(key, sort_keys=True).encode(),
                    None if value is None else json.dumps(value).encode(),
                )
            ],
        )
        deadline = asyncio.get_event_loop().time() + 10.0
        while self.store.applied_offset < off:
            if asyncio.get_event_loop().time() > deadline:
                raise HttpError(500, "registry replay lag", 50001)
            await asyncio.sleep(0.01)
        return off

    # -- routes --------------------------------------------------------
    def _install_routes(self) -> None:
        r = self.route
        r("GET", r"/subjects", self._subjects)
        r("GET", r"/subjects/([^/]+)/versions", self._versions)
        r("POST", r"/subjects/([^/]+)/versions", self._register)
        r("POST", r"/subjects/([^/]+)", self._lookup)
        r("DELETE", r"/subjects/([^/]+)", self._delete_subject)
        r("GET", r"/subjects/([^/]+)/versions/([^/]+)", self._get_version)
        r("GET", r"/schemas/ids/(\d+)", self._by_id)
        r("GET", r"/schemas/types", self._types)
        r("GET", r"/config", self._get_config)
        r("PUT", r"/config", self._put_config)
        r("GET", r"/config/([^/]+)", self._get_config)
        r("PUT", r"/config/([^/]+)", self._put_config)
        r(
            "POST",
            r"/compatibility/subjects/([^/]+)/versions/([^/]+)",
            self._check_compat,
        )

    def _parse_schema(self, body: bytes) -> tuple[str, str]:
        payload = self.json_body(body)
        schema = payload.get("schema")
        if not schema:
            raise HttpError(422, "schema field required", 42201)
        stype = (payload.get("schemaType") or "AVRO").upper()
        if stype not in ("AVRO", "JSON", "PROTOBUF"):
            raise HttpError(422, f"unknown schemaType {stype}", 42201)
        return canonicalize(str(schema), stype), stype

    def _subject_rows(self, subject: str) -> list[dict]:
        """Live versions newest-first, as compat-check inputs."""
        out = []
        for v in reversed(self.store.live_versions(subject)):
            row = self.store.subjects[subject][v]
            out.append({"canonical": row["canonical"], "type": row["type"]})
        return out

    async def _subjects(self, _m, _q, _b):
        return sorted(
            s for s in self.store.subjects if self.store.live_versions(s)
        )

    async def _versions(self, m, _q, _b):
        subject = m.group(1)
        versions = self.store.live_versions(subject)
        if not versions:
            raise HttpError(404, f"subject {subject} not found", 40401)
        return versions

    async def _register(self, m, _q, body):
        subject = m.group(1)
        canonical, stype = self._parse_schema(body)
        async with self._write_lock:
            for _attempt in range(5):
                existing = self.store.lookup(subject, canonical)
                if existing is not None:
                    return {"id": existing["id"]}
                level = self.store.config_for(subject)
                if not compatible(
                    level,
                    {"canonical": canonical, "type": stype},
                    self._subject_rows(subject),
                ):
                    raise HttpError(
                        409,
                        f"schema incompatible with {level} level",
                        409,
                    )
                version = self.store.next_version(subject)
                sid = self.store.id_by_canonical.get(
                    canonical, self.store.next_id()
                )
                await self._write(
                    {
                        "keytype": "SCHEMA",
                        "subject": subject,
                        "version": version,
                    },
                    {
                        "subject": subject,
                        "version": version,
                        "id": sid,
                        "schema": canonical,
                        "schemaType": stype,
                        "deleted": False,
                    },
                )
                # verify our write won the (subject, version) slot — a
                # concurrent writer through another node may have;
                # re-read and retry (seq_writer optimistic concurrency)
                applied = self.store.subjects.get(subject, {}).get(version)
                if applied is not None and applied["canonical"] == canonical:
                    return {"id": applied["id"]}
            raise HttpError(500, "register conflict persisted", 50001)

    async def _lookup(self, m, _q, body):
        subject = m.group(1)
        canonical, _stype = self._parse_schema(body)
        row = self.store.lookup(subject, canonical)
        if row is None:
            raise HttpError(404, "schema not found", 40403)
        return {
            "subject": subject,
            "version": row["version"],
            "id": row["id"],
            "schema": row["canonical"],
        }

    async def _delete_subject(self, m, _q, _b):
        subject = m.group(1)
        versions = self.store.live_versions(subject)
        if not versions:
            raise HttpError(404, f"subject {subject} not found", 40401)
        async with self._write_lock:
            for v in versions:
                row = self.store.subjects[subject][v]
                await self._write(
                    {"keytype": "SCHEMA", "subject": subject, "version": v},
                    {
                        "subject": subject,
                        "version": v,
                        "id": row["id"],
                        "schema": row["canonical"],
                        "schemaType": row["type"],
                        "deleted": True,
                    },
                )
        return versions

    async def _get_version(self, m, _q, _b):
        subject, vstr = m.group(1), m.group(2)
        versions = self.store.live_versions(subject)
        if not versions:
            raise HttpError(404, f"subject {subject} not found", 40401)
        if vstr == "latest":
            v = versions[-1]
        else:
            try:
                v = int(vstr)
            except ValueError:
                raise HttpError(422, f"invalid version {vstr}", 42202) from None
            if v not in versions:
                raise HttpError(404, f"version {v} not found", 40402)
        row = self.store.subjects[subject][v]
        return {
            "subject": subject,
            "version": v,
            "id": row["id"],
            "schemaType": row["type"],
            "schema": row["canonical"],
        }

    async def _by_id(self, m, _q, _b):
        sid = int(m.group(1))
        row = self.store.by_id.get(sid)
        if row is None:
            raise HttpError(404, f"schema id {sid} not found", 40403)
        return {"schema": row["canonical"]}

    async def _types(self, _m, _q, _b):
        return ["AVRO", "JSON", "PROTOBUF"]

    async def _get_config(self, m, _q, _b):
        subject = m.group(1) if m.groups() else ""
        if subject and subject not in self.store.configs:
            # Confluent returns 404 for unset subject config
            raise HttpError(404, f"no config for {subject}", 40401)
        return {"compatibilityLevel": self.store.config_for(subject)}

    async def _put_config(self, m, _q, body):
        subject = m.group(1) if m.groups() else ""
        payload = self.json_body(body)
        level = str(payload.get("compatibility", "")).upper()
        if level not in LEVELS:
            raise HttpError(422, f"invalid compatibility {level}", 42203)
        await self._write(
            {"keytype": "CONFIG", "subject": subject or None},
            {"compatibilityLevel": level},
        )
        return {"compatibility": level}

    async def _check_compat(self, m, _q, body):
        subject, vstr = m.group(1), m.group(2)
        canonical, stype = self._parse_schema(body)
        versions = self.store.live_versions(subject)
        if not versions:
            raise HttpError(404, f"subject {subject} not found", 40401)
        level = self.store.config_for(subject)
        if vstr == "latest":
            rows = self._subject_rows(subject)[:1]
        else:
            try:
                v = int(vstr)
            except ValueError:
                raise HttpError(422, f"invalid version {vstr}", 42202) from None
            if v not in versions:
                raise HttpError(404, f"version {v} not found", 40402)
            row = self.store.subjects[subject][v]
            rows = [{"canonical": row["canonical"], "type": row["type"]}]
        return {
            "is_compatible": compatible(
                level, {"canonical": canonical, "type": stype}, rows
            )
        }
