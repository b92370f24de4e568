"""Declarative Kafka message schemas → encoders/decoders.

Reference: src/v/kafka/protocol/schemata/generator.py (1,813 LoC)
consumes Kafka's upstream message JSON and emits C++ structs with
per-version, flex-aware codecs. Here the same version-gated field
model is interpreted directly: an `Api` declares request/response
field trees once, each field carrying its valid version range,
nullable range and optional tag, and `encode`/`decode` walk the tree
for a concrete negotiated version.

Messages decode into `Msg` objects (attribute access over a plain
dict) so handlers read `req.topics[0].partitions` the way reference
handlers read generated structs.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from .wire import Reader, Writer

_MISSING = object()


class Msg(dict):
    """Dict with attribute access; the decoded form of any message."""

    __slots__ = ()

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __repr__(self) -> str:  # pragma: no cover
        inner = ", ".join(f"{k}={v!r}" for k, v in self.items())
        return f"Msg({inner})"


class Array:
    """Array-of-struct (fields) or array-of-primitive (type str)."""

    __slots__ = ("inner",)

    def __init__(self, inner: "str | Sequence[F]"):
        self.inner = inner


class F:
    """One schema field.

    versions=(min, max) — version range where the field is on the wire
    (max None = open). nullable=(min, max) — range where null is legal.
    tag — KIP-482 tagged field number (encoded in the tagged section
    for flexible versions; ignored below the flex boundary).
    """

    __slots__ = ("name", "type", "versions", "nullable", "default", "tag")

    def __init__(
        self,
        name: str,
        type: "str | Array | Sequence[F]",
        versions: tuple[int, Optional[int]] = (0, None),
        nullable: Optional[tuple[int, Optional[int]]] = None,
        default: Any = _MISSING,
        tag: Optional[int] = None,
    ):
        self.name = name
        self.type = type
        self.versions = versions
        self.nullable = nullable
        self.default = default
        self.tag = tag

    def in_version(self, v: int) -> bool:
        lo, hi = self.versions
        return v >= lo and (hi is None or v <= hi)

    def nullable_in(self, v: int) -> bool:
        if self.nullable is None:
            return False
        lo, hi = self.nullable
        return v >= lo and (hi is None or v <= hi)

    def default_value(self) -> Any:
        if self.default is not _MISSING:
            return self.default
        t = self.type
        if isinstance(t, Array):
            return []
        if not isinstance(t, str):
            return None
        return {
            "bool": False,
            "string": "",
            "uuid": b"\x00" * 16,
            "float64": 0.0,
            "bytes": b"",
            "records": None,
        }.get(t, 0 if t.startswith(("int", "uint")) or t == "varint" else None)


_PRIM_READ = {
    "bool": Reader.read_bool,
    "int8": Reader.read_int8,
    "int16": Reader.read_int16,
    "int32": Reader.read_int32,
    "int64": Reader.read_int64,
    "uint16": Reader.read_uint16,
    "uint32": Reader.read_uint32,
    "varint": Reader.read_varint,
    "float64": Reader.read_float64,
    "uuid": Reader.read_uuid,
}

_PRIM_WRITE = {
    "bool": Writer.write_bool,
    "int8": Writer.write_int8,
    "int16": Writer.write_int16,
    "int32": Writer.write_int32,
    "int64": Writer.write_int64,
    "uint16": Writer.write_uint16,
    "uint32": Writer.write_uint32,
    "varint": Writer.write_varint,
    "float64": Writer.write_float64,
    "uuid": Writer.write_uuid,
}


def _decode_value(r: Reader, f: F, version: int, flexible: bool) -> Any:
    t = f.type
    if isinstance(t, Array):
        n = r.read_array_len(flexible)
        if n < 0:
            return None
        if isinstance(t.inner, str):
            if t.inner == "string":
                read = (
                    Reader.read_compact_string if flexible else Reader.read_string
                )
            elif t.inner == "bytes":
                read = (
                    Reader.read_compact_bytes if flexible else Reader.read_bytes
                )
            else:
                read = _PRIM_READ[t.inner]
            return [read(r) for _ in range(n)]
        return [_decode_fields(r, t.inner, version, flexible) for _ in range(n)]
    if not isinstance(t, str):  # nested struct
        return _decode_fields(r, t, version, flexible)
    if t == "string":
        if flexible:
            return (
                r.read_compact_nullable_string()
                if f.nullable_in(version)
                else r.read_compact_string()
            )
        return (
            r.read_nullable_string() if f.nullable_in(version) else r.read_string()
        )
    if t == "bytes":
        if flexible:
            return (
                r.read_compact_nullable_bytes()
                if f.nullable_in(version)
                else r.read_compact_bytes()
            )
        return r.read_nullable_bytes() if f.nullable_in(version) else r.read_bytes()
    if t == "records":
        return r.read_records(flexible)
    return _PRIM_READ[t](r)


def _decode_fields(
    r: Reader, fields: Sequence[F], version: int, flexible: bool
) -> Msg:
    out = Msg()
    tagged = [f for f in fields if f.tag is not None]
    for f in fields:
        if f.tag is not None or not f.in_version(version):
            out[f.name] = f.default_value()
            continue
        out[f.name] = _decode_value(r, f, version, flexible)
    if flexible:
        tags = r.skip_tagged_fields()
        for f in tagged:
            if f.tag in tags and f.in_version(version):
                out[f.name] = _decode_value(
                    Reader(tags[f.tag]), f, version, flexible
                )
    return out


def _encode_value(w: Writer, f: F, value: Any, version: int, flexible: bool) -> None:
    t = f.type
    if isinstance(t, Array):
        if value is None:
            w.write_array_len(-1, flexible)
            return
        w.write_array_len(len(value), flexible)
        if isinstance(t.inner, str):
            if t.inner == "string":
                write = (
                    Writer.write_compact_string
                    if flexible
                    else Writer.write_string
                )
            elif t.inner == "bytes":
                write = (
                    Writer.write_compact_bytes if flexible else Writer.write_bytes
                )
            else:
                write = _PRIM_WRITE[t.inner]
            for item in value:
                write(w, item)
        else:
            for item in value:
                _encode_fields(w, t.inner, item, version, flexible)
        return
    if not isinstance(t, str):
        _encode_fields(w, t, value, version, flexible)
        return
    if t == "string":
        if flexible:
            w.write_compact_nullable_string(value) if f.nullable_in(
                version
            ) else w.write_compact_string(value)
        else:
            w.write_nullable_string(value) if f.nullable_in(
                version
            ) else w.write_string(value)
        return
    if t == "bytes":
        if flexible:
            w.write_compact_nullable_bytes(value) if f.nullable_in(
                version
            ) else w.write_compact_bytes(value)
        else:
            w.write_nullable_bytes(value) if f.nullable_in(
                version
            ) else w.write_bytes(value)
        return
    if t == "records":
        w.write_records(value, flexible)
        return
    _PRIM_WRITE[t](w, value)


def _get(obj: Any, f: F) -> Any:
    if isinstance(obj, dict):
        v = obj.get(f.name, _MISSING)
    else:
        v = getattr(obj, f.name, _MISSING)
    return f.default_value() if v is _MISSING else v


def _encode_fields(
    w: Writer, fields: Sequence[F], obj: Any, version: int, flexible: bool
) -> None:
    tagged_out: list[tuple[int, bytes]] = []
    for f in fields:
        if not f.in_version(version):
            continue
        value = _get(obj, f)
        if f.tag is not None:
            if flexible and value != f.default_value() and value is not None:
                tw = Writer()
                _encode_value(tw, f, value, version, flexible)
                tagged_out.append((f.tag, tw.build()))
            continue
        _encode_value(w, f, value, version, flexible)
    if flexible:
        w.write_uvarint(len(tagged_out))
        for tag, raw in sorted(tagged_out):
            w.write_uvarint(tag)
            w.write_uvarint(len(raw))
            w.write_raw(raw)


class Api:
    """One Kafka API: key, version range, request/response field trees."""

    def __init__(
        self,
        key: int,
        name: str,
        versions: tuple[int, int],
        request: Sequence[F],
        response: Sequence[F],
        flex_since: Optional[int] = None,
    ):
        self.key = key
        self.name = name
        self.min_version, self.max_version = versions
        self.request = request
        self.response = response
        self.flex_since = flex_since

    def flexible(self, version: int) -> bool:
        return self.flex_since is not None and version >= self.flex_since

    def supports(self, version: int) -> bool:
        return self.min_version <= version <= self.max_version

    def decode_request(self, data: bytes | memoryview, version: int) -> Msg:
        return _decode_fields(Reader(data), self.request, version, self.flexible(version))

    def encode_request(self, obj: Any, version: int) -> bytes:
        w = Writer()
        _encode_fields(w, self.request, obj, version, self.flexible(version))
        return w.build()

    def decode_response(self, data: bytes | memoryview, version: int) -> Msg:
        return _decode_fields(
            Reader(data), self.response, version, self.flexible(version)
        )

    def encode_response(self, obj: Any, version: int) -> bytes:
        w = Writer()
        _encode_fields(w, self.response, obj, version, self.flexible(version))
        return w.build()
