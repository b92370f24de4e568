"""Versioned envelope serialization (reference: src/v/serde/envelope.h:26-64).

The wire format for all internal RPC types. An `Envelope` subclass
declares `SERDE_VERSION`, `SERDE_COMPAT_VERSION` and a `SERDE_FIELDS`
list of (attribute_name, serde_type) pairs. Encoding writes:

    [version u8][compat_version u8][payload_size u32 le][fields...]

Decoding reads exactly `payload_size` bytes: unknown trailing fields
written by a newer peer are skipped (forward compatibility), and a peer
whose `compat_version` exceeds our known version is rejected — the same
evolution contract as the reference's envelope
(serde/envelope_for_each_field.h drives field iteration there; here the
field list is explicit, which doubles as the wire documentation).

Primitive serde types mirror serde's fundamental encodings: fixed-width
little-endian ints, bool, length-prefixed bytes/string (u32 length),
optional (u8 presence tag), vector (u32 count), and nested envelopes.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple

from .iobuf import IOBufParser


class SerdeType(NamedTuple):
    encode: Callable[[bytearray, Any], None]
    decode: Callable[[IOBufParser], Any]
    # structural descriptor for generic tooling (the compat corpus
    # generator, schema dumps): ("fixed", fmt) | ("bool",) | ("bytes",)
    # | ("string",) | ("optional", t) | ("vector", t)
    # | ("mapping", kt, vt) | ("envelope", cls)
    spec: Any = None


def _fixed(fmt: str) -> SerdeType:
    s = struct.Struct(fmt)

    def enc(out: bytearray, v: Any) -> None:
        out += s.pack(v)

    def dec(p: IOBufParser) -> Any:
        return s.unpack(p.read(s.size))[0]

    return SerdeType(enc, dec, ("fixed", fmt))


i8 = _fixed("<b")
u8 = _fixed("<B")
i16 = _fixed("<h")
u16 = _fixed("<H")
i32 = _fixed("<i")
u32 = _fixed("<I")
i64 = _fixed("<q")
u64 = _fixed("<Q")
f64 = _fixed("<d")


def _enc_bool(out: bytearray, v: bool) -> None:
    out.append(1 if v else 0)


def _dec_bool(p: IOBufParser) -> bool:
    return p.read(1)[0] != 0


boolean = SerdeType(_enc_bool, _dec_bool, ("bool",))


def _enc_bytes(out: bytearray, v: bytes) -> None:
    out += struct.pack("<I", len(v))
    out += v


def _dec_bytes(p: IOBufParser) -> bytes:
    (n,) = struct.unpack("<I", p.read(4))
    return p.read(n)


bytes_t = SerdeType(_enc_bytes, _dec_bytes, ("bytes",))

string = SerdeType(
    lambda out, v: _enc_bytes(out, v.encode("utf-8")),
    lambda p: _dec_bytes(p).decode("utf-8"),
    ("string",),
)


def optional(t: SerdeType) -> SerdeType:
    def enc(out: bytearray, v: Any) -> None:
        if v is None:
            out.append(0)
        else:
            out.append(1)
            t.encode(out, v)

    def dec(p: IOBufParser) -> Any:
        return t.decode(p) if p.read(1)[0] else None

    return SerdeType(enc, dec, ("optional", t))


_FIXED_FMT = {}  # SerdeType -> struct letter, filled after the fixed defs


def vector(t: SerdeType) -> SerdeType:
    # bulk fast path for fixed-width scalars: one struct call for the
    # whole vector instead of one per element. Node-batched heartbeats
    # carry 5 such vectors of one entry per raft group — the per-item
    # path was the top profile line at 5k groups/node.
    letter = _FIXED_FMT.get(t)
    if letter is not None:
        import numpy as np

        item = struct.Struct("<" + letter)
        np_dtype = np.dtype("<" + letter)

        def enc_fast(out: bytearray, v: Any) -> None:
            out += struct.pack("<I", len(v))
            if isinstance(v, np.ndarray):
                out += np.ascontiguousarray(v, np_dtype).tobytes()
            else:
                out += struct.pack(f"<{len(v)}{letter}", *v)

        def dec_fast(p: IOBufParser) -> list:
            (n,) = struct.unpack("<I", p.read(4))
            # frombuffer+tolist: one C pass, no per-item struct calls
            return np.frombuffer(p.read(n * item.size), np_dtype).tolist()

        return SerdeType(enc_fast, dec_fast, ("vector", t))

    def enc(out: bytearray, v: Any) -> None:
        out += struct.pack("<I", len(v))
        for item in v:
            t.encode(out, item)

    def dec(p: IOBufParser) -> list:
        (n,) = struct.unpack("<I", p.read(4))
        return [t.decode(p) for _ in range(n)]

    return SerdeType(enc, dec, ("vector", t))


_FIXED_FMT.update(
    {
        i8: "b",
        u8: "B",
        i16: "h",
        u16: "H",
        i32: "i",
        u32: "I",
        i64: "q",
        u64: "Q",
        f64: "d",
    }
)


def ndvector(t: SerdeType) -> SerdeType:
    """Wire-identical to vector(t) for fixed-width scalars, but decodes
    to a (read-only) numpy array instead of a list — for hot batched
    types whose consumers are array programs (node-batched heartbeats):
    skipping the tolist()/asarray round-trip is worth ~20% of a 5k-group
    tick. Encode accepts ndarray or any sequence."""
    import numpy as np

    letter = _FIXED_FMT[t]
    np_dtype = np.dtype("<" + letter)

    def enc(out: bytearray, v: Any) -> None:
        out += struct.pack("<I", len(v))
        if isinstance(v, np.ndarray):
            out += np.ascontiguousarray(v, np_dtype).tobytes()
        else:
            out += struct.pack(f"<{len(v)}{letter}", *v)

    def dec(p: IOBufParser) -> Any:
        (n,) = struct.unpack("<I", p.read(4))
        return np.frombuffer(p.read(n * np_dtype.itemsize), np_dtype)

    # spec says "vector": generic tooling (compat corpus, schema dumps)
    # treats it exactly like the list form — same wire format
    return SerdeType(enc, dec, ("vector", t))


def mapping(kt: SerdeType, vt: SerdeType) -> SerdeType:
    def enc(out: bytearray, v: dict) -> None:
        out += struct.pack("<I", len(v))
        for k, val in v.items():
            kt.encode(out, k)
            vt.encode(out, val)

    def dec(p: IOBufParser) -> dict:
        (n,) = struct.unpack("<I", p.read(4))
        return {kt.decode(p): vt.decode(p) for _ in range(n)}

    return SerdeType(enc, dec, ("mapping", kt, vt))


class SerdeError(ValueError):
    pass


class Envelope:
    """Base for versioned wire types. Subclasses set SERDE_FIELDS (and
    optionally SERDE_VERSION / SERDE_COMPAT_VERSION) and get __init__,
    encode/decode, repr and equality for free."""

    SERDE_VERSION: int = 1
    SERDE_COMPAT_VERSION: int = 1
    SERDE_FIELDS: list[tuple[str, SerdeType]] = []
    # defaults for trailing fields absent in envelopes written by older
    # versions (property of appended-field evolution)
    SERDE_DEFAULTS: dict = {}
    # compiled encode/decode plan — see _compile_plan()
    _SERDE_PLAN = None

    def __init_subclass__(cls, **kwargs: Any) -> None:
        # registration-time plan compile: every subclass pays the
        # struct.Struct construction once at class-creation, never on
        # the hot encode/decode path. Classes that assemble
        # SERDE_FIELDS after the class body recompile transparently on
        # first use via the identity check in _plan().
        super().__init_subclass__(**kwargs)
        cls._compile_plan()

    @classmethod
    def _compile_plan(cls):
        """(fields, prefix_struct|None, names, bools, full_struct|None):
        `prefix_struct` collapses the leading run of fixed-width/bool
        fields into one pack/unpack; when that run covers EVERY field
        the envelope is fully fixed-width and `full_struct` spans
        header+payload ("<BBI"+fmt) for a single-call wire round trip
        (AppendEntriesReply et al on the replication hot loop). Wire
        bytes are identical to the per-field path (same fixed LE
        encodings; bool is one byte, normalized to 0/1 on encode,
        `!= 0` on decode). The plan is keyed to the SERDE_FIELDS list
        object itself so a class mutating its field table gets a fresh
        compile."""
        fields = cls.SERDE_FIELDS
        fmt = "<"
        names: list[str] = []
        bools: list[int] = []
        for i, (name, t) in enumerate(fields):
            spec = t.spec
            if spec is not None and spec[0] == "fixed":
                fmt += spec[1][1:]  # strip the leading "<"
            elif spec is not None and spec[0] == "bool":
                fmt += "B"
                bools.append(i)
            else:
                break
            names.append(name)
        prefix = struct.Struct(fmt) if len(names) >= 2 else None
        full = (
            struct.Struct("<BBI" + fmt[1:])
            if prefix is not None and len(names) == len(fields)
            else None
        )
        plan = (fields, prefix, tuple(names), tuple(bools), full)
        cls._SERDE_PLAN = plan
        return plan

    @classmethod
    def _plan(cls):
        plan = cls._SERDE_PLAN
        if plan is None or plan[0] is not cls.SERDE_FIELDS:
            plan = cls._compile_plan()
        return plan

    def __init__(self, **kwargs: Any):
        names = [n for n, _ in self.SERDE_FIELDS]
        for name in names:
            if name in kwargs:
                setattr(self, name, kwargs.pop(name))
            elif name in self.SERDE_DEFAULTS:
                # evolved trailing field: constructor parity with the
                # decode-side default
                setattr(self, name, self.SERDE_DEFAULTS[name])
            else:
                raise TypeError(f"missing field: {name}")
        if kwargs:
            raise TypeError(f"unknown fields: {sorted(kwargs)}")

    def encode(self) -> bytes:
        cls = type(self)
        fields, prefix, names, bools, full = cls._plan()
        getter = self.__getattribute__  # localize: one dict probe/field
        if full is not None:
            # fully fixed-width envelope: header + payload in ONE pack
            vals = [getter(n) for n in names]
            for i in bools:
                vals[i] = 1 if vals[i] else 0
            return full.pack(
                cls.SERDE_VERSION,
                cls.SERDE_COMPAT_VERSION,
                full.size - 6,
                *vals,
            )
        if prefix is not None:
            vals = [getter(n) for n in names]
            for i in bools:
                vals[i] = 1 if vals[i] else 0
            body = bytearray(prefix.pack(*vals))
            rest = fields[len(names):]
        else:
            body = bytearray()
            rest = fields
        for name, t in rest:
            t.encode(body, getter(name))
        head = struct.pack(
            "<BBI", cls.SERDE_VERSION, cls.SERDE_COMPAT_VERSION, len(body)
        )
        return head + bytes(body)

    @classmethod
    def decode(cls, data: "bytes | IOBufParser") -> "Envelope":
        fields, prefix, names, bools, full = cls._plan()
        if (
            full is not None
            and type(data) is bytes
            and len(data) == full.size
        ):
            # fully fixed-width envelope arriving as an exact-size
            # buffer: ONE unpack covers header + every field. Size or
            # version skew (evolved peers) falls through to the
            # general path below — wire semantics unchanged.
            vals = full.unpack(data)
            if vals[1] <= cls.SERDE_VERSION and vals[2] == full.size - 6:
                obj = cls.__new__(cls)
                setter = obj.__setattr__
                i = 3
                for n in names:
                    setter(n, vals[i])
                    i += 1
                for i in bools:
                    setter(names[i], vals[3 + i] != 0)
                return obj
        p = data if isinstance(data, IOBufParser) else IOBufParser(data)
        version, compat, size = struct.unpack("<BBI", p.read(6))
        if compat > cls.SERDE_VERSION:
            raise SerdeError(
                f"{cls.__name__}: peer compat_version {compat} > known "
                f"version {cls.SERDE_VERSION}"
            )
        end = p.pos() + size
        obj = cls.__new__(cls)
        if prefix is not None and end - p.pos() >= prefix.size:
            vals = prefix.unpack(p.read(prefix.size))
            setter = obj.__setattr__
            i = 0
            for n in names:
                setter(n, vals[i])
                i += 1
            for i in bools:
                setter(names[i], vals[i] != 0)
            fields = fields[len(names):]
        for name, t in fields:
            if p.pos() >= end:
                # older peer/log entry: fields added after its version
                # are absent — fill declared defaults, else fail
                if name in cls.SERDE_DEFAULTS:
                    setattr(obj, name, cls.SERDE_DEFAULTS[name])
                    continue
                raise SerdeError(
                    f"{cls.__name__}: truncated envelope (missing {name})"
                )
            setattr(obj, name, t.decode(p))
            if p.pos() > end:
                # field decode ran past the declared envelope size: a
                # truncated/corrupt envelope must fail HERE, not desync
                # the surrounding stream
                raise SerdeError(
                    f"{cls.__name__}: field {name} overran envelope "
                    f"bounds ({p.pos() - end} bytes)"
                )
        if p.pos() < end:  # newer peer wrote extra fields: skip
            p.skip(end - p.pos())
        return obj

    # `envelope(Cls)` serde type for nesting
    @classmethod
    def serde(cls) -> SerdeType:
        return SerdeType(
            lambda out, v: out.extend(v.encode()),
            lambda p: cls.decode(p),
            ("envelope", cls),
        )

    def __eq__(self, other: object) -> bool:
        if type(other) is not type(self):
            return NotImplemented

        def field_eq(a: Any, b: Any) -> bool:
            # ndvector fields decode to numpy arrays whose == is
            # elementwise; compare by content against arrays or lists
            if hasattr(a, "__array__") or hasattr(b, "__array__"):
                import numpy as np

                return bool(np.array_equal(np.asarray(a), np.asarray(b)))
            return a == b

        return all(
            field_eq(getattr(self, n), getattr(other, n))
            for n, _ in self.SERDE_FIELDS
        )

    def __repr__(self) -> str:  # pragma: no cover
        fields = ", ".join(
            f"{n}={getattr(self, n)!r}" for n, _ in self.SERDE_FIELDS
        )
        return f"{type(self).__name__}({fields})"


def envelope(cls: type[Envelope]) -> SerdeType:
    return cls.serde()
