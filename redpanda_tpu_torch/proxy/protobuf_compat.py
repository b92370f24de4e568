"""Protobuf schema parsing + structural compatibility.

Reference: src/v/pandaproxy/schema_registry/protobuf.cc (descriptor-
based compatibility over message/field/enum shapes — the checks the
Confluent registry names MESSAGE_REMOVED, FIELD_KIND_CHANGED,
FIELD_SCALAR_KIND_CHANGED, ONEOF_FIELD_REMOVED). The reference links
libprotobuf and compiles descriptors; here a self-contained proto2/3
subset parser builds equivalent descriptor trees from source text —
messages (nested), enums, oneofs, maps, scalar fields by NUMBER.

Backward compatibility = data written with OLD can be read with NEW:
  - a message that existed before must still exist
  - a field number that exists in both must keep its wire-kind group
    (varint / 64-bit / length-delimited / 32-bit) and, for
    length-delimited, its named type category (message vs scalar)
  - repeated <-> singular flips on the same number are violations
  - a field may not leave or join a oneof
FORWARD swaps the operands; FULL and the _TRANSITIVE variants compose
exactly like Avro's (schema_registry.compatible).
"""

from __future__ import annotations

import re

# wire-kind groups (encoding-compatible within a group)
_VARINT = {"int32", "int64", "uint32", "uint64", "sint32", "sint64", "bool"}
_FIX64 = {"fixed64", "sfixed64", "double"}
_FIX32 = {"fixed32", "sfixed32", "float"}
_LENGTH = {"string", "bytes"}
_SINT = {"sint32", "sint64"}  # zigzag: NOT value-compatible with int*


def _wire_kind(type_name: str, is_message: bool, is_enum: bool) -> str:
    if is_message:
        return "len:message"
    if is_enum:
        return "varint"
    if type_name in _VARINT:
        # zigzag encodings reinterpret the varint: treat as own kind
        return "varint:zigzag" if type_name in _SINT else "varint"
    if type_name in _FIX64:
        return "fix64"
    if type_name in _FIX32:
        return "fix32"
    if type_name in _LENGTH:
        return "len:scalar"
    # unresolved named type (cross-file import): assume message
    return "len:message"


class Field:
    __slots__ = ("name", "number", "type", "repeated", "oneof", "is_map")

    def __init__(self, name, number, type_, repeated, oneof, is_map=False):
        self.name = name
        self.number = number
        self.type = type_
        self.repeated = repeated
        self.oneof = oneof  # oneof name or None
        self.is_map = is_map


class Message:
    __slots__ = ("name", "fields", "messages", "enums")

    def __init__(self, name):
        self.name = name
        self.fields: dict[int, Field] = {}  # by field NUMBER
        self.messages: dict[str, "Message"] = {}
        self.enums: dict[str, dict[str, int]] = {}


class File:
    """Parsed top level: messages by name + file-level enum names."""

    __slots__ = ("messages", "enums")

    def __init__(self):
        self.messages: dict[str, Message] = {}
        self.enums: set[str] = set()


class ProtoError(ValueError):
    pass


_TOKEN = re.compile(
    r"""
    \s+ | //[^\n]* | /\*.*?\*/            # whitespace + comments
    | (?P<sym>[{}=;<>,\[\]()])            # punctuation
    | (?P<str>"(?:[^"\\]|\\.)*")          # string literal
    | (?P<word>[A-Za-z0-9_.+-]+)          # identifiers / numbers
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokenize(text: str) -> list[str]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ProtoError(f"bad token at offset {pos}: {text[pos:pos+20]!r}")
        pos = m.end()
        tok = m.group("sym") or m.group("str") or m.group("word")
        if tok is not None:
            out.append(tok)
    return out


class _Parser:
    def __init__(self, toks: list[str]):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        if self.i >= len(self.toks):
            raise ProtoError("unexpected end of schema")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, t):
        got = self.next()
        if got != t:
            raise ProtoError(f"expected {t!r}, got {got!r}")

    def skip_balanced_or_semi(self):
        """Skip to ; or over one balanced {...} (options, extensions)."""
        depth = 0
        while True:
            t = self.next()
            if t == "{":
                depth += 1
            elif t == "}":
                depth -= 1
                if depth == 0:
                    return
            elif t == ";" and depth == 0:
                return

    def skip_brackets(self):
        """[...] field options."""
        depth = 1
        while depth:
            t = self.next()
            if t == "[":
                depth += 1
            elif t == "]":
                depth -= 1

    def parse_file(self) -> "File":
        f = File()
        while self.peek() is not None:
            t = self.next()
            if t in ("syntax", "package", "option", "import"):
                while self.next() != ";":
                    pass
            elif t == "message":
                m = self.parse_message(self.next())
                f.messages[m.name] = m
            elif t == "enum":
                name = self.next()
                self.parse_enum()
                f.enums.add(name)
            elif t == ";":
                pass
            else:
                raise ProtoError(f"unexpected top-level token {t!r}")
        return f

    def parse_enum(self) -> None:
        self.expect("{")
        depth = 1
        while depth:
            t = self.next()
            if t == "{":
                depth += 1
            elif t == "}":
                depth -= 1

    def parse_message(self, name: str) -> Message:
        m = Message(name)
        self.expect("{")
        while True:
            t = self.next()
            if t == "}":
                return m
            if t == "message":
                sub = self.parse_message(self.next())
                m.messages[sub.name] = sub
            elif t == "enum":
                ename = self.next()
                self.parse_enum()
                m.enums[ename] = {}
            elif t == "oneof":
                oname = self.next()
                self.expect("{")
                while self.peek() != "}":
                    if self.peek() == "option":
                        self.next()
                        while self.next() != ";":
                            pass
                        continue
                    self.parse_field(m, oneof=oname)
                self.next()  # }
            elif t in ("reserved", "extensions", "option", "extend"):
                self.skip_balanced_or_semi()
            elif t == ";":
                pass
            else:
                self.parse_field(m, first=t)

    def parse_field(self, m: Message, oneof=None, first=None) -> None:
        t = first if first is not None else self.next()
        repeated = False
        if t in ("repeated", "optional", "required"):
            repeated = t == "repeated"
            t = self.next()
        is_map = False
        if t == "map":
            self.expect("<")
            self.next()  # key type
            self.expect(",")
            t = self.next()  # value type stands in as the field type
            self.expect(">")
            is_map = True
            repeated = True
        type_name = t
        fname = self.next()
        self.expect("=")
        raw = self.next()
        if not raw.isdigit():
            raise ProtoError(f"field {fname}: bad field number {raw!r}")
        number = int(raw)
        nxt = self.next()
        if nxt == "[":
            self.skip_brackets()
            nxt = self.next()
        if nxt != ";":
            raise ProtoError(f"expected ';' after field {fname}, got {nxt!r}")
        m.fields[number] = Field(fname, number, type_name, repeated, oneof, is_map)


def parse_proto(text: str) -> File:
    """Source text → File (top-level messages + file-level enums)."""
    return _Parser(_tokenize(text)).parse_file()


def _known_types(f: File) -> tuple[set, set]:
    messages, enums = set(), set(f.enums)

    def walk(m: Message, prefix: str):
        messages.add(prefix + m.name)
        messages.add(m.name)  # unqualified references
        for e in m.enums:
            enums.add(e)
            enums.add(f"{prefix}{m.name}.{e}")
        for sub in m.messages.values():
            walk(sub, f"{prefix}{m.name}.")

    for m in f.messages.values():
        walk(m, "")
    return messages, enums


def _check_message(
    new: Message, old: Message, new_types, old_types, path: str
) -> list[str]:
    errs: list[str] = []
    new_msgs, new_enums = new_types
    old_msgs, old_enums = old_types
    for number, of in old.fields.items():
        nf = new.fields.get(number)
        if nf is None:
            continue  # field removal is wire-safe (unknown fields skip)
        ok = _wire_kind(
            of.type, of.type in old_msgs, of.type in old_enums
        )
        nk = _wire_kind(
            nf.type, nf.type in new_msgs, nf.type in new_enums
        )
        if ok != nk:
            errs.append(
                f"{path}{new.name}.{nf.name} (field {number}): wire kind "
                f"changed {of.type} -> {nf.type} (FIELD_KIND_CHANGED)"
            )
        if of.repeated != nf.repeated:
            errs.append(
                f"{path}{new.name}.{nf.name} (field {number}): "
                f"repeated/singular flip (FIELD_LABEL_CHANGED)"
            )
        if of.is_map != nf.is_map:
            errs.append(
                f"{path}{new.name}.{nf.name} (field {number}): map <-> "
                f"non-map flip (FIELD_KIND_CHANGED)"
            )
        if (of.oneof is None) != (nf.oneof is None):
            errs.append(
                f"{path}{new.name}.{nf.name} (field {number}): moved "
                f"{'into' if nf.oneof else 'out of'} a oneof "
                f"(ONEOF_FIELD_CHANGED)"
            )
    for name, om in old.messages.items():
        nm = new.messages.get(name)
        if nm is None:
            errs.append(
                f"{path}{new.name}.{name}: nested message removed "
                f"(MESSAGE_REMOVED)"
            )
        else:
            errs.extend(
                _check_message(
                    nm, om, new_types, old_types, f"{path}{new.name}."
                )
            )
    return errs


def check_backward(new_text: str, old_text: str) -> list[str]:
    """Violations preventing NEW from reading data written by OLD;
    empty list = backward compatible."""
    new_file = parse_proto(new_text)
    old_file = parse_proto(old_text)
    new_types = _known_types(new_file)
    old_types = _known_types(old_file)
    errs: list[str] = []
    for name, om in old_file.messages.items():
        nm = new_file.messages.get(name)
        if nm is None:
            errs.append(f"{name}: message removed (MESSAGE_REMOVED)")
        else:
            errs.extend(_check_message(nm, om, new_types, old_types, ""))
    return errs
