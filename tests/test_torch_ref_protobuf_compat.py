"""tests/test_protobuf_compat.py run on the port: all 14 test functions,
with imports pointed at redpanda_tpu_torch. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
`http` and `proxy_broker` come from `test_torch_ref_http_services`.
Nothing is left out.


Protobuf schema parsing + structural compatibility.

Reference: src/v/pandaproxy/schema_registry/protobuf.cc (descriptor
compatibility: MESSAGE_REMOVED / FIELD_KIND_CHANGED / oneof checks)
and test_protobuf.cc's shape. End-to-end registration goes through the
real registry HTTP surface via the fixtures in test_http_services.
"""

import asyncio

import pytest

from redpanda_tpu_torch.proxy.protobuf_compat import (
    ProtoError,
    check_backward,
    parse_proto,
)

from test_torch_ref_http_services import http, proxy_broker  # noqa: F401
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")

V1 = """
syntax = "proto3";
package demo;

message User {
  string name = 1;
  int32 age = 2;
  repeated string tags = 3;
  map<string, int64> counters = 4;
  Address home = 5;
  message Address {
    string street = 1;
    string city = 2;
  }
  oneof contact {
    string email = 6;
    string phone = 7;
  }
  Kind kind = 8;
  enum Kind { UNKNOWN = 0; ADMIN = 1; }
}
"""

# adds a field, removes one (wire-safe), keeps numbers stable
V2_OK = """
syntax = "proto3";
package demo;

message User {
  string name = 1;
  int32 age = 2;
  repeated string tags = 3;
  map<string, int64> counters = 4;
  Address home = 5;
  message Address {
    string street = 1;
    string city = 2;
    string zip = 3;
  }
  oneof contact {
    string email = 6;
    string phone = 7;
  }
  Kind kind = 8;
  enum Kind { UNKNOWN = 0; ADMIN = 1; OPERATOR = 2; }
  uint64 created_ms = 9;
}
"""


def test_parse_shapes():
    f = parse_proto(V1)
    user = f.messages["User"]
    assert set(user.fields) == {1, 2, 3, 4, 5, 6, 7, 8}
    assert user.fields[3].repeated
    assert user.fields[4].is_map and user.fields[4].repeated
    assert user.fields[6].oneof == "contact"
    assert user.fields[7].oneof == "contact"
    assert "Address" in user.messages
    assert "Kind" in user.enums


def test_parse_rejects_garbage():
    with pytest.raises(ProtoError):
        parse_proto("message User { string name == 1; }")
    with pytest.raises(ProtoError):
        parse_proto("this is not a proto file {{{")


def test_backward_compatible_evolution():
    assert check_backward(V2_OK, V1) == []


def test_field_kind_change_is_violation():
    v2 = V1.replace("int32 age = 2;", "string age = 2;")
    errs = check_backward(v2, V1)
    assert any("FIELD_KIND_CHANGED" in e for e in errs), errs


def test_zigzag_reinterpretation_is_violation():
    # sint32 zigzags the varint: same wire type, different values
    v2 = V1.replace("int32 age = 2;", "sint32 age = 2;")
    errs = check_backward(v2, V1)
    assert any("FIELD_KIND_CHANGED" in e for e in errs), errs


def test_int32_to_int64_is_compatible():
    v2 = V1.replace("int32 age = 2;", "int64 age = 2;")
    assert check_backward(v2, V1) == []


def test_repeated_flip_is_violation():
    v2 = V1.replace("repeated string tags = 3;", "string tags = 3;")
    errs = check_backward(v2, V1)
    assert any("FIELD_LABEL_CHANGED" in e for e in errs), errs


def test_message_removed_is_violation():
    v2 = """
syntax = "proto3";
message Other { int32 x = 1; }
"""
    errs = check_backward(v2, V1)
    assert any("MESSAGE_REMOVED" in e for e in errs), errs


def test_oneof_escape_is_violation():
    v2 = V1.replace(
        """  oneof contact {
    string email = 6;
    string phone = 7;
  }""",
        """  string email = 6;
  string phone = 7;""",
    )
    errs = check_backward(v2, V1)
    assert any("ONEOF_FIELD_CHANGED" in e for e in errs), errs


def test_field_removal_is_backward_compatible():
    v2 = V1.replace("int32 age = 2;", "")
    assert check_backward(v2, V1) == []


# ---- end-to-end through the registry HTTP surface --------------------
async def _registry_protobuf(tmp_path):
    async with proxy_broker(tmp_path) as b:
        addr = b.schema_registry.address
        st, body = await http(
            addr,
            "POST",
            "/subjects/proto-value/versions",
            {"schema": V1, "schemaType": "PROTOBUF"},
        )
        assert st == 200, body
        # structural (not textual) evolution accepted at BACKWARD
        st, body = await http(
            addr,
            "POST",
            "/subjects/proto-value/versions",
            {"schema": V2_OK, "schemaType": "PROTOBUF"},
        )
        assert st == 200, body
        # kind change rejected
        st, body = await http(
            addr,
            "POST",
            "/subjects/proto-value/versions",
            {
                "schema": V2_OK.replace("int32 age = 2;", "string age = 2;"),
                "schemaType": "PROTOBUF",
            },
        )
        assert st == 409, body
        # unparseable proto rejected at registration
        st, body = await http(
            addr,
            "POST",
            "/subjects/proto-value/versions",
            {"schema": "message Broken {", "schemaType": "PROTOBUF"},
        )
        assert st == 422, body
        # compat probe endpoint agrees
        st, body = await http(
            addr,
            "POST",
            "/compatibility/subjects/proto-value/versions/latest",
            {
                "schema": V2_OK.replace(
                    "repeated string tags = 3;", "string tags = 3;"
                ),
                "schemaType": "PROTOBUF",
            },
        )
        assert st == 200 and body["is_compatible"] is False, body


def test_registry_protobuf_end_to_end(tmp_path):
    asyncio.run(_registry_protobuf(tmp_path))


def test_top_level_enum_is_varint_kind():
    """A field typed by a FILE-level enum is varint on the wire; a
    change to a message type must be flagged, and int32 <-> enum must
    not be (regression: top-level enums were misclassified)."""
    v1 = """
syntax = "proto3";
enum Color { RED = 0; BLUE = 1; }
message Item { Color c = 1; }
"""
    v2_msg = """
syntax = "proto3";
enum Color { RED = 0; BLUE = 1; }
message Sub { int32 x = 1; }
message Item { Sub c = 1; }
"""
    errs = check_backward(v2_msg, v1)
    assert any("FIELD_KIND_CHANGED" in e for e in errs), errs
    v2_int = """
syntax = "proto3";
enum Color { RED = 0; BLUE = 1; }
message Item { int32 c = 1; }
"""
    assert check_backward(v2_int, v1) == []


def test_map_flip_is_violation():
    v1 = """
syntax = "proto3";
message M { map<string, Foo> f = 3; message Foo { int32 a = 1; } }
"""
    v2 = """
syntax = "proto3";
message M { repeated Foo f = 3; message Foo { int32 a = 1; } }
"""
    errs = check_backward(v2, v1)
    assert any("map" in e for e in errs), errs


def test_oneof_option_statement_parses():
    parse_proto(
        "message M { oneof o { option deprecated = true; int32 a = 1; } }"
    )
