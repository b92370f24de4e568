"""tests/test_json_compat.py run on the port: all 12 test functions,
with imports pointed at redpanda_tpu_torch. An autouse fixture sets
`ops.default_device` (the codec and CRC entries' device) to "cpu".
`http` and `proxy_broker` come from `test_torch_ref_http_services`.
Nothing is left out.


JSON Schema structural compatibility (registry).

Reference: the Confluent-model JSON compat the reference's schema
registry performs — BACKWARD = the new schema is at least as
permissive as the old. End-to-end drives go through the real registry
HTTP surface.
"""

import asyncio
import json

import pytest

from redpanda_tpu_torch.proxy.json_compat import check_backward

from test_torch_ref_http_services import http, proxy_broker  # noqa: F401
from redpanda_tpu_torch.ops import default_device


@pytest.fixture(autouse=True)
def _plain_on_cpu(monkeypatch):
    # the port's codec and CRC entries run on the card by default; on
    # the CPU they run the kernels' plain PyTorch versions
    monkeypatch.setattr(default_device, "DEVICE", "cpu")

# closed content model: the evolvable shape (Confluent guidance) —
# with an OPEN model, adding any typed property is a genuine narrowing
V1 = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "age": {"type": "integer", "minimum": 0},
        "tags": {"type": "array", "items": {"type": "string"}},
        "kind": {"enum": ["a", "b"]},
    },
    "required": ["name"],
    "additionalProperties": False,
}


def test_widening_is_backward_compatible():
    v2 = json.loads(json.dumps(V1))
    v2["properties"]["age"] = {"type": ["integer", "null"], "minimum": 0}
    v2["properties"]["kind"] = {"enum": ["a", "b", "c"]}
    v2["properties"]["extra"] = {"type": "string"}  # new optional prop
    del v2["required"]  # nothing required anymore
    assert check_backward(v2, V1) == []


def test_integer_to_number_widens():
    v2 = json.loads(json.dumps(V1))
    v2["properties"]["age"] = {"type": "number", "minimum": 0}
    assert check_backward(v2, V1) == []
    # ...but number -> integer narrows
    errs = check_backward(V1, v2)
    assert any("TYPE_NARROWED" in e for e in errs), errs


def test_new_required_field_is_violation():
    v2 = json.loads(json.dumps(V1))
    v2["required"] = ["name", "age"]
    errs = check_backward(v2, V1)
    assert any("REQUIRED_ADDED" in e for e in errs), errs


def test_enum_narrowing_is_violation():
    v2 = json.loads(json.dumps(V1))
    v2["properties"]["kind"] = {"enum": ["a"]}
    errs = check_backward(v2, V1)
    assert any("ENUM_NARROWED" in e for e in errs), errs


def test_bound_tightening_is_violation():
    v2 = json.loads(json.dumps(V1))
    v2["properties"]["age"] = {"type": "integer", "minimum": 18}
    errs = check_backward(v2, V1)
    assert any("BOUND_NARROWED" in e for e in errs), errs


def test_closing_additional_properties_is_violation():
    open_v1 = {"type": "object", "properties": {"a": {"type": "string"}}}
    v2 = json.loads(json.dumps(open_v1))
    v2["additionalProperties"] = False
    errs = check_backward(v2, open_v1)
    assert any("ADDITIONAL_PROPERTIES_NARROWED" in e for e in errs), errs


def test_typed_property_added_to_open_model_is_violation():
    """With an OPEN old content model, old instances may carry 'x' in
    ANY shape — a typed new 'x' rejects some of them."""
    old = {"type": "object"}
    new = {"type": "object", "properties": {"x": {"type": "integer"}}}
    errs = check_backward(new, old)
    assert errs, "typed addition to an open model must be flagged"


def test_bool_int_enum_values_are_json_distinct():
    old = {"enum": [0, 1]}
    new = {"enum": [False, True]}
    errs = check_backward(new, old)
    assert any("ENUM_NARROWED" in e for e in errs), errs


def test_non_schema_shaped_input_raises_cleanly():
    from redpanda_tpu_torch.proxy.json_compat import JsonCompatError

    with pytest.raises(JsonCompatError):
        check_backward({"minimum": "x"}, {"minimum": 0})


def test_items_recursion():
    v2 = json.loads(json.dumps(V1))
    v2["properties"]["tags"]["items"] = {"type": "integer"}
    errs = check_backward(v2, V1)
    assert any("tags[]" in e and "TYPE_NARROWED" in e for e in errs), errs


def test_exotic_keywords_fail_closed():
    old = {"type": "string", "pattern": "^a"}
    new = {"type": "string", "pattern": "^b"}
    assert check_backward(new, old)  # changed pattern: flagged
    assert check_backward(old, old) == []  # unchanged: fine


async def _registry_json(tmp_path):
    async with proxy_broker(tmp_path) as b:
        addr = b.schema_registry.address
        st, body = await http(
            addr, "POST", "/subjects/j-value/versions",
            {"schema": json.dumps(V1), "schemaType": "JSON"},
        )
        assert st == 200, body
        # structural (not textual) widening accepted at BACKWARD
        v2 = json.loads(json.dumps(V1))
        v2["properties"]["nick"] = {"type": "string"}
        st, body = await http(
            addr, "POST", "/subjects/j-value/versions",
            {"schema": json.dumps(v2), "schemaType": "JSON"},
        )
        assert st == 200, body
        # narrowing rejected
        v3 = json.loads(json.dumps(v2))
        v3["required"] = ["name", "nick"]
        st, body = await http(
            addr, "POST", "/subjects/j-value/versions",
            {"schema": json.dumps(v3), "schemaType": "JSON"},
        )
        assert st == 409, body


def test_registry_json_end_to_end(tmp_path):
    asyncio.run(_registry_json(tmp_path))
