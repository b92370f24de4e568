"""JSON Schema structural compatibility for the schema registry.

Reference: src/v/pandaproxy/schema_registry (json compat in the
Confluent model): BACKWARD means every instance valid under the OLD
schema must validate under the NEW one — i.e. the new schema is at
least as PERMISSIVE. This module implements that as a conservative
subset check over the JSON Schema keywords the registry's users
actually rely on: type, properties/required/additionalProperties,
items, enum, numeric and length bounds. Anything it cannot prove
permissive is reported as a violation (fail closed), so FULL remains
sound: a pass here guarantees compatibility for the covered keyword
set; exotic keywords (oneOf/allOf/$ref/pattern...) are compared for
equality and flagged when they differ.

FORWARD swaps the operands; FULL and the _TRANSITIVE variants compose
in schema_registry.compatible exactly like Avro's.
"""

from __future__ import annotations

import json as _json

_TYPE_WIDENING = {
    # an integer instance also validates as "number"
    ("number", "integer"),
}

_EXOTIC = (
    "oneOf", "anyOf", "allOf", "not", "$ref", "pattern",
    "patternProperties", "dependencies", "if", "then", "else",
    "propertyNames", "contains", "uniqueItems", "multipleOf",
    "format",
)


def _types(schema: dict) -> set[str] | None:
    t = schema.get("type")
    if t is None:
        return None  # unconstrained
    return set(t) if isinstance(t, list) else {t}


def _accepts_type(new_types: set[str] | None, old: str) -> bool:
    if new_types is None:
        return True
    if old in new_types:
        return True
    return any((n, old) in _TYPE_WIDENING for n in new_types)


def _check(new, old, path: str, errs: list[str]) -> None:
    """Record violations where `new` is NOT at least as permissive as
    `old` (instances valid under old could fail under new)."""
    if isinstance(new, bool) or isinstance(old, bool):
        # boolean schemas: true = anything, false = nothing
        if new is True or old is False:
            return
        if new is False and old is not False:
            errs.append(f"{path}: schema narrowed to 'false'")
            return
        new = new if isinstance(new, dict) else {}
        old = old if isinstance(old, dict) else {}
    if not isinstance(new, dict) or not isinstance(old, dict):
        if new != old:
            errs.append(f"{path}: unsupported schema form changed")
        return

    # exotic keywords: proven only by equality (fail closed otherwise)
    for kw in _EXOTIC:
        if new.get(kw) != old.get(kw):
            errs.append(f"{path}: '{kw}' changed (unsupported for "
                        f"structural compat; treated as narrowing)")

    # type: the new set must accept every old type (absent = anything)
    old_types = _types(old)
    new_types = _types(new)
    if new_types is not None:
        for t in old_types if old_types is not None else {
            "null", "boolean", "integer", "number", "string", "array",
            "object",
        }:
            if not _accepts_type(new_types, t):
                errs.append(
                    f"{path}: type no longer accepts '{t}' "
                    f"(TYPE_NARROWED)"
                )

    # enum: new must accept every old value (absent new enum = open).
    # JSON-distinct comparison: Python equates True==1 and False==0,
    # JSON does not — compare serialized forms.
    if "enum" in new:
        old_enum = old.get("enum")
        if old_enum is None:
            errs.append(f"{path}: enum added where values were open "
                        f"(ENUM_ADDED)")
        else:
            new_keys = {_json.dumps(v, sort_keys=True) for v in new["enum"]}
            missing = [
                v
                for v in old_enum
                if _json.dumps(v, sort_keys=True) not in new_keys
            ]
            if missing:
                errs.append(
                    f"{path}: enum values removed {missing!r} "
                    f"(ENUM_NARROWED)"
                )

    # numeric/length/item-count bounds: new must not tighten
    for lo, hi in (
        ("minimum", "maximum"),
        ("exclusiveMinimum", "exclusiveMaximum"),
        ("minLength", "maxLength"),
        ("minItems", "maxItems"),
        ("minProperties", "maxProperties"),
    ):
        for kw, tighter_if in ((lo, "raised"), (hi, "lowered")):
            nv, ov = new.get(kw), old.get(kw)
            if nv is None:
                continue
            if ov is None:
                errs.append(f"{path}: '{kw}' added (BOUND_ADDED)")
            elif (tighter_if == "raised" and nv > ov) or (
                tighter_if == "lowered" and nv < ov
            ):
                errs.append(f"{path}: '{kw}' {tighter_if} "
                            f"{ov} -> {nv} (BOUND_NARROWED)")

    # required: new may not require anything old did not
    new_req = set(new.get("required") or [])
    old_req = set(old.get("required") or [])
    for prop in sorted(new_req - old_req):
        errs.append(
            f"{path}: property '{prop}' became required "
            f"(REQUIRED_ADDED)"
        )

    # properties: shared ones recurse; one-sided ones are governed by
    # the OTHER side's additionalProperties schema — old instances may
    # carry any old-valid value there, so the new constraint must be
    # at least as permissive as whatever the old side allowed.
    new_props = new.get("properties") or {}
    old_props = old.get("properties") or {}
    old_ap = old.get("additionalProperties", True)
    new_ap = new.get("additionalProperties", True)
    for name in sorted(set(new_props) & set(old_props)):
        _check(new_props[name], old_props[name],
               f"{path}.{name}", errs)
    for name in sorted(set(new_props) - set(old_props)):
        # old governed this property via its additionalProperties: the
        # new named constraint must accept everything old allowed
        # there. (With an OPEN old content model this flags any typed
        # addition — per JSON Schema semantics that IS a narrowing;
        # close the content model for evolvability, as the Confluent
        # guidance says.)
        _check(new_props[name], old_ap, f"{path}.{name}", errs)
    if new_ap is False:
        for name in sorted(set(old_props) - set(new_props)):
            errs.append(
                f"{path}: property '{name}' removed while "
                f"additionalProperties is false (PROPERTY_CLOSED)"
            )
        if old_ap is not False:
            errs.append(
                f"{path}: additionalProperties closed "
                f"(ADDITIONAL_PROPERTIES_NARROWED)"
            )
    else:
        for name in sorted(set(old_props) - set(new_props)):
            # new governs the removed property via additionalProperties
            _check(new_ap, old_props[name], f"{path}.{name}", errs)
        if isinstance(new_ap, dict):
            _check(
                new_ap,
                old_ap if isinstance(old_ap, (dict, bool)) else True,
                f"{path}.additionalProperties",
                errs,
            )

    # items (array element schema)
    if "items" in new:
        _check(new["items"], old.get("items", True), f"{path}[]", errs)


class JsonCompatError(ValueError):
    """The document parses as JSON but is not schema-shaped."""


def check_backward(new_schema, old_schema) -> list[str]:
    """Violations preventing instances valid under OLD from validating
    under NEW; empty list = backward compatible. Raises
    JsonCompatError on non-schema-shaped input (callers fall back to
    equality, like the protobuf branch)."""
    errs: list[str] = []
    try:
        _check(new_schema, old_schema, "$", errs)
    except (TypeError, AttributeError, ValueError) as e:
        raise JsonCompatError(str(e)) from e
    return errs
