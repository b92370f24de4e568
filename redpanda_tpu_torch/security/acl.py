"""ACL model + store + authorizer.

Reference: src/v/security/acl.h (acl_binding, resource_pattern,
acl_entry) and authorizer.h — Kafka-compatible enums (the wire values
in Describe/Create/DeleteAcls requests map 1:1), literal/prefixed/
wildcard pattern matching, deny-overrides-allow evaluation, and a
superuser bypass.
"""

from __future__ import annotations

import dataclasses
import enum
import fnmatch
from typing import Iterable

from ..utils import serde


class AclResourceType(enum.IntEnum):
    # Kafka AclResourceType wire values
    any = 1
    topic = 2
    group = 3
    cluster = 4
    transactional_id = 5


class AclPatternType(enum.IntEnum):
    any = 1  # filter-only
    match = 2  # filter-only
    literal = 3
    prefixed = 4


class AclOperation(enum.IntEnum):
    any = 1
    all = 2
    read = 3
    write = 4
    create = 5
    remove = 6  # Kafka DELETE
    alter = 7
    describe = 8
    cluster_action = 9
    describe_configs = 10
    alter_configs = 11
    idempotent_write = 12


class AclPermission(enum.IntEnum):
    any = 1
    deny = 2
    allow = 3


WILDCARD = "*"


# operations implied by others (authorizer.h acl_implied_ops)
_IMPLIED = {
    AclOperation.describe: (
        AclOperation.describe,
        AclOperation.read,
        AclOperation.write,
        AclOperation.remove,
        AclOperation.alter,
    ),
    AclOperation.describe_configs: (
        AclOperation.describe_configs,
        AclOperation.alter_configs,
    ),
}


@dataclasses.dataclass(frozen=True, slots=True)
class AclBinding:
    resource_type: AclResourceType
    pattern_type: AclPatternType  # literal | prefixed
    resource_name: str
    principal: str  # "User:name" or "User:*"
    host: str  # "*" or exact
    operation: AclOperation
    permission: AclPermission


class AclBindingE(serde.Envelope):
    SERDE_FIELDS = [
        ("resource_type", serde.u8),
        ("pattern_type", serde.u8),
        ("resource_name", serde.string),
        ("principal", serde.string),
        ("host", serde.string),
        ("operation", serde.u8),
        ("permission", serde.u8),
    ]

    @classmethod
    def from_binding(cls, b: AclBinding) -> "AclBindingE":
        return cls(
            resource_type=int(b.resource_type),
            pattern_type=int(b.pattern_type),
            resource_name=b.resource_name,
            principal=b.principal,
            host=b.host,
            operation=int(b.operation),
            permission=int(b.permission),
        )

    def to_binding(self) -> AclBinding:
        return AclBinding(
            AclResourceType(int(self.resource_type)),
            AclPatternType(int(self.pattern_type)),
            self.resource_name,
            self.principal,
            self.host,
            AclOperation(int(self.operation)),
            AclPermission(int(self.permission)),
        )


@dataclasses.dataclass(frozen=True, slots=True)
class AclFilter:
    """Describe/Delete filter; `any`/`match` wildcards allowed."""

    resource_type: AclResourceType = AclResourceType.any
    pattern_type: AclPatternType = AclPatternType.any
    resource_name: str | None = None
    principal: str | None = None
    host: str | None = None
    operation: AclOperation = AclOperation.any
    permission: AclPermission = AclPermission.any

    def matches(self, b: AclBinding) -> bool:
        if (
            self.resource_type != AclResourceType.any
            and self.resource_type != b.resource_type
        ):
            return False
        if self.pattern_type not in (AclPatternType.any, AclPatternType.match):
            if self.pattern_type != b.pattern_type:
                return False
        if self.resource_name is not None:
            if self.pattern_type == AclPatternType.match:
                if not _pattern_covers(
                    b.pattern_type, b.resource_name, self.resource_name
                ):
                    return False
            elif self.resource_name != b.resource_name:
                return False
        if self.principal is not None and self.principal != b.principal:
            return False
        if self.host is not None and self.host != b.host:
            return False
        if (
            self.operation != AclOperation.any
            and self.operation != b.operation
        ):
            return False
        if (
            self.permission != AclPermission.any
            and self.permission != b.permission
        ):
            return False
        return True


def _pattern_covers(
    pattern_type: AclPatternType, pattern_name: str, resource: str
) -> bool:
    if pattern_name == WILDCARD:
        return True
    if pattern_type == AclPatternType.prefixed:
        return resource.startswith(pattern_name)
    return pattern_name == resource


class AclStore:
    def __init__(self) -> None:
        self._bindings: set[AclBinding] = set()

    def add(self, bindings: Iterable[AclBinding]) -> None:
        self._bindings.update(bindings)

    def remove_matching(self, flt: AclFilter) -> list[AclBinding]:
        removed = [b for b in self._bindings if flt.matches(b)]
        self._bindings.difference_update(removed)
        return removed

    def describe(self, flt: AclFilter) -> list[AclBinding]:
        return sorted(
            (b for b in self._bindings if flt.matches(b)),
            key=lambda b: (b.resource_type, b.resource_name, b.principal),
        )

    def all(self) -> list[AclBinding]:
        return list(self._bindings)

    def find(
        self,
        resource_type: AclResourceType,
        resource: str,
        principal: str,
        host: str,
    ) -> list[AclBinding]:
        out = []
        for b in self._bindings:
            if b.resource_type != resource_type:
                continue
            if not _pattern_covers(b.pattern_type, b.resource_name, resource):
                continue
            if b.principal not in (principal, "User:" + WILDCARD):
                continue
            if b.host not in (host, WILDCARD):
                continue
            out.append(b)
        return out


class Authorizer:
    """Deny-overrides-allow evaluation with superuser bypass
    (reference: security/authorizer.h authorized())."""

    def __init__(self, store: AclStore, superusers: set[str] | None = None):
        self.store = store
        self.superusers = superusers or set()

    def authorized(
        self,
        resource_type: AclResourceType,
        resource: str,
        operation: AclOperation,
        principal: str,
        host: str = "*",
    ) -> bool:
        if principal in self.superusers or principal.removeprefix(
            "User:"
        ) in self.superusers:
            return True
        candidates = self.store.find(resource_type, resource, principal, host)
        ops = _IMPLIED.get(operation, (operation,))
        for b in candidates:
            if b.permission == AclPermission.deny and b.operation in (
                AclOperation.all,
                operation,
            ):
                return False
        for b in candidates:
            if b.permission == AclPermission.allow and (
                b.operation == AclOperation.all or b.operation in ops
            ):
                return True
        return False
