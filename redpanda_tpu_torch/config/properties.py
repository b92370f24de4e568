"""Typed cluster properties with live bindings.

Reference: src/v/config/property.h:63 (property<T>: name, description,
default, validation) and :280 (binding<T> — callbacks fired on change).
Values are plain strings on the wire (the controller command carries
key/value pairs); typing/validation happens at the registry.
"""

from __future__ import annotations

from typing import Any, Callable, Optional


class ConfigError(Exception):
    pass


def _parse_bool(v: str) -> bool:
    s = str(v).lower()
    if s in ("true", "1", "yes", "on"):
        return True
    if s in ("false", "0", "no", "off"):
        return False
    raise ConfigError(f"not a boolean: {v!r}")


_PARSERS: dict[str, Callable[[str], Any]] = {
    "int": int,
    "float": float,
    "bool": _parse_bool,
    "string": str,
}


class Property:
    def __init__(
        self,
        name: str,
        type_: str,
        default: Any,
        description: str = "",
        validator: Optional[Callable[[Any], Optional[str]]] = None,
        needs_restart: bool = False,
    ):
        if type_ not in _PARSERS:
            raise ValueError(f"unknown property type {type_}")
        self.name = name
        self.type = type_
        self.default = default
        self.description = description
        self.validator = validator
        self.needs_restart = needs_restart

    def parse(self, raw: str) -> Any:
        try:
            value = _PARSERS[self.type](raw)
        except (ValueError, TypeError) as e:
            raise ConfigError(f"{self.name}: {e}") from None
        if self.validator is not None:
            err = self.validator(value)
            if err:
                raise ConfigError(f"{self.name}: {err}")
        return value


def _positive(v) -> Optional[str]:
    return None if v > 0 else "must be > 0"


def _non_negative(v) -> Optional[str]:
    return None if v >= 0 else "must be >= 0"


def default_properties() -> list[Property]:
    """The cluster-level knobs this build exposes (the reference's
    configuration.cc registry, trimmed to implemented subsystems)."""
    return [
        Property(
            "cluster_license",
            "string",
            "",
            "Enterprise license key (validated on PUT; empty = unlicensed)",
        ),
        Property(
            "log_compaction_interval_s",
            "float",
            10.0,
            "Housekeeping (retention + compaction) pass interval",
            _positive,
        ),
        Property(
            "archival_interval_s",
            "float",
            1.0,
            "Tiered-storage upload pass interval",
            _positive,
        ),
        Property(
            "default_topic_retention_ms",
            "int",
            604800000,
            "Retention applied when a topic sets none",
            _positive,
        ),
        Property(
            "group_session_timeout_max_ms",
            "int",
            300000,
            "Upper bound accepted for consumer session timeouts",
            _positive,
        ),
        Property(
            "producer_id_expiration_ms",
            "int",
            24 * 3600 * 1000,
            "Idle idempotent-producer state is evicted after this "
            "long (rm_stm producer expiration); <= 0 disables",
        ),
        Property(
            "group_offset_retention_ms",
            "int",
            7 * 24 * 3600 * 1000,
            "Committed offsets of an EMPTY group expire after this "
            "long (KIP-211); <= 0 disables expiry",
        ),
        Property(
            "kafka_max_request_bytes",
            "int",
            100 * 1024 * 1024,
            "Largest accepted Kafka request frame",
            _positive,
        ),
        Property(
            "kafka_max_inflight_per_connection",
            "int",
            64,
            "Unwritten responses a single connection may have pending "
            "before its reader stops decoding ahead (pipelining window)",
            _positive,
        ),
        Property(
            "fetch_max_wait_cap_ms",
            "int",
            5000,
            "Server-side cap on fetch max_wait_ms",
            _non_negative,
        ),
        Property(
            "quota_produce_bytes_per_s",
            "int",
            0,
            "Per-client produce throughput quota (0 = unlimited)",
            _non_negative,
        ),
        Property(
            "quota_fetch_bytes_per_s",
            "int",
            0,
            "Per-client fetch throughput quota (0 = unlimited)",
            _non_negative,
        ),
        Property(
            "kafka_throughput_limit_node_in_bps",
            "int",
            0,
            "Node-wide ingress cap shared by ALL clients (snc quota; "
            "0 = unlimited)",
            _non_negative,
        ),
        Property(
            "kafka_throughput_limit_node_out_bps",
            "int",
            0,
            "Node-wide egress cap shared by ALL clients (snc quota; "
            "0 = unlimited)",
            _non_negative,
        ),
        Property(
            "raft_learner_recovery_rate",
            "int",
            64 * 1024 * 1024,
            "Node-wide raft catch-up/recovery rate budget shared by "
            "every lagging group (bytes/s)",
            _positive,
        ),
    ]


class ClusterConfig:
    """Registry + current values + bindings. Mutations come ONLY from
    applied controller commands (config_manager.cc apply), so every
    node holds identical values; bindings are local callbacks."""

    def __init__(self, properties: Optional[list[Property]] = None):
        self._props: dict[str, Property] = {
            p.name: p for p in (properties or default_properties())
        }
        self._values: dict[str, Any] = {}
        # raw (string) forms of the overrides in _values — what the
        # controller snapshot serializes, since parse() is one-way
        self._raws: dict[str, str] = {}
        self._bindings: dict[str, list[Callable[[Any], None]]] = {}
        self.version = 0

    def properties(self) -> dict[str, Property]:
        return dict(self._props)

    def get(self, name: str) -> Any:
        p = self._props.get(name)
        if p is None:
            raise ConfigError(f"unknown property {name}")
        return self._values.get(name, p.default)

    def is_default(self, name: str) -> bool:
        return name not in self._values

    def validate(self, name: str, raw: str) -> Any:
        p = self._props.get(name)
        if p is None:
            raise ConfigError(f"unknown property {name}")
        return p.parse(raw)

    def bind(self, name: str, fn: Callable[[Any], None]) -> None:
        """Live binding (property.h:280): fn(new_value) fires on every
        applied change, and once immediately with the current value."""
        if name not in self._props:
            raise ConfigError(f"unknown property {name}")
        self._bindings.setdefault(name, []).append(fn)
        fn(self.get(name))

    def apply(self, upserts: dict[str, str], removes: list[str]) -> None:
        """Controller-stm entry point — values were validated at the
        frontend; parse errors here (e.g. a newer node wrote a type
        this build can't parse) skip the key rather than halt apply."""
        for name, raw in upserts.items():
            p = self._props.get(name)
            if p is None:
                continue
            try:
                value = p.parse(raw)
            except ConfigError:
                continue
            self._values[name] = value
            self._raws[name] = raw
            for fn in self._bindings.get(name, []):
                fn(value)
        for name in removes:
            self._raws.pop(name, None)
            if name in self._values:
                del self._values[name]
                for fn in self._bindings.get(name, []):
                    fn(self.get(name))
        self.version += 1

    def raw_overrides(self) -> dict[str, str]:
        """Raw (string) forms of every non-default value — what the
        controller snapshot serializes (parse() is one-way)."""
        return dict(self._raws)

    def snapshot(self) -> dict[str, Any]:
        return {name: self.get(name) for name in self._props}
