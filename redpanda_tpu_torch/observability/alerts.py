"""Flight-data plane, part 2: burn-rate SLO alerting.

The SLO declarations already exist — `bench_profiles/slo_*.json` grade
`bench.py --slo` runs offline. This module loads the *same* files at
broker startup and judges them live against the metrics-history ring
(`flightdata.MetricsHistory`), using the SRE multi-window burn-rate
pattern: a rule fires only when BOTH a fast window (default 1 min —
catches the burn quickly) and a slow window (default 10 min — rejects
blips) breach, and clears as soon as the fast window recovers. Burn
rate is observed/threshold, so 1.0 is exactly "burning the budget".

A firing alert carries the evidence, not just a boolean: the breaching
windowed quantile from the ring, the top-k hot NTPs from the load
ledger at fire time, and — when the continuous profiler is running —
a collapsed-stack snapshot of the seconds leading up to the breach
(the profiler ring already holds them; capture is a read, not a wait).

Surfaces: `GET /v1/alerts`, additive keys in `health_overview`, and a
scalar `alerts_firing` gauge plus a transitions counter labeled by the
(statically bounded) rule name — inside RPL012 cardinality discipline.
Stand-down: `RP_ALERTS=0`.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from collections import deque
from typing import Callable, Optional

from .flightdata import MetricsHistory
from ..utils.tasks import cancel_and_wait

logger = logging.getLogger("alerts")

ENABLED = os.environ.get("RP_ALERTS", "1") != "0"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


DEFAULT_FAST_S = _env_float("RP_ALERT_FAST_S", 60.0)
DEFAULT_SLOW_S = _env_float("RP_ALERT_SLOW_S", 600.0)
DEFAULT_PROFILE = os.environ.get("RP_SLO_PROFILE", "default")

_PROFILE_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "bench_profiles"
)

# mirror of bench_profiles/slo_default.json's "slo" block, used when
# the profile files are not shipped next to the package
_BUILTIN_SLO = {"p99_ms": 40.0, "p999_ms": 160.0, "max_lag": 1024}


def load_slo_profile(name: Optional[str] = None) -> dict:
    """The declaration `bench.py --slo` grades against, reused live.
    `name` is a profile name (default/single/tiered) or a path to a
    json file; a missing file degrades to the built-in default block
    rather than refusing to boot the broker."""
    name = name or DEFAULT_PROFILE
    path = (
        name
        if name.endswith(".json")
        else os.path.join(_PROFILE_DIR, f"slo_{name}.json")
    )
    try:
        with open(path) as f:
            prof = json.load(f)
        slo = dict(prof.get("slo") or {})
        label = str(prof.get("profile", name))
    except (OSError, ValueError):
        logger.warning(
            "slo profile %r not loadable; using built-in default", path
        )
        slo, label = dict(_BUILTIN_SLO), "builtin-default"
    return {"profile": label, "slo": slo}


class AlertRule:
    """One live SLO clause. kind "quantile" judges a windowed
    histogram quantile; kind "gauge" judges the window max of a gauge
    family; kind "counter" judges the in-window delta of a counter
    family (reset-aware, so a crashed-and-reborn shard's restart does
    not read as a burst) — threshold 0.0 means "any increment fires",
    the shape the devplane invariants use."""

    __slots__ = (
        "name", "kind", "family", "labels", "q", "threshold", "unit",
        "description",
    )

    def __init__(
        self,
        name: str,
        kind: str,
        family: str,
        labels: Optional[dict],
        q: float,
        threshold: float,
        unit: str,
        description: str,
    ):
        self.name = name
        self.kind = kind
        self.family = family
        self.labels = labels
        self.q = q
        self.threshold = threshold
        self.unit = unit
        self.description = description

    def describe(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "family": self.family,
            "labels": self.labels or {},
            "q": self.q,
            "threshold": self.threshold,
            "unit": self.unit,
            "description": self.description,
        }


_STAGE_FAMILY = "redpanda_tpu_kafka_request_stage_seconds"
_LAG_FAMILY = "redpanda_tpu_partition_health_max_follower_lag"
_SKEW_FAMILY = "redpanda_tpu_placement_shard_skew"


def shard_skew_rule(threshold: Optional[float] = None) -> AlertRule:
    """Gauge rule over the placement layer's cross-shard skew index
    (1.0 = balanced). Firing hands the alert — hot NTPs attached — to
    the Rebalancer via on_fire (the placement closed loop). Tunable:
    RP_SKEW_ALERT_THRESHOLD."""
    if threshold is None:
        threshold = _env_float("RP_SKEW_ALERT_THRESHOLD", 2.0)
    return AlertRule(
        "shard_skew", "gauge", _SKEW_FAMILY, None,
        0.0, float(threshold), "ratio",
        "cross-shard load skew index vs the rebalance threshold",
    )


def rules_from_slo(slo: dict) -> list[AlertRule]:
    rules: list[AlertRule] = []
    if "p99_ms" in slo:
        rules.append(
            AlertRule(
                "produce_p99", "quantile", _STAGE_FAMILY,
                {"api": "produce", "stage": "done"},
                0.99, float(slo["p99_ms"]) / 1000.0, "s",
                "windowed produce e2e p99 vs the declared SLO",
            )
        )
    if "p999_ms" in slo:
        rules.append(
            AlertRule(
                "produce_p999", "quantile", _STAGE_FAMILY,
                {"api": "produce", "stage": "done"},
                0.999, float(slo["p999_ms"]) / 1000.0, "s",
                "windowed produce e2e p99.9 vs the declared SLO",
            )
        )
    if "max_lag" in slo:
        rules.append(
            AlertRule(
                "replication_lag", "gauge", _LAG_FAMILY, None,
                0.0, float(slo["max_lag"]), "entries",
                "worst follower lag vs the declared SLO",
            )
        )
    return rules


class AlertManager:
    def __init__(
        self,
        history: MetricsHistory,
        *,
        rules: Optional[list[AlertRule]] = None,
        profile: Optional[str] = None,
        ledger=None,
        profiler=None,
        registry=None,
        fast_s: Optional[float] = None,
        slow_s: Optional[float] = None,
        interval_s: Optional[float] = None,
        min_count: int = 8,
        top_k: int = 3,
        capture_s: Optional[float] = None,
        history_len: int = 64,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
    ):
        self.history = history
        if rules is None:
            prof = load_slo_profile(profile)
            self.profile = prof["profile"]
            rules = rules_from_slo(prof["slo"])
        else:
            self.profile = profile or "custom"
        self.rules = rules
        self.ledger = ledger
        self.profiler = profiler
        self.fast_s = DEFAULT_FAST_S if fast_s is None else float(fast_s)
        self.slow_s = DEFAULT_SLOW_S if slow_s is None else float(slow_s)
        # evaluate several times per fast window so "fires within two
        # fast windows" holds with margin
        self.interval_s = (
            max(0.25, min(15.0, self.fast_s / 6.0))
            if interval_s is None
            else float(interval_s)
        )
        self.min_count = int(min_count)
        self.top_k = int(top_k)
        self.capture_s = (
            min(30.0, max(5.0, self.fast_s))
            if capture_s is None
            else float(capture_s)
        )
        self._clock = clock
        self._wall = wall_clock
        self.active: dict[str, dict] = {}
        # async callbacks invoked (from the evaluation loop) with each
        # alert dict on its firing transition — e.g. the placement
        # Rebalancer's bounded rebalance (alert-closed loop)
        self.on_fire: list = []
        self.recent: deque[dict] = deque(maxlen=history_len)
        self.evaluations = 0
        self._task: Optional[asyncio.Task] = None
        self._transitions = None
        if registry is not None:
            registry.gauge(
                "alerts_firing",
                lambda: len(self.active),
                "SLO burn-rate alerts currently firing",
            )
            self._transitions = registry.counter(
                "alerts_transitions_total",
                "alert state transitions (labels: statically bounded "
                "rule names, never per-NTP)",
            )

    # -- evaluation ---------------------------------------------------
    def _observe(self, rule: AlertRule, window_s: float) -> dict:
        """{"value", "count"} for one rule over one window; value 0.0
        with count 0 when the ring has no data yet."""
        if rule.kind == "quantile":
            w = self.history.quantile(
                rule.family, window_s, rule.q, rule.labels
            )
            if w is None:
                return {"value": 0.0, "count": 0}
            return {"value": w["value"], "count": w["count"]}
        if rule.kind == "counter":
            w = self.history.counter_window(
                rule.family, window_s, rule.labels
            )
            if w is None:
                return {"value": 0.0, "count": 0}
            # count carries the number of matching label series so
            # _breaches can tell "family absent/quiet" (no fire at
            # threshold 0) from "a series moved"
            return {"value": w["total_delta"], "count": len(w["series"])}
        w = self.history.gauge_window(rule.family, window_s, rule.labels)
        if w is None or not w["series"]:
            return {"value": 0.0, "count": 0}
        return {
            "value": max(r["max"] for r in w["series"]),
            "count": w["samples"],
        }

    def _breaches(self, rule: AlertRule, obs: dict) -> bool:
        if rule.kind == "quantile" and obs["count"] < self.min_count:
            return False
        if rule.kind in ("gauge", "counter") and obs["count"] == 0:
            return False
        return obs["value"] > rule.threshold

    def evaluate(self) -> list[dict]:
        """One pass over all rules; returns the transitions it made."""
        self.evaluations += 1
        transitions = []
        for rule in self.rules:
            fast = self._observe(rule, self.fast_s)
            slow = self._observe(rule, self.slow_s)
            thr = rule.threshold or 1e-12
            burn_fast = fast["value"] / thr
            burn_slow = slow["value"] / thr
            alert = self.active.get(rule.name)
            if alert is None:
                if self._breaches(rule, fast) and self._breaches(rule, slow):
                    alert = self._fire(rule, fast, slow, burn_fast, burn_slow)
                    transitions.append(alert)
            else:
                # live-update the observed numbers while firing
                alert["observed"] = {"fast": fast, "slow": slow}
                alert["burn"] = {"fast": burn_fast, "slow": burn_slow}
                if not self._breaches(rule, fast):
                    self._clear(rule, alert)
                    transitions.append(alert)
        return transitions

    def _fire(self, rule, fast, slow, burn_fast, burn_slow) -> dict:
        alert = {
            "name": rule.name,
            "state": "firing",
            "rule": rule.describe(),
            "fired_wall": self._wall(),
            "fired_mono": self._clock(),
            "cleared_wall": None,
            "observed": {"fast": fast, "slow": slow},
            "burn": {"fast": burn_fast, "slow": burn_slow},
            "windows": {"fast_s": self.fast_s, "slow_s": self.slow_s},
            "hot_ntps": [],
            "profile": None,
        }
        if self.ledger is not None:
            try:
                alert["hot_ntps"] = self.ledger.top(self.top_k)
            except Exception:
                pass
        if self.profiler is not None and self.profiler.running():
            # the continuous ring already holds the breach window —
            # snapshot it now, no waiting, so the alert ships with the
            # stacks that were running while the budget burned
            try:
                alert["profile"] = self.profiler.snapshot(
                    self.capture_s, limit=20
                )
            except Exception:
                pass
        self.active[rule.name] = alert
        if self._transitions is not None:
            self._transitions.inc(alert=rule.name, to="firing")
        logger.warning(
            "alert firing: %s observed=%.6g threshold=%.6g "
            "(burn fast=%.2f slow=%.2f)",
            rule.name, alert["observed"]["fast"]["value"], rule.threshold,
            burn_fast, burn_slow,
        )
        return alert

    def _clear(self, rule, alert) -> None:
        alert["state"] = "cleared"
        alert["cleared_wall"] = self._wall()
        alert["duration_s"] = self._clock() - alert["fired_mono"]
        del self.active[rule.name]
        self.recent.append(alert)
        if self._transitions is not None:
            self._transitions.inc(alert=rule.name, to="cleared")
        logger.warning(
            "alert cleared: %s after %.1fs", rule.name, alert["duration_s"]
        )

    # -- lifecycle ----------------------------------------------------
    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                transitions = self.evaluate()
            except Exception:
                logger.exception("alert evaluation failed")
                continue
            for alert in transitions:
                if alert.get("state") != "firing":
                    continue
                for hook in list(self.on_fire):
                    try:
                        await hook(alert)
                    except Exception:
                        logger.exception("alert on_fire hook failed")

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        task, self._task = self._task, None
        await cancel_and_wait(task)

    # -- surfacing ----------------------------------------------------
    def status(self) -> dict:
        return {
            "enabled": True,
            "profile": self.profile,
            "fast_window_s": self.fast_s,
            "slow_window_s": self.slow_s,
            "interval_s": self.interval_s,
            "evaluations": self.evaluations,
            "rules": [r.describe() for r in self.rules],
            "firing": sorted(
                self.active.values(), key=lambda a: a["fired_mono"]
            ),
            "recent": list(self.recent),
        }

    def overview(self) -> dict:
        """The additive health_overview keys."""
        return {
            "alerts_firing": len(self.active),
            "alerts": sorted(self.active),
        }
