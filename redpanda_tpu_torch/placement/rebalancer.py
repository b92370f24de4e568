"""Alert-driven bounded rebalancer: closes the loop from the flight
-data plane to the placement layer.

All the signals already exist — the load ledger's per-NTP EWMA rates
and skew index (PR 8), burn-rate alerts that attach hot NTPs at fire
time (PR 10) — this consumes them. A sampling loop maintains per-shard
byte-rate EWMAs (shard 0 from the broker's own ledger, worker shards
from ShardStats counter deltas) and exposes the cross-shard skew index
as a gauge (`redpanda_tpu_placement_shard_skew`). When the
`shard_skew` or a latency burn-rate alert fires, `on_alert` picks
movers from the alert's attached hot-NTP list — hottest partitions on
the hottest shard — and moves them to the coldest shard, bounded by
the mover's per-window MoveBudget so an oscillating signal cannot
thrash the fleet. Every action lands in `history` for the admin
surface and the bench's SLO verdict.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time

from ..models.fundamental import DEFAULT_NS, NTP
from ..observability.load_ledger import skew_of
from .mover import MoveBudgetExhausted, MoveError

logger = logging.getLogger("placement.rebalancer")

SKEW_FAMILY = "placement_shard_skew"
# EWMA half-life for the per-shard rate estimate
_ALPHA = 0.3


class Rebalancer:
    """Per-broker (shard 0) placement feedback loop."""

    def __init__(
        self,
        broker,
        mover,
        table,
        interval_s: float = 1.0,
        max_moves_per_alert: int = 2,
        clock=time.monotonic,
    ):
        self.broker = broker
        self.mover = mover
        self.table = table
        self.interval_s = interval_s
        self.max_moves_per_alert = max_moves_per_alert
        self._clock = clock
        self._task: asyncio.Task | None = None
        # shard → EWMA byte rate; worker shards also carry the last
        # cumulative counter + stamp for the delta
        self._rate: dict[int, float] = {}
        self._last_counter: dict[int, tuple[float, float]] = {}
        self.history: list[dict] = []
        self.alerts_handled = 0
        # elastic capacity actions: the ShardLifecycle (wired by the
        # sharded broker) turns a sustained hot/idle signal into real
        # grow/retire, gated by RP_ELASTIC=1 and the lifecycle budget
        self.lifecycle = None
        self.grow_bps = float(os.environ.get("RP_ELASTIC_GROW_BPS", "1e6"))
        self.idle_bps = float(os.environ.get("RP_ELASTIC_IDLE_BPS", "1e3"))
        self.scale_ticks = int(os.environ.get("RP_ELASTIC_TICKS", "5"))
        self._hot_ticks = 0
        self._idle_ticks: dict[int, int] = {}
        self.scale_actions: list[dict] = []

    # -- load sampling ------------------------------------------------
    def _note_rate(self, shard: int, rate_bps: float) -> None:
        prev = self._rate.get(shard)
        self._rate[shard] = (
            rate_bps
            if prev is None
            else prev + _ALPHA * (rate_bps - prev)
        )

    async def sample(self) -> None:
        """One load observation across all shards."""
        led = getattr(self.broker, "load_ledger", None)
        if led is not None:
            self._note_rate(0, float(led.totals()["total_bps"]))
        router = getattr(self.broker, "shard_router", None)
        if router is None:
            return
        for sid in router.worker_shards():
            try:
                st = await router.stats(sid)
            except Exception:
                logger.debug(
                    "placement: stats poll failed for shard %d",
                    sid,
                    exc_info=True,
                )
                continue
            total = float(st.produce_bytes + st.fetch_bytes)
            now = self._clock()
            prev = self._last_counter.get(sid)
            self._last_counter[sid] = (now, total)
            if prev is None or now <= prev[0]:
                continue
            self._note_rate(sid, (total - prev[1]) / (now - prev[0]))

    def skew(self) -> float:
        """Cross-shard skew index (1.0 = balanced), same definition as
        the per-NTP ledger skew — the gauge the shard_skew alert
        judges."""
        active = self.table.active_shards()
        if len(active) <= 1:
            return 1.0
        return skew_of([self._rate.get(s, 0.0) for s in active])

    def shard_rates(self) -> dict[int, float]:
        return dict(self._rate)

    # -- the loop -----------------------------------------------------
    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.sample()
            except Exception:
                logger.exception("placement load sample failed")
            try:
                await self.maybe_scale()
            except Exception:
                logger.exception("placement scale action failed")

    # -- elastic capacity ---------------------------------------------
    async def maybe_scale(self) -> dict | None:
        """Grow-on-hot / retire-on-idle: when EVERY live worker's EWMA
        rate holds above `grow_bps` for `scale_ticks` consecutive
        samples, fork one more shard; when a worker (of several) holds
        below `idle_bps` that long, evacuate and retire it. Inert
        unless RP_ELASTIC=1; every action charges the lifecycle
        budget, so an oscillating signal cannot thrash fork/retire."""
        lc = self.lifecycle
        if lc is None or not lc.auto:
            return None
        router = getattr(self.broker, "shard_router", None)
        if router is None:
            return None
        workers = [s for s in router.worker_shards() if s in self._rate]
        if not workers:
            return None
        rates = {s: self._rate[s] for s in workers}
        if all(r >= self.grow_bps for r in rates.values()):
            self._hot_ticks += 1
        else:
            self._hot_ticks = 0
        for s in list(self._idle_ticks):
            if s not in rates:
                del self._idle_ticks[s]
        for s, r in rates.items():
            self._idle_ticks[s] = (
                self._idle_ticks.get(s, 0) + 1 if r <= self.idle_bps else 0
            )
        act: dict | None = None
        if self._hot_ticks >= self.scale_ticks:
            self._hot_ticks = 0
            try:
                sid = await lc.grow()
                act = {"action": "grow", "shard": sid}
            except Exception as e:
                act = {"action": "grow", "failed": str(e)}
        elif len(workers) > 1:
            idle = [
                s
                for s in workers
                if self._idle_ticks.get(s, 0) >= self.scale_ticks
            ]
            if idle:
                sid = min(idle, key=lambda s: rates[s])
                self._idle_ticks[sid] = 0
                try:
                    await lc.retire(sid)
                    act = {"action": "retire", "shard": sid}
                except Exception as e:
                    act = {"action": "retire", "shard": sid,
                           "failed": str(e)}
        if act is not None:
            act["rates_bps"] = {
                str(k): round(v, 1) for k, v in sorted(rates.items())
            }
            self.scale_actions.append(act)
            del self.scale_actions[:-32]
            logger.info("elastic scale action: %s", act)
        return act

    # -- alert hook ---------------------------------------------------
    def wants(self, alert: dict) -> bool:
        name = alert.get("name", "")
        return name == "shard_skew" or name.startswith("produce_p")

    async def on_alert(self, alert: dict) -> dict:
        """AlertManager on_fire hook: bounded rebalance using the
        alert's attached hot-NTP list."""
        if not self.wants(alert) or self.table.shard_count <= 1:
            return {"acted": False, "reason": "not a placement alert"}
        self.alerts_handled += 1
        result = await self.rebalance_once(
            hot_ntps=alert.get("hot_ntps") or [],
            reason=f"alert:{alert.get('name')}",
        )
        return result

    def _pick_shards(self) -> tuple[int, int]:
        """(hottest, coldest) shard by EWMA rate; partition count
        breaks ties so an idle fleet still spreads."""
        counts = self.table.counts()
        key = lambda s: (self._rate.get(s, 0.0), counts.get(s, 0))
        shards = self.table.active_shards()
        return max(shards, key=key), min(shards, key=key)

    async def rebalance_once(
        self, hot_ntps: list[dict] | None = None, reason: str = "manual"
    ) -> dict:
        """Pick movers from `hot_ntps` (ledger.top shape: {"key":
        "ns/topic/partition", ...}, hottest first) that live on the
        hottest shard and move them to the coldest, bounded by
        max_moves_per_alert and the mover's budget."""
        src, dst = self._pick_shards()
        actions: list[dict] = []
        verdict = {
            "reason": reason,
            "skew_before": round(self.skew(), 3),
            "from_shard": src,
            "to_shard": dst,
            "moves": actions,
        }
        if src == dst:
            verdict["outcome"] = "balanced"
            return self._done(verdict)
        candidates = []
        for h in hot_ntps or []:
            key = h.get("key", "")
            parts = key.split("/")
            if len(parts) != 3:
                continue
            try:
                ntp = NTP(parts[0], parts[1], int(parts[2]))
            except ValueError:
                continue
            if ntp.ns != DEFAULT_NS or ntp.topic.startswith("__"):
                continue
            if self.table.shard_for(ntp) == src:
                candidates.append(ntp)
        if not candidates:
            # no attached hot list (or none on the hot shard): fall
            # back to any partition of the hot shard
            candidates = [
                ntp
                for ntp, s in self.table._ntp.items()
                if s == src
                and ntp.ns == DEFAULT_NS
                and not ntp.topic.startswith("__")
            ][: self.max_moves_per_alert]
        moved = 0
        for ntp in candidates:
            if moved >= self.max_moves_per_alert:
                break
            try:
                out = await self.mover.move(ntp, dst)
                actions.append(out)
                if out.get("moved"):
                    moved += 1
            except MoveBudgetExhausted as e:
                actions.append({"moved": False, "reason": str(e)})
                break
            except MoveError as e:
                actions.append({"moved": False, "reason": str(e)})
        verdict["outcome"] = "moved" if moved else "no_moves"
        verdict["moved"] = moved
        return self._done(verdict)

    def _done(self, verdict: dict) -> dict:
        verdict["skew_after"] = round(self.skew(), 3)
        self.history.append(verdict)
        del self.history[:-32]
        logger.info(
            "rebalance (%s): %s, %d moves, skew %.2f -> %.2f",
            verdict["reason"], verdict["outcome"],
            verdict.get("moved", 0),
            verdict["skew_before"], verdict["skew_after"],
        )
        return verdict

    def describe(self) -> dict:
        return {
            "skew": round(self.skew(), 3),
            "shard_rates_bps": {
                str(k): round(v, 1) for k, v in sorted(self._rate.items())
            },
            "alerts_handled": self.alerts_handled,
            "history": self.history[-8:],
            "scale_actions": self.scale_actions[-8:],
        }
