"""ObjectNemesis: seeded deterministic fault injection for the
object-store path.

Reference: the same consistency-testing lineage as NemesisNet
(rpc/loopback.py) and iofaults (storage/iofaults.py) — the third fault
plane. The reference project exercises tiered storage against an
s3_imposter that answers with errors, slowdowns and truncated bodies;
here the imposter is a wrapper over any `ObjectStore` so the whole
cloud stack (archiver, cache, remote reader, kafka fetch) sees the
faults through its normal client surface.

Rules match (op, key glob) and fire with probability `prob` and/or on
every `nth` matching call, up to `count` times. Determinism follows
the NemesisNet dual-RNG design: one RNG (seeded `seed`) drives the
match/probability draws and therefore the firing trace; a second
(seeded `seed ^ 0x5EED`) drives effect parameters (the truncation
point of a partial upload), so tweaking effect shapes never perturbs
which ops fire. All draws happen synchronously before any await, so a
trace is a pure function of `(seed, op sequence)` and
`replay_trace()` reproduces it byte-equal.

Actions:

  * ``error``    — raise StoreError instead of performing the op;
  * ``throttle`` — raise StoreThrottled (429-style slow-down) carrying
                   `delay_s` as the retry-after hint;
  * ``timeout``  — sleep `delay_s`, then raise (client-side timeout);
  * ``hang``     — sleep `hang_s` (default: effectively forever); only
                   a caller deadline/cancel gets control back — the
                   wedged-endpoint case consumer deadlines must bound;
  * ``slow``     — bandwidth-capped transfer: sleep
                   `delay_s + payload/bandwidth_bps`, then proceed;
  * ``partial``  — `put` persists a truncated prefix of the object and
                   THEN raises. With `key_glob="*manifest.bin"` this is
                   a torn manifest write; on segment keys it is the
                   partial upload the archiver must never reference.
"""

from __future__ import annotations

import asyncio
import fnmatch
import random
from dataclasses import dataclass, field, replace
from typing import Iterable, Optional

from .object_store import ObjectStore, StoreError, StoreThrottled

_OPS = ("put", "get", "get_range", "exists", "list", "delete", "head")


@dataclass
class StoreRule:
    op: str = "*"  # one of _OPS or "*"
    key_glob: str = "*"
    action: str = "error"  # error|throttle|timeout|hang|slow|partial
    prob: float = 1.0
    nth: int = 1  # fire on every nth matching op
    count: int = 1 << 30  # max firings
    delay_s: float = 0.05  # timeout sleep / slow base latency / retry-after
    hang_s: float = 3600.0  # hang duration (bounded only by caller deadline)
    bandwidth_bps: float = 256 * 1024.0  # slow: simulated link speed
    keep_frac: float = 0.5  # partial: max fraction of bytes persisted
    fired: int = 0
    seen: int = 0

    def matches(self, op: str, key: str, rng: random.Random) -> bool:
        if self.op != "*" and op != self.op:
            return False
        if self.fired >= self.count:
            return False
        if not fnmatch.fnmatch(key, self.key_glob):
            return False
        self.seen += 1
        if self.seen % self.nth != 0:
            return False
        if self.prob < 1.0 and rng.random() >= self.prob:
            return False
        self.fired += 1
        return True


@dataclass
class StoreFaultSchedule:
    rules: list[StoreRule]
    seed: int = 0
    rng: random.Random = field(init=False)
    fx_rng: random.Random = field(init=False)
    injected: dict[str, int] = field(default_factory=dict)
    trace: list[str] = field(default_factory=list)
    # every act() call, firing or not: the op sequence a replay feeds
    # back in (rule counters and prob draws consume state on matches,
    # so the full sequence — not just firings — defines the trace)
    ops: list[tuple[str, str]] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.rng = random.Random(self.seed)
        self.fx_rng = random.Random(self.seed ^ 0x5EED)

    def act(self, op: str, key: str) -> Optional[StoreRule]:
        self.ops.append((op, key))
        for r in self.rules:
            if r.matches(op, key, self.rng):
                self.injected[r.action] = self.injected.get(r.action, 0) + 1
                self.trace.append(f"#{len(self.trace)} {r.action} {op} {key}")
                return r
        return None


def replay_trace(
    rules: Iterable[StoreRule], seed: int, ops: Iterable[tuple[str, str]]
) -> list[str]:
    """Rebuild the firing trace from (seed, op sequence): fresh rule
    counters, same seed, same calls — byte-equal to the original run's
    `schedule.trace` by construction."""
    sched = StoreFaultSchedule(
        rules=[replace(r, fired=0, seen=0) for r in rules], seed=seed
    )
    for op, key in ops:
        sched.act(op, key)
    return sched.trace


class NemesisObjectStore:
    """ObjectStore wrapper applying a StoreFaultSchedule to every op.

    With no schedule installed it is a transparent passthrough, so the
    wrapper can live permanently in a broker's store stack and chaos
    runs just `install()` a schedule for the fault window. Unknown
    attributes (MemoryObjectStore's `put_count`, `_data`, ...) proxy to
    the inner store so test doubles keep their inspection surface.
    """

    def __init__(
        self, inner: ObjectStore, schedule: Optional[StoreFaultSchedule] = None
    ):
        self._inner = inner
        self.schedule = schedule

    def install(self, schedule: StoreFaultSchedule) -> None:
        self.schedule = schedule

    def clear(self) -> None:
        self.schedule = None

    def _act(self, op: str, key: str) -> Optional[StoreRule]:
        return self.schedule.act(op, key) if self.schedule is not None else None

    async def _fault(self, r: StoreRule, op: str, key: str, nbytes: int) -> None:
        """Apply pre-op effects for every action except `partial`
        (which needs the put payload). Raises for the fail actions,
        returns normally for `slow` after the transfer delay."""
        if r.action == "error":
            raise StoreError(f"nemesis: injected {op} error ({key})")
        if r.action == "throttle":
            raise StoreThrottled(
                f"nemesis: {op} throttled ({key})", retry_after_s=r.delay_s
            )
        if r.action == "timeout":
            await asyncio.sleep(r.delay_s)
            raise StoreError(f"nemesis: {op} timed out ({key})")
        if r.action == "hang":
            await asyncio.sleep(r.hang_s)
            raise StoreError(f"nemesis: {op} hung ({key})")
        if r.action == "slow":
            await asyncio.sleep(r.delay_s + nbytes / max(r.bandwidth_bps, 1.0))

    async def put(self, key: str, data: bytes) -> None:
        r = self._act("put", key)
        if r is not None:
            if r.action == "partial":
                # fx_rng (not rng): effect-parameter stream, so the
                # truncation point never shifts the firing trace
                keep = int(len(data) * self.schedule.fx_rng.uniform(0.1, r.keep_frac))
                await self._inner.put(key, data[:keep])
                raise StoreError(
                    f"nemesis: partial upload ({key}: {keep}/{len(data)} bytes)"
                )
            await self._fault(r, "put", key, len(data))
        await self._inner.put(key, data)

    async def get(self, key: str) -> bytes:
        r = self._act("get", key)
        if r is not None:
            if r.action == "slow":
                data = await self._inner.get(key)
                await self._fault(r, "get", key, len(data))
                return data
            await self._fault(r, "get", key, 0)
        return await self._inner.get(key)

    async def get_range(self, key: str, start: int, end: int) -> bytes:
        r = self._act("get_range", key)
        if r is not None:
            if r.action == "slow":
                data = await self._inner.get_range(key, start, end)
                await self._fault(r, "get_range", key, len(data))
                return data
            await self._fault(r, "get_range", key, 0)
        return await self._inner.get_range(key, start, end)

    async def exists(self, key: str) -> bool:
        r = self._act("exists", key)
        if r is not None:
            await self._fault(r, "exists", key, 0)
        return await self._inner.exists(key)

    async def list(self, prefix: str) -> list[str]:
        r = self._act("list", prefix)
        if r is not None:
            await self._fault(r, "list", prefix, 0)
        return await self._inner.list(prefix)

    async def delete(self, key: str) -> None:
        r = self._act("delete", key)
        if r is not None:
            await self._fault(r, "delete", key, 0)
        await self._inner.delete(key)

    async def head(self, key: str) -> int:
        r = self._act("head", key)
        if r is not None:
            await self._fault(r, "head", key, 0)
        head = getattr(self._inner, "head", None)
        if head is not None:
            return await head(key)
        return len(await self._inner.get(key))

    async def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close is not None:
            await close()

    def __getattr__(self, name: str):
        return getattr(self._inner, name)
