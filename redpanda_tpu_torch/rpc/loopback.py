"""In-memory loopback transport — the fixture backbone (SURVEY.md §4.2).

The reference tests distribution by booting several full application
instances in one process over localhost sockets
(cluster/tests/cluster_test_fixture.h, raft/tests/raft_group_fixture.h:83).
We go one step lighter: a `LoopbackNetwork` maps node-id → Dispatcher,
and `LoopbackTransport` awaits handlers directly — zero sockets, fully
deterministic, and supports partition/heal for failure tests
(the ducktape failure_injector's iptables isolation, in-process).

NemesisNet: beyond the binary faults (isolation, symmetric link cuts,
one global delay), a seeded `NemesisSchedule` of per-link `NetRule`s
can be installed on the network — mirroring the iofaults
(path_glob, op) schedule design, but matching (src, dst, method).
Actions:

  * drop / one_way  — the message never arrives (one_way rules are
    written with a concrete (src, dst) so only that direction dies:
    an asymmetric partition);
  * delay (+jitter) — fixed latency plus a seeded random jitter;
  * slow            — bandwidth cap: latency grows with payload size;
  * duplicate       — the handler runs twice; the duplicate's reply is
    discarded like a late packet (consumers must be idempotent);
  * reorder         — hold-and-release: deliveries on a link queue up
    until `reorder_window` are held, then release in seeded-shuffled
    order (a failsafe timer releases part-filled windows);
  * corrupt         — a payload byte is flipped and checked against the
    original's CRC-32C, standing in for the wire frame's checksum the
    loopback path skips; the mismatch raises BAD_CHECKSUM, so corrupt
    payloads are rejected, never applied.

Determinism: the schedule carries TWO seeded RNGs. `rng` is consumed
only by `act()`'s probability draws, so the firing `trace` is a pure
function of (seed, delivery sequence) — feeding a recorded sequence
back through a fresh same-seed schedule's `act()` replays the trace
byte-identically. `fx_rng` covers effect parameters (jitter amount,
corrupt byte index, reorder shuffle) so those draws never shift the
match stream. All draws happen synchronously before any await.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field
from typing import Optional

from ..observability import trace
from ..utils.crc import crc32c
from .server import Dispatcher, Service
from .types import RpcError, Status

_TIMEOUT_CTX = getattr(asyncio, "timeout", None)  # 3.11+


@dataclass
class NetRule:
    """One fault rule matching (src, dst, method); "*" is a wildcard.

    Same firing contract as iofaults.Rule: fires with probability
    `prob` and/or on every `nth` matching delivery, up to `count`
    times. The RNG is only consulted when prob < 1.0, so rule order
    and match filters never shift another rule's draw sequence.
    """

    src: int | str = "*"
    dst: int | str = "*"
    method: int | str = "*"  # method_id
    action: str = "drop"  # see module docstring
    prob: float = 1.0
    nth: int = 1  # fire on every nth matching delivery
    count: int = 1 << 30  # max firings
    delay_s: float = 0.0  # "delay"/"slow" base latency
    jitter_s: float = 0.0  # "delay": + uniform(0, jitter_s)
    bandwidth_bps: float = 1 << 20  # "slow": + len(payload)/bandwidth
    reorder_window: int = 4  # "reorder": held messages per release
    reorder_hold_s: float = 0.05  # "reorder": part-filled window failsafe
    fired: int = 0
    seen: int = 0

    def matches(
        self, src: int, dst: int, method_id: int, rng: random.Random
    ) -> bool:
        if self.fired >= self.count:
            return False
        if self.src != "*" and self.src != src:
            return False
        if self.dst != "*" and self.dst != dst:
            return False
        if self.method != "*" and self.method != method_id:
            return False
        self.seen += 1
        if self.seen % self.nth != 0:
            return False
        if self.prob < 1.0 and rng.random() >= self.prob:
            return False
        self.fired += 1
        return True


@dataclass
class NemesisSchedule:
    """Seeded rule set + replayable firing trace (FaultSchedule twin)."""

    rules: list[NetRule]
    seed: int = 0
    rng: random.Random = field(init=False)  # match/prob draws (trace)
    fx_rng: random.Random = field(init=False)  # effect-parameter draws
    injected: dict[str, int] = field(default_factory=dict)
    trace: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.rng = random.Random(self.seed)
        self.fx_rng = random.Random(self.seed ^ 0x5EED)

    def act(self, src: int, dst: int, method_id: int) -> Optional[NetRule]:
        for r in self.rules:
            if r.matches(src, dst, method_id, self.rng):
                self.injected[r.action] = self.injected.get(r.action, 0) + 1
                self.trace.append(
                    f"#{len(self.trace)} {r.action} {src}->{dst} m{method_id}"
                )
                return r
        return None


class LoopbackNetwork:
    def __init__(self):
        self._nodes: dict[int, Dispatcher] = {}
        self._isolated: set[int] = set()
        self._links_down: set[tuple[int, int]] = set()
        self.delay_s: float = 0.0
        self._nemesis: Optional[NemesisSchedule] = None
        # (src, dst) -> futures held by an open reorder window
        self._held: dict[tuple[int, int], list[asyncio.Future]] = {}

    def register_node(self, node_id: int) -> Dispatcher:
        d = Dispatcher()
        self._nodes[node_id] = d
        return d

    def register(self, node_id: int, service: Service) -> None:
        if node_id not in self._nodes:
            self.register_node(node_id)
        self._nodes[node_id].register(service)

    # -- failure injection (iptables isolation analog) ---------------
    def isolate(self, node_id: int) -> None:
        self._isolated.add(node_id)

    def heal(self, node_id: int | None = None) -> None:
        if node_id is None:
            self._isolated.clear()
            self._links_down.clear()
        else:
            self._isolated.discard(node_id)
            self._links_down = {
                l for l in self._links_down if node_id not in l
            }

    def cut_link(self, a: int, b: int) -> None:
        self._links_down.add((a, b))
        self._links_down.add((b, a))

    def reachable(self, src: int, dst: int) -> bool:
        return (
            dst in self._nodes
            and src not in self._isolated
            and dst not in self._isolated
            and (src, dst) not in self._links_down
        )

    # -- NemesisNet ---------------------------------------------------
    def install_nemesis(self, schedule: NemesisSchedule) -> None:
        """Install (last one wins); open reorder windows are released."""
        self._flush_held()
        self._nemesis = schedule

    def clear_nemesis(self) -> None:
        self._nemesis = None
        self._flush_held()

    def _flush_held(self) -> None:
        held, self._held = self._held, {}
        for q in held.values():
            for f in q:
                if not f.done():
                    f.set_result(None)

    async def _hold_for_reorder(
        self, sched: NemesisSchedule, rule: NetRule, src: int, dst: int
    ) -> None:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        key = (src, dst)
        q = self._held.setdefault(key, [])
        q.append(fut)
        if len(q) >= rule.reorder_window:
            batch, self._held[key] = q[:], []
            sched.fx_rng.shuffle(batch)  # synchronous draw: replayable
            for f in batch:
                if not f.done():
                    f.set_result(None)
        else:
            # a part-filled window must not hold the link's traffic
            # hostage forever (the sender's timeout would otherwise
            # turn every reorder into a drop)
            loop.call_later(rule.reorder_hold_s, self._release_one, key, fut)
        await fut

    def _release_one(self, key: tuple[int, int], fut: asyncio.Future) -> None:
        if not fut.done():
            fut.set_result(None)
        q = self._held.get(key)
        if q is not None and fut in q:
            q.remove(fut)

    @staticmethod
    def _corrupted(rng: random.Random, payload: bytes) -> bytes:
        if not payload:
            return b"\xff"
        buf = bytearray(payload)
        i = rng.randrange(len(buf))
        buf[i] ^= 0xFF
        return bytes(buf)

    async def deliver(
        self, src: int, dst: int, method_id: int, payload: bytes
    ) -> bytes:
        if not self.reachable(src, dst):
            raise ConnectionError(f"node {dst} unreachable from {src}")
        sched = self._nemesis
        duplicate = False
        if sched is not None:
            rule = sched.act(src, dst, method_id)
            if rule is not None:
                act = rule.action
                # flight recorder: the fault marks the span it fired
                # under (a produce's raft.append, a heartbeat tick) and
                # lands in the event log for /v1/debug/traces
                trace.default_recorder().record_event(
                    "nemesis", action=act, src=src, dst=dst,
                    method=method_id,
                )
                if act in ("drop", "one_way"):
                    raise ConnectionError(
                        f"nemesis: {act} {src}->{dst} m{method_id}"
                    )
                if act == "corrupt":
                    want = crc32c(payload)
                    payload = self._corrupted(sched.fx_rng, payload)
                    if crc32c(payload) != want:
                        # the frame codec's checksum gate, replayed here
                        # since loopback skips the wire frame: a flipped
                        # payload is rejected, never dispatched
                        raise RpcError(
                            Status.BAD_CHECKSUM,
                            f"nemesis: payload crc mismatch m{method_id}",
                        )
                elif act == "delay":
                    d = rule.delay_s
                    if rule.jitter_s:
                        d += sched.fx_rng.random() * rule.jitter_s
                    await asyncio.sleep(d)
                elif act == "slow":
                    await asyncio.sleep(
                        rule.delay_s + len(payload) / rule.bandwidth_bps
                    )
                elif act == "duplicate":
                    duplicate = True
                elif act == "reorder":
                    await self._hold_for_reorder(sched, rule, src, dst)
        if self.delay_s:
            await asyncio.sleep(self.delay_s)
        try:
            reply = await self._nodes[dst].dispatch(method_id, payload)
            if duplicate:
                # re-deliver after the first completes; the consumer
                # must be idempotent and this reply is discarded like a
                # late packet (the sender already has its answer)
                try:
                    await self._nodes[dst].dispatch(method_id, payload)
                except (RpcError, ConnectionError):
                    pass
            return reply
        except (RpcError, ConnectionError, asyncio.CancelledError):
            raise
        except Exception as e:
            # match the TCP server's contract: handler failures surface
            # as RpcError(SERVICE_ERROR), never as the raw exception
            raise RpcError(Status.SERVICE_ERROR, str(e))


class LoopbackTransport:
    """Transport-protocol adapter for one (src → dst) edge."""

    def __init__(self, network: LoopbackNetwork, src: int, dst: int):
        self._net = network
        self.src = src
        self.dst = dst

    async def connect(self) -> None:
        if not self._net.reachable(self.src, self.dst):
            raise ConnectionRefusedError(f"node {self.dst} unreachable")

    def is_connected(self) -> bool:
        return self._net.reachable(self.src, self.dst)

    async def call(
        self, method_id: int, payload: bytes, timeout: float | None = None
    ) -> bytes:
        try:
            coro = self._net.deliver(self.src, self.dst, method_id, payload)
            if timeout is not None:
                # asyncio.timeout (3.11+) arms a timer on the current
                # task instead of wrapping the coro in a new Task the
                # way wait_for does — one Task per RPC was ~5% of the
                # replicated-bench core
                if _TIMEOUT_CTX is not None:
                    async with _TIMEOUT_CTX(timeout):
                        return await coro
                # 3.10 fallback: a Task per RPC, but functional
                return await asyncio.wait_for(coro, timeout)
            return await coro
        except (TimeoutError, asyncio.TimeoutError):
            raise RpcError(Status.TIMEOUT, f"method {method_id} timed out")

    async def close(self) -> None:
        pass
