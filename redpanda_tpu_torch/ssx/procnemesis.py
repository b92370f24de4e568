"""ProcNemesis: seeded deterministic process-fault injection for the
shard runtime (the process-plane sibling of rpc/loopback.py's
NemesisNet and cloud's ObjectNemesis).

Where NemesisNet matches (src, dst, method) on message delivery,
ProcNemesis matches (shard, event) at the named operation boundaries
the runtime and the broker lifecycle thread through `ShardRuntime.
_nemesis()`: spawn.fork / spawn.forked during any fork, grow.ready /
grow.activate during an elastic grow, retire.freeze / retire.evacuate
/ retire.drain / retire.stop during a retire, restart.readopt during a
per-shard crash restart, and produce on the cross-shard produce hop.
Actions:

  * kill       — SIGKILL the shard's process at the boundary: the
    supervisor must recover via per-shard restart (or the grow/retire
    coordinator must roll the operation back) with no orphaned
    process, no lost acked record, and a consistent placement table;
  * pause      — SIGSTOP now, SIGCONT after `pause_s` (+ seeded
    jitter): a gray failure — waitpid still reports the child alive,
    so the supervisor can only notice through its heartbeat deadline;
  * slow_start — the freshly forked child sleeps `delay_s` before its
    ready handshake (spawn.fork only), stressing the ready timeout;
  * fork_fail  — the fork itself fails (`ForkFailInjected` raised at
    the spawn.fork boundary): grow must report failure and leave no
    partial state behind.

Determinism contract (identical to NemesisNet): the schedule carries
TWO seeded RNGs. `rng` is consumed only by `act()`'s probability
draws, so the firing `trace` is a pure function of (seed, event
sequence) — feeding a recorded (shard, event) sequence through a
fresh same-seed schedule replays the trace byte-identically. `fx_rng`
covers effect parameters (pause/slow-start jitter) so those draws
never shift the match stream. All draws happen synchronously.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional


class ForkFailInjected(RuntimeError):
    """A scheduled fork failure (ProcRule action `fork_fail`)."""


@dataclass
class ProcRule:
    """One process-fault rule matching (shard, event); "*" wildcards.

    Same firing contract as NetRule/iofaults.Rule: fires with
    probability `prob` and/or on every `nth` matching boundary, up to
    `count` times. The RNG is only consulted when prob < 1.0, so rule
    order and match filters never shift another rule's draw sequence.
    """

    shard: int | str = "*"
    event: str = "*"  # boundary name, e.g. "retire.evacuate"
    action: str = "kill"  # kill | pause | slow_start | fork_fail
    prob: float = 1.0
    nth: int = 1  # fire on every nth matching boundary
    count: int = 1  # max firings (faults default to one-shot)
    pause_s: float = 0.2  # "pause": SIGSTOP duration before SIGCONT
    delay_s: float = 0.05  # "slow_start": sleep before ready handshake
    jitter_s: float = 0.0  # pause/slow_start: + uniform(0, jitter_s)
    fired: int = 0
    seen: int = 0

    def matches(self, shard: int, event: str, rng: random.Random) -> bool:
        if self.fired >= self.count:
            return False
        if self.shard != "*" and self.shard != shard:
            return False
        if self.event != "*" and self.event != event:
            return False
        self.seen += 1
        if self.seen % self.nth != 0:
            return False
        if self.prob < 1.0 and rng.random() >= self.prob:
            return False
        self.fired += 1
        return True


@dataclass
class ProcSchedule:
    """Seeded rule set + replayable firing trace (NemesisSchedule twin
    for the process plane)."""

    rules: list[ProcRule]
    seed: int = 0
    rng: random.Random = field(init=False)  # match/prob draws (trace)
    fx_rng: random.Random = field(init=False)  # effect-parameter draws
    injected: dict[str, int] = field(default_factory=dict)
    trace: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.rng = random.Random(self.seed)
        self.fx_rng = random.Random(self.seed ^ 0x5EED)

    def act(self, shard: int, event: str) -> Optional[ProcRule]:
        for r in self.rules:
            if r.matches(shard, event, self.rng):
                self.injected[r.action] = self.injected.get(r.action, 0) + 1
                self.trace.append(
                    f"#{len(self.trace)} {r.action} s{shard} {event}"
                )
                return r
        return None

    def effect_jitter(self, rule: ProcRule) -> float:
        """Seeded jitter for a firing's effect parameter — drawn from
        fx_rng so the match stream never shifts."""
        if rule.jitter_s <= 0.0:
            return 0.0
        return self.fx_rng.uniform(0.0, rule.jitter_s)

    def describe(self) -> dict:
        return {
            "seed": self.seed,
            "rules": len(self.rules),
            "injected": dict(self.injected),
            "trace_len": len(self.trace),
        }
