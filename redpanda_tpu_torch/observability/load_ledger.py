"""Per-NTP load ledger: EWMA byte/op rates + skew index.

The reference tracks per-partition throughput in `partition_probe` and
feeds it to the partition balancer; here the same signal accumulates
in one dict-backed ledger per shard, fed by the probe sampling hooks
(kafka.probe produce/fetch, raft.probe append).

Hot-path contract: `note()` is one dict lookup + two float adds — no
time syscall, no decay math, no allocation after the first touch of a
key. All EWMA folding is LAZY: raw byte/op accumulators roll into the
half-life-decayed rate only when a reader asks (`rates`, `top`,
`skew`, `totals`), which happens on scrape/endpoint cadence, never per
request.

The skew index is max/mean of per-key total byte rates — 1.0 means
perfectly balanced, N means the hottest key carries N× the mean. The
future placement layer consumes this to decide when rebalancing pays
(ROADMAP: unified placement plane).
"""

from __future__ import annotations

import heapq
import time

KINDS = ("produce", "fetch", "append")
_NK = len(KINDS)
_KIND_IDX = {k: i for i, k in enumerate(KINDS)}

# record layout per key (plain list — cheapest mutable cell):
# [acc_bytes x3, acc_ops x3, rate_bps x3, rate_ops x3, last_fold_t]
_T = 4 * _NK


def _new_record(now: float) -> list:
    rec = [0.0] * (4 * _NK + 1)
    rec[_T] = now
    return rec


class LoadLedger:
    """EWMA byte/op rates per key (NTP string), per kind."""

    def __init__(self, halflife_s: float = 10.0, clock=time.monotonic):
        self.halflife_s = float(halflife_s)
        self._clock = clock
        self._m: dict[str, list] = {}
        # pre-bound per-kind note methods (probe hot sites call these)
        self.note_produce = self._binder(0)
        self.note_fetch = self._binder(1)
        self.note_append = self._binder(2)

    def _binder(self, idx: int):
        m = self._m
        clock = self._clock
        ops = _NK + idx

        def note(key: str, nbytes: int) -> None:
            rec = m.get(key)
            if rec is None:
                rec = m[key] = _new_record(clock())
            rec[idx] += nbytes
            rec[ops] += 1.0

        return note

    def note(self, kind: str, key: str, nbytes: int) -> None:
        (self.note_produce, self.note_fetch, self.note_append)[
            _KIND_IDX[kind]
        ](key, nbytes)

    # -- read side (lazy fold) ----------------------------------------
    def _fold(self, rec: list, now: float) -> None:
        dt = now - rec[_T]
        if dt < 1e-3:
            return
        decay = 0.5 ** (dt / self.halflife_s)
        gain = 1.0 - decay
        for i in range(_NK):
            rec[2 * _NK + i] = decay * rec[2 * _NK + i] + gain * (rec[i] / dt)
            rec[3 * _NK + i] = decay * rec[3 * _NK + i] + gain * (
                rec[_NK + i] / dt
            )
            rec[i] = 0.0
            rec[_NK + i] = 0.0
        rec[_T] = now

    def rates(self, key: str) -> dict[str, dict[str, float]]:
        """{kind: {bytes_per_s, ops_per_s}} for one key (folded now)."""
        rec = self._m.get(key)
        if rec is None:
            return {k: {"bytes_per_s": 0.0, "ops_per_s": 0.0} for k in KINDS}
        self._fold(rec, self._clock())
        return {
            k: {
                "bytes_per_s": rec[2 * _NK + i],
                "ops_per_s": rec[3 * _NK + i],
            }
            for i, k in enumerate(KINDS)
        }

    def _folded_totals(self) -> list[tuple[str, float, list]]:
        now = self._clock()
        out = []
        for key, rec in self._m.items():
            self._fold(rec, now)
            out.append((key, sum(rec[2 * _NK : 3 * _NK]), rec))
        return out

    def top(self, k: int) -> list[dict]:
        """Top-k hottest keys by total byte rate, hottest first."""
        rows = heapq.nlargest(
            k, self._folded_totals(), key=lambda t: t[1]
        )
        return [
            {
                "key": key,
                "total_bps": total,
                **{
                    f"{kind}_bps": rec[2 * _NK + i]
                    for i, kind in enumerate(KINDS)
                },
            }
            for key, total, rec in rows
            if total > 0.0
        ]

    def totals(self) -> dict[str, float]:
        """Shard-level rollup: total byte rate per kind + overall."""
        now = self._clock()
        sums = [0.0] * _NK
        for rec in self._m.values():
            self._fold(rec, now)
            for i in range(_NK):
                sums[i] += rec[2 * _NK + i]
        out = {f"{k}_bps": sums[i] for i, k in enumerate(KINDS)}
        out["total_bps"] = sum(sums)
        return out

    def skew(self) -> float:
        """max/mean ratio of per-key total byte rates; 1.0 = balanced
        (also the degenerate answer for <=1 loaded key)."""
        loads = [t for _, t, _ in self._folded_totals() if t > 0.0]
        if len(loads) <= 1:
            return 1.0
        mean = sum(loads) / len(loads)
        if mean <= 0.0:
            return 1.0
        return max(loads) / mean

    def __len__(self) -> int:
        return len(self._m)

    def forget(self, key: str) -> None:
        """Drop a key (partition deleted / moved off this shard)."""
        self._m.pop(key, None)


def skew_of(loads: list[float]) -> float:
    """Skew index over an arbitrary load vector (fleet merge reuses
    the same definition over per-shard totals)."""
    loads = [x for x in loads if x > 0.0]
    if len(loads) <= 1:
        return 1.0
    mean = sum(loads) / len(loads)
    return max(loads) / mean if mean > 0.0 else 1.0
