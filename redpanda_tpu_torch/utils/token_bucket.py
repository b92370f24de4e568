"""Token bucket (reference: src/v/utils/token_bucket.h and the
throttling math of kafka/server/quota_manager.cc).

Tokens replenish continuously at `rate` per second up to `burst`.
`record()` spends tokens (going negative when the caller overshoots);
`throttle_delay_s()` is how long the client must back off for the
deficit to refill — the value produce/fetch responses surface as
throttle_time_ms.
"""

from __future__ import annotations


class TokenBucket:
    __slots__ = ("rate", "burst", "_tokens", "_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last = now

    def _refill(self, now: float) -> None:
        dt = max(0.0, now - self._last)
        self._last = now
        self._tokens = min(self.burst, self._tokens + dt * self.rate)

    def record(self, amount: float, now: float) -> None:
        """Spend tokens; may go negative (the client already sent the
        bytes — quotas throttle AFTER the fact, like the reference)."""
        self._refill(now)
        self._tokens -= amount

    def throttle_delay_s(self, now: float) -> float:
        self._refill(now)
        if self._tokens >= 0 or self.rate <= 0:
            return 0.0
        return -self._tokens / self.rate
