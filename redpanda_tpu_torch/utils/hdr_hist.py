"""HdrHistogram-style latency histogram.

Reference: src/v/utils/hdr_hist.h (wraps HdrHistogram_c; used by
kafka/latency_probe.h and the per-subsystem probes). Same recording
model: values bucketed with a bounded RELATIVE error (configurable
significant decimal figures) over a dynamic range, O(1) record,
percentile queries by bucket walk. Implemented directly: buckets are
(exponent, sub-bucket) pairs exactly like HdrHistogram's
counts layout.
"""

from __future__ import annotations

import math


class HdrHist:
    def __init__(
        self,
        lowest: int = 1,
        highest: int = 60_000_000,  # default: 1 us .. 60 s in us
        sig_figs: int = 3,
    ):
        if not (1 <= sig_figs <= 5):
            raise ValueError("sig_figs in [1,5]")
        if lowest < 1 or highest < 2 * lowest:
            raise ValueError("need lowest >= 1 and highest >= 2*lowest")
        self.lowest = lowest
        self.highest = highest
        largest_single_unit_res = 2 * 10**sig_figs
        self._sub_bucket_bits = (largest_single_unit_res - 1).bit_length()
        self._sub_bucket_count = 1 << self._sub_bucket_bits
        self._sub_bucket_half = self._sub_bucket_count // 2
        self._unit_magnitude = int(math.floor(math.log2(lowest)))
        # number of bucket levels to cover `highest`
        smallest_untrackable = self._sub_bucket_count << self._unit_magnitude
        buckets = 1
        while smallest_untrackable <= highest:
            smallest_untrackable <<= 1
            buckets += 1
        self._bucket_count = buckets
        self._counts = [0] * (
            (buckets + 1) * self._sub_bucket_half
        )
        self.total = 0
        self.max_value = 0
        self.min_value = None
        self._sum = 0

    # -- index math (HdrHistogram counts layout) ----------------------
    def _index_for(self, value: int) -> int:
        pow2 = value.bit_length() - 1  # floor log2
        bucket = max(0, pow2 - self._unit_magnitude - (self._sub_bucket_bits - 1))
        sub = value >> (bucket + self._unit_magnitude)
        return (bucket + 1) * self._sub_bucket_half + (sub - self._sub_bucket_half)

    def _value_at(self, index: int) -> int:
        bucket = index // self._sub_bucket_half - 1
        sub = index % self._sub_bucket_half + self._sub_bucket_half
        if bucket < 0:
            bucket = 0
            sub -= self._sub_bucket_half
        return sub << (bucket + self._unit_magnitude)

    def _highest_equivalent(self, value: int) -> int:
        pow2 = value.bit_length() - 1
        bucket = max(0, pow2 - self._unit_magnitude - (self._sub_bucket_bits - 1))
        size = 1 << (bucket + self._unit_magnitude)
        return (value | (size - 1))

    # -- recording ----------------------------------------------------
    def record(self, value: int, count: int = 1) -> None:
        v = max(self.lowest, min(int(value), self.highest))
        self._counts[self._index_for(v)] += count
        self.total += count
        self._sum += v * count
        if v > self.max_value:
            self.max_value = v
        if self.min_value is None or v < self.min_value:
            self.min_value = v

    # -- queries ------------------------------------------------------
    def value_at_percentile(self, pct: float) -> int:
        if self.total == 0:
            return 0
        target = max(1, int(math.ceil(self.total * pct / 100.0)))
        running = 0
        for i, c in enumerate(self._counts):
            running += c
            if running >= target:
                return self._highest_equivalent(self._value_at(i))
        return self.max_value

    def mean(self) -> float:
        return self._sum / self.total if self.total else 0.0

    def snapshot(self) -> dict:
        return {
            "count": self.total,
            "min": self.min_value or 0,
            "max": self.max_value,
            "mean": round(self.mean(), 3),
            "p50": self.value_at_percentile(50),
            "p90": self.value_at_percentile(90),
            "p99": self.value_at_percentile(99),
            "p999": self.value_at_percentile(99.9),
        }
