"""Kafka request-stage probe (reference: kafka latency_probe.h).

One family, `kafka_request_stage_seconds{api,stage,path}`, covering
the produce/fetch pipeline the way the reference splits its probes:

  decode    frame bytes -> typed request (path=native when the C
            produce frontend decoded it, else python)
  dispatch  handler execution up to stage-1 completion (for produce:
            batches parsed, CRC-verified and enqueued in log order;
            for fetch: the full read)
  done      frame arrival -> response encoded (staged produce: after
            the requested ack level resolved)

All label children are resolved here, once — the request hot path in
kafka/server._process calls pre-bound `observe` methods keyed by
(api_key, native?) tuples.
"""

from __future__ import annotations

from ..metrics import MetricsRegistry

_PRODUCE = 0
_FETCH = 1


class KafkaProbe:
    def __init__(self, metrics: MetricsRegistry, ledger=None):
        self.registry = metrics
        # per-NTP load ledger leg (observability/load_ledger): shared
        # with the raft probe when the broker wires one, so the
        # hot-partition view merges produce/fetch/append rates
        if ledger is None:
            from ..observability.load_ledger import LoadLedger

            ledger = LoadLedger()
        self.ledger = ledger
        self.note_produce = ledger.note_produce
        self.note_fetch = ledger.note_fetch
        self.stage_hist = metrics.histogram(
            "kafka_request_stage_seconds",
            "Produce/fetch stage latency (decode -> dispatch -> done)",
        )
        h = self.stage_hist

        def obs(api: str, stage: str, path: str):
            return h.labels(api=api, stage=stage, path=path).observe

        # (api_key, native_decode?) -> bound observe
        self.decode = {
            (_PRODUCE, True): obs("produce", "decode", "native"),
            (_PRODUCE, False): obs("produce", "decode", "python"),
            (_FETCH, False): obs("fetch", "decode", "python"),
        }
        self.dispatch = {
            (_PRODUCE, True): obs("produce", "dispatch", "native"),
            (_PRODUCE, False): obs("produce", "dispatch", "python"),
            (_FETCH, False): obs("fetch", "dispatch", "python"),
        }
        self.done = {
            (_PRODUCE, True): obs("produce", "done", "native"),
            (_PRODUCE, False): obs("produce", "done", "python"),
            (_FETCH, False): obs("fetch", "done", "python"),
        }

        # read_all() passes a fetch's long-poll made: sum = passes,
        # count = fetches answered (a count, not seconds: values over
        # 32 land in the overflow bucket, sum and count stay exact)
        self.fetch_polls = metrics.histogram(
            "kafka_fetch_polls",
            "Long-poll read passes of each fetch answered",
        ).observe

    def produce_done_quantile(self, q: float) -> float:
        """Merged produce e2e quantile in seconds (bench --probes
        cross-check against the bench's own client-side timers)."""
        merged = None
        from ..metrics import HistogramChild

        merged = HistogramChild()
        for native in (True, False):
            c = self.stage_hist.labels(
                api="produce", stage="done",
                path="native" if native else "python",
            )
            for i, n in enumerate(c._buckets):
                merged._buckets[i] += n
            merged._overflow += c._overflow
            merged._sum += c._sum
            merged._count += c._count
        return merged.quantile(q)
