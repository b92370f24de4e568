"""The batches a traffic mix sends, made from the seed.

A mix's file fixes only what differs between mixes (`MIX_KEYS`): the
offered rate, the batch size (a record count) and the producers' codec.
The deployment's file fixes the acks, the producer and consumer counts
and the message size; the rest of a run's parameters are the harness's
own (`CLIENT`). `plan` joins the three. Batch i of the pool holds
JSON-like text where i is even and random bytes where it is odd, so
the codec does compressible and incompressible work in turn. Every seed
gives the same sizes; the seed changes the bytes alone.
"""

from __future__ import annotations

import numpy as np

from . import lz4, wire
from .crc32c import crc32c_rows

TIMESTAMP_MS = 1_700_000_000_000

MIX_KEYS = {"name", "why", "batches_per_s", "records_per_batch", "producer_codec"}

# the same in every mix: the generator's pool, its warm-up and drain, the
# Kafka client defaults it keeps (request.timeout.ms, a consumer's
# fetch.max.wait.ms, fetch.max.bytes, max.partition.fetch.bytes,
# max.in.flight.requests.per.connection) and the reference's sample
CLIENT = {"pool_batches": 256, "pool_stride": 37, "warmup_s": 4, "drain_s": 120, "request_timeout_ms": 30000,
          "fetch_max_wait_ms": 500, "fetch_max_bytes": 52428800, "fetch_partition_max_bytes": 1048576,
          "max_in_flight": 5, "check_sample": 400}


def plan(config: dict, mix: dict) -> dict:
    """A run's parameters: the mix file's keys, the harness's `CLIENT`,
    and the acks, producers, consumers and message size of the
    deployment, which no mix can set."""
    extra = set(mix) - MIX_KEYS
    if extra:
        raise ValueError(f"mix {mix.get('name')!r} sets {sorted(extra)}: a mix holds only {sorted(MIX_KEYS)}")
    return {**mix, **CLIENT, "acks": int(config["acks"]), "producers": int(config["producers"]),
            "consumers": int(config["consumers"]), "record_bytes": int(config["message_bytes"])}


def json_values(rng, count: int, size: int) -> list:
    """`count` JSON-like values of `size` bytes each: order records with
    fields drawn in bulk."""
    per = size // 60 + 2
    m = count * per
    fields = zip(rng.integers(0, 10**6, m).tolist(), rng.integers(0, 10**9, m).tolist(),
                 rng.integers(0, 10**4, m).tolist(), rng.integers(0, 100, m).tolist(),
                 (rng.random(m) < 0.5).tolist())
    recs = [b'{"key":"user-%06d","topic":"orders","seq":%d,"amount":%d.%02d,"flag":%s},'
            % (u, q, a, c, b"true" if f else b"false") for u, q, a, c, f in fields]
    return [b"".join(recs[i * per : (i + 1) * per])[:size] for i in range(count)]


def key(batch: int, record: int) -> bytes:
    return b"key-%06d-%03d" % (batch, record)


def pool(mix: dict, seed: int, wire_batches: bool = True) -> list:
    """The mix's distinct batches: each a dict of `records` [(key,
    value)], `section` (the uncompressed records section) and, with
    `wire_batches`, `wire` (the batch as the producer sends it)."""
    rng = np.random.default_rng(seed)
    n, per, size = int(mix["pool_batches"]), int(mix["records_per_batch"]), int(mix["record_bytes"])
    texts = iter(json_values(rng, (n + 1) // 2 * per, size))
    out = []
    for i in range(n):
        if i % 2 == 0:
            values = [next(texts) for _ in range(per)]
        else:
            values = [rng.bytes(size) for _ in range(per)]
        records = [(key(i, r), v) for r, v in enumerate(values)]
        out.append({"records": records, "section": wire.encode_records(records)})
    if wire_batches:
        codec = wire.CODECS[mix["producer_codec"]]
        bodies = [b["section"] if codec == 0 else lz4.compress_frame(b["section"]) for b in out]
        if codec not in (0, wire.CODECS["lz4"]):
            raise ValueError(f"producer codec {mix['producer_codec']} has no encoder here")
        tails = [wire.batch_tail(codec, per - 1, TIMESTAMP_MS + i, TIMESTAMP_MS + i, -1, -1, -1, per) + body
                 for i, body in enumerate(bodies)]
        for b, tail, crc in zip(out, tails, crc32c_rows(tails)):
            b["wire"] = wire.batch_wire(tail, crc)
    return out


def pool_index(mix: dict, partition: int, k: int) -> int:
    """The pool batch that partition `partition` sends as its k-th."""
    return (partition * int(mix["pool_stride"]) + k) % int(mix["pool_batches"])
