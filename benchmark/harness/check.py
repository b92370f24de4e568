"""The reference check that decides `correct`: plain Python and NumPy,
no module of the program. It reads what the program stored (every
replica's data batches, read back once the window has closed) and what
the generator's producers were told and its consumers received, and
works everything else out again from the seed's batches:

- every batch the mix sent was acknowledged (after the producer's
  retries), and none failed;
- every replica holds the same data batches, on as many nodes as the
  configuration's replication factor (RF=3: all three);
- the Kafka offsets, counted again from the stored batches' record
  counts, put each acknowledged batch at its acknowledged offset, with
  no batch between a partition's acknowledged batches where no request
  of it failed, and the high watermark the consumers last saw at the
  end of the log;
- every stored batch's CRC-32C, computed here, equals its header's;
- a sample drawn from the seed of the acknowledged batches decodes, by
  the topic's codec, to exactly the records section that was sent, and
  its records parse back to the keys and values sent;
- every acknowledged batch reached a consumer with the stored batch's
  bytes (digest, length, CRC).

Each number compared is exact, so each limit is 0.
"""

from __future__ import annotations

import zlib

import numpy as np

from . import lz4, wire, zstd
from .crc32c import crc32c_rows

DECODERS = {wire.CODECS["none"]: lambda b: bytes(b), wire.CODECS["lz4"]: lz4.decompress_frame,
            wire.CODECS["zstd"]: zstd.decompress}


def tail_bytes(fields: tuple, body: bytes) -> bytes:
    """A stored batch's bytes from the attributes on: what its CRC
    covers and what a consumer's digest covers."""
    crc, attrs, lod, first_ts, max_ts, pid, pepoch, bseq, count = fields
    return wire.batch_tail(attrs, lod, first_ts, max_ts, pid, pepoch, bseq, count) + body


def check(gen: dict, stored: dict, pool: list, codec: int, rf: int, seed: int, sample: int) -> list:
    """([(name, reading, limit)] for every number compared, {what was
    counted})."""
    per = len(pool[0]["records"])
    failed = len(gen["failed"])
    acked = {(p, base): idx for p, k, idx, _, _, base in gen["acks"]}
    failed_parts = {a[0] for a in gen["attempts"] if a[4] != 0}

    missing_replicas = mismatched_replicas = 0
    leaders: dict = {}  # partition -> {kafka base: (fields, body)}
    ends: dict = {}
    for p, rows in stored.items():
        have = [r for r in rows if r is not None]
        missing_replicas += max(0, rf - len(have))
        if not have:
            continue
        ref = have[0]
        mismatched_replicas += sum(1 for r in have[1:] if r != ref)
        offset, by_base = 0, {}
        for fields, body in ref:
            by_base[offset] = (fields, body)
            offset += fields[8]
        leaders[p], ends[p] = by_base, offset

    offset_errors = 0
    for p, by_base in leaders.items():
        mine = sorted(b for (q, b) in acked if q == p)
        for base in mine:
            if base not in by_base or by_base[base][0][8] != per:
                offset_errors += 1
        if p not in failed_parts:
            # no request of this partition failed: its log is exactly
            # the acknowledged batches, one after another from 0
            if sorted(by_base) != mine or (mine and mine[-1] + per != ends[p]):
                offset_errors += 1
    for p, base in acked:
        if p not in leaders:
            offset_errors += 1
    hwm_errors = sum(1 for p, end in ends.items() if int(gen["hwm"].get(str(p), gen["hwm"].get(p, -1))) != end)

    # CRC-32C of every stored batch, computed here
    keys = [(p, b) for p, by_base in leaders.items() for b in by_base]
    tails = [tail_bytes(*leaders[p][b]) for p, b in keys]
    crcs = crc32c_rows(tails)
    crc_errors = sum(1 for (p, b), c in zip(keys, crcs) if leaders[p][b][0][0] != c)
    codec_errors = sum(1 for p, b in keys if leaders[p][b][0][1] & 7 != codec)
    digest = {key: (zlib.crc32(t), len(t) + 9, leaders[key[0]][key[1]][0][0]) for key, t in zip(keys, tails)}

    # the sample: decoded by the topic's codec, parsed, compared
    order = sorted(acked)
    rng = np.random.default_rng(seed ^ 0x5EED)
    take = order if len(order) <= sample else [order[i] for i in sorted(rng.choice(len(order), sample, replace=False))]
    decode_errors = 0
    for p, base in take:
        entry = leaders.get(p, {}).get(base)
        if entry is None:
            decode_errors += 1
            continue
        fields, body = entry
        want = pool[acked[(p, base)]]
        try:
            section = DECODERS[fields[1] & 7](body)
            ok = section == want["section"] and [
                (k, v) for _, k, v in wire.decode_records(section, fields[8])] == want["records"]
        except (ValueError, KeyError, IndexError):
            ok = False
        decode_errors += not ok

    got = {}
    for p, base, _, dig, length, crc, count, _ in gen["receipts"]:
        got[(p, base)] = (dig, length, crc)
    consumer_missing = sum(1 for key in acked if key not in got)
    consumer_mismatch = sum(1 for key in acked if key in got and key in digest and got[key] != digest[key])

    return [("no_acks", int(not acked), 0), ("failed_batches", failed, 0), ("missing_replicas", missing_replicas, 0),
            ("replica_mismatches", mismatched_replicas, 0), ("offset_errors", offset_errors, 0),
            ("hwm_errors", hwm_errors, 0), ("crc_errors", crc_errors, 0), ("codec_errors", codec_errors, 0),
            ("decode_errors", decode_errors, 0), ("consumer_missing", consumer_missing, 0),
            ("consumer_mismatch", consumer_mismatch, 0)], {"acked_batches": len(acked), "decoded": len(take)}
