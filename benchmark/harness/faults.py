"""Faults planted in the program for the benchmark's own tests of its
check (`run.py --fault NAME`; the benchmark's runs plant none). Each
must turn `correct` false:

- rf1: the control. The topic is made with one replica where the
  configuration states three (Redpanda takes odd replication factors
  only), the guarantee a faster broker would be tempted to give up.
  Planted in run.py, not here.
- corrupt: the broker's recompressed body has one byte altered where
  the codec produces it (the card's output: `ops.fused.crc_lz4_fused`'s
  block, or `compression.tpu_backend.compress_many_zstd`'s frame).
- halve: the codec compresses only the first half of each records
  section (the CRC verify still sees the whole batch), so half of every
  batch is left out of what is stored.
- corrupt-fetch: the last byte of each fetch response's first records
  is altered once the broker's handler (its CRC verify included) has
  built the answer.
"""

from __future__ import annotations

NAMES = ("rf1", "corrupt", "halve", "corrupt-fetch")


def _flip(b: bytes, at: int) -> bytes:
    return b[:at] + bytes([b[at] ^ 0x5A]) + b[at + 1 :]


def install(name: str) -> None:
    if name not in NAMES:
        raise SystemExit(f"unknown fault {name!r} (have {NAMES})")
    if name == "rf1":
        return
    from redpanda_tpu_torch.compression import tpu_backend
    from redpanda_tpu_torch.kafka import server
    from redpanda_tpu_torch.ops import fused

    lz4_fused, zstd_many = fused.crc_lz4_fused, tpu_backend.compress_many_zstd
    handle_fetch = server.KafkaServer.handle_fetch

    if name == "corrupt":
        def crc_lz4_fused(prefixes, bodies, device=None):
            crcs, blocks = lz4_fused(prefixes, bodies, device)
            return crcs, [_flip(b, len(b) // 2) for b in blocks]

        def compress_many_zstd(buffers):
            return [_flip(f, len(f) - 2) for f in zstd_many(buffers)]
    elif name == "halve":
        def crc_lz4_fused(prefixes, bodies, device=None):
            crcs, _ = lz4_fused(prefixes, bodies, device)
            _, blocks = lz4_fused(prefixes, [b[: len(b) // 2] for b in bodies], device)
            return crcs, blocks

        def compress_many_zstd(buffers):
            return zstd_many([b[: len(b) // 2] for b in buffers])
    else:
        async def altered_fetch(self, hdr, req):
            resp = await handle_fetch(self, hdr, req)
            for p in (p for t in resp.responses for p in t.partitions if p.records):
                p.records = _flip(bytes(p.records), len(p.records) - 1)
                break
            return resp

        server.KafkaServer.handle_fetch = altered_fetch
        return
    fused.crc_lz4_fused = crc_lz4_fused
    tpu_backend.compress_many_zstd = compress_many_zstd
