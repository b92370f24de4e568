"""Kafka's public wire format, written for the benchmark from the
protocol's published message definitions: record batches v2 (magic 2),
and the three requests a producer and a consumer need, at versions
every Kafka broker since 0.11 takes with the classic (non-flexible)
encoding: Metadata v1, Produce v3 and Fetch v4.

Plain Python, no third-party module: the load generator imports it
beside the standard library alone, and the reference check reads the
brokers' stored batches with it.
"""

from __future__ import annotations

import struct

METADATA, PRODUCE, FETCH = 3, 0, 1
METADATA_V, PRODUCE_V, FETCH_V = 1, 3, 4

# errors a Kafka client retries after a metadata refresh
RETRIABLE = {
    3: "unknown_topic_or_partition",
    5: "leader_not_available",
    6: "not_leader_for_partition",
    7: "request_timed_out",
    19: "not_enough_replicas",
    20: "not_enough_replicas_after_append",
    56: "kafka_storage_error",
}

# a record batch's fixed part: base offset, batch length, leader epoch,
# magic, crc, then (from the attributes on, what the CRC covers)
# attributes, last offset delta, first and max timestamps, producer id,
# producer epoch, base sequence, record count
BATCH_HEAD = struct.Struct(">qiibI")
BATCH_TAIL = struct.Struct(">hiqqqhii")
BATCH_OVERHEAD = BATCH_HEAD.size + BATCH_TAIL.size  # 61
CRC_FROM = BATCH_HEAD.size  # 21: the CRC covers the bytes from here
LENGTH_FROM = 12  # batch_length counts the bytes after base offset and itself

CODECS = {"none": 0, "gzip": 1, "snappy": 2, "lz4": 3, "zstd": 4}


# ------------------------------------------------------------ varints
def zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def put_varint(out: bytearray, n: int) -> None:
    """Append `n` as a zigzag varint (Kafka's record fields)."""
    v = zigzag(n) & 0xFFFFFFFFFFFFFFFF
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def get_varint(buf, pos: int) -> tuple:
    """(value, next position) of the zigzag varint at `pos`."""
    shift = result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            break
        shift += 7
        if shift > 63:
            raise ValueError("varint longer than 10 bytes")
    return (result >> 1) ^ -(result & 1), pos


# ------------------------------------------------------------ records
def encode_records(records, timestamp_delta: int = 0) -> bytes:
    """The records section of a batch: each (key, value) as a v2 record
    at its offset delta, no headers."""
    out = bytearray()
    for i, (key, value) in enumerate(records):
        body = bytearray(b"\x00")  # attributes
        put_varint(body, timestamp_delta)
        put_varint(body, i)
        if key is None:
            put_varint(body, -1)
        else:
            put_varint(body, len(key))
            body += key
        if value is None:
            put_varint(body, -1)
        else:
            put_varint(body, len(value))
            body += value
        put_varint(body, 0)  # header count
        put_varint(out, len(body))
        out += body
    return bytes(out)


def record_size(key: bytes, value: bytes, offset_delta: int) -> int:
    """Bytes one record takes in a records section."""
    body = bytearray()
    put_varint(body, 0)
    put_varint(body, offset_delta)
    put_varint(body, len(key))
    put_varint(body, len(value))
    put_varint(body, 0)
    n = 1 + len(body) + len(key) + len(value)
    head = bytearray()
    put_varint(head, n)
    return len(head) + n


def decode_records(section, count: int) -> list:
    """[(offset delta, key, value)] of a records section holding
    `count` records; raises ValueError where the bytes do not parse to
    exactly that."""
    out, pos = [], 0
    for _ in range(count):
        length, pos = get_varint(section, pos)
        end = pos + length
        if length < 0 or end > len(section):
            raise ValueError("record runs past its section")
        pos += 1  # attributes
        _, pos = get_varint(section, pos)  # timestamp delta
        delta, pos = get_varint(section, pos)
        klen, pos = get_varint(section, pos)
        key = None if klen < 0 else bytes(section[pos : pos + klen])
        pos += max(klen, 0)
        vlen, pos = get_varint(section, pos)
        value = None if vlen < 0 else bytes(section[pos : pos + vlen])
        pos += max(vlen, 0)
        nh, pos = get_varint(section, pos)
        for _ in range(nh):
            hk, pos = get_varint(section, pos)
            pos += max(hk, 0)
            hv, pos = get_varint(section, pos)
            pos += max(hv, 0)
        if pos != end:
            raise ValueError("record length disagrees with its fields")
        out.append((delta, key, value))
    if pos != len(section):
        raise ValueError(f"{len(section) - pos} bytes after the last record")
    return out


def batch_tail(attrs: int, last_offset_delta: int, first_ts: int, max_ts: int, producer_id: int,
               producer_epoch: int, base_sequence: int, record_count: int) -> bytes:
    return BATCH_TAIL.pack(attrs, last_offset_delta, first_ts, max_ts, producer_id, producer_epoch,
                           base_sequence, record_count)


def batch_wire(tail: bytes, crc: int) -> bytes:
    """A whole v2 batch as a producer sends it (base offset 0), from its
    bytes from the attributes on and their CRC-32C."""
    return BATCH_HEAD.pack(0, 4 + 1 + 4 + len(tail), -1, 2, crc) + tail  # epoch, magic, crc, tail


def split_batches(blob) -> list:
    """The whole batches of a fetch response's records, as (base offset,
    memoryview of the batch); a trailing partial batch (Kafka may cut
    one at the size limit) is left out."""
    out, pos, n = [], 0, len(blob)
    view = memoryview(blob)
    while pos + LENGTH_FROM <= n:
        base, length = struct.unpack_from(">qi", blob, pos)
        end = pos + LENGTH_FROM + length
        if length <= 0 or end > n:
            break
        out.append((base, view[pos:end]))
        pos = end
    return out


def batch_fields(batch) -> dict:
    """The fixed fields of one wire batch."""
    base, length, epoch, magic, crc = BATCH_HEAD.unpack_from(batch, 0)
    attrs, lod, first_ts, max_ts, pid, pepoch, bseq, count = BATCH_TAIL.unpack_from(batch, CRC_FROM)
    return {"base_offset": base, "length": length, "magic": magic, "crc": crc, "attrs": attrs,
            "last_offset_delta": lod, "record_count": count}


# ------------------------------------------------------------ requests
def _str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def request(api: int, version: int, corr: int, client_id: str, body: bytes) -> bytes:
    """A size-prefixed request frame, header v1."""
    head = struct.pack(">hhi", api, version, corr) + _str(client_id)
    return struct.pack(">i", len(head) + len(body)) + head + body


def metadata_request(topics) -> bytes:
    return struct.pack(">i", len(topics)) + b"".join(_str(t) for t in topics)


def produce_request(topic: str, partition: int, batch: bytes, acks: int, timeout_ms: int) -> bytes:
    return (struct.pack(">hhi", -1, acks, timeout_ms) + struct.pack(">i", 1) + _str(topic)
            + struct.pack(">iii", 1, partition, len(batch)) + batch)


def fetch_request(topic: str, offsets, max_wait_ms: int, min_bytes: int, max_bytes: int,
                  partition_max_bytes: int) -> bytes:
    """One topic's partitions, `offsets` as [(partition, fetch offset)]."""
    parts = b"".join(struct.pack(">iqi", p, off, partition_max_bytes) for p, off in offsets)
    return (struct.pack(">iiiib", -1, max_wait_ms, min_bytes, max_bytes, 0) + struct.pack(">i", 1)
            + _str(topic) + struct.pack(">i", len(offsets)) + parts)


class Reader:
    def __init__(self, buf, pos: int = 0):
        self.buf, self.pos = buf, pos

    def take(self, fmt: str):
        s = struct.Struct(fmt)
        v = s.unpack_from(self.buf, self.pos)
        self.pos += s.size
        return v if len(v) > 1 else v[0]

    def string(self):
        n = self.take(">h")
        if n < 0:
            return None
        s = bytes(self.buf[self.pos : self.pos + n]).decode()
        self.pos += n
        return s

    def blob(self):
        n = self.take(">i")
        if n < 0:
            return None
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b


def metadata_response(body) -> tuple:
    """({node id: (host, port)}, {(topic, partition): (error, leader)})."""
    r = Reader(body)
    brokers = {}
    for _ in range(r.take(">i")):
        node = r.take(">i")
        host = r.string()
        port = r.take(">i")
        r.string()  # rack
        brokers[node] = (host, port)
    r.take(">i")  # controller
    parts = {}
    for _ in range(r.take(">i")):
        terr = r.take(">h")
        name = r.string()
        r.take(">b")
        for _ in range(r.take(">i")):
            perr, idx, leader = r.take(">hii")
            for _ in range(2):  # replicas, isr
                n = r.take(">i")
                r.pos += 4 * max(n, 0)
            parts[(name, idx)] = (perr or terr, leader)
    return brokers, parts


def produce_response(body) -> tuple:
    """(error code, base offset) of a one-partition produce."""
    r = Reader(body)
    r.take(">i")  # topics
    r.string()
    r.take(">i")  # partitions
    _, error, base, _ = r.take(">ihqq")
    return error, base


def fetch_response(body) -> list:
    """[(partition, error, high watermark, records blob or None)]."""
    r = Reader(body)
    r.take(">i")  # throttle
    out = []
    for _ in range(r.take(">i")):
        r.string()
        for _ in range(r.take(">i")):
            part, error, hwm, _ = r.take(">ihqq")
            n = r.take(">i")
            r.pos += 16 * max(n, 0)  # aborted transactions
            out.append((part, error, hwm, r.blob()))
    return out
