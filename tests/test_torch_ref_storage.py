"""tests/test_storage.py run on the port: all 22 cases, with imports
pointed at redpanda_tpu_torch. Nothing is left out.

Storage engine tests.

Mirrors reference coverage: storage/tests/storage_e2e_test.cc,
kvstore_test.cc, log_segment_appender_test.cc, plus an opfuzz-style
randomized op sequence (storage/opfuzz/).
"""

import os

import numpy as np
import pytest

from redpanda_tpu_torch.compression import CompressionType
from redpanda_tpu_torch.models import NTP, RecordBatchBuilder, RecordBatchType
from redpanda_tpu_torch.storage import (
    BatchCache,
    KeySpace,
    KvStore,
    Log,
    LogConfig,
    LogManager,
    StorageApi,
    read_snapshot,
    write_snapshot,
)
from redpanda_tpu_torch.storage.snapshot import SnapshotCorruption


def make_batch(n=3, ts=1_700_000_000_000, value_size=32, btype=RecordBatchType.raft_data):
    b = RecordBatchBuilder(btype, timestamp_ms=ts)
    for i in range(n):
        b.add(os.urandom(value_size), key=f"k{i}".encode())
    return b.build()


class TestSnapshotFile:
    def test_roundtrip(self, tmp_path):
        p = str(tmp_path / "snap")
        write_snapshot(p, b"meta", b"payload" * 100)
        meta, payload = read_snapshot(p)
        assert meta == b"meta"
        assert payload == b"payload" * 100

    def test_detects_corruption(self, tmp_path):
        p = str(tmp_path / "snap")
        write_snapshot(p, b"meta", b"payload")
        data = bytearray(open(p, "rb").read())
        data[8] ^= 0xFF  # metadata_len field
        open(p, "wb").write(bytes(data))
        with pytest.raises(SnapshotCorruption):
            read_snapshot(p)


class TestKvStore:
    def test_put_get_remove(self, tmp_path):
        kv = KvStore(str(tmp_path))
        kv.put(KeySpace.consensus, b"vote", b"node-3")
        assert kv.get(KeySpace.consensus, b"vote") == b"node-3"
        # keyspaces are disjoint
        assert kv.get(KeySpace.storage, b"vote") is None
        kv.remove(KeySpace.consensus, b"vote")
        assert kv.get(KeySpace.consensus, b"vote") is None
        kv.close()

    def test_recovery_from_wal(self, tmp_path):
        kv = KvStore(str(tmp_path))
        for i in range(100):
            kv.put(KeySpace.controller, f"k{i}".encode(), f"v{i}".encode())
        kv.remove(KeySpace.controller, b"k50")
        kv.close()
        kv2 = KvStore(str(tmp_path))
        assert kv2.get(KeySpace.controller, b"k0") == b"v0"
        assert kv2.get(KeySpace.controller, b"k99") == b"v99"
        assert kv2.get(KeySpace.controller, b"k50") is None
        kv2.close()

    def test_recovery_after_snapshot_roll(self, tmp_path):
        kv = KvStore(str(tmp_path), wal_threshold=1024)
        for i in range(200):
            kv.put(KeySpace.storage, f"key{i}".encode(), os.urandom(64))
        kv.put(KeySpace.storage, b"final", b"value")
        kv.close()
        kv2 = KvStore(str(tmp_path), wal_threshold=1024)
        assert kv2.get(KeySpace.storage, b"final") == b"value"
        assert kv2.get(KeySpace.storage, b"key199") is not None
        kv2.close()

    def test_torn_wal_tail_dropped(self, tmp_path):
        kv = KvStore(str(tmp_path))
        kv.put(KeySpace.testing, b"a", b"1")
        kv.put(KeySpace.testing, b"b", b"2")
        kv.close()
        # corrupt the tail: append garbage simulating a torn write
        with open(str(tmp_path / "kvstore.wal"), "ab") as f:
            f.write(b"\x99" * 7)
        kv2 = KvStore(str(tmp_path))
        assert kv2.get(KeySpace.testing, b"a") == b"1"
        assert kv2.get(KeySpace.testing, b"b") == b"2"
        kv2.close()


class TestLog:
    def test_append_read(self, tmp_path):
        log = Log(str(tmp_path))
        offsets = []
        for i in range(10):
            base, last = log.append(make_batch(5), term=1)
            offsets.append((base, last))
        assert offsets[0] == (0, 4)
        assert offsets[9] == (45, 49)
        offs = log.offsets()
        assert offs.dirty_offset == 49
        batches = log.read(0)
        assert sum(b.record_count for b in batches) == 50
        # mid-log read
        batches = log.read(27)
        assert batches[0].header.base_offset == 25
        log.close()

    def test_flush_boundary(self, tmp_path):
        log = Log(str(tmp_path))
        log.append(make_batch(), term=1)
        offs = log.offsets()
        assert offs.dirty_offset == 2
        assert offs.committed_offset == -1  # not yet fsynced
        log.flush()
        assert log.offsets().committed_offset == 2
        log.close()

    def test_segment_rolling(self, tmp_path):
        log = Log(str(tmp_path), LogConfig(segment_max_bytes=2048))
        for _ in range(20):
            log.append(make_batch(4, value_size=64), term=1)
        assert log.segment_count() > 1
        # reads span segments
        batches = log.read(0)
        assert sum(b.record_count for b in batches) == 80
        log.close()

    def test_term_rolls_segment(self, tmp_path):
        log = Log(str(tmp_path))
        log.append(make_batch(), term=1)
        log.append(make_batch(), term=2)
        assert log.segment_count() == 2
        assert log.get_term(0) == 1
        assert log.get_term(3) == 2
        assert log.get_term(99) is None
        log.close()

    def test_recovery(self, tmp_path):
        log = Log(str(tmp_path), LogConfig(segment_max_bytes=4096))
        payloads = []
        for i in range(12):
            b = make_batch(3, value_size=128)
            log.append(b, term=1 + i // 6)
            payloads.append(b.body)
        log.close()
        log2 = Log(str(tmp_path))
        offs = log2.offsets()
        assert offs.dirty_offset == 35
        batches = log2.read(0)
        assert [b.body for b in batches] == payloads
        log2.close()

    def test_recovery_truncates_torn_tail(self, tmp_path):
        log = Log(str(tmp_path))
        log.append(make_batch(2), term=1)
        log.append(make_batch(2), term=1)
        log.close()
        # find the data file, chop 3 bytes off the tail
        seg_file = [f for f in os.listdir(tmp_path) if f.endswith(".log")][0]
        path = str(tmp_path / seg_file)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size - 3)
        log2 = Log(str(tmp_path))
        assert log2.offsets().dirty_offset == 1  # second batch dropped
        assert sum(b.record_count for b in log2.read(0)) == 2
        log2.close()

    def test_suffix_truncate(self, tmp_path):
        log = Log(str(tmp_path))
        for _ in range(5):
            log.append(make_batch(2), term=1)
        assert log.offsets().dirty_offset == 9
        log.truncate(6)
        assert log.offsets().dirty_offset == 5
        batches = log.read(0)
        assert sum(b.record_count for b in batches) == 6
        # appends continue from the cut
        base, last = log.append(make_batch(1), term=2)
        assert base == 6
        log.close()

    def test_prefix_truncate_and_retention(self, tmp_path):
        log = Log(str(tmp_path), LogConfig(segment_max_bytes=1024))
        for _ in range(30):
            log.append(make_batch(2, value_size=128), term=1)
        n_before = log.segment_count()
        assert n_before > 3
        log.prefix_truncate(log.offsets().dirty_offset // 2)
        assert log.segment_count() < n_before
        assert log.offsets().start_offset > 0
        # reads below start return nothing usable from removed range
        log.close()

    def test_compressed_batches_roundtrip(self, tmp_path):
        log = Log(str(tmp_path))
        b = RecordBatchBuilder(compression=CompressionType.zstd, timestamp_ms=1)
        for i in range(50):
            b.add(f"v{i}".encode() * 10)
        log.append(b.build(), term=1)
        out = log.read(0)[0]
        assert out.verify_crc()
        assert len(out.records()) == 50
        log.close()

    def test_timequery(self, tmp_path):
        log = Log(str(tmp_path))
        for i in range(5):
            log.append(make_batch(1, ts=1000 * (i + 1)), term=1)
        assert log.timequery(2500) == 2  # first batch with ts >= 2500 is #3 (ts 3000) at offset 2... bisect by batch
        log.close()


class TestBatchCache:
    def test_hit_and_eviction(self):
        cache = BatchCache(max_bytes=4096)
        idx = cache.make_index()
        batches = []
        for i in range(20):
            b = make_batch(2, value_size=100)
            b.header.base_offset = i * 2
            b.finalize_crcs()
            idx.put(b)
            batches.append(b)
        # newest entries cached, oldest evicted
        assert cache.size_bytes <= 4096
        assert idx.get(38) is not None
        assert idx.get(0) is None  # evicted

    def test_lookup_by_contained_offset(self):
        cache = BatchCache()
        idx = cache.make_index()
        b = make_batch(5)
        b.header.base_offset = 100
        b.header.last_offset_delta = 4
        b.finalize_crcs()
        idx.put(b)
        assert idx.get(102) is b
        assert idx.get(104) is b
        assert idx.get(105) is None

    def test_truncate(self):
        cache = BatchCache()
        idx = cache.make_index()
        for i in range(5):
            b = make_batch(1)
            b.header.base_offset = i
            idx.put(b)
        idx.truncate(3)
        assert idx.get(2) is not None
        assert idx.get(3) is None


class TestLogManager:
    def test_manage_and_reads_through_cache(self, tmp_path):
        api = StorageApi(str(tmp_path))
        ntp = NTP("kafka", "orders", 0)
        log = api.log_mgr.manage(ntp)
        log.append(make_batch(3), term=1)
        assert api.log_mgr.get(ntp) is log
        # cached read
        assert log.read(0)[0].record_count == 3
        assert api.cache.hits > 0 or api.cache.misses >= 0
        api.close()

    def test_remove_deletes_files(self, tmp_path):
        api = StorageApi(str(tmp_path))
        ntp = NTP("kafka", "t", 1)
        log = api.log_mgr.manage(ntp)
        log.append(make_batch(), term=1)
        api.log_mgr.remove(ntp)
        assert api.log_mgr.get(ntp) is None
        api.close()


class TestOpFuzz:
    """Randomized op-sequence fuzz (storage/opfuzz analog): a model log
    (list of batches) tracks expected state through appends, flushes,
    truncations, rolls and reopens."""

    @pytest.mark.parametrize("seed", [0, 1])
    def test_fuzz(self, tmp_path, seed):
        rng = np.random.default_rng(seed)
        d = str(tmp_path / f"fuzz{seed}")
        log = Log(d, LogConfig(segment_max_bytes=2048))
        model: list[bytes] = []  # expected record values in offset order
        boundaries = [0]  # batch-aligned offsets (raft truncates whole batches)
        term = 1
        for step in range(120):
            op = rng.choice(["append", "flush", "truncate", "reopen", "term"])
            if op == "append":
                n = int(rng.integers(1, 4))
                b = RecordBatchBuilder(timestamp_ms=step)
                vals = [os.urandom(16) for _ in range(n)]
                for v in vals:
                    b.add(v)
                log.append(b.build(), term=term)
                model.extend(vals)
                boundaries.append(len(model))
            elif op == "flush":
                log.flush()
            elif op == "truncate" and model:
                cut = int(rng.choice(boundaries))
                log.truncate(cut)
                del model[cut:]
                boundaries = [x for x in boundaries if x <= cut]
                if boundaries[-1] != cut:
                    boundaries.append(cut)
            elif op == "reopen":
                log.close()
                log = Log(d, LogConfig(segment_max_bytes=2048))
            elif op == "term":
                term += 1
        # final verification: full read matches the model
        got = []
        for b in log.read(0, max_bytes=1 << 30):
            got.extend(r.value for r in b.records())
        assert got == model
        assert log.offsets().dirty_offset == len(model) - 1
        log.close()
