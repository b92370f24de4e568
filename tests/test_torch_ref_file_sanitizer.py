"""tests/test_file_sanitizer.py run on the port: all 4 cases, with
imports pointed at redpanda_tpu_torch. Nothing is left out.

File-op sanitizer tests (reference: utils/file_sanitizer.h debug
wrapper — op histories + misuse-site assertions)."""

import os

import pytest

from redpanda_tpu_torch.storage import file_sanitizer as fs


def test_wrap_identity_when_disabled(tmp_path, monkeypatch):
    monkeypatch.delenv("RP_FILE_SANITIZER", raising=False)
    raw = open(tmp_path / "f", "ab")
    assert fs.wrap(raw, "f") is raw
    raw.close()


def test_violations_carry_op_history(tmp_path, monkeypatch):
    monkeypatch.setenv("RP_FILE_SANITIZER", "1")
    path = str(tmp_path / "f.log")
    f = fs.wrap(open(path, "ab"), path)
    f.write(b"hello")
    f.flush()
    os.fsync(f.fileno())
    f.close()
    with pytest.raises(fs.FileSanitizerError) as ei:
        f.write(b"late")
    msg = str(ei.value)
    assert "write after close" in msg
    # the dumped history shows the life of the file up to the misuse
    for op in ("open", "write 5B", "flush", "fileno(fsync)", "close"):
        assert op in msg, msg
    with pytest.raises(fs.FileSanitizerError, match="double close"):
        f.close()
    with pytest.raises(fs.FileSanitizerError, match="flush after close"):
        f.flush()


def test_fsync_with_unflushed_writes_flagged(tmp_path, monkeypatch):
    """fsync before flush() marks unflushed userspace data durable —
    the sanitizer must catch the intent at fileno() time."""
    monkeypatch.setenv("RP_FILE_SANITIZER", "1")
    path = str(tmp_path / "g.log")
    f = fs.wrap(open(path, "ab"), path)
    f.write(b"buffered")
    with pytest.raises(fs.FileSanitizerError, match="unflushed"):
        f.fileno()
    f.flush()
    os.fsync(f.fileno())  # flushed: fine
    f.close()


def test_segment_lifecycle_under_sanitizer(tmp_path, monkeypatch):
    """A real segment append/flush/roll/truncate cycle runs clean with
    the sanitizer armed (the storage suite also runs under it in CI
    spot checks)."""
    monkeypatch.setenv("RP_FILE_SANITIZER", "1")
    from redpanda_tpu_torch.models.record import RecordBatchBuilder
    from redpanda_tpu_torch.storage.segment import Segment

    seg = Segment(str(tmp_path), 0, 1)
    for i in range(5):
        b = RecordBatchBuilder(base_offset=i, timestamp_ms=0)
        b.add(b"v%d" % i, key=b"k")
        seg.append(b.build())
    # the append handle is lazy (FD_BUDGET); it exists after a write
    assert isinstance(seg._file, fs.SanitizedFile)
    seg.flush()
    got = seg.read_batches(0)
    assert len(got) == 5
    seg.truncate(3)
    assert seg.dirty_offset == 2
    seg.close()
