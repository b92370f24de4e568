"""tests/test_foundation.py's storage case run on the port: the
positioned reader of `storage.log`, with imports pointed at
redpanda_tpu_torch. The file's other cases (crc, vint, iobuf and the
codec registry) hold modules that earlier slices ported and their own
tests hold; they are not carried here.
"""


def test_positioned_reader_hints_reused(tmp_path):
    """readers_cache analog (readers_cache.h:31): sequential polls
    resume at the exact byte where the previous read ended; truncation
    invalidates the positions."""
    from redpanda_tpu_torch.models.record import RecordBatchBuilder
    from redpanda_tpu_torch.storage.log import Log, LogConfig

    log = Log(str(tmp_path / "l"), LogConfig(segment_max_bytes=1 << 20))
    for i in range(200):
        b = RecordBatchBuilder(timestamp_ms=i)
        b.add(b"v%03d" % i * 100, key=b"k%d" % i)
        log.append(b.build(), term=1)
    log.flush()
    # sequential polls, small windows (no batch cache on this Log)
    pos = 0
    polls = 0
    while pos <= log.offsets().dirty_offset:
        got = log.read(pos, max_bytes=2048)
        if not got:
            break
        pos = got[-1].header.last_offset + 1
        polls += 1
    assert polls > 5
    assert log.reader_hits > 0, (log.reader_hits, log.reader_misses)
    # most disk reads after the first resumed from a cached position
    assert log.reader_hits >= log.reader_misses, (
        log.reader_hits,
        log.reader_misses,
    )
    # truncation drops the positions (stale bytes must not be served)
    hits_before = log.reader_hits
    log.truncate(150)
    got = log.read(100, max_bytes=2048)
    assert got and got[0].header.base_offset <= 100
    data = [r for b in log.read(140, max_bytes=1 << 20) for r in b.records()]
    assert all(int(r.key[1:]) < 150 for r in data)
    log.close()
