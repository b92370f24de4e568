"""storage::api facade — kvstore + log_manager per shard.

Reference: src/v/storage/api.h:102-130 (per-shard bundle) and
log_manager.{h,cc} (ntp → log registry with manage()/remove(),
housekeeping timer driving retention).
"""

from __future__ import annotations

import os
import re
import time

from ..models.fundamental import NTP
from .batch_cache import BatchCache
from .kvstore import KvStore
from .log import Log, LogConfig

_SAFE = re.compile(r"[^A-Za-z0-9._-]")


def _ntp_dir(base: str, ntp: NTP) -> str:
    return os.path.join(
        base,
        _SAFE.sub("_", ntp.ns),
        _SAFE.sub("_", ntp.topic),
        str(ntp.partition),
    )


class LogManager:
    def __init__(
        self,
        data_dir: str,
        cache: BatchCache | None = None,
        probe=None,
    ):
        self._data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self._cache = cache if cache is not None else BatchCache()
        self._probe = probe  # StorageProbe shared by every managed log
        self._logs: dict[NTP, Log] = {}

    def manage(self, ntp: NTP, config: LogConfig | None = None) -> Log:
        """Create-or-open the log for ntp (log_manager.h:159)."""
        if ntp in self._logs:
            return self._logs[ntp]
        log = Log(
            _ntp_dir(self._data_dir, ntp), config, self._cache,
            probe=self._probe,
        )
        self._logs[ntp] = log
        return log

    def get(self, ntp: NTP) -> Log | None:
        return self._logs.get(ntp)

    def remove(self, ntp: NTP) -> None:
        log = self._logs.pop(ntp, None)
        if log is not None:
            log.close()
            # delete files
            d = _ntp_dir(self._data_dir, ntp)
            if os.path.isdir(d):
                for name in os.listdir(d):
                    os.remove(os.path.join(d, name))
                os.rmdir(d)

    @staticmethod
    def housekeeping_one(log: Log, now_ms: int) -> None:
        """One log's retention/compaction pass. Raft-replicated logs
        route through their snapshot-gated override so retention never
        strands a lagging follower."""
        if log.housekeeping_override is not None:
            log.housekeeping_override(now_ms)
        else:
            log.apply_retention(now_ms)

    def housekeeping(self) -> None:
        """Retention pass over all logs (log_manager.h:228-244 timer).
        The broker's sweep routes each log through the compaction
        scheduling group instead (app._housekeeping_loop)."""
        now_ms = int(time.time() * 1000)
        for log in self._logs.values():
            self.housekeeping_one(log, now_ms)

    def logs(self) -> dict[NTP, Log]:
        return dict(self._logs)

    def close(self) -> None:
        for log in self._logs.values():
            log.close()
        self._logs.clear()


class StorageApi:
    """Per-shard storage facade (storage/api.h:102)."""

    def __init__(
        self,
        data_dir: str,
        cache_max_bytes: int = 128 * 1024 * 1024,
        metrics=None,
    ):
        from .probe import StorageProbe

        self.data_dir = data_dir
        self.cache = BatchCache(cache_max_bytes)
        self.kvs = KvStore(os.path.join(data_dir, "kvstore"))
        self.probe = StorageProbe(metrics)
        self.log_mgr = LogManager(
            os.path.join(data_dir, "data"), self.cache, probe=self.probe
        )
        self.probe.register_read_metrics(self.cache, self.log_mgr)

    def close(self) -> None:
        self.log_mgr.close()
        self.kvs.close()
