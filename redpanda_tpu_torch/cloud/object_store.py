"""Object-store client abstraction.

Reference: src/v/cloud_storage_clients/ (client.h — the S3/ABS client
interface: put/get/head/list/delete on keys) and src/v/cloud_storage/
remote.h:117 (the retrying orchestration wrapper).

Zero-egress environments get two backends: a filesystem store (atomic
rename puts — the durability model of a real bucket) and an in-memory
store for tests. Both speak the same minimal S3-shaped API, so a real
boto-style client slots in behind the same surface.
"""

from __future__ import annotations

import asyncio
import os
import random
from typing import Optional, Protocol


class StoreError(Exception):
    pass


class StoreThrottled(StoreError):
    """429-style slow-down response. Retriable, but the backoff should
    honor the server's retry-after hint instead of hammering."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class CloudUnavailableError(StoreError):
    """Typed degradation signal: the cloud path stayed unreachable (or
    kept corrupting) past its bounded retries. Consumers surface this
    as a retriable condition (Kafka: KAFKA_STORAGE_ERROR) instead of a
    hung fetch or a bogus out-of-range."""


class ObjectStore(Protocol):
    async def put(self, key: str, data: bytes) -> None: ...

    async def get(self, key: str) -> bytes: ...

    async def get_range(self, key: str, start: int, end: int) -> bytes: ...

    async def exists(self, key: str) -> bool: ...

    async def list(self, prefix: str) -> list[str]: ...

    async def delete(self, key: str) -> None: ...

    async def head(self, key: str) -> int: ...


class MemoryObjectStore:
    """In-memory bucket (the test double the reference builds with
    s3_imposter). Fault injection lives in cloud/nemesis.py — wrap
    with NemesisObjectStore instead of hooking the store itself."""

    def __init__(self):
        self._data: dict[str, bytes] = {}
        self.put_count = 0
        self.get_count = 0

    async def put(self, key: str, data: bytes) -> None:
        self.put_count += 1
        self._data[key] = bytes(data)

    async def get(self, key: str) -> bytes:
        self.get_count += 1
        if key not in self._data:
            raise StoreError(f"no such key: {key}")
        return self._data[key]

    async def get_range(self, key: str, start: int, end: int) -> bytes:
        self.get_count += 1
        if key not in self._data:
            raise StoreError(f"no such key: {key}")
        return self._data[key][start:end]

    async def exists(self, key: str) -> bool:
        return key in self._data

    async def list(self, prefix: str) -> list[str]:
        return sorted(k for k in self._data if k.startswith(prefix))

    async def delete(self, key: str) -> None:
        self._data.pop(key, None)

    async def head(self, key: str) -> int:
        if key not in self._data:
            raise StoreError(f"no such key: {key}")
        return len(self._data[key])


class FilesystemObjectStore:
    """Bucket on a directory: keys are relative paths, puts are
    tmp-write + fsync + atomic rename (objects are all-or-nothing,
    like S3)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        if key.startswith("/") or ".." in key.split("/"):
            raise StoreError(f"invalid key: {key}")
        return os.path.join(self.root, key)

    async def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{random.randrange(1 << 30)}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    async def get(self, key: str) -> bytes:
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise StoreError(f"no such key: {key}") from None

    async def get_range(self, key: str, start: int, end: int) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                f.seek(start)
                return f.read(end - start)
        except FileNotFoundError:
            raise StoreError(f"no such key: {key}") from None

    async def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    async def list(self, prefix: str) -> list[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for name in files:
                if name.endswith(".tmp") or ".tmp." in name:
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    async def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    async def head(self, key: str) -> int:
        try:
            return os.path.getsize(self._path(key))
        except FileNotFoundError:
            raise StoreError(f"no such key: {key}") from None


class RetryingStore:
    """Exp-backoff retry wrapper (cloud_storage/remote.h over
    utils/retry_chain_node.h): every operation runs under a child of
    the store's retry-chain root, so transient StoreErrors back off
    with jitter, per-op deadlines bound total retry time, per-attempt
    timeouts bound a hung endpoint (a stuck socket burns one attempt,
    not the whole budget), throttle responses honor their retry-after
    hint, and `abort()` (archiver shutdown) cancels every in-flight
    retry loop at once."""

    def __init__(
        self,
        inner: ObjectStore,
        attempts: int = 4,
        base_backoff_s: float = 0.05,
        op_deadline_s: float | None = 30.0,
        attempt_timeout_s: float | None = 10.0,
    ):
        from ..utils.retry_chain import RetryChainNode

        self._inner = inner
        self._attempts = attempts
        self._chain = RetryChainNode(base_backoff_s=base_backoff_s)
        self._op_deadline = op_deadline_s
        self._attempt_timeout = attempt_timeout_s
        # observability hook: called with the op name on every retry
        # (CloudProbe wires this to the upload-retries counter)
        self.on_retry = None

    def abort(self) -> None:
        self._chain.abort()

    async def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close is not None:
            await close()

    async def _retry(self, op, *args):
        from ..utils.retry_chain import RetryChainAborted

        node = self._chain.child(deadline_s=self._op_deadline)
        try:
            for attempt in range(self._attempts):
                node.check_abort()
                timeout = self._attempt_timeout
                rem = node.remaining_s()
                if rem is not None:
                    if rem <= 0:
                        raise StoreError(f"{op.__name__}: op deadline exhausted")
                    timeout = min(timeout, rem) if timeout is not None else rem
                try:
                    if timeout is None:
                        return await op(*args)
                    return await asyncio.wait_for(op(*args), timeout=timeout)
                except asyncio.TimeoutError:
                    err: StoreError = StoreError(
                        f"{op.__name__}: attempt timed out after {timeout:.1f}s"
                    )
                except StoreError as e:
                    err = e
                if attempt == self._attempts - 1:
                    raise err
                if isinstance(err, StoreThrottled) and err.retry_after_s > 0:
                    # server asked for a pause: honor it (capped by the
                    # op deadline) before the jittered backoff
                    pause = err.retry_after_s
                    rem = node.remaining_s()
                    if rem is not None:
                        pause = min(pause, max(rem, 0.0))
                    await asyncio.sleep(pause)
                if self.on_retry is not None:
                    self.on_retry(op.__name__)
                if not await node.backoff():
                    raise err
        except RetryChainAborted:
            # callers handle store unavailability, not chain internals
            raise StoreError("aborted (shutdown)") from None

    async def put(self, key: str, data: bytes) -> None:
        await self._retry(self._inner.put, key, data)

    async def get(self, key: str) -> bytes:
        return await self._retry(self._inner.get, key)

    async def get_range(self, key: str, start: int, end: int) -> bytes:
        ranged = getattr(self._inner, "get_range", None)
        if ranged is None:
            # store without range support: fetch whole, slice (correct,
            # just not bandwidth-optimal)
            return (await self._retry(self._inner.get, key))[start:end]
        return await self._retry(ranged, key, start, end)

    async def exists(self, key: str) -> bool:
        return await self._retry(self._inner.exists, key)

    async def list(self, prefix: str) -> list[str]:
        return await self._retry(self._inner.list, prefix)

    async def delete(self, key: str) -> None:
        await self._retry(self._inner.delete, key)

    async def head(self, key: str) -> int:
        head = getattr(self._inner, "head", None)
        if head is None:
            # store without a head/stat op: size via full fetch
            return len(await self._retry(self._inner.get, key))
        return await self._retry(head, key)
