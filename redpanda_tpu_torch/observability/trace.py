"""Flight recorder: ring-buffered trace spans with a slow-request freezer.

The reference has no distributed tracer (SURVEY §5.1 — request-level
visibility is sampled logs); this is the piece we add on top of the
probe/histogram layer. One `FlightRecorder` per broker holds:

  * a fixed-size ring of completed span *trees* (most recent first at
    dump time) — the "what just happened" tail;
  * a bounded freezer of full span trees whose root latency exceeded
    the slow threshold — the "why was that one slow" sample;
  * a small event log for out-of-band markers (NemesisNet fault
    injections land here and also tag the span they hit).

Span mechanics mirror utils/spans.py (the RP_SPANS featherweight
profiler): a module-level ENABLED flag checked per call, a shared
no-op context object when tracing is off, and `time.monotonic_ns()`
stamps. Parent linkage is a contextvar within a task; across tasks
(produce request -> batcher flush round) the caller captures
`current_span()` and passes it back via `span(..., parent=...)`.

Env knobs:
  RP_TRACE=0          kill switch — span() returns the shared no-op,
                      nothing is allocated or recorded
  RP_TRACE_SLOW_MS    slow-request freeze threshold (default 100 ms)
  RP_TRACE_RING       ring capacity in span trees (default 256)
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from contextvars import ContextVar
from typing import Optional

ENABLED = os.environ.get("RP_TRACE", "1") != "0"
SLOW_MS = float(os.environ.get("RP_TRACE_SLOW_MS", "100"))
RING_CAP = int(os.environ.get("RP_TRACE_RING", "256"))
FROZEN_CAP = 32
EVENTS_CAP = 256

_ids = itertools.count(1)
_current: ContextVar[Optional["Span"]] = ContextVar("rp_trace_span", default=None)
# cross-process parent adopted by the next ROOT span opened in this
# task: (trace_id, parent_span_id, origin) shipped inside the invoke_on
# envelope / TRACED_CALL rpc wrapper by the sending side
_remote: ContextVar[Optional[tuple]] = ContextVar("rp_trace_remote", default=None)


def _after_fork_child() -> None:
    """Fork hygiene: the id counter and the module-default recorder are
    copied by fork — reseed ids into a pid-disjoint range (stitched
    cross-process trees must never collide on span ids) and drop the
    parent's trees/events from the child's recorder."""
    global _ids
    _ids = itertools.count(((os.getpid() & 0x3FFFFF) << 40) | 1)
    r = _default_recorder
    r._ring = [None] * len(r._ring)
    r._ring_idx = 0
    r._frozen.clear()
    r._events.clear()
    r.trees_total = 0
    r.frozen_total = 0


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_after_fork_child)


class Span:
    """One timed node in a trace tree. Construct via span() — the
    context manager guarantees the exit stamp and ring handoff; a bare
    Span() that never closes silently poisons its whole tree (enforced
    by rplint RPL008 outside this package)."""

    __slots__ = (
        "name",
        "span_id",
        "parent_id",
        "start_ns",
        "dur_ns",
        "tags",
        "trace_id",
        "origin",
        "_root",
        "_recorder",
        "_spans",
        "_token",
    )

    def __init__(
        self,
        name: str,
        parent: Optional["Span"] = None,
        recorder: Optional["FlightRecorder"] = None,
        tags: Optional[dict] = None,
    ):
        self.name = name
        self.span_id = next(_ids)
        self.start_ns = 0
        self.dur_ns = -1
        self.tags = tags
        if parent is not None:
            self.parent_id = parent.span_id
            self._root = parent._root
            self._recorder = parent._recorder
        else:
            self._root = self
            # collector for every span in this tree, filled on exits
            self._spans: list[dict] = []
            self._recorder = recorder if recorder is not None else _default_recorder
            r = _remote.get()
            if r is not None:
                # root of a remote continuation: join the propagated
                # trace under the sender's span
                self.trace_id, self.parent_id, self.origin = r
            else:
                self.parent_id = 0
                self.trace_id = self.span_id
                self.origin = None
        self._token = None

    def tag(self, **tags) -> None:
        if self.tags is None:
            self.tags = tags
        else:
            self.tags.update(tags)

    def _to_dict(self) -> dict:
        d = {
            "name": self.name,
            "id": self.span_id,
            "parent": self.parent_id,
            "start_ns": self.start_ns,
            "dur_ns": self.dur_ns,
        }
        if self.tags:
            d["tags"] = self.tags
        return d

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        self.start_ns = time.monotonic_ns()
        return self

    def detach(self) -> None:
        """End this span's contextvar scope without stamping its end
        time — for a root whose lifetime crosses tasks (staged produce:
        dispatch happens here, the ack lands in the response writer).
        Call finish() from wherever the request actually completes."""
        if self._token is not None:
            try:
                _current.reset(self._token)
            except ValueError:
                # token from another Context (detach after a task hop)
                _current.set(None)
            self._token = None

    def finish(self, exc_type=None) -> None:
        """Stamp the end time and hand the tree to the recorder.
        Idempotent; __exit__ is detach()+finish()."""
        if self.dur_ns >= 0:
            return
        self.dur_ns = time.monotonic_ns() - self.start_ns
        if exc_type is not None:
            self.tag(error=exc_type.__name__)
        root = self._root
        root._spans.append(self._to_dict())
        if root is self:
            rec = self._recorder
            if rec is not None:
                rec._finish_tree(self)

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.detach()
        self.finish(exc_type)
        return False


class _NoopSpan:
    """Shared do-nothing context when tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **tags):
        pass

    def detach(self):
        pass

    def finish(self, exc_type=None):
        pass

    span_id = 0
    dur_ns = -1


_NOOP = _NoopSpan()


def span(
    name: str,
    parent: Optional[Span] = None,
    recorder: Optional["FlightRecorder"] = None,
    **tags,
):
    """Open a trace span. Parent defaults to the task's current span;
    pass `parent=` explicitly to stitch across tasks (e.g. a batcher
    flush round adopting the first queued produce's span). Keep tag
    values pre-formatted plain objects — building f-strings in the
    argument list runs even when tracing is off (rplint RPL008)."""
    if not ENABLED:
        return _NOOP
    if parent is None:
        parent = _current.get()
    return Span(name, parent=parent, recorder=recorder, tags=tags or None)


def current_span() -> Optional[Span]:
    """The innermost open span of this task, or None (also None when
    tracing is disabled — callers pass it straight back to span())."""
    if not ENABLED:
        return None
    return _current.get()


def propagation_ctx() -> Optional[tuple[int, int]]:
    """(trace_id, span_id) of the innermost open span, for shipping
    across a process/rpc boundary (invoke_on envelope, TRACED_CALL
    wrapper). None when tracing is off or no span is open — callers
    skip the wrap entirely."""
    if not ENABLED:
        return None
    s = _current.get()
    if s is None:
        return None
    return s._root.trace_id, s.span_id


def set_remote_parent(trace_id: int, span_id: int, origin: str):
    """Adopt an incoming cross-process trace context: the next root
    span opened under this token joins `trace_id` as a child of the
    sender's `span_id`. Returns a reset token (None when tracing is off
    or the context is empty — pass it straight to reset_remote_parent)."""
    if not ENABLED or not trace_id:
        return None
    return _remote.set((trace_id, span_id, origin))


def reset_remote_parent(token) -> None:
    if token is not None:
        _remote.reset(token)


def tag_current(**tags) -> None:
    """Attach tags to the innermost open span, if any."""
    if not ENABLED:
        return
    s = _current.get()
    if s is not None:
        s.tag(**tags)


class FlightRecorder:
    """Per-broker store of finished span trees + fault events."""

    def __init__(
        self,
        ring_capacity: int = RING_CAP,
        slow_ms: float = SLOW_MS,
        node_id: int = -1,
        shard: int = 0,
    ):
        self.node_id = node_id
        self.shard = shard
        self.slow_ns = int(slow_ms * 1e6)
        self._ring: list[Optional[dict]] = [None] * max(1, ring_capacity)
        self._ring_idx = 0
        self._frozen: deque[dict] = deque(maxlen=FROZEN_CAP)
        self._events: deque[dict] = deque(maxlen=EVENTS_CAP)
        self.trees_total = 0
        self.frozen_total = 0

    def span(self, name: str, **tags):
        """Open a *root* span recorded into this recorder."""
        if not ENABLED:
            return _NOOP
        return Span(name, recorder=self, tags=tags or None)

    def _finish_tree(self, root: Span) -> None:
        tree = {
            "trace_id": root.trace_id,
            "root": root.name,
            "dur_ns": root.dur_ns,
            "spans": root._spans,
            "node": self.node_id,
            "shard": self.shard,
        }
        if root.origin is not None:
            # continuation of a remote trace: the root's parent span
            # lives in another process's dump (stitch by trace_id)
            tree["remote_parent"] = root.parent_id
            tree["origin"] = root.origin
        self.trees_total += 1
        self._ring[self._ring_idx] = tree
        self._ring_idx = (self._ring_idx + 1) % len(self._ring)
        if root.dur_ns >= self.slow_ns:
            self.frozen_total += 1
            self._frozen.append(tree)

    def record_event(self, name: str, **tags) -> None:
        """Out-of-band marker (e.g. a NemesisNet fault firing): logged
        here and tagged onto the task's current span if one is open."""
        if not ENABLED:
            return
        self._events.append(
            {"name": name, "at_ns": time.monotonic_ns(), "tags": tags}
        )
        s = _current.get()
        if s is not None:
            s.tag(**{name: tags or True})

    def ring_tail(self, n: int = 50) -> list[dict]:
        """Most recent completed trees, newest last."""
        cap = len(self._ring)
        out = []
        for i in range(cap):
            t = self._ring[(self._ring_idx + i) % cap]
            if t is not None:
                out.append(t)
        return out[-n:]

    def frozen(self) -> list[dict]:
        return list(self._frozen)

    def events(self) -> list[dict]:
        return list(self._events)

    def dump(self, tail: int = 50) -> dict:
        """JSON-ready dump for /v1/debug/traces and tools/log_viewer."""
        return {
            "node_id": self.node_id,
            "shard": self.shard,
            "enabled": ENABLED,
            "slow_threshold_ms": self.slow_ns / 1e6,
            "trees_total": self.trees_total,
            "frozen_total": self.frozen_total,
            "frozen": self.frozen(),
            "ring": self.ring_tail(tail),
            "events": self.events(),
        }


# fallback recorder for spans opened outside any broker (unit tests,
# bench one-offs); brokers own their own instance
_default_recorder = FlightRecorder()


def default_recorder() -> FlightRecorder:
    return _default_recorder
