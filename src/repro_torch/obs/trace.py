"""Trace spans → Chrome trace-event JSON (the JAX package's
:mod:`repro.obs.trace`, DESIGN.md §13, copied).

A :class:`Tracer` records **complete events** (``"ph": "X"`` in the
Chrome trace-event format): name, category, start timestamp, duration,
thread id, and free-form ``args``.  Load the exported JSON in
``chrome://tracing`` or https://ui.perfetto.dev and a service run
renders as the familiar flame view — spans on one thread nest by time
containment, so the dispatcher's ``bucket`` span visibly contains its
``pack`` / ``cache`` / ``execute`` / ``resolve`` children.

Per-request **trace ids** stitch the cross-thread story together: the
caller-side ``submit`` span carries ``args.trace_id``; the dispatcher's
per-bucket spans carry ``args.trace_ids`` (every request packed into
that dispatch); the per-request ``resolve`` span carries ``trace_id``
again.  Following one id through the export is following one request
through the service.

Design constraints (the service's zero-build argument):

* **host-side only** — spans wrap calls *into* the engines, never code
  inside a captured CUDA graph.  Nothing here touches torch.
* **bounded** — events land in a ``deque(maxlen=...)``; a long-lived
  service keeps the most recent window instead of leaking.
* **cheap when off** — a disabled tracer's ``span()`` returns a shared
  no-op context manager: no timestamp read, no allocation, no lock.

Timestamps come from ``time.perf_counter()`` rebased to the tracer's
creation, exported in microseconds (the trace-event unit).
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from functools import wraps
from typing import Iterable


@dataclass(frozen=True)
class SpanEvent:
    """One completed span (a Chrome trace-event complete event)."""

    name: str
    cat: str
    ts_us: float                # start, microseconds since tracer epoch
    dur_us: float
    tid: int
    pid: int = 0
    args: dict = field(default_factory=dict)

    def to_trace_event(self) -> dict:
        return {
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": self.ts_us,
            "dur": self.dur_us,
            "pid": self.pid,
            "tid": self.tid,
            "args": self.args,
        }


class _NullSpan:
    """Shared no-op context manager — the disabled tracer's span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Span recorder.  One per service run (or one global, your call).

    ``enabled=False`` builds a tracer whose every operation is a cheap
    no-op — instrumented code does not need its own ``if`` guards, and
    ``new_trace_id()`` still hands out unique ids so the metrics-only
    path keeps request identity.
    """

    def __init__(self, *, enabled: bool = True, max_events: int = 262144,
                 pid: int = 0) -> None:
        self.enabled = enabled
        self.pid = pid
        self._epoch = time.perf_counter()
        # hot path appends raw (name, cat, t0, t1, tid, args) tuples;
        # SpanEvent objects materialize only at export — a frozen
        # dataclass construction per span would dominate the span cost
        self._events: deque[tuple] = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._thread_names: dict[int, str] = {}

    # -- ids / time -----------------------------------------------------------

    def new_trace_id(self) -> int:
        """Unique per-request id (atomic: itertools.count holds the GIL)."""
        return next(self._ids)

    def now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def name_thread(self, name: str) -> None:
        """Label the calling thread in the exported trace metadata."""
        if self.enabled:
            with self._lock:
                self._thread_names[threading.get_ident()] = name

    # -- recording ------------------------------------------------------------

    def span(self, name: str, cat: str = "service", **args):
        """Context manager timing one span.  No-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return self._span(name, cat, args)

    @contextmanager
    def _span(self, name: str, cat: str, args: dict):
        t0 = time.perf_counter()
        try:
            yield args      # callers may add result args before exit
        finally:
            t1 = time.perf_counter()
            self._record(name, cat, t0, t1, args)

    def trace(self, fn=None, *, name: str | None = None,
              cat: str = "service"):
        """Decorator form: ``@tracer.trace`` or ``@tracer.trace(name=...)``."""
        def deco(f):
            label = name or f.__qualname__

            @wraps(f)
            def wrapper(*a, **kw):
                if not self.enabled:
                    return f(*a, **kw)
                with self._span(label, cat, {}):
                    return f(*a, **kw)
            return wrapper
        return deco(fn) if fn is not None else deco

    def add_span(self, name: str, t0: float, t1: float, cat: str = "service",
                 **args) -> None:
        """Record a span from already-measured ``perf_counter`` endpoints
        (instrumentation that must not sit inside the timed region)."""
        if self.enabled:
            self._record(name, cat, t0, t1, args)

    def _record(self, name: str, cat: str, t0: float, t1: float,
                args: dict) -> None:
        # no lock: CPython deque.append is GIL-atomic, and readers only
        # ever take a point-in-time list() copy (also atomic) — the lock
        # guards the thread-name table, not the event window
        self._events.append((name, cat, t0, t1, threading.get_ident(), args))

    def _materialize(self, raw: tuple) -> SpanEvent:
        name, cat, t0, t1, tid, args = raw
        return SpanEvent(
            name=name,
            cat=cat,
            ts_us=(t0 - self._epoch) * 1e6,
            dur_us=max(t1 - t0, 0.0) * 1e6,
            tid=tid,
            pid=self.pid,
            args=args,
        )

    # -- export ---------------------------------------------------------------

    def events(self) -> list[SpanEvent]:
        """Point-in-time copy of the (bounded) event window."""
        raws = list(self._events)       # atomic snapshot under the GIL
        return [self._materialize(r) for r in raws]

    def export(self) -> dict:
        """Chrome trace-event JSON object (``json.dump`` it verbatim)."""
        raws = list(self._events)       # atomic snapshot under the GIL
        with self._lock:
            names = dict(self._thread_names)
        trace_events = [self._materialize(r).to_trace_event() for r in raws]
        for tid, name in names.items():
            trace_events.append({
                "name": "thread_name", "ph": "M", "pid": self.pid,
                "tid": tid, "args": {"name": name},
            })
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {"exporter": "repro_torch.obs.trace"},
        }

    def write(self, path: str) -> int:
        """Write the export to ``path``; returns the event count."""
        doc = self.export()
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


#: Shared always-off tracer — the default for every instrumented
#: component, so the uninstrumented path pays one attribute check.
NULL_TRACER = Tracer(enabled=False, max_events=1)


def spans_by_name(events: Iterable[SpanEvent], name: str) -> list[SpanEvent]:
    """Test/analysis helper: all spans with a given name."""
    return [e for e in events if e.name == name]
