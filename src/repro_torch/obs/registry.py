"""Thread-safe metrics registry — the ONE metrics substrate (the JAX
package's :mod:`repro.obs.registry`, DESIGN.md §13, copied).

Before this module the repo had three disconnected ad-hoc telemetry
mechanisms (``service.batcher.ServiceMetrics``, ``service.cache.CacheStats``,
the distributed driver's restart/straggler warnings).  All of them now
sit on this registry; anything new instruments itself here and gets the
exporters (:mod:`repro_torch.obs.export`) for free.

Three instrument kinds, all label-aware and safe under concurrent
writers (``tests/test_torch_obs.py`` hammers them from many threads):

* :class:`Counter` — monotonic float, ``inc(v, **labels)``.
* :class:`Gauge` — last-write-wins float, ``set(v, **labels)``.
* :class:`Histogram` — bounded-window distribution: observations land in
  a ``deque(maxlen=window)`` per label set (so a long-lived service
  neither grows without bound nor pays an ever-larger percentile sort),
  while ``count``/``sum`` stay whole-lifetime.  ``percentile(q)`` reads
  the window.

Locking is per-instrument (one lock covers every label series of that
instrument); the registry itself only locks the instrument table.  A
reader (``snapshot()``, the exporters) takes the same locks, so it sees
each instrument at a consistent point — never a torn update, never an
exception mid-write.

Instrumented code paths stay **host-side**: nothing in this module may
be called from inside a captured CUDA graph (the service's zero-build
contract).

The process-global default registry (:func:`get_registry`) serves
code without a natural owner (the distributed chain driver, fault
events); components with a lifecycle (one ``ClusteringService``) own a
private registry so two services in one process never double-count.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Iterator

LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: dict) -> LabelKey:
    """Canonical hashable form of a label set (sorted, stringified)."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    """Shared plumbing: name, help text, one lock, per-label-set series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "") -> None:  # noqa: A002
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: dict[LabelKey, object] = {}

    def labelsets(self) -> list[LabelKey]:
        with self._lock:
            return list(self._series)

    def series(self) -> Iterator[tuple[LabelKey, object]]:
        """Consistent point-in-time copy of every (labels, value) pair."""
        with self._lock:
            return iter(list(self._series.items()))


class Counter(_Instrument):
    """Monotonic accumulator.  ``inc`` never goes backwards; ``value``
    reads one label series, ``total`` sums across all of them."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({value})")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._series.values()))


class Gauge(_Instrument):
    """Last-write-wins scalar (queue depth, bytes resident, flags)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def add(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class _HistSeries:
    __slots__ = ("window", "count", "sum")

    def __init__(self, maxlen: int) -> None:
        self.window: deque[float] = deque(maxlen=maxlen)
        self.count = 0              # whole-lifetime
        self.sum = 0.0              # whole-lifetime


class Histogram(_Instrument):
    """Bounded-window distribution with whole-lifetime count/sum.

    ``percentile`` sorts a copy of the window (taken under the lock), so
    concurrent ``observe`` calls can never tear the read.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", window: int = 8192) -> None:  # noqa: A002
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        super().__init__(name, help)
        self.window_size = window

    def _get(self, key: LabelKey) -> _HistSeries:
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(self.window_size)
        return s

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._get(key)
            s.window.append(float(value))
            s.count += 1
            s.sum += value

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s.count if s is not None else 0

    def sum(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s.sum if s is not None else 0.0

    def window(self, **labels) -> list[float]:
        """Copy of the bounded window (the last ``window_size`` values)."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            return list(s.window) if s is not None else []

    def percentile(self, q: float, **labels) -> float:
        """q-th percentile (0..100) of the window; 0.0 when empty.

        Linear interpolation between closest ranks — matches
        ``numpy.percentile``'s default on the same data.
        """
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {q}")
        vals = self.window(**labels)
        if not vals:
            return 0.0
        vals.sort()
        pos = (len(vals) - 1) * q / 100.0
        lo = math.floor(pos)
        hi = min(lo + 1, len(vals) - 1)
        return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


class MetricsRegistry:
    """Named instruments, created idempotently.

    ``counter``/``gauge``/``histogram`` return the existing instrument
    when the name was already registered (so modules can declare their
    metrics at call sites without coordination) and raise if the name is
    registered under a *different* kind — a silent kind collision would
    corrupt the export.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}
        self.started_at = time.time()
        self._t0 = time.perf_counter()

    @property
    def uptime_s(self) -> float:
        return time.perf_counter() - self._t0

    def _register(self, cls, name: str, help: str, **kw) -> _Instrument:  # noqa: A002
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{inst.kind}, cannot re-register as {cls.kind}"
                    )
                return inst
            inst = cls(name, help, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "") -> Counter:  # noqa: A002
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:  # noqa: A002
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",  # noqa: A002
                  window: int = 8192) -> Histogram:
        return self._register(Histogram, name, help, window=window)

    def instruments(self) -> list[_Instrument]:
        with self._lock:
            return list(self._instruments.values())

    def get(self, name: str) -> _Instrument | None:
        with self._lock:
            return self._instruments.get(name)

    def snapshot(self) -> dict:
        """Plain-data dump of every instrument (the JSON exporter's input).

        Histograms export lifetime count/sum plus window p50/p90/p99 —
        the quantiles a dashboard actually plots.
        """
        out: dict = {}
        for inst in self.instruments():
            if isinstance(inst, Histogram):
                series = {}
                for key, _ in inst.series():
                    labels = dict(key)
                    series[_fmt_labels(key)] = {
                        "count": inst.count(**labels),
                        "sum": inst.sum(**labels),
                        "p50": inst.percentile(50, **labels),
                        "p90": inst.percentile(90, **labels),
                        "p99": inst.percentile(99, **labels),
                        "window_len": len(inst.window(**labels)),
                    }
            else:
                series = {_fmt_labels(k): v for k, v in inst.series()}
            out[inst.name] = {"kind": inst.kind, "help": inst.help,
                              "series": series}
        return out


def _fmt_labels(key: LabelKey) -> str:
    """Stable string form of a label key for snapshot/JSON dicts."""
    return ",".join(f"{k}={v}" for k, v in key) if key else ""


_default_registry = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global default registry (distributed chain, fault
    events — anything without a natural single owner)."""
    return _default_registry


def reset_registry() -> MetricsRegistry:
    """Swap in a fresh default registry (tests isolate themselves with
    this); returns the new one."""
    global _default_registry
    with _default_lock:
        _default_registry = MetricsRegistry()
        return _default_registry
