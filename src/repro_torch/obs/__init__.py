"""repro_torch.obs — dependency-free observability layer.

Counterpart of :mod:`repro.obs` (DESIGN.md §13), framework-free and
copied here because the port imports nothing of the JAX package.

One metrics substrate + one span substrate for the whole repo:

* :mod:`~repro_torch.obs.registry` — thread-safe :class:`MetricsRegistry`
  (labeled counters, gauges, bounded-window histograms with
  percentiles).  ``service.batcher.ServiceMetrics`` and
  ``service.cache.CacheStats`` sit on it; the distributed chain and
  fault runtime feed the process-global default (:func:`get_registry`).
* :mod:`~repro_torch.obs.trace` — :class:`Tracer` span API (context manager +
  decorator + record-from-timestamps), per-request trace ids, Chrome
  trace-event JSON export (renders in ``chrome://tracing`` / Perfetto).
* :mod:`~repro_torch.obs.export` — Prometheus-style text exposition, JSON
  dump, and the periodic dumper the service load driver uses.

Everything is host-side by design: instrumentation wraps calls *into*
the engines and never runs inside a captured CUDA graph, so the
service's zero-build contract is untouched.
"""

from repro_torch.obs.export import (
    PeriodicDumper,
    dump_json,
    prometheus_text,
    registry_json,
)
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    reset_registry,
)
from repro_torch.obs.trace import NULL_TRACER, SpanEvent, Tracer, spans_by_name

__all__ = [
    "NULL_TRACER",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "PeriodicDumper",
    "SpanEvent",
    "Tracer",
    "dump_json",
    "get_registry",
    "prometheus_text",
    "registry_json",
    "reset_registry",
    "spans_by_name",
]
