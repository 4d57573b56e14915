"""Exporters: Prometheus-style text exposition + JSON dump (DESIGN.md §13).

Two renderings of one :class:`~repro_torch.obs.registry.MetricsRegistry`:

* :func:`prometheus_text` — the text exposition format a scrape
  endpoint would serve (``# HELP`` / ``# TYPE`` headers, labeled
  samples, histograms rendered as Prometheus *summaries*:
  ``name{quantile="0.5"}`` plus ``name_count`` / ``name_sum``).
  Dependency-free; paste into any Prometheus-compatible ingester.
* :func:`registry_json` / :func:`dump_json` — the machine-readable dump
  the CI workflow uploads as an artifact next to the Chrome trace.

:class:`PeriodicDumper` is the tiny daemon the load driver
(``repro_torch.service.server``) starts for periodic dumps: write-to-temp +
atomic rename, so a reader never sees a half-written file.
"""

from __future__ import annotations

import json
import os
import threading
import time

from repro_torch.obs.registry import Histogram, MetricsRegistry

_QUANTILES = ((50, "0.5"), (90, "0.9"), (99, "0.99"))


def _esc(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_sample(name: str, key, value, extra: tuple[str, str] | None = None):
    pairs = list(key)
    if extra is not None:
        pairs.append(extra)
    if pairs:
        body = ",".join(f'{k}="{_esc(str(v))}"' for k, v in pairs)
        return f"{name}{{{body}}} {value}"
    return f"{name} {value}"


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render every instrument in the Prometheus text exposition format."""
    lines: list[str] = []
    for inst in registry.instruments():
        if isinstance(inst, Histogram):
            lines.append(f"# HELP {inst.name} {inst.help}")
            lines.append(f"# TYPE {inst.name} summary")
            for key in inst.labelsets():
                labels = dict(key)
                for q, qs in _QUANTILES:
                    lines.append(_fmt_sample(
                        inst.name, key, inst.percentile(q, **labels),
                        extra=("quantile", qs),
                    ))
                lines.append(_fmt_sample(
                    f"{inst.name}_count", key, inst.count(**labels)))
                lines.append(_fmt_sample(
                    f"{inst.name}_sum", key, inst.sum(**labels)))
            continue
        # counters get the conventional `_total` suffix — unless the
        # instrument was already named with it
        suffix = (
            "_total"
            if inst.kind == "counter" and not inst.name.endswith("_total")
            else ""
        )
        lines.append(f"# HELP {inst.name}{suffix} {inst.help}")
        lines.append(f"# TYPE {inst.name}{suffix} {inst.kind}")
        for key, value in inst.series():
            lines.append(_fmt_sample(f"{inst.name}{suffix}", key, value))
    lines.append("")
    return "\n".join(lines)


def registry_json(registry: MetricsRegistry, extra: dict | None = None) -> dict:
    """JSON-serializable dump: instruments + registry timebase."""
    doc = {
        "started_at": registry.started_at,
        "uptime_s": registry.uptime_s,
        "metrics": registry.snapshot(),
    }
    if extra:
        doc["extra"] = extra
    return doc


def dump_json(registry: MetricsRegistry, path: str,
              extra: dict | None = None) -> None:
    """Atomic JSON dump (temp file + rename) — safe to read mid-run."""
    doc = registry_json(registry, extra)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=2, default=str)
    os.replace(tmp, path)


class PeriodicDumper:
    """Background thread writing a metrics dump every ``period_s``.

    The final state is always captured: ``stop()`` performs one last
    dump (dump-on-exit), so a crashed-early load run still leaves the
    freshest numbers on disk.  Use as a context manager.
    """

    def __init__(self, registry: MetricsRegistry, path: str,
                 period_s: float = 10.0) -> None:
        if period_s <= 0:
            raise ValueError(f"period_s must be positive, got {period_s}")
        self.registry = registry
        self.path = path
        self.period_s = period_s
        self.n_dumps = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="obs-metrics-dumper", daemon=True
        )

    def _dump(self) -> None:
        dump_json(self.registry, self.path)
        self.n_dumps += 1

    def _loop(self) -> None:
        next_t = time.perf_counter() + self.period_s
        while not self._stop.wait(max(next_t - time.perf_counter(), 0.0)):
            self._dump()
            next_t += self.period_s

    def start(self) -> "PeriodicDumper":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._dump()                        # dump-on-exit, always

    def __enter__(self) -> "PeriodicDumper":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
