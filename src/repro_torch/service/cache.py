"""Program cache + warmup for the clustering service.

Counterpart of :mod:`repro.service.cache` (DESIGN.md §10).  The JAX
package keeps one AOT-compiled XLA executable per
:class:`~repro_torch.core.batched.BucketSignature`; the port keeps one
**bucket program** per signature on the service's device
(:class:`~repro_torch.core.batched.BucketProgram`): the bucket's static
device buffers (operand, sizes, each compaction stage's state) and, on the
kernel engine, each stage's CUDA graph, captured once when the program is
built.  The cache is:

* **observable** — hits / misses / compiles (programs built) / evictions
  are counted, so the zero-build steady-state property is an
  *assertion*, not a hope (``tests/test_torch_service.py``).
* **bounded** — LRU eviction at ``capacity`` entries; a traffic shift to
  new shapes retires old programs (and frees their buffers) instead of
  leaking them.
* **warmable** — :func:`warmup_signatures` enumerates every signature a
  declared traffic mix can touch (bucket grid × padded batch sizes), so a
  service warms up before taking traffic and then never builds.
* **restart-durable** — the cache is owned by the *service*, not by the
  worker thread that runs buckets: when the watchdog abandons a wedged
  worker and installs a replacement, the warmed programs survive, and the
  first request after recovery is a cache hit.

A program owns buffers that its run updates in place, so it carries a lock
(an XLA executable is a pure function and needs none): one run at a time.
:func:`engine_jit_cache_size` counts the programs built and the CUDA graphs
captured in this process, so tests can assert that warmed traffic builds
and captures nothing, through the cache or past it.

Only the ``serial`` and ``kernel`` engines are cacheable: the
``distributed`` engine's run is a collective over a live process group,
so mesh traffic goes through ``cluster_batch``, as in the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterable, Sequence

import torch

from repro_torch.core.batched import (
    BUCKETS,
    BucketProgram,
    BucketSignature,
    bucket_batch,
    bucket_signature,
)
from repro_torch.core.engine import resolve_device, stage_plan
from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer

#: Engines the program cache can build.
CACHEABLE_ENGINES: tuple[str, ...] = ("serial", "kernel")


class CacheStats:
    """Counters of one :class:`CompileCache` (monotonic), on the obs
    registry's labeled ``service_cache_events_total`` counter, read through
    ``stats.hits`` / ``.misses`` / ``.compiles`` (programs built) /
    ``.evictions`` / ``.hit_rate``."""

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        self.registry = registry or MetricsRegistry()
        self._events = self.registry.counter(
            "service_cache_events_total",
            "CompileCache events by kind (hit/miss/compile/eviction)",
        )

    def record(self, event: str, n: int = 1) -> None:
        self._events.inc(n, event=event)

    @property
    def hits(self) -> int:
        return int(self._events.value(event="hit"))

    @property
    def misses(self) -> int:
        return int(self._events.value(event="miss"))

    @property
    def compiles(self) -> int:
        return int(self._events.value(event="compile"))

    @property
    def evictions(self) -> int:
        return int(self._events.value(event="eviction"))

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclass(frozen=True)
class CostProfile:
    """Static per-dispatch cost of one bucket program, attached to its
    :class:`BucketSignature` when the program is built.  The JAX package
    reads it from the executable's optimized HLO; the port counts it
    analytically (:func:`profile_program`), under the same names.
    """

    flops: float
    bytes: float
    coll_bytes: float

    @property
    def intensity(self) -> float:
        """Arithmetic intensity (flop/byte) — <1 means memory-bound."""
        return self.flops / self.bytes if self.bytes else 0.0


def profile_program(sig: BucketSignature) -> CostProfile:
    """The analytic cost of one dispatch of ``sig``'s program at the
    bucket's full width (:mod:`repro_torch.roofline.cost`), counted as
    the same work whatever engine implements it: every lane of an LW
    bucket runs ``n_steps`` merges, each at the live width that the
    signature's stage plan gives, plus one seed a stage; every lane of a
    chain bucket runs the loop's cap of ``4n + 8`` trips."""
    from repro_torch.roofline import cost

    n = sig.bucket_n
    if sig.algorithm == "nnchain":
        lane = cost.nn_chain(n, 4 * n + 8, sig.points_dim, sig.method)
    else:
        lane = cost.lw_merge_loop(n, sig.n_steps,
                                  stage_plan(sig.engine, n, sig.n_steps, sig.compaction))
    total = sig.bucket_B * lane
    return CostProfile(flops=float(total.flops), bytes=float(total.bytes),
                       coll_bytes=float(total.coll_bytes))


def _sig_label(sig: BucketSignature) -> str:
    """Compact span/metric label for one signature."""
    return (f"{sig.algorithm}/{sig.method}/{sig.engine}"
            f"/n{sig.bucket_n}/B{sig.bucket_B}"
            + (f"/d{sig.points_dim}" if sig.points_dim else ""))


def _build(sig: BucketSignature, device: torch.device) -> BucketProgram:
    """Build the bucket program of one signature on ``device``: its static
    buffers, and on the kernel engine each stage's captured graph."""
    if sig.engine not in CACHEABLE_ENGINES:
        raise ValueError(
            f"the service program cache supports engines {CACHEABLE_ENGINES}, "
            f"not {sig.engine!r} (the distributed engine's run depends on the live "
            "process group — use cluster_batch for mesh traffic)"
        )
    return BucketProgram(sig, device, eager=True)


class CompileCache:
    """LRU cache of bucket programs on one device, keyed by signature.

    Thread-safe: the service's worker and a foreground warmup may race on
    :meth:`get`.  Builds are serialized by a lock of their own, outside the
    entry table's lock, so a hit never waits for a build; a caller that
    lost the race to build a signature finds it built.

    Observability: stats live on an obs registry (private by default; the
    owning service passes its own), each build is timed into a
    ``service_compile_seconds`` histogram and recorded as a ``compile``
    span on ``tracer``, and ``service_cache_entries`` gauges the live
    programs.  :attr:`cost_profiles` holds each cached program's
    :class:`CostProfile` (:func:`profile_program`), put in at build and
    popped on eviction, and the ``compile`` span carries it as
    ``hlo_flops``, ``hlo_bytes`` and ``hlo_coll_bytes``: the JAX package's
    names, so that one telemetry schema serves both packages, though the
    port's counts are analytic, not read from HLO.
    """

    def __init__(self, capacity: int = 64, *,
                 registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None,
                 device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.device = resolve_device(device)
        self.registry = registry or MetricsRegistry()
        self.tracer = tracer or NULL_TRACER
        self.stats = CacheStats(self.registry)
        self.cost_profiles: dict[BucketSignature, CostProfile] = {}
        self._entries: OrderedDict[BucketSignature, BucketProgram] = OrderedDict()
        self._lock = threading.Lock()
        self._build_lock = threading.Lock()
        self._entries_gauge = self.registry.gauge(
            "service_cache_entries", "Live bucket programs in the cache"
        )
        self._compile_hist = self.registry.histogram(
            "service_compile_seconds", "Bucket program build wall time", window=1024
        )

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, sig: BucketSignature) -> bool:
        return sig in self._entries

    def signatures(self) -> list[BucketSignature]:
        """Currently cached signatures, least-recently-used first."""
        with self._lock:
            return list(self._entries)

    def programs(self) -> list[BucketProgram]:
        """Currently cached programs, least-recently-used first."""
        with self._lock:
            return list(self._entries.values())

    def _lookup(self, sig: BucketSignature) -> BucketProgram | None:
        prog = self._entries.get(sig)
        if prog is not None:
            self._entries.move_to_end(sig)
        return prog

    def get(self, sig: BucketSignature) -> BucketProgram:
        """The program for ``sig`` on the cache's device, building it on a
        miss."""
        with self._lock:
            prog = self._lookup(sig)
            self.stats.record("hit" if prog is not None else "miss")
            if prog is not None:
                return prog
        with self._build_lock:
            with self._lock:
                prog = self._lookup(sig)
            if prog is not None:
                return prog
            t0 = time.perf_counter()
            prog = _build(sig, self.device)
            t1 = time.perf_counter()
            profile = profile_program(sig)
            self._compile_hist.observe(t1 - t0)
            self.tracer.add_span("compile", t0, t1, cat="cache", signature=_sig_label(sig),
                                 compile_s=round(t1 - t0, 6), program_bytes=prog.nbytes,
                                 hlo_flops=profile.flops, hlo_bytes=profile.bytes,
                                 hlo_coll_bytes=profile.coll_bytes)
            with self._lock:
                self.stats.record("compile")
                self._entries[sig] = prog
                self.cost_profiles[sig] = profile
                while len(self._entries) > self.capacity:
                    old, _ = self._entries.popitem(last=False)
                    self.cost_profiles.pop(old, None)
                    self.stats.record("eviction")
                self._entries_gauge.set(len(self._entries))
            return prog

    def warmup(self, sigs: Iterable[BucketSignature]) -> int:
        """Build every signature's program up front; returns programs built."""
        before = self.stats.compiles
        for sig in sigs:
            self.get(sig)
        return self.stats.compiles - before


def warmup_signatures(
    bucket_ns: Sequence[int],
    *,
    method: str,
    engine: str = "serial",
    variant: str = "baseline",
    stop_at_k: int = 1,
    with_threshold: bool = False,
    max_batch: int = 1,
    compaction: bool | str = "auto",
    algorithm: str = "lw",
    points_dim: int = 0,
) -> list[BucketSignature]:
    """The declarative warmup list for a traffic mix, as the JAX package
    enumerates it: every signature the batcher can dispatch for problems
    that fall into ``bucket_ns`` under a ``max_batch`` batching policy, the
    padded batch axis taking the powers of two up to
    ``bucket_batch(max_batch)`` — ``len(bucket_ns) × (log2(max_batch) + 1)``
    programs; warm them all and steady traffic builds nothing.

    ``compaction``, ``algorithm`` and ``points_dim`` resolve per bucket
    through :func:`~repro_torch.core.batched.bucket_signature`, so the
    signatures carry the stage schedule and the chain's canonical form.
    The one difference from the JAX package's list is the kernel engine at
    bucket 256, which the port's kernel plan does not stage
    (:func:`~repro_torch.core.batched._resolve_bucket_compaction`).
    """
    for n in bucket_ns:
        if n not in BUCKETS:
            raise ValueError(
                f"declared bucket {n} is not on the bucket grid {BUCKETS}"
            )
    sigs = []
    B_max = bucket_batch(max_batch)
    for n in bucket_ns:
        B = 1
        while B <= B_max:
            sigs.append(
                bucket_signature(
                    n,
                    B,
                    method=method,
                    engine=engine,
                    variant=variant,
                    stop_at_k=stop_at_k,
                    with_threshold=with_threshold,
                    compaction=compaction,
                    algorithm=algorithm,
                    points_dim=points_dim,
                )
            )
            B *= 2
    return sigs


def engine_jit_cache_size() -> int:
    """Bucket programs built plus CUDA graphs captured by the engine
    entries, in this process.

    The JAX package's function of this name counts the entries of the
    engines' implicit jit caches; the port's engines have no such cache,
    and what a run may build is a program or a graph.  Warmed steady
    service traffic runs exclusively through cached programs, whose graphs
    were captured when they were built, so this number must not grow while
    the service serves it (the tests snapshot it before and after).  A
    ``cluster_batch`` call builds a program a bucket, and the landmark
    lane's chain captures its graph a request.
    """
    from repro_torch.kernels.lw_step import MergeGraph
    from repro_torch.kernels.pairwise import TripGraph

    return BucketProgram.built + MergeGraph.captures + TripGraph.captures
