"""Micro-batching front-end over the batched LW engine.

Counterpart of :mod:`repro.service.batcher` (DESIGN.md §10), on the
port's batched engines and its cache of bucket programs
(:mod:`repro_torch.service.cache`).

Production traffic is not one offline ``cluster_batch`` call — it is
many small independent requests arriving *continuously* (one dendrogram
per user session, document shard, protein family).  Dispatching each
request alone forfeits the batched engine's throughput; waiting for a
full batch forfeits latency.  The batcher implements the standard
continuous-batching compromise:

* the first request into an empty queue opens a **batching window** of
  ``max_delay_ms``;
* the window closes early once ``max_batch`` requests have arrived;
* whatever arrived is grouped into the scheduler's shape buckets
  (:func:`repro_torch.core.batched.bucket_n`) and each bucket is dispatched
  as ONE engine call — a bucket program fetched from the
  :class:`~repro_torch.service.cache.CompileCache` by its
  :class:`~repro_torch.core.batched.BucketSignature`, so warmed steady-state
  traffic builds no program and captures no graph.

Every ``submit`` returns a ``concurrent.futures.Future`` resolving to
the same :class:`~repro_torch.core.api.ClusterResult` the single-problem
``cluster(data, method, algorithm='lw', backend=<engine>, ...)`` call
would produce — exactly the ``cluster_batch`` per-problem contract, since
each bucket IS one batched-engine dispatch (the port's merges equal its
``cluster_batch``'s bit for bit).  The result carries the request's
points/distance matrix, so the streaming assignment path
(:mod:`repro_torch.service.assign`) can export exemplars without
re-touching the service.

**The device.**  A service runs on one device, CUDA unless the caller
names the CPU (``ClusteringService(..., device="cpu")``); without a card
it raises, and it never falls back to the CPU on its own.  Every device
operation of a bucket (the upload, the run and the read-back, and a cache
miss's program build and graph capture) runs inside the bucket's
``execute`` on the supervised worker; the dispatcher and the submitting
threads touch host memory only.  A points request that rides a dense LW
bucket has its matrix built there too, on the service's device, as
``cluster_batch`` builds it.

Buckets route between the LW and batched NN-chain engines exactly as
``cluster_batch`` does (``ServiceConfig.algorithm``): under ``"auto"``
a large matrix-free points request dispatches as an ``(B, n, d)``
NN-chain bucket — its ``(n, n)`` matrix is never built, its merge list
comes back canonicalized (height-sorted, LW-equivalent to float
tolerance) and a matrix-free result stores no ``distances``.  LW and
nnchain buckets grouped out of the same window never share a
:class:`~repro_torch.core.batched.BucketSignature` (distinct ``algorithm``
/ ``points_dim`` fields), so they cannot collide in the program cache.

**Overload safety (DESIGN.md §14).**  Submission runs through a
bounded, priority-laned, quota-aware
:class:`~repro_torch.service.admission.AdmissionQueue` (policy: ``block``
/ ``reject`` / ``shed-oldest``); declined requests resolve with typed
:class:`~repro_torch.service.errors.ServiceOverloaded` instead of queueing
without bound.  Per-request deadlines are enforced *before* a bucket is
padded (a dead request never costs engine time), transient engine
failures get a bounded backoff-retry
(:class:`repro_torch.distributed.fault.RetryPolicy`) that reruns the same
program (never the kernels' plain twins), and bucket execution runs on a
supervised :class:`~repro_torch.service.worker.Watchdog` worker — a wedged
engine call fails only its own bucket, the worker is replaced, and the
warmed :class:`~repro_torch.service.cache.CompileCache` survives so
recovery builds nothing.  A program's lock makes an abandoned worker that
wakes later queue behind the replacement instead of racing it.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import dendrogram as dg
from repro_torch.core.api import (
    ClusterResult,
    _interpret_input,
    build_distance_matrix,
    check_points,
)
from repro_torch.core.batched import (
    BUCKETS,
    bucket_batch,
    bucket_n,
    bucket_signature,
    merge_prefix,
)
from repro_torch.core.distance import _budget_stack, count_distance_queries
from repro_torch.core.engine import VARIANTS, resolve_device
from repro_torch.core.landmark import LANDMARK_METRICS, landmark_cluster
from repro_torch.core.linkage import METHODS
from repro_torch.core.nnchain import (
    POINTS_METHODS,
    REDUCIBLE_METHODS,
    resolve_batch_algorithm,
)
from repro_torch.distributed.fault import RetryPolicy, retry_call
from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer
from repro_torch.service.admission import OVERLOAD_POLICIES, AdmissionQueue
from repro_torch.service.cache import (
    CACHEABLE_ENGINES,
    CompileCache,
    _sig_label,
    warmup_signatures,
)
from repro_torch.service.errors import (
    DeadlineExceeded,
    ServiceClosed,
    ServiceOverloaded,
    is_transient,
)
from repro_torch.service.worker import Watchdog


@dataclass(frozen=True)
class ServiceConfig:
    """One service = one engine configuration.

    ``bucket_ns`` declares the steady-state traffic mix (which shape
    buckets :meth:`ClusteringService.warmup` builds programs for).
    Requests outside the declared buckets are still served — they just
    pay an on-demand build (a recorded cache miss), exactly the signal the
    cache-hit-rate metric exists to surface.
    """

    method: str = "complete"
    engine: str = "serial"             # 'serial' | 'kernel'
    variant: str = "baseline"
    # per-bucket merge engine, resolved exactly as cluster_batch resolves
    # it (repro_torch.core.nnchain.resolve_batch_algorithm): "auto" keeps dense
    # buckets on LW and routes matrix-free points buckets of
    # NNCHAIN_BATCH_AUTO_MIN_N or larger to the batched NN-chain engine;
    # "nnchain" forces the chain (reducible methods, serial engine only);
    # "landmark" routes EVERY request to the sub-quadratic landmark lane
    # (repro_torch.core.landmark, DESIGN.md §15) — per-request execution on
    # the supervised worker, no shape bucket, no cache entry, no bucket-
    # grid size cap: the lane for large single requests whose Ω(n²)
    # distance evaluations the exact engines cannot afford
    algorithm: str = "auto"
    # landmark-lane knobs (algorithm="landmark" only): landmark count
    # override (None = ⌈√n·log₂ n⌉), sampling seed, refinement passes
    n_landmarks: int | None = None
    landmark_seed: int = 0
    landmark_refine: int = 0
    # declared embedding dim of the steady-state *points* traffic, so
    # warmup() also builds the matrix-free (B, n, d) programs;
    # None: warm dense signatures only (points requests of another d are
    # still served — they just pay a recorded on-demand build)
    points_dim: int | None = None
    stop_at_k: int = 1
    distance_threshold: float | None = None
    # engine compaction schedule; "auto" stages buckets past the first
    # boundary and canonicalizes smaller ones to the single-stage loop,
    # so the warmed working set stays one program per (bucket, B).
    compaction: bool | str = "auto"
    max_batch: int = 8                 # close the window at this many requests
    max_delay_ms: float = 2.0          # batching window opened by first request
    bucket_ns: tuple[int, ...] = (8, 16, 32, 64)
    cache_capacity: int = 64
    # -- §14 admission control / overload policy ----------------------------
    # bound on queued (not yet dispatched) requests across all lanes
    max_queue: int = 1024
    # at the bound: 'block' the submitter (backpressure), 'reject' the
    # newcomer, or 'shed-oldest' (evict the oldest request of the lowest
    # lane not above the newcomer's — freshest-first load shedding)
    overload_policy: str = "block"
    # priority lanes, 0 = highest; shedding drops the lowest class first
    n_lanes: int = 3
    default_lane: int = 1              # middle lane when submit() names none
    # max queued requests one tenant may hold (None = no quota); request
    # quota+1 is rejected typed regardless of policy, so a flooding
    # tenant cannot block or shed its neighbours
    tenant_quota: int | None = None
    # deadline stamped on requests that don't bring one (None = no
    # deadline); expired requests are shed BEFORE their bucket is padded
    default_deadline_ms: float | None = None
    # -- §14 retry + watchdog -----------------------------------------------
    max_retries: int = 2               # backoff-retries per bucket on
    retry_backoff_ms: float = 10.0     # transient engine failures
    # watchdog: a bucket running past the hard deadline fails (typed
    # WorkerWedged) and the supervised worker is replaced; the soft
    # deadline (factor x running median) only counts stragglers
    hard_deadline_ms: float | None = 30_000.0
    soft_deadline_factor: float = 3.0

    def __post_init__(self) -> None:
        if self.method not in METHODS:
            raise ValueError(f"unknown linkage method {self.method!r}")
        if self.engine == "distributed":
            raise NotImplementedError(
                "engine='distributed' is not ported yet: ROADMAP.md A7"
            )
        if self.engine not in CACHEABLE_ENGINES:
            raise ValueError(
                f"service engine must be one of {CACHEABLE_ENGINES}, got "
                f"{self.engine!r}"
            )
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.algorithm == "nnchain":
            # raises on a non-reducible method or a non-serial engine
            resolve_batch_algorithm(
                "nnchain", method=self.method, engine=self.engine,
                bucket_n=BUCKETS[0], variant=self.variant,
                compaction=self.compaction,
            )
        elif self.algorithm == "landmark":
            if self.method not in REDUCIBLE_METHODS:
                raise ValueError(
                    f"algorithm='landmark' clusters its landmarks with the "
                    f"NN-chain engine, which needs a reducible method "
                    f"{REDUCIBLE_METHODS}; got {self.method!r}"
                )
            if self.engine != "serial":
                raise ValueError(
                    f"algorithm='landmark' runs per-request on the "
                    f"supervised worker (engine='serial'), got "
                    f"{self.engine!r}"
                )
        elif self.algorithm not in ("auto", "lw"):
            raise ValueError(
                f"algorithm must be 'auto', 'lw', 'nnchain' or 'landmark', "
                f"got {self.algorithm!r}"
            )
        if self.n_landmarks is not None and self.n_landmarks < 1:
            raise ValueError(
                f"n_landmarks must be >= 1 or None, got {self.n_landmarks}"
            )
        if self.landmark_refine < 0:
            raise ValueError(
                f"landmark_refine must be >= 0, got {self.landmark_refine}"
            )
        if (
            self.algorithm != "landmark"
            and (self.n_landmarks is not None or self.landmark_refine != 0)
        ):
            raise ValueError(
                "n_landmarks/landmark_refine belong to the landmark lane — "
                f"set algorithm='landmark' (got {self.algorithm!r})"
            )
        if self.points_dim is not None and self.points_dim < 1:
            raise ValueError(
                f"points_dim must be a positive dim or None, got "
                f"{self.points_dim}"
            )
        if self.stop_at_k < 1:
            raise ValueError(f"stop_at_k must be >= 1, got {self.stop_at_k}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_delay_ms < 0:
            raise ValueError(f"max_delay_ms must be >= 0, got {self.max_delay_ms}")
        if self.compaction not in (True, False, "auto"):
            raise ValueError(
                f"compaction must be a bool or 'auto', got {self.compaction!r}"
            )
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.overload_policy not in OVERLOAD_POLICIES:
            raise ValueError(
                f"overload_policy must be one of {OVERLOAD_POLICIES}, got "
                f"{self.overload_policy!r}"
            )
        if not 1 <= self.n_lanes <= 8:
            raise ValueError(
                f"n_lanes must be in [1, 8] (2-3 covers real tiers), got "
                f"{self.n_lanes}"
            )
        if not 0 <= self.default_lane < self.n_lanes:
            raise ValueError(
                f"default_lane must be in [0, {self.n_lanes}), got "
                f"{self.default_lane}"
            )
        if self.tenant_quota is not None and self.tenant_quota < 1:
            raise ValueError(
                f"tenant_quota must be >= 1 or None, got {self.tenant_quota}"
            )
        if (self.default_deadline_ms is not None
                and self.default_deadline_ms <= 0):
            raise ValueError(
                f"default_deadline_ms must be > 0 or None, got "
                f"{self.default_deadline_ms}"
            )
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}"
            )
        if self.retry_backoff_ms < 0:
            raise ValueError(
                f"retry_backoff_ms must be >= 0, got {self.retry_backoff_ms}"
            )
        if self.hard_deadline_ms is not None and self.hard_deadline_ms <= 0:
            raise ValueError(
                f"hard_deadline_ms must be > 0 or None, got "
                f"{self.hard_deadline_ms}"
            )
        if self.soft_deadline_factor <= 1.0:
            raise ValueError(
                f"soft_deadline_factor must be > 1, got "
                f"{self.soft_deadline_factor}"
            )
        for n in self.bucket_ns:
            if n not in BUCKETS:
                raise ValueError(
                    f"declared bucket {n} is not on the bucket grid {BUCKETS}"
                )
        working_set = len(self.bucket_ns) * bucket_batch(self.max_batch).bit_length()
        if self.points_dim is not None:
            working_set *= 2    # dense + matrix-free signature families
        if self.cache_capacity < working_set:
            raise ValueError(
                f"cache_capacity={self.cache_capacity} is smaller than the "
                f"declared warmup working set ({working_set} signatures: "
                f"{len(self.bucket_ns)} buckets x padded batch sizes) — the "
                "LRU would thrash and steady-state traffic would rebuild, "
                "silently breaking the zero-build contract"
            )


@dataclass(frozen=True)
class MetricsSnapshot:
    """Point-in-time service metrics (see ``ServiceMetrics.snapshot``).

    Carries its own timebase (``started_at`` wall clock, ``uptime_s``
    monotonic) and the derived ``throughput_rps`` so a snapshot is
    interpretable without the caller keeping a clock of its own.  The
    trailing fields default so pre-timebase constructions stay valid.
    """

    n_requests: int
    n_batches: int
    n_failed: int
    p50_ms: float
    p99_ms: float
    mean_batch_size: float
    pad_waste: float            # fraction of dispatched matrix cells that pad
    cache_hit_rate: float | None
    started_at: float = 0.0     # service start, seconds since the epoch
    uptime_s: float = 0.0       # monotonic seconds since service start
    throughput_rps: float = 0.0  # n_requests / uptime_s
    # §14 overload accounting (trailing defaults keep old constructions
    # valid, same convention as the timebase fields above)
    n_shed: int = 0             # admission-control drops (all reasons)
    n_deadline_expired: int = 0  # requests whose deadline passed queued
    n_retries: int = 0          # transient-failure bucket retries
    n_worker_restarts: int = 0  # wedged-worker replacements
    n_stragglers: int = 0       # buckets past the soft deadline


class ServiceMetrics:
    """The dispatcher's per-batch accumulators — registry instruments.

    On :class:`repro_torch.obs.registry.MetricsRegistry`
    (DESIGN.md §13): counters are labeled registry counters, latencies a
    bounded-window histogram (the last ``window`` requests, so a
    long-lived service neither grows without bound nor pays an
    ever-larger percentile sort per snapshot).  The original API — the
    ``observe_*`` feeders, the scalar attributes, ``snapshot()`` — is
    unchanged; the registry view is what the exporters
    (:mod:`repro_torch.obs.export`) render.
    """

    def __init__(self, window: int = 8192,
                 registry: MetricsRegistry | None = None) -> None:
        self.registry = registry or MetricsRegistry()
        self.started_at = time.time()
        self._t0 = time.perf_counter()
        self._requests = self.registry.counter(
            "service_requests_total", "Requests resolved successfully")
        self._failed = self.registry.counter(
            "service_failed_total", "Requests resolved with an error")
        self._batches = self.registry.counter(
            "service_batches_total", "Bucket dispatches (engine calls)")
        self._cells = self.registry.counter(
            "service_cells_total",
            "Dispatched operand cells by kind (real vs padded total)")
        self._latency = self.registry.histogram(
            "service_request_latency_ms", "submit→resolve latency",
            window=window)
        # §14 overload / robustness instruments
        self._shed = self.registry.counter(
            "service_shed_total",
            "Requests dropped by admission control (by reason and lane)")
        self._expired = self.registry.counter(
            "service_deadline_expired_total",
            "Requests shed because their deadline passed while queued")
        self._retries = self.registry.counter(
            "service_retries_total",
            "Bucket dispatches retried on a transient engine failure")
        self._restarts = self.registry.counter(
            "service_worker_restarts_total",
            "Supervised workers replaced after a hard-deadline wedge")
        self._stragglers = self.registry.counter(
            "service_straggler_buckets_total",
            "Buckets past the soft (factor x median) deadline")
        self._queue_depth = self.registry.gauge(
            "service_queue_depth", "Queued requests by priority lane")

    # original scalar attributes, now registry-backed reads
    @property
    def n_requests(self) -> int:
        return int(self._requests.total())

    @property
    def n_batches(self) -> int:
        return int(self._batches.total())

    @property
    def n_failed(self) -> int:
        return int(self._failed.total())

    @property
    def cells_real(self) -> int:
        return int(self._cells.value(kind="real"))

    @property
    def cells_padded(self) -> int:
        return int(self._cells.value(kind="padded"))

    @property
    def n_shed(self) -> int:
        return int(self._shed.total())

    @property
    def n_deadline_expired(self) -> int:
        return int(self._expired.total())

    @property
    def n_retries(self) -> int:
        return int(self._retries.total())

    @property
    def n_worker_restarts(self) -> int:
        return int(self._restarts.total())

    @property
    def n_stragglers(self) -> int:
        return int(self._stragglers.total())

    def observe_request(self, latency_ms: float) -> None:
        self._requests.inc()
        self._latency.observe(latency_ms)

    def observe_failure(self) -> None:
        self._failed.inc()

    def observe_shed(self, reason: str, lane: int) -> None:
        self._shed.inc(reason=reason, lane=lane)

    def observe_expired(self, lane: int) -> None:
        self._expired.inc(lane=lane)

    def observe_retry(self) -> None:
        self._retries.inc()

    def observe_worker_restart(self) -> None:
        self._restarts.inc()

    def observe_straggler(self) -> None:
        self._stragglers.inc()

    def observe_queue_depths(self, depths: Sequence[int]) -> None:
        for lane, depth in enumerate(depths):
            self._queue_depth.set(depth, lane=lane)

    def shed_by_lane(self, lane: int) -> int:
        """Admission drops charged to one lane (all reasons)."""
        return int(sum(
            self._shed.value(reason=r, lane=lane)
            for r in ("queue-full", "quota", "shed")
        ))

    def observe_bucket(self, cells_real: int, cells_padded: int) -> None:
        self._batches.inc()
        self._cells.inc(cells_real, kind="real")
        self._cells.inc(cells_padded, kind="padded")

    def snapshot(self, cache: CompileCache | None = None) -> MetricsSnapshot:
        n_req = self.n_requests
        n_bat = self.n_batches
        padded = self.cells_padded
        pad = 1.0 - self.cells_real / padded if padded else 0.0
        uptime = time.perf_counter() - self._t0
        return MetricsSnapshot(
            n_requests=n_req,
            n_batches=n_bat,
            n_failed=self.n_failed,
            p50_ms=self._latency.percentile(50),
            p99_ms=self._latency.percentile(99),
            mean_batch_size=n_req / n_bat if n_bat else 0.0,
            pad_waste=pad,
            cache_hit_rate=cache.stats.hit_rate if cache is not None else None,
            started_at=self.started_at,
            uptime_s=uptime,
            throughput_rps=n_req / uptime if uptime > 0 else 0.0,
            n_shed=self.n_shed,
            n_deadline_expired=self.n_deadline_expired,
            n_retries=self.n_retries,
            n_worker_restarts=self.n_worker_restarts,
            n_stragglers=self.n_stragglers,
        )


@dataclass
class _Job:
    # None for a points job: a matrix-free NN-chain job's (n, n) matrix is
    # never built (`points` holds its (n, d) float32 operand); a points job
    # on a dense bucket gets its matrix on the worker, on the device
    matrix: np.ndarray | torch.Tensor | None
    points: np.ndarray | None
    metric: str | None
    future: Future = field(repr=False)
    t_submit: float = 0.0
    n: int = 0                  # problem size (leaves)
    trace_id: int = 0           # per-request id threading the span story
    done: bool = False          # guarded by the service condition lock
    lane: int = 0               # priority lane (0 = highest)
    tenant: str | None = None   # quota bucket
    deadline: float | None = None   # absolute perf_counter deadline
    landmark: bool = False      # route to the sub-quadratic landmark lane
    # DistanceBudget scopes open on the SUBMITTING thread — the landmark
    # lane replays its worker-side query tally onto these, so a caller's
    # count_distance_queries() sees service traffic too (budgets are
    # thread-local, the worker's own stack is empty)
    budgets: list = field(default_factory=list, repr=False)
    matrix_free: bool = False   # rides a (B, n, d) NN-chain bucket


class ClusteringService:
    """The continuous-batching clustering server.

    One background dispatcher thread owns batching and bucket order;
    engine calls run serially on its supervised :class:`Watchdog` worker
    (the dispatcher waits on each bucket, but can abandon a wedged one;
    a program's lock serializes its runs).  Callers interact only through
    :meth:`submit` futures.  Use as a context manager, or call
    :meth:`close`.  ``device`` is CUDA unless the caller names another
    (``"cpu"`` runs the kernels' plain versions); without a card the
    constructor raises.
    """

    def __init__(
        self,
        config: ServiceConfig | None = None,
        *,
        cache: CompileCache | None = None,
        registry: MetricsRegistry | None = None,
        tracer: Tracer | None = None,
        execute_hook: Callable | None = None,
        device=None,
    ) -> None:
        self.config = config or ServiceConfig()
        cfg = self.config
        self.device = resolve_device(device)
        self.tracer = tracer or NULL_TRACER
        # one registry per service (two services in one process must not
        # double-count); a caller-built cache brings its own, adopt it
        if cache is not None:
            if cache.device != self.device:
                raise ValueError(
                    f"the cache builds programs on {cache.device}, the service "
                    f"runs on {self.device}"
                )
            self.cache = cache
            self.registry = registry or cache.stats.registry
        else:
            self.registry = registry or MetricsRegistry()
            self.cache = CompileCache(
                self.config.cache_capacity,
                registry=self.registry, tracer=self.tracer, device=self.device,
            )
        self.metrics = ServiceMetrics(registry=self.registry)
        # fault-injection point (tests, load drivers): called on the
        # worker thread with the BucketSignature right before the cache
        # fetch + engine call — raise to simulate a transient failure,
        # sleep past hard_deadline_ms to simulate a wedge
        self._execute_hook = execute_hook
        self._queue = AdmissionQueue(
            max_queue=cfg.max_queue,
            n_lanes=cfg.n_lanes,
            policy=cfg.overload_policy,
            tenant_quota=cfg.tenant_quota,
        )
        self._retry_policy = RetryPolicy(
            attempts=cfg.max_retries + 1,
            base_delay_s=cfg.retry_backoff_ms / 1e3,
        )
        self._watchdog = Watchdog(
            hard_deadline_s=(
                None if cfg.hard_deadline_ms is None
                else cfg.hard_deadline_ms / 1e3
            ),
            soft_factor=cfg.soft_deadline_factor,
            on_straggler=lambda dt: self.metrics.observe_straggler(),
            on_restart=lambda gen: self.metrics.observe_worker_restart(),
        )
        self._pending = 0
        self._cond = threading.Condition()
        self._thread = threading.Thread(
            target=self._loop, name="lw-service-batcher", daemon=True
        )
        self._thread.start()

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self) -> "ClusteringService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def warmup(self) -> int:
        """Build the declared working set's programs; returns programs built.

        Covers every ``(bucket_n, padded-B)`` signature traffic inside
        ``config.bucket_ns`` can touch under the ``max_batch`` policy —
        after this returns, such traffic builds no program and captures no
        graph.  With ``points_dim`` declared the matrix-free NN-chain
        signatures of that dim are warmed too.  The builds run on this
        thread.
        """
        cfg = self.config
        if cfg.algorithm == "landmark":
            return 0    # per-request lane: no bucket programs
        kw = dict(
            method=cfg.method,
            engine=cfg.engine,
            variant=cfg.variant,
            stop_at_k=cfg.stop_at_k,
            with_threshold=cfg.distance_threshold is not None,
            max_batch=cfg.max_batch,
            compaction=cfg.compaction,
            algorithm=cfg.algorithm,
        )
        sigs = warmup_signatures(cfg.bucket_ns, **kw)
        if cfg.points_dim is not None:
            sigs += warmup_signatures(
                cfg.bucket_ns, points_dim=cfg.points_dim, **kw
            )
        return self.cache.warmup(sigs)

    def flush(self, timeout: float | None = None) -> bool:
        """Block until every submitted request has resolved."""
        with self._cond:
            return self._cond.wait_for(lambda: self._pending == 0, timeout)

    def close(self, timeout: float | None = 30.0) -> None:
        """Stop the service: the in-flight batch completes, still-queued
        requests fail fast with typed :class:`ServiceClosed` (call
        :meth:`flush` first if you want queued work served), the
        dispatcher and worker threads stop.

        The closed flag and the queue sweep happen in ONE admission-lock
        critical section (:meth:`AdmissionQueue.close_and_drain`), so a
        ``submit`` racing with close either lands in the sweep or
        observes closed — no future is ever stranded unresolved
        (``tests/test_service_robustness.py`` hammers this).

        Raises if the dispatcher is still mid-dispatch after ``timeout``
        (e.g. stuck in a long on-demand build) — silently returning
        would strand that batch's futures unresolved forever once the
        daemon thread dies with the interpreter.
        """
        swept = self._queue.close_and_drain()
        for job in swept:
            self._finish(job, error=ServiceClosed("service is closed"))
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError(
                f"service dispatcher did not stop within {timeout}s; "
                "in-flight work is still running — its futures are not "
                "resolved yet (retry close() with a larger timeout)"
            )
        self._watchdog.stop()

    # -- request path -------------------------------------------------------

    def submit(
        self,
        data,
        *,
        metric: str | None = None,
        is_distance: bool | None = None,
        priority: int | None = None,
        tenant: str | None = None,
        deadline_ms: float | None = None,
    ) -> Future:
        """Enqueue one clustering request; returns a Future[ClusterResult].

        ``data``/``metric``/``is_distance`` are interpreted exactly as by
        :func:`repro_torch.core.cluster` (points that ride a dense bucket
        are checked here and embedded by the worker, on the service's
        device, keeping the dispatcher free and the device to the worker).  Invalid
        requests resolve the future with the error instead of raising,
        so one bad request cannot take down a submission loop.

        §14 knobs: ``priority`` picks the lane (0 highest; default
        ``config.default_lane``), ``tenant`` the quota bucket, and
        ``deadline_ms`` the submit-relative deadline (default
        ``config.default_deadline_ms``).  Admission declines resolve the
        future with typed :class:`ServiceOverloaded` /
        :class:`DeadlineExceeded` / :class:`ServiceClosed` — never a
        raise, never an unbounded queue.
        """
        fut: Future = Future()
        if self._queue.closed:
            fut.set_exception(ServiceClosed("service is closed"))
            return fut
        trace_id = self.tracer.new_trace_id()
        t_sub0 = time.perf_counter()
        cfg = self.config
        lane = cfg.default_lane if priority is None else int(priority)
        try:
            if not 0 <= lane < cfg.n_lanes:
                raise ValueError(
                    f"priority must be in [0, {cfg.n_lanes}), got {lane}"
                )
            if deadline_ms is None:
                deadline_ms = cfg.default_deadline_ms
            elif deadline_ms <= 0:
                raise ValueError(
                    f"deadline_ms must be > 0, got {deadline_ms}"
                )
            D, points, used_metric = _interpret_input(
                data, cfg.method, metric, is_distance
            )
            n = int((D if points is None else points).shape[0])
            if n < 2:
                raise ValueError(f"need at least 2 items to cluster, got {n}")
            landmark = cfg.algorithm == "landmark"
            if landmark:
                # the sub-quadratic lane: per-request execution, no shape
                # bucket and no bucket-grid size cap — the (n, n) matrix
                # is never built anywhere
                if points is None:
                    raise ValueError(
                        "algorithm='landmark' samples landmarks from "
                        "coordinates: submit points/conformations, not a "
                        "pre-built distance matrix"
                    )
                if used_metric not in LANDMARK_METRICS:
                    raise ValueError(
                        f"algorithm='landmark' supports metrics "
                        f"{LANDMARK_METRICS}, got {used_metric!r}"
                    )
                mat = None
                points = np.asarray(points, np.float32)
                matrix_free = True
            else:
                bn = bucket_n(n)        # raises if larger than the top bucket
                # matrix-free routing: same capability rule and per-bucket
                # resolution as cluster_batch — a capable request whose
                # bucket resolves to nnchain never builds its (n, n) matrix
                capable = (
                    points is not None and points.ndim == 2
                    and cfg.method in POINTS_METHODS
                    and used_metric == "sqeuclidean"
                )
                algo = resolve_batch_algorithm(
                    cfg.algorithm, method=cfg.method, engine=cfg.engine,
                    bucket_n=bn, variant=cfg.variant,
                    compaction=cfg.compaction, points_capable=capable,
                )
                matrix_free = algo == "nnchain" and capable
                mat = None if points is not None else np.asarray(D, np.float32)
                if points is not None:
                    points = check_points(points, used_metric)
                    if matrix_free:
                        points = np.asarray(points, np.float32)
        except Exception as exc:  # noqa: BLE001 — resolve, don't raise
            self.metrics.observe_failure()
            self.tracer.add_span(
                "submit", t_sub0, time.perf_counter(),
                trace_id=trace_id, error=type(exc).__name__,
            )
            fut.set_exception(exc)
            return fut
        t_sub1 = time.perf_counter()
        self.tracer.add_span(
            "submit", t_sub0, t_sub1,
            trace_id=trace_id, n=n, matrix_free=matrix_free, lane=lane,
        )
        job = _Job(
            mat, points, used_metric, fut, t_sub1, matrix_free=matrix_free, n=n,
            trace_id=trace_id,
            lane=lane, tenant=tenant,
            deadline=(
                None if deadline_ms is None else t_sub1 + deadline_ms / 1e3
            ),
            landmark=landmark,
            budgets=list(_budget_stack()) if landmark else [],
        )
        with self._cond:
            self._pending += 1
        decision = self._queue.offer(job)   # may block (policy='block')
        for victim in decision.victims:
            self._shed(victim, reason="shed")
        if not decision.admitted:
            reason = decision.rejected_reason
            if reason == "closed":
                self._finish(job, error=ServiceClosed("service is closed"))
            elif reason == "deadline":
                self._expire(job)
            else:
                self._shed(job, reason=reason)
        self.metrics.observe_queue_depths(self._queue.depths())
        return fut

    def submit_many(self, datas: Sequence, **kw) -> list[Future]:
        return [self.submit(d, **kw) for d in datas]

    def _shed(self, job: _Job, *, reason: str) -> None:
        """Resolve one admission-control drop: typed error + counter + span."""
        t0 = time.perf_counter()
        self.metrics.observe_shed(reason, job.lane)
        self._finish(job, error=ServiceOverloaded(
            f"request shed by admission control ({reason}; lane={job.lane}"
            + (f", tenant={job.tenant!r}" if job.tenant else "") + ")",
            reason=reason, lane=job.lane, tenant=job.tenant,
        ), count_failure=False)
        self.tracer.add_span(
            "shed", t0, time.perf_counter(),
            trace_id=job.trace_id, reason=reason, lane=job.lane,
        )

    def _expire(self, job: _Job) -> None:
        """Resolve one expired-deadline request (shed before any padding)."""
        t0 = time.perf_counter()
        self.metrics.observe_expired(job.lane)
        self._finish(job, error=DeadlineExceeded(
            f"deadline expired after "
            f"{(t0 - job.t_submit) * 1e3:.1f} ms in queue (lane={job.lane})"
        ), count_failure=False)
        self.tracer.add_span(
            "deadline_expired", t0, time.perf_counter(),
            trace_id=job.trace_id, lane=job.lane,
        )

    # -- dispatcher ---------------------------------------------------------

    def _loop(self) -> None:
        cfg = self.config
        self.tracer.name_thread("lw-service-batcher")
        while True:
            # event-driven wakeup: an idle dispatcher sleeps in the
            # admission queue's Condition (no 20 ms poll) and wakes on the
            # next offer; None here means closed-and-drained → exit
            first = self._queue.take()
            if first is None:
                return
            batch = [first]
            deadline = time.perf_counter() + cfg.max_delay_ms / 1e3
            while len(batch) < cfg.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                job = self._queue.take(timeout=remaining)
                if job is None:     # window elapsed (or service closing) —
                    break           # dispatch what arrived either way
                batch.append(job)
            self.metrics.observe_queue_depths(self._queue.depths())
            try:
                self._dispatch(batch)
            except Exception as exc:  # noqa: BLE001 — the thread must survive
                for job in batch:   # _finish is idempotent per job
                    self._finish(job, error=exc)

    def _reap_expired(self, jobs: list[_Job]) -> list[_Job]:
        """Split out and resolve (typed) the jobs whose deadline passed."""
        now = time.perf_counter()
        live: list[_Job] = []
        for job in jobs:
            if job.deadline is not None and now > job.deadline:
                self._expire(job)
            else:
                live.append(job)
        return live

    def _dispatch(self, jobs: list[_Job]) -> None:
        # (bucket_n, matrix-free dim or 0): LW and nnchain buckets may
        # coexist in one window — distinct keys, distinct signatures.
        # Landmark jobs group under the (-1, dim) sentinel: no shape
        # bucket, executed per-request by _run_landmark.
        groups: dict[tuple[int, int], list[_Job]] = {}
        for job in self._reap_expired(jobs):
            if job.landmark:
                groups.setdefault((-1, job.points.shape[1]), []).append(job)
                continue
            pdim = job.points.shape[1] if job.matrix_free else 0
            groups.setdefault((bucket_n(job.n), pdim), []).append(job)
        for key in sorted(groups):
            # re-check per bucket: earlier buckets of the same window may
            # have consumed the budget — an expired job is shed HERE,
            # before it can pad a bucket or touch an engine (_run_bucket
            # never sees one; tests/test_service_robustness.py asserts it)
            group = self._reap_expired(groups[key])
            if not group:
                continue
            try:
                if key[0] == -1:
                    self._run_landmark(group)
                else:
                    self._run_bucket(key, group)
            except Exception as exc:  # noqa: BLE001 — fail the bucket's futures
                for job in group:
                    self._finish(job, error=exc)

    def _run_landmark(self, group: list[_Job]) -> None:
        """The sub-quadratic lane (DESIGN.md §15): each job is ONE
        supervised :func:`repro_torch.core.landmark.landmark_cluster` call
        on the service's device.

        No shape bucket, no packing, no cache entry — a landmark
        request is a large single problem whose batching win would be
        nil and whose (n, n) padding cost would be the exact waste this
        tier exists to avoid.  Watchdog + bounded retry still apply, so
        a wedged or transiently failing run fails only its own request.
        Worker-side distance queries are replayed onto any budget scopes
        the submitter had open (``_Job.budgets``) — budgets are
        thread-local, so the worker's own stack never sees them.
        """
        cfg = self.config
        tracer = self.tracer
        for job in group:
            t0 = time.perf_counter()

            def execute(job: _Job = job):
                if self._execute_hook is not None:
                    self._execute_hook(f"landmark/{job.n}")
                with count_distance_queries() as spent:
                    res = landmark_cluster(
                        job.points, cfg.method, metric=job.metric,
                        n_landmarks=cfg.n_landmarks,
                        seed=cfg.landmark_seed,
                        refine=cfg.landmark_refine,
                        device=self.device,
                    )
                for budget in job.budgets:
                    for tag, v in spent.by_tag.items():
                        budget.record(v, tag)
                return res, time.perf_counter()

            try:
                res, t_done = retry_call(
                    lambda execute=execute: self._watchdog.run(execute),
                    self._retry_policy,
                    retry_if=is_transient,
                    on_retry=lambda attempt, exc: self.metrics.observe_retry(),
                )
            except Exception as exc:  # noqa: BLE001 — fail only this job
                self._finish(job, error=exc)
                tracer.add_span(
                    "landmark", t0, time.perf_counter(),
                    trace_id=job.trace_id, error=type(exc).__name__,
                )
                continue
            self.metrics.observe_bucket(
                cells_real=int(job.n * res.k), cells_padded=int(job.n * res.k)
            )
            m = dg.truncate_canonical(
                np.asarray(res.merges), job.n,
                cfg.stop_at_k, cfg.distance_threshold,
            )
            result = ClusterResult(
                merges=m,
                method=cfg.method,
                backend=cfg.engine,
                algorithm="landmark",
                n_leaves=job.n,
                points=job.points,
                distances=None,
                metric=job.metric,
            )
            self._finish(job, result=result, t_done=t_done)
            tracer.add_span(
                "landmark", t0, time.perf_counter(),
                trace_id=job.trace_id, n=job.n, k=res.k,
            )

    def _run_bucket(self, key: tuple[int, int], group: list[_Job]) -> None:
        cfg = self.config
        n_pad, pdim = key
        tracer = self.tracer
        t_bucket0 = time.perf_counter()
        sig = bucket_signature(
            n_pad,
            len(group),
            method=cfg.method,
            engine=cfg.engine,
            variant=cfg.variant,
            stop_at_k=cfg.stop_at_k,
            with_threshold=cfg.distance_threshold is not None,
            compaction=cfg.compaction,
            algorithm=cfg.algorithm,
            points_dim=pdim,
        )
        thr = cfg.distance_threshold
        if pdim:
            cells_real = sum(j.n * pdim for j in group)
            cells_padded = sig.bucket_B * n_pad * pdim
        else:
            cells_real = sum(j.n ** 2 for j in group)
            cells_padded = sig.bucket_B * n_pad * n_pad

        def execute():
            # runs on the supervised worker thread (§14): the dispatcher
            # waits under the hard watchdog deadline and can abandon a
            # wedged engine call instead of dying with it.  Every device
            # operation of the bucket happens here: a miss's program build
            # (and graph capture), the upload, the run and the read-back.
            # The program's lock covers the upload through the read-back,
            # so a retry (or an abandoned worker waking late) loads the
            # operand again from the host copies.
            if self._execute_hook is not None:
                self._execute_hook(sig)
            hits_before = self.cache.stats.hits
            t_cache0 = time.perf_counter()
            prog = self.cache.get(sig)
            t_cache1 = time.perf_counter()
            tracer.add_span(
                "cache", t_cache0, t_cache1, cat="cache",
                hit=self.cache.stats.hits > hits_before,
            )
            with prog.lock:
                if not pdim:
                    for j in group:     # points on a dense bucket: their matrix
                        if j.matrix is None:
                            j.matrix = build_distance_matrix(j.points, j.metric,
                                                             device=self.device)
                prog.load([j.points if pdim else j.matrix for j in group])
                t_pack1 = time.perf_counter()
                tracer.add_span("pack", t_cache1, t_pack1, n_jobs=len(group))
                res_merges, res_n = prog.execute(thr)
                m = res_merges.cpu().numpy()       # device sync — execute span ends
                nm = res_n.cpu().numpy()
            t_exec1 = time.perf_counter()
            tracer.add_span(
                "execute", t_pack1, t_exec1, cat="device",
                bucket_n=n_pad, bucket_B=sig.bucket_B,
            )
            return m, nm, t_exec1

        # transient failures (a poisoned runtime call, device OOM) get a
        # bounded backoff-retry; a wedge raises typed WorkerWedged (a
        # ServiceError → non-transient) up to _dispatch, failing exactly
        # this bucket's futures while the watchdog replaces the worker
        merges, n_merges, t_done = retry_call(
            lambda: self._watchdog.run(execute),
            self._retry_policy,
            retry_if=is_transient,
            on_retry=lambda attempt, exc: self.metrics.observe_retry(),
        )

        self.metrics.observe_bucket(
            cells_real=int(cells_real), cells_padded=int(cells_padded)
        )
        for slot, job in enumerate(group):
            t_res0 = time.perf_counter()
            n = job.n
            if sig.algorithm == "nnchain":
                if int(n_merges[slot]) != n - 1:
                    self._finish(job, error=RuntimeError(
                        "NN-chain loop hit its iteration cap before "
                        "finishing — the input likely contains NaNs (the "
                        "chain invariant needs a total order on distances)"
                    ))
                    tracer.add_span(
                        "resolve", t_res0, time.perf_counter(),
                        trace_id=job.trace_id, error="nnchain-cap",
                    )
                    continue
                m = dg.truncate_canonical(
                    dg.canonical_order(merges[slot, : n - 1], n=n),
                    n, cfg.stop_at_k, cfg.distance_threshold,
                )
            else:
                upto = merge_prefix(n, cfg.stop_at_k, n_merges[slot])
                m = merges[slot, :upto]
            result = ClusterResult(
                merges=m,
                method=cfg.method,
                backend=cfg.engine,
                algorithm=sig.algorithm,
                n_leaves=n,
                points=job.points,
                distances=job.matrix,
                metric=job.metric,
            )
            self._finish(job, result=result, t_done=t_done)
            tracer.add_span(
                "resolve", t_res0, time.perf_counter(),
                trace_id=job.trace_id, n=n,
            )
        tracer.add_span(
            "bucket", t_bucket0, time.perf_counter(),
            signature=_sig_label(sig),
            trace_ids=[j.trace_id for j in group],
        )

    def _finish(
        self,
        job: _Job,
        *,
        result: ClusterResult | None = None,
        error: Exception | None = None,
        t_done: float | None = None,
        count_failure: bool = True,
    ) -> None:
        """Resolve one job exactly once — idempotent and cancel-safe.

        A client may have cancelled the future (or the error path may
        revisit a job its bucket already resolved); neither is allowed
        to raise into the dispatcher thread or double-count
        ``_pending``.  ``count_failure=False`` is the shed/expired path:
        those land on their own §14 counters, not ``service_failed_total``
        (an overload drop is a policy outcome, not a broken request).
        """
        with self._cond:
            if job.done:
                return
            job.done = True
        try:
            if error is not None:
                if count_failure:
                    self.metrics.observe_failure()
                job.future.set_exception(error)
            else:
                self.metrics.observe_request(
                    ((t_done or time.perf_counter()) - job.t_submit) * 1e3
                )
                job.future.set_result(result)
        except InvalidStateError:       # future was cancelled by the client
            pass
        finally:
            with self._cond:
                self._pending -= 1
                self._cond.notify_all()
