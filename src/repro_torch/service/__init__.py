"""repro_torch.service — online clustering service over the batched LW engine.

Counterpart of :mod:`repro.service` (DESIGN.md §10): a micro-batching
front-end (:mod:`~repro_torch.service.batcher`) that packs continuously
arriving requests into the scheduler's shape buckets, an explicit cache of
bucket programs (static device buffers and captured CUDA graphs) with LRU
eviction and declarative warmup (:mod:`~repro_torch.service.cache`) so
steady-state traffic builds nothing,
and a streaming-assignment path (:mod:`~repro_torch.service.assign`) that
labels new points against a fitted dendrogram cut with one
pairwise-distance call instead of a re-cluster.  Overload safety
(DESIGN.md §14) lives in :mod:`~repro_torch.service.admission` (bounded
priority-laned admission control), :mod:`~repro_torch.service.errors` (the
typed decline taxonomy) and :mod:`~repro_torch.service.worker` (the
supervised watchdog worker).  Synthetic open- and closed-loop load
drivers live in :mod:`~repro_torch.service.server`
(``python -m repro_torch.service.server``).
"""

from repro_torch.service.admission import OVERLOAD_POLICIES, AdmissionQueue
from repro_torch.service.assign import AssignIndex, assign, build_index
from repro_torch.service.batcher import (
    ClusteringService,
    MetricsSnapshot,
    ServiceConfig,
    ServiceMetrics,
)
from repro_torch.service.cache import (
    CacheStats,
    CompileCache,
    engine_jit_cache_size,
    warmup_signatures,
)
from repro_torch.service.errors import (
    DeadlineExceeded,
    ServiceClosed,
    ServiceError,
    ServiceOverloaded,
    WorkerWedged,
    is_transient,
)
from repro_torch.service.worker import BucketWorker, Watchdog

__all__ = [
    "AdmissionQueue",
    "AssignIndex",
    "BucketWorker",
    "CacheStats",
    "ClusteringService",
    "CompileCache",
    "DeadlineExceeded",
    "MetricsSnapshot",
    "OVERLOAD_POLICIES",
    "ServiceClosed",
    "ServiceConfig",
    "ServiceError",
    "ServiceMetrics",
    "ServiceOverloaded",
    "Watchdog",
    "WorkerWedged",
    "assign",
    "build_index",
    "engine_jit_cache_size",
    "is_transient",
    "warmup_signatures",
]
